"""Reproducible seeded randomness (the port of ``veles_tpu/prng``):
Threefry-2x32 draws equal to ``jax.random``'s (:mod:`.threefry`) and
the named host/device generator (:mod:`.random_generator`)."""

from veles_tpu_torch.prng.random_generator import (  # noqa: F401
    RandomGenerator, get)
