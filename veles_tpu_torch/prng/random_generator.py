"""RandomGenerator — one seed, two deterministic streams (the port of
``veles_tpu/prng/random_generator.py``).

- The host stream is ``numpy.random.Generator(PCG64(seed))``, as in
  the JAX package, so a loader's shuffle order is the reference's for
  the same seed.
- The device stream is Threefry keys (:mod:`.threefry`):
  :meth:`key` folds a monotone counter into ``key(seed)``, exactly the
  keys ``jax.random.fold_in(jax.random.key(seed), counter)`` gives.
"""

import numpy

from veles_tpu_torch.prng import threefry


class RandomGenerator:
    """Named reproducible RNG (default seed 42, as in the JAX
    package)."""

    def __init__(self, name="default", seed=None):
        self.name = name
        self.seed(42 if seed is None else seed)

    def seed(self, seed):
        """(Re)seed both streams.  Bytes, strings and numpy arrays (an
        entropy file's contents) are hashed to a 63-bit seed, as the
        JAX package hashes them."""
        if isinstance(seed, str):
            seed = seed.encode()
        if isinstance(seed, numpy.ndarray):
            seed = seed.tobytes()
        if isinstance(seed, bytes):
            import hashlib
            seed = int.from_bytes(
                hashlib.sha256(seed).digest()[:8], "little") % (1 << 63)
        self._seed = int(seed)
        self._counter = 0
        self.np = numpy.random.Generator(numpy.random.PCG64(self._seed))
        return self

    # -- host stream ---------------------------------------------------------

    def shuffle(self, arr):
        """Permute a numpy array in place."""
        self.np.shuffle(arr)

    def permutation(self, n):
        return self.np.permutation(n)

    def randint(self, low, high=None, size=None):
        return self.np.integers(low, high, size=size)

    def rand(self, *shape):
        return self.np.random(shape)

    def normal(self, loc=0.0, scale=1.0, size=None):
        return self.np.normal(loc, scale, size)

    def fill(self, arr, vmin=-1.0, vmax=1.0):
        """Fill a numpy array in place with uniform draws in [vmin,
        vmax) (the reference's ``fill``, the same stream)."""
        arr[...] = self.np.uniform(vmin, vmax, arr.shape).astype(arr.dtype)

    def fill_normal(self, arr, mean=0.0, stddev=1.0):
        """Fill a numpy array in place with normal draws."""
        arr[...] = self.np.normal(mean, stddev, arr.shape).astype(arr.dtype)

    # -- device stream -------------------------------------------------------

    def key(self, device=None):
        """A fresh key ([2] int64 words); advances the counter."""
        self._counter += 1
        return threefry.fold_in(threefry.key(self._seed, device),
                                self._counter)

    def peek_key(self, offset=0, device=None):
        """The key the (offset+1)-th future :meth:`key` call would
        return, without advancing."""
        return threefry.fold_in(threefry.key(self._seed, device),
                                self._counter + 1 + offset)


_generators = {}


def get(key="default"):
    """The process-wide generator named ``key`` (the JAX package's
    ``prng.get``): the command line seeds ``get()``, and a workflow
    built with ``weights_seed=None`` fills its first parameters from
    it."""
    gen = _generators.get(key)
    if gen is None:
        gen = _generators[key] = RandomGenerator(name=key)
    return gen
