"""Procedurally generated stand-in datasets (the port of
``veles_tpu/datasets``): numpy (and scipy for the tones), with the JAX
package's arrays for the same arguments.

- :func:`render_digits` (``glyphs.py``) — MNIST-shaped 28x28 stroke
  digits under random affine warps, jitter and noise;
- :func:`render_scenes` (``scenes.py``) — CIFAR-shaped 32x32 RGB shape
  classes over gradient backgrounds, colours independent of the class;
- ``tones.generate`` — a GTZAN-layout tree of wav files in ten
  synthetic "genres".
"""

from veles_tpu_torch.datasets.glyphs import render_digits  # noqa: F401
from veles_tpu_torch.datasets.scenes import render_scenes  # noqa: F401
