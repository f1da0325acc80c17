"""Minibatch loaders (the port of ``veles_tpu/loader``).

- :mod:`.base` — Loader: minibatch serving, class split, shuffling,
  epoch flags, failed-minibatch requeue;
- :mod:`.fullbatch` — the device-resident dataset;
- :mod:`.prefetch` — the asynchronous input pipeline;
- :mod:`.image`, :mod:`.pickles`, :mod:`.hdf5_loader`, :mod:`.text`,
  :mod:`.sound` — datasets from files;
- :mod:`.saver` — minibatch stream save and replay;
- :mod:`.interactive` — minibatches fed from code.
"""

from veles_tpu_torch.loader.base import (  # noqa: F401
    CLASS_NAME, TEST, TRAIN, VALID, ILoader, Loader)
from veles_tpu_torch.loader.fullbatch import (  # noqa: F401
    FullBatchLoader, FullBatchLoaderMSE)
