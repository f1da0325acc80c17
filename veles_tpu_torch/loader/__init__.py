"""Minibatch loaders (the port of ``veles_tpu/loader`` for training on a
device-resident dataset)."""

from veles_tpu_torch.loader.base import TEST, TRAIN, VALID  # noqa: F401
from veles_tpu_torch.loader.fullbatch import FullBatchLoader  # noqa: F401
