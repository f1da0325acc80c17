"""DropoutForward — the port of ``veles_tpu/models/dropout.py``.

Inverted dropout: :meth:`DropoutForward.apply` (inference) is the
identity; :meth:`DropoutForward.apply_train` keeps each input with
probability ``keep = 1 - dropout_ratio`` and scales the kept ones by
``1 / keep``.  The mask is ``jax.random.bernoulli(key, keep)`` =
``uniform(key) < keep``, drawn through ``ops.random.uniform`` (kernel 5
on the card), so it equals the JAX package's mask for the same key.
"""

import torch

from veles_tpu_torch.models.nn_units import ForwardBase
from veles_tpu_torch.ops import random as ops_random


class DropoutForward(ForwardBase):

    def __init__(self, dropout_ratio=0.5, device=None, dtype=None, **hyper):
        super().__init__(device=device, dtype=dtype, **hyper)
        self.dropout_ratio = float(dropout_ratio)

    def export_config(self):
        return {"dropout_ratio": self.dropout_ratio}

    def apply(self, x):
        return x

    def mask(self, x, key):
        """The keep mask of ``x``'s shape for ``key`` (bool)."""
        return self.mask_of(x.shape, key, x.device)

    def mask_of(self, shape, key, device):
        """The keep mask of ``shape`` for ``key`` (bool), on ``device``
        (a mesh trainer draws the whole minibatch's once and gives each
        data-parallel group its rows)."""
        keep = torch.tensor(1.0 - self.dropout_ratio, dtype=torch.float32)
        return ops_random.uniform(key, tuple(shape), device=device) < keep

    def apply_train(self, x, key, mask=None):
        keep = 1.0 - self.dropout_ratio
        if mask is None:
            mask = self.mask(x, key)
        # JAX divides a bf16 x by keep rounded to bf16 (a weak-typed
        # Python scalar), not by keep in f32
        div = torch.tensor(keep, dtype=x.dtype, device=x.device)
        return torch.where(mask, x / div,
                           torch.zeros((), dtype=x.dtype, device=x.device))
