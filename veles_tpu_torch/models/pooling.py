"""Pooling layers — the port of ``veles_tpu/models/pooling.py``
(``MaxPooling``, ``AvgPooling``, ``Depooling``).  VALID windows over
NHWC, ``sliding`` as ``(sx, sy)`` (default: the window), computed by
the library's pooling on the channels-last view.  A max window's
gradient goes to its first maximum in row-major order, as XLA's
``select_and_scatter`` routes it.  ``Depooling`` is the nearest-neighbour
upsampling of the conv autoencoders' decoders: each value repeated
``sy`` times down and ``sx`` times across."""

import torch.nn.functional as F

from veles_tpu_torch.models.conv import pair
from veles_tpu_torch.models.nn_units import ForwardBase


class PoolingBase(ForwardBase):
    """Parameterless window reduction over NHWC."""

    def __init__(self, kx=2, ky=2, sliding=None, device=None, dtype=None,
                 **hyper):
        super().__init__(device=device, dtype=dtype, **hyper)
        self.kx, self.ky = int(kx), int(ky)
        self.sliding = pair(sliding) if sliding is not None \
            else (self.kx, self.ky)

    def export_config(self):
        return {"kx": self.kx, "ky": self.ky, "sliding": list(self.sliding)}

    def out_shape(self, in_shape):
        h, w, c = in_shape
        sx, sy = self.sliding
        return ((h - self.ky) // sy + 1, (w - self.kx) // sx + 1, c)

    def _pool(self, fn, x, **kw):
        sx, sy = self.sliding
        y = fn(x.permute(0, 3, 1, 2), (self.ky, self.kx), stride=(sy, sx),
               **kw)
        return y.permute(0, 2, 3, 1)


class MaxPooling(PoolingBase):

    def apply(self, x):
        return self._pool(F.max_pool2d, x)


class AvgPooling(PoolingBase):
    """The window sum divided by the window's size."""

    def apply(self, x):
        return self._pool(F.avg_pool2d, x, divisor_override=1) \
            / (self.kx * self.ky)


class Depooling(PoolingBase):
    """[N, H, W, C] → [N, H·sy, W·sx, C], each value repeated over its
    ``sy`` × ``sx`` cell."""

    def out_shape(self, in_shape):
        h, w, c = in_shape
        sx, sy = self.sliding
        return (h * sy, w * sx, c)

    def apply(self, x):
        sx, sy = self.sliding
        return x.repeat_interleave(sy, dim=1).repeat_interleave(sx, dim=2)
