"""Convolutional layers — the port of ``veles_tpu/models/conv.py``
(``Conv`` and its activation subclasses; ``space_to_depth`` stems and
``Deconv`` wait for a later slice).

Activations stay NHWC and kernels HWIO ``[ky, kx, C/groups, O]`` as
masters, as in the JAX package.  The convolution is the library's
(``F.conv2d``), as the JAX package leaves it to XLA's
``lax.conv_general_dilated``: it runs on the channels-last view
``x.permute(0, 3, 1, 2)`` (no copy) with the kernel viewed as
``[O, C/groups, ky, kx]``, and its result is viewed back as NHWC.

- Both operands and the output are in the compute dtype, the bias is
  added in it (the JAX unit's dtype policy).
- ``sliding`` is ``(sx, sy)`` (znicz's order); the strides are
  ``(sy, sx)``.
- ``padding`` ``"same"`` is XLA's SAME rule (output ``ceil(size /
  stride)``, the low side padded ``total // 2``); an uneven split is
  padded explicitly, since ``F.conv2d`` pads both sides alike.
- A float32 convolution on the card must not run in TF32 (cuDNN's
  default): ``veles_tpu_torch.dtypes`` turns TF32 off for the process
  at import, which covers the backward convolutions too.
"""

import torch.nn.functional as F

from veles_tpu_torch.models.activations import get_activation
from veles_tpu_torch.models.nn_units import ForwardBase


def pair(v):
    if isinstance(v, (tuple, list)):
        return tuple(int(x) for x in v[:2])
    return (int(v), int(v))


def _same(size, k, stride):
    """XLA's SAME padding (low, high) along one axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


class Conv(ForwardBase):
    """``y = activation(conv(x, W) + b)``, x ``[N, H, W, C]``."""

    ACTIVATION = "linear"

    PARAMS = ("weights", "bias")

    def __init__(self, n_kernels=None, kx=3, ky=3, sliding=(1, 1),
                 padding="same", n_groups=1, activation=None, device=None,
                 dtype=None, **hyper):
        super().__init__(device=device, dtype=dtype, **hyper)
        if n_kernels is None:
            raise ValueError("n_kernels is required")
        self.n_kernels = int(n_kernels)
        self.kx, self.ky = int(kx), int(ky)
        #: (sliding_x, sliding_y), znicz's order
        self.sliding = pair(sliding)
        self.padding = padding
        self.n_groups = int(n_groups)
        self.activation = activation or self.ACTIVATION

    def pads(self, h, w):
        """((top, bottom), (left, right)) for an [h, w] input."""
        p = self.padding
        if isinstance(p, str):
            if p.lower() == "valid":
                return (0, 0), (0, 0)
            if p.lower() == "same":
                sx, sy = self.sliding
                return _same(h, self.ky, sy), _same(w, self.kx, sx)
            raise ValueError("unknown padding %r" % p)
        if isinstance(p, int):
            return (p, p), (p, p)
        return tuple(tuple(int(v) for v in side) for side in p)

    def param_shapes(self, in_shape, window):
        c = in_shape[-1]
        if c % self.n_groups or self.n_kernels % self.n_groups:
            raise ValueError("%d input channels and %d kernels do not "
                             "split into %d groups"
                             % (c, self.n_kernels, self.n_groups))
        return {"weights": (self.ky, self.kx, c // self.n_groups,
                            self.n_kernels),
                "bias": (self.n_kernels,)}

    def fans(self, shape):
        return self.ky * self.kx * shape[2], shape[3]

    def out_shape(self, in_shape):
        h, w = in_shape[0], in_shape[1]
        (pt, pb), (pl, pr) = self.pads(h, w)
        sx, sy = self.sliding
        return ((h + pt + pb - self.ky) // sy + 1,
                (w + pl + pr - self.kx) // sx + 1, self.n_kernels)

    def conv(self, x):
        """The convolution alone, NHWC in and out, in the compute
        dtype."""
        (pt, pb), (pl, pr) = self.pads(x.shape[1], x.shape[2])
        xin = x.to(self.dtype).permute(0, 3, 1, 2)
        pad = (pt, pl)
        if pt != pb or pl != pr:
            xin = F.pad(xin, (pl, pr, pt, pb))
            pad = 0
        w = self.cast("weights").permute(3, 2, 0, 1)
        sx, sy = self.sliding
        y = F.conv2d(xin, w, stride=(sy, sx), padding=pad,
                     groups=self.n_groups)
        return y.permute(0, 2, 3, 1)

    def apply(self, x):
        return get_activation(self.activation)(self.conv(x)
                                               + self.cast("bias"))


class ConvTanh(Conv):
    ACTIVATION = "tanh"


class ConvRELU(Conv):
    ACTIVATION = "relu"


class ConvStrictRELU(Conv):
    ACTIVATION = "strict_relu"
