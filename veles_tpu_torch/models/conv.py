"""Convolutional layers — the port of ``veles_tpu/models/conv.py``:
``Conv`` and its activation subclasses (with the ``space_to_depth``
stem), and ``Deconv``.

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
- ``Conv(space_to_depth=n)`` is a stride-n VALID stem computed as a
  stride-1 VALID convolution over input pre-blocked by
  :func:`space_to_depth` (``[B, ceil(H/n), ceil(W/n), n²·C]``, or that
  flattened per sample with ``space_to_depth_hw``).  The weights stay in
  the logical ``[ky, kx, C, O]`` layout: the blocked kernel is built at
  every forward and autograd maps its gradient back.
- ``Deconv`` is ``lax.conv_transpose`` with ``transpose_kernel=False``,
  which is not ``F.conv_transpose2d``: a stride-1 cross-correlation
  (kernel not flipped) over the input dilated by the stride, padded by
  JAX's rule (:func:`conv_transpose_padding`; explicit pairs pad the
  dilated input as given, as in JAX).  The kernel is HWOI
  ``[ky, kx, n_kernels, C_in]``; the bias is added to the f32 result,
  on which the activation runs.
"""

import torch
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


def validate_space_to_depth(h, w, ky, kx, n):
    """Raise unless a stride-n VALID ky×kx convolution over [h, w] gives
    the same output from the blocked form: (h - ky) and (w - kx) are
    multiples of n and the blocked VALID output count equals the
    logical one (otherwise border outputs would come from the block
    padding)."""
    for dim, k in ((h, ky), (w, kx)):
        if (dim - k) % n:
            raise ValueError(
                "space_to_depth=%d misaligned: (%d - %d) %% %d != 0"
                % (n, dim, k, n))
        logical = (dim - k) // n + 1
        blocked = -(-dim // n) - (-(-k // n)) + 1
        if logical != blocked:
            raise ValueError(
                "space_to_depth=%d: blocked VALID output %d != logical %d "
                "over extent %d (kernel %d)" % (n, blocked, logical, dim, k))


def space_to_depth(x, n):
    """[B, H, W, C] → [B, ceil(H/n), ceil(W/n), n²·C], zero-padded to
    whole blocks, each block's channels in (dh, dw, c) order: the input
    of a ``Conv(space_to_depth=n)`` stem."""
    b, h, w, c = x.shape
    hp, wp = -h % n, -w % n
    if hp or wp:
        x = F.pad(x, (0, 0, 0, wp, 0, hp))
    hb, wb = (h + hp) // n, (w + wp) // n
    x = x.reshape(b, hb, n, wb, n, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, hb, wb, n * n * c)


def blocked_kernel(kernel, n):
    """Logical [ky, kx, C, O] → blocked [ceil(ky/n), ceil(kx/n), n²·C, O]
    in :func:`space_to_depth`'s channel order."""
    ky, kx, c, o = kernel.shape
    kby, kbx = -(-ky // n), -(-kx // n)
    kp = F.pad(kernel, (0, 0, 0, 0, 0, kbx * n - kx, 0, kby * n - ky))
    kp = kp.reshape(kby, n, kbx, n, c, o)
    return kp.permute(0, 2, 1, 3, 4, 5).reshape(kby, kbx, n * n * c, o)


def conv_transpose_padding(k, s, padding):
    """(before, after) padding of the dilated input along one axis for
    ``padding`` "SAME" or "VALID" (``jax.lax``'s
    ``_conv_transpose_padding``)."""
    if padding == "SAME":
        pad_len = k + s - 2
        pad_a = k - 1 if s > k - 1 else -(-pad_len // 2)
    else:
        pad_len = k + s - 2 + max(k - s, 0)
        pad_a = k - 1
    return pad_a, pad_len - pad_a


class Conv(ForwardBase):
    """``y = activation(conv(x, W) + b)``, x ``[N, H, W, C]``."""

    ACTIVATION = "linear"

    PARAMS = ("weights", "bias")

    def __init__(self, n_kernels=None, kx=3, ky=3, sliding=(1, 1),
                 padding="same", n_groups=1, activation=None,
                 space_to_depth=0, space_to_depth_hw=None, device=None,
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
        #: the blocked stem's block side (0: the plain convolution)
        self.space_to_depth = int(space_to_depth or 0)
        #: (hb, wb) of a blocked input stored flat [batch, hb·wb·n²·C]
        self.space_to_depth_hw = tuple(space_to_depth_hw) \
            if space_to_depth_hw else None
        if self.space_to_depth:
            n = self.space_to_depth
            if self.n_groups != 1:
                raise ValueError("space_to_depth requires n_groups=1")
            if self.sliding != (n, n):
                raise ValueError("space_to_depth=%d requires sliding=(%d, "
                                 "%d)" % (n, n, n))
            if not (isinstance(self.padding, str)
                    and self.padding.lower() == "valid"):
                raise ValueError("space_to_depth requires VALID padding")

    def _blocked_shape(self, in_shape):
        """(hb, wb, n²·C) of a blocked input's sample shape, flat or
        not."""
        if len(in_shape) == 1:
            if not self.space_to_depth_hw:
                raise ValueError(
                    "flat space_to_depth input needs space_to_depth_hw")
            hb, wb = self.space_to_depth_hw
            return hb, wb, in_shape[0] // (hb * wb)
        return tuple(in_shape)

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
        if self.space_to_depth:
            c = self._blocked_shape(in_shape)[-1] // self.space_to_depth ** 2
            return {"weights": (self.ky, self.kx, c, self.n_kernels),
                    "bias": (self.n_kernels,)}
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
        if self.space_to_depth:
            n = self.space_to_depth
            hb, wb, _ = self._blocked_shape(in_shape)
            return (hb - -(-self.ky // n) + 1, wb - -(-self.kx // n) + 1,
                    self.n_kernels)
        h, w = in_shape[0], in_shape[1]
        (pt, pb), (pl, pr) = self.pads(h, w)
        sx, sy = self.sliding
        return ((h + pt + pb - self.ky) // sy + 1,
                (w + pl + pr - self.kx) // sx + 1, self.n_kernels)

    def conv(self, x):
        """The convolution alone, NHWC in and out, in the compute
        dtype."""
        if self.space_to_depth:
            if x.dim() == 2:
                x = x.reshape((x.shape[0],)
                              + self._blocked_shape(x.shape[1:]))
            w = blocked_kernel(self.cast("weights"), self.space_to_depth)
            y = F.conv2d(x.to(self.dtype).permute(0, 3, 1, 2),
                         w.permute(3, 2, 0, 1))
            return y.permute(0, 2, 3, 1)
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

    def export_config(self):
        cfg = {"n_kernels": self.n_kernels, "kx": self.kx, "ky": self.ky,
               "sliding": list(self.sliding), "padding": self.padding,
               "n_groups": self.n_groups, "activation": self.activation,
               "include_bias": True}
        if self.space_to_depth:
            cfg["space_to_depth"] = self.space_to_depth
            if self.space_to_depth_hw:
                cfg["space_to_depth_hw"] = list(self.space_to_depth_hw)
        return cfg

    def apply(self, x):
        return get_activation(self.activation)(self.conv(x)
                                               + self.cast("bias"))


class ConvTanh(Conv):
    ACTIVATION = "tanh"


class ConvRELU(Conv):
    ACTIVATION = "relu"


class ConvStrictRELU(Conv):
    ACTIVATION = "strict_relu"


class Deconv(ForwardBase):
    """``y = activation(conv_transpose(x, W) + b)``, x ``[N, H, W, C]``,
    W HWOI ``[ky, kx, n_kernels, C]``; ``padding`` "same", "valid" or
    ((top, bottom), (left, right)) of the dilated input."""

    ACTIVATION = "linear"

    PARAMS = ("weights", "bias")

    def __init__(self, n_kernels=None, kx=3, ky=3, sliding=(1, 1),
                 padding="same", activation=None, device=None, dtype=None,
                 **hyper):
        super().__init__(device=device, dtype=dtype, **hyper)
        if n_kernels is None:
            raise ValueError("n_kernels is required")
        self.n_kernels = int(n_kernels)
        self.kx, self.ky = int(kx), int(ky)
        #: (sliding_x, sliding_y), znicz's order
        self.sliding = pair(sliding)
        self.padding = padding
        self.activation = activation or self.ACTIVATION

    def pads(self):
        """((top, bottom), (left, right)) of the dilated input."""
        p = self.padding
        if not isinstance(p, str):   # explicit pairs pad it as given
            return tuple(tuple(int(v) for v in side) for side in p)
        if p.upper() not in ("SAME", "VALID"):
            raise ValueError("unknown padding %r" % p)
        sx, sy = self.sliding
        return (conv_transpose_padding(self.ky, sy, p.upper()),
                conv_transpose_padding(self.kx, sx, p.upper()))

    def param_shapes(self, in_shape, window):
        return {"weights": (self.ky, self.kx, self.n_kernels, in_shape[-1]),
                "bias": (self.n_kernels,)}

    def fans(self, shape):
        return self.ky * self.kx * shape[3], shape[2]

    def out_shape(self, in_shape):
        h, w = in_shape[0], in_shape[1]
        sx, sy = self.sliding
        (pt, pb), (pl, pr) = self.pads()
        return ((h - 1) * sy + 1 + pt + pb - self.ky + 1,
                (w - 1) * sx + 1 + pl + pr - self.kx + 1, self.n_kernels)

    def deconv(self, x):
        """The transposed convolution alone, NHWC in and out, in the
        compute dtype."""
        sx, sy = self.sliding
        n, h, w, c = x.shape
        xin = x.to(self.dtype).permute(0, 3, 1, 2)
        if sx > 1 or sy > 1:
            dil = xin.new_zeros((n, c, (h - 1) * sy + 1, (w - 1) * sx + 1))
            dil[:, :, ::sy, ::sx] = xin
            xin = dil
        (pt, pb), (pl, pr) = self.pads()
        xin = F.pad(xin, (pl, pr, pt, pb))
        y = F.conv2d(xin, self.cast("weights").permute(2, 3, 0, 1))
        return y.permute(0, 2, 3, 1)

    def export_config(self):
        return {"n_kernels": self.n_kernels, "kx": self.kx, "ky": self.ky,
                "sliding": list(self.sliding), "padding": self.padding,
                "activation": self.activation, "include_bias": True}

    def apply(self, x):
        y = self.deconv(x).to(torch.float32) + self.params["bias"]
        return get_activation(self.activation)(y)
