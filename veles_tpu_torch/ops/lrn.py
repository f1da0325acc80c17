"""Cross-channel LRN — the port of ``veles_tpu/ops/lrn.py::lrn_pallas``
(kernel pair: forward + recompute backward).

    y = x · (k + alpha · Σ_{j ∈ window(c)} x_j²) ** -beta

over the last axis, the window ``[c - n//2, c + n - 1 - n//2]`` clipped
to the channels.

- :func:`lrn_fwd` / :func:`lrn_bwd` are the kernel wrappers
  (``csrc/lrn.cu``) for CUDA tensors, their plain versions
  :func:`lrn_plain` / :func:`lrn_bwd_plain` for CPU tensors.
  ``lrn.cu`` has two variants of each kernel: the row kernels (16-byte
  chunks of 8 channels, neighbours by warp shuffles) and the tile
  kernels (any shape); :func:`plan` picks one from the shape, the
  window and the pointers' alignment alone.
- :func:`lrn` is the autograd Function the ``norm`` unit calls: its
  forward saves only ``x`` and its backward recomputes the denominator
  (the TPU kernel's custom VJP).

Rounding points follow ``lrn_pallas``, not the band-matmul ``lrn`` the
TPU path runs (which rounds the window sum to ``x``'s type): squares in
``x``'s type, window sums and the power in float32, the backward's ``t``
rounded to ``x``'s type before its transposed window sum, one rounding
of the result.  The TPU path runs the band because its 4D→2D relayout
costs a copy there; NHWC rows are already contiguous ``[R, C]`` on the
card, so the card runs the kernel.
"""

import ctypes

import torch
import torch.nn.functional as F

from veles_tpu_torch import _build
from veles_tpu_torch.ops import (
    DTYPE_CODES, check_cuda_inputs, ptr, require, stream_ptr)

#: kernel launches so far, by kernel (the wrappers add one per launch,
#: of either variant)
launches = {"lrn_fwd": 0, "lrn_bwd": 0}
#: the same launches by variant (:func:`plan`'s ``kernel``)
variant_launches = {name: {"rows": 0, "tile": 0} for name in launches}

#: the tile kernels stage the window's halo in shared memory
MAX_N = 64
#: the row kernels reach one 8-channel chunk to either side (half <= 8)
ROWS_MAX_N = 17
#: the row kernels load and store 16 bytes at a time
ROWS_ALIGN = 16

_argtypes_set = False


def _power(s, beta):
    """``s ** -beta`` as the JAX package computes it (beta 0.75 as
    ``rsqrt(s) · sqrt(rsqrt(s))``)."""
    if beta == 0.75:
        r = torch.rsqrt(s)
        return r * torch.sqrt(r)
    return torch.pow(s, -beta)


def _window_sum(v, lo, hi):
    """Σ of ``v`` over channels ``[c - lo, c + hi]`` of each channel c
    (zero past the edges), added in ascending channel order."""
    c = v.shape[-1]
    pad = F.pad(v, (lo, hi))
    acc = pad[..., 0:c]
    for i in range(1, lo + hi + 1):
        acc = acc + pad[..., i:i + c]
    return acc


def _denominator(x, alpha, n, k):
    sq = (x * x).to(torch.float32)          # rounded to x's type first
    half = n // 2
    return k + alpha * _window_sum(sq, half, n - 1 - half)


def lrn_plain(x, alpha=1e-4, beta=0.75, n=5, k=2.0):
    """Plain PyTorch LRN over the last axis (f32 shifted adds)."""
    s = _denominator(x, alpha, n, k)
    return (x.to(torch.float32) * _power(s, beta)).to(x.dtype)


def lrn_bwd_plain(x, dy, alpha=1e-4, beta=0.75, n=5, k=2.0):
    """Plain PyTorch LRN gradient: ``dx = dy·p − 2αβ·x·u`` with
    ``p = s^-β``, ``t = dy·x·p/s`` rounded to ``x``'s type and ``u_i``
    the sum of ``t`` over the windows that contain ``i`` — channels
    ``[i - (n - 1 - n//2), i + n//2]``, the mirror image of the forward
    window when ``n`` is even."""
    s = _denominator(x, alpha, n, k)
    p = _power(s, beta)
    xf = x.to(torch.float32)
    dyf = dy.to(x.dtype).to(torch.float32)
    t = (dyf * xf * (p / s)).to(x.dtype).to(torch.float32)
    half = n // 2
    u = _window_sum(t, n - 1 - half, half)
    return (dyf * p - (2.0 * alpha * beta) * xf * u).to(x.dtype)


def plan(shape, n, dtype, ptr_alignment):
    """Which kernel of ``csrc/lrn.cu`` takes LRN over the last axis of
    ``shape`` with window ``n`` when every pointer (x, dy and the
    output) is a multiple of ``ptr_alignment`` bytes: ``{"kernel":
    "rows" | "tile", "why": ...}``, and for the row kernels the 16-byte
    loads per chunk of 8 channels of each tensor.  Decided from these
    arguments alone, never from a failed launch."""
    c = shape[-1]
    if c % 8:
        return {"kernel": "tile", "why": "C %% 8 = %d" % (c % 8)}
    if n > ROWS_MAX_N:
        return {"kernel": "tile", "why": "n %d > %d" % (n, ROWS_MAX_N)}
    if ptr_alignment % ROWS_ALIGN:
        return {"kernel": "tile",
                "why": "pointers aligned to %d bytes" % ptr_alignment}
    return {"kernel": "rows", "why": "C %% 8 = 0, n <= %d, aligned"
            % ROWS_MAX_N,
            "loads_per_chunk": 8 * dtype.itemsize // ROWS_ALIGN}


def alignment(*tensors):
    """The largest power of two (up to 256) dividing every tensor's
    address."""
    align = 256
    for t in tensors:
        addr = t.data_ptr()
        while addr % align:
            align //= 2
    return align


def _lib():
    global _argtypes_set
    lib = _build.library("lrn")
    if not _argtypes_set:
        vp, ci, cf, cl = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                          ctypes.c_int64)
        lib.veles_lrn_fwd.argtypes = [vp, vp, ci, cl, ci, ci, cf, cf, cf,
                                      ci, ci, vp]
        lib.veles_lrn_fwd.restype = ci
        lib.veles_lrn_bwd.argtypes = [vp, vp, vp, ci, cl, ci, ci, cf, cf,
                                      cf, cf, ci, ci, vp]
        lib.veles_lrn_bwd.restype = ci
        _argtypes_set = True
    return lib


def _check(what, x, n, **tensors):
    require(x.device.type == "cuda", "%s: unsupported device %s", what,
            x.device)
    require(x.dtype in (torch.float32, torch.bfloat16),
            "%s: dtype %s (want float32 or bfloat16)", what, x.dtype)
    require(x.dim() >= 1 and x.shape[-1] > 0, "%s: no channel axis", what)
    require(1 <= n <= MAX_N, "%s: window n=%d outside [1, %d]", what, n,
            MAX_N)
    for name, t in tensors.items():
        require(t.dtype == x.dtype and t.shape == x.shape,
                "%s: %s is %s %s, x is %s %s", what, name, t.dtype,
                tuple(t.shape), x.dtype, tuple(x.shape))
    check_cuda_inputs(what, x.device, x=x, **tensors)


def _count(name, kernel):
    launches[name] += 1
    variant_launches[name][kernel] += 1


def lrn_fwd(x, alpha=1e-4, beta=0.75, n=5, k=2.0):
    """LRN forward (signature of :func:`lrn_plain`): the plain version
    for CPU tensors, ``csrc/lrn.cu`` for CUDA tensors (the variant
    :func:`plan` picks; any channel count; raises on what no variant
    takes)."""
    if x.device.type == "cpu":
        return lrn_plain(x, alpha, beta, n, k)
    _check("lrn_fwd", x, n)
    y = torch.empty_like(x)
    if x.numel():
        c = x.shape[-1]
        kernel = plan(x.shape, n, x.dtype, alignment(x, y))["kernel"]
        rc = _lib().veles_lrn_fwd(
            ptr(x), ptr(y), DTYPE_CODES[x.dtype], x.numel() // c, c, n,
            alpha, beta, k, int(beta == 0.75), int(kernel == "rows"),
            stream_ptr(x.device))
        _build.check(rc, "lrn_fwd launch")
        _count("lrn_fwd", kernel)
    return y


def lrn_bwd(x, dy, alpha=1e-4, beta=0.75, n=5, k=2.0):
    """LRN gradient (signature of :func:`lrn_bwd_plain`; ``dy`` in
    ``x``'s dtype): the plain version for CPU tensors, ``csrc/lrn.cu``
    for CUDA tensors."""
    if x.device.type == "cpu":
        return lrn_bwd_plain(x, dy, alpha, beta, n, k)
    _check("lrn_bwd", x, n, dy=dy)
    dx = torch.empty_like(x)
    if x.numel():
        c = x.shape[-1]
        kernel = plan(x.shape, n, x.dtype, alignment(x, dy, dx))["kernel"]
        rc = _lib().veles_lrn_bwd(
            ptr(x), ptr(dy), ptr(dx), DTYPE_CODES[x.dtype], x.numel() // c,
            c, n, alpha, beta, k, 2.0 * alpha * beta, int(beta == 0.75),
            int(kernel == "rows"), stream_ptr(x.device))
        _build.check(rc, "lrn_bwd launch")
        _count("lrn_bwd", kernel)
    return dx


class _LRN(torch.autograd.Function):
    """Forward saves only ``x``; the backward recomputes the
    denominator (``lrn_pallas``'s custom VJP)."""

    @staticmethod
    def forward(ctx, x, alpha, beta, n, k):
        x = x.contiguous()
        ctx.save_for_backward(x)
        ctx.hyper = (alpha, beta, n, k)
        return lrn_fwd(x, alpha, beta, n, k)

    @staticmethod
    def backward(ctx, dy):
        (x,) = ctx.saved_tensors
        dx = lrn_bwd(x, dy.to(x.dtype).contiguous(), *ctx.hyper)
        return dx, None, None, None, None


def lrn(x, alpha=1e-4, beta=0.75, n=5, k=2.0):
    """Differentiable LRN over the last axis of ``x`` through the kernel
    pair (plain versions for CPU tensors)."""
    return _LRN.apply(x, float(alpha), float(beta), int(n), float(k))
