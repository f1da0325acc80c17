"""Exact attention with a FlashAttention-2 forward and backward — the
port of ``veles_tpu/ops/pallas_attention.py::pallas_attention``.

:func:`flash_attention` is a ``torch.autograd.Function``: the forward
returns O and saves (q, k, v, O, LSE); the backward returns dq, dk, dv.
For CUDA tensors each pass launches ``csrc/flash_attention.cu`` (the
forward kernel, then the dq and the dk/dv kernels: tensor-core tiles in
bfloat16, SIMT in float32); for CPU tensors it runs the plain PyTorch
versions :func:`flash_fwd_plain` and :func:`flash_bwd_plain`
(:func:`flash_bwd_dq_plain` and :func:`flash_bwd_dkv_plain`), which
mirror the kernels' math and rounding points: f32 scores, the finite
``-1e30`` mask, a top-left causal mask (``col <= row``, also when
``sq != sk``), P rounded to the input type before each product, P
recomputed from the LSE in the backward, ``delta = rowsum(dO·O)`` and
``ds = P·(dP − delta)·scale`` in f32, and outputs in the input type.
The dq pass computes delta once per query row and returns it beside dq;
the dk/dv pass takes it instead of O.

Layout: q [b, sq, h, d], k [b, sk, h, d], v [b, sk, h, dv] — the JAX
package's; the LSE and delta are [b, h, sq] f32.  The kernels take
``dv == d`` and the head dims of :data:`KERNEL_HEAD_DIMS`, in float32
or bfloat16 (bf16 tensors 16-byte aligned); the plain versions take
any.
"""

import ctypes

import torch

from veles_tpu_torch import _build
from veles_tpu_torch.ops import (
    DTYPE_CODES, check_cuda_inputs, ptr, require, stream_ptr)

#: finite stand-in for -inf (the TPU kernel's convention)
NEG_INF = -1e30
#: head dims the kernels are built for (csrc/flash_attention.cu)
KERNEL_HEAD_DIMS = (128, 256)

#: kernel launches so far, by kernel (the wrappers add one per launch
#: and nothing else touches the counts but a caller resetting them)
launches = {"flash_attn_fwd": 0, "flash_attn_dq": 0, "flash_attn_dkv": 0}

_argtypes_set = False


def default_scale(head_dim):
    """``1/sqrt(head_dim)`` as a Python float (``pallas_attention``'s
    default; the kernels take it rounded to f32)."""
    return 1.0 / (head_dim ** 0.5)


def _scores(q, k, causal, scale):
    """Masked f32 scores [b, h, sq, sk]."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    sq, sk = s.shape[-2], s.shape[-1]
    if causal:
        rows = torch.arange(sq, device=s.device)[:, None]
        cols = torch.arange(sk, device=s.device)[None, :]
        s = s.masked_fill(cols > rows, NEG_INF)
    return s


def flash_fwd_plain(q, k, v, causal=False, scale=None):
    """Plain version of the forward: (O [b, sq, h, dv] in q's dtype,
    LSE [b, h, sq] f32)."""
    if scale is None:
        scale = default_scale(q.shape[-1])
    s = _scores(q, k, causal, scale)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp(min=1e-30)
    acc = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).float(), v.float())
    o = (acc / l).transpose(1, 2).to(q.dtype)
    return o, (m + torch.log(l))[..., 0]


def _bwd_terms(q, k, v, do, lse, delta, causal, scale):
    """P recomputed from the LSE, and ds = P·(dP − delta)·scale (f32,
    [b, h, sq, sk]) — what each backward kernel recomputes."""
    p = torch.exp(_scores(q, k, causal, scale) - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    return p, p * (dp - delta[..., None]) * scale


def flash_bwd_dq_plain(q, k, v, do, o, lse, causal=False, scale=None):
    """Plain version of the dq kernel: (dq in q's dtype, delta =
    rowsum(dO·O) [b, h, sq] f32)."""
    if scale is None:
        scale = default_scale(q.shape[-1])
    delta = (do.float() * o.float()).sum(dim=-1).transpose(1, 2)
    _, ds = _bwd_terms(q, k, v, do, lse, delta, causal, scale)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).float(), k.float())
    return dq.to(q.dtype), delta.contiguous()


def flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal=False, scale=None):
    """Plain version of the dk/dv kernel: (dk, dv) in k's and v's
    dtypes, from the dq pass's delta."""
    if scale is None:
        scale = default_scale(q.shape[-1])
    p, ds = _bwd_terms(q, k, v, do, lse, delta, causal, scale)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).float(), q.float())
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).float(),
                      do.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_plain(q, k, v, do, o, lse, causal=False, scale=None):
    """Plain version of the backward: (dq, dk, dv) in the inputs'
    dtypes, from the forward's O and LSE and the cotangent ``do``."""
    dq, delta = flash_bwd_dq_plain(q, k, v, do, o, lse, causal, scale)
    return (dq, *flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal,
                                     scale))


def _lib():
    global _argtypes_set
    lib = _build.library("flash_attention")
    if not _argtypes_set:
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        dims = [ci] * 7 + [cf, vp]      # dtype b h sq sk d causal scale stream
        lib.veles_flash_fwd.argtypes = [vp] * 5 + dims
        lib.veles_flash_bwd_dq.argtypes = [vp] * 8 + dims
        lib.veles_flash_bwd_dkv.argtypes = [vp] * 8 + dims
        for fn in (lib.veles_flash_fwd, lib.veles_flash_bwd_dq,
                   lib.veles_flash_bwd_dkv):
            fn.restype = ci
        _argtypes_set = True
    return lib


def _check(what, q, k, v, **more):
    """What every kernel wrapper checks before a launch; returns
    (b, h, sq, sk, d)."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    require(tuple(k.shape) == (b, sk, h, d) and tuple(v.shape) == (b, sk, h, d),
            "%s: q %s, k %s, v %s (the kernels take dv == d)", what,
            tuple(q.shape), tuple(k.shape), tuple(v.shape))
    require(d in KERNEL_HEAD_DIMS,
            "%s: head_dim %d is not built (the kernels take %s)", what, d,
            KERNEL_HEAD_DIMS)
    require(q.dtype in (torch.float32, torch.bfloat16),
            "%s: dtype %s", what, q.dtype)
    for name, t in dict(q=q, k=k, v=v, **more).items():
        if name in ("lse", "delta"):
            require(t.dtype == torch.float32 and tuple(t.shape) == (b, h, sq),
                    "%s: %s must be f32 [%d, %d, %d]", what, name, b, h, sq)
            continue
        require(t.dtype == q.dtype, "%s: %s is %s, q is %s", what, name,
                t.dtype, q.dtype)
        # the tensor-core kernels copy rows in 16-byte pieces
        require(t.dtype != torch.bfloat16 or t.data_ptr() % 16 == 0,
                "%s: %s must be 16-byte aligned", what, name)
    for name in ("do", "o"):
        if name in more:
            require(tuple(more[name].shape) == (b, sq, h, d),
                    "%s: %s must be [%d, %d, %d, %d]", what, name, b, sq, h,
                    d)
    require(q.device.type == "cuda", "%s: unsupported device %s", what,
            q.device)
    check_cuda_inputs(what, q.device, q=q, k=k, v=v, **more)
    return b, h, sq, sk, d


def _dims(q, b, h, sq, sk, d, causal, scale):
    return (DTYPE_CODES[q.dtype], b, h, sq, sk, d, int(bool(causal)),
            float(scale), stream_ptr(q.device))


def flash_fwd(q, k, v, causal=False, scale=None):
    """Forward (signature of :func:`flash_fwd_plain`): the plain version
    for CPU tensors, the ``sm_90a`` kernel for CUDA tensors."""
    if scale is None:
        scale = default_scale(q.shape[-1])
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, causal, scale)
    b, h, sq, sk, d = _check("flash_attn_fwd", q, k, v)
    o = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    if o.numel() and sk:
        rc = _lib().veles_flash_fwd(ptr(q), ptr(k), ptr(v), ptr(o), ptr(lse),
                                    *_dims(q, b, h, sq, sk, d, causal, scale))
        _build.check(rc, "flash_attn_fwd launch")
        launches["flash_attn_fwd"] += 1
    return o, lse


def flash_bwd_dq(q, k, v, do, o, lse, causal=False, scale=None):
    """(dq, delta) of the backward: the plain version's for CPU
    tensors, the dq kernel for CUDA tensors."""
    if scale is None:
        scale = default_scale(q.shape[-1])
    if q.device.type == "cpu":
        return flash_bwd_dq_plain(q, k, v, do, o, lse, causal, scale)
    b, h, sq, sk, d = _check("flash_attn_dq", q, k, v, do=do, o=o, lse=lse)
    dq = torch.empty_like(q)
    delta = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    if dq.numel() and sk:
        rc = _lib().veles_flash_bwd_dq(
            ptr(q), ptr(k), ptr(v), ptr(do), ptr(o), ptr(lse), ptr(dq),
            ptr(delta), *_dims(q, b, h, sq, sk, d, causal, scale))
        _build.check(rc, "flash_attn_dq launch")
        launches["flash_attn_dq"] += 1
    return dq, delta


def flash_bwd_dkv(q, k, v, do, lse, delta, causal=False, scale=None):
    """(dk, dv) of the backward from the dq pass's delta: the plain
    version's for CPU tensors, the dk/dv kernel for CUDA tensors."""
    if scale is None:
        scale = default_scale(q.shape[-1])
    if q.device.type == "cpu":
        return flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal, scale)
    b, h, sq, sk, d = _check("flash_attn_dkv", q, k, v, do=do, lse=lse,
                             delta=delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if dk.numel() and sq:
        rc = _lib().veles_flash_bwd_dkv(
            ptr(q), ptr(k), ptr(v), ptr(do), ptr(lse), ptr(delta), ptr(dk),
            ptr(dv), *_dims(q, b, h, sq, sk, d, causal, scale))
        _build.check(rc, "flash_attn_dkv launch")
        launches["flash_attn_dkv"] += 1
    return dk, dv


def _aligned(t):
    """``t`` contiguous and 16-byte aligned (a copy when a view starts
    off the alignment the kernels' row copies need)."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


class _FlashAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        o, lse = flash_fwd(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = _aligned(do.to(q.dtype))
        dq, delta = flash_bwd_dq(q, k, v, do, o, lse, ctx.causal, ctx.scale)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, ctx.causal,
                               ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal=False, scale=None):
    """Exact attention over q [b, sq, h, d], k [b, sk, h, d], v
    [b, sk, h, dv] → [b, sq, h, dv] in q's dtype, differentiable in q,
    k and v.  ``scale`` defaults to ``1/sqrt(d)``."""
    if scale is None:
        scale = default_scale(q.shape[-1])
    return _FlashAttention.apply(_aligned(q), _aligned(k), _aligned(v),
                                 bool(causal), float(scale))
