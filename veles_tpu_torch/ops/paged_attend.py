"""Block-gather attention over a (possibly int8) paged KV pool — the
port of ``veles_tpu/ops/pallas_paged.py::pallas_paged_attend``.

:func:`paged_attend` launches ``csrc/paged_attend.cu`` for CUDA
tensors; :func:`paged_attend_plain` is the same function in plain
PyTorch (gather the table's blocks, dequantize, masked softmax), which
the wrapper runs for CPU tensors and the tests hold against the JAX
kernel.  The caller scatters the run's new K/V into the pool first;
both read the post-scatter pool.
"""

import ctypes

import numpy
import torch

from veles_tpu_torch import _build
from veles_tpu_torch.ops import (
    DTYPE_CODES, check_cuda_inputs, ptr, require, stream_ptr)

#: finite stand-in for -inf (the TPU kernel's convention)
NEG_INF = -1e30
#: queries per row the kernel takes (decode K1 = 1, verify K1 = k + 1)
MAX_K1 = 16
#: shared memory a CTA may take without an opt-in attribute
_SMEM_LIMIT = 48 * 1024

#: kernel launches so far (a plain count: the wrapper adds one per
#: launch and nothing else touches it but a caller resetting it)
launches = 0

_argtypes_set = False


def attend_scale(head_dim):
    """1/sqrt(head_dim) rounded as the JAX reference rounds it (f32)."""
    return float(numpy.float32(1.0) / numpy.sqrt(numpy.float32(head_dim)))


def paged_attend_plain(q, pool_k, pool_v, tables, qpos, heads,
                       scale_k=None, scale_v=None):
    """Plain PyTorch version: ``q`` [B, K1, d] at positions ``qpos``
    [B, K1]; pools [num_blocks, bs, d] (int8 when ``scale_k`` /
    ``scale_v`` [num_blocks, bs] f32 are given); ``tables`` [B, T]
    block ids.  Returns the f32 context [B, K1, d].  Materializes the
    gathered (dequantized) blocks — the kernel never does."""
    b, k1, d = q.shape
    bs = pool_k.shape[1]
    hd = d // heads
    idx = tables.long()
    kg = pool_k[idx].float()                       # [B, T, bs, d]
    vg = pool_v[idx].float()
    if scale_k is not None:
        kg = kg * scale_k[idx].float()[..., None]
        vg = vg * scale_v[idx].float()[..., None]
    length = kg.shape[1] * bs
    kh = kg.reshape(b, length, heads, hd)
    vh = vg.reshape(b, length, heads, hd)
    qh = q.float().reshape(b, k1, heads, hd)
    s = torch.einsum("bqhd,bkhd->bhqk", qh, kh) * attend_scale(hd)
    keep = (torch.arange(length, device=q.device)[None, None, :]
            <= qpos.long()[:, :, None])[:, None]   # [B, 1, K1, L]
    s = torch.where(keep, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, vh).reshape(b, k1, d)


def _lib():
    global _argtypes_set
    lib = _build.library("paged_attend")
    if not _argtypes_set:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.veles_paged_attend.argtypes = [
            vp, ci, vp, vp, ci, vp, vp, vp, vp, vp,
            ci, ci, ci, ci, ci, ci, ctypes.c_float, vp]
        lib.veles_paged_attend.restype = ci
        _argtypes_set = True
    return lib


def paged_attend(q, pool_k, pool_v, tables, qpos, heads, scale_k=None,
                 scale_v=None):
    """Paged attention (signature of :func:`paged_attend_plain`): the
    plain version for CPU tensors, the ``sm_90a`` kernel for CUDA
    tensors.  Raises on anything the kernel does not take."""
    global launches
    if q.device.type == "cpu":
        return paged_attend_plain(q, pool_k, pool_v, tables, qpos, heads,
                                  scale_k=scale_k, scale_v=scale_v)
    require(q.device.type == "cuda", "paged_attend: unsupported device %s",
            q.device)
    b, k1, d = q.shape
    nb, bs, dp = pool_k.shape
    nt = tables.shape[1]
    quant = scale_k is not None
    require(dp == d and pool_v.shape == pool_k.shape,
            "paged_attend: pools %s/%s do not match q %s",
            tuple(pool_k.shape), tuple(pool_v.shape), tuple(q.shape))
    require(d % heads == 0 and d // heads <= 1024,
            "paged_attend: d=%d over %d heads", d, heads)
    require(1 <= k1 <= MAX_K1, "paged_attend: K1=%d outside [1, %d]", k1,
            MAX_K1)
    require(tuple(tables.shape) == (b, nt) and nt >= 1
            and tuple(qpos.shape) == (b, k1),
            "paged_attend: tables %s / qpos %s do not fit q %s",
            tuple(tables.shape), tuple(qpos.shape), tuple(q.shape))
    require(q.dtype in (torch.float32, torch.bfloat16),
            "paged_attend: q dtype %s", q.dtype)
    require(pool_k.dtype == pool_v.dtype and pool_k.dtype in DTYPE_CODES,
            "paged_attend: pool dtype %s", pool_k.dtype)
    require(quant == (pool_k.dtype == torch.int8)
            and (scale_v is not None) == quant,
            "paged_attend: int8 pools need scale_k and scale_v (and only "
            "they take them)")
    require(tables.dtype == torch.int32 and qpos.dtype == torch.int32,
            "paged_attend: tables and qpos must be int32")
    if quant:
        require(scale_k.dtype == torch.float32
                and tuple(scale_k.shape) == (nb, bs)
                and tuple(scale_v.shape) == (nb, bs)
                and scale_v.dtype == torch.float32,
                "paged_attend: scales must be f32 [%d, %d]", nb, bs)
    threads = (d // heads + 31) // 32 * 32
    smem = ((threads // 32 + 1) * k1 * bs + k1) * 4
    require(smem <= _SMEM_LIMIT,
            "paged_attend: %d bytes of shared memory (K1=%d, bs=%d)",
            smem, k1, bs)
    check_cuda_inputs("paged_attend", q.device, q=q, pool_k=pool_k,
                      pool_v=pool_v, scale_k=scale_k, scale_v=scale_v,
                      tables=tables, qpos=qpos)
    out = torch.empty((b, k1, d), dtype=torch.float32, device=q.device)
    if b == 0:
        return out
    rc = _lib().veles_paged_attend(
        ptr(q), DTYPE_CODES[q.dtype], ptr(pool_k), ptr(pool_v),
        DTYPE_CODES[pool_k.dtype], ptr(scale_k), ptr(scale_v), ptr(tables),
        ptr(qpos), ptr(out), b, k1, d, heads, bs, nt,
        attend_scale(d // heads), stream_ptr(q.device))
    _build.check(rc, "paged_attend launch")
    launches += 1
    return out
