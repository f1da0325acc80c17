"""Block-gather attention over a (possibly int8) paged KV pool — the
port of ``veles_tpu/ops/pallas_paged.py::pallas_paged_attend``.

:func:`paged_attend` launches ``csrc/paged_attend.cu`` for CUDA
tensors; :func:`paged_attend_plain` is the same function in plain
PyTorch (gather the table's blocks, dequantize, masked softmax), which
the wrapper runs for CPU tensors and the tests hold against the JAX
kernel.  The caller scatters the run's new K/V into the pool first;
both read the post-scatter pool.

``paged_attend.cu`` has two kernels: the split kernel (a row's blocks
split over a thread-block cluster, the partial softmaxes merged through
distributed shared memory) for head rows of a multiple of 16 bytes on
16-byte-aligned pools, and the column kernel (one CTA per row and head)
for the rest; :func:`plan` picks one from the shape alone.  Each
launch takes at most :data:`MAX_K1` queries per row; a wider run (a
verify pass past 15 drafts, the quality gate's block-wide passes)
launches once per chunk of :data:`MAX_K1` queries.  A row's queries are
independent once the run's K/V is in the pool, so the chunks compute
what one launch over all of them would.
"""

import ctypes
import functools

import numpy
import torch

from veles_tpu_torch import _build
from veles_tpu_torch.ops import (
    DTYPE_CODES, check_cuda_inputs, ptr, require, stream_ptr)

#: finite stand-in for -inf (the TPU kernel's convention)
NEG_INF = -1e30
#: queries per row one launch takes (decode K1 = 1, verify K1 = k + 1);
#: :func:`paged_attend` splits a wider run into chunks of this many
MAX_K1 = 16
#: shared memory a column CTA may take (it sets no opt-in attribute)
_SMEM_LIMIT = 48 * 1024
#: shared memory a split CTA may opt into (the kernel sets it once)
SPLIT_SMEM_LIMIT = 232448
#: ranks of a split cluster at most (the portable cluster size)
MAX_CLUSTER = 8
#: bytes of K and V rows a split CTA stages at a time
TILE_BYTES = 32 * 1024
#: SMs of an H100: a split launch aims at 4 CTAs per SM
SMS = 132

#: kernel launches so far (a plain count: the wrapper adds one per
#: launch, of either kernel, and nothing else touches it but a caller
#: resetting it)
launches = 0
#: the same launches by kernel (:func:`plan`'s ``kernel``)
variant_launches = {"split": 0, "column": 0}
_VARIANT_CODES = {"column": 0, "split": 1}

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


def split_smem(k1, hd, elem, tile, nt, quant):
    """Shared-memory bytes of a split CTA (``split_smem`` in
    ``paged_attend.cu``): running max, sum, alpha and positions, the
    merge weights and the ranks' pushed max and sum, of up to 16
    queries (1 when K1 = 1); the table row; the K and V tiles; their
    scales and the tile's scores (padded to 4 rows); the queries, the
    row subsets' contexts and the ranks' pushed outputs in f32."""
    kmax = 1 if k1 == 1 else 16
    tile4 = (tile + 3) // 4 * 4
    nt4 = (nt + 3) // 4 * 4
    threads = 128 if hd // 4 <= 128 else 256
    subsets = threads // (hd // 4)
    return ((4 + 3 * MAX_CLUSTER) * kmax * 4 + 4 * nt4
            + 2 * tile * hd * elem + (8 * tile4 if quant else 0)
            + 4 * k1 * tile4 + 4 * k1 * hd + 4 * subsets * k1 * hd
            + 4 * (k1 * hd + MAX_CLUSTER))


@functools.lru_cache(maxsize=256)
def plan(b, k1, d, heads, bs, nt, pool_dtype, aligned=True):
    """Which kernel of ``csrc/paged_attend.cu`` takes ``q`` [b, k1, d]
    over ``heads`` heads and pools of ``pool_dtype`` blocks of ``bs``
    rows through a [b, nt] table, when both pools start on a 16-byte
    boundary (``aligned``): ``{"kernel": "split" | "column", "why":
    ...}``, and for the split kernel its cluster (ranks per row and
    head: 4 CTAs per SM over the b x heads pairs, at most 8 and at most
    ``nt``), the key rows it stages per tile and its shared memory.
    Decided from these arguments alone, never from the positions or
    the table (which stay on the card) or from a failed launch."""
    hd = d // heads
    elem = pool_dtype.itemsize
    if hd * elem % 16:
        return {"kernel": "column",
                "why": "head row of %d bytes, not a multiple of 16"
                % (hd * elem)}
    if not aligned:
        return {"kernel": "column", "why": "pools not 16-byte aligned"}
    cluster = max(1, min(MAX_CLUSTER, nt, -(-4 * SMS // max(1, b * heads))))
    rank_rows = -(-nt // cluster) * bs
    tile = max(1, min(rank_rows, TILE_BYTES // (2 * hd * elem)))
    smem = split_smem(k1, hd, elem, tile, nt, elem == 1)
    if smem > SPLIT_SMEM_LIMIT:
        return {"kernel": "column",
                "why": "split CTA would take %d bytes of shared memory"
                % smem}
    return {"kernel": "split", "why": "head row of %d bytes, aligned"
            % (hd * elem), "cluster": cluster, "tile": tile, "smem": smem}


def _lib():
    global _argtypes_set
    lib = _build.library("paged_attend")
    if not _argtypes_set:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.veles_paged_attend.argtypes = [
            vp, ci, vp, vp, ci, vp, vp, vp, vp, vp,
            ci, ci, ci, ci, ci, ci, ctypes.c_float, ci, ci, ci, vp]
        lib.veles_paged_attend.restype = ci
        _argtypes_set = True
    return lib


def paged_attend(q, pool_k, pool_v, tables, qpos, heads, scale_k=None,
                 scale_v=None):
    """Paged attention (signature of :func:`paged_attend_plain`): the
    plain version for CPU tensors, the ``sm_90a`` kernel for CUDA
    tensors, one launch per chunk of up to :data:`MAX_K1` queries.
    Raises on anything the kernel does not take."""
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
    require(k1 >= 1, "paged_attend: K1=%d", k1)
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
    require(b <= 65535 and heads <= 65535,
            "paged_attend: %d rows x %d heads", b, heads)
    check_cuda_inputs("paged_attend", q.device, q=q, pool_k=pool_k,
                      pool_v=pool_v, scale_k=scale_k, scale_v=scale_v,
                      tables=tables, qpos=qpos)
    out = torch.empty((b, k1, d), dtype=torch.float32, device=q.device)
    if b == 0:
        return out
    if k1 <= MAX_K1:
        _launch(q, pool_k, pool_v, scale_k, scale_v, tables, qpos, heads,
                out)
        return out
    for j in range(0, k1, MAX_K1):
        part = torch.empty((b, min(MAX_K1, k1 - j), d),
                           dtype=torch.float32, device=q.device)
        _launch(q[:, j:j + MAX_K1].contiguous(), pool_k, pool_v, scale_k,
                scale_v, tables, qpos[:, j:j + MAX_K1].contiguous(), heads,
                part)
        out[:, j:j + MAX_K1] = part
    return out


def _launch(q, pool_k, pool_v, scale_k, scale_v, tables, qpos, heads, out):
    """One launch over ``q`` [b, k1 <= MAX_K1, d] into ``out``."""
    global launches
    b, k1, d = q.shape
    bs, nt = pool_k.shape[1], tables.shape[1]
    how = plan(b, k1, d, heads, bs, nt, pool_k.dtype,
               pool_k.data_ptr() % 16 == 0 and pool_v.data_ptr() % 16 == 0)
    if how["kernel"] == "column":
        threads = (d // heads + 31) // 32 * 32
        smem = ((threads // 32 + 1) * k1 * bs + k1) * 4
        require(smem <= _SMEM_LIMIT,
                "paged_attend: %d bytes of shared memory (K1=%d, bs=%d)",
                smem, k1, bs)
    rc = _lib().veles_paged_attend(
        ptr(q), DTYPE_CODES[q.dtype], ptr(pool_k), ptr(pool_v),
        DTYPE_CODES[pool_k.dtype], ptr(scale_k), ptr(scale_v), ptr(tables),
        ptr(qpos), ptr(out), b, k1, d, heads, bs, nt,
        attend_scale(d // heads), _VARIANT_CODES[how["kernel"]],
        how.get("cluster", 0), how.get("tile", 0), stream_ptr(q.device))
    _build.check(rc, "paged_attend launch")
    launches += 1
    variant_launches[how["kernel"]] += 1
