"""Block-table (paged) attention — the port of
``veles_tpu/ops/paged_attention.py``: the decode step and the
speculative-decoding verify step.

K/V live in per-layer pools of fixed-size blocks
(``[num_blocks, block_size, d]``); a request owns a block table
(``[B, T]`` physical ids) instead of a dense window row.  Table entries
past a slot's live blocks, and every entry of an occupancy bucket's
padding rows, point at block 0 — the reserved trash block — whose
garbage the causal mask ``key <= pos`` zeroes exactly.  A verify run's
positions past its row's ``lens`` scatter into the trash block too.

The new K/V scatter into the pools IN PLACE (JAX returns new arrays;
the port writes the same tensors, which it still returns so the
signatures match).  The scatter stays plain PyTorch, as it was jnp.
The fp32-pool attention is the plain gather, as in the JAX package,
but for the single-pass verify on the card; the int8 path's
gather→dequant→attend tail :func:`_q8_ctx` runs
:func:`~veles_tpu_torch.ops.paged_attend.paged_attend`, the
hand-written kernel for CUDA tensors.
"""

import torch

from veles_tpu_torch.ops import softmax
from veles_tpu_torch.ops.paged_attend import attend_scale, paged_attend

#: symmetric int8 range of the KV pools (one f32 scale per pool row)
INT8_QMAX = 127.0


def row_amax(x):
    """The f32 amax of each row of ``x`` [..., d] (what a row's int8
    scale is taken from)."""
    return x.to(torch.float32).abs().amax(dim=-1)


def quantize_kv_rows(x, amax=None):
    """Per-row symmetric int8 quantization of K/V rows ``x`` [..., d]:
    ``(q int8 [..., d], scale f32 [...])`` with ``q * scale ~= x``; an
    all-zero row gets scale 0 and dequantizes to exact zeros.
    Bit-equal to the JAX function.  ``amax`` [...] gives the rows'
    amax when ``x`` holds only some of each row's columns (a
    tensor-parallel shard: the max over every shard's
    :func:`row_amax`)."""
    xf = x.to(torch.float32)
    if amax is None:
        amax = xf.abs().amax(dim=-1)
    scale = amax / INT8_QMAX
    q = torch.where(scale[..., None] > 0.0,
                    xf / torch.clamp(scale[..., None], min=1e-30),
                    torch.zeros_like(xf))
    q = torch.clamp(torch.round(q), -INT8_QMAX, INT8_QMAX)
    return q.to(torch.int8), scale


def dequantize_kv(q, scale, dtype=torch.float32):
    """Inverse of :func:`quantize_kv_rows`: ``q`` int8 [..., d],
    ``scale`` [...] → [..., d] in ``dtype``."""
    return (q.to(torch.float32)
            * scale[..., None].to(torch.float32)).to(dtype)


def _scatter_rows(tables, pos, bs):
    """Physical (block, row) of each row's position ``pos`` [B]."""
    pos = pos.long()
    blk = torch.gather(tables.long(), 1, (pos // bs)[:, None])[:, 0]
    return blk, pos % bs


def _verify_rows(tables, pos, lens, k1, bs):
    """Positions ``qpos`` [B, K1] of a verify run (row n's position j at
    ``pos[n] + j``) and their physical (block, row); positions at or
    past ``lens[n]`` go to the trash block's row 0."""
    qpos = pos.long()[:, None] + torch.arange(k1, device=pos.device)[None, :]
    valid = torch.arange(k1, device=pos.device)[None, :] \
        < lens.long()[:, None]
    # padding positions may lie past the table: clamp before the gather,
    # they land in the trash block whatever it reads
    col = torch.clamp(qpos // bs, max=tables.shape[1] - 1)
    blk = torch.gather(tables.long(), 1, col)
    zero = torch.zeros_like(blk)
    return qpos, torch.where(valid, blk, zero), \
        torch.where(valid, qpos % bs, zero)


def _attend_gathered(q, kg, vg, qpos, heads):
    """Masked softmax attention of ``q`` [B, K1, d] over gathered K/V
    [B, L, d] (the compute dtype), causal ``key <= qpos`` [B, K1] per
    query: the jnp formulation of the JAX package."""
    b, k1, d = q.shape
    hd = d // heads
    length = kg.shape[1]
    kh = kg.reshape(b, length, heads, hd)
    vh = vg.reshape(b, length, heads, hd)
    qh = q.reshape(b, k1, heads, hd)
    logits = torch.einsum("bqhd,bkhd->bhqk", qh, kh) * attend_scale(hd)
    keep = (torch.arange(length, device=q.device)[None, None, :]
            <= qpos[:, :, None])[:, None]
    logits = logits.masked_fill(~keep, float("-inf"))
    probs = softmax(logits)
    return torch.einsum("bhqk,bkhd->bqhd", probs, vh).reshape(b, k1, d)


def _gather(pool, tables, dtype):
    """The table's blocks of ``pool`` as [B, T·bs, d] in ``dtype``."""
    b, t = tables.shape
    return pool[tables.long()].to(dtype).reshape(b, t * pool.shape[1], -1)


def paged_decode_attention(q, k_new, v_new, pool_k, pool_v, tables, pos,
                           heads, compute_dtype):
    """One decode position per row against an fp32 (compute-dtype)
    paged pool: ``q``/``k_new``/``v_new`` [B, 1, d] at ``pos`` [B];
    ``tables`` [B, T] (T·block_size covers ``max(pos) + 1``).  Writes
    the new K/V into the pools in place and returns
    ``(pool_k, pool_v, context [B, 1, d])`` in the compute dtype."""
    bs = pool_k.shape[1]
    blk, off = _scatter_rows(tables, pos, bs)
    pool_k[blk, off] = k_new[:, 0].to(pool_k.dtype)
    pool_v[blk, off] = v_new[:, 0].to(pool_v.dtype)
    ctx = _attend_gathered(q, _gather(pool_k, tables, compute_dtype),
                           _gather(pool_v, tables, compute_dtype),
                           pos.long()[:, None], heads)
    return pool_k, pool_v, ctx


def paged_verify_attention(q, k_new, v_new, pool_k, pool_v, tables, pos,
                           lens, heads, compute_dtype):
    """Score a width-K1 token run per row against an fp32
    (compute-dtype) paged pool — the speculative-decoding verify step,
    two-pass: ``q``/``k_new``/``v_new`` [B, K1, d], row n's position j
    at ``pos[n] + j``; ``lens`` [B] real positions per row (padding
    past it scatters into the trash block, its output rows are garbage
    the caller must not read).  The run scatters first, then the table
    is gathered, so a query sees the drafts before it written this
    pass: position for position :func:`paged_decode_attention`.
    Returns ``(pool_k, pool_v, context [B, K1, d])``, the pools written
    in place."""
    k1 = q.shape[1]
    qpos, blk, off = _verify_rows(tables, pos, lens, k1, pool_k.shape[1])
    pool_k[blk, off] = k_new.to(pool_k.dtype)
    pool_v[blk, off] = v_new.to(pool_v.dtype)
    ctx = _attend_gathered(q, _gather(pool_k, tables, compute_dtype),
                           _gather(pool_v, tables, compute_dtype), qpos,
                           heads)
    return pool_k, pool_v, ctx


def paged_verify_attention_fused(q, k_new, v_new, pool_k, pool_v, tables,
                                 pos, lens, heads, compute_dtype):
    """Single-pass fp32 verify (signature of
    :func:`paged_verify_attention`).  On the card the run scatters into
    the pools and the paged-attention kernel attends over the
    post-scatter pool (f32 context), as the JAX package's accelerator
    path does.  On the CPU the table is gathered from the pre-scatter
    pool and the run's rows are written into the gathered buffer,
    as JAX's interpret path does: valid output rows equal the two-pass
    path's."""
    b, k1, d = q.shape
    qpos, blk, off = _verify_rows(tables, pos, lens, k1, pool_k.shape[1])
    on_cpu = q.device.type == "cpu"
    if on_cpu:
        kg = _gather(pool_k, tables, compute_dtype)
        vg = _gather(pool_v, tables, compute_dtype)
    pool_k[blk, off] = k_new.to(pool_k.dtype)
    pool_v[blk, off] = v_new.to(pool_v.dtype)
    if not on_cpu:
        return pool_k, pool_v, paged_attend(
            q.contiguous(), pool_k, pool_v,
            tables.to(torch.int32).contiguous(),
            qpos.to(torch.int32).contiguous(), heads)
    # the run's rows land in the gathered buffer at their positions
    # (distinct per row); padding positions past the table are dropped,
    # as the JAX scatter drops them — they only feed masked scores
    inside = qpos < kg.shape[1]
    rows = torch.arange(b)[:, None].expand(b, k1)[inside]
    kg[rows, qpos[inside]] = k_new.to(compute_dtype)[inside]
    vg[rows, qpos[inside]] = v_new.to(compute_dtype)[inside]
    return pool_k, pool_v, _attend_gathered(q, kg, vg, qpos, heads)


def _q8_ctx(q, pk, pv, sk, sv, tables, qpos, heads):
    """Shared gather→dequant→attend tail of the int8 decode and verify
    paths: queries [B, K1, d] at ``qpos`` [B, K1] over
    the post-scatter int8 pools — the paged-attention kernel on the
    card, its plain version on the CPU.  Returns the f32 context."""
    return paged_attend(q, pk, pv, tables.to(torch.int32).contiguous(),
                        qpos.to(torch.int32).contiguous(), heads,
                        scale_k=sk, scale_v=sv)


def paged_decode_attention_q8(q, k_new, v_new, pool_k, pool_v, scale_k,
                              scale_v, tables, pos, heads, amax_k=None,
                              amax_v=None):
    """:func:`paged_decode_attention` over INT8 pools: the new rows
    quantize on the scatter (their scales written at the same
    ``[block, row]``), the attention dequantizes inside the kernel.
    ``scale_k``/``scale_v`` [num_blocks, block_size] f32.  ``amax_k``/
    ``amax_v`` [B] are the new rows' whole-row amaxes when the pools
    hold a tensor-parallel shard's columns.  Returns ``(pool_k, pool_v,
    scale_k, scale_v, context)`` — the pools updated in place."""
    bs = pool_k.shape[1]
    blk, off = _scatter_rows(tables, pos, bs)
    qk, sk_new = quantize_kv_rows(k_new[:, 0], amax_k)
    qv, sv_new = quantize_kv_rows(v_new[:, 0], amax_v)
    pool_k[blk, off] = qk
    pool_v[blk, off] = qv
    scale_k[blk, off] = sk_new
    scale_v[blk, off] = sv_new
    ctx = _q8_ctx(q.contiguous(), pool_k, pool_v, scale_k, scale_v,
                  tables, pos[:, None], heads)
    return pool_k, pool_v, scale_k, scale_v, ctx


def paged_verify_attention_q8(q, k_new, v_new, pool_k, pool_v, scale_k,
                              scale_v, tables, pos, lens, heads, amax_k=None,
                              amax_v=None):
    """:func:`paged_verify_attention` over INT8 pools: ONE quantizing
    scatter of the width-K1 run (padding past ``lens`` lands in the
    trash block, scale included), then ONE gather→dequant→attend pass
    (:func:`_q8_ctx`, the kernel on the card).  In-pass keys read back
    quantized: the cache state later decode steps read.  ``amax_k``/
    ``amax_v`` [B, K1]: whole-row amaxes of a tensor-parallel shard's
    rows.  Returns ``(pool_k, pool_v, scale_k, scale_v, context)``,
    updated in place."""
    k1 = q.shape[1]
    qpos, blk, off = _verify_rows(tables, pos, lens, k1, pool_k.shape[1])
    qk, sk_new = quantize_kv_rows(k_new, amax_k)
    qv, sv_new = quantize_kv_rows(v_new, amax_v)
    pool_k[blk, off] = qk
    pool_v[blk, off] = qv
    scale_k[blk, off] = sk_new
    scale_v[blk, off] = sv_new
    ctx = _q8_ctx(q.contiguous(), pool_k, pool_v, scale_k, scale_v,
                  tables, qpos, heads)
    return pool_k, pool_v, scale_k, scale_v, ctx
