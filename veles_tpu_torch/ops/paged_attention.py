"""Block-table (paged) decode attention — the port of
``veles_tpu/ops/paged_attention.py`` for the decode step.

K/V live in per-layer pools of fixed-size blocks
(``[num_blocks, block_size, d]``); a request owns a block table
(``[B, T]`` physical ids) instead of a dense window row.  Table entries
past a slot's live blocks, and every entry of an occupancy bucket's
padding rows, point at block 0 — the reserved trash block — whose
garbage the causal mask ``key <= pos`` zeroes exactly.

The new token's K/V scatter into the pools IN PLACE (JAX returns new
arrays; the port writes the same tensors, which it still returns so
the signatures match).  The scatter stays plain PyTorch, as it was
jnp.  The fp32-pool attention is the plain gather, as in the JAX
package; the int8 path's gather→dequant→attend tail :func:`_q8_ctx`
runs :func:`~veles_tpu_torch.ops.paged_attend.paged_attend`, the
hand-written kernel for CUDA tensors.
"""

import torch

from veles_tpu_torch.ops import softmax
from veles_tpu_torch.ops.paged_attend import attend_scale, paged_attend

#: symmetric int8 range of the KV pools (one f32 scale per pool row)
INT8_QMAX = 127.0


def quantize_kv_rows(x):
    """Per-row symmetric int8 quantization of K/V rows ``x`` [..., d]:
    ``(q int8 [..., d], scale f32 [...])`` with ``q * scale ~= x``; an
    all-zero row gets scale 0 and dequantizes to exact zeros.
    Bit-equal to the JAX function."""
    xf = x.to(torch.float32)
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


def paged_decode_attention(q, k_new, v_new, pool_k, pool_v, tables, pos,
                           heads, compute_dtype):
    """One decode position per row against an fp32 (compute-dtype)
    paged pool: ``q``/``k_new``/``v_new`` [B, 1, d] at ``pos`` [B];
    ``tables`` [B, T] (T·block_size covers ``max(pos) + 1``).  Writes
    the new K/V into the pools in place and returns
    ``(pool_k, pool_v, context [B, 1, d])`` in the compute dtype."""
    b, _, d = q.shape
    hd = d // heads
    bs = pool_k.shape[1]
    blk, off = _scatter_rows(tables, pos, bs)
    pool_k[blk, off] = k_new[:, 0].to(pool_k.dtype)
    pool_v[blk, off] = v_new[:, 0].to(pool_v.dtype)
    idx = tables.long()
    length = idx.shape[1] * bs
    kh = pool_k[idx].to(compute_dtype).reshape(b, length, heads, hd)
    vh = pool_v[idx].to(compute_dtype).reshape(b, length, heads, hd)
    qh = q.reshape(b, 1, heads, hd)
    logits = torch.einsum("bqhd,bkhd->bhqk", qh, kh) * attend_scale(hd)
    keep = (torch.arange(length, device=q.device)[None, :]
            <= pos.long()[:, None])[:, None, None, :]
    logits = logits.masked_fill(~keep, float("-inf"))
    probs = softmax(logits)
    ctx = torch.einsum("bhqk,bkhd->bqhd", probs, vh).reshape(b, 1, d)
    return pool_k, pool_v, ctx


def _q8_ctx(q, pk, pv, sk, sv, tables, qpos, heads):
    """Shared gather→dequant→attend tail of the int8 decode (and,
    later, verify) paths: queries [B, K1, d] at ``qpos`` [B, K1] over
    the post-scatter int8 pools — the paged-attention kernel on the
    card, its plain version on the CPU.  Returns the f32 context."""
    return paged_attend(q, pk, pv, tables.to(torch.int32).contiguous(),
                        qpos.to(torch.int32).contiguous(), heads,
                        scale_k=sk, scale_v=sv)


def paged_decode_attention_q8(q, k_new, v_new, pool_k, pool_v, scale_k,
                              scale_v, tables, pos, heads):
    """:func:`paged_decode_attention` over INT8 pools: the new rows
    quantize on the scatter (their scales written at the same
    ``[block, row]``), the attention dequantizes inside the kernel.
    ``scale_k``/``scale_v`` [num_blocks, block_size] f32.  Returns
    ``(pool_k, pool_v, scale_k, scale_v, context)`` — the pools
    updated in place."""
    bs = pool_k.shape[1]
    blk, off = _scatter_rows(tables, pos, bs)
    qk, sk_new = quantize_kv_rows(k_new[:, 0])
    qv, sv_new = quantize_kv_rows(v_new[:, 0])
    pool_k[blk, off] = qk
    pool_v[blk, off] = qv
    scale_k[blk, off] = sk_new
    scale_v[blk, off] = sv_new
    ctx = _q8_ctx(q.contiguous(), pool_k, pool_v, scale_k, scale_v,
                  tables, pos[:, None], heads)
    return pool_k, pool_v, scale_k, scale_v, ctx
