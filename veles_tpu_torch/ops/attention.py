"""Single-device attention cores — the port of ``veles_tpu/ops/
attention.py``: :func:`attention` (dense, the plain core ``mha_apply``
takes off the kernel rule and the tests' dense reference) and
:func:`blockwise_attention` (K/V streamed in blocks through an online
softmax, never the full score matrix).  The ring schedule over the
``sp`` mesh axis is not ported."""

import torch

from veles_tpu_torch.ops import softmax
from veles_tpu_torch.ops.paged_attend import attend_scale


def attention(q, k, v, causal=False, scale=None):
    """softmax(q·kᵀ·scale)·v over q [..., sq, h, d], k/v [..., sk, h,
    d] in their dtype; the causal mask is the reference's
    ``tril(ones(sq, sk), sk - sq)`` (bottom-right aligned)."""
    if scale is None:
        scale = attend_scale(q.shape[-1])
    logits = torch.einsum("...qhd,...khd->...hqk", q, k) * scale
    if causal:
        sq, sk = logits.shape[-2], logits.shape[-1]
        keep = torch.ones((sq, sk), dtype=torch.bool,
                          device=q.device).tril(sk - sq)
        logits = logits.masked_fill(~keep, float("-inf"))
    return torch.einsum("...hqk,...khd->...qhd", softmax(logits), v)


def _block_contrib(q, k, v, scale, mask=None):
    """One K/V block's unnormalized contribution: (max, sumexp,
    weighted V) per query, in the inputs' dtype."""
    logits = torch.einsum("...qhd,...khd->...hqk", q, k) * scale
    if mask is not None:
        logits = logits.masked_fill(~mask, float("-inf"))
    m = logits.amax(dim=-1)
    # fully masked rows: exp(-inf - -inf) would be nan
    m_safe = torch.where(torch.isneginf(m), torch.zeros_like(m), m)
    p = torch.exp(logits - m_safe[..., None])
    if mask is not None:
        p = torch.where(mask, p, torch.zeros_like(p))
    return m_safe, p.sum(dim=-1), torch.einsum("...hqk,...khd->...qhd", p, v)


def _online_merge(acc, new):
    """Merge two partial softmax accumulators (the flash update)."""
    m_a, s_a, o_a = acc
    m_b, s_b, o_b = new
    m = torch.maximum(m_a, m_b)
    ca, cb = torch.exp(m_a - m), torch.exp(m_b - m)
    # coefficients are [..., h, q]; outputs [..., q, h, d]
    return (m, s_a * ca + s_b * cb,
            o_a * ca.transpose(-2, -1)[..., None]
            + o_b * cb.transpose(-2, -1)[..., None])


def blockwise_attention(q, k, v, block_size=512, causal=False, scale=None):
    """Exact attention over q [..., sq, h, d], k/v [..., sk, h, d]
    streaming K/V in blocks of ``block_size`` (a ragged last block is
    zero-padded and masked); the running max, sum and output are f32.
    The causal mask is bottom-right aligned, as :func:`attention`'s."""
    if scale is None:
        scale = attend_scale(q.shape[-1])
    seq_q, seq_k = q.shape[-3], k.shape[-3]
    bs = min(block_size, seq_k)
    pad = (-seq_k) % bs
    if pad:
        widths = [0, 0, 0, 0, 0, pad]           # F.pad: last dims first
        k = torch.nn.functional.pad(k, widths)
        v = torch.nn.functional.pad(v, widths)
    q_pos = torch.arange(seq_q, device=q.device)
    heads = q.shape[-2]
    lead = q.shape[:-3]
    acc = (torch.full(lead + (heads, seq_q), float("-inf"),
                      device=q.device),
           torch.zeros(lead + (heads, seq_q), device=q.device),
           torch.zeros(q.shape[:-1] + (v.shape[-1],), device=q.device))
    for idx in range((seq_k + pad) // bs):
        sl = slice(idx * bs, (idx + 1) * bs)
        k_pos = idx * bs + torch.arange(bs, device=q.device)
        mask = None
        if causal:
            mask = (k_pos < seq_k)[None, None, :] & (
                k_pos[None, None, :]
                <= q_pos[None, :, None] + (seq_k - seq_q))
        elif pad:
            mask = (k_pos < seq_k)[None, None, :].expand(1, seq_q, bs)
        contrib = _block_contrib(q, k[..., sl, :, :], v[..., sl, :, :],
                                 scale, mask)
        acc = _online_merge(acc, tuple(t.float() for t in contrib))
    _, s, o = acc
    denom = torch.clamp(s, min=1e-30).transpose(-2, -1)[..., None]
    return (o / denom).to(q.dtype)
