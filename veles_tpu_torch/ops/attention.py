"""Single-device attention cores — the port of ``veles_tpu/ops/
attention.py``: :func:`attention` (dense, the plain core ``mha_apply``
takes off the kernel rule and the tests' dense reference) and
:func:`blockwise_attention` (K/V streamed in blocks through an online
softmax, never the full score matrix) and the ring over the ``sp``
mesh axis (:func:`ring_attention`, :func:`ring_attention_sharded`): Q
stays on its position while K/V rotate, merged by the same online
softmax with f32 accumulators."""

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


def ring_attention(qs, ks, vs, causal=False, scale=None, procs=None):
    """Attention with the sequence split over a ring of positions:
    ``qs``/``ks``/``vs`` hold each position's contiguous slice
    [..., seq_shard, h, d] on its device, in sequence order.  K/V
    rotate around the ring (position i sends to i + 1) while each Q
    stays put; the online-softmax accumulator makes the result exact.
    ``causal`` masks by GLOBAL sequence position.  Returns each
    position's output slice, on its device.

    With ``procs`` (each position's process) the ring spans a gang's
    processes: another process's entries are None, the shifts between
    processes are hops (``collectives.ring_shift``), and each process
    computes and returns its own positions' slices (None for the
    others).  The ring shifts n - 1 times: the n-th would bring every
    slice home unused."""
    from veles_tpu_torch.parallel.collectives import ring_shift
    n = len(qs)
    mine = [i for i in range(n) if qs[i] is not None]
    if not mine:
        return [None] * n
    if scale is None:
        scale = attend_scale(qs[mine[0]].shape[-1])
    seq_q, seq_k = qs[mine[0]].shape[-3], ks[mine[0]].shape[-3]
    accs = [None] * n
    for i in mine:
        q, v = qs[i], vs[i]
        lead, heads = q.shape[:-3], q.shape[-2]
        accs[i] = (
            torch.full(lead + (heads, seq_q), float("-inf"),
                       device=q.device),
            torch.zeros(lead + (heads, seq_q), device=q.device),
            torch.zeros(q.shape[:-1] + (v.shape[-1],), device=q.device))
    idx = list(range(n))
    for step in range(n):
        for i in mine:
            mask = None
            if causal:
                dev = qs[i].device
                q_pos = i * seq_q + torch.arange(seq_q, device=dev)
                k_pos = idx[i] * seq_k + torch.arange(seq_k, device=dev)
                mask = (k_pos[None, :] <= q_pos[:, None])[None]
            contrib = _block_contrib(qs[i], ks[i], vs[i], scale, mask)
            accs[i] = _online_merge(accs[i],
                                    tuple(t.float() for t in contrib))
        if step < n - 1:
            ks, vs = ring_shift(ks, procs), ring_shift(vs, procs)
            idx = idx[-1:] + idx[:-1]
    out = [None] * n
    for i in mine:
        _, s, o = accs[i]
        denom = torch.clamp(s, min=1e-30).transpose(-2, -1)[..., None]
        out[i] = (o / denom).to(qs[i].dtype)
    return out


def ring_attention_sharded(mesh, q, k, v, axis="sp", causal=False):
    """Split q/k/v [seq, heads, dim] over ``mesh``'s ``axis`` positions
    (the others at index 0), run :func:`ring_attention` and put the
    outputs back together on q's device.  On a mesh across processes
    the process of the ring's first position passes q/k/v and gets the
    output; the ring's other processes pass None and get None."""
    from veles_tpu_torch.parallel.p2p import Route
    ring = mesh.along(0, axis)
    route = Route(mesh, ring[0], ring)
    n = len(ring)

    def split(t):
        parts = torch.chunk(t, n, dim=-3) if t is not None else [None] * n
        return [route.move(c, None, i) for i, c in enumerate(parts)]

    out = ring_attention(split(q), split(k), split(v), causal=causal,
                         procs=route.procs)
    out = [route.move(o, i, None) for i, o in enumerate(out)]
    return torch.cat(out, dim=-3) if route.here() else None
