"""The merge algebra of the split paged-attention kernel
(``veles_tpu_torch/csrc/paged_attend.cu``, ``paged_split_kernel``), on
the CPU, where the kernel cannot run: a test-local emulation splits
each row's live blocks over the ranks of a cluster as the kernel does
(equal shares of the blocks up to the deepest query, or of every block
when a query lies before the table; no row past the deepest query),
takes each rank's (m, l, acc) by the online softmax over tiles of
``plan``'s size, and merges them in rank order (weights exp(m - M) for
the ranks that hold rows).  It must equal ``paged_attend_plain`` and the
JAX kernel in interpret mode at 1e-5 (f32 sums in another order).  The
emulation is a model of the design, not of the compiled kernel: it pins
the algebra the kernel relies on (a split and a rank-ordered merge give
the reference's function, masked ranks included), and it would not see
the kernel drift from it; the card tests (``test_torch_kernels.py``)
and ``chip_smoke.py`` hold the kernel itself.  Also
:func:`~veles_tpu_torch.ops.paged_attend.plan`: the split count from the
shape, a cluster of at most 8, the kernel by shape and alignment."""

import numpy
import pytest
import torch

import jax.numpy as jnp

pytestmark = pytest.mark.torch_port

D, HEADS, BS, NB = 32, 2, 16, 30
TOL = dict(rtol=1e-5, atol=1e-5)
NEG_INF = -1e30


def _online(s, v, m, l, acc):
    """Fold one tile's scores ``s`` [K1, r] and values ``v`` [r, hd]
    into the running (m, l, acc) of the kernel's softmax warps."""
    m_new = torch.maximum(m, s.max(dim=1).values)
    p = torch.exp(s - m_new[:, None])
    alpha = torch.exp(m - m_new)
    return m_new, l * alpha + p.sum(dim=1), acc * alpha[:, None] + p @ v


def split_attend(q, pool_k, pool_v, tables, qpos, heads, scale_k=None,
                 scale_v=None, drop_last=False):
    """The split kernel's function in plain PyTorch (f32), ranks and
    tiles as ``plan`` sets them; ``drop_last`` leaves each row's last
    busy rank out of the merge (a planted fault)."""
    from veles_tpu_torch.ops.paged_attend import attend_scale, plan
    b, k1, d = q.shape
    bs = pool_k.shape[1]
    nt = tables.shape[1]
    hd = d // heads
    how = plan(b, k1, d, heads, bs, nt, pool_k.dtype)
    assert how["kernel"] == "split"
    cluster, tile = how["cluster"], how["tile"]
    kf, vf = pool_k.float(), pool_v.float()
    if scale_k is not None:
        kf = kf * scale_k[..., None]
        vf = vf * scale_v[..., None]
    out = torch.zeros((b, k1, d))
    for r in range(b):
        qp = qpos[r].long()
        minq, maxq = int(qp.min()), int(qp.max())
        live = nt if minq < 0 else min(nt, maxq // bs + 1)
        share = -(-live // cluster)
        rows = kf[tables[r].long()].reshape(nt * bs, d)
        vrows = vf[tables[r].long()].reshape(nt * bs, d)
        for h in range(heads):
            cols = slice(h * hd, (h + 1) * hd)
            qh = q[r, :, cols].float()
            parts = []
            for rank in range(cluster):
                row0 = min(live, rank * share) * bs
                row1 = min(live, (rank + 1) * share) * bs
                if minq >= 0:
                    row1 = min(row1, maxq + 1)
                m = torch.full((k1,), NEG_INF)
                l = torch.zeros(k1)
                acc = torch.zeros((k1, hd))
                for t0 in range(row0, row1, tile):
                    t1 = min(row1, t0 + tile)
                    s = qh @ rows[t0:t1, cols].T * attend_scale(hd)
                    pos = torch.arange(t0, t1)
                    s = torch.where(pos[None, :] <= qp[:, None], s,
                                    torch.full_like(s, NEG_INF))
                    m, l, acc = _online(s, vrows[t0:t1, cols], m, l, acc)
                parts.append((m, l, acc))
            if drop_last:
                busy = [i for i, (_, l, _) in enumerate(parts)
                        if bool((l > 0).any())]
                parts = [p for i, p in enumerate(parts) if i != busy[-1]] \
                    if len(busy) > 1 else parts
            ms = torch.stack([m for m, _, _ in parts])        # [ranks, K1]
            ls = torch.stack([l for _, l, _ in parts])
            big = torch.where(ls > 0, ms, torch.full_like(ms, NEG_INF)) \
                .max(dim=0).values
            w = torch.where(ls > 0, torch.exp(ms - big), torch.zeros_like(ms))
            total = (w * ls).sum(dim=0)
            o = sum(w[i][:, None] * parts[i][2] for i in range(len(parts)))
            out[r, :, cols] = o / torch.clamp(total, min=1e-30)[:, None]
    return out


def _inputs(seed, quant, k1, nt, first):
    """Pools of NB blocks (int8 with per-row scales when ``quant``), a
    [len(first), nt] table of distinct blocks up to each row's deepest
    query (every block for a row before the table), trash block 0 past
    it, and queries at ``first[r] + i``."""
    from veles_tpu.ops.paged_attention import quantize_kv_rows
    rng = numpy.random.default_rng(seed)
    k = rng.standard_normal((NB, BS, D)).astype(numpy.float32)
    v = rng.standard_normal((NB, BS, D)).astype(numpy.float32)
    b = len(first)
    tables = numpy.zeros((b, nt), numpy.int32)
    qpos = numpy.zeros((b, k1), numpy.int32)
    free = list(rng.permutation(numpy.arange(1, NB)))
    for r, p in enumerate(first):
        qpos[r] = p + numpy.arange(k1)
        live = nt if p < 0 else min(nt, (p + k1 - 1) // BS + 1)
        tables[r, :live] = [free.pop() for _ in range(live)]
    pools = {"k": k, "v": v}
    if quant:
        (qk, sk), (qv, sv) = (quantize_kv_rows(jnp.asarray(x))
                              for x in (k, v))
        pools = {"k": numpy.array(qk), "v": numpy.array(qv),
                 "scale_k": numpy.array(sk), "scale_v": numpy.array(sv)}
    q = rng.standard_normal((b, k1, D)).astype(numpy.float32)
    return q, pools, tables, qpos


#: (case, int8 pools, K1, T, first positions of the rows): short rows in
#: a long table (ranks wholly past the deepest query); a row whose
#: queries all lie before its table beside a live row; three queries
#: per row with one at the start of the table; int8 pools with a row
#: ending mid-block
CASES = [("ranks past the query", False, 1, 8, [20, 3, 0]),
         ("all-negative row", False, 1, 3, [-4, 40, 0]),
         ("K1 3", False, 3, 5, [70, 9, 0]),
         ("int8", True, 1, 6, [90, 47, 0])]


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_split_merge_matches_plain_and_pallas(case):
    from veles_tpu.ops.pallas_paged import pallas_paged_attend
    from veles_tpu_torch.ops.paged_attend import paged_attend_plain, plan
    _, quant, k1, nt, first = case
    q, pools, tables, qpos = _inputs(len(first) + k1 + nt, quant, k1, nt,
                                     first)
    scales = {n: pools[n] for n in ("scale_k", "scale_v") if n in pools}
    targs = (torch.as_tensor(q), torch.as_tensor(pools["k"]),
             torch.as_tensor(pools["v"]), torch.as_tensor(tables),
             torch.as_tensor(qpos), HEADS)
    tsc = {n: torch.as_tensor(a) for n, a in scales.items()}
    got = split_attend(*targs, **tsc)
    want = paged_attend_plain(*targs, **tsc)
    ref = numpy.asarray(pallas_paged_attend(
        jnp.asarray(q), jnp.asarray(pools["k"]), jnp.asarray(pools["v"]),
        jnp.asarray(tables), jnp.asarray(qpos), HEADS, interpret=True,
        **{n: jnp.asarray(a) for n, a in scales.items()}))
    numpy.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    numpy.testing.assert_allclose(got.numpy(), ref, **TOL)
    how = plan(len(first), k1, D, HEADS, BS, nt, targs[1].dtype)
    if case[0] == "ranks past the query":
        # 8 ranks for rows of at most 2 live blocks: most ranks are empty
        assert how["cluster"] == 8
    # leaving a busy rank out of the merge moves a row that spans ranks
    bad = split_attend(*targs, **tsc, drop_last=True)
    assert float((bad - want).abs().max()) > 1e-2


def test_all_masked_rank_is_dropped_exactly():
    """A rank whose keys are all masked for a query weighs each of them
    exp(0) = 1 locally (l > 0, m = -1e30); the merge must drop it
    exactly when another rank holds a live key (exp(-1e30 - M) = 0).
    K1 = 2 over 2 blocks in 2 ranks: query 0 at position 3 sees only
    rank 0's keys, query 1 at 20 both ranks'."""
    from veles_tpu_torch.ops.paged_attend import paged_attend_plain
    q, pools, tables, _ = _inputs(4, False, 2, 2, [20, 0])
    qpos = numpy.asarray([[3, 20], [0, 0]], numpy.int32)
    targs = (torch.as_tensor(q), torch.as_tensor(pools["k"]),
             torch.as_tensor(pools["v"]), torch.as_tensor(tables),
             torch.as_tensor(qpos), HEADS)
    got = split_attend(*targs)
    numpy.testing.assert_allclose(got.numpy(),
                                  paged_attend_plain(*targs).numpy(), **TOL)


def test_plan_splits_by_shape():
    from veles_tpu_torch.ops.paged_attend import MAX_CLUSTER, SMS, plan
    i8, bf16, f32 = torch.int8, torch.bfloat16, torch.float32
    # the serving decode step: 8 rows x 8 heads of 128, int8, T 16 / 64
    for nt, tile in ((16, 32), (64, 128)):
        how = plan(8, 1, 1024, 8, 16, nt, i8)
        assert (how["kernel"], how["cluster"], how["tile"]) \
            == ("split", 8, tile)
    # the split count: 4 CTAs per SM over the rows x heads, at most 8
    # ranks and at most one per block of the table
    for b, heads, nt in ((1, 8, 64), (8, 8, 3), (32, 8, 64), (64, 16, 64),
                         (500, 8, 64)):
        how = plan(b, 1, 1024, heads, 16, nt, i8)
        want = max(1, min(MAX_CLUSTER, nt, -(-4 * SMS // (b * heads))))
        assert how["cluster"] == want and 1 <= want <= MAX_CLUSTER
    assert plan(64, 1, 1024, 16, 16, 64, i8)["cluster"] == 1
    # a tile holds at most 32 KB of K and V, and no more than a rank's rows
    assert plan(8, 1, 1024, 8, 16, 64, f32)["tile"] == 32
    assert plan(8, 1, 1024, 8, 16, 8, i8)["tile"] == 16
    # K1 16 and head dims 64 / 256 stay on the split kernel
    for k1, heads, dt in ((16, 8, i8), (5, 8, f32), (16, 4, bf16),
                          (1, 16, i8), (16, 1, f32)):
        assert plan(8, k1, 1024, heads, 16, 16, dt)["kernel"] == "split"
    # the widest head the wrapper takes (1024 f32) with 16 queries fits
    # a CTA's shared memory
    how = plan(8, 16, 4096, 4, 16, 16, f32)
    assert how["kernel"] == "split" and how["smem"] <= 227 * 1024
    # head rows off the 16-byte chunks or misaligned pools go to the
    # column kernel
    assert plan(8, 1, 1000, 8, 16, 16, i8)["kernel"] == "column"
    assert plan(8, 1, 8 * 6, 8, 16, 16, f32)["kernel"] == "column"
    assert plan(8, 1, 1024, 8, 16, 16, i8, aligned=False)["kernel"] \
        == "column"
