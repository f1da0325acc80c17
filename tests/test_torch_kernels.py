"""The port's hand-written CUDA kernels held against their plain
PyTorch versions ON THE CARD, at the serving model's width (d=1024,
8 heads, block 16; paged attention also at its split kernel's edges,
bit-equal twice, rows whose queries all lie before their table, the
column kernel for a head row off 16 bytes, and the C entry refusing a
split launch it cannot take, runs of 17 and 32 queries launched in
chunks of 16; a verify pass's logits, and its hidden-state lane,
against the CPU's and against sequential decode steps; tables sharing
their leading
blocks; a warm resubmit through the prefix cache on a chain trained on
the card), at the training shapes of the attention
kernels and odd ones off their tiles (with the backward bit-equal from run to
run, and a head dim they are not built for kept off them), at
AlexNet's LRN shapes and odd ones (each on the variant ``ops.lrn.plan``
names, the backward bit-equal across two runs, an offset view on the
tile kernels), the uniform fill bit for bit, and the general tiled
GEMM (``pallas_matmul``: every kernel variant on the inputs its plan
must send it, int8 ``b``, the fused and unfused epilogues, bit-equal
twice, 16-byte and misaligned views, the timed squares, split_k and
wgmma forced across their crossover); ``generate``'s rescan form
through the FlashAttention forward kernel, a streamed request through
the serving kernels, and the REST server's ``/generate`` (batch and
SSE) through them while its embeddings, beam search and serialized
decode launch none; a MoE chain served through the serving kernels
(one ``int8_gemm`` launch per layer per pass: the expert FFN stays off
the int8 path) and its block's paged step against the CPU's, the RBM's
hidden samples drawn by the uniform fill bit-equal to the CPU's, the
blocked AlexNet stem against the strided one, and the prefetch pipeline
on CUDA tensors (pinned staging, its upload stream and events: batches
a slow step reads equal the synchronous arm's; a narrow AlexNet trained
from ``.npy`` files bit-equal at prefetch 2 and 0); the command line's
AlexNet run bit-equal to the workflow built directly, and the serving
workflow's loop answering ``POST /api`` on CUDA tensors.
The kernels have no CPU mode, so without a CUDA device every test here
skips.  This file imports no jax (the card's machine has none): run it
there with ``python -m pytest tests/test_torch_kernels.py -q``.

Tolerances: bf16 queries/activations 2e-3, f32 1e-5 — both sides
compute in f32, only the order of the sums differs; the attention and
LRN kernels element by element (``_flash_excess``, ``_lrn_excess``)."""

import numpy
import pytest
import torch

pytestmark = pytest.mark.torch_port

D, HEADS, BS = 1024, 8, 16


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _tol(dtype):
    return dict(rtol=2e-3, atol=2e-3) if dtype == torch.bfloat16 \
        else dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("pool", ["int8", "float32", "bfloat16"])
@pytest.mark.parametrize("k1", [1, 5])
def test_paged_attend_kernel_matches_plain(card, pool, k1):
    from veles_tpu_torch.ops import paged_attend as mod
    from veles_tpu_torch.ops.paged_attention import quantize_kv_rows
    rng = numpy.random.default_rng(11 + k1)
    nb, b, t = 40, 4, 8
    qdt = torch.float32 if pool == "float32" else torch.bfloat16
    q = torch.as_tensor(rng.standard_normal((b, k1, D)),
                        dtype=qdt).to(card)
    tables = numpy.zeros((b, t), numpy.int32)
    tables[:3, :4] = rng.permutation(numpy.arange(1, nb))[:12].reshape(3, 4)
    qpos = (numpy.asarray([58, 33, 7, 0])[:, None]
            + numpy.arange(k1)[None, :]).astype(numpy.int32)
    qpos[3] = 0                      # an all-trash padding row
    kv = [torch.as_tensor(rng.standard_normal((nb, BS, D)),
                          dtype=torch.float32) for _ in range(2)]
    scales = {}
    if pool == "int8":
        (kq, ks), (vq, vs) = (quantize_kv_rows(x) for x in kv)
        kv = [kq, vq]
        scales = dict(scale_k=ks.to(card), scale_v=vs.to(card))
    else:
        kv = [x.to(getattr(torch, pool)) for x in kv]
    args = (q, kv[0].to(card), kv[1].to(card),
            torch.as_tensor(tables).to(card), torch.as_tensor(qpos).to(card),
            HEADS)
    before = mod.launches
    got = mod.paged_attend(*args, **scales)
    want = mod.paged_attend_plain(*args, **scales)
    torch.cuda.synchronize()
    assert mod.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == (b, k1, D)
    torch.testing.assert_close(got, want, **_tol(qdt))


@pytest.mark.parametrize("k1", [1, 5])
def test_paged_attend_tp_shard(card, k1):
    """Kernel 1 at a tp=2 shard of the serving chain: 4 heads of 128 over
    a 512-column int8 pool whose row scales are those of the WHOLE
    1024-column rows (the tp pools' replicated scales): the split
    kernel, against its plain version, bit-equal twice."""
    from veles_tpu_torch.ops import paged_attend as mod
    from veles_tpu_torch.ops.paged_attention import quantize_kv_rows
    rng = numpy.random.default_rng(21 + k1)
    nb, b, t, half = 40, 4, 8, D // 2
    q = torch.as_tensor(rng.standard_normal((b, k1, half)),
                        dtype=torch.bfloat16).to(card)
    tables = numpy.zeros((b, t), numpy.int32)
    tables[:3, :4] = rng.permutation(numpy.arange(1, nb))[:12].reshape(3, 4)
    qpos = (numpy.asarray([58, 33, 7, 0])[:, None]
            + numpy.arange(k1)[None, :]).astype(numpy.int32)
    qpos[3] = 0
    whole = [torch.as_tensor(rng.standard_normal((nb, BS, D)),
                             dtype=torch.float32) for _ in range(2)]
    (kq, ks), (vq, vs) = (quantize_kv_rows(x) for x in whole)
    shard = [x[..., half:].contiguous().to(card) for x in (kq, vq)]
    args = (q, shard[0], shard[1], torch.as_tensor(tables).to(card),
            torch.as_tensor(qpos).to(card), HEADS // 2)
    scales = dict(scale_k=ks.to(card), scale_v=vs.to(card))
    how = mod.plan(b, k1, half, HEADS // 2, BS, t, torch.int8)
    assert how["kernel"] == "split"
    before = dict(mod.variant_launches)
    got = mod.paged_attend(*args, **scales)
    again = mod.paged_attend(*args, **scales)
    want = mod.paged_attend_plain(*args, **scales)
    torch.cuda.synchronize()
    assert mod.variant_launches["split"] == before["split"] + 2
    assert torch.equal(got, again) and got.shape == (b, k1, half)
    torch.testing.assert_close(got, want, **_tol(torch.bfloat16))


def _paged_inputs(card, pool, k1, hd, nt, first, seed, nb=None):
    """q [B, k1, D] at positions ``first[r] + i`` (a negative first
    position puts every query of the row before the table; 0 is a
    padding row on the trash block); each row owns distinct blocks up to
    its deepest query (all ``nt`` for a negative row), trash past it."""
    from veles_tpu_torch.ops.paged_attention import quantize_kv_rows
    rng = numpy.random.default_rng(seed)
    b = len(first)
    nb = nb or b * nt + 1
    qdt = torch.float32 if pool == "float32" else torch.bfloat16
    q = torch.as_tensor(rng.standard_normal((b, k1, D)), dtype=qdt).to(card)
    tables = numpy.zeros((b, nt), numpy.int32)
    qpos = numpy.zeros((b, k1), numpy.int32)
    free = list(rng.permutation(numpy.arange(1, nb)))
    for r, p in enumerate(first):
        qpos[r] = p + numpy.arange(k1)
        if p == 0 and r == b - 1:
            qpos[r] = 0                  # the padding row
            continue
        live = nt if p < 0 else (p + k1 - 1) // BS + 1
        tables[r, :live] = [free.pop() for _ in range(live)]
    kv = [torch.as_tensor(rng.standard_normal((nb, BS, D)),
                          dtype=torch.float32) for _ in range(2)]
    scales = {}
    if pool == "int8":
        (kq, ks), (vq, vs) = (quantize_kv_rows(x) for x in kv)
        kv = [kq, vq]
        scales = dict(scale_k=ks.to(card), scale_v=vs.to(card))
    else:
        kv = [x.to(getattr(torch, pool)) for x in kv]
    args = (q, kv[0].to(card), kv[1].to(card),
            torch.as_tensor(tables).to(card), torch.as_tensor(qpos).to(card),
            D // hd)
    return args, scales


#: (case, pool, k1, hd, nt, first positions of the rows) at the split
#: kernel's edges, each row set ending in a padding row: one live block;
#: exactly one block per rank (nt 8, cluster 8); fewer live blocks than
#: ranks; nt 13, not a multiple of the cluster (the last rank's share
#: short, one rank empty); T 64 full (the serving window); then K1 5, 9
#: (a verify pass at spec_k 8, at the window's end) and 16, f32 and bf16
#: pools, head dims 64 and 256
PAGED_EDGES = [("live 1", "int8", 1, 128, 16, [3, 15, 0]),
               ("one block per rank", "int8", 1, 128, 8, [127, 113, 0]),
               ("fewer than the ranks", "int8", 1, 128, 16, [40, 70, 0]),
               ("nt 13", "int8", 1, 128, 13, [207, 150, 0]),
               ("T 64 full", "int8", 1, 128, 64, [1023, 960, 0]),
               ("K1 5", "int8", 5, 128, 16, [200, 33, 0]),
               ("K1 9 T 64", "int8", 9, 128, 64, [1015, 500, 0]),
               ("K1 16", "int8", 16, 128, 16, [240, 7, 0]),
               ("f32 K1 5", "float32", 5, 128, 13, [190, 60, 0]),
               ("bf16", "bfloat16", 1, 128, 16, [250, 100, 0]),
               ("hd 64", "int8", 1, 64, 16, [255, 17, 0]),
               ("hd 256 f32", "float32", 1, 256, 16, [130, 31, 0]),
               ("hd 256 K1 16", "bfloat16", 16, 256, 13, [180, 0, 0])]


@pytest.mark.parametrize("case", PAGED_EDGES, ids=lambda c: c[0])
def test_paged_attend_split_edges(card, case):
    """Each edge case on the kernel :func:`plan` names (the split kernel
    for all of these), against the plain version, bit-equal twice."""
    from veles_tpu_torch.ops import paged_attend as mod
    _, pool, k1, hd, nt, first = case
    args, scales = _paged_inputs(card, pool, k1, hd, nt, first, nt + k1)
    how = mod.plan(len(first), k1, D, D // hd, BS, nt, args[1].dtype)
    assert how["kernel"] == "split"
    before = dict(mod.variant_launches)
    got = mod.paged_attend(*args, **scales)
    again = mod.paged_attend(*args, **scales)
    want = mod.paged_attend_plain(*args, **scales)
    torch.cuda.synchronize()
    assert mod.variant_launches["split"] == before["split"] + 2
    assert torch.equal(got, again)
    torch.testing.assert_close(got, want, **_tol(args[0].dtype))


@pytest.mark.parametrize("pool,k1", [("int8", 17), ("int8", 32),
                                     ("bfloat16", 17), ("float32", 32)])
def test_paged_attend_past_16_queries(card, pool, k1):
    """A run wider than one launch's 16 queries (a verify pass past 15
    drafts, the quality gate's block-wide passes) launches once per
    chunk of 16 queries and matches the plain version, bit-equal
    twice."""
    from veles_tpu_torch.ops import paged_attend as mod
    args, scales = _paged_inputs(card, pool, k1, 128, 16, [200, 40, 0], k1)
    before = mod.launches
    got = mod.paged_attend(*args, **scales)
    again = mod.paged_attend(*args, **scales)
    want = mod.paged_attend_plain(*args, **scales)
    torch.cuda.synchronize()
    assert mod.launches == before + 2 * -(-k1 // mod.MAX_K1)
    assert got.shape == (3, k1, D) and torch.equal(got, again)
    torch.testing.assert_close(got, want, **_tol(args[0].dtype))


def test_verify_hidden_lane_on_the_card(card):
    """The hidden-state lane of a verify pass at K1 5 over int8 pools
    with ``int8_decode``: the card's [B, K1, d] hidden states within
    1e-3 of the CPU's, left on the card, and its tokens those of the
    pass without the lane."""
    import copy
    from veles_tpu_torch.convert import init_params
    from veles_tpu_torch.serving import PagedKVCache, prefill
    from veles_tpu_torch.serving.engine import verify_step_paged
    spec = [{"type": "embedding", "vocab": 512, "dim": 256}]
    spec += [{"type": "transformer_block", "heads": 2, "int8_decode": True}
             for _ in range(2)]
    spec += [{"type": "token_logits", "vocab": 512}]
    rng = numpy.random.default_rng(5)
    prompts = [rng.integers(0, 512, (1, n)) for n in (40, 23)]
    toks = rng.integers(0, 512, (2, 5))
    pos, lens = numpy.asarray([40, 23]), numpy.asarray([5, 3])
    zf, zi = numpy.zeros(2, numpy.float32), numpy.zeros(2, numpy.int32)
    seeds = numpy.asarray([1, 2], numpy.uint32)
    hid = {}
    for d in ("cpu", card):
        chain = init_params(spec, 3, 128, device=d, dtype="float32")
        cache = PagedKVCache(chain, 2, 128, block_size=BS, kv_dtype="int8")
        slots = [cache.alloc(64) for _ in prompts]
        for slot, p in zip(slots, prompts):
            cache.insert(slot, prefill(chain, p, window=64)[0], p.shape[1])
        tables = cache.table_rows(slots, 4)
        twin = copy.copy(cache)
        twin.pools = {i: {n: t.clone() for n, t in pool.items()}
                      for i, pool in cache.pools.items()}
        nxt, h = verify_step_paged(chain, cache, toks, pos, lens, tables,
                                   zf, zi, seeds, zi, want_hidden=True)
        plain = verify_step_paged(chain, twin, toks, pos, lens, tables, zf,
                                  zi, seeds, zi)
        assert h.device.type == torch.device(d).type
        assert h.shape == (2, 5, 256) and h.dtype == torch.float32
        assert numpy.array_equal(nxt, plain)
        hid[str(d)] = h.cpu()
    for n in range(2):
        torch.testing.assert_close(hid["cuda"][n, :lens[n]],
                                   hid["cpu"][n, :lens[n]], rtol=1e-3,
                                   atol=1e-3)


@pytest.mark.parametrize("kind", ["int8", "fused"])
def test_verify_logits_on_the_card(card, kind):
    """A verify pass at K1 5 over two rows (5 and 3 real positions) of a
    small f32 chain with ``int8_decode``: the card's logits within 1e-3
    of the CPU's and of 5 sequential decode steps on the card, through
    the kernels — int8 pools, or f32 pools with the single-pass verify
    (the paged-attention kernel over the post-scatter pool)."""
    import copy
    from veles_tpu_torch.convert import init_params
    from veles_tpu_torch.ops import gemm, paged_attend as pa
    from veles_tpu_torch.serving import (
        PagedKVCache, paged_decode_logits, prefill, verify_logits)
    spec = [{"type": "embedding", "vocab": 512, "dim": 256}]
    spec += [{"type": "transformer_block", "heads": 2, "int8_decode": True}
             for _ in range(2)]
    spec += [{"type": "token_logits", "vocab": 512}]
    rng = numpy.random.default_rng(2)
    prompts = [rng.integers(0, 512, (1, n)) for n in (40, 23)]
    toks = rng.integers(0, 512, (2, 5))
    pos, lens = numpy.asarray([40, 23]), numpy.asarray([5, 3])
    valid = [(n, j) for n in range(2) for j in range(lens[n])]
    kv_dtype = "int8" if kind == "int8" else "fp32"
    got = {}
    for d in ("cpu", card):
        chain = init_params(spec, 3, 128, device=d, dtype="float32")
        cache = PagedKVCache(chain, 2, 128, block_size=BS, kv_dtype=kv_dtype)
        slots = [cache.alloc(64) for _ in prompts]
        for slot, p in zip(slots, prompts):
            cache.insert(slot, prefill(chain, p, window=64)[0], p.shape[1])
        tables = cache.table_rows(slots, 4)
        twin = copy.copy(cache)
        twin.pools = {i: {n: t.clone() for n, t in pool.items()}
                      for i, pool in cache.pools.items()}
        before = (pa.launches, gemm.launches)
        got[str(d)] = verify_logits(chain, cache, toks, pos, lens, tables,
                                    fused_verify=kind == "fused").cpu()
        launched = (pa.launches - before[0], gemm.launches - before[1])
    assert launched == (2, 6)
    steps = torch.zeros_like(got["cuda"])
    for j in range(5):
        rows = [n for n in range(2) if j < lens[n]]
        out = paged_decode_logits(chain, twin, toks[rows, j:j + 1],
                                  pos[rows] + j, tables[rows]).cpu()
        for r, n in enumerate(rows):
            steps[n, j] = out[r]
    card_, cpu, seq = (torch.stack([x[n, j] for n, j in valid])
                       for x in (got["cuda"], got["cpu"], steps))
    assert torch.isfinite(card_).all()
    torch.testing.assert_close(card_, cpu, rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(card_, seq, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("k1", [1, 3])
def test_paged_attend_all_negative_row(card, k1):
    """A row whose queries all lie before the table masks every key: its
    context is the mean of all T*bs V rows (3 distinct blocks), as in the
    plain version and the TPU kernel, not of its first block's."""
    from veles_tpu_torch.ops import paged_attend as mod
    args, scales = _paged_inputs(card, "int8", k1, 128, 3, [-5 - k1, 20, 0],
                                 7)
    got = mod.paged_attend(*args, **scales)
    want = mod.paged_attend_plain(*args, **scales)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **_tol(args[0].dtype))


def test_paged_attend_column_kernel_on_the_card(card):
    """A head row off the 16-byte chunks (hd 125, int8) takes the column
    kernel, all-negative row included."""
    from veles_tpu_torch.ops import paged_attend as mod
    from veles_tpu_torch.ops.paged_attention import quantize_kv_rows
    rng = numpy.random.default_rng(5)
    d, heads, b, nt, nb = 1000, 8, 3, 4, 16
    q = torch.as_tensor(rng.standard_normal((b, 2, d)),
                        dtype=torch.bfloat16).to(card)
    (kq, ks), (vq, vs) = (quantize_kv_rows(torch.as_tensor(
        rng.standard_normal((nb, BS, d)), dtype=torch.float32).to(card))
        for _ in range(2))
    tables = torch.as_tensor([[1, 2, 3, 4], [5, 6, 0, 0], [7, 8, 9, 10]],
                             dtype=torch.int32).to(card)
    qpos = torch.as_tensor([[60, 61], [17, 18], [-3, -2]],
                           dtype=torch.int32).to(card)
    assert mod.plan(b, 2, d, heads, BS, nt, torch.int8)["kernel"] == "column"
    before = mod.variant_launches["column"]
    got = mod.paged_attend(q, kq, vq, tables, qpos, heads, scale_k=ks,
                           scale_v=vs)
    want = mod.paged_attend_plain(q, kq, vq, tables, qpos, heads,
                                  scale_k=ks, scale_v=vs)
    torch.cuda.synchronize()
    assert mod.variant_launches["column"] == before + 1
    torch.testing.assert_close(got, want, **_tol(torch.bfloat16))


@pytest.mark.parametrize("pool", ["int8", "bfloat16"])
def test_paged_attend_offset_view_takes_the_column_kernel(card, pool):
    """Pools passed as views one element off the 16-byte boundary take
    the column kernel, a row part before its table (positions -1, 0, 1)
    and an all-negative row included, bit-equal twice."""
    from veles_tpu_torch.ops import paged_attend as mod
    args, scales = _paged_inputs(card, pool, 3, 128, 16, [130, -1, -9, 0],
                                 11)
    views = []
    for pool_t in args[1:3]:
        flat = torch.empty(pool_t.numel() + 1, dtype=pool_t.dtype,
                           device=card)
        views.append(flat[1:].view(pool_t.shape))
        views[-1].copy_(pool_t)
    args = (args[0], *views, *args[3:])
    assert mod.plan(4, 3, D, HEADS, BS, 16, views[0].dtype,
                    False)["kernel"] == "column"
    before = mod.variant_launches["column"]
    got = mod.paged_attend(*args, **scales)
    again = mod.paged_attend(*args, **scales)
    want = mod.paged_attend_plain(*args, **scales)
    torch.cuda.synchronize()
    assert mod.variant_launches["column"] == before + 2
    assert torch.equal(got, again)
    torch.testing.assert_close(got, want, **_tol(args[0].dtype))


def test_paged_attend_split_entry_refuses(card):
    """The C entry refuses (-2) a split launch it cannot take — a head
    row off the 16-byte chunks, a misaligned pool, a cluster past 8 —
    and never switches to the column kernel itself."""
    from veles_tpu_torch.ops import DTYPE_CODES, ptr, stream_ptr
    from veles_tpu_torch.ops import paged_attend as mod
    q = torch.zeros((1, 1, D), device=card)
    pool = torch.zeros((3, BS, D + 16), dtype=torch.int8, device=card)
    scale = torch.ones((3, BS), device=card)
    tables = torch.zeros((1, 2), dtype=torch.int32, device=card)
    qpos = torch.zeros((1, 1), dtype=torch.int32, device=card)
    out = torch.empty((1, 1, D), device=card)
    lib = mod._lib()

    def launch(pk, d, heads, cluster):
        return lib.veles_paged_attend(
            ptr(q), DTYPE_CODES[torch.float32], ptr(pk), ptr(pk),
            DTYPE_CODES[torch.int8], ptr(scale), ptr(scale), ptr(tables),
            ptr(qpos), ptr(out), 1, 1, d, heads, BS, 2, 1.0, 1, cluster,
            16, stream_ptr(card))

    before = dict(mod.variant_launches)
    assert launch(pool, D, HEADS, 2) == 0
    assert launch(pool, 1000, 8, 2) == -2           # hd 125
    assert launch(pool.view(-1)[1:], D, HEADS, 2) == -2   # misaligned
    assert launch(pool, D, HEADS, 9) == -2
    torch.cuda.synchronize()
    assert mod.variant_launches == before           # the C entry's own


#: (k, n): the serving model's three decode GEMMs (wo, ffn_w1, ffn_w2),
#: then ragged ones: n off the 64-column tiles and the 8-byte loads
#: (70, 1001, 6), k off the 16-row steps and the cluster's chunks
INT8_SHAPES = [(1024, 1024), (1024, 4096), (4096, 1024), (100, 70),
               (1000, 1001), (1000, 6)]


def _int8_inputs(card, m, k, n, dtype, seed):
    """Activations N(0, 1); weights N(0, 0.3) in bf16 and N(0, 0.02) in
    f32, the serving model's scale: outputs of ~0.6, whose f32 sums
    taken in another order stay within 1e-5 (at ~10, a 1e-5 limit is a
    few ulps of a 1000-term sum)."""
    from veles_tpu_torch.ops import gemm
    rng = numpy.random.default_rng(seed)
    a = torch.as_tensor(rng.standard_normal((m, k)), dtype=dtype).to(card)
    std = 0.3 if dtype == torch.bfloat16 else 0.02
    wq, scale = gemm.int8_weight_quantize(
        torch.as_tensor(rng.standard_normal((k, n)) * std,
                        dtype=torch.float32).to(card))
    return a, wq, scale


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("m", [1, 2, 3, 8, 13, 40, 136])
@pytest.mark.parametrize("k,n", INT8_SHAPES)
def test_int8_gemm_kernel_matches_plain(card, m, k, n, dtype):
    from veles_tpu_torch.ops import gemm
    a, wq, scale = _int8_inputs(card, m, k, n, dtype, m + n)
    before = gemm.launches
    got = gemm.int8_matmul(a, wq, scale)
    want = gemm.int8_matmul_plain(a, wq, scale)
    torch.cuda.synchronize()
    assert gemm.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == (m, n)
    torch.testing.assert_close(got, want, **_tol(dtype))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_int8_gemm_is_deterministic(card, dtype):
    """No atomics: the split-K sums meet in a fixed order, so two runs
    are bit-equal (ffn_w2's shape: the largest cluster, the most k)."""
    from veles_tpu_torch.ops import gemm
    a, wq, scale = _int8_inputs(card, 8, 4096, 1024, dtype, 3)
    first = gemm.int8_matmul(a, wq, scale)
    second = gemm.int8_matmul(a, wq, scale)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


#: pallas_matmul on the card: (m, k, n, a dtype, b — True: int8 with
#: col_scale, "scaled": a's type with col_scale, False: a's type —,
#: epilogue, out dtype, the variant its plan must name) — every kernel
#: variant: the register-staged kernels on what the new ones refuse
#: (int8 b, k off 8), shapes that tile only by min(block, dim), int8 b, a
#: bf16 output, the serving widths and the large tiles; then the new
#: variants' edges:
#: wgmma at m one past / short of its 128 rows, n and k 8 past / short of
#: its tiles at its 64-, 128- and 256-column tiles, one k-tile; split_k at
#: the serving rows, k and n off its steps and columns, one k16 step, n
#: under 64; simt_pipe past / short of its tiles and stages, one stage;
#: each with a bf16 output under ReLU and col_scale; and the squares the
#: smoke times (wgmma's persistent CTAs walking several tiles each)
MM_CARD = [
    (128, 256, 128, torch.float32, False, None, torch.float32, "simt_pipe"),
    (128, 128, 128, torch.float32, False, "relu", torch.float32,
     "simt_pipe"),
    (8, 64, 128, torch.float32, False, None, torch.float32, "simt_pipe"),
    (100, 50, 64, torch.float32, False, None, torch.float32, "simt_pipe"),
    (100, 50, 72, torch.bfloat16, True, "relu", torch.float32, "tc_small"),
    (64, 128, 96, torch.bfloat16, False, None, torch.bfloat16, "wgmma"),
    (8, 1024, 4096, torch.bfloat16, False, None, torch.float32, "split_k"),
    (72, 1024, 4096, torch.bfloat16, True, None, torch.float32, "tc_small"),
    (512, 384, 512, torch.bfloat16, False, torch.relu, torch.float32,
     "wgmma"),
    (256, 258, 256, torch.float32, True, None, torch.bfloat16, "simt_big"),
    (256, 500, 512, torch.bfloat16, False, torch.tanh, torch.bfloat16,
     "tc_big"),
    (129, 136, 264, torch.bfloat16, False, None, torch.float32, "wgmma"),
    (127, 120, 248, torch.bfloat16, False, None, torch.float32, "wgmma"),
    (1023, 1016, 2040, torch.bfloat16, False, None, torch.float32, "wgmma"),
    (1537, 520, 2824, torch.bfloat16, False, None, torch.float32, "wgmma"),
    (256, 64, 512, torch.bfloat16, False, None, torch.float32, "wgmma"),
    (384, 256, 512, torch.bfloat16, "scaled", "relu", torch.bfloat16,
     "wgmma"),
    (72, 1024, 4096, torch.bfloat16, False, None, torch.float32, "wgmma"),
    (136, 1024, 4096, torch.bfloat16, False, None, torch.float32, "wgmma"),
    (1, 1024, 4096, torch.bfloat16, False, None, torch.float32, "split_k"),
    (9, 1024, 4096, torch.bfloat16, False, None, torch.float32, "split_k"),
    (16, 1024, 4096, torch.bfloat16, False, None, torch.float32, "split_k"),
    (8, 1032, 4104, torch.bfloat16, False, None, torch.float32, "split_k"),
    (9, 1016, 4088, torch.bfloat16, False, None, torch.float32, "split_k"),
    (8, 16, 4096, torch.bfloat16, False, None, torch.float32, "split_k"),
    (100, 72, 56, torch.bfloat16, False, None, torch.float32, "split_k"),
    (8, 1024, 4096, torch.bfloat16, "scaled", "relu", torch.bfloat16,
     "split_k"),
    (257, 264, 264, torch.float32, False, None, torch.float32, "simt_pipe"),
    (255, 248, 248, torch.float32, False, None, torch.float32, "simt_pipe"),
    (64, 16, 128, torch.float32, False, None, torch.float32, "simt_pipe"),
    (8, 1024, 4096, torch.float32, False, None, torch.float32, "simt_pipe"),
    (256, 128, 256, torch.float32, "scaled", "relu", torch.bfloat16,
     "simt_pipe"),
    (4096, 4096, 4096, torch.bfloat16, False, None, torch.float32, "wgmma"),
    (2048, 2048, 2048, torch.float32, False, None, torch.float32,
     "simt_pipe"),
]


def _mm_card_inputs(card, m, k, n, dtype, int8_b, seed, offset=0):
    """a, b and col_scale (None unless ``int8_b`` is True — int8 b — or
    "scaled"); with ``offset``, both operands lie that many elements into
    their buffers."""
    rng = numpy.random.default_rng(seed)
    a = torch.as_tensor(rng.standard_normal((m, k)),
                        dtype=torch.float32).to(card, dtype)
    if int8_b is True:
        b = torch.as_tensor(rng.integers(-127, 128, (k, n)),
                            dtype=torch.int8).to(card)
    else:
        b = torch.as_tensor(rng.standard_normal((k, n)),
                            dtype=torch.float32).to(card, dtype)
    scale = None if int8_b is False else torch.as_tensor(
        rng.random(n) * 0.01, dtype=torch.float32).to(card)
    if offset:
        a, b = (_offset(x, offset) for x in (a, b))
    return a, b, scale


def _offset(x, offset):
    flat = torch.empty(x.numel() + offset, dtype=x.dtype, device=x.device)
    view = flat[offset:].view(x.shape)
    view.copy_(x)
    return view


def _mm_close(got, want, out_dtype):
    """1e-5 of the largest magnitude (sums in another order), plus one
    bf16 step of the element for a bf16 output."""
    got, want = got.float(), want.float()
    floor = 1e-5 * float(want.abs().max())
    step = 2.0 ** -7 if out_dtype == torch.bfloat16 else 0.0
    return bool(((got - want).abs() <= step * want.abs() + floor).all())


@pytest.mark.parametrize("case", MM_CARD, ids=lambda c: "%dx%dx%d-%s%s-%s-%s"
                         % (c[0], c[1], c[2], str(c[3])[6:],
                            {True: "-int8", "scaled": "-scaled"}.get(c[4],
                                                                     ""),
                            getattr(c[5], "__name__", c[5]),
                            str(c[6])[6:]))
def test_pallas_matmul_kernel_matches_plain(card, case):
    from veles_tpu_torch.ops import gemm
    m, k, n, dtype, int8_b, epilogue, out_dtype, variant = case
    a, b, scale = _mm_card_inputs(card, m, k, n, dtype, int8_b, m + k + n)
    assert gemm.matmul_plan(a, b)["variant"] == variant
    kw = dict(block_m=m, block_n=n, block_k=k, epilogue=epilogue,
              out_dtype=out_dtype, col_scale=scale)
    before = gemm.matmul_launches
    got = gemm.pallas_matmul(a, b, **kw)
    want = gemm.pallas_matmul_plain(a, b, **kw)
    torch.cuda.synchronize()
    assert gemm.matmul_launches == before + 1
    assert got.dtype == out_dtype and got.shape == (m, n)
    assert _mm_close(got, want, out_dtype)


#: (id, m, k, n, dtype, variant, variant of a view 16 bytes into its
#: buffer, element offset off 16 bytes, variant of that view)
MM_VIEWS = [
    ("bf16", 256, 512, 256, torch.bfloat16, "wgmma", 8, "tc_big"),
    ("f32", 256, 512, 256, torch.float32, "simt_pipe", 4, "simt_big"),
    ("bf16-split_k", 8, 1024, 4096, torch.bfloat16, "split_k", 8,
     "tc_small"),
    ("f32-small", 8, 1024, 4096, torch.float32, "simt_pipe", 4,
     "simt_small"),
]


@pytest.mark.parametrize("case", MM_VIEWS, ids=lambda c: c[0])
def test_pallas_matmul_is_deterministic_and_misaligned_views(card, case):
    """Every element summed in a fixed order: two runs are bit-equal.
    Operands 16 bytes into their buffers stay on the variant and give
    the same bits; one element in, they leave the TMA / cp.async
    variants for the register-staged kernels (element loads) and agree
    with the plain version."""
    from veles_tpu_torch.ops import gemm
    _, m, k, n, dtype, variant, offset16, other = case
    a, b, _ = _mm_card_inputs(card, m, k, n, dtype, False, 5)
    a16, b16, _ = _mm_card_inputs(card, m, k, n, dtype, False, 5, offset16)
    a1, b1, _ = _mm_card_inputs(card, m, k, n, dtype, False, 5, 1)
    assert gemm.matmul_plan(a, b)["variant"] == variant
    assert gemm.matmul_plan(a16, b16)["variant"] == variant
    plan1 = gemm.matmul_plan(a1, b1)
    assert plan1["variant"] == other and not plan1["aligned"]
    first = gemm.pallas_matmul(a, b)
    second = gemm.pallas_matmul(a, b)
    third = gemm.pallas_matmul(a16, b16)
    fourth = gemm.pallas_matmul(a1, b1)
    want = gemm.pallas_matmul_plain(a, b)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    assert torch.equal(first, third)
    assert _mm_close(fourth, want, torch.float32)


#: inputs the TMA / cp.async variants refuse, on the register-staged
#: kernel the plan names: (id, m, k, n, a dtype, b int8, variant)
MM_REFUSED = [
    ("bf16-int8-big", 256, 512, 256, torch.bfloat16, True, "tc_big"),
    ("bf16-int8-small", 8, 1024, 4096, torch.bfloat16, True, "tc_small"),
    ("bf16-k-off-8", 64, 100, 128, torch.bfloat16, False, "tc_small"),
    ("bf16-n-off-8", 300, 64, 260, torch.bfloat16, False, "tc_big"),
    ("f32-int8", 256, 512, 256, torch.float32, True, "simt_big"),
    ("f32-n-off-4", 64, 64, 130, torch.float32, False, "simt_small"),
]


@pytest.mark.parametrize("case", MM_REFUSED, ids=lambda c: c[0])
def test_pallas_matmul_refused_inputs_take_the_old_kernels(card, case):
    from veles_tpu_torch.ops import gemm
    _, m, k, n, dtype, int8_b, variant = case
    a, b, scale = _mm_card_inputs(card, m, k, n, dtype, int8_b, 7)
    assert gemm.matmul_plan(a, b)["variant"] == variant
    kw = dict(block_m=m, block_n=n, block_k=k, col_scale=scale)
    got = gemm.pallas_matmul(a, b, **kw)
    want = gemm.pallas_matmul_plain(a, b, **kw)
    torch.cuda.synchronize()
    assert _mm_close(got, want, torch.float32)


@pytest.mark.parametrize("case", [
    ("wgmma", 8, 1024, 4096, "split_k"),
    ("split_k", 72, 1024, 4096, "wgmma"),
    ("split_k-m136", 136, 1024, 4096, "wgmma")], ids=lambda c: c[0])
def test_pallas_matmul_forced_variants_match_plain(card, case):
    """``matmul_variant`` (split_k and wgmma, which the smoke times
    across their crossover): a forced variant on the other side of the
    crossover agrees with the plain version, and operands it refuses
    (f32, a variant that cannot be forced) raise instead of running
    another kernel."""
    from veles_tpu_torch.ops import gemm
    name, m, k, n, planned = case
    variant = name.split("-")[0]
    a, b, _ = _mm_card_inputs(card, m, k, n, torch.bfloat16, False, 9)
    assert gemm.matmul_plan(a, b)["variant"] == planned
    assert gemm.matmul_plan(a, b, variant)["variant"] == variant
    got = gemm.matmul_variant(a, b, variant)
    want = gemm.pallas_matmul_plain(a, b)
    torch.cuda.synchronize()
    assert _mm_close(got, want, torch.float32)
    for x, y, refused in ((a.float(), b.float(), variant),
                          (a, b, "simt_pipe")):
        assert gemm.matmul_plan(x, y, refused)["variant"] is None
        with pytest.raises(RuntimeError, match="forced variant"):
            gemm.matmul_variant(x, y, refused)


def test_pallas_matmul_refuses_on_the_card(card):
    from veles_tpu_torch.ops import gemm
    a = torch.ones((64, 64), device=card)
    with pytest.raises(ValueError, match="tile evenly"):
        gemm.pallas_matmul(a[:60], torch.ones((64, 64), device=card),
                           block_m=32)
    with pytest.raises(ValueError, match="lies on"):
        gemm.pallas_matmul(a, torch.ones((64, 64)))
    with pytest.raises(ValueError, match="out_dtype"):
        gemm.pallas_matmul(a, torch.ones((64, 64), device=card),
                           out_dtype=torch.float16)


def test_wrappers_refuse_what_the_kernels_do_not_take(card):
    from veles_tpu_torch.ops import gemm
    from veles_tpu_torch.ops.paged_attend import paged_attend
    a = torch.zeros((2, 8), device=card)
    with pytest.raises(ValueError):
        gemm.int8_matmul(a, torch.zeros((8, 4), device=card),
                         torch.ones(4, device=card))
    with pytest.raises(ValueError):
        gemm.int8_matmul(a, torch.zeros((8, 4), dtype=torch.int8),
                         torch.ones(4, device=card))
    q = torch.zeros((1, 1, D), device=card)
    pool = torch.zeros((2, BS, D), dtype=torch.int8, device=card)
    tables = torch.zeros((1, 1), dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="scale"):
        paged_attend(q, pool, pool, tables, tables, HEADS)


#: (b, sq, sk, h, d, dtype, causal): the training shape (b 4, s 2048,
#: 16 heads of 128, bf16, causal), then small odd ones — f32, sq != sk,
#: lengths off the 64-row tile, non-causal, the 256-wide variant, and
#: one-row queries or keys; then bf16 off the tensor-core tiles (64-row
#: CTA tiles; key tiles of 64 at hd 128, 32 and 16 at hd 256; dk/dv
#: query tiles of 32 and 16): sq != sk both ways, lengths one past a
#: tile, non-causal, one-row queries and keys
FLASH_CASES = [(4, 2048, 2048, 16, 128, torch.bfloat16, True),
               (2, 100, 77, 3, 128, torch.float32, False),
               (1, 130, 200, 2, 128, torch.float32, True),
               (1, 77, 50, 2, 128, torch.float32, True),
               (2, 65, 65, 1, 256, torch.bfloat16, True),
               (1, 33, 90, 2, 256, torch.float32, False),
               (1, 70, 40, 2, 256, torch.float32, True),
               (3, 1, 1, 2, 128, torch.float32, True),
               (1, 1, 129, 2, 128, torch.bfloat16, False),
               (1, 129, 1, 2, 128, torch.bfloat16, True),
               (2, 100, 77, 3, 128, torch.bfloat16, False),
               (1, 130, 200, 2, 128, torch.bfloat16, True),
               (1, 65, 33, 2, 128, torch.bfloat16, True),
               (1, 33, 65, 2, 128, torch.bfloat16, False),
               (3, 1, 1, 2, 128, torch.bfloat16, True),
               (1, 17, 90, 2, 256, torch.bfloat16, False),
               (1, 70, 33, 2, 256, torch.bfloat16, True),
               (1, 1, 17, 2, 256, torch.bfloat16, True)]


def _flash_excess(got, want):
    """The largest ratio, over the elements, of ``|got - want|`` to
    ``tol * (|want| + rms(want)) + floor``, by ``want``'s type: bf16
    2e-2 and 1e-4 (five half-steps of bf16: P and ds round to bf16 at
    each tile's running max in the kernel, once over the row in the
    plain version), f32 1e-4 and 1e-5 (sums in another order).  The
    floor covers gradients that are rounding noise of both sides (a
    row of one key has ds = 0 but for the order of its sums).  At most
    1 passes."""
    tol, floor = (2e-2, 1e-4) if want.dtype == torch.bfloat16 \
        else (1e-4, 1e-5)
    got, want = got.float(), want.float()
    lim = tol * (want.abs() + want.square().mean().sqrt()) + floor
    return float(((got - want).abs() / lim).max())


@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
def test_flash_attention_kernels_match_plain(card, case):
    from veles_tpu_torch.ops import flash_attention as fa
    b, sq, sk, h, d, dtype, causal = case
    gen = torch.Generator(device="cpu").manual_seed(sq * sk + d)
    q, k, v = (torch.randn((b, s, h, d), generator=gen).to(card, dtype)
               for s in (sq, sk, sk))
    do = torch.randn((b, sq, h, d), generator=gen).to(card, dtype)
    before = dict(fa.launches)
    o, lse = fa.flash_fwd(q, k, v, causal)
    dq, delta = fa.flash_bwd_dq(q, k, v, do, o, lse, causal)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, causal)
    torch.cuda.synchronize()
    assert {n: fa.launches[n] - before[n] for n in before} == {
        n: 1 for n in before}
    want_o, want_lse = fa.flash_fwd_plain(q, k, v, causal)
    want_dq, want_delta = fa.flash_bwd_dq_plain(q, k, v, do, o, lse, causal)
    want_dk, want_dv = fa.flash_bwd_dkv_plain(q, k, v, do, lse, delta,
                                              causal)
    for name, got, ref in (("o", o, want_o), ("lse", lse, want_lse),
                           ("dq", dq, want_dq), ("delta", delta, want_delta),
                           ("dk", dk, want_dk), ("dv", dv, want_dv)):
        assert got.dtype == ref.dtype and got.shape == ref.shape, name
        assert _flash_excess(got, ref) <= 1.0, name


def test_flash_attention_backward_is_deterministic(card):
    """No atomics: two backward passes at the training shapes give
    bit-equal dq, delta, dk and dv."""
    from veles_tpu_torch.ops import flash_attention as fa
    gen = torch.Generator(device="cpu").manual_seed(5)
    q, k, v, do = (torch.randn((4, 2048, 16, 128), generator=gen).to(
        card, torch.bfloat16) for _ in range(4))
    o, lse = fa.flash_fwd(q, k, v, True)
    runs = []
    for _ in range(2):
        dq, delta = fa.flash_bwd_dq(q, k, v, do, o, lse, True)
        runs.append((dq, delta, *fa.flash_bwd_dkv(q, k, v, do, lse, delta,
                                                  True)))
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_head_dim_off_the_kernels_on_the_card(card):
    """hd 384 (d 1536, 4 heads), which JAX's rule sends to its kernel
    on the accelerator: the default core runs (the dense one, no
    ``block_size``) and matches an explicit dense run; an explicit
    ``attn_impl="pallas"`` raises."""
    from veles_tpu_torch.convert import init_params
    spec = [{"type": "attention", "heads": 4, "causal": True}]
    (u,) = init_params(spec, 0, device=card, dtype="bfloat16",
                       in_shape=(24, 1536))
    gen = torch.Generator(device="cpu").manual_seed(6)
    x = torch.randn((2, 24, 1536), generator=gen).to(card, torch.bfloat16)
    y = u.apply(x)
    u.attn_impl = "dense"
    want = u.apply(x)
    torch.cuda.synchronize()
    assert torch.isfinite(y.float()).all() and torch.equal(y, want)
    u.attn_impl = "pallas"
    with pytest.raises(ValueError, match="head_dim 384 is not built"):
        u.apply(x)


def test_flash_attention_function_on_the_card(card):
    """The autograd Function runs the three kernels, once each."""
    from veles_tpu_torch.ops import flash_attention as fa
    gen = torch.Generator(device="cpu").manual_seed(0)
    q, k, v = (torch.randn((2, 96, 2, 128), generator=gen).to(card)
               .requires_grad_(True) for _ in range(3))
    before = dict(fa.launches)
    fa.flash_attention(q, k, v, causal=True).square().sum().backward()
    torch.cuda.synchronize()
    assert {n: fa.launches[n] - before[n] for n in before} == {
        n: 1 for n in before}
    assert all(torch.isfinite(t.grad).all() for t in (q, k, v))
    with pytest.raises(ValueError, match="head_dim 64 is not built"):
        fa.flash_fwd(*(torch.zeros((1, 4, 1, 64), device=card),) * 3)


#: (shape, dtype, n, beta): AlexNet's two LRN layers at a batch of 8
#: (bf16), then odd float32 ones — 7 channels, an even window, rows that
#: straddle the tile kernel's 2048-element tiles; then the row kernels'
#: edges in both types — one chunk per row (C 8), 33 chunks per row
#: (C 264), an even window, the widest window (17: two halo lanes in the
#: backward), row counts that leave a ragged last warp tile
LRN_CASES = [((8, 55, 55, 96), torch.bfloat16, 5, 0.75),
             ((8, 27, 27, 256), torch.bfloat16, 5, 0.75),
             ((3, 13, 11, 7), torch.float32, 3, 0.5),
             ((2, 9, 96), torch.float32, 4, 0.75),
             ((5, 3, 256), torch.float32, 5, 0.5),
             ((700, 7), torch.float32, 4, 0.5),
             ((5, 7, 8), torch.bfloat16, 4, 0.5),
             ((3, 11, 264), torch.bfloat16, 17, 0.75),
             ((37, 8), torch.float32, 4, 0.75),
             ((7, 13, 264), torch.float32, 17, 0.5),
             ((2, 3, 264), torch.float32, 10, 0.75)]
#: inputs of scale 50 with alpha 1e-4: the window sum (~1.3) is as large
#: as k, so a kernel that sums the wrong window fails the check
LRN_SCALE, LRN_KW = 50.0, dict(alpha=1e-4, k=2.0)


def _lrn_excess(got, want):
    """As :func:`_flash_excess` with LRN's limits: bf16 one step (2**-7)
    of tol, f32 1e-5, floor 1e-7 (both sides round once; f32 differs by
    the card's rsqrt/pow against the CPU's)."""
    tol, floor = (2.0 ** -7, 1e-7) if want.dtype == torch.bfloat16 \
        else (1e-5, 1e-7)
    got, want = got.float(), want.float()
    lim = tol * (want.abs() + want.square().mean().sqrt()) + floor
    return float(((got - want).abs() / lim).max())


@pytest.mark.parametrize("case", LRN_CASES, ids=str)
def test_lrn_kernels_match_plain(card, case):
    from veles_tpu_torch.ops import lrn as mod
    shape, dtype, n, beta = case
    gen = torch.Generator(device="cpu").manual_seed(len(shape) * 100 + n)
    x = (torch.randn(shape, generator=gen) * LRN_SCALE).to(card, dtype)
    dy = torch.randn(shape, generator=gen).to(card, dtype)
    kw = dict(LRN_KW, beta=beta, n=n)
    before = dict(mod.launches)
    kernel = mod.plan(shape, n, dtype, 16)["kernel"]
    before_variant = {k: mod.variant_launches[k][kernel] for k in before}
    y = mod.lrn_fwd(x, **kw)
    dx = mod.lrn_bwd(x, dy, **kw)
    torch.cuda.synchronize()
    assert {k: mod.launches[k] - before[k] for k in before} == {
        "lrn_fwd": 1, "lrn_bwd": 1}
    assert {k: mod.variant_launches[k][kernel] - before_variant[k]
            for k in before} == {"lrn_fwd": 1, "lrn_bwd": 1}
    want_y = mod.lrn_plain(x, **kw)
    want_dx = mod.lrn_bwd_plain(x, dy, **kw)
    for name, got, ref in (("y", y, want_y), ("dx", dx, want_dx)):
        assert got.dtype == ref.dtype and got.shape == ref.shape, name
        assert _lrn_excess(got, ref) <= 1.0, name
    # the window shifted by one channel must fail the same check
    half = n // 2
    s = kw["k"] + kw["alpha"] * mod._window_sum(
        (x * x).float(), half - 1, n - half)
    bad = (x.float() * mod._power(s, beta)).to(dtype)
    assert _lrn_excess(bad, want_y) > 1.0


def test_lrn_backward_bit_equal_twice(card):
    """The row kernels' backward has one writer per element and fixed
    sums: two runs give the same bits."""
    from veles_tpu_torch.ops import lrn as mod
    gen = torch.Generator(device="cpu").manual_seed(17)
    x = (torch.randn((4, 27, 27, 256), generator=gen) * LRN_SCALE).to(
        card, torch.bfloat16)
    dy = torch.randn(x.shape, generator=gen).to(card, torch.bfloat16)
    first = mod.lrn_bwd(x, dy, **LRN_KW)
    second = mod.lrn_bwd(x, dy, **LRN_KW)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_lrn_misaligned_view_takes_the_tile_kernel(card, dtype):
    """``flat[1:]`` of a buffer is contiguous but off the 16-byte
    alignment the row kernels need: the tile kernels take it, and it
    still matches its plain version."""
    from veles_tpu_torch.ops import lrn as mod
    rows, c = 300, 96
    gen = torch.Generator(device="cpu").manual_seed(23)
    buf = (torch.randn(rows * c + 1, generator=gen) * LRN_SCALE).to(
        card, dtype)
    x = buf[1:].view(rows, c)
    dy = torch.randn((rows, c), generator=gen).to(card, dtype)
    assert mod.plan(x.shape, 5, dtype, mod.alignment(x))["kernel"] == "tile"
    before = {k: dict(v) for k, v in mod.variant_launches.items()}
    y = mod.lrn_fwd(x, **LRN_KW)
    dx = mod.lrn_bwd(x, dy, **LRN_KW)
    torch.cuda.synchronize()
    assert {k: mod.variant_launches[k]["tile"] - before[k]["tile"]
            for k in before} == {"lrn_fwd": 1, "lrn_bwd": 1}
    assert _lrn_excess(y, mod.lrn_plain(x, **LRN_KW)) <= 1.0
    assert _lrn_excess(dx, mod.lrn_bwd_plain(x, dy, **LRN_KW)) <= 1.0


def test_lrn_function_and_refusals_on_the_card(card):
    from veles_tpu_torch.ops import lrn as mod
    x = torch.randn((2, 5, 5, 96), device=card).requires_grad_(True)
    before = dict(mod.launches)
    mod.lrn(x).square().sum().backward()
    torch.cuda.synchronize()
    assert {k: mod.launches[k] - before[k] for k in before} == {
        "lrn_fwd": 1, "lrn_bwd": 1}
    assert torch.isfinite(x.grad).all()
    with pytest.raises(ValueError, match="window"):
        mod.lrn_fwd(x.detach(), n=mod.MAX_N + 1)
    with pytest.raises(ValueError, match="dtype"):
        mod.lrn_fwd(x.detach().half())
    with pytest.raises(ValueError):
        mod.lrn_bwd(x.detach(), torch.zeros((2, 5, 5, 96)))


@pytest.mark.parametrize("offset", [0, 2 ** 32 - 1000, 5 * 2 ** 32 + 3])
def test_uniform_fill_bit_equal(card, offset):
    """3,000,001 floats (a ragged last group of 4); the two large
    offsets put the count's high word above 0 inside the draw."""
    from veles_tpu_torch.ops import random as mod
    from veles_tpu_torch.prng import threefry
    k = threefry.fold_in(threefry.key(42), 7)
    n = 3_000_001
    before = mod.launches
    got = mod.uniform_fill(k, (n,), card, offset=offset)
    want = mod.uniform_plain(k.to(card), (n,), offset=offset)
    torch.cuda.synchronize()
    assert mod.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == (n,)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert 0.0 <= float(got.min()) and float(got.max()) < 1.0
    if offset == 0:
        assert torch.equal(mod.uniform(k, (n,), device=card), got)


@pytest.mark.parametrize("pool,k1", [("int8", 1), ("int8", 5),
                                     ("bfloat16", 1)])
def test_paged_attend_shared_leading_blocks(card, pool, k1):
    """A batch whose tables share their leading blocks, as rows
    admitted warm through the prefix cache do (the same 3 resident
    blocks head every live row, each row's own blocks after them, a
    padding row last): the split kernel against the plain version,
    bit-equal twice, and the shared blocks' bytes unchanged."""
    from veles_tpu_torch.ops import paged_attend as mod
    args, scales = _paged_inputs(card, pool, k1, 128, 16,
                                 [100, 170, 60, 0], 31)
    q, pk, pv, tables, qpos, heads = args
    tables = tables.clone()
    tables[:3, :3] = tables[0, :3]          # the shared prefix
    args = (q, pk, pv, tables, qpos, heads)
    shared = tables[0, :3].long()
    before = (pk[shared].clone(), pv[shared].clone())
    assert mod.plan(4, k1, D, heads, BS, 16, pk.dtype)["kernel"] == "split"
    got = mod.paged_attend(*args, **scales)
    again = mod.paged_attend(*args, **scales)
    want = mod.paged_attend_plain(*args, **scales)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    torch.testing.assert_close(got, want, **_tol(q.dtype))
    assert torch.equal(pk[shared], before[0])
    assert torch.equal(pv[shared], before[1])


def _trained_pattern_chain(card):
    """A small LM (d 256, 2 heads of 128, 2 layers, vocab 64, window
    64, f32) trained on the card with Adam to continue a 12-token
    pattern; returns the chain and the pattern."""
    from veles_tpu_torch.loader import FullBatchLoader
    from veles_tpu_torch.samples.lm import build_lm, train_lm
    pattern = (numpy.arange(12) * 5 % 64).tolist()
    tiled = numpy.tile(pattern, 64 // 12 + 2)
    offs = numpy.random.default_rng(0).integers(0, 12, 256)
    data = numpy.stack([tiled[o:o + 64] for o in offs]).astype(numpy.int32)
    loader = FullBatchLoader(data, None, [0, 0, 256], minibatch_size=16,
                             seed=0, device=card)
    lm = build_lm(vocab=64, dim=256, blocks=2, heads=2, seq=64,
                  loader=loader, learning_rate=3e-3, lr_schedule="constant",
                  device=card, dtype="float32")
    train_lm(lm, 6)
    return lm.chain, pattern


def test_warm_resubmit_on_the_card(card):
    """The prefix cache on the card: a trained chain with int8 KV pools,
    ``int8_decode`` and speculative decoding serves a 40-token pattern
    prompt cold, then warm (2 blocks of 16 shared, an 8-token cold tail
    chunk-prefilled over their dequantized rows); both streams follow
    the pattern and equal the prefix-cache-off stream, through kernels 1
    and 2, and the pool is clean after each close."""
    from veles_tpu_torch.ops import gemm, paged_attend as pa
    from veles_tpu_torch.serving import InferenceScheduler
    chain, pattern = _trained_pattern_chain(card)
    for u in chain:
        if hasattr(u, "int8_decode"):
            u.int8_decode = True
    prompt = (pattern * 4)[:40]
    learned = [pattern[(40 + i) % 12] for i in range(20)]
    outs = {}
    for pfx in (False, True):
        sch = InferenceScheduler(chain, max_slots=2, window=64,
                                 block_size=BS, kv_dtype="int8",
                                 prefill_chunk=32, spec_k=4,
                                 prefix_cache=pfx, device=card).start()
        try:
            before = (pa.launches, gemm.launches)
            outs[pfx] = [sch.submit(prompt, 20).result(120)
                         for _ in range(2)]
            launched = (pa.launches - before[0], gemm.launches - before[1])
            hits = sch.prefix_cache_hits
            warm_work = sch.prefill_chunk_tokens
        finally:
            sch.close()
        sch.check_kv()
        assert launched[0] > 0 and launched[1] == 3 * launched[0]
    assert outs[False][0][40:] == learned, "the chain did not learn"
    assert outs[True] == outs[False]
    assert hits == 1
    assert warm_work == 40 + 8       # cold: 32 + 8; warm: the 8-token tail


def _bf16_copies(chain, card):
    """bf16 copies of a trained f32 LM chain, on the card and on the
    CPU (the same weights)."""
    from veles_tpu_torch.convert import params_from_numpy, params_to_numpy
    from veles_tpu_torch.samples.lm import lm_spec
    spec = lm_spec(chain[-1].vocab, chain[0].dim,
                   len(chain) - 2, chain[1].heads)
    params = params_to_numpy(chain)
    return [params_from_numpy(spec, params, device=d, dtype="bfloat16")
            for d in (card, "cpu")]


def test_generate_rescan_on_the_card(card):
    """``generate(kv_cache=False)`` on a trained bf16 chain (head dim
    128): on the card every rescan step runs the FlashAttention
    forward kernel once per layer (8 steps x 2 layers) and nothing of
    kernels 1 and 2; its greedy stream equals the CPU's (the plain
    version), the kv form's on the card (no kernel launch) and the
    pattern."""
    from veles_tpu_torch.models.generate import generate
    from veles_tpu_torch.ops import gemm, paged_attend as pa
    from veles_tpu_torch.ops import flash_attention as fa
    chain, pattern = _trained_pattern_chain(card)
    on_card, on_cpu = _bf16_copies(chain, card)
    prompt = [(pattern * 4)[o:o + 20] for o in (0, 5)]
    before = (fa.launches["flash_attn_fwd"], pa.launches, gemm.launches)
    got = generate(on_card, prompt, 8).cpu()
    torch.cuda.synchronize()
    launched = (fa.launches["flash_attn_fwd"] - before[0],
                pa.launches - before[1], gemm.launches - before[2])
    assert launched == (8 * 2, 0, 0)
    want = generate(on_cpu, prompt, 8)
    assert got.tolist() == want.tolist()
    before = fa.launches["flash_attn_fwd"]
    kv = generate(on_card, prompt, 8, kv_cache=True).cpu()
    assert fa.launches["flash_attn_fwd"] == before
    assert kv.tolist() == got.tolist()
    for n, o in enumerate((0, 5)):
        assert got[n, 20:].tolist() == [pattern[(o + 20 + i) % 12]
                                        for i in range(8)]


def test_streamed_request_runs_the_serving_kernels(card):
    """One streamed request on the card (int8 KV, ``int8_decode``, spec
    off): every decode step launches ``paged_attend`` once per layer
    and ``int8_gemm`` three times, and the iterated tokens equal the
    batch reply's."""
    from veles_tpu_torch.convert import init_params
    from veles_tpu_torch.ops import gemm, paged_attend as pa
    from veles_tpu_torch.serving import InferenceScheduler
    from veles_tpu_torch.samples.lm import lm_spec
    chain = init_params(lm_spec(256, 256, 2, 2, int8_decode=True), 0, 64,
                        device=card, dtype="bfloat16")
    sch = InferenceScheduler(chain, max_slots=2, window=64, block_size=BS,
                             kv_dtype="int8", spec=False, prefix_cache=False,
                             device=card).start()
    try:
        prompt = list(range(3, 40))
        batch = sch.submit(prompt, 12).result(120)
        steps = sch.decode_steps
        before = (pa.launches, gemm.launches)
        ts = sch.submit(prompt, 12, stream=True)
        toks = list(ts)
        steps = sch.decode_steps - steps
        launched = (pa.launches - before[0], gemm.launches - before[1])
    finally:
        sch.close()
    sch.check_kv()
    assert prompt + toks == batch == ts.result(1)
    assert steps == 11 and launched == (2 * steps, 6 * steps)


def _http(port, path, body=None):
    import json
    import urllib.request
    req = urllib.request.Request(
        "http://127.0.0.1:%d%s" % (port, path),
        data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as resp:
        raw = resp.read()
    return raw if body is not None and body.get("stream") \
        else json.loads(raw)


def test_rest_generate_runs_the_serving_kernels(card):
    """The REST server on the card over a trained bf16 chain with int8
    KV pools and ``int8_decode`` (spec on, spec_k 4): ``/generate``'s
    batch and SSE replies equal the scheduler's own results, and every
    model pass (decode or verify) launches ``paged_attend`` once per
    layer, all on its split kernel, and ``int8_gemm`` three times;
    ``/v1/embeddings``, beam search and the serialized decode
    (``serving=False``) launch none of kernels 1-3."""
    import json
    from veles_tpu_torch.models.generate import generate, generate_beam
    from veles_tpu_torch.ops import flash_attention as fa
    from veles_tpu_torch.ops import gemm, paged_attend as pa
    from veles_tpu_torch.restful_api import RESTfulAPI
    chain, pattern = _trained_pattern_chain(card)
    on_card, _ = _bf16_copies(chain, card)
    layers = len(on_card) - 2
    for u in on_card:
        if hasattr(u, "int8_decode"):
            u.int8_decode = True

    def counts():
        return (pa.launches, pa.variant_launches["split"], gemm.launches,
                fa.launches["flash_attn_fwd"])

    prompt = (pattern * 4)[:24]
    api = RESTfulAPI(forwards=on_card, max_slots=2, serving_kv_dtype="int8",
                     serving_block_size=BS, device=card)
    api.initialize()
    try:
        sch = api.scheduler_
        want = sch.submit(prompt, 20).result(300)
        for body in ({"prompt": prompt, "steps": 20},
                     {"prompt": prompt, "steps": 20, "stream": True}):
            passes = sch.decode_steps + sch.verify_steps
            before = counts()
            reply = _http(api.port, "/generate", body)
            torch.cuda.synchronize()
            passes = sch.decode_steps + sch.verify_steps - passes
            got = [b - a for a, b in zip(before, counts())]
            if body.get("stream"):
                frames = [json.loads(line[6:]) for line in reply.split(b"\n")
                          if line.startswith(b"data: {")]
                toks = [f["token"] for f in frames if "token" in f]
                assert prompt + toks == frames[-1]["tokens"] == want
            else:
                assert reply["tokens"] == want
            assert passes > 0
            assert got == [layers * passes, layers * passes,
                           3 * layers * passes, 0]
        before = counts()
        emb = _http(api.port, "/v1/embeddings",
                    {"input": [prompt, prompt[3:]]})
        beam = _http(api.port, "/generate",
                     {"prompt": prompt, "steps": 8, "beam": 2})
        torch.cuda.synchronize()
        assert counts() == before
        assert len(emb["data"]) == 2
        toks, scores = generate_beam(on_card, [prompt], 8, 2)
        assert beam["beams"] == toks[0].tolist()
        numpy.testing.assert_allclose(beam["scores"], scores[0].tolist(),
                                      rtol=0, atol=1e-5)
    finally:
        api.stop()
    legacy = RESTfulAPI(forwards=on_card, serving=False, device=card)
    legacy.initialize()
    try:
        before = counts()
        reply = _http(legacy.port, "/generate",
                      {"prompt": prompt, "steps": 12})
        torch.cuda.synchronize()
        assert counts() == before
        assert reply["tokens"] == generate(on_card, [prompt], 12,
                                           kv_cache=True)[0].tolist()
        assert reply["tokens"] == want[:len(prompt) + 12]
    finally:
        legacy.stop()


def test_moe_chain_serves_through_the_kernels(card):
    """A MoE chain (d 256, 2 heads of 128, 4 experts, top-2; int8 KV and
    ``int8_decode``, spec off) on the card: every decode step launches
    ``paged_attend`` and ``int8_gemm`` once per layer (``wo`` only),
    spec on streams as spec off, and the pool comes back clean."""
    from veles_tpu_torch.convert import init_params
    from veles_tpu_torch.ops import gemm, paged_attend as pa
    from veles_tpu_torch.serving import InferenceScheduler
    from veles_tpu_torch.samples.lm import lm_spec
    chain = init_params(lm_spec(256, 256, 2, 2, int8_decode=True,
                                n_experts=4, top_k=2), 0, 64, device=card,
                        dtype="float32")
    streams = {}
    for spec in (False, True):
        sch = InferenceScheduler(chain, max_slots=2, window=64,
                                 block_size=BS, kv_dtype="int8", spec=spec,
                                 prefix_cache=False, device=card).start()
        try:
            before = (pa.launches, gemm.launches)
            prompt = list(range(3, 40))
            streams[spec] = sch.submit(prompt, 12).result(120)
            passes = sch.decode_steps + sch.verify_steps
            launched = (pa.launches - before[0], gemm.launches - before[1])
        finally:
            sch.close()
        sch.check_kv()
        assert launched == (2 * passes, 2 * passes)
    assert streams[True] == streams[False]


@pytest.mark.parametrize("w8", [False, True])
def test_moe_block_paged_step_on_the_card(card, w8):
    """One MoE block's paged decode step over an int8 pool on the card
    (the kernels) against the same block on the CPU (plain versions),
    float32: within 1e-4."""
    from veles_tpu_torch.convert import init_params
    from veles_tpu_torch.ops.paged_attention import quantize_kv_rows
    spec = [{"type": "transformer_block", "heads": 2, "n_experts": 4,
             "top_k": 2, "int8_decode": w8}]
    blocks = [init_params(spec, 3, device=dev, dtype="float32",
                          in_shape=(16, 256))[0]
              for dev in ("cpu", card)]
    rng = numpy.random.default_rng(9)
    nb = 8
    (kq, ks), (vq, vs) = (quantize_kv_rows(torch.as_tensor(
        rng.standard_normal((nb, BS, 256)), dtype=torch.float32))
        for _ in range(2))
    x = torch.as_tensor(rng.standard_normal((3, 1, 256)) * 0.5,
                        dtype=torch.float32)
    pos = torch.as_tensor([20, 3, 0], dtype=torch.int32)
    tables = torch.as_tensor([[2, 4, 0, 0], [5, 0, 0, 0], [0, 0, 0, 0]],
                             dtype=torch.int32)
    out = []
    for blk in blocks:
        dev = blk.device
        pool = {n: t.clone().to(dev) for n, t in
                (("k", kq), ("v", vq), ("k_scale", ks), ("v_scale", vs))}
        y, _ = blk.apply_step_paged(x.to(dev), pos.to(dev), tables.to(dev),
                                    pool)
        out.append(y.cpu())
    numpy.testing.assert_allclose(out[1][:2].numpy(), out[0][:2].numpy(),
                                  rtol=1e-4, atol=1e-4)


def test_rbm_samples_on_the_card_bit_equal(card):
    """Three CD-1 steps of the RBM on the card, where the uniform fill
    draws the hidden samples, against the CPU: samples bit-equal,
    weights within 1e-5."""
    from veles_tpu_torch.models.rbm import BernoulliRBM
    from veles_tpu_torch.ops import random as ops_random
    rbms = [BernoulliRBM(64, hidden=32, learning_rate=0.5, seed=5,
                         device=dev) for dev in ("cpu", card)]
    rng = numpy.random.default_rng(4)
    for _ in range(3):
        v = torch.as_tensor((rng.random((16, 64)) < 0.4).astype(
            numpy.float32))
        before = ops_random.launches
        for r in rbms:
            r.step(v.to(r.device))
        assert ops_random.launches == before + 1
        assert torch.equal(rbms[0].samples[0], rbms[1].samples[0].cpu())
    numpy.testing.assert_allclose(rbms[1].weights.cpu().numpy(),
                                  rbms[0].weights.numpy(), rtol=1e-5,
                                  atol=1e-5)


def test_s2d_stem_on_the_card(card):
    """AlexNet's blocked 11×11/4 stem on the card (float32, its flat
    pre-blocked input) against the strided stem: within 1e-4."""
    from veles_tpu_torch.models.conv import Conv, space_to_depth
    rng = numpy.random.default_rng(6)
    x = torch.as_tensor(rng.standard_normal((4, 227, 227, 3)),
                        dtype=torch.float32).to(card)
    w = rng.standard_normal((11, 11, 3, 96)).astype(numpy.float32) * 0.05
    b = rng.standard_normal(96).astype(numpy.float32)
    conv = dict(n_kernels=96, kx=11, ky=11, sliding=(4, 4), padding="valid",
                device=card, dtype="float32")
    plain = Conv(**conv)
    s2d = Conv(space_to_depth=4, space_to_depth_hw=(57, 57), **conv)
    for u in (plain, s2d):
        u.load_params({"weights": w, "bias": b})
    y = plain.apply(x)
    yb = s2d.apply(space_to_depth(x, 4).reshape(4, -1))
    numpy.testing.assert_allclose(yb.cpu().numpy(), y.cpu().numpy(),
                                  rtol=1e-4, atol=1e-4)


def _card_stream_loader(card, prefetch, decode_s=0.0):
    """A streaming loader on the card: every minibatch decoded on the
    host (``fill_minibatch``), optionally slowly."""
    import time as _time
    from veles_tpu_torch.loader.base import Loader

    class Stream(Loader):
        def load_data(self):
            self.class_lengths[:] = [0, 64, 448]
            rng = numpy.random.default_rng(0)
            self._base = rng.normal(size=(512, 256, 64)).astype(
                numpy.float32)
            self._lab = (numpy.arange(512) % 5).astype(numpy.int32)

        def create_minibatch_data(self):
            self.minibatch_data.reset(numpy.zeros(
                (self.max_minibatch_size, 256, 64), numpy.float32))

        def fill_minibatch(self):
            if decode_s:
                _time.sleep(decode_s)
            idx = self.minibatch_indices.mem[:self.minibatch_size]
            self.minibatch_data.mem[:self.minibatch_size] = self._base[idx]
            self.minibatch_labels.mem[:self.minibatch_size] = \
                self._lab[idx]

    loader = Stream(None, minibatch_size=64, prefetch=prefetch, seed=3)
    loader.initialize(device=card)
    return loader


def test_prefetch_on_the_card_pinned_stream_and_events(card):
    """The pipeline on the card: pinned staging buffers, copies on its
    own upload stream, and each popped batch on the compute stream's
    side of an event — every batch a slow step reads (a long kernel
    queued before the next pop) equals the synchronous arm's."""
    from veles_tpu_torch.loader.prefetch import PrefetchPipeline
    sync = _card_stream_loader(card, 0)
    pf = _card_stream_loader(card, 3)
    weight = torch.randn(64, 64, device=card)
    outs = {}
    for name, loader in (("sync", sync), ("prefetch", pf)):
        acc = []
        for _ in range(20):
            loader.run()
            x = loader.minibatch_data.devmem
            assert x.device.type == "cuda"
            # a step long enough that the next copies land while it runs
            y = x
            for _ in range(8):
                y = torch.tanh(y @ weight)
            acc.append((y.sum(dim=(1, 2)).cpu(),
                        loader.minibatch_labels.devmem.cpu(),
                        loader.minibatch_class, loader.minibatch_size))
        outs[name] = acc
        loader.stop()
    pipe = pf.prefetch_
    assert pipe is None  # closed by stop()
    for (a, la, ca, sa), (b, lb, cb, sb) in zip(outs["sync"],
                                                outs["prefetch"]):
        assert (ca, sa) == (cb, sb)
        assert torch.equal(a, b) and torch.equal(la, lb)
    probe = _card_stream_loader(card, 2)
    probe.run()
    pipe = probe.prefetch_
    assert isinstance(pipe, PrefetchPipeline)
    assert pipe.stream is not None
    assert pipe.stream != torch.cuda.current_stream(card)
    bufs = pipe._installed.bufs
    assert all(p.is_pinned() for p in bufs.pins)
    assert bufs.data.mem.ctypes.data == bufs.pins[0].data_ptr()
    probe.stop()


def _files_run(card, base, prefetch):
    """2 epochs of a narrow AlexNet (augment and dropout on) over the
    ``.npy`` tree ``base``; returns (parameters, history)."""
    import os
    from veles_tpu_torch.loader.image import FileImageLoader
    from veles_tpu_torch.models.standard import StandardWorkflow
    from veles_tpu_torch.samples.alexnet import alexnet_layers
    wf = StandardWorkflow(
        loader_factory=FileImageLoader, loader_config=dict(
            train_paths=[os.path.join(base, "train")],
            validation_paths=[os.path.join(base, "valid")],
            minibatch_size=32, prefetch=prefetch),
        layers=alexnet_layers(4, 0.5, (8, 16, 24, 24, 16, 32), side=67),
        solver="sgd", learning_rate=0.01, gradient_moment=0.9,
        augment={"kind": "image", "flip": True, "pad": 4, "cutout": 16},
        decision_config={"max_epochs": 2},
        snapshotter_config={"enabled": False}, dtype="float32")
    wf.initialize(device=card)
    wf.run()
    torch.cuda.synchronize()
    wf.stop()
    return ([p.detach().cpu() for u in wf.gd.forwards
             for p in u.params.values()], wf.decision.history)


def test_prefetch_trains_bit_equal_on_the_card(card, tmp_path):
    """A small conv chain with augment and dropout trained through
    ``StandardWorkflow`` from ``.npy`` files on the card: prefetch 2
    bit-equal to prefetch 0 (weights and epoch metrics).  cuDNN runs
    deterministically here: its f32 backward may sum in another order
    from run to run, and the pipeline, not the convolutions, is under
    test."""
    rng = numpy.random.default_rng(1)
    for split, n in (("train", 96), ("valid", 32)):
        for i in range(n):
            d = tmp_path / split / ("c%d" % (i % 4))
            d.mkdir(parents=True, exist_ok=True)
            numpy.save(d / ("%03d.npy" % i),
                       rng.integers(0, 256, (67, 67, 3)).astype(
                           numpy.uint8))
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        (wa, ha), (wb, hb) = (_files_run(card, str(tmp_path), prefetch)
                              for prefetch in (2, 0))
    finally:
        torch.backends.cudnn.deterministic = saved
    assert ha == hb
    assert all(torch.equal(a, b) for a, b in zip(wa, wb))


# -- the command line on the card ---------------------------------------------

def _port_cli(argv, thread=False):
    """``veles_tpu_torch.__main__.Main(argv)`` in process, the port's
    config tree and process-wide generator restored after it (on a
    thread when ``thread``: returns (main, thread, outcome))."""
    import threading
    from veles_tpu_torch import prng
    from veles_tpu_torch.__main__ import Main
    from veles_tpu_torch.config import Config, root

    def nodes(node, out):
        out.append((node, dict(vars(node))))
        for v in list(vars(node).values()):
            if isinstance(v, Config):
                nodes(v, out)
        return out
    saved = nodes(root, [])
    gen = prng.get()
    state = (gen._seed, gen._counter, gen.np.bit_generator.state)
    main, outcome = Main(list(argv)), {}

    def run():
        try:
            outcome["rc"] = main.run()
        finally:
            for node, d in saved:
                vars(node).clear()
                vars(node).update(d)
            gen.seed(state[0])
            gen._counter = state[1]
            gen.np.bit_generator.state = state[2]
    if not thread:
        run()
        assert outcome["rc"] == 0
        return main
    t = threading.Thread(target=run, daemon=True)
    t.start()
    return main, t, outcome


def _sample_path(name):
    import os
    return os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "veles_tpu_torch", "samples", name)


def test_cli_alexnet_on_the_card(card, tmp_path):
    """A narrow AlexNet through ``python -m veles_tpu_torch``'s ``Main``
    on the card is bit-equal to ``AlexNetWorkflow`` built directly with
    the same keys and seed, launching the LRN kernels and the uniform
    fill as often."""
    from veles_tpu_torch import prng
    from veles_tpu_torch.ops import lrn, random as rnd
    from veles_tpu_torch.samples.alexnet import AlexNetWorkflow
    keys = dict(side=67, classes=10, widths=(8, 16, 24, 24, 16, 32),
                minibatch_size=16, synthetic_train=64, synthetic_valid=16,
                max_epochs=1)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        counts = []
        for how in ("direct", "cli"):
            lrn.launches.update(lrn_fwd=0, lrn_bwd=0)
            rnd.launches = 0
            if how == "direct":
                prng.get().seed(42)
                wf = AlexNetWorkflow(dtype="float32", weights_seed=None,
                                     snapshotter_config={"enabled": False},
                                     **keys)
                wf.initialize(device=card)
                wf.run()
                want = [{n: t.detach().cpu() for n, t in u.params.items()}
                        for u in wf.gd.forwards]
            else:
                m = _port_cli([
                    _sample_path("alexnet.py"),
                    _sample_path("alexnet_config.py"),
                    "-c", "root.alexnet_tpu.update(%r)" % keys,
                    "-c", "root.common.precision.compute_dtype = "
                    "'float32'", "-c", "root.common.dirs.snapshots = %r"
                    % str(tmp_path)])
                wf = m.workflow
            torch.cuda.synchronize()
            counts.append((dict(lrn.launches), rnd.launches))
        got = [{n: t.detach().cpu() for n, t in u.params.items()}
               for u in wf.gd.forwards]
    finally:
        torch.backends.cudnn.deterministic = deterministic
    assert counts[0] == counts[1] and all(counts[1][0].values()) \
        and counts[1][1]
    for g, w in zip(got, want):
        for n in w:
            assert torch.equal(g[n], w[n]), n


def test_serve_loop_on_the_card(card, tmp_path):
    """MNIST trained through the command line on the card, then
    ``samples/serve.py`` serving its snapshot: ``POST /api`` replies
    equal the chain's own forward on CUDA tensors, and ``/shutdown``
    ends the run with 0."""
    import json
    import os
    import time
    import urllib.request
    from veles_tpu_torch.snapshotter import SnapshotterToFile
    f32 = "root.common.precision.compute_dtype = 'float32'"
    _port_cli([_sample_path("mnist.py"), _sample_path("mnist_config.py"),
               "-c", "root.mnist_tpu.update({'synthetic_train': 256, "
               "'synthetic_valid': 64, 'max_epochs': 1, "
               "'snapshot_time_interval': 0.0})", "-c", f32,
               "-c", "root.common.dirs.snapshots = %r" % str(tmp_path)])
    snap = os.path.join(str(tmp_path), "mnist_current.pickle.gz")
    chain = SnapshotterToFile.import_file(snap).gd.forwards
    xs = numpy.random.default_rng(3).random((4, 784)).astype(numpy.float32)
    with torch.no_grad():
        h = torch.as_tensor(xs, device=card)
        for u in chain:
            u.to_device(card)
            h = u.apply(h)
    want = h.cpu().numpy()
    main, thread, outcome = _port_cli(
        [_sample_path("serve.py"), "-c", "root.serve.update({'snapshot': "
         "%r, 'max_wait': 0.05})" % snap, "-c", f32], thread=True)
    t_end = time.time() + 120
    while time.time() < t_end and (main.workflow is None or getattr(
            main.workflow, "api", None) is None
            or main.workflow.api._server_ is None):
        time.sleep(0.05)
    port = main.workflow.api.port

    def post(path, body):
        req = urllib.request.Request("http://127.0.0.1:%d%s" % (port, path),
                                     data=json.dumps(body).encode())
        with urllib.request.urlopen(req, timeout=60) as r:
            return json.loads(r.read())
    try:
        got = [post("/api", {"input": x.tolist()})["result"] for x in xs]
    finally:
        post("/shutdown", {})
        thread.join(60)
    assert outcome.get("rc") == 0
    assert main.workflow.chain.device.type == "cuda"
    numpy.testing.assert_allclose(numpy.asarray(got), want, rtol=1e-5,
                                  atol=1e-5)
