"""Speculative decoding in the PyTorch port (``serving/spec.py``, the
verify attention of ``ops/paged_attention.py``,
``Embedding.apply_verify_slots``, ``TransformerBlock.
apply_verify_paged``, ``engine.verify_step_paged`` and the scheduler's
n-gram branch) held against the JAX package on the CPU, from
numpy-seeded inputs and the same weights.

Tolerances: the n-gram proposer, the acceptance rule, the int8 pools
and every token stream are exact; f32 contexts agree within 1e-6 where
both packages run the same ops on the same pool values (the verify
attention), 1e-5 where the projections feeding them sum in another
order (a block's verify), and an int8 pool value quantized from such a
K/V row may land one step off (|Δ| <= 1)."""

import numpy
import pytest
import torch

import jax.numpy as jnp

from veles_tpu.config import root

from tests.test_torch_serving import BLOCK, WINDOW, _prompts, _spec
from tests.test_torch_transformer import (  # noqa: F401 (chains: fixture)
    TOL, _pool, chains, jax_params, port_chain)

pytestmark = pytest.mark.torch_port

# the verify attention's shapes: 3 rows (the last one occupancy
# padding), runs of 5, block 4, 4 blocks per table, d 16 over 2 heads
B, K1, BS, T, D, HEADS, NB = 3, 5, 4, 4, 16, 2, 9
LENS = [5, 3, 1]
POS = [6, 2, 0]
TABLES = [[5, 2, 7, 0], [3, 8, 0, 0], [0, 0, 0, 0]]
VALID = [(n, j) for n in range(B - 1) for j in range(LENS[n])]
STEPS = 12


@pytest.fixture
def f32():
    saved = root.common.precision.get("compute_dtype", "bfloat16")
    root.common.precision.compute_dtype = "float32"
    yield
    root.common.precision.compute_dtype = saved


@pytest.fixture
def fused_verify():
    """The JAX package's single-pass verify knob, restored after."""
    saved = root.common.serving.get("fused_verify", False)

    def set_to(on):
        root.common.serving.fused_verify = bool(on)

    yield set_to
    root.common.serving.fused_verify = saved


# -- proposer and acceptance ---------------------------------------------------

def _contexts():
    """Seeded repetitive contexts over vocabularies of 2–6 tokens: cycles
    with noise, runs and plain draws."""
    rng = numpy.random.default_rng(0)
    out = []
    for _ in range(40):
        vocab = int(rng.integers(2, 7))
        n = int(rng.integers(1, 40))
        cycle = rng.integers(0, vocab, int(rng.integers(1, 6)))
        ctx = numpy.resize(cycle, n)
        flip = rng.random(n) < rng.choice([0.0, 0.1, 0.3])
        ctx[flip] = rng.integers(0, vocab, int(flip.sum()))
        out.append([int(t) for t in ctx])
    return out


@pytest.mark.parametrize("k,max_ngram,min_ngram",
                         [(4, 3, 1), (1, 1, 1), (8, 4, 2), (3, 2, 2)])
def test_ngram_proposer_matches_reference(k, max_ngram, min_ngram):
    """Drafts equal the JAX proposer's for every prefix of every context,
    with and without a per-request index and under ``max_tokens`` caps;
    an index synced token by token equals one built fresh."""
    from veles_tpu.serving.spec import (
        NgramIndex as JaxIndex, NgramProposer as JaxProposer)
    from veles_tpu_torch.serving.spec import NgramIndex, NgramProposer
    want_p = JaxProposer(k, max_ngram, min_ngram)
    got_p = NgramProposer(k, max_ngram, min_ngram)
    for ctx in _contexts():
        index, jindex = (NgramIndex(max_ngram, min_ngram),
                         JaxIndex(max_ngram, min_ngram))
        for n in range(len(ctx) + 1):
            for cap in (None, 1, 2, k + 1):
                want = want_p.propose(ctx[:n], cap)
                assert got_p.propose(ctx[:n], cap) == want
                assert got_p.propose(ctx[:n], cap, index=index) == want
                assert want_p.propose(ctx[:n], cap, index=jindex) == want
        # propose synced the indexes prefix by prefix (a context too
        # short to draft from skips it)
        index.sync(ctx)
        jindex.sync(ctx)
        fresh = NgramIndex(max_ngram, min_ngram)
        fresh.sync(ctx)
        assert index._last == fresh._last == jindex._last
        assert index.n == fresh.n == len(ctx)
    # a rewritten (shorter) context rebuilds the index
    index.sync([1, 2])
    again = NgramIndex(max_ngram, min_ngram)
    again.sync([1, 2])
    assert index._last == again._last


def test_proposer_rejects_what_the_reference_rejects():
    from veles_tpu.serving.spec import NgramProposer as JaxProposer
    from veles_tpu_torch.serving.spec import NgramProposer
    for args in ((0,), (4, 1, 2), (-1, 3, 1)):
        with pytest.raises(ValueError):
            JaxProposer(*args)
        with pytest.raises(ValueError):
            NgramProposer(*args)


def test_accept_drafts_matches_reference():
    from veles_tpu.serving.spec import accept_drafts as jax_accept
    from veles_tpu_torch.serving.spec import accept_drafts
    rng = numpy.random.default_rng(1)
    for _ in range(500):
        m = int(rng.integers(0, 6))
        sampled = rng.integers(0, 3, m + 1).tolist()
        drafts = rng.integers(0, 3, m).tolist()
        assert accept_drafts(drafts, sampled) == jax_accept(drafts,
                                                            sampled)
        assert accept_drafts(drafts, numpy.asarray(sampled)) \
            == jax_accept(drafts, sampled)


# -- the verify attention ------------------------------------------------------

def _verify_inputs(quant):
    """q / k_new / v_new [3, 5, 16] and pools of 9 blocks of 4 rows with
    the trash block zeroed (int8 ones with their scales)."""
    from veles_tpu.ops.paged_attention import quantize_kv_rows
    rng = numpy.random.default_rng(3 + quant)
    run = [rng.standard_normal((B, K1, D)).astype(numpy.float32)
           for _ in range(3)]
    k = rng.standard_normal((NB, BS, D)).astype(numpy.float32)
    v = rng.standard_normal((NB, BS, D)).astype(numpy.float32)
    k[0] = v[0] = 0.0
    pools = {"k": k, "v": v}
    if quant:
        (qk, sk), (qv, sv) = (quantize_kv_rows(jnp.asarray(x))
                              for x in (k, v))
        pools = {"k": numpy.asarray(qk), "v": numpy.asarray(qv),
                 "k_scale": numpy.asarray(sk), "v_scale": numpy.asarray(sv)}
    return run, pools


def _valid(ctx):
    return numpy.stack([numpy.asarray(ctx)[n, j] for n, j in VALID])


def _jax_verify(kind, run, pools):
    from veles_tpu.ops import paged_attention as jpa
    args = [jnp.asarray(a) for a in run]
    idx = (jnp.asarray(TABLES, jnp.int32), jnp.asarray(POS, jnp.int32),
           jnp.asarray(LENS, jnp.int32), HEADS)
    if kind == "q8":
        out = jpa.paged_verify_attention_q8(
            *args, *(jnp.asarray(pools[n]) for n in
                     ("k", "v", "k_scale", "v_scale")), *idx)
        names = ("k", "v", "k_scale", "v_scale")
    else:
        fn = jpa.paged_verify_attention_fused if kind == "fused" \
            else jpa.paged_verify_attention
        out = fn(*args, jnp.asarray(pools["k"]), jnp.asarray(pools["v"]),
                 *idx)
        names = ("k", "v")
    return dict(zip(names, map(numpy.asarray, out[:-1]))), \
        numpy.asarray(out[-1])


def _port_verify(kind, run, pools):
    from veles_tpu_torch.ops import paged_attention as pa
    args = [torch.as_tensor(a) for a in run]
    tp = {n: torch.as_tensor(a.copy()) for n, a in pools.items()}
    idx = (torch.as_tensor(TABLES, dtype=torch.int32),
           torch.as_tensor(POS), torch.as_tensor(LENS), HEADS)
    if kind == "q8":
        *_, ctx = pa.paged_verify_attention_q8(
            *args, tp["k"], tp["v"], tp["k_scale"], tp["v_scale"], *idx)
    else:
        fn = pa.paged_verify_attention_fused if kind == "fused" \
            else pa.paged_verify_attention
        *_, ctx = fn(*args, tp["k"], tp["v"], *idx, torch.float32)
    return {n: t.numpy() for n, t in tp.items()}, ctx.float().numpy()


@pytest.mark.parametrize("kind", ["two-pass", "fused", "q8"])
def test_verify_attention_matches_reference(f32, kind):
    """Pools equal outside the trash block (f32 bit for bit, int8 values
    and scales bit for bit) and the valid context rows within 1e-6
    (1e-5 for int8); padding positions never reach a live block."""
    run, pools = _verify_inputs(kind == "q8")
    want_pools, want = _jax_verify(kind, run, pools)
    got_pools, got = _port_verify(kind, run, pools)
    for name in want_pools:
        numpy.testing.assert_array_equal(got_pools[name][1:],
                                         want_pools[name][1:],
                                         err_msg=name)
    # the rows each valid position wrote, and nothing else, changed
    changed = {(int(b), int(r)) for b, r in zip(*numpy.nonzero(
        (got_pools["v"][1:] != pools["v"][1:]).any(-1)))}
    wrote = {(TABLES[n][(POS[n] + j) // BS] - 1, (POS[n] + j) % BS)
             for n, j in VALID}
    assert changed <= wrote
    tol = 1e-5 if kind == "q8" else 1e-6
    numpy.testing.assert_allclose(_valid(got), _valid(want), rtol=tol,
                                  atol=tol)


def test_fused_verify_matches_two_pass(f32):
    """The single-pass verify equals the two-pass one on the valid rows,
    in both packages."""
    run, pools = _verify_inputs(False)
    for verify in (_jax_verify, _port_verify):
        (_, two), (_, fused) = (verify(kind, run, pools)
                                for kind in ("two-pass", "fused"))
        numpy.testing.assert_allclose(_valid(fused), _valid(two),
                                      rtol=1e-6, atol=1e-6)


# -- the chain's verify pieces -------------------------------------------------

def test_apply_verify_slots_matches_reference(f32, chains):
    """Token and positional rows per position, clamped to the positional
    table past its end (rows at 60..65 of a 64-row table)."""
    spec, fw = chains
    emb = port_chain(spec, fw)[0]
    params = {n: jnp.asarray(a) for n, a in jax_params(fw)[0].items()}
    toks = numpy.random.default_rng(4).integers(0, 64, (3, 6)).astype(
        numpy.int32)
    pos = numpy.asarray([60, 3, 0], numpy.int32)
    want = numpy.asarray(fw[0].apply_verify_slots(
        params, jnp.asarray(toks), jnp.asarray(pos)))
    got = emb.apply_verify_slots(torch.as_tensor(toks), torch.as_tensor(pos))
    numpy.testing.assert_allclose(got.numpy(), want, **TOL)
    step = emb.apply_step_slots(torch.as_tensor(toks[:, :1]),
                                torch.as_tensor(pos))
    numpy.testing.assert_array_equal(got[:, :1].numpy(), step.numpy())


#: rows of a block's verify: depths 20, 3 and 24 with 5, 2 and 4 real
#: positions over blocks of their own, then a padding row
V_POS = numpy.asarray([20, 3, 24, 0], numpy.int32)
V_LENS = numpy.asarray([5, 2, 4, 1], numpy.int32)
V_TABLES = numpy.asarray([[2, 4, 0, 0], [5, 0, 0, 0], [1, 3, 0, 0],
                          [0, 0, 0, 0]], numpy.int32)


def _assert_pools_close(got, want):
    for name in want:
        g, w = got[name][1:], want[name][1:]
        if g.dtype == numpy.int8:
            assert numpy.abs(g.astype(int) - w.astype(int)).max() <= 1, name
        else:
            numpy.testing.assert_allclose(g, w, err_msg=name, **TOL)


@pytest.mark.parametrize("w8", [False, True], ids=["w32", "int8_decode"])
@pytest.mark.parametrize("kind", ["fp32", "fused", "int8"])
def test_apply_verify_paged_matches_reference(f32, chains, fused_verify,
                                              kind, w8):
    """One block's verify against the JAX block's (the fused knob set on
    both sides), and against K1 sequential ``apply_step_paged`` calls
    of the port, each over the rows still inside their run."""
    spec, fw = chains
    jblk = fw[1]
    tblk = port_chain(spec, fw)[1]
    jblk.int8_decode = tblk.int8_decode = w8
    fused_verify(kind == "fused")
    try:
        rng = numpy.random.default_rng(7)
        pool = _pool(rng, kind == "int8")
        x = (rng.standard_normal((4, 5, 32)) * 0.5).astype(numpy.float32)
        params = {n: jnp.asarray(a) for n, a in jax_params(fw)[1].items()}
        jy, jpool = jblk.apply_verify_paged(
            params, jnp.asarray(x), jnp.asarray(V_POS), jnp.asarray(V_LENS),
            jnp.asarray(V_TABLES),
            {n: jnp.asarray(a) for n, a in pool.items()})
    finally:
        jblk.int8_decode = False
    tpool = {n: torch.as_tensor(a.copy()) for n, a in pool.items()}
    ty, tpool = tblk.apply_verify_paged(
        torch.as_tensor(x), torch.as_tensor(V_POS), torch.as_tensor(V_LENS),
        torch.as_tensor(V_TABLES), tpool, fused_verify=kind == "fused")
    valid = [(n, j) for n in range(3) for j in range(V_LENS[n])]

    def pick(y):
        return numpy.stack([numpy.asarray(y)[n, j] for n, j in valid])

    numpy.testing.assert_allclose(pick(ty.numpy()), pick(jy), **TOL)
    _assert_pools_close({n: t.numpy() for n, t in tpool.items()},
                        {n: numpy.asarray(a) for n, a in jpool.items()})
    # the same run as sequential decode steps inside the port
    spool = {n: torch.as_tensor(a.copy()) for n, a in pool.items()}
    for j in range(5):
        rows = [n for n in range(3) if j < V_LENS[n]]
        sy, spool = tblk.apply_step_paged(
            torch.as_tensor(x[rows, j:j + 1]),
            torch.as_tensor(V_POS[rows] + j),
            torch.as_tensor(V_TABLES[rows]), spool)
        for r, n in enumerate(rows):
            numpy.testing.assert_allclose(sy[r, 0].float().numpy(),
                                          ty[n, j].float().numpy(), **TOL)
    _assert_pools_close({n: t.numpy() for n, t in tpool.items()},
                        {n: t.numpy() for n, t in spool.items()})


def _caches(fw, chain, kv_dtype, prompts):
    """JAX and port paged caches with ``prompts`` prefilled into slots
    0.., and their [len(prompts), T] tables."""
    from veles_tpu.serving import prefill as jprefill
    from veles_tpu.serving.kv_slots import PagedKVCache as JaxCache
    from veles_tpu_torch.serving import PagedKVCache, prefill
    jc = JaxCache(fw, 4, WINDOW, block_size=BLOCK, kv_dtype=kv_dtype)
    tc = PagedKVCache(chain, 4, WINDOW, block_size=BLOCK, kv_dtype=kv_dtype)
    slots = []
    for p in prompts:
        row = numpy.asarray([p], numpy.int32)
        js, ts = jc.alloc(len(p) + 16), tc.alloc(len(p) + 16)
        assert js == ts
        slots.append(ts)
        jc.insert(js, jprefill(fw, row, window=32)[0], len(p))
        tc.insert(ts, prefill(chain, row, window=32)[0], len(p))
    return jc, tc, slots


@pytest.mark.parametrize("kv_dtype", ["fp32", "int8"])
def test_verify_step_tokens_match_reference(f32, spec_trained_chain,
                                            kv_dtype):
    """``verify_step_paged``'s [B, K1] tokens equal JAX's for greedy and
    seeded rows (position j of row n draws ``counts[n] + j``) over the
    real positions of the real rows."""
    from veles_tpu.serving.engine import verify_step_paged as jax_verify
    from veles_tpu_torch.serving import verify_step_paged
    fw, pattern = spec_trained_chain
    chain = port_chain(_spec(fw), fw)
    prompts = [(pattern * 3)[o:o + n] for o, n in ((0, 9), (3, 14), (1, 5))]
    jc, tc, slots = _caches(fw, chain, kv_dtype, prompts)
    toks = numpy.zeros((4, 5), numpy.int32)
    for n, p in enumerate(prompts):
        toks[n] = (pattern * 4)[len(p) % 8:len(p) % 8 + 5]
    toks[1, 2] = (toks[1, 2] + 1) % 12          # a draft that misses
    pos = numpy.asarray([len(p) for p in prompts] + [0], numpy.int32)
    lens = numpy.asarray([5, 4, 2, 1], numpy.int32)
    tables = numpy.zeros((4, 2), numpy.int32)
    tables[:3] = tc.table_rows(slots, 2)
    assert (tables[:3] == jc.table_rows(slots, 2)).all()
    temps = numpy.asarray([0.0, 0.9, 0.9, 0.0], numpy.float32)
    topks = numpy.asarray([0, 5, 0, 0], numpy.int32)
    seeds = numpy.asarray([0, 41, 2 ** 32 - 3, 0], numpy.uint32)
    counts = numpy.asarray([1, 4, 9, 0], numpy.int32)
    args = (toks, pos, lens, tables, temps, topks, seeds, counts)
    want = numpy.asarray(jax_verify(fw, jc, *args))
    got = verify_step_paged(chain, tc, *args)
    assert got.shape == (4, 5)
    for n in range(3):
        assert got[n, :lens[n]].tolist() == want[n, :lens[n]].tolist()


# -- the scheduler -------------------------------------------------------------

def _submits(pattern):
    """The serving tests' four prompts, greedy, then the same four
    sampled (temperature 0.9, top-k 5, a seed each)."""
    prompts = _prompts(pattern)
    return [(p, dict(seed=0)) for p in prompts] + [
        (p, dict(temperature=0.9, top_k=5, seed=41 + i))
        for i, p in enumerate(prompts)]


def _serve_jax(fw, submits, kv_dtype, chunk, **kw):
    from veles_tpu.serving import InferenceScheduler
    sch = InferenceScheduler(
        fw, max_slots=4, window=WINDOW, kv="paged", block_size=BLOCK,
        kv_dtype=kv_dtype, prefill_chunk=chunk, prefix_cache=False,
        warm_buckets=False, **kw).start()
    try:
        futs = [sch.submit(p, STEPS, **skw) for p, skw in submits]
        return [f.result(240) for f in futs], sch.metrics()
    finally:
        sch.close()


def _serve_port(chain, submits, kv_dtype, chunk, **kw):
    from veles_tpu_torch.serving import InferenceScheduler
    sch = InferenceScheduler(chain, max_slots=4, window=WINDOW,
                             block_size=BLOCK, kv_dtype=kv_dtype,
                             prefill_chunk=chunk, prefix_cache=False,
                             device="cpu", **kw).start()
    try:
        futs = [sch.submit(p, STEPS, **skw) for p, skw in submits]
        outs = [f.result(240) for f in futs]
    finally:
        sch.close()
    sch.check_kv()
    assert sch.cache_.free_slots == 4
    assert sch.cache_.free_blocks == sch.cache_.capacity_blocks
    return outs, sch


@pytest.mark.parametrize("chunk", [0, 16], ids=["oneshot", "chunked"])
@pytest.mark.parametrize("kind", ["fp32", "fused", "int8", "int8_decode"])
def test_spec_streams_match_reference(f32, spec_trained_chain,
                                      fused_verify, kind, chunk):
    """Port spec-on == JAX spec-on (spec_k 4) == port spec-off, greedy
    and seeded, with the JAX metrics' drafted and accepted counts."""
    fw, pattern = spec_trained_chain
    kv_dtype = "int8" if kind.startswith("int8") else "fp32"
    w8 = kind == "int8_decode"
    submits = _submits(pattern)
    blocks = [u for u in fw if hasattr(u, "init_cache")]
    for u in blocks:
        u.int8_decode = w8
    fused_verify(kind == "fused")
    try:
        want, snap = _serve_jax(fw, submits, kv_dtype, chunk, spec=True,
                                spec_k=4)
    finally:
        for u in blocks:
            u.int8_decode = False
    chain = port_chain(_spec(fw, int8_decode=w8), fw)
    got, sch = _serve_port(chain, submits, kv_dtype, chunk, spec_k=4,
                           fused_verify=kind == "fused")
    off, plain = _serve_port(chain, submits, kv_dtype, chunk, spec=False)
    assert got == want
    assert off == want
    assert sch.spec and not plain.spec and plain.verify_steps == 0
    assert (sch.spec_drafted_tokens, sch.spec_accepted_tokens) == (
        snap["spec_drafted_tokens"], snap["spec_accepted_tokens"])
    assert sch.spec_accepted_tokens > 0 and sch.verify_steps > 0
    assert sch.spec_accept_rate == pytest.approx(snap["spec_accept_rate"],
                                                 abs=1e-4)
    # every token after a request's first came from one of the passes
    assert sch.decode_tokens == plain.decode_tokens \
        == len(submits) * (STEPS - 1)
    assert sch.decode_steps + sch.verify_steps < plain.decode_steps


def test_stop_token_inside_accepted_run(f32, spec_trained_chain):
    """A stop token inside an accepted run ends the stream there, where
    the JAX scheduler's ends."""
    fw, pattern = spec_trained_chain
    prompt = (pattern * 4)[:16]
    stop = prompt[5]
    submits = [(prompt, dict(seed=0, stop_token=stop))]
    want, _ = _serve_jax(fw, submits, "fp32", 0, spec=True, spec_k=4)
    got, sch = _serve_port(port_chain(_spec(fw), fw), submits, "fp32", 0,
                           spec_k=4)
    assert got == want
    stream = got[0][len(prompt):]
    assert stream[-1] == stop and stop not in stream[:-1]
    assert 1 < len(stream) < STEPS
    assert sch.verify_steps >= 1 and sch.spec_accepted_tokens >= 1


class _NoVerify:
    """A unit that lacks the paged verify step (all else delegated)."""

    def __init__(self, unit):
        self._unit = unit

    def __getattr__(self, name):
        if name == "apply_verify_paged":
            raise AttributeError(name)
        return getattr(self._unit, name)


def test_verify_supported_both_ways(f32, spec_trained_chain):
    """A chain whose blocks lack the verify step serves with spec off
    (the same streams); a full chain reports support, as JAX's does."""
    from veles_tpu.serving.engine import verify_supported as jax_supported
    from veles_tpu_torch.serving import verify_supported
    fw, pattern = spec_trained_chain
    chain = port_chain(_spec(fw), fw)
    assert verify_supported(chain) and jax_supported(fw)
    blind = [chain[0]] + [_NoVerify(u) for u in chain[1:-1]] + [chain[-1]]
    assert not verify_supported(blind)
    assert not verify_supported([chain[0], chain[-1]])
    submits = _submits(pattern)[:2]
    got, sch = _serve_port(blind, submits, "fp32", 0)
    want, _ = _serve_port(chain, submits, "fp32", 0, spec=False)
    assert got == want and not sch.spec and sch.verify_steps == 0


def test_spec_serves_a_chain_fresh_from_training(f32, spec_trained_chain):
    """A chain straight out of the port's trainer (its parameters still
    require grad) serves the same streams: the loop records no graph,
    its pools do not require grad and the int8 weights are cached."""
    from veles_tpu_torch.models.evaluator import EvaluatorNextToken
    from veles_tpu_torch.models.gd import GradientDescent
    fw, pattern = spec_trained_chain
    chain = port_chain(_spec(fw, int8_decode=True), fw)
    want, _ = _serve_port(port_chain(_spec(fw, int8_decode=True), fw),
                          _submits(pattern)[:4], "int8", 16, spec=False)
    GradientDescent(chain, EvaluatorNextToken(), solver="sgd")
    assert all(t.requires_grad for t in chain[1].params.values())
    got, sch = _serve_port(chain, _submits(pattern)[:4], "int8", 16)
    assert got == want and sch.verify_steps > 0
    assert not any(t.requires_grad for pool in sch.cache_.pools.values()
                   for t in pool.values())
    assert ("w8", "wo") in chain[1]._derived
