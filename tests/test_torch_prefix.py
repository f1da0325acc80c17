"""The radix prefix cache of the PyTorch port (``serving/
prefix_cache.py``, the shared blocks of ``PagedKVCache`` and the warm
admissions of ``InferenceScheduler``) held against the JAX package on
the CPU.

The trie runs the JAX package's own trie checks and a seeded random
sequence of operations applied to both packages (equal results, equal
``ValueError``s).  The block cache runs one call sequence through both
packages' ``alloc(shared=)``, ``release(donate=)``, ``reclaim`` and
``check(resident=)``, and ``load_staging`` on the same pools.  A warm
insert must never write a shared block: the port's pools are written
in place, so that would change rows other live requests read.  The
scheduler serves the suite's trained chain (``spec_trained_chain``)
with the prefix cache on in both packages (the JAX side at
``warm_buckets=False``): the streams, cold and warm, greedy and seeded,
must be identical, and the prefix counters equal JAX's ``metrics()``.

Tolerances: streams, counters and block ids are exact; staging rows
gathered from the same pool values agree within 1e-6."""

import numpy
import pytest
import torch

import jax.numpy as jnp

from veles_tpu.config import root

from tests.test_torch_serving import _spec
from tests.test_torch_transformer import (  # noqa: F401 (chains: fixture)
    chains, port_chain)

pytestmark = pytest.mark.torch_port

#: the scheduler cases: window 64, block 4, a 24-token prompt (5 full
#: blocks can match, so the warm cold tail is one block) and 12 steps
WINDOW, BLOCK, STEPS = 64, 4, 12
#: the counters the port keeps under the reference's metrics() names
COUNTERS = ("prefix_cache_hits", "prefix_cache_misses",
            "prefix_cache_evictions", "prefix_cache_blocks_resident",
            "prefill_chunk_tokens", "kv_blocks_free", "active_slots",
            "requests_expired", "requests_cancelled", "requests_shed",
            "requests_rejected", "preempts", "preempt_resumes",
            "watchdog_trips")


@pytest.fixture
def f32():
    saved = root.common.precision.get("compute_dtype", "bfloat16")
    root.common.precision.compute_dtype = "float32"
    yield
    root.common.precision.compute_dtype = saved


def port_counters(sch):
    return {n: getattr(sch, n) for n in COUNTERS}


def jax_counters(sch):
    """JAX's ``metrics()`` values; its prefix keys are absent when the
    prefix cache is off, where the port's counters read 0."""
    snap = sch.metrics()
    return {n: snap[n] if n in snap or not n.startswith("prefix_")
            else 0 for n in COUNTERS}


# -- the trie ------------------------------------------------------------------

def test_prefix_trie_invariants():
    """``tests/test_spec.py::test_prefix_trie_invariants`` on the port:
    match pins, release unpins, a double release raises, evicting a
    referenced or inner block raises, and LRU eviction walks refcount-0
    leaves oldest-first."""
    from veles_tpu_torch.serving import RadixPrefixCache
    pc = RadixPrefixCache(block_size=2)
    taken, rejected = pc.insert([1, 2, 3, 4, 5, 6], [10, 11, 12])
    assert taken == [10, 11, 12] and rejected == []
    assert pc.resident == 3
    taken, rejected = pc.insert([1, 2, 3, 4, 9, 9], [20, 21, 22])
    assert taken == [22] and rejected == [20, 21]
    h = pc.match([1, 2, 3, 4, 7, 7, 7])
    assert h.blocks == [10, 11]
    assert pc.shared_blocks() == 2
    node = pc._walk([1, 2])[0]
    with pytest.raises(ValueError, match="live reference"):
        pc._evict_node(pc._walk([1, 2, 3, 4])[1])
    pc.release(h)
    with pytest.raises(ValueError, match="double-released"):
        pc.release(h)
    with pytest.raises(ValueError, match="children"):
        pc._evict_node(node)
    h2 = pc.match([1, 2])
    h2.nodes[0].refs = 0
    with pytest.raises(ValueError, match="double-freed"):
        pc.release(h2)
    pc2 = RadixPrefixCache(block_size=1)
    pc2.insert([1, 2], [31, 32])
    pc2.insert([5], [35])
    assert pc2.evict(2) == [32, 31], "leaf-first, oldest-first"
    assert pc2.evict(5) == [35]
    assert pc2.resident == 0
    assert pc2.evictions == 3
    pc3 = RadixPrefixCache(block_size=2)
    pc3.insert([1, 2, 3, 4], [41, 42])
    assert pc3.peek([1, 2, 3, 4], max_blocks=1) == 1


def test_prefix_trie_evictable_accounting():
    """``tests/test_spec.py::test_prefix_trie_evictable_accounting`` on
    the port: evictable_blocks counts exactly what evict() can free."""
    from veles_tpu_torch.serving import RadixPrefixCache
    pc = RadixPrefixCache(block_size=1)
    pc.insert([1, 2, 3], [11, 12, 13])
    assert pc.evictable_blocks() == 3
    h = pc.match([1, 2])
    assert pc.evictable_blocks() == 1
    assert pc.evict(10) == [13]
    pc.release(h)
    assert pc.evictable_blocks() == 2


def _trie_script(mod, seed, n_ops=300):
    """A seeded random sequence of trie operations on ``mod``'s
    ``RadixPrefixCache``; returns every result (exceptions as
    ``(type, message)``) and the final state."""
    rng = numpy.random.default_rng(seed)
    pc = mod.RadixPrefixCache(block_size=2)
    handles, out, next_id = [], [], [100]

    def tokens():
        return rng.integers(0, 3, rng.integers(0, 11)).tolist()

    def call(fn, *args):
        try:
            return fn(*args)
        except ValueError as e:
            return ("ValueError", str(e))

    for _ in range(n_ops):
        op = rng.integers(0, 9)
        if op <= 1:
            toks = tokens()
            ids = list(range(next_id[0], next_id[0] + len(toks) // 2))
            next_id[0] += len(ids)
            got = call(pc.insert, toks, ids)
        elif op == 2:
            mb = None if rng.integers(0, 2) else int(rng.integers(0, 4))
            h = pc.match(tokens(), mb)
            handles.append(h)
            got = h.blocks
        elif op == 3 and handles:
            got = call(pc.release, handles[rng.integers(0, len(handles))])
        elif op == 4:
            got = call(pc.evict, int(rng.integers(0, 4)))
        elif op == 5:
            toks = tokens()
            path = pc._walk(toks)
            got = call(pc._evict_node, path[-1]) if path else None
        elif op == 6:
            toks = tokens()
            got = (pc.peek(toks), pc.resident_prefix(toks, 2))
        elif op == 7:
            got = (pc.evictable_blocks(), pc.shared_blocks(), pc.resident,
                   sorted(pc.resident_blocks()))
        else:
            got = call(pc.clear) if rng.integers(0, 8) == 0 else None
        out.append(got)
    out.append((pc.hits, pc.misses, pc.hit_blocks, pc.evictions,
                pc.resident, sorted(pc.resident_blocks())))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_prefix_trie_random_ops_match_reference(seed):
    """The same seeded insert/match/release/evict/clear sequence on both
    packages' tries gives equal results, equal ``ValueError``s and the
    same final state."""
    from veles_tpu.serving import prefix_cache as jax_pc
    from veles_tpu_torch.serving import prefix_cache as port_pc
    want = _trie_script(jax_pc, seed)
    got = _trie_script(port_pc, seed)
    assert got == want
    assert any(isinstance(r, tuple) and r and r[0] == "ValueError"
               for r in got), "the script raised no ValueError"


def test_chunk_digests_match_reference():
    from veles_tpu.serving.prefix_cache import chunk_digests as want
    from veles_tpu_torch.serving import chunk_digests as got
    toks = numpy.random.default_rng(4).integers(0, 50000, 70).tolist()
    for bs, depth in ((1, None), (4, None), (16, 2), (16, None)):
        assert got(toks, bs, depth) == want(toks, bs, depth)


# -- the block cache -----------------------------------------------------------

def _caches(chains, kv_dtype, kv_blocks=10):
    from veles_tpu.serving.kv_slots import PagedKVCache as JaxCache
    from veles_tpu_torch.serving import PagedKVCache
    spec, fw = chains
    want = JaxCache(fw, 3, 64, block_size=16, kv_blocks=kv_blocks,
                    kv_dtype=kv_dtype)
    got = PagedKVCache(port_chain(spec, fw), 3, 64, block_size=16,
                       kv_blocks=kv_blocks, kv_dtype=kv_dtype)
    return want, got


def _state(c):
    return (c.tables.tolist(), c.n_blocks.tolist(), c.n_shared.tolist(),
            list(c._free_blocks), list(c._free_slots), c.used_blocks)


def _cache_script(c):
    """One call sequence over ``alloc(shared=)``, ``release(donate=)``,
    ``reclaim`` and ``check(resident=)``; returns each result (errors as
    their type and message) and the state after each call."""
    out = []

    def call(fn, *args, **kw):
        try:
            got = fn(*args, **kw)
        except (ValueError, AssertionError) as e:
            got = (type(e).__name__, str(e))
        out.append((got, _state(c)))
        return got

    a = call(c.alloc, 40)                       # 3 private blocks
    row = [int(b) for b in c.tables[a, :3]]
    shared, donated = call(c.release, a, donate=2)
    assert (shared, donated) == ([], row[:2])
    resident = donated                          # what a trie would own
    b = call(c.alloc, 60, shared=resident)      # 2 shared + 2 new
    call(c.check, resident=resident)
    call(c.check)                               # shares non-resident
    call(c.alloc, 30, shared=resident)          # shared >= need
    call(c.alloc, 200)                          # wider than a table
    call(c.release, b, donate=3)                # past its private blocks
    shared, donated = call(c.release, b, donate=1)
    resident = resident + donated
    call(c.release, b)                          # double free
    call(c.reclaim, [resident[-1]])             # a duplicate donation
    resident = resident[:-1]
    call(c.reclaim, [resident[0], resident[0]])  # double-freed
    call(c.reclaim, [0])                        # the trash block
    call(c.check, resident=resident)
    return out


@pytest.mark.parametrize("kv_dtype", ["fp32", "int8"])
def test_cache_shared_blocks_match_reference(f32, chains, kv_dtype):
    want, got = _caches(chains, kv_dtype)
    assert _cache_script(got) == _cache_script(want)
    assert got.kv_dtype == kv_dtype


def _staging_np(rng, layers, width, d):
    return {i: {n: rng.standard_normal((1, width, d)).astype(numpy.float32)
                for n in ("k", "v")} for i in layers}


@pytest.mark.parametrize("kv_dtype", ["fp32", "int8"])
def test_load_staging_matches_reference(f32, chains, kv_dtype):
    """Blocks inserted from one staging row, gathered back into the
    front of a fresh staging row: the port equals JAX within 1e-6, and
    the rows past the gathered blocks stay as they were."""
    want, got = _caches(chains, kv_dtype)
    rng = numpy.random.default_rng(5)
    d = chains[0][0]["dim"]
    src = _staging_np(rng, want.pools, 64, d)
    for c, conv in ((want, jnp.asarray), (got, torch.as_tensor)):
        slot = c.alloc(64)
        c.insert(slot, {i: {n: conv(a) for n, a in row.items()}
                        for i, row in src.items()}, 60)
    ids = [int(b) for b in got.tables[0, [2, 0, 3]]]
    assert ids == [int(b) for b in want.tables[0, [2, 0, 3]]]
    dst = _staging_np(rng, want.pools, 64, d)
    w = want.load_staging({i: {n: jnp.asarray(a) for n, a in row.items()}
                           for i, row in dst.items()}, ids)
    g = got.load_staging({i: {n: torch.as_tensor(a) for n, a in row.items()}
                          for i, row in dst.items()}, ids)
    for i in dst:
        for n in ("k", "v"):
            gi, wi = g[i][n].numpy(), numpy.asarray(w[i][n])
            numpy.testing.assert_allclose(gi, wi, rtol=1e-6, atol=1e-6)
            numpy.testing.assert_array_equal(gi[0, 48:], dst[i][n][0, 48:])
            if kv_dtype == "fp32":
                numpy.testing.assert_array_equal(
                    gi[0, :16], src[i][n][0, 32:48])


@pytest.mark.parametrize("kv_dtype", ["fp32", "int8"])
def test_warm_insert_leaves_shared_blocks_untouched(f32, chains, kv_dtype):
    """A warm insert whose staging rows over the shared range DIFFER
    from the pool (as a re-prefilled or re-quantized row may) writes
    only the blocks past ``from_block``: the shared blocks' bytes and
    scales stay exactly as they were, and the private blocks take the
    new rows."""
    from veles_tpu_torch.ops.paged_attention import quantize_kv_rows
    _, c = _caches(chains, kv_dtype)
    rng = numpy.random.default_rng(6)
    d = chains[0][0]["dim"]
    conv = {i: {n: torch.as_tensor(a) for n, a in row.items()}
            for i, row in _staging_np(rng, c.pools, 64, d).items()}
    a = c.alloc(40)
    c.insert(a, conv, 40)
    _, shared = c.release(a, donate=2)
    before = {i: {n: t[shared].clone() for n, t in pool.items()}
              for i, pool in c.pools.items()}
    b = c.alloc(60, shared=shared)
    fresh = {i: {n: torch.as_tensor(a) for n, a in row.items()}
             for i, row in _staging_np(rng, c.pools, 64, d).items()}
    c.insert(b, fresh, 60, from_block=2)
    own = torch.as_tensor(c.tables[b, 2:4].astype(numpy.int64))
    for i, pool in c.pools.items():
        for n, t in pool.items():
            assert torch.equal(t[shared], before[i][n]), (i, n)
        for n in ("k", "v"):
            rows = fresh[i][n][0, 32:64].reshape(2, 16, d)
            if kv_dtype == "int8":
                q, s = quantize_kv_rows(rows)
                assert torch.equal(pool[n][own], q)
                assert torch.equal(pool[n + "_scale"][own], s)
            else:
                assert torch.equal(pool[n][own], rows)
    c.release(b)
    c.check(resident=shared)
    with pytest.raises(ValueError, match="leaves nothing"):
        c.insert(c.alloc(20), fresh, 20, from_block=2)


# -- the scheduler -------------------------------------------------------------

def _prompt(pattern, off=0, n=24):
    return (pattern * 6)[off:off + n]


def _jax_sched(fw, **kw):
    from veles_tpu.serving import InferenceScheduler
    args = dict(max_slots=2, window=WINDOW, kv="paged", block_size=BLOCK,
                kv_dtype="fp32", prefill_chunk=8, spec=False, spec_k=4,
                prefix_cache=True, prefix_evict=True, request_timeout=120.0,
                watchdog=0, shed_block_factor=4.0, warm_buckets=False)
    args.update(kw)
    return InferenceScheduler(fw, **args).start()


def _port_sched(chain, **kw):
    from veles_tpu_torch.serving import InferenceScheduler
    args = dict(max_slots=2, window=WINDOW, block_size=BLOCK,
                kv_dtype="fp32", prefill_chunk=8, spec=False, spec_k=4,
                watchdog=0, device="cpu")
    args.update(kw)
    return InferenceScheduler(chain, **args).start()


def _warm_run(sch, counters, prompt):
    """Cold then warm greedy submits, then two seeded ones (warm), with
    the warm greedy resubmit's chunked-prefill tokens."""
    cold = sch.submit(prompt, STEPS, seed=0).result(240)
    before = counters(sch)["prefill_chunk_tokens"]
    warm = sch.submit(prompt, STEPS, seed=0).result(240)
    warm_work = counters(sch)["prefill_chunk_tokens"] - before
    seeded = [sch.submit(prompt, STEPS, temperature=0.8, top_k=4,
                         seed=7).result(240) for _ in range(2)]
    return [cold, warm] + seeded, warm_work, counters(sch)


@pytest.mark.parametrize("chunk", [4, 8])
@pytest.mark.parametrize("spec", [False, True], ids=["spec_off", "spec_on"])
@pytest.mark.parametrize("kv_dtype", ["fp32", "int8"])
def test_warm_resubmit_matches_reference(f32, spec_trained_chain, kv_dtype,
                                         spec, chunk):
    """``test_spec.py::test_prefix_warm_resubmit_parity`` and
    ``test_kv_quant.py::test_int8_warm_radix_resubmit_parity`` against
    the port: the warm resubmit's stream equals the cold one and the
    prefix-cache-off stream, it prefills at most one block, seeded
    warm streams repeat, and every stream and counter equals JAX's."""
    fw, pattern = spec_trained_chain
    prompt = _prompt(pattern)
    kw = dict(kv_dtype=kv_dtype, spec=spec, prefill_chunk=chunk)
    jsch = _jax_sched(fw, **kw)
    try:
        want, want_work, want_n = _warm_run(jsch, jax_counters, prompt)
    finally:
        jsch.close()
    chain = port_chain(_spec(fw), fw)
    sch = _port_sched(chain, prefix_cache=False, **kw)
    try:
        ref = sch.submit(prompt, STEPS, seed=0).result(240)
    finally:
        sch.close()
    sch = _port_sched(chain, **kw)
    try:
        got, work, got_n = _warm_run(sch, port_counters, prompt)
        sch.check_kv()
    finally:
        sch.close()
    sch.check_kv()
    assert got == want
    assert got[0] == got[1] == ref, "the warm resubmit diverged"
    assert got[2] == got[3]
    assert work == want_work and 0 < work <= BLOCK
    assert got_n == want_n
    assert (got_n["prefix_cache_hits"], got_n["prefix_cache_misses"]) \
        == (3, 1)
    assert got_n["prefix_cache_blocks_resident"] > 0


def test_admission_counts_cold_blocks_only(f32, spec_trained_chain):
    """``test_spec.py::test_prefix_admission_counts_cold_blocks_only``
    against the port: a warm request claims only its cold blocks, so it
    admits into a pool whose free list (3) could not hold its full
    budget (7); the counters equal JAX's after each request."""
    fw, pattern = spec_trained_chain
    prompt = _prompt(pattern, 1, 22)
    kw = dict(window=32, kv_blocks=9, prefix_evict=False)

    def run(sch, counters):
        first = sch.submit(prompt, 6, seed=0).result(240)
        mid = counters(sch)
        warm = sch.submit(prompt, 6, seed=0).result(240)
        return [first, warm], mid, counters(sch)

    jsch = _jax_sched(fw, **kw)
    try:
        want = run(jsch, jax_counters)
    finally:
        jsch.close()
    sch = _port_sched(port_chain(_spec(fw), fw), **kw)
    try:
        got = run(sch, port_counters)
        sch.check_kv()
    finally:
        sch.close()
    assert got == want
    (first, warm), mid, end = got
    assert warm == first
    assert mid["prefix_cache_blocks_resident"] == 6
    assert mid["kv_blocks_free"] == 3
    assert end["prefix_cache_hits"] == 1


def test_eviction_under_pressure(f32, spec_trained_chain):
    """``test_spec.py::test_prefix_eviction_under_pressure`` against the
    port: a cold request that needs resident blocks evicts them LRU
    (the counts equal JAX's); with ``prefix_evict=False`` the same
    request queues until its deadline instead, and the pool stays
    clean either way."""
    from veles_tpu.serving import DeadlineExceededError as JaxDeadline
    from veles_tpu_torch.serving import DeadlineExceededError
    fw, pattern = spec_trained_chain
    a, b = _prompt(pattern, 0, 18), _prompt(pattern, 3, 18)
    kw = dict(window=32, kv_blocks=7)

    def run(sch, counters, evict, expired):
        out = [sch.submit(a, 6, seed=0).result(240), counters(sch)]
        if evict:
            out += [sch.submit(b, 6, seed=0).result(240), counters(sch)]
        else:
            with pytest.raises(expired) as e:
                sch.submit(b, 6, seed=0, timeout=0.3).result(240)
            assert e.value.tokens_generated == 0
            out.append(counters(sch))
        return out

    chain = port_chain(_spec(fw), fw)
    for evict in (True, False):
        jsch = _jax_sched(fw, prefix_evict=evict, **kw)
        try:
            want = run(jsch, jax_counters, evict, JaxDeadline)
        finally:
            jsch.close()
        sch = _port_sched(chain, prefix_evict=evict, **kw)
        try:
            got = run(sch, port_counters, evict, DeadlineExceededError)
            sch.check_kv()
        finally:
            sch.close()
        assert got == want
        assert got[1]["prefix_cache_blocks_resident"] == 5
        if evict:
            assert got[3]["prefix_cache_evictions"] >= 4
        else:
            assert got[2]["prefix_cache_evictions"] == 0
            assert got[2]["requests_expired"] == 1


@pytest.mark.parametrize("kv_dtype", ["fp32", "int8"])
def test_continuation_prompt_matches_reference(f32, spec_trained_chain,
                                               kv_dtype):
    """A conversation's next turn: the first request's whole stream
    (36 tokens, a multiple of the block) plus 4 new tokens as the next
    prompt.  It matches the first request's donated blocks, which cover
    only the positions whose K/V was written ([0, 35): the final token
    was never fed back, and a rejected draft's row may sit there), so
    its stream equals the prefix-cache-off one and JAX's."""
    fw, pattern = spec_trained_chain
    prompt = _prompt(pattern)
    kw = dict(kv_dtype=kv_dtype, spec=True)

    def run(sch):
        first = sch.submit(prompt, STEPS, seed=0).result(240)
        return first, sch.submit(first + _prompt(pattern, 5, 4), STEPS,
                                 seed=0).result(240)

    jsch = _jax_sched(fw, **kw)
    try:
        want = run(jsch) + (jax_counters(jsch),)
    finally:
        jsch.close()
    chain = port_chain(_spec(fw), fw)
    sch = _port_sched(chain, prefix_cache=False, **kw)
    try:
        cold = run(sch)
    finally:
        sch.close()
    sch = _port_sched(chain, **kw)
    try:
        got = run(sch) + (port_counters(sch),)
        sch.check_kv()
    finally:
        sch.close()
    assert len(got[0]) % BLOCK == 0
    assert got == want
    assert got[:2] == cold
    assert got[2]["prefix_cache_hits"] == 1
