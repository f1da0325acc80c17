"""The dense KV layout of the PyTorch port (``SlotKVCache``,
``engine.slot_decode_step`` and ``InferenceScheduler(kv="dense")``)
held against the JAX package on the CPU, on the suite's trained chain
(``spec_trained_chain``) carried into the port.

Oracles: ``tests/test_serving.py::test_paged_vs_dense_token_parity``
and ``::test_slot_step_matches_scalar_step`` (the step itself is held
in ``tests/test_torch_generate.py``).

Tolerances: tokens are exact (greedy and seeded); f32 cache rows
within 1e-5."""

import random
import time

import numpy
import pytest

from veles_tpu import faults as jax_faults
from veles_tpu.config import root
from veles_tpu_torch import faults

from tests.test_torch_serving import _spec
from tests.test_torch_transformer import TOL, port_chain

pytestmark = pytest.mark.torch_port

WINDOW, STEPS = 64, 8


@pytest.fixture
def f32():
    saved = root.common.precision.get("compute_dtype", "bfloat16")
    root.common.precision.compute_dtype = "float32"
    yield
    root.common.precision.compute_dtype = saved


@pytest.fixture(autouse=True)
def disarm():
    faults.clear()
    jax_faults.clear()
    yield
    faults.clear()
    jax_faults.clear()


@pytest.fixture(scope="module")
def trained(spec_trained_chain):
    fw, pattern = spec_trained_chain
    return fw, port_chain(_spec(fw), fw), pattern


def _prompts(pattern):
    """Ragged prompts: one past the 16-token chunk (chunked prefill),
    the rest one-shot."""
    tiled = pattern * 4
    return [tiled[o:o + n] for o, n in ((0, 3), (2, 1), (1, 9), (4, 2),
                                        (3, 20))]


def _submits(pattern):
    prompts = _prompts(pattern)
    return [(p, dict(seed=0)) for p in prompts] + [
        (p, dict(temperature=0.9, top_k=5, seed=13 + i))
        for i, p in enumerate(prompts)]


# -- the slot cache ------------------------------------------------------------

def test_slot_cache_churn_matches_reference(f32, trained):
    """Alloc/release under seeded churn: the same slot ids, free and
    active counts and admission answers as the JAX cache; a double
    free raises in both; exhaustion returns None."""
    from veles_tpu.serving import SlotKVCache as JaxSlots
    from veles_tpu_torch.serving import SlotKVCache
    fw, chain, _ = trained
    jc, tc = JaxSlots(fw, 3, 32), SlotKVCache(chain, 3, 32)
    assert set(tc.caches) == set(jc.caches) == {1, 2}
    assert tc.caches[1]["k"].shape == (3, 32, 16)
    rng = random.Random(5)
    live = []
    for _ in range(120):
        assert (tc.free_slots, tc.active_slots, tc.can_admit(40)) \
            == (jc.free_slots, jc.active_slots, jc.can_admit(40))
        if live and (rng.random() < 0.45 or len(live) == 3):
            slot = live.pop(rng.randrange(len(live)))
            jc.release(slot)
            tc.release(slot)
        else:
            slot = tc.alloc(rng.randrange(1, 33))
            assert slot == jc.alloc(1)
            if slot is not None:
                live.append(slot)
    for slot in list(live):
        tc.release(slot)
        jc.release(slot)
    for cache in (tc, jc):
        with pytest.raises(ValueError):
            cache.release(0)
    for cls, fwd in ((SlotKVCache, chain), (JaxSlots, fw)):
        with pytest.raises(ValueError):
            cls(fwd, 0, 32)


def _filled(fw, chain, prompts, width):
    """Both packages' slot caches with ``prompts`` prefilled into slots
    0.. through ``insert`` (staging ``width`` wide)."""
    from veles_tpu.serving import SlotKVCache as JaxSlots
    from veles_tpu.serving import prefill as jprefill
    from veles_tpu_torch.serving import SlotKVCache, prefill
    jc, tc = JaxSlots(fw, 4, WINDOW), SlotKVCache(chain, 4, WINDOW)
    for p in prompts:
        row = numpy.zeros((1, min(width, WINDOW)), numpy.int32)
        row[0, :len(p)] = p
        js, ts = jc.alloc(len(p)), tc.alloc(len(p))
        assert js == ts
        jc.insert(js, jprefill(fw, row, prompt_lens=[len(p)],
                               window=width)[0], len(p))
        tc.insert(ts, prefill(chain, row, prompt_lens=[len(p)],
                              window=width)[0], len(p))
    return jc, tc


def test_slot_cache_insert_matches_reference(f32, trained):
    """Staging rows narrower and wider than the window land in their
    slots as JAX's insert lands them."""
    fw, chain, pattern = trained
    prompts = _prompts(pattern)[:3]
    for width in (32, 128):
        jc, tc = _filled(fw, chain, prompts, width)
        for i in jc.caches:
            for n in ("k", "v"):
                numpy.testing.assert_allclose(
                    tc.caches[i][n].numpy(),
                    numpy.asarray(jc.caches[i][n]), err_msg="%d %s" % (i, n),
                    **TOL)


def test_slot_decode_step_matches_reference(f32, trained):
    """Three steps over three live slots and a free one: greedy and
    seeded rows draw JAX's tokens, and the live slots' caches match."""
    from veles_tpu.serving import slot_decode_step as jax_step
    from veles_tpu_torch.serving import slot_decode_step
    fw, chain, pattern = trained
    prompts = _prompts(pattern)[:3]
    jc, tc = _filled(fw, chain, prompts, 32)
    toks = numpy.asarray([[p[-1]] for p in prompts] + [[0]], numpy.int32)
    pos = numpy.asarray([len(p) - 1 for p in prompts] + [0], numpy.int32)
    temps = numpy.asarray([0.0, 0.9, 0.9, 0.0], numpy.float32)
    topks = numpy.asarray([0, 5, 0, 0], numpy.int32)
    seeds = numpy.asarray([0, 41, 2 ** 32 - 3, 0], numpy.uint32)
    for step in range(3):
        counts = numpy.asarray([step] * 4, numpy.int32)
        args = (toks, pos, temps, topks, seeds, counts)
        want = numpy.asarray(jax_step(fw, jc, *args))
        got = slot_decode_step(chain, tc, *args)
        assert got[:3].tolist() == want[:3].tolist()
        toks = want[:, None].astype(numpy.int32)
        pos = pos + 1
    for i in jc.caches:
        for n in ("k", "v"):
            for slot, p in enumerate(prompts):
                numpy.testing.assert_allclose(
                    tc.caches[i][n][slot, :len(p) + 3].numpy(),
                    numpy.asarray(jc.caches[i][n])[slot, :len(p) + 3],
                    **TOL)


# -- the scheduler -------------------------------------------------------------

def _serve_jax(fw, submits, **kw):
    from veles_tpu.serving import InferenceScheduler
    args = dict(max_slots=3, window=WINDOW, kv="dense", prefill_chunk=0,
                spec=False, prefix_cache=False, warm_buckets=False)
    args.update(kw)
    sch = InferenceScheduler(fw, **args).start()
    try:
        futs = [sch.submit(p, STEPS, **k) for p, k in submits]
        return [f.result(240) for f in futs], sch.metrics()
    finally:
        sch.close()


def _serve_port(chain, submits, **kw):
    from veles_tpu_torch.serving import InferenceScheduler
    args = dict(max_slots=3, window=WINDOW, kv="dense", prefill_chunk=0,
                spec=False, prefix_cache=False, device="cpu")
    args.update(kw)
    sch = InferenceScheduler(chain, **args).start()
    try:
        futs = [sch.submit(p, STEPS, **k) for p, k in submits]
        outs = [f.result(240) for f in futs]
        snap = sch.metrics()
    finally:
        sch.close()
    sch.check_kv()
    assert sch.cache_.free_slots == sch.max_slots
    return outs, snap, sch


@pytest.mark.parametrize("chunk", [0, 16], ids=["oneshot", "chunked"])
def test_dense_streams_match_reference_and_paged(f32, trained, chunk):
    """10 requests (greedy and seeded, ragged prompts, more than the 3
    slots) through ``kv="dense"``: the port's streams equal JAX's dense
    streams and the port's paged fp32 ones; every dense decode step
    rode all 3 slots; greedy rows equal ``generate(kv_cache=True)``."""
    from veles_tpu_torch.models.generate import generate
    fw, chain, pattern = trained
    submits = _submits(pattern)
    want, jsnap = _serve_jax(fw, submits, prefill_chunk=chunk)
    got, snap, sch = _serve_port(chain, submits, prefill_chunk=chunk)
    paged, _, psch = _serve_port(chain, submits, prefill_chunk=chunk,
                                 kv="paged", block_size=4)
    assert got == want
    assert paged == want
    assert sch.kv == "dense" and psch.kv == "paged"
    assert sch.decode_tokens == len(submits) * (STEPS - 1)
    assert sch.stats.slot_total_steps == 3 * sch.decode_steps
    for key in ("requests_completed", "tokens_generated", "slot_busy_steps",
                "prefill_chunks"):
        assert snap[key] == jsnap[key], key
    for (p, k), out in zip(submits, got):
        if "temperature" not in k:
            ref = generate(chain, [p], STEPS, kv_cache=True)[0].tolist()
            assert out == ref


def test_dense_knobs_fall_back_as_reference(f32, trained):
    """Under ``kv="dense"`` int8 pools, speculative decoding and the
    prefix cache switch off and the block budget is 0, in both
    packages alike; ``metrics()`` has the reference's dense KV keys
    and no block keys; a request longer than the default pool's
    blocks is not refused, and no block-pressure shed trips; an
    unknown layout is refused by both."""
    from veles_tpu.serving import InferenceScheduler as JaxScheduler
    from veles_tpu_torch.serving import InferenceScheduler
    fw, chain, pattern = trained
    knobs = dict(max_slots=2, window=WINDOW, kv="dense", kv_dtype="int8",
                 spec=True, prefix_cache=True, shed_block_factor=0.01,
                 kv_blocks=1)
    jsch = JaxScheduler(fw, warm_buckets=False, **knobs).start()
    sch = InferenceScheduler(chain, device="cpu", **knobs).start()
    try:
        for s in (jsch, sch):
            assert (s.kv, s.kv_dtype, s.spec, s.prefix_cache,
                    s.kv_blocks) == ("dense", "fp32", False, False, 0)
        outs = [s.submit(pattern[:4], 40, seed=0).result(240)
                for s in (jsch, sch)]
        assert outs[0] == outs[1]
        jsnap, snap = jsch.metrics(), sch.metrics()
    finally:
        jsch.close()
        sch.close()
    kv_keys = {k for k in jsnap if k.startswith(("kv_", "prefix_", "spec"))}
    assert {k for k in snap
            if k.startswith(("kv_", "prefix_", "spec"))} == kv_keys
    assert "kv_blocks_total" not in snap and snap["kv_mode"] == "dense"
    assert (snap["spec"], snap["prefix_cache"]) == (False, False)
    assert sch.debug_requests() == []
    for cls, fwd, kw in ((JaxScheduler, fw, {}),
                         (InferenceScheduler, chain, dict(device="cpu"))):
        with pytest.raises(ValueError, match="kv"):
            cls(fwd, window=WINDOW, kv="sparse", warm_buckets=False, **kw)


def test_dense_lifecycle_and_streams(f32, trained):
    """On the dense layout: a stream preempted by a high-class arrival
    at one slot resumes and iterates its uninterrupted stream; a
    cancel mid-decode frees its slot; ``debug_requests()`` reports 0
    blocks."""
    from veles_tpu_torch.serving import RequestCancelledError
    fw, chain, pattern = trained
    low, high = (pattern * 4)[:5], (pattern * 4)[2:9]
    alone, _, _ = _serve_port(chain, [(low, dict(seed=0)),
                                      (high, dict(seed=0))])
    from veles_tpu_torch.serving import InferenceScheduler
    sch = InferenceScheduler(chain, max_slots=1, window=WINDOW, kv="dense",
                             prefill_chunk=0, device="cpu").start()
    try:
        faults.inject("serving.scheduler.step", "delay", arg=0.05)
        ts = sch.submit(low, STEPS, priority="low", stream=True)
        it = iter(ts)
        first = next(it)
        # the first token is pushed while the request is still listed
        # as admitting; its row settles in the decode phase
        deadline = time.monotonic() + 30
        while [r["phase"] for r in sch.debug_requests()] != ["decode"]:
            assert time.monotonic() < deadline, sch.debug_requests()
            time.sleep(0.002)
        assert [(r["blocks"], r["blocks_budget"], r["stream"])
                for r in sch.debug_requests()] == [(0, 0, True)]
        hf = sch.submit(high, STEPS, priority="high")
        assert low + [first] + list(it) == alone[0]
        assert hf.result(240) == alone[1]
        assert sch.preempts == 1 and sch.preempt_resumes == 1
        before = sch.decode_steps
        gone = sch.submit(high, 40)
        while sch.decode_steps < before + 2:
            time.sleep(0.005)
        sch.cancel(gone)
        with pytest.raises(RequestCancelledError):
            gone.result(60)
        faults.clear()
        assert sch.submit(low, STEPS, seed=0).result(60) == alone[0]
        assert sch.cache_.free_slots == 1
    finally:
        sch.close()


class _NoPaged:
    """A unit without the paged decode step (all else delegated)."""

    def __init__(self, unit):
        self._unit = unit

    def __getattr__(self, name):
        if name in ("apply_step_paged", "apply_verify_paged"):
            raise AttributeError(name)
        return getattr(self._unit, name)


def test_chain_without_paged_step_serves_dense(f32, trained):
    """A chain whose blocks lack the paged step falls back to the dense
    layout, as the reference's does, and serves the same streams."""
    from veles_tpu_torch.serving import paged_supported
    fw, chain, pattern = trained
    blind = [chain[0]] + [_NoPaged(u) for u in chain[1:-1]] + [chain[-1]]
    assert not paged_supported(blind)
    submits = _submits(pattern)[:4]
    got, _, sch = _serve_port(blind, submits, kv="paged")
    want, _, _ = _serve_port(chain, submits)
    assert sch.kv == "dense" and got == want
