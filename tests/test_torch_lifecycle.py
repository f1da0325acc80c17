"""The request lifecycle of the PyTorch port's ``InferenceScheduler`` —
deadlines, cancel, close with work in flight, preempt→resume,
``resume_tokens``, drain, block-pressure shed by class, the watchdog —
driven through the port's own fault registry
(``veles_tpu_torch.faults``), mirroring ``tests/test_faults.py`` and
``tests/test_spec.py::test_prefix_mixed_soak_with_faults`` on the CPU.

Where the outcome does not depend on timing, the port is held against
the JAX scheduler on the same weights (the suite's trained chain,
``spec_trained_chain``; the JAX side at ``warm_buckets=False``): a
preempted or resumed stream equals JAX's uninterrupted one token for
token, and the shed decisions, their ``retry_after`` and the counters
equal JAX's.  Every test ends with the paged cache's invariant sweep
clean and every block free or resident in the prefix cache.  The one
injected hang lasts 1.5 s and the watchdog trips at 0.3 s."""

import inspect
import time

import pytest

from veles_tpu import faults as jax_faults
from veles_tpu.config import root
from veles_tpu_torch import faults

from tests.test_torch_prefix import (
    _jax_sched, _port_sched, jax_counters, port_counters)
from tests.test_torch_serving import _spec
from tests.test_torch_transformer import port_chain

pytestmark = pytest.mark.torch_port


@pytest.fixture
def f32():
    saved = root.common.precision.get("compute_dtype", "bfloat16")
    root.common.precision.compute_dtype = "float32"
    yield
    root.common.precision.compute_dtype = saved


@pytest.fixture(autouse=True)
def disarm():
    """Every test starts and ends with both registries empty."""
    faults.clear()
    jax_faults.clear()
    yield
    faults.clear()
    jax_faults.clear()


def _tiny(window=256):
    """A port-only chain (vocab 12, d 16, 2 heads, 1 block) for the
    timing-driven cases, which compare with no reference stream."""
    from veles_tpu_torch.convert import init_params
    spec = [{"type": "embedding", "vocab": 12, "dim": 16},
            {"type": "transformer_block", "heads": 2},
            {"type": "token_logits", "vocab": 12}]
    return init_params(spec, 0, window, device="cpu", dtype="float32")


def _sched(chain, **kw):
    from veles_tpu_torch.serving import InferenceScheduler
    args = dict(max_slots=1, window=256, block_size=4, prefill_chunk=0,
                watchdog=0, device="cpu")
    args.update(kw)
    return InferenceScheduler(chain, **args).start()


def _clean(sch):
    """Every block free or resident in the prefix cache, every slot
    free, the sweep clean."""
    cache = sch.cache_
    resident = sch.prefix_cache_blocks_resident
    sch.check_kv()
    assert cache.used_blocks == resident
    assert cache.free_blocks == cache.capacity_blocks - resident
    assert cache.free_slots == cache.max_slots


def _passes(sch):
    return sch.decode_steps + sch.verify_steps


def _wait(cond, what, limit=60.0):
    deadline = time.monotonic() + limit
    while not cond():
        assert time.monotonic() < deadline, what
        time.sleep(0.01)


# -- the registry --------------------------------------------------------------

def test_registry_semantics():
    """``test_faults.py::test_registry_semantics`` and
    ``::test_http_error_action_and_point_globs`` on the port's registry
    (no metrics counter: the port has no registry of metrics yet)."""
    assert faults.fire("nothing.armed") is False
    faults.inject("p.drop", "drop", after=1, times=1)
    assert faults.fire("p.drop") is False
    assert faults.fire("p.drop") is True
    assert faults.fire("p.drop") is False
    faults.inject("p.key", "drop", key="w?")
    assert faults.fire("p.key", key="w1") is True
    assert faults.fire("p.key", key="other") is False
    assert faults.fire("p.key") is False
    faults.inject("p.boom", "exception")
    with pytest.raises(faults.InjectedFault):
        faults.fire("p.boom")
    faults.inject("p.slow", "delay", arg=0.05)
    t0 = time.monotonic()
    faults.fire("p.slow")
    assert time.monotonic() - t0 >= 0.05
    faults.clear()
    faults.inject("p.http", "http_error", arg=503)
    with pytest.raises(faults.InjectedHTTPError) as e:
        faults.fire("p.http")
    assert e.value.status == 503
    faults.clear("p.http")
    faults.inject("router.*", "drop", key="r[12]")
    assert faults.fire("router.forward", key="r1") is True
    assert faults.fire("router.forward", key="r3") is False
    assert faults.fire("router.replica.health", key="r2") is True
    assert faults.fire("serving.scheduler.step", key="r1") is False
    assert faults.fire("router.forward") is False
    assert len(faults.active()) == 1


SPECS = ("a.b=hang:1.5@3x2;c.d=drop~w*; e.f=delay",
         "rest.x=http_error:418x1;rest.y=http_error",
         "serving.scheduler.*=delay:0.01", "no-equals-sign", "p=warp",
         "=drop", "s=exception@2")


@pytest.mark.parametrize("spec", SPECS)
def test_spec_grammar_matches_reference(spec):
    """``load`` parses each spec string as the JAX registry does: the
    same fields, or the same ``ValueError``."""
    def parse(mod):
        mod.clear()
        try:
            return [(s.point, s.action, s.arg, s.after, s.times, s.key)
                    for s in mod.load(spec)]
        except ValueError as e:
            return str(e)
    assert parse(faults) == parse(jax_faults)


# -- deadlines, cancel, close --------------------------------------------------

def test_deadline_expiry_frees_all_blocks():
    """``test_faults.py::test_deadline_expiry_frees_all_blocks``: a
    request expiring mid-decode fails with its partial token count and
    returns every block; a queued one expires with 0 tokens."""
    from veles_tpu_torch.serving import DeadlineExceededError
    sch = _sched(_tiny())
    try:
        faults.inject("serving.scheduler.step", "delay", arg=0.02)
        busy = sch.submit([1, 2, 3], 200, timeout=0.3)
        queued = sch.submit([4], 4, timeout=0.2)
        with pytest.raises(DeadlineExceededError) as e1:
            busy.result(60)
        assert e1.value.tokens_generated > 0
        with pytest.raises(DeadlineExceededError) as e2:
            queued.result(60)
        assert e2.value.tokens_generated == 0
        faults.clear()
        assert len(sch.submit([5, 6], 3).result(60)) == 5
        assert sch.requests_expired == 2
        _clean(sch)
    finally:
        sch.close()
    _clean(sch)


def test_cancel_frees_blocks():
    """``test_faults.py::test_cancel_frees_blocks``: a queued and a
    mid-decode request are cancelled and their blocks return."""
    from veles_tpu_torch.serving import RequestCancelledError
    sch = _sched(_tiny())
    try:
        faults.inject("serving.scheduler.step", "delay", arg=0.01)
        active = sch.submit([1, 2, 3], 200)
        _wait(lambda: _passes(sch) >= 3, "never decoded")
        queued = sch.submit([4, 5], 8)
        assert sch.cancel(queued) is True
        assert sch.cancel(active) is True
        with pytest.raises(RequestCancelledError):
            queued.result(60)
        with pytest.raises(RequestCancelledError):
            active.result(60)
        assert sch.cancel(active) is False
        faults.clear()
        assert len(sch.submit([7], 2).result(60)) == 3
        assert sch.requests_cancelled == 2
        _clean(sch)
    finally:
        sch.close()


def test_close_with_inflight_frees_blocks():
    """``test_faults.py::test_close_with_inflight_frees_blocks``:
    closing with requests decoding and queued fails them and returns
    every block."""
    from veles_tpu_torch.serving import SchedulerError
    sch = _sched(_tiny(), max_slots=2, prefill_chunk=8)
    faults.inject("serving.scheduler.step", "delay", arg=0.01)
    futs = [sch.submit([1, 2, 3], 200), sch.submit([4, 5], 200),
            sch.submit([6], 200)]
    _wait(lambda: sch.active_slots == 2, "never admitted")
    assert sch.cache_.used_blocks > 0
    sch.close()
    for fut in futs:
        with pytest.raises(SchedulerError, match="closed"):
            fut.result(10)
    _clean(sch)
    with pytest.raises(SchedulerError, match="closed"):
        sch.submit([1], 2)


# -- preemption and resume -----------------------------------------------------

def _jobs(pattern):
    return [((pattern * 4)[:5], dict(seed=0)),
            ((pattern * 4)[2:9], dict(temperature=0.9, top_k=5, seed=123))]


@pytest.mark.parametrize("spec", [False, True], ids=["spec_off", "spec_on"])
def test_preempt_resume_matches_reference(f32, spec_trained_chain, spec):
    """``test_faults.py::test_preempt_resume_token_parity`` against the
    port: both requests (greedy and seeded) preempted mid-decode resume
    by re-prefill and emit JAX's uninterrupted streams token for
    token."""
    fw, pattern = spec_trained_chain
    jobs = _jobs(pattern)
    kw = dict(prefill_chunk=4, spec=spec)
    jsch = _jax_sched(fw, **kw)
    try:
        want = [f.result(240) for f in
                [jsch.submit(p, 24, **k) for p, k in jobs]]
    finally:
        jsch.close()
    sch = _port_sched(port_chain(_spec(fw), fw), **kw)
    try:
        faults.inject("serving.scheduler.step", "delay", arg=0.02)
        futs = [sch.submit(p, 24, **k) for p, k in jobs]
        _wait(lambda: _passes(sch) >= 2, "never decoded")
        sch.request_preempt()
        time.sleep(0.05)
        sch.request_preempt()
        got = [f.result(240) for f in futs]
        assert sch.preempts >= 1, "no preemption happened"
        assert sch.preempt_resumes >= 1
        _clean(sch)
    finally:
        sch.close()
    assert got == want
    assert all(len(o) == len(p) + 24 for o, (p, _) in zip(got, jobs))


def test_priority_arrival_preempts_lower_class(f32, spec_trained_chain):
    """At one slot a high-class arrival preempts the decoding low-class
    request; the victim resumes after it, and both streams equal JAX's
    uninterrupted ones."""
    fw, pattern = spec_trained_chain
    (low, _), (high, _) = _jobs(pattern)
    jsch = _jax_sched(fw, max_slots=1)
    try:
        want = [jsch.submit(p, 24, seed=0).result(240) for p in (low, high)]
    finally:
        jsch.close()
    sch = _port_sched(port_chain(_spec(fw), fw), max_slots=1)
    try:
        faults.inject("serving.scheduler.step", "delay", arg=0.02)
        lf = sch.submit(low, 24, seed=0, priority="low")
        _wait(lambda: _passes(sch) >= 2, "never decoded")
        hf = sch.submit(high, 24, seed=0, priority="high")
        got = [lf.result(240), hf.result(240)]
        assert sch.preempts == 1 and sch.preempt_resumes == 1
        _clean(sch)
    finally:
        sch.close()
    assert got == want


def test_resume_tokens_match_reference(f32, spec_trained_chain):
    """``submit(resume_tokens=)`` continues an uninterrupted run: the
    resumed streams (greedy and seeded) equal the full ones in both
    packages, and a prefix that covers the budget is refused alike."""
    from veles_tpu_torch.serving import InferenceScheduler
    fw, pattern = spec_trained_chain
    jobs = _jobs(pattern)
    jsch = _jax_sched(fw)
    try:
        full = [jsch.submit(p, 16, **k).result(240) for p, k in jobs]
        resumed = [jsch.submit(p, 16, resume_tokens=f[len(p):len(p) + 5],
                               **k).result(240)
                   for (p, k), f in zip(jobs, full)]
        with pytest.raises(ValueError) as want_err:
            jsch.submit(jobs[0][0], 3, resume_tokens=[1, 2, 3])
    finally:
        jsch.close()
    assert resumed == full
    sch = _port_sched(port_chain(_spec(fw), fw))
    try:
        got = [sch.submit(p, 16, resume_tokens=f[len(p):len(p) + 5],
                          **k).result(240)
               for (p, k), f in zip(jobs, full)]
        with pytest.raises(ValueError) as got_err:
            sch.submit(jobs[0][0], 3, resume_tokens=[1, 2, 3])
        _clean(sch)
    finally:
        sch.close()
    assert got == full
    assert str(got_err.value) == str(want_err.value)
    assert sch.preempt_resumes == 0     # no preemption: not a resume
    assert "resume_tokens" not in [
        p.name for p in inspect.signature(
            InferenceScheduler.submit).parameters.values()
        if p.kind == p.POSITIONAL_OR_KEYWORD]


# -- drain, shed, priorities ---------------------------------------------------

def test_drain_completes_inflight_rejects_new():
    """``test_faults.py::test_drain_completes_inflight_rejects_new``:
    drain() finishes every request in flight while new submits raise
    :class:`DrainingError`; ``drained`` sets once empty."""
    from veles_tpu_torch.serving import DrainingError
    sch = _sched(_tiny(64), max_slots=2, window=64)
    try:
        faults.inject("serving.scheduler.step", "delay", arg=0.005)
        futs = [sch.submit([i + 1, i + 2], 20) for i in range(4)]
        assert sch.drain() is False
        assert sch.draining
        with pytest.raises(DrainingError) as e:
            sch.submit([9], 2)
        assert e.value.http_status == 503 and e.value.retry_after >= 1
        outs = [f.result(120) for f in futs]
        assert all(len(o) == 22 for o in outs)
        assert sch.drain(timeout=60) is True and sch.drained
        assert sch.requests_rejected == 1 and sch.in_flight == 0
        _clean(sch)
    finally:
        sch.close()


def _shed_script(sch, full_error, counters):
    """One busy request holds the only slot (its steps paced by an
    injected delay); then submits of each class against a pool of 8
    blocks at shed factor 1.0 (low sheds above 4 queued blocks, normal
    above 8, high above 12), then the depth cap (4 waiting).  Returns each
    submit's outcome — its class of error and ``retry_after``."""
    out = []

    def submit(prompt, steps, prio):
        try:
            futs.append(sch.submit(prompt, steps, seed=0, priority=prio))
            out.append("queued")
        except full_error as e:
            out.append((str(e).split(":")[0], e.retry_after))

    futs = [sch.submit([1, 2], 30, seed=0)]       # 8 blocks, the slot
    _wait(lambda: not sch._queue, "the busy request to admit")
    submit([4], 3, "low")        # 0 + 1 <= 4: queued
    submit([3], 27, "normal")    # 1 + 7 <= 8: queued
    submit([4], 3, "low")        # 8 + 1 > 4: shed
    submit([4], 3, "normal")     # 8 + 1 > 8: shed
    submit([5], 3, "high")       # 8 + 1 <= 12: queued
    submit([6], 19, "high")      # 9 + 5 > 12: shed
    submit([7], 3, 2)            # the 4th seat
    submit([8], 3, "high")       # queue full: sheds the queued low
    submit([9], 3, "normal")     # queue full, no lower class to shed
    results = []
    for f in futs:
        try:
            results.append(len(f.result(120)))
        except full_error as e:
            results.append((str(e).split(":")[0], e.retry_after))
    return out, results, counters(sch)


def test_block_pressure_shed_by_class(f32, spec_trained_chain):
    """``test_faults.py::test_block_pressure_shed`` with classes: each
    class sheds at its own fraction of the budget with its own
    ``retry_after`` (low 4, normal 2, high 1), a full queue sheds its
    youngest lower-class request for a higher one; the outcomes and
    counters equal JAX's."""
    from veles_tpu.serving import QueueFullError as JaxFull
    from veles_tpu_torch.serving import QueueFullError
    fw, _ = spec_trained_chain
    kw = dict(max_slots=1, kv_blocks=8, max_queue=4, shed_block_factor=1.0,
              prefill_chunk=0)
    jax_faults.inject("serving.scheduler.step", "delay", arg=0.01)
    jsch = _jax_sched(fw, **kw)
    try:
        want = _shed_script(jsch, JaxFull, jax_counters)
    finally:
        jsch.close()
    faults.inject("serving.scheduler.step", "delay", arg=0.01)
    sch = _port_sched(port_chain(_spec(fw), fw), **kw)
    try:
        got = _shed_script(sch, QueueFullError, port_counters)
        _clean(sch)
    finally:
        sch.close()
    assert got == want
    out, results, n = got
    assert out == ["queued", "queued", ("overloaded", 4),
                   ("overloaded", 2), "queued", ("overloaded", 1),
                   "queued", "queued",
                   ("serving queue full (4 waiting)", 2)]
    assert results[1] == ("shed while queued", 4)
    assert results[0] == 32 and results[2] == 28
    assert (n["requests_shed"], n["requests_rejected"]) == (4, 5)


def test_resolve_priority_matches_reference():
    from veles_tpu.serving.scheduler import resolve_priority as want
    from veles_tpu_torch.serving import resolve_priority as got
    for v in (None, "low", "NORMAL", "high", 0, 1, 2, 3, -1, True, 1.0,
              "urgent", [1]):
        try:
            w = want(v)
        except ValueError as e:
            with pytest.raises(ValueError) as g:
                got(v)
            assert str(g.value) == str(e)
        else:
            assert got(v) == w


def test_submit_positional_order_matches_reference():
    """``submit``'s first nine parameters are the reference's, in its
    order, so a call by position binds ``timeout``, ``priority`` and
    ``stream`` as the JAX one does (a bad priority by position is
    refused; a timeout by position expires a queued request)."""
    from veles_tpu.serving import InferenceScheduler as JaxScheduler
    from veles_tpu_torch.serving import (
        DeadlineExceededError, InferenceScheduler)
    names = [p.name for p in inspect.signature(
        InferenceScheduler.submit).parameters.values()
        if p.kind == p.POSITIONAL_OR_KEYWORD]
    want = list(inspect.signature(JaxScheduler.submit).parameters)[:10]
    assert names == want == ["self", "prompt", "steps", "temperature",
                             "top_k", "seed", "stop_token", "timeout",
                             "priority", "stream"]
    sch = _sched(_tiny())
    try:
        with pytest.raises(ValueError, match="priority"):
            sch.submit([1], 2, 0.0, 0, 0, None, None, "urgent")
        faults.inject("serving.scheduler.step", "delay", arg=0.02)
        busy = sch.submit([1, 2], 40, 0.0, 0, 0, None, 30.0, "high")
        late = sch.submit([3], 2, 0.0, 0, 0, None, 0.05, 0)
        with pytest.raises(DeadlineExceededError):
            late.result(60)
        assert len(busy.result(60)) == 42
        _clean(sch)
    finally:
        sch.close()


# -- the watchdog --------------------------------------------------------------

def test_watchdog_recovers_from_injected_hang():
    """``test_faults.py::test_watchdog_recovers_from_injected_hang``: a
    hung step trips the watchdog, which fails the pending requests
    during the hang; after it the loop reaps them, frees their blocks
    and serves again."""
    from veles_tpu_torch.serving import SchedulerError
    chain = _tiny()
    # a first pass over a fresh chain pays torch's one-time set-up: run
    # it on a scheduler without a watchdog, so it cannot trip a false
    # stall on the one that has one
    warm = _sched(chain, max_slots=2)
    try:
        assert len(warm.submit([9, 8], 2).result(60)) == 4
    finally:
        warm.close()
    sch = _sched(chain, max_slots=2, watchdog=0.3)
    try:
        assert len(sch.submit([9, 8], 2).result(60)) == 4
        faults.inject("serving.scheduler.step", "hang", arg=1.5, times=1)
        fut = sch.submit([1, 2, 3], 200)
        queued = sch.submit([4], 150)
        t0 = time.monotonic()
        with pytest.raises(SchedulerError, match="stalled"):
            fut.result(60)
        with pytest.raises(SchedulerError, match="stalled"):
            queued.result(60)
        assert time.monotonic() - t0 < 1.5, "failed after the hang, not in it"
        assert sch.watchdog_trips == 1
        _wait(lambda: sch.in_flight == 0, "zombies not reaped")
        assert len(sch.submit([5, 6], 3).result(60)) == 5
        _clean(sch)
    finally:
        sch.close()
    assert sch._watchdog_thread is None


# -- soaks ---------------------------------------------------------------------

def test_mixed_fault_soak_no_block_leak():
    """``test_faults.py::test_mixed_fault_soak_no_block_leak``: requests
    complete, expire, cancel, preempt and shed under injected step
    delays, and the pool ends clean."""
    from veles_tpu_torch.serving import QueueFullError, SchedulerError
    sch = _sched(_tiny(64), max_slots=2, window=64, kv_blocks=16,
                 max_queue=4, prefill_chunk=4, watchdog=30.0)
    try:
        faults.inject("serving.scheduler.step", "delay", arg=0.002)
        futs = []
        for i in range(12):
            try:
                futs.append(sch.submit(
                    [(i % 11) + 1] * ((i % 5) + 1), 10 + (i % 7),
                    temperature=0.8 if i % 3 else 0.0, seed=i,
                    timeout=0.001 if i % 4 == 3 else 30.0))
            except QueueFullError:
                pass
            if i == 6:
                sch.request_preempt()
            if i == 8 and futs:
                sch.cancel(futs[-1])
            time.sleep(0.01)
        done = failed = 0
        for f in futs:
            try:
                f.result(120)
                done += 1
            except SchedulerError:
                failed += 1
        assert done + failed == len(futs) and done >= 1
        _wait(lambda: sch.in_flight == 0, "requests left in flight")
        _clean(sch)
    finally:
        sch.close()


@pytest.mark.parametrize("kv_dtype", ["fp32", "int8"])
def test_prefix_soak_with_faults(kv_dtype):
    """``test_spec.py::test_prefix_mixed_soak_with_faults`` and
    ``test_kv_quant.py::test_int8_check_kv_clean_under_churn``: warm and
    cold traffic with step delays, prefill exceptions, a preemption and
    a cancel finishes or fails every request without leaking a block
    or a pin; residents stay."""
    import numpy
    from veles_tpu_torch.serving import SchedulerError
    rng = numpy.random.default_rng(3)
    warm_p = rng.integers(0, 12, (16,)).tolist()
    sch = _sched(_tiny(48), max_slots=3, window=48, kv_blocks=24,
                 kv_dtype=kv_dtype, prefill_chunk=8, spec=True, spec_k=2,
                 request_timeout=60.0)
    try:
        sch.submit(warm_p, 6, seed=0).result(240)
        faults.load("serving.scheduler.step=delay:0.002x20;"
                    "serving.scheduler.prefill=exception@3x2")
        futs = []
        for i in range(16):
            p = warm_p if i % 2 else \
                rng.integers(0, 12, (rng.integers(4, 20),)).tolist()
            futs.append(sch.submit(p, 6, seed=i,
                                   **(dict(temperature=0.8, top_k=4)
                                      if i % 3 == 0 else {})))
            if i == 7:
                sch.request_preempt()
            if i == 9:
                sch.cancel(futs[3])
        done = failed = 0
        for f in futs:
            try:
                f.result(240)
                done += 1
            except SchedulerError:
                failed += 1
        assert done + failed == 16
        assert failed >= 1, "the injected prefill faults never fired"
        assert done >= 8
        faults.clear()
        assert sch.prefix_cache_hits >= 1
        _wait(lambda: sch.in_flight == 0, "requests left in flight")
        sch.check_kv()
        assert sch.active_slots == 0
        assert sch.prefix_cache_blocks_resident > 0
    finally:
        sch.close()
    _clean(sch)


def test_concurrent_clients_keep_the_books():
    """Eight client threads (more than the cores the suite gives a
    worker) submit, cancel and hit the shed and the depth cap against
    one loop while the interpreter switches threads every 10 µs: every
    future settles and is counted once (completed, cancelled, expired,
    shed while queued), each refusal is counted once, the queue's
    committed-block count returns to 0 and the pool is clean — a lost
    update in the shared books would break one of these."""
    import sys
    import threading
    from veles_tpu_torch.serving import (
        DeadlineExceededError, QueueFullError, RequestCancelledError)
    sch = _sched(_tiny(64), max_slots=2, window=64, kv_blocks=24,
                 max_queue=6, prefill_chunk=4, shed_block_factor=1.0)
    futs, refused, lock = [], [], threading.Lock()

    def client(k):
        for i in range(8):
            try:
                f = sch.submit([k + 1, i + 1], 4 + (i % 3), seed=k,
                               timeout=0.002 if (k + i) % 7 == 0 else 30.0,
                               priority=(k + i) % 3)
            except QueueFullError as e:
                with lock:
                    refused.append(str(e).split(" ")[0])
                continue
            with lock:
                futs.append(f)
            if (k + i) % 5 == 0:
                sch.cancel(f)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
            assert not t.is_alive()
        outcome = {"done": 0, "cancelled": 0, "expired": 0, "evicted": 0}
        for f in futs:
            try:
                f.result(60)
                outcome["done"] += 1
            except RequestCancelledError:
                outcome["cancelled"] += 1
            except DeadlineExceededError:
                outcome["expired"] += 1
            except QueueFullError as e:
                assert str(e).startswith("shed while queued")
                outcome["evicted"] += 1
    finally:
        sys.setswitchinterval(old)
    try:
        _wait(lambda: sch.in_flight == 0, "requests left in flight")
        assert outcome["done"] == len(sch.completed) > 0
        assert outcome["cancelled"] == sch.requests_cancelled
        assert outcome["expired"] == sch.requests_expired
        assert sch.requests_shed \
            == refused.count("overloaded") + outcome["evicted"]
        assert sch.requests_rejected == len(refused) + outcome["evicted"]
        assert sch._queued_blocks == 0
        _clean(sch)
    finally:
        sch.close()
