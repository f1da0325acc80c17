"""Request traces of the PyTorch port (``veles_tpu_torch/telemetry/
reqtrace.py``, ``logger.py`` and the scheduler's ``req.*`` events) held
against the JAX package on the CPU, on the suite's trained chain
(``spec_trained_chain``, f32; the JAX side at ``warm_buckets=False``):

- trace ids mint and sanitize as the reference's do;
- across preempt→resume the same requests give the same ordered
  ``req.*`` and ``serving.preempt`` events with the same attributes,
  less those that measure time (TIME_ATTRS);
- the JAX package's ``trace_export`` reads the port's JSONL log and
  gives the same request timeline as from JAX's own log;
- with ``reqtrace=False`` no ``req.*`` event is recorded and ids are
  still minted;
- ``debug_requests()`` agrees with ``check_kv()``.

The preemption is made deterministic: a one-off hang of the fourth
step holds the loop while ``request_preempt()`` is called (once the
hang has fired), so both schedulers evict the request after the same
four steps."""

import json
import time

import pytest

from veles_tpu import faults as jax_faults
from veles_tpu.config import root
from veles_tpu_torch import faults

from tests.test_torch_serving import _spec
from tests.test_torch_transformer import port_chain

pytestmark = pytest.mark.torch_port

#: event attributes that measure time, left out of the comparison
TIME_ATTRS = ("time", "pid", "tid", "duration", "total_s", "ttft_ms",
              "queued_ms", "duration_ms", "tokens_per_sec")


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


def test_trace_id_minting_and_sanitization():
    from veles_tpu.telemetry import reqtrace as jrt
    from veles_tpu_torch.telemetry import reqtrace
    a, b = reqtrace.new_trace_id(), reqtrace.new_trace_id()
    assert a != b and len(a) == 16
    for raw in ("ok-1.2:3_X", "evil\r\nInjected: 1", "x" * 500, "\r\n ",
                None, "  keep  ", "a/b?c=d"):
        assert reqtrace.clean_trace_id(raw) == jrt.clean_trace_id(raw)
    assert reqtrace.clean_trace_id("evil\r\nInjected: 1") \
        == "evilInjected:1"
    assert reqtrace.clean_trace_id("x" * 500) == "x" * 64
    assert reqtrace.clean_trace_id("\r\n ") is None
    assert reqtrace.ensure_trace_id(None)  # mints
    assert reqtrace.ensure_trace_id("keep") == "keep"
    assert reqtrace.TRACE_HEADER == jrt.TRACE_HEADER
    assert reqtrace.record(None, "x") is None
    assert reqtrace.record_step({}) is None


def _events(sink, trace):
    """The sink's events of ``trace``: its own, and its share of every
    batched ``req.step`` (projected to its token count, as
    ``trace_export`` projects them)."""
    out = []
    for ev in list(sink.ring):
        if ev.get("trace") == trace:
            out.append(dict(ev))
        elif trace in (ev.get("traces") or {}):
            ev = dict(ev)
            ev["tokens"] = ev.pop("traces")[trace]
            ev["trace"] = trace
            out.append(ev)
    return out


def _comparable(evs):
    return [{k: v for k, v in ev.items() if k not in TIME_ATTRS}
            for ev in evs if ev["name"].startswith("req.")
            or ev["name"] in ("serving.preempt", "serving.request")]


def _preempted_run(sch, reg, prompt, trace):
    """One request (10 greedy steps) evicted after its fourth step
    (held by a one-off hang of that step) and resumed."""
    hang = reg.inject("serving.scheduler.step", "hang", arg=1.0, after=3,
                      times=1)
    fut = sch.submit(prompt, 10, trace=trace)
    deadline = time.monotonic() + 240
    while not hang.fired:           # the loop is inside the fourth step
        assert time.monotonic() < deadline
        time.sleep(0.002)
    sch.request_preempt()
    out = fut.result(120)
    snap = sch.metrics()
    assert snap["preempts"] == 1 and snap["preempt_resumes"] == 1
    return out, snap


def _schedulers(spec_trained_chain, **kw):
    from veles_tpu.serving import InferenceScheduler as JSched
    from veles_tpu_torch.serving import InferenceScheduler
    fw, pattern = spec_trained_chain
    chain = port_chain(_spec(fw), fw)
    args = dict(max_slots=2, window=64, block_size=4, prefill_chunk=4,
                spec=False, watchdog=0, prefix_cache=True)
    args.update(kw)
    return (JSched(fw, kv="paged", warm_buckets=False, **args).start(),
            InferenceScheduler(chain, device="cpu", **args).start(),
            pattern)


def test_phase_timeline_across_preempt_resume_matches_jax(
        f32, spec_trained_chain):
    """``test_reqtrace.py::test_phase_timeline_across_preempt_resume``
    against the port: one trace id over the whole lifecycle, queue
    (cold) → admit → prefill chunks → first token → steps → preempt →
    queue (resume) → admit → chunks → steps → retire, the same events
    in the same order with the same attributes as JAX's."""
    from veles_tpu.logger import events as jevents
    from veles_tpu_torch.logger import events
    jsch, tsch, pattern = _schedulers(spec_trained_chain)
    prompt = (pattern * 2)[:6]
    try:
        want_out, want_snap = _preempted_run(jsch, jax_faults, prompt,
                                             "pr-j")
        got_out, got_snap = _preempted_run(tsch, faults, prompt, "pr-t")
    finally:
        jsch.close()
        tsch.close()
    assert got_out == want_out
    want = _comparable(_events(jevents, "pr-j"))
    got = _comparable(_events(events, "pr-t"))
    for ev in want:
        ev["trace"] = "pr-t"
    assert [e["name"] for e in got] == [e["name"] for e in want]
    assert got == want
    names = [e["name"] for e in got]
    assert names.count("req.retire") == 1
    assert [e["resume"] for e in got if e["name"] == "req.queue"] \
        == [False, True]
    assert names.index("serving.preempt") \
        < names.index("req.queue", names.index("req.queue") + 1)
    retire = [e for e in got if e["name"] == "req.retire"][0]
    assert retire["outcome"] == "ok" and retire["preempts"] == 1
    for key in ("preempts", "preempt_resumes", "tokens_generated",
                "slot_busy_steps", "prefill_chunks",
                "prefill_chunk_tokens"):
        assert got_snap[key] == want_snap[key], key


def _timeline(path, trace, tmp_path, tag):
    from veles_tpu.telemetry.trace_export import export_request
    out = tmp_path / ("%s.json" % tag)
    export_request([str(path)], trace, str(out))
    with open(out) as f:
        evs = json.load(f)["traceEvents"]
    return [(e["name"], e["ph"]) for e in evs if e["ph"] != "M"]


def test_trace_export_reads_the_port_log(f32, spec_trained_chain,
                                         tmp_path):
    """The port's JSONL log, read by the JAX package's
    ``trace_export.export_request``, gives the request timeline JAX's
    own log gives (span names, kinds and order)."""
    from veles_tpu.logger import events as jevents
    from veles_tpu_torch.logger import events
    jsch, tsch, pattern = _schedulers(spec_trained_chain)
    prompt = (pattern * 2)[:10]
    jpath, tpath = tmp_path / "jax.jsonl", tmp_path / "port.jsonl"
    try:
        jevents.open(str(jpath))
        events.open(str(tpath))
        want_out = jsch.submit(prompt, 6, trace="exp-1").result(120)
        got_out = tsch.submit(prompt, 6, trace="exp-1").result(120)
    finally:
        # a loop records a step's req.step event after the step has
        # resolved its requests: stop the loops before the logs close,
        # or the last step's event can miss the file
        jsch.close()
        tsch.close()
        jevents.close()
        events.close()
    assert got_out == want_out
    with open(tpath) as f:
        lines = [json.loads(line) for line in f]
    assert lines and all({"name", "kind", "time", "pid", "tid"} <= set(ev)
                         for ev in lines)
    want = _timeline(jpath, "exp-1", tmp_path, "jax")
    got = _timeline(tpath, "exp-1", tmp_path, "port")
    assert got == want
    assert [n for n, _ in got][:2] == ["req.queue", "req.admit"]
    assert ("req.retire", "i") in got and ("req.step", "X") in got


def test_reqtrace_off_records_no_phase_events(f32, spec_trained_chain):
    """``reqtrace=False``: the request's only event is its
    ``serving.request`` record; its given id, and a minted one, still
    label the in-flight rows."""
    from veles_tpu_torch.logger import events
    from veles_tpu_torch.serving import InferenceScheduler
    fw, pattern = spec_trained_chain
    sch = InferenceScheduler(port_chain(_spec(fw), fw), max_slots=2,
                             window=64, block_size=4, prefill_chunk=4,
                             spec=False, watchdog=0, reqtrace=False,
                             device="cpu").start()
    try:
        fut = sch.submit((pattern * 2)[:6], 4, trace="off-1")
        rows = sch.debug_requests()
        fut.result(120)
        minted = sch.submit((pattern * 2)[:6], 2)
        rows_minted = sch.debug_requests()
        minted.result(120)
    finally:
        sch.close()
    evs = _events(events, "off-1")
    assert not any(e["name"].startswith("req.") for e in evs)
    assert [e["name"] for e in evs] == ["serving.request"]
    assert all(r["trace"] == "off-1" for r in rows)
    assert all(r["trace"] and len(r["trace"]) == 16 for r in rows_minted)


def test_debug_requests_consistent_with_check_kv(f32, spec_trained_chain):
    """``test_reqtrace.py::test_debug_requests_consistent_with_check_kv``
    on the port: the private blocks summed over the in-flight rows
    equal ``used_blocks`` less the prefix cache's residents while
    ``check_kv()`` passes with the table non-empty, and the process-wide
    in-flight table lists the same requests."""
    from veles_tpu_torch.serving import InferenceScheduler
    from veles_tpu_torch.telemetry import reqtrace
    fw, pattern = spec_trained_chain
    sch = InferenceScheduler(port_chain(_spec(fw), fw), max_slots=2,
                             window=64, block_size=4, prefill_chunk=4,
                             spec=False, watchdog=0, device="cpu").start()
    try:
        faults.inject("serving.scheduler.step", "delay", arg=0.02)
        futs = [sch.submit([7, 2, 5, 1], 12, trace="dbg-%d" % i)
                for i in range(3)]
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            rows = sch.debug_requests()
            decoding = [r for r in rows if r["phase"] == "decode"]
            if len(decoding) >= 2:
                break
            time.sleep(0.01)
        assert len(decoding) >= 2
        # hold the loop inside one step (a one-off hang, as the
        # preemption test does) so every read below sees one state
        hang = faults.inject("serving.scheduler.step", "hang", arg=2.0,
                             times=1)
        while not hang.fired:
            assert time.monotonic() < deadline
            time.sleep(0.002)
        rows = sch.debug_requests()
        decoding = [r for r in rows if r["phase"] == "decode"]
        assert len(decoding) >= 2
        assert {r["phase"] for r in rows} <= {"queued", "admitting",
                                               "prefill", "decode"}
        for r in rows:
            assert r["trace"].startswith("dbg-")
            assert r["cls"] == "normal" and r["age_s"] >= 0
            assert r["blocks_budget"] > 0 and r["stream"] is False
        private = sum(r["blocks"] - r["blocks_shared"] for r in rows)
        resident = sch.prefix_.resident if sch.prefix_ is not None else 0
        assert private == sch.cache_.used_blocks - resident
        sch.check_kv()
        table = reqtrace.inflight_table()
        assert any(str(r.get("trace", "")).startswith("dbg-")
                   and r["source"] == "scheduler" for r in table)
        faults.clear()
        for f in futs:
            f.result(240)
    finally:
        faults.clear()
        sch.close()
    sch.check_kv()
    assert sch.debug_requests() == []
