"""The port's workflow tracing (``telemetry/spans.py``) and its trace
exporter (``telemetry/trace_export.py``) held against the JAX package's
on the CPU.  Oracles: ``tests/test_telemetry.py::
test_unit_span_pairing_and_histograms``, ``test_chrome_trace_export_
roundtrip``, ``test_trace_export_skips_malformed_lines``,
``test_trace_export_cli`` and ``tests/test_reqtrace.py::
test_trace_export_request_merges_and_adjusts_skew``: the same logs go
through both exporters, whose Chrome JSON agrees but for
``otherData.source``."""

import json
import threading
import time

import pytest

from veles_tpu_torch.logger import events
from veles_tpu_torch.telemetry import metrics, next_span_id, span
from veles_tpu_torch.telemetry import trace_export
from veles_tpu_torch.units import Unit
from veles_tpu_torch.workflow import Workflow

pytestmark = pytest.mark.torch_port


def _run_workflow(n_runs=2):
    class Work(Unit):
        def run(self):
            time.sleep(0.001)

    wf = Workflow(None, name="torch-telemetry-wf")
    a = Work(wf, name="ttele-a")
    b = Work(wf, name="ttele-b")
    c = Work(wf, name="ttele-c")
    a.link_from(wf.start_point)
    b.link_from(a)
    c.link_from(a, b)   # multi-input: exercises gate-wait
    wf.end_point.link_from(c)
    wf.initialize()
    for _ in range(n_runs):
        wf.run()
    return wf


def _recorded(path):
    return [json.loads(line) for line in path.read_text().splitlines()]


def _pairs(recorded, prefix):
    begins, pairs = {}, 0
    for ev in recorded:
        if not str(ev["name"]).startswith(prefix):
            continue
        if ev["kind"] == "begin":
            assert ev["span"] not in begins
            begins[ev["span"]] = ev
        elif ev["kind"] == "end":
            assert ev["span"] in begins, "end without begin"
            b = begins.pop(ev["span"])
            assert b["name"] == ev["name"] and b["tid"] == ev["tid"]
            assert ev["duration"] >= 0
            pairs += 1
    assert not begins, "begin without end: %r" % begins
    return pairs


def test_unit_span_pairing_and_histograms(tmp_path):
    log = tmp_path / "run.jsonl"
    events.open(str(log))
    try:
        wf = _run_workflow(n_runs=3)
    finally:
        events.close()
    recorded = _recorded(log)
    assert all("gate_wait" in ev for ev in recorded
               if ev["name"].startswith("unit:") and ev["kind"] == "end")
    # 3 runs x (3 Work units + Start/End plumbing) = 15 pairs
    assert _pairs(recorded, "unit:") == 3 * 5
    assert _pairs(recorded, "workflow run") == 3
    fam = metrics.get("veles_unit_run_seconds")
    for u in wf:
        child = fam.children().get((u.name,))
        assert child is not None and child.count >= u.timers["runs"]
    waits = metrics.get("veles_unit_gate_wait_seconds").children()
    assert waits[("ttele-c",)].count >= 3


def test_span_pairing_across_threads(tmp_path):
    """Spans of interleaved threads pair by their ids; an exception
    names its type on the end event."""
    log = tmp_path / "threads.jsonl"
    events.open(str(log))
    barrier = threading.Barrier(4)

    def work(i):
        barrier.wait()
        for j in range(5):
            with span("thread work", worker=i, item=j):
                time.sleep(0.0005)
    try:
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        with pytest.raises(KeyError):
            with span("failing"):
                raise KeyError("x")
    finally:
        events.close()
    recorded = _recorded(log)
    assert _pairs(recorded, "thread work") == 20
    ends = [ev for ev in recorded if ev["name"] == "thread work"
            and ev["kind"] == "end"]
    assert sorted((ev["worker"], ev["item"]) for ev in ends) == \
        [(i, j) for i in range(4) for j in range(5)]
    end = [ev for ev in recorded if ev["name"] == "failing"
           and ev["kind"] == "end"]
    assert end and end[0]["error"] == "KeyError"
    a, b = next_span_id(), next_span_id()
    assert a != b and a.split("-")[0] == b.split("-")[0]


def test_chrome_trace_export_roundtrip(tmp_path):
    """A recorded run's log exports to valid Chrome trace JSON, equal to
    the JAX exporter's on the same log."""
    from veles_tpu.telemetry import trace_export as jax_export
    log = tmp_path / "run.jsonl"
    events.open(str(log))
    try:
        _run_workflow(n_runs=2)
        with span("custom block", detail="x"):
            pass
        events.record("one-shot", "single", duration=0.25)
        events.record("instant", "single")
    finally:
        events.close()
    out, jout = tmp_path / "trace.json", tmp_path / "jtrace.json"
    n = trace_export.export(str(log), str(out))
    assert jax_export.export(str(log), str(jout)) == n
    trace, jtrace = json.loads(out.read_text()), \
        json.loads(jout.read_text())
    assert trace["traceEvents"] == jtrace["traceEvents"]
    assert trace["otherData"]["source"] == \
        "veles_tpu_torch.telemetry.trace_export"
    trace["otherData"].pop("source")
    jtrace["otherData"].pop("source")
    assert trace == jtrace
    tev = trace["traceEvents"]
    assert len(tev) == n and n > 0
    stacks = {}
    for ev in tev:
        key = (ev["pid"], ev["tid"])
        if ev["ph"] == "B":
            stacks.setdefault(key, []).append(ev["name"])
        elif ev["ph"] == "E":
            assert stacks[key].pop() == ev["name"], "unbalanced nesting"
        elif ev["ph"] == "X":
            assert ev["dur"] >= 0
    assert all(not s for s in stacks.values()), "unclosed B events"
    assert any(e["ph"] == "X" and e["name"] == "one-shot" for e in tev)
    assert any(e["ph"] == "i" and e["name"] == "instant" for e in tev)
    assert min(e["ts"] for e in tev if e["ph"] != "X") == 0.0


def test_trace_export_skips_malformed_lines(tmp_path):
    from veles_tpu.telemetry import trace_export as jax_export
    log = tmp_path / "torn.jsonl"
    good = {"name": "a", "kind": "single", "time": 1.0, "pid": 1,
            "tid": 1, "duration": 0.5}
    log.write_text(json.dumps(good) + "\n{torn tail\n[1, 2]\n\n")
    out, jout = tmp_path / "trace.json", tmp_path / "jtrace.json"
    assert trace_export.export(str(log), str(out)) == 1
    jax_export.export(str(log), str(jout))
    got, want = json.loads(out.read_text()), json.loads(jout.read_text())
    assert got["otherData"]["skipped_lines"] == 2
    assert got["traceEvents"] == want["traceEvents"]
    stats = {}
    assert list(trace_export.iter_spans(str(log), stats)) == [good]
    assert stats["skipped"] == 2


def test_trace_export_cli(tmp_path, capsys):
    log = tmp_path / "run.jsonl"
    log.write_text(json.dumps(
        {"name": "a", "kind": "begin", "time": 1.0, "pid": 1,
         "tid": 1}) + "\n")
    assert trace_export.main([str(log), str(tmp_path / "t.json")]) == 0
    assert "wrote 1 trace events" in capsys.readouterr().out
    assert trace_export.main([]) == 2
    assert trace_export.main(["--request"]) == 2
    assert trace_export.main(["--request", "x", "-o"]) == 2


def _write_jsonl(path, evs):
    with open(path, "w") as f:
        for ev in evs:
            f.write(json.dumps(ev) + "\n")


def test_trace_export_request_merges_and_adjusts_skew(tmp_path, capsys):
    """``--request``: a router log and a replica log in another clock
    domain merge into one nested timeline, the shift counted — the
    same file as the JAX exporter writes."""
    from veles_tpu.telemetry import trace_export as jax_export
    t = 1000.0
    router_log = tmp_path / "router.jsonl"
    replica_log = tmp_path / "replica.jsonl"
    _write_jsonl(str(router_log), [
        {"name": "router.request", "kind": "begin", "time": t,
         "pid": 10, "tid": 0, "span": "10-1", "trace": "sk-1"},
        {"name": "router.attempt", "kind": "begin", "time": t + 0.01,
         "pid": 10, "tid": 0, "span": "10-2", "trace": "sk-1",
         "attempt": 1, "replica": "pid77:9000"},
        {"name": "router.attempt", "kind": "end", "time": t + 0.5,
         "pid": 10, "tid": 0, "span": "10-2", "trace": "sk-1"},
        {"name": "router.request", "kind": "end", "time": t + 0.51,
         "pid": 10, "tid": 0, "span": "10-1", "trace": "sk-1"},
        {"name": "unrelated", "kind": "single", "time": t,
         "pid": 10, "tid": 0, "trace": "other"},
    ])
    _write_jsonl(str(replica_log), [
        {"name": "req.queue", "kind": "single", "time": 5.0,
         "pid": 77, "tid": 1, "trace": "sk-1", "duration": 0.002},
        {"name": "req.step", "kind": "single", "time": 5.1,
         "pid": 77, "tid": 1, "traces": {"sk-1": 1, "zz": 1},
         "duration": 0.01},
        {"name": "req.retire", "kind": "single", "time": 5.2,
         "pid": 77, "tid": 1, "trace": "sk-1", "outcome": "ok"},
        {"name": "req.open", "kind": "begin", "time": 5.3,
         "pid": 77, "tid": 1, "trace": "sk-1", "span": "77-9"},
    ])
    out = tmp_path / "trace.json"
    assert trace_export.main(["--request", "sk-1", "-o", str(out),
                              str(router_log), str(replica_log)]) == 0
    assert "request sk-1" in capsys.readouterr().out
    jout = tmp_path / "jtrace.json"
    jax_export.export_request([str(router_log), str(replica_log)],
                              "sk-1", str(jout))
    got, want = json.loads(out.read_text()), json.loads(jout.read_text())
    assert got["otherData"]["skew_adjusted"] == 1
    assert got["traceEvents"] == want["traceEvents"]
    by_name = {e["name"]: e for e in got["traceEvents"] if e["ph"] != "M"}
    assert "unrelated" not in by_name
    assert by_name["req.queue"]["ts"] >= by_name["router.attempt"]["ts"]
    assert by_name["req.step"]["args"]["tokens"] == 1
    # a log without the id still writes a trace, empty but for metadata
    n = trace_export.export_request([str(replica_log)], "none",
                                    str(tmp_path / "e.json"))
    assert n == 2
