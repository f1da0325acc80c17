"""JSONL span log → Chrome ``trace_event`` JSON (the port's own copy
of ``veles_tpu/telemetry/trace_export.py``).

The EventSink's JSONL file (``EventSink.open``) is greppable but not
visual; this converter turns a recorded run into the Chrome trace
format that https://ui.perfetto.dev (and ``chrome://tracing``) load
directly::

    python -m veles_tpu_torch.telemetry.trace_export run.jsonl trace.json

Mapping:

- ``begin``/``end`` events → ``B``/``E`` phase pairs (Perfetto nests
  them per pid/tid track, so per-unit spans stack under the workflow
  run span);
- ``single`` events with a ``duration`` → ``X`` complete events
  (``ts`` backdated by the duration so the bar ends at record time);
- other ``single`` events → ``i`` instants;
- remaining attributes ride along as ``args`` (visible on click).

Timestamps are microseconds relative to the first event, keeping the
numbers readable in the UI.

**Per-request mode** (``--request``) answers "why did THIS request
take 3 s": it merges the router's JSONL log with N replica logs,
keeps only the events carrying the trace id (``trace`` attr, or the
id inside a batched ``req.step`` span's ``traces`` map), and emits
ONE timeline track where the ``router.request`` span parents its
``router.attempt`` children, which in turn parent the winning
replica's queue → admit → prefill → step → retire phases by time
containment::

    python -m veles_tpu_torch.telemetry.trace_export --request <id> \\
        -o trace.json router.jsonl replica0.jsonl replica1.jsonl

Merging logs from different processes mixes clock domains: a replica
log whose events land BEFORE the router attempt that produced them
(wallclock skew, or a writer that recorded monotonic stamps) would
silently render a misordered timeline.  Per-request mode detects
that per source file, shifts the file's events to just after their
parenting attempt (matched by replica pid when the replica id is
the default ``pid<N>:<port>`` shape, else the request edge), WARNS,
and counts the shifts in ``otherData.skew_adjusted`` — loud, not
silent.
"""

import json
import logging
import sys

from veles_tpu_torch.telemetry.spans import iter_spans

_META = ("name", "kind", "time", "pid", "tid")


def _args(ev):
    return {k: v for k, v in ev.items() if k not in _META}


def spans_to_chrome(events, t0=None):
    """Convert an iterable of span-event dicts to a list of Chrome
    trace events.  ``t0`` pins the timeline origin (defaults to the
    first event's timestamp)."""
    out = []
    for ev in events:
        try:
            t = float(ev["time"])
            kind = ev["kind"]
            name = str(ev["name"])
        except (KeyError, TypeError, ValueError):
            continue
        if t0 is None:
            t0 = t
        pid = int(ev.get("pid", 0))
        tid = int(ev.get("tid", 0))
        ts = (t - t0) * 1e6
        cat = str(ev.get("cls", ev.get("unit", "span")))
        if kind == "begin":
            out.append({"name": name, "ph": "B", "ts": ts, "pid": pid,
                        "tid": tid, "cat": cat, "args": _args(ev)})
        elif kind == "end":
            out.append({"name": name, "ph": "E", "ts": ts, "pid": pid,
                        "tid": tid, "cat": cat, "args": _args(ev)})
        elif kind == "single" and ev.get("duration") is not None:
            try:
                dur = float(ev["duration"]) * 1e6
            except (TypeError, ValueError):
                continue
            out.append({"name": name, "ph": "X", "ts": ts - dur,
                        "dur": dur, "pid": pid, "tid": tid,
                        "cat": cat, "args": _args(ev)})
        else:
            out.append({"name": name, "ph": "i", "ts": ts, "pid": pid,
                        "tid": tid, "cat": cat, "s": "t",
                        "args": _args(ev)})
    return out


def export(in_path, out_path):
    """Convert the JSONL span log at ``in_path`` into a Chrome trace
    JSON at ``out_path``; returns the number of trace events.

    Corrupt/truncated lines (a crashed writer's torn tail) are
    counted and warned about, never fatal — the point of a flight
    recording is that it converts AFTER the crash."""
    stats = {}
    trace = {
        "traceEvents": spans_to_chrome(iter_spans(in_path, stats)),
        "displayTimeUnit": "ms",
        "otherData": {"source": "veles_tpu_torch.telemetry.trace_export",
                      "input": str(in_path)},
    }
    skipped = stats.get("skipped", 0)
    if skipped:
        trace["otherData"]["skipped_lines"] = skipped
        logging.getLogger("trace_export").warning(
            "%s: skipped %d corrupt/truncated line(s) — likely a "
            "crash-torn tail; the remaining %d events converted",
            in_path, skipped, len(trace["traceEvents"]))
    with open(out_path, "w") as f:
        json.dump(trace, f)
        f.write("\n")
    return len(trace["traceEvents"])


# -- per-request merge (--request) --------------------------------------------

def _request_events(path, trace_id, stats):
    """The events of one JSONL file that belong to ``trace_id``: a
    matching ``trace`` attr, or membership in a batched ``req.step``
    span's ``traces`` map (projected down to this request's token
    count)."""
    out = []
    for ev in iter_spans(path, stats):
        if ev.get("trace") == trace_id:
            out.append(dict(ev))
            continue
        traces = ev.get("traces")
        if isinstance(traces, dict) and trace_id in traces:
            ev = dict(ev)
            ev["tokens"] = ev.pop("traces")[trace_id]
            ev["trace"] = trace_id
            out.append(ev)
    return out


def _attempt_windows(events):
    """(begin_time, replica) per ``router.attempt`` begin event —
    the parent candidates a replica file's spans nest under."""
    return [(float(ev["time"]), str(ev.get("replica", "")))
            for ev in events
            if ev.get("name") == "router.attempt"
            and ev.get("kind") == "begin" and "time" in ev]


def _adjust_skew(per_file, log):
    """Shift replica files whose events PRECEDE the router span that
    parents them (clock skew / a monotonic-stamped writer) so the
    merged timeline nests instead of misordering.  Returns the shift
    count; mutates event times in place."""
    router_events = []
    for path, events in per_file:
        if any(str(ev.get("name", "")).startswith("router.")
               for ev in events):
            router_events.extend(events)
    if not router_events:
        return 0  # single-process log (or no router leg recorded)
    begins = [float(ev["time"]) for ev in router_events
              if ev.get("name") == "router.request"
              and ev.get("kind") == "begin" and "time" in ev]
    edge = min(begins) if begins \
        else min(float(ev["time"]) for ev in router_events
                 if "time" in ev)
    attempts = _attempt_windows(router_events)
    adjusted = 0
    for path, events in per_file:
        if not events \
                or any(str(ev.get("name", "")).startswith("router.")
                       for ev in events):
            continue  # router-side (or empty) file: the reference
        times = []
        for ev in events:
            if "time" not in ev:
                continue
            t = float(ev["time"])
            try:
                # a single with a duration RENDERS from time - dur
                # (backdated complete slice) — align that edge, not
                # the record stamp, or the shifted span still pokes
                # out before its parent
                t -= float(ev.get("duration") or 0.0)
            except (TypeError, ValueError):
                pass
            times.append(t)
        if not times:
            continue
        t_first = min(times)
        # the parenting attempt: matched by the replica-id pid
        # convention ("pid<N>:<port>") when it holds, else the edge
        parent = edge
        pids = {ev.get("pid") for ev in events if "pid" in ev}
        matched = [t for t, rid in attempts
                   if any(rid.startswith("pid%d:" % p)
                          for p in pids if p is not None)]
        if matched:
            parent = min(matched)
        if t_first >= parent:
            continue
        shift = parent - t_first + 1e-4
        for ev in events:
            if "time" in ev:
                ev["time"] = float(ev["time"]) + shift
        adjusted += 1
        log.warning(
            "%s: events for this request start %.3fs BEFORE the "
            "router span that parents them (clock skew or a "
            "monotonic-vs-wallclock mix) — shifted +%.3fs to nest",
            path, parent - t_first, shift)
    return adjusted


def _complete_events(events, t0):
    """One flat timeline track: begin/end pairs matched by span id
    into ``X`` complete slices, singles with a duration backdated
    into ``X``, the rest ``i`` instants.  A single track makes time
    containment THE parent relation — the router attempt slice
    visually parents the replica phase slices inside it."""
    out = []
    open_spans = {}
    for ev in sorted(events, key=lambda e: float(e.get("time", 0))):
        try:
            t = float(ev["time"])
            kind = ev["kind"]
            name = str(ev["name"])
        except (KeyError, TypeError, ValueError):
            continue
        cat = "router" if name.startswith("router.") else "replica"
        base = {"name": name, "pid": 0, "tid": 0, "cat": cat}
        if kind == "begin":
            open_spans[ev.get("span")] = (t, ev)
        elif kind == "end":
            pair = open_spans.pop(ev.get("span"), None)
            if pair is None:
                out.append({**base, "ph": "i", "ts": (t - t0) * 1e6,
                            "s": "t", "args": _args(ev)})
                continue
            tb, bev = pair
            args = _args(bev)
            args.update(_args(ev))
            args.pop("span", None)
            out.append({**base, "ph": "X", "ts": (tb - t0) * 1e6,
                        "dur": max(0.0, (t - tb) * 1e6),
                        "args": args})
        elif ev.get("duration") is not None:
            try:
                dur = float(ev["duration"]) * 1e6
            except (TypeError, ValueError):
                continue
            out.append({**base, "ph": "X", "ts": (t - t0) * 1e6 - dur,
                        "dur": dur, "args": _args(ev)})
        else:
            out.append({**base, "ph": "i", "ts": (t - t0) * 1e6,
                        "s": "t", "args": _args(ev)})
    for span, (tb, bev) in open_spans.items():  # crash-torn begins
        out.append({"name": str(bev.get("name")), "pid": 0, "tid": 0,
                    "cat": "span", "ph": "i", "ts": (tb - t0) * 1e6,
                    "s": "t", "args": _args(bev)})
    out.sort(key=lambda e: (e["ts"], -e.get("dur", 0.0)))
    return out


def export_request(paths, trace_id, out_path):
    """Merge the JSONL logs at ``paths`` (router + N replicas, any
    order) into ONE parented Chrome trace for ``trace_id`` at
    ``out_path``; returns the number of trace events.  Corrupt lines
    are counted and skipped; cross-file clock skew is warned about,
    adjusted, and counted in ``otherData.skew_adjusted``."""
    log = logging.getLogger("trace_export")
    stats = {}
    per_file = [(p, _request_events(p, trace_id, stats))
                for p in paths]
    skew = _adjust_skew(per_file, log)
    merged = [ev for _, events in per_file for ev in events]
    times = [float(ev["time"]) for ev in merged if "time" in ev]
    t0 = min(times) if times else 0.0
    trace_events = [
        {"ph": "M", "name": "process_name", "pid": 0,
         "args": {"name": "request %s" % trace_id}},
        {"ph": "M", "name": "thread_name", "pid": 0, "tid": 0,
         "args": {"name": "router -> replica timeline"}},
    ] + _complete_events(merged, t0)
    trace = {
        "traceEvents": trace_events,
        "displayTimeUnit": "ms",
        "otherData": {
            "source": "veles_tpu_torch.telemetry.trace_export",
            "request": trace_id,
            "inputs": [str(p) for p in paths],
            "skew_adjusted": skew,
        },
    }
    skipped = stats.get("skipped", 0)
    if skipped:
        trace["otherData"]["skipped_lines"] = skipped
        log.warning("skipped %d corrupt/truncated line(s) across "
                    "%d input file(s)", skipped, len(paths))
    if not merged:
        log.warning("no events carry trace id %r — is tracing "
                    "enabled and are "
                    "these the right logs?", trace_id)
    with open(out_path, "w") as f:
        json.dump(trace, f)
        f.write("\n")
    return len(trace["traceEvents"])


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    usage = ("usage: python -m veles_tpu_torch.telemetry.trace_export "
             "<run.jsonl> <trace.json>\n"
             "       python -m veles_tpu_torch.telemetry.trace_export "
             "--request ID [-o trace.json] <router.jsonl> "
             "[replica.jsonl ...]")
    if "--request" in argv:
        i = argv.index("--request")
        try:
            trace_id = argv[i + 1]
        except IndexError:
            print(usage, file=sys.stderr)
            return 2
        del argv[i:i + 2]
        out_path = "trace-%s.json" % trace_id
        if "-o" in argv:
            j = argv.index("-o")
            try:
                out_path = argv[j + 1]
            except IndexError:
                print(usage, file=sys.stderr)
                return 2
            del argv[j:j + 2]
        if not argv:
            print(usage, file=sys.stderr)
            return 2
        n = export_request(argv, trace_id, out_path)
        print("wrote %d trace events for request %s to %s (open in "
              "https://ui.perfetto.dev)" % (n, trace_id, out_path))
        return 0
    if len(argv) != 2:
        print(usage, file=sys.stderr)
        return 2
    n = export(argv[0], argv[1])
    print("wrote %d trace events to %s (open in "
          "https://ui.perfetto.dev)" % (n, argv[1]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
