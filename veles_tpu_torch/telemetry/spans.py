"""Span pipeline — structured begin/end tracing over the EventSink (the
port's own copy of ``veles_tpu/telemetry/spans.py``).

The :class:`veles_tpu_torch.logger.EventSink` records raw ``begin``/``end``/
``single`` events; this module adds the *workflow tracing* contract on
top:

- :func:`span` — a context manager emitting a ``begin``/``end`` pair
  that shares a unique ``span`` id, with the measured ``duration``
  (seconds) attached to the ``end`` event, so every begin can be paired
  with its end even across interleaved threads;
- :func:`iter_spans` — stream a recorded JSONL span log back as dicts
  (the reader side used by :mod:`veles_tpu_torch.telemetry.trace_export`).

The per-unit spans the scheduler emits (``unit:<name>`` in
:meth:`veles_tpu_torch.units.Unit._run_wrapped`) and the ``workflow run`` wave (:meth:`veles_tpu_torch.workflow.Workflow.
run`) follow the same schema.
"""

import itertools
import json
import os
import time

from veles_tpu_torch.logger import events as default_sink

_span_ids = itertools.count(1)


def next_span_id():
    """Process-unique span id (pid-qualified so merged logs from a
    coordinator fleet keep their pairs distinct)."""
    return "%d-%d" % (os.getpid(), next(_span_ids))


class span:
    """Context manager emitting a paired begin/end span::

        with span("load checkpoint", path=p):
            ...

    The end event carries ``duration`` (seconds) and ``error`` (the
    exception type name) when the block raised."""

    def __init__(self, name, sink=None, **attrs):
        self.name = name
        self.sink = sink or default_sink
        self.attrs = attrs
        self.span_id = None
        self._t0 = None

    def __enter__(self):
        self.span_id = next_span_id()
        self._t0 = time.time()
        self.sink.record(self.name, "begin", span=self.span_id,
                         **self.attrs)
        return self

    def __exit__(self, exc_type, exc, tb):
        attrs = dict(self.attrs)
        attrs["duration"] = time.time() - self._t0
        if exc_type is not None:
            attrs["error"] = exc_type.__name__
        self.sink.record(self.name, "end", span=self.span_id, **attrs)
        return False


def iter_spans(path, stats=None):
    """Yield the events of a JSONL span log as dicts; malformed lines
    (a crashed writer's torn tail, binary garbage, non-dict JSON) are
    skipped, not fatal.  Pass a dict as ``stats`` to learn how many
    lines were dropped (``stats["skipped"]``) — the trace exporter
    reports it so a crash-truncated log converts loudly, not
    silently."""
    if stats is not None:
        stats.setdefault("skipped", 0)
    with open(path, errors="replace") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                ev = json.loads(line)
            except ValueError:
                if stats is not None:
                    stats["skipped"] += 1
                continue
            if isinstance(ev, dict):
                yield ev
            elif stats is not None:
                stats["skipped"] += 1
