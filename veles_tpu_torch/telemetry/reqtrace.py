"""Per-request traces — the port of ``veles_tpu/telemetry/reqtrace.py``.

A request carries a trace id: minted at submit, or taken from the
client (``X-Veles-Trace``, :data:`TRACE_HEADER`) and sanitized
(:func:`clean_trace_id`: the id is header and log material, so no
whitespace or control bytes survive).  The scheduler records one
``req.<phase>`` event per phase boundary it owns (queue wait,
admission, each prefill chunk, first token, retire) and ONE batched
``req.step`` event per decode or verify boundary, whose ``traces`` map
carries each participating request's emitted tokens — per-slot events
would multiply the hot path's cost by the occupancy.  Events go
through the event sink (:data:`veles_tpu_torch.logger.events`), whose
JSONL file the JAX package's ``trace_export --request <id>`` turns into
one request's timeline.

A process-wide in-flight registry (:func:`register` /
:func:`inflight_table`) enumerates the live requests of every
registered scheduler (trace id, phase, age, blocks held).

Whether a scheduler records events is its own ``reqtrace`` argument;
the router reads :func:`enabled` (``root.common.reqtrace.enabled``).
Trace ids are minted either way.
"""

import os
import re
import threading
import weakref

from veles_tpu_torch.logger import events

#: the propagation and echo header (case-insensitive on the wire)
TRACE_HEADER = "X-Veles-Trace"

#: client-supplied ids are header AND log material: strip anything
#: outside this set
_SAFE = re.compile(r"[^A-Za-z0-9._:-]")
_MAX_ID = 64


def new_trace_id():
    """A fresh 16-hex trace id (64 random bits)."""
    return os.urandom(8).hex()


def clean_trace_id(raw):
    """Sanitize a client-supplied trace id; ``None`` when nothing
    usable survives (the caller then mints a fresh one)."""
    if raw is None:
        return None
    s = _SAFE.sub("", str(raw).strip())[:_MAX_ID]
    return s or None


def ensure_trace_id(raw=None):
    """The sanitized client id when one was sent, else a fresh one."""
    return clean_trace_id(raw) or new_trace_id()


def enabled():
    """Whether request tracing emits span events
    (``root.common.reqtrace.enabled``, default True).  Trace ids are
    minted and echoed regardless — only the event emission is gated."""
    from veles_tpu_torch.config import root
    return bool(root.common.reqtrace.get("enabled", True))


def record(trace, phase, sink=None, **attrs):
    """One request-phase event: ``req.<phase>``, kind ``single``,
    carrying the ``trace`` id.  A ``duration`` attribute (seconds)
    marks the event as the END of a phase of that length."""
    if trace is None:
        return None
    return (sink or events).record("req." + phase, "single",
                                   trace=str(trace), **attrs)


def record_step(traces, sink=None, **attrs):
    """One batched decode or verify boundary: ``traces`` maps each
    participating request's trace id to the tokens it emitted there (0
    for a slot whose drafts were all rejected).  The scheduler passes
    ``time``, the step's end: the event is recorded after the step has
    retired its finished requests, and a trace reader puts an ``X``
    event at ``time - duration``, so stamping it at recording could
    place the step after its own request's retire."""
    if not traces:
        return None
    return (sink or events).record("req.step", "single",
                                   traces=dict(traces), **attrs)


# -- live in-flight registry --------------------------------------------------
#
# Schedulers register themselves weakly: a closed scheduler is not kept
# alive by the registry.

_providers = {}
_plock = threading.Lock()


def register(name, obj, attr="debug_requests"):
    """Register a live in-flight provider: ``obj.<attr>()`` returns a
    list of row dicts (see ``InferenceScheduler.debug_requests``)."""
    with _plock:
        _providers[id(obj)] = (str(name), weakref.ref(obj), str(attr))


def inflight_table():
    """The merged in-flight table of every registered provider, each
    row tagged with its provider's name under ``source``.  Dead
    providers drop out; a provider that raises is skipped."""
    with _plock:
        items = list(_providers.items())
    out = []
    for key, (name, ref, attr) in items:
        obj = ref()
        if obj is None:
            with _plock:
                _providers.pop(key, None)
            continue
        try:
            rows = getattr(obj, attr)()
        except Exception:
            continue
        for row in rows:
            row = dict(row)
            row.setdefault("source", name)
            out.append(row)
    return out
