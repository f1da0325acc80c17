"""Telemetry of the port: the process-wide :data:`metrics` registry
(:mod:`~veles_tpu_torch.telemetry.registry`), per-request traces
(:mod:`~veles_tpu_torch.telemetry.reqtrace`) and workflow spans
(:mod:`~veles_tpu_torch.telemetry.spans`, converted for Perfetto by
:mod:`~veles_tpu_torch.telemetry.trace_export`) over the event sink
:data:`veles_tpu_torch.logger.events`, the training-health monitor
(:mod:`~veles_tpu_torch.telemetry.health`), the kernel-build and call
counts (:mod:`~veles_tpu_torch.telemetry.compile_tracker`), the crash
flight recorder
(:mod:`~veles_tpu_torch.telemetry.flight_recorder`), the embedded
time-series store (:mod:`~veles_tpu_torch.telemetry.tsdb`), the alert
engine (:mod:`~veles_tpu_torch.telemetry.alerts`), the fleet metrics
federation (:mod:`~veles_tpu_torch.telemetry.federation`) and the
serving dashboard (:mod:`~veles_tpu_torch.telemetry.dashboard`) — the
port's own copies of the JAX package's ``telemetry`` pieces that the serving path
and ``/healthz``/``/debug/state`` read, and the workflow runtime's
switch :func:`enabled`."""

from veles_tpu_torch.telemetry.registry import (  # noqa: F401
    Counter, DEFAULT_BUCKETS, Gauge, Histogram, MS_BUCKETS,
    MetricsRegistry, metrics, nearest_rank, render_families_text)

from veles_tpu_torch.telemetry.compile_tracker import (  # noqa: E402,F401
    compile_summary, cost_summary, maybe_profiler_trace, track_jit)
from veles_tpu_torch.telemetry.alerts import (  # noqa: E402,F401
    AlertEngine, AlertRule, default_rules, firing_table)
from veles_tpu_torch.telemetry.federation import (  # noqa: E402,F401
    fleet_families, merge_scrapes, parse_prometheus)
from veles_tpu_torch.telemetry.flight_recorder import (  # noqa: E402,F401
    FlightRecorder, recorder)
from veles_tpu_torch.telemetry.health import (  # noqa: E402,F401
    HealthMonitor, configure, health_config, monitor)
from veles_tpu_torch.telemetry.reqtrace import (  # noqa: E402,F401
    TRACE_HEADER, clean_trace_id, ensure_trace_id, new_trace_id)
from veles_tpu_torch.telemetry.spans import (  # noqa: E402,F401
    iter_spans, next_span_id, span)
from veles_tpu_torch.telemetry.tsdb import (  # noqa: E402,F401
    DEFAULT_TIERS, TimeSeriesStore, bundle_history, history_query)


#: the reference's ``root.common.telemetry.enabled`` (default True)
_ENABLED = [True]


def enabled():
    """Whether the workflow runtime's per-unit events and histograms are
    recorded (the metrics registry itself is always live)."""
    return _ENABLED[0]


def set_enabled(flag):
    """Turn the per-unit instrumentation on or off, process-wide."""
    _ENABLED[0] = bool(flag)


