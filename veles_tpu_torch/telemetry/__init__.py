"""Telemetry of the port: the process-wide :data:`metrics` registry
(:mod:`~veles_tpu_torch.telemetry.registry`), per-request traces
(:mod:`~veles_tpu_torch.telemetry.reqtrace`) over the event sink
:data:`veles_tpu_torch.logger.events`, the training-health monitor
(:mod:`~veles_tpu_torch.telemetry.health`) and the crash flight recorder
(:mod:`~veles_tpu_torch.telemetry.flight_recorder`) — the port's own
copies of the JAX package's ``telemetry`` pieces that the serving path
and ``/healthz``/``/debug/state`` read, and the workflow runtime's
switch :func:`enabled` with :func:`next_span_id`."""

import itertools
import os

from veles_tpu_torch.telemetry.registry import (  # noqa: F401
    Counter, DEFAULT_BUCKETS, Gauge, Histogram, MS_BUCKETS,
    MetricsRegistry, nearest_rank, render_families_text)

#: the process-wide registry: every scheduler's ``veles_serving_*``
#: series and the ``veles_health_*`` ones, rendered by
#: ``metrics.render_prometheus()``
metrics = MetricsRegistry()

from veles_tpu_torch.telemetry.flight_recorder import (  # noqa: E402,F401
    FlightRecorder, recorder)
from veles_tpu_torch.telemetry.health import (  # noqa: E402,F401
    HealthMonitor, configure, health_config, monitor)
from veles_tpu_torch.telemetry.reqtrace import (  # noqa: E402,F401
    TRACE_HEADER, clean_trace_id, ensure_trace_id, new_trace_id)


#: the reference's ``root.common.telemetry.enabled`` (default True)
_ENABLED = [True]
_span_ids = itertools.count(1)


def enabled():
    """Whether the workflow runtime's per-unit events and histograms are
    recorded (the metrics registry itself is always live)."""
    return _ENABLED[0]


def set_enabled(flag):
    """Turn the per-unit instrumentation on or off, process-wide."""
    _ENABLED[0] = bool(flag)


def next_span_id():
    """Process-unique span id, pid-qualified as the reference's."""
    return "%d-%d" % (os.getpid(), next(_span_ids))

