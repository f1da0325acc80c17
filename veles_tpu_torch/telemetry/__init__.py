"""Telemetry of the port: the process-wide :data:`metrics` registry
(:mod:`~veles_tpu_torch.telemetry.registry`), per-request traces
(:mod:`~veles_tpu_torch.telemetry.reqtrace`) over the event sink
:data:`veles_tpu_torch.logger.events`, the training-health monitor
(:mod:`~veles_tpu_torch.telemetry.health`) and the crash flight recorder
(:mod:`~veles_tpu_torch.telemetry.flight_recorder`) — the port's own
copies of the JAX package's ``telemetry`` pieces that the serving path
and ``/healthz``/``/debug/state`` read."""

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
