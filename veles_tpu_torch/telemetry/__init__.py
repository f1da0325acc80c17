"""Telemetry of the port: the process-wide :data:`metrics` registry
(:mod:`~veles_tpu_torch.telemetry.registry`) and per-request traces
(:mod:`~veles_tpu_torch.telemetry.reqtrace`) over the event sink
:data:`veles_tpu_torch.logger.events` — the port's own copies of the
JAX package's ``telemetry`` pieces the serving path reads."""

from veles_tpu_torch.telemetry.registry import (  # noqa: F401
    Counter, DEFAULT_BUCKETS, Gauge, Histogram, MS_BUCKETS,
    MetricsRegistry, nearest_rank, render_families_text)

#: the process-wide registry: every scheduler's ``veles_serving_*``
#: series, rendered by ``metrics.render_prometheus()``
metrics = MetricsRegistry()

from veles_tpu_torch.telemetry.reqtrace import (  # noqa: E402,F401
    TRACE_HEADER, clean_trace_id, ensure_trace_id, new_trace_id)
