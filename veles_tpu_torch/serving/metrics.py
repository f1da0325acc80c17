"""Serving metrics — the port of ``veles_tpu/serving/metrics.py``
(``SLOTracker`` and ``ServingMetrics``): per-request TTFT and
tokens per second, queue, slot and KV gauges, speculative decoding,
prefix cache, lifecycle, tenant and SLO accounting.

Each :class:`ServingMetrics` instance keeps its OWN counters and
latency histograms (so :meth:`ServingMetrics.snapshot` — what
``InferenceScheduler.metrics()`` returns — reports this scheduler's
lifetime), and every observation is mirrored into the process-wide
registry (:data:`veles_tpu_torch.telemetry.metrics`) under the JAX
package's ``veles_serving_*`` / ``veles_slo_*`` / ``veles_tenant_*``
series names.  Lifecycle events (``serving.request``,
``serving.preempt``, …) go to the event sink
(:data:`veles_tpu_torch.logger.events`).

:class:`RouterMetrics` is the fleet router's (``veles_router_*``).
"""

import itertools
import threading
import time
from collections import deque

from veles_tpu_torch.logger import events
from veles_tpu_torch.telemetry import MS_BUCKETS, Histogram, metrics


# -- SLO accounting -----------------------------------------------------------

#: priority class names (the scheduler's CLASS_NAMES; a local copy, as
#: the scheduler imports this module)
_SLO_CLASSES = ("low", "normal", "high")

#: the JAX package's SLO defaults where ``root.common.slo`` lacks a
#: key: latency objectives in ms by class, for TTFT and whole-request
#: (e2e) time, and the burn-rate windows in seconds
SLO_TTFT_MS = {"low": 5000.0, "normal": 2000.0, "high": 500.0}
SLO_E2E_MS = {"low": 120000.0, "normal": 60000.0, "high": 30000.0}
SLO_WINDOWS = (60.0, 300.0, 3600.0)


def _slo_conf(name, default):
    from veles_tpu_torch.config import root
    if name in ("ttft_ms", "e2e_ms"):
        return root.common.slo.get_dict(name, default)
    return root.common.slo.get(name, default)


def _slo_series():
    return {
        "good": metrics.counter(
            "veles_slo_requests_good_total",
            "requests that met their class's latency objective, by "
            "scope (serving TTFT/e2e at the replica, e2e at the "
            "router), class and objective kind",
            labelnames=("scope", "cls", "slo")),
        "bad": metrics.counter(
            "veles_slo_requests_bad_total",
            "requests that MISSED their class's latency objective — "
            "the numerator of the burn rate",
            labelnames=("scope", "cls", "slo")),
        "burn": metrics.gauge(
            "veles_slo_burn_rate",
            "error-budget burn rate over a trailing window: "
            "(bad fraction in window) / (1 - target); 1.0 burns the "
            "budget exactly at the objective rate, >1 burns faster "
            "(multi-window alerting pairs a fast and a slow window)",
            labelnames=("scope", "cls", "slo", "window")),
        "objective": metrics.gauge(
            "veles_slo_objective_ms",
            "the configured latency objective (root.common.slo.*), "
            "exported so dashboards need no config access",
            labelnames=("scope", "cls", "slo")),
    }


class SLOTracker:
    """Per-class latency-SLO accounting: good/bad counters plus
    multi-window burn-rate gauges.  ``enabled``, ``target`` (the
    success ratio whose complement is the error budget), ``windows``
    (trailing burn-rate horizons, seconds) and the per-class objectives
    ``ttft_ms`` / ``e2e_ms`` (dicts by class name over the defaults; a
    class given None has no objective): each left None reads
    ``root.common.slo``, with the JAX package's defaults where the key
    is absent.  ``scope`` labels the exported series ("serving" for the
    scheduler's TTFT and e2e, "router" for the fleet-tail e2e clients
    see).  Thread-safe; one observation is a lock,
    a deque append and two counter bumps."""

    #: per-(cls, kind) observation window cap — at the largest
    #: default window (1 h) this bounds memory, and a saturated ring
    #: still yields a correct burn rate over the events it holds
    _RING = 4096

    def __init__(self, scope, enabled=None, target=None, windows=None,
                 ttft_ms=None, e2e_ms=None):
        self.scope = str(scope)
        self.enabled = bool(_slo_conf("enabled", True)
                            if enabled is None else enabled)
        self.target = float(_slo_conf("target", 0.99)
                            if target is None else target)
        self.windows = tuple(float(w) for w in (
            _slo_conf("windows", SLO_WINDOWS)
            if windows is None else windows))
        if ttft_ms is None:
            ttft_ms = _slo_conf("ttft_ms", None)
        if e2e_ms is None:
            e2e_ms = _slo_conf("e2e_ms", None)
        self.objectives = {
            kind: {c: dict(default, **(given or {})).get(c)
                   for c in _SLO_CLASSES}
            for kind, given, default in (("ttft", ttft_ms, SLO_TTFT_MS),
                                         ("e2e", e2e_ms, SLO_E2E_MS))}
        self._budget = max(1e-9, 1.0 - self.target)
        self._lock = threading.Lock()
        self._events = {}   # (cls, kind) -> deque[(t, bad)]
        self._good = {}
        self._bad = {}
        self._global = _slo_series()
        if self.enabled:
            for kind, by_cls in self.objectives.items():
                for cls, obj in by_cls.items():
                    if obj is not None:
                        self._global["objective"].labels(
                            scope=self.scope, cls=cls,
                            slo=kind).set(float(obj))

    def record(self, cls, kind, ms):
        """One finished observation: ``kind`` in {"ttft", "e2e"},
        ``ms`` the measured latency.  No objective configured for the
        class (or SLOs disabled) means no accounting."""
        if not self.enabled:
            return
        obj = self.objectives.get(kind, {}).get(cls)
        if obj is None:
            return
        bad = float(ms) > float(obj)
        now = time.monotonic()
        key = (cls, kind)
        with self._lock:
            ring = self._events.get(key)
            if ring is None:
                ring = self._events[key] = deque(maxlen=self._RING)
            ring.append((now, bad))
            if bad:
                self._bad[key] = self._bad.get(key, 0) + 1
            else:
                self._good[key] = self._good.get(key, 0) + 1
        self._global["bad" if bad else "good"].labels(
            scope=self.scope, cls=cls, slo=kind).inc()
        self._refresh_burn(key, now)

    def _burn_rates(self, key, now):
        """Burn rate per window from the bounded ring: bad fraction
        in the trailing window divided by the error budget."""
        with self._lock:
            ring = list(self._events.get(key, ()))
        out = {}
        for w in self.windows:
            recent = [bad for t, bad in ring if now - t <= w]
            rate = (sum(recent) / len(recent) / self._budget) \
                if recent else 0.0
            out["%ds" % int(w)] = round(rate, 4)
        return out

    def _refresh_burn(self, key, now):
        cls, kind = key
        for w, rate in zip(self.windows,
                           self._burn_rates(key, now).values()):
            self._global["burn"].labels(
                scope=self.scope, cls=cls, slo=kind,
                window="%ds" % int(w)).set(rate)

    def snapshot(self):
        """JSON view (the ``slo`` block of ``metrics()``): objectives,
        good/bad counts and the current multi-window burn rates per
        class and kind."""
        now = time.monotonic()
        with self._lock:
            keys = list(self._events)
            good = dict(self._good)
            bad = dict(self._bad)
        out = {"enabled": self.enabled, "target": self.target,
               "windows_s": [int(w) for w in self.windows],
               "objectives_ms": {
                   k: {c: v for c, v in by.items() if v is not None}
                   for k, by in self.objectives.items()},
               "classes": {}}
        for key in keys:
            cls, kind = key
            rec = out["classes"].setdefault(cls, {})
            rec[kind] = {"good": good.get(key, 0),
                         "bad": bad.get(key, 0),
                         "burn_rate": self._burn_rates(key, now)}
            self._refresh_burn(key, now)
        return out


def _registry_series():
    return {
        "submitted": metrics.counter(
            "veles_serving_requests_submitted_total",
            "requests accepted into the serving queue"),
        "completed": metrics.counter(
            "veles_serving_requests_completed_total",
            "requests that finished decoding"),
        "rejected": metrics.counter(
            "veles_serving_requests_rejected_total",
            "requests refused at admission (queue-depth cap, HTTP 503)"),
        "expired": metrics.counter(
            "veles_serving_requests_expired_total",
            "requests that aged out while queued (HTTP 408)"),
        "tokens": metrics.counter(
            "veles_serving_tokens_generated_total",
            "tokens generated across all requests"),
        "busy_steps": metrics.counter(
            "veles_serving_slot_busy_steps_total",
            "slot-steps spent decoding an active request"),
        "total_steps": metrics.counter(
            "veles_serving_slot_steps_total",
            "slot-steps elapsed (busy + idle slots)"),
        "ttft_ms": metrics.histogram(
            "veles_serving_ttft_ms",
            "submit-to-first-token latency (ms)", buckets=MS_BUCKETS),
        "queued_ms": metrics.histogram(
            "veles_serving_queued_ms",
            "submit-to-slot-admission latency (ms)",
            buckets=MS_BUCKETS),
        "kv_blocks_used": metrics.gauge(
            "veles_serving_kv_blocks_used",
            "paged-KV blocks currently owned by in-flight requests"),
        "kv_blocks_free": metrics.gauge(
            "veles_serving_kv_blocks_free",
            "paged-KV blocks available for admission (memory-pressure"
            " rejections start when a prompt's budget exceeds this)"),
        "kv_dtype": metrics.gauge(
            "veles_serving_kv_dtype",
            "KV pool storage dtype in use (1 on the active dtype's "
            "series — fp32 is the parity baseline, int8 the "
            "quantized ~2x-streams layout); labeled per replica so "
            "a mixed fleet's schedulers stop stomping one series",
            labelnames=("dtype", "replica")),
        "kv_bytes_per_token": metrics.gauge(
            "veles_serving_kv_bytes_per_token",
            "per-chip HBM bytes one cached token costs across all "
            "layers' pools (scales included; tensor-parallel pools "
            "divide by the mesh factor) — the streams-per-HBM-"
            "dollar denominator, labeled per replica",
            labelnames=("replica",)),
        "prefill_chunks": metrics.counter(
            "veles_serving_prefill_chunk_total",
            "prompt chunks prefilled (chunked-prefill path)"),
        "prefill_chunk_tokens": metrics.counter(
            "veles_serving_prefill_chunk_tokens_total",
            "prompt tokens prefilled through the chunked path"),
        "prefill_chunk_ms": metrics.histogram(
            "veles_serving_prefill_chunk_ms",
            "wall time of one prefill chunk — the decode-stall bound "
            "each loop iteration pays for a joining long prompt",
            buckets=MS_BUCKETS),
        "cancelled": metrics.counter(
            "veles_serving_requests_cancelled_total",
            "requests cancelled mid-flight (client gone/disconnected)"
        ),
        "shed": metrics.counter(
            "veles_serving_requests_shed_total",
            "requests shed at admission under block-pressure overload"
            " (HTTP 503)"),
        "preempts": metrics.counter(
            "veles_serving_preempts_total",
            "requests evicted mid-decode (blocks released, generated "
            "prefix kept, requeued for resume)"),
        "preempt_resumes": metrics.counter(
            "veles_serving_preempt_resumes_total",
            "preempted requests re-admitted (prompt + prefix "
            "re-prefilled, stream continues bit-identically)"),
        "preempt_reprefill_tokens": metrics.counter(
            "veles_serving_preempt_reprefill_tokens_total",
            "tokens re-prefilled on resume — the compute cost "
            "preemption traded for the freed KV blocks"),
        "watchdog_trips": metrics.counter(
            "veles_serving_watchdog_trips_total",
            "decode-loop stalls detected (pending requests failed "
            "instead of hanging their clients)"),
        "drains": metrics.counter(
            "veles_serving_drains_total",
            "graceful-drain requests accepted (admission closed)"),
        "spec_drafted": metrics.counter(
            "veles_serving_spec_drafted_tokens_total",
            "tokens drafted by the speculative proposer (n-gram "
            "prompt lookup) and scored by the batched verify step"),
        "spec_accepted": metrics.counter(
            "veles_serving_spec_accepted_tokens_total",
            "drafted tokens the verify step accepted — each one a "
            "model pass the request did not pay"),
        "spec_rollback": metrics.counter(
            "veles_serving_spec_rollback_tokens_total",
            "drafted tokens rejected at verify (their KV rows are "
            "logically rolled back: masked until overwritten)"),
        "prefix_hits": metrics.counter(
            "veles_serving_prefix_hits_total",
            "admissions whose prompt prefix was resident in the "
            "radix cache (warm: only the cold tail prefilled)"),
        "prefix_misses": metrics.counter(
            "veles_serving_prefix_misses_total",
            "admissions with no resident prefix (fully cold)"),
        "prefix_hit_tokens": metrics.counter(
            "veles_serving_prefix_hit_tokens_total",
            "prompt tokens served from resident KV blocks instead "
            "of prefill compute"),
        "prefix_evictions": metrics.counter(
            "veles_serving_prefix_evicted_blocks_total",
            "resident refcount-0 blocks evicted (LRU) under "
            "admission pressure"),
        "prefix_resident": metrics.gauge(
            "veles_serving_prefix_blocks_resident",
            "KV blocks currently owned by the radix prefix cache"),
        "prefix_shared": metrics.gauge(
            "veles_serving_prefix_blocks_shared",
            "resident blocks currently pinned by at least one "
            "in-flight request"),
        # per-priority-class QoS series (low/normal/high): the
        # observable contract of preemptive scheduling — high-class
        # TTFT stays bounded BECAUSE low-class requests absorb the
        # preemptions and sheds these count
        "class_submitted": metrics.counter(
            "veles_serving_class_requests_total",
            "requests accepted into the queue, by priority class",
            labelnames=("cls",)),
        "class_completed": metrics.counter(
            "veles_serving_class_completed_total",
            "requests that finished decoding, by priority class",
            labelnames=("cls",)),
        "class_preempts": metrics.counter(
            "veles_serving_class_preempts_total",
            "mid-decode evictions, by the VICTIM's priority class",
            labelnames=("cls",)),
        "class_sheds": metrics.counter(
            "veles_serving_class_sheds_total",
            "requests shed (block pressure or a higher-class "
            "arrival taking the seat), by the SHED class",
            labelnames=("cls",)),
        "class_ttft_ms": metrics.histogram(
            "veles_serving_class_ttft_ms",
            "submit-to-first-token latency by priority class (ms)",
            labelnames=("cls",), buckets=MS_BUCKETS),
        # goodput accounting: the decode loop already padded
        # every step to a pow2 occupancy bucket — these gauges make
        # "busy but wasting its batches" a visible, alertable fact
        "goodput": metrics.gauge(
            "veles_serving_goodput_tokens_per_sec",
            "tokens emitted per wall second over the recent "
            "decode-step window — throughput the CLIENTS received, "
            "as opposed to slot-steps burned; labeled per replica",
            labelnames=("replica",)),
        "pad_eff": metrics.gauge(
            "veles_serving_bucket_padding_efficiency",
            "real vs padded batch positions over the recent "
            "decode-step window (sum(active)/sum(bucket)); 1.0 means "
            "every padded row carried a request, low values mean the "
            "pow2 buckets are mostly padding; labeled per replica",
            labelnames=("replica",)),
        "kv_pressure": metrics.gauge(
            "veles_serving_kv_pressure",
            "paged-KV pool occupancy fraction used/(used+free) — "
            "the admission-pressure number the kv_block_pressure "
            "alert rule watches; labeled per replica",
            labelnames=("replica",)),
        "prefix_rate": metrics.gauge(
            "veles_serving_prefix_hit_rate_recent",
            "radix prefix-cache hit rate over the recent lookup "
            "window (NO sample until the window has enough lookups "
            "— an idle replica exports nothing rather than a fake "
            "healthy 1.0 that would pacify the collapse alert); "
            "labeled per replica", labelnames=("replica",)),
        # disaggregated-handoff export lifecycle: a healthy fleet
        # fetches every parked record within the TTL — pending
        # should hover near 0 and expired should never grow (the
        # kv_export_expiry alert rule watches the latter: growth
        # means the decode pool is not fetching)
        "kv_export_pending": metrics.gauge(
            "veles_serving_kv_export_pending",
            "prefill-export records parked and not yet fetched "
            "(one-shot handles awaiting the decode pool); labeled "
            "per replica", labelnames=("replica",)),
        "kv_export_expired": metrics.counter(
            "veles_serving_kv_export_expired_total",
            "export records the TTL sweeper garbage-collected "
            "unfetched — each one a decode pool that never came "
            "for its handoff; labeled per replica",
            labelnames=("replica",)),
        "kv_export_fetched": metrics.counter(
            "veles_serving_kv_export_fetched_total",
            "export records claimed by their one-shot fetch; "
            "labeled per replica", labelnames=("replica",)),
        # host-RAM KV overflow tier (serving/kv_host.py): demotions
        # park evicted prefix blocks in host RAM, promotions bring
        # them back on a matching admission.  Sustained promotion ~=
        # demotion churn means the budget is too small for the
        # working set (the kv_host_thrash alert rule)
        "kv_host_blocks": metrics.gauge(
            "veles_serving_kv_host_blocks",
            "KV blocks resident in the host-RAM overflow tier; "
            "labeled per replica", labelnames=("replica",)),
        "kv_host_bytes": metrics.gauge(
            "veles_serving_kv_host_bytes",
            "payload bytes resident in the host-RAM overflow tier "
            "(bounded by kv_host_bytes); labeled per replica",
            labelnames=("replica",)),
        "kv_host_promotions": metrics.counter(
            "veles_serving_kv_host_promotions_total",
            "host-tier blocks promoted back into device pools on a "
            "matching admission (incl. peer-prefix imports); "
            "labeled per replica", labelnames=("replica",)),
        "kv_host_demotions": metrics.counter(
            "veles_serving_kv_host_demotions_total",
            "evicted prefix blocks demoted into the host tier "
            "instead of dropped; labeled per replica",
            labelnames=("replica",)),
        "kv_host_thrash": metrics.gauge(
            "veles_serving_kv_host_thrash_rate",
            "min(promotion, demotion) blocks/s over the recent "
            "window — high when blocks ping-pong between tiers "
            "(the kv_host_thrash alert rule); labeled per replica",
            labelnames=("replica",)),
        "ttft_p95": metrics.gauge(
            "veles_serving_ttft_p95_ms",
            "recent-window TTFT p95 as a gauge (the histogram's "
            "reservoir percentile) — the series the ttft_p95_creep "
            "trend rule differentiates; labeled per replica",
            labelnames=("replica",)),
        # per-tenant cost metering: the usage quantities a
        # bill is made of, attributed by the scheduler at step/retire
        # boundaries to the bounded tenant label (tenant/admission.py
        # first-N cardinality bound — raw ids never become label
        # values).  Counters, so the router's federated merge sums
        # them fleet-wide and the tsdb rates them over any window.
        "tenant_prompt_tokens": metrics.counter(
            "veles_tenant_usage_prompt_tokens_total",
            "prompt tokens ingested (prefill cost), by bounded "
            "tenant label", labelnames=("tenant",)),
        "tenant_generated_tokens": metrics.counter(
            "veles_tenant_usage_generated_tokens_total",
            "tokens generated (decode output), by bounded tenant "
            "label", labelnames=("tenant",)),
        "tenant_kv_block_seconds": metrics.counter(
            "veles_tenant_usage_kv_block_seconds_total",
            "KV blocks held x wall seconds, sampled at decode-step "
            "boundaries — the HBM-residency cost of a tenant's "
            "streams, by bounded tenant label",
            labelnames=("tenant",)),
        "tenant_compute_seconds": metrics.counter(
            "veles_tenant_usage_compute_seconds_total",
            "step wall time attributed to a tenant's active slots "
            "(each step's duration split evenly across its live "
            "requests), by bounded tenant label",
            labelnames=("tenant",)),
    }


# -- tenant label bounding ----------------------------------------------------

_tenant_bounder = None
_tenant_bounder_lock = threading.Lock()


def _tenant_label(tenant):
    """Bound a raw tenant id to its metrics-safe label value through
    the admission cardinality bounder (first-N distinct tenants keep
    their own label, the rest read "other") — a raw id NEVER becomes
    a label value, so a tenant flood cannot leak unbounded series
    into the registry.  One shared bounder per
    process, so every metrics instance agrees on which N tenants won
    their own label."""
    global _tenant_bounder
    if _tenant_bounder is None:
        from veles_tpu_torch.tenant.admission import TenantAdmission
        with _tenant_bounder_lock:
            if _tenant_bounder is None:
                _tenant_bounder = TenantAdmission()
    return _tenant_bounder.label(str(tenant or "anon"))


_BREAKER_STATES = {"closed": 0, "half_open": 1, "open": 2}


def _router_series():
    return {
        "requests": metrics.counter(
            "veles_router_requests_total",
            "forward attempts, by replica, outcome (ok/error) and "
            "bounded tenant label (first-N distinct tenants keep "
            "their own, the rest share \"other\")",
            labelnames=("replica", "outcome", "tenant")),
        "retries": metrics.counter(
            "veles_router_retries_total",
            "forward attempts retried on another replica after a "
            "failure/timeout/5xx"),
        "hedges": metrics.counter(
            "veles_router_hedges_total",
            "hedge requests launched against a straggler replica "
            "(idempotent requests only)"),
        "hedge_wins": metrics.counter(
            "veles_router_hedge_wins_total",
            "hedge requests that answered before the primary"),
        "shed": metrics.counter(
            "veles_router_shed_total",
            "requests shed at the router (503 + Retry-After: no "
            "eligible replica)"),
        "disagg": metrics.counter(
            "veles_router_disagg_handoffs_total",
            "/generate requests served disaggregated: prefill on a "
            "prefill-specialist, KV export handed to a decode "
            "replica"),
        "prefix_fetches": metrics.counter(
            "veles_router_prefix_peer_fetches_total",
            "prefix blocks shipped replica-to-replica ahead of a "
            "request (fleet-wide prefix store: export from the "
            "holder, import on the target)"),
        "prefix_fetch_fails": metrics.counter(
            "veles_router_prefix_peer_fetch_fails_total",
            "peer prefix transfers that failed or were dropped — "
            "the request still runs, just cold"),
        "breaker_state": metrics.gauge(
            "veles_router_breaker_state",
            "per-replica circuit breaker: 0 closed, 1 half-open, "
            "2 open", labelnames=("replica",)),
        "replica_up": metrics.gauge(
            "veles_router_replica_up",
            "1 while the router's health poll reaches the replica, "
            "0 once it is unreachable/out of rotation — the "
            "replica_unreachable alert rule watches this",
            labelnames=("replica",)),
        "breaker_transitions": metrics.counter(
            "veles_router_breaker_transitions_total",
            "circuit-breaker state entries, by replica and new state",
            labelnames=("replica", "to")),
        "request_ms": metrics.histogram(
            "veles_router_request_ms",
            "router-side whole-request latency (all attempts + "
            "backoff; the fleet tail clients actually see)",
            buckets=MS_BUCKETS),
        "restarts": metrics.counter(
            "veles_router_replica_restarts_total",
            "replica respawns (supervisor recovery or rolling "
            "restart)", labelnames=("replica",)),
        "drains": metrics.counter(
            "veles_router_replica_drains_total",
            "replica drains initiated through the router",
            labelnames=("replica",)),
        "streams": metrics.counter(
            "veles_router_streams_total",
            "streaming (SSE) requests PINNED to a replica — counted "
            "once per client stream (a mid-stream failover's resumed "
            "leg does NOT re-count)", labelnames=("replica",)),
        "stream_failovers": metrics.counter(
            "veles_router_stream_failovers_total",
            "mid-stream failover attempts after a pinned replica "
            "died or stalled, by outcome (resumed: the continuation "
            "spliced into the open SSE connection; failed: no "
            "eligible replica or the resume itself errored; "
            "abandoned: the client disconnected during the resume)",
            labelnames=("outcome",)),
    }


def forget_serving_replica(replica):
    """Drop every replica-labeled ``veles_serving_*`` child for one
    replica id (goodput, padding efficiency, KV pressure, export
    lifecycle, ...).  Walks the live registry rather than a fixed
    family list, so ad-hoc serving gauges a replica mirrored in sweep
    too; the label position is looked up per family, so multi-label
    families (e.g. ``{dtype, replica}``) clean up as well.
    Idempotent: families with no child for the id are untouched."""
    replica = str(replica)
    for name, fam in metrics.collect():
        if not name.startswith("veles_serving_"):
            continue
        names = getattr(fam, "labelnames", ())
        if "replica" not in names:
            continue
        idx = names.index("replica")
        for key in list(fam.children()):
            if key[idx] == replica:
                fam.remove(*key)


class RouterMetrics:
    """Thread-safe router counters, mirrored into the process-wide
    registry as the ``veles_router_*`` Prometheus families (same
    instance-plus-global split as :class:`ServingMetrics`)."""

    def __init__(self, recent=256):
        self._lock = threading.Lock()
        self.requests_ok = 0
        self.requests_error = 0
        self.retries = 0
        self.hedges = 0
        self.hedge_wins = 0
        self.shed = 0
        self.disagg_handoffs = 0
        self.prefix_fetches = 0
        self.prefix_fetch_fails = 0
        self.restarts = 0
        self.drains = 0
        self.streams = 0
        self.stream_failovers = {}   # outcome -> count
        self._request_ms = Histogram("router_request_ms",
                                     buckets=MS_BUCKETS,
                                     reservoir=recent)
        self._global = _router_series()
        #: fleet-tail SLO: whole-request (all attempts + backoff)
        #: latency vs the per-class e2e objective — what the CLIENT
        #: experiences, as opposed to the replica-side view
        self.slo = SLOTracker("router")

    def record_forward(self, replica, ok, tenant=None):
        outcome = "ok" if ok else "error"
        with self._lock:
            if ok:
                self.requests_ok += 1
            else:
                self.requests_error += 1
        self._global["requests"].labels(
            replica=str(replica), outcome=outcome,
            tenant=str(tenant or "anon")).inc()

    def record_retry(self):
        with self._lock:
            self.retries += 1
        self._global["retries"].inc()

    def record_hedge(self):
        with self._lock:
            self.hedges += 1
        self._global["hedges"].inc()

    def record_hedge_win(self):
        with self._lock:
            self.hedge_wins += 1
        self._global["hedge_wins"].inc()

    def record_shed(self):
        with self._lock:
            self.shed += 1
        self._global["shed"].inc()
        events.record("router.shed", "single", cls="Router")

    def record_disagg(self):
        with self._lock:
            self.disagg_handoffs += 1
        self._global["disagg"].inc()

    def record_prefix_fetch(self, blocks=1):
        with self._lock:
            self.prefix_fetches += 1
        self._global["prefix_fetches"].inc(int(blocks))

    def record_prefix_fetch_fail(self):
        with self._lock:
            self.prefix_fetch_fails += 1
        self._global["prefix_fetch_fails"].inc()

    def record_breaker(self, replica, state):
        self._global["breaker_state"].labels(
            replica=str(replica)).set(_BREAKER_STATES[state])
        self._global["breaker_transitions"].labels(
            replica=str(replica), to=state).inc()
        events.record("router.breaker", "single", cls="Router",
                      replica=str(replica), to=state)

    def record_replica_up(self, replica, up):
        """Health-poll outcome: 1 reachable, 0 unreachable (the
        alert engine's replica_unreachable series)."""
        self._global["replica_up"].labels(
            replica=str(replica)).set(1 if up else 0)

    def forget_replica(self, replica):
        """Drop a deregistered replica's labeled series so a removed
        replica neither exports stale state forever nor keeps a
        resolved unreachable-alert series alive.  Router families
        first, then every ``veles_serving_*{replica=...}`` child the
        replica's own process mirrored into this registry (the
        in-process LocalReplica shape) — a retired replica must not
        leave frozen goodput/KV gauges on the exposition forever."""
        for name in ("replica_up", "breaker_state"):
            self._global[name].remove(str(replica))
        forget_serving_replica(replica)

    def record_stream(self, replica):
        with self._lock:
            self.streams += 1
        self._global["streams"].labels(replica=str(replica)).inc()

    def record_stream_failover(self, outcome):
        """One mid-stream failover attempt: ``resumed`` (the
        continuation spliced into the open SSE connection),
        ``failed`` (no eligible replica / resume errored — the
        client sees a terminal error frame) or ``abandoned`` (the
        client disconnected while the resume was in flight).  The
        resumed leg is deliberately NOT a second
        ``veles_router_streams_total`` pin — one client stream, one
        count."""
        with self._lock:
            self.stream_failovers[outcome] = \
                self.stream_failovers.get(outcome, 0) + 1
        self._global["stream_failovers"].labels(
            outcome=str(outcome)).inc()
        events.record("router.stream_failover", "single",
                      cls="Router", outcome=str(outcome))

    def record_request(self, ms, cls="normal"):
        self._request_ms.observe(ms)
        self._global["request_ms"].observe(ms)
        self.slo.record(cls, "e2e", ms)

    def record_restart(self, replica):
        with self._lock:
            self.restarts += 1
        self._global["restarts"].labels(replica=str(replica)).inc()
        events.record("router.replica_restart", "single",
                      cls="Router", replica=str(replica))

    def record_drain(self, replica):
        with self._lock:
            self.drains += 1
        self._global["drains"].labels(replica=str(replica)).inc()
        events.record("router.replica_drain", "single", cls="Router",
                      replica=str(replica))

    def snapshot(self):
        with self._lock:
            out = {
                "requests_ok": self.requests_ok,
                "requests_error": self.requests_error,
                "retries": self.retries,
                "hedges": self.hedges,
                "hedge_wins": self.hedge_wins,
                "shed": self.shed,
                "streams_pinned": self.streams,
                "stream_failovers": dict(self.stream_failovers),
                "prefix_peer_fetches": self.prefix_fetches,
                "prefix_peer_fetch_fails": self.prefix_fetch_fails,
                "replica_restarts": self.restarts,
                "replica_drains": self.drains,
            }
        out["request_ms_p50"] = self._request_ms.percentile(0.50)
        out["request_ms_p95"] = self._request_ms.percentile(0.95)
        out["request_ms_p99"] = self._request_ms.percentile(0.99)
        out["slo"] = self.slo.snapshot()
        return out


class ServingMetrics:
    """Thread-safe serving counters + recent-window latency stats.

    ``replica`` names this instance's series on the per-replica
    labeled gauges (``veles_serving_kv_dtype`` /
    ``kv_bytes_per_token``, …) — the scheduler passes its
    ``replica_id``; the default is a process-unique stand-in so even
    anonymous schedulers never share a label.  ``slo`` — keyword
    arguments of the :class:`SLOTracker` (the reference's defaults
    when left out)."""

    _seq = itertools.count(1)

    def __init__(self, recent=256, replica=None, slo=None):
        self.replica = str(replica) if replica \
            else "serving%d" % next(self._seq)
        self._lock = threading.Lock()
        self.submitted = 0
        self.completed = 0
        self.rejected = 0       # queue-depth cap (503)
        self.expired = 0        # queue deadline (408)
        self.tokens_generated = 0
        self.slot_busy_steps = 0
        self.slot_total_steps = 0
        self.prefill_chunks = 0
        self.prefill_chunk_tokens = 0
        self.cancelled = 0      # client-gone cancellations
        self.shed = 0           # block-pressure 503s
        self.preempts = 0
        self.preempt_resumes = 0
        self.watchdog_trips = 0
        self.kv_exports_expired = 0     # TTL-swept unfetched records
        self.kv_exports_fetched = 0     # one-shot claims served
        self.spec_drafted_tokens = 0    # proposer output, cumulative
        self.spec_accepted_tokens = 0   # drafts kept at verify
        self.spec_rollback_tokens = 0   # drafts rejected at verify
        #: {drafter: [drafted, accepted]} — the arbitration between
        #: the n-gram proposer and the model draft head is per-slot,
        #: so accept rates must split by source to be interpretable
        self.spec_by_drafter = {}
        self.spec_draft_k_last = 0      # adaptive draft length, last
        self.spec_draft_k_min_seen = 0  # ...and the smallest adapted-to
        # instance-lifetime latency histograms (the shared telemetry
        # type: bounded reservoir + bucket counts), window = `recent`
        self._ttft = Histogram("ttft_ms", buckets=MS_BUCKETS,
                               reservoir=recent)
        self._queued = Histogram("queued_ms", buckets=MS_BUCKETS,
                                 reservoir=recent)
        self._completions = deque(maxlen=recent)  # (t, tokens)
        #: recent decode-step window feeding the goodput/padding
        #: gauges: (t, tokens emitted, active rows, bucket rows)
        self._steps = deque(maxlen=recent)
        #: recent prefix lookups (True = hit) for the windowed rate
        self._prefix_recent = deque(maxlen=64)
        self.kv_host_promotions = 0     # host tier -> device blocks
        self.kv_host_demotions = 0      # device -> host tier blocks
        #: recent host-tier movements feeding the thrash-rate gauge:
        #: (t, promoted, demoted)
        self._kv_host_recent = deque(maxlen=64)
        #: per-tenant usage accumulators, keyed by BOUNDED label —
        #: the scheduler-side metering ground truth the
        #: /tenants/usage fleet rollup must equal exactly:
        #: label -> {prompt_tokens, generated_tokens,
        #: kv_block_seconds, compute_seconds}
        self.tenant_usage = {}
        # per-priority-class counters + TTFT windows, created on the
        # first request of each class (most deployments see one)
        self._classes = {}
        self._t0 = time.monotonic()
        self._global = _registry_series()
        #: replica-side SLO accounting (TTFT + e2e vs the per-class
        #: objectives)
        self.slo = SLOTracker("serving", **(slo or {}))

    def _class(self, cls):
        """The per-class accumulator dict (lock held by callers of
        the record_* methods that touch it)."""
        rec = self._classes.get(cls)
        if rec is None:
            rec = self._classes[cls] = {
                "submitted": 0, "completed": 0, "preempts": 0,
                "sheds": 0,
                "ttft": Histogram("class_ttft_ms",
                                  buckets=MS_BUCKETS, reservoir=256)}
        return rec

    # -- scheduler hooks ------------------------------------------------

    def record_submit(self, cls="normal"):
        with self._lock:
            self.submitted += 1
            self._class(cls)["submitted"] += 1
        self._global["submitted"].inc()
        self._global["class_submitted"].labels(cls=cls).inc()

    def record_reject(self, depth):
        with self._lock:
            self.rejected += 1
        self._global["rejected"].inc()
        events.record("serving.reject", "single",
                      cls="InferenceScheduler", queue_depth=depth)

    def record_expire(self, queued_ms, tokens=0, trace=None):
        """A request crossed its deadline — queued (tokens=0, the 408
        admission case) or mid-decode (tokens = generated so far)."""
        with self._lock:
            self.expired += 1
        self._global["expired"].inc()
        attrs = {"trace": trace} if trace else {}
        events.record("serving.expire", "single",
                      cls="InferenceScheduler",
                      queued_ms=round(queued_ms, 3),
                      tokens=int(tokens), **attrs)

    def record_cancel(self, tokens, trace=None):
        with self._lock:
            self.cancelled += 1
        self._global["cancelled"].inc()
        attrs = {"trace": trace} if trace else {}
        events.record("serving.cancel", "single",
                      cls="InferenceScheduler", tokens=int(tokens),
                      **attrs)

    def record_shed(self, queued_blocks, cls="normal", trace=None):
        with self._lock:
            self.shed += 1
            self.rejected += 1
            self._class(cls)["sheds"] += 1
        self._global["shed"].inc()
        self._global["rejected"].inc()
        self._global["class_sheds"].labels(cls=cls).inc()
        attrs = {"trace": trace} if trace else {}
        events.record("serving.shed", "single",
                      cls="InferenceScheduler",
                      queued_blocks=int(queued_blocks),
                      priority=cls, **attrs)

    def record_preempt(self, tokens, cls="normal", trace=None):
        with self._lock:
            self.preempts += 1
            self._class(cls)["preempts"] += 1
        self._global["preempts"].inc()
        self._global["class_preempts"].labels(cls=cls).inc()
        attrs = {"trace": trace} if trace else {}
        events.record("serving.preempt", "single",
                      cls="InferenceScheduler", tokens=int(tokens),
                      priority=cls, **attrs)

    def record_resume(self, reprefill_tokens):
        with self._lock:
            self.preempt_resumes += 1
        self._global["preempt_resumes"].inc()
        self._global["preempt_reprefill_tokens"].inc(
            int(reprefill_tokens))

    def record_watchdog_trip(self, failed, stalled_s):
        with self._lock:
            self.watchdog_trips += 1
        self._global["watchdog_trips"].inc()
        events.record("serving.watchdog_trip", "single",
                      cls="InferenceScheduler", failed=int(failed),
                      stalled_s=round(stalled_s, 3))

    def record_drain(self):
        self._global["drains"].inc()
        events.record("serving.drain", "single",
                      cls="InferenceScheduler")

    def set_kv_exports_pending(self, pending):
        self._global["kv_export_pending"].labels(
            replica=self.replica).set(int(pending))

    def record_kv_export_expired(self, n, trace=None):
        """The TTL sweeper GC'd ``n`` unfetched export records —
        growth here means the decode pool never came for its
        handoffs (the kv_export_expiry alert rule)."""
        n = int(n)
        with self._lock:
            self.kv_exports_expired += n
        self._global["kv_export_expired"].labels(
            replica=self.replica).inc(n)
        events.record("serving.kv_export_expired", "single",
                      cls="InferenceScheduler", records=n)

    def record_kv_export_fetched(self):
        with self._lock:
            self.kv_exports_fetched += 1
        self._global["kv_export_fetched"].labels(
            replica=self.replica).inc()

    def record_spec(self, drafted, accepted, drafter="ngram",
                    draft_k=None):
        """One slot's verify outcome: ``drafted`` tokens proposed,
        ``accepted`` of them kept (the correction token is free and
        not counted either way).  ``drafter`` names the source that
        proposed this slot's drafts ("ngram" or "model") so accept
        rates stay interpretable under per-slot arbitration;
        ``draft_k`` (when given) is the slot's ADAPTED draft length
        after this verify — the gauge tests watch to see the EMA
        controller shrink under rejection."""
        drafted, accepted = int(drafted), int(accepted)
        with self._lock:
            self.spec_drafted_tokens += drafted
            self.spec_accepted_tokens += accepted
            self.spec_rollback_tokens += drafted - accepted
            rec = self.spec_by_drafter.setdefault(str(drafter), [0, 0])
            rec[0] += drafted
            rec[1] += accepted
            if draft_k is not None:
                draft_k = int(draft_k)
                self.spec_draft_k_last = draft_k
                if not self.spec_draft_k_min_seen \
                        or draft_k < self.spec_draft_k_min_seen:
                    self.spec_draft_k_min_seen = draft_k
        self._global["spec_drafted"].inc(drafted)
        self._global["spec_accepted"].inc(accepted)
        self._global["spec_rollback"].inc(drafted - accepted)

    # -- per-tenant metering ----------------------------------------------

    def _tenant_rec(self, label):
        """lock held."""
        rec = self.tenant_usage.get(label)
        if rec is None:
            rec = self.tenant_usage[label] = {
                "prompt_tokens": 0, "generated_tokens": 0,
                "kv_block_seconds": 0.0, "compute_seconds": 0.0}
        return rec

    def record_tenant_tokens(self, tenant, prompt=0, generated=0):
        """Retire-time token attribution (failed requests attribute
        too — the prefill/decode compute was spent either way)."""
        label = _tenant_label(tenant)
        prompt, generated = int(prompt), int(generated)
        with self._lock:
            rec = self._tenant_rec(label)
            rec["prompt_tokens"] += prompt
            rec["generated_tokens"] += generated
        if prompt:
            self._global["tenant_prompt_tokens"].labels(
                tenant=label).inc(prompt)
        if generated:
            self._global["tenant_generated_tokens"].labels(
                tenant=label).inc(generated)

    def record_tenant_step(self, usage):
        """One decode-step boundary's residency/compute attribution:
        ``usage`` maps raw tenant id ->
        ``(kv_block_seconds, compute_seconds)`` increments the
        scheduler sampled for that step (blocks held x step wall
        time; the step's duration split across its active slots)."""
        for tenant, (blocks_s, compute_s) in usage.items():
            label = _tenant_label(tenant)
            with self._lock:
                rec = self._tenant_rec(label)
                rec["kv_block_seconds"] += blocks_s
                rec["compute_seconds"] += compute_s
            if blocks_s > 0:
                self._global["tenant_kv_block_seconds"].labels(
                    tenant=label).inc(blocks_s)
            if compute_s > 0:
                self._global["tenant_compute_seconds"].labels(
                    tenant=label).inc(compute_s)

    def tenant_usage_snapshot(self):
        """Per-tenant usage rollup (bounded labels), rounded for the
        JSON surface."""
        with self._lock:
            return {label: {
                "prompt_tokens": rec["prompt_tokens"],
                "generated_tokens": rec["generated_tokens"],
                "kv_block_seconds": round(rec["kv_block_seconds"], 6),
                "compute_seconds": round(rec["compute_seconds"], 6),
            } for label, rec in sorted(self.tenant_usage.items())}

    #: minimum recent lookups before the windowed hit rate is
    #: trusted — below it NO sample is exported (the series is
    #: absent, not a fake-healthy 1.0), so the prefix_hit_collapse
    #: alert neither fires on idle/startup traffic nor gets
    #: pacified by an idle replica's placeholder
    _PREFIX_MIN_LOOKUPS = 16

    def record_prefix_lookup(self, matched_blocks, block_size):
        """One admission's radix-cache lookup: a hit when >= 1
        leading block was resident."""
        if matched_blocks > 0:
            self._global["prefix_hits"].inc()
            self._global["prefix_hit_tokens"].inc(
                int(matched_blocks) * int(block_size))
        else:
            self._global["prefix_misses"].inc()
        with self._lock:
            self._prefix_recent.append(matched_blocks > 0)
            window = list(self._prefix_recent)
        if len(window) < self._PREFIX_MIN_LOOKUPS:
            self._global["prefix_rate"].remove(self.replica)
            return
        rate = sum(window) / len(window)
        self._global["prefix_rate"].labels(
            replica=self.replica).set(round(rate, 4))

    def record_prefix_evict(self, blocks):
        self._global["prefix_evictions"].inc(int(blocks))

    def record_kv_host(self, promoted=0, demoted=0):
        """Host-tier block movement at one boundary; also refreshes
        the thrash-rate gauge — min(promotion, demotion) blocks/s
        over the recent window, which is high exactly when the same
        blocks ping-pong between tiers (budget too small for the
        working set) and near zero for healthy one-way flow."""
        promoted, demoted = int(promoted), int(demoted)
        now = time.monotonic()
        with self._lock:
            self.kv_host_promotions += promoted
            self.kv_host_demotions += demoted
            self._kv_host_recent.append((now, promoted, demoted))
            window = list(self._kv_host_recent)
        if promoted:
            self._global["kv_host_promotions"].labels(
                replica=self.replica).inc(promoted)
        if demoted:
            self._global["kv_host_demotions"].labels(
                replica=self.replica).inc(demoted)
        span = now - window[0][0]
        if span <= 0 or len(window) < 2:
            return
        rate = min(sum(w[1] for w in window),
                   sum(w[2] for w in window)) / span
        self._global["kv_host_thrash"].labels(
            replica=self.replica).set(round(rate, 4))

    def set_kv_host(self, blocks, nbytes):
        self._global["kv_host_blocks"].labels(
            replica=self.replica).set(int(blocks))
        self._global["kv_host_bytes"].labels(
            replica=self.replica).set(int(nbytes))

    def set_prefix_blocks(self, resident, shared):
        self._global["prefix_resident"].set(int(resident))
        self._global["prefix_shared"].set(int(shared))

    def record_first_token(self, ttft_ms, queued_ms, cls="normal"):
        self._ttft.observe(ttft_ms)
        self._queued.observe(queued_ms)
        with self._lock:
            self._class(cls)["ttft"].observe(ttft_ms)
        self._global["ttft_ms"].observe(ttft_ms)
        self._global["queued_ms"].observe(queued_ms)
        self._global["class_ttft_ms"].labels(cls=cls).observe(ttft_ms)
        self._global["ttft_p95"].labels(replica=self.replica).set(
            round(self._ttft.percentile(0.95), 3))
        self.slo.record(cls, "ttft", ttft_ms)

    def record_prefill_chunk(self, tokens, chunk_ms):
        with self._lock:
            self.prefill_chunks += 1
            self.prefill_chunk_tokens += int(tokens)
        self._global["prefill_chunks"].inc()
        self._global["prefill_chunk_tokens"].inc(int(tokens))
        self._global["prefill_chunk_ms"].observe(chunk_ms)

    def set_kv_blocks(self, used, free):
        self._global["kv_blocks_used"].set(int(used))
        self._global["kv_blocks_free"].set(int(free))
        total = int(used) + int(free)
        self._global["kv_pressure"].labels(replica=self.replica).set(
            round(int(used) / total, 4) if total else 0.0)

    def set_kv_dtype(self, kv_dtype, bytes_per_token):
        """Advertise the KV pool layout (once, at cache build): the
        active dtype's labeled series reads 1, the other 0 — a
        dashboard can tell at a glance which fleet replicas run
        quantized pools and what a cached token costs them.  Both
        gauges carry this instance's ``replica`` label, so a
        multi-replica fleet (or a test building several schedulers
        in one process) no longer last-writer-wins one shared
        series."""
        for d in ("fp32", "int8"):
            self._global["kv_dtype"].labels(
                dtype=d, replica=self.replica).set(
                1 if d == kv_dtype else 0)
        self._global["kv_bytes_per_token"].labels(
            replica=self.replica).set(int(bytes_per_token))

    def record_step(self, active, slots, tokens=None,
                    duration_s=None):
        """One batched decode/verify boundary: ``active`` real rows
        rode a padded ``slots``-row bucket; ``tokens`` is what the
        step actually emitted (spec verify can emit up to k+1 per
        slot, a fully-rejected slot emits 0) and feeds the goodput
        gauge; ``duration_s`` is accepted for symmetry with the
        tracing hook (the goodput window uses wall-clock arrival
        times, so a stalled loop DROPS the gauge instead of freezing
        it at the last healthy rate)."""
        now = time.monotonic()
        with self._lock:
            self.slot_busy_steps += int(active)
            self.slot_total_steps += int(slots)
            if tokens is not None:
                self._steps.append((now, int(tokens), int(active),
                                    int(slots)))
                window = list(self._steps)
            else:
                window = None
        self._global["busy_steps"].inc(int(active))
        self._global["total_steps"].inc(int(slots))
        if not window:
            return
        pad = sum(s for _, _, _, s in window)
        eff = sum(a for _, _, a, _ in window) / pad if pad else 0.0
        self._global["pad_eff"].labels(replica=self.replica).set(
            round(eff, 4))
        span = window[-1][0] - window[0][0]
        if len(window) >= 2 and span > 0:
            tps = sum(t for _, t, _, _ in window) / span
            self._global["goodput"].labels(
                replica=self.replica).set(round(tps, 2))

    def goodput_snapshot(self):
        """(tokens_per_sec, padding_efficiency) over the recent step
        window (read by ``snapshot``)."""
        with self._lock:
            window = list(self._steps)
        if not window:
            return None, None
        pad = sum(s for _, _, _, s in window)
        eff = round(sum(a for _, _, a, _ in window) / pad, 4) \
            if pad else None
        span = window[-1][0] - window[0][0]
        tps = round(sum(t for _, t, _, _ in window) / span, 2) \
            if len(window) >= 2 and span > 0 else None
        return tps, eff

    def record_complete(self, req_tokens, duration_s, ttft_ms,
                        queued_ms, cls="normal", trace=None):
        now = time.monotonic()
        with self._lock:
            self.completed += 1
            self.tokens_generated += int(req_tokens)
            self._completions.append((now, int(req_tokens)))
            self._class(cls)["completed"] += 1
        self._global["completed"].inc()
        self._global["tokens"].inc(int(req_tokens))
        self._global["class_completed"].labels(cls=cls).inc()
        self.slo.record(cls, "e2e", duration_s * 1e3)
        attrs = {"trace": trace} if trace else {}
        events.record(
            "serving.request", "single", cls="InferenceScheduler",
            tokens=int(req_tokens), ttft_ms=round(ttft_ms, 3),
            queued_ms=round(queued_ms, 3),
            duration_ms=round(duration_s * 1e3, 3),
            tokens_per_sec=round(req_tokens / duration_s, 1)
            if duration_s > 0 else None, **attrs)

    # -- reads ----------------------------------------------------------

    def recent_tokens_per_sec(self):
        """Aggregate decode throughput over the recent completion
        window (None before two completions)."""
        with self._lock:
            if len(self._completions) < 2:
                return None
            t_first = self._completions[0][0]
            t_last = self._completions[-1][0]
            toks = sum(n for _, n in self._completions)
            if t_last <= t_first:
                return None
            return toks / (t_last - t_first)

    def snapshot(self, queue_depth=0, active_slots=0, max_slots=0,
                 kv=None):
        with self._lock:
            occ = (self.slot_busy_steps / self.slot_total_steps
                   if self.slot_total_steps else 0.0)
            out = {
                "requests_submitted": self.submitted,
                "requests_completed": self.completed,
                "requests_rejected": self.rejected,
                "requests_expired": self.expired,
                "tokens_generated": self.tokens_generated,
                "queue_depth": int(queue_depth),
                "active_slots": int(active_slots),
                "max_slots": int(max_slots),
                "slot_occupancy": round(occ, 4),
                "slot_busy_steps": self.slot_busy_steps,
                "prefill_chunks": self.prefill_chunks,
                "prefill_chunk_tokens": self.prefill_chunk_tokens,
                "requests_cancelled": self.cancelled,
                "requests_shed": self.shed,
                "preempts": self.preempts,
                "preempt_resumes": self.preempt_resumes,
                "watchdog_trips": self.watchdog_trips,
                "kv_exports_expired": self.kv_exports_expired,
                "kv_exports_fetched": self.kv_exports_fetched,
                "spec_drafted_tokens": self.spec_drafted_tokens,
                "spec_accepted_tokens": self.spec_accepted_tokens,
                "spec_rollback_tokens": self.spec_rollback_tokens,
                "spec_accept_rate": round(
                    self.spec_accepted_tokens
                    / self.spec_drafted_tokens, 4)
                if self.spec_drafted_tokens else None,
                "spec_accept_rate_by_drafter": {
                    name: round(rec[1] / rec[0], 4) if rec[0] else None
                    for name, rec in sorted(
                        self.spec_by_drafter.items())},
                "spec_draft_k_last": self.spec_draft_k_last,
                "spec_draft_k_min_seen": self.spec_draft_k_min_seen,
                "uptime_s": round(time.monotonic() - self._t0, 3),
            }
        if kv:  # paged-cache occupancy (operator admission headroom)
            out.update(kv)
        with self._lock:
            out["classes"] = {
                cls: {"submitted": rec["submitted"],
                      "completed": rec["completed"],
                      "preempts": rec["preempts"],
                      "sheds": rec["sheds"],
                      "ttft_ms_p50": rec["ttft"].percentile(0.50),
                      "ttft_ms_p95": rec["ttft"].percentile(0.95)}
                for cls, rec in self._classes.items()}
        out["ttft_ms_p50"] = self._ttft.percentile(0.50)
        out["ttft_ms_p95"] = self._ttft.percentile(0.95)
        out["ttft_ms_p99"] = self._ttft.percentile(0.99)
        out["queued_ms_p50"] = self._queued.percentile(0.50)
        tps = self.recent_tokens_per_sec()
        out["tokens_per_sec_recent"] = round(tps, 1) if tps else None
        goodput, pad_eff = self.goodput_snapshot()
        out["goodput_tokens_per_sec"] = goodput
        out["bucket_padding_efficiency"] = pad_eff
        out["slo"] = self.slo.snapshot()
        return out
