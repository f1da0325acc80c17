"""Alerting engine over the metrics registry and fleet state — the
port's own copy of ``veles_tpu/telemetry/alerts.py``.

The fleet records everything (Prometheus families, SLO burn-rate
gauges, breaker states, watchdog trips) and until now *told* no one:
an operator had to be staring at the right scrape at the right
moment.  This module closes the loop — a low-frequency ticker thread
evaluates declarative rules over the process-wide registry and drives
a per-series ``pending → firing → resolved`` state machine with
``for_seconds`` hold-downs (one transient bad sample never pages).

**Rule grammar** (``root.common.alerts.rules``, a tuple of dicts)::

    {"name": "kv_low", "expr": "veles_serving_kv_blocks_free < 2",
     "for": 5.0, "severity": "ticket"}

``expr`` is ``[func(]family[{label=value,...}][)] OP number`` with
``OP`` one of ``> < >= <= == !=`` and ``func`` one of ``sum``,
``min``, ``max``, ``avg`` (aggregate matching series into ONE alert
instance), ``increase`` (per-series delta since the last tick —
counters) or ``rate`` (delta per second).  Without a func, every
matching series gets its OWN state machine, so one replica's breaker
firing does not mask a second replica's.

**Trend functions** read the embedded time-series store
(:mod:`veles_tpu_torch.telemetry.tsdb`) instead of the instantaneous
registry, so rules can compare now against history::

    avg_over_time(family[{sel}][, window_s]) OP number
    max_over_time(family[{sel}][, window_s]) OP number
    min_over_time(family[{sel}][, window_s]) OP number
    deriv(family[{sel}][, window_s]) OP number          # per-second slope
    drop_vs_baseline(family[{sel}][, short, long]) OP number

``drop_vs_baseline`` is the regression detector: the fractional drop
of the short-window average below the long-window *median* (the
trailing baseline), 0 when the baseline is empty or non-positive —
``> 0.5`` means "running at less than half the trailing-hour
median".  Windows default to 60s (and 3600s for the baseline).  Each
stored series matching the selector keeps its own state machine;
with no live store the functions yield no rows (and a firing
instance resolves via the vanished-series path).

**Shipped defaults** (:func:`default_rules`, disable with
``root.common.alerts.defaults = False``) cover the fleet's known
failure shapes: multi-window fast+slow SLO burn (the SRE Workbook
pairing — both windows must burn before paging, so a blip neither
pages nor hides a sustained burn), breaker open, health-policy halt,
replica unreachable, KV block pressure, unfetched KV-export expiry
(a decode pool that stopped coming for its disaggregated handoffs),
watchdog stalls, prefix-hit collapse, and bucket-padding waste
("busy but wasting its batches").

**Sinks** on every fire/resolve: the JSONL event ring
(``alert.fire`` / ``alert.resolve``), the process log, the
``veles_alerts_firing{rule,severity}`` gauge, and an optional webhook
POST (``root.common.alerts.webhook_url``) guarded by the
``alerts.webhook`` fault point so chaos tests can drop or fail it.
Engines register weakly at :func:`register_engine`;
:func:`firing_table` merges every live engine's firing alerts — the
flight recorder embeds it so a hang bundle says what was already
wrong *before* the hang.

``GET /alerts`` on the router, the serving replicas and the
web-status dashboard all serve :meth:`AlertEngine.snapshot`.
"""

import json
import re
import threading
import time
import urllib.request
import weakref
from collections import deque

from veles_tpu_torch import faults
from veles_tpu_torch.logger import Logger, events
from veles_tpu_torch.telemetry.registry import metrics as default_registry  # noqa: E501

__all__ = ("AlertRule", "AlertEngine", "default_rules",
           "register_engine", "firing_table")

SEVERITIES = ("info", "ticket", "page")

_EXPR = re.compile(
    r'^\s*(?:(sum|min|max|avg|increase|rate)\s*\(\s*)?'
    r'([A-Za-z_:][A-Za-z0-9_:]*)\s*(?:\{([^}]*)\})?\s*\)?\s*'
    r'(>=|<=|==|!=|>|<)\s*'
    r'(-?(?:\d+\.?\d*|\.\d+)(?:[eE]-?\d+)?)\s*$')
# the tsdb-backed trend functions: windows are positional seconds
# (avg/max/min_over_time + deriv take one, drop_vs_baseline takes
# short, long).  Tried BEFORE _EXPR so "deriv(...)" never half-parses
# as a bare family read.
_EXPR_TIME = re.compile(
    r'^\s*(avg_over_time|max_over_time|min_over_time|deriv|'
    r'drop_vs_baseline)\s*\(\s*'
    r'([A-Za-z_:][A-Za-z0-9_:]*)\s*(?:\{([^}]*)\})?\s*'
    r'(?:,\s*(\d+\.?\d*)\s*)?(?:,\s*(\d+\.?\d*)\s*)?\)\s*'
    r'(>=|<=|==|!=|>|<)\s*'
    r'(-?(?:\d+\.?\d*|\.\d+)(?:[eE]-?\d+)?)\s*$')
_SEL_LABEL = re.compile(r'([A-Za-z_][A-Za-z0-9_]*)\s*=\s*'
                        r'"?([^",}]*)"?')

_OPS = {
    ">": lambda a, b: a > b, "<": lambda a, b: a < b,
    ">=": lambda a, b: a >= b, "<=": lambda a, b: a <= b,
    "==": lambda a, b: a == b, "!=": lambda a, b: a != b,
}


def _alerts_conf(name, default):
    from veles_tpu_torch.config import root
    return root.common.alerts.get(name, default)


class AlertRule:
    """One declarative rule: an ``expr`` over registry families, or a
    built-in ``kind`` evaluator (``slo_burn`` — the fast+slow
    multi-window pair).  ``for_seconds`` is the pending hold-down
    before an instance may fire."""

    def __init__(self, name, expr=None, severity="ticket",
                 for_seconds=0.0, kind="expr", params=None,
                 description=""):
        self.name = str(name)
        if severity not in SEVERITIES:
            raise ValueError("severity %r not in %s"
                             % (severity, SEVERITIES))
        self.severity = severity
        self.for_seconds = float(for_seconds)
        self.kind = kind
        self.params = dict(params or {})
        self.description = description
        self.expr = expr
        self._parsed = None
        self._time_memo = None   # (store id+sample count, rows)
        if kind == "expr":
            if not expr:
                raise ValueError("rule %s: expr required" % name)
            mt = _EXPR_TIME.match(expr)
            if mt is not None:
                func, family, selector, w1, w2, op, threshold = \
                    mt.groups()
                self._parsed = {
                    "func": func, "family": family,
                    "selector": dict(
                        _SEL_LABEL.findall(selector or "")),
                    "op": op, "threshold": float(threshold),
                    "time": True,
                    "w1": float(w1) if w1 else None,
                    "w2": float(w2) if w2 else None}
                return
            m = _EXPR.match(expr)
            if m is None:
                raise ValueError("rule %s: cannot parse expr %r"
                                 % (name, expr))
            func, family, selector, op, threshold = m.groups()
            self._parsed = {
                "func": func, "family": family,
                "selector": dict(_SEL_LABEL.findall(selector or "")),
                "op": op, "threshold": float(threshold)}
        elif kind != "slo_burn":
            raise ValueError("rule %s: unknown kind %r" % (name, kind))

    @classmethod
    def from_dict(cls, spec):
        spec = dict(spec)
        return cls(spec.pop("name"),
                   expr=spec.pop("expr", None),
                   severity=spec.pop("severity", "ticket"),
                   for_seconds=float(spec.pop("for", 0.0)),
                   kind=spec.pop("kind", "expr"),
                   description=spec.pop("description", ""),
                   params=spec or None)

    def describe(self):
        return {"name": self.name, "severity": self.severity,
                "for_seconds": self.for_seconds, "kind": self.kind,
                "expr": self.expr, "params": self.params or None,
                "description": self.description or None}

    # -- evaluation --------------------------------------------------------

    def _series(self, registry):
        """[(labels dict, value)] for the rule's family, restricted
        to the selector.  Histograms contribute their ``_count``."""
        from veles_tpu_torch.telemetry.registry import Histogram, _Family
        fam = registry.get(self._parsed["family"])
        if fam is None:
            return []
        sel = self._parsed["selector"]
        rows = []
        if isinstance(fam, _Family):
            for lv, child in fam.children().items():
                rows.append((dict(zip(fam.labelnames, lv)), child))
        else:
            rows.append(({}, fam))
        out = []
        for labels, child in rows:
            if any(labels.get(k) != v for k, v in sel.items()):
                continue
            try:
                value = child.count if isinstance(child, Histogram) \
                    else child.value
            except Exception:
                continue
            out.append((labels, float(value)))
        return out

    def evaluate(self, registry, prev, dt, tsdb=None):
        """[(labels dict, value, condition bool)] — one entry per
        alert instance this tick.  ``prev`` is the engine's
        per-series memory for increase/rate (first sight reads as
        delta 0, so restarts never page on a counter's history);
        ``tsdb`` is the history store the trend functions query."""
        if self.kind == "slo_burn":
            return self._evaluate_slo_burn(registry)
        if self._parsed.get("time"):
            # the store only gains data once per sampling interval,
            # so between samples the answer cannot change — memoize
            # on the sample counter (engines often tick much faster
            # than the store samples, e.g. 20 Hz test intervals
            # against the 1 Hz tier-0 ticker)
            key = (id(tsdb), tsdb.samples) if tsdb is not None \
                else None
            cached = self._time_memo
            if cached is not None and cached[0] == key:
                return cached[1]
            rows = self._evaluate_time(tsdb)
            self._time_memo = (key, rows)
            return rows
        p = self._parsed
        cmp_, thr = _OPS[p["op"]], p["threshold"]
        rows = self._series(registry)
        if p["func"] in ("increase", "rate"):
            out = []
            for labels, value in rows:
                key = (self.name, tuple(sorted(labels.items())))
                last = prev.get(key)
                prev[key] = value
                delta = max(0.0, value - last) \
                    if last is not None else 0.0
                if p["func"] == "rate":
                    delta = delta / dt if dt > 0 else 0.0
                out.append((labels, delta, cmp_(delta, thr)))
            return out
        if p["func"]:
            vals = [v for _, v in rows if v == v]  # drop NaNs
            if not vals:
                return [(dict(p["selector"]), float("nan"), False)]
            agg = {"sum": sum, "min": min, "max": max,
                   "avg": lambda v: sum(v) / len(v)}[p["func"]](vals)
            return [(dict(p["selector"]), agg, cmp_(agg, thr))]
        return [(labels, v, v == v and cmp_(v, thr))
                for labels, v in rows]

    def _evaluate_time(self, store):
        """The tsdb-backed trend functions: one row per stored
        series matching the selector.  No live store (or no data in
        the window) yields no rows — a firing instance then resolves
        through the vanished-series path instead of latching."""
        if store is None:
            return []
        p = self._parsed
        cmp_, thr = _OPS[p["op"]], p["threshold"]
        family, sel, func = p["family"], p["selector"], p["func"]
        w1 = p["w1"] if p["w1"] is not None else 60.0
        out = []
        for labels in store.label_sets(family, sel):
            try:
                if func == "drop_vs_baseline":
                    long_ = p["w2"] if p["w2"] is not None else 3600.0
                    base = store.range(family, labels, window=long_,
                                       agg=0.5)
                    recent = store.range(family, labels, window=w1,
                                         agg="avg")
                    if base is None or recent is None or base <= 0:
                        value = 0.0
                    else:
                        value = (base - recent) / base
                else:
                    agg = {"avg_over_time": "avg",
                           "max_over_time": "max",
                           "min_over_time": "min",
                           "deriv": "deriv"}[func]
                    value = store.range(family, labels, window=w1,
                                        agg=agg)
            except Exception:
                continue
            if value is None:
                continue
            out.append((labels, value, cmp_(value, thr)))
        return out

    def _evaluate_slo_burn(self, registry):
        """The SRE multi-window pair: one instance per
        ``(scope, cls, slo)`` series group of ``veles_slo_burn_rate``;
        the condition needs BOTH the fast and the slow window above
        the threshold factor."""
        from veles_tpu_torch.telemetry.registry import _Family
        fam = registry.get(self.params.get(
            "family", "veles_slo_burn_rate"))
        if not isinstance(fam, _Family):
            return []
        fast = str(self.params.get("fast", "60s"))
        slow = str(self.params.get("slow", "300s"))
        thr = float(self.params.get("threshold", 14.4))
        groups = {}
        for lv, child in fam.children().items():
            labels = dict(zip(fam.labelnames, lv))
            w = labels.pop("window", None)
            if w not in (fast, slow):
                continue
            key = tuple(sorted(labels.items()))
            try:
                groups.setdefault(key, {})[w] = float(child.value)
            except Exception:
                continue
        out = []
        for key, by_window in sorted(groups.items()):
            burn_fast = by_window.get(fast, 0.0)
            burn_slow = by_window.get(slow, 0.0)
            cond = burn_fast > thr and burn_slow > thr
            labels = dict(key)
            labels["window"] = "%s+%s" % (fast, slow)
            out.append((labels, max(burn_fast, burn_slow), cond))
        return out


def default_rules():
    """The shipped rule set — every known fleet failure shape pages
    or tickets out of the box (docs/observability.md has the table;
    docs/robustness.md maps episodes to the rule that fires)."""
    return [
        AlertRule(
            "slo_burn_page", kind="slo_burn", severity="page",
            for_seconds=0.0,
            params={"fast": "60s", "slow": "300s",
                    "threshold": 14.4},
            description="error budget burning >=14.4x over BOTH the "
                        "60s and 300s windows — at this rate a 99% "
                        "monthly budget dies in ~2 days"),
        AlertRule(
            "slo_burn_ticket", kind="slo_burn", severity="ticket",
            for_seconds=0.0,
            params={"fast": "300s", "slow": "3600s",
                    "threshold": 3.0},
            description="sustained 3x budget burn over 300s+3600s — "
                        "not page-worthy, but trending to exhaustion"),
        AlertRule(
            "breaker_open", severity="page", for_seconds=1.0,
            expr="veles_router_breaker_state >= 2",
            description="a replica's circuit breaker is open: "
                        "consecutive forward failures took it out of "
                        "rotation"),
        AlertRule(
            "health_halt", severity="page", for_seconds=0.0,
            expr="veles_health_status >= 2",
            description="the training-health policy latched halted "
                        "(non-finite loss/grads) — the process is up "
                        "for forensics but not servable"),
        AlertRule(
            "replica_unreachable", severity="page", for_seconds=1.0,
            expr="veles_router_replica_up == 0",
            description="the router's health poll cannot reach a "
                        "replica (two strikes — out of rotation)"),
        AlertRule(
            "kv_block_pressure", severity="ticket", for_seconds=2.0,
            expr="veles_serving_kv_pressure > 0.92",
            description="paged-KV pool >92% occupied — admissions "
                        "start shedding/preempting soon"),
        AlertRule(
            "kv_export_expiry", severity="ticket", for_seconds=0.0,
            expr="increase(veles_serving_kv_export_expired_total)"
                 " > 0",
            description="disaggregated KV-export records are "
                        "expiring unfetched — the decode pool is "
                        "not coming for its handoffs (dead decode "
                        "specialists, a partitioned router, or a "
                        "role pool that emptied)"),
        AlertRule(
            "watchdog_stall", severity="page", for_seconds=0.0,
            expr="increase(veles_serving_watchdog_trips_total) > 0",
            description="the decode-loop watchdog tripped: a stalled "
                        "step failed its pending requests"),
        AlertRule(
            "prefix_hit_collapse", severity="ticket",
            for_seconds=5.0,
            expr="veles_serving_prefix_hit_rate_recent < 0.05",
            description="radix prefix-cache hit rate collapsed under "
                        "real lookup traffic — affinity routing or "
                        "the cache itself regressed"),
        AlertRule(
            "bucket_padding_waste", severity="info",
            for_seconds=10.0,
            expr="veles_serving_bucket_padding_efficiency < 0.35",
            description="the fleet is busy but wasting its batches: "
                        "most padded positions carry no request"),
        AlertRule(
            "controller_flapping", severity="ticket",
            for_seconds=5.0,
            expr="increase(veles_controller_scale_transitions_total)"
                 " > 2",
            description="the fleet controller is scaling up AND down "
                        "inside one evaluation window — its "
                        "thresholds/cooldowns are mis-tuned and "
                        "replicas are churning instead of serving"),
        AlertRule(
            "tenant_throttled", severity="info",
            for_seconds=5.0,
            expr="rate(veles_router_tenant_throttled_total) > 1",
            description="a tenant is being 429'd at a sustained "
                        "rate (token bucket or concurrency lane) — "
                        "either a flood the lane is correctly "
                        "containing, or a limit set too tight for a "
                        "legitimate client (per-series: one state "
                        "machine per bounded tenant label)"),
        AlertRule(
            "goodput_regression", severity="ticket",
            for_seconds=5.0,
            expr="drop_vs_baseline("
                 "veles_serving_goodput_tokens_per_sec, 60, 3600)"
                 " > 0.5",
            description="goodput over the last minute is running at "
                        "less than half the trailing-hour median — "
                        "a regression the instantaneous gauge can't "
                        "see (it has no memory of what 'normal' "
                        "was); catches slow-burn degradations like "
                        "a shrinking batch or a sick replica "
                        "dragging the fleet"),
        AlertRule(
            "ttft_p95_creep", severity="ticket", for_seconds=10.0,
            expr="deriv(veles_serving_ttft_p95_ms, 600) > 1.0",
            description="TTFT p95 climbing >1ms/s sustained over 10 "
                        "minutes — queueing or prefill pressure "
                        "building faster than the fleet absorbs it "
                        "(the creep an instantaneous threshold "
                        "misses until it's already an SLO burn)"),
        AlertRule(
            "kv_pressure_growth", severity="info",
            for_seconds=10.0,
            expr="deriv(veles_serving_kv_pressure, 300) > 0.001",
            description="paged-KV occupancy growing monotonically "
                        "over 5 minutes — long-lived streams are "
                        "accumulating toward the shed threshold; "
                        "heads-up before kv_block_pressure tickets"),
        AlertRule(
            "kv_host_thrash", severity="ticket", for_seconds=5.0,
            expr="avg_over_time("
                 "veles_serving_kv_host_thrash_rate, 60) > 2",
            description="the host KV tier is churning: blocks are "
                        "demoting AND promoting back at a sustained "
                        "rate (min of the two, blocks/s) — the "
                        "working set exceeds device capacity and "
                        "the tier is paging instead of caching; "
                        "grow kv_host_bytes' device budget "
                        "(kv_blocks), spread load, or expect "
                        "staging-gather overhead on every warm "
                        "admission"),
    ]


def _firing_series():
    return {
        "firing": default_registry.gauge(
            "veles_alerts_firing",
            "currently firing alert instances, by rule and severity",
            labelnames=("rule", "severity")),
        "transitions": default_registry.counter(
            "veles_alerts_transitions_total",
            "alert state-machine transitions, by rule and new state",
            labelnames=("rule", "to")),
    }


class _Instance:
    """One (rule, label set) state machine."""

    __slots__ = ("labels", "state", "since", "fired_at", "value")

    def __init__(self, labels):
        self.labels = labels
        self.state = "ok"       # ok | pending | firing
        self.since = None       # first-true time of this episode
        self.fired_at = None
        self.value = None


class AlertEngine(Logger):
    """Evaluate rules on a ticker thread; serve snapshots.

    ``providers`` maps extra context names to zero-arg callables whose
    dicts ride into :meth:`snapshot` (the router passes its replica
    table) — rules themselves read only the registry, so the engine
    never blocks on a provider."""

    def __init__(self, name="alerts", rules=None, registry=None,
                 interval=None, webhook_url=None, providers=None,
                 resolved_keep=64, tsdb=None):
        super(AlertEngine, self).__init__()
        self.name = str(name)
        self.registry = registry if registry is not None \
            else default_registry
        self.tsdb = tsdb        # None -> resolve a live store per tick
        self.interval = float(_alerts_conf("interval", 1.0)
                              if interval is None else interval)
        self.webhook_url = _alerts_conf("webhook_url", None) \
            if webhook_url is None else webhook_url
        if rules is None:
            rules = list(default_rules()) \
                if _alerts_conf("defaults", True) else []
            for spec in _alerts_conf("rules", ()) or ():
                rules.append(AlertRule.from_dict(spec))
        self.rules = list(rules)
        self.providers = dict(providers or {})
        self._lock = threading.Lock()
        self._instances = {}    # (rule name, labels key) -> _Instance
        self._prev = {}         # increase/rate memory
        self._last_tick = None
        self._resolved = deque(maxlen=int(resolved_keep))
        self._global = _firing_series()
        self.ticks = 0
        self.webhook_ok = 0
        self.webhook_failures = 0
        self._stop = threading.Event()
        self._thread = None
        register_engine(self)

    # -- lifecycle ---------------------------------------------------------

    def start(self):
        with self._lock:
            if self._thread is None:
                self._stop.clear()
                self._thread = threading.Thread(
                    target=self._run, daemon=True,
                    name="alerts-%s" % self.name)
                self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        with self._lock:
            thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(5)

    def _run(self):
        while not self._stop.wait(self.interval):
            try:
                self.tick()
            except Exception as e:  # the ticker must outlive any rule
                self.warning("alert tick failed: %r", e)

    # -- evaluation --------------------------------------------------------

    def tick(self, now=None):
        """One evaluation pass; returns the transition events it
        emitted (tests drive the state machine through here)."""
        now = time.monotonic() if now is None else now
        with self._lock:
            dt = (now - self._last_tick) if self._last_tick else 0.0
            self._last_tick = now
            self.ticks += 1
        store = self.tsdb
        if store is None:
            from veles_tpu_torch.telemetry.tsdb import default_store
            store = default_store()
        transitions = []
        for rule in self.rules:
            try:
                rows = rule.evaluate(self.registry, self._prev, dt,
                                     tsdb=store)
            except Exception as e:
                self.warning("rule %s evaluation failed: %r",
                             rule.name, e)
                continue
            transitions.extend(self._advance(rule, rows, now))
        self._sync_gauges()
        for ev in transitions:
            self._emit(ev)
        return transitions

    def _advance(self, rule, rows, now):
        with self._lock:
            live = set()
            out = []
            for labels, value, cond in rows:
                key = (rule.name, tuple(sorted(labels.items())))
                live.add(key)
                inst = self._instances.get(key)
                if inst is None:
                    inst = self._instances[key] = _Instance(labels)
                inst.value = value
                if cond:
                    if inst.state == "ok":
                        inst.state = "pending"
                        inst.since = now
                    if inst.state == "pending" \
                            and now - inst.since >= rule.for_seconds:
                        inst.state = "firing"
                        inst.fired_at = now
                        out.append(("fire", rule, inst))
                else:
                    if inst.state == "firing":
                        out.append(("resolve", rule, inst))
                        self._retire(rule, inst, now)
                    if inst.state == "pending":
                        inst.state = "ok"
                        inst.since = None
            # a series that vanished (replica removed, family gone)
            # resolves rather than firing forever
            for key in [k for k in self._instances
                        if k[0] == rule.name and k not in live]:
                inst = self._instances.pop(key)
                if inst.state == "firing":
                    out.append(("resolve", rule, inst))
                    self._retire(rule, inst, now)
            return out

    def _retire(self, rule, inst, now):
        """lock held: firing -> resolved bookkeeping."""
        self._resolved.append({
            "rule": rule.name, "severity": rule.severity,
            "labels": dict(inst.labels), "value": inst.value,
            "fired_for_s": round(now - (inst.fired_at or now), 3),
            "resolved_at": time.time()})
        inst.state = "ok"
        inst.since = inst.fired_at = None

    def _sync_gauges(self):
        with self._lock:
            counts = {}
            for (rname, _), inst in self._instances.items():
                if inst.state == "firing":
                    counts[rname] = counts.get(rname, 0) + 1
        for rule in self.rules:
            self._global["firing"].labels(
                rule=rule.name, severity=rule.severity).set(
                counts.get(rule.name, 0))

    # -- sinks -------------------------------------------------------------

    def _emit(self, transition):
        what, rule, inst = transition
        payload = {"rule": rule.name, "severity": rule.severity,
                   "labels": dict(inst.labels),
                   "value": inst.value, "engine": self.name}
        events.record("alert.%s" % what, "single", cls="AlertEngine",
                      **payload)
        self._global["transitions"].labels(
            rule=rule.name, to="firing" if what == "fire"
            else "resolved").inc()
        log = self.warning if what == "fire" else self.info
        log("alert %s: %s [%s] %s value=%s", what, rule.name,
            rule.severity, inst.labels, inst.value)
        self._post_webhook(what, payload)

    def _post_webhook(self, what, payload):
        if not self.webhook_url:
            return
        try:
            if faults.fire("alerts.webhook", key=payload["rule"]):
                raise ConnectionError("injected webhook drop")
            body = dict(payload)
            body["event"] = what
            body["time"] = time.time()
            req = urllib.request.Request(
                self.webhook_url, data=json.dumps(body).encode(),
                headers={"Content-Type": "application/json"})
            urllib.request.urlopen(req, timeout=2.0).read()
            self.webhook_ok += 1
        except Exception as e:
            # the webhook is a sink, never a dependency: count and
            # keep going (the JSONL/log/gauge sinks already fired)
            self.webhook_failures += 1
            self.debug("webhook POST failed: %r", e)

    # -- reads -------------------------------------------------------------

    def _rows(self, state):
        with self._lock:
            items = [(k, inst) for k, inst in self._instances.items()
                     if inst.state == state]
        by_rule = {r.name: r for r in self.rules}
        out = []
        for (rname, _), inst in sorted(items, key=lambda kv: kv[0]):
            rule = by_rule.get(rname)
            out.append({
                "rule": rname,
                "severity": rule.severity if rule else "?",
                "labels": dict(inst.labels), "value": inst.value,
                "since": inst.since,
                "firing_for_s": round(
                    time.monotonic() - inst.fired_at, 3)
                if inst.fired_at else None})
        return out

    def firing(self):
        return self._rows("firing")

    def snapshot(self):
        """The ``GET /alerts`` payload."""
        with self._lock:
            resolved = list(self._resolved)
        return {
            "engine": self.name,
            "interval_s": self.interval,
            "ticks": self.ticks,
            "webhook": {"url": self.webhook_url,
                        "ok": self.webhook_ok,
                        "failures": self.webhook_failures}
            if self.webhook_url else None,
            "rules": [r.describe() for r in self.rules],
            "firing": self.firing(),
            "pending": self._rows("pending"),
            "recent_resolved": resolved,
            "context": {name: self._provider(fn)
                        for name, fn in self.providers.items()},
        }

    @staticmethod
    def _provider(fn):
        try:
            return fn()
        except Exception as e:
            return {"error": repr(e)}


# -- the weak engine registry (flight recorder / web_status reads) ----------

_engines = {}
_elock = threading.Lock()


def register_engine(engine):
    """Weakly register an engine so process-wide surfaces (the flight
    recorder's crash bundle, web_status ``/alerts``) can enumerate
    firing alerts without owning any engine's lifecycle."""
    with _elock:
        _engines[id(engine)] = weakref.ref(engine)


def live_engines():
    with _elock:
        items = list(_engines.items())
    out = []
    for key, ref in items:
        engine = ref()
        if engine is None:
            with _elock:
                _engines.pop(key, None)
            continue
        out.append(engine)
    return out


def firing_table():
    """Every live engine's firing alerts, engine-tagged — what a
    flight-recorder bundle embeds so a hang dump says what was
    already wrong before the hang."""
    out = []
    for engine in live_engines():
        try:
            for row in engine.firing():
                row = dict(row)
                row["engine"] = engine.name
                out.append(row)
        except Exception:
            continue
    return out
