"""Embedded time-series store — the observability plane's memory; the
port's own copy of ``veles_tpu/telemetry/tsdb.py``.

Every signal the fleet emits is instantaneous: the dashboard a
point-in-time snapshot, the controller deciding off the current tick.
This module is their history: an in-process, allocation-bounded store that samples a
metrics source on a background ticker into downsampling tiers and
answers windowed queries without a database, a scrape pipeline or an
unbounded allocation.

**Tiers** (``root.common.tsdb.tiers``, default 1s x 10min /
10s x 1h / 60s x 24h): each tier is a ``(step_s, retention_s)`` pair
backed by one ring per series — a sample lands in EVERY tier's
current bucket, so a query picks the finest tier whose retention
covers its window and never re-aggregates across tiers.

**Counters are stored as deltas**, not cumulative values: each bucket
holds the increase observed inside it, so a rate over any window is
``sum(deltas) / window`` at EVERY tier — exact across tier
boundaries, and a counter reset (replica respawn) clamps to delta 0
instead of poisoning the record with a negative spike.  Dead
replicas' contributions stay in the buckets they landed in: fleet
history survives replica churn.  Gauges keep per-bucket
``(count, sum, min, max, last)`` aggregates, so avg/min/max are exact
at every tier and quantile queries over the finest tier see the raw
samples themselves.

**Bounds**: ``max_series`` caps distinct series (later arrivals are
counted in ``dropped_series``, never stored); ``max_bytes`` is the
estimated-allocation budget — when the rings outgrow it, whole
least-recently-updated series are evicted (``evicted_series``) until
the estimate fits.  Histogram ``_bucket`` samples are skipped (their
``le`` cardinality would eat the budget for no queryable gain);
``_sum``/``_count`` ride as monotone series, which is what rate
queries need.

Stores register weakly (:func:`register_store`) like alert engines,
so the flight recorder can embed :func:`bundle_history` — the last
minutes of tier-0 history for the SLO/goodput/KV-pressure series —
and ``GET /metrics/history`` on replicas and the router both answer
from :meth:`TimeSeriesStore.history`.
"""

import math
import threading
import time
from collections import deque

from veles_tpu_torch.logger import Logger
from veles_tpu_torch.telemetry.registry import (
    metrics as default_registry, nearest_rank)

__all__ = ("TimeSeriesStore", "DEFAULT_TIERS", "register_store",
           "live_stores", "default_store", "bundle_history",
           "history_query")

#: (step seconds, retention seconds) per downsampling tier,
#: finest first
DEFAULT_TIERS = ((1.0, 600.0), (10.0, 3600.0), (60.0, 86400.0))

#: estimated allocation per stored bucket (python floats + list +
#: deque slot) — the byte-budget unit; an estimate the eviction test
#: holds the store to, not an exact heap measurement
POINT_BYTES = 112

#: series whose tier-0 tail a flight-recorder bundle embeds (the
#: lead-up to a hang, not just the moment of death)
BUNDLE_SERIES = ("veles_serving_goodput_tokens_per_sec",
                 "veles_serving_kv_pressure",
                 "veles_slo_burn_rate",
                 "veles_serving_ttft_p95_ms")


def _tsdb_conf(name, default):
    from veles_tpu_torch.config import root
    return root.common.tsdb.get(name, default)


class _Series:
    """One (name, label set) series: a raw-value memory for delta
    extraction plus one ring per tier."""

    __slots__ = ("name", "labels", "monotone", "last_raw", "updated",
                 "rings")

    def __init__(self, name, labels, monotone, tiers):
        self.name = name
        self.labels = labels          # tuple(sorted(items))
        self.monotone = monotone
        self.last_raw = None
        self.updated = 0.0
        self.rings = tuple(
            deque(maxlen=max(1, int(retention / step)))
            for step, retention in tiers)

    def ingest(self, value, now, tiers):
        if self.monotone:
            v = max(0.0, value - self.last_raw) \
                if self.last_raw is not None else 0.0
            self.last_raw = value
        else:
            v = value
        self.updated = now
        for ring, (step, _) in zip(self.rings, tiers):
            bucket_t = math.floor(now / step) * step
            if ring and ring[-1][0] == bucket_t:
                p = ring[-1]
                if self.monotone:
                    p[1] += v
                else:
                    p[1] += 1
                    p[2] += v
                    p[3] = min(p[3], v)
                    p[4] = max(p[4], v)
                    p[5] = v
            elif self.monotone:
                ring.append([bucket_t, v])
            else:
                ring.append([bucket_t, 1, v, v, v, v])

    def points_used(self):
        return sum(len(r) for r in self.rings)


class TimeSeriesStore(Logger):
    """Tiered ring-buffer store over one metrics source.

    ``collect`` is a zero-arg callable returning structured families
    (the :meth:`MetricsRegistry.collect_families` / federation-merge
    shape); the default samples the process-wide registry.  The
    router passes its federated-merge closure instead, which is what
    makes fleet history survive replica churn.  :meth:`start` arms a
    ticker at the finest tier's step; tests drive :meth:`sample`
    directly with explicit timestamps."""

    def __init__(self, name="tsdb", collect=None, registry=None,
                 tiers=None, max_series=None, max_bytes=None,
                 interval=None):
        super(TimeSeriesStore, self).__init__()
        self.name = str(name)
        reg = registry if registry is not None else default_registry
        self._collect = collect if collect is not None \
            else reg.collect_families
        raw = tiers if tiers is not None \
            else _tsdb_conf("tiers", DEFAULT_TIERS)
        self.tiers = tuple(sorted(
            (float(s), float(r)) for s, r in raw))
        if not self.tiers:
            raise ValueError("tsdb needs at least one tier")
        self.max_series = int(_tsdb_conf("max_series", 512)
                              if max_series is None else max_series)
        self.max_bytes = int(_tsdb_conf("max_bytes", 16 << 20)
                             if max_bytes is None else max_bytes)
        self.interval = float(self.tiers[0][0]
                              if interval is None else interval)
        self._lock = threading.Lock()
        self._series = {}       # (name, labels tuple) -> _Series
        self.samples = 0
        self.dropped_series = 0
        self.evicted_series = 0
        self._stop = threading.Event()
        self._thread = None
        register_store(self)

    # -- lifecycle ---------------------------------------------------------

    def start(self):
        with self._lock:
            if self._thread is None:
                self._stop.clear()
                self._thread = threading.Thread(
                    target=self._run, daemon=True,
                    name="tsdb-%s" % self.name)
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
                self.sample()
            except Exception as e:  # the ticker must outlive any bug
                self.warning("tsdb sample failed: %r", e)

    # -- ingest ------------------------------------------------------------

    def sample(self, now=None, families=None):
        """One sampling pass over the source (or explicit
        ``families`` — the router's loop-thread merge hands its
        result in directly)."""
        now = time.time() if now is None else now
        if families is None:
            families = self._collect()
        with self._lock:
            self.samples += 1
            for fam in families:
                kind = fam.get("type")
                base = fam["name"]
                for suffix, labels, value in fam["samples"]:
                    if suffix == "_bucket":
                        continue     # le-cardinality: not stored
                    monotone = kind == "counter" \
                        or suffix in ("_sum", "_count")
                    try:
                        v = float(value)
                    except (TypeError, ValueError):
                        continue
                    if v != v:       # NaN never lands in a ring
                        continue
                    self._ingest(base + suffix, labels, v, monotone,
                                 now)
            self._enforce_budget()

    def _ingest(self, name, labels, value, monotone, now):
        key = (name, tuple(sorted(
            (str(k), str(v)) for k, v in (labels or {}).items())))
        series = self._series.get(key)
        if series is None:
            if len(self._series) >= self.max_series:
                self.dropped_series += 1
                return
            series = self._series[key] = _Series(
                name, key[1], monotone, self.tiers)
        series.ingest(value, now, self.tiers)

    def _enforce_budget(self):
        """lock held: evict least-recently-updated whole series until
        the allocation estimate fits the byte budget."""
        while self.bytes_used(locked=True) > self.max_bytes \
                and self._series:
            stale = min(self._series,
                        key=lambda k: self._series[k].updated)
            del self._series[stale]
            self.evicted_series += 1

    def bytes_used(self, locked=False):
        """Estimated ring allocation (POINT_BYTES per stored
        bucket)."""
        if locked:
            return sum(s.points_used()
                       for s in self._series.values()) * POINT_BYTES
        with self._lock:
            return sum(s.points_used()
                       for s in self._series.values()) * POINT_BYTES

    # -- query -------------------------------------------------------------

    def _match(self, series, labels):
        sel = {str(k): str(v) for k, v in (labels or {}).items()}
        out = []
        for (name, ltuple), s in self._series.items():
            if name != series:
                continue
            have = dict(ltuple)
            if any(have.get(k) != v for k, v in sel.items()):
                continue
            out.append(s)
        return out

    def label_sets(self, series, labels=None):
        """Distinct label dicts stored under ``series`` that match
        the selector — the alert grammar's per-series fan-out (each
        matching series keeps its own state machine)."""
        with self._lock:
            return [dict(s.labels)
                    for s in self._match(series, labels)]

    def tier_for(self, window, tier=None):
        """The finest tier index whose retention covers ``window``
        (the coarsest tier as the fallback)."""
        if tier is not None:
            return max(0, min(len(self.tiers) - 1, int(tier)))
        for i, (_, retention) in enumerate(self.tiers):
            if window <= retention:
                return i
        return len(self.tiers) - 1

    def points(self, series, labels=None, window=60.0, tier=None,
               now=None):
        """``[(bucket_t, value)]`` over the window, oldest first —
        gauge buckets contribute their last raw sample, counter
        buckets their delta.  The sparkline / history-endpoint /
        flight-recorder read."""
        now = time.time() if now is None else now
        ti = self.tier_for(float(window), tier)
        cutoff = now - float(window)
        with self._lock:
            matched = self._match(series, labels)
            rows = []
            for s in matched:
                for p in s.rings[ti]:
                    if p[0] >= cutoff:
                        rows.append((p[0], p[1] if s.monotone
                                     else p[5]))
        rows.sort()
        return rows

    def range(self, series, labels=None, window=60.0, agg="avg",
              now=None, tier=None):
        """One aggregate over the window: ``avg``/``min``/``max``/
        ``last``/``sum``, a nearest-rank quantile (``"p95"`` or a
        float in (0, 1)), ``rate`` (counter deltas per second —
        exact at every tier because deltas are what the buckets
        hold) or ``deriv`` (per-second slope first->last bucket).
        None when no bucket falls inside the window."""
        now = time.time() if now is None else now
        window = float(window)
        ti = self.tier_for(window, tier)
        cutoff = now - window
        with self._lock:
            matched = self._match(series, labels)
            mono = []       # deltas
            buckets = []    # (t, count, sum, min, max, last)
            for s in matched:
                for p in s.rings[ti]:
                    if p[0] < cutoff:
                        continue
                    if s.monotone:
                        mono.append((p[0], p[1]))
                    else:
                        buckets.append(tuple(p))
        if agg == "rate":
            if not mono:
                return None
            return sum(v for _, v in mono) / window
        if agg == "sum":
            if mono:
                return sum(v for _, v in mono)
            return sum(b[2] for b in buckets) if buckets else None
        if agg == "deriv":
            rows = sorted(mono) if mono \
                else sorted((b[0], b[5]) for b in buckets)
            if len(rows) < 2 or rows[-1][0] <= rows[0][0]:
                return None
            return (rows[-1][1] - rows[0][1]) \
                / (rows[-1][0] - rows[0][0])
        if not buckets:
            if not mono:
                return None
            # counters answer avg/min/max over their per-bucket deltas
            vals = [v for _, v in mono]
            buckets = [(t, 1, v, v, v, v) for t, v in mono]
            del vals
        if agg == "avg":
            n = sum(b[1] for b in buckets)
            return sum(b[2] for b in buckets) / n if n else None
        if agg == "min":
            return min(b[3] for b in buckets)
        if agg == "max":
            return max(b[4] for b in buckets)
        if agg == "last":
            return max(buckets)[5]
        q = agg
        if isinstance(q, str) and q.startswith("p"):
            q = float(q[1:]) / 100.0
        q = float(q)
        if not 0.0 < q <= 1.0:
            raise ValueError("unknown agg %r" % (agg,))
        return nearest_rank(sorted(b[5] for b in buckets), q)

    # -- surfaces ----------------------------------------------------------

    def series_names(self):
        with self._lock:
            return sorted({name for name, _ in self._series})

    def stats(self):
        with self._lock:
            n = len(self._series)
        return {
            "name": self.name,
            "tiers": [{"step_s": s, "retention_s": r}
                      for s, r in self.tiers],
            "series": n,
            "max_series": self.max_series,
            "samples": self.samples,
            "dropped_series": self.dropped_series,
            "evicted_series": self.evicted_series,
            "bytes_used": self.bytes_used(),
            "max_bytes": self.max_bytes,
        }

    def history(self, series=None, labels=None, window=60.0,
                agg="avg", tier=None, now=None):
        """The ``GET /metrics/history`` payload: without ``series``,
        the store's catalog (series names + tier table + bounds
        counters); with one, the windowed aggregate plus the raw
        bucket points the query aggregated over."""
        if not series:
            out = self.stats()
            out["series_names"] = self.series_names()
            return out
        try:
            value = self.range(series, labels=labels, window=window,
                               agg=agg, now=now, tier=tier)
        except ValueError as e:
            return {"error": str(e)}
        ti = self.tier_for(float(window), tier)
        return {
            "series": series,
            "labels": dict(labels or {}),
            "window_s": float(window),
            "agg": str(agg),
            "tier": ti,
            "tier_step_s": self.tiers[ti][0],
            "value": value,
            "points": [(round(t, 3), v) for t, v in self.points(
                series, labels=labels, window=window, tier=tier,
                now=now)],
        }


def history_query(store, query):
    """Answer a ``GET /metrics/history`` query string against a
    store — the one parser both the replica endpoint and the router
    endpoint share.  Parameters: ``series`` (none = the catalog),
    ``window`` (seconds), ``agg`` (avg/min/max/last/sum/rate/deriv/
    pNN), ``tier`` (force one), plus ``label.<name>=<value>``
    selectors."""
    from urllib.parse import parse_qs
    params = {k: v[-1] for k, v in parse_qs(query or "").items()}
    labels = {k[6:]: v for k, v in params.items()
              if k.startswith("label.")}
    try:
        window = float(params.get("window", 60.0))
        tier = params.get("tier")
        tier = int(tier) if tier is not None else None
    except ValueError:
        return {"error": "bad window/tier"}
    return store.history(series=params.get("series"),
                         labels=labels or None, window=window,
                         agg=params.get("agg", "avg"), tier=tier)


def store_enabled():
    """``root.common.tsdb.enabled`` (default True) — gates the
    background samplers the replica/router tiers arm, never the
    query API of a store a test built by hand."""
    return bool(_tsdb_conf("enabled", True))


# -- the weak store registry (flight recorder / alert engines) --------------

import weakref  # noqa: E402  (registry helpers mirror alerts.py)

_stores = {}
_slock = threading.Lock()


def register_store(store):
    """Weakly register a store so process-wide surfaces (the flight
    recorder's bundle, the alert grammar's default resolution) can
    find history without owning any store's lifecycle."""
    with _slock:
        _stores[id(store)] = weakref.ref(store)


def live_stores():
    with _slock:
        items = list(_stores.items())
    out = []
    for key, ref in items:
        store = ref()
        if store is None:
            with _slock:
                _stores.pop(key, None)
            continue
        out.append(store)
    return out


def default_store():
    """The live store an un-parameterized consumer (a replica-tier
    alert engine built without an explicit handle) reads — the most
    recently registered one, or None."""
    stores = live_stores()
    return stores[-1] if stores else None


def bundle_history(window=300.0, series=BUNDLE_SERIES):
    """Tier-0 tails of the key serving series from every live store,
    store-tagged — what a flight-recorder bundle embeds so a hang
    dump shows the lead-up, not just the moment of death."""
    out = {}
    for store in live_stores():
        rec = {}
        for name in series:
            try:
                pts = store.points(name, window=window, tier=0)
            except Exception:
                continue
            if pts:
                rec[name] = [(round(t, 3), v) for t, v in pts]
        if rec:
            out[store.name] = rec
    return out
