"""Metrics registry — counters, gauges, histograms; the port of
``veles_tpu/telemetry/registry.py``.

Metrics aggregate in process behind one lock per metric and export on
demand:

- :class:`Counter` — monotonically increasing totals;
- :class:`Gauge` — instantaneous values (queue depth, active slots),
  optionally read from a callback (:meth:`Gauge.set_function`);
- :class:`Histogram` — fixed cumulative buckets (Prometheus
  exposition) plus a bounded reservoir of recent observations for
  nearest-rank percentiles (p50/p95/p99 without unbounded memory);
- labeled series: a family created with ``labelnames`` hands out one
  child per label-value tuple via :meth:`_Family.labels`.

``MetricsRegistry.render_prometheus()`` produces the text exposition
format v0.0.4, byte for byte what the JAX package renders for the same
operations.  The process-wide registry is
:data:`veles_tpu_torch.telemetry.metrics`.
"""

import math
import threading
from collections import deque

#: default latency buckets (seconds): 1 ms .. 60 s, roughly log-spaced
DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                   0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)

#: millisecond-scale buckets for latency series recorded in ms (TTFT,
#: queue wait) — same spread, ms units
MS_BUCKETS = (1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
              1000.0, 2500.0, 5000.0, 10000.0, 30000.0, 60000.0)


def nearest_rank(sorted_vals, q):
    """Nearest-rank percentile over a SORTED sequence: the value at
    1-based rank ``ceil(q * n)``, clamped to the window.  ``q=0.5``
    over a 2-element window returns the LOWER value; ``q=0.99`` can
    never index out of range on tiny windows."""
    n = len(sorted_vals)
    if not n:
        return None
    i = max(0, min(n - 1, int(math.ceil(q * n)) - 1))
    return sorted_vals[i]


def _format_value(v):
    if v == float("inf"):
        return "+Inf"
    if v == float("-inf"):
        return "-Inf"
    if isinstance(v, float) and v != v:
        return "NaN"
    if isinstance(v, float) and v.is_integer():
        return str(int(v))
    return repr(v) if isinstance(v, float) else str(v)


def _escape_label(v):
    return str(v).replace("\\", "\\\\").replace('"', '\\"') \
        .replace("\n", "\\n")


def _label_str(labelnames, labelvalues):
    if not labelnames:
        return ""
    return "{%s}" % ",".join(
        '%s="%s"' % (k, _escape_label(v))
        for k, v in zip(labelnames, labelvalues))


class Counter:
    """Monotonically increasing total."""

    TYPE = "counter"

    def __init__(self, name, help=""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, amount=1):
        if amount < 0:
            raise ValueError("counters only go up (inc %r)" % amount)
        with self._lock:
            self._value += amount

    @property
    def value(self):
        with self._lock:
            return self._value

    def samples(self):
        """Structured samples: (suffix, extra labels, value) — the
        in-process read, without a round trip through the text
        format."""
        return [("", {}, self.value)]

    def expose(self, labels=""):
        yield "%s%s %s" % (self.name, labels,
                           _format_value(self.value))


class Gauge:
    """Instantaneous value (settable both ways)."""

    TYPE = "gauge"

    def __init__(self, name, help=""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._value = 0.0
        self._fn = None

    def set(self, value):
        with self._lock:
            self._value = float(value)

    def inc(self, amount=1):
        with self._lock:
            self._value += amount

    def dec(self, amount=1):
        with self._lock:
            self._value -= amount

    def set_function(self, fn):
        """Read the gauge from a callback at exposition time (for
        values someone else already tracks, e.g. queue depth)."""
        self._fn = fn

    @property
    def value(self):
        if self._fn is not None:
            try:
                return float(self._fn())
            except Exception:
                return float("nan")
        with self._lock:
            return self._value

    def samples(self):
        return [("", {}, self.value)]

    def expose(self, labels=""):
        yield "%s%s %s" % (self.name, labels,
                           _format_value(self.value))


class Histogram:
    """Cumulative fixed buckets + a bounded reservoir of recent
    observations.

    The buckets feed the Prometheus exposition (``_bucket{le=...}`` /
    ``_sum`` / ``_count``); the reservoir — a deque of the last
    ``reservoir`` observations — answers :meth:`percentile` queries by
    nearest rank, which is what serving snapshots read."""

    TYPE = "histogram"

    def __init__(self, name, help="", buckets=DEFAULT_BUCKETS,
                 reservoir=512):
        self.name = name
        self.help = help
        self.buckets = tuple(sorted(float(b) for b in buckets))
        self._lock = threading.Lock()
        self._bucket_counts = [0] * (len(self.buckets) + 1)  # +Inf
        self._count = 0
        self._sum = 0.0
        self._min = None
        self._max = None
        self._recent = deque(maxlen=int(reservoir))

    def observe(self, value):
        value = float(value)
        with self._lock:
            self._count += 1
            self._sum += value
            self._min = value if self._min is None \
                else min(self._min, value)
            self._max = value if self._max is None \
                else max(self._max, value)
            self._recent.append(value)
            for i, b in enumerate(self.buckets):
                if value <= b:
                    self._bucket_counts[i] += 1
                    break
            else:
                self._bucket_counts[-1] += 1

    @property
    def count(self):
        with self._lock:
            return self._count

    @property
    def sum(self):
        with self._lock:
            return self._sum

    @property
    def min(self):
        with self._lock:
            return self._min

    @property
    def max(self):
        with self._lock:
            return self._max

    def mean(self):
        with self._lock:
            return self._sum / self._count if self._count else None

    def percentile(self, q):
        """Nearest-rank percentile over the recent reservoir (None on
        an empty histogram)."""
        with self._lock:
            window = sorted(self._recent)
        return nearest_rank(window, q)

    def summary(self):
        """Plain-dict digest (count/sum/mean/min/max/p50/p95/p99)."""
        with self._lock:
            window = sorted(self._recent)
            count, total = self._count, self._sum
            vmin, vmax = self._min, self._max
        return {
            "count": count,
            "sum": round(total, 6),
            "mean": round(total / count, 6) if count else None,
            "min": round(vmin, 6) if vmin is not None else None,
            "max": round(vmax, 6) if vmax is not None else None,
            "p50": nearest_rank(window, 0.50),
            "p95": nearest_rank(window, 0.95),
            "p99": nearest_rank(window, 0.99),
        }

    def samples(self):
        """Structured exposition samples, cumulative buckets included
        (``le`` rides as an extra label, mirroring the text form)."""
        with self._lock:
            counts = list(self._bucket_counts)
            count, total = self._count, self._sum
        out = []
        acc = 0
        for b, c in zip(self.buckets, counts):
            acc += c
            out.append(("_bucket", {"le": _format_value(b)}, acc))
        out.append(("_bucket", {"le": "+Inf"}, acc + counts[-1]))
        out.append(("_sum", {}, total))
        out.append(("_count", {}, count))
        return out

    def expose(self, labels=""):
        with self._lock:
            counts = list(self._bucket_counts)
            count, total = self._count, self._sum
        # exposition buckets are CUMULATIVE
        acc = 0
        inner = labels[1:-1] if labels else ""
        for b, c in zip(self.buckets, counts):
            acc += c
            sep = "," if inner else ""
            yield '%s_bucket{%s%sle="%s"} %d' % (
                self.name, inner, sep, _format_value(b), acc)
        acc += counts[-1]
        sep = "," if inner else ""
        yield '%s_bucket{%s%sle="+Inf"} %d' % (self.name, inner, sep,
                                               acc)
        yield "%s_sum%s %s" % (self.name, labels, _format_value(total))
        yield "%s_count%s %d" % (self.name, labels, count)


class _Family:
    """A labeled metric family: one child metric per label-value
    tuple, created on first use."""

    def __init__(self, cls, name, help, labelnames, **kwargs):
        self.cls = cls
        self.name = name
        self.help = help
        self.TYPE = cls.TYPE
        self.labelnames = tuple(labelnames)
        self._kwargs = kwargs
        self._lock = threading.Lock()
        self._children = {}

    def labels(self, *labelvalues, **labelkv):
        if labelkv:
            if labelvalues:
                raise ValueError(
                    "pass label values positionally OR by name")
            labelvalues = tuple(labelkv[k] for k in self.labelnames)
        labelvalues = tuple(str(v) for v in labelvalues)
        if len(labelvalues) != len(self.labelnames):
            raise ValueError("expected labels %s, got %r"
                             % (self.labelnames, labelvalues))
        with self._lock:
            child = self._children.get(labelvalues)
            if child is None:
                child = self.cls(self.name, self.help, **self._kwargs)
                self._children[labelvalues] = child
        return child

    def children(self):
        with self._lock:
            return dict(self._children)

    def remove(self, *labelvalues):
        """Drop one child series (e.g. a deregistered replica's
        labeled gauge) so stale labels stop exporting forever."""
        labelvalues = tuple(str(v) for v in labelvalues)
        with self._lock:
            self._children.pop(labelvalues, None)

    def samples(self):
        out = []
        for labelvalues, child in sorted(self.children().items()):
            base = dict(zip(self.labelnames, labelvalues))
            for suffix, extra, value in child.samples():
                labels = dict(base)
                labels.update(extra)
                out.append((suffix, labels, value))
        return out

    def expose(self):
        for labelvalues, child in sorted(self.children().items()):
            for line in child.expose(
                    _label_str(self.labelnames, labelvalues)):
                yield line


class MetricsRegistry:
    """Get-or-create registry of metric families.

    ``counter/gauge/histogram`` return the existing series when the
    name is already registered (same semantics as ``logging.getLogger``
    — modules declare the metrics they touch without coordinating);
    asking for a registered name with a different type raises."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics = {}   # name -> metric or _Family

    def _get_or_create(self, cls, name, help, labelnames, **kwargs):
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if existing.TYPE != cls.TYPE:
                    raise ValueError(
                        "metric %s already registered as %s"
                        % (name, existing.TYPE))
                return existing
            if labelnames:
                m = _Family(cls, name, help, labelnames, **kwargs)
            else:
                m = cls(name, help, **kwargs)
            self._metrics[name] = m
            return m

    def counter(self, name, help="", labelnames=()):
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name, help="", labelnames=()):
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(self, name, help="", labelnames=(),
                  buckets=DEFAULT_BUCKETS, reservoir=512):
        return self._get_or_create(Histogram, name, help, labelnames,
                                   buckets=buckets, reservoir=reservoir)

    def get(self, name):
        with self._lock:
            return self._metrics.get(name)

    def unregister(self, name):
        with self._lock:
            self._metrics.pop(name, None)

    def collect(self):
        with self._lock:
            return sorted(self._metrics.items())

    def collect_families(self):
        """Structured exposition: one dict per family —
        ``{name, type, help, samples: [(suffix, labels, value)]}`` —
        read in process instead of rendering to the text format and
        parsing it back."""
        out = []
        for name, m in self.collect():
            out.append({"name": name, "type": m.TYPE,
                        "help": m.help, "samples": m.samples()})
        return out

    def render_prometheus(self):
        """The registry as Prometheus text exposition format v0.0.4
        (the one text renderer, over :meth:`collect_families`)."""
        return render_families_text(self.collect_families())

    def snapshot(self):
        """Plain nested dict of every series (histograms as their
        :meth:`Histogram.summary`) — the JSON-friendly read."""
        out = {}
        for name, m in self.collect():
            if isinstance(m, _Family):
                fam = {}
                for lv, child in sorted(m.children().items()):
                    key = ",".join(lv)
                    fam[key] = child.summary() \
                        if isinstance(child, Histogram) else child.value
                out[name] = fam
            elif isinstance(m, Histogram):
                out[name] = m.summary()
            else:
                out[name] = m.value
        return out


def render_families_text(families):
    """Render structured families (the :meth:`MetricsRegistry.
    collect_families` shape) as Prometheus text exposition v0.0.4 —
    the single text renderer of the registry."""
    lines = []
    for fam in families:
        name = fam["name"]
        if fam.get("help"):
            lines.append("# HELP %s %s" % (
                name, fam["help"].replace("\\", "\\\\")
                .replace("\n", "\\n")))
        lines.append("# TYPE %s %s" % (name, fam["type"]))
        for suffix, labels, value in fam["samples"]:
            label_str = _label_str(tuple(labels), tuple(
                labels.values())) if labels else ""
            if suffix in ("_bucket", "_count"):
                lines.append("%s%s%s %d" % (name, suffix, label_str,
                                            value))
            else:
                lines.append("%s%s%s %s" % (name, suffix, label_str,
                                            _format_value(value)))
    return "\n".join(lines) + "\n"


#: the process-wide registry (re-exported as
#: :data:`veles_tpu_torch.telemetry.metrics`): every scheduler's
#: ``veles_serving_*`` series, the router's ``veles_router_*``, the
#: ``veles_health_*`` and ``veles_alerts_*`` ones
metrics = MetricsRegistry()
