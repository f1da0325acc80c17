"""The live serving dashboard — one auto-refreshing escaped-HTML
page over the fleet's state; the port's own copy of
``veles_tpu/telemetry/dashboard.py``.

Veles shipped a web-status server as a first-class platform component;
this module is the *serving* counterpart: :func:`render_dashboard_html`
turns the data the router/replica tiers already hold — the replica
table, SLO burn rates, firing alerts, the live in-flight request table
and the goodput/padding gauges — into a single operator page, served at
``GET /dashboard`` on the router.

Discipline of a status page: EVERY interpolated
string is attacker input (replica ids come off the wire, trace ids
from clients) and goes through ``html.escape`` — the page must render
a hostile replica id as text, never as markup.
"""

import html
import time

_PAGE = """<!DOCTYPE html>
<html><head><title>%TITLE%</title>
<meta http-equiv="refresh" content="%REFRESH%">
<style>
 body { font-family: sans-serif; margin: 2em; }
 table { border-collapse: collapse; margin-bottom: 1.2em; }
 td, th { border: 1px solid #999; padding: 4px 10px; }
 th { background: #eee; }
 h3 { margin-bottom: 0.3em; }
 .page { color: #fff; background: #c0392b; }
 .ticket { color: #fff; background: #d68910; }
 .info { background: #d6eaf8; }
 .bad { color: #c0392b; font-weight: bold; }
 .warn { color: #d68910; }
 .meter { display: inline-block; height: 10px; background: #2e86c1;
          vertical-align: middle; }
 .dim { color: #888; }
</style></head>
<body><h2>%TITLE%</h2>%BODY%
<p class="dim">rendered %NOW% &middot; auto-refresh %REFRESH%s
 &middot; <a href="/alerts">alerts</a>
 <a href="/metrics">metrics</a></p></body></html>
"""


def _e(v, dash="-"):
    return html.escape(str(v)) if v is not None else dash


def _num(v, fmt="%.3g", dash="-"):
    try:
        return fmt % float(v)
    except (TypeError, ValueError):
        return dash


def _table(headers, rows):
    head = "".join("<th>%s</th>" % html.escape(h) for h in headers)
    body = "".join(
        "<tr>%s</tr>" % "".join("<td>%s</td>" % c for c in row)
        for row in rows)
    return "<table><tr>%s</tr>%s</table>" % (head, body)


def render_fleet_table(replicas):
    """The fleet table: one row per replica view dict (the router's
    ``_Replica.view()`` shape, ``last metrics`` fields included)."""
    if not replicas:
        return "<p class='dim'>no replicas registered</p>"
    rows = []
    for r in replicas:
        breaker = _e(r.get("breaker"))
        if r.get("breaker") == "open":
            breaker = "<span class='bad'>%s</span>" % breaker
        status = _e(r.get("status"))
        if r.get("status") not in ("ok", None):
            status = "<span class='warn'>%s</span>" % status
        rows.append((
            _e(r.get("id")), _e(r.get("role")), _e(r.get("tp")),
            status, breaker, _e(r.get("outstanding")),
            _e(r.get("queue_depth")),
            "%s/%s" % (_e(r.get("kv_blocks_used")),
                       _e(r.get("kv_blocks_free"))),
            _num(r.get("prefix_hit_rate")),
            _num(r.get("spec_accept_rate")),
            _num(r.get("goodput_tokens_per_sec"), "%.1f"),
            _num(r.get("bucket_padding_efficiency"), "%.2f"),
        ))
    return _table(("replica", "role", "tp", "status", "breaker",
                   "outstanding", "queue", "kv used/free",
                   "prefix hit", "spec accept", "goodput tok/s",
                   "pad eff"), rows)


def render_slo_meters(slo):
    """Burn-rate meters from an ``SLOTracker.snapshot()`` dict: one
    row per (class, kind), a bar per window (width saturates at
    14.4x — the page threshold)."""
    classes = (slo or {}).get("classes") or {}
    if not classes:
        return "<p class='dim'>no SLO observations yet</p>"
    rows = []
    for cls in sorted(classes):
        for kind in sorted(classes[cls]):
            rec = classes[cls][kind]
            burns = rec.get("burn_rate") or {}
            cells = [_e(cls), _e(kind),
                     "%s/%s" % (_e(rec.get("good", 0)),
                                _e(rec.get("bad", 0)))]
            for w in sorted(burns, key=lambda s: int(s.rstrip("s"))):
                burn = burns[w]
                width = max(1, min(100, int(
                    100 * float(burn or 0) / 14.4)))
                klass = " bad" if (burn or 0) >= 14.4 \
                    else (" warn" if (burn or 0) >= 1 else "")
                cells.append(
                    "%s: <span class='meter%s' style='width:%dpx'>"
                    "</span> %s" % (_e(w), klass, width, _num(burn)))
            rows.append(cells)
    width = max(len(r) for r in rows)
    rows = [tuple(r) + ("-",) * (width - len(r)) for r in rows]
    headers = ("class", "slo", "good/bad") \
        + tuple("burn" for _ in range(width - 3))
    return _table(headers, rows)


def render_alerts_table(firing, pending=()):
    if not firing and not pending:
        return "<p class='dim'>no alerts firing</p>"
    rows = []
    for state, alerts in (("firing", firing), ("pending", pending)):
        for a in alerts:
            sev = _e(a.get("severity"))
            rows.append((
                "<span class='%s'>%s</span>" % (sev, sev),
                _e(a.get("rule")), _e(state),
                _e(", ".join("%s=%s" % kv for kv in sorted(
                    (a.get("labels") or {}).items()))),
                _num(a.get("value")),
                _num(a.get("firing_for_s"), "%.1f")))
    return _table(("severity", "rule", "state", "labels", "value",
                   "for (s)"), rows)


def render_inflight_table(requests):
    if not requests:
        return "<p class='dim'>no requests in flight</p>"
    rows = [(
        _e(r.get("trace")), _e(r.get("phase")), _e(r.get("path")),
        _e(r.get("cls")), _num(r.get("age_s"), "%.2f"),
        _e(r.get("attempts")), _e(r.get("replica")),
        "yes" if r.get("stream") else "no",
    ) for r in requests]
    return _table(("trace", "phase", "path", "class", "age (s)",
                   "attempts", "replica", "stream"), rows)


_SPARK_BLOCKS = "▁▂▃▄▅▆▇█"


def _sparkline(points, width=40):
    """A unicode block sparkline over ``[(t, value)]`` points (last
    ``width`` kept) — no javascript, no external assets, survives
    any terminal-grade browser.  Returns "" for no data."""
    vals = [float(v) for _, v in points][-int(width):]
    vals = [v for v in vals if v == v]
    if not vals:
        return ""
    lo, hi = min(vals), max(vals)
    span = hi - lo
    if span <= 0:
        return _SPARK_BLOCKS[0] * len(vals)
    return "".join(
        _SPARK_BLOCKS[min(len(_SPARK_BLOCKS) - 1,
                          int((v - lo) / span * len(_SPARK_BLOCKS)))]
        for v in vals)


def render_history_sparklines(history):
    """The history section: ``history`` maps display name ->
    ``[(t, value)]`` tier-0 points (the tsdb ``points()`` shape).
    One row per series: sparkline + last/min/max over the window."""
    if not history:
        return "<p class='dim'>no history yet</p>"
    rows = []
    for name in sorted(history):
        points = list(history[name] or ())
        vals = [float(v) for _, v in points if v == v]
        if not vals:
            continue
        rows.append((
            _e(name),
            "<span style='font-family:monospace'>%s</span>"
            % html.escape(_sparkline(points)),
            _num(vals[-1]), _num(min(vals)), _num(max(vals))))
    if not rows:
        return "<p class='dim'>no history yet</p>"
    return _table(("series", "trend", "last", "min", "max"), rows)


def render_tenant_usage(usage):
    """The per-tenant metering lines: ``usage`` is the router's
    ``/tenants/usage`` payload (``{"window_s", "tenants": {label:
    {...}}}``)."""
    tenants = (usage or {}).get("tenants") or {}
    if not tenants:
        return "<p class='dim'>no tenant usage recorded</p>"
    rows = []
    for tenant in sorted(tenants):
        rec = tenants[tenant]
        rows.append((
            _e(tenant),
            _e(rec.get("prompt_tokens")),
            _e(rec.get("generated_tokens")),
            _num(rec.get("generated_tokens_per_sec")),
            _num(rec.get("kv_block_seconds"), "%.2f"),
            _num(rec.get("compute_seconds"), "%.3f")))
    return _table(("tenant", "prompt tok", "generated tok",
                   "gen tok/s", "kv block-s", "compute-s"), rows)


def render_dashboard_html(title, replicas=(), slo=None, alerts=None,
                          inflight=(), note=None, refresh=2,
                          history=None, tenants=None):
    """Compose the full page.  ``alerts`` is an
    ``AlertEngine.snapshot()`` dict (or None); ``history`` maps
    series display names to tier-0 point lists (sparkline rows);
    ``tenants`` is the ``/tenants/usage`` payload."""
    alerts = alerts or {}
    parts = []
    if note:
        parts.append("<p>%s</p>" % html.escape(str(note)))
    parts.append("<h3>fleet</h3>")
    parts.append(render_fleet_table(list(replicas)))
    parts.append("<h3>SLO burn</h3>")
    parts.append(render_slo_meters(slo))
    parts.append("<h3>alerts</h3>")
    parts.append(render_alerts_table(
        alerts.get("firing") or (), alerts.get("pending") or ()))
    if history is not None:
        parts.append("<h3>history</h3>")
        parts.append(render_history_sparklines(history))
    if tenants is not None:
        parts.append("<h3>tenant usage</h3>")
        parts.append(render_tenant_usage(tenants))
    parts.append("<h3>in flight</h3>")
    parts.append(render_inflight_table(list(inflight)))
    return (_PAGE
            .replace("%REFRESH%", str(int(refresh)))
            .replace("%TITLE%", html.escape(str(title)))
            .replace("%NOW%", time.strftime("%H:%M:%S"))
            .replace("%BODY%", "".join(parts)))
