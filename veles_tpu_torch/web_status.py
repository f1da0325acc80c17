"""Web status dashboard (the port of ``veles_tpu/web_status.py``).

A small HTTP service on the stdlib's ``ThreadingHTTPServer`` (the
reference's runs on tornado, which the card's machine does not have;
the routes, replies and HTML are the reference's): launchers POST their
run status to ``/update`` once a second — with the workflow's unit
graph and the tail of the event-span ring; browsers read ``/`` (an
auto-refreshing table of runs with per-worker state), ``/graph/<run>``
(the workflow graph as layered SVG), ``/events/<run>`` (the event
stream's tail, filterable by unit, name and kind), ``/alerts`` and
``/dashboard`` (this process's alert engines and in-flight requests,
:mod:`veles_tpu_torch.telemetry.alerts` and
:mod:`~veles_tpu_torch.telemetry.dashboard`); machines read
``/api/runs``, ``/healthz``, ``/debug/state`` and scrape ``/metrics``
(the process-wide registry as Prometheus text).  Every string an update
supplies is escaped; a malformed graph or event list answers 400.

:class:`StatusNotifier` is the launcher's side: it POSTs ``{id,
workflow, mode, metrics, graph, events, workers}`` to a server's
``/update`` every ``interval`` seconds and once more when it stops.

Run standalone:  ``python -m veles_tpu_torch.web_status --port 8090``
"""

import argparse
import json
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from veles_tpu_torch.logger import Logger


_PAGE = """<!DOCTYPE html>
<html><head><title>veles_tpu_torch status</title>
<meta http-equiv="refresh" content="2">
<style>
 body { font-family: sans-serif; margin: 2em; }
 table { border-collapse: collapse; }
 td, th { border: 1px solid #999; padding: 4px 10px; }
 th { background: #eee; }
 .dead { color: #999; }
</style></head>
<body><h2>veles_tpu_torch runs</h2>
<p><a href="/dashboard">dashboard</a> <a href="/alerts">alerts</a>
 <a href="/metrics">metrics</a> <a href="/debug/state">debug</a></p>
%TABLE%</body></html>
"""


def _render_runs(runs):
    import html
    e = html.escape  # EVERY update-supplied string is attacker input
    rows = []
    now = time.time()
    for rid, r in sorted(runs.items()):
        age = now - r.get("_received", now)
        cls = ' class="dead"' if age > 10 else ""
        workers = r.get("workers", [])
        wtable = "".join(
            "<br>%s: %s (%.0f jobs)" % (e(str(w.get("id"))),
                                        e(str(w.get("state"))),
                                        w.get("jobs", 0))
            for w in workers)
        metrics = ", ".join(
            "%s=%s" % (e(str(k)), e(str(v)))
            for k, v in (r.get("metrics") or {}).items())
        q = html.escape(rid, quote=True)
        links = ('<a href="/graph/%s">graph</a> '
                 '<a href="/events/%s">events</a>' % (q, q))
        rows.append(
            "<tr%s><td>%s</td><td>%s</td><td>%s</td><td>%s</td>"
            "<td>%s</td><td>%.0fs ago</td><td>%s</td></tr>"
            % (cls, e(rid), e(str(r.get("workflow", "?"))),
               e(str(r.get("mode", "?"))), metrics, wtable or "-", age,
               links))
    return ("<table><tr><th>run</th><th>workflow</th><th>mode</th>"
            "<th>metrics</th><th>workers</th><th>updated</th>"
            "<th>views</th></tr>" + "".join(rows) + "</table>")


_GROUP_FILL = {"PLUMBING": "#d9d9d9", "LOADER": "#c6dbef",
               "WORKER": "#c7e9c0", "TRAINER": "#fdd0a2",
               "EVALUATOR": "#fcbba1", "SERVICE": "#dadaeb"}


def _graph_layers(graph):
    """BFS depth from the roots; back edges (Repeater loops) simply
    point upward in the drawing."""
    nodes = graph.get("nodes", [])
    edges = graph.get("edges", [])
    succ = {}
    indeg = {n["id"]: 0 for n in nodes}
    for s, d in edges:
        succ.setdefault(s, []).append(d)
        indeg[d] = indeg.get(d, 0) + 1
    roots = [i for i, d in indeg.items() if d == 0] or \
        [nodes[0]["id"]] if nodes else []
    layer = {}
    frontier = list(roots)
    depth = 0
    while frontier:
        nxt = []
        for i in frontier:
            if i not in layer:
                layer[i] = depth
                nxt.extend(succ.get(i, []))
        frontier = nxt
        depth += 1
    for n in nodes:  # disconnected units go to the bottom
        layer.setdefault(n["id"], depth)
    return layer


def render_graph_svg(graph):
    """Layered SVG of a workflow graph dict (``Workflow.graph_dict``),
    rendered server-side without dependencies."""
    import html
    nodes = graph.get("nodes", [])
    edges = graph.get("edges", [])
    layer = _graph_layers(graph)
    by_layer = {}
    for n in nodes:
        by_layer.setdefault(layer[n["id"]], []).append(n)
    bw, bh, hgap, vgap = 170, 46, 30, 60
    pos = {}
    width = 40 + max((len(v) for v in by_layer.values()), default=1) \
        * (bw + hgap)
    for ly, members in sorted(by_layer.items()):
        for col, n in enumerate(members):
            pos[n["id"]] = (40 + col * (bw + hgap),
                            30 + ly * (bh + vgap))
    height = 30 + (max(by_layer, default=0) + 1) * (bh + vgap)
    parts = [
        '<svg xmlns="http://www.w3.org/2000/svg" width="%d" height="%d"'
        ' font-family="sans-serif" font-size="12">' % (width, height),
        '<defs><marker id="arr" markerWidth="8" markerHeight="8" '
        'refX="7" refY="3" orient="auto"><path d="M0,0 L7,3 L0,6 z" '
        'fill="#555"/></marker></defs>']
    for s, d in edges:
        if s not in pos or d not in pos:
            continue
        x1, y1 = pos[s][0] + bw / 2, pos[s][1] + bh
        x2, y2 = pos[d][0] + bw / 2, pos[d][1]
        if layer[d] <= layer[s]:  # back edge: loop out the side
            xa = min(pos[s][0], pos[d][0]) - 18
            parts.append(
                '<path d="M%g,%g C%g,%g %g,%g %g,%g" fill="none" '
                'stroke="#b55" stroke-dasharray="4 2" '
                'marker-end="url(#arr)"/>'
                % (x1 - bw / 2, y1 - bh / 2, xa, y1 - bh / 2,
                   xa, y2 + bh / 2, x2 - bw / 2, y2 + bh / 2))
        else:
            parts.append(
                '<line x1="%g" y1="%g" x2="%g" y2="%g" stroke="#555" '
                'marker-end="url(#arr)"/>' % (x1, y1, x2, y2))
    for n in nodes:
        x, y = pos[n["id"]]
        fill = _GROUP_FILL.get(n.get("group"), "#ffffff")
        parts.append(
            '<g><rect x="%g" y="%g" width="%d" height="%d" rx="6" '
            'fill="%s" stroke="#333"/>'
            '<text x="%g" y="%g" text-anchor="middle">%s</text>'
            '<text x="%g" y="%g" text-anchor="middle" fill="#666" '
            'font-size="10">%s</text></g>'
            % (x, y, bw, bh, fill,
               x + bw / 2, y + 19, html.escape(str(n["label"])[:24]),
               x + bw / 2, y + 35, html.escape(str(n["cls"])[:26])))
    parts.append("</svg>")
    return "".join(parts)


def _render_events(run_id, events, unit=None, name=None, kind=None,
                   limit=200):
    """Filterable HTML view of a run's event-span tail."""
    import html
    out = []
    for ev in reversed(events):
        if unit and str(ev.get("unit", ev.get("cls", ""))) != unit:
            continue
        if name and name not in str(ev.get("name", "")):
            continue
        if kind and ev.get("kind") != kind:
            continue
        out.append(ev)
        if len(out) >= limit:
            break
    rows = "".join(
        "<tr><td>%s</td><td>%s</td><td>%s</td><td>%s</td><td>%s</td>"
        "</tr>" % (
            time.strftime("%H:%M:%S",
                          time.localtime(ev.get("time", 0)))
            + ".%03d" % (1000 * (ev.get("time", 0) % 1)),
            html.escape(str(ev.get("name", ""))),
            html.escape(str(ev.get("kind", ""))),
            html.escape(str(ev.get("unit", ev.get("cls", "")))),
            html.escape(", ".join(
                "%s=%s" % (k, v) for k, v in sorted(ev.items())
                if k not in ("name", "kind", "unit", "cls", "time",
                             "pid"))))
        for ev in out)
    form = ('<form method="get">unit <input name="unit" value="%s"> '
            'name <input name="name" value="%s"> kind '
            '<select name="kind"><option value="">any</option>'
            '%s</select> <button>filter</button></form>'
            % (html.escape(unit or "", quote=True),
               html.escape(name or "", quote=True),
               "".join('<option%s>%s</option>'
                       % (' selected' if kind == k else '', k)
                       for k in ("begin", "end", "single"))))
    return ("<h2>events — %s</h2>%s<table><tr><th>time</th><th>name"
            "</th><th>kind</th><th>unit</th><th>attrs</th></tr>%s"
            "</table>" % (html.escape(run_id), form, rows))


class _StatusHandler(BaseHTTPRequestHandler):
    """Routes a request to its :class:`WebStatusServer` (``self.server.
    status``)."""

    def log_message(self, *args):
        pass

    def _reply(self, code, body, ctype):
        if isinstance(body, str):
            body = body.encode()
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _json(self, obj, code=200):
        self._reply(code, json.dumps(obj, default=str),
                    "application/json; charset=UTF-8")

    def _html(self, text):
        self._reply(200, text, "text/html; charset=utf-8")

    def do_POST(self):
        if urllib.parse.urlsplit(self.path).path != "/update":
            self.send_error(404)
            return
        try:
            data = json.loads(self.rfile.read(
                int(self.headers.get("Content-Length", 0))))
            if not isinstance(data, dict):
                raise ValueError("not an object")
        except ValueError:
            self.send_error(400, "malformed update")
            return
        data["_received"] = time.time()
        self.server.status.runs[str(data.get("id", "?"))] = data
        self._json({"ok": True})

    def do_GET(self):
        url = urllib.parse.urlsplit(self.path)
        path = url.path
        runs = self.server.status.runs
        if path == "/":
            self._html(_PAGE.replace("%TABLE%", _render_runs(runs)))
        elif path == "/api/runs":
            self._json({"runs": runs})
        elif path.startswith("/graph/"):
            self._graph(urllib.parse.unquote(path[len("/graph/"):]))
        elif path.startswith("/events/"):
            self._events(urllib.parse.unquote(path[len("/events/"):]),
                         dict(urllib.parse.parse_qsl(url.query)))
        elif path == "/metrics":
            from veles_tpu_torch.telemetry import (
                metrics, render_families_text)
            self._reply(200, render_families_text(
                metrics.collect_families()),
                "text/plain; version=0.0.4; charset=utf-8")
        elif path == "/alerts":
            from veles_tpu_torch.telemetry import alerts
            self._json({"engines": [e.snapshot()
                                    for e in alerts.live_engines()],
                        "firing": alerts.firing_table()})
        elif path == "/dashboard":
            self._dashboard()
        elif path == "/healthz":
            import os
            from veles_tpu_torch.telemetry.health import monitor
            state = monitor.state()
            # 503 once halted, so probes act without parsing the body
            self._json({"status": state["status"], "pid": os.getpid(),
                        "health": state},
                       503 if state["status"] == "halted" else 200)
        elif path == "/debug/state":
            from veles_tpu_torch.logger import events
            from veles_tpu_torch.telemetry.flight_recorder import recorder
            from veles_tpu_torch.telemetry.health import monitor
            self._json({"flightrec": recorder.state(),
                        "health": monitor.state(),
                        "events": list(events.ring)[-100:],
                        "logs": list(recorder.log_ring)[-50:]})
        else:
            self.send_error(404)

    def _graph(self, rid):
        import html
        run = self.server.status.runs.get(rid)
        if run is None or not run.get("graph"):
            self.send_error(404)
            return
        try:
            svg = render_graph_svg(run["graph"])
        except Exception:
            # an update is untrusted input: a malformed graph must not
            # fail the dashboard
            self.send_error(400, "malformed graph")
            return
        self._html("<!DOCTYPE html><html><body><h2>%s — workflow graph"
                   "</h2>%s</body></html>"
                   % (html.escape(str(run.get("workflow", rid))), svg))

    def _events(self, rid, query):
        run = self.server.status.runs.get(rid)
        if run is None:
            self.send_error(404)
            return
        try:
            body = _render_events(
                rid, run.get("events", []), unit=query.get("unit"),
                name=query.get("name"), kind=query.get("kind"))
        except Exception:
            self.send_error(400, "malformed events")
            return
        self._html("<!DOCTYPE html><html><body>%s</body></html>" % body)

    def _dashboard(self):
        from veles_tpu_torch.telemetry import alerts, reqtrace
        from veles_tpu_torch.telemetry.dashboard import render_dashboard_html
        engines = alerts.live_engines()
        merged = {"firing": alerts.firing_table(),
                  "pending": [row for e in engines
                              for row in e.snapshot().get("pending", ())]}
        self._html(render_dashboard_html(
            "veles_tpu_torch process dashboard", replicas=(), slo=None,
            alerts=merged, inflight=reqtrace.inflight_table(),
            note="process-local view: alerts + in-flight requests of "
                 "every engine/scheduler in this process (the fleet "
                 "table lives on the router's /dashboard)"))


class WebStatusServer(Logger):
    """The dashboard service on ``host:port`` (defaults:
    ``root.common.web.host`` and ``.port``, 8090; port 0 picks a free
    one, read back from ``port`` after :meth:`start`)."""

    def __init__(self, port=None, host=None):
        super(WebStatusServer, self).__init__()
        from veles_tpu_torch.config import root
        self.host = host or root.common.web.get("host", "localhost")
        self.port = int(root.common.web.get("port", 8090)
                        if port is None else port)
        self.runs = {}
        self._server = None
        self._thread = None

    def start(self, background=True):
        self._server = ThreadingHTTPServer((self.host, self.port),
                                           _StatusHandler)
        self._server.daemon_threads = True
        self._server.status = self
        self.port = self._server.server_address[1]
        self.info("web status on http://%s:%d/", self.host, self.port)
        if not background:
            self._server.serve_forever()
            return
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True, name="web-status")
        self._thread.start()

    def stop(self):
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
        if self._thread is not None:
            self._thread.join(5)
            self._thread = None


class StatusNotifier(Logger):
    """The launcher's POST loop: reports ``{id, workflow, mode,
    metrics, graph, events, workers}`` to a :class:`WebStatusServer`'s
    ``/update`` every ``interval`` seconds (``posted`` counts the POSTs
    that landed)."""

    def __init__(self, url, launcher, interval=1.0):
        super(StatusNotifier, self).__init__()
        self.url = url.rstrip("/") + "/update"
        self.launcher = launcher
        self.interval = interval
        self.posted = 0
        self._stop = threading.Event()
        self._thread = None

    def _status(self):
        import os
        from veles_tpu_torch.logger import events
        launcher = self.launcher
        wf = launcher.workflow
        status = {
            "id": "%s-%d" % (type(wf).__name__, os.getpid()),
            "workflow": getattr(wf, "name", type(wf).__name__),
            "mode": launcher.mode,
            "metrics": wf.gather_results() if wf is not None else {},
        }
        if wf is not None and hasattr(wf, "graph_dict"):
            status["graph"] = wf.graph_dict()
        # the tail of the span ring feeds the dashboard's event viewer
        status["events"] = list(events.ring)[-200:]
        coord = getattr(launcher, "coordinator", None)
        if coord is not None:
            status["workers"] = [
                {"id": w.id, "state": w.state, "power": w.power,
                 "jobs": w.jobs_done} for w in coord.workers.values()]
        return status

    def _post_once(self):
        import urllib.request
        body = json.dumps(self._status(), default=str).encode()
        req = urllib.request.Request(
            self.url, data=body,
            headers={"Content-Type": "application/json"})
        urllib.request.urlopen(req, timeout=2).read()
        self.posted += 1

    def run_forever(self):
        while not self._stop.wait(self.interval):
            try:
                self._post_once()
            except Exception as e:
                self.debug("status POST failed: %s", e)

    def start(self):
        self._thread = threading.Thread(target=self.run_forever,
                                        daemon=True, name="status-notify")
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            try:  # the final state lands even if the loop never fired
                self._post_once()
            except Exception as e:
                self.debug("final status POST failed: %s", e)
            self._thread.join(3)
            self._thread = None


def main(argv=None):
    p = argparse.ArgumentParser(prog="veles_tpu_torch.web_status")
    p.add_argument("--port", type=int, default=None,
                   help="default: root.common.web.port (8090)")
    args = p.parse_args(argv)
    WebStatusServer(port=args.port).start(background=False)
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
