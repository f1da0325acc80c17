"""The alert engine, the fleet federation and the dashboard of the
PyTorch port (``veles_tpu_torch/telemetry/{alerts, federation,
dashboard}.py``) held against the JAX package's (oracle
``tests/test_observability.py`` and the rule case of
``tests/test_controller.py``): given the same series both engines make
the same transitions (hold-down, no flap, the two-window burn pair,
the shipped rules), ``merge_scrapes`` renders the same text,
``render_dashboard_html`` the same page at a fixed time; the webhook
sink behind ``alerts.webhook``, config rules, the flight-recorder
bundle, ``GET /metrics/fleet`` and ``/dashboard`` over fake replicas
and a replica kill driving ``replica_unreachable`` end to end run on
the port's router.  The reference's wall-clock overhead gate is not
ported as a timing assert: a replica's engine is checked to tick and
its goodput gauges to export."""

import json
import threading
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from veles_tpu_torch import faults
from veles_tpu_torch.config import root
from veles_tpu_torch.logger import events
from veles_tpu_torch.telemetry.alerts import AlertEngine, AlertRule
from veles_tpu_torch.telemetry.registry import (
    MetricsRegistry, render_families_text)

from tests.test_torch_router import (  # noqa: F401 (fixture)
    make_replica, no_leaked_threads, post)
from tests.test_torch_tenant import knobs  # noqa: F401 (fixture)

pytestmark = pytest.mark.torch_port


@pytest.fixture(autouse=True)
def disarm():
    from veles_tpu import faults as jax_faults
    faults.clear()
    jax_faults.clear()
    yield
    faults.clear()
    jax_faults.clear()


def _pkgs():
    """(port, JAX) module pairs: alerts, registry, federation,
    dashboard."""
    import veles_tpu.telemetry.alerts as ja
    import veles_tpu.telemetry.dashboard as jd
    import veles_tpu.telemetry.federation as jf
    import veles_tpu.telemetry.registry as jr
    import veles_tpu_torch.telemetry.alerts as pa
    import veles_tpu_torch.telemetry.dashboard as pd
    import veles_tpu_torch.telemetry.federation as pf
    import veles_tpu_torch.telemetry.registry as pr
    return ((pa, pr, pf, pd), (ja, jr, jf, jd))


def _serve(handler_cls):
    server = ThreadingHTTPServer(("127.0.0.1", 0), handler_cls)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, server.server_address[1]


def _get(url, timeout=10):
    resp = urllib.request.urlopen(url, timeout=timeout)
    return resp.status, resp.read().decode()


def _transitions(fired):
    return [(w, rule.name, dict(inst.labels), inst.value)
            for w, rule, inst in fired]


# -- federation ---------------------------------------------------------------

SCRAPE_A = """\
# HELP veles_serving_tokens_generated_total tokens
# TYPE veles_serving_tokens_generated_total counter
veles_serving_tokens_generated_total 100
# TYPE veles_serving_ttft_ms histogram
veles_serving_ttft_ms_bucket{le="10"} 2
veles_serving_ttft_ms_bucket{le="+Inf"} 3
veles_serving_ttft_ms_sum 45.5
veles_serving_ttft_ms_count 3
# TYPE veles_serving_kv_blocks_free gauge
veles_serving_kv_blocks_free 7
# TYPE veles_serving_class_requests_total counter
veles_serving_class_requests_total{cls="high"} 4
"""

SCRAPE_B = """\
# TYPE veles_serving_tokens_generated_total counter
veles_serving_tokens_generated_total 11
# TYPE veles_serving_ttft_ms histogram
veles_serving_ttft_ms_bucket{le="10"} 1
veles_serving_ttft_ms_bucket{le="+Inf"} 1
veles_serving_ttft_ms_sum 2.5
veles_serving_ttft_ms_count 1
# TYPE veles_serving_kv_blocks_free gauge
veles_serving_kv_blocks_free 3
# TYPE veles_serving_class_requests_total counter
veles_serving_class_requests_total{cls="high"} 1
veles_serving_class_requests_total{cls="low"} 9
"""


def test_federation_merge_matches_reference():
    """Counters and histogram bucket/sum/count sum per label set,
    gauges stay per replica: the merged text is the JAX package's byte
    for byte, and it re-parses to itself; ``fleet_families`` adds the
    same fleet gauges."""
    texts = []
    for _, reg, fed, _ in _pkgs():
        scrapes = [("a", fed.parse_prometheus(SCRAPE_A)),
                   ("b", fed.parse_prometheus(SCRAPE_B))]
        text = reg.render_families_text(fed.merge_scrapes(scrapes))
        assert reg.render_families_text(fed.parse_prometheus(text)) \
            == text
        texts.append((text, reg.render_families_text(
            fed.fleet_families(scrapes, errors=["c"]))))
    assert texts[0] == texts[1]
    text = texts[0][0]
    for line in ("veles_serving_tokens_generated_total 111",
                 'veles_serving_ttft_ms_bucket{le="10"} 3',
                 'veles_serving_ttft_ms_bucket{le="+Inf"} 4',
                 "veles_serving_ttft_ms_sum 48",
                 "veles_serving_ttft_ms_count 4",
                 'veles_serving_class_requests_total{cls="high"} 5',
                 'veles_serving_class_requests_total{cls="low"} 9',
                 'veles_serving_kv_blocks_free{replica="a"} 7',
                 'veles_serving_kv_blocks_free{replica="b"} 3'):
        assert line in text
    assert "veles_fleet_scrape_errors 1" in texts[0][1]


def test_registry_collect_families_matches_text_render():
    """The structured collect and the text exposition are two views of
    one renderer, in both packages, equal across them."""
    out = []
    for _, reg_mod, _, _ in _pkgs():
        reg = reg_mod.MetricsRegistry()
        reg.counter("veles_t_total", "help").inc(2)
        reg.gauge("veles_t_g", "help", labelnames=("cls",)) \
            .labels(cls="a").set(1.5)
        reg.histogram("veles_t_ms", "h", buckets=(1.0,)).observe(0.5)
        assert reg_mod.render_families_text(reg.collect_families()) \
            == reg.render_prometheus()
        out.append(reg.collect_families())
    assert out[0] == out[1]


# -- fake replicas ------------------------------------------------------------

def _fake_replica(tokens, free):
    class Fake(BaseHTTPRequestHandler):
        def log_message(self, *args):
            pass

        def _reply(self, code, blob, ctype="application/json"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(blob)))
            self.end_headers()
            self.wfile.write(blob)

        def do_GET(self):
            path = self.path.split("?")[0]
            if path == "/healthz":
                self._reply(200, json.dumps(
                    {"status": "ok", "role": "both", "tp": 2,
                     "draining": False}).encode())
            elif path == "/serving/metrics":
                self._reply(200, json.dumps(
                    {"queue_depth": 1, "kv_blocks_used": 3,
                     "kv_blocks_free": free,
                     "goodput_tokens_per_sec": 42.5,
                     "bucket_padding_efficiency": 0.75,
                     "prefix_cache_hit_rate": 0.5,
                     "spec_accept_rate": 0.6}).encode())
            elif path == "/metrics":
                self._reply(200, (
                    "# TYPE veles_serving_tokens_generated_total "
                    "counter\n"
                    "veles_serving_tokens_generated_total %d\n"
                    "# TYPE veles_serving_kv_blocks_free gauge\n"
                    "veles_serving_kv_blocks_free %d\n"
                    % (tokens, free)).encode(), "text/plain")
            else:
                self._reply(404, b"{}")

    return Fake


def test_fleet_scrape_and_dashboard_over_fake_replicas():
    """``GET /metrics/fleet`` on the port's router equals the hand-summed
    replica scrapes; ``/dashboard`` renders the fleet with a hostile
    replica id escaped; query strings never 404."""
    from veles_tpu_torch.serving import Router
    s1, p1 = _serve(_fake_replica(100, 7))
    s2, p2 = _serve(_fake_replica(11, 3))
    hostile = 'rep<script>alert(1)</script>'
    router = Router(health_interval=0.1).start()
    try:
        router.add_replica("127.0.0.1", p1, replica_id=hostile)
        router.add_replica("127.0.0.1", p2, replica_id="rep2")
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            st, fleet = _get(router.url + "/metrics/fleet")
            if "veles_serving_tokens_generated_total 111" in fleet:
                break
            time.sleep(0.1)
        assert "veles_serving_tokens_generated_total 111" in fleet
        assert "veles_fleet_replicas 2" in fleet
        assert "veles_fleet_scrape_errors 0" in fleet
        assert 'veles_serving_kv_blocks_free{replica="rep2"} 3' in fleet
        st, page = _get(router.url + "/dashboard")
        assert st == 200
        assert "<script>" not in page and "rep&lt;script&gt;" in page
        assert "42.5" in page and "0.75" in page
        for path in ("/metrics?x=1", "/metrics/fleet?x=1",
                     "/alerts?probe=1", "/dashboard?r=2",
                     "/healthz?probe=1", "/router/state?x=y",
                     "/metrics/history?x=1", "/tenants/usage?window=5"):
            assert _get(router.url + path)[0] == 200, path
    finally:
        router.stop()
        for s in (s1, s2):
            s.shutdown()
            s.server_close()


# -- the state machine --------------------------------------------------------

def _state_machine(alerts_mod, reg_mod):
    reg = reg_mod.MetricsRegistry()
    g = reg.gauge("veles_t_pressure", "x")
    engine = alerts_mod.AlertEngine(
        name="t", registry=reg, interval=999,
        rules=[alerts_mod.AlertRule("hot", expr="veles_t_pressure > 5",
                                    for_seconds=1.0, severity="page")])
    t0, out = 100.0, []
    for value, dt in ((9, 0.0), (9, 1.1), (1, 2.0), (9, 3.0), (1, 3.5),
                      (1, 9.0), (9, 10.0), (9, 10.5), (9, 11.2),
                      (9, 12.0), (0, 13.0)):
        g.set(value)
        out.append(_transitions(engine.tick(now=t0 + dt)))
        snap = engine.snapshot()
        out.append(([r["rule"] for r in snap["pending"]],
                    [r["rule"] for r in snap["firing"]]))
    return engine, out


def test_alert_state_machine_matches_reference():
    """pending → firing after ``for_seconds`` of continuous truth,
    resolved on the first false tick, a condition shorter than the
    hold-down never fires: both engines make the same transitions over
    the same series; the port's sinks (the firing gauge, the event
    ring) carry them."""
    (pa, pr, _, _), (ja, jr, _, _) = _pkgs()
    engine, got = _state_machine(pa, pr)
    _, want = _state_machine(ja, jr)
    assert got == want
    assert got[0] == [] and got[1] == (["hot"], [])
    assert [t[0] for t in got[2]] == ["fire"]
    assert [t[0] for t in got[4]] == ["resolve"]
    assert all(t == [] for t in got[6:12:2])
    assert engine.snapshot()["recent_resolved"][0]["rule"] == "hot"
    from veles_tpu_torch.telemetry import metrics
    fam = metrics.get("veles_alerts_firing")
    assert fam.labels(rule="hot", severity="page").value == 0
    ring = [ev for ev in list(events.ring) if ev.get("rule") == "hot"]
    assert any(ev["name"] == "alert.fire" for ev in ring)
    assert any(ev["name"] == "alert.resolve" for ev in ring)
    assert metrics.get("veles_alerts_transitions_total").labels(
        rule="hot", to="firing").value >= 2


def _slo_burn(alerts_mod, reg_mod):
    reg = reg_mod.MetricsRegistry()
    burn = reg.gauge("veles_slo_burn_rate", "x",
                     labelnames=("scope", "cls", "slo", "window"))
    rule = alerts_mod.AlertRule(
        "page", kind="slo_burn", severity="page",
        params={"fast": "60s", "slow": "300s", "threshold": 14.4})
    engine = alerts_mod.AlertEngine(name="slo", registry=reg,
                                    interval=999, rules=[rule])
    out = []
    for i, (fast, slow) in enumerate(((20.0, 1.0), (1.0, 20.0),
                                      (20.0, 20.0), (20.0, 20.0),
                                      (0.0, 0.0))):
        for w, v in (("60s", fast), ("300s", slow)):
            burn.labels(scope="serving", cls="high", slo="ttft",
                        window=w).set(v)
        out.append(_transitions(engine.tick(now=1.0 + i)))
    return out


def test_slo_burn_rule_matches_reference():
    """The two-window burn pair pages only while both windows burn,
    in both packages alike."""
    (pa, pr, _, _), (ja, jr, _, _) = _pkgs()
    got = _slo_burn(pa, pr)
    assert got == _slo_burn(ja, jr)
    assert got[0] == got[1] == got[3] == []
    assert [t[0] for t in got[2]] == ["fire"]
    assert got[2][0][2]["window"] == "60s+300s"
    assert [t[0] for t in got[4]] == ["resolve"]


def test_default_rules_match_reference():
    """The shipped rule set is the reference's rule for rule, and its
    series are ones the port's modules export under the reference's
    names."""
    (pa, _, _, _), (ja, _, _, _) = _pkgs()
    assert [r.describe() for r in pa.default_rules()] \
        == [r.describe() for r in ja.default_rules()]


def _webhook(alerts_mod, reg_mod, fault_mod):
    posts = []

    class Sink(BaseHTTPRequestHandler):
        def log_message(self, *args):
            pass

        def do_POST(self):
            body = self.rfile.read(int(self.headers.get(
                "Content-Length", 0)))
            posts.append(json.loads(body))
            self.send_response(200)
            self.send_header("Content-Length", "2")
            self.end_headers()
            self.wfile.write(b"{}")

    server, port = _serve(Sink)
    reg = reg_mod.MetricsRegistry()
    g = reg.gauge("veles_t_g", "x")
    engine = alerts_mod.AlertEngine(
        name="wh", registry=reg, interval=999,
        webhook_url="http://127.0.0.1:%d/hook" % port,
        rules=[alerts_mod.AlertRule("r", expr="veles_t_g > 0")])
    try:
        g.set(1)
        engine.tick(now=1.0)
        first = (engine.webhook_ok, [(p["event"], p["rule"], p["labels"],
                                      p["engine"]) for p in posts])
        fault_mod.inject("alerts.webhook", "drop")
        g.set(0)
        out = _transitions(engine.tick(now=2.0))
        return first, out, engine.webhook_failures, len(posts)
    finally:
        fault_mod.clear()
        server.shutdown()
        server.server_close()


def test_webhook_sink_and_fault_point():
    """fire and resolve POST JSON to the webhook; an armed
    ``alerts.webhook`` drops the POST and counts a failure without
    breaking the engine — the port as the reference."""
    from veles_tpu import faults as jax_faults
    (pa, pr, _, _), (ja, jr, _, _) = _pkgs()
    got = _webhook(pa, pr, faults)
    assert got == _webhook(ja, jr, jax_faults)
    first, out, failures, n = got
    assert first == (1, [("fire", "r", {}, "wh")])
    assert [t[0] for t in out] == ["resolve"]
    assert failures == 1 and n == 1


def test_config_rules_and_bad_expr_rejected(knobs):
    """Rules load from ``root.common.alerts.rules`` dicts, with the
    defaults off; a malformed expression or severity fails at
    construction — in both packages."""
    (pa, pr, _, _), (ja, jr, _, _) = _pkgs()
    knobs.alerts.rules = (
        {"name": "mine", "expr": "veles_t_g >= 2", "for": 0.5,
         "severity": "info"},)
    knobs.alerts.defaults = False
    for alerts_mod, reg_mod in ((pa, pr), (ja, jr)):
        engine = alerts_mod.AlertEngine(
            name="cfg", registry=reg_mod.MetricsRegistry(), interval=999)
        assert [r.name for r in engine.rules] == ["mine"]
        assert engine.rules[0].for_seconds == 0.5
        with pytest.raises(ValueError):
            alerts_mod.AlertRule("bad", expr="not a rule at all")
        with pytest.raises(ValueError):
            alerts_mod.AlertRule("bad", expr="veles_x > 1",
                                 severity="sev51")


def test_flight_recorder_bundle_embeds_firing_alerts():
    """A bundle carries the firing alerts of every live engine."""
    from veles_tpu_torch.telemetry.flight_recorder import FlightRecorder
    reg = MetricsRegistry()
    reg.gauge("veles_t_g", "x").set(5)
    engine = AlertEngine(name="fr", registry=reg, interval=999,
                         rules=[AlertRule("stuck", expr="veles_t_g > 1")])
    engine.tick(now=1.0)
    assert engine.firing()
    bundle = FlightRecorder().bundle("test")
    mine = [a for a in bundle["alerts"] if a.get("engine") == "fr"]
    assert mine and mine[0]["rule"] == "stuck"


def test_replica_kill_drives_alert_end_to_end(knobs):
    """Killing a replica drives the shipped ``replica_unreachable``
    rule of the port's router to firing (``GET /alerts``, the event
    ring, the dashboard); reviving it resolves the alert."""
    from veles_tpu_torch.serving import Router
    knobs.alerts.interval = 0.05
    server, port = _serve(_fake_replica(5, 5))
    router = Router(health_interval=0.05, health_timeout=0.5).start()
    server2 = None
    try:
        router.add_replica("127.0.0.1", port, replica_id="victim")
        time.sleep(0.3)
        server.shutdown()
        server.server_close()
        deadline = time.monotonic() + 15
        firing = []
        while time.monotonic() < deadline and not firing:
            firing = [a for a in json.loads(
                _get(router.url + "/alerts")[1])["firing"]
                if a["rule"] == "replica_unreachable"]
            time.sleep(0.05)
        assert firing, "replica_unreachable never fired"
        assert firing[0]["labels"]["replica"] == "victim"
        assert any(ev.get("name") == "alert.fire"
                   and ev.get("rule") == "replica_unreachable"
                   for ev in list(events.ring))
        assert "replica_unreachable" in _get(router.url + "/dashboard")[1]
        server2 = ThreadingHTTPServer(("127.0.0.1", port),
                                      _fake_replica(5, 5))
        threading.Thread(target=server2.serve_forever, daemon=True).start()
        deadline = time.monotonic() + 15
        while time.monotonic() < deadline:
            snap = json.loads(_get(router.url + "/alerts")[1])
            if not [a for a in snap["firing"]
                    if a["rule"] == "replica_unreachable"]:
                break
            time.sleep(0.05)
        assert [a for a in snap["recent_resolved"]
                if a["rule"] == "replica_unreachable"]
    finally:
        router.stop()
        if server2 is not None:
            server2.shutdown()
            server2.server_close()


# -- dashboard ----------------------------------------------------------------

EVIL = '<script>alert(1)</script>'


def _dashboard(dash_mod):
    return dash_mod.render_dashboard_html(
        "t" + EVIL,
        replicas=[{"id": EVIL, "role": EVIL, "status": EVIL,
                   "breaker": EVIL, "outstanding": 1,
                   "goodput_tokens_per_sec": 12.5}],
        slo={"classes": {EVIL: {"e2e": {"good": 1, "bad": 0,
                                        "burn_rate": {"60s": 0.5}}}}},
        alerts={"firing": [{"rule": EVIL, "severity": "page",
                            "labels": {EVIL: EVIL}, "value": 1}]},
        inflight=[{"trace": EVIL, "path": EVIL, "phase": "proxy"}],
        note=EVIL)


def test_dashboard_renderer_matches_reference_and_escapes(monkeypatch):
    """Every interpolated string goes through ``html.escape``; at a
    fixed time the page is the JAX package's byte for byte."""
    monkeypatch.setattr(time, "strftime", lambda fmt, *a: "12:34:56")
    (_, _, _, pd), (_, _, _, jd) = _pkgs()
    page = _dashboard(pd)
    assert page == _dashboard(jd)
    assert "<script>" not in page
    assert page.count("&lt;script&gt;") >= 7


# -- the shipped rules the fleet tier feeds ------------------------------------

def _flap_rules(alerts_mod, reg_mod):
    rules = {r.name: r for r in alerts_mod.default_rules()}
    reg = reg_mod.MetricsRegistry()
    flaps = reg.counter("veles_controller_scale_transitions_total", "x")
    shed = reg.counter("veles_router_tenant_throttled_total", "x",
                       labelnames=("tenant",))
    engine = alerts_mod.AlertEngine(
        name="ctl-rules", registry=reg, interval=999,
        rules=[rules["controller_flapping"], rules["tenant_throttled"]])
    shed.labels(tenant="mallory").inc()
    out = [_transitions(engine.tick(now=100.0))]
    for dt in (10, 20):
        flaps.inc(4)
        shed.labels(tenant="mallory").inc(30)
        out.append(_transitions(engine.tick(now=100.0 + dt)))
    return out, sorted(r["rule"] for r in engine.firing())


def test_controller_flapping_and_tenant_throttled_rules():
    """The controller-flapping and tenant-throttled rules fire on the
    series the controller and the admission lane move, in both
    packages alike."""
    (pa, pr, _, _), (ja, jr, _, _) = _pkgs()
    got = _flap_rules(pa, pr)
    assert got == _flap_rules(ja, jr)
    out, firing = got
    assert out[0] == out[1] == []
    assert sorted(t[1] for t in out[2] if t[0] == "fire") \
        == ["controller_flapping", "tenant_throttled"]
    assert firing == ["controller_flapping", "tenant_throttled"]


# -- a replica's engine --------------------------------------------------------

def test_replica_engine_ticks_and_goodput_gauges(knobs):
    """A replica's alert engine and store run while it serves (ticks
    counted, samples taken — the reference's overhead gate is a
    wall-clock ratio, printed by the card smoke, not asserted here),
    ``GET /alerts`` answers the engine's snapshot with the shipped
    rules, the goodput and padding gauges export for the replica, and
    ``stop()`` joins both threads."""
    from veles_tpu_torch.telemetry import metrics
    knobs.alerts.interval = 0.05
    knobs.tsdb.tiers = ((0.05, 30.0),)
    rep = make_replica()
    try:
        url = "http://%s:%d" % (rep.host, rep.port)
        for i in range(3):
            post(url, {"prompt": [3, 1, 4], "steps": 6, "seed": i})
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and (
                rep.api.alerts_.ticks < 3 or rep.api.tsdb_.samples < 3):
            time.sleep(0.05)
        assert rep.api.alerts_.ticks >= 3 and rep.api.tsdb_.samples >= 3
        snap = json.loads(_get(url + "/alerts")[1])
        assert snap["engine"] == rep.replica_id and snap["ticks"] >= 3
        assert {r["name"] for r in snap["rules"]} >= {
            "breaker_open", "kv_block_pressure", "goodput_regression"}
        rid = rep.api.scheduler_.replica_id
        for name in ("veles_serving_goodput_tokens_per_sec",
                     "veles_serving_bucket_padding_efficiency"):
            assert (rid,) in metrics.get(name).children(), name
        threads = (rep.api.alerts_._thread, rep.api.tsdb_._thread)
    finally:
        rep.stop()
    assert not any(t.is_alive() for t in threads)
    assert rep.api.alerts_ is None and rep.api.tsdb_ is None
