"""The embedded time-series store of the PyTorch port
(``veles_tpu_torch/telemetry/tsdb.py``) and the scheduler's tenant
metering, held against the JAX package (oracle ``tests/test_tsdb.py``):
both stores fed the same sample stream on an injected clock answer
``range``/``points``/``history()`` and ``history_query`` equally —
counter rates across tier boundaries, the reset clamp, nearest-rank
quantiles, histograms (buckets skipped, sum and count kept), the byte
budget; the trend rules over a store make the same transitions; the
dashboard's sparklines and tenant table render equal.  On the port:
``GET /metrics/history`` on a replica and on the router (history
continuous across replica churn), the ``/tenants/usage`` rollup equal
to the scheduler's counters, the prefix-hit-rate gauge absent until its
window fills, and the flight-recorder bundle's history.  The
reference's wall-clock overhead gate is not ported as a timing assert:
a scheduler serving beside a sampling store is checked to have been
sampled and metered."""

import json
import math
import threading
import time
import types
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from veles_tpu_torch.telemetry.registry import metrics, nearest_rank

from tests.test_torch_router import (  # noqa: F401 (fixture)
    make_replica, no_leaked_threads)
from tests.test_torch_tenant import knobs  # noqa: F401 (fixture)

pytestmark = pytest.mark.torch_port


def _tsdb_mods():
    import veles_tpu.telemetry.tsdb as jt
    import veles_tpu_torch.telemetry.tsdb as pt
    return pt, jt


@pytest.fixture
def fast_tiers(knobs):
    """Sub-second sampling in both trees."""
    knobs.tsdb.tiers = ((0.25, 30.0), (2.0, 240.0))
    yield


def _serve(handler_cls):
    server = ThreadingHTTPServer(("127.0.0.1", 0), handler_cls)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, server.server_address[1]


def _get(url, timeout=10):
    resp = urllib.request.urlopen(url, timeout=timeout)
    return resp.status, resp.read().decode()


def _fam(name, value, kind="gauge", labels=None, suffix=""):
    return [{"name": name, "type": kind, "help": "",
             "samples": [(suffix, labels or {}, value)]}]


def _both(scenario):
    """``scenario(tsdb module)`` over the port's store and the JAX
    package's; returns the port's answer after asserting they are
    equal."""
    pt, jt = _tsdb_mods()
    got, want = scenario(pt), scenario(jt)
    assert got == want
    return got


def _store(mod, **kw):
    kw.setdefault("name", "t-%s-%d" % (mod.__name__, id(kw)))
    kw.setdefault("max_series", 64)
    return mod.TimeSeriesStore(**kw)


# -- ring/tier math -----------------------------------------------------------

def test_counter_rate_exact_across_tier_boundaries():
    """Buckets hold deltas, so the rate is exact at every tier; a window
    past tier-0 retention selects tier 1."""
    def scenario(mod):
        st = _store(mod, tiers=((1.0, 60.0), (10.0, 600.0)))
        for i in range(31):
            st.sample(now=100.0 + i, families=_fam(
                "veles_t_total", 300.0 + 3.0 * i, kind="counter"))
        return ([st.range("veles_t_total", window=30.0, agg="rate",
                          now=130.0, tier=t) for t in (0, 1)],
                st.tier_for(200.0),
                st.range("veles_t_total", window=200.0, agg="rate",
                         now=130.0),
                st.range("veles_t_total", window=30.0, agg="sum",
                         now=130.0, tier=1),
                st.points("veles_t_total", window=40.0, now=130.0, tier=1),
                st.history("veles_t_total", window=40.0, now=130.0))

    rates, tier, long_rate, total, _, _ = _both(scenario)
    assert rates == [pytest.approx(3.0)] * 2
    assert tier == 1 and long_rate == pytest.approx(90.0 / 200.0)
    assert total == pytest.approx(90.0)


def test_counter_reset_clamps_to_zero_delta():
    def scenario(mod):
        st = _store(mod, tiers=((1.0, 60.0),))
        for t, v in ((100.0, 50.0), (101.0, 60.0), (102.0, 4.0),
                     (103.0, 9.0)):
            st.sample(now=t, families=_fam("veles_t_total", v,
                                           kind="counter"))
        return (st.points("veles_t_total", window=10.0, now=103.0,
                          tier=0),
                st.range("veles_t_total", window=10.0, agg="rate",
                         now=103.0))

    pts, rate = _both(scenario)
    assert [v for _, v in pts] == [0.0, 10.0, 0.0, 5.0]
    assert rate == pytest.approx(1.5)


def test_gauge_aggregates_and_quantiles_match_nearest_rank():
    vals = [float(v) for v in (7, 1, 9, 4, 2, 8, 3, 6, 5, 10)]

    def scenario(mod):
        st = _store(mod, tiers=((1.0, 600.0),))
        for i, v in enumerate(vals):
            st.sample(now=100.5 + i, families=_fam("veles_t_g", v))
        kw = dict(window=60.0, now=110.0)
        out = {agg: st.range("veles_t_g", agg=agg, **kw)
               for agg in ("avg", "min", "max", "last", "deriv", "p50",
                           "p95", "p99", 0.5, 0.95, 0.99, "sum")}
        out["none"] = st.range("veles_t_g", window=60.0, now=9999.0)
        with pytest.raises(ValueError):
            st.range("veles_t_g", agg="bogus", **kw)
        return out

    out = _both(scenario)
    assert out["avg"] == pytest.approx(sum(vals) / len(vals))
    assert (out["min"], out["max"], out["last"]) == (1.0, 10.0, 10.0)
    for q in (0.5, 0.95, 0.99):
        assert out["p%d" % int(q * 100)] == out[q] \
            == nearest_rank(sorted(vals), q)
    assert out["deriv"] == pytest.approx(3.0 / 9.0)
    assert out["none"] is None


def test_histogram_buckets_skipped_sum_count_kept():
    def scenario(mod):
        st = _store(mod, tiers=((1.0, 60.0),))
        fams = [{"name": "veles_t_ms", "type": "histogram", "help": "",
                 "samples": [("_bucket", {"le": "10"}, 2.0),
                             ("_bucket", {"le": "+Inf"}, 3.0),
                             ("_sum", {}, 45.5), ("_count", {}, 3.0)]}]
        st.sample(now=100.0, families=fams)
        st.sample(now=101.0, families=_fam("veles_t_nan", float("nan")))
        return sorted(st.series_names()), st.samples

    names, samples = _both(scenario)
    assert "veles_t_ms_sum" in names and "veles_t_ms_count" in names
    assert not any("_bucket" in n for n in names)
    assert "veles_t_nan" not in names and samples == 2


def test_bounds_eviction_never_exceeds_byte_budget():
    def scenario(mod):
        st = _store(mod, tiers=((1.0, 4.0),), max_series=64,
                    max_bytes=10 * mod.POINT_BYTES)
        used = []
        for i in range(12):
            fams = []
            for s in range(6):
                fams.extend(_fam("veles_t_b%d" % s, float(i)))
            st.sample(now=100.0 + i, families=fams)
            used.append(st.bytes_used() <= st.max_bytes)
        st2 = _store(mod, tiers=((1.0, 60.0),), max_series=3)
        fams = []
        for s in range(5):
            fams.extend(_fam("veles_t_c%d" % s, 1.0))
        st2.sample(now=100.0, families=fams)
        return (all(used), st.evicted_series, sorted(st.series_names()),
                len(st2.series_names()), st2.dropped_series,
                st2.stats()["dropped_series"])

    ok, evicted, _, kept, dropped, stat = _both(scenario)
    assert ok and evicted > 0
    assert (kept, dropped, stat) == (3, 2, 2)


def test_history_query_parsing_and_errors():
    t0 = time.time()

    def scenario(mod):
        st = _store(mod, tiers=((1.0, 60.0), (10.0, 600.0)))
        for dt, v in ((-2.0, 5.0), (-1.0, 7.0)):
            st.sample(now=t0 + dt, families=_fam(
                "veles_t_q", v, labels={"replica": "r0"}))
        cat = mod.history_query(st, "")
        return ({k: cat[k] for k in ("series_names", "samples")},
                mod.history_query(st, "series=veles_t_q&window=60&agg=max"
                                  "&label.replica=r0"),
                mod.history_query(st, "series=veles_t_q&label.replica=rX"
                                  )["value"],
                mod.history_query(st, "series=veles_t_q&window=nope"),
                "error" in mod.history_query(
                    st, "series=veles_t_q&agg=bogus"))

    cat, ans, miss, bad, bogus = _both(scenario)
    assert "veles_t_q" in cat["series_names"] and cat["samples"] == 2
    assert ans["value"] == 7.0 and ans["tier"] == 0
    assert ans["labels"] == {"replica": "r0"} and ans["points"]
    assert miss is None and bad == {"error": "bad window/tier"} and bogus


# -- endpoints ----------------------------------------------------------------

def test_replica_history_endpoint_answers_both_tiers(fast_tiers):
    """``GET /metrics/history`` on a port replica answers the catalog
    and each tier at its own step."""
    rep = make_replica()
    try:
        base = "http://%s:%s" % (rep.host, rep.port)
        deadline = time.monotonic() + 15
        cat = {}
        while time.monotonic() < deadline:
            cat = json.loads(_get(base + "/metrics/history")[1])
            if cat.get("samples", 0) >= 3 and cat["series_names"]:
                break
            time.sleep(0.1)
        assert cat["samples"] >= 3
        series = next(n for n in cat["series_names"]
                      if n.startswith("veles_"))
        for tier, step in ((0, 0.25), (1, 2.0)):
            st, body = _get(base + "/metrics/history?series=%s&window=20"
                            "&tier=%d" % (series, tier))
            ans = json.loads(body)
            assert st == 200 and ans["tier"] == tier
            assert ans["tier_step_s"] == step
    finally:
        rep.stop()


def _counting_replica(start, step):
    state = {"n": start}

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
                    {"status": "ok", "role": "both",
                     "draining": False}).encode())
            elif path == "/serving/metrics":
                self._reply(200, b"{}")
            elif path == "/metrics":
                state["n"] += step
                self._reply(200, (
                    "# TYPE veles_serving_tokens_generated_total counter\n"
                    "veles_serving_tokens_generated_total %d\n"
                    % state["n"]).encode(), "text/plain")
            else:
                self._reply(404, b"{}")

    return Fake


def test_router_history_two_tiers_and_continuity_across_churn(fast_tiers):
    """The port router's store samples the federated merge: fleet
    history answers at both tiers and stays continuous, with no
    negative spike, across a replica replaced by a fresh one."""
    from veles_tpu_torch.serving import Router
    q = ("/metrics/history?series=veles_serving_tokens_generated_total"
         "&window=25&agg=sum&tier=0")
    s1, p1 = _serve(_counting_replica(1000, 7))
    s2, p2 = _serve(_counting_replica(0, 3))
    s3 = None
    router = Router(health_interval=0.1).start()
    try:
        router.add_replica("127.0.0.1", p1, replica_id="h1")
        router.add_replica("127.0.0.1", p2, replica_id="h2")
        deadline = time.monotonic() + 15
        ans = {}
        while time.monotonic() < deadline:
            ans = json.loads(_get(router.url + q)[1])
            if len(ans.get("points") or ()) >= 4:
                break
            time.sleep(0.1)
        assert len(ans["points"]) >= 4
        for tier, step in ((0, 0.25), (1, 2.0)):
            st, body = _get(router.url + "/metrics/history?series=veles_"
                            "serving_tokens_generated_total&window=25"
                            "&agg=rate&tier=%d" % tier)
            tans = json.loads(body)
            assert st == 200 and tans["tier"] == tier
            assert tans["tier_step_s"] == step
            assert tans["value"] is not None and tans["value"] >= 0
        t_churn = time.time()
        s1.shutdown()
        s1.server_close()
        router.remove_replica("h1")
        s3, p3 = _serve(_counting_replica(0, 5))
        router.add_replica("127.0.0.1", p3, replica_id="h3")
        deadline = time.monotonic() + 15
        while time.monotonic() < deadline:
            ans = json.loads(_get(router.url + q)[1])
            if any(t > t_churn + 1.0 for t, _ in ans["points"]):
                break
            time.sleep(0.1)
        pts = ans["points"]
        assert any(t < t_churn for t, _ in pts)
        assert any(t > t_churn + 1.0 for t, _ in pts)
        assert min(v for _, v in pts) >= 0.0
    finally:
        router.stop()
        for s in (s2, s3):
            if s is not None:
                s.shutdown()
                s.server_close()


# -- per-tenant metering ------------------------------------------------------

USAGE_FAMILIES = {
    "veles_tenant_usage_prompt_tokens_total": "prompt_tokens",
    "veles_tenant_usage_generated_tokens_total": "generated_tokens",
    "veles_tenant_usage_kv_block_seconds_total": "kv_block_seconds",
    "veles_tenant_usage_compute_seconds_total": "compute_seconds",
}


def _usage_counter_values(family):
    fam = metrics.get(family)
    if fam is None:
        return {}
    return {key[0]: child.value for key, child in fam.children().items()}


def _registry_replica():
    """A replica stub serving this process's registry: the router's
    federated merge sums the very counters the scheduler moved."""

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
                    {"status": "ok", "role": "both",
                     "draining": False}).encode())
            elif path == "/serving/metrics":
                self._reply(200, b"{}")
            elif path == "/metrics":
                self._reply(200, metrics.render_prometheus().encode(),
                            "text/plain")
            else:
                self._reply(404, b"{}")

    return Fake


def _tiny_chain():
    from veles_tpu_torch.convert import init_params
    spec = [{"type": "embedding", "vocab": 12, "dim": 16},
            {"type": "transformer_block", "heads": 2, "causal": True},
            {"type": "token_logits", "vocab": 12}]
    return init_params(spec, 3, window=64, device="cpu", dtype="float32")


JOBS = [([3, 1, 4, 1, 5], 8, i, "usage-a") for i in range(3)] \
    + [([2, 7, 1], 6, 9, "usage-b")]


def test_tenant_usage_rollup_equals_scheduler_counters():
    """``/tenants/usage`` on the port's router sums the fleet's counters
    to the scheduler's own per-tenant totals: tokens exactly, seconds to
    rounding (on deltas over a baseline, as the shared registry holds
    earlier tests' metering)."""
    from veles_tpu_torch.serving import InferenceScheduler, Router
    baseline = {fam: _usage_counter_values(fam) for fam in USAGE_FAMILIES}
    sch = InferenceScheduler(_tiny_chain(), max_slots=2, window=64,
                             kv="paged", block_size=4, warm_buckets=False,
                             replica_id="meter-r0", device="cpu").start()
    try:
        futs = [sch.submit(p, n, seed=s, tenant=t) for p, n, s, t in JOBS]
        for f in futs:
            f.result(60)
        snap = sch.metrics()["tenants"]
    finally:
        sch.close()
    assert set(snap) == {"usage-a", "usage-b"}
    assert snap["usage-a"]["prompt_tokens"] == 15
    assert snap["usage-a"]["generated_tokens"] == 24
    assert snap["usage-b"]["generated_tokens"] == 6
    assert all(rec["kv_block_seconds"] > 0 and rec["compute_seconds"] > 0
               for rec in snap.values())
    server, port = _serve(_registry_replica())
    router = Router(health_interval=0.1).start()
    try:
        router.add_replica("127.0.0.1", port, replica_id="meter-rep")
        deadline = time.monotonic() + 20
        usage = {}
        while time.monotonic() < deadline:
            usage = json.loads(_get(router.url + "/tenants/usage")[1])[
                "tenants"]
            if all(label in usage for label in snap):
                break
            time.sleep(0.1)
        for label, rec in snap.items():
            for fam, field in USAGE_FAMILIES.items():
                delta = usage[label][field] - baseline[fam].get(label, 0.0)
                if field.endswith("_tokens"):
                    assert delta == rec[field], (label, field)
                else:
                    assert delta == pytest.approx(rec[field], abs=1e-4)
    finally:
        router.stop()
        server.shutdown()
        server.server_close()


def test_scheduler_tenant_tokens_match_reference():
    """The same requests with the same tenants through the JAX
    scheduler and the port's: equal per-tenant prompt and generated
    token counts, KV-block-seconds and compute-seconds above 0 in both
    (their values are wall time); with metering off nothing is
    attributed."""
    from veles_tpu import prng as jax_prng
    from veles_tpu.config import root as jroot
    from veles_tpu.serving import InferenceScheduler as JaxScheduler
    from veles_tpu_torch.config import root
    from veles_tpu_torch.serving import InferenceScheduler
    from tests.test_torch_serving import _spec
    from tests.test_torch_transformer import jax_chain, port_chain
    saved = jroot.common.precision.get("compute_dtype", "bfloat16")
    jroot.common.precision.compute_dtype = "float32"
    try:
        spec = [{"type": "embedding", "vocab": 12, "dim": 16},
                {"type": "transformer_block", "heads": 2, "causal": True},
                {"type": "token_logits", "vocab": 12}]
        # the JAX package's shared "default" generator stays as it was
        with jax_prng.get().preserve_state():
            fw = jax_chain(spec, window=64)
        kw = dict(max_slots=2, window=64, kv="paged", block_size=4,
                  warm_buckets=False, spec=False, prefix_cache=False)
        out = []
        for make in (lambda: JaxScheduler(fw, replica_id="meter-j", **kw),
                     lambda: InferenceScheduler(
                         port_chain(_spec(fw), fw), replica_id="meter-p",
                         device="cpu", **kw)):
            sch = make().start()
            try:
                futs = [sch.submit(p, n, seed=s, tenant=t)
                        for p, n, s, t in JOBS]
                toks = [f.result(120) for f in futs]
                out.append((toks, sch.metrics()["tenants"]))
            finally:
                sch.close()
        vars(root.common.tsdb)["metering"] = False
        try:
            off = InferenceScheduler(port_chain(_spec(fw), fw),
                                     device="cpu", **kw).start()
            try:
                off.submit([3, 1], 4, tenant="quiet").result(60)
                assert off.metrics()["tenants"] == {}
            finally:
                off.close()
        finally:
            vars(root.common.tsdb)["metering"] = True
    finally:
        jroot.common.precision.compute_dtype = saved
    (got_toks, got), (want_toks, want) = out[1], out[0]
    assert got_toks == want_toks
    assert set(got) == set(want) == {"usage-a", "usage-b"}
    for label in got:
        for field in ("prompt_tokens", "generated_tokens"):
            assert got[label][field] == want[label][field]
        for field in ("kv_block_seconds", "compute_seconds"):
            assert got[label][field] > 0 and want[label][field] > 0


# -- trend rules --------------------------------------------------------------

def _goodput_episode(tsdb_mod, alerts_mod):
    rule = next(r for r in alerts_mod.default_rules()
                if r.name == "goodput_regression")
    st = _store(tsdb_mod, name="t-goodput-%s" % tsdb_mod.__name__)
    now = 5000.0

    def seed(values):
        for dt, v in values:
            st.sample(now=now + dt, families=_fam(
                "veles_serving_goodput_tokens_per_sec", v))

    seed([(-3000.0, 100.0), (-2500.0, 100.0), (-2000.0, 100.0),
          (-1500.0, 100.0), (-1000.0, 100.0), (-40.0, 10.0),
          (-20.0, 10.0)])
    # the trend rules read the store against the wall clock: pin the
    # store module's clock (its own view of ``time``, nothing else's)
    real = tsdb_mod.time
    tsdb_mod.time = types.SimpleNamespace(
        **{n: getattr(time, n) for n in dir(time) if not n.startswith("_")})
    tsdb_mod.time.time = lambda: now
    try:
        engine = alerts_mod.AlertEngine(name="t-goodput-eng",
                                        rules=[rule], interval=999,
                                        tsdb=st)
        out = [engine.tick(now=1000.0),
               engine.tick(now=1000.0 + rule.for_seconds + 1.0)]
        firing = [r["rule"] for r in engine.firing()]
        seed([(-12.0 + i, 100.0) for i in range(12)])
        out.append(engine.tick(now=1010.0))
    finally:
        tsdb_mod.time = real
    return [[(w, r.name, dict(i.labels), round(i.value, 9))
             for w, r, i in fired] for fired in out], firing


def test_goodput_regression_rule_fires_and_resolves():
    """A goodput collapse against the hour's baseline fires
    ``goodput_regression`` after its hold-down and a recovery resolves
    it — the same transitions and values in both packages."""
    import veles_tpu.telemetry.alerts as ja
    import veles_tpu_torch.telemetry.alerts as pa
    pt, jt = _tsdb_mods()
    got = _goodput_episode(pt, pa)
    assert got == _goodput_episode(jt, ja)
    out, firing = got
    assert out[0] == [] and [t[0] for t in out[1]] == ["fire"]
    assert firing == ["goodput_regression"]
    assert [t[0] for t in out[2]] == ["resolve"]


def test_trend_rules_quiet_without_a_store():
    import veles_tpu.telemetry.alerts as ja
    import veles_tpu.telemetry.registry as jr
    import veles_tpu_torch.telemetry.alerts as pa
    for alerts_mod, reg in ((pa, metrics), (ja, jr.metrics)):
        rule = alerts_mod.AlertRule(name="t",
                                    expr="deriv(veles_t_g, 60) > 0")
        assert rule.evaluate(reg, {}, 1.0, tsdb=None) == []


# -- prefix-hit-rate gauge ----------------------------------------------------

def test_prefix_hit_rate_absent_until_window_populated():
    """Under ``_PREFIX_MIN_LOOKUPS`` recent lookups the gauge exports no
    sample for the replica; a fresh instance retracts a stale one."""
    from veles_tpu_torch.serving.metrics import ServingMetrics
    fam_name = "veles_serving_prefix_hit_rate_recent"
    m = ServingMetrics(replica="pfx-regress")
    floor = ServingMetrics._PREFIX_MIN_LOOKUPS
    for _ in range(floor - 1):
        m.record_prefix_lookup(1, 4)
    fam = metrics.get(fam_name)
    assert ("pfx-regress",) not in fam.children()
    m.record_prefix_lookup(0, 4)
    assert fam.children()[("pfx-regress",)].value \
        == pytest.approx((floor - 1) / floor)
    m2 = ServingMetrics(replica="pfx-regress")
    m2.record_prefix_lookup(1, 4)
    assert ("pfx-regress",) not in fam.children()


# -- flight recorder + dashboard ---------------------------------------------

def test_flight_recorder_bundle_embeds_history():
    from veles_tpu_torch.telemetry.flight_recorder import FlightRecorder
    from veles_tpu_torch.telemetry.tsdb import (
        TimeSeriesStore, bundle_history)
    st = TimeSeriesStore(name="t-bundle", max_series=64)
    now = time.time()
    for i in range(5):
        st.sample(now=now - 10.0 + 2.0 * i, families=_fam(
            "veles_serving_goodput_tokens_per_sec", 40.0 + i))
    hist = FlightRecorder().bundle("test")["history"]["t-bundle"]
    pts = hist["veles_serving_goodput_tokens_per_sec"]
    assert len(pts) == 5 and pts[-1][1] == 44.0
    assert bundle_history()["t-bundle"] == hist


def test_dashboard_sparklines_and_tenant_usage_render():
    """Sparklines and the tenant usage table escape their input and
    render as the reference's."""
    import veles_tpu.telemetry.dashboard as jd
    import veles_tpu_torch.telemetry.dashboard as pd
    hist = {"veles_x<script>": [(1.0, 1.0), (2.0, 9.0), (3.0, 5.0)],
            "veles_flat": [(1.0, 2.0), (2.0, 2.0)],
            "veles_nan": [(1.0, math.nan), (2.0, 1.0)]}
    usage = {"window_s": 60.0, "tenants": {
        "acme<b>": {"prompt_tokens": 10, "generated_tokens": 32,
                    "generated_tokens_per_sec": 1.5,
                    "kv_block_seconds": 2.25, "compute_seconds": 0.125}}}
    pages = [(m.render_history_sparklines(hist),
              m.render_history_sparklines({}),
              m.render_tenant_usage(usage),
              m.render_tenant_usage({"tenants": {}})) for m in (pd, jd)]
    assert pages[0] == pages[1]
    spark, empty, table, none = pages[0]
    assert "<script>" not in spark and "veles_x&lt;script&gt;" in spark
    assert "▁" in spark and "█" in spark
    assert empty == "<p class='dim'>no history yet</p>"
    assert "acme&lt;b&gt;" in table and "<b>" not in table
    assert "32" in table and "1.5" in table
    assert none == "<p class='dim'>no tenant usage recorded</p>"


# -- a store beside a serving scheduler ----------------------------------------

def test_store_samples_beside_a_serving_scheduler():
    """A store ticking at 20 Hz beside a scheduler serving metered
    requests: it takes samples and holds the scheduler's series, the
    tenant counters move, and ``stop()`` joins its thread (the
    reference's <5 % overhead is a wall-clock ratio the card smoke
    prints)."""
    from veles_tpu_torch.serving import InferenceScheduler
    from veles_tpu_torch.telemetry.tsdb import TimeSeriesStore
    sch = InferenceScheduler(_tiny_chain(), max_slots=2, window=64,
                             kv="paged", block_size=4, warm_buckets=False,
                             replica_id="tsdb-soak", device="cpu").start()
    store = TimeSeriesStore(name="beside", interval=0.05,
                            tiers=((0.05, 30.0),)).start()
    try:
        futs = [sch.submit([3, 1, 4], 24, seed=i, tenant="soak")
                for i in range(4)]
        for f in futs:
            f.result(60)
        deadline = time.monotonic() + 10
        while store.samples < 3 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert store.samples >= 3
        assert "veles_serving_tokens_generated_total" in \
            store.series_names()
        assert sch.metrics()["tenants"]["soak"]["generated_tokens"] == 96
        thread = store._thread
    finally:
        store.stop()
        sch.close()
    assert not thread.is_alive()
