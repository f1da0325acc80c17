"""The fleet control plane of the PyTorch port
(``veles_tpu_torch/serving/controller.py``) held against the JAX
package's (oracle ``tests/test_controller.py`` and the controller case
of ``tests/test_tsdb.py``): both controllers, fed the same observations
through stub routers and fleets on an injected clock, make the same
decisions — scale up on queue depth and on the SLO burn pair within
bounds and cooldowns, scale down only after quiet ticks through drain
then retire, re-role inside the deadband, KV tuning that tightens and
relaxes but never starts from idle, history windows read from a store.
On the port: a real fleet grown and drained back, a coverage rebalance
that leaves a covered fleet alone while the controller moves the role
ratio, and a dead replica leaving the federation and the registry."""

import time
import urllib.request

import pytest

from tests.test_torch_router import (  # noqa: F401 (fixture)
    make_replica, no_leaked_threads, post, wait_healthy)
from tests.test_torch_tenant import knobs  # noqa: F401 (fixture)

pytestmark = pytest.mark.torch_port


def _controllers():
    from veles_tpu.serving.controller import FleetController as JaxCtl
    from veles_tpu_torch.serving.controller import FleetController
    return FleetController, JaxCtl


def _view(rid, **kw):
    base = {"id": rid, "host": "127.0.0.1", "port": 1,
            "healthy": True, "draining": False, "role": None,
            "queue_depth": 0, "outstanding": 0, "active_slots": 0,
            "max_slots": 2, "kv_blocks_used": 0, "kv_blocks_free": 100}
    base.update(kw)
    return base


class _StubRouter:
    def __init__(self, views, alerts=None):
        self.views = views
        self.alerts = alerts
        self.drained = []

    def replica_state(self):
        return {"replicas": [dict(v) for v in self.views]}

    def drain_replica(self, rid):
        self.drained.append(rid)


class _StubFleet:
    def __init__(self, roles=None):
        self.roles = roles
        self.grown, self.retired, self.reroled = [], [], []

    def grow(self, role=None):
        self.grown.append(role)
        return 90 + len(self.grown)

    def index_of(self, rid):
        return int(rid[1:])

    def retire(self, index):
        self.retired.append(index)
        return "r%d" % index

    def restart_as(self, index, role):
        self.reroled.append((index, role))


class _StubAlerts:
    def __init__(self, rows):
        self.rows = rows

    def firing(self):
        return self.rows


def _strip(rec):
    """A decision without its wall-clock stamp."""
    if rec is None:
        return None
    return {k: v for k, v in rec.items() if k != "t"}


def _both(scenario):
    """``scenario(FleetController class)`` for the port and the JAX
    package; returns the port's outcome after asserting equality."""
    port, jax = _controllers()
    got, want = scenario(port), scenario(jax)
    assert got == want
    return got


def test_controller_refuses_to_arm_unless_enabled(knobs):
    for cls in _controllers():
        assert not cls.enabled()
        ctl = cls(_StubRouter([_view("r0")]), _StubFleet(), interval=999)
        assert ctl.start()._thread is None
    knobs.controller.enabled = True
    for cls in _controllers():
        assert cls.enabled()


def test_scale_up_on_queue_depth_with_bounds_and_cooldown(knobs):
    knobs.controller.update({"queue_high": 2.0, "max_replicas": 2,
                             "scale_up_cooldown": 5.0})

    def scenario(cls):
        router = _StubRouter([_view("r0", queue_depth=6)])
        fleet = _StubFleet()
        ctl = cls(router, fleet, interval=999)
        out = [ctl.tick(now=100.0), ctl.tick(now=102.0)]
        router.views.append(_view("r1", queue_depth=6))
        out.append(ctl.tick(now=200.0))
        assert ctl.audit()[-1] is out[0]
        return [_strip(r) for r in out], fleet.grown

    out, grown = _both(scenario)
    assert out[0]["action"] == "scale_up"
    assert out[0]["reason"] == "queue_depth"
    assert out[1] is None and out[2] is None and grown == [None]


def test_scale_up_on_slo_burn_pair(knobs):
    knobs.controller.update({"queue_high": 100.0, "max_replicas": 4,
                             "scale_up_cooldown": 0.0})

    def scenario(cls):
        router = _StubRouter([_view("r0")], _StubAlerts(
            [{"rule": "slo_burn_page"}, {"rule": "slo_burn_ticket"},
             {"rule": "breaker_open"}]))
        fleet = _StubFleet()
        return _strip(cls(router, fleet, interval=999).tick(now=100.0)), \
            fleet.grown

    rec, grown = _both(scenario)
    assert rec["action"] == "scale_up" and rec["reason"] == "slo_burn"
    assert rec["burn_rules"] == ["slo_burn_page", "slo_burn_ticket"]
    assert grown == [None]


def test_scale_down_needs_quiet_ticks_then_drains(knobs):
    knobs.controller.update({"queue_high": 4.0, "min_replicas": 1,
                             "quiet_ticks": 3, "scale_down_cooldown": 0.0,
                             "occupancy_low": 0.5, "max_replicas": 4})

    def scenario(cls):
        router = _StubRouter([_view("r0", outstanding=2, active_slots=1),
                              _view("r1", outstanding=0)])
        fleet = _StubFleet()
        ctl = cls(router, fleet, interval=999)
        out = [_strip(ctl.tick(now=100.0 + i)) for i in range(3)]
        router.alerts = _StubAlerts([{"rule": "slo_burn_page"}])
        knobs.controller.max_replicas = 2
        ctl2 = cls(router, _StubFleet(), interval=999)
        quiet = [ctl2.tick(now=200.0 + i) for i in range(5)]
        knobs.controller.max_replicas = 4
        return out, router.drained, fleet.retired, quiet, ctl2._quiet

    out, drained, retired, quiet, q = _both(scenario)
    assert out[0] is None and out[1] is None
    assert out[2]["action"] == "scale_down" and out[2]["replica"] == "r1"
    assert drained == ["r1"] and retired == [1]
    assert quiet == [None] * 5 and q == 0


def test_scale_down_respects_min_replicas(knobs):
    knobs.controller.update({"quiet_ticks": 1, "min_replicas": 1,
                             "scale_down_cooldown": 0.0,
                             "occupancy_low": 0.5})

    def scenario(cls):
        fleet = _StubFleet()
        ctl = cls(_StubRouter([_view("r0")]), fleet, interval=999)
        return [ctl.tick(now=100.0 + i) for i in range(4)], fleet.retired

    assert _both(scenario) == ([None] * 4, [])


def test_rerole_moves_ratio_within_deadband_guardrails(knobs):
    knobs.controller.update({"queue_high": 4.0, "role_deadband": 0.25,
                             "scale_up_cooldown": 0.0,
                             "occupancy_low": 0.0})
    roles = ("prefill", "prefill", "decode", "decode")

    def scenario(cls):
        views = [_view("r0", role="prefill"),
                 _view("r1", role="prefill", outstanding=1),
                 _view("r2", role="decode", active_slots=2),
                 _view("r3", role="decode", active_slots=2)]
        fleet = _StubFleet(roles=roles)
        rec = _strip(cls(_StubRouter(views), fleet, interval=999)
                     .tick(now=100.0))
        views[2]["active_slots"] = views[3]["active_slots"] = 0
        fleet2 = _StubFleet(roles=roles)
        inside = cls(_StubRouter(views), fleet2, interval=999) \
            .tick(now=200.0)
        solo = [_view("r0", role="prefill"),
                _view("r1", role="decode", active_slots=2)]
        fleet3 = _StubFleet(roles=("prefill", "decode"))
        lone = cls(_StubRouter(solo), fleet3, interval=999).tick(now=300.0)
        return rec, fleet.reroled, inside, fleet2.reroled, lone, \
            fleet3.reroled

    rec, reroled, inside, r2, lone, r3 = _both(scenario)
    assert rec["action"] == "rerole" and reroled == [(0, "decode")]
    assert inside is None and r2 == []
    assert lone is None and r3 == []


def test_kv_tune_tightens_then_relaxes_never_from_idle(knobs):
    knobs.controller.update({
        "queue_high": 100.0, "occupancy_low": 0.0, "quiet_ticks": 99,
        "scale_up_cooldown": 0.0, "kv_pressure_high": 0.8,
        "kv_pressure_low": 0.3, "shed_step": 0.5, "shed_min": 1.0,
        "shed_max": 8.0})

    def scenario(cls):
        views = [_view("r0", kv_blocks_used=90, kv_blocks_free=10)]
        ctl = cls(_StubRouter(views), _StubFleet(), interval=999)
        tuned = []
        ctl._tune_replica = lambda view, factor: tuned.append(
            (view["id"], factor)) or True
        ctl.tick(now=100.0)
        views[0].update(kv_blocks_used=10, kv_blocks_free=90)
        ctl.tick(now=200.0)
        fresh = cls(_StubRouter(views), _StubFleet(), interval=999)
        fresh._tune_replica = lambda view, factor: tuned.append(
            ("fresh", factor)) or True
        fresh.tick(now=300.0)
        return tuned, [_strip(d) for d in ctl.audit()]

    tuned, audit = _both(scenario)
    assert tuned == [("r0", 3.5), ("r0", 4.0)]
    actions = [d["action"] for d in audit]
    assert "recommend_kv_blocks" in actions and "tune_shed" in actions
    assert [d for d in audit if d["action"] == "recommend_kv_blocks"][0][
        "kv_blocks"] == 125


def test_controller_decisions_consume_history_windows(knobs):
    """KV tuning keys off the store's window average (the instantaneous
    pressure is below threshold), the pool recommendation is sized from
    the window p95, and the audit records carry the window — for both
    controllers over equally fed stores."""
    import veles_tpu.telemetry.tsdb as jt
    import veles_tpu_torch.telemetry.tsdb as pt
    knobs.controller.update({
        "queue_high": 100.0, "occupancy_low": 0.0, "quiet_ticks": 99,
        "scale_up_cooldown": 0.0, "kv_pressure_high": 0.8,
        "kv_pressure_low": 0.3, "shed_step": 0.5, "shed_min": 1.0,
        "shed_max": 8.0, "history_window": 60.0})
    now = time.time()

    def scenario(cls):
        mod = pt if cls.__module__.startswith("veles_tpu_torch") else jt
        st = mod.TimeSeriesStore(name="t-ctl-%s" % mod.__name__,
                                 tiers=((1.0, 600.0),), max_series=64)
        for i, v in enumerate((0.84, 0.88, 0.92, 0.96)):
            st.sample(now=now - 8.0 + 2.0 * i, families=[{
                "name": "veles_serving_kv_pressure", "type": "gauge",
                "help": "", "samples": [("", {"replica": "r0"}, v)]}])
        views = [_view("r0", kv_blocks_used=50, kv_blocks_free=50)]
        ctl = cls(_StubRouter(views), _StubFleet(), interval=999, tsdb=st)
        tuned = []
        ctl._tune_replica = lambda view, factor: tuned.append(
            (view["id"], factor)) or True
        ctl.tick(now=100.0)
        return tuned, [_strip(d) for d in ctl.audit()]

    tuned, audit = _both(scenario)
    assert tuned == [("r0", 3.5)]
    rec = [d for d in audit if d["action"] == "tune_shed"][0]
    assert rec["window"]["kv_pressure_avg"] == pytest.approx(0.9)
    sized = [d for d in audit if d["action"] == "recommend_kv_blocks"][0]
    assert sized["kv_blocks"] == 120
    assert sized["window"]["kv_pressure_p95"] == pytest.approx(0.96)


# -- the real actuation path ---------------------------------------------------

def _router():
    from veles_tpu_torch.serving import Router
    return Router(health_interval=0.1, health_timeout=5.0,
                  request_timeout=60.0, retries=3, retry_delay=0.02,
                  retry_cap=0.2).start()


SMALL = dict(serving_warm_buckets=False, serving_block_size=4,
             serving_prefill_chunk=4)


def test_controller_scales_real_fleet_up_and_down(knobs):
    """One tick grows a real replica through ``Fleet.grow``; calm ticks
    drain and retire it through ``drain_replica`` → the /healthz poll →
    ``Fleet.retire``; the monitor never respawns the retired index."""
    from veles_tpu_torch.serving import Fleet
    from veles_tpu_torch.serving.controller import FleetController
    knobs.controller.update({
        "queue_high": 0.0, "max_replicas": 2, "min_replicas": 1,
        "scale_up_cooldown": 0.0, "scale_down_cooldown": 0.0,
        "quiet_ticks": 1, "occupancy_low": 1.0})
    router = _router()
    fleet = Fleet(lambda index: make_replica(**SMALL), 1, router=router,
                  monitor_interval=0.1).start()
    ctl = FleetController(router, fleet, interval=999)
    try:
        wait_healthy(router, 1)
        rec = ctl.tick()
        assert rec["action"] == "scale_up" and rec["index"] == 1
        assert fleet.index_of(fleet.handles()[1].replica_id) == 1
        wait_healthy(router, 2)
        _, out = post(router.url, {"prompt": [3, 1, 4, 1], "steps": 4,
                                   "seed": 0})
        assert len(out["tokens"]) == 8
        knobs.controller.queue_high = 100.0
        down = None
        deadline = time.monotonic() + 30
        while down is None and time.monotonic() < deadline:
            down = ctl.tick()
            time.sleep(0.05)
        assert down and down["action"] == "scale_down"
        assert sorted(fleet.handles()) == [down["index"] ^ 1]
        time.sleep(0.5)
        assert sorted(fleet.handles()) == [down["index"] ^ 1]
        _, out2 = post(router.url, {"prompt": [3, 1, 4, 1], "steps": 4,
                                    "seed": 0})
        assert out2["tokens"] == out["tokens"]
        assert [d["action"] for d in ctl.audit()] \
            == ["scale_up", "scale_down"]
        from veles_tpu_torch.telemetry import metrics
        assert metrics.get("veles_controller_scale_transitions_total") \
            is not None
        for handle in fleet.handles().values():
            handle.api.scheduler_.check_kv()
    finally:
        fleet.stop()
        router.stop()


def test_rebalance_restores_coverage_only_controller_moves_ratio(knobs):
    """``Fleet.rebalance()`` leaves a fully covered fleet alone however
    lopsided its ratio; the controller's re-role (``Fleet.restart_as``)
    moves the ratio, and the reshaped fleet serves the disaggregated
    path with the same greedy reply."""
    from veles_tpu_torch.serving import Fleet
    from veles_tpu_torch.serving.controller import FleetController
    router = _router()
    fleet = Fleet(lambda index, role: make_replica(serving_role=role,
                                                   **SMALL),
                  3, router=router, monitor_interval=0.2,
                  roles=("prefill", "prefill", "decode")).start()
    try:
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            roles = sorted(r["role"] or "" for r in
                           router.replica_state()["replicas"]
                           if r["healthy"])
            if roles == ["decode", "prefill", "prefill"]:
                break
            time.sleep(0.05)
        assert roles == ["decode", "prefill", "prefill"]
        body = {"prompt": [3, 1, 4, 1, 5, 9, 2, 6, 5, 3], "steps": 6,
                "seed": 0}
        _, want = post(router.url, body)
        before = {i: fleet.role_of(i) for i in fleet.handles()}
        fleet.rebalance()
        assert {i: fleet.role_of(i) for i in fleet.handles()} == before
        ctl = FleetController(router, fleet, interval=999)
        knobs.controller.update({"role_deadband": 0.25,
                                 "scale_up_cooldown": 0.0,
                                 "queue_high": 100.0,
                                 "occupancy_low": 0.0})
        live = wait_healthy(router, 3)
        for r in live:
            if r["role"] == "decode":
                r["active_slots"], r["max_slots"] = 2, 2
        obs = {"live": live, "queue_mean": 0.0, "occupancy": 0.5,
               "kv_pressure": 0.0, "kv_blocks_total": 0}
        ctl._observe = lambda: obs
        rec = ctl.tick()
        assert rec["action"] == "rerole" and rec["role"] == "decode"
        assert sorted(fleet.role_of(i) for i in fleet.handles()) \
            == ["decode", "decode", "prefill"]
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            roles = sorted(r["role"] or "" for r in
                           router.replica_state()["replicas"]
                           if r["healthy"])
            if roles == ["decode", "decode", "prefill"]:
                break
            time.sleep(0.05)
        assert roles == ["decode", "decode", "prefill"]
        _, got = post(router.url, body)
        assert got["tokens"] == want["tokens"]
        for handle in fleet.handles().values():
            if handle is not None and handle.alive():
                handle.api.scheduler_.check_kv()
    finally:
        fleet.stop()
        router.stop()


def test_dead_replica_leaves_federation_and_registry():
    """A health-failed replica stops contributing its last scrape to
    ``GET /metrics/fleet`` (only ``veles_fleet_up 0`` names it), and
    deregistration clears its ``veles_serving_*{replica=...}``
    children."""
    from veles_tpu_torch.serving import Router
    from veles_tpu_torch.telemetry import metrics
    rep = make_replica(**SMALL)
    router = Router(health_interval=0.1, health_timeout=0.5,
                    request_timeout=60.0, retries=3, retry_delay=0.02,
                    retry_cap=0.2).start()

    def fleet_text():
        return urllib.request.urlopen(router.url + "/metrics/fleet",
                                      timeout=30).read().decode()

    def stale(text):
        return [ln for ln in text.splitlines()
                if 'replica="fed-r0"' in ln
                and not ln.startswith("veles_fleet_up")]

    try:
        rid = router.add_replica(rep.host, rep.port, replica_id="fed-r0")
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            post(router.url, {"prompt": [3, 1, 4, 1], "steps": 2,
                              "seed": 0})
            text = fleet_text()
            if 'replica="fed-r0"' in text:
                break
            time.sleep(0.1)
        assert 'replica="fed-r0"' in text
        rep.stop()
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            text = fleet_text()
            if not stale(text):
                break
            time.sleep(0.1)
        assert not stale(text)
        assert 'veles_fleet_up{replica="fed-r0"} 0' in text
        assert "scrape_errors" in text
        gauge = metrics.gauge("veles_serving_goodput_ratio", "x",
                              labelnames=("replica",))
        gauge.labels(replica=rid).set(0.5)
        router.remove_replica(rid)
        assert (rid,) not in gauge.children()
    finally:
        router.stop()
        rep.stop()
