"""Per-tenant admission of the PyTorch port (``veles_tpu_torch/tenant``)
held against the JAX package's (oracle ``tests/test_controller.py:
420-472``): the same header sequences and the same injected clock
through both packages' ``resolve_tenant`` and ``TenantAdmission`` give
identical labels and admit/429 decisions; the port's router answers an
over-budget tenant a structured 429 and tags every forwarded request;
the scheduler's metrics and the router bound labels through one
process-wide bounder."""

import asyncio
import json
import threading
import time
import urllib.error

import pytest

from tests.test_torch_router import (  # noqa: F401 (fixture)
    get_json, make_replica, no_leaked_threads, post, wait_healthy)

pytestmark = pytest.mark.torch_port


class _Both:
    """A config node of both packages' trees: reads come from the
    port's, writes and ``update`` go to both."""

    def __init__(self, nodes):
        object.__setattr__(self, "_nodes", nodes)

    def __getattr__(self, name):
        return _Both([getattr(n, name) for n in self._nodes])

    def __setattr__(self, name, value):
        for n in self._nodes:
            setattr(n, name, value)

    def update(self, value):
        for n in self._nodes:
            n.update(value)

    def get(self, name, default=None):
        return self._nodes[0].get(name, default)


@pytest.fixture
def knobs():
    """Scratch ``root.common.{controller, tenant, alerts, tsdb, fleet}``
    of both packages, restored afterwards."""
    from veles_tpu.config import root as jroot
    from veles_tpu_torch.config import root
    sections = ("controller", "tenant", "alerts", "tsdb", "fleet")
    saved = [(tree, s, getattr(tree.common, s).__content__())
             for tree in (root, jroot) for s in sections]
    yield _Both([root.common, jroot.common])
    for tree, s, content in saved:
        node = getattr(tree.common, s)
        for k in list(node.__content__()):
            if k not in content:
                delattr(node, k)
        node.update(content)


HEADERS = [
    ({"authorization": "Bearer sk-secret-1"}, False),
    ({"authorization": "Bearer sk-secret-1"}, True),
    ({"authorization": "Bearer other"}, False),
    ({"authorization": "bearer   spaced  "}, False),
    ({"authorization": "Bearer "}, False),
    ({"authorization": "Basic abc"}, False),
    ({"x-veles-tenant": "acme!corp//7"}, True),
    ({"x-veles-tenant": "acme!corp//7"}, False),
    ({"x-veles-tenant": "x" * 50}, True),
    ({"x-veles-tenant": "ok.name-1_2",
      "authorization": "Bearer sk-secret-1"}, True),
    ({}, False),
    ({}, True),
]


def test_resolve_tenant_matches_reference():
    """Bearer hashes (stable, opaque), the loopback-only explicit
    header (sanitized, clipped) and ``anon``: the same ids as the JAX
    package's for every header set."""
    from veles_tpu.tenant import resolve_tenant as jax_resolve
    from veles_tpu_torch.tenant import resolve_tenant
    got = [resolve_tenant(dict(h), loopback=lb) for h, lb in HEADERS]
    want = [jax_resolve(dict(h), loopback=lb) for h, lb in HEADERS]
    assert got == want
    t = got[0]
    assert t.startswith("t-") and len(t) == 10 and "secret" not in t
    assert got[1] == t and got[2] != t
    assert got[6] == "acme_corp__7" and got[7] == "anon"
    assert got[-1] == got[-2] == "anon"


def test_tenant_label_cardinality_matches_reference(knobs):
    """The first ``label_cardinality`` distinct tenants keep their own
    label, later ones read "other", and a first-seen label is stable —
    in both packages, over the same sequence."""
    from veles_tpu.tenant import TenantAdmission as JaxAdmission
    from veles_tpu_torch.tenant import TenantAdmission
    knobs.tenant.update({"enabled": True, "label_cardinality": 3})
    seq = ["t0", "t1", "t0", "t2", "t3", "t4", "t1", "t3", "t5"]
    out = []
    for cls in (TenantAdmission, JaxAdmission):
        adm = cls()
        out.append([adm.label(t) for t in seq])
        headers = {"x-veles-tenant": "t9"}
        out[-1].append((adm.tag(headers, loopback=True), headers))
    assert out[0] == out[1]
    assert out[0][:6] == ["t0", "t1", "t0", "t2", "other", "other"]
    assert out[0][-1] == ("t9", {"x-veles-tenant": "other"})


def _bucket_decisions(cls):
    adm = cls()
    script = [("a", 100.0), ("a", 100.0), ("a", 100.0), ("b", 100.0),
              ("a", 100.2), ("a", 101.0), ("a", 101.1), ("b", 100.4),
              ("b", 100.5), ("c", 102.0), ("a", 104.0), ("a", 104.0),
              ("a", 104.0)]
    return adm, [adm.throttle(t, now=now) for t, now in script]


def test_tenant_token_bucket_and_lane_match_reference(knobs):
    """One injected clock through both packages' token buckets: the
    same admits and the same Retry-After seconds; the weighted-fair
    lane seats, queues and frees as the reference's; disabled, the lane
    is free."""
    from veles_tpu.tenant import TenantAdmission as JaxAdmission
    from veles_tpu_torch.tenant import TenantAdmission
    knobs.tenant.update({"enabled": True, "rate": 2.0, "burst": 2.0,
                         "max_concurrent": 1})
    adm, got = _bucket_decisions(TenantAdmission)
    jadm, want = _bucket_decisions(JaxAdmission)
    assert got == want
    assert got[:2] == [None, None] and 0 < got[2] <= 2.0
    assert got[3] is None and got[5] is None
    assert adm.snapshot() == jadm.snapshot()
    assert adm.throttled == sum(d is not None for d in got)

    async def lane(a):
        out = [await a.acquire("a", 0.05), await a.acquire("b", 0.05),
               await a.acquire("a", 0.05)]
        a.release("a")
        out.append(await a.acquire("a", 0.05))
        a.release("a")
        a.release("b")
        return out

    assert asyncio.run(lane(adm)) == asyncio.run(lane(jadm)) \
        == ["seat", "seat", None, "seat"]
    knobs.tenant.enabled = False

    async def disabled(a):
        return await a.acquire("a", 0.05)

    assert asyncio.run(disabled(adm)) == asyncio.run(disabled(jadm)) \
        == "free"
    assert adm.throttle("a", now=0.0) is None


def test_router_tenant_429_and_request_tagging(knobs):
    """An over-budget tenant gets a structured 429 with Retry-After
    while another tenant is served; every forwarded request carries
    the bounded label into ``veles_router_requests_total``, and the
    replica's in-flight rows and usage rollup carry it too."""
    from veles_tpu_torch.serving import Router
    from veles_tpu_torch.telemetry import metrics
    knobs.tenant.update({"enabled": True, "rate": 0.02, "burst": 1.0,
                         "max_concurrent": 0, "label_cardinality": 8})
    rep = make_replica(serving_warm_buckets=False, serving_block_size=4,
                       serving_prefill_chunk=4)
    router = Router(health_interval=0.1, health_timeout=5.0,
                    request_timeout=60.0, retries=3, retry_delay=0.02,
                    retry_cap=0.2).start()
    body = {"prompt": [3, 1, 4, 1], "steps": 4, "seed": 0}
    t = None
    try:
        router.add_replica(rep.host, rep.port, replica_id="ten-r0")
        wait_healthy(router, 1)
        _, out = post(router.url, body, headers={"X-Veles-Tenant": "alice"})
        assert len(out["tokens"]) == 8
        with pytest.raises(urllib.error.HTTPError) as e:
            post(router.url, body, headers={"X-Veles-Tenant": "alice"})
        assert e.value.code == 429
        assert float(e.value.headers["Retry-After"]) > 0
        assert "alice" in json.loads(e.value.read().decode())[
            "error"]["message"]
        _, out2 = post(router.url, body, headers={"X-Veles-Tenant": "bob"})
        assert out2["tokens"] == out["tokens"]
        fam = metrics.get("veles_router_requests_total")
        for who in ("alice", "bob"):
            assert fam.labels(replica="ten-r0", outcome="ok",
                              tenant=who).value >= 1
        assert metrics.get("veles_router_tenant_throttled_total").labels(
            tenant="alice").value >= 1
        slow = dict(body, steps=18)
        t = threading.Thread(target=lambda: post(
            router.url, slow, headers={"X-Veles-Tenant": "carol"}),
            daemon=True)
        t.start()
        rep_url = "http://%s:%d" % (rep.host, rep.port)
        seen = False
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and not seen:
            rows = get_json(rep_url, "/debug/requests")["requests"]
            seen = any(r.get("tenant") == "carol" for r in rows)
            time.sleep(0.005)
        t.join(60)
        assert seen
        usage = rep.api.scheduler_.metrics()["tenants"]
        assert usage["alice"]["prompt_tokens"] == 4
        assert usage["alice"]["generated_tokens"] == 4
        assert usage["carol"]["generated_tokens"] == 18
        assert usage["bob"]["kv_block_seconds"] > 0
    finally:
        if t is not None:
            t.join(60)
        router.stop()
        rep.stop()


def test_scheduler_and_router_share_the_tenant_bounder(knobs):
    """The serving metrics bound tenant labels through the process-wide
    ``TenantAdmission`` the router's labels agree with: past the
    cardinality both read "other" for the same tenants."""
    import veles_tpu_torch.serving.metrics as sm
    from veles_tpu_torch.tenant import TenantAdmission
    knobs.tenant.label_cardinality = 2
    saved = sm._tenant_bounder
    sm._tenant_bounder = None
    try:
        labels = [sm._tenant_label(t) for t in ("u0", None, "u1", "u0")]
        assert isinstance(sm._tenant_bounder, TenantAdmission)
        assert labels == ["u0", "anon", "other", "u0"]
        m = sm.ServingMetrics(replica="bounder-r0")
        m.record_tenant_tokens("u1", prompt=3, generated=2)
        assert m.tenant_usage_snapshot()["other"]["prompt_tokens"] == 3
    finally:
        sm._tenant_bounder = saved


# -- the config tree -----------------------------------------------------------

def test_fleet_knobs_read_the_config_tree(knobs):
    """Every knob left None reads ``root.common.<section>`` as the
    reference reads its own tree: the router's, the fleet's, the
    store's, the alert engine's and the SLO tracker's, set alike in
    both trees, give both packages' objects the same values."""
    from veles_tpu.serving.fleet import Fleet as JaxFleet
    from veles_tpu.serving.metrics import SLOTracker as JaxSLO
    from veles_tpu.serving.router import Router as JaxRouter
    from veles_tpu.telemetry.alerts import AlertEngine as JaxEngine
    from veles_tpu.telemetry.tsdb import TimeSeriesStore as JaxStore
    from veles_tpu_torch.serving.fleet import Fleet
    from veles_tpu_torch.serving.metrics import SLOTracker
    from veles_tpu_torch.serving.router import Router
    from veles_tpu_torch.telemetry.alerts import AlertEngine
    from veles_tpu_torch.telemetry.tsdb import TimeSeriesStore
    from veles_tpu.config import root as jroot
    from veles_tpu_torch.config import root
    router_keys = {
        "health_interval": 0.7, "health_timeout": 1.5,
        "breaker_failures": 5, "breaker_cooldown": 3.5, "retries": 2,
        "retry_delay": 0.01, "retry_cap": 1.5, "hedge_delay": 0.25,
        "affinity_tokens": 8, "request_timeout": 9.0,
        "shed_retry_after": 4, "prefix_routing": False,
        "prefix_fetch": False, "prefix_fetch_min": 3}
    slo_saved = [(t, t.common.slo.__content__(),
                  t.common.router.__content__()) for t in (root, jroot)]
    try:
        for tree in (root, jroot):
            tree.common.router.update(router_keys)
            tree.common.slo.update({"target": 0.95,
                                    "ttft_ms": {"high": 250.0}})
        knobs.tsdb.update({"tiers": ((0.5, 60.0),), "max_series": 17,
                           "max_bytes": 4096})
        knobs.alerts.update({"interval": 0.3, "defaults": False})
        knobs.fleet.rebalance = False
        got, want = [], []
        for out, cls_router, cls_fleet, cls_store, cls_engine, cls_slo in (
                (got, Router, Fleet, TimeSeriesStore, AlertEngine,
                 SLOTracker),
                (want, JaxRouter, JaxFleet, JaxStore, JaxEngine, JaxSLO)):
            r = cls_router()
            out.append({k: getattr(r, k) for k in router_keys})
            f = cls_fleet(lambda i, role: None, 1, roles=("prefill",))
            out.append(f.rebalance_enabled)
            st = cls_store(name="knobs")
            out.append((st.tiers, st.max_series, st.max_bytes))
            eng = cls_engine(name="knobs")
            out.append((eng.interval, [x.name for x in eng.rules]))
            slo = cls_slo("knobs")
            out.append((slo.target, slo.objectives))
    finally:
        for tree, slo, rt in slo_saved:
            for node, content in ((tree.common.slo, slo),
                                  (tree.common.router, rt)):
                for k in list(node.__content__()):
                    if k not in content:
                        delattr(node, k)
                node.update(content)
    assert got == want
    assert got[0] == router_keys
    assert got[1] is False and got[2] == (((0.5, 60.0),), 17, 4096)
    assert got[3] == (0.3, [])
    assert got[4][0] == 0.95 and got[4][1]["ttft"]["high"] == 250.0 \
        and got[4][1]["ttft"]["normal"] == 2000.0
