"""Serving metrics of the PyTorch port (``veles_tpu_torch/telemetry/
registry.py``, ``serving/metrics.py``, ``InferenceScheduler.metrics()``
and ``debug_requests()``, ``PagedKVCache.can_admit``/``bytes_per_token``
and the scheduler's ``queue_timeout``) held against the JAX package on
the CPU.

- The registry: the same operations on a fresh registry of each package
  give the same Prometheus text, byte for byte, and the same snapshot.
- ``ServingMetrics``: one seeded sequence of every recorder on an
  instance of each package gives equal snapshots.  Left out of the
  comparison, because they divide by wall-clock spans the two runs do
  not share: ``uptime_s``, ``tokens_per_sec_recent`` and
  ``goodput_tokens_per_sec``.  The SLO burn rates are compared: every
  observation lies inside the shortest window.
- The scheduler: the same requests through both packages' schedulers
  give equal counting keys of ``metrics()`` and the same key set, less
  the keys of features the port does not have.
"""

import random
import time

import numpy
import pytest

from veles_tpu.config import root

from tests.test_torch_transformer import (  # noqa: F401 (chains: fixture)
    chains, port_chain)

pytestmark = pytest.mark.torch_port


# -- the registry -------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 3])
@pytest.mark.parametrize("q", [0.5, 0.99])
def test_nearest_rank_matches_jax(n, q):
    from veles_tpu.telemetry.registry import nearest_rank as jrank
    from veles_tpu_torch.telemetry import nearest_rank
    vals = sorted([3.5, -1.0, 2.0][:n])
    assert nearest_rank(vals, q) == jrank(vals, q)
    assert nearest_rank([], q) is None and jrank([], q) is None


def _drive_registry(reg, seed):
    """A seeded sequence of counter, gauge, histogram and label
    operations, the same whichever package's registry ``reg`` is."""
    rng = random.Random(seed)
    c = reg.counter("t_requests_total", 'requests "served"\nper test')
    g = reg.gauge("t_depth", "queue depth \\ slots")
    h = reg.histogram("t_latency_seconds", "latency")
    hm = reg.histogram("t_ttft_ms", "ttft", buckets=(1.0, 2.5, 10.0, 50.0),
                       reservoir=8)
    fc = reg.counter("t_class_total", "by class", labelnames=("cls",))
    fg = reg.gauge("t_kv", "by replica and dtype",
                   labelnames=("replica", "dtype"))
    fh = reg.histogram("t_class_ms", "by class", labelnames=("cls",),
                       buckets=(1.0, 100.0))
    reg.gauge("t_fn", "callback").set_function(lambda: 41.5)
    reg.gauge("t_fn_broken", "callback raising").set_function(
        lambda: 1 / 0)
    reg.counter("t_unregistered", "dropped")
    reg.unregister("t_unregistered")
    for _ in range(200):
        op = rng.randrange(9)
        if op == 0:
            c.inc(rng.choice([1, 2, 0.5]))
        elif op == 1:
            g.set(rng.uniform(-5, 5))
        elif op == 2:
            (g.inc if rng.random() < 0.5 else g.dec)(rng.randrange(4))
        elif op == 3:
            h.observe(rng.expovariate(20.0))
        elif op == 4:
            hm.observe(rng.choice([0.5, 2.5, 7.0, 80.0, 1e9]))
        elif op == 5:
            fc.labels(rng.choice(["low", "normal", 'hi"gh'])).inc()
        elif op == 6:
            fg.labels(replica=rng.choice(["r1", "r\n2"]),
                      dtype=rng.choice(["fp32", "int8"])).set(
                          rng.randrange(100))
        elif op == 7:
            fh.labels(cls=rng.choice(["low", "high"])).observe(
                rng.uniform(0, 200))
        else:
            fg.remove(rng.choice(["r1", "r\n2"]), "int8")
    assert reg.get("t_unregistered") is None
    with pytest.raises(ValueError):
        reg.gauge("t_requests_total")
    with pytest.raises(ValueError):
        c.inc(-1)
    return reg


@pytest.mark.parametrize("seed", [0, 1])
def test_registry_text_and_snapshot_match_jax(seed):
    from veles_tpu.telemetry.registry import MetricsRegistry as JReg
    from veles_tpu_torch.telemetry import MetricsRegistry
    jreg = _drive_registry(JReg(), seed)
    treg = _drive_registry(MetricsRegistry(), seed)
    text = treg.render_prometheus()
    assert text == jreg.render_prometheus()
    assert "NaN" in text and '\\"' in text and "+Inf" in text
    assert _nan_safe(treg.snapshot()) == _nan_safe(jreg.snapshot())
    assert treg.collect_families()[0]["name"] \
        == jreg.collect_families()[0]["name"]


def _nan_safe(x):
    """Snapshots compare with NaN equal to itself."""
    if isinstance(x, dict):
        return {k: _nan_safe(v) for k, v in x.items()}
    if isinstance(x, float) and x != x:
        return "nan"
    return x


def test_histogram_summary_matches_jax():
    from veles_tpu.telemetry.registry import Histogram as JHist
    from veles_tpu_torch.telemetry import Histogram
    rng = numpy.random.default_rng(2)
    vals = rng.exponential(30.0, 700).tolist()
    j, t = JHist("x", reservoir=256), Histogram("x", reservoir=256)
    assert t.summary() == j.summary()
    for v in vals:
        j.observe(v)
        t.observe(v)
    assert t.summary() == j.summary()
    assert t.percentile(0.95) == j.percentile(0.95)
    assert (t.count, t.sum, t.min, t.max, t.mean()) \
        == (j.count, j.sum, j.min, j.max, j.mean())


# -- SLO accounting -----------------------------------------------------------

def test_slo_good_bad_and_burn_rate():
    """The port of the JAX test of the same name: latency under the
    class objective counts good; over it counts bad and burns the error
    budget, bad fraction / (1 - target)."""
    from veles_tpu_torch.serving.metrics import SLOTracker
    slo = SLOTracker("test-slo", ttft_ms={"normal": 100.0})
    for _ in range(4):
        slo.record("normal", "ttft", 50.0)    # under: good
    snap = slo.snapshot()["classes"]["normal"]["ttft"]
    assert snap["good"] == 4 and snap["bad"] == 0
    assert all(v == 0.0 for v in snap["burn_rate"].values())
    for _ in range(4):
        slo.record("normal", "ttft", 500.0)   # over: bad
    snap = slo.snapshot()["classes"]["normal"]["ttft"]
    assert snap["good"] == 4 and snap["bad"] == 4
    # 50% bad over the window / 1% budget = 50x burn
    assert snap["burn_rate"]["60s"] == pytest.approx(50.0)
    slo.record("normal", "e2e", 10.0 ** 9)
    slo2 = SLOTracker("test-slo")
    assert "e2e" in slo2.objectives
    assert slo2.objectives["ttft"] == {"low": 5000.0, "normal": 2000.0,
                                       "high": 500.0}
    none = SLOTracker("test-slo", ttft_ms={"normal": None})
    none.record("normal", "ttft", 10.0 ** 9)
    assert "normal" not in none.snapshot()["classes"]


def test_slo_disabled_is_inert():
    from veles_tpu_torch.serving.metrics import SLOTracker
    slo = SLOTracker("test-slo-off", enabled=False)
    slo.record("normal", "ttft", 10.0 ** 9)
    snap = slo.snapshot()
    assert snap["enabled"] is False and snap["classes"] == {}


def test_slo_defaults_match_jax():
    from veles_tpu.serving.metrics import SLOTracker as JSLO
    from veles_tpu_torch.serving.metrics import SLOTracker
    j, t = JSLO("test-slo-defaults"), SLOTracker("test-slo-defaults")
    assert (t.enabled, t.target, t.windows, t.objectives) \
        == (j.enabled, j.target, j.windows, j.objectives)


# -- ServingMetrics -----------------------------------------------------------

#: snapshot keys derived from wall-clock spans (see the module docstring)
CLOCK_KEYS = ("uptime_s", "tokens_per_sec_recent", "goodput_tokens_per_sec")


@pytest.fixture
def fresh_tenant_labels():
    """Both packages bound tenant labels process-wide (the first 8
    distinct tenants keep theirs); start both from none."""
    import veles_tpu.serving.metrics as jm
    import veles_tpu_torch.serving.metrics as tm
    saved_j, saved_t = jm._tenant_bounder, tm._tenant_bounder
    jm._tenant_bounder = tm._tenant_bounder = None
    yield
    jm._tenant_bounder, tm._tenant_bounder = saved_j, saved_t


def _drive_serving_metrics(sm, seed):
    rng = random.Random(seed)
    classes = ("low", "normal", "high")
    tenants = ["t%d" % i for i in range(11)] + [None]
    for _ in range(400):
        op = rng.randrange(26)
        cls = rng.choice(classes)
        trace = rng.choice([None, "tr%d" % rng.randrange(5)])
        if op == 0:
            sm.record_submit(cls=cls)
        elif op == 1:
            sm.record_reject(rng.randrange(40))
        elif op == 2:
            sm.record_expire(rng.uniform(0, 900), tokens=rng.randrange(9),
                             trace=trace)
        elif op == 3:
            sm.record_cancel(rng.randrange(30), trace=trace)
        elif op == 4:
            sm.record_shed(rng.randrange(200), cls=cls, trace=trace)
        elif op == 5:
            sm.record_preempt(rng.randrange(50), cls=cls, trace=trace)
        elif op == 6:
            sm.record_resume(rng.randrange(300))
        elif op == 7:
            sm.record_watchdog_trip(rng.randrange(5), rng.uniform(0, 9))
        elif op == 8:
            sm.record_drain()
        elif op == 9:
            sm.set_kv_exports_pending(rng.randrange(6))
        elif op == 10:
            sm.record_kv_export_expired(rng.randrange(4), trace=trace)
        elif op == 11:
            sm.record_kv_export_fetched()
        elif op == 12:
            d = rng.randrange(1, 9)
            sm.record_spec(d, rng.randrange(d + 1),
                           drafter=rng.choice(["ngram", "model"]),
                           draft_k=rng.choice([None, 1, 2, 4, 8]))
        elif op == 13:
            sm.record_tenant_tokens(rng.choice(tenants),
                                    prompt=rng.randrange(300),
                                    generated=rng.randrange(60))
        elif op == 14:
            sm.record_tenant_step({
                rng.choice(tenants): (rng.randrange(40) * 0.25,
                                      rng.randrange(8) * 0.125)
                for _ in range(rng.randrange(1, 4))})
        elif op == 15:
            sm.record_prefix_lookup(rng.choice([0, 0, 1, 3]), 16)
        elif op == 16:
            sm.record_prefix_evict(rng.randrange(5))
        elif op == 17:
            sm.record_kv_host(promoted=rng.randrange(3),
                              demoted=rng.randrange(3))
        elif op == 18:
            sm.set_kv_host(rng.randrange(50), rng.randrange(10 ** 6))
        elif op == 19:
            sm.set_prefix_blocks(rng.randrange(30), rng.randrange(10))
        elif op == 20:
            sm.record_first_token(rng.uniform(1, 9000),
                                  rng.uniform(0, 900), cls=cls)
        elif op == 21:
            sm.record_prefill_chunk(rng.randrange(1, 65),
                                    rng.uniform(1, 40))
        elif op == 22:
            used = rng.randrange(64)
            sm.set_kv_blocks(used, 64 - used)
        elif op == 23:
            sm.set_kv_dtype(rng.choice(["fp32", "int8"]),
                            rng.choice([4096, 2080]))
        elif op == 24:
            a = rng.randrange(1, 9)
            sm.record_step(a, 8, tokens=rng.choice([None, a, 3 * a]),
                           duration_s=0.01)
        else:
            sm.record_complete(rng.randrange(1, 100), rng.uniform(0.01, 90),
                               rng.uniform(1, 9000), rng.uniform(0, 900),
                               cls=cls, trace=trace)
    kv = {"kv_mode": "paged", "kv_blocks_used": 3, "kv_blocks_free": 61}
    return sm.snapshot(queue_depth=2, active_slots=3, max_slots=8, kv=kv)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_serving_metrics_snapshot_matches_jax(seed, fresh_tenant_labels):
    from veles_tpu.serving.metrics import ServingMetrics as JSM
    from veles_tpu_torch.serving.metrics import ServingMetrics
    j = JSM(replica="parity-j%d" % seed)
    t = ServingMetrics(replica="parity-t%d" % seed)
    want = _drive_serving_metrics(j, seed)
    got = _drive_serving_metrics(t, seed)
    for key in CLOCK_KEYS:
        assert key in got and key in want
        got.pop(key)
        want.pop(key)
    assert got == want
    assert t.tenant_usage_snapshot() == j.tenant_usage_snapshot()
    assert "other" in t.tenant_usage_snapshot()   # 12 tenants, 8 labels
    assert t.goodput_snapshot()[1] == j.goodput_snapshot()[1]


def test_serving_metrics_mirror_the_registry_series():
    """Every series of the JAX package's serving metrics exists in the
    port's registry under the same name, type and help text."""
    from veles_tpu.serving import metrics as jm
    from veles_tpu.telemetry import metrics as jreg
    from veles_tpu_torch.serving import metrics as tm
    from veles_tpu_torch.telemetry import metrics as treg
    jm.ServingMetrics(replica="mirror-j")
    tm.ServingMetrics(replica="mirror-t")
    for key, fam in jm._registry_series().items():
        got = treg.get(fam.name)
        assert got is not None, fam.name
        assert (got.TYPE, got.help) == (fam.TYPE, fam.help), fam.name
    for key, fam in jm._slo_series().items():
        got = treg.get(fam.name)
        assert (got.TYPE, got.help) == (fam.TYPE, fam.help), fam.name
    assert jreg.get("veles_serving_ttft_ms") is not None


# -- C4: the paged cache's admission reads ------------------------------------

@pytest.fixture
def f32():
    saved = root.common.precision.get("compute_dtype", "bfloat16")
    root.common.precision.compute_dtype = "float32"
    yield
    root.common.precision.compute_dtype = saved


def test_paged_cache_block_churn_matches_jax(f32, chains):
    """The exhaustion sequence of ``test_serving.py::
    test_paged_cache_block_churn`` (4 slots, window 32, 16 blocks of 4)
    on both packages' caches: after ``alloc(32)`` and ``alloc(28)`` one
    block and two slots are free, ``can_admit(8)`` is False and
    ``alloc(8)`` None, ``can_admit(4)`` is True; ``active_slots`` and
    the free counts agree at every step.  The port raised
    AttributeError here before."""
    from veles_tpu.serving.kv_slots import PagedKVCache as JCache
    from veles_tpu_torch.serving.kv_slots import PagedKVCache
    spec, fw = chains
    kw = dict(max_slots=4, window=32, block_size=4, kv_blocks=16)
    caches = [JCache(fw, **kw), PagedKVCache(port_chain(spec, fw), **kw)]

    def reads(c):
        return (c.free_slots, c.active_slots, c.free_blocks,
                c.used_blocks, c.can_admit(8), c.can_admit(4),
                c.can_admit(1), c.can_admit(32))

    seen = []
    for c in caches:
        row = [reads(c)]
        a = c.alloc(32)   # 8 blocks
        b = c.alloc(28)   # 7 blocks -> 1 of 16 left
        assert a is not None and b is not None
        assert c.free_blocks == 1 and c.free_slots == 2
        assert c.active_slots == 2
        row.append(reads(c))
        assert not c.can_admit(8)
        assert c.alloc(8) is None
        assert c.can_admit(4) and c.alloc(4) is not None
        row.append(reads(c))
        assert c.active_slots == 3 and not c.can_admit(1)
        c.release(a)
        row.append(reads(c))
        assert c.can_admit(32)
        c.check()
        seen.append(row)
    assert seen[1] == seen[0]


@pytest.mark.parametrize("kv_dtype", ["fp32", "int8"])
def test_bytes_per_token_matches_jax(f32, chains, kv_dtype):
    from veles_tpu.serving.kv_slots import PagedKVCache as JCache
    from veles_tpu_torch.serving.kv_slots import PagedKVCache
    spec, fw = chains
    j = JCache(fw, 2, 64, block_size=8, kv_dtype=kv_dtype)
    t = PagedKVCache(port_chain(spec, fw), 2, 64, block_size=8,
                     kv_dtype=kv_dtype)
    layers = len(fw) - 2
    d = spec[0]["dim"]
    assert t.bytes_per_token() == j.bytes_per_token()
    assert t.bytes_per_token() == layers * 2 * (
        d * 4 if kv_dtype == "fp32" else d + 4)


# -- the scheduler's metrics() ------------------------------------------------

#: metrics() keys compared exactly between the packages: every counting
#: key, the KV and prefix-cache state, the configuration echo
COUNT_KEYS = (
    "requests_submitted", "requests_completed", "requests_rejected",
    "requests_expired", "requests_cancelled", "requests_shed",
    "tokens_generated", "slot_busy_steps", "slot_occupancy",
    "prefill_chunks", "prefill_chunk_tokens", "preempts",
    "preempt_resumes", "watchdog_trips", "spec_drafted_tokens",
    "spec_accepted_tokens", "spec_rollback_tokens", "spec_accept_rate",
    "prefix_cache_hits", "prefix_cache_misses",
    "prefix_cache_hit_blocks", "prefix_cache_blocks_resident",
    "prefix_cache_blocks_shared", "prefix_cache_evictions",
    "prefix_cache_hit_rate", "prefix_digests", "kv_blocks_used",
    "kv_blocks_free", "kv_blocks_total", "kv_bytes_per_token",
    "kv_dtype", "kv_block_size", "kv_mode", "queue_depth",
    "active_slots", "max_slots", "queued_kv_blocks", "window",
    "draining", "drained", "spec", "spec_k", "drafter", "draft_k_min",
    "tp", "role", "kv_exports_pending", "prefilling", "prefix_cache")
#: per-class counting keys
CLASS_KEYS = ("submitted", "completed", "preempts", "sheds")
#: keys whose values the JAX scheduler fills from features the port does
#: not have (tenant metering's "anon" usage); the key itself is in both
FEATURE_OFF = ("tenants",)


def _drive_scheduler(sch, pattern, expire_sleep):
    """One request mix, fed before the loop starts so both packages
    batch it alike: five greedy prompts (two repeats, so the prefix
    cache hits; one longer than the chunk), a request past the queue
    cap (rejected), one cancelled while queued and one whose deadline
    passes before the loop starts; then the loop runs them and two
    warm resubmits follow."""
    from veles_tpu_torch.serving import QueueFullError as TFull
    from veles_tpu.serving.scheduler import QueueFullError as JFull
    prompts = [(pattern * 4)[o:o + n] for o, n in
               ((0, 12), (0, 12), (2, 20), (1, 9), (3, 12))]
    futs = [sch.submit(p, 8, seed=0) for p in prompts]
    gone = sch.submit(prompts[3], 4)
    late = sch.submit(prompts[4], 4, timeout=0.05)
    with pytest.raises((TFull, JFull)):
        sch.submit(prompts[0], 4)
    assert sch.cancel(gone)
    time.sleep(expire_sleep)
    sch.start()
    outs = [f.result(240) for f in futs]
    with pytest.raises(Exception, match="queued"):
        late.result(240)
    outs += [sch.submit(prompts[k], 8, seed=0).result(240) for k in (0, 2)]
    return outs


def _compare_metrics(got, want):
    for key in COUNT_KEYS:
        assert got[key] == want[key], (key, got[key], want[key])
    assert got["classes"].keys() == want["classes"].keys()
    for cls, rec in want["classes"].items():
        assert {k: got["classes"][cls][k] for k in CLASS_KEYS} \
            == {k: rec[k] for k in CLASS_KEYS}, cls
    assert set(got) == set(want), set(got) ^ set(want)
    for key in FEATURE_OFF:
        assert key in got


@pytest.mark.parametrize("kv_dtype,spec", [("fp32", False), ("fp32", True),
                                           ("int8", False), ("int8", True)])
def test_scheduler_metrics_match_jax(f32, spec_trained_chain, kv_dtype, spec):
    """The same requests through both packages' schedulers (greedy, the
    prefix cache on, chunked prefill, spec off and on, int8 and fp32
    pools) give the same streams, equal counting keys of ``metrics()``
    and the same key set; the scheduler's own counter attributes agree
    with ``metrics()``."""
    from tests.test_torch_serving import _spec
    from veles_tpu.serving import InferenceScheduler as JSched
    from veles_tpu_torch.serving import InferenceScheduler
    fw, pattern = spec_trained_chain
    chain = port_chain(_spec(fw), fw)
    kw = dict(max_slots=2, window=64, block_size=4, kv_dtype=kv_dtype,
              prefill_chunk=8, spec=spec, spec_k=4, request_timeout=120.0,
              watchdog=0, shed_block_factor=4.0, prefix_cache=True,
              prefix_evict=True)
    jsch = JSched(fw, max_queue=7, kv="paged", warm_buckets=False, **kw)
    tsch = InferenceScheduler(chain, max_queue=7, device="cpu", **kw)
    try:
        want_out = _drive_scheduler(jsch, pattern, 0.2)
        got_out = _drive_scheduler(tsch, pattern, 0.2)
        want, got = jsch.metrics(), tsch.metrics()
    finally:
        jsch.close()
        tsch.close()
    assert got_out == want_out
    _compare_metrics(got, want)
    assert got["requests_completed"] == 7 and got["requests_expired"] == 1
    assert got["requests_cancelled"] == 1 and got["requests_rejected"] == 1
    assert got["prefix_cache_hits"] >= 2
    assert (got["spec_drafted_tokens"] > 0) == spec
    assert got["ttft_ms_p50"] is not None and got["slo"]["enabled"]
    for name in ("requests_expired", "requests_cancelled", "requests_shed",
                 "requests_rejected", "preempts", "preempt_resumes",
                 "watchdog_trips", "prefill_chunk_tokens",
                 "spec_drafted_tokens", "spec_accepted_tokens",
                 "prefix_cache_hits", "prefix_cache_misses"):
        assert getattr(tsch, name) == got[name], name
    # each completed request's first token comes from its prefill
    assert tsch.decode_tokens + got["requests_completed"] \
        == got["tokens_generated"]
    assert len(tsch.completed) == got["requests_completed"]


def test_queue_timeout_expires_a_queued_request_as_jax_does(
        f32, spec_trained_chain):
    """C5: with ``request_timeout=0`` a request given no ``timeout``
    still carries ``queue_timeout``; one slot busy behind an injected
    step delay keeps the second request queued past it, and both
    packages fail it with DeadlineExceededError (the port never
    expired it before)."""
    from tests.test_torch_serving import _spec
    from veles_tpu import faults as jfaults
    from veles_tpu.serving import InferenceScheduler as JSched
    from veles_tpu.serving.scheduler import DeadlineExceededError as JLate
    from veles_tpu_torch import faults
    from veles_tpu_torch.serving import (
        DeadlineExceededError, InferenceScheduler)
    fw, pattern = spec_trained_chain
    chain = port_chain(_spec(fw), fw)
    kw = dict(max_slots=1, window=64, block_size=4, prefill_chunk=8,
              spec=False, request_timeout=0, queue_timeout=0.3,
              watchdog=0, prefix_cache=False)
    prompt = (pattern * 4)[:12]
    runs = ((JSched(fw, kv="paged", warm_buckets=False, **kw), jfaults,
             JLate),
            (InferenceScheduler(chain, device="cpu", **kw), faults,
             DeadlineExceededError))
    for sch, reg, late_error in runs:
        assert sch.queue_timeout == 0.3 and sch.request_timeout == 0
        sch.start()
        try:
            reg.inject("serving.scheduler.step", "delay", arg=0.05)
            busy = sch.submit(prompt, 30, timeout=60)
            queued = sch.submit(prompt, 4)
            with pytest.raises(late_error, match="queued"):
                queued.result(60)
            reg.clear()
            assert len(busy.result(120)) == len(prompt) + 30
            assert sch.metrics()["requests_expired"] == 1
        finally:
            reg.clear()
            sch.close()
