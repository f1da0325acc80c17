"""The serving fleet of the PyTorch port (``veles_tpu_torch/serving/
{router, fleet}.py``) over the port's own replicas on the CPU — the
cases of ``tests/test_router.py`` and the router-side cases of
``tests/test_failover.py`` (oracles), on a tiny f32 chain: the chaos
soak (a replica killed mid-decode, a breaker episode and a rolling
restart under load with zero failed requests and no leaked KV block),
breakers under an injected hang, drain without a breaker trip, hedging
of idempotent requests only, the retry budget under the deadline with
``tokens_generated`` propagated, the spawn retry through
``fleet.replica.spawn``, mid-stream failover spliced bit-identical
(injected and by a real kill), the kill at every request phase and
role rebalancing.  A parity case drives a JAX fleet and a port fleet
on the same weights under the same injected faults (equal greedy
replies, equal breaker transitions), and a ``SubprocessReplica`` runs
the port's command line.

The helpers here (``make_replica``, ``post``, ``wait_healthy``) serve
the port's other fleet test files."""

import json
import os
import sys
import threading
import time
import urllib.error
import urllib.request
import zlib
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from veles_tpu_torch import faults
from veles_tpu_torch.config import root

from tests.test_torch_cli import cli_env  # noqa: F401 (fixture)

pytestmark = pytest.mark.torch_port

#: the oracle's replica chain (tests/test_router.py::_make_replica)
SPEC = [{"type": "embedding", "vocab": 11, "dim": 8},
        {"type": "transformer_block", "heads": 2, "causal": True},
        {"type": "token_logits", "vocab": 11}]
WINDOW = 24


@pytest.fixture(autouse=True)
def disarm():
    from veles_tpu import faults as jax_faults
    faults.clear()
    jax_faults.clear()
    yield
    faults.clear()
    jax_faults.clear()


#: the thread names of routers, fleets, controllers, stores, alert
#: engines, schedulers and servers (both packages name them alike)
FLEET_THREADS = ("serving-router", "fleet-monitor", "fleet-controller",
                 "tsdb-", "alerts-", "serving-scheduler",
                 "serving-watchdog", "restful-api")


@pytest.fixture(autouse=True)
def no_leaked_threads():
    """Every test stops what it started: no fleet-tier thread that was
    not alive before the test outlives it (each gets 10 s to end)."""
    before = {t.ident for t in threading.enumerate()}

    def leaked():
        return [t.name for t in threading.enumerate()
                if t.ident not in before and t.is_alive()
                and t.name.startswith(FLEET_THREADS)]

    yield
    deadline = time.monotonic() + 10
    while leaked() and time.monotonic() < deadline:
        time.sleep(0.05)
    assert not leaked(), leaked()


def make_replica(seed=1234, chain=None, **api_kwargs):
    """One in-process port replica (its own scheduler thread and KV
    pool) over a fresh f32 chain drawn from ``default_rng(seed)``:
    every replica of one seed carries the same weights, so greedy
    replies do not depend on which replica answers."""
    from veles_tpu_torch.convert import init_params
    from veles_tpu_torch.restful_api import RESTfulAPI
    from veles_tpu_torch.serving.fleet import LocalReplica
    if chain is None:
        chain = init_params(SPEC, seed, window=WINDOW, device="cpu",
                            dtype="float32")
    api = RESTfulAPI(forwards=chain, device="cpu",
                     max_slots=api_kwargs.pop("max_slots", 2),
                     **api_kwargs)
    api.initialize()
    return LocalReplica(api)


def post(url, payload, timeout=60, headers=None, path="/generate"):
    hdrs = {"Content-Type": "application/json"}
    hdrs.update(headers or {})
    req = urllib.request.Request(url + path,
                                 data=json.dumps(payload).encode(),
                                 headers=hdrs)
    resp = urllib.request.urlopen(req, timeout=timeout)
    return dict(resp.headers), json.load(resp)


def get_json(url, path, timeout=30):
    return json.load(urllib.request.urlopen(url + path, timeout=timeout))


def session_for(replica_ids, target_id):
    """A session key whose rendezvous hash (the router's affinity
    formula) lands on ``target_id``."""
    for i in range(10000):
        s = "sess%d" % i
        owner = max(replica_ids, key=lambda rid: zlib.crc32(
            ("%s|%s" % (s, rid)).encode()))
        if owner == target_id:
            return s
    raise AssertionError("no session hashed to %s" % target_id)


def wait_healthy(router, n, timeout=30):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        live = [r for r in router.replica_state()["replicas"]
                if r["healthy"]]
        if len(live) >= n:
            return live
        time.sleep(0.05)
    raise AssertionError("fewer than %d healthy replicas" % n)


def breaker_transitions(metrics, replica_id):
    counter = metrics.counter("veles_router_breaker_transitions_total",
                              labelnames=("replica", "to"))
    return {to: counter.labels(replica=str(replica_id), to=to).value
            for to in ("closed", "half_open", "open")}


def _router(**kw):
    from veles_tpu_torch.serving import Router
    args = dict(health_interval=0.1, health_timeout=5.0,
                request_timeout=60.0, retries=4, retry_delay=0.02,
                retry_cap=0.2)
    args.update(kw)
    return Router(**args).start()


# -- the chaos soak -----------------------------------------------------------

def test_fleet_chaos_soak_kill_and_rolling_restart():
    """3 replicas under continuous mixed load survive a hard kill
    mid-decode, an injected-500 breaker episode with its full open →
    half-open → closed recovery and a rolling restart: zero failed
    requests, no leaked KV block, greedy replies the same whichever
    replica served them."""
    from veles_tpu_torch.serving import Fleet
    from veles_tpu_torch.telemetry import metrics
    router = _router(health_timeout=2.0, request_timeout=60.0,
                     breaker_failures=2, breaker_cooldown=0.3)
    fleet = Fleet(lambda index: make_replica(), 3, router=router,
                  monitor_interval=0.1).start()
    url = router.url
    errors, replies = [], []
    stop = threading.Event()
    prompts = [[3, 1, 4], [5], [7, 2, 9, 1], [2, 2]]
    threads = []
    try:
        wait_healthy(router, 3)
        h1, ref = post(url, {"prompt": [3, 1, 4], "steps": 6})
        h2, again = post(url, {"prompt": [3, 1, 4], "steps": 6})
        assert again == ref
        assert h1["X-Veles-Replica"] == h2["X-Veles-Replica"]

        def client(i):
            k = 0
            while not stop.is_set():
                p = prompts[(i + k) % len(prompts)]
                body = {"prompt": p, "steps": 6}
                if k % 3 == 1:
                    body.update(temperature=0.8, top_k=4, seed=17)
                try:
                    _, out = post(url, body, timeout=60)
                    replies.append((list(p), body.get("temperature"),
                                    out["tokens"]))
                except Exception as e:  # noqa: BLE001 — asserted 0
                    errors.append(repr(e))
                k += 1

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        faults.inject("serving.scheduler.step", "delay", arg=0.002)
        time.sleep(0.5)

        victim = fleet.handles()[0]
        victim_id = fleet.replica_id(0)
        victim.stop()
        deadline = time.monotonic() + 30
        while fleet.replica_id(0) == victim_id \
                or not fleet.handles()[0].alive():
            assert time.monotonic() < deadline, "no respawn"
            time.sleep(0.05)
        time.sleep(0.3)

        target_id = fleet.replica_id(1)
        ids = [r["id"] for r in router.replica_state()["replicas"]]
        aim = {"X-Veles-Session": session_for(ids, target_id)}
        before = breaker_transitions(metrics, target_id)
        deadline = time.monotonic() + 30
        while True:
            faults.inject("router.forward", "http_error", arg=500,
                          times=2, key=target_id)
            post(url, {"prompt": [9, 9], "steps": 2}, headers=aim)
            post(url, {"prompt": [9, 9], "steps": 2}, headers=aim)
            if breaker_transitions(metrics, target_id)["open"] \
                    > before["open"]:
                break
            assert time.monotonic() < deadline, "breaker did not open"
        faults.clear("router.forward")
        deadline = time.monotonic() + 30
        while True:
            after = breaker_transitions(metrics, target_id)
            if after["half_open"] > before["half_open"] \
                    and after["closed"] > before["closed"]:
                break
            assert time.monotonic() < deadline, (after, before)
            post(url, {"prompt": [9, 9], "steps": 2}, headers=aim)
            time.sleep(0.1)

        report = fleet.rolling_restart(drain_timeout=60)
        assert len(report) == 3
        time.sleep(0.3)
        stop.set()
        for t in threads:
            t.join(60)
            assert not t.is_alive(), "client wedged"
        faults.clear()

        assert not errors, errors[:10]
        assert len(replies) >= 20, "soak produced too little traffic"
        refs = {tuple(p): post(url, {"prompt": p, "steps": 6})[1]["tokens"]
                for p in prompts}
        for p, temp, toks in replies:
            assert len(toks) == len(p) + 6
            if not temp:
                assert toks == refs[tuple(p)], p
        for idx, handle in fleet.handles().items():
            sch = handle.api.scheduler_
            sch.check_kv()
            resident = sch.prefix_.resident \
                if sch.prefix_ is not None else 0
            assert sch.cache_.used_blocks == resident, idx
        state = router.replica_state()
        assert state["router"]["retries"] >= 1
        assert state["router"]["replica_restarts"] >= 4
        assert state["router"]["requests_error"] >= 1
        assert all(r["breaker"] == "closed" for r in state["replicas"])
    finally:
        stop.set()
        faults.clear()
        for t in threads:
            t.join(60)
        fleet.stop()
        router.stop()


# -- circuit breaker ----------------------------------------------------------

def test_breaker_hang_timeout_counts_as_failure():
    """A hung forward times out at the request deadline, fails the
    attempt and opens the breaker; with its only replica open the
    fleet sheds with a structured 503 and Retry-After."""
    rep = make_replica()
    router = _router(health_interval=0.2, request_timeout=0.8,
                     retries=1, breaker_failures=1,
                     breaker_cooldown=5.0)
    try:
        router.add_replica(rep.host, rep.port, replica_id="rH")
        faults.inject("router.forward", "hang", arg=3.0, times=1,
                      key="rH")
        t0 = time.monotonic()
        with pytest.raises(urllib.error.HTTPError) as e:
            post(router.url, {"prompt": [3, 1], "steps": 2}, timeout=30)
        elapsed = time.monotonic() - t0
        assert e.value.code == 502
        body = json.loads(e.value.read().decode())
        assert body["error"]["attempts"] == 1
        assert elapsed < 2.5, "did not fail at the deadline"
        assert router.replica_state()["replicas"][0]["breaker"] == "open"
        with pytest.raises(urllib.error.HTTPError) as e:
            post(router.url, {"prompt": [3, 1], "steps": 2}, timeout=30)
        assert e.value.code == 503
        assert int(e.value.headers["Retry-After"]) >= 1
        assert json.loads(e.value.read().decode())["error"]["shed"] \
            is True
    finally:
        router.stop()
        rep.stop()


def test_draining_is_not_a_breaker_trip():
    """Draining a replica routes traffic away without opening its
    breaker, and /drain through the router reaches the replica."""
    reps = [make_replica() for _ in range(2)]
    router = _router(request_timeout=30.0)
    try:
        for i, rep in enumerate(reps):
            router.add_replica(rep.host, rep.port, replica_id="rD%d" % i)
        assert router.drain_replica("rD0")["draining"] is True
        for _ in range(4):
            headers, _ = post(router.url, {"prompt": [3, 1], "steps": 2})
            assert headers["X-Veles-Replica"] == reps[1].replica_id
        state = {r["id"]: r for r in router.replica_state()["replicas"]}
        assert state["rD0"]["draining"] is True
        assert state["rD0"]["breaker"] == "closed"
        assert state["rD1"]["draining"] is False
        assert reps[0].api._draining_
    finally:
        router.stop()
        for rep in reps:
            rep.stop()


# -- hedging ------------------------------------------------------------------

def test_hedging_fires_only_on_idempotent_requests():
    """A straggling primary is hedged once for an idempotent request
    (greedy or seeded) and the hedge wins; an unseeded sampled request
    waits the straggler out instead of decoding twice."""
    reps = [make_replica() for _ in range(2)]
    router = _router(health_interval=0.2, request_timeout=30.0,
                     hedge_delay=0.1, affinity_tokens=0, retries=2)
    try:
        for i, rep in enumerate(reps):
            router.add_replica(rep.host, rep.port, replica_id="r%d" % i)
        post(router.url, {"prompt": [3, 1], "steps": 2})
        faults.inject("router.forward", "delay", arg=1.0, key="r0")
        t0 = time.monotonic()
        headers, out = post(router.url, {"prompt": [3, 1, 4], "steps": 3})
        fast = time.monotonic() - t0
        assert len(out["tokens"]) == 6
        assert headers["X-Veles-Replica"] == reps[1].replica_id
        assert fast < 0.9, "hedge did not win over the straggler"
        snap = router.stats.snapshot()
        assert snap["hedges"] == 1 and snap["hedge_wins"] == 1
        t0 = time.monotonic()
        post(router.url, {"prompt": [3, 1, 4], "steps": 3,
                          "temperature": 0.9})
        assert time.monotonic() - t0 >= 0.9, \
            "non-idempotent request was hedged"
        assert router.stats.snapshot()["hedges"] == 1
    finally:
        router.stop()
        for rep in reps:
            rep.stop()


# -- retry budget / deadline --------------------------------------------------

class _FakeReplicaHandler(BaseHTTPRequestHandler):
    """Always-failing replica: /healthz answers, every /generate is a
    structured 500 carrying a ``tokens_generated`` count."""

    tokens = (3, 7, 5, 2, 1)
    hits = [0]

    def log_message(self, *args):
        pass

    def _reply(self, code, obj):
        blob = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(blob)))
        self.end_headers()
        self.wfile.write(blob)

    def do_GET(self):
        self._reply(200, {"status": "ok", "draining": False})

    def do_POST(self):
        n = self.tokens[self.hits[0] % len(self.tokens)]
        self.hits[0] += 1
        self._reply(500, {"error": {"code": 500,
                                    "message": "scripted failure",
                                    "tokens_generated": n}})


def test_retry_budget_and_tokens_propagation():
    """Retries stop at the budget and never sleep past the deadline;
    the final reply carries ``tokens_generated`` of the best failed
    attempt."""
    _FakeReplicaHandler.hits[0] = 0
    server = ThreadingHTTPServer(("127.0.0.1", 0), _FakeReplicaHandler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    port = server.server_address[1]
    router = _router(health_interval=5.0, request_timeout=5.0,
                     retries=3, retry_delay=0.01, retry_cap=0.05,
                     breaker_failures=100)
    router2 = None
    try:
        router.add_replica("127.0.0.1", port, replica_id="fake")
        t0 = time.monotonic()
        with pytest.raises(urllib.error.HTTPError) as e:
            post(router.url, {"prompt": [1, 2], "steps": 4}, timeout=30)
        elapsed = time.monotonic() - t0
        assert e.value.code == 500
        body = json.loads(e.value.read().decode())
        assert body["error"]["attempts"] == 3
        assert body["error"]["tokens_generated"] == 7
        assert _FakeReplicaHandler.hits[0] == 3
        assert elapsed < 2.0
        assert router.stats.snapshot()["retries"] == 2
        router2 = _router(health_interval=5.0, request_timeout=0.5,
                          retries=10, retry_delay=0.4, retry_cap=0.4,
                          breaker_failures=100)
        router2.add_replica("127.0.0.1", port, replica_id="fake")
        before = _FakeReplicaHandler.hits[0]
        t0 = time.monotonic()
        with pytest.raises(urllib.error.HTTPError):
            post(router2.url, {"prompt": [1, 2], "steps": 4}, timeout=30)
        assert _FakeReplicaHandler.hits[0] - before < 4, \
            "kept retrying past the deadline"
        assert time.monotonic() - t0 < 1.5
    finally:
        if router2 is not None:
            router2.stop()
        router.stop()
        server.shutdown()
        server.server_close()


# -- fleet spawn fault point --------------------------------------------------

class _DummyHandle:
    def __init__(self, port):
        self.host = "127.0.0.1"
        self.port = port
        self.replica_id = "dummy%d" % port
        self.stopped = False

    def alive(self):
        return not self.stopped

    def stop(self):
        self.stopped = True


def test_fleet_spawn_retries_through_fault_point():
    """An injected spawn failure is retried with backoff until the
    replica comes up, a dead handle is respawned by the monitor, and
    spawn exhaustion raises."""
    from veles_tpu_torch.serving import Fleet
    spawned = []

    def spawn(index):
        handle = _DummyHandle(9000 + len(spawned))
        spawned.append(handle)
        return handle

    faults.inject("fleet.replica.spawn", "exception", times=1, key="0")
    fleet = Fleet(spawn, 2, router=None, monitor_interval=0.05,
                  spawn_retries=3, spawn_delay=0.01)
    t0 = time.monotonic()
    fleet.start()
    try:
        assert len(spawned) == 2
        assert time.monotonic() - t0 >= 0.01
        spawned[0].stopped = True
        deadline = time.monotonic() + 10
        while len(spawned) < 3:
            assert time.monotonic() < deadline, "no respawn"
            time.sleep(0.02)
        faults.inject("fleet.replica.spawn", "exception", key="9")
        bad = Fleet(lambda i: _DummyHandle(9999), 1, router=None,
                    spawn_retries=2, spawn_delay=0.01)
        with pytest.raises(faults.InjectedFault):
            bad._spawn_one(9)
    finally:
        fleet.stop()


# -- mid-stream failover ------------------------------------------------------

def read_sse(resp, on_frame=None):
    """One SSE response's frames ([DONE] excluded): (tokens, terminal
    frame, error frames); ``on_frame(payload, i)`` runs after each."""
    frames, data, i = [], None, 0
    while True:
        line = resp.readline()
        if not line:
            break
        line = line.rstrip(b"\r\n")
        if line.startswith(b"data: "):
            data = line[6:]
            continue
        if line or data is None:
            continue
        payload, data = data, None
        if payload == b"[DONE]":
            break
        obj = json.loads(payload.decode())
        frames.append(obj)
        if on_frame is not None:
            on_frame(obj, i)
        i += 1
    tokens = [f["token"] for f in frames if "token" in f]
    terminal = next((f for f in frames if "done" in f), None)
    return tokens, terminal, [f for f in frames if "error" in f]


def stream(url, payload, on_frame=None, timeout=60, headers=None):
    hdrs = {"Content-Type": "application/json"}
    hdrs.update(headers or {})
    req = urllib.request.Request(
        url + "/generate", data=json.dumps(dict(payload, stream=True))
        .encode(), headers=hdrs)
    resp = urllib.request.urlopen(req, timeout=timeout)
    try:
        return read_sse(resp, on_frame)
    finally:
        resp.close()


def test_stream_failover_resumes_bit_identical():
    """The pinned replica 'dies' under a token frame (the armed
    ``router.stream.replica_death``): the stream resumes on the peer
    with no error frame, greedy and seeded streams equal to an
    uninterrupted run; an unseeded sampled stream is truncated."""
    reps = [make_replica(serving_warm_buckets=False) for _ in range(2)]
    router = _router(request_timeout=60.0)
    try:
        for i, rep in enumerate(reps):
            router.add_replica(rep.host, rep.port, replica_id="fo%d" % i)
        for body in ({"prompt": [3, 1, 4], "steps": 8},
                     {"prompt": [3, 1, 4], "steps": 8,
                      "temperature": 0.8, "top_k": 4, "seed": 17}):
            _, want = post(router.url, body)
            before = dict(router.stats.snapshot()["stream_failovers"])
            faults.inject("router.stream.replica_death", "drop",
                          after=2, times=1)
            toks, terminal, errors = stream(router.url, body)
            assert not errors, errors
            assert terminal is not None \
                and terminal["tokens"] == want["tokens"], body
            assert toks == want["tokens"][len(body["prompt"]):]
            after = router.stats.snapshot()["stream_failovers"]
            assert after.get("resumed", 0) == before.get("resumed", 0) + 1
            faults.clear("router.stream.replica_death")
        faults.inject("router.stream.replica_death", "drop", after=1,
                      times=1)
        toks, terminal, errors = stream(
            router.url, {"prompt": [3, 1, 4], "steps": 6,
                         "temperature": 0.9})
        assert terminal is None or len(toks) == 6
        for rep in reps:
            rep.api.scheduler_.check_kv()
    finally:
        router.stop()
        for rep in reps:
            rep.stop()


def test_stream_failover_real_kill_and_respawn():
    """A real replica death under an open SSE connection: the router
    splices the continuation from the peer (no error frame, greedy
    tokens equal to the uninterrupted reply) and the fleet respawns the
    victim."""
    from veles_tpu_torch.serving import Fleet
    router = _router(request_timeout=60.0)
    fleet = Fleet(lambda index: make_replica(serving_warm_buckets=False),
                  2, router=router, monitor_interval=0.1).start()
    try:
        wait_healthy(router, 2)
        body = {"prompt": [3, 1, 4, 1], "steps": 10}
        _, want = post(router.url, body)
        faults.inject("serving.scheduler.step", "delay", arg=0.05)
        req = urllib.request.Request(
            router.url + "/generate",
            data=json.dumps(dict(body, stream=True)).encode(),
            headers={"Content-Type": "application/json"})
        resp = urllib.request.urlopen(req, timeout=60)
        pinned = resp.headers["X-Veles-Replica"]
        victim_idx = next(i for i in (0, 1)
                          if fleet.replica_id(i) == pinned)
        killed = []

        def on_frame(obj, i):
            if i == 2 and not killed:
                fleet.handles()[victim_idx].stop()
                killed.append(True)

        try:
            toks, terminal, errors = read_sse(resp, on_frame=on_frame)
        finally:
            resp.close()
        assert killed, "the kill hook never ran"
        assert not errors, errors
        assert terminal is not None and terminal["tokens"] == want["tokens"]
        assert toks == want["tokens"][4:]
        assert router.stats.snapshot()["stream_failovers"].get(
            "resumed", 0) >= 1
        deadline = time.monotonic() + 30
        while not (fleet.handles()[victim_idx]
                   and fleet.handles()[victim_idx].alive()):
            assert time.monotonic() < deadline, "no respawn"
            time.sleep(0.05)
        faults.clear()
        for handle in fleet.handles().values():
            handle.api.scheduler_.check_kv()
    finally:
        faults.clear()
        fleet.stop()
        router.stop()


def test_chaos_phase_matrix_zero_client_failures():
    """A replica killed (or severed) at every request phase — queued,
    mid-prefill, export-pending, mid-import, mid-stream — under a
    disaggregation-capable fleet: no client-visible failure, greedy
    replies equal to the reference, ``check_kv()`` clean."""
    mk = dict(serving_warm_buckets=False, serving_block_size=4,
              serving_prefill_chunk=4)
    both = make_replica(**mk)
    pre = make_replica(serving_role="prefill", **mk)
    dec = make_replica(serving_role="decode", **mk)
    router = _router(request_timeout=60.0)
    try:
        router.add_replica("127.0.0.1", both.port, replica_id="both")
        router.add_replica("127.0.0.1", pre.port, replica_id="pre")
        router.add_replica("127.0.0.1", dec.port, replica_id="dec")
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            state = {r["id"]: r for r in router.replica_state()["replicas"]}
            if state.get("pre", {}).get("role") == "prefill" \
                    and state.get("dec", {}).get("healthy") \
                    and state.get("both", {}).get("healthy"):
                break
            time.sleep(0.05)
        prompt = [3, 1, 4, 1, 5, 9, 2, 6]
        body = {"prompt": prompt, "steps": 8, "seed": 0}
        _, want = post(router.url, body)
        for point, action, kw, phase in (
                ("restful.generate", "http_error", {"arg": 500},
                 "queued"),
                ("serving.scheduler.prefill", "exception", {},
                 "mid-prefill"),
                ("disagg.export.fetch", "drop", {}, "export-pending"),
                ("serving.scheduler.kv_import", "exception", {},
                 "mid-import")):
            faults.inject(point, action, times=1, **kw)
            _, got = post(router.url, body)
            assert got["tokens"] == want["tokens"], phase
        faults.inject("router.stream.replica_death", "drop", after=1,
                      times=1)
        toks, terminal, errors = stream(router.url, body)
        assert not errors and terminal is not None, "mid-stream"
        assert terminal["tokens"] == want["tokens"], "mid-stream"
        for handle in (both, pre, dec):
            handle.api.scheduler_.check_kv()
    finally:
        router.stop()
        for handle in (both, pre, dec):
            handle.stop()


def test_role_rebalance_restores_decode_pool():
    """The only decode specialist of a prefill/prefill/decode fleet is
    killed with its respawn pinned failing: the monitor re-roles the
    highest surplus prefill replica into decode, and a client riding
    the shed 503s completes once coverage is back."""
    from veles_tpu_torch.serving import Fleet
    from veles_tpu_torch.telemetry import metrics
    rebalances = metrics.counter("veles_fleet_rebalances_total",
                                 labelnames=("role",))
    router = _router(request_timeout=60.0)

    def spawn(index, role):
        return make_replica(serving_warm_buckets=False,
                            serving_block_size=4, serving_prefill_chunk=4,
                            serving_role=role)

    fleet = Fleet(spawn, 3, router=router, monitor_interval=0.1,
                  spawn_retries=1, spawn_delay=0.01,
                  roles=("prefill", "prefill", "decode")).start()
    try:
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            roles = {r["id"]: r["role"] for r in
                     router.replica_state()["replicas"] if r["healthy"]}
            if sorted(roles.values()) == ["decode", "prefill", "prefill"]:
                break
            time.sleep(0.05)
        assert sorted(roles.values()) == ["decode", "prefill", "prefill"]
        body = {"prompt": [3, 1, 4, 1], "steps": 6, "seed": 0}
        _, want = post(router.url, body)
        before = rebalances.labels(role="decode").value
        faults.inject("fleet.replica.spawn", "exception", key="2")
        t_kill = time.monotonic()
        fleet.handles()[2].stop()
        result = {}

        def client():
            give_up = time.monotonic() + 50
            while time.monotonic() < give_up:
                try:
                    _, out = post(router.url, body, timeout=50)
                    result["tokens"] = out["tokens"]
                    result["t"] = time.monotonic()
                    return
                except urllib.error.HTTPError as e:
                    if e.code not in (502, 503):
                        result["error"] = e.code
                        return
                    time.sleep(0.1)
                except Exception:
                    time.sleep(0.1)

        t = threading.Thread(target=client)
        t.start()
        t.join(55)
        assert not t.is_alive() and "error" not in result, result
        assert result.get("tokens") == want["tokens"]
        assert rebalances.labels(role="decode").value > before
        assert fleet.role_of(1) == "decode"
        assert fleet.role_of(0) == "prefill"
        assert result["t"] - t_kill < 50
        for handle in fleet.handles().values():
            if handle is not None and handle.alive():
                handle.api.scheduler_.check_kv()
    finally:
        faults.clear()
        fleet.stop()
        router.stop()


# -- parity with the JAX fleet ------------------------------------------------

PARITY_PROMPTS = ([3, 1, 4], [5, 2], [7, 2, 9, 1], [2, 2, 8])
#: the breaker's cooldown in the parity episode: longer than a retried
#: request can take under a loaded test run, so the breaker is still
#: open when its state is read
PARITY_COOLDOWN = 5.0


def _drive_fleet(router_cls, fault_mod, metrics, reps):
    """The same scripted episode over either package's router: greedy
    replies to every prompt, then two injected 500s on the session's
    replica r0 that open r0's breaker (the request then lands on r1),
    then, past
    the cooldown, the probe that half-opens and closes it.  Returns
    the replies and r0's and r1's breaker transitions."""
    router = router_cls(health_interval=0.1, health_timeout=5.0,
                        request_timeout=60.0, retries=3,
                        retry_delay=0.02, retry_cap=0.2,
                        breaker_failures=2,
                        breaker_cooldown=PARITY_COOLDOWN).start()
    try:
        for i, rep in enumerate(reps):
            router.add_replica(rep.host, rep.port, replica_id="r%d" % i)
        wait_healthy(router, 2)
        before = {r: breaker_transitions(metrics, r) for r in ("r0", "r1")}
        replies = [post(router.url, {"prompt": p, "steps": 6})[1]["tokens"]
                   for p in PARITY_PROMPTS]
        aim = {"X-Veles-Session": session_for(["r0", "r1"], "r0")}
        fault_mod.inject("router.forward", "http_error", arg=500, times=2,
                         key="r0")
        served = []
        for p in PARITY_PROMPTS[:2]:
            h, out = post(router.url, {"prompt": p, "steps": 6},
                          headers=aim)
            replies.append(out["tokens"])
            served.append(h["X-Veles-Router-Attempts"])
        states = [r["breaker"] for r in router.replica_state()["replicas"]]
        opened = time.monotonic()
        time.sleep(PARITY_COOLDOWN + 0.3)
        assert time.monotonic() - opened >= PARITY_COOLDOWN
        h, out = post(router.url, {"prompt": PARITY_PROMPTS[2],
                                   "steps": 6}, headers=aim)
        replies.append(out["tokens"])
        after = {r: breaker_transitions(metrics, r) for r in ("r0", "r1")}
        deltas = {r: {to: after[r][to] - before[r][to] for to in after[r]}
                  for r in after}
        return replies, served, states, deltas
    finally:
        router.stop()


def test_fleet_matches_jax_fleet_under_the_same_faults():
    """A JAX fleet and a port fleet of two replicas each, on the same
    weights (the JAX chain's carried into the port), take the same
    requests and the same injected faults: equal greedy replies, equal
    attempt counts, equal breaker states and transitions."""
    from veles_tpu import faults as jax_faults
    from veles_tpu import prng as jax_prng
    from veles_tpu.config import root as jroot
    from veles_tpu.serving.router import Router as JaxRouter
    from veles_tpu.telemetry import metrics as jax_metrics
    from veles_tpu_torch.serving.router import Router
    from veles_tpu_torch.telemetry import metrics
    from tests.test_router import _make_replica
    from tests.test_torch_serving import _spec
    from tests.test_torch_transformer import port_chain
    saved = jroot.common.precision.get("compute_dtype", "bfloat16")
    jroot.common.precision.compute_dtype = "float32"
    jreps, preps = [], []
    try:
        with jax_prng.get().preserve_state():
            jreps = [_make_replica("parity-j%d" % i) for i in range(2)]
        fw = jreps[0].api.forwards
        preps = [make_replica(chain=port_chain(_spec(fw), fw))
                 for _ in range(2)]
        want = _drive_fleet(JaxRouter, jax_faults, jax_metrics, jreps)
        got = _drive_fleet(Router, faults, metrics, preps)
    finally:
        jroot.common.precision.compute_dtype = saved
        for rep in jreps + preps:
            rep.stop()
    assert got == want
    replies, attempts, states, deltas = got
    # the session retries on r0 until its breaker opens, then on r1
    assert attempts == ["3", "1"]
    assert states == ["open", "closed"]
    assert deltas["r0"] == {"open": 1, "half_open": 1, "closed": 1}
    assert deltas["r1"] == {"open": 0, "half_open": 0, "closed": 0}


# -- a replica process --------------------------------------------------------

def test_subprocess_replica_serves_the_command_line(cli_env):
    """``SubprocessReplica`` runs the port's serving command line
    (``python -m veles_tpu_torch samples/serve.py``) on an LM snapshot:
    the router registers it, its greedy replies equal ``generate`` on
    the snapshot's chain, and stopping the fleet ends the process."""
    import torch
    from tests.test_torch_cli import F32, port_sample, run_port
    from tests.test_torch_serve import LM_KEYS
    from veles_tpu_torch.models.generate import generate
    from veles_tpu_torch.serving import Fleet, SubprocessReplica, free_port
    from veles_tpu_torch.snapshotter import SnapshotterToFile
    run_port([port_sample("lm.py"), "-c", LM_KEYS, "-c", F32, "-a", "cpu"])
    snap = os.path.join(root.common.dirs.get("snapshots"),
                        "lm_current.pickle.gz")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [repo] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    procs = []

    def spawn(index):
        port = free_port()
        argv = [sys.executable, "-m", "veles_tpu_torch",
                port_sample("serve.py"), "-a", "cpu", "-c", F32,
                "-c", "root.serve.update({'snapshot': %r, 'port': %d, "
                "'max_wait': 0.05})" % (snap, port),
                "-c", "root.common.serving.update({'spec': False, "
                "'warm_buckets': False})"]
        handle = SubprocessReplica(argv, "127.0.0.1", port, env=env)
        procs.append(handle.proc)
        return handle

    router = _router(request_timeout=60.0)
    fleet = Fleet(spawn, 1, router=router, monitor_interval=0.5)
    try:
        fleet.start()
        wait_healthy(router, 1, timeout=60)
        _, out = post(router.url, {"prompt": [3, 1, 4], "steps": 8})
        chain = SnapshotterToFile.import_file(snap).gd.forwards
        for u in chain:
            u.to_device(torch.device("cpu"))
        want = generate(chain, torch.tensor([[3, 1, 4]]), 8)[0].tolist()
        assert out["tokens"] == want
        assert fleet.handles()[0].alive()
    finally:
        fleet.stop()
        router.stop()
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait(10)
    assert all(p.poll() is not None for p in procs)


def test_router_metrics_forget_a_retired_replica():
    """``RouterMetrics.forget_replica`` drops the router's series and
    every ``veles_serving_*{replica=...}`` child of the replica, as the
    reference's does."""
    from veles_tpu_torch.serving.metrics import RouterMetrics
    from veles_tpu_torch.telemetry import metrics
    rm = RouterMetrics()
    rm.record_replica_up("gone-r0", True)
    rm.record_breaker("gone-r0", "open")
    gauge = metrics.gauge("veles_serving_goodput_ratio", "x",
                          labelnames=("replica",))
    gauge.labels(replica="gone-r0").set(0.5)
    rm.forget_replica("gone-r0")
    assert ("gone-r0",) not in gauge.children()
    assert ("gone-r0",) not in metrics.get(
        "veles_router_replica_up").children()
    assert ("gone-r0",) not in metrics.get(
        "veles_router_breaker_state").children()
    # the fleet-tail SLO tracker reads root.common.slo
    assert rm.slo.scope == "router"
    assert rm.slo.target == root.common.slo.get("target")
    assert rm.snapshot()["requests_ok"] == 0
