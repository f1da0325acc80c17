"""Health-aware HTTP router over N serving replicas — the tier that
makes the fleet fail like a fleet instead of like its weakest process;
the port's own copy of ``veles_tpu/serving/router.py``.

One engine process (``restful_api.py`` + ``serving/scheduler.py``) is
both the availability and the throughput ceiling: a crash takes the
service down and there is no way to restart under live traffic.  The
:class:`Router` fronts N replicas and composes the primitives each
replica serves (``GET /healthz``, ``POST /drain``, structured
JSON errors with ``Retry-After``, the :mod:`veles_tpu_torch.faults`
registry) into fleet behavior:

- **health-aware routing** — a poll task GETs every replica's
  ``/healthz`` (and piggybacks ``/serving/metrics``) each
  ``health_interval``; replicas reporting ``"draining"`` or
  ``"halted"``, or unreachable twice in a row, leave the rotation
  without tripping a breaker.  Among eligible replicas the router
  picks **least-outstanding-requests**, with optional prompt-prefix /
  session **affinity** (rendezvous hash over the first
  ``affinity_tokens`` prompt tokens, or the ``X-Veles-Session``
  header) so repeated prompts land on the replica already holding
  their KV blocks;
- **circuit breakers** — per replica: ``closed`` → ``open`` after
  ``breaker_failures`` consecutive transport failures/timeouts/5xx;
  after ``breaker_cooldown`` the breaker goes ``half_open`` and
  admits a SINGLE probe request — success (any HTTP reply, 503
  included: backpressure proves liveness) closes it, failure
  re-opens.  State rides ``veles_router_breaker_state{replica}``;
- **retries** — a failed attempt (connection error, timeout, 5xx)
  retries on another replica under a per-request budget
  (``retries`` total attempts) with capped exponential backoff plus
  jitter (the coordinator ``_backoff`` shape), never past the
  request deadline; when every attempt fails, the reply propagates
  ``tokens_generated`` from the best attempt so the client knows
  what its budget bought;
- **hedging** — for idempotent requests only (greedy, or seeded
  sampling: the reply is the same whichever replica answers), a
  straggling primary attempt is hedged once against a second replica
  after ``hedge_delay`` seconds; the first deliverable reply wins
  and the loser is cancelled (0 disables);
- **load shedding** — once no replica is eligible (all open,
  draining, unhealthy or saturated) the router answers a structured
  503 with ``Retry-After`` instead of queueing unbounded;
- **rolling restarts** — :meth:`drain_replica` marks the replica
  draining router-side FIRST (no new traffic — explicitly NOT a
  breaker trip), then POSTs ``/drain`` (with the
  ``root.common.api.admin_token`` bearer when configured, so remote
  replicas accept it); :class:`veles_tpu_torch.serving.fleet.Fleet`
  orchestrates drain → wait drained → restart → re-admit over the
  whole fleet with zero failed client requests.

- **streaming + the OpenAI facade** — ``POST /generate`` /
  ``/v1/completions`` bodies with ``"stream": true`` proxy as SSE
  **frame by frame**.  Replayable ``/generate`` streams (single
  row, greedy or seed-pinned) get **transparent mid-stream
  failover**: the router records the body and every token frame it
  forwarded, and when the pinned replica dies or errors mid-stream
  it resubmits through the replica ``resume_tokens`` lane — the
  continuation re-prefills prompt + prefix, samples at draw counter
  ``len(forwarded)`` and splices into the open connection
  bit-identical to an uninterrupted run, with zero client-visible
  error frames (``veles_router_stream_failovers_total{outcome}``).
  Non-replayable streams (multi-row, unseeded sampling, the /v1
  facade) keep the pin-and-truncate contract; hedging never arms
  for streams.  A client that disconnects mid-stream tears down the
  upstream connection — the active leg AND any resume in flight —
  which cancels the request on the replica and frees its KV blocks.
  ``/v1/completions``, ``/v1/embeddings``, ``/v1/classify`` and
  ``GET /v1/models`` forward with the same affinity/retry/breaker
  machinery as ``/generate``.

- **cache-topology routing + prefix shipping** — each
  metrics poll carries the replica's ``prefix_digests``
  advertisement (rolling crc32 path digests of every resident
  prefix, device trie + host tier).  For single-row ``/generate``
  bodies the router computes the prompt's own digests and routes to
  the replica holding the LONGEST resident prefix — an upgrade over
  blind crc32 affinity, which spreads identical prompts by hash
  regardless of who is actually warm.  When a PEER holds a prefix
  ``prefix_fetch_min`` blocks longer than the chosen target's, the
  router first SHIPS it: ``POST /serving/prefix_export`` on the
  peer (binary KV wire, ``application/x-veles-kv``) → ``POST
  /serving/prefix_import`` on the target — so one replica's warm
  cache seeds another's and a drained replica's warmth is rescued
  before it dies.  Both steps are best-effort: any failure counts
  ``veles_router_prefix_peer_fetch_fails_total`` and the request
  proceeds cold.  Fault point ``router.prefix.fetch`` (keyed by the
  holder id) injects exactly the peer-death window.

- **request tracing + SLOs** — every request gets a trace id at the
  edge (``X-Veles-Trace``, accepted-or-minted, echoed on EVERY reply
  including structured errors) that is propagated to the replica; the
  routed request is a ``router.request`` span and each retry/hedge
  attempt a ``router.attempt`` child span in the JSONL event sink
  (merge with the replica logs via ``telemetry.trace_export
  --request <id>``).  ``GET /debug/requests`` lists the live
  in-flight proxy table, and ``/router/state`` carries the fleet-tail
  SLO block (per-class e2e good/bad + multi-window burn rates,
  ``root.common.slo.*``).

Fault points ``router.forward`` and ``router.replica.health`` (keyed
by replica id) wire the router into the injection registry; they run
in the executor so a ``hang``/``delay`` stalls one attempt, not the
event loop.  Everything is asyncio on ONE background loop thread —
replica state is only ever mutated there, so routing decisions need
no locks; public entry points marshal through the loop.

Config: ``root.common.router.*`` (every knob also a constructor
kwarg); see ``config.py`` for the full table.
"""

import asyncio
import itertools
import json
import random
import threading
import time
import zlib

from veles_tpu_torch import faults
from veles_tpu_torch.logger import Logger, events
from veles_tpu_torch.serving.disagg import WIRE_CONTENT_TYPE
from veles_tpu_torch.serving.metrics import RouterMetrics
from veles_tpu_torch.serving.prefix_cache import chunk_digests
from veles_tpu_torch.telemetry import reqtrace
from veles_tpu_torch.telemetry.spans import next_span_id
from veles_tpu_torch.tenant import TenantAdmission

#: outcomes the router hands to the client as-is (2xx/3xx/4xx — the
#: replica spoke; 5xx and transport errors are the router's to mask)
_DELIVERABLE_BELOW = 500


def _router_conf(name, default):
    from veles_tpu_torch.config import root
    return root.common.router.get(name, default)


class _Replica(object):
    """Router-side view of one replica.  Mutated ONLY on the router's
    event-loop thread (the no-locks invariant of this module)."""

    __slots__ = ("id", "host", "port", "outstanding", "healthy",
                 "status", "draining", "marked_draining",
                 "health_failures", "breaker", "failures",
                 "opened_at", "probing", "saturated_until",
                 "last_health", "last_metrics", "requests", "role",
                 "last_scrape", "scrape_failed", "prefix_digests")

    def __init__(self, replica_id, host, port):
        self.id = str(replica_id)
        self.host = host
        self.port = int(port)
        self.role = "both"        # /healthz advertises the real one
        self.outstanding = 0      # in-flight forwards (routing load)
        self.healthy = False      # until the first probe passes
        self.status = "unknown"
        self.draining = False     # healthz said so (or marked below)
        self.marked_draining = False  # router-initiated drain latch
        self.health_failures = 0  # consecutive failed probes
        self.breaker = "closed"   # closed | open | half_open
        self.failures = 0         # consecutive forward failures
        self.opened_at = 0.0
        self.probing = False      # the half-open single probe is out
        self.saturated_until = 0.0  # 503 Retry-After backoff window
        self.last_health = None
        self.last_metrics = None
        self.last_scrape = None   # latest /metrics exposition text
        self.scrape_failed = False
        #: cache-topology advertisement off the last metrics poll:
        #: rolling digests of every prefix resident on the replica
        #: (device trie + host tier) — the routing warmth signal
        self.prefix_digests = frozenset()
        self.requests = 0

    def view(self):
        return {
            "id": self.id, "host": self.host, "port": self.port,
            "healthy": self.healthy, "status": self.status,
            "role": self.role,
            "tp": (self.last_health or {}).get("tp"),
            "draining": self.draining, "breaker": self.breaker,
            "outstanding": self.outstanding,
            "requests": self.requests,
            "consecutive_failures": self.failures,
            "queue_depth": (self.last_metrics or {}).get(
                "queue_depth"),
            # slot occupancy (the controller's scale-down and
            # role-ratio signals read these off replica_state())
            "active_slots": (self.last_metrics or {}).get(
                "active_slots"),
            "max_slots": (self.last_metrics or {}).get(
                "max_slots"),
            "kv_blocks_used": (self.last_metrics or {}).get(
                "kv_blocks_used"),
            "kv_blocks_free": (self.last_metrics or {}).get(
                "kv_blocks_free"),
            # goodput accounting: real throughput + how much of each
            # padded batch carried requests (the dashboard columns)
            "goodput_tokens_per_sec": (self.last_metrics or {}).get(
                "goodput_tokens_per_sec"),
            "bucket_padding_efficiency": (
                self.last_metrics or {}).get(
                "bucket_padding_efficiency"),
            # the observable payoff of prefix/session affinity: a
            # well-aimed router keeps this high on repeat traffic
            "prefix_hit_rate": (self.last_metrics or {}).get(
                "prefix_cache_hit_rate"),
            # tiered-KV topology: how much warmth the replica
            # advertises, and how much of it lives in host RAM
            "prefix_digests": len(self.prefix_digests),
            "kv_host_blocks": (self.last_metrics or {}).get(
                "kv_host_blocks"),
            "spec_accept_rate": (self.last_metrics or {}).get(
                "spec_accept_rate"),
            # per-priority-class QoS counters (TTFT p95, preempts,
            # sheds by class) straight off /serving/metrics — the
            # observable half of preemptive scheduling
            "classes": (self.last_metrics or {}).get("classes"),
        }


class _Outcome(object):
    """One normalized forward attempt: either a replica reply
    (``status``/``headers``/``body``) or a transport ``error``."""

    __slots__ = ("rep", "status", "headers", "body", "error")

    def __init__(self, rep, status=None, headers=None, body=b"",
                 error=None):
        self.rep = rep
        self.status = status
        self.headers = headers or {}
        self.body = body
        self.error = error

    @property
    def deliverable(self):
        return self.error is None and self.status < _DELIVERABLE_BELOW

    def tokens_generated(self):
        """The partial-decode count a failed attempt's structured
        error body carried (408/5xx material), else None."""
        try:
            err = json.loads(self.body.decode()).get("error", {})
            return int(err["tokens_generated"])
        except Exception:
            return None


class Router(Logger):
    """Asyncio HTTP router over N serving replicas (module docstring
    has the behavior contract).  ``start()`` binds and returns self;
    ``add_replica``/``remove_replica``/``drain_replica`` are
    thread-safe; ``stop()`` tears the loop down."""

    def __init__(self, host="127.0.0.1", port=0, replicas=(),
                 health_interval=None, health_timeout=None,
                 breaker_failures=None, breaker_cooldown=None,
                 retries=None, retry_delay=None, retry_cap=None,
                 hedge_delay=None, affinity_tokens=None,
                 request_timeout=None, shed_retry_after=None,
                 prefix_routing=None, prefix_fetch=None,
                 prefix_fetch_min=None):
        super(Router, self).__init__()
        self.host = host
        self.port = int(port)
        self.health_interval = float(
            _router_conf("health_interval", 0.5)
            if health_interval is None else health_interval)
        self.health_timeout = float(
            _router_conf("health_timeout", 1.0)
            if health_timeout is None else health_timeout)
        self.breaker_failures = int(
            _router_conf("breaker_failures", 3)
            if breaker_failures is None else breaker_failures)
        self.breaker_cooldown = float(
            _router_conf("breaker_cooldown", 2.0)
            if breaker_cooldown is None else breaker_cooldown)
        self.retries = int(_router_conf("retries", 3)
                           if retries is None else retries)
        self.retry_delay = float(_router_conf("retry_delay", 0.05)
                                 if retry_delay is None
                                 else retry_delay)
        self.retry_cap = float(_router_conf("retry_cap", 2.0)
                               if retry_cap is None else retry_cap)
        self.hedge_delay = float(_router_conf("hedge_delay", 0.0)
                                 if hedge_delay is None
                                 else hedge_delay)
        self.affinity_tokens = int(
            _router_conf("affinity_tokens", 16)
            if affinity_tokens is None else affinity_tokens)
        if request_timeout is None:
            request_timeout = _router_conf("request_timeout", None)
        if request_timeout is None:
            from veles_tpu_torch.config import root
            request_timeout = root.common.serving.get(
                "request_timeout", 120.0)
        self.request_timeout = float(request_timeout or 120.0)
        self.shed_retry_after = int(
            _router_conf("shed_retry_after", 2)
            if shed_retry_after is None else shed_retry_after)
        #: tiered-KV topology: route /generate on the
        #: longest advertised resident prefix instead of blind crc32
        #: affinity, and ship a peer's longer prefix onto the target
        #: when it leads by >= prefix_fetch_min blocks
        self.prefix_routing = bool(
            _router_conf("prefix_routing", True)
            if prefix_routing is None else prefix_routing)
        self.prefix_fetch = bool(
            _router_conf("prefix_fetch", True)
            if prefix_fetch is None else prefix_fetch)
        self.prefix_fetch_min = int(
            _router_conf("prefix_fetch_min", 2)
            if prefix_fetch_min is None else prefix_fetch_min)
        self.stats = RouterMetrics()
        #: per-tenant identity + admission (tenant/admission.py):
        #: tagging is always on, the bucket/lane enforce only when
        #: root.common.tenant.enabled
        self.tenants = TenantAdmission()
        #: the router-tier alert engine (telemetry/alerts.py),
        #: created at start() when root.common.alerts.enabled
        self.alerts = None
        #: the router-tier history store (telemetry/tsdb.py),
        #: created at start() when root.common.tsdb.enabled — its
        #: ticker samples the FEDERATED merge, so fleet-wide history
        #: survives replica churn (a dead replica's counted work
        #: stays in the buckets it landed in)
        self.tsdb = None
        #: request tracing (telemetry/reqtrace.py), read once — the
        #: per-attempt gate is an attribute test
        self._tron = reqtrace.enabled()
        self._seed_replicas = [tuple(r) for r in replicas]
        self._replicas = {}        # id -> _Replica (loop thread only)
        self._inflight = {}        # seq -> live request info (loop
        #                            thread only, like _replicas)
        self._req_seq = itertools.count(1)
        self._lock = threading.Lock()
        self._loop = None
        self._thread = None
        self._server = None
        self._health_task = None
        self._ready = threading.Event()

    # -- lifecycle -------------------------------------------------------

    def start(self):
        with self._lock:  # two racing start()s must not spawn 2 loops
            if self._thread is not None:
                self._ready.wait(60)
                return self
            self._loop = asyncio.new_event_loop()
            self._thread = threading.Thread(
                target=self._loop.run_forever, daemon=True,
                name="serving-router")
        self._thread.start()
        asyncio.run_coroutine_threadsafe(
            self._bind(), self._loop).result(60)
        for spec in self._seed_replicas:
            self.add_replica(*spec)
        self._ready.set()
        # flight-recorder / debug surface (weakly held)
        reqtrace.register("router", self)
        from veles_tpu_torch.config import root
        if root.common.tsdb.get("enabled", True):
            from veles_tpu_torch.telemetry.tsdb import TimeSeriesStore

            def _fleet_collect():
                # the store's ticker thread marshals onto the router
                # loop for the merge; a stopped/stopping router just
                # yields an empty sample instead of raising forever
                try:
                    return self._call(self._fleet_async())
                except Exception:
                    return []
            self.tsdb = TimeSeriesStore(
                name="router", collect=_fleet_collect).start()
        if root.common.alerts.get("enabled", True):
            from veles_tpu_torch.telemetry.alerts import AlertEngine
            # no providers: GET /alerts is answered ON the router
            # loop, and a provider marshalling back into that loop
            # (replica_state) would deadlock the handler.  The trend
            # rules read the router's own store — fleet-merged
            # history, not any single replica's
            self.alerts = AlertEngine(name="router",
                                      tsdb=self.tsdb).start()
        self.info("router on http://%s:%d -> %d replica(s)",
                  self.host, self.port, len(self._seed_replicas))
        return self

    async def _bind(self):
        self._server = await asyncio.start_server(
            self._serve_conn, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        self._health_task = asyncio.ensure_future(self._health_loop())

    def stop(self):
        if self.tsdb is not None:
            self.tsdb.stop()
        if self.alerts is not None:
            self.alerts.stop()
        with self._lock:
            loop, self._loop = self._loop, None
            thread, self._thread = self._thread, None
        if loop is None:
            return
        asyncio.run_coroutine_threadsafe(
            self._shutdown(), loop).result(30)
        loop.call_soon_threadsafe(loop.stop)
        if thread is not None:
            thread.join(30)
        loop.close()

    async def _shutdown(self):
        if self._health_task is not None:
            self._health_task.cancel()
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()

    @property
    def url(self):
        return "http://%s:%d" % (self.host, self.port)

    def _call(self, coro):
        """Run a coroutine on the router loop from any thread."""
        with self._lock:
            loop = self._loop
        if loop is None:
            raise RuntimeError("router is not running")
        return asyncio.run_coroutine_threadsafe(coro, loop).result(60)

    # -- replica registry ------------------------------------------------

    def add_replica(self, host, port, replica_id=None):
        """Register a replica and probe it once (so a freshly started
        healthy replica is routable without waiting out a poll
        period).  Returns the replica id."""
        rid = str(replica_id or "%s:%d" % (host, int(port)))
        return self._call(self._add(rid, host, int(port)))

    async def _add(self, rid, host, port):
        rep = _Replica(rid, host, port)
        self._replicas[rid] = rep
        self.stats.record_breaker(rid, "closed")
        await self._probe(rep)
        return rid

    def remove_replica(self, replica_id):
        """Deregister (a stopped/dead replica); in-flight forwards to
        it finish or fail on their own."""
        return self._call(self._remove(str(replica_id)))

    async def _remove(self, rid):
        gone = self._replicas.pop(rid, None) is not None
        if gone:
            # drop the labeled series so a deregistered replica's
            # replica_up=0 cannot keep an unreachable alert firing
            self.stats.forget_replica(rid)
        return gone

    def replica_state(self):
        """Monitoring snapshot: per-replica view + router counters."""
        return self._call(self._state())

    async def _state(self):
        return {
            "replicas": [r.view() for r in self._replicas.values()],
            "eligible": len(self._pickable(time.monotonic())),
            "router": self.stats.snapshot(),
        }

    def drain_replica(self, replica_id, timeout=30.0):
        """Begin draining one replica for a rolling restart: the
        router stops routing to it IMMEDIATELY (a drain is not a
        breaker trip), then POSTs ``/drain`` (bearer admin token when
        configured).  Returns the replica's drain reply dict."""
        return self._call(self._drain(str(replica_id), timeout))

    async def _drain(self, rid, timeout):
        rep = self._replicas.get(rid)
        if rep is None:
            raise KeyError("unknown replica %r" % rid)
        rep.marked_draining = rep.draining = True
        self.stats.record_drain(rid)
        headers = {}
        from veles_tpu_torch.config import root
        token = root.common.api.get("admin_token", None)
        if token:
            headers["Authorization"] = "Bearer %s" % token
        status, _, body = await asyncio.wait_for(
            self._http(rep, "POST", "/drain", b"{}", headers),
            timeout)
        if status >= 400:
            raise RuntimeError("drain of %s failed: HTTP %d" %
                               (rid, status))
        return json.loads(body.decode() or "{}")

    # -- routing ---------------------------------------------------------

    def _eligible(self, rep, now):
        if rep.draining or not rep.healthy:
            return False
        if now < rep.saturated_until:
            return False
        if rep.breaker == "open":
            if now - rep.opened_at < self.breaker_cooldown:
                return False
            self._breaker_to(rep, "half_open")
        if rep.breaker == "half_open" and rep.probing:
            return False  # single probe at a time
        return True

    @staticmethod
    def _serves(rep, phase):
        """Role gate for one dispatch phase: DECODE-phase traffic
        (client /generate and the /v1 facade) never lands on a
        prefill specialist — it would answer 409 — and PREFILL-phase
        traffic (the disaggregated first hop) never lands on a
        decode specialist."""
        if phase == "prefill":
            return rep.role in ("prefill", "both")
        return rep.role in ("decode", "both")

    def _pickable(self, now, exclude=(), phase="decode"):
        return [r for r in self._replicas.values()
                if r.id not in exclude and self._serves(r, phase)
                and self._eligible(r, now)]

    @staticmethod
    def _prompt_row(raw):
        """The single prompt row of a /generate body as an int list,
        or None when the body is not topology-routable (multi-row,
        non-token prompt, malformed — those keep the affinity
        path)."""
        try:
            body = json.loads(raw.decode() or "{}")
        except Exception:
            return None
        prompt = body.get("prompt")
        if not isinstance(prompt, list) or not prompt:
            return None
        if isinstance(prompt[0], list):
            if len(prompt) != 1:
                return None  # batch rows share one replica anyway
            row = prompt[0]
        else:
            row = prompt
        if not row or not all(
                isinstance(t, int) and not isinstance(t, bool)
                for t in row):
            return None
        return row

    @staticmethod
    def _match_depth(rep, row, memo):
        """How many leading block chunks of prompt ``row`` the
        replica advertises as resident (device trie + host tier).
        ``memo`` caches the prompt's digests per block size across
        one request's replica comparisons.  A digest is a 32-bit
        HINT — the replica re-verifies tokens on admission, so an
        overcount here costs a miss, never wrong KV."""
        if not rep.prefix_digests:
            return 0
        bs = (rep.last_metrics or {}).get("kv_block_size")
        if not bs:
            return 0
        bs = int(bs)
        digs = memo.get(bs)
        if digs is None:
            digs = memo[bs] = chunk_digests(row, bs)
        n = 0
        for d in digs:
            if d not in rep.prefix_digests:
                break
            n += 1
        return n

    def _pick(self, affinity, now, exclude=(), phase="decode",
              row=None, memo=None):
        """Choose the attempt's replica: a half-open breaker's probe
        first (recovery must not wait for idle), then the replica
        advertising the longest resident prefix of ``row`` (when
        prefix routing supplied one), then the affinity target, then
        least-outstanding (ties by id for determinism)."""
        candidates = self._pickable(now, exclude, phase)
        if not candidates:
            return None
        half = [r for r in candidates if r.breaker == "half_open"]
        if half:
            rep = min(half, key=lambda r: r.id)
            rep.probing = True
            return rep
        if row is not None:
            warm = min(candidates,
                       key=lambda r: (-self._match_depth(r, row, memo),
                                      r.outstanding, r.id))
            if self._match_depth(warm, row, memo) > 0:
                return warm
        if affinity is not None:
            # rendezvous hash over the FULL registry (stable under
            # breaker flaps), honored only when the owner is eligible
            owner = max(
                self._replicas.values(),
                key=lambda r: zlib.crc32(
                    ("%s|%s" % (affinity, r.id)).encode()))
            if owner in candidates:
                return owner
        return min(candidates, key=lambda r: (r.outstanding, r.id))

    def _breaker_to(self, rep, state):
        if rep.breaker == state:
            return
        rep.breaker = state
        rep.probing = False
        if state == "open":
            rep.opened_at = time.monotonic()
        self.stats.record_breaker(rep.id, state)
        self.info("replica %s breaker -> %s", rep.id, state)

    def _breaker_failure(self, rep):
        rep.failures += 1
        rep.probing = False
        if rep.breaker == "half_open" \
                or rep.failures >= self.breaker_failures:
            self._breaker_to(rep, "open")

    def _breaker_success(self, rep):
        if rep.breaker == "open":
            # a stale success from an attempt launched BEFORE the
            # trip: the documented machine leaves `open` only via
            # cooldown → half_open probe, so a late reply must not
            # short-circuit recovery (it proves the replica was
            # alive THEN, not that it recovered)
            return
        rep.failures = 0
        if rep.breaker != "closed":
            self._breaker_to(rep, "closed")

    def _backoff(self, attempt):
        """Delay before retry ``attempt`` (1-based): exponential from
        ``retry_delay``, capped at ``retry_cap``, half-window jitter
        (the coordinator reconnect shape — fleet retries must
        decorrelate)."""
        base = min(self.retry_cap,
                   self.retry_delay * (2 ** (attempt - 1)))
        return base * (0.5 + 0.5 * random.random())

    def _inspect(self, raw, headers):
        """(idempotent, affinity_key, stream, cls) for a forwarded
        body (/generate and the /v1 facade).  Greedy and seed-pinned
        requests are idempotent (any replica answers the same
        tokens; embeddings/classify always are); the affinity key is
        the session header or the first ``affinity_tokens`` prompt
        tokens; ``stream`` marks SSE bodies for the pinning proxy;
        ``cls`` is the priority class name (SLO accounting — the
        replica still authoritatively validates it)."""
        try:
            body = json.loads(raw.decode() or "{}")
            prompt = body.get("prompt")
            if prompt is None:
                prompt = body.get("input")
        except Exception:
            return False, None, False, "normal"  # replica will 400 it
        idempotent = not float(body.get("temperature") or 0.0) \
            or body.get("seed") is not None
        affinity = headers.get("x-veles-session")
        if affinity is None and self.affinity_tokens > 0 \
                and isinstance(prompt, list) and prompt:
            row = prompt[0] if isinstance(prompt[0], list) else prompt
            affinity = repr(row[:self.affinity_tokens])
        prio = body.get("priority")
        if isinstance(prio, int) and not isinstance(prio, bool) \
                and 0 <= prio <= 2:
            cls = ("low", "normal", "high")[prio]
        elif isinstance(prio, str) \
                and prio.lower() in ("low", "normal", "high"):
            cls = prio.lower()
        else:
            cls = "normal"
        return idempotent, affinity, bool(body.get("stream")), cls

    async def _attempt(self, rep, raw, headers, timeout,
                       path="/generate", method="POST", trace=None,
                       attempt=0, hedge=False):
        """One forward, normalized to an :class:`_Outcome`, with the
        breaker/metrics accounting applied.  Each attempt — retries
        and hedges alike — is its OWN child span (``router.attempt``
        begin/end pair carrying the trace id, attempt number and
        replica), so the merged Chrome trace shows exactly which
        replica each leg of a retried request ran on."""
        async def _payload():
            # executor: an armed hang/delay stalls this attempt (and
            # times out below like any straggler), not the event loop
            dropped = await asyncio.get_running_loop() \
                .run_in_executor(None, faults.fire,
                                 "router.forward", rep.id)
            if dropped:
                raise ConnectionError("injected forward drop")
            return await self._http(
                rep, method, path,
                raw if method == "POST" else None,
                {k: v for k, v in headers.items()
                 if k in ("x-veles-session", "x-veles-trace",
                          "x-veles-tenant")})

        span = None
        if self._tron and trace is not None:
            span = next_span_id()
            events.record("router.attempt", "begin", cls="Router",
                          span=span, trace=trace, attempt=attempt,
                          replica=rep.id, hedge=hedge)
        t0 = time.monotonic()
        rep.outstanding += 1
        rep.requests += 1
        try:
            try:
                status, rheaders, rbody = await asyncio.wait_for(
                    _payload(), timeout)
                out = _Outcome(rep, status, rheaders, rbody)
            except faults.InjectedHTTPError as e:
                # a replica that REPLIES an error (http_error action)
                out = _Outcome(rep, e.status, {}, json.dumps(
                    {"error": {"code": e.status, "message": str(e),
                               "injected": True,
                               "trace_id": trace}}).encode())
            except asyncio.CancelledError:
                if span is not None:
                    events.record("router.attempt", "end",
                                  cls="Router", span=span,
                                  trace=trace, attempt=attempt,
                                  replica=rep.id, hedge=hedge,
                                  duration=time.monotonic() - t0,
                                  outcome="cancelled")
                raise
            except Exception as e:
                out = _Outcome(rep, error=e)
        finally:
            rep.outstanding -= 1
        if span is not None:
            events.record("router.attempt", "end", cls="Router",
                          span=span, trace=trace, attempt=attempt,
                          replica=rep.id, hedge=hedge,
                          duration=time.monotonic() - t0,
                          status=out.status,
                          outcome="ok" if out.error is None
                          else type(out.error).__name__)
        now = time.monotonic()
        if out.error is not None \
                or (out.status >= 500 and out.status != 503):
            self._breaker_failure(rep)
        else:
            # any reply proves liveness — 503 is backpressure, not a
            # fault; park the replica for its Retry-After instead
            self._breaker_success(rep)
            if out.status == 503:
                try:
                    after = float(out.headers.get("retry-after", 1))
                except ValueError:
                    after = 1.0
                rep.saturated_until = now + min(after, 5.0)
        self.stats.record_forward(rep.id, out.deliverable,
                                  tenant=headers.get(
                                      "x-veles-tenant"))
        return out

    async def _attempt_hedged(self, rep, raw, headers, timeout,
                              idempotent, now, path="/generate",
                              method="POST", trace=None, attempt=0):
        """The primary attempt, hedged once against a second replica
        when the primary straggles past ``hedge_delay`` and the
        request is idempotent.  Returns the winning outcome (a
        deliverable one when either attempt produced it)."""
        primary = asyncio.ensure_future(
            self._attempt(rep, raw, headers, timeout, path=path,
                          method=method, trace=trace,
                          attempt=attempt))
        if not idempotent or self.hedge_delay <= 0 \
                or not self._pickable(now, exclude=(rep.id,)):
            return await primary
        done, _ = await asyncio.wait({primary},
                                     timeout=self.hedge_delay)
        if primary in done:
            return primary.result()
        rep2 = self._pick(None, time.monotonic(),
                          exclude=(rep.id,))
        if rep2 is None:
            return await primary
        self.stats.record_hedge()
        hedge = asyncio.ensure_future(
            self._attempt(rep2, raw, headers, timeout, path=path,
                          method=method, trace=trace,
                          attempt=attempt, hedge=True))
        pending = {primary, hedge}
        best = None
        while pending:
            done, pending = await asyncio.wait(
                pending, return_when=asyncio.FIRST_COMPLETED)
            for task in done:
                out = task.result()
                if out.deliverable:
                    for p in pending:
                        p.cancel()
                    if task is hedge:
                        self.stats.record_hedge_win()
                    return out
                best = out
        return best

    async def _forward_request(self, path, raw, headers,
                               method="POST", trace=None):
        """The data-plane path (non-streaming): pick → attempt
        (hedged) → classify → retry/shed, all bounded by the request
        deadline.  The whole routed request is a ``router.request``
        span parenting one ``router.attempt`` span per try, and it
        sits in the live in-flight table (``GET /debug/requests``)
        until answered."""
        t0 = time.monotonic()
        deadline = t0 + self.request_timeout
        idempotent, affinity, _, cls = self._inspect(raw, headers)
        tenant = headers.get("x-veles-tenant")
        if method == "GET":
            idempotent = True
        root_span = None
        if self._tron and trace is not None:
            root_span = next_span_id()
            events.record("router.request", "begin", cls="Router",
                          span=root_span, trace=trace, path=path,
                          tenant=tenant)
        seq = next(self._req_seq)
        info = {"trace": trace, "path": path, "t0": t0,
                "attempts": 0, "replica": None, "stream": False,
                "cls": cls, "tenant": tenant}
        self._inflight[seq] = info
        # cache-topology routing: only single-row token /generate
        # bodies carry a routable prefix; everything else keeps the
        # affinity path untouched
        row = self._prompt_row(raw) if self.prefix_routing \
            and method == "POST" and path == "/generate" else None
        try:
            return await self._forward_attempts(
                path, raw, headers, method, trace, t0, deadline,
                idempotent, affinity, cls, info, row=row)
        finally:
            self._inflight.pop(seq, None)
            if root_span is not None:
                events.record("router.request", "end", cls="Router",
                              span=root_span, trace=trace, path=path,
                              tenant=tenant,
                              duration=time.monotonic() - t0,
                              attempts=info["attempts"])

    async def _forward_attempts(self, path, raw, headers, method,
                                trace, t0, deadline, idempotent,
                                affinity, cls, info, row=None):
        best_tokens = None
        last = None
        attempts = 0
        memo = {}
        while attempts < self.retries:
            now = time.monotonic()
            if now >= deadline:
                break
            rep = self._pick(affinity, now, row=row, memo=memo)
            if rep is None:
                break  # fleet-level shed (or nothing left to try)
            attempts += 1
            info["attempts"] = attempts
            info["replica"] = rep.id
            if attempts > 1:
                self.stats.record_retry()
            elif row is not None and self.prefix_fetch:
                # first attempt only: ship a peer's longer resident
                # prefix onto the chosen replica before forwarding
                # (best-effort — a failed fetch just admits cold)
                await self._maybe_prefix_fetch(
                    rep, row, memo, trace, deadline)
            out = await self._attempt_hedged(
                rep, raw, headers, deadline - now, idempotent, now,
                path=path, method=method, trace=trace,
                attempt=attempts)
            if out.deliverable:
                self.stats.record_request(
                    (time.monotonic() - t0) * 1e3, cls=cls)
                rheaders = {
                    "Content-Type": out.headers.get(
                        "content-type", "application/json"),
                    "X-Veles-Router-Attempts": str(attempts)}
                if trace is not None:
                    rheaders["X-Veles-Trace"] = trace
                if "x-veles-replica" in out.headers:
                    rheaders["X-Veles-Replica"] = \
                        out.headers["x-veles-replica"]
                else:
                    rheaders["X-Veles-Replica"] = out.rep.id
                if "retry-after" in out.headers:
                    rheaders["Retry-After"] = \
                        out.headers["retry-after"]
                return out.status, rheaders, out.body
            last = out
            toks = out.tokens_generated()
            if toks is not None:
                best_tokens = max(best_tokens or 0, toks)
            delay = self._backoff(attempts)
            if time.monotonic() + delay >= deadline:
                break
            await asyncio.sleep(delay)
        # every attempt failed (or none was possible) — shed/report
        self.stats.record_request((time.monotonic() - t0) * 1e3,
                                  cls=cls)
        if last is None:
            self.stats.record_shed()
            return self._error(
                503, "no eligible replica (fleet saturated, "
                "draining or open)", retry_after=self.shed_retry_after,
                attempts=attempts, shed=True, trace=trace)
        if last.error is not None:
            return self._error(
                502, "replica unreachable after %d attempt(s): %s"
                % (attempts, last.error), attempts=attempts,
                tokens_generated=best_tokens, trace=trace)
        return self._error(
            last.status, "replica error after %d attempt(s)"
            % attempts,
            retry_after=self.shed_retry_after
            if last.status == 503 else None,
            attempts=attempts, tokens_generated=best_tokens,
            trace=trace)

    async def _http_begin(self, rep, method, path, body,
                          headers=None):
        """Open a replica request and return after the response
        HEADERS arrive, leaving the body unread on the connection —
        the streaming proxy's handle: ``(reader, writer, status,
        rheaders)``.  The caller owns closing the writer."""
        reader, writer = await asyncio.open_connection(rep.host,
                                                       rep.port)
        try:
            blob = body if body is not None else b""
            lines = ["%s %s HTTP/1.1" % (method, path),
                     "Host: %s:%d" % (rep.host, rep.port),
                     "Connection: close",
                     "Content-Length: %d" % len(blob)]
            if not any(k.lower() == "content-type"
                       for k in (headers or {})):
                lines.append("Content-Type: application/json")
            for k, v in (headers or {}).items():
                lines.append("%s: %s" % (k, v))
            writer.write(("\r\n".join(lines) + "\r\n\r\n").encode()
                         + blob)
            await writer.drain()
            line = (await reader.readline()).decode("latin-1")
            parts = line.split(None, 2)
            if len(parts) < 2 or not parts[1].isdigit():
                raise ConnectionError("bad status line %r" % line)
            status = int(parts[1])
            rheaders = {}
            while True:
                hline = await reader.readline()
                if hline in (b"\r\n", b"\n", b""):
                    break
                key, _, val = hline.decode("latin-1").partition(":")
                rheaders[key.strip().lower()] = val.strip()
            return reader, writer, status, rheaders
        except BaseException:
            writer.close()
            raise

    async def _stream_proxy(self, path, headers, raw, writer,
                            trace=None):
        """Proxy one streaming (SSE) request frame by frame.

        Retries, backoff and replica selection apply freely UNTIL a
        replica's response status line arrives; the first forwarded
        byte pins the client's response headers.  For REPLAYABLE
        ``/generate`` streams (single row, greedy or seed-pinned —
        the idempotent set) the pin is no longer final: the router
        records the request's replay state (body + every token frame
        it forwarded) and when the pinned replica dies or errors
        mid-stream it RESUBMITS the request to another eligible
        replica through the ``resume_tokens`` lane — the replica
        re-prefills prompt + forwarded prefix and continues sampling
        at draw counter ``len(forwarded)``, so the spliced
        continuation is bit-identical to an uninterrupted run
        (fp32; the preempt→resume contract) and the client sees
        zero error frames.  Non-replayable streams (multi-row,
        unseeded sampling, the /v1 facade) keep the old pin-and-
        truncate contract.  Hedging never arms for streams.  A
        mid-stream client disconnect closes the upstream connection
        — including a resume leg in flight — which makes the
        replica's SSE writer fail and CANCEL the request (slot + KV
        blocks free at the next decode boundary).  Error replies
        (shed 503s, 4xx) stay ordinary JSON — only a success opens
        the event stream."""
        t0 = time.monotonic()
        deadline = t0 + self.request_timeout
        _, affinity, _, cls = self._inspect(raw, headers)
        tenant = headers.get("x-veles-tenant")
        fwd = {k: v for k, v in headers.items()
               if k in ("x-veles-session", "x-veles-trace",
                        "x-veles-tenant")}
        root_span = None
        if self._tron and trace is not None:
            root_span = next_span_id()
            events.record("router.request", "begin", cls="Router",
                          span=root_span, trace=trace, path=path,
                          stream=True, tenant=tenant)
        seq = next(self._req_seq)
        info = {"trace": trace, "path": path, "t0": t0,
                "attempts": 0, "replica": None, "stream": True,
                "cls": cls, "tenant": tenant}
        self._inflight[seq] = info
        try:
            await self._stream_attempts(
                path, raw, writer, trace, t0, deadline, affinity,
                cls, fwd, info)
        finally:
            self._inflight.pop(seq, None)
            if root_span is not None:
                events.record("router.request", "end", cls="Router",
                              span=root_span, trace=trace, path=path,
                              stream=True, tenant=tenant,
                              duration=time.monotonic() - t0,
                              attempts=info["attempts"])

    #: SSE frame terminator — the replica's sse_event wire format
    #: (``data: <json>\n\n``); the failover parser splits on it
    _SSE_SEP = b"\n\n"

    def _stream_replay_state(self, path, raw):
        """Replay state for mid-stream failover, or None when the
        stream is not resumable: only single-row ``/generate``
        bodies that are IDEMPOTENT (greedy, or seed-pinned sampling
        — any replica regenerates the same tokens) and not already a
        resume leg qualify.  ``generated`` accumulates every token
        frame the router has forwarded; a resume resubmits the body
        with exactly that prefix."""
        if path != "/generate":
            return None
        try:
            body = json.loads(raw.decode() or "{}")
        except Exception:
            return None
        prompt = body.get("prompt")
        if not isinstance(prompt, list) or not prompt \
                or isinstance(prompt[0], list) \
                or body.get("beam") or body.get("resume_tokens"):
            return None
        if float(body.get("temperature") or 0.0) \
                and body.get("seed") is None:
            return None      # unseeded sampling cannot be replayed
        try:
            if int(body.get("steps") or 0) < 1:
                return None
        except (TypeError, ValueError):
            return None
        return {"body": body, "generated": []}

    async def _resume_begin(self, rep, state, fwd, timeout):
        """Open one resume leg: the replay body + the forwarded
        prefix through the replica's loopback/admin
        ``resume_tokens`` lane (the admin bearer rides along for
        remote replicas).  Returns the ``_http_begin`` handle."""
        body = dict(state["body"])
        body["stream"] = True
        body["resume_tokens"] = list(state["generated"])
        headers = dict(fwd)
        from veles_tpu_torch.config import root
        token = root.common.api.get("admin_token", None)
        if token:
            headers["Authorization"] = "Bearer %s" % token
        return await asyncio.wait_for(
            self._http_begin(rep, "POST", "/generate",
                             json.dumps(body).encode(), headers),
            timeout)

    async def _relay_one_frame(self, rep, frame, writer, state):
        """Forward one complete SSE frame to the client, tracking
        replay state.  Returns None to keep relaying, ``"done"``
        after the terminal [DONE], ``"died"`` when the frame is an
        error frame (failover material — NOT forwarded) or the armed
        ``router.stream.replica_death`` point killed the replica
        under this frame, ``"client_gone"`` when the client hung
        up."""
        data = frame.strip()
        if data.startswith(b"data:"):
            data = data[5:].strip()
        payload = None
        if data != b"[DONE]":
            try:
                payload = json.loads(data.decode())
            except Exception:
                payload = None
        is_token = isinstance(payload, dict) and "token" in payload
        if isinstance(payload, dict) and "error" in payload:
            # a mid-stream scheduler failure (watchdog, close, the
            # replica dying politely) — resume elsewhere instead of
            # delivering the error frame
            return "died"
        if is_token:
            # the chaos hook: an armed drop/exception here IS the
            # pinned replica dying before this frame reached the
            # client — the token is not counted as forwarded, so the
            # resume regenerates it
            try:
                dropped = await asyncio.get_running_loop() \
                    .run_in_executor(None, faults.fire,
                                     "router.stream.replica_death",
                                     rep.id)
            except faults.InjectedFault:
                return "died"
            if dropped:
                return "died"
        try:
            writer.write(frame)
            await writer.drain()
        except (ConnectionError, OSError):
            return "client_gone"
        if is_token and state is not None:
            state["generated"].append(int(payload["token"]))
        return "done" if data == b"[DONE]" else None

    async def _relay_sse_frames(self, rep, upstream, writer, state,
                                deadline):
        """Relay one pinned upstream's SSE stream frame by frame.
        Returns ``"done"`` (terminal [DONE] delivered), ``"died"``
        (upstream EOF/error/error-frame before [DONE] — failover
        material), ``"client_gone"`` or ``"deadline"``.  A trailing
        partial frame is never forwarded, so the replay state counts
        exactly the frames the client received."""
        buf = b""
        while True:
            try:
                chunk = await asyncio.wait_for(
                    upstream.read(4096),
                    max(0.05, deadline - time.monotonic()))
            except asyncio.TimeoutError:
                return "deadline"
            except (ConnectionError, asyncio.IncompleteReadError,
                    OSError):
                return "died"
            if not chunk:
                return "died"   # EOF without [DONE]: replica died
            buf += chunk
            while self._SSE_SEP in buf:
                frame, buf = buf.split(self._SSE_SEP, 1)
                verdict = await self._relay_one_frame(
                    rep, frame + self._SSE_SEP, writer, state)
                if verdict is not None:
                    return verdict

    async def _relay_blind(self, upstream, writer, deadline):
        """The legacy pin-and-truncate relay for non-resumable
        streams (and non-200 bodies): bytes through as they arrive
        until EOF, client disconnect or the deadline."""
        try:
            while True:
                chunk = await asyncio.wait_for(
                    upstream.read(4096),
                    max(1.0, deadline - time.monotonic()))
                if not chunk:
                    break
                writer.write(chunk)
                await writer.drain()
        except (ConnectionError, asyncio.IncompleteReadError,
                asyncio.TimeoutError):
            # client gone or replica stalled past the deadline: drop
            # the upstream connection — the replica's SSE writer
            # fails and cancels the request, freeing slot + blocks
            pass

    async def _stream_attempts(self, path, raw, writer, trace, t0,
                               deadline, affinity, cls, fwd, info):
        state = self._stream_replay_state(path, raw)
        attempts = 0
        last_status, last_body = None, b""
        pinned = False       # the client's SSE headers are out
        exclude = set()      # replicas that died under THIS stream
        try:
            while attempts < self.retries:
                now = time.monotonic()
                if now >= deadline:
                    break
                rep = self._pick(affinity, now,
                                 exclude=tuple(exclude))
                if rep is None:
                    break
                attempts += 1
                info["attempts"] = attempts
                info["replica"] = rep.id
                if attempts > 1 and not pinned:
                    self.stats.record_retry()
                kind, arg = await self._stream_one_attempt(
                    path, raw, writer, trace, deadline, fwd, rep,
                    attempts, pinned, state)
                if kind == "retry":
                    if arg is not None:
                        last_status, last_body = arg
                    if pinned:
                        # a failed RESUME leg: this replica cannot
                        # continue the stream right now
                        exclude.add(rep.id)
                    continue
                if kind == "sent":
                    # non-resumable relay (or error body) delivered
                    self.stats.record_request(
                        (time.monotonic() - t0) * 1e3, cls=cls)
                    return
                if kind == "relay":
                    # ("resumed" is recorded inside the attempt, at
                    # the moment a resume leg's 200 arrives — before
                    # its first spliced frame reaches the client)
                    pinned = True
                    if arg == "done":
                        self.stats.record_request(
                            (time.monotonic() - t0) * 1e3, cls=cls)
                        return
                    if arg == "client_gone":
                        # the client hung up (possibly mid-failover):
                        # the attempt's upstream was closed by the
                        # per-attempt cleanup, cancelling the request
                        # replica-side — nothing left to resume for
                        if exclude:
                            self.stats.record_stream_failover(
                                "abandoned")
                        self.stats.record_request(
                            (time.monotonic() - t0) * 1e3, cls=cls)
                        return
                    if arg == "deadline":
                        break
                    # arg == "died": the pinned replica is gone —
                    # the loop resumes on another one
                    exclude.add(rep.id)
        except asyncio.CancelledError:
            raise
        if pinned:
            # the stream started but could not complete and no
            # replica can continue it: end it with ONE structured
            # error frame + [DONE] instead of a silent truncation
            if exclude:   # a replica death was involved, not just
                self.stats.record_stream_failover("failed")  # expiry
            self.stats.record_request((time.monotonic() - t0) * 1e3,
                                      cls=cls)
            err = {"error": {
                "code": 503,
                "message": "stream interrupted and no eligible "
                           "replica could resume it",
                "trace_id": trace,
                "tokens_generated": len(state["generated"])
                if state else None}}
            try:
                writer.write(b"data: " + json.dumps(
                    err, separators=(",", ":")).encode()
                    + b"\n\ndata: [DONE]\n\n")
                await writer.drain()
            except (ConnectionError, OSError):
                pass
            return
        # no replica ever produced a status line (or only 5xx) — shed
        self.stats.record_request((time.monotonic() - t0) * 1e3,
                                  cls=cls)
        if last_status is not None:
            status, rheaders, rbody = self._error(
                last_status, "replica error after %d attempt(s)"
                % attempts, attempts=attempts, trace=trace)
        else:
            self.stats.record_shed()
            status, rheaders, rbody = self._error(
                503, "no eligible replica (fleet saturated, "
                "draining or open)",
                retry_after=self.shed_retry_after,
                attempts=attempts, shed=True, trace=trace)
        out = ["HTTP/1.1 %d X" % status, "Connection: close",
               "Content-Length: %d" % len(rbody)]
        out += ["%s: %s" % (k, v) for k, v in rheaders.items()]
        writer.write(("\r\n".join(out) + "\r\n\r\n").encode()
                     + rbody)
        await writer.drain()

    async def _stream_one_attempt(self, path, raw, writer, trace,
                                  deadline, fwd, rep, attempts,
                                  pinned, state):
        """One streaming forward attempt (first leg or resume leg),
        with the breaker/metrics accounting.  Returns a verdict
        tuple: ``("retry", (status, body) | None)`` to try another
        replica, ``("sent", None)`` when a complete non-resumable
        reply was delivered, or ``("relay", outcome)`` with the
        frame-relay outcome of a pinned resumable stream."""
        now = time.monotonic()
        span = None
        if self._tron and trace is not None:
            span = next_span_id()
            events.record("router.attempt", "begin", cls="Router",
                          span=span, trace=trace, attempt=attempts,
                          replica=rep.id, stream=True, resume=pinned)
        t_att = time.monotonic()
        rep.outstanding += 1
        rep.requests += 1
        upstream = up_writer = None
        injected_body = None
        try:
            try:
                dropped = await asyncio.get_running_loop() \
                    .run_in_executor(None, faults.fire,
                                     "router.forward", rep.id)
                if dropped:
                    raise ConnectionError("injected forward drop")
                if pinned:
                    upstream, up_writer, status, rheaders = \
                        await self._resume_begin(
                            rep, state, fwd, deadline - now)
                else:
                    upstream, up_writer, status, rheaders = \
                        await asyncio.wait_for(
                            self._http_begin(rep, "POST", path, raw,
                                             fwd),
                            deadline - now)
            except faults.InjectedHTTPError as e:
                status = e.status
                rheaders = {"content-type": "application/json"}
                injected_body = json.dumps(
                    {"error": {"code": status,
                               "message": str(e),
                               "injected": True,
                               "trace_id": trace}}).encode()
                upstream = None
            except asyncio.CancelledError:
                raise
            except Exception:
                self._breaker_failure(rep)
                self.stats.record_forward(
                    rep.id, False, tenant=fwd.get("x-veles-tenant"))
                return ("retry", (502, b""))
            if status >= 500 and status != 503:
                self._breaker_failure(rep)
                self.stats.record_forward(
                    rep.id, False, tenant=fwd.get("x-veles-tenant"))
                body = b""
                if upstream is not None:
                    try:
                        body = await asyncio.wait_for(
                            upstream.read(65536), 5.0)
                    except Exception:
                        body = b""
                return ("retry", (status, body))
            # the replica spoke: liveness proven (503 included)
            self._breaker_success(rep)
            self.stats.record_forward(
                rep.id, True, tenant=fwd.get("x-veles-tenant"))
            if status == 503:
                try:
                    after = float(rheaders.get("retry-after", 1))
                except ValueError:
                    after = 1.0
                rep.saturated_until = now + min(after, 5.0)
            if pinned:
                # resume legs can only relay a 200 event stream —
                # the client's headers are long gone; anything else
                # is a failed resume attempt
                if status != 200 or upstream is None:
                    return ("retry", None)
                # recorded BEFORE the continuation's first frame, so
                # the count is visible by the time the client reads
                # the spliced [DONE]
                self.stats.record_stream_failover("resumed")
                outcome = await self._relay_sse_frames(
                    rep, upstream, writer, state, deadline)
                return ("relay", outcome)
            # FIRST reply: pin the client response — headers out,
            # then frames/bytes as they arrive (SSE for a 200, the
            # structured JSON error body otherwise).  One client
            # stream counts ONE pin, resume legs never re-count.
            self.stats.record_stream(rep.id)
            out = ["HTTP/1.1 %d %s" % (status, "OK"
                                       if status == 200 else "X"),
                   "Connection: close",
                   "Content-Type: %s" % rheaders.get(
                       "content-type", "application/json"),
                   "X-Veles-Router-Attempts: %d" % attempts,
                   "X-Veles-Replica: %s" % rheaders.get(
                       "x-veles-replica", rep.id)]
            if trace is not None:
                out.append("X-Veles-Trace: %s" % trace)
            if "content-length" in rheaders:
                out.append("Content-Length: %s"
                           % rheaders["content-length"])
            if "retry-after" in rheaders:
                out.append("Retry-After: %s"
                           % rheaders["retry-after"])
            writer.write(("\r\n".join(out) + "\r\n\r\n").encode())
            if upstream is None:       # injected reply, no socket
                try:
                    writer.write(injected_body or b"")
                    await writer.drain()
                except (ConnectionError, OSError):
                    pass
                return ("sent", None)
            if status == 200 and state is not None:
                outcome = await self._relay_sse_frames(
                    rep, upstream, writer, state, deadline)
                return ("relay", outcome)
            await self._relay_blind(upstream, writer, deadline)
            return ("sent", None)
        finally:
            rep.outstanding -= 1
            if up_writer is not None:
                up_writer.close()
            if span is not None:
                events.record(
                    "router.attempt", "end", cls="Router",
                    span=span, trace=trace, attempt=attempts,
                    replica=rep.id, stream=True, resume=pinned,
                    duration=time.monotonic() - t_att)

    # -- live in-flight inspection ---------------------------------------

    def _inflight_rows(self):
        """The router-side in-flight table: one row per request the
        router is still proxying (trace id, path, age, attempt count,
        current replica, streaming flag) — the router half of ``GET
        /debug/requests``.  Loop thread only."""
        now = time.monotonic()
        return [{
            "trace": info["trace"], "phase": "proxy",
            "path": info["path"],
            "age_s": round(now - info["t0"], 3),
            "attempts": info["attempts"],
            "replica": info["replica"],
            "stream": info["stream"], "cls": info["cls"],
            "tenant": info.get("tenant"),
        } for info in self._inflight.values()]

    def debug_requests(self, timeout=2.0):
        """Thread-safe snapshot of :meth:`_inflight_rows` (the
        flight-recorder registry calls this from whatever thread is
        dumping; a dead/stuck loop answers [] instead of hanging the
        crash path)."""
        with self._lock:
            loop = self._loop
        if loop is None:
            return []

        async def _rows():
            return self._inflight_rows()
        try:
            return asyncio.run_coroutine_threadsafe(
                _rows(), loop).result(timeout)
        except Exception:
            return []

    # -- health polling --------------------------------------------------

    async def _health_loop(self):
        while True:
            await asyncio.sleep(self.health_interval)
            reps = list(self._replicas.values())
            if reps:
                await asyncio.gather(
                    *[self._probe(r) for r in reps],
                    return_exceptions=True)

    async def _probe(self, rep):
        try:
            dropped = await asyncio.get_running_loop() \
                .run_in_executor(None, faults.fire,
                                 "router.replica.health", rep.id)
            if dropped:
                raise ConnectionError("injected health drop")
            status, _, body = await asyncio.wait_for(
                self._http(rep, "GET", "/healthz", None),
                self.health_timeout)
            info = json.loads(body.decode())
        except asyncio.CancelledError:
            raise
        except Exception:
            # flappy/unreachable: two strikes take it out of rotation
            # (health exclusion, NOT a breaker trip)
            rep.health_failures += 1
            if rep.health_failures >= 2:
                if rep.healthy:
                    self.info("replica %s unreachable — out of "
                              "rotation", rep.id)
                rep.healthy = False
                rep.status = "unreachable"
                # the cached exposition text is stale the moment the
                # replica is unreachable: without this the federated
                # merge keeps summing a DEAD replica's final counters
                # until something else overwrites last_scrape
                rep.scrape_failed = True
                self.stats.record_replica_up(rep.id, False)
            return
        rep.health_failures = 0
        self.stats.record_replica_up(rep.id, True)
        rep.last_health = info
        rep.role = str(info.get("role") or "both")
        rep.status = str(info.get("status", "unknown"))
        rep.draining = rep.marked_draining \
            or rep.status == "draining" \
            or bool(info.get("draining"))
        # a draining replica is ALIVE (it finishes its in-flight
        # work); "halted" (health policy latched) is not servable
        rep.healthy = status == 200 or rep.draining
        try:
            _, _, mbody = await asyncio.wait_for(
                self._http(rep, "GET", "/serving/metrics", None),
                self.health_timeout)
            rep.last_metrics = json.loads(mbody.decode())
            digs = rep.last_metrics.get("prefix_digests")
            rep.prefix_digests = frozenset(
                int(d) for d in digs) if isinstance(digs, list) \
                else frozenset()
        except asyncio.CancelledError:
            raise
        except Exception:
            pass
        # federation scrape piggybacks the same poll: the replica's
        # Prometheus text rides into GET /metrics/fleet's merge
        try:
            status, _, sbody = await asyncio.wait_for(
                self._http(rep, "GET", "/metrics", None),
                self.health_timeout)
            if status == 200:
                rep.last_scrape = sbody.decode("utf-8", "replace")
                rep.scrape_failed = False
            else:
                rep.scrape_failed = True
        except asyncio.CancelledError:
            raise
        except Exception:
            rep.scrape_failed = True

    # -- plumbing: async HTTP client + server ----------------------------

    async def _http(self, rep, method, path, body, headers=None):
        reader, writer = await asyncio.open_connection(rep.host,
                                                       rep.port)
        try:
            blob = body if body is not None else b""
            lines = ["%s %s HTTP/1.1" % (method, path),
                     "Host: %s:%d" % (rep.host, rep.port),
                     "Connection: close",
                     "Content-Length: %d" % len(blob)]
            # an explicit Content-Type (the binary KV wire) wins
            # over the JSON default — never send the header twice
            if body is not None and not any(
                    k.lower() == "content-type"
                    for k in (headers or {})):
                lines.append("Content-Type: application/json")
            for k, v in (headers or {}).items():
                lines.append("%s: %s" % (k, v))
            writer.write(("\r\n".join(lines) + "\r\n\r\n").encode()
                         + blob)
            await writer.drain()
            line = (await reader.readline()).decode("latin-1")
            parts = line.split(None, 2)
            if len(parts) < 2 or not parts[1].isdigit():
                raise ConnectionError("bad status line %r" % line)
            status = int(parts[1])
            rheaders = {}
            while True:
                hline = await reader.readline()
                if hline in (b"\r\n", b"\n", b""):
                    break
                key, _, val = hline.decode("latin-1").partition(":")
                rheaders[key.strip().lower()] = val.strip()
            length = rheaders.get("content-length")
            if length is not None:
                rbody = await reader.readexactly(int(length))
            else:
                rbody = await reader.read()
            return status, rheaders, rbody
        finally:
            writer.close()
            try:
                await writer.wait_closed()
            except Exception:
                pass

    def _error(self, code, message, retry_after=None, trace=None,
               **extra):
        """Structured error reply; ``trace`` rides the body as
        ``trace_id`` AND the ``X-Veles-Trace`` header, so a failed or
        slow request is correlatable from the client side (the
        ``attempts`` extra says how many replicas were tried)."""
        err = {"code": int(code), "message": str(message)}
        if trace is not None:
            err["trace_id"] = trace
        err.update({k: v for k, v in extra.items() if v is not None})
        headers = {"Content-Type": "application/json"}
        if trace is not None:
            headers["X-Veles-Trace"] = trace
        if retry_after is not None:
            headers["Retry-After"] = str(max(1, int(retry_after)))
        return int(code), headers, json.dumps({"error": err}).encode()

    #: POST paths proxied to the replicas (streaming bodies divert
    #: to the pinning proxy in _serve_conn)
    FORWARD_POSTS = ("/generate", "/v1/completions",
                     "/v1/embeddings", "/v1/classify")

    def _disagg_active(self, now):
        """Disaggregated dispatch engages only when SPECIALISTS of
        both phases exist and are eligible — a fleet of "both"
        replicas keeps the plain colocated path (zero behavior
        change for every pre-role deployment)."""
        reps = self._replicas.values()
        return any(r.role == "prefill" and self._eligible(r, now)
                   for r in reps) \
            and any(r.role == "decode" and self._eligible(r, now)
                    for r in reps)

    async def _maybe_disagg(self, raw, headers, trace):
        """Disaggregated /generate: prefill on a prefill-specialist
        → fetch its KV export → hand the blocks to an
        affinity-picked decode replica for the token loop.  Every
        hop is individually retryable: a prefill specialist dying
        before its export was fetched re-runs prefill on ANOTHER
        specialist (the export is one-shot, so the fetch is never
        retried against a second owner), and a decode replica
        failing the import gets the SAME export payload retried on a
        peer.  Returns the final reply tuple, or None to fall back
        to the plain colocated forward (multi-row/stream/beam
        bodies, no specialists up, or every hop budget exhausted —
        the decode pool can always serve the request cold, so a
        request is NEVER failed while a colocated-capable replica
        exists)."""
        now = time.monotonic()
        if not self._disagg_active(now):
            return None
        try:
            body = json.loads(raw.decode() or "{}")
            prompt = body.get("prompt")
        except Exception:
            return None      # the replica will 400 it
        if not isinstance(prompt, list) or not prompt \
                or body.get("stream") or body.get("beam") \
                or body.get("resume_tokens") \
                or int(body.get("steps") or 0) < 1:
            return None
        squeeze = not isinstance(prompt[0], list)
        rows = [prompt] if squeeze else prompt
        if len(rows) != 1:
            return None      # batch bodies stay colocated
        deadline = now + self.request_timeout
        _, affinity, _, cls = self._inspect(raw, headers)
        pf_body = json.dumps({"prompt": rows[0],
                              "priority": body.get("priority")}) \
            .encode()
        export = None
        pre = None
        tried_pre = set()
        for _ in range(2):   # prefill+fetch: up to two specialists
            if time.monotonic() >= deadline:
                return None
            specialists = [
                r for r in self._pickable(time.monotonic(),
                                          exclude=tuple(tried_pre),
                                          phase="prefill")
                if r.role == "prefill"]
            if not specialists:
                return None  # no SPECIALIST free — serve colocated
            pre = min(specialists,
                      key=lambda r: (r.outstanding, r.id))
            tried_pre.add(pre.id)
            out = await self._attempt(
                pre, pf_body, headers, deadline - time.monotonic(),
                path="/serving/prefill", trace=trace)
            if not out.deliverable or out.status != 200:
                continue     # prefill failed: try the next owner
            try:
                handle = json.loads(out.body.decode())["handle"]
            except Exception:
                continue
            # THE chaos window: the specialist can die between
            # parking the export and our fetch — an armed drop/
            # exception here is exactly that death
            try:
                dropped = await asyncio.get_running_loop() \
                    .run_in_executor(None, faults.fire,
                                     "disagg.export.fetch", pre.id)
            except faults.InjectedFault:
                dropped = True
            if not dropped:
                out = await self._attempt(
                    pre, None, headers,
                    deadline - time.monotonic(),
                    path="/serving/kv_export/%s" % handle,
                    method="GET", trace=trace)
                if out.deliverable and out.status == 200:
                    try:
                        export = json.loads(out.body.decode())
                        break
                    except Exception:
                        export = None
            # the fetch failed (death, injected drop, expiry 404 or
            # a one-shot 409 race): the record is unrecoverable —
            # re-run prefill from the prompt on another specialist
        if export is None:
            return None
        imp_body = json.dumps({
            "export": export, "steps": body.get("steps"),
            "temperature": body.get("temperature"),
            "top_k": body.get("top_k"), "seed": body.get("seed"),
            "stop": body.get("stop"),
            "priority": body.get("priority")}).encode()
        tried_dec = {pre.id}
        for _ in range(2):   # import: up to two decode replicas —
            #                  the payload is router-held, so a dead
            #                  importer costs one retry, not a
            #                  re-prefill
            if time.monotonic() >= deadline:
                return None
            dec = self._pick(affinity, time.monotonic(),
                             exclude=tuple(tried_dec))
            if dec is None:
                return None
            tried_dec.add(dec.id)
            out = await self._attempt(
                dec, imp_body, headers,
                deadline - time.monotonic(),
                path="/serving/kv_import", trace=trace)
            if not out.deliverable or out.status != 200:
                continue
            try:
                toks = json.loads(out.body.decode())["tokens"]
            except Exception:
                continue
            self.stats.record_disagg()
            self.stats.record_request(
                (time.monotonic() - now) * 1e3, cls=cls)
            rheaders = {"Content-Type": "application/json",
                        "X-Veles-Router-Disagg": "%s>%s"
                        % (pre.id, dec.id),
                        "X-Veles-Replica": dec.id}
            if trace is not None:
                rheaders["X-Veles-Trace"] = trace
            return 200, rheaders, json.dumps(
                {"tokens": toks if squeeze else [toks]}).encode()
        return None

    async def _maybe_prefix_fetch(self, target, row, memo, trace,
                                  deadline):
        """Ship the prompt's warm prefix onto ``target`` before the
        forward: when a PEER advertises a resident prefix at least
        ``prefix_fetch_min`` blocks longer than the target's, fetch
        it over the binary KV wire (``POST /serving/prefix_export``
        on the peer, Accept ``application/x-veles-kv``) and import it
        into the target (``POST /serving/prefix_import``, same
        frame).  DRAINING peers still qualify as holders — a
        draining replica's cache is exactly the warmth worth
        rescuing, and its scheduler serves prefix exports to the
        end.  Best-effort throughout: every failed leg counts
        ``prefix_fetch_fails`` and the request proceeds cold; the
        second-best holder gets one retry.  Fault point
        ``router.prefix.fetch`` (keyed by the holder id) injects the
        peer dying between advertisement and fetch."""
        have = self._match_depth(target, row, memo)
        holders = [r for r in self._replicas.values()
                   if r.id != target.id and r.healthy
                   and self._match_depth(r, row, memo) - have
                   >= self.prefix_fetch_min]
        holders.sort(key=lambda r: (-self._match_depth(r, row, memo),
                                    r.outstanding, r.id))
        for holder in holders[:2]:
            budget = min(deadline - time.monotonic(), 10.0)
            if budget <= 0:
                return
            try:
                dropped = await asyncio.get_running_loop() \
                    .run_in_executor(None, faults.fire,
                                     "router.prefix.fetch", holder.id)
            except faults.InjectedFault:
                dropped = True
            blob = None
            if not dropped:
                try:
                    status, rheaders, body = await asyncio.wait_for(
                        self._http(
                            holder, "POST", "/serving/prefix_export",
                            json.dumps({"tokens": row}).encode(),
                            {"Accept": WIRE_CONTENT_TYPE}),
                        budget)
                    ctype = rheaders.get("content-type", "") \
                        .split(";")[0].strip().lower()
                    if status == 200 and ctype == WIRE_CONTENT_TYPE:
                        blob = body
                except asyncio.CancelledError:
                    raise
                except Exception:
                    blob = None
            if blob is None:
                # advertisement was stale (evicted since the poll),
                # the peer died, or the drop was injected — next
                self.stats.record_prefix_fetch_fail()
                continue
            budget = min(deadline - time.monotonic(), 10.0)
            if budget <= 0:
                return
            try:
                status, _, rbody = await asyncio.wait_for(
                    self._http(
                        target, "POST", "/serving/prefix_import",
                        blob, {"Content-Type": WIRE_CONTENT_TYPE}),
                    budget)
                if status == 200:
                    blocks = int(json.loads(
                        rbody.decode()).get("blocks") or 0)
                    self.stats.record_prefix_fetch(max(1, blocks))
                    self.info("prefix fetch %s -> %s: %d block(s)",
                              holder.id, target.id, blocks)
                    return
            except asyncio.CancelledError:
                raise
            except Exception:
                pass
            # the import leg failed (target busy/shape mismatch) —
            # a second holder's export rarely helps, but it is the
            # only remaining card and costs one bounded POST
            self.stats.record_prefix_fetch_fail()

    def _fleet_families(self):
        """loop thread: every replica's last-polled /metrics text
        merged (counters/histograms summed, gauges re-labeled per
        replica) + the veles_fleet_* rollups — the one federated
        view /metrics/fleet renders, the history store samples and
        /tenants/usage totals from."""
        from veles_tpu_torch.telemetry import federation
        scrapes, errors = [], []
        for rep in self._replicas.values():
            if rep.last_scrape and not rep.scrape_failed:
                scrapes.append((rep.id, federation.parse_prometheus(
                    rep.last_scrape)))
            else:
                errors.append(rep.id)
        return federation.fleet_families(scrapes, errors=errors)

    async def _fleet_async(self):
        return self._fleet_families()

    _TENANT_USAGE_FAMILIES = {
        "veles_tenant_usage_prompt_tokens_total": "prompt_tokens",
        "veles_tenant_usage_generated_tokens_total":
            "generated_tokens",
        "veles_tenant_usage_kv_block_seconds_total":
            "kv_block_seconds",
        "veles_tenant_usage_compute_seconds_total":
            "compute_seconds",
    }

    def _tenant_usage(self, window=60.0):
        """loop thread: the ``GET /tenants/usage`` rollup — exact
        fleet-summed totals straight from the CURRENT federated
        merge (counters sum across replicas, so these equal the
        scheduler-side per-tenant counters exactly), plus windowed
        token rates answered by the history store."""
        totals = {}
        for fam in self._fleet_families():
            field = self._TENANT_USAGE_FAMILIES.get(fam["name"])
            if field is None:
                continue
            for suffix, labels, value in fam["samples"]:
                if suffix:
                    continue
                rec = totals.setdefault(
                    labels.get("tenant", "anon"),
                    {f: 0.0
                     for f in self._TENANT_USAGE_FAMILIES.values()})
                rec[field] += value
        out = {}
        for tenant, rec in sorted(totals.items()):
            row = {
                "prompt_tokens": int(rec["prompt_tokens"]),
                "generated_tokens": int(rec["generated_tokens"]),
                "kv_block_seconds": round(rec["kv_block_seconds"], 6),
                "compute_seconds": round(rec["compute_seconds"], 6),
            }
            if self.tsdb is not None:
                for field in ("prompt_tokens", "generated_tokens"):
                    rate = self.tsdb.range(
                        "veles_tenant_usage_%s_total" % field,
                        {"tenant": tenant}, window=window, agg="rate")
                    row["%s_per_sec" % field] = round(rate, 4) \
                        if rate is not None else None
            out[tenant] = row
        return {"window_s": float(window), "tenants": out}

    async def _route(self, method, path, headers, body, trace=None,
                     query=""):
        if method == "POST" and path == "/generate":
            reply = await self._maybe_disagg(body, headers, trace)
            if reply is not None:
                return reply
        if method == "POST" and path in self.FORWARD_POSTS:
            return await self._forward_request(path, body, headers,
                                               trace=trace)
        if method == "GET" and path == "/v1/models":
            return await self._forward_request(path, b"", headers,
                                               method="GET",
                                               trace=trace)
        if method == "GET" and path == "/debug/requests":
            # live in-flight table (loop thread owns _inflight — no
            # locks needed, same invariant as the replica registry)
            return (200, {"Content-Type": "application/json"},
                    json.dumps({"role": "router",
                                "requests": self._inflight_rows()},
                               default=str).encode())
        if method == "GET" and path == "/healthz":
            state = await self._state()
            ok = state["eligible"] > 0
            return (200 if ok else 503,
                    {"Content-Type": "application/json"},
                    json.dumps({
                        "status": "ok" if ok else "unavailable",
                        "role": "router",
                        "replicas": len(self._replicas),
                        "eligible": state["eligible"]}).encode())
        if method == "GET" and path == "/router/state":
            return (200, {"Content-Type": "application/json"},
                    json.dumps(await self._state(),
                               default=str).encode())
        if method == "GET" and path == "/metrics":
            from veles_tpu_torch.telemetry import metrics as registry
            return (200, {"Content-Type":
                          "text/plain; version=0.0.4; charset=utf-8"},
                    registry.render_prometheus().encode())
        if method == "GET" and path == "/metrics/fleet":
            from veles_tpu_torch.telemetry import federation
            return (200, {"Content-Type":
                          "text/plain; version=0.0.4; charset=utf-8"},
                    federation.render_families_text(
                        self._fleet_families()).encode())
        if method == "GET" and path == "/metrics/history":
            if self.tsdb is None:
                return self._error(503, "tsdb disabled")
            from veles_tpu_torch.telemetry.tsdb import history_query
            return (200, {"Content-Type": "application/json"},
                    json.dumps(history_query(self.tsdb, query),
                               default=str).encode())
        if method == "GET" and path == "/tenants/usage":
            from urllib.parse import parse_qs
            params = {k: v[-1]
                      for k, v in parse_qs(query or "").items()}
            try:
                window = float(params.get("window", 60.0))
            except ValueError:
                return self._error(400, "bad window")
            return (200, {"Content-Type": "application/json"},
                    json.dumps(self._tenant_usage(window=window),
                               default=str).encode())
        if method == "GET" and path == "/alerts":
            snap = self.alerts.snapshot() if self.alerts is not None \
                else {"enabled": False}
            return (200, {"Content-Type": "application/json"},
                    json.dumps(snap, default=str).encode())
        if method == "GET" and path == "/dashboard":
            from veles_tpu_torch.telemetry.dashboard import \
                render_dashboard_html
            from veles_tpu_torch.telemetry.tsdb import BUNDLE_SERIES
            state = await self._state()
            history = None
            if self.tsdb is not None:
                history = {}
                for series in BUNDLE_SERIES:
                    pts = self.tsdb.points(series, window=300.0,
                                           tier=0)
                    if pts:
                        history[series] = pts
            page = render_dashboard_html(
                "veles fleet — %s:%d" % (self.host, self.port),
                replicas=state["replicas"],
                slo=state["router"].get("slo"),
                alerts=self.alerts.snapshot()
                if self.alerts is not None else None,
                inflight=self._inflight_rows(),
                note="%d replica(s), %d eligible" % (
                    len(self._replicas), state["eligible"]),
                history=history,
                tenants=self._tenant_usage()
                if self.tsdb is not None else None)
            return (200,
                    {"Content-Type": "text/html; charset=utf-8"},
                    page.encode())
        return self._error(404, "no route %s %s" % (method, path))

    async def _serve_conn(self, reader, writer):
        try:
            line = (await reader.readline()).decode("latin-1")
            parts = line.split()
            if len(parts) < 2:
                return
            method, target = parts[0].upper(), parts[1]
            headers = {}
            while True:
                hline = await reader.readline()
                if hline in (b"\r\n", b"\n", b""):
                    break
                key, _, val = hline.decode("latin-1").partition(":")
                headers[key.strip().lower()] = val.strip()
            length = int(headers.get("content-length", 0))
            body = await reader.readexactly(length) if length \
                else b""
            path, _, query = target.partition("?")
            path = path.rstrip("/") or "/"
            # the EDGE mint: accept the client's X-Veles-Trace when
            # sane, else mint — and propagate it to the replica via
            # the same (sanitized) header so one id spans the fleet
            trace = reqtrace.ensure_trace_id(
                headers.get("x-veles-trace"))
            headers["x-veles-trace"] = trace
            # tenant identity at the edge: EVERY request is resolved
            # and tagged (the forwarded x-veles-tenant header is the
            # bounded label — replica spans and metrics then agree
            # with the router's); the token bucket and the fair lane
            # judge only the forwarded data-plane POSTs
            peer = writer.get_extra_info("peername")
            raw_tenant = self.tenants.tag(
                headers, loopback=bool(peer)
                and peer[0] in ("127.0.0.1", "::1", "localhost"))
            tenant = headers["x-veles-tenant"]
            reply = None
            seat = None
            if method == "POST" and path in self.FORWARD_POSTS:
                after = self.tenants.throttle(raw_tenant)
                if after is not None:
                    reply = self._error(
                        429, "tenant %s over its rate limit"
                        % tenant, retry_after=after, tenant=tenant,
                        trace=trace)
                else:
                    # the weighted-fair lane: the wait happens in the
                    # TENANT'S own queue — other tenants' traffic
                    # never sits behind it
                    seat = await self.tenants.acquire(
                        raw_tenant, self.request_timeout)
                    if seat is None:
                        reply = self._error(
                            429, "tenant %s concurrency lane stayed "
                            "full" % tenant,
                            retry_after=self.shed_retry_after,
                            tenant=tenant, trace=trace)
            try:
                if reply is None and method == "POST" \
                        and path in self.FORWARD_POSTS \
                        and self._inspect(body, headers)[2]:
                    # SSE streaming: the proxy writes the whole
                    # client response itself (headers relay chunk by
                    # chunk; first forwarded byte pins the replica)
                    await self._stream_proxy(path, headers, body,
                                             writer, trace=trace)
                    return
                if reply is None:
                    try:
                        reply = await self._route(
                            method, path, headers, body, trace=trace,
                            query=query)
                    except asyncio.CancelledError:
                        raise
                    except Exception as e:
                        # the router must outlive any bug
                        reply = self._error(
                            500, "router error: %r" % (e,),
                            trace=trace)
            finally:
                if seat == "seat":
                    self.tenants.release(raw_tenant)
            status, rheaders, rbody = reply
            rheaders.setdefault("X-Veles-Trace", trace)
            reason = {200: "OK", 202: "Accepted"}.get(status, "X")
            out = ["HTTP/1.1 %d %s" % (status, reason),
                   "Connection: close",
                   "Content-Length: %d" % len(rbody)]
            out += ["%s: %s" % (k, v) for k, v in rheaders.items()]
            writer.write(("\r\n".join(out) + "\r\n\r\n").encode()
                         + rbody)
            await writer.drain()
        except (ConnectionError, asyncio.IncompleteReadError):
            pass  # client went away mid-request
        finally:
            writer.close()
            try:
                await writer.wait_closed()
            except Exception:
                pass
