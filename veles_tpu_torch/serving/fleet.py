"""Replica supervision for the router fleet: spawn N engine replicas,
monitor them, respawn the dead, and orchestrate zero-downtime rolling
restarts through :class:`veles_tpu_torch.serving.router.Router`; the
port's own copy of ``veles_tpu/serving/fleet.py``.

The Veles DCN contract (the master re-distributes a dead worker's
work) applied to serving: a replica process is EXPECTED to die, and
the fleet's job is to make that invisible — the router retries the
victim's in-flight requests elsewhere while the :class:`Fleet`
supervisor respawns it and re-registers it for traffic.

A *replica handle* is anything with ``host``/``port``/``alive()``/
``stop()`` (and optionally ``replica_id``): :class:`LocalReplica`
wraps an in-process :class:`~veles_tpu_torch.restful_api.RESTfulAPI` (the
test and smoke shape — every replica still gets its OWN scheduler
thread and KV cache), :class:`SubprocessReplica` runs a serving
process from an argv template (the deployment shape).  ``Fleet``
only sees the protocol, so chaos tests kill in-process replicas the
same way production loses containers.

Spawn attempts pass through the ``fleet.replica.spawn`` fault point
(keyed by replica index) — an armed ``exception`` makes respawn fail
and exercises the capped-backoff retry; ``hang`` delays recovery.

**Role rebalancing** (disaggregated fleets, policy knob
``root.common.fleet.rebalance``, default on): a fleet of
specialists must never lose a whole ROLE pool to one death.  Two
mechanisms cooperate, both counted in
``veles_fleet_rebalances_total{role}``:

- every (re)spawn decides its role through :meth:`Fleet._assign_role`
  — the index's own pool membership by default, but when another
  desired role's pool has ZERO live members (and the index's own
  pool keeps one), the respawn fills the empty pool instead (fault
  point ``fleet.role.assign``, keyed by index; ``drop`` pins the
  original role);
- the monitor runs :meth:`Fleet.rebalance` each tick: when a
  desired pool stays empty and no respawn is filling it (the dead
  index's spawns keep failing), the youngest replica of a pool with
  >= 2 live members is restarted INTO the empty role (fault point
  ``fleet.role.rebalance``; ``drop`` skips the pass).  Rebalancing
  restores role COVERAGE, not proportions — a 2:1 fleet that ends
  1:2 after an episode is alive, which is the contract.

Rolling restart (:meth:`Fleet.rolling_restart`), one replica at a
time, zero failed client requests end to end:

1. ``router.drain_replica(id)`` — routing stops immediately (the
   "draining" state, NOT a breaker trip), then ``POST /drain`` closes
   the replica's admission while in-flight requests finish;
2. poll the replica's ``/healthz`` until ``drained`` (in-flight 0);
3. stop the old handle, spawn a fresh one (same index, next
   generation);
4. re-register with the router — the registration probe re-admits it
   as soon as ``/healthz`` answers 200.
"""

import json
import subprocess
import threading
import time
import urllib.error
import urllib.request

from veles_tpu_torch import faults
from veles_tpu_torch.logger import Logger


def _get_json(host, port, path, timeout=5.0):
    """GET a replica endpoint, returning (status, body-dict) — error
    statuses still parse their structured JSON body (a draining
    /healthz answers 503 WITH the drain progress)."""
    url = "http://%s:%d%s" % (host, port, path)
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read().decode())
    except urllib.error.HTTPError as e:
        try:
            return e.code, json.loads(e.read().decode())
        except Exception:
            return e.code, {}


class LocalReplica(object):
    """In-process replica handle around a started
    :class:`~veles_tpu_torch.restful_api.RESTfulAPI` (plus its loader, when
    the caller wants it closed on stop)."""

    def __init__(self, api, loader=None):
        self.api = api
        self.loader = loader
        self.host = api.host
        self.port = api.port
        self.replica_id = api.replica_id

    def alive(self):
        return self.api._server_ is not None

    def stop(self):
        """Stop serving.  On a drained replica this is graceful; on a
        busy one it is the crash shape — pending futures fail and
        in-flight handlers answer 5xx, which is exactly what the
        router's retries exist to absorb."""
        self.api.stop()
        if self.loader is not None:
            self.loader.close()


class SubprocessReplica(object):
    """Replica handle over a serving subprocess: ``argv`` is launched
    as-is (the caller bakes host/port in; ``free_port()`` helps), and
    liveness is the process's own."""

    def __init__(self, argv, host, port, env=None):
        self.host = host
        self.port = int(port)
        self.replica_id = None   # defer to the replica's own pid:port
        self.proc = subprocess.Popen(argv, env=env)

    def alive(self):
        return self.proc.poll() is None

    def stop(self):
        self.proc.terminate()
        try:
            self.proc.wait(10)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait(10)


def _rebalance_metric():
    from veles_tpu_torch.telemetry import metrics
    return metrics.counter(
        "veles_fleet_rebalances_total",
        "replica role re-assignments (a respawn filling an empty "
        "role pool, or the monitor restarting a surplus replica "
        "into one), by the role assigned TO",
        labelnames=("role",))


def free_port(host="127.0.0.1"):
    """Ask the OS for an ephemeral port (subprocess replicas need the
    port chosen BEFORE exec)."""
    import socket
    with socket.socket() as s:
        s.bind((host, 0))
        return s.getsockname()[1]


class Fleet(Logger):
    """Spawn/supervise ``n`` replicas and keep them registered with
    ``router``.  ``spawn(index)`` returns a replica handle; the
    monitor thread respawns any handle whose ``alive()`` goes False
    (capped-backoff retries through the ``fleet.replica.spawn`` fault
    point)."""

    def __init__(self, spawn, n, router=None, monitor_interval=0.25,
                 spawn_retries=5, spawn_delay=0.2, spawn_cap=5.0,
                 roles=None, rebalance=None):
        super(Fleet, self).__init__()
        self.spawn = spawn
        self.n = int(n)
        #: disaggregated fleets: per-index serving role — ``roles``
        #: is a sequence cycled over the replica indices (e.g.
        #: ("prefill", "decode", "decode")); when set, ``spawn`` is
        #: called as ``spawn(index, role)`` so a respawned replica
        #: keeps its pool membership across generations.  None keeps
        #: the legacy ``spawn(index)`` homogeneous-fleet contract.
        self.roles = tuple(roles) if roles else None
        if self.roles:
            bad = [r for r in self.roles
                   if r not in ("prefill", "decode", "both")]
            if bad:
                raise ValueError(
                    "roles must be prefill/decode/both, got %s"
                    % bad)
        if rebalance is None:
            from veles_tpu_torch.config import root
            rebalance = root.common.fleet.get("rebalance", True)
        #: role-rebalancing policy (module docstring): off, a dead
        #: pool stays dead until a human re-roles the fleet
        self.rebalance_enabled = bool(rebalance) and bool(self.roles)
        self.router = router
        self.monitor_interval = float(monitor_interval)
        self.spawn_retries = int(spawn_retries)
        self.spawn_delay = float(spawn_delay)
        self.spawn_cap = float(spawn_cap)
        self._replicas = {}     # index -> handle (None: spawn owed)
        self._ids = {}          # index -> router replica id
        self._generation = {}   # index -> spawn count
        self._role_of = {}      # index -> CURRENT role (rebalanced)
        self._busy = set()      # indices mid-rolling-restart
        self._lock = threading.Lock()
        self._stopping = threading.Event()
        self._thread = None

    # -- lifecycle -------------------------------------------------------

    def start(self):
        for i in range(self.n):
            self._spawn_one(i)
        with self._lock:
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._monitor, daemon=True,
                    name="fleet-monitor")
                self._thread.start()
        return self

    def stop(self):
        self._stopping.set()
        with self._lock:
            thread, self._thread = self._thread, None
            handles = dict(self._replicas)
            ids = dict(self._ids)
            self._replicas = {}
            self._ids = {}
        if thread is not None:
            thread.join(10)
        for i, handle in handles.items():
            if self.router is not None and i in ids:
                try:
                    self.router.remove_replica(ids[i])
                except Exception:
                    pass
            if handle is not None:
                handle.stop()

    def handles(self):
        """Live handles snapshot (index -> handle), e.g. for per-
        replica KV-leak checks after a soak."""
        with self._lock:
            return dict(self._replicas)

    def replica_id(self, index):
        with self._lock:
            return self._ids.get(index)

    def role_of(self, index):
        """The role replica ``index`` currently serves (None for a
        homogeneous fleet) — tracks rebalancing re-assignments."""
        if not self.roles:
            return None
        with self._lock:
            return self._role_of.get(
                index, self.roles[index % len(self.roles)])

    def index_of(self, replica_id):
        """The fleet index currently serving router id
        ``replica_id`` (None when unknown) — how the control plane
        maps a router replica view back onto a fleet slot."""
        with self._lock:
            for index, rid in self._ids.items():
                if rid == replica_id:
                    return index
        return None

    # -- spawning --------------------------------------------------------

    def _live_role_counts(self, exclude=None):
        """Live members per role (``_role_of`` over alive handles),
        skipping ``exclude`` — the pool-health view both rebalance
        mechanisms decide from.  Takes the lock."""
        with self._lock:
            live = [self._role_of.get(
                        i, self.roles[i % len(self.roles)])
                    for i, h in self._replicas.items()
                    if i != exclude and h is not None and h.alive()]
        counts = {}
        for r in live:
            counts[r] = counts.get(r, 0) + 1
        return counts

    def _assign_role(self, index):
        """The role replica ``index`` (re)spawns with: its own pool
        by default; an EMPTY desired pool instead, when this index's
        own pool keeps a live member without it (the passive half of
        rebalancing — a respawn is a free chance to fix coverage)."""
        base = self._role_of.get(
            index, self.roles[index % len(self.roles)])
        if not self.rebalance_enabled:
            return base
        with self._lock:
            if self._generation.get(index, 0) == 0:
                # FIRST spawn: later indices have not spawned yet,
                # so every pool but the earliest looks empty — only
                # a RE-spawn may fill a pool emptied by death
                return base
        if faults.fire("fleet.role.assign", key=str(index)):
            return base      # armed drop pins the original role
        counts = self._live_role_counts(exclude=index)
        if counts.get(base, 0) == 0:
            return base      # respawning as base fills its own hole
        empty = sorted(r for r in set(self.roles)
                       if counts.get(r, 0) == 0)
        if not empty:
            return base
        role = empty[0]
        _rebalance_metric().labels(role=role).inc()
        self.warning("rebalance: replica %d re-roles %s -> %s (the "
                     "%s pool had no live member)", index, base,
                     role, role)
        return role

    def rebalance(self):
        """One ACTIVE rebalance pass (monitor-driven; also callable
        by an operator): when a desired role pool has zero live
        members and no dead index is about to fill it, restart the
        highest-index replica of a pool holding >= 2 live members
        into the empty role.  Returns the re-roled index, or None
        when coverage is already complete (or the pass was dropped
        at the ``fleet.role.rebalance`` point)."""
        if not self.rebalance_enabled:
            return None
        if faults.fire("fleet.role.rebalance"):
            return None
        counts = self._live_role_counts()
        empty = sorted(r for r in set(self.roles)
                       if counts.get(r, 0) == 0)
        if not empty:
            return None
        with self._lock:
            surplus = [
                i for i, h in self._replicas.items()
                if h is not None and h.alive()
                and i not in self._busy
                and counts.get(self._role_of.get(
                    i, self.roles[i % len(self.roles)]), 0) >= 2]
            if not surplus:
                return None
            victim = max(surplus)
            self._busy.add(victim)
        role = empty[0]
        try:
            with self._lock:
                old = self._ids.get(victim)
                handle = self._replicas.get(victim)
            self.warning("rebalance: restarting replica %d (%s) as "
                         "%s — the %s pool lost its last member",
                         victim, old, role, role)
            if self.router is not None and old is not None:
                try:
                    self.router.remove_replica(old)
                except Exception:
                    pass
            if handle is not None:
                handle.stop()
            with self._lock:
                self._role_of[victim] = role
            _rebalance_metric().labels(role=role).inc()
            self._spawn_one(victim)
        finally:
            with self._lock:
                self._busy.discard(victim)
        return victim

    # -- control-plane actuation (FleetController's verbs) ---------------

    def grow(self, role=None):
        """Scale-up: spawn one NEW replica at the next free index
        (optionally into ``role`` on a specialist fleet) and register
        it for traffic.  Returns the new index.  ``n`` is a
        high-water index bound, not a live count — indices are
        identities (generations, roles) and are never reused by a
        grow after a retire."""
        with self._lock:
            if self._stopping.is_set():
                raise RuntimeError("fleet is stopping")
            if role is not None:
                if not self.roles:
                    raise ValueError(
                        "role=%r on a homogeneous fleet" % role)
                if role not in ("prefill", "decode", "both"):
                    raise ValueError(
                        "roles must be prefill/decode/both, got %r"
                        % role)
            index = max(list(self._replicas) + [self.n - 1]) + 1
            self.n = index + 1
            if role is not None:
                self._role_of[index] = role
        self._spawn_one(index)
        return index

    def retire(self, index):
        """Scale-down removal of replica ``index``: forget it FIRST
        (so the monitor never respawns it), deregister from the
        router, stop the handle.  The caller drains beforehand — the
        controller's drain → poll-/healthz → retire path; retiring a
        busy replica is the crash shape the router's retries absorb.
        Returns the retired router id (None when the index was
        unknown)."""
        with self._lock:
            if index in self._busy:
                raise RuntimeError(
                    "replica %d is mid-restart" % index)
            handle = self._replicas.pop(index, None)
            rid = self._ids.pop(index, None)
            self._role_of.pop(index, None)
            self._generation.pop(index, None)
        if self.router is not None and rid is not None:
            try:
                self.router.remove_replica(rid)
            except Exception:
                pass
        if handle is not None:
            handle.stop()
        self.info("replica %d (%s) retired", index, rid)
        return rid

    def restart_as(self, index, role):
        """Load-driven re-roling (the controller's ratio loop):
        restart live replica ``index`` into ``role`` through the
        same spawn machinery a coverage rebalance uses.
        :meth:`rebalance` only ever FILLS an empty pool; this moves
        the prefill:decode RATIO on purpose.  Coverage still wins:
        if the respawn finds some OTHER pool emptied meanwhile,
        :meth:`_assign_role` may override the requested role."""
        if not self.roles:
            raise RuntimeError("restart_as needs a role-aware fleet")
        if role not in ("prefill", "decode", "both"):
            raise ValueError(
                "roles must be prefill/decode/both, got %r" % role)
        with self._lock:
            if index not in self._replicas:
                raise KeyError("no replica %d" % index)
            if index in self._busy:
                raise RuntimeError(
                    "replica %d is mid-restart" % index)
            self._busy.add(index)
            old = self._ids.get(index)
            handle = self._replicas.get(index)
        try:
            self.warning("re-role: restarting replica %d (%s) as %s "
                         "(controller ratio decision)", index, old,
                         role)
            if self.router is not None and old is not None:
                try:
                    self.router.remove_replica(old)
                except Exception:
                    pass
            if handle is not None:
                handle.stop()
            with self._lock:
                self._role_of[index] = role
            _rebalance_metric().labels(role=role).inc()
            self._spawn_one(index)
        finally:
            with self._lock:
                self._busy.discard(index)
        return index

    def _spawn_one(self, index):
        """Spawn replica ``index`` (next generation) and register it
        with the router; retries with capped exponential backoff when
        the spawn itself fails (the ``fleet.replica.spawn`` point)."""
        handle = None
        role = self._assign_role(index) if self.roles else None
        for attempt in range(1, self.spawn_retries + 1):
            try:
                if faults.fire("fleet.replica.spawn", key=str(index)):
                    raise RuntimeError("injected spawn drop")
                if self.roles:
                    handle = self.spawn(index, role)
                else:
                    handle = self.spawn(index)
                break
            except Exception as e:
                if attempt >= self.spawn_retries:
                    self.error("replica %d spawn failed %d times: "
                               "%r", index, attempt, e)
                    raise
                delay = min(self.spawn_cap,
                            self.spawn_delay * (2 ** (attempt - 1)))
                self.warning("replica %d spawn attempt %d failed "
                             "(%r); retrying in %.2fs", index,
                             attempt, e, delay)
                time.sleep(delay)
        rid = getattr(handle, "replica_id", None) \
            or "%s:%d" % (handle.host, handle.port)
        with self._lock:
            gen = self._generation.get(index, 0)
            self._generation[index] = gen + 1
            self._replicas[index] = handle
            self._ids[index] = rid
            if role is not None:
                self._role_of[index] = role
        if self.router is not None:
            self.router.add_replica(handle.host, handle.port,
                                    replica_id=rid)
            if gen > 0:
                self.router.stats.record_restart(rid)
        self.info("replica %d generation %d up as %s on %s:%d",
                  index, gen + 1, rid, handle.host, handle.port)
        return handle

    def _monitor(self):
        """Respawn dead replicas: deregister (the router already
        breaker-opened it after the first failed forwards), spawn the
        next generation, re-register."""
        while not self._stopping.wait(self.monitor_interval):
            with self._lock:
                dead = [i for i, h in self._replicas.items()
                        if i not in self._busy
                        and (h is None or not h.alive())]
            for index in dead:
                if self._stopping.is_set():
                    return
                with self._lock:
                    old = self._ids.get(index)
                self.warning("replica %d (%s) died — respawning",
                             index, old)
                if self.router is not None and old is not None:
                    try:
                        self.router.remove_replica(old)
                    except Exception:
                        pass
                try:
                    self._spawn_one(index)
                except Exception:
                    # spawn exhausted its retries; the next tick
                    # tries again (the index stays dead in the map)
                    with self._lock:
                        self._replicas[index] = None
            if self.rebalance_enabled and not self._stopping.is_set():
                # coverage check AFTER the respawn pass: only a pool
                # no respawn could fill triggers the active restart
                try:
                    self.rebalance()
                except Exception as e:
                    self.warning("rebalance pass failed: %r", e)

    # -- rolling restart -------------------------------------------------

    def rolling_restart(self, drain_timeout=60.0, poll=0.05):
        """Drain → stop → respawn → re-admit, one replica at a time,
        under live traffic.  Returns per-index drain/restart info;
        raises if any replica fails to drain inside
        ``drain_timeout``."""
        if self.router is None:
            raise RuntimeError("rolling restart needs a router")
        report = {}
        for index in sorted(self._replicas):
            with self._lock:
                handle = self._replicas.get(index)
                rid = self._ids.get(index)
                self._busy.add(index)
            try:
                if handle is None:
                    continue
                t0 = time.monotonic()
                self.router.drain_replica(rid)
                deadline = time.monotonic() + drain_timeout
                while True:
                    _, health = _get_json(handle.host, handle.port,
                                          "/healthz")
                    if health.get("status") == "draining" \
                            and (health.get("drained")
                                 or not health.get("in_flight")):
                        break
                    if time.monotonic() > deadline:
                        raise TimeoutError(
                            "replica %s did not drain in %.0fs "
                            "(in_flight=%s)"
                            % (rid, drain_timeout,
                               health.get("in_flight")))
                    time.sleep(poll)
                drained_s = time.monotonic() - t0
                self.router.remove_replica(rid)
                handle.stop()
                self._spawn_one(index)  # records the restart metric
                report[index] = {
                    "old": rid, "new": self.replica_id(index),
                    "drain_s": round(drained_s, 3)}
                self.info("rolling restart %d/%d: %s -> %s "
                          "(drained in %.2fs)", index + 1,
                          len(report), rid,
                          self.replica_id(index), drained_s)
            finally:
                with self._lock:
                    self._busy.discard(index)
        return report
