"""Elastic job-queue coordinator — the port of
``veles_tpu/parallel/coordinator.py``, the master/worker exchange.

Rebuild of the reference's master–slave stack (veles/server.py:659,
client.py, network_common.py, txzmq/): inside a process gang, gradient
sync is the mesh trainer's collectives (no coordinator involvement);
this service keeps the *elastic* semantics the reference had across its
ZeroMQ star — workers join/leave anytime, the coordinator hands out jobs
(minibatch index ranges via ``IDistributable``), re-queues work from
dropped workers, and weights distribution by each worker's measured
compute power.  Used by ensemble/genetics fleets and cross-DCN data
serving.

Transport: asyncio TCP with length-prefixed pickle frames + gzip where it pays
(replaces Twisted JSON-lines control + txzmq ``vpb``/``vpe`` streamed
pickling, ref: txzmq/connection.py:255-340).  The handshake carries the
workflow checksum (mismatch ⇒ reject, ref: server.py:490-493) and the
worker's compute power (ref: server.py:540-567).

Failure handling (ref: server.py:619-655): per-worker job timers; a job
exceeding ``max(mean + 3σ, job_timeout)`` drops the worker and requeues
its minibatches (``Workflow.drop_slave``).  Blacklisting follows the
reference's *repeat offender* semantics (ref: server.py:383-394): a
worker is banned only after ``blacklist_strikes`` timeouts, a completed
job clears its strikes, and bans expire after ``blacklist_forgive``
seconds (plus an explicit :meth:`Coordinator.forgive`) so a once-slow
worker on a loaded host can rejoin the fleet.

Death detection is two-tier.  A modern :class:`WorkerClient` runs its
job in a thread-pool executor and keeps a **heartbeat** task pinging
the coordinator every ``heartbeat_interval`` seconds even mid-job; a
worker whose pings stop for ``heartbeat_timeout`` seconds while it
holds a job is declared dead LONG before the mean+3σ job watchdog
would fire, its connection is torn down and its in-flight job frame
is requeued to the live fleet (``veles_coordinator_reassigned_total``)
— epoch sample accounting stays exact because ``drop_slave`` refiles
the dead worker's minibatches, honoring the Veles DCN contract
(PAPER.md: the master re-distributes work on worker loss).  Workers
that never ping (legacy/raw peers) keep the job-timeout tier only.
Worker reconnects use capped exponential backoff with jitter
(``veles_coordinator_reconnects_total``) so a restarting coordinator
is not met by a synchronized thundering herd.

Injection points (``coordinator.*`` — :mod:`veles_tpu_torch.faults`,
keyed by worker id) let tier-1 arm dropped heartbeats, hung jobs, slow
dispatches and crashing handlers deterministically.
"""

import asyncio
import collections
import contextlib
import functools
import gzip
import pickle
import random
import struct
import time
import uuid
import zlib

from veles_tpu_torch import faults
from veles_tpu_torch.logger import Logger

_HDR = struct.Struct("!IB")  # length, flags
_FLAG_GZIP = 1


def _coord_metrics():
    """Fleet-level series in the shared registry (created lazily —
    importing the coordinator must not populate /metrics)."""
    from veles_tpu_torch.telemetry import metrics
    return {
        "workers": metrics.gauge(
            "veles_coordinator_workers",
            "workers currently registered with the coordinator"),
        "dispatched": metrics.counter(
            "veles_coordinator_jobs_dispatched_total",
            "jobs handed to workers"),
        "completed": metrics.counter(
            "veles_coordinator_jobs_completed_total",
            "job updates applied"),
        "dropped": metrics.counter(
            "veles_coordinator_workers_dropped_total",
            "worker sessions dropped (timeouts, disconnects, evictions)"),
        "reassigned": metrics.counter(
            "veles_coordinator_reassigned_total",
            "in-flight job frames requeued to the live fleet after "
            "their worker died (heartbeat/job-timeout/disconnect)"),
        "heartbeat_deaths": metrics.counter(
            "veles_coordinator_heartbeat_deaths_total",
            "workers declared dead because their heartbeats stopped "
            "mid-job"),
        "job_seconds": metrics.histogram(
            "veles_coordinator_job_seconds",
            "job round-trip time (dispatch to update)"),
    }


#: a frame over _GZIP_PROBE bytes is gzipped only when a probe of that
#: many bytes from its middle shrinks below _GZIP_GAIN of its size (a
#: port addition): a model's float32 parameters shrink by ~7 % at level
#: 1, for seconds of CPU per hundred MB on each side of the wire; the
#: flag byte tells the peer either way, so the reference reads both
_GZIP_PROBE, _GZIP_GAIN = 1 << 20, 0.9


def _gzip_pays(blob):
    if len(blob) <= _GZIP_PROBE:
        return True
    start = (len(blob) - _GZIP_PROBE) // 2
    probe = blob[start:start + _GZIP_PROBE]
    return len(zlib.compress(probe, 1)) < _GZIP_GAIN * len(probe)


def _encode(obj, compress):
    blob = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    flags = 0
    if compress and len(blob) > 4096 and _gzip_pays(blob):
        blob = gzip.compress(blob, 1)
        flags |= _FLAG_GZIP
    return blob, flags


def _decode(blob, flags):
    if flags & _FLAG_GZIP:
        blob = gzip.decompress(blob)
    return pickle.loads(blob)


async def send_frame(writer, obj, compress=True):
    """Write ``obj`` as one frame; returns the bytes put on the wire.
    The pickling and compression run in the loop's executor (a port
    addition): a model's parameters take seconds to encode, and the
    loop must keep serving heartbeats meanwhile."""
    blob, flags = await asyncio.get_running_loop().run_in_executor(
        None, _encode, obj, compress)
    writer.write(_HDR.pack(len(blob), flags))
    writer.write(blob)
    await writer.drain()
    return _HDR.size + len(blob)


async def recv_frame_sized(reader, arrived=None):
    """One frame: ``(obj, bytes read off the wire)``, decoded in the
    loop's executor; ``arrived()`` is called once its bytes are in,
    before the decoding."""
    hdr = await reader.readexactly(_HDR.size)
    length, flags = _HDR.unpack(hdr)
    blob = await reader.readexactly(length)
    if arrived is not None:
        arrived()
    obj = await asyncio.get_running_loop().run_in_executor(
        None, _decode, blob, flags)
    return obj, _HDR.size + length


async def recv_frame(reader):
    return (await recv_frame_sized(reader))[0]


class WorkerDescription:
    """ref: veles/server.py:172 SlaveDescription."""

    def __init__(self, wid, power, writer):
        self.id = wid
        self.power = power
        self.writer = writer
        self.state = "WAIT"
        self.jobs_done = 0
        self.job_started = None
        #: trace id of the in-flight job (rides the job frame so the
        #: worker's event stream stitches to the master's in merged
        #: Chrome-trace exports)
        self.trace = None
        #: wall stamp of the last frame received on this session; a
        #: pinging worker that goes silent mid-job is declared dead
        #: at heartbeat_timeout (far before the job watchdog)
        self.last_seen = time.time()
        #: the session has sent at least one ping — only then does
        #: silence mean death (legacy peers never ping; their only
        #: death tier is the job timeout)
        self.heartbeats = False
        #: the session is encoding or sending a frame to the worker and
        #: reads nothing from it meanwhile: its silence is not the
        #: worker's (a port addition)
        self.sending = False

    def __repr__(self):
        return "<worker %s power=%.1f jobs=%d state=%s>" % (
            self.id, self.power, self.jobs_done, self.state)


class Coordinator(Logger):
    """The coordinator service (ref: veles/server.py:659 Server)."""

    #: rolling window of recent job durations feeding the mean+3σ
    #: watchdog threshold — bounded so a week-long elastic fleet doesn't
    #: accumulate unbounded floats (the reference kept no history at all,
    #: it tracked only per-slave start times, server.py:619-635)
    DURATION_WINDOW = 256

    def __init__(self, workflow, host="127.0.0.1", port=5050,
                 job_timeout=60.0, blacklist_strikes=3,
                 blacklist_forgive=300.0, watchdog_interval=1.0,
                 heartbeat_timeout=10.0):
        super(Coordinator, self).__init__()
        self.workflow = workflow
        self.host, self.port = host, port
        self.job_timeout = job_timeout
        self.watchdog_interval = float(watchdog_interval)
        #: a pinging worker silent this long while holding a job is
        #: dead — its frame requeues to the live fleet (0 disables)
        self.heartbeat_timeout = float(heartbeat_timeout)
        self.blacklist_strikes = int(blacklist_strikes)
        self.blacklist_forgive = float(blacklist_forgive)
        self.workers = {}
        self.blacklist = set()
        #: worker id -> {"count", "last_strike", "banned_at"} — ONE
        #: record per offender so strike count, aging, and ban expiry
        #: can't drift apart
        self._offenders = {}
        self.job_durations = collections.deque(maxlen=self.DURATION_WINDOW)
        self._server = None
        self._done = asyncio.Event()
        self._stopping = False
        self._metrics = _coord_metrics()
        #: wire bytes of the job frames sent and the update frames
        #: received, and their counts (a port addition: what one job
        #: costs the fleet's network)
        self.frame_bytes = {"job": 0, "jobs": 0, "update": 0,
                            "updates": 0}

    @property
    def strikes(self):
        """Read-only view: worker id -> current strike count."""
        return {wid: rec["count"] for wid, rec in self._offenders.items()}

    # -- lifecycle -------------------------------------------------------------

    async def start(self):
        self._server = await asyncio.start_server(
            self._on_connect, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        self._loop = asyncio.get_running_loop()
        self.info("coordinator listening on %s:%d", self.host, self.port)
        self._watchdog_task = asyncio.ensure_future(self._watchdog())

    def notify_jobs(self):
        """Thread-safe wake for parked workers after jobs arrive from
        OUTSIDE the coordinator's own protocol flow (e.g. a genetics
        fleet submitting the next generation from the optimizer
        thread): without this the wait/resume push has no trigger and
        every worker stays parked."""
        loop = getattr(self, "_loop", None)
        if loop is not None:
            loop.call_soon_threadsafe(
                lambda: asyncio.ensure_future(self._wake_idle()))

    def request_stop(self):
        """Thread-safe run termination: marks the run finished and
        pushes terminate to every connected worker.  ``wait_finished``
        returns and the owner's ``stop()`` drains as usual."""
        loop = getattr(self, "_loop", None)
        if loop is None:
            self._done.set()
            return

        def _finish():
            self._done.set()
            asyncio.ensure_future(self._broadcast_terminate())

        loop.call_soon_threadsafe(_finish)

    async def wait_finished(self):
        await self._done.wait()

    async def stop(self, drain_timeout=10.0):
        # no new jobs from here on (an abort-stop with jobs remaining
        # must not keep dispatching through the drain window)
        self._stopping = True
        await self._broadcast_terminate()
        # wait for sessions to END on their own (worker reads terminate,
        # closes its end, handler unregisters it) rather than closing
        # under them: a server-side close() with an unread frame (e.g. a
        # final "job" request racing the terminate) sends TCP RST, which
        # DISCARDS the terminate buffered toward the worker and strands
        # it in a reconnect loop against a dead server (ref:
        # launcher.py:588-592 "master waits for slaves to drain")
        deadline = time.time() + drain_timeout
        while time.time() < deadline and self.workers:
            await asyncio.sleep(0.05)
        self._watchdog_task.cancel()
        with contextlib.suppress(asyncio.CancelledError):
            await self._watchdog_task
        for w in list(self.workers.values()):
            w.writer.close()
        self._server.close()
        # py3.12 wait_closed() blocks until every connection handler AND
        # transport is gone; handlers close their writers in _on_connect's
        # finally, so this terminates — but cap it in case a worker holds
        # its end open across a network partition.
        with contextlib.suppress(asyncio.TimeoutError, TimeoutError):
            await asyncio.wait_for(self._server.wait_closed(), 5.0)

    # -- protocol (ref: server.py:230-254 FSM) ---------------------------------

    async def _on_connect(self, reader, writer):
        peer = writer.get_extra_info("peername")
        try:
            hello = await recv_frame(reader)
        except (asyncio.IncompleteReadError, ConnectionError):
            writer.close()
            return
        checksum = hello.get("checksum")
        if checksum != self.workflow.checksum():
            self.warning("%s: checksum mismatch — rejected", peer)
            await send_frame(writer, {"error": "checksum mismatch"})
            writer.close()
            return
        wid = hello.get("id") or str(uuid.uuid4())[:8]
        self._expire_bans()
        if wid in self.blacklist:
            await send_frame(writer, {"error": "blacklisted"})
            writer.close()
            return
        worker = WorkerDescription(wid, hello.get("power", 1.0), writer)
        stale = self.workers.get(wid)
        if stale is not None:
            # same-id rejoin over a fresh connection (the old one died
            # silently): evict the stale session's registration so its
            # eventual read-error cleanup can't tear down OUR entry, and
            # requeue whatever the dead session had in flight
            self.info("worker %s rejoined — evicting stale session", wid)
            self._drop(stale, requeue=True)
            try:
                stale.writer.close()
            except Exception:
                pass
        self.workers[wid] = worker
        self._metrics["workers"].set(len(self.workers))
        self.info("worker %s joined from %s (power %.1f)", wid, peer,
                  worker.power)
        await send_frame(writer, {"id": wid})
        try:
            await self._serve_worker(worker, reader)
        except (asyncio.IncompleteReadError, ConnectionError):
            pass
        finally:
            self._drop(worker, requeue=True)
            writer.close()
            with contextlib.suppress(Exception):
                await writer.wait_closed()

    async def _finish_session(self, worker, reader):
        """Send terminate and wait (bounded) for the WORKER to close
        first: returning immediately would close a socket that may hold
        an unread frame (the worker's next "job" racing our terminate),
        and close-with-unread-data sends TCP RST — discarding the very
        terminate we buffered (the same race stop()'s drain handles)."""
        await send_frame(worker.writer, {"cmd": "terminate"})
        self._drop(worker, requeue=False)
        try:
            async def drain():
                while True:
                    data = await reader.read(65536)
                    if not data:
                        return
            await asyncio.wait_for(drain(), 5.0)
        except (asyncio.TimeoutError, TimeoutError, ConnectionError,
                OSError):
            pass

    async def _serve_worker(self, worker, reader):
        def arrived():
            worker.last_seen = time.time()

        while True:
            msg, nbytes = await recv_frame_sized(reader, arrived)
            worker.last_seen = time.time()
            cmd = msg.get("cmd")
            if cmd == "ping":
                # liveness only — no reply (the worker's read loop is
                # elsewhere); the stamp above is the whole point
                worker.heartbeats = True
                continue
            if cmd == "job":
                if self.workers.get(worker.id) is not worker:
                    # dropped/evicted session — don't hand a ghost a job
                    # (its in-flight bookkeeping would pollute the live
                    # worker registered under the same id)
                    return
                if self._done.is_set() or self._stopping:
                    await self._finish_session(worker, reader)
                    return
                if self._has_more_jobs():
                    # injected dispatch faults: a delayed/dropped job
                    # frame exercises the worker-side timeout paths
                    if faults.fire("coordinator.dispatch",
                                   key=worker.id):
                        continue
                    job = self.workflow.generate_data_for_slave(worker.id)
                else:
                    # out of fresh jobs but updates still in flight —
                    # the worker parks until the coordinator pushes a
                    # resume (ref NEED_UPDATE postponement,
                    # server.py:369-399; the reference postponed the
                    # deferred rather than polling)
                    worker.state = "IDLE"
                    await send_frame(worker.writer, {"cmd": "wait"})
                    continue
                worker.state = "WORK"
                worker.job_started = time.time()
                self._metrics["dispatched"].inc()
                from veles_tpu_torch.telemetry import next_span_id
                worker.trace = next_span_id()
                self.event("job", "begin", span=worker.trace,
                           trace=worker.trace, worker=worker.id)
                # a model's parameters take seconds to encode and send,
                # and this session reads nothing from the worker
                # meanwhile: its silence counts from the end of the send
                worker.sending = True
                try:
                    self.frame_bytes["job"] += await send_frame(
                        worker.writer, {"cmd": "job", "data": job,
                                        "trace": worker.trace})
                finally:
                    worker.sending = False
                    worker.last_seen = time.time()
                self.frame_bytes["jobs"] += 1
            elif cmd == "update":
                if self._done.is_set() or self._stopping:
                    # run already complete — the straggler's update is
                    # redundant; release it cleanly
                    worker.state = "WAIT"
                    await self._finish_session(worker, reader)
                    return
                if self.workers.get(worker.id) is not worker:
                    # this session was dropped (watchdog timeout or a
                    # same-id rejoin evicted it) and its minibatches were
                    # requeued — applying the late update would double-
                    # count the work when the requeued job completes
                    self.warning("late update from dropped worker %s "
                                 "discarded", worker.id)
                    return
                dt = time.time() - (worker.job_started or time.time())
                self.frame_bytes["update"] += nbytes
                self.frame_bytes["updates"] += 1
                self.job_durations.append(dt)
                self._metrics["completed"].inc()
                self._metrics["job_seconds"].observe(dt)
                if worker.trace is not None:
                    self.event("job", "end", span=worker.trace,
                               trace=worker.trace, worker=worker.id,
                               duration=dt)
                    worker.trace = None
                worker.state = "WAIT"
                worker.jobs_done += 1
                # a completed job proves the worker is healthy — clear
                # its timeout strikes (repeat-offender semantics)
                self._offenders.pop(worker.id, None)
                self.workflow.apply_data_from_slave(msg["data"], worker.id)
                if self._finished():
                    self._done.set()
                    # push terminate to EVERYONE now — parked workers
                    # would otherwise only learn at stop(), racing the
                    # server close into a reconnect storm
                    await self._broadcast_terminate()
                else:
                    # applying an update may have freed jobs — wake every
                    # parked worker so it re-requests
                    await self._wake_idle()
            elif cmd == "bye":
                self._drop(worker, requeue=False)
                return

    async def _broadcast_terminate(self):
        for w in list(self.workers.values()):
            try:
                await send_frame(w.writer, {"cmd": "terminate"})
            except Exception:
                pass

    async def _wake_idle(self):
        """Push a resume to every parked worker (replaces the worker-side
        0.2s busy poll); the woken worker re-requests a job and the job
        branch decides job/wait/terminate."""
        for w in list(self.workers.values()):
            if w.state == "IDLE":
                w.state = "WAIT"
                try:
                    await send_frame(w.writer, {"cmd": "resume"})
                except (ConnectionError, OSError):
                    pass

    def _has_more_jobs(self):
        wf = self.workflow
        has = getattr(wf, "has_more_jobs", None)
        return has() if callable(has) else True

    def _finished(self):
        fin = getattr(self.workflow, "all_jobs_done", None)
        return fin() if callable(fin) else False

    # -- failure detection (ref: server.py:619-655) ----------------------------

    def _drop(self, worker, requeue):
        if self.workers.get(worker.id) is not worker:
            # already dropped, or a rejoined session owns the id now —
            # never unregister a registration we don't own
            return
        del self.workers[worker.id]
        self._metrics["dropped"].inc()
        self._metrics["workers"].set(len(self.workers))
        if requeue and not self._done.is_set():
            # the workflow refiles the worker's in-flight minibatches
            # (ref: loader/base.py:679-687 failed_minibatches); the
            # requeued work may unpark idle workers
            if worker.state == "WORK":
                # the dead session held a job frame — its work is now
                # the live fleet's (the Veles DCN reassignment)
                self._metrics["reassigned"].inc()
                if worker.trace is not None:
                    self.event("job", "end", span=worker.trace,
                               trace=worker.trace, worker=worker.id,
                               error="WorkerLost")
                    worker.trace = None
            self.workflow.drop_slave(worker.id)
            self.info("worker %s dropped — work requeued", worker.id)
            asyncio.ensure_future(self._wake_idle())

    def forgive(self, worker_id):
        """Lift a ban (operator override; auto-expiry is
        ``blacklist_forgive`` seconds)."""
        self.blacklist.discard(worker_id)
        self._offenders.pop(worker_id, None)

    def _expire_bans(self):
        # one sweep ages both bans and sub-ban strike records — a
        # churning elastic fleet of ephemeral worker ids must not
        # accumulate offender entries forever
        now = time.time()
        for wid, rec in list(self._offenders.items()):
            stamp = rec["banned_at"] or rec["last_strike"]
            if now - stamp >= self.blacklist_forgive:
                if rec["banned_at"]:
                    self.info("worker %s ban expired — forgiven", wid)
                self.forgive(wid)

    def _timeout_threshold(self):
        """mean + 3·stddev over the rolling duration window, floored at
        ``job_timeout`` (ref: server.py:619-635)."""
        if len(self.job_durations) < 4:
            return self.job_timeout
        mean = sum(self.job_durations) / len(self.job_durations)
        var = sum((d - mean) ** 2 for d in self.job_durations) \
            / len(self.job_durations)
        return max(mean + 3 * var ** 0.5, self.job_timeout)

    async def _watchdog(self):
        while True:
            await asyncio.sleep(self.watchdog_interval)
            self._expire_bans()
            thr = self._timeout_threshold()
            now = time.time()
            for w in list(self.workers.values()):
                if self.heartbeat_timeout > 0 and w.heartbeats \
                        and w.state == "WORK" and not w.sending \
                        and now - w.last_seen > self.heartbeat_timeout:
                    # the heartbeat tier: a pinging worker went silent
                    # mid-job — dead or wedged either way; reassign
                    # its frame NOW instead of waiting out mean+3σ
                    self.warning(
                        "worker %s silent %.1fs mid-job (heartbeat "
                        "timeout %.1fs) — declaring dead, requeueing",
                        w.id, now - w.last_seen,
                        self.heartbeat_timeout)
                    self._metrics["heartbeat_deaths"].inc()
                    self._strike(w.id, now)
                    try:
                        w.writer.close()
                    except Exception:
                        pass
                    self._drop(w, requeue=True)
                    continue
                if w.state == "WORK" and w.job_started \
                        and now - w.job_started > thr:
                    n = self._strike(w.id, now)
                    if n >= self.blacklist_strikes:
                        self.warning(
                            "worker %s exceeded job timeout %.1fs "
                            "(strike %d/%d) — dropping + blacklisting",
                            w.id, thr, n, self.blacklist_strikes)
                    else:
                        self.warning(
                            "worker %s exceeded job timeout %.1fs "
                            "(strike %d/%d) — dropping, may rejoin",
                            w.id, thr, n, self.blacklist_strikes)
                    try:
                        w.writer.close()
                    except Exception:
                        pass
                    self._drop(w, requeue=True)

    def _strike(self, wid, now):
        """Record one timeout strike against ``wid`` (repeat-offender
        semantics); the Nth strike bans.  Returns the new count."""
        rec = self._offenders.setdefault(
            wid, {"count": 0, "last_strike": now, "banned_at": None})
        rec["count"] += 1
        rec["last_strike"] = now
        if rec["count"] >= self.blacklist_strikes:
            self.blacklist.add(wid)
            rec["banned_at"] = now
        return rec["count"]


class RejectedError(ConnectionError):
    """The coordinator actively refused this worker (blacklisted,
    checksum mismatch, …) — retrying cannot help, unlike transport
    failures."""


class WorkerClient(Logger):
    """Reconnecting worker (ref: veles/client.py Client).

    Jobs execute in a thread-pool executor so the event loop stays
    live mid-job: a heartbeat task pings the coordinator every
    ``heartbeat_interval`` seconds (0 disables), which is what lets
    the master tell "working on a long job" from "dead" without
    waiting out the mean+3σ job watchdog.  Transport losses reconnect
    with capped exponential backoff plus jitter (base
    ``reconnect_delay``, cap ``reconnect_cap``, budget
    ``max_reconnects``) — a coordinator restart must not be greeted by
    every worker at once."""

    def __init__(self, workflow, address, power=None, worker_id=None,
                 reconnect_delay=1.0, max_reconnects=10,
                 reconnect_cap=30.0, heartbeat_interval=1.0):
        super(WorkerClient, self).__init__()
        self.workflow = workflow
        host, _, port = address.rpartition(":")
        self.host, self.port = host or "127.0.0.1", int(port)
        self.power = power
        self.worker_id = worker_id
        self.reconnect_delay = float(reconnect_delay)
        self.reconnect_cap = float(reconnect_cap)
        self.max_reconnects = max_reconnects
        self.heartbeat_interval = float(heartbeat_interval)
        #: the wall seconds of each job this worker ran (the frames'
        #: transfer and coding excluded; a port addition)
        self.job_seconds = []

    def _backoff(self, attempt):
        """Delay before reconnect ``attempt`` (1-based): exponential
        from ``reconnect_delay``, capped at ``reconnect_cap``, with
        half-window jitter so a fleet's retries decorrelate."""
        base = min(self.reconnect_cap,
                   self.reconnect_delay * (2 ** (attempt - 1)))
        return base * (0.5 + 0.5 * random.random())

    async def run(self):
        from veles_tpu_torch.telemetry import metrics
        reconnects = metrics.counter(
            "veles_coordinator_reconnects_total",
            "worker reconnect attempts after a lost coordinator "
            "connection (exponential backoff with jitter)")
        attempts = 0
        while True:
            try:
                await self._session()
                return
            except RejectedError:
                # a protocol-level refusal is permanent — reconnecting
                # would hammer the coordinator and mask the real reason
                raise
            except (ConnectionError, asyncio.IncompleteReadError, OSError):
                attempts += 1
                if attempts > self.max_reconnects:
                    raise ConnectionError(
                        "coordinator unreachable after %d reconnect "
                        "attempts" % self.max_reconnects)
                delay = self._backoff(attempts)
                reconnects.inc()
                self.warning("connection lost — reconnect %d/%d in "
                             "%.2fs", attempts, self.max_reconnects,
                             delay)
                await asyncio.sleep(delay)

    async def _heartbeat(self, writer):
        """Ping until cancelled: the coordinator reads liveness off
        these even while the executor grinds a long job.  A ``drop``
        fault here simulates the half-dead worker (socket open, a job
        in hand, nothing flowing) heartbeat death detection exists
        for."""
        try:
            while True:
                await asyncio.sleep(self.heartbeat_interval)
                if faults.fire("coordinator.worker.heartbeat",
                               key=self.worker_id):
                    continue
                await send_frame(writer, {"cmd": "ping"})
        except (ConnectionError, OSError):
            return  # session teardown races us; the main loop reports

    def _run_job(self, data, on_done):
        """Executor-side job body: the injected-fault hook first (a
        ``hang`` here is a wedged worker whose heartbeats — or their
        injected absence — decide its fate), then the real work."""
        faults.fire("coordinator.worker.job", key=self.worker_id)
        self.workflow.do_job(data, None, on_done)

    async def _session(self):
        import concurrent.futures
        reader, writer = await asyncio.open_connection(self.host, self.port)
        heartbeat = None
        # one dedicated job thread per worker: jobs of THIS worker
        # stay serialized (the pre-executor contract) while the event
        # loop — heartbeats, other in-process workers — keeps running
        executor = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="worker-job")
        try:
            await send_frame(writer, {
                "checksum": self.workflow.checksum(),
                "power": self.power if self.power is not None else 1.0,
                "id": self.worker_id,
            })
            reply = await recv_frame(reader)
            if "error" in reply:
                raise RejectedError(reply["error"])
            self.worker_id = reply["id"]
            self.info("joined as worker %s", self.worker_id)
            if self.heartbeat_interval > 0:
                heartbeat = asyncio.ensure_future(
                    self._heartbeat(writer))
            while True:
                await send_frame(writer, {"cmd": "job"})
                msg = await recv_frame(reader)
                cmd = msg.get("cmd")
                while cmd == "wait":
                    # park until the coordinator pushes resume/terminate
                    # (no busy poll — the coordinator wakes us the moment
                    # an update frees jobs or the run completes)
                    msg = await recv_frame(reader)
                    cmd = msg.get("cmd")
                if cmd == "terminate":
                    return
                if cmd == "resume":
                    continue
                update = {}

                def on_done(data):
                    update["data"] = data

                # the master's trace id brackets the local execution so
                # merged master+worker span logs stitch per job
                trace = msg.get("trace")
                self.event("job.work", "begin", span=trace,
                           trace=trace, worker=self.worker_id)
                t0 = time.time()
                try:
                    # the executor keeps the EVENT LOOP free while the
                    # job grinds: heartbeats (and other workers in the
                    # same process) keep flowing
                    await asyncio.get_running_loop().run_in_executor(
                        executor, functools.partial(
                            self._run_job, msg["data"], on_done))
                finally:
                    self.job_seconds.append(time.time() - t0)
                    self.event("job.work", "end", span=trace,
                               trace=trace, worker=self.worker_id,
                               duration=self.job_seconds[-1])
                await send_frame(writer, {"cmd": "update",
                                          "data": update.get("data")})
        finally:
            if heartbeat is not None:
                heartbeat.cancel()
                with contextlib.suppress(
                        asyncio.CancelledError, Exception):
                    await heartbeat
            # wait=False: a hung job must not wedge session teardown
            # (its thread ends with the hang; the session is gone)
            executor.shutdown(wait=False)
            writer.close()
            with contextlib.suppress(Exception):
                await writer.wait_closed()


async def _watch_spawned(launcher, coord, interval=1.0):
    """End the run when every worker the launcher spawned has exited
    while none is connected: nothing would ever finish it."""
    while True:
        await asyncio.sleep(interval)
        if launcher.workers_alive() is False and not coord.workers:
            launcher.workers_lost = True
            coord.warning("every spawned worker exited before the run "
                          "finished")
            coord.request_stop()
            return


async def _await_spawned_exit(launcher, timeout=60.0, interval=0.1):
    """After the run finished, keep the coordinator listening while a
    worker the launcher spawned still runs, so one that starts late
    joins, is told to terminate and exits cleanly: a closed port would
    leave it in its reconnect backoff until the reap kills it."""
    deadline = time.time() + timeout
    while launcher.workers_alive() and time.time() < deadline:
        await asyncio.sleep(interval)


def serve_master(launcher):
    """Blocking coordinator entry used by the Launcher."""
    host, _, port = (launcher._listen or ":5050").rpartition(":")

    async def _main():
        coord = Coordinator(launcher.workflow, host or "0.0.0.0",
                            int(port or 5050))
        launcher.coordinator = coord  # SlaveStats / web status read it
        await coord.start()
        watch = asyncio.ensure_future(_watch_spawned(launcher, coord))
        await coord.wait_finished()
        watch.cancel()
        await _await_spawned_exit(launcher)
        await coord.stop()

    asyncio.run(_main())


def compute_power(device):
    """A worker's dispatch weight: its card's streaming multiprocessors
    (1.0 on the CPU)."""
    if device is None or device.type != "cuda":
        return 1.0
    import torch
    return float(torch.cuda.get_device_properties(device)
                 .multi_processor_count)


def serve_worker(launcher):
    """Blocking worker entry used by the Launcher."""
    power = compute_power(launcher.device)

    async def _main():
        client = WorkerClient(launcher.workflow,
                              launcher._master_address, power=power)
        launcher.worker_client = client
        await client.run()

    asyncio.run(_main())
