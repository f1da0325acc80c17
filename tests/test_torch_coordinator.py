"""The port's elastic coordinator (``veles_tpu_torch.parallel.
coordinator``) on loopback, coordinator and workers in ONE process —
the cases of ``tests/test_coordinator.py``, the coordinator half of
``tests/test_faults.py`` (heartbeat failover with exact accounting,
reconnect backoff) and the stitched job spans of ``tests/test_health.py``
run against the port — and the master/worker exchange of real
workflows: the port's MNIST master with two workers completes its
epochs, and with one worker it takes the JAX package's steps (the same
weights and minibatches, parameters within 2e-5 in f32, equal epoch
accounting)."""

import asyncio
import pickle
import time

import numpy
import pytest

from veles_tpu_torch import faults
from veles_tpu_torch.parallel.coordinator import (
    Coordinator, WorkerClient, recv_frame, send_frame)

from tests.test_torch_workflow import _close, _jax_params, jax_state

pytestmark = pytest.mark.torch_port


class FakeMasterWorkflow:
    """The IDistributable face the coordinator consumes."""

    def __init__(self, n_jobs=6):
        self.n_jobs = n_jobs
        self.served = 0
        self.applied = []
        self.dropped = []
        self.in_flight = {}

    def checksum(self):
        return "abc123"

    def generate_data_for_slave(self, slave_id):
        self.served += 1
        self.in_flight.setdefault(slave_id, []).append(self.served)
        return {"job_no": self.served}

    def apply_data_from_slave(self, data, slave_id):
        self.applied.append((slave_id, data))
        jobs = self.in_flight.get(slave_id)
        if jobs:
            jobs.pop()

    def drop_slave(self, slave_id):
        # refile the dead worker's in-flight jobs, as the loader does
        self.dropped.append(slave_id)
        self.served -= len(self.in_flight.pop(slave_id, []))

    def has_more_jobs(self):
        return self.served < self.n_jobs

    def all_jobs_done(self):
        return len(self.applied) >= self.n_jobs


class FakeWorkerWorkflow:
    def __init__(self, checksum="abc123"):
        self._checksum = checksum
        self.jobs = []

    def checksum(self):
        return self._checksum

    def do_job(self, data, update, callback):
        self.jobs.append(data)
        callback({"result": data["job_no"] * 10})


def run_loop(coro):
    return asyncio.new_event_loop().run_until_complete(coro)


class _FakeLauncher:
    def __init__(self, mode):
        self.mode = mode

    def add_ref(self, unit):
        pass

    def del_ref(self, unit):
        pass


@pytest.fixture(autouse=True)
def disarm():
    faults.clear()
    yield
    faults.clear()


# -- the coordinator (tests/test_coordinator.py) -----------------------------

def test_job_flow_single_worker():
    async def main():
        master = FakeMasterWorkflow(n_jobs=5)
        coord = Coordinator(master, port=0)
        await coord.start()
        worker_wf = FakeWorkerWorkflow()
        client = WorkerClient(worker_wf, "127.0.0.1:%d" % coord.port,
                              power=2.0)
        await asyncio.wait_for(client.run(), 10)
        await coord.stop()
        return master, worker_wf, coord

    master, worker_wf, coord = run_loop(main())
    assert len(worker_wf.jobs) == 5
    assert len(master.applied) == 5
    assert master.applied[0][1] == {"result": 10}
    # the port's frame accounting: one job and one update frame per job
    assert coord.frame_bytes["jobs"] == coord.frame_bytes["updates"] == 5
    assert coord.frame_bytes["job"] > 0 and coord.frame_bytes["update"] > 0


def test_two_workers_share_jobs():
    async def main():
        master = FakeMasterWorkflow(n_jobs=8)
        coord = Coordinator(master, port=0)
        await coord.start()
        w1, w2 = FakeWorkerWorkflow(), FakeWorkerWorkflow()
        c1 = WorkerClient(w1, "127.0.0.1:%d" % coord.port)
        c2 = WorkerClient(w2, "127.0.0.1:%d" % coord.port)
        await asyncio.wait_for(asyncio.gather(c1.run(), c2.run()), 10)
        await coord.stop()
        return master, w1, w2

    master, w1, w2 = run_loop(main())
    assert len(master.applied) >= 8
    assert len(w1.jobs) + len(w2.jobs) >= 8


def test_checksum_mismatch_rejected():
    async def main():
        coord = Coordinator(FakeMasterWorkflow(), port=0)
        await coord.start()
        bad = WorkerClient(FakeWorkerWorkflow(checksum="WRONG"),
                           "127.0.0.1:%d" % coord.port,
                           max_reconnects=0, reconnect_delay=0.01)
        with pytest.raises(ConnectionError):
            await asyncio.wait_for(bad.run(), 10)
        await coord.stop()

    run_loop(main())


def _mnist_workflow(mode, **keys):
    """The port's MNIST sample in ``mode`` ("master" graphs never run;
    workers run one minibatch per job)."""
    from veles_tpu_torch.samples.mnist import MnistWorkflow
    args = dict(synthetic_train=256, synthetic_valid=64, minibatch_size=32,
                max_epochs=2, layers=(24, 10), dtype="float32",
                snapshotter_config={"enabled": False})
    args.update(keys)
    wf = MnistWorkflow(_FakeLauncher(mode), **args)
    wf.initialize(device="cpu")
    return wf


def test_two_workers_real_workflow_completes():
    """A real workflow trains across TWO async workers and the master's
    sample-count epoch tracking ends the run (the loader's serve-time
    flags are not observable with two workers in flight)."""
    async def main():
        master = _mnist_workflow("master")
        coord = Coordinator(master, port=0)
        await coord.start()
        addr = "127.0.0.1:%d" % coord.port
        w1, w2 = _mnist_workflow("slave"), _mnist_workflow("slave")
        try:
            await asyncio.wait_for(asyncio.gather(
                WorkerClient(w1, addr).run(), WorkerClient(w2, addr).run()),
                120)
            await coord.stop()
        finally:
            for wf in (master, w1, w2):
                wf.stop()
        return master, (w1, w2)

    master, workers = run_loop(main())
    assert master.all_jobs_done()
    assert master.decision._master_epoch >= 2
    assert master.decision.epoch_metrics.get(
        "validation_error_pct") is not None
    # both workers trained every train minibatch of the 2 epochs (an
    # idle worker may start the next epoch's before the last update
    # lands, as in the reference)
    assert all(w.gd.global_step > 0 for w in workers)
    assert sum(w.gd.global_step for w in workers) >= 2 * 256 // 32


def test_dropped_worker_requeues():
    async def main():
        master = FakeMasterWorkflow(n_jobs=3)
        coord = Coordinator(master, port=0)
        await coord.start()
        # a worker that takes a job then vanishes
        reader, writer = await asyncio.open_connection(
            "127.0.0.1", coord.port)
        await send_frame(writer, {"checksum": "abc123", "power": 1.0})
        reply = await recv_frame(reader)
        await send_frame(writer, {"cmd": "job"})
        await recv_frame(reader)  # got the job
        writer.close()            # die without returning the update
        await asyncio.sleep(0.2)
        assert master.dropped == [reply["id"]]
        good = WorkerClient(FakeWorkerWorkflow(),
                            "127.0.0.1:%d" % coord.port)
        await asyncio.wait_for(good.run(), 10)
        await coord.stop()
        return master

    master = run_loop(main())
    assert len(master.applied) >= 3


def test_slow_worker_rejoins_after_one_strike():
    """One timeout drops the worker but does not blacklist it: the
    once-slow worker reconnects and finishes the run."""
    async def main():
        master = FakeMasterWorkflow(n_jobs=2)
        coord = Coordinator(master, port=0, job_timeout=0.2,
                            blacklist_strikes=2, watchdog_interval=0.05)
        await coord.start()
        reader, writer = await asyncio.open_connection(
            "127.0.0.1", coord.port)
        await send_frame(writer, {"checksum": "abc123", "power": 1.0,
                                  "id": "slowpoke"})
        await recv_frame(reader)
        await send_frame(writer, {"cmd": "job"})
        await recv_frame(reader)  # job in hand, now stall
        await asyncio.sleep(0.6)  # > job_timeout: 1 strike
        assert coord.strikes.get("slowpoke") == 1
        assert "slowpoke" not in coord.blacklist
        writer.close()
        good = WorkerClient(FakeWorkerWorkflow(),
                            "127.0.0.1:%d" % coord.port,
                            worker_id="slowpoke")
        await asyncio.wait_for(good.run(), 10)
        await coord.stop()
        return master, coord

    master, coord = run_loop(main())
    assert len(master.applied) >= 2
    assert "slowpoke" not in coord.blacklist
    assert coord.strikes.get("slowpoke") is None


def test_repeat_offender_blacklisted_then_forgiven():
    async def main():
        master = FakeMasterWorkflow(n_jobs=2)
        coord = Coordinator(master, port=0, job_timeout=0.15,
                            blacklist_strikes=2, blacklist_forgive=1e9,
                            watchdog_interval=0.05)
        await coord.start()

        async def stall_once():
            reader, writer = await asyncio.open_connection(
                "127.0.0.1", coord.port)
            await send_frame(writer, {"checksum": "abc123",
                                      "power": 1.0, "id": "lemon"})
            reply = await recv_frame(reader)
            if "error" in reply:
                writer.close()
                return reply["error"]
            await send_frame(writer, {"cmd": "job"})
            await recv_frame(reader)
            await asyncio.sleep(0.5)
            writer.close()
            return None

        assert await stall_once() is None   # strike 1
        assert await stall_once() is None   # strike 2 -> banned
        assert "lemon" in coord.blacklist
        assert await stall_once() == "blacklisted"
        coord.forgive("lemon")
        assert "lemon" not in coord.blacklist
        good = WorkerClient(FakeWorkerWorkflow(),
                            "127.0.0.1:%d" % coord.port,
                            worker_id="lemon")
        await asyncio.wait_for(good.run(), 10)
        await coord.stop()
        return master

    master = run_loop(main())
    assert len(master.applied) >= 2


def test_duration_window_bounded():
    async def main():
        coord = Coordinator(FakeMasterWorkflow(n_jobs=600), port=0)
        await coord.start()
        client = WorkerClient(FakeWorkerWorkflow(),
                              "127.0.0.1:%d" % coord.port)
        await asyncio.wait_for(client.run(), 60)
        await coord.stop()
        return coord

    coord = run_loop(main())
    assert len(coord.job_durations) <= Coordinator.DURATION_WINDOW


# -- faults (tests/test_faults.py) -------------------------------------------

def test_dead_worker_heartbeat_failover_exact_epoch():
    """A worker that goes silent mid-job (its job hangs, its heartbeats
    stop) is declared dead by the heartbeat tier, its job frame goes to
    the live worker, and every job is applied exactly once."""
    from veles_tpu_torch.telemetry import metrics
    reassigned = metrics.counter("veles_coordinator_reassigned_total")
    before = reassigned.value
    faults.inject("coordinator.worker.job", "hang", arg=1.5, times=1,
                  key="wA")
    faults.inject("coordinator.worker.heartbeat", "drop", after=2,
                  key="wA")

    async def main():
        master = FakeMasterWorkflow(n_jobs=4)
        coord = Coordinator(master, port=0, job_timeout=30.0,
                            watchdog_interval=0.05, heartbeat_timeout=0.4)
        await coord.start()
        addr = "127.0.0.1:%d" % coord.port
        dead = WorkerClient(FakeWorkerWorkflow(), addr, worker_id="wA",
                            heartbeat_interval=0.05, reconnect_delay=0.05,
                            max_reconnects=5)
        live = WorkerClient(FakeWorkerWorkflow(), addr, worker_id="wB",
                            heartbeat_interval=0.05)
        dead_task = asyncio.ensure_future(dead.run())
        await asyncio.wait_for(live.run(), 30)
        try:
            await asyncio.wait_for(dead_task, 10)
        except (ConnectionError, asyncio.TimeoutError, TimeoutError):
            dead_task.cancel()
        await coord.stop()
        return master

    master = run_loop(main())
    assert len(master.applied) == 4
    assert master.all_jobs_done()
    assert "wA" in master.dropped
    assert not any(master.in_flight.values())
    assert any(wid == "wB" for wid, _ in master.applied)
    assert reassigned.value >= before + 1


def test_worker_reconnect_backoff():
    """Reconnects back off exponentially with jitter under a capped
    budget, counted in ``veles_coordinator_reconnects_total``."""
    from veles_tpu_torch.telemetry import metrics
    counter = metrics.counter("veles_coordinator_reconnects_total")
    before = counter.value
    client = WorkerClient(FakeWorkerWorkflow(), "127.0.0.1:1",
                          reconnect_delay=0.05, max_reconnects=3)
    t0 = time.monotonic()
    with pytest.raises(ConnectionError, match="after 3 reconnect"):
        run_loop(asyncio.wait_for(client.run(), 30))
    assert time.monotonic() - t0 >= 0.17
    assert counter.value == before + 3
    assert client._backoff(1) <= 0.05
    assert client._backoff(10) <= client.reconnect_cap


def test_dispatch_fault_drops_a_job_frame():
    """``coordinator.dispatch`` armed for one worker: its job request
    gets no frame, so it holds no job while the other worker finishes
    every job, and the run's terminate releases it."""
    faults.inject("coordinator.dispatch", "drop", times=1, key="wX")

    async def main():
        master = FakeMasterWorkflow(n_jobs=3)
        coord = Coordinator(master, port=0)
        await coord.start()
        addr = "127.0.0.1:%d" % coord.port
        quiet = WorkerClient(FakeWorkerWorkflow(), addr, worker_id="wX",
                             heartbeat_interval=0)
        task = asyncio.ensure_future(quiet.run())
        await asyncio.sleep(0.1)
        await asyncio.wait_for(
            WorkerClient(FakeWorkerWorkflow(), addr, worker_id="wY").run(),
            10)
        await coord.stop()
        await asyncio.wait_for(task, 10)
        return master

    master = run_loop(main())
    assert len(master.applied) == 3
    assert all(wid == "wY" for wid, _ in master.applied)


# -- stitched job spans (tests/test_health.py) -------------------------------

def test_coordinator_job_trace_ids():
    """Every dispatched job carries a trace id recorded as paired
    master-side ``job`` spans and worker-side ``job.work`` spans sharing
    the id."""
    from veles_tpu_torch.logger import events
    before = len(events.ring)

    async def main():
        coord = Coordinator(FakeMasterWorkflow(n_jobs=3), port=0)
        await coord.start()
        await WorkerClient(FakeWorkerWorkflow(),
                           "127.0.0.1:%d" % coord.port).run()
        await coord.stop()

    run_loop(main())
    tail = list(events.ring)[before:]
    job_begins = {ev["span"] for ev in tail
                  if ev["name"] == "job" and ev["kind"] == "begin"}
    job_ends = {ev["span"] for ev in tail
                if ev["name"] == "job" and ev["kind"] == "end"}
    work_spans = {ev["span"] for ev in tail if ev["name"] == "job.work"}
    assert len(job_begins) == 3
    assert job_ends <= job_begins and job_ends
    assert work_spans == job_begins
    assert all(ev.get("worker") for ev in tail
               if ev["name"] in ("job", "job.work"))


# -- one worker: the port's exchange against the JAX package's ---------------

MNIST = dict(synthetic_train=96, synthetic_valid=32, minibatch_size=32,
             layers=(24, 10))


def _serve_pair(master, worker, coordinator_cls, client_cls):
    async def main():
        coord = coordinator_cls(master, port=0)
        await coord.start()
        await asyncio.wait_for(
            client_cls(worker, "127.0.0.1:%d" % coord.port).run(), 120)
        await coord.stop()
    run_loop(main())


def _record_epochs(decision):
    """Each closed epoch's ``epoch_metrics`` on the master, in order."""
    rows = []
    orig = decision._on_epoch_ended

    def wrapped():
        orig()
        rows.append(dict(decision.epoch_metrics))
    decision._on_epoch_ended = wrapped
    return rows


def test_one_worker_matches_reference(tmp_path):
    """One worker, two epochs: the port's master and worker take the
    JAX package's steps from the same weights over the same minibatches:
    the master's parameters within 2e-5 after the same jobs, every
    closed epoch's metrics within 2e-5, the same sample counts."""
    from veles_tpu.parallel import coordinator as jcoord
    from veles_tpu.samples.mnist import MnistWorkflow as JaxMnist
    from veles_tpu_torch.convert import load_workflow_params, params_to_numpy
    keys = dict(MNIST, max_epochs=2, snapshot_time_interval=1e9)
    keys.pop("layers")
    with jax_state("mnist_tpu", tmp_path / "jax", **keys):
        from veles_tpu import prng
        from veles_tpu.backends import Device
        jwfs = {}
        # the JAX loaders shuffle from ONE process-wide generator, the
        # port's each from its own: the worker is built first and the
        # generator reseeded, so the master's shuffles are the stream a
        # port loader draws alone (a worker's own shuffle is unused: its
        # jobs carry the indices)
        for mode in ("slave", "master"):
            prng.get("loader").seed(42)
            wf = JaxMnist(_FakeLauncher(mode), layers=MNIST["layers"],
                          plotters=False)
            wf.initialize(device=Device(backend="numpy"))
            jwfs[mode] = wf
        jmaster, jworker = jwfs["master"], jwfs["slave"]
        jrows = _record_epochs(jmaster.decision)
        params = _jax_params(jmaster.forwards)
        try:
            _serve_pair(jmaster, jworker, jcoord.Coordinator,
                        jcoord.WorkerClient)
        finally:
            jmaster.stop()
            jworker.stop()
        want = _jax_params(jmaster.forwards)
        jsteps = jworker.gd.global_step
        jserved = jmaster.loader.samples_served
    pmaster = _mnist_workflow("master", **dict(MNIST, synthetic_train=96,
                                               synthetic_valid=32))
    pworker = _mnist_workflow("slave", **MNIST)
    load_workflow_params(pmaster, params)
    prows = _record_epochs(pmaster.decision)
    try:
        _serve_pair(pmaster, pworker, Coordinator, WorkerClient)
    finally:
        pmaster.stop()
        pworker.stop()
    got = params_to_numpy(pmaster.gd.forwards)
    assert len(prows) == len(jrows) == 2
    for grow, wrow in zip(prows, jrows):
        assert sorted(grow) == sorted(wrow)
        for k in wrow:
            _close(grow[k], wrow[k])
    assert pworker.gd.global_step == jsteps == 2 * 96 // 32
    assert pmaster.loader.samples_served == jserved == 2 * 128
    for i in want:
        for n in want[i]:
            _close(got[i][n], want[i][n])
    assert numpy.any(got[0]["weights"] != params[0]["weights"])


def test_slow_job_frame_is_not_worker_silence(monkeypatch):
    """A job frame that takes the master longer to encode than the
    heartbeat timeout (a model's parameters) does not make its pinging
    worker look dead: the master reads nothing from it while it sends,
    so its silence counts from the end of the send (a port addition;
    the reference would drop and requeue every such job)."""
    from veles_tpu_torch.parallel import coordinator as coord_mod
    encode = coord_mod._encode

    def slow(obj, compress):
        if isinstance(obj, dict) and obj.get("cmd") == "job":
            time.sleep(0.6)
        return encode(obj, compress)

    monkeypatch.setattr(coord_mod, "_encode", slow)

    async def main():
        master = FakeMasterWorkflow(n_jobs=3)
        coord = Coordinator(master, port=0, watchdog_interval=0.05,
                            heartbeat_timeout=0.3)
        await coord.start()
        await asyncio.wait_for(WorkerClient(
            FakeWorkerWorkflow(), "127.0.0.1:%d" % coord.port,
            worker_id="w", heartbeat_interval=0.05).run(), 20)
        await coord.stop()
        return master

    master = run_loop(main())
    assert master.dropped == [] and len(master.applied) == 3


@pytest.mark.parametrize("kind", ["params", "records"])
def test_frames_gzip_only_where_it_pays(kind):
    """A frame of float32 parameters goes on the wire raw and one of
    repetitive records gzipped (a port addition: the reference gzips
    every frame over 4 KB); the JAX package's reader decodes both to
    the object sent."""
    from veles_tpu.parallel import coordinator as ref
    from veles_tpu_torch.parallel import coordinator as port
    rng = numpy.random.default_rng(0)
    if kind == "params":
        obj = {"params": {0: {"weights": rng.standard_normal(
            1 << 19).astype(numpy.float32)}}}
    else:
        obj = {"rows": [{"unit": "u%d" % (i % 7), "n": i % 3}
                        for i in range(100000)]}
    assert len(pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)) \
        > port._GZIP_PROBE
    blob, flags = port._encode(obj, True)
    assert bool(flags & port._FLAG_GZIP) == (kind == "records")

    async def main():
        reader = asyncio.StreamReader()
        reader.feed_data(port._HDR.pack(len(blob), flags) + blob)
        reader.feed_eof()
        return await ref.recv_frame(reader)

    got = run_loop(main())
    if kind == "params":
        assert numpy.array_equal(got["params"][0]["weights"],
                                 obj["params"][0]["weights"])
    else:
        assert got == obj
