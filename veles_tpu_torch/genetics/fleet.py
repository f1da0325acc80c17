"""Distributed GA evaluation over the elastic coordinator (the port of
``veles_tpu/genetics/fleet.py``, over the port's
:mod:`veles_tpu_torch.parallel.coordinator`): the optimizer pushes each
generation's individuals into a :class:`Coordinator` as jobs
(payload = config overrides + seed), workers evaluate them — normally
by the same CLI-subprocess contract as local mode — and send the
fitness back as the update.  Between generations workers park on the
coordinator's wait/resume push (no polling), so one fleet spans the
whole optimization like the reference's master/slave GA.

Master side: :class:`FleetJobSource` (the IDistributable face the
coordinator consumes) + :class:`CoordinatorEvaluator` (plugs into
``GeneticsOptimizer`` as its batch evaluator).
Worker side: :func:`serve_fleet_worker` (blocking; pass the same
``evaluate`` callable the local optimizer would use).
"""

import asyncio
import queue
import threading

from veles_tpu_torch.logger import Logger


class FleetJobSource(Logger):
    """Thread-safe job queue with the coordinator's workflow face.

    Jobs: ``{"job_id", "overrides", "seed"}``; updates:
    ``{"job_id", "fitness"}``.  ``finish()`` ends the run (workers get
    terminate); until then an empty queue just parks workers.
    """

    def __init__(self, checksum="genetics-fleet"):
        super(FleetJobSource, self).__init__()
        self._checksum = checksum
        self._jobs = queue.Queue()
        self._in_flight = {}     # job_id -> (job, worker_id)
        self._results = {}       # job_id -> fitness|None
        self._result_event = threading.Event()
        self._finished = False
        self._lock = threading.Lock()
        self._next_id = 0

    # -- optimizer side --------------------------------------------------------

    def submit(self, overrides, seed):
        """Enqueue one individual; returns its job id."""
        with self._lock:
            jid = self._next_id
            self._next_id += 1
        self._jobs.put({"job_id": jid, "overrides": list(overrides),
                        "seed": int(seed)})
        return jid

    def wait_all(self, job_ids, timeout=None):
        """Block until every job id has a result; returns
        {job_id: fitness|None}."""
        import time
        deadline = None if timeout is None else time.time() + timeout
        while True:
            with self._lock:
                if all(j in self._results for j in job_ids):
                    return {j: self._results[j] for j in job_ids}
            if deadline is not None and time.time() > deadline:
                raise TimeoutError("fleet evaluation timed out")
            self._result_event.wait(0.1)
            self._result_event.clear()

    def finish(self):
        self._finished = True

    # -- the coordinator's face of a workflow ----------------------------------

    def checksum(self):
        return self._checksum

    def has_more_jobs(self):
        return not self._jobs.empty()

    def all_jobs_done(self):
        return self._finished

    def generate_data_for_slave(self, worker_id):
        job = self._jobs.get_nowait()
        with self._lock:
            self._in_flight[job["job_id"]] = (job, worker_id)
        return job

    def apply_data_from_slave(self, data, worker_id):
        jid = data["job_id"]
        with self._lock:
            self._in_flight.pop(jid, None)
            self._results[jid] = data.get("fitness")
        self._result_event.set()

    def drop_slave(self, worker_id):
        """Requeue the dead worker's in-flight individuals."""
        with self._lock:
            requeue = [job for jid, (job, wid) in
                       list(self._in_flight.items()) if wid == worker_id]
            for job in requeue:
                del self._in_flight[job["job_id"]]
        for job in requeue:
            self._jobs.put(job)
        if requeue:
            self.info("requeued %d individual(s) from dropped worker %s",
                      len(requeue), worker_id)


class CoordinatorEvaluator(Logger):
    """Batch evaluator backed by a coordinator fleet.

    Plugs into :class:`~veles_tpu_torch.genetics.optimizer.GeneticsOptimizer`
    (which prefers ``evaluate_batch`` when the evaluator has one).
    Owns the coordinator: it runs on a background asyncio thread for
    the whole optimization.
    """

    def __init__(self, checksum="genetics-fleet", host="127.0.0.1",
                 port=0, job_timeout=600.0, result_timeout=None):
        super(CoordinatorEvaluator, self).__init__()
        from veles_tpu_torch.parallel.coordinator import Coordinator
        self.source = FleetJobSource(checksum)
        self.result_timeout = result_timeout
        self._coord = Coordinator(self.source, host=host, port=port,
                                  job_timeout=job_timeout)
        self._loop = None
        self._started = threading.Event()
        self._thread = threading.Thread(target=self._serve, daemon=True,
                                        name="genetics-fleet")
        self._thread.start()
        self._started.wait(10)
        self.port = self._coord.port

    def _serve(self):
        async def main():
            await self._coord.start()
            self._loop = asyncio.get_event_loop()
            self._started.set()
            await self._coord.wait_finished()
            await self._coord.stop()

        asyncio.run(main())

    def evaluate_batch(self, batch):
        """batch: [(overrides, seed)] -> [fitness|None] in order."""
        ids = [self.source.submit(ov, seed) for ov, seed in batch]
        # wake workers parked since the previous generation drained —
        # submit() runs on the optimizer thread, outside the protocol
        # flow the coordinator's own wake piggybacks on
        self._coord.notify_jobs()
        results = self.source.wait_all(ids, timeout=self.result_timeout)
        return [results[i] for i in ids]

    def __call__(self, overrides, seed):
        return self.evaluate_batch([(overrides, seed)])[0]

    def close(self):
        """End the optimization: workers get terminate, the coordinator
        drains and stops."""
        self.source.finish()
        self._coord.request_stop()
        self._thread.join(15)


class _FleetWorkerFace:
    """Worker-side workflow face: do_job evaluates one individual."""

    def __init__(self, evaluate, checksum):
        self._evaluate = evaluate
        self._checksum = checksum

    def checksum(self):
        return self._checksum

    def do_job(self, job, update, callback):
        fitness = self._evaluate(job["overrides"], seed=job["seed"])
        callback({"job_id": job["job_id"], "fitness": fitness})


def serve_fleet_worker(address, evaluate, checksum="genetics-fleet",
                       worker_id=None, max_reconnects=10):
    """Blocking fleet worker: joins the coordinator at ``address`` and
    evaluates individuals with ``evaluate(overrides, seed)`` (same
    contract as the local :class:`SubprocessEvaluator`)."""
    from veles_tpu_torch.parallel.coordinator import WorkerClient

    async def main():
        client = WorkerClient(_FleetWorkerFace(evaluate, checksum),
                              address, worker_id=worker_id,
                              max_reconnects=max_reconnects)
        await client.run()

    asyncio.run(main())
