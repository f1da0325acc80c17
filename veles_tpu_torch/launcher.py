"""Launcher — the composition root of a command-line run (the port of
``veles_tpu/launcher.py``).

It owns the run's mode, its device and the workflow's lifecycle: the
top-level workflow adopts the launcher as its parent, ``initialize``
joins the process gang when one is configured
(:func:`veles_tpu_torch.parallel.multihost.initialize`) and puts the
workflow on the device, ``run`` runs it and ``stop`` reports.  The
modes are the reference's: standalone runs the workflow to completion;
a master (``listen``) serves jobs from its workflow through the elastic
coordinator (:func:`~veles_tpu_torch.parallel.coordinator.serve_master`),
after spawning ``workers`` (a count of local processes, or host specs
``host[/D]``, remote ones over ``ssh``); a worker (``master_address``)
takes jobs from its master
(:func:`~veles_tpu_torch.parallel.coordinator.serve_worker`).  A master
whose device is a card builds every kernel once before it spawns, so
its workers find them built instead of all running ``nvcc`` at once.
A worker prints one ``veles-worker-report {json}`` line when it stops
(its train steps, its jobs and the seconds it worked on them, and its
kernel launches); the master reads it from the
worker's log and puts the reports, and its coordinator's job counts
and frame bytes, into its results.

Two services observe a run that is not a worker's: ``graphics`` (the
command line's ``-g``, else ``root.common.graphics.enabled``) starts a
:class:`~veles_tpu_torch.graphics_server.GraphicsServer` at
``initialize`` (on ``root.common.graphics.port``, 0 picking one), through
which the workflow's plotters publish; ``status_url`` (``--web-status``,
else ``root.common.web.status_url``) starts a
:class:`~veles_tpu_torch.web_status.StatusNotifier` POSTing the run's
status there while it runs.  ``stop`` closes both.

``profile_dir`` is the counterpart of the reference's
``jax.profiler.start_trace``: the run is recorded by ``torch.profiler``
with CPU (and, on the card, CUDA) activity and written into the
directory as a Chrome trace; the workflow's ``trace_run`` is set, so
every unit run is a named range in it.
"""

import json
import resource
import subprocess
import time

import torch

from veles_tpu_torch.backends import resolve_device
from veles_tpu_torch.cmdline import backend_device
from veles_tpu_torch.logger import Logger
from veles_tpu_torch.memory import Watcher


class Launcher(Logger):
    """Mode detection as the reference's: ``listen`` → coordinator
    ("master"), ``master_address`` → worker ("slave"), else
    standalone."""

    #: the line a worker prints when it stops, before its JSON report
    REPORT_TAG = "veles-worker-report"

    #: live services and handles: a snapshot of the workflow (which
    #: reaches its launcher as its parent) holds None in their place
    VOLATILE = ("graphics_server", "status_notifier", "coordinator",
                "worker_client", "_worker_procs", "_profiler")

    def __init__(self, backend=None, device_index=0, listen=None,
                 master_address=None, graphics=None, status_url=None,
                 profile_dir=None, workers=None, worker_cmd_tail=None,
                 **kwargs):
        super(Launcher, self).__init__()
        self._listen = listen
        #: None: root.common.graphics.enabled decides
        self._graphics = graphics
        self._status_url = status_url
        self.graphics_server = None
        self.status_notifier = None
        self._master_address = master_address
        #: worker specs: an int (N local processes), or a list or comma
        #: list of host specs ("localhost" → a subprocess, any other
        #: host → ssh); "host/D" pins the worker to device D
        self._workers = workers
        #: the command tail spawned workers run (workflow file, config,
        #: -c snippets, shared flags); the spawner appends -d and -m
        self._worker_cmd_tail = list(worker_cmd_tail or [])
        self._worker_procs = []
        #: set when every spawned worker exited before the run finished
        self.workers_lost = False
        #: the reports the spawned workers printed when they stopped
        self.worker_reports = []
        #: the master's coordinator while it serves; a worker's client
        self.coordinator = None
        self.worker_client = None
        #: (process id, process count, transport) of the gang
        self.gang = None
        self._backend = backend
        self._device_index = device_index
        self._profile_dir = profile_dir
        self._profiler = None
        #: the Chrome trace the profiler wrote, once stopped
        self.profile_path = None
        self.device = None
        self.workflow = None
        self.start_time = None
        self.stopped = False

    def __getstate__(self):
        return {k: None if k in self.VOLATILE else v
                for k, v in self.__dict__.items()}

    # -- mode -----------------------------------------------------------------

    @property
    def mode(self):
        if self._listen:
            return "master"
        if self._master_address:
            return "slave"
        return "standalone"

    @property
    def is_standalone(self):
        return self.mode == "standalone"

    @property
    def is_master(self):
        return self.mode == "master"

    @property
    def is_slave(self):
        return self.mode == "slave"

    # -- lifecycle ------------------------------------------------------------

    def add_ref(self, workflow):
        """Called by the top-level workflow adopting this launcher as
        its parent."""
        self.workflow = workflow

    def del_ref(self, workflow):
        if self.workflow is workflow:
            self.workflow = None

    def initialize(self, **kwargs):
        """Join the process gang when ``VELES_TPU_COORDINATOR`` /
        ``VELES_TPU_NUM_PROCESSES`` / ``VELES_TPU_PROCESS_ID`` configure
        one, resolve the device (raises without a card unless ``-a
        cpu``) and initialize the workflow on it."""
        from veles_tpu_torch.parallel import multihost
        self.gang = multihost.initialize(
            device=backend_device(self._backend, self._device_index))
        if self.gang.num_processes > 1:
            self.info("process gang: process %d/%d over %s",
                      *self.gang)
        if self.device is None:
            self.device = resolve_device(
                backend_device(self._backend, self._device_index))
        self.info("mode: %s, device: %s", self.mode, self.device)
        from veles_tpu_torch.config import root
        graphics = self._graphics
        if graphics is None:
            graphics = root.common.graphics.get("enabled", False)
        if graphics and not self.is_slave:
            from veles_tpu_torch.graphics_server import GraphicsServer
            self.graphics_server = GraphicsServer(
                port=int(root.common.graphics.get("port", 0) or 0))
        self.workflow.initialize(device=self.device, **kwargs)

    def run(self):
        """Run the workflow to completion (standalone) or serve it (the
        master and worker modes), then :meth:`stop`."""
        from veles_tpu_torch.config import root
        self.start_time = time.time()
        status_url = self._status_url \
            or root.common.web.get("status_url")
        if status_url and not self.is_slave:
            from veles_tpu_torch.web_status import StatusNotifier
            self.status_notifier = StatusNotifier(status_url, self)
            self.status_notifier.start()
        if self._profile_dir:
            self._start_profiler()
        try:
            if self.is_standalone:
                self.workflow.run()
            elif self.is_master:
                if self._workers:
                    self._spawn_workers()
                from veles_tpu_torch.parallel.coordinator import (
                    serve_master)
                serve_master(self)
                if self.workers_lost:
                    raise RuntimeError(
                        "every spawned worker exited before the run "
                        "finished (their logs: %s)"
                        % [log for _, log in self._worker_procs])
            else:
                from veles_tpu_torch.parallel.coordinator import (
                    serve_worker)
                serve_worker(self)
        finally:
            self.stop()

    # -- worker spawning (ref: veles/launcher.py:617-842) ---------------------

    def _spawn_workers(self):
        import shlex
        import socket
        import sys
        import tempfile
        specs = self._workers
        if isinstance(specs, int):
            specs = ["localhost"] * specs
        elif isinstance(specs, str):
            specs = [s for s in specs.split(",") if s]
        host, _, port = (self._listen or ":5050").rpartition(":")
        port = port or "5050"
        if port == "0":
            # spawned workers need a dialable address before the
            # coordinator binds: an OS-assigned port can't reach them
            raise ValueError(
                "-l :0 (OS-assigned port) cannot be combined with -w "
                "worker spawning; pick a fixed port")
        on_card = self.device is not None and self.device.type == "cuda"
        if on_card:
            # one build before the workers start, instead of every
            # worker running nvcc at once
            from veles_tpu_torch import _build
            _build.build_all()
        n_local_devices = torch.cuda.device_count() if on_card else 1
        # a local worker imports the package this master runs
        from veles_tpu_torch.cli_exec import child_env
        env = child_env()
        local_count = 0
        for i, spec in enumerate(specs):
            # "host/D" pins the worker to device D; plain local workers
            # round-robin over this host's devices
            spec, _, dev = spec.partition("/")
            is_local = spec in ("localhost", "127.0.0.1", "")
            if not dev:
                dev = str(local_count % n_local_devices) if is_local \
                    else "0"
            tail = list(self._worker_cmd_tail) + ["-d", dev]
            if is_local:
                tail += ["-m", "%s:%s" % (host or "127.0.0.1", port)]
                cmd = [sys.executable, "-m", "veles_tpu_torch"] + tail
                local_count += 1
            else:
                # a remote worker dials THIS host, not its own loopback;
                # every argument quoted: ssh re-joins argv through the
                # remote shell
                master_host = host if host not in ("", "0.0.0.0") \
                    else socket.getfqdn()
                tail += ["-m", "%s:%s" % (master_host, port)]
                cmd = ["ssh", "-o", "BatchMode=yes", spec,
                       "python3", "-m", "veles_tpu_torch"] + [
                           shlex.quote(a) for a in tail]
            log = tempfile.NamedTemporaryFile(
                mode="wb", suffix=".log", prefix="veles_worker%d_" % i,
                delete=False)
            proc = subprocess.Popen(cmd, stdout=log, stderr=log,
                                    env=env if is_local else None)
            log.close()
            self._worker_procs.append((proc, log.name))
            self.info("spawned worker %d on %s dev %s (pid %d, log %s)",
                      i, spec or "localhost", dev, proc.pid, log.name)

    def workers_alive(self):
        """Whether a worker this launcher spawned still runs (None when
        it spawned none)."""
        if not self._worker_procs:
            return None
        return any(proc.poll() is None for proc, _ in self._worker_procs)

    def _reap_workers(self, timeout=30.0):
        """Wait for the spawned workers (killing one that outlives
        ``timeout``), collect the report each printed, and log the tail
        of a failed one's log."""
        for proc, log in self._worker_procs:
            try:
                rc = proc.wait(timeout)
            except subprocess.TimeoutExpired:
                proc.kill()
                rc = proc.wait(5)
            try:
                with open(log, "rb") as f:
                    text = f.read().decode(errors="replace")
            except OSError:
                text = "<no log>"
            report = {"pid": proc.pid, "rc": rc}
            for line in text.splitlines():
                if line.startswith(self.REPORT_TAG + " "):
                    report.update(json.loads(line.split(" ", 1)[1]))
            self.worker_reports.append(report)
            if rc:
                self.warning("worker pid %d exited rc=%d: %s",
                             proc.pid, rc, text[-500:])
        self._worker_procs = []

    def _start_profiler(self):
        from veles_tpu_torch.telemetry.compile_tracker import (
            maybe_profiler_trace)
        # per-unit record_function ranges ride the workflow's trace_run
        # (the reference's root.common.trace.run)
        self.workflow.trace_run = True
        capture = maybe_profiler_trace(self._profile_dir, self.device)
        self._profiler = (capture, capture.__enter__())
        self.info("torch.profiler trace -> %s", self._profile_dir)

    def _stop_profiler(self):
        (capture, out), self._profiler = self._profiler, None
        capture.__exit__(None, None, None)
        self.profile_path = out["path"]
        self.info("profile -> %s", self.profile_path)

    def boot(self, **kwargs):
        self.initialize(**kwargs)
        self.run()

    def stop(self):
        if self.stopped:
            return
        self.stopped = True
        if self._worker_procs:
            self._reap_workers()
        if self.is_slave:
            from veles_tpu_torch.ops import kernel_launches
            jobs = getattr(self.worker_client, "job_seconds", [])
            print("%s %s" % (self.REPORT_TAG, json.dumps(
                {"launches": kernel_launches(),
                 "steps": int(getattr(self._trainer(), "global_step", 0)),
                 "jobs": len(jobs), "job_work_seconds": sum(jobs)})),
                flush=True)
        if self._profiler is not None:
            self._stop_profiler()
        if self.status_notifier is not None:
            self.status_notifier.stop()
        if self.graphics_server is not None:
            self.graphics_server.close()
        elapsed = time.time() - (self.start_time or time.time())
        self.workflow.stop()
        self.workflow.print_stats()
        _, peak = Watcher.report()
        if self.device is not None and self.device.type == "cuda":
            peak = max(peak, torch.cuda.max_memory_allocated(self.device))
        rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        self.info("total run time: %.2fs; peak RSS: %.1f MiB; "
                  "peak device mem: %.1f MiB",
                  elapsed, rss / 1024.0, peak / 2 ** 20)

    # -- results --------------------------------------------------------------

    def _trainer(self):
        from veles_tpu_torch.models.gd import GradientDescent
        for u in getattr(self.workflow, "units", ()):
            if isinstance(u, GradientDescent):
                return u
        return None

    def coordinator_stats(self):
        """The master's coordinator after the run: the job and update
        frames it exchanged, the mean of ``veles_coordinator_job_seconds``
        (the process's job round trips) and the mean wire bytes of a
        job frame and of an update frame."""
        c = self.coordinator
        if c is None:
            return None
        fb = c.frame_bytes
        return {"jobs": fb["jobs"], "updates": fb["updates"],
                "job_seconds_mean": c._metrics["job_seconds"].mean(),
                "job_frame_bytes": fb["job"] / max(fb["jobs"], 1),
                "update_frame_bytes": fb["update"] / max(fb["updates"], 1)}

    def write_results(self, path):
        """The workflow's gathered metrics, the run's wall time and the
        snapshot written last, as JSON at ``path``; a master adds its
        coordinator's stats and its workers' reports."""
        from veles_tpu_torch.snapshotter import SnapshotterBase
        metrics = self.workflow.gather_results()
        metrics["elapsed_sec"] = time.time() - (self.start_time
                                                or time.time())
        if self.is_master:
            metrics["Coordinator"] = self.coordinator_stats()
            metrics["Workers"] = self.worker_reports
        for u in self.workflow.units:
            if isinstance(u, SnapshotterBase) \
                    and getattr(u, "destination", None):
                metrics["Snapshot"] = u.destination
        with open(path, "w") as f:
            json.dump(metrics, f, indent=2, default=str)
        self.info("results -> %s", path)
        return metrics
