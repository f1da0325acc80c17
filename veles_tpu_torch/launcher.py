"""Launcher — the composition root of a command-line run (the port of
``veles_tpu/launcher.py``, standalone mode).

It owns the run's mode, its device and the workflow's lifecycle: the
top-level workflow adopts the launcher as its parent, ``initialize``
puts the workflow on the device, ``run`` runs it to completion and
``stop`` reports.  Only the standalone mode is ported: a coordinator
(``listen``) or a worker (``master_address``) raises and names ROADMAP
item 10, which brings the master/worker exchange.

``profile_dir`` is the counterpart of the reference's
``jax.profiler.start_trace``: the run is recorded by ``torch.profiler``
with CPU (and, on the card, CUDA) activity and written into the
directory as a Chrome trace; the workflow's ``trace_run`` is set, so
every unit run is a named range in it.
"""

import json
import os
import resource
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

    def __init__(self, backend=None, device_index=0, listen=None,
                 master_address=None, profile_dir=None, **kwargs):
        super(Launcher, self).__init__()
        self._listen = listen
        self._master_address = master_address
        if not self.is_standalone:
            raise NotImplementedError(
                "the %s mode is not ported yet: the master/worker "
                "exchange is ROADMAP item 10" % self.mode)
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
        """Resolve the device (raises without a card unless ``-a cpu``)
        and initialize the workflow on it."""
        if self.device is None:
            self.device = resolve_device(
                backend_device(self._backend, self._device_index))
        self.info("mode: %s, device: %s", self.mode, self.device)
        self.workflow.initialize(device=self.device, **kwargs)

    def run(self):
        """Run the workflow to completion, then :meth:`stop`."""
        self.start_time = time.time()
        if self._profile_dir:
            self._start_profiler()
        try:
            self.workflow.run()
        finally:
            self.stop()

    def _start_profiler(self):
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if self.device is not None and self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        os.makedirs(self._profile_dir, exist_ok=True)
        # per-unit record_function ranges ride the workflow's trace_run
        # (the reference's root.common.trace.run)
        self.workflow.trace_run = True
        self._profiler = profile(activities=activities)
        self._profiler.__enter__()
        self.info("torch.profiler trace -> %s", self._profile_dir)

    def _stop_profiler(self):
        prof, self._profiler = self._profiler, None
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof.__exit__(None, None, None)
        self.profile_path = os.path.join(
            self._profile_dir, "trace-%d.json" % os.getpid())
        prof.export_chrome_trace(self.profile_path)
        self.info("profile -> %s", self.profile_path)

    def boot(self, **kwargs):
        self.initialize(**kwargs)
        self.run()

    def stop(self):
        if self.stopped:
            return
        self.stopped = True
        if self._profiler is not None:
            self._stop_profiler()
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

    def write_results(self, path):
        """The workflow's gathered metrics, the run's wall time and the
        snapshot written last, as JSON at ``path``."""
        from veles_tpu_torch.snapshotter import SnapshotterBase
        metrics = self.workflow.gather_results()
        metrics["elapsed_sec"] = time.time() - (self.start_time
                                                or time.time())
        for u in self.workflow.units:
            if isinstance(u, SnapshotterBase) \
                    and getattr(u, "destination", None):
                metrics["Snapshot"] = u.destination
        with open(path, "w") as f:
            json.dump(metrics, f, indent=2, default=str)
        self.info("results -> %s", path)
        return metrics
