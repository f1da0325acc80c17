"""Workflow — the unit container and scheduler (the port of
``veles_tpu/workflow.py``).

A Workflow owns a set of Units plus ``start_point``/``end_point``,
initializes them in dependency order (with re-queue on unsatisfied
demands), and runs the graph to completion with a deterministic worklist
scheduler (see :mod:`veles_tpu_torch.units`).

A Workflow is itself a Unit, so workflows nest (ref: workflow.py:87).
The top-level workflow takes its mode (standalone / coordinator /
worker) from its parent :class:`~veles_tpu_torch.launcher.Launcher`
when the command line runs it, and is standalone without one.  The reference's ``root.common`` keys the units read become
keyword arguments of the top-level workflow under the reference's
names: ``trace_run`` and ``timings`` (see :mod:`veles_tpu_torch.units`;
the command line fills them from ``root.common``).
"""

import hashlib
import inspect
import time
from collections import deque

from veles_tpu_torch.mutable import Bool
from veles_tpu_torch.plumbing import StartPoint, EndPoint
from veles_tpu_torch.result_provider import IResultProvider
from veles_tpu_torch.units import MissingDemand, Unit


class NoMoreJobs(Exception):
    """Raised by the data feed when the job queue is exhausted
    (ref: veles/workflow.py:500-502)."""


class Workflow(Unit):
    """Directed graph of units with start/end points
    (ref: veles/workflow.py:87)."""

    hide_from_registry = True

    def __init__(self, workflow=None, name=None, trace_run=False,
                 timings=False, **kwargs):
        self.units = []          # before super() — add_ref may fire early
        self._sched_queue_ = deque()
        super(Workflow, self).__init__(workflow, name=name, **kwargs)
        self.trace_run = trace_run
        self.timings = timings
        self.stopped = Bool(False, "stopped")
        self.start_point = StartPoint(self)
        self.end_point = EndPoint(self)
        self._run_time = 0.0

    def init_unpickled(self):
        super(Workflow, self).init_unpickled()
        self._sched_queue_ = deque()
        # volatile (often a launcher closure) — never snapshotted
        self.run_is_finished_callback_ = None

    # -- membership ---------------------------------------------------------

    def add_ref(self, unit):
        if unit is not self and unit not in self.units:
            self.units.append(unit)

    def del_ref(self, unit):
        if unit in self.units:
            self.units.remove(unit)

    def __iter__(self):
        return iter(self.units)

    def __len__(self):
        return len(self.units)

    def __getitem__(self, key):
        """Units by name or index (ref: workflow.py:~250)."""
        if isinstance(key, str):
            for u in self.units:
                if u.name == key:
                    return u
            raise KeyError(key)
        return self.units[key]

    # -- mode flags (delegated to the launcher) ----------------------------

    @property
    def launcher(self):
        w = self._workflow
        while isinstance(w, Workflow):
            w = w._workflow
        return w

    @property
    def is_standalone(self):
        l = self.launcher
        return l.mode == "standalone" if l is not None else True

    @property
    def is_master(self):
        l = self.launcher
        return l.mode == "master" if l is not None else False

    @property
    def is_slave(self):
        l = self.launcher
        return l.mode == "slave" if l is not None else False

    # -- initialization (ref: workflow.py:303-341) --------------------------

    def initialize(self, **kwargs):
        """Initialize all units in dependency order: a unit raising
        :class:`MissingDemand` is re-queued until its supplier has
        initialized; no-progress passes raise."""
        self.verify_demands()
        pending = list(self.units)
        while pending:
            requeue, last_err = [], None
            for u in pending:
                try:
                    u.initialize(**kwargs)
                except MissingDemand as e:
                    requeue.append(u)
                    last_err = e
            if len(requeue) == len(pending):
                raise last_err
            pending = requeue
        self._is_initialized = True

    # -- scheduling ---------------------------------------------------------

    def schedule(self, unit, src):
        self._sched_queue_.append((unit, src))

    def run(self):
        """Run the graph to completion (one full wave from start_point
        until end_point fires or the queue drains)
        (ref: workflow.py:351-377).  The wave is one paired span in
        the event log."""
        from veles_tpu_torch.telemetry import metrics, next_span_id
        self.stopped.set(False)
        self._sched_queue_.clear()
        t0 = time.time()
        span_id = next_span_id()
        self.event("workflow run", "begin", workflow=self.name,
                   span=span_id)
        try:
            self.schedule(self.start_point, None)
            while self._sched_queue_ and not self.stopped:
                unit, src = self._sched_queue_.popleft()
                unit._check_gate_and_run(src)
        finally:
            dt = time.time() - t0
            self._run_time += dt
            self.event("workflow run", "end", workflow=self.name,
                       span=span_id, duration=dt)
            metrics.histogram(
                "veles_workflow_run_seconds",
                "wall time of one full workflow wave",
                ("workflow",)).labels(self.name).observe(dt)
        if self.run_is_finished_callback_ is not None:
            self.run_is_finished_callback_()

    def on_workflow_finished(self):
        self.stopped.set(True)

    def stop(self):
        self.stopped.set(True)
        for u in self.units:
            u.stop()

    # -- master–worker aggregation (IDistributable over all units,
    #    ref: workflow.py:478-558), driven by the elastic coordinator
    #    (parallel/coordinator.py) in the launcher's master and worker
    #    modes -----------------------------------------------------------

    def _unit_keys(self):
        # unique payload keys: units may share a default name, and
        # construction order is deterministic on both ends
        return {u: "%s#%d" % (u.name, i)
                for i, u in enumerate(self.units)}

    def generate_data_for_slave(self, slave=None):
        return {k: u.generate_data_for_slave(slave)
                for u, k in self._unit_keys().items()
                if u.negotiates_on_connect}

    def apply_data_from_master(self, data):
        for u, k in self._unit_keys().items():
            if u.negotiates_on_connect and k in data:
                u.apply_data_from_master(data[k])

    def generate_data_for_master(self):
        return {k: u.generate_data_for_master()
                for u, k in self._unit_keys().items()
                if u.negotiates_on_connect}

    def apply_data_from_slave(self, data, slave=None):
        for u, k in self._unit_keys().items():
            if u.negotiates_on_connect and k in data:
                u.apply_data_from_slave(data[k], slave)

    def drop_slave(self, slave=None):
        for u in self.units:
            if u.negotiates_on_connect:
                u.drop_slave(slave)

    def do_job(self, data, update, callback):
        """Worker-side: apply job payload, run the local graph, send the
        update back (ref: workflow.py:558)."""
        self.apply_data_from_master(data)
        if update is not None:
            self.apply_data_from_master(update)
        self.run()
        callback(self.generate_data_for_master())

    def has_more_jobs(self):
        """Coordinator-side: keep serving until a unit (the Decision)
        declares the workflow finished (ref NoMoreJobs flow:
        veles/workflow.py:500-502)."""
        return not bool(self.stopped)

    def all_jobs_done(self):
        return bool(self.stopped)

    # -- results (ref: workflow.py:827-849) ---------------------------------

    def gather_results(self):
        metrics = {}
        for u in self.units:
            if isinstance(u, IResultProvider):
                metrics.update(u.get_metric_values() or {})
        return metrics

    # -- introspection ------------------------------------------------------

    def package_export(self, path, batch=None):
        """Export the forward chain as an inference package
        (:mod:`veles_tpu_torch.package_export`; the C++ runner in
        ``runtime/`` and both packages' ``load_package`` read it).
        Needs ``self.forwards`` and an initialized ``self.loader`` (the
        StandardWorkflow shape), whose minibatch gives the input's shape
        and dtype; ``batch`` replaces its batch size."""
        from veles_tpu_torch.package_export import export_package
        forwards = getattr(self, "forwards", None)
        if not forwards:
            raise ValueError("%s has no forward chain to export" % self)
        loader = getattr(self, "loader", None)
        if loader is None or not bool(loader.minibatch_data):
            raise ValueError(
                "%s has no initialized loader — package_export needs its "
                "minibatch shape/dtype" % self)
        in_shape = list(loader.minibatch_data.shape)
        if batch is not None:
            in_shape[0] = int(batch)
        return export_package(
            forwards, path, in_shape, input_dtype=loader.minibatch_data.dtype,
            name=type(self).__name__, checksum=self.checksum())

    def checksum(self):
        """Stable digest of the workflow's defining source — coordinator /
        worker handshakes compare it (ref: workflow.py:852)."""
        from veles_tpu_torch.mutable import unshadow
        cls = unshadow(type(self))
        try:
            src = inspect.getsource(cls)
        except (OSError, TypeError):
            src = cls.__qualname__
        return hashlib.sha256(src.encode()).hexdigest()

    _GROUP_COLORS = {
        "PLUMBING": "lightgrey", "LOADER": "lightblue",
        "WORKER": "palegreen", "TRAINER": "gold",
        "EVALUATOR": "plum", "SERVICE": "white",
    }

    def graph_dict(self):
        """The unit graph as plain data — {nodes: [{id,label,cls,group}],
        edges: [[src,dst]]} — consumed by the DOT export below and the
        web dashboard's SVG renderer (ref: the viz.js graph view,
        veles/web_status.py:66-112 + web/)."""
        index = {u: i for i, u in enumerate(self.units)}
        nodes = [{"id": i, "label": u.name, "cls": type(u).__name__,
                  "group": u.view_group} for u, i in index.items()]
        edges = [[index[u], index[dst]] for u in self.units
                 for dst in u.links_to if dst in index]
        return {"name": self.name, "nodes": nodes, "edges": edges}

    def generate_graph(self, filename=None):
        """Graphviz DOT export of the unit graph
        (ref: workflow.py:628)."""
        g = self.graph_dict()
        lines = ["digraph %s {" % type(self).__name__.replace(" ", "_"),
                 "  rankdir=TB;"]
        for n in g["nodes"]:
            color = self._GROUP_COLORS.get(n["group"], "white")
            lines.append('  u%d [label="%s", style=filled, fillcolor=%s];'
                         % (n["id"], n["label"], color))
        for src, dst in g["edges"]:
            lines.append("  u%d -> u%d;" % (src, dst))
        lines.append("}")
        dot = "\n".join(lines)
        if filename:
            with open(filename, "w") as f:
                f.write(dot)
        return dot

    def print_stats(self, top=5):
        """Top-N per-unit run-time table (ref: workflow.py:788-825),
        with per-run p50/p95 and cumulative gate-wait from the shared
        telemetry histograms when instrumentation is on."""
        from veles_tpu_torch.telemetry import metrics
        stats = sorted(((u.timers["run"], u.timers["runs"], u.name)
                        for u in self.units), reverse=True)[:top]
        total = self._run_time or sum(s[0] for s in stats) or 1e-9
        run_fam = metrics.get("veles_unit_run_seconds")
        wait_fam = metrics.get("veles_unit_gate_wait_seconds")
        self.info("---- unit run-time stats (total %.2fs) ----", total)
        for t, n, name in stats:
            extra = ""
            hist = run_fam.children().get((name,)) if run_fam else None
            if hist is not None and hist.count:
                p50 = hist.percentile(0.50)
                p95 = hist.percentile(0.95)
                extra = "  p50 %.4fs  p95 %.4fs" % (p50, p95)
            wait = wait_fam.children().get((name,)) if wait_fam \
                else None
            if wait is not None and wait.count:
                extra += "  gate-wait %.3fs" % wait.sum
            self.info("  %-30s %8.3fs  %6d runs  %5.1f%%%s",
                      name, t, n, 100.0 * t / total, extra)
        from veles_tpu_torch.telemetry.health import monitor
        health_line = monitor.summary_line()
        if health_line:
            self.info("  %s", health_line)
        return stats
