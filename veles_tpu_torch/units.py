"""Unit — the dataflow graph node (the port of ``veles_tpu/units.py``).

A model is a :class:`~veles_tpu_torch.workflow.Workflow`: a directed
graph of Units wired by control links (:meth:`Unit.link_from`) and data
links (:meth:`Unit.link_attrs`).  Control flow is event-driven through
*gates*: a unit runs when all of its incoming links have fired, unless its
``gate_block`` Bool is set; ``gate_skip`` propagates the signal without
running (ref: units.py:524-552).

The scheduler is the reference's deterministic worklist run by the
Workflow (no thread pool, no per-unit locks in the hot path): the port's
units launch their device work eagerly and the host-side walk between
them is microseconds.

The reference's ``root.common`` keys the units read become attributes
of the top-level workflow, under the reference's names: ``trace_run``
(``trace.run``: each run is also a ``torch.profiler.record_function``
range, so per-unit spans show in a device trace) and ``timings`` (log
each run's time).
"""

import time

from veles_tpu_torch.mutable import Bool, LinkableAttribute
from veles_tpu_torch.unit_registry import RegisteredDistributable


def _unit_metrics():
    """The shared per-unit telemetry series (created on first use so
    importing units never forces the registry into being)."""
    from veles_tpu_torch.telemetry import metrics
    return (
        metrics.histogram(
            "veles_unit_run_seconds",
            "wall time of one unit run() firing", ("unit",)),
        metrics.histogram(
            "veles_unit_gate_wait_seconds",
            "time between a unit's first incoming link firing and its "
            "gate opening (scheduling slack on multi-input units)",
            ("unit",)),
        metrics.counter(
            "veles_unit_runs_total", "unit run() firings", ("unit",)),
    )


class MissingDemand(AttributeError):
    """A demanded attribute is absent at initialize() time — the workflow
    re-queues the unit and tries again after its suppliers initialize
    (ref: veles/units.py:682, workflow.py:319-341)."""

    def __init__(self, unit, attrs):
        super(MissingDemand, self).__init__(
            "%s demands unsatisfied attribute(s): %s" %
            (unit, ", ".join(sorted(attrs))))
        self.unit = unit
        self.attrs = attrs


class Unit(RegisteredDistributable):
    """A graph node with gates, links and a lifecycle
    (ref: veles/units.py:108).

    Lifecycle: ``__init__`` (wire the graph) → ``initialize`` (allocate,
    validate demands) → ``run`` (once per gate opening) → ``stop``.
    """

    hide_from_registry = True

    def __init__(self, workflow, name=None, view_group=None, **kwargs):
        super(Unit, self).__init__()
        self._name = name
        self.view_group = view_group or getattr(self, "VIEW_GROUP", "PLUMBING")
        self.links_from = {}   # src Unit -> fired flag (bool)
        self.links_to = {}     # dst Unit -> True (ordered set)
        self.gate_block = Bool(False, "gate_block")
        self.gate_skip = Bool(False, "gate_skip")
        self._demanded = set()
        self._is_initialized = False
        self.timers = {"run": 0.0, "runs": 0}
        self._workflow = None
        if workflow is not None:
            self.workflow = workflow

    def init_unpickled(self):
        super(Unit, self).init_unpickled()
        self._gate_wait_t0_ = None
        self._gate_wait_ = 0.0
        self._telemetry_ = None

    # -- identity ----------------------------------------------------------

    @property
    def name(self):
        return self._name or type(self).__name__

    @name.setter
    def name(self, value):
        self._name = value

    @property
    def id(self):
        return type(self).__id__

    def __repr__(self):
        return "<%s \"%s\">" % (type(self).__name__, self.name)

    # -- workflow membership ----------------------------------------------

    @property
    def workflow(self):
        return self._workflow

    @workflow.setter
    def workflow(self, wf):
        if self._workflow is not None:
            self._workflow.del_ref(self)
        self._workflow = wf
        wf.add_ref(self)

    def _common(self, key, default=None):
        """The top-level workflow's setting ``key`` (the reference's
        ``root.common.<key>``)."""
        w = self
        while isinstance(getattr(w, "_workflow", None), Unit):
            w = w._workflow
        return getattr(w, key, default)

    @property
    def is_standalone(self):
        return self._workflow.is_standalone if self._workflow else True

    @property
    def is_master(self):
        return self._workflow.is_master if self._workflow else False

    @property
    def is_slave(self):
        return self._workflow.is_slave if self._workflow else False

    # -- graph wiring (ref: units.py:554-680) -------------------------------

    def link_from(self, *units):
        """Add control edges ``unit → self``; self runs after all fire."""
        for src in units:
            self.links_from[src] = False
            src.links_to[self] = True
        return self

    def unlink_from(self, *units):
        for src in units:
            self.links_from.pop(src, None)
            src.links_to.pop(self, None)
        return self

    def unlink_all(self):
        self.unlink_before()
        self.unlink_after()

    def unlink_before(self):
        for src in list(self.links_from):
            self.unlink_from(src)

    def unlink_after(self):
        for dst in list(self.links_to):
            dst.unlink_from(self)

    def link_attrs(self, other, *args, two_way=False):
        """Data links: each arg is ``"attr"`` (same name both sides) or
        ``("own_name", "other_name")`` (ref: veles/units.py:638)."""
        for arg in args:
            if isinstance(arg, str):
                own, theirs = arg, arg
            else:
                own, theirs = arg
            LinkableAttribute(self, own, (other, theirs), two_way=two_way)
        return self

    def demand(self, *attrs):
        """Declare attributes that must be non-None before initialize
        (ref: veles/units.py:682)."""
        self._demanded.update(attrs)

    # -- lifecycle ----------------------------------------------------------

    def verify_demands(self):
        missing = {a for a in self._demanded
                   if getattr(self, a, None) is None}
        if missing:
            raise MissingDemand(self, missing)

    def initialize(self, **kwargs):
        """Validate demands and allocate.  Subclasses call super() first."""
        self.verify_demands()
        self._is_initialized = True

    @property
    def is_initialized(self):
        return self._is_initialized

    def run(self):
        """One firing of this unit.  Subclasses override."""
        pass

    def stop(self):
        """Called on workflow shutdown; release external resources."""
        pass

    # -- gate machinery (ref: units.py:524-552, 782-803) --------------------

    def open_gate(self, src):
        """Mark the ``src → self`` edge fired; True when all inputs fired
        (flags then reset for the next wave).  On multi-input units the
        span between the FIRST edge firing and the gate opening is the
        unit's gate-wait (scheduling slack), surfaced through telemetry."""
        if src is not None and src in self.links_from:
            if len(self.links_from) > 1 and self._gate_wait_t0_ is None \
                    and not any(self.links_from.values()):
                # fallback stamp for signals that bypassed
                # run_dependent (direct open_gate callers)
                self._gate_wait_t0_ = time.time()
            self.links_from[src] = True
        if all(self.links_from.values()) or not self.links_from:
            for k in self.links_from:
                self.links_from[k] = False
            t0 = self._gate_wait_t0_
            self._gate_wait_ = time.time() - t0 if t0 else 0.0
            self._gate_wait_t0_ = None
            return True
        return False

    def _check_gate_and_run(self, src):
        """Scheduler entry: signal arriving over the ``src → self`` edge."""
        if self.gate_block:
            return
        if not self.open_gate(src):
            return
        if not self.gate_skip:
            if self._workflow is not None and self._workflow.stopped:
                return
            self._run_wrapped()
        self.run_dependent()

    def _run_wrapped(self):
        """run() with timing + initialization check
        (ref: units.py:805-845).  With the workflow's ``trace_run`` each
        run is also a ``torch.profiler.record_function`` range, so
        per-unit spans appear inside a device trace."""
        if not self._is_initialized:
            raise RuntimeError("%s.run() before initialize()" % self)
        import veles_tpu_torch.telemetry as telemetry
        from veles_tpu_torch.logger import events
        tracing = self._common("trace_run", False)
        observing = telemetry.enabled()
        gate_wait = self._gate_wait_
        self._gate_wait_ = 0.0
        span_id = None
        if observing:
            span_id = telemetry.next_span_id()
            events.record("unit:%s" % self.name, "begin",
                          unit=self.name, cls=type(self).__name__,
                          span=span_id)
        t0 = time.time()
        error = None
        try:
            if tracing:
                import torch.profiler
                with torch.profiler.record_function(
                        "unit:%s" % self.name):
                    self.run()
            else:
                self.run()
        except BaseException as e:
            # the end span names the exception type so the event tail
            # shows WHICH unit died, not just that the wave stopped
            error = type(e).__name__
            raise
        finally:
            dt = time.time() - t0
            self.timers["run"] += dt
            self.timers["runs"] += 1
            if observing:
                end_attrs = {"unit": self.name,
                             "cls": type(self).__name__,
                             "span": span_id, "duration": dt,
                             "gate_wait": round(gate_wait, 6)}
                if error is not None:
                    end_attrs["error"] = error
                events.record("unit:%s" % self.name, "end",
                              **end_attrs)
                if self._telemetry_ is None:
                    run_h, wait_h, runs_c = _unit_metrics()
                    self._telemetry_ = (run_h.labels(self.name),
                                        wait_h.labels(self.name),
                                        runs_c.labels(self.name))
                run_h, wait_h, runs_c = self._telemetry_
                run_h.observe(dt)
                runs_c.inc()
                if gate_wait:
                    wait_h.observe(gate_wait)
            if self._common("timings", False):
                self.debug("%s ran in %.4fs", self.name, dt)

    def run_dependent(self):
        """Propagate the control signal to successors
        (ref: units.py:485-505) — enqueues on the workflow scheduler.
        A multi-input successor's gate-wait clock starts when its FIRST
        producer finishes (here, at schedule time — not at queue
        delivery, which the serial worklist makes back-to-back)."""
        now = time.time()
        for dst in self.links_to:
            if len(dst.links_from) > 1 and dst._gate_wait_t0_ is None \
                    and not any(dst.links_from.values()):
                dst._gate_wait_t0_ = now
            self._workflow.schedule(dst, self)

    # -- export metadata ----------------------------------------------------

    def export_config(self):
        """Picklable kwargs snapshot of the unit's configuration
        (overridden by units with meaningful config)."""
        return {}
