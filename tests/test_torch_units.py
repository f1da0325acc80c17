"""The workflow runtime's graph mechanics in the PyTorch port held
against the JAX package on the CPU: the same unit graph built in both
packages must run the same units in the same order.  Oracles:
``tests/test_units.py``, ``tests/test_workflow.py`` and
``tests/test_mutable.py``.

Covered: chains and fan-in, ``gate_block``/``gate_skip`` (also through a
shared Bool), ``Repeater`` loops closed by a decider, the
``MissingDemand`` re-queue, ``link_attrs`` one-way and ``two_way``,
derived Bools' truth tables, ``graph_dict`` and the DOT text, a pickle
round trip that resumes a loop, the ``unit:<name>`` events and the
``veles_unit_*`` series, and the ``IDistributable`` aggregation."""

import itertools
import pickle

import pytest

import veles_tpu.mutable as jmutable
import veles_tpu.plumbing as jplumbing
import veles_tpu.units as junits
import veles_tpu.workflow as jworkflow
import veles_tpu_torch.mutable as pmutable
import veles_tpu_torch.plumbing as pplumbing
import veles_tpu_torch.units as punits
import veles_tpu_torch.workflow as pworkflow

pytestmark = pytest.mark.torch_port

PKGS = {
    "jax": (junits, jworkflow, jplumbing, jmutable),
    "port": (punits, pworkflow, pplumbing, pmutable),
}


def _recorder_classes(tag, units):
    """Module-level (so picklable) Recorder, Counter, Supplier and
    Consumer classes over ``units.Unit``."""
    def rec_init(self, workflow, **kwargs):
        units.Unit.__init__(self, workflow, **kwargs)
        self.trace = workflow.trace

    def rec_run(self):
        self.trace.append(self.name)

    def cnt_init(self, workflow, limit=3, **kwargs):
        rec_init(self, workflow, **kwargs)
        self.limit, self.count = limit, 0
        self.complete = PKGS[tag][3].Bool(False, "complete")

    def cnt_run(self):
        rec_run(self)
        self.count += 1
        if self.count >= self.limit:
            self.complete <<= True

    def sup_init(self, **kwargs):
        units.Unit.initialize(self, **kwargs)
        self.product = 42

    def con_init(self, workflow, **kwargs):
        units.Unit.__init__(self, workflow, **kwargs)
        self.demand("product")

    made = {}
    for name, body in (
            ("Recorder", {"__init__": rec_init, "run": rec_run}),
            ("Counter", {"__init__": cnt_init, "run": cnt_run}),
            ("Supplier", {"initialize": sup_init}),
            ("Consumer", {"__init__": con_init})):
        qual = "%s_%s" % (tag, name)
        cls = type(qual, (units.Unit,), dict(body, __qualname__=qual))
        globals()[qual] = made[name] = cls
    return made


CLASSES = {tag: _recorder_classes(tag, mods[0]) for tag, mods in PKGS.items()}


def _trace_workflow(tag):
    wf = PKGS[tag][1].Workflow(name="trace")
    wf.trace = []
    return wf


def build(tag, kind):
    """The graph ``kind`` in package ``tag``; returns (workflow, named
    units)."""
    _, _, plumbing, mutable = PKGS[tag]
    C = CLASSES[tag]
    wf = _trace_workflow(tag)
    u = {}
    if kind in ("chain", "block", "skip", "shared_skip"):
        for i in range(4):
            u["u%d" % i] = C["Recorder"](wf, name="u%d" % i)
        u["u0"].link_from(wf.start_point)
        for a, b in zip("012", "123"):
            u["u" + b].link_from(u["u" + a])
        wf.end_point.link_from(u["u3"])
        if kind == "block":
            u["u2"].gate_block <<= True
        elif kind == "skip":
            u["u1"].gate_skip <<= True
        elif kind == "shared_skip":
            u["u2"].gate_skip = ~wf.stopped
    elif kind == "fan_in":
        for name in ("a", "b", "c", "join"):
            u[name] = C["Recorder"](wf, name=name)
        for name in "abc":
            u[name].link_from(wf.start_point)
        u["join"].link_from(u["a"], u["b"], u["c"])
        wf.end_point.link_from(u["join"])
    elif kind in ("loop", "nested_loop"):
        rep = plumbing.Repeater(wf)
        cnt = C["Counter"](wf, limit=4, name="cnt")
        side = C["Recorder"](wf, name="side")
        rep.link_from(wf.start_point)
        cnt.link_from(rep)
        side.link_from(cnt)
        side.gate_skip = ~cnt.complete & ~mutable.Bool(False)
        rep.link_from(side)
        rep.gate_block = cnt.complete
        wf.end_point.link_from(side)
        wf.end_point.gate_block = ~cnt.complete
        u.update(rep=rep, cnt=cnt, side=side)
        if kind == "nested_loop":
            outer = PKGS[tag][1].Workflow(name="outer")
            outer.trace = wf.trace
            wf.workflow = outer
            wf.link_from(outer.start_point)
            outer.end_point.link_from(wf)
            u["inner"] = wf
            wf = outer
    return wf, u


KINDS = ("chain", "block", "skip", "shared_skip", "fan_in", "loop",
         "nested_loop")


@pytest.mark.parametrize("kind", KINDS)
def test_run_trace_matches_reference(kind):
    """The unit-name trace of ``run()``, the workflow's ``stopped`` and
    every unit's run count are the reference's."""
    got = {}
    for tag in PKGS:
        wf, u = build(tag, kind)
        wf.initialize()
        wf.run()
        got[tag] = (list(wf.trace), bool(wf.stopped),
                    {n: x.timers["runs"] for n, x in u.items()})
    assert got["port"] == got["jax"]
    assert got["port"][0]


@pytest.mark.parametrize("kind", KINDS)
def test_graph_dict_matches_reference(kind):
    """``graph_dict()`` (nodes, groups, edges) and the DOT text."""
    want = build("jax", kind)[0]
    got = build("port", kind)[0]

    def strip(g):
        return {"name": g["name"], "edges": g["edges"],
                "nodes": [(n["id"], n["label"], n["cls"].split("_")[-1],
                           n["group"]) for n in g["nodes"]]}
    assert strip(got.graph_dict()) == strip(want.graph_dict())
    assert got.generate_graph().replace("port_", "") == \
        want.generate_graph().replace("jax_", "")


@pytest.mark.parametrize("kind", ("loop", "skip", "fan_in"))
def test_pickle_round_trip_resumes(kind):
    """A workflow pickled before its run resumes with live derived
    gates, and runs the reference's trace."""
    got = {}
    for tag in PKGS:
        wf = pickle.loads(pickle.dumps(build(tag, kind)[0]))
        assert len(wf._sched_queue_) == 0
        wf.initialize()
        wf.run()
        got[tag] = list(wf.trace)
    assert got["port"] == got["jax"]


def test_loop_reruns_after_reset():
    for tag in PKGS:
        wf, u = build(tag, "loop")
        wf.initialize()
        wf.run()
        u["cnt"].count = 0
        u["cnt"].complete <<= False
        wf.trace.clear()
        wf.run()
        assert wf.trace.count("cnt") == 4, tag


def test_missing_demand_requeues_and_raises():
    """A consumer built before its supplier initializes after it; an
    unsupplied demand raises ``MissingDemand``."""
    for tag, (units, workflow, _, _) in PKGS.items():
        C = CLASSES[tag]
        wf = workflow.Workflow()
        c = C["Consumer"](wf, name="c")
        s = C["Supplier"](wf, name="s")
        c.link_attrs(s, "product")
        wf.initialize()
        assert c.product == 42
        wf2 = pickle.loads(pickle.dumps(wf))
        wf2.initialize()
        wf2["s"].product = 7
        assert wf2["c"].product == 7
        lone = workflow.Workflow()
        C["Consumer"](lone)
        with pytest.raises(units.MissingDemand):
            lone.initialize()
        with pytest.raises(RuntimeError):
            units.Unit(workflow.Workflow())._run_wrapped()


@pytest.mark.parametrize("two_way", [False, True])
def test_link_attrs_matches_reference(two_way):
    """Reads forward; a write goes back to the source with ``two_way``
    and detaches the link without it; ``unlink`` freezes the value."""
    seen = {}
    for tag, (units, workflow, _, mutable) in PKGS.items():
        wf = workflow.Workflow()
        src, dst = units.Unit(wf, name="src"), units.Unit(wf, name="dst")
        src.x = 1
        dst.link_attrs(src, ("y", "x"), two_way=two_way)
        log = [dst.y]
        src.x = 2
        log.append(dst.y)
        dst.y = 3
        log += [src.x, dst.y]
        src.x = 4
        log.append(dst.y)
        mutable.LinkableAttribute.unlink(dst, "y")
        src.x = 5
        log.append(dst.y)
        seen[tag] = log
    assert seen["port"] == seen["jax"]


EXPRS = {
    "not": lambda a, b, c: ~a,
    "and": lambda a, b, c: a & b,
    "or": lambda a, b, c: a | b,
    "xor": lambda a, b, c: a ^ b,
    "compound": lambda a, b, c: (a | b) & ~c,
    "plain": lambda a, b, c: (a ^ True) | (c & False),
}


@pytest.mark.parametrize("name", sorted(EXPRS))
def test_derived_bools_match_reference(name):
    """Each expression's value over all eight inputs, live and after a
    pickle round trip of (sources, expression)."""
    rows = {}
    for tag, (_, _, _, mutable) in PKGS.items():
        a, b, c = (mutable.Bool(False) for _ in range(3))
        expr = EXPRS[name](a, b, c)
        out = []
        for bits in itertools.product((False, True), repeat=3):
            for cell, v in zip((a, b, c), bits):
                cell <<= v
            a2, b2, c2, e2 = pickle.loads(pickle.dumps((a, b, c, expr)))
            out.append((bool(expr), bool(e2)))
            a2 <<= not bits[0]
            out.append(bool(e2))
        with pytest.raises(ValueError):
            expr.set(True)
        rows[tag] = out
    assert rows["port"] == rows["jax"]


def test_bool_equals_plain_bools():
    """The port's Bool compares equal to a plain bool of its value (its
    loader flags take the place of the span server's plain ones)."""
    b = pmutable.Bool(True)
    assert b == True and b != False  # noqa: E712
    assert b != pmutable.Bool(True) and b == b
    assert len({b, pmutable.Bool(True)}) == 2


def test_unit_events_and_series():
    """``run()`` records a begin/end ``unit:<name>`` pair per firing and
    feeds ``veles_unit_run_seconds``, ``veles_unit_gate_wait_seconds``
    and ``veles_unit_runs_total`` under the reference's labels; the wave
    is a ``workflow run`` pair and observes
    ``veles_workflow_run_seconds``."""
    from veles_tpu_torch import telemetry
    from veles_tpu_torch.logger import events
    wf, u = build("port", "fan_in")
    wf.initialize()
    events.ring.clear()
    wf.run()
    names = [(e["name"], e["kind"]) for e in events.ring]
    assert names[0] == ("workflow run", "begin")
    assert names[-1] == ("workflow run", "end")
    for unit in ("a", "b", "c", "join"):
        assert names.count(("unit:%s" % unit, "begin")) == 1
        assert names.count(("unit:%s" % unit, "end")) == 1
    end = [e for e in events.ring if e["name"] == "unit:join"
           and e["kind"] == "end"][0]
    assert end["unit"] == "join" and end["duration"] >= 0
    assert end["gate_wait"] >= 0
    runs = telemetry.metrics.get("veles_unit_runs_total")
    assert runs.labelnames == ("unit",)
    assert runs.children()[("join",)].value >= 1
    assert telemetry.metrics.get("veles_unit_run_seconds").children()[
        ("a",)].count >= 1
    assert telemetry.metrics.get("veles_unit_gate_wait_seconds") \
        .labelnames == ("unit",)
    assert telemetry.metrics.get("veles_workflow_run_seconds").children()[
        ("trace",)].count >= 1
    stats = wf.print_stats(top=6)
    assert sorted(s[2] for s in stats) == ["End", "Start", "a", "b", "c",
                                           "join"]
    assert all(s[1] == 1 for s in stats if s[2] != "End")
    telemetry.set_enabled(False)
    try:
        events.ring.clear()
        wf.run()
        assert [e["name"] for e in events.ring] == ["workflow run"] * 2
    finally:
        telemetry.set_enabled(True)


def test_trace_run_and_timings():
    """With the workflow's ``trace_run`` each unit's run is a
    ``unit:<name>`` range in a ``torch.profiler`` trace; ``timings`` logs
    each run's time."""
    import logging
    import torch.profiler
    wf, u = build("port", "chain")
    wf.trace_run = wf.timings = True
    wf.initialize()
    logger = logging.getLogger(type(u["u1"]).__name__)
    seen = []
    handler = logging.Handler(logging.DEBUG)
    handler.emit = lambda record: seen.append(record.getMessage())
    logger.addHandler(handler)
    level = logger.level
    logger.setLevel(logging.DEBUG)
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            wf.run()
    finally:
        logger.removeHandler(handler)
        logger.setLevel(level)
    keys = {e.key for e in prof.key_averages()}
    assert {"unit:u0", "unit:u1", "unit:u2", "unit:u3"} <= keys
    assert sum(m.startswith("u1 ran in") for m in seen) == 1


def test_distributable_aggregation_matches_reference():
    """The workflow's ``IDistributable`` methods gather and apply its
    units' payloads under the reference's ``name#index`` keys."""
    got = {}
    for tag, (units, workflow, _, _) in PKGS.items():
        class_ = type("%s_Neg" % tag, (units.Unit,), {
            "negotiates_on_connect": True,
            "generate_data_for_slave": lambda self, s=None: self.name,
            "generate_data_for_master": lambda self: self.name.upper(),
            "apply_data_from_master": lambda self, d: setattr(
                self, "got", d),
            "apply_data_from_slave": lambda self, d, s=None: setattr(
                self, "got", d)})
        wf = workflow.Workflow(name="d")
        a, b = class_(wf, name="a"), class_(wf, name="b")
        units.Unit(wf, name="plain")
        jobs = wf.generate_data_for_slave()
        wf.apply_data_from_master({"a#2": 1, "b#3": 2})
        upd = wf.generate_data_for_master()
        wf.apply_data_from_slave({"b#3": 3})
        wf.drop_slave()
        got[tag] = (jobs, upd, a.got, b.got, wf.has_more_jobs(),
                    wf.all_jobs_done(), wf.checksum() == wf.checksum())
    assert got["port"] == got["jax"]


def test_workflow_feature_off_values():
    """``package_export`` waits for ROADMAP item 11."""
    with pytest.raises(NotImplementedError, match="item 11"):
        pworkflow.Workflow().package_export("x.tar.gz")
