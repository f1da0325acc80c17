"""The service tier of the PyTorch port — the plotting units, the ZMQ
graphics fan-out, the web status dashboard, the composer frontend and
the shell — held against the JAX package's on the CPU (the oracles are
``tests/test_l8_services.py`` and ``tests/test_cli.py::
test_frontend_composes_and_executes``):

- each plotter's payload equals the JAX plotter's on the same values
  (the port's read from torch tensors, the JAX package's from
  ``Array``\\ s), the renderer draws every kind;
- the PUB socket fans payloads out, through the launcher too, and a
  payload reads back through the port's restricted unpickler;
- the port's dashboard (on the stdlib's HTTP server) answers the
  reference's routes with the reference's tables, escapes what updates
  supply and answers a malformed graph with 400; the notifier ships the
  graph and the events;
- ``StandardWorkflow``'s plotters follow the decision's history;
- the frontend composes a command line the parser reads back.

Every test stops the servers, sockets and threads it starts."""

import gzip
import json
import pickle
import threading
import time
import urllib.error
import urllib.parse
import urllib.request

import numpy
import pytest
import torch

pytestmark = pytest.mark.torch_port


class Obj:
    pass


def _strip(payload):
    """A payload without its wall-clock stamp."""
    return {k: v for k, v in payload.items() if k != "time"}


def _get(url, timeout=5):
    return urllib.request.urlopen(url, timeout=timeout).read().decode()


def _post(url, obj):
    req = urllib.request.Request(
        url, data=json.dumps(obj).encode(),
        headers={"Content-Type": "application/json"})
    return json.load(urllib.request.urlopen(req, timeout=5))


# -- plotting units -------------------------------------------------------------

def test_accumulating_plotter():
    from veles_tpu_torch.plotting_units import AccumulatingPlotter
    o = Obj()
    o.err = 5.0
    p = AccumulatingPlotter(None, obj=o, attr="err", label="err",
                            collect=True)
    p.run()
    o.err = torch.tensor(3.0)
    p.run()
    assert p.last_payload["kind"] == "curve"
    assert p.last_payload["series"]["err"] == [5.0, 3.0]


def test_accumulating_plotter_skips_none():
    from veles_tpu_torch.plotting_units import AccumulatingPlotter
    o = Obj()
    o.err = None
    p = AccumulatingPlotter(None, obj=o, attr="err", collect=True)
    p.run()
    assert p.last_payload is None and p.series == []


def test_matrix_and_histogram_and_table():
    from veles_tpu_torch.memory import Array
    from veles_tpu_torch.plotting_units import (
        Histogram, MatrixPlotter, TableMaxMin)
    o = Obj()
    o.confusion_matrix = Array(numpy.eye(3, dtype=numpy.int32))
    m = MatrixPlotter(None, obj=o, collect=True)
    m.run()
    assert numpy.asarray(m.last_payload["data"]).shape == (3, 3)
    o.weights = torch.arange(12, dtype=torch.float32)
    h = Histogram(None, obj=o, attr="weights", bins=4, collect=True)
    h.run()
    assert sum(h.last_payload["counts"]) == 12
    t = TableMaxMin(None, collect=True).watch("w", o, "weights")
    t.run()
    assert t.last_payload["rows"][0] == ["w", 11.0, 0.0]


def test_image_plotter_2d_weights():
    from veles_tpu_torch.plotting_units import ImagePlotter
    o = Obj()
    o.weights = torch.rand(16, 6)
    p = ImagePlotter(None, obj=o, limit=4, collect=True)
    p.run()
    tiles = numpy.asarray(p.last_payload["tiles"])
    assert tiles.shape == (4, 4, 4)  # 16 inputs → 4x4 tiles, limit 4


def _plot_cases(rng):
    """(class name, constructor keywords, attribute values) of every
    plotter over the same values."""
    w2 = rng.standard_normal((16, 6)).astype(numpy.float32)
    w4 = rng.standard_normal((3, 3, 2, 5)).astype(numpy.float32)
    w3 = rng.standard_normal((4, 5, 5)).astype(numpy.float32)
    cm = rng.integers(0, 9, (4, 4)).astype(numpy.int32)
    return {
        "curve": ("AccumulatingPlotter", dict(attr="v", label="loss",
                                              ylabel="l"),
                  {"v": [numpy.float32(2.5), numpy.float32(1.25)]}),
        "matrix": ("MatrixPlotter", {}, {"confusion_matrix": [cm]}),
        "images_2d": ("ImagePlotter", dict(limit=5), {"weights": [w2]}),
        "images_4d": ("ImagePlotter", {}, {"weights": [w4]}),
        "images_3d": ("ImagePlotter", dict(limit=3), {"weights": [w3]}),
        "histogram": ("Histogram", dict(bins=7), {"weights": [w4]}),
    }


@pytest.mark.parametrize("case", ["curve", "matrix", "images_2d",
                                  "images_4d", "images_3d", "histogram"])
def test_plotter_payload_matches_reference(case):
    """The port's payload over torch tensors equals the JAX plotter's
    over ``Array``\\ s of the same values, run for run."""
    import veles_tpu.plotting_units as J
    from veles_tpu.memory import Array as JArray
    import veles_tpu_torch.plotting_units as P
    cls, kw, values = _plot_cases(numpy.random.default_rng(4))[case]
    jo, po = Obj(), Obj()
    jp = getattr(J, cls)(None, obj=jo, collect=True, name="p", **kw)
    pp = getattr(P, cls)(None, obj=po, collect=True, name="p", **kw)
    steps = len(next(iter(values.values())))
    for i in range(steps):
        for attr, vs in values.items():
            v = vs[i]
            setattr(jo, attr, JArray(numpy.asarray(v)) if numpy.ndim(v)
                    else float(v))
            setattr(po, attr, torch.as_tensor(numpy.asarray(v)))
        jp.run()
        pp.run()
        assert _strip(pp.last_payload) == _strip(jp.last_payload)


def test_multi_histogram_and_table_match_reference():
    """``MultiHistogram`` over a chain's weights and ``TableMaxMin``
    over watched arrays, the port's against the JAX package's."""
    import veles_tpu.plotting_units as J
    import veles_tpu_torch.plotting_units as P
    from tests.test_torch_package_export import jax_chain, jax_params
    from veles_tpu_torch.convert import params_from_numpy
    spec = [{"type": "conv_relu", "n_kernels": 4, "kx": 3, "ky": 3},
            {"type": "max_pooling", "kx": 2, "ky": 2},
            {"type": "softmax", "output_sample_shape": (3,)}]
    x = numpy.zeros((2, 6, 6, 2), numpy.float32)
    units = jax_chain(spec, x)
    chain = params_from_numpy(spec, jax_params(units), device="cpu")
    jm = J.MultiHistogram(None, forwards=units, bins=5, collect=True,
                          name="h")
    pm = P.MultiHistogram(None, forwards=chain, bins=5, collect=True,
                          name="h")
    jm.run()
    pm.run()
    assert _strip(pm.last_payload) == _strip(jm.last_payload)
    assert sorted(pm.last_payload["layers"]) == ["conv_relu0", "softmax2"]
    jt, pt = J.TableMaxMin(None, collect=True, name="t"), \
        P.TableMaxMin(None, collect=True, name="t")
    po = Obj()
    for i in (0, 2):
        setattr(po, "w%d" % i, chain[i].params["weights"])
        jt.watch("w%d" % i, units[i], "weights")
        pt.watch("w%d" % i, po, "w%d" % i)
    jt.run()
    pt.run()
    assert _strip(pt.last_payload) == _strip(jt.last_payload)


def test_slave_stats_matches_reference():
    import veles_tpu.plotting_units as J
    import veles_tpu_torch.plotting_units as P
    from veles_tpu_torch.parallel.coordinator import WorkerDescription
    coord = Obj()
    coord.workers = {}
    for i, (state, power, jobs) in enumerate(
            [("WORK", 10.26, 3), ("WAIT", 2.0, 0)]):
        w = WorkerDescription("w%d" % i, power, None)
        w.state, w.jobs_done = state, jobs
        coord.workers[w.id] = w
    jp = J.SlaveStats(None, coordinator=coord, collect=True, name="s")
    pp = P.SlaveStats(None, coordinator=coord, collect=True, name="s")
    jp.run()
    pp.run()
    assert _strip(pp.last_payload) == _strip(jp.last_payload)
    assert pp.last_payload["rows"][0] == ["w0", "WORK", 10.3, 3]


def test_render_all_kinds(tmp_path):
    pytest.importorskip("matplotlib")
    from veles_tpu_torch.graphics_client import render_payload
    payloads = [
        {"kind": "curve", "series": {"a": [1, 2, 3]}, "name": "c"},
        {"kind": "matrix", "data": [[1, 0], [0, 1]], "name": "m"},
        {"kind": "images", "tiles": numpy.random.rand(3, 4, 4).tolist(),
         "name": "i"},
        {"kind": "histogram", "counts": [1, 2], "edges": [0, 1, 2],
         "name": "h"},
        {"kind": "multi_histogram", "layers": {
            "fc0": {"counts": [1], "edges": [0, 1]}}, "name": "mh"},
        {"kind": "table", "header": ["a"], "rows": [["x"]], "name": "t"},
    ]
    fig = None
    for pl in payloads:
        fig = render_payload(pl, figure=fig)
        fig.savefig(tmp_path / (pl["name"] + ".png"))
    assert len(list(tmp_path.glob("*.png"))) == len(payloads)
    with pytest.raises(ValueError, match="unknown payload kind"):
        render_payload({"kind": "nope"}, figure=fig)
    import matplotlib.pyplot as plt
    plt.close(fig)


# -- graphics fan-out -----------------------------------------------------------

def _subscriber(endpoint):
    zmq = pytest.importorskip("zmq")
    sub = zmq.Context.instance().socket(zmq.SUB)
    sub.setsockopt(zmq.SUBSCRIBE, b"")
    sub.setsockopt(zmq.LINGER, 0)
    sub.connect(endpoint)
    time.sleep(0.3)  # PUB/SUB join
    return sub


def test_graphics_server_pub_sub():
    pytest.importorskip("zmq")
    from veles_tpu_torch.graphics_server import GraphicsServer
    from veles_tpu_torch.safe_pickle import safe_loads
    server = GraphicsServer()
    sub = _subscriber(server.endpoint)
    try:
        payload = {"kind": "curve", "series": {"x": [1.0]}, "name": "p"}
        server.enqueue(payload)
        assert sub.poll(3000), "no payload arrived"
        blob = gzip.decompress(sub.recv())
        assert safe_loads(blob) == payload == pickle.loads(blob)
        assert server.sent == 1
    finally:
        sub.close(0)
        server.close()


def test_plotter_publishes_through_launcher():
    """Workflow → launcher.graphics_server → SUB loopback; the payload
    names no class of either package."""
    pytest.importorskip("zmq")
    from veles_tpu_torch.graphics_server import GraphicsServer
    from veles_tpu_torch.plotting_units import AccumulatingPlotter
    from veles_tpu_torch.safe_pickle import safe_loads
    from veles_tpu_torch.workflow import Workflow

    class FakeLauncher:
        def add_ref(self, wf):
            self.workflow = wf

        def del_ref(self, wf):
            pass

    launcher = FakeLauncher()
    launcher.graphics_server = GraphicsServer()
    wf = Workflow(launcher, name="gfx")
    o = Obj()
    o.v = torch.tensor(1.5)
    p = AccumulatingPlotter(wf, obj=o, attr="v")
    sub = _subscriber(launcher.graphics_server.endpoint)
    try:
        p.run()
        assert sub.poll(3000)
        blob = gzip.decompress(sub.recv())
        assert b"veles_tpu" not in blob
        assert safe_loads(blob)["series"] == {"v": [1.5]}
    finally:
        sub.close(0)
        launcher.graphics_server.close()


def test_graphics_client_renders_what_it_receives(tmp_path):
    """``graphics_client.main`` subscribes, renders one payload to a PNG
    and returns."""
    pytest.importorskip("zmq")
    pytest.importorskip("matplotlib")
    from veles_tpu_torch import graphics_client
    from veles_tpu_torch.graphics_server import GraphicsServer
    server = GraphicsServer()
    out = {}
    t = threading.Thread(target=lambda: out.update(rc=graphics_client.main(
        [server.endpoint, "--out", str(tmp_path), "--timeout", "20",
         "--limit", "1"])))
    t.start()
    try:
        deadline = time.time() + 20
        while t.is_alive() and not out and time.time() < deadline:
            server.enqueue({"kind": "curve", "series": {"x": [1.0, 2.0]},
                            "name": "loss_curve"})
            t.join(0.3)
    finally:
        t.join(30)
        server.close()
    assert out.get("rc") == 0 and (tmp_path / "loss_curve.png").exists()
    import matplotlib.pyplot as plt
    plt.close("all")


# -- web status -----------------------------------------------------------------

@pytest.fixture(scope="module")
def status_server():
    from veles_tpu_torch.web_status import WebStatusServer
    server = WebStatusServer(port=0, host="127.0.0.1")
    server.start()
    yield server
    server.stop()


def _url(server):
    return "http://127.0.0.1:%d" % server.port


def test_web_status_update_and_pages(status_server):
    url = _url(status_server)
    run = {"id": "run-1", "workflow": "MNIST", "mode": "master",
           "metrics": {"validation_error_pct": 2.5},
           "workers": [{"id": "w0", "state": "WORK", "jobs": 3}]}
    assert _post(url + "/update", run)["ok"]
    runs = json.loads(_get(url + "/api/runs"))["runs"]
    assert runs["run-1"]["workflow"] == "MNIST"
    page = _get(url + "/")
    assert "MNIST" in page and "w0: WORK" in page


def test_runs_table_matches_reference(monkeypatch):
    """The run table is the reference's for the same runs, the clock
    pinned (each row says how long ago it was updated)."""
    from veles_tpu.web_status import _render_runs as jax_render
    from veles_tpu_torch.web_status import _render_runs
    monkeypatch.setattr(time, "time", lambda: 1000.0)
    runs = {"run-1": {"id": "run-1", "workflow": "MNIST", "mode": "master",
                      "metrics": {"loss": 0.5, "<b>": "&"},
                      "workers": [{"id": "w0", "state": "WORK",
                                   "jobs": 3}], "_received": 995.0},
            "old": {"workflow": "X", "_received": 900.0}}
    assert _render_runs(runs) == jax_render(runs)
    assert 'class="dead"' in _render_runs(runs)


def test_status_notifier(status_server):
    from veles_tpu_torch.web_status import StatusNotifier

    class FakeWorkflow:
        name = "FakeWF"

        def gather_results(self):
            return {"loss": 0.5}

    class FakeLauncher:
        mode = "standalone"
        workflow = FakeWorkflow()
        coordinator = None

    url = _url(status_server)
    notifier = StatusNotifier(url, FakeLauncher(), interval=60)
    notifier._post_once()
    runs = json.loads(_get(url + "/api/runs"))["runs"]
    assert any(r.get("workflow") == "FakeWF" for r in runs.values())
    assert notifier.posted == 1


def test_web_status_graph_and_events(status_server):
    url = _url(status_server)
    _post(url + "/update", {
        "id": "run-g", "workflow": "MNIST", "mode": "standalone",
        "metrics": {},
        "graph": {"name": "MNIST", "nodes": [
            {"id": 0, "label": "Start", "cls": "StartPoint",
             "group": "PLUMBING"},
            {"id": 1, "label": "loader", "cls": "MnistLoader",
             "group": "LOADER"},
            {"id": 2, "label": "trainer", "cls": "GradientDescent",
             "group": "TRAINER"},
            {"id": 3, "label": "repeater", "cls": "Repeater",
             "group": "PLUMBING"},
        ], "edges": [[0, 1], [1, 2], [2, 3], [3, 1]]},
        "events": [
            {"name": "serve", "kind": "begin", "cls": "MnistLoader",
             "time": 100.0},
            {"name": "serve", "kind": "end", "cls": "MnistLoader",
             "time": 100.5},
            {"name": "step", "kind": "single",
             "cls": "GradientDescent", "time": 101.0},
        ]})
    page = _get(url + "/graph/run-g")
    assert "<svg" in page
    for label in ("Start", "loader", "trainer", "repeater"):
        assert label in page
    assert "stroke-dasharray" in page  # the repeater's back edge
    page = _get(url + "/events/run-g")
    assert "serve" in page and "step" in page
    page = _get(url + "/events/run-g?unit=GradientDescent")
    assert "step" in page and "serve" not in page
    page = _get(url + "/events/run-g?kind=begin")
    assert "begin" in page and "single</td>" not in page
    page = _get(url + "/")
    assert "/graph/run-g" in page and "/events/run-g" in page


def test_graph_svg_matches_reference():
    """The SVG and the events table are the reference's for the same
    graph and events."""
    from veles_tpu.web_status import (
        _render_events as jax_events, render_graph_svg as jax_svg)
    from veles_tpu_torch.web_status import _render_events, render_graph_svg
    graph = {"nodes": [{"id": i, "label": "u%d" % i, "cls": "C",
                        "group": g} for i, g in enumerate(
                            ["PLUMBING", "LOADER", "TRAINER"])],
             "edges": [[0, 1], [1, 2], [2, 1]]}
    assert render_graph_svg(graph) == jax_svg(graph)
    evs = [{"name": "a", "kind": "begin", "unit": "u", "time": 5.25}]
    assert _render_events("r", evs) == jax_events("r", evs)


def test_notifier_ships_graph_and_events(status_server):
    from veles_tpu_torch.logger import events as sink
    from veles_tpu_torch.web_status import StatusNotifier

    class FakeWorkflow:
        name = "GraphWF"

        def gather_results(self):
            return {}

        def graph_dict(self):
            return {"name": "GraphWF",
                    "nodes": [{"id": 0, "label": "u", "cls": "U",
                               "group": "WORKER"}],
                    "edges": []}

    class FakeLauncher:
        mode = "standalone"
        workflow = FakeWorkflow()
        coordinator = None

    sink.record("probe-span", "single", cls="TestUnit")
    url = _url(status_server)
    StatusNotifier(url, FakeLauncher())._post_once()
    runs = json.loads(_get(url + "/api/runs"))["runs"]
    run = next(r for r in runs.values() if r.get("workflow") == "GraphWF")
    assert run["graph"]["nodes"][0]["label"] == "u"
    assert any(e["name"] == "probe-span" for e in run["events"])


def test_web_status_escapes_update_fields(status_server):
    url = _url(status_server)
    evil = "<script>alert(1)</script>"
    _post(url + "/update", {
        "id": "run-x", "workflow": evil, "mode": evil,
        "metrics": {evil: evil},
        "workers": [{"id": evil, "state": evil, "jobs": 1}],
        "graph": {"nodes": [{"id": 0, "label": evil, "cls": evil,
                             "group": "WORKER"}], "edges": []}})
    for path in ("/", "/graph/run-x"):
        assert "<script>" not in _get(url + path), path


def test_web_status_malformed_input_is_400(status_server):
    """A malformed graph, event list or update answers 400, never 500;
    an unknown run 404."""
    url = _url(status_server)
    _post(url + "/update", {"id": "run-bad", "graph": {"nodes": [
        {"label": "no id"}], "edges": [[0, 9]]}, "events": [1, 2]})
    for path, code in (("/graph/run-bad", 400), ("/events/run-bad", 400),
                       ("/graph/no-such-run", 404)):
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(url + path)
        assert e.value.code == code, path
    req = urllib.request.Request(url + "/update", data=b"{not json")
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=5)
    assert e.value.code == 400


def test_web_status_telemetry_routes(status_server):
    """``/alerts`` and ``/dashboard`` over the port's alert engines and
    in-flight table, ``/healthz``, ``/metrics`` and ``/debug/state``."""
    from veles_tpu_torch.telemetry import alerts, metrics
    url = _url(status_server)
    engine = alerts.AlertEngine(name="services-test")   # registered, idle
    got = json.loads(_get(url + "/alerts"))
    assert sorted(got) == ["engines", "firing"]
    assert "services-test" in json.dumps(got["engines"])
    assert "<html" in _get(url + "/dashboard").lower()
    del engine
    health = json.loads(_get(url + "/healthz"))
    assert health["status"] in ("ok", "degraded")
    metrics.counter("veles_services_test_total", "a probe").inc()
    assert "veles_services_test_total 1" in _get(url + "/metrics")
    state = json.loads(_get(url + "/debug/state"))
    assert sorted(state) == ["events", "flightrec", "health", "logs"]


# -- a training run ---------------------------------------------------------------

def test_standard_workflow_plotters_collect():
    """The reference's plot set: the validation error once per epoch,
    equal to the decision's history, and the train loss per decision
    run."""
    from veles_tpu_torch.samples.mnist import MnistWorkflow
    wf = MnistWorkflow(layers=[32, 10], max_epochs=2, synthetic_train=512,
                       synthetic_valid=128, minibatch_size=128,
                       dtype="float32", snapshotter_config={"enabled": False})
    for p in wf.plotters:
        p.collect = True
    wf.initialize(device="cpu")
    wf.run()
    curves = {p.name: p.last_payload for p in wf.plotters}
    assert sorted(curves) == ["error_curve", "loss_curve"]
    assert curves["error_curve"]["series"]["validation error"] == [
        h["validation_error_pct"] for h in wf.decision.history]
    losses = curves["loss_curve"]["series"]["train loss"]
    assert all(h["validation_loss"] in losses for h in wf.decision.history)


def test_jax_snapshot_carries_the_plotters(tmp_path):
    """A JAX snapshot's plotting units map onto the port's (none is
    dropped): the resumed workflow's curves hold the JAX run's series."""
    from veles_tpu.backends import Device
    from veles_tpu.samples.mnist import MnistWorkflow as JaxMnist
    from veles_tpu_torch.snapshotter import SnapshotterToFile
    from tests.test_torch_workflow import jax_state
    keys = dict(synthetic_train=256, synthetic_valid=64, minibatch_size=64,
                max_epochs=2, snapshot_time_interval=1e9)
    with jax_state("mnist_tpu", tmp_path, **keys):
        jwf = JaxMnist(None, layers=[16, 10])
        for p in jwf.plotters:
            p.collect = True
        jwf.initialize(device=Device(backend="numpy"))
        try:
            jwf.run()
        finally:
            jwf.loader.stop()
        jwf.snapshotter.export()
        series = {p.name: list(p.series) for p in jwf.plotters}
    wf = SnapshotterToFile.import_file(jwf.snapshotter.destination)
    assert {p.name: p.series for p in wf.plotters} == series
    assert sorted(series) == ["error_curve", "loss_curve"] \
        and all(series.values())


def test_shell_unit_runs_its_hook_once():
    from veles_tpu_torch.interaction import Shell
    from veles_tpu_torch.workflow import Workflow
    wf = Workflow(None, name="shell")
    seen = []
    shell = Shell(wf)
    shell.interact_hook = seen.append
    shell.run()
    shell.run()
    assert len(seen) == 1 and seen[0]["workflow"] is wf \
        and seen[0]["unit"] is shell


# -- the frontend -------------------------------------------------------------------

def test_frontend_composes_and_executes(tmp_path):
    """The form lists every flag; a submitted form resolves ``wait()``
    with the composed argv, equal to the JAX package's composition of
    the same form, which the parser reads back."""
    from veles_tpu.frontend import compose_argv as jax_compose
    from veles_tpu_torch.cmdline import build_parser
    from veles_tpu_torch.frontend import Frontend, compose_argv
    parser = build_parser()
    frontend = Frontend(parser, port=0)
    try:
        page = _get("http://127.0.0.1:%d/" % frontend.port)
        assert "--optimize" in page and "--listen" in page
        form = {"workflow": "wf.py", "config": "cfg.py",
                "config_override": "root.a=1;;root.b=2",
                "graphics": "1", "verbose": "1",
                "result_file": str(tmp_path / "r.json")}
        body = urllib.parse.urlencode(form).encode()
        out = {}

        def submit():
            req = urllib.request.Request(
                "http://127.0.0.1:%d/compose" % frontend.port, data=body)
            out["reply"] = json.load(urllib.request.urlopen(req, timeout=5))

        t = threading.Thread(target=submit)
        t.start()
        argv = frontend.wait(10)
        t.join(5)
    finally:
        frontend.stop()
    assert argv[:2] == ["wf.py", "cfg.py"]
    assert argv.count("--config-override") == 2 and "root.b=2" in argv
    assert "--graphics" in argv and "--verbose" in argv
    assert out["reply"]["argv"] == argv
    from veles_tpu.cmdline import build_parser as jax_parser
    assert argv == jax_compose(jax_parser(), form) == compose_argv(
        parser, form)
    ns = build_parser().parse_args(argv)
    assert ns.workflow == "wf.py" and ns.graphics
    assert ns.config_override == ["root.a=1", "root.b=2"]
