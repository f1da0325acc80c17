"""The workflow runtime of the PyTorch port held against the JAX package
on the CPU (``Device(backend="numpy")`` on the JAX side, ``device="cpu"``
on the port's), float32 throughout:

- ``memory.Array``'s map states against the JAX ``Array`` (oracle
  ``tests/test_backends_memory.py``);
- ``FusedSegment`` plans and results against the JAX ones (oracle
  ``tests/test_accelerated.py``);
- the sample workflows — MNIST, CIFAR (mean_disp), the transformer,
  the LM, Kohonen, a narrow AlexNet and an MSE regression — built in
  both packages, the JAX workflow's initial weights carried into the
  port's (``convert.load_workflow_params``), both run by
  ``Workflow.run()`` for 2 epochs: ``DecisionGD.epoch_metrics`` at every
  closed epoch, ``global_step``, the loader's epoch flags and the final
  weights within 2e-5;
- the per-minibatch path (``span_serving=False``) against the JAX one
  and against spans;
- snapshots: snapshot → ``import_file`` → resume equal to an
  uninterrupted run bit for bit, every codec with its ``_current``
  link, ``weights_dtype="int8"``, ``SnapshotterToDB`` on sqlite;
  ``Rollback`` restoring the best weights;
- the LM and AlexNet workflows equal to ``build_lm``/``train_lm`` and
  ``build_alexnet``/``train_alexnet`` bit for bit.

JAX workflows draw weights and shuffles from the JAX package's
process-wide generators and read ``root.<sample>_tpu``: every test here
restores both (:func:`jax_state`)."""

import contextlib
import os
import pickle

import numpy
import pytest
import torch

pytestmark = pytest.mark.torch_port

W = 2e-5
GENERATORS = ("default", "loader", "trainer", "kohonen")


def _close(got, want, tol=W):
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else got
    numpy.testing.assert_allclose(numpy.asarray(got, numpy.float64),
                                  numpy.asarray(want, numpy.float64),
                                  rtol=tol, atol=tol)


@contextlib.contextmanager
def jax_state(ns=None, tmp=None, **keys):
    """f32 compute, ``root.<ns>`` set to ``keys``, snapshots into
    ``tmp``, the ``loader``/``trainer`` generators seeded 42 (the port's
    default seeds) — all restored afterwards, with every generator the
    JAX workflows draw from."""
    from veles_tpu import prng
    from veles_tpu.config import root
    nodes = [root.common.precision, root.common.dirs]
    if ns is not None:
        nodes.append(getattr(root, ns))
    saved = [(n, dict(vars(n))) for n in nodes]
    gens = {g: prng.get(g).state for g in GENERATORS}
    try:
        root.common.precision.compute_dtype = "float32"
        if tmp is not None:
            root.common.dirs.snapshots = str(tmp)
        if ns is not None:
            getattr(root, ns).update(keys)
        for g in ("loader", "trainer"):
            prng.get(g).seed(42)
        yield
    finally:
        for node, d in saved:
            vars(node).clear()
            vars(node).update(d)
        for g, s in gens.items():
            prng.get(g).state = s


def _jax_device():
    from veles_tpu.backends import Device
    return Device(backend="numpy")


def _jax_params(forwards):
    return {i: {n: numpy.array(a.map_read().mem)
                for n, a in u.param_arrays().items()}
            for i, u in enumerate(forwards)}


def _record_epochs(decision):
    """Each closed epoch's ``epoch_metrics`` (a copy), in order."""
    rows = []
    orig = decision._on_epoch_ended

    def wrapped():
        orig()
        rows.append(dict(decision.epoch_metrics))
    decision._on_epoch_ended = wrapped
    return rows


def _loader_state(l):
    return (l.epoch_number, bool(l.train_ended), bool(l.epoch_ended),
            bool(l.last_minibatch), l.global_offset, l.samples_served,
            list(l.class_lengths))


def _compare_runs(jwf, pwf, jrows, prows):
    assert len(prows) == len(jrows) == 2
    for got, want in zip(prows, jrows):
        assert sorted(got) == sorted(want)
        for k in want:
            _close(got[k], want[k])
    assert pwf.gd.global_step == jwf.gd.global_step > 0
    assert _loader_state(pwf.loader) == _loader_state(jwf.loader)
    assert bool(pwf.decision.complete) and bool(jwf.decision.complete)
    from veles_tpu_torch.convert import params_to_numpy
    got, want = params_to_numpy(pwf.gd.forwards), _jax_params(jwf.forwards)
    for i in want:
        for n in want[i]:
            _close(got[i][n], want[i][n])


# -- Array -------------------------------------------------------------------

def _array_script(Array, device, to_dev, from_dev):
    """One sequence of map-state operations; returns what it observed."""
    out = []
    a = Array(numpy.arange(12, dtype=numpy.float32).reshape(3, 4))
    a.initialize(device)
    out.append(from_dev(a.devmem))
    a.map_write()
    a.mem[1] = -1
    a.unmap()
    out.append(from_dev(a.devmem))
    a.devmem = to_dev(numpy.full((3, 4), 7, numpy.float32))
    out.append(repr(a))
    a.map_read()
    out += [a.mem.copy(), repr(a)]
    a.map_invalidate()
    a.mem[...] = 3
    out.append(from_dev(a.unmap().devmem))
    a[0, 0] = 9
    out += [a[0].copy(), a.shape, a.size, a.nbytes, len(a), bool(a)]
    a.devmem = to_dev(numpy.full((3, 4), 41, numpy.float32))
    b = pickle.loads(pickle.dumps(a))
    out += [b.mem.copy(), repr(b)]
    b.initialize(device)
    out.append(from_dev(b.devmem))
    c = Array()
    out += [bool(c), len(c), c.shape]
    c.initialize(device)
    c.devmem = to_dev(numpy.ones((2, 3), numpy.float32))
    c.map_invalidate()
    out.append(c.mem.shape)
    d = Array()
    d.initialize(device)
    d.adopt(numpy.ones(3, numpy.float32),
            to_dev(numpy.ones(3, numpy.float32)))
    out.append(repr(d))
    d.adopt(numpy.zeros(3, numpy.float32),
            to_dev(numpy.full(3, 2, numpy.float32)), dev_dirty=True)
    out += [repr(d), d.map_read().mem.copy()]
    d.adopt(numpy.full(3, 5, numpy.float32))
    out += [repr(d), from_dev(d.devmem)]
    return out


def test_array_states_match_reference():
    import jax.numpy as jnp
    from veles_tpu.memory import Array as JArray, Watcher as JWatcher
    from veles_tpu.memory import roundup as jroundup
    from veles_tpu_torch.memory import Array, Watcher, roundup
    want = _array_script(JArray, _jax_device(), jnp.asarray, numpy.asarray)
    got = _array_script(Array, "cpu", torch.as_tensor,
                        lambda t: t.numpy().copy())
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, numpy.ndarray):
            numpy.testing.assert_array_equal(g, w)
        else:
            assert g == w
    for n, k in ((5, 8), (8, 8), (0, 8), (17, 4)):
        assert roundup(n, k) == jroundup(n, k)
    for W_, A, dev in ((JWatcher, JArray, _jax_device()),
                       (Watcher, Array, "cpu")):
        W_.reset()
        a = A(numpy.zeros(1024, numpy.float32))
        a.initialize(dev)
        assert W_.total() == 0
        a.devmem
        assert W_.total() == 4096
        a.reset()
        assert W_.total() == 0


def test_array_bf16_tensor_mirrors_as_f32():
    from veles_tpu_torch.memory import Array
    a = Array()
    a.initialize("cpu")
    a.devmem = torch.full((2, 2), 1.5, dtype=torch.bfloat16)
    assert a.map_read().mem.dtype == numpy.float32
    a.map_write()
    a.mem[0, 0] = 2.0
    assert a.unmap().devmem.dtype == torch.bfloat16
    assert float(a.devmem[0, 0]) == 2.0


# -- FusedSegment --------------------------------------------------------------

def _accel_classes(mod, memory, units):
    class Scale(mod.AcceleratedUnit):
        READS = ("input",)
        WRITES = ("output",)

        def __init__(self, workflow, factor=2.0, **kwargs):
            super(Scale, self).__init__(workflow, **kwargs)
            self.factor = factor
            self.input = None
            self.output = memory.Array()
            self.demand("input")

        def initialize(self, device=None, **kwargs):
            if self.input is None or not bool(self.input):
                raise units.MissingDemand(self, {"input"})
            self.output.reset(numpy.zeros_like(self.input.mem))
            super(Scale, self).initialize(device=device, **kwargs)

        def step(self, input):
            return {"output": input * self.factor}

    class Add(Scale):
        READS = ("input", "other")

        def step(self, input, other):
            return {"output": input + other}

    class Accumulate(mod.AcceleratedUnit):
        READS = ("input", "total")
        WRITES = ("total",)

        def __init__(self, workflow, **kwargs):
            super(Accumulate, self).__init__(workflow, **kwargs)
            self.input = None
            self.total = memory.Array(numpy.zeros((), numpy.float32))

        def step(self, input, total):
            return {"total": total + input.sum()}

    return Scale, Add, Accumulate


def _fused(pkg, kind):
    if pkg == "jax":
        import veles_tpu.accelerated_units as mod
        import veles_tpu.memory as memory
        import veles_tpu.units as units
        device = _jax_device()
    else:
        import veles_tpu_torch.accelerated_units as mod
        import veles_tpu_torch.memory as memory
        import veles_tpu_torch.units as units
        device = "cpu"
    Scale, Add, Accumulate = _accel_classes(mod, memory, units)
    wf = mod.AcceleratedWorkflow(None, name="fuse")
    src = memory.Array(numpy.arange(8, dtype=numpy.float32))
    s0 = Scale(wf, factor=2.0, name="s0")
    s0.input = src
    s0.link_from(wf.start_point)
    s1 = Scale(wf, factor=3.0, name="s1")
    s1.link_attrs(s0, ("input", "output"))
    s1.link_from(s0)
    last = s1
    made = [s0, s1]
    if kind == "diamond":
        s2 = Scale(wf, factor=5.0, name="s2")
        s2.link_attrs(s0, ("input", "output"))
        s2.link_from(s0)
        j = Add(wf, name="join")
        j.link_attrs(s1, ("input", "output"))
        j.link_attrs(s2, ("other", "output"))
        j.link_from(s1, s2)
        last = j
        made += [s2, j]
    acc = Accumulate(wf, name="acc")
    acc.link_attrs(last, ("input", "output"))
    acc.link_from(last)
    made.append(acc)
    wf.end_point.link_from(acc)
    if kind == "skip":
        s1.gate_skip <<= True
    wf.initialize(device=device)
    plans = [([u.name for u in s.units], s.plan()[1:])
             for s in wf._segments_]
    outs = []
    for _ in range(2):
        wf.run()
        outs.append([numpy.array(u.output.map_read().mem)
                     if hasattr(u, "output") else
                     numpy.array(u.total.map_read().mem)
                     for u in made])
    return plans, outs


@pytest.mark.parametrize("kind", ["chain", "diamond", "skip"])
def test_fused_segments_match_reference(kind):
    """Segment membership, each plan's donated/held/output slots, and
    every unit's output over two runs (the skip run falls back to
    per-unit steps)."""
    jplans, jouts = _fused("jax", kind)
    pplans, pouts = _fused("port", kind)
    assert pplans == jplans and pplans
    for g, w in zip(pouts, jouts):
        for a, b in zip(g, w):
            assert numpy.shape(a) == numpy.shape(b)
            _close(a, b, 0)


def test_device_benchmark_and_power():
    from veles_tpu_torch.accelerated_units import (
        AcceleratedWorkflow, DeviceBenchmark)
    wf = AcceleratedWorkflow(None, name="bench")
    b = DeviceBenchmark(wf)
    b.link_from(wf.start_point)
    wf.end_point.link_from(b)
    wf.initialize(device="cpu")
    assert b.computing_power > 0 and wf.computing_power > 0


# -- the sample workflows ------------------------------------------------------

def _mse_loaders():
    from veles_tpu.loader.fullbatch import FullBatchLoaderMSE as J
    from veles_tpu_torch.loader.fullbatch import FullBatchLoaderMSE as P

    def load(self):
        rng = numpy.random.default_rng(11)
        x = rng.standard_normal((48, 6)).astype(numpy.float32)
        self.class_lengths[:] = [0, 16, 32]
        self.original_data = x
        self.original_targets = numpy.tanh(
            x @ rng.standard_normal((6, 3))).astype(numpy.float32)
        self.original_labels = None
    return (type("Regression", (J,), {"load_data": load}),
            type("Regression", (P,), {"load_data": load}))


SAMPLES = {
    "mnist": ("mnist_tpu", dict(
        synthetic_train=96, synthetic_valid=32, minibatch_size=32,
        layers=(24, 10))),
    "cifar": ("cifar_tpu", dict(
        synthetic_train=64, synthetic_valid=32, minibatch_size=32)),
    "transformer": ("transformer_tpu", dict(
        vocab=16, dim=32, blocks=1, heads=2, seq=16, synthetic_train=64,
        synthetic_valid=32, minibatch_size=32)),
    "lm": ("lm_tpu", dict(
        vocab=16, dim=32, blocks=1, heads=2, seq=16, synthetic_train=48,
        synthetic_valid=16, minibatch_size=16)),
    "alexnet": ("alexnet_tpu", dict(
        side=67, classes=10, synthetic_train=32, synthetic_valid=16,
        minibatch_size=16)),
    "mse": (None, {}),
}


def _build_jax(name, keys, spans):
    """The JAX sample workflow ``name`` (``root`` keys already set)."""
    if name == "mnist":
        from veles_tpu.samples.mnist import MnistWorkflow
        wf = MnistWorkflow(None, layers=keys["layers"], plotters=False)
    elif name == "cifar":
        from veles_tpu.samples.cifar import CifarWorkflow
        wf = CifarWorkflow(None, plotters=False)
    elif name == "transformer":
        from veles_tpu.samples.transformer import TransformerWorkflow
        wf = TransformerWorkflow(None, plotters=False)
    elif name == "lm":
        from veles_tpu.samples.lm import LMWorkflow
        wf = LMWorkflow(None, plotters=False)
    elif name == "alexnet":
        from veles_tpu.samples.alexnet import AlexNetWorkflow
        from veles_tpu_torch.samples.alexnet import alexnet_layers
        narrow = alexnet_layers(10, 0.5, (8, 16, 24, 24, 16, 32))
        import veles_tpu.samples.alexnet as jalex
        orig = jalex.alexnet_layers
        jalex.alexnet_layers = lambda *a, **k: narrow
        try:
            wf = AlexNetWorkflow(None, plotters=False)
        finally:
            jalex.alexnet_layers = orig
    else:
        from veles_tpu.models.standard import StandardWorkflow
        wf = StandardWorkflow(
            None, loader_factory=_mse_loaders()[0],
            loader_config={"minibatch_size": 16}, layers=_mse_layers(),
            loss="mse", solver="sgd", learning_rate=0.05,
            gradient_moment=0.9,
            decision_config={"max_epochs": 2},
            snapshotter_config={"time_interval": 1e9}, plotters=False)
    if not spans:
        wf.loader.span_serving = False
    return wf


def _mse_layers():
    return [{"type": "all2all_tanh", "output_sample_shape": (8,)},
            {"type": "all2all", "output_sample_shape": (3,)}]


def _build_port(name, keys, spans, tmp):
    snap = {"directory": str(tmp), "time_interval": 1e9}
    common = dict(max_epochs=2, dtype="float32", snapshotter_config=snap)
    if name == "mnist":
        from veles_tpu_torch.samples.mnist import MnistWorkflow
        wf = MnistWorkflow(**keys, **common)
    elif name == "cifar":
        from veles_tpu_torch.samples.cifar import CifarWorkflow
        wf = CifarWorkflow(**keys, **common)
    elif name == "transformer":
        from veles_tpu_torch.samples.transformer import TransformerWorkflow
        wf = TransformerWorkflow(**keys, **common)
    elif name == "lm":
        from veles_tpu_torch.samples.lm import LMWorkflow
        wf = LMWorkflow(**keys, **common)
    elif name == "alexnet":
        from veles_tpu_torch.samples.alexnet import AlexNetWorkflow
        wf = AlexNetWorkflow(widths=(8, 16, 24, 24, 16, 32), **keys,
                             **common)
    else:
        from veles_tpu_torch.models.standard import StandardWorkflow
        wf = StandardWorkflow(
            loader_factory=_mse_loaders()[1],
            loader_config={"minibatch_size": 16}, layers=_mse_layers(),
            loss="mse", solver="sgd", learning_rate=0.05,
            gradient_moment=0.9, decision_config={"max_epochs": 2},
            snapshotter_config=snap, dtype="float32")
    if not spans:
        wf.loader.span_serving = False
    return wf


def _run_pair(name, tmp_path, spans=True):
    ns, keys = SAMPLES[name]
    jkeys = dict(keys, max_epochs=2, snapshot_time_interval=1e9)
    jkeys.pop("layers", None)
    with jax_state(ns, tmp_path / "jax", **jkeys):
        jwf = _build_jax(name, keys, spans)
        jwf.initialize(device=_jax_device())
        jrows = _record_epochs(jwf.decision)
        params = _jax_params(jwf.forwards)
        jwf.run()
    from veles_tpu_torch.convert import load_workflow_params
    pwf = _build_port(name, keys, spans, tmp_path / "port")
    pwf.initialize(device="cpu")
    load_workflow_params(pwf, params)
    prows = _record_epochs(pwf.decision)
    pwf.run()
    return jwf, pwf, jrows, prows


@pytest.mark.parametrize("name", sorted(SAMPLES))
def test_sample_workflow_matches_reference(name, tmp_path):
    """Two epochs of the sample through ``Workflow.run()`` in both
    packages from the same weights (spans where the reference spans)."""
    jwf, pwf, jrows, prows = _run_pair(name, tmp_path)
    assert pwf.loader.span_serving and jwf.loader.span_serving
    _compare_runs(jwf, pwf, jrows, prows)
    assert [u.name for u in pwf.units] == [u.name for u in jwf.units
                                           if u not in jwf.plotters
                                           and u not in jwf.forwards
                                           and u is not jwf.evaluator]


@pytest.mark.parametrize("name", ["mnist", "mse", "lm"])
def test_minibatch_path_matches_reference(name, tmp_path):
    """``span_serving=False``: the synchronous per-minibatch path in both
    packages."""
    jwf, pwf, jrows, prows = _run_pair(name, tmp_path, spans=False)
    assert pwf.loader.span_serving is False
    _compare_runs(jwf, pwf, jrows, prows)


def test_minibatch_path_equals_spans(tmp_path):
    """Without dropout the two serving paths train the same weights."""
    from veles_tpu_torch.convert import params_to_numpy
    runs = []
    for spans in (True, False):
        wf = _build_port("mnist", SAMPLES["mnist"][1], spans,
                         tmp_path / str(spans))
        wf.initialize(device="cpu")
        wf.run()
        runs.append((params_to_numpy(wf.gd.forwards), wf.decision.history,
                     _loader_state(wf.loader), wf.gd.global_step))
    (pa, ha, la, sa), (pb, hb, lb, sb) = runs
    assert (la, sa) == (lb, sb)
    for i in pa:
        for n in pa[i]:
            _close(pa[i][n], pb[i][n], 1e-6)
    for a, b in zip(ha, hb):
        for k in a:
            _close(a[k], b[k], 1e-6)


def test_kohonen_workflow_matches_reference(tmp_path):
    """The SOM sample: per-epoch quantization errors, the map and the
    winners of the last epoch's BMU pass."""
    from veles_tpu.samples.kohonen import KohonenWorkflow as J
    from veles_tpu_torch.samples.kohonen import KohonenWorkflow as P
    keys = dict(samples=256, minibatch_size=64, shape=(4, 4), max_epochs=2)
    with jax_state("kohonen_tpu", tmp_path, **keys):
        jwf = J(None)
        jwf.initialize(device=_jax_device())
        w0 = numpy.array(jwf.trainer.weights.map_read().mem)
        try:
            jwf.run()
        finally:
            jwf.loader.stop()
    pwf = P(**keys)
    pwf.initialize(device="cpu")
    pwf.trainer.weights = torch.as_tensor(w0)
    try:
        pwf.run()
    finally:
        pwf.stop()     # joins the per-minibatch loader's prefetch threads
    assert len(pwf.decision.epoch_qerror) == 2
    _close(pwf.decision.epoch_qerror, jwf.decision.epoch_qerror)
    _close(pwf.trainer.weights, jwf.trainer.weights.map_read().mem)
    assert pwf.trainer.time == jwf.trainer.time == 8
    numpy.testing.assert_array_equal(
        pwf.forward.output.map_read().mem,
        jwf.forward.output.map_read().mem)
    assert _loader_state(pwf.loader) == _loader_state(jwf.loader)
    assert pwf.gather_results() == {
        "quantization_error": pwf.decision.epoch_qerror[-1],
        "Total epochs": 2}


# -- workflow against the direct entry points ------------------------------

def test_lm_workflow_equals_train_lm():
    """``LMWorkflow`` is ``build_lm`` + ``train_lm`` from the same seeds:
    the same per-epoch rows and bit-equal weights."""
    from veles_tpu_torch.samples.lm import LMWorkflow, build_lm, train_lm
    wf = LMWorkflow(dim=32, blocks=1, heads=2, vocab=16, seq=16,
                    synthetic_train=48, synthetic_valid=16,
                    minibatch_size=16, max_epochs=2, dtype="float32",
                    snapshotter_config={"enabled": False})
    wf.initialize(device="cpu")
    wf.run()
    lm = build_lm(vocab=16, dim=32, blocks=1, heads=2, seq=16, n_train=48,
                  n_valid=16, minibatch_size=16, device="cpu",
                  dtype="float32")
    history = train_lm(lm, 2)
    assert wf.decision.history == history
    for a, b in zip(wf.gd.forwards, lm.chain):
        for n in a.params:
            assert torch.equal(a.params[n], b.params[n])


def _alexnet_wf(tmp, **kw):
    from veles_tpu_torch.samples.alexnet import AlexNetWorkflow
    return AlexNetWorkflow(
        side=67, widths=(8, 16, 24, 24, 16, 32), classes=10,
        synthetic_train=32, synthetic_valid=16, minibatch_size=16,
        dtype="float32", snapshot_compression=None,
        snapshot_time_interval=0.0,
        snapshotter_config={"directory": str(tmp)}, **kw)


def test_alexnet_workflow_equals_train_alexnet(tmp_path):
    """``AlexNetWorkflow`` (dropout on: the trainer's keys and the
    dataset's draw) is ``build_alexnet`` + ``train_alexnet``."""
    from veles_tpu_torch.samples.alexnet import build_alexnet, train_alexnet
    wf = _alexnet_wf(tmp_path, max_epochs=2)
    wf.initialize(device="cpu")
    wf.run()
    net = build_alexnet(minibatch_size=16, side=67, classes=10, n_train=32,
                        n_valid=16, widths=(8, 16, 24, 24, 16, 32),
                        device="cpu", dtype="float32")
    assert wf.decision.history == train_alexnet(net, 2)
    for a, b in zip(wf.gd.forwards, net.chain):
        for n in a.params:
            assert torch.equal(a.params[n], b.params[n])


# -- snapshots -----------------------------------------------------------------

def _weights(wf):
    return [{n: t.detach().clone() for n, t in u.params.items()}
            for u in wf.gd.forwards]


def _equal_weights(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert sorted(x) == sorted(y)
        assert all(torch.equal(x[n], y[n]) for n in x)


@pytest.mark.parametrize("after", ["first validation", "epoch 1"])
def test_snapshot_resume_equals_uninterrupted(after, tmp_path):
    """Snapshot → ``import_file`` → ``initialize`` → ``run()`` ends with
    the weights, solver slots, step and history of the uninterrupted run,
    bit for bit: the decision-gated snapshot (written at the first
    improvement, after epoch 1's validation span), and one written at
    the end of epoch 1 by an ungated snapshotter of ``interval`` 2 (the
    decision's second run; its fourth ends the workflow before the
    snapshotter runs again)."""
    from veles_tpu_torch.snapshotter import SnapshotterToFile
    full = _alexnet_wf(tmp_path / "full", max_epochs=2)
    full.initialize(device="cpu")
    full.run()
    first = _alexnet_wf(tmp_path / "snap", max_epochs=2)
    if after == "epoch 1":
        first.snapshotter.decision = None
        first.snapshotter.interval = 2
    first.initialize(device="cpu")
    first.run()
    _equal_weights(_weights(first), _weights(full))
    path = os.path.join(str(tmp_path / "snap"), "alexnet.pickle")
    resumed = SnapshotterToFile.import_file(path)
    assert resumed._restored_from_snapshot_
    assert resumed.gd.global_step == (0 if after == "first validation"
                                      else 2)
    assert all(t.device.type == "cpu" for u in resumed.gd.forwards
               for t in u.params.values())
    assert not resumed.decision.complete
    resumed.snapshotter.directory = str(tmp_path / "again")
    resumed.initialize(device="cpu")
    resumed.run()
    _equal_weights(_weights(resumed), _weights(full))
    assert resumed.gd.global_step == full.gd.global_step == 4
    for k, slots in full.gd.opt_state.items():
        for s, t in slots.items():
            assert torch.equal(resumed.gd.opt_state[k][s], t)
    assert resumed.decision.history == full.decision.history
    assert _loader_state(resumed.loader) == _loader_state(full.loader)


@pytest.mark.parametrize("codec", [None, "gz", "bz2", "xz"])
def test_snapshot_codecs_and_current_link(codec, tmp_path):
    from veles_tpu_torch.snapshotter import EXT, SnapshotterToFile
    from veles_tpu_torch.samples.mnist import MnistWorkflow
    wf = MnistWorkflow(synthetic_train=64, synthetic_valid=32,
                       minibatch_size=32, layers=(8, 10), max_epochs=1,
                       dtype="float32", snapshot_compression=codec,
                       snapshot_time_interval=0.0,
                       snapshotter_config={"directory": str(tmp_path)})
    wf.initialize(device="cpu")
    wf.run()
    path = os.path.join(str(tmp_path), "mnist" + EXT[codec])
    assert wf.snapshotter.destination == path
    current = os.path.join(str(tmp_path), "mnist_current" + EXT[codec])
    assert os.path.islink(current)
    assert os.readlink(current) == os.path.basename(path)
    back = SnapshotterToFile.import_file(current)
    assert back.loader.epoch_number == 0 and back.gd.global_step == 0
    assert back.decision.min_validation_n_err is not None


def test_snapshot_int8_weights(tmp_path):
    """``weights_dtype="int8"`` quantizes the LM's blocks at load."""
    from veles_tpu_torch.samples.lm import LMWorkflow
    from veles_tpu_torch.snapshotter import SnapshotterToFile
    wf = LMWorkflow(dim=32, blocks=1, heads=2, vocab=16, seq=16,
                    synthetic_train=16, synthetic_valid=16,
                    minibatch_size=16, max_epochs=1, dtype="float32",
                    snapshot_time_interval=0.0,
                    snapshotter_config={"directory": str(tmp_path),
                                        "compression": None})
    wf.initialize(device="cpu")
    wf.run()
    path = os.path.join(str(tmp_path), "lm.pickle")
    plain = SnapshotterToFile.import_file(path)
    q = SnapshotterToFile.import_file(path, weights_dtype="int8")
    block, qblock = plain.forwards[1], q.forwards[1]
    assert not block.weights_int8 and qblock.weights_int8
    assert qblock.params["wq"].dtype == torch.int8
    with pytest.raises(ValueError):
        SnapshotterToFile.import_file(path, weights_dtype="fp16")


def test_db_snapshotter_roundtrip(tmp_path):
    """The reference's ``tests/test_weak_fixes.py:20-60`` on the port:
    an sqlite export, the facade's routing, the newest row for a prefix,
    and a bad table name refused."""
    import sqlite3
    from veles_tpu_torch.samples.mnist import MnistWorkflow
    from veles_tpu_torch.snapshotter import Snapshotter, SnapshotterToDB
    dsn = "sqlite:%s" % (tmp_path / "snaps.db")
    wf = MnistWorkflow(synthetic_train=32, synthetic_valid=32,
                       minibatch_size=32, layers=(4, 10), max_epochs=1,
                       dtype="float32",
                       snapshotter_config={"enabled": False})
    wf.initialize(device="cpu")
    snap = SnapshotterToDB(wf, odbc=dsn, prefix="t", interval=1,
                           time_interval=0.0, directory=str(tmp_path))
    snap.initialize()
    snap.export()
    assert isinstance(Snapshotter(wf, odbc=dsn), SnapshotterToDB)
    restored = SnapshotterToDB.import_db(dsn, prefix="t")
    assert restored._restored_from_snapshot_
    _equal_weights(_weights(restored), _weights(wf))
    with pytest.raises(ValueError):
        SnapshotterToDB(None, odbc="sqlite::memory:",
                        table="veles; drop table x")
    odbc = SnapshotterToDB(wf, odbc="DSN=veles", directory=str(tmp_path))
    with pytest.raises(ValueError, match="sqlite"):
        odbc.initialize()
    path = str(tmp_path / "s.db")
    conn = sqlite3.connect(path)
    conn.execute("CREATE TABLE veles (id INTEGER PRIMARY KEY, "
                 "prefix TEXT, ts TIMESTAMP, blob BLOB)")
    for value in ("old", "new"):
        conn.execute("INSERT INTO veles (prefix, ts, blob) VALUES "
                     "(?, CURRENT_TIMESTAMP, ?)",
                     ("p", pickle.dumps({"v": value})))
    conn.commit()
    conn.close()
    assert SnapshotterToDB.import_db("sqlite:" + path, prefix="p")["v"] \
        == "new"


def test_rollback_restores_best_weights(tmp_path):
    """``Rollback`` saves the weights and solver slots at an improvement
    and, ``fail_iterations`` epochs later without one, restores them and
    scales the learning rate by ``lr_plus``."""
    from veles_tpu_torch.models.decision import Rollback
    from veles_tpu_torch.samples.mnist import MnistWorkflow
    wf = MnistWorkflow(synthetic_train=64, synthetic_valid=32,
                       minibatch_size=32, layers=(8, 10), max_epochs=3,
                       dtype="float32", learning_rate=0.01,
                       snapshotter_config={"enabled": False})
    rb = Rollback(wf, fail_iterations=1, lr_plus=0.5)
    rb.decision, rb.trainer = wf.decision, wf.gd
    wf.initialize(device="cpu")
    wf.decision.improved <<= True
    rb.run()                                 # an improvement: save
    best = _weights(wf)
    slots = {k: {s: t.clone() for s, t in v.items()}
             for k, v in wf.gd.opt_state.items()}
    wf.run()
    assert not all(torch.equal(a[n], b[n]) for a, b in zip(
        _weights(wf), best) for n in a)
    rb.restore()
    _equal_weights(_weights(wf), best)
    for k, v in slots.items():
        for s, t in v.items():
            assert torch.equal(wf.gd.opt_state[k][s], t)
    assert wf.gd.lr_multiplier == 0.5


def test_gather_results_and_metric_values(tmp_path):
    jwf, pwf, _, _ = _run_pair("mnist", tmp_path)
    got, want = pwf.gather_results(), jwf.gather_results()
    assert sorted(got) == sorted(want)
    for k in want:
        _close(got[k], want[k])


def test_feature_off_values():
    """Each waits for the item named: plotters (11: none built).
    Meshes (item 10's in-process half) reach the trainer; augmentation,
    prefetch, the glyphs stand-in and the BPE text path (item 9) are on
    since the input-pipeline slice."""
    from veles_tpu_torch.loader.fullbatch import FullBatchLoader
    from veles_tpu_torch.samples.mnist import MnistWorkflow
    assert MnistWorkflow(mesh={"dp": 2}).gd.mesh == {"dp": 2}
    aug = {"kind": "image", "shape": (28, 28, 1)}
    assert MnistWorkflow(augment=aug).gd.augment == aug
    assert FullBatchLoader(None, prefetch=2).prefetch == 2
    assert MnistWorkflow(synthetic_kind="glyphs").loader.synthetic_kind \
        == "glyphs"
    from veles_tpu_torch.samples.lm import LMWorkflow
    with pytest.raises(FileNotFoundError):
        LMWorkflow(text_path="no-such-corpus.txt")
    wf = MnistWorkflow(plotters=True)
    assert wf.plotters == []
