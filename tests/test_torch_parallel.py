"""Meshes, sharding conventions, collectives and the mesh trainer of the
PyTorch port (``veles_tpu_torch/parallel/``, ``models/gd_mesh.py``) held
against the JAX package on the CPU.

The JAX side runs on the suite's 8 virtual CPU devices; the port on 8
positions that share the CPU (``parallel.mesh.set_positions_per_device``).

- Mesh and specs: ``MeshConfig.resolve``, the axis order, ``batch_spec``
  and ``param_spec`` equal to JAX's (their divisibility errors raised
  by both), per-position shard shapes, and per-position bytes dropping
  by the sharding factor.
- Collectives: sum, max, gather, reduce-scatter and ppermute equal the
  plain numpy result; two runs are bit-equal.
- The trainer: the MLP over ``dp``, ``dp×tp`` and ``dp×fsdp×tp`` and
  the MoE over ``dp×ep`` take 5 minibatches from the JAX loader on
  both sides; the LM chain takes a validation span and a 3-step train
  span over ``dp``.  Parameters agree with the JAX mesh trainer's and
  with the port's unsharded trainer's within 2e-5 (f32 compute), and
  the port's state is sharded by ``param_spec``.
"""

import contextlib
import math

import jax
import numpy
import pytest
import torch

from veles_tpu.config import root

pytestmark = pytest.mark.torch_port

TOL = 2e-5


@pytest.fixture
def f32():
    saved = root.common.precision.get("compute_dtype", "bfloat16")
    root.common.precision.compute_dtype = "float32"
    yield
    root.common.precision.compute_dtype = saved


@pytest.fixture
def positions():
    from veles_tpu_torch.parallel.mesh import set_positions_per_device
    old = set_positions_per_device(8)
    yield
    set_positions_per_device(old)


@contextlib.contextmanager
def jax_streams():
    """The JAX package's generators a test draws from, restored after
    it, so the tests after it on the worker draw what they would."""
    from veles_tpu import prng
    with contextlib.ExitStack() as stack:
        for name in ("default", "dist", "loader", "trainer"):
            stack.enter_context(prng.get(name).preserve_state())
        yield


def _jax_mesh(axes):
    from veles_tpu.parallel import build_mesh
    return build_mesh(dict(axes),
                      devices=jax.devices()[:math.prod(axes.values())])


def _port_mesh(axes):
    from veles_tpu_torch.parallel import build_mesh
    return build_mesh(dict(axes),
                      devices=["cpu"] * math.prod(axes.values()))


def _norm(spec):
    """A spec as a tuple, one-axis tuples as the axis name (JAX's
    ``PartitionSpec`` compares so)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if torch.is_tensor(got) else got
    numpy.testing.assert_allclose(numpy.asarray(got, numpy.float64),
                                  numpy.asarray(want, numpy.float64),
                                  rtol=tol, atol=tol)


# -- meshes and specs -----------------------------------------------------------

@pytest.mark.parametrize("axes,n", [({"dp": -1, "tp": 2}, 8),
                                    ({"tp": 2, "dp": 2, "pp": 2}, 8),
                                    ({"sp": 4, "ep": 2}, 8),
                                    ({"dp": 3}, 8), ({"dp": -1, "tp": -1}, 8)])
def test_mesh_config_resolve(axes, n):
    from veles_tpu.parallel.mesh import MeshConfig as JaxConfig
    from veles_tpu_torch.parallel import MeshConfig
    try:
        want = JaxConfig(dict(axes)).resolve(n)
    except ValueError:
        with pytest.raises(ValueError):
            MeshConfig(dict(axes)).resolve(n)
        return
    got = MeshConfig(dict(axes)).resolve(n)
    assert got == want and list(got) == list(want)


def test_build_mesh_and_positions(positions):
    from veles_tpu_torch.parallel import (
        build_mesh, positions_per_device, single_device_mesh)
    mesh = build_mesh({"dp": 2, "tp": 4}, device="cpu")
    assert positions_per_device() == 8
    assert mesh.shape == {"dp": 2, "tp": 4} and mesh.size == 8
    assert mesh.coords(5) == {"dp": 1, "tp": 1}
    assert mesh.position(dp=1, tp=1) == 5
    assert mesh.along(5, "tp") == [4, 5, 6, 7]
    assert mesh.along(5, "dp") == [1, 5]
    assert single_device_mesh(device="cpu").shape == {"dp": 1}
    with pytest.raises(ValueError):
        build_mesh({"dp": 3}, device="cpu")


MESHES = [{"dp": 4, "tp": 2}, {"dp": 8}, {"dp": 2, "fsdp": 2, "tp": 2},
          {"dp": 2, "ep": 4}, {"dp": 2, "sp": 4}, {"pp": 2, "dp": 4}]


@pytest.mark.parametrize("axes", MESHES)
def test_specs_match_reference(axes):
    from veles_tpu.parallel import sharding as jsh
    from veles_tpu_torch.parallel import sharding as psh
    jm, pm = _jax_mesh(axes), _port_mesh(axes)
    for name, shape in [("weights", (16, 8)), ("weights", (16, 7)),
                        ("bias", (8,)), ("expert_w1", (4, 8, 16)),
                        ("expert_b1", (4, 16)), ("expert_w1", (3, 8, 16)),
                        ("wq", (32, 32)), ("gate", (8, 4))]:
        assert _norm(psh.param_spec(pm, name, shape)) == _norm(
            jsh.param_spec(jm, name, shape)), (name, shape)
    for ndim, dim0, seq in [(2, 64, None), (2, 64, 16), (3, 8, None),
                            (1, 16, None)]:
        assert _norm(psh.batch_spec(pm, ndim, dim0, seq)) == _norm(
            jsh.batch_spec(jm, ndim, dim0, seq))


@pytest.mark.parametrize("axes,args", [({"dp": 8}, (2, 100, None)),
                                       ({"dp": 2, "fsdp": 2}, (2, 6, None)),
                                       ({"dp": 2, "sp": 4}, (2, 8, 6))])
def test_batch_spec_divisibility_errors(axes, args):
    from veles_tpu.parallel.sharding import batch_spec as jax_spec
    from veles_tpu_torch.parallel.sharding import batch_spec
    with pytest.raises(ValueError, match="divisible") as want:
        jax_spec(_jax_mesh(axes), *args)
    with pytest.raises(ValueError, match="divisible") as got:
        batch_spec(_port_mesh(axes), *args)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("axes", MESHES)
def test_shards_match_reference_placement(axes):
    """Each position's slice is the slice JAX's sharding puts on the
    device at the same mesh coordinates; gathering restores the whole;
    per-position bytes drop by the spec's factor."""
    from jax.sharding import NamedSharding
    from veles_tpu.parallel import sharding as jsh
    from veles_tpu_torch.parallel import sharding as psh
    jm, pm = _jax_mesh(axes), _port_mesh(axes)
    rng = numpy.random.default_rng(0)
    for name, shape in [("weights", (16, 8)), ("expert_w1", (4, 8, 16)),
                        ("bias", (8,))]:
        a = rng.standard_normal(shape).astype(numpy.float32)
        spec = psh.param_spec(pm, name, shape)
        shards = psh.put(torch.as_tensor(a), pm, spec)
        arr = jax.device_put(a, NamedSharding(jm, jsh.param_spec(
            jm, name, shape)))
        by_dev = {s.device: numpy.asarray(s.data)
                  for s in arr.addressable_shards}
        flat = list(jm.devices.flat)
        for p in range(pm.size):
            assert numpy.array_equal(shards[p].numpy(), by_dev[flat[p]])
        assert numpy.array_equal(
            psh.gather(pm, shards, spec, shape, "cpu").numpy(), a)
        factor = math.prod(pm.shape[x] for e in spec if e
                           for x in ((e,) if isinstance(e, str) else e))
        assert max(t.numel() * t.element_size() for t in shards) \
            == a.nbytes // factor


# -- collectives ------------------------------------------------------------------

def test_collectives_match_numpy_and_repeat():
    from veles_tpu_torch.parallel import collectives as col
    rng = numpy.random.default_rng(1)
    arrs = [rng.standard_normal((4, 6)).astype(numpy.float32)
            for _ in range(5)]
    xs = [torch.as_tensor(a) for a in arrs]

    def run():
        return (col.psum(xs), col.pmax(xs), col.all_gather(xs, dim=0),
                col.reduce_scatter([torch.as_tensor(numpy.tile(a, (5, 1)))
                                    for a in arrs], dim=0),
                col.ppermute(xs, [(0, 1), (1, 2), (2, 0)]),
                col.ring_shift(xs))

    first, second = run(), run()
    total = arrs[0].copy()
    for a in arrs[1:]:
        total = total + a
    for got in first[0]:
        assert numpy.array_equal(got.numpy(), total)
    for got in first[1]:
        assert numpy.array_equal(got.numpy(), numpy.max(arrs, axis=0))
    for got in first[2]:
        assert numpy.array_equal(got.numpy(), numpy.concatenate(arrs))
    tiled = numpy.tile(total, (5, 1))
    for i, got in enumerate(first[3]):
        numpy.testing.assert_allclose(got.numpy(), tiled[4 * i:4 * i + 4],
                                      rtol=1e-6, atol=1e-6)
    perm = first[4]
    assert numpy.array_equal(perm[1].numpy(), arrs[0])
    assert numpy.array_equal(perm[0].numpy(), arrs[2])
    assert not perm[3].any() and not perm[4].any()
    assert numpy.array_equal(first[5][0].numpy(), arrs[4])
    for a, b in zip(first, second):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    # explicit slices and receivers: the [4, 6] tensor in 2×2 blocks
    index = [(slice(r, r + 2), slice(c, c + 3))
             for r in (0, 2) for c in (0, 3)]
    whole = col.all_gather([xs[0][i] for i in index], index=index,
                           shape=(4, 6), to=["cpu"] * 3)
    assert len(whole) == 3 and all(numpy.array_equal(w.numpy(), arrs[0])
                                   for w in whole)
    parts = col.reduce_scatter(xs, index=index + index[:1],
                               to=["cpu"] * 5)
    for i, got in zip(index + index[:1], parts):
        assert numpy.array_equal(got.numpy(), total[i])
    assert parts[4] is parts[0]


# -- the trainer ------------------------------------------------------------------

def _jax_mlp(axes, loader_cls, build, steps=5):
    """The JAX trainer on its loader, per minibatch; returns the
    minibatches it took and its final parameters."""
    from veles_tpu import prng
    with jax_streams():
        prng.get("dist").seed(99)
        prng.get("default").seed(7)
        return _jax_mlp_steps(axes, loader_cls, build, steps)


def _jax_mlp_steps(axes, loader_cls, build, steps):
    from veles_tpu.accelerated_units import AcceleratedWorkflow
    from veles_tpu.backends import Device
    wf = AcceleratedWorkflow(None, name="torch-dist")
    loader = loader_cls(wf, minibatch_size=64, prng_key="dist")
    loader.span_serving = False
    batches = []
    try:
        layers, gd = build(Device(backend="numpy"), wf, loader,
                           None if axes is None else _jax_mesh(axes))
        init = [{n: numpy.array(a.map_read().mem)
                 for n, a in u.param_arrays().items()} for u in layers]
        for _ in range(steps):
            loader.run()
            batches.append((numpy.array(loader.minibatch_data.map_read().mem),
                            numpy.array(loader.minibatch_labels.map_read().mem),
                            int(loader.minibatch_size),
                            int(loader.minibatch_class)))
            gd.run()
        final = [{n: numpy.array(a.map_read().mem)
                  for n, a in u.param_arrays().items()} for u in layers]
    finally:
        loader.stop()
    return batches, init, final


def _build_jax_mlp(device, wf, loader, mesh):
    from veles_tpu.models.standard import build_mlp_classifier
    _, layers, _, gd = build_mlp_classifier(
        device, loader, hidden=(16,), classes=4, workflow=wf, mesh=mesh,
        learning_rate=0.1, gradient_moment=0.9)
    return layers, gd


def _build_jax_moe(device, wf, loader, mesh):
    from veles_tpu.models import EvaluatorSoftmax, GradientDescent
    from veles_tpu.models.all2all import All2AllSoftmax
    from veles_tpu.models.moe import MoE
    loader.initialize(device=device)
    moe = MoE(wf, n_experts=4, top_k=2, hidden=16, name="moe0")
    moe.input = loader.minibatch_data
    moe.initialize(device=device)
    head = All2AllSoftmax(wf, output_sample_shape=(4,), name="head")
    head.input = moe.output
    head.initialize(device=device)
    ev = EvaluatorSoftmax(wf, compute_confusion_matrix=False)
    ev.output = head.output
    ev.labels = loader.minibatch_labels
    ev.loader = loader
    ev.initialize(device=device)
    gd = GradientDescent(wf, forwards=[moe, head], evaluator=ev,
                         loader=loader, learning_rate=0.1, mesh=mesh)
    gd.initialize(device=device)
    return [moe, head], gd


def _port_run(spec, init, batches, mesh, **gd_kwargs):
    from veles_tpu_torch.convert import params_from_numpy, params_to_numpy
    from veles_tpu_torch.models.evaluator import EvaluatorSoftmax
    from veles_tpu_torch.models.gd import GradientDescent
    chain = params_from_numpy(spec, dict(enumerate(init)), device="cpu",
                              dtype="float32")
    gd = GradientDescent(chain, EvaluatorSoftmax(), mesh=mesh, **gd_kwargs)
    for x, labels, size, cls in batches:
        gd.run_minibatch(torch.as_tensor(x), torch.as_tensor(labels), size,
                         cls)
    return gd, params_to_numpy(chain)


MLP = [{"type": "all2all_tanh", "output_sample_shape": (16,)},
       {"type": "softmax", "output_sample_shape": (4,)}]
MOE = [{"type": "moe", "n_experts": 4, "top_k": 2, "hidden": 16},
       {"type": "softmax", "output_sample_shape": (4,)}]


@pytest.mark.parametrize("case,axes", [
    ("mlp", {"dp": 8}), ("mlp", {"dp": 4, "tp": 2}),
    ("mlp", {"dp": 2, "fsdp": 2, "tp": 2}), ("moe", {"dp": 2, "ep": 4})])
def test_mesh_trainer_matches_reference(f32, positions, case, axes):
    from tests.test_models import BlobsLoader
    from veles_tpu_torch.parallel.sharding import param_spec, shard_slices
    build, spec, kw = (_build_jax_mlp, MLP, dict(
        learning_rate=0.1, gradient_moment=0.9)) if case == "mlp" \
        else (_build_jax_moe, MOE, dict(learning_rate=0.1))
    batches, init, want = _jax_mlp(axes, BlobsLoader, build)
    mesh = _port_mesh(axes)
    gd, got = _port_run(spec, init, batches, mesh, **kw)
    _, plain = _port_run(spec, init, batches, None, **kw)
    assert gd.global_step == sum(b[3] == 2 for b in batches) > 2
    for i, layer in enumerate(want):
        for n, w in layer.items():
            _close(got[i][n], w)
            _close(got[i][n], plain[i][n])
    # the state is sharded by param_spec: each position holds its slice
    plan = gd.plan_
    for (i, n), shards in plan.shards.items():
        shape = plan.shapes[(i, n)]
        spec_ = param_spec(mesh, n, shape)
        for p, t in enumerate(shards):
            want_shape = tuple(s.stop - s.start for s in shard_slices(
                mesh, spec_, shape, p))
            assert tuple(t.shape) == want_shape
            assert tuple(plan.slots[(i, n)]["v"][p].shape) == want_shape \
                if "v" in plan.slots[(i, n)] else True
    whole = sum(a.nbytes for layer in want for a in layer.values())
    held = max(plan.position_bytes())      # parameters and their slots
    if "tp" in axes or "ep" in axes:
        assert held < 2 * whole
    else:
        assert held == 2 * whole


def test_span_run_on_dp_mesh_matches_reference(f32, positions):
    """The LM chain (``bench_lm``'s at test width) takes a validation
    span then a 3-step train span over ``{"dp": 2}``: loss, n_err,
    the epoch accumulator, the health vector and the parameters agree
    with the JAX mesh trainer's."""
    from tests.test_torch_training import (
        _compare, _jax_span, _jax_trainer, _port_trainer, _tokens)
    from tests.test_torch_transformer import jax_params
    kw = dict(solver="sgd", learning_rate=0.01, gradient_moment=0.9)
    tokens = _tokens()
    with jax_streams():
        jl, jfw, jgd, healths = _jax_trainer(
            tokens, 11, mesh=_jax_mesh({"dp": 2}), **kw)
        pl, pchain, pgd = _port_trainer(tokens, jax_params(jfw), 11,
                                        mesh=_port_mesh({"dp": 2}), **kw)
        for _ in range(2):
            _jax_span(jl, jgd)
            pl.serve_span()
            _, _, health = pgd.run_span(pl)
    assert pgd.global_step == 3
    _compare(jgd, jfw, healths, pgd, pchain, health)


def test_build_mlp_classifier_on_a_mesh(f32, positions):
    """``build_mlp_classifier(mesh=)`` builds the workflow's trainer on
    the mesh; its steps equal the unsharded classifier's."""
    from veles_tpu_torch.convert import params_to_numpy
    from veles_tpu_torch.loader import FullBatchLoader
    from veles_tpu_torch.models.standard import build_mlp_classifier
    rng = numpy.random.default_rng(2)
    data = rng.standard_normal((96, 8)).astype(numpy.float32)
    labels = rng.integers(0, 4, 96)
    runs = []
    for mesh in (None, {"dp": 4, "tp": 2}):
        loader = FullBatchLoader(data, labels, [0, 0, 96],
                                 minibatch_size=32, seed=1, device="cpu")
        _, layers, _, gd = build_mlp_classifier(
            "cpu", loader, hidden=(16,), classes=4, mesh=mesh,
            dtype="float32", learning_rate=0.1)
        assert (gd.mesh is None) == (mesh is None)
        try:
            for _ in range(3):
                loader.run()
                gd.run()
        finally:
            loader.stop()
        assert gd.global_step >= 3
        runs.append(params_to_numpy(layers))
    for i in runs[0]:
        for n in runs[0][i]:
            _close(runs[1][i][n], runs[0][i][n])


@pytest.mark.parametrize("axes", [{"fsdp": 4}, {"dp": 2, "tp": 2}])
def test_eval_after_train_reads_the_updated_parameters(positions, axes):
    """A validation step, two train steps, a validation step: the second
    validation loss equals the unsharded trainer's.  (A unit's cached
    casts are keyed by its parameters' versions, which each step's
    freshly gathered leaves restart; the mesh trainer drops them at
    every install, or the second validation would read the first one's
    weights.)"""
    from veles_tpu_torch.convert import params_from_numpy
    from veles_tpu_torch.models.evaluator import EvaluatorSoftmax
    from veles_tpu_torch.models.gd import GradientDescent
    rng = numpy.random.default_rng(5)
    init = {0: {"weights": rng.standard_normal((8, 16)).astype(
        numpy.float32), "bias": rng.standard_normal(16).astype(
            numpy.float32)},
            1: {"weights": rng.standard_normal((16, 4)).astype(
                numpy.float32), "bias": rng.standard_normal(4).astype(
                    numpy.float32)}}
    batches = [(rng.standard_normal((32, 8)).astype(numpy.float32),
                rng.integers(0, 4, 32), 32, cls) for cls in (1, 2, 2, 1)]
    losses = []
    for mesh in (None, _port_mesh(axes)):
        chain = params_from_numpy(MLP, init, device="cpu", dtype="float32")
        gd = GradientDescent(chain, EvaluatorSoftmax(), mesh=mesh,
                             learning_rate=0.5)
        losses.append([float(gd.run_minibatch(
            torch.as_tensor(x), torch.as_tensor(y), s, c)[0])
            for x, y, s, c in batches])
    assert losses[0][0] != losses[0][3]
    numpy.testing.assert_allclose(losses[1], losses[0], rtol=TOL, atol=TOL)


@pytest.mark.parametrize("axes", [{"fsdp": 4}, {"dp": 2, "tp": 2},
                                  {"fsdp": 2, "tp": 2}])
def test_per_unit_gather_holds_one_unit(positions, axes):
    """Under fsdp and tp a group gathers a unit's parameters only while
    the unit runs (and again in the backward, where autograd reads
    them): the most gathered bytes alive at once, counted at every
    gather, are the largest unit's, and no group's gradient part waits
    for another's.  The step is bit-equal to the whole-step gather (a
    gather is an exact copy, the slices' gradients fold in group order)
    and within phase 15's 1e-5 of the unsharded trainer."""
    from veles_tpu_torch.convert import (
        init_params, params_from_numpy, params_to_numpy)
    from veles_tpu_torch.loader import TRAIN, VALID
    from veles_tpu_torch.models.evaluator import EvaluatorNextToken
    from veles_tpu_torch.models.gd import GradientDescent
    from veles_tpu_torch.samples.lm import lm_spec
    spec = lm_spec(64, 32, 2, 2)
    params = params_to_numpy(init_params(spec, 0, window=16, device="cpu",
                                         dtype="float32"))
    toks = numpy.random.default_rng(0).integers(0, 64, (16, 16))

    def run(mesh, per_unit=True):
        chain = params_from_numpy(spec, params, device="cpu",
                                  dtype="float32")
        shape = (16,)
        for u in chain:
            u.in_shape = shape
            shape = tuple(u.out_shape(shape))
        gd = GradientDescent(chain, EvaluatorNextToken(), solver="sgd",
                             learning_rate=0.1, gradient_moment=0.9,
                             mesh=mesh)
        if mesh is not None:
            assert gd.plan_.unit_gather
            gd.plan_.unit_gather = per_unit
        losses = []
        for k, cls in enumerate((TRAIN, TRAIN, VALID, TRAIN)):
            x = torch.as_tensor(toks[4 * k:4 * k + 4])
            losses.append(float(gd.run_minibatch(x, x, 4, cls)[0]))
        return gd, losses, params_to_numpy(chain)

    plain, want, ref = run(None)
    gd, losses, got = run(_port_mesh(axes))
    _, whole_losses, whole = run(_port_mesh(axes), per_unit=False)
    plan = gd.plan_
    unit = max(sum(math.prod(plan.shapes[k]) * 4   # f32
                   for k in plan.sharded if k[0] == i)
               for i in range(len(spec)))
    assert plan.gather_peak_bytes == unit
    assert plan.grad_wait_peak_bytes == 0
    assert losses == whole_losses
    for i in ref:
        for n in ref[i]:
            assert numpy.array_equal(got[i][n], whole[i][n])
            numpy.testing.assert_allclose(got[i][n], ref[i][n], rtol=1e-5,
                                          atol=1e-5)
    numpy.testing.assert_allclose(losses, want, rtol=1e-5, atol=1e-5)
