"""Pipeline (``pp``) and sequence (``sp``) parallelism of the PyTorch
port — ``parallel/pipeline.py``, the ring in ``ops/attention.py``, the
trainer's pp plan and sp hand-off, mesh snapshots — held against the
JAX package on the CPU (its 8 virtual devices; the port's 8 positions
share the CPU).

- Ring attention: ``ring_attention_sharded`` forward (plain, causal,
  a value dim unlike the key dim) and gradients against the JAX
  function at 1e-5; the attention unit's ring against its dense core.
- GPipe: ``split_stages``, ``pipeline_forward`` over ``pp`` and
  ``pp×dp`` against JAX's, forward and parameter gradients at 1e-5,
  and the microbatch refusal.
- The trainer: the LM trunk (``test_pp_trainer``'s ``_build_lm``) over
  ``{"pp": 2}``, ``{"pp": 2, "dp": 2}`` and ``{"pp": 4, "dp": 2}`` takes
  3 minibatches of the JAX loader on both sides; the transformer sample
  over ``{"dp": 2, "sp": 4}`` and, with a MoE trunk, ``{"dp": 2, "sp":
  2, "ep": 2}`` takes 3 minibatches.  Losses and parameters agree with
  the JAX mesh trainer's within 2e-5 (f32 compute); the pp plan's
  refusals are the reference's.
- Snapshots: a mesh workflow pickles its mesh as the axis spec and
  resumes on a rebuilt mesh, in the port's form and from a JAX
  snapshot.
"""

import contextlib
import pickle

import jax
import jax.numpy as jnp
import numpy
import pytest
import torch

from veles_tpu.config import root

from tests.test_torch_parallel import _jax_mesh, _port_mesh, jax_streams

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


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if torch.is_tensor(got) else got
    numpy.testing.assert_allclose(numpy.asarray(got, numpy.float64),
                                  numpy.asarray(want, numpy.float64),
                                  rtol=tol, atol=tol)


# -- ring attention -------------------------------------------------------------

@pytest.mark.parametrize("seq,causal,dv", [(32, False, 8), (16, True, 8),
                                           (32, True, 6)])
def test_ring_attention_matches_reference(seq, causal, dv):
    from veles_tpu.ops.attention import ring_attention_sharded as jring
    from veles_tpu_torch.ops.attention import (
        attention, ring_attention_sharded)
    rng = numpy.random.default_rng(7)
    q, k = (rng.normal(size=(seq, 2, 8)).astype(numpy.float32)
            for _ in range(2))
    v = rng.normal(size=(seq, 2, dv)).astype(numpy.float32)
    want = jring(_jax_mesh({"sp": 4}), jnp.asarray(q), jnp.asarray(k),
                 jnp.asarray(v), causal=causal)
    got = ring_attention_sharded(_port_mesh({"sp": 4}), torch.as_tensor(q),
                                 torch.as_tensor(k), torch.as_tensor(v),
                                 causal=causal)
    assert tuple(got.shape) == (seq, 2, dv)
    _close(got, want, 1e-5)
    if dv == 8:
        _close(got, attention(torch.as_tensor(q), torch.as_tensor(k),
                              torch.as_tensor(v), causal=causal), 1e-5)


@pytest.mark.parametrize("sp", [4])
def test_ring_attention_gradients_match_reference(sp):
    from veles_tpu.ops.attention import ring_attention_sharded as jring
    from veles_tpu_torch.ops.attention import ring_attention_sharded
    rng = numpy.random.default_rng(3)
    arrs = [rng.normal(size=(16, 2, 8)).astype(numpy.float32)
            for _ in range(3)]
    jm = _jax_mesh({"sp": sp})

    def jloss(q, k, v):
        return jnp.sum(jnp.sin(jring(jm, q, k, v, causal=True)))

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in arrs))
    ts = [torch.as_tensor(a).requires_grad_(True) for a in arrs]
    torch.sin(ring_attention_sharded(_port_mesh({"sp": sp}), *ts,
                                     causal=True)).sum().backward()
    for t, w in zip(ts, want):
        _close(t.grad, w, 1e-5)


def test_mha_unit_ring_matches_dense(f32):
    """The attention unit's ring core (a trainer's sp hand-off) computes
    what its dense core does, forward and weight gradients."""
    from veles_tpu_torch.models.attention import MultiHeadAttention
    rng = numpy.random.default_rng(4)
    x = torch.as_tensor(rng.normal(size=(2, 16, 8)).astype(numpy.float32))
    u = MultiHeadAttention(heads=2, causal=True, device="cpu",
                           dtype="float32")
    u.load_params(u.fill_arrays(rng, (16, 8), None))
    for t in u.params.values():
        t.requires_grad_(True)
    dense = u.apply(x)
    gd = torch.autograd.grad(dense.sum(), list(u.params.values()))
    u.sp_mesh_ = _port_mesh({"sp": 4})
    ring = u.apply(x)
    gr = torch.autograd.grad(ring.sum(), list(u.params.values()))
    _close(ring, dense.detach(), 1e-5)
    for a, b in zip(gr, gd):
        _close(a, b, 1e-5)


# -- GPipe ------------------------------------------------------------------------

def test_split_stages_matches_reference():
    from veles_tpu.parallel.pipeline import split_stages as jsplit
    from veles_tpu_torch.parallel.pipeline import split_stages
    for n, s in [(8, 4), (10, 4), (3, 3), (7, 2)]:
        assert split_stages(n, s) == jsplit(n, s)
    from veles_tpu.parallel.pipeline import stack_stage_params as jstack
    from veles_tpu_torch.parallel.pipeline import stack_stage_params
    per = [{"w": numpy.full((2, 3), s, numpy.float32),
            "b": {"v": numpy.arange(3, dtype=numpy.float32) + s}}
           for s in range(4)]
    got = stack_stage_params([{"w": torch.as_tensor(p["w"]), "b": {
        "v": torch.as_tensor(p["b"]["v"])}} for p in per])
    want = jstack([{"w": jnp.asarray(p["w"]), "b": {
        "v": jnp.asarray(p["b"]["v"])}} for p in per])
    assert numpy.array_equal(got["w"].numpy(), numpy.asarray(want["w"]))
    assert numpy.array_equal(got["b"]["v"].numpy(),
                             numpy.asarray(want["b"]["v"]))
    for fn in (split_stages, jsplit):
        with pytest.raises(ValueError):
            fn(2, 3)


@pytest.mark.parametrize("axes,batch_axes", [({"pp": 4}, None),
                                             ({"pp": 4, "dp": 2}, ("dp",))])
def test_gpipe_matches_reference(axes, batch_axes):
    """Forward and parameter gradients of a 4-stage tanh MLP through the
    pipeline equal JAX's pipeline and the stages applied in order."""
    from veles_tpu.parallel.pipeline import pipeline_forward as jpipe
    from veles_tpu_torch.parallel.pipeline import pipeline_forward
    rng = numpy.random.default_rng(0)
    ws = [rng.normal(size=(6, 6)).astype(numpy.float32) * 0.5
          for _ in range(4)]
    bs = [rng.normal(size=(6,)).astype(numpy.float32) * 0.1
          for _ in range(4)]
    x = rng.normal(size=(8, 6)).astype(numpy.float32)
    jm = _jax_mesh(axes)

    def jloss(params):
        out = jpipe(jm, lambda p, h: jnp.tanh(h @ p["w"] + p["b"]),
                    params, jnp.asarray(x), n_micro=2,
                    batch_axes=batch_axes)
        return jnp.sum(out ** 2), out

    jparams = [{"w": jnp.asarray(w), "b": jnp.asarray(b)}
               for w, b in zip(ws, bs)]
    (_, jout), jgrads = jax.value_and_grad(jloss, has_aux=True)(jparams)
    params = [{"w": torch.as_tensor(w).requires_grad_(True),
               "b": torch.as_tensor(b).requires_grad_(True)}
              for w, b in zip(ws, bs)]
    out = pipeline_forward(_port_mesh(axes),
                           lambda p, h: torch.tanh(h @ p["w"] + p["b"]),
                           params, torch.as_tensor(x), n_micro=2,
                           batch_axes=batch_axes)
    _close(out, jout, 1e-5)
    ref = torch.as_tensor(x)
    for p in params:
        ref = torch.tanh(ref @ p["w"] + p["b"])
    _close(out, ref.detach(), 1e-5)
    (out ** 2).sum().backward()
    for p, g in zip(params, jgrads):
        _close(p["w"].grad, g["w"], 1e-5)
        _close(p["b"].grad, g["b"], 1e-5)
    with pytest.raises(ValueError, match="microbatches"):
        pipeline_forward(_port_mesh(axes), lambda p, h: h, [{}] * 4,
                         torch.zeros(6, 2), n_micro=4)


# -- the trainer --------------------------------------------------------------------

def _jax_lm_run(axes, steps=3):
    """``test_pp_trainer._build_lm`` on ``axes`` (None: unsharded) for
    ``steps`` minibatches; returns the minibatches, the first and the
    final parameters and the losses."""
    from tests.test_pp_trainer import _build_lm
    from tests.test_torch_transformer import jax_params
    with jax_streams():
        loader, gd, fw = _build_lm(None if axes is None
                                   else _jax_mesh(axes))
        return _jax_lm_steps(loader, gd, fw, steps)


def _jax_lm_steps(loader, gd, fw, steps):
    from tests.test_torch_transformer import jax_params
    batches, losses = [], []
    try:
        init = jax_params(fw)
        for _ in range(steps):
            loader.run()
            batches.append((
                numpy.array(loader.minibatch_data.map_read().mem),
                numpy.array(loader.minibatch_labels.map_read().mem),
                int(loader.minibatch_size), int(loader.minibatch_class)))
            gd.run()
            losses.append(float(gd.loss.map_read().mem))
        final = jax_params(fw)
    finally:
        loader.stop()
    return batches, init, final, losses


def _lm_spec(blocks=4, dim=16, heads=2, experts=0, top_k=2):
    spec = [{"type": "embedding", "vocab": 11, "dim": dim}]
    spec += [{"type": "transformer_block", "heads": heads, "causal": True,
              "n_experts": experts, "top_k": top_k}
             for _ in range(blocks)]
    return spec + [{"type": "mean_pool_seq"},
                   {"type": "softmax", "output_sample_shape": (11,)}]


def _port_lm_run(spec, init, batches, mesh, **kw):
    from veles_tpu_torch.convert import params_from_numpy, params_to_numpy
    from veles_tpu_torch.models.evaluator import EvaluatorSoftmax
    from veles_tpu_torch.models.gd import GradientDescent
    chain = params_from_numpy(spec, init, device="cpu", dtype="float32")
    shape = (batches[0][0].shape[1],)
    for u in chain:
        u.in_shape = shape
        shape = tuple(u.out_shape(shape))
    gd = GradientDescent(chain, EvaluatorSoftmax(), mesh=mesh, **kw)
    losses = []
    for x, labels, size, cls in batches:
        loss, _, _ = gd.run_minibatch(torch.as_tensor(x),
                                      torch.as_tensor(labels), size, cls)
        losses.append(float(loss))
    return gd, params_to_numpy(chain), losses


@pytest.mark.parametrize("axes", [{"pp": 2}, {"pp": 2, "dp": 2},
                                  {"pp": 4, "dp": 2}])
def test_pp_trainer_matches_reference(f32, positions, axes):
    batches, init, want, jlosses = _jax_lm_run(axes)
    kw = dict(solver="sgd", learning_rate=0.05, gradient_moment=0.9)
    gd, got, losses = _port_lm_run(_lm_spec(), init, batches,
                                   _port_mesh(axes), **kw)
    assert gd.plan_.pp["stages"] == axes["pp"]
    assert (gd.plan_.pp["start"], gd.plan_.pp["end"]) == (1, 5)
    _, plain, plosses = _port_lm_run(_lm_spec(), init, batches, None, **kw)
    _close(losses, jlosses)
    _close(losses, plosses)
    for i in want:
        for n in want[i]:
            _close(got[i][n], want[i][n])
            _close(got[i][n], plain[i][n])


def test_pp_plan_refusals(positions):
    from veles_tpu_torch.convert import init_params
    from veles_tpu_torch.models.evaluator import EvaluatorSoftmax
    from veles_tpu_torch.models.gd import GradientDescent

    def build(axes, blocks=4, **kw):
        chain = init_params(_lm_spec(blocks), 0, window=8, device="cpu",
                            dtype="float32")
        return GradientDescent(chain, EvaluatorSoftmax(),
                               mesh=_port_mesh(axes), **kw)

    with pytest.raises(ValueError, match="stage-divisible"):
        build({"pp": 3})
    with pytest.raises(ValueError, match="composes with dp"):
        build({"pp": 2, "tp": 2})
    gd = build({"pp": 2}, pp_microbatches=5)
    with pytest.raises(ValueError, match="microbatch"):
        gd.run_minibatch(torch.zeros((16, 8), dtype=torch.int64),
                         torch.zeros(16, dtype=torch.int64), 16, 2)


@contextlib.contextmanager
def transformer_config(**cfg):
    """``root.transformer_tpu`` (the JAX sample's keys) set to ``cfg``,
    then put back as it was: keys it lacked removed, the others
    restored."""
    node = root.transformer_tpu

    def keys():
        return [k for k in vars(node)
                if not (k.startswith("_") and k.endswith("_"))]

    before = {k: vars(node)[k] for k in keys()}
    try:
        node.update(cfg)
        yield
    finally:
        for k in keys():
            if k not in before:
                delattr(node, k)
        for k, v in before.items():
            object.__setattr__(node, k, v)


def _jax_sample_run(mesh, steps=3, **cfg):
    """The JAX transformer sample (``test_pp_sp``'s configuration) for
    ``steps`` minibatches; returns the minibatches, first and final
    parameters and the losses."""
    from veles_tpu.backends import Device
    from veles_tpu.loader.base import TRAIN
    from veles_tpu.samples.transformer import TransformerWorkflow
    from tests.test_torch_transformer import jax_params
    batches, losses = [], []
    with transformer_config(**dict({
            "mesh": mesh, "seq": 16, "dim": 16, "heads": 2, "blocks": 1,
            "causal": True, "minibatch_size": 16, "synthetic_train": 64,
            "synthetic_valid": 16, "max_epochs": 1, "solver": "sgd",
            "learning_rate": 0.05, "snapshot_time_interval": 1e9}, **cfg)), \
            jax_streams():
        wf = TransformerWorkflow(None, plotters=False)
        wf.initialize(device=Device(backend="numpy"))
        loader, gd = wf.loader, wf.gd
        loader.span_serving = False
        init = jax_params(wf.forwards)
        try:
            while len(batches) < steps:
                loader.run()
                if loader.minibatch_class != TRAIN:
                    continue
                batches.append((
                    numpy.array(loader.minibatch_data.map_read().mem),
                    numpy.array(loader.minibatch_labels.map_read().mem),
                    int(loader.minibatch_size),
                    int(loader.minibatch_class)))
                gd.run()
                losses.append(float(gd.loss.map_read().mem))
        finally:
            loader.stop()
        final = jax_params(wf.forwards)
    return batches, init, final, losses


@pytest.mark.parametrize("axes,experts,top_k", [
    ({"dp": 2, "sp": 4}, 0, 2), ({"dp": 2, "sp": 2, "ep": 2}, 2, 1)])
def test_transformer_sample_sp_matches_reference(f32, positions, axes,
                                                 experts, top_k):
    batches, init, want, jlosses = _jax_sample_run(
        axes, n_experts=experts, top_k=top_k)
    spec = _lm_spec(blocks=1, experts=experts, top_k=top_k)
    spec[-1]["output_sample_shape"] = (16,)
    spec[0]["vocab"] = 16
    gd, got, losses = _port_lm_run(spec, init, batches, _port_mesh(axes),
                                   solver="sgd", learning_rate=0.05,
                                   gradient_moment=0.9)
    assert gd.forwards[1].sp_mesh_ is gd.mesh
    _close(losses, jlosses)
    for i in want:
        for n in want[i]:
            _close(got[i][n], want[i][n])
    if experts:
        shards = gd.plan_.shards[(1, "expert_w1")]
        assert {tuple(t.shape)[0] for t in shards} == {experts // 2}


# -- snapshots ------------------------------------------------------------------------

def _port_sample(**kw):
    from veles_tpu_torch.samples.transformer import TransformerWorkflow
    return TransformerWorkflow(
        mesh={"dp": 2, "sp": 4}, seq=16, dim=16, heads=2, blocks=1,
        causal=True, minibatch_size=16, synthetic_train=64,
        synthetic_valid=16, max_epochs=1,
        snapshotter_config={"enabled": False}, dtype="float32", **kw)


def test_mesh_workflow_snapshot_resume(f32, positions):
    """A mesh workflow pickles its mesh as the axis spec (re-pickling an
    unresumed restore keeps the spec), resumes on a rebuilt mesh with
    the sp hand-off re-established, and its resumed state equals the
    state it pickled."""
    from veles_tpu_torch.convert import params_to_numpy
    wf = _port_sample()
    wf.initialize(device="cpu")
    wf.run()
    wf.stop()
    before = params_to_numpy(wf.forwards)
    slots = {k: {s: t.clone() for s, t in v.items()}
             for k, v in wf.gd.state_tensors()[1].items()}
    blob = pickle.dumps(wf)
    wf2 = pickle.loads(blob)
    assert wf2.gd.mesh == {"__mesh_axes__": {"dp": 2, "sp": 4}}
    wf2 = pickle.loads(pickle.dumps(wf2))
    assert wf2.gd.mesh == {"__mesh_axes__": {"dp": 2, "sp": 4}}
    wf2.initialize(device="cpu")
    assert wf2.gd.mesh.shape == {"dp": 2, "sp": 4}
    assert wf2.forwards[1].sp_mesh_ is wf2.gd.mesh
    after = params_to_numpy(wf2.forwards)
    for i in before:
        for n in before[i]:
            assert numpy.array_equal(after[i][n], before[i][n])
    for k, v in wf2.gd.state_tensors()[1].items():
        for s, t in v.items():
            assert torch.equal(t, slots[k][s])
    wf2.decision.complete <<= False
    wf2.decision.max_epochs = 2
    wf2.run()
    wf2.stop()
    assert numpy.isfinite(float(wf2.gd.loss)) and float(wf2.gd.loss) != 0


def test_jax_mesh_snapshot_resumes_on_port_mesh(f32, positions, tmp_path):
    """A JAX transformer workflow trained on ``{"dp": 2, "sp": 4}`` and
    snapshotted resumes in the port on its own mesh of that spec, with
    the JAX state: parameters and solver slots."""
    from veles_tpu.backends import Device
    from veles_tpu.samples.transformer import TransformerWorkflow as JaxWF
    from veles_tpu_torch.snapshotter import SnapshotterToFile
    from tests.test_torch_transformer import jax_params
    with transformer_config(
            mesh={"dp": 2, "sp": 4}, seq=16, dim=16, heads=2, blocks=1,
            causal=True, minibatch_size=16, synthetic_train=64,
            synthetic_valid=16, max_epochs=1,
            snapshot_time_interval=1e9), jax_streams():
        jwf = JaxWF(None, plotters=False)
        jwf.initialize(device=Device(backend="numpy"))
        try:
            jwf.run()
        finally:
            jwf.loader.stop()
        path = str(tmp_path / "jax_mesh.pickle")
        with open(path, "wb") as f:
            pickle.dump(jwf, f)
        want = jax_params(jwf.forwards)
        wslots = {(i, n): {s: numpy.array(a.map_read().mem)
                           for s, a in slots.items()}
                  for i, layer in jwf.gd.opt_state.items()
                  for n, slots in layer.items()}
    wf = SnapshotterToFile.import_file(path)
    assert wf.gd.mesh == {"__mesh_axes__": {"dp": 2, "sp": 4}}
    wf.initialize(device="cpu")
    assert wf.gd.mesh.shape == {"dp": 2, "sp": 4}
    from veles_tpu_torch.convert import params_to_numpy
    got = params_to_numpy(wf.forwards)
    for i in want:
        for n in want[i]:
            assert numpy.array_equal(got[i][n], want[i][n])
    slots = wf.gd.state_tensors()[1]
    for k, v in wslots.items():
        for s, a in v.items():
            assert numpy.array_equal(slots[k][s].numpy(), a)
