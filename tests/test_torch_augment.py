"""In-step augmentation of the PyTorch port (``veles_tpu_torch/ops/
augment.py``, ``prng/threefry.randint`` and the trainer's ``augment=``)
held against the JAX package on the CPU (oracle
``tests/test_augment.py``):

- ``threefry.randint`` equals ``jax.random.randint`` bit for bit:
  int32 bounds, array bounds, negative ``minval``, empty and reversed
  ranges, the full int32 range;
- ``image_augment`` equals the JAX augment bit for bit for each of its
  options (flip, reflect pad and crop, cutout, flat minibatches) on
  the same inputs and keys;
- training with augment on: a conv chain with dropout through
  ``StandardWorkflow`` in both packages from the same weights, the
  per-minibatch and the span path, weights and epoch metrics within
  2e-5 (the split key changes dropout's masks, as in the reference),
  and the CIFAR and MNIST samples with their augment.
"""

import jax
import numpy
import pytest
import torch

from tests.test_torch_workflow import (
    _compare_runs, _jax_device, _jax_params, _record_epochs,
    jax_state)

pytestmark = pytest.mark.torch_port

RANDINT_CASES = [
    ((5, 2), 0, 9),
    ((17,), -8, 27),
    ((4,), -2, 8),
    ((3, 3), -2 ** 31, 2 ** 31 - 1),
    ((6,), 5, 5),
    ((6,), 7, 3),
    ((2, 3), 0, 1000003),
    ((64,), -16 // 2, 227),
    ((0,), 0, 4),
]


@pytest.mark.parametrize("shape,lo,hi", RANDINT_CASES)
@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 - 1])
def test_randint_matches_jax(shape, lo, hi, seed):
    from veles_tpu_torch.prng import threefry
    want = numpy.asarray(jax.random.randint(jax.random.key(seed), shape,
                                            lo, hi))
    got = threefry.randint(threefry.key(seed), shape, lo, hi).numpy()
    assert got.dtype == want.dtype == numpy.int32
    numpy.testing.assert_array_equal(got, want)


def test_randint_array_bounds_and_folded_keys():
    from veles_tpu_torch.prng import threefry
    lo = numpy.array([-3, 0, 5, -100], numpy.int32)
    hi = numpy.array([4, 100, 6, -99], numpy.int32)
    for seed in range(4):
        jk = jax.random.fold_in(jax.random.key(seed), 1)
        pk = threefry.fold_in(threefry.key(seed), 1)
        want = numpy.asarray(jax.random.randint(jk, (3, 4), lo, hi))
        got = threefry.randint(pk, (3, 4), torch.tensor(lo),
                               torch.tensor(hi)).numpy()
        numpy.testing.assert_array_equal(got, want)


AUGMENTS = [
    ("flip", dict(flip=True), (8, 9, 7, 3)),
    ("pad", dict(flip=False, pad=2), (6, 9, 7, 3)),
    ("cutout", dict(flip=False, cutout=3), (6, 9, 7, 2)),
    ("cutout_even", dict(flip=False, cutout=4), (6, 8, 8, 1)),
    ("all", dict(flip=True, pad=4, cutout=16), (8, 32, 32, 3)),
    ("flat", dict(flip=True, pad=2, cutout=5, shape=(28, 28, 1)),
     (6, 784)),
]


@pytest.mark.parametrize("name,kw,shape", AUGMENTS,
                         ids=[a[0] for a in AUGMENTS])
def test_image_augment_matches_jax(name, kw, shape):
    from veles_tpu.ops.augment import image_augment as jax_augment
    from veles_tpu_torch.ops.augment import image_augment
    from veles_tpu_torch.prng import threefry
    x = numpy.random.default_rng(3).normal(size=shape).astype(
        numpy.float32)
    for seed in range(4):
        want = numpy.asarray(jax_augment(**kw)(jax.numpy.asarray(x),
                                               jax.random.key(seed)))
        got = image_augment(**kw)(torch.tensor(x), threefry.key(seed))
        assert got.shape == x.shape and got.dtype == torch.float32
        numpy.testing.assert_array_equal(got.numpy(), want)


def test_image_augment_bf16_and_make_augment():
    from veles_tpu.ops.augment import make_augment as jax_make
    from veles_tpu_torch.ops.augment import make_augment
    from veles_tpu_torch.prng import threefry
    x = numpy.random.default_rng(4).normal(size=(4, 8, 8, 3)).astype(
        numpy.float32)
    spec = {"kind": "flip_crop", "pad": 1, "cutout": 2}
    want = numpy.asarray(jax_make(**spec)(
        jax.numpy.asarray(x, jax.numpy.bfloat16), jax.random.key(9)),
        numpy.float32)
    got = make_augment(**spec)(torch.tensor(x).bfloat16(),
                               threefry.key(9))
    assert got.dtype == torch.bfloat16
    numpy.testing.assert_array_equal(got.float().numpy(), want)
    with pytest.raises(ValueError):
        make_augment("nope")


# -- training with augment on --------------------------------------------------

AUG = {"kind": "image", "flip": True, "pad": 2, "cutout": 3}


def _layers():
    return [{"type": "conv_str", "n_kernels": 4, "kx": 3, "ky": 3,
             "padding": 1},
            {"type": "max_pooling", "kx": 2, "ky": 2, "sliding": (2, 2)},
            {"type": "all2all_tanh", "output_sample_shape": (12,)},
            {"type": "dropout", "dropout_ratio": 0.5},
            {"type": "softmax", "output_sample_shape": (3,)}]


def _images(self):
    rng = numpy.random.default_rng(21)
    self.class_lengths[:] = [0, 16, 40]
    self.original_data = rng.random((56, 8, 8, 3)).astype(numpy.float32)
    self.original_labels = rng.integers(0, 3, 56).tolist()


def _jax_workflow(spans):
    from veles_tpu.loader.fullbatch import FullBatchLoader
    from veles_tpu.models.standard import StandardWorkflow
    wf = StandardWorkflow(
        None, loader_factory=type("Imgs", (FullBatchLoader,),
                                  {"load_data": _images}),
        loader_config={"minibatch_size": 16}, layers=_layers(),
        solver="sgd", learning_rate=0.05, gradient_moment=0.9,
        augment=dict(AUG) if AUG else None, decision_config={"max_epochs": 2},
        snapshotter_config={"time_interval": 1e9}, plotters=False)
    wf.loader.span_serving = None if spans else False
    return wf


def _port_workflow(tmp, spans, augment=AUG):
    from veles_tpu_torch.loader.fullbatch import FullBatchLoader
    from veles_tpu_torch.models.standard import StandardWorkflow
    wf = StandardWorkflow(
        loader_factory=type("Imgs", (FullBatchLoader,),
                            {"load_data": _images}),
        loader_config={"minibatch_size": 16}, layers=_layers(),
        solver="sgd", learning_rate=0.05, gradient_moment=0.9,
        augment=dict(augment) if isinstance(augment, dict) else augment,
        decision_config={"max_epochs": 2},
        snapshotter_config={"directory": str(tmp), "time_interval": 1e9},
        dtype="float32")
    wf.loader.span_serving = None if spans else False
    return wf


@pytest.mark.parametrize("spans", [True, False], ids=["span", "minibatch"])
def test_training_with_augment_matches_jax(spans, tmp_path):
    """Two epochs of a conv chain with dropout, augment on, from the
    same weights: every epoch's metrics and the final weights within
    2e-5 of the JAX trainer's (the per-minibatch arm through both
    packages' default prefetch pipelines)."""
    from veles_tpu_torch.convert import load_workflow_params
    with jax_state(tmp=tmp_path / "jax"):
        jwf = _jax_workflow(spans)
        jwf.initialize(device=_jax_device())
        jrows = _record_epochs(jwf.decision)
        params = _jax_params(jwf.forwards)
        jwf.run()
        jwf.stop()
    pwf = _port_workflow(tmp_path / "port", spans)
    pwf.initialize(device="cpu")
    load_workflow_params(pwf, params)
    prows = _record_epochs(pwf.decision)
    pwf.run()
    assert bool(pwf.loader.span_serving) == spans
    assert (pwf.loader.prefetch_ is None) == spans
    pwf.stop()
    _compare_runs(jwf, pwf, jrows, prows)


def test_augment_splits_the_dropout_key(tmp_path):
    """With augment on, the minibatch key is split before the forward:
    an identity augment changes the dropout masks, so the weights end
    elsewhere than without augment."""
    from veles_tpu_torch.convert import params_to_numpy

    def run(augment):
        wf = _port_workflow(tmp_path, True, augment)
        wf.initialize(device="cpu")
        wf.run()
        return params_to_numpy(wf.gd.forwards)

    plain = run(None)
    identity = run(lambda x, key: x)
    assert max(float(numpy.abs(plain[i][n] - identity[i][n]).max())
               for i in plain for n in plain[i]) > 1e-4
    again = run(lambda x, key: x)
    for i in identity:
        for n in identity[i]:
            numpy.testing.assert_array_equal(again[i][n], identity[i][n])


SAMPLE_AUG = {
    "mnist": ("mnist_tpu", dict(
        synthetic_train=96, synthetic_valid=32, minibatch_size=32,
        layers=(24, 10), synthetic_kind="glyphs",
        augment={"kind": "image", "flip": False, "pad": 2, "cutout": 4,
                 "shape": (28, 28, 1)})),
    "cifar": ("cifar_tpu", dict(
        synthetic_train=64, synthetic_valid=32, minibatch_size=32,
        synthetic_kind="scenes", augment={"kind": "image", "pad": 4})),
}


@pytest.mark.parametrize("name", sorted(SAMPLE_AUG))
def test_sample_with_augment_matches_jax(name, tmp_path):
    """The MNIST (glyphs, flat augment) and CIFAR (scenes, pad 4)
    samples for two epochs in both packages from the same weights."""
    from tests.test_torch_workflow import _build_jax, _build_port
    from veles_tpu_torch.convert import load_workflow_params
    ns, keys = SAMPLE_AUG[name]
    jkeys = dict(keys, max_epochs=2, snapshot_time_interval=1e9)
    jkeys.pop("layers", None)
    with jax_state(ns, tmp_path / "jax", **jkeys):
        jwf = _build_jax(name, keys, True)
        jwf.initialize(device=_jax_device())
        jrows = _record_epochs(jwf.decision)
        params = _jax_params(jwf.forwards)
        jwf.run()
    pwf = _build_port(name, keys, True, tmp_path / "port")
    assert pwf.gd.augment == keys["augment"]
    pwf.initialize(device="cpu")
    load_workflow_params(pwf, params)
    prows = _record_epochs(pwf.decision)
    pwf.run()
    _compare_runs(jwf, pwf, jrows, prows)
