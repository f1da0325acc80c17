"""AlexNet training in the PyTorch port held against the JAX package on
the CPU: a narrow AlexNet-shaped chain (side 67, conv widths
8/16/24/24/16, FC 32, 10 classes, dropout 0.5, float32) wired as
``bench.py``'s ``bench_alexnet`` wires it — ``make_forwards`` over an
``ImagenetLoader``, ``EvaluatorSoftmax``, ``GradientDescent`` with SGD,
momentum 0.9 and weights decay 0.0005 — trained from the same weights,
trainer seed and synthetic minibatches by both packages:

- through the span path (``run_span``: one validation minibatch, then
  three train steps, each with its key folded from the span's);
- through the per-minibatch path (``run_minibatch``, the JAX loader
  serving one minibatch at a time), one validation and three train
  minibatches.

Each train step draws two dropout masks from keys split off the step's
key, so the masks must be bit-equal for the weights to agree.  Losses,
``n_err``, the health vector and the epoch accumulator within 1e-5,
weights within 2e-5 (float32 sums in another order)."""

import numpy
import pytest
import torch

from veles_tpu.config import root

from tests.test_torch_transformer import jax_params

pytestmark = pytest.mark.torch_port

OUT, W = 1e-5, 2e-5
SIDE, CLASSES, WIDTHS, MB = 67, 10, (8, 16, 24, 24, 16, 32), 4
N_TRAIN, N_VALID = 12, 4
TRAINER_SEED = 1234
GD = dict(solver="sgd", learning_rate=0.01, gradient_moment=0.9,
          weights_decay=0.0005)


@pytest.fixture
def jax_alexnet_config():
    """f32 compute and the JAX loader's ``root.alexnet_tpu`` for this
    test, restored afterwards."""
    saved_dtype = root.common.precision.get("compute_dtype", "bfloat16")
    keys = {"synthetic_train": 2048, "synthetic_valid": 256, "side": 227,
            "classes": 1000, "space_to_depth": 0}
    saved = {k: root.alexnet_tpu.get(k, v) for k, v in keys.items()}
    root.common.precision.compute_dtype = "float32"
    root.alexnet_tpu.update({"synthetic_train": N_TRAIN,
                             "synthetic_valid": N_VALID, "side": SIDE,
                             "classes": CLASSES, "space_to_depth": 0})
    yield
    root.common.precision.compute_dtype = saved_dtype
    root.alexnet_tpu.update(saved)


def _close(got, want, tol):
    got = got.detach().numpy() if torch.is_tensor(got) else got
    numpy.testing.assert_allclose(numpy.asarray(got, numpy.float64),
                                  numpy.asarray(want, numpy.float64),
                                  rtol=tol, atol=tol)


def _spec():
    from veles_tpu_torch.samples.alexnet import alexnet_layers
    return alexnet_layers(CLASSES, 0.5, WIDTHS)


def _jax_trainer(spans):
    from veles_tpu import prng
    from veles_tpu.accelerated_units import AcceleratedWorkflow
    from veles_tpu.backends import Device
    from veles_tpu.models.evaluator import EvaluatorSoftmax
    from veles_tpu.models.gd import GradientDescent
    from veles_tpu.models.standard import make_forwards
    from veles_tpu.samples.alexnet import ImagenetLoader
    wf = AcceleratedWorkflow(None, name="torch-alexnet-parity")
    dev = Device(backend="numpy")
    prng.get("loader").seed(7)
    prng.get("trainer").seed(TRAINER_SEED)
    loader = ImagenetLoader(wf, minibatch_size=MB, space_to_depth=0)
    loader.span_serving = spans
    loader.initialize(device=dev)
    forwards = make_forwards(wf, loader.minibatch_data, _spec())
    for u in forwards:
        u.initialize(device=dev)
    ev = EvaluatorSoftmax(wf, compute_confusion_matrix=False)
    ev.output = forwards[-1].output
    ev.labels = loader.minibatch_labels
    ev.loader = loader
    ev.initialize(device=dev)
    gd = GradientDescent(wf, forwards=forwards, evaluator=ev, loader=loader,
                         **GD)
    gd.initialize(device=dev)
    healths = []
    gd._observe_health = lambda health, force=False: healths.append(
        numpy.asarray(health))
    return loader, forwards, gd, healths


def _port_trainer(params):
    from veles_tpu_torch.convert import params_from_numpy
    from veles_tpu_torch.models.evaluator import EvaluatorSoftmax
    from veles_tpu_torch.models.gd import GradientDescent
    from veles_tpu_torch.samples.alexnet import ImagenetLoader
    chain = params_from_numpy(_spec(), params, device="cpu", dtype="float32")
    loader = ImagenetLoader(SIDE, CLASSES, N_TRAIN, N_VALID,
                            minibatch_size=MB, seed=7, device="cpu")
    gd = GradientDescent(chain, EvaluatorSoftmax(), seed=TRAINER_SEED, **GD)
    return loader, chain, gd


def _compare(jgd, jfw, healths, pgd, pchain, health):
    from veles_tpu_torch.convert import params_to_numpy
    _close(pgd.loss, jgd.loss.map_read().mem, OUT)
    assert int(pgd.n_err) == int(jgd.n_err.map_read().mem)
    _close(pgd.epoch_acc, jgd.epoch_acc.map_read().mem, OUT)
    _close(health, healths[-1], OUT)
    got, want = params_to_numpy(pchain), jax_params(jfw)
    for i in want:
        for n in want[i]:
            _close(got[i][n], want[i][n], W)
    assert pgd.global_step == jgd.global_step == 3


def test_trains_through_spans_like_jax(jax_alexnet_config):
    jl, jfw, jgd, healths = _jax_trainer(spans=True)
    pl, pchain, pgd = _port_trainer(jax_params(jfw))
    for _ in range(2):                      # the validation span, then train
        jl.run()
        assert jl.span_fresh_
        jgd.run()
        pl.serve_span()
        assert numpy.array_equal(pl.span_indices_, jl.span_indices_)
        _, _, health = pgd.run_span(pl)
    _compare(jgd, jfw, healths, pgd, pchain, health)


def test_trains_minibatch_by_minibatch_like_jax(jax_alexnet_config):
    jl, jfw, jgd, healths = _jax_trainer(spans=False)
    _, pchain, pgd = _port_trainer(jax_params(jfw))
    for _ in range(1 + N_TRAIN // MB):
        jl.run()
        jgd.run()
        x = torch.as_tensor(numpy.array(
            jl.minibatch_data.map_read().mem, numpy.float32))
        labels = torch.as_tensor(numpy.array(
            jl.minibatch_labels.map_read().mem))
        _, _, health = pgd.run_minibatch(x, labels, jl.minibatch_size,
                                         jl.minibatch_class)
    _compare(jgd, jfw, healths, pgd, pchain, health)
