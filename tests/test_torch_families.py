"""The layer types and model families the PyTorch port adds beside the
LM and AlexNet, held against the JAX package on the CPU on the same
weights and inputs (oracles: ``tests/test_model_families.py`` and
``tests/test_conv_s2d.py``):

- ``SimpleRNN``, ``LSTM``, ``LastTimestep`` and ``MeanPoolSeq``: forward
  and parameter gradients against ``jax.grad``;
- ``Deconv`` (``lax.conv_transpose``, kernel not flipped) at strides 1
  and 2 (and 3 × 2), "same", "valid" and explicit padding, odd and even
  kernels, non-square inputs, with its bias and activation, and its
  gradients; ``Depooling``;
- ``space_to_depth`` and ``validate_space_to_depth``; ``Conv
  (space_to_depth)`` equal to the JAX unit and to the strided stem,
  blocked and flat, and its gradient on the logical weights;
- ``vgg_a_layers`` and ``alexnet_layers(space_to_depth=4)``: the JAX
  sample's specs, building its shapes;
- ``EvaluatorMSE`` and a conv autoencoder (conv → max_pooling →
  depooling → deconv) taking a validation span and 3 SGD steps under
  MSE on both trainers;
- Kohonen: ``bmu`` (ties to the first neuron), the ``"kohonen"``
  generator's initial weights and 3 trainer steps;
- the RBM: the ``"rbm"`` generator's initial weights and 3 CD-1 steps
  whose hidden samples are bit-equal to ``jax.random.bernoulli``'s.

Tolerances (float32 throughout, the frameworks sum in other orders):
1e-5 on outputs, losses, weights and Kohonen/RBM parameters; 1e-4 on
gradients (``jax.grad`` against autograd over a time loop or a
convolution); the blocked stem against the strided one 1e-5 (both in
float32 here), its weight gradient 1e-5 of the largest magnitude (each
element sums thousands of terms that cancel).  Generated weights, chosen winners and samples exactly.
JAX units are built under ``prng.get().preserve_state()``."""

import jax
import jax.numpy as jnp
import numpy
import pytest
import torch

from veles_tpu import prng as jax_prng
from veles_tpu.config import root

from tests.test_torch_training import _numpy_device

pytestmark = pytest.mark.torch_port

OUT, GRAD = 1e-5, 1e-4


@pytest.fixture
def f32():
    saved = root.common.precision.get("compute_dtype", "bfloat16")
    root.common.precision.compute_dtype = "float32"
    yield
    root.common.precision.compute_dtype = saved


def _close(got, want, tol):
    got = got.detach().numpy() if torch.is_tensor(got) else got
    numpy.testing.assert_allclose(numpy.asarray(got, numpy.float64),
                                  numpy.asarray(want, numpy.float64),
                                  rtol=tol, atol=tol)


def _jax_units(spec, x):
    """The JAX chain for ``spec`` over an input like ``x``, initialized,
    and its parameters as numpy ({index: {name: array}})."""
    from veles_tpu.accelerated_units import AcceleratedWorkflow
    from veles_tpu.memory import Array
    from veles_tpu.models.standard import make_forwards
    with jax_prng.get().preserve_state():
        units = make_forwards(AcceleratedWorkflow(None, name="t"), Array(x),
                              spec)
        dev = _numpy_device()
        for u in units:
            u.initialize(device=dev)
    params = {i: {n: numpy.array(a.map_read().mem)
                  for n, a in u.param_arrays().items()}
              for i, u in enumerate(units)}
    return units, params


def _jax_forward(units, params, x):
    h = jnp.asarray(x)
    for i, u in enumerate(units):
        h = u.apply({n: jnp.asarray(a) for n, a in params[i].items()}, h)
    return h


def _check_chain(spec, x, edit=None):
    """Forward and parameter gradients of ``spec`` over ``x``: the port
    chain (weights carried over, after ``edit(params)``) against the
    JAX chain and ``jax.grad`` of ``sum(y · g)``."""
    from veles_tpu_torch.convert import params_from_numpy
    units, params = _jax_units(spec, x)
    if edit is not None:
        edit(params)
    want = numpy.asarray(_jax_forward(units, params, x))
    g = numpy.random.default_rng(1).standard_normal(
        want.shape).astype(numpy.float32)

    def f(p):
        return jnp.sum(_jax_forward(units, p, x) * g)

    want_g = jax.grad(f)({i: {n: jnp.asarray(a) for n, a in layer.items()}
                          for i, layer in params.items()})
    chain = params_from_numpy(spec, params, device="cpu", dtype="float32")
    for u in chain:
        for t in u.params.values():
            t.requires_grad_(True)
    h = torch.as_tensor(x)
    for u in chain:
        h = u.apply(h)
    assert tuple(h.shape) == want.shape
    _close(h, want, OUT)
    (h * torch.as_tensor(g)).sum().backward()
    for i, u in enumerate(chain):
        for n, t in u.params.items():
            _close(t.grad, want_g[i][n], GRAD)
    return chain


# -- recurrent units and the sequence pools -----------------------------------

@pytest.mark.parametrize("spec", [
    [{"type": "rnn", "hidden": 6}],
    [{"type": "lstm", "hidden": 5}],
    [{"type": "lstm", "hidden": 4, "forget_bias": 0.5},
     {"type": "last_timestep"}],
    [{"type": "rnn", "hidden": 6}, {"type": "mean_pool_seq"}],
    [{"type": "lstm", "hidden": 8}, {"type": "last_timestep"},
     {"type": "softmax", "output_sample_shape": (3,)}]],
    ids=["rnn", "lstm", "lstm_last", "rnn_meanpool", "lstm_classifier"])
def test_recurrent_chains_match_reference(f32, spec):
    x = numpy.random.default_rng(0).standard_normal((3, 7, 4)).astype(
        numpy.float32)
    chain = _check_chain(spec, x)
    out = chain[0].out_shape((7, 4))
    assert out == (7, chain[0].hidden)
    if len(chain) > 1 and not chain[1].params:
        assert chain[1].out_shape(out) == (chain[0].hidden,)


# -- Deconv and Depooling -----------------------------------------------------

@pytest.mark.parametrize("h,w,k,stride,padding", [
    (5, 7, (3, 3), (1, 1), "same"),
    (5, 7, (3, 3), (2, 2), "same"),
    (4, 6, (4, 2), (2, 2), "same"),
    (5, 6, (4, 2), (1, 2), "valid"),
    (6, 5, (5, 3), (2, 3), "valid"),
    (4, 4, (3, 2), (2, 2), ((1, 0), (2, 1)))],
    ids=["s1_same_odd", "s2_same_odd", "s2_same_even", "s12_valid_even",
         "s32_valid_odd", "explicit"])
def test_deconv_matches_reference(f32, h, w, k, stride, padding):
    """``Deconv`` against the JAX unit: ``sliding`` is (sx, sy), ``k``
    is (ky, kx); the bias is random (the JAX fill draws none), the
    activation the sigmoid of the conv autoencoder's decoder."""
    ky, kx = k
    sy, sx = stride
    spec = [{"type": "deconv", "n_kernels": 4, "kx": kx, "ky": ky,
             "sliding": (sx, sy), "padding": padding,
             "activation": "sigmoid"}]
    x = numpy.random.default_rng(2).standard_normal((2, h, w, 3)).astype(
        numpy.float32)

    def bias(params):
        params[0]["bias"] = numpy.linspace(-0.5, 0.5, 4).astype(
            numpy.float32)

    chain = _check_chain(spec, x, bias)
    assert chain[0].out_shape((h, w, 3)) \
        == tuple(chain[0].apply(torch.as_tensor(x)).shape[1:])


def test_deconv_is_not_conv_transpose2d(f32):
    """At stride 2 the unit is not ``F.conv_transpose2d`` (which flips
    the kernel and pads otherwise): they differ."""
    from veles_tpu_torch.models.conv import Deconv
    rng = numpy.random.default_rng(3)
    u = Deconv(n_kernels=2, kx=3, ky=3, sliding=(2, 2), device="cpu",
               dtype="float32")
    u.load_params({"weights": rng.standard_normal((3, 3, 2, 2)).astype(
        numpy.float32), "bias": numpy.zeros(2, numpy.float32)})
    x = torch.as_tensor(rng.standard_normal((1, 4, 4, 2)).astype(
        numpy.float32))
    y = u.apply(x)
    lib = torch.nn.functional.conv_transpose2d(
        x.permute(0, 3, 1, 2), u.params["weights"].permute(3, 2, 0, 1),
        stride=2, padding=1, output_padding=1).permute(0, 2, 3, 1)
    assert y.shape == lib.shape
    assert float((y - lib).abs().max()) > 1e-2


@pytest.mark.parametrize("kx,ky", [(2, 2), (3, 2)])
def test_depooling_matches_reference(kx, ky):
    spec = [{"type": "depooling", "kx": kx, "ky": ky}]
    x = numpy.random.default_rng(4).standard_normal((2, 3, 5, 4)).astype(
        numpy.float32)
    units, params = _jax_units(spec, x)
    want = numpy.asarray(_jax_forward(units, params, x))
    from veles_tpu_torch.models.standard import make_forwards
    (u,) = make_forwards(spec, device="cpu", dtype="float32")
    got = u.apply(torch.as_tensor(x))
    numpy.testing.assert_array_equal(got.numpy(), want)
    assert u.out_shape((3, 5, 4)) == want.shape[1:]


# -- the space-to-depth stem --------------------------------------------------

def test_space_to_depth_matches_reference():
    from veles_tpu.models.conv import space_to_depth as jax_s2d
    from veles_tpu_torch.models.conv import space_to_depth
    for shape, n in (((2, 227, 227, 3), 4), ((1, 9, 7, 2), 2),
                     ((2, 8, 8, 3), 2)):
        x = numpy.random.default_rng(5).standard_normal(shape).astype(
            numpy.float32)
        numpy.testing.assert_array_equal(
            space_to_depth(torch.as_tensor(x), n).numpy(),
            numpy.asarray(jax_s2d(jnp.asarray(x), n)))


@pytest.mark.parametrize("args", [(227, 227, 11, 11, 4), (29, 29, 5, 5, 2),
                                  (21, 21, 3, 3, 3), (227, 227, 11, 11, 3),
                                  (30, 29, 5, 5, 2), (10, 10, 3, 3, 4)])
def test_validate_space_to_depth_matches_reference(args):
    from veles_tpu.models.conv import validate_space_to_depth as jax_valid
    from veles_tpu_torch.models.conv import validate_space_to_depth

    def outcome(fn):
        try:
            fn(*args)
        except ValueError as e:
            return str(e)
        return None

    assert outcome(validate_space_to_depth) == outcome(jax_valid)


@pytest.mark.parametrize("h,k,n,flat", [(227, 11, 4, False),
                                        (227, 11, 4, True),
                                        (29, 5, 2, False), (21, 3, 3, True)])
def test_s2d_conv_matches_reference_and_strided(f32, h, k, n, flat):
    """The blocked stem against the JAX unit on the blocked input, and
    against the port's own strided stem on the plain input; its weight
    gradient (the logical layout) against the strided stem's."""
    from veles_tpu.models.conv import space_to_depth as jax_s2d
    from veles_tpu_torch.convert import params_from_numpy
    rng = numpy.random.default_rng(6)
    x = rng.standard_normal((2, h, h, 3)).astype(numpy.float32)
    xb = numpy.array(jax_s2d(jnp.asarray(x), n))
    hb = xb.shape[1]
    if flat:
        xb = xb.reshape(2, -1)
    conv = {"type": "conv_relu", "n_kernels": 8, "kx": k, "ky": k,
            "sliding": (n, n), "padding": "valid"}
    s2d = dict(conv, space_to_depth=n,
               space_to_depth_hw=(hb, hb) if flat else None)
    units, params = _jax_units([s2d], xb)
    params[0]["bias"] = rng.standard_normal(8).astype(numpy.float32)
    want = numpy.asarray(_jax_forward(units, params, xb))
    (pu,) = params_from_numpy([s2d], params, device="cpu", dtype="float32")
    (ref,) = params_from_numpy([conv], params, device="cpu",
                               dtype="float32")
    assert pu.params["weights"].shape == (k, k, 3, 8)
    for u in (pu, ref):
        u.params["weights"].requires_grad_(True)
    y = pu.apply(torch.as_tensor(xb))
    _close(y, want, OUT)
    assert pu.out_shape(xb.shape[1:]) == want.shape[1:] \
        == ref.out_shape((h, h, 3))
    y_ref = ref.apply(torch.as_tensor(x))
    _close(y.detach(), y_ref.detach(), OUT)
    (y * y).sum().backward()
    (y_ref * y_ref).sum().backward()
    # each gradient element sums ~6,500 terms that largely cancel, so
    # its rounding scales with the terms, not with the element: held
    # to 1e-5 of the largest magnitude
    g, g_ref = pu.params["weights"].grad, ref.params["weights"].grad
    assert float((g - g_ref).abs().max()) \
        <= 1e-5 * float(g_ref.abs().max())


def test_s2d_conv_refuses_what_the_reference_refuses():
    from veles_tpu_torch.models.conv import Conv
    for kw in (dict(sliding=(2, 2)), dict(padding="same"),
               dict(n_groups=2)):
        args = dict(dict(n_kernels=4, kx=3, ky=3, sliding=(4, 4),
                         padding="valid", space_to_depth=4), **kw)
        with pytest.raises(ValueError):
            Conv(device="cpu", **args)
    u = Conv(n_kernels=4, kx=3, ky=3, sliding=(4, 4), padding="valid",
             space_to_depth=4, device="cpu")
    with pytest.raises(ValueError, match="space_to_depth_hw"):
        u.param_shapes((48 * 4,), None)


# -- the ImageNet samples' specs ----------------------------------------------

def test_vgg_a_spec_builds():
    """``vgg_a_layers`` is the JAX sample's spec; the port's chain over
    [64, 64, 3] has the JAX units' output shapes and parameter
    shapes."""
    from veles_tpu.samples.alexnet import vgg_a_layers as jax_vgg
    from veles_tpu_torch.models.standard import make_forwards
    from veles_tpu_torch.samples.alexnet import vgg_a_layers
    spec = vgg_a_layers(classes=10)
    assert spec == jax_vgg(classes=10)
    assert sum(1 for s in spec if s["type"] == "conv_relu") == 8
    x = numpy.zeros((2, 64, 64, 3), numpy.float32)
    units, params = _jax_units(spec, x)
    chain = make_forwards(spec, device="cpu", dtype="float32",
                          in_shape=(64, 64, 3))
    for i, (u, ju) in enumerate(zip(chain, units)):
        assert u.out_shape(u.in_shape) == tuple(ju.output.shape[1:])
        assert {n: tuple(s) for n, s in u.param_shapes(
            u.in_shape, None).items()} == {n: a.shape for n, a in
                                           params[i].items()}
    assert chain[-1].out_shape(chain[-1].in_shape) == (10,)


@pytest.mark.parametrize("s2d,side", [(0, 227), (4, 227), (4, 67)])
def test_alexnet_spec_matches_reference(s2d, side):
    from veles_tpu.samples.alexnet import alexnet_layers as jax_alexnet
    from veles_tpu_torch.samples.alexnet import alexnet_layers
    assert alexnet_layers(space_to_depth=s2d, side=side) \
        == jax_alexnet(space_to_depth=s2d, side=side)


def test_build_alexnet_s2d_and_vgg_a():
    """``build_alexnet(space_to_depth=4)`` feeds the blocked stem the
    flat pre-blocked dataset and starts from the plain stem's weights
    (same seed, same draws): its stem output equals the plain stem's;
    ``model="vgg_a"`` builds VGG-A."""
    from veles_tpu_torch.samples.alexnet import build_alexnet
    kw = dict(minibatch_size=4, side=67, classes=10, n_train=8,
              widths=(8, 16, 24, 24, 16, 32), device="cpu",
              dtype="float32")
    plain = build_alexnet(**kw)
    s2d = build_alexnet(space_to_depth=4, **kw)
    assert s2d.loader.dataset_dev.shape == (8, 17 * 17 * 48)
    for n, t in plain.chain[0].params.items():
        assert torch.equal(t, s2d.chain[0].params[n])
    with torch.no_grad():
        y = plain.chain[0].apply(plain.loader.dataset_dev[:4].float())
        yb = s2d.chain[0].apply(s2d.loader.dataset_dev[:4].float())
    _close(yb, y, OUT)
    vgg = build_alexnet(model="vgg_a", **dict(kw, side=32))
    assert len(vgg.chain) == 18 and vgg.chain[-1].neurons_number == 10
    with pytest.raises(ValueError, match="model"):
        build_alexnet(model="resnet", **kw)
    with pytest.raises(ValueError, match="misaligned"):
        build_alexnet(space_to_depth=4, **dict(kw, side=66))


# -- the MSE evaluator and the conv autoencoder -------------------------------

def test_evaluator_mse_matches_reference():
    from veles_tpu.accelerated_units import AcceleratedWorkflow
    from veles_tpu.models.evaluator import EvaluatorMSE as JaxMSE
    from veles_tpu_torch.models.evaluator import EvaluatorMSE
    rng = numpy.random.default_rng(7)
    y = rng.standard_normal((5, 3, 4)).astype(numpy.float32)
    t = rng.standard_normal((5, 3, 4)).astype(numpy.float32)
    ev = JaxMSE(AcceleratedWorkflow(None, name="t"))
    for size in (5, 3, 0):
        want = float(ev.loss(jnp.asarray(y), jnp.asarray(t), size))
        got = float(EvaluatorMSE().loss(torch.as_tensor(y),
                                        torch.as_tensor(t), size))
        assert got == pytest.approx(want, rel=OUT, abs=OUT)


AE_SPEC = [{"type": "conv_str", "n_kernels": 4, "kx": 3, "ky": 3,
            "padding": "same"},
           {"type": "max_pooling", "kx": 2, "ky": 2},
           {"type": "depooling", "kx": 2, "ky": 2},
           {"type": "deconv", "n_kernels": 2, "kx": 3, "ky": 3,
            "padding": "same", "activation": "sigmoid"}]


def test_conv_autoencoder_trains_as_reference(f32):
    """The conv autoencoder (conv → max_pooling → depooling → deconv, the
    reference's ``mnist_ae`` conv shape) on [8, 8, 2] samples: a
    validation span and 3 SGD-momentum steps under ``EvaluatorMSE`` on
    both trainers, the targets being the inputs: losses, the epoch
    accumulator (``n_err`` 0) and every parameter within 1e-5."""
    from veles_tpu.accelerated_units import AcceleratedWorkflow
    from veles_tpu.loader.fullbatch import FullBatchLoaderMSE
    from veles_tpu.models.evaluator import EvaluatorMSE as JaxMSE
    from veles_tpu.models.gd import GradientDescent as JGD
    from veles_tpu.models.standard import make_forwards as jax_make
    from veles_tpu_torch.convert import params_from_numpy, params_to_numpy
    from veles_tpu_torch.loader import FullBatchLoader
    from veles_tpu_torch.models.evaluator import EvaluatorMSE
    from veles_tpu_torch.models.gd import GradientDescent
    data = numpy.random.default_rng(8).random((16, 8, 8, 2)).astype(
        numpy.float32)
    lengths = [0, 4, 12]

    class AELoader(FullBatchLoaderMSE):
        def load_data(self):
            self.class_lengths[:] = lengths
            self.original_data = data
            self.original_targets = data
            self.original_labels = None

    kw = dict(solver="sgd", learning_rate=0.5, gradient_moment=0.9)
    with jax_prng.get().preserve_state(), \
            jax_prng.get("loader").preserve_state():
        wf = AcceleratedWorkflow(None, name="torch-ae")
        jax_prng.get("loader").seed(9)
        jl = AELoader(wf, minibatch_size=4, normalization_type="none")
        jl.span_serving = True
        dev = _numpy_device()
        jl.initialize(device=dev)
        jfw = jax_make(wf, jl.minibatch_data, AE_SPEC)
        for u in jfw:
            u.initialize(device=dev)
        ev = JaxMSE(wf)
        ev.output = jfw[-1].output
        ev.target = jl.minibatch_targets
        ev.loader = jl
        ev.initialize(device=dev)
        jgd = JGD(wf, forwards=jfw, evaluator=ev, loader=jl, **kw)
        jgd.initialize(device=dev)
    jgd._observe_health = lambda health, force=False: None
    params = {i: {n: numpy.array(a.map_read().mem)
                  for n, a in u.param_arrays().items()}
              for i, u in enumerate(jfw)}
    chain = params_from_numpy(AE_SPEC, params, device="cpu",
                              dtype="float32")
    pl = FullBatchLoader(data, None, lengths, minibatch_size=4, seed=9,
                         device="cpu", targets=data)
    pgd = GradientDescent(chain, EvaluatorMSE(), **kw)
    for _ in range(2):                  # the validation span, then train
        jl.run()
        assert jl.span_fresh_
        jgd.run()
        pl.serve_span()
        pgd.run_span(pl)
        assert float(pgd.loss) == pytest.approx(
            float(jgd.loss.map_read().mem), rel=OUT, abs=OUT)
    assert pgd.global_step == jgd.global_step == 3
    assert int(pgd.n_err) == int(jgd.n_err.map_read().mem) == 0
    _close(pgd.epoch_acc, jgd.epoch_acc.map_read().mem, OUT)
    got = params_to_numpy(chain)
    for i, u in enumerate(jfw):
        for n, a in u.param_arrays().items():
            _close(got[i][n], a.map_read().mem, OUT)
            assert not numpy.array_equal(got[i][n], params[i][n]), (i, n)


# -- Kohonen maps -------------------------------------------------------------

def test_kohonen_bmu_matches_reference():
    from veles_tpu.models.kohonen import KohonenForward as JaxForward
    from veles_tpu_torch.models.kohonen import KohonenForward, bmu
    rng = numpy.random.default_rng(10)
    w = rng.standard_normal((12, 5)).astype(numpy.float32)
    w[7] = w[3]                                   # a planted tie
    x = rng.standard_normal((20, 5)).astype(numpy.float32)
    x[0] = w[3]
    jw, jd = JaxForward.bmu(jnp.asarray(w), jnp.asarray(x))
    tw, td = bmu(torch.as_tensor(w), torch.as_tensor(x))
    numpy.testing.assert_array_equal(tw.numpy(), numpy.asarray(jw))
    assert int(tw[0]) == 3
    _close(td, jd, OUT)
    got = KohonenForward(torch.as_tensor(w)).apply(
        torch.as_tensor(x).reshape(20, 5, 1))
    numpy.testing.assert_array_equal(got.numpy(), numpy.asarray(jw))


def test_kohonen_trainer_matches_reference():
    """The ``"kohonen"`` generator's initial weights, then 3 batch
    updates (the last minibatch ragged) against the JAX trainer's
    step: weights and quantization errors within 1e-5."""
    from veles_tpu.accelerated_units import AcceleratedWorkflow
    from veles_tpu.models.kohonen import KohonenTrainer as JaxTrainer
    from veles_tpu_torch.models.kohonen import KohonenTrainer
    gen = jax_prng.get("kohonen")
    with gen.preserve_state():
        gen.seed(21)
        w0 = numpy.zeros((12, 6), numpy.float32)
        gen.fill(w0, -0.1, 0.1)
    tr = KohonenTrainer(6, shape=(3, 4), sigma_decay=5.0, lr_decay=7.0,
                        seed=21, device="cpu")
    numpy.testing.assert_array_equal(tr.weights.numpy(), w0)
    jt = JaxTrainer(AcceleratedWorkflow(None, name="t"), shape=(3, 4),
                    sigma_decay=5.0, lr_decay=7.0)
    step = jt._build_step()
    rng = numpy.random.default_rng(11)
    jw = jnp.asarray(w0)
    for t, size in enumerate((8, 8, 5)):
        x = rng.random((8, 2, 3)).astype(numpy.float32)
        jw, jq = step(jw, jnp.asarray(x), jnp.int32(size), jnp.float32(t))
        q = tr.step(torch.as_tensor(x), size)
        _close(q, jq, OUT)
        _close(tr.weights, jw, OUT)
    assert tr.time == 3


# -- the RBM ------------------------------------------------------------------

def test_rbm_cd1_matches_reference_bit_equal_samples():
    """The ``"rbm"`` generator's initial weights, then 3 CD-1 steps (the
    last minibatch ragged) against the JAX unit's step: each step's
    hidden samples bit-equal to ``jax.random.bernoulli`` under the key
    ``fold_in(peek_key(step), 0)``, weights, biases and reconstruction
    errors within 1e-5; ``hidden_probs`` and ``reconstruct`` too."""
    from veles_tpu.accelerated_units import AcceleratedWorkflow
    from veles_tpu.models.rbm import BernoulliRBM as JaxRBM
    from veles_tpu_torch.models.rbm import BernoulliRBM
    gen = jax_prng.get("rbm")
    with gen.preserve_state():
        gen.seed(31)
        w0 = numpy.zeros((10, 6), numpy.float32)
        gen.fill_normal(w0, 0.0, 0.01)
        keys = [gen.peek_key(t) for t in range(3)]
    rbm = BernoulliRBM(10, hidden=6, learning_rate=0.5, seed=31,
                       device="cpu")
    numpy.testing.assert_array_equal(rbm.weights.numpy(), w0)
    jr = JaxRBM(AcceleratedWorkflow(None, name="t"), hidden=6,
                learning_rate=0.5)
    step = jr._build_step()
    rng = numpy.random.default_rng(12)
    w, vb, hb = (jnp.asarray(w0), jnp.zeros(10, jnp.float32),
                 jnp.zeros(6, jnp.float32))
    for t, size in enumerate((8, 8, 6)):
        v = (rng.random((8, 10)) < 0.4).astype(numpy.float32)
        mask = (numpy.arange(8) < size).astype(numpy.float32)[:, None]
        h0p = jax.nn.sigmoid(jnp.asarray(v * mask) @ w + hb)
        want_h = numpy.asarray(jax.random.bernoulli(
            jax.random.fold_in(keys[t], 0), h0p)).astype(numpy.float32)
        w, vb, hb, err = step(w, vb, hb, jnp.asarray(v), jnp.int32(size),
                              keys[t])
        got_err = rbm.step(torch.as_tensor(v), size)
        assert len(rbm.samples) == 1
        numpy.testing.assert_array_equal(rbm.samples[0].numpy(), want_h)
        assert 0 < want_h.sum() < want_h.size
        _close(got_err, err, OUT)
        for got, want in ((rbm.weights, w), (rbm.vbias, vb),
                          (rbm.hbias, hb)):
            _close(got, want, OUT)
    assert rbm.global_step == 3
    v = (rng.random((4, 10)) < 0.5).astype(numpy.float32)
    params = {"weights": w, "vbias": vb, "hbias": hb}
    _close(rbm.hidden_probs(torch.as_tensor(v)),
           jr.hidden_probs(jnp.asarray(v), params), OUT)
    _close(rbm.reconstruct(torch.as_tensor(v)),
           jr.reconstruct(jnp.asarray(v), params), OUT)
    fresh = BernoulliRBM(10, hidden=3, device="cpu")
    fresh.load_params({n: numpy.asarray(a) for n, a in params.items()})
    _close(fresh.reconstruct(torch.as_tensor(v)),
           jr.reconstruct(jnp.asarray(v), params), OUT)
