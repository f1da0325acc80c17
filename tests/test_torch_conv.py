"""The conv-net units of the PyTorch port held against the JAX package's
units on the CPU, in float32, on the same numpy-seeded inputs and
parameters:

- ``Conv``/``ConvRELU``/``ConvTanh``: forward and the gradients of the
  input and of every parameter — grouped, strided with sx ≠ sy (znicz's
  ``sliding`` order), int / ``"valid"`` / ``"same"`` padding, stride 2
  with ``"same"`` (XLA pads that one unevenly), and the sample shapes
  the port derives (``out_shape``) against the JAX unit's;
- ``MaxPooling``/``AvgPooling``: forward and input gradient, with
  windows full of ties (a max window's gradient goes to its first
  maximum on both sides);
- ``DropoutForward.apply_train``: the masked outputs equal (f32 and
  bf16), so the masks are equal;
- ``All2All*``/``All2AllSoftmax``: forward, logits and gradients, NHWC
  input flattened in NHWC order.

Tolerance 1e-5 (sums in another order)."""

import jax
import jax.numpy as jnp
import numpy
import pytest
import torch

from veles_tpu.config import root

pytestmark = pytest.mark.torch_port

TOL = 1e-5


@pytest.fixture
def f32():
    saved = root.common.precision.get("compute_dtype", "bfloat16")
    root.common.precision.compute_dtype = "float32"
    yield
    root.common.precision.compute_dtype = saved


def _close(got, want, tol=TOL):
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    numpy.testing.assert_allclose(numpy.asarray(got, numpy.float64),
                                  numpy.asarray(want, numpy.float64),
                                  rtol=tol, atol=tol)


def _units(spec, x):
    """(JAX unit, port unit) for one layer spec over input ``x``."""
    from veles_tpu.accelerated_units import AcceleratedWorkflow
    from veles_tpu.memory import Array
    from veles_tpu.models.standard import make_forwards as jax_make
    from veles_tpu_torch.models.standard import make_forwards
    (ju,) = jax_make(AcceleratedWorkflow(None, name="t"), Array(x), [spec])
    (pu,) = make_forwards([spec], device="cpu", dtype="float32",
                          in_shape=x.shape[1:])
    return ju, pu


def _check_unit(spec, x, seed):
    """Forward and the gradients of the input and of the parameters
    (drawn from ``seed`` at the shapes the port asks for)."""
    ju, pu = _units(spec, x)
    rng = numpy.random.default_rng(seed)
    shapes = pu.param_shapes(pu.in_shape, None)
    params = {n: (rng.standard_normal(s) * 0.3).astype(numpy.float32)
              for n, s in shapes.items()}
    out = ju.output_shape_for(x.shape)
    assert (x.shape[0],) + tuple(pu.out_shape(pu.in_shape)) == tuple(out)
    g = rng.standard_normal(out).astype(numpy.float32)
    jp = {n: jnp.asarray(a) for n, a in params.items()}
    want_y, vjp = jax.vjp(lambda p, v: ju.apply(p, v), jp, jnp.asarray(x))
    want_dp, want_dx = vjp(jnp.asarray(g))
    pu.load_params(params)
    for t in pu.params.values():
        t.requires_grad_(True)
    xt = torch.tensor(x, requires_grad=True)
    y = pu.apply(xt)
    y.backward(torch.as_tensor(g))
    _close(y, want_y)
    _close(xt.grad, want_dx)
    for n, t in pu.params.items():
        _close(t.grad, want_dp[n])


CONV_CASES = {
    "grouped-pad2": ({"type": "conv_relu", "n_kernels": 8, "kx": 5, "ky": 5,
                      "padding": 2, "n_groups": 2}, (2, 9, 9, 6)),
    "strided-valid": ({"type": "conv", "n_kernels": 5, "kx": 3, "ky": 4,
                       "sliding": (2, 3), "padding": "valid"},
                      (2, 13, 11, 3)),
    "stem": ({"type": "conv_relu", "n_kernels": 4, "kx": 11, "ky": 11,
              "sliding": (4, 4), "padding": "valid"}, (2, 35, 35, 3)),
    "same": ({"type": "conv_tanh", "n_kernels": 6, "kx": 3, "ky": 3},
             (2, 7, 8, 4)),
    "same-stride2": ({"type": "conv_relu", "n_kernels": 6, "kx": 4, "ky": 3,
                      "sliding": (2, 2), "padding": "same", "n_groups": 3},
                     (2, 8, 9, 6)),
}


@pytest.mark.parametrize("name", sorted(CONV_CASES))
def test_conv(f32, name):
    spec, shape = CONV_CASES[name]
    x = numpy.random.default_rng(1).standard_normal(shape).astype(
        numpy.float32)
    _check_unit(spec, x, 2)


@pytest.mark.parametrize("kind", ["max_pooling", "avg_pooling"])
@pytest.mark.parametrize("sliding", [(2, 2), (1, 2), None])
def test_pooling_with_ties(f32, kind, sliding):
    """Inputs drawn from {0, 1, 2}: most windows hold several maxima."""
    spec = {"type": kind, "kx": 3, "ky": 2}
    if sliding is not None:
        spec["sliding"] = sliding
    x = numpy.random.default_rng(4).integers(0, 3, (2, 9, 8, 5)).astype(
        numpy.float32)
    _check_unit(spec, x, 5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ratio", [0.5, 0.3])
def test_dropout_masks_equal(ratio, dtype):
    from veles_tpu.accelerated_units import AcceleratedWorkflow
    from veles_tpu.models.dropout import DropoutForward as JaxDropout
    from veles_tpu_torch.models.dropout import DropoutForward
    from veles_tpu_torch.prng import threefry
    x = numpy.random.default_rng(6).standard_normal((16, 40)).astype(
        numpy.float32)
    ju = JaxDropout(AcceleratedWorkflow(None, name="t"), dropout_ratio=ratio)
    pu = DropoutForward(dropout_ratio=ratio, device="cpu", dtype="float32")
    jx = jnp.asarray(x, getattr(jnp, dtype))
    px = torch.as_tensor(x).to(getattr(torch, dtype))
    for seed, count in ((3, 0), (77, 12)):
        jk = jax.random.fold_in(jax.random.key(seed), count)
        pk = threefry.fold_in(threefry.key(seed), count)
        want = numpy.asarray(ju.apply_train({}, jx, jk).astype(jnp.float32))
        got = pu.apply_train(px, pk)
        assert got.dtype == px.dtype
        assert numpy.array_equal(got.float().numpy(), want)
        assert numpy.array_equal(pu.mask(px, pk).numpy(), want != 0)
    assert pu.apply(px) is px


@pytest.mark.parametrize("kind", ["all2all", "all2all_relu", "all2all_tanh",
                                  "all2all_sigmoid", "softmax"])
def test_all2all(f32, kind):
    x = numpy.random.default_rng(7).standard_normal((3, 2, 2, 5)).astype(
        numpy.float32)
    _check_unit({"type": kind, "output_sample_shape": (6,)}, x, 8)


def test_softmax_head_logits(f32):
    """``logits`` (f32, what the trainer's loss takes) and the
    probabilities of ``apply``."""
    x = numpy.random.default_rng(9).standard_normal((4, 3, 3, 2)).astype(
        numpy.float32)
    ju, pu = _units({"type": "softmax", "output_sample_shape": (7,)}, x)
    rng = numpy.random.default_rng(10)
    params = {"weights": rng.standard_normal((18, 7)).astype(numpy.float32),
              "bias": rng.standard_normal(7).astype(numpy.float32)}
    pu.load_params(params)
    jp = {n: jnp.asarray(a) for n, a in params.items()}
    xt = torch.as_tensor(x)
    z = pu.logits(xt)
    assert z.dtype == torch.float32
    _close(z, ju.logits(jp, jnp.asarray(x)))
    _close(pu.apply(xt), ju.apply(jp, jnp.asarray(x)))
