"""Cross-channel LRN of the PyTorch port (kernel 4's plain versions and
the autograd Function around them) held against the JAX package on the
CPU, on the same numpy-seeded inputs.

- ``ops.lrn.lrn`` and ``lrn_bwd_plain`` against ``veles_tpu.ops.lrn.
  lrn_pallas``, whose kernel pair runs in interpret mode here: three
  shapes (96 and 256 channels as AlexNet has them, and 7), windows
  n ∈ {3, 4, 5} (4: the backward's transposed window is the forward
  window's mirror image), β ∈ {0.5, 0.75}.  alpha 0.05 on inputs of
  scale 2 makes the window sum half the denominator, so a window off by
  one channel shows.  Float32: forward 1e-5, gradient 1e-4 (sums in
  another order).
- ``LRNormalizerForward`` against the JAX unit (shifted adds off the
  TPU) at AlexNet's parameters and at the strong ones.
- One bfloat16 case: both sides round at the same points, so they agree
  to one bf16 step.
- ``ops.lrn.plan``, the card kernels' dispatch, from shapes and
  alignments alone: the row kernels for AlexNet's shapes and C 8 and
  264, the tile kernels for C 7, a window past ``ROWS_MAX_N`` and a
  pointer off 16 bytes (an offset view of a buffer).
"""

import jax
import jax.numpy as jnp
import numpy
import pytest
import torch

pytestmark = pytest.mark.torch_port

FWD, GRAD = 1e-5, 1e-4
SHAPES = [(8, 5, 5, 96), (4, 3, 3, 256), (3, 11, 7)]
STRONG = dict(alpha=0.05, k=1.5)


def _inputs(shape, seed, scale=2.0):
    rng = numpy.random.default_rng(seed)
    x = (rng.standard_normal(shape) * scale).astype(numpy.float32)
    g = rng.standard_normal(shape).astype(numpy.float32)
    return x, g


def _close(got, want, tol):
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    numpy.testing.assert_allclose(numpy.asarray(got, numpy.float64),
                                  numpy.asarray(want, numpy.float64),
                                  rtol=tol, atol=tol)


def _port_lrn(x, g, dtype=torch.float32, **kw):
    """(y, dx) of the port's Function for cotangent ``g``."""
    from veles_tpu_torch.ops.lrn import lrn
    xt = torch.tensor(x).to(dtype).requires_grad_(True)
    y = lrn(xt, **kw)
    y.backward(torch.as_tensor(g).to(dtype))
    return y, xt.grad


@pytest.mark.parametrize("beta", [0.5, 0.75])
@pytest.mark.parametrize("n", [3, 4, 5])
@pytest.mark.parametrize("shape", SHAPES)
def test_lrn_matches_lrn_pallas(shape, n, beta):
    from veles_tpu.ops.lrn import lrn_pallas
    from veles_tpu_torch.ops.lrn import lrn_bwd_plain
    kw = dict(STRONG, beta=beta, n=n)
    x, g = _inputs(shape, 10 * n + int(4 * beta))
    want_y, vjp = jax.vjp(lambda v: lrn_pallas(v, backend="cpu", **kw),
                          jnp.asarray(x))
    (want_dx,) = vjp(jnp.asarray(g))
    y, dx = _port_lrn(x, g, **kw)
    _close(y, want_y, FWD)
    _close(dx, want_dx, GRAD)
    _close(lrn_bwd_plain(torch.as_tensor(x), torch.as_tensor(g), **kw),
           want_dx, GRAD)


@pytest.mark.parametrize("params", [{}, dict(STRONG, n=4, beta=0.5)],
                         ids=["alexnet", "strong-even"])
def test_unit_matches_jax_unit(params):
    from veles_tpu.accelerated_units import AcceleratedWorkflow
    from veles_tpu.models.lrn import LRNormalizerForward as JaxLRN
    from veles_tpu_torch.models.lrn import LRNormalizerForward
    x, g = _inputs((4, 6, 6, 96), 5)
    ju = JaxLRN(AcceleratedWorkflow(None, name="t"), **params)
    want_y, vjp = jax.vjp(lambda v: ju.apply({}, v), jnp.asarray(x))
    (want_dx,) = vjp(jnp.asarray(g))
    pu = LRNormalizerForward(device="cpu", dtype="float32", **params)
    xt = torch.tensor(x, requires_grad=True)
    y = pu.apply(xt)
    y.backward(torch.as_tensor(g))
    _close(y, want_y, FWD)
    _close(xt.grad, want_dx, GRAD)


def test_bfloat16_within_one_step():
    """bf16 in and out: forward and gradient within one bf16 step
    (2**-7 of the value) of ``lrn_pallas`` in bf16."""
    from veles_tpu.ops.lrn import lrn_pallas
    kw = dict(STRONG, beta=0.75, n=5)
    x, g = _inputs((2, 9, 9, 96), 3)
    xb = jnp.asarray(x, jnp.bfloat16)
    want_y, vjp = jax.vjp(lambda v: lrn_pallas(v, backend="cpu", **kw), xb)
    (want_dx,) = vjp(jnp.asarray(g, jnp.bfloat16))
    y, dx = _port_lrn(numpy.array(xb.astype(jnp.float32)),
                      numpy.array(jnp.asarray(g, jnp.bfloat16)
                                  .astype(jnp.float32)),
                      dtype=torch.bfloat16, **kw)
    assert y.dtype == dx.dtype == torch.bfloat16
    for got, want in ((y, want_y), (dx, want_dx)):
        got = got.detach().float().numpy()
        want = numpy.asarray(want.astype(jnp.float32))
        assert (numpy.abs(got - want)
                <= 2.0 ** -7 * numpy.abs(want) + 1e-30).all()


#: (shape, n, dtype, pointer alignment, kernel): AlexNet's two LRN
#: layers and the row kernels' edges take the row kernels; 7 channels, a
#: window past ROWS_MAX_N and a pointer off 16 bytes take the tile ones
PLAN_CASES = [((1024, 55, 55, 96), 5, torch.bfloat16, 256, "rows"),
              ((1024, 27, 27, 256), 5, torch.bfloat16, 256, "rows"),
              ((4, 8), 4, torch.float32, 16, "rows"),
              ((3, 11, 264), 17, torch.bfloat16, 16, "rows"),
              ((700, 7), 4, torch.float32, 256, "tile"),
              ((8, 96), 18, torch.bfloat16, 256, "tile"),
              ((8, 96), 5, torch.bfloat16, 2, "tile"),
              ((8, 96), 5, torch.float32, 8, "tile")]


@pytest.mark.parametrize("case", PLAN_CASES, ids=str)
def test_plan_picks_the_kernel(case):
    from veles_tpu_torch.ops.lrn import plan
    shape, n, dtype, align, kernel = case
    got = plan(shape, n, dtype, align)
    assert got["kernel"] == kernel, got
    if kernel == "rows":
        assert got["loads_per_chunk"] == dtype.itemsize // 2


def test_alignment_of_an_offset_view():
    """``flat[1:]`` of a bf16 buffer lies 2 bytes past an aligned
    address: contiguous, but the row kernels cannot take it."""
    from veles_tpu_torch.ops.lrn import alignment, plan
    buf = torch.zeros(8 * 96 + 1, dtype=torch.bfloat16)
    x = buf[1:].view(8, 96)
    assert x.is_contiguous() and alignment(buf) >= 16
    assert alignment(x) == 2
    assert plan(x.shape, 5, x.dtype, alignment(x))["kernel"] == "tile"
    assert plan(x.shape, 5, x.dtype, alignment(buf))["kernel"] == "rows"
