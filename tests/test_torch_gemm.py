"""GEMMs of the PyTorch port (``veles_tpu_torch/ops/gemm.py``) held
against the JAX package on the CPU: the int8 weight quantization
bit-equal, the int8 GEMM's plain version against ``pallas_matmul`` with
the fused ``col_scale`` epilogue (interpret mode) at tile-multiple
shapes and against ``int8_matmul`` at ragged ones, and the policy
matmul.  The tolerance is 1e-5: the sums run in another order.  The
kernel itself is held against this plain version on the card in
``test_torch_kernels.py``."""

import numpy
import pytest
import torch

import jax.numpy as jnp

from veles_tpu.config import root

pytestmark = pytest.mark.torch_port

TOL = dict(rtol=1e-5, atol=1e-5)


def _weights(rng, k, n):
    w = (rng.standard_normal((k, n)) * 0.3).astype(numpy.float32)
    w[:, 1] = 0.0                    # an all-zero column → scale 0
    return w


def test_int8_weight_quantize_bit_equal():
    from veles_tpu.ops import gemm as jgemm
    from veles_tpu_torch.ops import gemm as tgemm
    w = _weights(numpy.random.default_rng(0), 64, 48)
    jq, js = jgemm.int8_weight_quantize(jnp.asarray(w))
    tq, ts = tgemm.int8_weight_quantize(torch.as_tensor(w))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    numpy.testing.assert_array_equal(tq.numpy(), numpy.asarray(jq))
    numpy.testing.assert_array_equal(ts.numpy(), numpy.asarray(js))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n", [(1, 32, 64), (4, 64, 128),
                                   (8, 1024, 512)])
def test_int8_matmul_matches_pallas_epilogue(m, k, n, dtype):
    from veles_tpu.ops import gemm as jgemm
    from veles_tpu_torch.ops import gemm as tgemm
    rng = numpy.random.default_rng(m * k + n)
    a = rng.standard_normal((m, k)).astype(numpy.float32)
    jq, js = jgemm.int8_weight_quantize(jnp.asarray(_weights(rng, k, n)))
    ja = jnp.asarray(a).astype(dtype)
    want = jgemm.pallas_matmul(ja, jq, col_scale=js, interpret=True)
    ta = torch.as_tensor(a).to(getattr(torch, dtype))
    got = tgemm.int8_matmul(ta, torch.as_tensor(numpy.array(jq)),
                            torch.as_tensor(numpy.array(js)))
    assert got.dtype == torch.float32 and got.shape == (m, n)
    numpy.testing.assert_allclose(got.numpy(), numpy.asarray(want), **TOL)


@pytest.mark.parametrize("m,k,n", [(3, 40, 300), (5, 600, 17)])
def test_int8_matmul_ragged_matches_jax(m, k, n):
    """Shapes that do not tile: the JAX package takes an XLA dot with
    the same deferred dequant, the port the same function."""
    from veles_tpu.ops import gemm as jgemm
    from veles_tpu_torch.ops import gemm as tgemm
    rng = numpy.random.default_rng(m + k + n)
    a = rng.standard_normal((m, k)).astype(numpy.float32)
    jq, js = jgemm.int8_weight_quantize(jnp.asarray(_weights(rng, k, n)))
    want = jgemm.int8_matmul(jnp.asarray(a), jq, js)
    got = tgemm.int8_matmul(torch.as_tensor(a),
                            torch.as_tensor(numpy.array(jq)),
                            torch.as_tensor(numpy.array(js)))
    numpy.testing.assert_allclose(got.numpy(), numpy.asarray(want), **TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_matmul_plain_at_verify_width(dtype):
    """m = 40, the width of a speculative verify step (B rows x (spec_k
    + 1) tokens), against the JAX ``int8_matmul`` at a decode shape."""
    from veles_tpu.ops import gemm as jgemm
    from veles_tpu_torch.ops import gemm as tgemm
    rng = numpy.random.default_rng(40)
    a = rng.standard_normal((40, 256)).astype(numpy.float32)
    jq, js = jgemm.int8_weight_quantize(jnp.asarray(_weights(rng, 256, 384)))
    want = jgemm.int8_matmul(jnp.asarray(a).astype(dtype), jq, js)
    got = tgemm.int8_matmul_plain(
        torch.as_tensor(a).to(getattr(torch, dtype)),
        torch.as_tensor(numpy.array(jq)), torch.as_tensor(numpy.array(js)))
    assert got.dtype == torch.float32 and got.shape == (40, 384)
    numpy.testing.assert_allclose(got.numpy(), numpy.asarray(want,
                                                             numpy.float32),
                                  **TOL)


def test_policy_matmul_matches_jax():
    from veles_tpu.ops import gemm as jgemm
    from veles_tpu_torch.ops import gemm as tgemm
    rng = numpy.random.default_rng(5)
    a = rng.standard_normal((6, 48)).astype(numpy.float32)
    b = rng.standard_normal((48, 20)).astype(numpy.float32)
    saved = root.common.precision.get("compute_dtype", "bfloat16")
    root.common.precision.compute_dtype = "float32"
    try:
        want = jgemm.matmul(jnp.asarray(a), jnp.asarray(b))
    finally:
        root.common.precision.compute_dtype = saved
    got = tgemm.matmul(torch.as_tensor(a), torch.as_tensor(b),
                       torch.float32)
    numpy.testing.assert_allclose(got.numpy(), numpy.asarray(want), **TOL)

