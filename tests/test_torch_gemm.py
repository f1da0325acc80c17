"""GEMMs of the PyTorch port (``veles_tpu_torch/ops/gemm.py``) held
against the JAX package on the CPU: the int8 weight quantization
bit-equal, the int8 GEMM's plain version against ``pallas_matmul`` with
the fused ``col_scale`` epilogue (interpret mode) at tile-multiple
shapes and against ``int8_matmul`` at ragged ones, the policy matmul,
and the general ``pallas_matmul`` (f32 and bf16 operands, int8 ``b``
with ``col_scale``, fused and other epilogues, bf16 output, the shapes
it refuses).  The tolerance is 1e-5 (of the largest magnitude for
``pallas_matmul``): the sums run in another order; a bf16 output may
round to the neighbouring bf16 value.  The kernels themselves are held
against these plain versions on the card in ``test_torch_kernels.py``."""

import numpy
import pytest
import torch

import jax
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



#: pallas_matmul cases: (m, k, n, blocks, a dtype, b — True: int8 with
#: col_scale, "scaled": a's type with col_scale, False: a's type —,
#: epilogue, out dtype) — the JAX tests' shapes and blocks (128 x 256 x
#: 128 at 64/64/128; 128^3 at 64 with ReLU; 8 x 64 x 128 at the
#: defaults), bf16 operands, int8 b, a bf16 output, shapes that tile only
#: by min(block, dim) (m 100, k 50) and a callable the kernel does not
#: fuse; then the edges of the card kernel's variants, with blocks that
#: tile them: the wgmma tiles' (m one past / short of 128 rows, n and k 8
#: past / short of 64-wide tiles, one 64-deep k-tile), split_k's (the
#: serving rows 1, 9, 136 at 1024 x 4096, k and n 8 past / short of its
#: steps and columns, one k16 step, n under 64) and the f32 ring's (past
#: / short of its 128- and 32-row tiles, one stage), each with a bf16
#: output under ReLU and col_scale
MM_CASES = [
    (128, 256, 128, (64, 64, 128), "float32", False, None, "float32"),
    (128, 128, 128, (64, 64, 64), "float32", False, "relu", "float32"),
    (8, 64, 128, (256, 256, 512), "float32", False, None, "float32"),
    (64, 128, 96, (32, 32, 64), "bfloat16", False, None, "float32"),
    (16, 256, 64, (256, 256, 512), "bfloat16", True, None, "float32"),
    (32, 96, 48, (256, 256, 512), "float32", True, "relu", "float32"),
    (64, 64, 128, (32, 64, 64), "bfloat16", False, "relu", "bfloat16"),
    (100, 50, 64, (256, 256, 512), "float32", False, None, "float32"),
    (100, 50, 72, (256, 256, 512), "bfloat16", True, "relu", "float32"),
    (24, 40, 32, (256, 256, 512), "float32", False, "tanh", "float32"),
    (24, 40, 32, (256, 256, 512), "bfloat16", False, "tanh", "bfloat16"),
    (129, 136, 264, (129, 264, 136), "bfloat16", False, None, "float32"),
    (127, 120, 248, (127, 248, 120), "bfloat16", False, None, "float32"),
    (256, 64, 512, (256, 256, 512), "bfloat16", False, None, "float32"),
    (384, 256, 512, (128, 256, 256), "bfloat16", "scaled", "relu",
     "bfloat16"),
    (1, 1024, 4096, (256, 256, 512), "bfloat16", False, None, "float32"),
    (9, 1024, 4096, (256, 256, 512), "bfloat16", False, None, "float32"),
    (136, 1024, 4096, (256, 256, 512), "bfloat16", False, None, "float32"),
    (8, 1032, 4104, (8, 4104, 1032), "bfloat16", False, None, "float32"),
    (9, 1016, 4088, (9, 4088, 1016), "bfloat16", False, None, "float32"),
    (8, 16, 4096, (256, 256, 512), "bfloat16", False, None, "float32"),
    (100, 72, 56, (256, 256, 512), "bfloat16", False, None, "float32"),
    (8, 1024, 4096, (256, 256, 512), "bfloat16", "scaled", "relu",
     "bfloat16"),
    (257, 264, 264, (257, 264, 264), "float32", False, None, "float32"),
    (255, 248, 248, (255, 248, 248), "float32", False, None, "float32"),
    (64, 16, 128, (256, 256, 512), "float32", False, None, "float32"),
    (256, 128, 256, (256, 256, 512), "float32", "scaled", "relu",
     "bfloat16"),
]

#: the epilogues by name: (JAX's, the port's)
MM_EPILOGUES = {None: (None, None), "relu": (jax.nn.relu, torch.relu),
                "tanh": (jnp.tanh, torch.tanh)}


def _mm_operands(rng, m, k, n, dtype, int8_b):
    a = rng.standard_normal((m, k)).astype(numpy.float32)
    if int8_b is True:
        b = rng.integers(-127, 128, (k, n)).astype(numpy.int8)
    else:
        b = rng.standard_normal((k, n)).astype(numpy.float32)
    scale = None if int8_b is False else (rng.random(n) * 0.01).astype(
        numpy.float32)
    return a, b, scale


@pytest.mark.parametrize("case", MM_CASES, ids=lambda c: "%dx%dx%d-%s%s-%s-%s"
                         % (c[0], c[1], c[2], c[4],
                            {True: "-int8", "scaled": "-scaled"}.get(c[5],
                                                                     ""),
                            c[6], c[7]))
def test_pallas_matmul_matches_jax(case):
    """The port's ``pallas_matmul`` against JAX's in interpret mode on
    the same operands: within 1e-5 of the largest magnitude, plus for a
    bf16 output one bf16 step of each element (both round an f32 sum
    that differs in its last bits)."""
    from veles_tpu.ops import gemm as jgemm
    from veles_tpu_torch.ops import gemm as tgemm
    m, k, n, (bm, bn, bk), dt, int8_b, ep, out_dt = case
    rng = numpy.random.default_rng(m * 7 + k * 3 + n)
    a, b, scale = _mm_operands(rng, m, k, n, dt, int8_b)
    jep, tep = MM_EPILOGUES[ep]
    want = jgemm.pallas_matmul(
        jnp.asarray(a).astype(dt), jnp.asarray(b).astype(
            numpy.int8 if int8_b is True else dt),
        block_m=bm, block_n=bn, block_k=bk, epilogue=jep,
        out_dtype=getattr(jnp, out_dt), interpret=True,
        col_scale=None if scale is None else jnp.asarray(scale))
    tdt = getattr(torch, dt)
    got = tgemm.pallas_matmul(
        torch.as_tensor(a).to(tdt),
        torch.as_tensor(b) if int8_b is True else torch.as_tensor(b).to(tdt),
        block_m=bm, block_n=bn, block_k=bk, epilogue=tep,
        out_dtype=getattr(torch, out_dt),
        col_scale=None if scale is None else torch.as_tensor(scale))
    assert got.dtype == getattr(torch, out_dt) and got.shape == (m, n)
    want = numpy.asarray(want.astype(jnp.float32))
    got = got.to(torch.float32).numpy()
    step = 2.0 ** -7 if out_dt == "bfloat16" else 0.0
    assert (numpy.abs(got - want) <= step * numpy.abs(want)
            + 1e-5 * numpy.abs(want).max()).all()


@pytest.mark.parametrize("epilogue", ["relu", torch.relu,
                                      torch.nn.functional.relu])
def test_pallas_matmul_relu_spellings(epilogue):
    """Every spelling of the fused ReLU gives JAX's ``jax.nn.relu``."""
    from veles_tpu.ops import gemm as jgemm
    from veles_tpu_torch.ops import gemm as tgemm
    rng = numpy.random.default_rng(3)
    a, b, _ = _mm_operands(rng, 16, 32, 24, "float32", False)
    want = numpy.asarray(jgemm.pallas_matmul(
        jnp.asarray(a), jnp.asarray(b), epilogue=jax.nn.relu,
        interpret=True))
    got = tgemm.pallas_matmul(torch.as_tensor(a), torch.as_tensor(b),
                              epilogue=epilogue).numpy()
    numpy.testing.assert_allclose(got, want, rtol=0,
                                  atol=1e-5 * numpy.abs(want).max())


@pytest.mark.parametrize("m,k,n,blocks", [
    (100, 64, 64, (64, 64, 64)),     # m off its 64-row block
    (64, 96, 64, (64, 64, 64)),      # k off its block
    (64, 64, 80, (64, 64, 64)),      # n off its block
])
def test_pallas_matmul_refuses_what_jax_refuses(m, k, n, blocks):
    from veles_tpu.ops import gemm as jgemm
    from veles_tpu_torch.ops import gemm as tgemm
    rng = numpy.random.default_rng(9)
    a, b, _ = _mm_operands(rng, m, k, n, "float32", False)
    bm, bn, bk = blocks
    with pytest.raises(AssertionError, match="tile evenly"):
        jgemm.pallas_matmul(jnp.asarray(a), jnp.asarray(b), block_m=bm,
                            block_n=bn, block_k=bk, interpret=True)
    with pytest.raises(ValueError, match="tile evenly"):
        tgemm.pallas_matmul(torch.as_tensor(a), torch.as_tensor(b),
                            block_m=bm, block_n=bn, block_k=bk)


def test_pallas_matmul_refuses_other_types_and_precisions():
    from veles_tpu_torch.ops import gemm as tgemm
    a = torch.ones((8, 16))
    with pytest.raises(ValueError, match="b must be"):
        tgemm.pallas_matmul(a, torch.ones((16, 8), dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="precision"):
        tgemm.pallas_matmul(a, torch.ones((16, 8)), precision="default")
    with pytest.raises(ValueError, match="col_scale"):
        tgemm.pallas_matmul(a, torch.ones((16, 8)),
                            col_scale=torch.ones(4))
    out = tgemm.pallas_matmul(a, torch.ones((16, 8)), precision="highest")
    assert torch.equal(out, torch.full((8, 8), 16.0))


def test_matmul_plan_names_follow_the_kernel_enum():
    """``matmul_plan`` labels a launch plan by its index into
    ``MATMUL_VARIANTS``: the kernel's ``enum Variant`` must list the same
    names (``kSplitK`` as ``split_k``) with the values 0, 1, ... in the
    same order, or a plan would be mislabelled on the card."""
    import os
    import re
    from veles_tpu_torch import _build
    from veles_tpu_torch.ops import gemm as tgemm
    with open(os.path.join(_build.CSRC, "matmul.cu")) as f:
        src = f.read()
    body = re.search(r"enum Variant : int \{(.*?)\};", src, re.S).group(1)
    entries = re.findall(r"\bk(\w+) = (\d+)", body)
    assert [int(v) for _, v in entries] == list(range(len(entries)))
    names = tuple(re.sub(r"(?<!^)([A-Z])", r"_\1", name).lower()
                  for name, _ in entries)
    assert names == tgemm.MATMUL_VARIANTS
