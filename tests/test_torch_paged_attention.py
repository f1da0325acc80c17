"""Paged attention of the PyTorch port (``veles_tpu_torch/ops``) held
against the JAX package on the CPU: the kernel's plain version against
``pallas_paged_attend`` in interpret mode, the decode paths against
``ops/paged_attention.py``, over fp32 and int8 pools, one and three
queries per row, with trash-block padding.  The tolerance is 1e-5
(f32): the online softmax of the TPU kernel sums in another order."""

import numpy
import pytest
import torch

import jax.numpy as jnp

from veles_tpu.config import root

pytestmark = pytest.mark.torch_port

D, HEADS, BS, NB = 32, 2, 16, 9
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture
def f32():
    saved = root.common.precision.get("compute_dtype", "bfloat16")
    root.common.precision.compute_dtype = "float32"
    yield
    root.common.precision.compute_dtype = saved


def _pools(rng, quant):
    """Random pools with the trash block 0 zeroed (as a fresh cache
    keeps it); int8 pools come with their per-row scales."""
    from veles_tpu.ops.paged_attention import quantize_kv_rows
    k = rng.standard_normal((NB, BS, D)).astype(numpy.float32)
    v = rng.standard_normal((NB, BS, D)).astype(numpy.float32)
    k[0] = v[0] = 0.0
    if not quant:
        return {"k": k, "v": v}
    qk, sk = quantize_kv_rows(jnp.asarray(k))
    qv, sv = quantize_kv_rows(jnp.asarray(v))
    return {"k": numpy.asarray(qk), "v": numpy.asarray(qv),
            "k_scale": numpy.asarray(sk), "v_scale": numpy.asarray(sv)}


def _tables():
    """Three rows: two live blocks then trash, one live block then
    trash, and an all-trash padding row (position 0)."""
    return numpy.asarray([[3, 5, 0], [7, 0, 0], [0, 0, 0]], numpy.int32)


def _qpos(k1):
    base = numpy.asarray([20, 9, 0], numpy.int32)
    qp = base[:, None] + numpy.arange(k1, dtype=numpy.int32)[None, :]
    qp[2] = 0                        # the padding row stays at 0
    return qp


def _t(a, dtype=None):
    t = torch.as_tensor(numpy.array(a))
    return t if dtype is None else t.to(dtype)


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("k1", [1, 3])
def test_paged_attend_plain_matches_pallas(quant, k1):
    from veles_tpu.ops.pallas_paged import pallas_paged_attend
    from veles_tpu_torch.ops.paged_attend import (
        paged_attend, paged_attend_plain)
    rng = numpy.random.default_rng(k1 + 10 * quant)
    pools = _pools(rng, quant)
    q = rng.standard_normal((3, k1, D)).astype(numpy.float32)
    tables, qpos = _tables(), _qpos(k1)
    scales = {}
    if quant:
        scales = dict(scale_k=pools["k_scale"], scale_v=pools["v_scale"])
    want = numpy.asarray(pallas_paged_attend(
        jnp.asarray(q), jnp.asarray(pools["k"]), jnp.asarray(pools["v"]),
        jnp.asarray(tables), jnp.asarray(qpos), HEADS,
        interpret=True, **{n: jnp.asarray(a) for n, a in scales.items()}))
    targs = (_t(q), _t(pools["k"]), _t(pools["v"]), _t(tables), _t(qpos),
             HEADS)
    tsc = {n: _t(a) for n, a in scales.items()}
    got = paged_attend_plain(*targs, **tsc)
    assert got.dtype == torch.float32 and got.shape == (3, k1, D)
    numpy.testing.assert_allclose(got.numpy(), want, **TOL)
    # the wrapper takes the plain version for CPU tensors
    numpy.testing.assert_array_equal(paged_attend(*targs, **tsc).numpy(),
                                     got.numpy())


@pytest.mark.parametrize("k1", [1, 3])
def test_paged_attend_plain_all_negative_row(k1):
    """A row whose queries all lie before its table masks every key
    (score -1e30), so its context is the mean of all T*bs V rows: the
    JAX kernel walks every block of the table.  Over T = 3 distinct
    blocks that is not the first block's mean (which a walk stopped at
    the first block would give)."""
    from veles_tpu.ops.pallas_paged import pallas_paged_attend
    from veles_tpu_torch.ops.paged_attend import paged_attend_plain
    rng = numpy.random.default_rng(30 + k1)
    pools = _pools(rng, False)
    q = rng.standard_normal((2, k1, D)).astype(numpy.float32)
    tables = numpy.asarray([[3, 5, 8], [7, 0, 0]], numpy.int32)
    qpos = numpy.asarray([numpy.arange(k1) - 9, numpy.arange(k1) + 9],
                         numpy.int32)
    want = numpy.asarray(pallas_paged_attend(
        jnp.asarray(q), jnp.asarray(pools["k"]), jnp.asarray(pools["v"]),
        jnp.asarray(tables), jnp.asarray(qpos), HEADS, interpret=True))
    got = paged_attend_plain(_t(q), _t(pools["k"]), _t(pools["v"]),
                             _t(tables), _t(qpos), HEADS).numpy()
    numpy.testing.assert_allclose(got, want, **TOL)
    every = pools["v"][tables[0]].reshape(3 * BS, D).mean(axis=0)
    first = pools["v"][tables[0, 0]].mean(axis=0)
    numpy.testing.assert_allclose(got[0], numpy.broadcast_to(every, (k1, D)),
                                  **TOL)
    assert numpy.abs(got[0] - first).max() > 0.1


def test_quantize_kv_rows_bit_equal():
    from veles_tpu.ops import paged_attention as jpa
    from veles_tpu_torch.ops import paged_attention as tpa
    rng = numpy.random.default_rng(3)
    x = (rng.standard_normal((4, 5, D)) * 3).astype(numpy.float32)
    x[1, 2] = 0.0                    # all-zero row → scale 0, zeros
    x[2, 0, :4] = [0.5, -0.5, 1.5, 127.0]
    jq, js = jpa.quantize_kv_rows(jnp.asarray(x))
    tq, ts = tpa.quantize_kv_rows(_t(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    numpy.testing.assert_array_equal(tq.numpy(), numpy.asarray(jq))
    numpy.testing.assert_array_equal(ts.numpy(), numpy.asarray(js))
    numpy.testing.assert_array_equal(
        tpa.dequantize_kv(tq, ts).numpy(),
        numpy.asarray(jpa.dequantize_kv(jq, js)))


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
def test_paged_decode_attention_matches_jax(f32, quant):
    """One decode position per row, new K/V scattered (quantized for
    int8) into the pools, then the masked attention — pools and
    context against the JAX decode functions."""
    from veles_tpu.ops import paged_attention as jpa
    from veles_tpu_torch.ops import paged_attention as tpa
    rng = numpy.random.default_rng(7 + quant)
    pools = _pools(rng, quant)
    q, kn, vn = (rng.standard_normal((3, 1, D)).astype(numpy.float32)
                 for _ in range(3))
    tables = _tables()
    pos = numpy.asarray([20, 9, 0], numpy.int32)
    tp = {n: _t(a).clone() for n, a in pools.items()}
    jargs = [jnp.asarray(a) for a in (q, kn, vn)]
    targs = [_t(a) for a in (q, kn, vn)]
    if quant:
        want = jpa.paged_decode_attention_q8(
            *jargs, *(jnp.asarray(pools[n]) for n in
                      ("k", "v", "k_scale", "v_scale")),
            jnp.asarray(tables), jnp.asarray(pos), HEADS)
        got = tpa.paged_decode_attention_q8(
            *targs, tp["k"], tp["v"], tp["k_scale"], tp["v_scale"],
            _t(tables), _t(pos), HEADS)
        names = ("k", "v", "k_scale", "v_scale")
    else:
        want = jpa.paged_decode_attention(
            *jargs, jnp.asarray(pools["k"]), jnp.asarray(pools["v"]),
            jnp.asarray(tables), jnp.asarray(pos), HEADS)
        got = tpa.paged_decode_attention(
            *targs, tp["k"], tp["v"], _t(tables), _t(pos), HEADS,
            torch.float32)
        names = ("k", "v")
    for name, w, g in zip(names, want[:-1], got[:-1]):
        # the new rows went into the live blocks, the pool in place
        assert g is tp[name]
        numpy.testing.assert_allclose(g.numpy(), numpy.asarray(w),
                                      err_msg=name, **TOL)
    ctx = got[-1]
    assert ctx.shape == (3, 1, D)
    # row 2 is bucket padding — its output is garbage nobody reads
    numpy.testing.assert_allclose(ctx[:2].float().numpy(),
                                  numpy.asarray(want[-1])[:2], **TOL)

