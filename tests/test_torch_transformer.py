"""The LM chain of the PyTorch port held against the JAX package on the
CPU, on the same weights (carried over by ``convert.params_from_numpy``
from a JAX ``make_forwards`` chain): full-chain logits, one-shot and
chunked prefill (caches and last logits), and one paged decode step
over fp32 and int8 pools with ``int8_decode`` off and on.

Tolerances: 1e-5 in float32 (the frameworks sum in other orders); the
one bfloat16 case holds the logits to 2e-2, because bfloat16 rounds at
other points in the two frameworks (its unit roundoff is 3.9e-3).  An
int8 pool row that quantizes from a K/V row computed in another order
may land one step off (|Δ| <= 1)."""

import numpy
import pytest
import torch

import jax.numpy as jnp

from veles_tpu.config import root

pytestmark = pytest.mark.torch_port

VOCAB, DIM, LAYERS, HEADS, WINDOW, BS = 64, 32, 2, 2, 64, 16
TOL = dict(rtol=1e-5, atol=1e-5)


def _compute(dtype):
    saved = root.common.precision.get("compute_dtype", "bfloat16")
    root.common.precision.compute_dtype = dtype
    return saved


@pytest.fixture
def f32():
    saved = _compute("float32")
    yield
    root.common.precision.compute_dtype = saved


def lm_spec(vocab=VOCAB, dim=DIM, layers=LAYERS, heads=HEADS, **block):
    spec = [{"type": "embedding", "vocab": vocab, "dim": dim}]
    spec += [dict({"type": "transformer_block", "heads": heads,
                   "causal": True}, **block) for _ in range(layers)]
    return spec + [{"type": "token_logits", "vocab": vocab}]


def jax_params(fw):
    """``{i: {name: numpy}}`` of a JAX chain — what
    ``params_from_numpy`` takes."""
    return {i: {n: numpy.array(a.map_read().mem)
                for n, a in u.param_arrays().items()}
            for i, u in enumerate(fw)}


def port_chain(spec, fw, dtype="float32"):
    from veles_tpu_torch.convert import params_from_numpy
    return params_from_numpy(spec, jax_params(fw), device="cpu",
                             dtype=dtype)


def jax_chain(spec, window=WINDOW):
    from veles_tpu.accelerated_units import AcceleratedWorkflow
    from veles_tpu.backends import Device
    from veles_tpu.memory import Array
    from veles_tpu.models.standard import make_forwards
    wf = AcceleratedWorkflow(None, name="torch-parity")
    fw = make_forwards(wf, Array(numpy.zeros((1, window), numpy.int32)),
                       spec)
    dev = Device(backend="numpy")
    for u in fw:
        u.initialize(device=dev)
    return fw


@pytest.fixture(scope="module")
def chains():
    saved = _compute("float32")
    try:
        spec = lm_spec()
        fw = jax_chain(spec)
    finally:
        root.common.precision.compute_dtype = saved
    return spec, fw


def _jparams(fw):
    return {i: {n: jnp.asarray(a) for n, a in layer.items()}
            for i, layer in jax_params(fw).items()}


def _tokens(shape, seed=0):
    return numpy.random.default_rng(seed).integers(
        0, VOCAB, shape).astype(numpy.int32)


def _jax_logits(fw, toks):
    params = _jparams(fw)
    h = jnp.asarray(toks)
    for i, u in enumerate(fw):
        h = u.apply(params[i], h)
    return numpy.asarray(h, numpy.float32)


def test_chain_logits_match(f32, chains):
    spec, fw = chains
    toks = _tokens((2, 20))
    want = _jax_logits(fw, toks)
    h = torch.as_tensor(toks)
    for u in port_chain(spec, fw):
        h = u.apply(h)
    assert h.dtype == torch.float32 and h.shape == (2, 20, VOCAB)
    numpy.testing.assert_allclose(h.numpy(), want, **TOL)


def test_chain_logits_match_bf16(chains):
    """bfloat16 on both sides, at the stated looser tolerance."""
    spec, fw = chains
    toks = _tokens((2, 20), seed=1)
    saved = _compute("bfloat16")
    try:
        want = _jax_logits(fw, toks)
    finally:
        root.common.precision.compute_dtype = saved
    h = torch.as_tensor(toks)
    for u in port_chain(spec, fw, dtype="bfloat16"):
        h = u.apply(h)
    numpy.testing.assert_allclose(h.float().numpy(), want, rtol=2e-2,
                                  atol=2e-2)


def test_prefill_caches_and_last_logits_match(f32, chains):
    from veles_tpu.serving import prefill as jprefill
    from veles_tpu_torch.serving import prefill
    spec, fw = chains
    toks = _tokens((2, 24), seed=2)
    lens = [24, 13]
    jc, jl = jprefill(fw, toks, prompt_lens=lens, window=32)
    tc, tl = prefill(port_chain(spec, fw), toks, prompt_lens=lens,
                     window=32)
    assert set(tc) == set(jc) == {1, 2}
    for i in jc:
        for part in ("k", "v"):
            numpy.testing.assert_allclose(
                tc[i][part].numpy(), numpy.asarray(jc[i][part]),
                err_msg="layer %d %s" % (i, part), **TOL)
            assert not tc[i][part][1, 13:].any()
    numpy.testing.assert_allclose(tl.numpy(), numpy.asarray(jl), **TOL)


def test_prefill_chunk_chain_matches(f32, chains):
    """Two chained 16-token chunks (the second ragged) against the JAX
    chunked prefill, and against the port's own one-shot prefill."""
    from veles_tpu.serving import prefill_chunk as jchunk
    from veles_tpu_torch.serving import prefill, prefill_chunk
    spec, fw = chains
    pc = port_chain(spec, fw)
    seq = _tokens((1, 27), seed=3)
    jc = {i: u.init_cache(1, 32, jnp.float32)
          for i, u in enumerate(fw) if hasattr(u, "init_cache")}
    tc = {i: u.init_cache(1, 32, torch.float32)
          for i, u in enumerate(pc) if hasattr(u, "init_cache")}
    for off in (0, 16):
        clen = min(16, 27 - off)
        chunk = numpy.zeros((1, 16), numpy.int32)
        chunk[0, :clen] = seq[0, off:off + clen]
        jc, jl = jchunk(fw, chunk, off, [clen], jc, key_width=off + 16)
        tc, tl = prefill_chunk(pc, chunk, off, [clen], tc,
                               key_width=off + 16)
    for i in jc:
        for part in ("k", "v"):
            numpy.testing.assert_allclose(
                tc[i][part].numpy(), numpy.asarray(jc[i][part]),
                err_msg="layer %d %s" % (i, part), **TOL)
    numpy.testing.assert_allclose(tl.numpy(), numpy.asarray(jl), **TOL)
    oc, ol = prefill(pc, seq, window=32)
    numpy.testing.assert_allclose(tl.numpy(), ol.numpy(), **TOL)
    for i in oc:
        numpy.testing.assert_allclose(tc[i]["k"].numpy(),
                                      oc[i]["k"].numpy(), **TOL)


def _pool(rng, quant):
    nb = 6
    k = rng.standard_normal((nb, BS, DIM)).astype(numpy.float32)
    v = rng.standard_normal((nb, BS, DIM)).astype(numpy.float32)
    k[0] = v[0] = 0.0
    if not quant:
        return {"k": k, "v": v}
    from veles_tpu.ops.paged_attention import quantize_kv_rows
    (qk, sk), (qv, sv) = (quantize_kv_rows(jnp.asarray(x)) for x in (k, v))
    return {"k": numpy.asarray(qk), "v": numpy.asarray(qv),
            "k_scale": numpy.asarray(sk), "v_scale": numpy.asarray(sv)}


@pytest.mark.parametrize("w8", [False, True], ids=["w32", "int8_decode"])
@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
def test_paged_step_matches(f32, chains, quant, w8):
    spec, fw = chains
    jblk = fw[1]
    tblk = port_chain(spec, fw)[1]
    jblk.int8_decode = tblk.int8_decode = w8
    try:
        rng = numpy.random.default_rng(5 + 2 * quant + w8)
        pool = _pool(rng, quant)
        x = (rng.standard_normal((4, 1, DIM)) * 0.5).astype(numpy.float32)
        pos = numpy.asarray([20, 3, 40, 0], numpy.int32)
        tables = numpy.asarray([[2, 4, 0, 0], [5, 0, 0, 0],
                                [1, 3, 2, 0], [0, 0, 0, 0]], numpy.int32)
        params = {n: jnp.asarray(a)
                  for n, a in jax_params(fw)[1].items()}
        jy, jpool = jblk.apply_step_paged(
            params, jnp.asarray(x), jnp.asarray(pos), jnp.asarray(tables),
            {n: jnp.asarray(a) for n, a in pool.items()})
        tpool = {n: torch.as_tensor(a.copy()) for n, a in pool.items()}
        ty, tpool = tblk.apply_step_paged(
            torch.as_tensor(x), torch.as_tensor(pos),
            torch.as_tensor(tables), tpool)
    finally:
        jblk.int8_decode = False
    # row 3 is bucket padding (trash block, position 0): not compared
    numpy.testing.assert_allclose(ty[:3].numpy(), numpy.asarray(jy)[:3],
                                  **TOL)
    for name in pool:
        want = numpy.asarray(jpool[name])
        if name in ("k", "v") and quant:
            diff = numpy.abs(tpool[name].numpy().astype(int)
                             - want.astype(int))
            assert diff.max() <= 1, name
        else:
            numpy.testing.assert_allclose(tpool[name].numpy(), want,
                                          err_msg=name, **TOL)
