"""Mixture-of-experts FFNs in the PyTorch port (``models/moe.py``, the
``TransformerBlock(n_experts=...)`` FFN) held against the JAX package on
the CPU, on the same weights and inputs.

- ``moe_apply`` and the ``MoE`` unit in float32 and bfloat16, with gate
  ties planted (equal gate columns) at top-k 1 and 2, and ``top_k``
  against ``jax.lax.top_k`` on rows full of ties;
- the MoE block's ``apply``, one-shot prefill, ``apply_step_paged`` and
  ``apply_verify_paged`` over fp32 and int8 pools with ``int8_decode``
  off and on (a MoE block's FFN never takes the int8 path);
- the scheduler over a tiny MoE chain (the oracle is
  ``tests/test_serving.py::test_scheduler_moe_chain``): greedy streams
  equal to the JAX scheduler's and to the port's ``generate(kv_cache=
  True)``, spec-on equal to spec-off, int8 KV with ``int8_decode``;
- ``quantize_weights`` and int8 checkpoints refused on a MoE block;
  ``per_chip_bytes`` counting the expert tensors as the reference does;
- 3 trainer steps of a MoE LM (``tests/test_lm.py``'s MoE configuration:
  vocab 12, d 16, one block of 2 heads, 3 experts, top-2) against the
  JAX ``GradientDescent``.

Tolerances: 1e-5 in float32 (sums in another order; 2e-5 on the
trainer's losses and weights), 2e-2 on bfloat16 outputs (bfloat16's
unit roundoff is 3.9e-3 and the two frameworks round the expert sums
apart); the chosen experts exactly; token streams exactly.  Every JAX
chain is built under ``prng.get().preserve_state()`` so the suite's
shared chain (``spec_trained_chain``) stays as it is."""

import jax
import jax.numpy as jnp
import numpy
import pytest
import torch

from veles_tpu import prng as jax_prng
from veles_tpu.config import root

from tests.test_torch_serving import _spec
from tests.test_torch_training import _numpy_device, _token_loader
from tests.test_torch_transformer import (
    DIM, TOL, _pool, jax_chain, jax_params, lm_spec, port_chain)

pytestmark = pytest.mark.torch_port

N_EXPERTS, TOP_K = 4, 2
BF16_TOL = dict(rtol=2e-2, atol=2e-2)


def _compute(dtype):
    saved = root.common.precision.get("compute_dtype", "bfloat16")
    root.common.precision.compute_dtype = dtype
    return saved


@pytest.fixture
def f32():
    saved = _compute("float32")
    yield
    root.common.precision.compute_dtype = saved


@pytest.fixture(scope="module")
def moe_chains():
    """The transformer tests' LM chain (vocab 64, d 32, 2 blocks of 2
    heads) with MoE FFNs of 4 experts, top-2."""
    spec = lm_spec(n_experts=N_EXPERTS, top_k=TOP_K)
    with jax_prng.get().preserve_state():
        fw = jax_chain(spec)
    return spec, fw


def _jparams(layer):
    return {n: jnp.asarray(a) for n, a in layer.items()}


# -- moe_apply and the unit ---------------------------------------------------

def _moe_params(rng, d, e, h, gate_cols=None):
    """Random MoE parameters; ``gate_cols`` lists, per expert, which
    random gate column it takes (equal entries plant exact ties)."""
    gate = rng.standard_normal((d, e)).astype(numpy.float32)
    if gate_cols is not None:
        gate = gate[:, list(gate_cols)]
    return {"gate": gate,
            "expert_w1": (rng.standard_normal((e, d, h)) * 0.3).astype(
                numpy.float32),
            "expert_b1": (rng.standard_normal((e, h)) * 0.1).astype(
                numpy.float32),
            "expert_w2": (rng.standard_normal((e, h, d)) * 0.3).astype(
                numpy.float32),
            "expert_b2": (rng.standard_normal((e, d)) * 0.1).astype(
                numpy.float32)}


def _chosen_jax(params, x, k, dtype):
    xf = jnp.asarray(x).reshape(-1, x.shape[-1]).astype(dtype)
    logits = xf @ jnp.asarray(params["gate"]).astype(dtype)
    return numpy.asarray(jax.lax.top_k(logits, k)[1])


def _chosen_port(params, x, k, dtype):
    from veles_tpu_torch.models.moe import top_k
    xf = torch.as_tensor(x).reshape(-1, x.shape[-1]).to(dtype)
    w = torch.as_tensor(params["gate"]).to(dtype).to(torch.float32)
    return top_k(torch.matmul(xf.float(), w).to(dtype), k)[1].numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k,gate_cols", [
    (2, None), (2, (0, 1, 1, 1)), (1, (0, 0, 1, 1)), (2, (0, 0, 0, 0))],
    ids=["random", "tie3_top2", "tie2_top1", "all_tied"])
def test_moe_apply_matches_reference(dtype, k, gate_cols):
    from veles_tpu.models.moe import moe_apply as jax_moe
    from veles_tpu_torch.models.moe import moe_apply
    rng = numpy.random.default_rng(11)
    params = _moe_params(rng, 16, 4, 24, gate_cols)
    x = rng.standard_normal((3, 7, 16)).astype(numpy.float32)
    saved = _compute(dtype)
    try:
        want = numpy.asarray(jax_moe(_jparams(params), jnp.asarray(x), k,
                                     "strict_relu"))
        jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
        want_idx = _chosen_jax(params, x, k, jdt)
    finally:
        root.common.precision.compute_dtype = saved
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    got = moe_apply({n: torch.as_tensor(a) for n, a in params.items()},
                    torch.as_tensor(x), k, "strict_relu", tdt)
    assert got.dtype == torch.float32 and got.shape == x.shape
    numpy.testing.assert_array_equal(_chosen_port(params, x, k, tdt),
                                     want_idx)
    numpy.testing.assert_allclose(
        got.numpy(), want, **(TOL if dtype == "float32" else BF16_TOL))


def test_top_k_breaks_ties_as_jax():
    """Rows of small integers (many ties): values and indices equal to
    ``jax.lax.top_k``'s, the lower index first among equals."""
    from veles_tpu_torch.models.moe import top_k
    x = numpy.random.default_rng(3).integers(0, 4, (64, 8)).astype(
        numpy.float32)
    for k in (1, 2, 3, 8):
        wv, wi = jax.lax.top_k(jnp.asarray(x), k)
        gv, gi = top_k(torch.as_tensor(x), k)
        numpy.testing.assert_array_equal(gi.numpy(), numpy.asarray(wi))
        numpy.testing.assert_array_equal(gv.numpy(), numpy.asarray(wv))


def test_moe_unit_matches_reference(f32):
    """The ``"moe"`` layer type: the JAX unit's fill (each expert slice
    by its own fans), carried over by ``params_from_numpy``, and its
    forward on a [batch, seq, d] input."""
    from veles_tpu.accelerated_units import AcceleratedWorkflow
    from veles_tpu.memory import Array
    from veles_tpu.models.standard import make_forwards as jax_make
    from veles_tpu_torch.convert import params_from_numpy
    from veles_tpu_torch.models.moe import MoE
    x = numpy.random.default_rng(4).standard_normal((2, 5, 16)).astype(
        numpy.float32)
    spec = [{"type": "moe", "n_experts": 3, "top_k": 2, "hidden": 20}]
    with jax_prng.get().preserve_state():
        (ju,) = jax_make(AcceleratedWorkflow(None, name="t"), Array(x), spec)
        ju.initialize(device=_numpy_device())
    params = {n: numpy.array(a.mem) for n, a in ju.param_arrays().items()}
    want = numpy.asarray(ju.apply(_jparams(params), jnp.asarray(x)))
    (pu,) = params_from_numpy(spec, {0: params}, device="cpu",
                              dtype="float32")
    assert isinstance(pu, MoE) and pu.hidden == 20
    numpy.testing.assert_allclose(pu.apply(torch.as_tensor(x)).numpy(),
                                  want, **TOL)
    with pytest.raises(ValueError, match="top_k"):
        MoE(n_experts=2, top_k=3, device="cpu")


def test_fill_uses_each_experts_fans():
    """``init_params`` fills each expert slice within its own Glorot
    limit sqrt(6 / (d + h)), not the 3-D tensor's, and the stacked
    biases with zeros."""
    from veles_tpu_torch.convert import init_params
    chain = init_params([{"type": "moe", "n_experts": 3, "hidden": 40}], 0,
                        device="cpu", dtype="float32", in_shape=(5, 8))
    p = chain[0].params
    lim = numpy.sqrt(6.0 / (8 + 40))
    for n in ("expert_w1", "expert_w2"):
        assert float(p[n].abs().max()) <= lim
        assert float(p[n].abs().max()) > 0.8 * lim
    assert not p["expert_b1"].any() and not p["expert_b2"].any()


# -- the MoE block ------------------------------------------------------------

def test_moe_chain_logits_match(f32, moe_chains):
    from tests.test_torch_transformer import _jax_logits, _tokens
    spec, fw = moe_chains
    toks = _tokens((2, 20))
    want = _jax_logits(fw, toks)
    h = torch.as_tensor(toks)
    for u in port_chain(spec, fw):
        h = u.apply(h)
    numpy.testing.assert_allclose(h.numpy(), want, **TOL)


def test_moe_chain_logits_match_bf16(moe_chains):
    from tests.test_torch_transformer import _jax_logits, _tokens
    spec, fw = moe_chains
    toks = _tokens((2, 20), seed=1)
    saved = _compute("bfloat16")
    try:
        want = _jax_logits(fw, toks)
    finally:
        root.common.precision.compute_dtype = saved
    h = torch.as_tensor(toks)
    for u in port_chain(spec, fw, dtype="bfloat16"):
        h = u.apply(h)
    numpy.testing.assert_allclose(h.float().numpy(), want, **BF16_TOL)


def test_moe_prefill_matches(f32, moe_chains):
    from tests.test_torch_transformer import _tokens
    from veles_tpu.serving import prefill as jprefill
    from veles_tpu_torch.serving import prefill
    spec, fw = moe_chains
    toks = _tokens((2, 24), seed=2)
    lens = [24, 13]
    jc, jl = jprefill(fw, toks, prompt_lens=lens, window=32)
    tc, tl = prefill(port_chain(spec, fw), toks, prompt_lens=lens, window=32)
    for i in jc:
        for part in ("k", "v"):
            numpy.testing.assert_allclose(
                tc[i][part].numpy(), numpy.asarray(jc[i][part]), **TOL)
    numpy.testing.assert_allclose(tl.numpy(), numpy.asarray(jl), **TOL)


def _assert_pool(got, want, quant):
    for name in want:
        w = numpy.asarray(want[name])
        if name in ("k", "v") and quant:
            d = numpy.abs(got[name].numpy().astype(int) - w.astype(int))
            assert d.max() <= 1, name
        else:
            numpy.testing.assert_allclose(got[name].numpy(), w,
                                          err_msg=name, **TOL)


@pytest.mark.parametrize("w8", [False, True], ids=["w32", "int8_decode"])
@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
def test_moe_paged_step_and_verify_match(f32, moe_chains, monkeypatch, quant,
                                        w8):
    """One MoE block's paged decode step and its K1 5 verify against the
    JAX block's; with ``int8_decode`` only ``wo`` takes the int8 GEMM
    (its plain version here), the MoE FFN the policy products."""
    from veles_tpu_torch.ops import gemm
    spec, fw = moe_chains
    jblk = fw[1]
    tblk = port_chain(spec, fw)[1]
    jblk.int8_decode = tblk.int8_decode = w8
    params = _jparams(jax_params(fw)[1])
    rng = numpy.random.default_rng(5 + 2 * quant + w8)
    pool = _pool(rng, quant)
    x = (rng.standard_normal((4, 1, DIM)) * 0.5).astype(numpy.float32)
    xv = (rng.standard_normal((4, 5, DIM)) * 0.5).astype(numpy.float32)
    pos = numpy.asarray([20, 3, 40, 0], numpy.int32)
    lens = numpy.asarray([5, 2, 4, 1], numpy.int32)
    tables = numpy.asarray([[2, 4, 0, 0], [5, 0, 0, 0], [1, 3, 2, 0],
                            [0, 0, 0, 0]], numpy.int32)
    try:
        jy, jpool = jblk.apply_step_paged(
            params, jnp.asarray(x), jnp.asarray(pos), jnp.asarray(tables),
            _jparams(pool))
        jv, jvpool = jblk.apply_verify_paged(
            params, jnp.asarray(xv), jnp.asarray(pos), jnp.asarray(lens),
            jnp.asarray(tables), _jparams(pool))
    finally:
        jblk.int8_decode = False
    calls = []
    real = gemm.int8_matmul_plain

    def counted(*a, **kw):
        calls.append(a[1].shape)
        return real(*a, **kw)

    monkeypatch.setattr(gemm, "int8_matmul_plain", counted)
    tpool = {n: torch.as_tensor(a.copy()) for n, a in pool.items()}
    ty, tpool = tblk.apply_step_paged(
        torch.as_tensor(x), torch.as_tensor(pos), torch.as_tensor(tables),
        tpool)
    vpool = {n: torch.as_tensor(a.copy()) for n, a in pool.items()}
    tv, vpool = tblk.apply_verify_paged(
        torch.as_tensor(xv), torch.as_tensor(pos), torch.as_tensor(lens),
        torch.as_tensor(tables), vpool)
    assert calls == ([(DIM, DIM)] * 2 if w8 else [])
    numpy.testing.assert_allclose(ty[:3].numpy(), numpy.asarray(jy)[:3],
                                  **TOL)
    _assert_pool(tpool, jpool, quant)
    valid = [(n, j) for n in range(3) for j in range(lens[n])]
    numpy.testing.assert_allclose(
        numpy.stack([tv[n, j].numpy() for n, j in valid]),
        numpy.stack([numpy.asarray(jv)[n, j] for n, j in valid]), **TOL)
    _assert_pool({n: t[1:] for n, t in vpool.items()},
                 {n: numpy.asarray(a)[1:] for n, a in jvpool.items()},
                 quant)


def test_moe_block_refuses_int8_checkpoints(f32, moe_chains):
    """``quantize_weights`` and ``load_params`` of int8 weights refuse a
    MoE block with ``ValueError``, as the reference's
    ``quantize_weights`` does; ``per_chip_bytes`` counts the expert
    tensors as the reference counts them."""
    from veles_tpu.models.generate import _device_params
    from veles_tpu.serving import per_chip_bytes as jax_bytes
    from veles_tpu_torch.models.transformer import TransformerBlock
    from veles_tpu_torch.serving import per_chip_bytes
    from veles_tpu_torch.serving.tp import chain_params
    spec, fw = moe_chains
    chain = port_chain(spec, fw)
    blk = chain[1]
    with pytest.raises(ValueError, match="dense FFN"):
        fw[1].quantize_weights()
    with pytest.raises(ValueError, match="dense FFN"):
        blk.quantize_weights()
    arrays = dict(jax_params(fw)[1])
    for n in ("wq", "wk", "wv", "wo"):
        arrays[n] = arrays[n].astype(numpy.int8)
        arrays[n + "_scale"] = numpy.ones(DIM, numpy.float32)
    fresh = TransformerBlock(heads=2, n_experts=N_EXPERTS, device="cpu",
                             dtype="float32")
    with pytest.raises(ValueError, match="dense FFN"):
        fresh.load_params(arrays)
    want = jax_bytes(_device_params(fw))
    assert per_chip_bytes(chain_params(chain)) == want
    experts = sum(t.numel() * 4 for n, t in blk.params.items()
                  if n.startswith(("gate", "expert_")))
    assert experts > 0 and "ffn_w1" not in blk.params
    assert sorted(blk.params) == sorted(fw[1].param_arrays())


# -- serving ------------------------------------------------------------------

WINDOW, STEPS = 16, 5
PROMPTS = ([3, 1, 4], [5, 9, 2, 6, 5], [7], [2, 7, 1, 8, 2, 8])


@pytest.fixture(scope="module")
def tiny_moe():
    """``test_scheduler_moe_chain``'s chain: vocab 12, d 16, one block of
    2 heads with 3 experts, top-2, window 16."""
    saved = _compute("float32")
    try:
        with jax_prng.get().preserve_state():
            fw = jax_chain(lm_spec(vocab=12, dim=16, layers=1, heads=2,
                                   n_experts=3, top_k=2), window=WINDOW)
    finally:
        root.common.precision.compute_dtype = saved
    return fw


def _serve(pkg, chain, **kw):
    kw = dict(dict(max_slots=2, window=WINDOW, kv="paged", block_size=4,
                   prefill_chunk=0, spec=False, prefix_cache=False,
                   warm_buckets=False), **kw)
    if pkg == "jax":
        from veles_tpu.serving import InferenceScheduler
    else:
        from veles_tpu_torch.serving import InferenceScheduler
        kw["device"] = "cpu"
    sch = InferenceScheduler(chain, **kw).start()
    try:
        out = [f.result(240) for f in [sch.submit(list(p), STEPS, seed=0)
                                       for p in PROMPTS]]
    finally:
        sch.close()
    if pkg == "port":
        sch.check_kv()
        assert sch.cache_.free_blocks == sch.cache_.capacity_blocks
    return out, sch


@pytest.mark.parametrize("kv_dtype", ["fp32", "int8"])
def test_moe_scheduler_streams_match_reference(f32, tiny_moe, kv_dtype):
    """Greedy streams over the paged cache equal the JAX scheduler's
    (``int8_decode`` on both sides with int8 KV), the port's spec-on
    streams equal its spec-off ones, and the fp32 ones equal the port's
    ``generate(kv_cache=True)``."""
    from veles_tpu_torch.models.generate import generate
    fw = tiny_moe
    w8 = kv_dtype == "int8"
    for u in fw[1:-1]:
        u.int8_decode = w8
    try:
        want, _ = _serve("jax", fw, kv_dtype=kv_dtype)
    finally:
        for u in fw[1:-1]:
            u.int8_decode = False
    chain = port_chain(_spec(fw, n_experts=3, top_k=2, int8_decode=w8), fw)
    got, sch = _serve("port", chain, kv_dtype=kv_dtype)
    assert got == want
    assert sch.decode_tokens == len(PROMPTS) * (STEPS - 1)
    spec_on, ssch = _serve("port", chain, kv_dtype=kv_dtype, spec=True,
                           spec_k=3)
    assert spec_on == got
    if not w8:
        for p, stream in zip(PROMPTS, got):
            ref = generate(chain, numpy.asarray([p], numpy.int32), STEPS,
                           kv_cache=True)
            assert numpy.asarray(ref)[0].tolist() == stream


def test_moe_chain_is_servable(tiny_moe):
    from veles_tpu_torch.serving import serving_supported
    from veles_tpu_torch.serving.kv_slots import paged_supported
    chain = port_chain(_spec(tiny_moe, n_experts=3, top_k=2), tiny_moe)
    assert serving_supported(chain) and paged_supported(chain)
    assert chain[1].n_experts == 3 and chain[1].top_k == 2


# -- training -----------------------------------------------------------------

T_VOCAB, T_SEQ, T_MB = 12, 10, 4


def _moe_lm_spec():
    return [{"type": "embedding", "vocab": T_VOCAB, "dim": 16},
            {"type": "transformer_block", "heads": 2, "causal": True,
             "n_experts": 3, "top_k": 2},
            {"type": "token_logits", "vocab": T_VOCAB}]


def test_moe_trainer_three_steps_match_reference(f32):
    """A validation span and 3 SGD-momentum steps of the MoE LM on both
    trainers from the same weights and minibatches: losses, ``n_err``,
    the epoch accumulator and every parameter within 2e-5."""
    from veles_tpu.accelerated_units import AcceleratedWorkflow
    from veles_tpu.models.evaluator import EvaluatorNextToken as JNext
    from veles_tpu.models.gd import GradientDescent as JGD
    from veles_tpu.models.standard import make_forwards as jax_make
    from veles_tpu_torch.convert import params_from_numpy, params_to_numpy
    from veles_tpu_torch.loader import FullBatchLoader
    from veles_tpu_torch.models.evaluator import EvaluatorNextToken
    from veles_tpu_torch.models.gd import GradientDescent
    tokens = numpy.random.default_rng(8).integers(
        0, T_VOCAB, (16, T_SEQ)).astype(numpy.int32)
    kw = dict(solver="sgd", learning_rate=0.05, gradient_moment=0.9)
    with jax_prng.get().preserve_state(), \
            jax_prng.get("loader").preserve_state():
        wf = AcceleratedWorkflow(None, name="torch-moe-train")
        jl = _token_loader(wf, tokens, [0, 4, 12], T_MB, 5)
        jfw = jax_make(wf, jl.minibatch_data, _moe_lm_spec())
        dev = _numpy_device()
        for u in jfw:
            u.initialize(device=dev)
        ev = JNext(wf)
        ev.output = jfw[-1].output
        ev.tokens = jl.minibatch_data
        ev.loader = jl
        ev.initialize(device=dev)
        jgd = JGD(wf, forwards=jfw, evaluator=ev, loader=jl, **kw)
        jgd.initialize(device=dev)
    jgd._observe_health = lambda health, force=False: None
    chain = params_from_numpy(_moe_lm_spec(), jax_params(jfw), device="cpu",
                              dtype="float32")
    pl = FullBatchLoader(tokens, None, [0, 4, 12], minibatch_size=T_MB,
                         seed=5, device="cpu")
    pgd = GradientDescent(chain, EvaluatorNextToken(), **kw)
    losses = []
    for _ in range(2):                  # the validation span, then train
        jl.run()
        jgd.run()
        pl.serve_span()
        pgd.run_span(pl)
        losses.append((float(pgd.loss), float(jgd.loss.map_read().mem)))
    assert pgd.global_step == jgd.global_step == 3
    for got, want in losses:
        assert got == pytest.approx(want, rel=2e-5, abs=2e-5)
    assert int(pgd.n_err) == int(jgd.n_err.map_read().mem)
    numpy.testing.assert_allclose(pgd.epoch_acc.numpy(),
                                  jgd.epoch_acc.map_read().mem,
                                  rtol=2e-5, atol=2e-5)
    got, want = params_to_numpy(chain), jax_params(jfw)
    for i in want:
        for n in want[i]:
            numpy.testing.assert_allclose(got[i][n], want[i][n], rtol=2e-5,
                                          atol=2e-5, err_msg="%d %s" % (i, n))
