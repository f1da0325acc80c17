"""Int8 weight checkpoints in the PyTorch port
(``TransformerBlock.quantize_weights``, ``load_params`` of int8 weights
with their ``*_scale`` arrays, ``serving/kv_quality.
weight_quant_quality``, ``serving/tp.per_chip_bytes``) held against the
JAX package on the CPU, on copies of the suite's trained chain
(``spec_trained_chain``): the gate quantizes in place, so each package
gets its own copy.

Tolerances: the int8 weights equal the reference's exactly and their
scales within 1e-7; the gate's cross-entropies within 1e-5; bytes and
token streams exact.

The finding this file pins: the reference's ``int8_decode`` on an int8
checkpoint re-quantizes the stored int8 values and never applies their
scales (``_w8_matmul``; ``_attn_tail`` and ``_ffn`` take the ``w8``
branch first), so its logits are those of another model.  The port
refuses the combination with a ``ValueError`` (ROADMAP §C, a deliberate
deviation)."""

import numpy
import pytest
import torch

from veles_tpu.config import root

from tests.test_torch_serving import _spec
from tests.test_torch_transformer import jax_chain, jax_params, port_chain

pytestmark = pytest.mark.torch_port

WINDOW = 64


@pytest.fixture
def f32():
    saved = root.common.precision.get("compute_dtype", "bfloat16")
    root.common.precision.compute_dtype = "float32"
    yield
    root.common.precision.compute_dtype = saved


def _jax_copy(fw):
    """A JAX chain holding ``fw``'s weights (its own arrays); building
    it leaves the process-wide generator other chains draw from as it
    was."""
    from veles_tpu import prng
    params = jax_params(fw)
    with prng.get().preserve_state():
        copy = jax_chain(_spec(fw), window=WINDOW)
    for i, u in enumerate(copy):
        for n, a in u.param_arrays().items():
            a.reset(params[i][n].copy())
    return copy


@pytest.fixture(scope="module")
def w8(spec_trained_chain):
    """Both packages' copies of the trained chain, gated and quantized
    once; the records and the bytes before and after."""
    from veles_tpu.models.generate import _device_params
    from veles_tpu.serving import per_chip_bytes as jax_bytes
    from veles_tpu.serving import weight_quant_quality as jax_gate
    from veles_tpu_torch.serving import per_chip_bytes, weight_quant_quality
    from veles_tpu_torch.serving.tp import chain_params
    fw, pattern = spec_trained_chain
    saved = root.common.precision.get("compute_dtype", "bfloat16")
    root.common.precision.compute_dtype = "float32"
    try:
        jfw = _jax_copy(fw)
        chain = port_chain(_spec(fw), fw)
        seqs = [(pattern * 10)[:64],
                numpy.random.RandomState(0).randint(0, 12, size=64).tolist()]
        before = (jax_bytes(_device_params(jfw)),
                  per_chip_bytes(chain_params(chain)))
        want = jax_gate(jfw, seqs, block_size=16)
        got = weight_quant_quality(chain, seqs, block_size=16)
        after = (jax_bytes(_device_params(jfw)),
                 per_chip_bytes(chain_params(chain)))
    finally:
        root.common.precision.compute_dtype = saved
    yield dict(jfw=jfw, chain=chain, pattern=pattern, want=want, got=got,
               before=before, after=after)


def test_weight_quant_record_matches_reference(w8):
    """The gate's record: the reference's keys, its cross-entropies
    within 1e-5, within the 0.05-nat tolerance, two blocks quantized."""
    from veles_tpu_torch.serving.kv_quality import WEIGHT_QUANT_CE_TOLERANCE
    want, got = w8["want"], w8["got"]
    assert set(got) == set(want)
    for key in ("weight_quant_ce_fp32", "weight_quant_ce_int8",
                "weight_quant_ce_delta"):
        assert got[key] == pytest.approx(want[key], abs=1e-5), key
    for key in ("weight_quant_positions", "weight_quant_blocks",
                "weight_quant_ce_tolerance",
                "weight_quant_within_tolerance"):
        assert got[key] == want[key], key
    assert got["weight_quant_within_tolerance"]
    assert got["weight_quant_ce_delta"] <= WEIGHT_QUANT_CE_TOLERANCE
    assert got["weight_quant_blocks"] == 2


def test_weights_and_bytes_match_reference(w8):
    """The int8 weights equal the reference's, their scales within 1e-7;
    the bytes ``per_chip_bytes`` reads equal the reference's before and
    after and drop below 0.6x; a second ``quantize_weights`` is a
    no-op."""
    jfw, chain = w8["jfw"], w8["chain"]
    assert w8["before"][0] == w8["before"][1]
    assert w8["after"][0] == w8["after"][1]
    assert w8["after"][1] < 0.6 * w8["before"][1]
    for ju, u in zip(jfw, chain):
        if not hasattr(u, "quantize_weights"):
            continue
        assert u.weights_int8 and ju.weights_int8
        n_params = len(u.PARAMS)
        u.quantize_weights()
        assert len(u.PARAMS) == n_params == len(ju.PARAMS)
        for name in ("wq", "wk", "wv", "wo", "ffn_w1", "ffn_w2"):
            assert u.params[name].dtype == torch.int8
            assert numpy.array_equal(u.params[name].numpy(),
                                     getattr(ju, name).mem)
            numpy.testing.assert_allclose(
                u.params[name + "_scale"].numpy(),
                getattr(ju, name + "_scale").mem, rtol=1e-7, atol=0)


def test_int8_checkpoint_loads(w8, f32):
    """``params_from_numpy`` takes the reference's int8 checkpoint
    (int8 weights and ``*_scale`` arrays): the loaded chain holds the
    same tensors and teacher-forces the same logits as the one
    quantized in place; an int8 weight without its scale is refused."""
    from veles_tpu_torch.convert import params_from_numpy
    from veles_tpu_torch.serving.kv_quality import teacher_forced_logits
    jfw, chain, pattern = w8["jfw"], w8["chain"], w8["pattern"]
    params = jax_params(jfw)
    loaded = params_from_numpy(_spec(jfw), params, device="cpu",
                               dtype="float32")
    assert loaded[1].weights_int8
    for n, t in chain[1].params.items():
        assert torch.equal(loaded[1].params[n], t), n
    seq = (pattern * 4)[:32]
    numpy.testing.assert_array_equal(
        teacher_forced_logits(loaded, seq, 16),
        teacher_forced_logits(chain, seq, 16))
    broken = dict(params[1])
    del broken["wq_scale"]
    with pytest.raises(ValueError):
        params_from_numpy(_spec(jfw), {**params, 1: broken},
                          device="cpu", dtype="float32")


def _serve(pkg, chain, submits, **kw):
    kw.setdefault("warm_buckets", False)
    if pkg == "jax":
        from veles_tpu.serving import InferenceScheduler
    else:
        from veles_tpu_torch.serving import InferenceScheduler
        kw.setdefault("device", "cpu")
    sch = InferenceScheduler(chain, max_slots=3, window=WINDOW, kv="paged",
                             block_size=4, prefill_chunk=0, **kw).start()
    try:
        outs = [sch.submit(p, steps, **skw).result(240)
                for p, steps, skw in submits]
        sch.check_kv()
        return outs
    finally:
        sch.close()


def test_w8_spec_parity_matches_reference(w8, f32):
    """On the quantized chain spec-on streams equal spec-off ones, greedy
    and seeded, and both equal the reference's."""
    jfw, chain = w8["jfw"], w8["chain"]
    prompts = [[3, 1, 4, 1, 5, 9], [2, 6, 3, 1]]
    submits = [(p, 10, dict(seed=0)) for p in prompts]
    submits += [(p, 8, dict(temperature=0.9, top_k=5, seed=7))
                for p in prompts]
    off = _serve("port", chain, submits, spec=False)
    assert _serve("port", chain, submits, spec=True, spec_k=4) == off
    assert _serve("jax", jfw, submits, spec=False) == off


def test_int8_decode_on_checkpoint_is_refused(w8, f32):
    """The finding: the reference's logits with ``int8_decode`` on its
    int8 checkpoint drop the scales (cross-entropy off by orders of
    magnitude against the same checkpoint with ``int8_decode`` off); the
    port refuses the combination — setting the flag on a quantized
    block, quantizing a block that has it, and loading an int8
    checkpoint into one — with a ValueError that says why."""
    from veles_tpu.serving.kv_quality import _mean_ce
    from veles_tpu.serving.kv_quality import (
        teacher_forced_logits as jax_logits)
    from veles_tpu_torch.convert import params_from_numpy
    from veles_tpu_torch.models.transformer import TransformerBlock
    jfw, chain, pattern = w8["jfw"], w8["chain"], w8["pattern"]
    seq = (pattern * 8)[:64]
    targets = numpy.asarray(seq[1:49])
    blocks = [u for u in jfw if hasattr(u, "init_cache")]
    right = _mean_ce(jax_logits(jfw, seq, 16)[:48], targets)
    for u in blocks:
        u.int8_decode = True
    try:
        dropped = _mean_ce(jax_logits(jfw, seq, 16)[:48], targets)
    finally:
        for u in blocks:
            u.int8_decode = False
    assert right < 1.0 and dropped > 100 * right
    with pytest.raises(ValueError, match="scale"):
        chain[1].int8_decode = True
    assert not chain[1].int8_decode
    fresh = TransformerBlock(heads=2, int8_decode=True, device="cpu",
                             dtype="float32")
    fresh.load_params(_f32_params(w8))
    with pytest.raises(ValueError, match="int8_decode"):
        fresh.quantize_weights()
    with pytest.raises(ValueError, match="int8_decode"):
        params_from_numpy(_spec(jfw, int8_decode=True), jax_params(jfw),
                          device="cpu", dtype="float32")


def _f32_params(w8):
    """A block's f32 weights (the dequantized checkpoint), for a block
    built with ``int8_decode``."""
    from veles_tpu_torch.models.transformer import INT8_WEIGHTS
    u = w8["chain"][1]
    out = {}
    for n in type(u).PARAMS:
        t = u.params[n]
        if n in INT8_WEIGHTS:
            t = t.to(torch.float32) * u.params[n + "_scale"]
        out[n] = t.numpy()
    return out
