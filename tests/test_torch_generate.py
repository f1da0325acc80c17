"""Decoding outside the scheduler in the PyTorch port
(``models/generate.py``, ``Embedding.apply_step``,
``TransformerBlock.apply_step``/``apply_step_slots``) held against the
JAX package on the CPU, from the same weights.

Oracles: ``tests/test_lm.py::test_generate_*`` and
``tests/test_serving.py::test_slot_step_matches_scalar_step``.

Tolerances: token streams are exact (greedy and seeded, in all four
decode forms, with ``top_k`` and ``stop_token``, and the beams); f32
values (the steps' outputs and caches, the beam scores) within 1e-5.
Greedy and seeded streams come from the suite's briefly trained
chain (``spec_trained_chain``), whose confident logits keep the argmax
and the Gumbel draws away from near-ties."""

import numpy
import pytest
import torch

import jax
import jax.numpy as jnp

from veles_tpu.config import root

from tests.test_torch_serving import _spec
from tests.test_torch_transformer import (  # noqa: F401 (chains: fixture)
    TOL, chains, jax_chain, jax_params, lm_spec, port_chain)

pytestmark = pytest.mark.torch_port

STEPS = 8


@pytest.fixture
def f32():
    saved = root.common.precision.get("compute_dtype", "bfloat16")
    root.common.precision.compute_dtype = "float32"
    yield
    root.common.precision.compute_dtype = saved


@pytest.fixture(scope="module")
def trained(spec_trained_chain):
    """The suite's trained chain, its port copy and its pattern."""
    fw, pattern = spec_trained_chain
    return fw, port_chain(_spec(fw), fw), pattern


def _jparams(fw, i):
    return {n: jnp.asarray(a) for n, a in jax_params(fw)[i].items()}


def _prompts(pattern):
    """Three rows of 6 over the pattern; row 1 is a 3-token prompt and
    row 2 a 1-token one under ``prompt_lens``."""
    tiled = pattern * 4
    return numpy.asarray([tiled[o:o + 6] for o in (0, 3, 5)], numpy.int32)


# -- the single-position steps -------------------------------------------------

def test_embedding_apply_step_matches_reference(f32, chains):
    spec, fw = chains
    emb = port_chain(spec, fw)[0]
    params = _jparams(fw, 0)
    toks = numpy.asarray([[3], [7], [60]], numpy.int32)
    want = numpy.asarray(fw[0].apply_step(params, jnp.asarray(toks), 5))
    got = emb.apply_step(torch.as_tensor(toks), 5)
    numpy.testing.assert_allclose(got.numpy(), want, **TOL)
    slots = emb.apply_step_slots(torch.as_tensor(toks),
                                 torch.as_tensor([5, 5, 5]))
    numpy.testing.assert_array_equal(slots.numpy(), got.numpy())


def _block_cache(rng, b, length, filled):
    """K/V caches [b, length, 32] whose first ``filled`` rows hold
    values (the rest zero, as a prefill leaves them)."""
    out = {}
    for n in ("k", "v"):
        a = numpy.zeros((b, length, 32), numpy.float32)
        a[:, :filled] = rng.standard_normal((b, filled, 32))
        out[n] = a
    return out


def test_block_apply_step_matches_reference(f32, chains):
    """``apply_step`` at position 9 of a 16-row cache: output and both
    caches against the JAX block's."""
    spec, fw = chains
    blk = port_chain(spec, fw)[1]
    rng = numpy.random.default_rng(11)
    cache = _block_cache(rng, 3, 16, 9)
    x = (rng.standard_normal((3, 1, 32)) * 0.5).astype(numpy.float32)
    jy, jc = fw[1].apply_step(_jparams(fw, 1), jnp.asarray(x), 9,
                              {n: jnp.asarray(a) for n, a in cache.items()})
    ty, tc = blk.apply_step(torch.as_tensor(x), 9,
                            {n: torch.as_tensor(a.copy())
                             for n, a in cache.items()})
    numpy.testing.assert_allclose(ty.numpy(), numpy.asarray(jy), **TOL)
    for n in ("k", "v"):
        numpy.testing.assert_allclose(tc[n].numpy(), numpy.asarray(jc[n]),
                                      err_msg=n, **TOL)


def test_block_apply_step_slots_matches_reference(f32, chains):
    """``apply_step_slots`` with each row at its own position against
    the JAX block's; with every row at one position it equals
    ``apply_step`` (the reference's scalar-step oracle)."""
    spec, fw = chains
    blk = port_chain(spec, fw)[1]
    rng = numpy.random.default_rng(12)
    cache = _block_cache(rng, 3, 16, 12)
    x = (rng.standard_normal((3, 1, 32)) * 0.5).astype(numpy.float32)
    pos = numpy.asarray([12, 4, 0], numpy.int32)
    jy, jc = fw[1].apply_step_slots(
        _jparams(fw, 1), jnp.asarray(x), jnp.asarray(pos),
        {n: jnp.asarray(a) for n, a in cache.items()})
    ty, tc = blk.apply_step_slots(
        torch.as_tensor(x), torch.as_tensor(pos),
        {n: torch.as_tensor(a.copy()) for n, a in cache.items()})
    numpy.testing.assert_allclose(ty.numpy(), numpy.asarray(jy), **TOL)
    for n in ("k", "v"):
        numpy.testing.assert_allclose(tc[n].numpy(), numpy.asarray(jc[n]),
                                      err_msg=n, **TOL)
    same = {n: torch.as_tensor(a.copy()) for n, a in cache.items()}
    sy, sc = blk.apply_step_slots(torch.as_tensor(x),
                                  torch.as_tensor([7, 7, 7]), same)
    one = {n: torch.as_tensor(a.copy()) for n, a in cache.items()}
    oy, oc = blk.apply_step(torch.as_tensor(x), 7, one)
    numpy.testing.assert_allclose(sy.numpy(), oy.numpy(), atol=1e-6)
    for n in ("k", "v"):
        numpy.testing.assert_array_equal(sc[n].numpy(), oc[n].numpy())


def test_dense_steps_never_take_the_int8_path(f32, chains):
    """With ``int8_decode`` set, the dense steps still run the policy
    matmul (the reference's ``_attn_out`` passes no ``w8``)."""
    spec, fw = chains
    plain = port_chain(spec, fw)[1]
    w8 = port_chain(lm_spec(int8_decode=True), fw)[1]
    assert w8.int8_decode
    rng = numpy.random.default_rng(13)
    cache = _block_cache(rng, 2, 8, 5)
    x = torch.as_tensor(rng.standard_normal((2, 1, 32)).astype(
        numpy.float32))
    outs = [u.apply_step(x, 5, {n: torch.as_tensor(a.copy())
                                for n, a in cache.items()})[0]
            for u in (plain, w8)]
    numpy.testing.assert_array_equal(outs[0].numpy(), outs[1].numpy())
    assert ("w8", "wo") not in w8._derived


# -- generate ------------------------------------------------------------------

#: (kv_cache, variable-length, sampler) — every decode form greedy and
#: seeded; top_k on the kv forms and the var-length rescan
FORMS = [(kv, var, smp) for kv in (False, True) for var in (False, True)
         for smp in ("greedy", "sampled")]
FORMS += [(True, False, "top_k"), (True, True, "top_k"),
          (False, True, "top_k")]

SAMPLERS = {"greedy": {}, "sampled": dict(temperature=1.5, seed=7),
            "top_k": dict(temperature=1.5, top_k=3, seed=9)}


def _both_generate(fw, chain, prompt, steps, sampler, **kw):
    from veles_tpu.models.generate import generate as jax_generate
    from veles_tpu_torch.models.generate import generate
    from veles_tpu_torch.prng import threefry
    kw = dict(kw, **SAMPLERS[sampler])
    seed = kw.pop("seed", None)
    want = numpy.asarray(jax_generate(
        fw, prompt, steps,
        key=None if seed is None else jax.random.key(seed), **kw))
    got = generate(chain, prompt, steps,
                   key=None if seed is None else threefry.key(seed), **kw)
    return got, want


@pytest.mark.parametrize(
    "kv,var,sampler", FORMS,
    ids=["%s-%s-%s" % ("kv" if kv else "rescan",
                       "varlen" if var else "uniform", s)
         for kv, var, s in FORMS])
def test_generate_matches_reference(f32, trained, kv, var, sampler):
    fw, chain, pattern = trained
    prompt = _prompts(pattern)
    lens = [6, 3, 1] if var else None
    got, want = _both_generate(fw, chain, prompt, STEPS, sampler,
                               kv_cache=kv, prompt_lens=lens)
    assert got.dtype == torch.int64 and got.shape == (3, 6 + STEPS)
    assert got.tolist() == want.tolist()


@pytest.mark.parametrize("kv,var", [(False, False), (True, False),
                                    (True, True)],
                         ids=["rescan", "kv", "kv-varlen"])
def test_generate_stop_token_matches_reference(f32, trained, kv, var):
    """A generated stop token freezes its row; the same token inside a
    prompt does not."""
    fw, chain, pattern = trained
    prompt = _prompts(pattern)
    stop = pattern[(6 + 2) % len(pattern)]
    lens = [6, 3, 1] if var else None
    got, want = _both_generate(fw, chain, prompt, STEPS, "greedy",
                               kv_cache=kv, prompt_lens=lens,
                               stop_token=stop)
    assert got.tolist() == want.tolist()
    row = got[0, 6:].tolist()
    first = row.index(stop)
    assert first < STEPS - 1 and set(row[first:]) == {stop}


def test_generate_forms_agree_in_the_port(f32, trained):
    """Greedy: rescan == kv, and a var-length row equals its own
    single-row decode (the reference's parity claims)."""
    from veles_tpu_torch.models.generate import generate
    _, chain, pattern = trained
    prompt = _prompts(pattern)
    rescan = generate(chain, prompt, STEPS)
    kv = generate(chain, prompt, STEPS, kv_cache=True)
    assert rescan.tolist() == kv.tolist()
    var = generate(chain, prompt, STEPS, kv_cache=True,
                   prompt_lens=[6, 3, 1])
    for n, ln in enumerate((6, 3, 1)):
        alone = generate(chain, prompt[n:n + 1, :ln], STEPS, kv_cache=True)
        assert var[n, :ln + STEPS].tolist() == alone[0].tolist()


def test_generate_beam_matches_reference(f32, trained):
    """Beam 3 tokens equal JAX's, scores within 1e-5, best first; each
    score re-scores by a teacher-forced forward in the port; beam 1 is
    greedy ``generate``."""
    from veles_tpu.models.generate import generate_beam as jax_beam
    from veles_tpu_torch.models.generate import (
        _chain_logits, generate, generate_beam)
    fw, chain, pattern = trained
    prompt = _prompts(pattern)[:2, :4]
    want_t, want_s = jax_beam(fw, prompt, STEPS, 3)
    got_t, got_s = generate_beam(chain, prompt, STEPS, 3)
    assert got_t.shape == (2, 3, 4 + STEPS) and got_s.shape == (2, 3)
    assert got_t.tolist() == numpy.asarray(want_t).tolist()
    numpy.testing.assert_allclose(got_s.numpy(), numpy.asarray(want_s),
                                  **TOL)
    assert (numpy.diff(got_s.numpy(), axis=1) <= 1e-6).all()
    with torch.no_grad():
        for n in range(2):
            logp = torch.log_softmax(_chain_logits(chain, got_t[n]), -1)
            for j in range(3):
                lp = sum(float(logp[j, t, got_t[n, j, t + 1]])
                         for t in range(3, 3 + STEPS))
                assert abs(lp - float(got_s[n, j])) < 1e-4
    one, _ = generate_beam(chain, prompt, STEPS, 1)
    assert one[:, 0].tolist() == generate(chain, prompt, STEPS,
                                          kv_cache=True).tolist()


def test_beam_ties_rank_as_top_k(f32):
    """A chain whose head is zero ties every candidate: ``jax.lax.top_k``
    keeps the lowest flat indices, and so must the port: every step's
    survivors are beam 0's tokens 0, 1, 2, so the beams share beam 0's
    prefix of token 0 and end in 0, 1, 2."""
    from veles_tpu.models.generate import generate_beam as jax_beam
    from veles_tpu_torch.models.generate import generate_beam
    spec = lm_spec(vocab=16, dim=16, layers=1, heads=2)
    fw = jax_chain(spec, window=16)
    for arr in fw[-1].param_arrays().values():
        arr.mem = numpy.zeros_like(arr.mem)
    chain = port_chain(spec, fw)
    want_t, want_s = jax_beam(fw, [[5, 6]], 3, 3)
    got_t, got_s = generate_beam(chain, [[5, 6]], 3, 3)
    assert got_t.tolist() == numpy.asarray(want_t).tolist()
    assert got_t[0].tolist() == [[5, 6, 0, 0, t] for t in (0, 1, 2)]
    numpy.testing.assert_allclose(got_s.numpy(), numpy.asarray(want_s),
                                  **TOL)


# -- what both packages refuse -------------------------------------------------

def _refusals(trained_fw, chain):
    """(name, JAX call, port call) — each must raise ValueError in both."""
    from veles_tpu.models.generate import (
        generate as jgen, generate_beam as jbeam)
    from veles_tpu_torch.models.generate import generate, generate_beam
    from veles_tpu_torch.prng import threefry
    p = [[1, 2, 3]]
    return [
        ("top_k without temperature",
         lambda: jgen(trained_fw, p, 4, top_k=3),
         lambda: generate(chain, p, 4, top_k=3)),
        ("temperature without a key",
         lambda: jgen(trained_fw, p, 4, temperature=1.0),
         lambda: generate(chain, p, 4, temperature=1.0)),
        ("top_k above vocab",
         lambda: jgen(trained_fw, p, 4, temperature=1.0, top_k=13,
                      key=jax.random.key(0)),
         lambda: generate(chain, p, 4, temperature=1.0, top_k=13,
                          key=threefry.key(0))),
        ("prompt_lens shape",
         lambda: jgen(trained_fw, p, 4, prompt_lens=[1, 2]),
         lambda: generate(chain, p, 4, prompt_lens=[1, 2])),
        ("prompt_lens 0",
         lambda: jgen(trained_fw, p, 4, prompt_lens=[0]),
         lambda: generate(chain, p, 4, prompt_lens=[0])),
        ("prompt_lens past the width",
         lambda: jgen(trained_fw, p, 4, prompt_lens=[4]),
         lambda: generate(chain, p, 4, prompt_lens=[4])),
        ("past the positional table",
         lambda: jgen(trained_fw, p, 62),
         lambda: generate(chain, p, 62)),
        ("beam 0",
         lambda: jbeam(trained_fw, p, 2, 0),
         lambda: generate_beam(chain, p, 2, 0)),
        ("beam above vocab",
         lambda: jbeam(trained_fw, p, 2, 13),
         lambda: generate_beam(chain, p, 2, 13)),
        ("beam past the positional table",
         lambda: jbeam(trained_fw, p, 62, 2),
         lambda: generate_beam(chain, p, 62, 2)),
    ]


def test_validation_errors_match_reference(f32, trained):
    fw, chain, _ = trained
    for name, jcall, tcall in _refusals(fw, chain):
        with pytest.raises(ValueError):
            jcall()
        with pytest.raises(ValueError):
            tcall()
        del name


def test_uncacheable_chains_refused_as_reference(f32):
    """A non-causal block and a sequence-mixing unit without a step
    (multi-head attention): ``kv_cache_eligible`` is False in both
    packages, the kv path and beam search raise ValueError in both,
    and the rescan path still decodes the non-causal chain alike."""
    from veles_tpu.models.generate import (
        generate as jgen, generate_beam as jbeam,
        kv_cache_eligible as jeligible)
    from veles_tpu_torch.models.generate import (
        generate, generate_beam, kv_cache_eligible)
    base = lm_spec(vocab=16, dim=16, layers=1, heads=2)
    specs = {"non-causal": base[:1] + [dict(base[1], causal=False)]
             + base[2:],
             "attention": base[:1] + [{"type": "attention", "heads": 2,
                                        "causal": True}] + base[2:]}
    for name, spec in specs.items():
        fw = jax_chain(spec, window=16)
        chain = port_chain(spec, fw)
        assert not jeligible(fw) and not kv_cache_eligible(chain), name
        for call in (lambda: jgen(fw, [[1, 2]], 3, kv_cache=True),
                     lambda: generate(chain, [[1, 2]], 3, kv_cache=True),
                     lambda: jbeam(fw, [[1, 2]], 3, 2),
                     lambda: generate_beam(chain, [[1, 2]], 3, 2)):
            with pytest.raises(ValueError):
                call()
        want = numpy.asarray(jgen(fw, [[1, 2], [3, 4]], 3))
        assert generate(chain, [[1, 2], [3, 4]], 3).tolist() \
            == want.tolist(), name


def test_generate_records_no_graph(f32, trained):
    """A chain whose parameters require grad (fresh from training)
    decodes without recording a graph (fault C3's pattern)."""
    from veles_tpu_torch.models.generate import generate, generate_beam
    fw, _, pattern = trained
    chain = port_chain(_spec(fw), fw)
    for u in chain:
        for t in u.params.values():
            t.requires_grad_(True)
    prompt = _prompts(pattern)[:1]
    for out in (generate(chain, prompt, 3),
                generate(chain, prompt, 3, kv_cache=True),
                generate_beam(chain, prompt, 3, 2)[1]):
        assert not out.requires_grad and out.grad_fn is None
