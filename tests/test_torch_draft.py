"""The model drafter of the PyTorch port (``serving/draft.py``, the
engine's hidden-state lane, the scheduler's drafter arbitration and its
verify width ladder) held against the JAX package on the CPU, on the
suite's trained chain (``spec_trained_chain``) and trained head
(``spec_trained_head``) carried into the port.

Tolerances: head logits within 1e-5 of a float64 evaluation of the same
parameters, drafts exact; the first training steps' losses and the
trained parameters within 1e-5 of the reference's (f32 both sides);
token streams, drafted and accepted counts by drafter, and the ladder's
widths exact."""

import io
import pickle
import time
import types

import numpy
import pytest
import torch

from veles_tpu.config import root

from tests.test_torch_serving import _spec
from tests.test_torch_transformer import port_chain

pytestmark = pytest.mark.torch_port

WINDOW, BLOCK = 64, 4


@pytest.fixture
def f32():
    saved = root.common.precision.get("compute_dtype", "bfloat16")
    root.common.precision.compute_dtype = "float32"
    yield
    root.common.precision.compute_dtype = saved


@pytest.fixture(scope="module")
def trained(spec_trained_chain):
    fw, pattern = spec_trained_chain
    return fw, pattern, port_chain(_spec(fw), fw)


def _port_head(jax_head):
    """The port's head holding the JAX head's state."""
    from veles_tpu_torch.serving import MedusaDraftHead
    head = MedusaDraftHead.__new__(MedusaDraftHead)
    head.__setstate__(jax_head.__getstate__())
    return head


class _Retarget(pickle.Unpickler):
    """Unpickles a head pickled by one package as the other's class."""

    def __init__(self, data, cls):
        super().__init__(io.BytesIO(data))
        self.cls = cls

    def find_class(self, module, name):
        if name == "MedusaDraftHead":
            return self.cls
        return super().find_class(module, name)


def _logits64(params, h):
    p = {n: numpy.asarray(a, numpy.float64) for n, a in params.items()}
    pre = numpy.einsum("bd,kde->bke", h, p["w1"]) + p["b1"]
    z = h[:, None, :] + pre / (1.0 + numpy.exp(-pre))
    return numpy.einsum("bke,kev->bkv", z, p["w2"]) + p["b2"]


# -- the head ------------------------------------------------------------------

def test_propose_matches_reference(f32, trained, spec_trained_head):
    """Drafts equal the JAX head's on every batch size (both pad to a
    power of two), logits within 1e-5 of float64; ``from_chain`` sizes
    the head as the reference's does; k < 1 is refused by both."""
    from veles_tpu.serving import MedusaDraftHead as JaxHead
    from veles_tpu_torch.serving import MedusaDraftHead, draft_supported
    from veles_tpu_torch.serving.draft import _logits
    fw, _, chain = trained
    jhead, _ = spec_trained_head
    head = _port_head(jhead)
    assert draft_supported(chain)
    fresh = MedusaDraftHead.from_chain(chain, 4, seed=0)
    want = JaxHead.from_chain(fw, 4, seed=0)
    assert (fresh.k, fresh.d_model, fresh.vocab) == (4, 16, 12)
    for n in ("w1", "b1", "w2", "b2"):
        assert numpy.array_equal(fresh.params[n], want.params[n])
    rng = numpy.random.RandomState(0)
    for b in (1, 3, 4, 5):
        hid = rng.randn(b, 16).astype(numpy.float32)
        got = head.propose(torch.from_numpy(hid))
        assert got.dtype == numpy.int32 and got.shape == (b, 4)
        assert numpy.array_equal(got, jhead.propose(hid))
        p = {n: torch.from_numpy(a) for n, a in head.params.items()}
        lg = _logits(p, torch.from_numpy(hid)).numpy()
        numpy.testing.assert_allclose(
            lg, _logits64(head.params, hid.astype(numpy.float64)),
            rtol=1e-5, atol=1e-5)
    for cls in (JaxHead, MedusaDraftHead):
        with pytest.raises(ValueError):
            cls(0, 8, 8)


def test_training_matches_reference(f32, trained):
    """The first training steps' losses and the trained parameters
    equal the reference trainer's within 1e-5 (the same windows from
    ``RandomState(seed)``, SGD with momentum on the heads only), and
    the chain stays frozen."""
    from veles_tpu.serving import MedusaDraftHead as JaxHead
    from veles_tpu_torch.serving import MedusaDraftHead
    fw, pattern, chain = trained
    corpus = numpy.asarray((pattern * 20)[:120])
    before = {n: t.clone() for n, t in chain[1].params.items()}
    want = JaxHead.from_chain(fw, 3, seed=1)
    got = MedusaDraftHead.from_chain(chain, 3, seed=1)
    kw = dict(steps=6, batch=4, window=16, lr=0.1, momentum=0.9, seed=5)
    want_losses = want.train(fw, corpus, **kw)
    got_losses = got.train(chain, corpus, **kw)
    numpy.testing.assert_allclose(got_losses, want_losses, rtol=1e-5,
                                  atol=1e-5)
    assert got_losses[-1] < got_losses[0]
    for n in ("w1", "b1", "w2", "b2"):
        numpy.testing.assert_allclose(got.params[n], want.params[n],
                                      rtol=1e-5, atol=1e-5)
    for n, t in chain[1].params.items():
        assert torch.equal(t, before[n])
    with pytest.raises(ValueError):
        got.train(chain, corpus[:10], window=16)


def test_pickle_crosses_packages(f32, spec_trained_head):
    """A head pickled by either package loads as the other's class and
    drafts what the original drafts."""
    from veles_tpu.serving import MedusaDraftHead as JaxHead
    from veles_tpu_torch.serving import MedusaDraftHead
    jhead, _ = spec_trained_head
    hid = numpy.random.RandomState(1).randn(3, 16).astype(numpy.float32)
    port = _Retarget(pickle.dumps(jhead), MedusaDraftHead).load()
    assert isinstance(port, MedusaDraftHead)
    assert numpy.array_equal(port.propose(hid), jhead.propose(hid))
    back = _Retarget(pickle.dumps(port), JaxHead).load()
    assert isinstance(back, JaxHead)
    assert numpy.array_equal(back.propose(hid), jhead.propose(hid))
    twin = pickle.loads(pickle.dumps(port))
    assert numpy.array_equal(twin.propose(hid), port.propose(hid))


# -- the hidden-state lane -----------------------------------------------------

def test_hidden_lane_matches_reference(f32, trained):
    """``want_hidden`` returns the final unit's f32 input, [B, d] from a
    decode step and [B, K1, d] from a verify pass, equal to the JAX
    lane's within 1e-5; the tokens are those the step returns without
    it."""
    from veles_tpu.serving import PagedKVCache as JaxCache
    from veles_tpu.serving.engine import (
        paged_decode_step as jax_decode, verify_step_paged as jax_verify)
    from veles_tpu_torch.serving import PagedKVCache
    from veles_tpu_torch.serving.engine import (
        hidden_supported, paged_decode_step, verify_step_paged)
    fw, _, chain = trained
    assert hidden_supported(chain) and not hidden_supported(chain[:1])
    rng = numpy.random.default_rng(3)
    b, k1 = 2, 3
    toks = rng.integers(0, 12, (b, 1)).astype(numpy.int32)
    vtoks = rng.integers(0, 12, (b, k1)).astype(numpy.int32)
    pos = numpy.asarray([5, 2], numpy.int32)
    tables = numpy.asarray([[1, 2, 3, 0], [4, 5, 0, 0]], numpy.int32)
    zf = numpy.zeros((b,), numpy.float32)
    zi = numpy.zeros((b,), numpy.int32)
    seeds = numpy.asarray([0, 9], numpy.uint32)
    lens = numpy.asarray([3, 2], numpy.int32)
    jc = JaxCache(fw, 2, WINDOW, block_size=BLOCK, kv_blocks=8)
    tc = PagedKVCache(chain, 2, WINDOW, block_size=BLOCK, kv_blocks=8)
    want_t, want_h = jax_decode(fw, jc, toks, pos, tables, zf, zi, seeds,
                                zi, want_hidden=True)
    got_t, got_h = paged_decode_step(chain, tc, toks, pos, tables, zf, zi,
                                     seeds, zi, want_hidden=True)
    assert got_h.shape == (b, 16) and got_h.dtype == torch.float32
    numpy.testing.assert_allclose(got_h.numpy(), numpy.asarray(want_h),
                                  rtol=1e-5, atol=1e-5)
    assert got_t.tolist() == numpy.asarray(want_t).tolist()
    want_t, want_h = jax_verify(fw, jc, vtoks, pos + 1, lens, tables, zf,
                                zi, seeds, zi, want_hidden=True)
    got_t, got_h = verify_step_paged(chain, tc, vtoks, pos + 1, lens,
                                     tables, zf, zi, seeds, zi,
                                     want_hidden=True)
    assert got_h.shape == (b, k1, 16)
    for n in range(b):
        numpy.testing.assert_allclose(
            got_h[n, :lens[n]].numpy(),
            numpy.asarray(want_h)[n, :lens[n]], rtol=1e-5, atol=1e-5)
        assert got_t[n, :lens[n]].tolist() \
            == numpy.asarray(want_t)[n, :lens[n]].tolist()


# -- the scheduler -------------------------------------------------------------

def _run(pkg, chain, submits, start_first=False, **kw):
    """Serve ``submits`` (all queued before the loop starts, so both
    packages batch alike) and return (streams, scheduler)."""
    kw.setdefault("warm_buckets", False)
    if pkg == "jax":
        from veles_tpu.serving import InferenceScheduler
    else:
        from veles_tpu_torch.serving import InferenceScheduler
        kw.setdefault("device", "cpu")
    sch = InferenceScheduler(chain, max_slots=3, window=WINDOW, kv="paged",
                             block_size=BLOCK, prefix_cache=False, **kw)
    try:
        futs = [sch.submit(p, steps, **skw) for p, steps, skw in submits]
        sch.start()
        outs = [f.result(240) for f in futs]
        sch.check_kv()
        return outs, sch
    finally:
        sch.close()


@pytest.fixture
def jax_widths(monkeypatch):
    """Records the width K1 of every verify pass the JAX scheduler runs
    (its module's ``verify_step_paged``), by width."""
    import veles_tpu.serving.scheduler as jsched
    seen = {}
    real = jsched.verify_step_paged

    def recorder(forwards, cache, toks, *args, **kw):
        k1 = numpy.asarray(toks).shape[1]
        seen[k1] = seen.get(k1, 0) + 1
        return real(forwards, cache, toks, *args, **kw)

    monkeypatch.setattr(jsched, "verify_step_paged", recorder)
    return seen


def _drafter_counts(sch):
    return {d: tuple(v) for d, v in sch.stats.spec_by_drafter.items()}


@pytest.mark.parametrize("chunk", [0, 8], ids=["oneshot", "chunked"])
def test_model_drafter_matches_reference(f32, trained, spec_trained_head,
                                         jax_widths, chunk):
    """``drafter="model"`` streams equal spec-off and the reference's
    model-drafter streams, greedy and seeded, with the reference's
    drafted and accepted counts by drafter and its verify widths."""
    fw, pattern, chain = trained
    jhead, _ = spec_trained_head
    head = _port_head(jhead)
    prompts = [(pattern * 3)[:18], [2, 9] * 6, [3, 1, 4, 1]]
    submits = [(p, 14, dict(seed=0)) for p in prompts]
    submits += [(p, 10, dict(temperature=0.9, top_k=5, seed=31 + i))
                for i, p in enumerate(prompts)]
    kw = dict(prefill_chunk=chunk, spec=True, spec_k=4, drafter="model")
    want, jsch = _run("jax", fw, submits, draft_head=jhead, **kw)
    got, sch = _run("port", chain, submits, draft_head=head, **kw)
    off, plain = _run("port", chain, submits, prefill_chunk=chunk,
                      spec=False)
    assert got == want == off
    assert sch.drafter == "model" and jsch.drafter == "model"
    counts = _drafter_counts(sch)
    assert counts == _drafter_counts(jsch)
    assert counts["model"][1] > 0
    snap, jsnap = sch.metrics(), jsch.metrics()
    for key in ("drafter", "spec_drafted_tokens", "spec_accepted_tokens",
                "spec_accept_rate_by_drafter", "spec_draft_k_min_seen"):
        assert snap[key] == jsnap[key], key
    assert sch.verify_steps + sch.decode_steps < plain.decode_steps
    assert sch.verify_widths == jax_widths


def test_verify_width_ladder(f32, trained, jax_widths):
    """With a draft head the verify pass runs at one more than the
    power-of-two bucket of the widest drafting slot's ``draft_k``: an
    untrained head (it drafts token 0) rejects, the slot's ``draft_k``
    shrinks, and the passes step down the ladder from 5 as the
    reference's do, each width giving the spec-off stream; without a
    head every pass is ``spec_k + 1`` wide."""
    from veles_tpu.serving import MedusaDraftHead as JaxHead
    from veles_tpu_torch.serving import MedusaDraftHead
    fw, pattern, chain = trained
    garbage = MedusaDraftHead.from_chain(chain, 4, seed=3)
    submits = [((pattern * 2)[:10], 14, dict(seed=0))]
    off, _ = _run("port", chain, submits, prefill_chunk=0, spec=False)
    got, sch = _run("port", chain, submits, prefill_chunk=0, spec=True,
                    spec_k=4, drafter="model", draft_head=garbage)
    want, _ = _run("jax", fw, submits, prefill_chunk=0, spec=True,
                   spec_k=4, drafter="model",
                   draft_head=JaxHead.from_chain(fw, 4, seed=3))
    assert got == off == want
    assert sch.verify_widths == jax_widths
    assert len(sch.verify_widths) > 1 and max(sch.verify_widths) == 5
    snap = sch.metrics()
    assert snap["spec_draft_k_min_seen"] < 4
    assert snap["spec_accept_rate_by_drafter"]["model"] < 0.5
    _, ngram = _run("port", chain, submits, prefill_chunk=0, spec=True,
                    spec_k=4)
    assert set(ngram.verify_widths) == {5}


def test_adapt_draft_k_by_drafter(f32, trained):
    """The reference's controller sequence: rejection walks draft_k down
    to draft_k_min, one perfect verify does not regrow it, sustained
    acceptance does; the EMAs are per drafter."""
    from veles_tpu_torch.serving import InferenceScheduler
    _, _, chain = trained
    sch = InferenceScheduler(chain, max_slots=1, window=WINDOW, spec=True,
                             spec_k=8, draft_k_min=1, device="cpu")
    req = types.SimpleNamespace(accept_ema={}, draft_k=8)
    for want in (4, 2, 1, 1):
        sch._adapt_draft_k(req, req.draft_k, 0, "model")
        assert req.draft_k == want
    sch._adapt_draft_k(req, 1, 1, "model")
    assert req.draft_k == 1
    for _ in range(6):
        sch._adapt_draft_k(req, req.draft_k, req.draft_k, "model")
    assert req.draft_k == 8
    assert "ngram" not in req.accept_ema
    snap = sch.stats.snapshot()
    assert (snap["spec_draft_k_min_seen"], snap["spec_draft_k_last"]) \
        == (1, 8)


def test_model_drafter_preempt_resume(f32, trained, spec_trained_head):
    """A preempt→resume with the model drafter leaves the streams those
    of an uninterrupted run (the hidden is dropped with the slot; the
    first step after the resume drafts by n-gram)."""
    from veles_tpu_torch import faults
    from veles_tpu_torch.serving import InferenceScheduler
    _, pattern, chain = trained
    head = _port_head(spec_trained_head[0])
    prompts = [((pattern * 2)[:7], dict(seed=0)),
               ([7, 2] * 4, dict(temperature=0.9, top_k=5, seed=123))]

    def run(preempt):
        sch = InferenceScheduler(chain, max_slots=2, window=WINDOW,
                                 block_size=BLOCK, prefill_chunk=4,
                                 spec=True, spec_k=4, drafter="model",
                                 draft_head=head, device="cpu").start()
        try:
            if preempt:
                # slow steps keep both requests decoding until the
                # preemption lands
                faults.inject("serving.scheduler.step", "delay", arg=0.05)
            futs = [sch.submit(p, 20, **kw) for p, kw in prompts]
            if preempt:
                deadline = time.monotonic() + 60
                while sch.metrics()["slot_busy_steps"] < 4:
                    assert time.monotonic() < deadline
                    time.sleep(0.01)
                sch.request_preempt()
            outs = [f.result(240) for f in futs]
            sch.check_kv()
            return outs, sch
        finally:
            faults.clear()
            sch.close()

    base, _ = run(False)
    got, sch = run(True)
    assert sch.preempts >= 1 and sch.preempt_resumes >= 1
    assert got == base


def test_drafter_fallbacks_and_refusals(f32, trained):
    """Without a head, ``drafter="model"`` drafts by n-gram, as the
    reference's does; an unknown drafter and a head of another size are
    refused by both packages."""
    from veles_tpu.serving import (
        InferenceScheduler as JaxScheduler, MedusaDraftHead as JaxHead)
    from veles_tpu_torch.serving import InferenceScheduler, MedusaDraftHead
    fw, pattern, chain = trained
    submits = [((pattern * 2)[:8], 8, dict(seed=0))]
    got, sch = _run("port", chain, submits, prefill_chunk=0, spec=True,
                    spec_k=4, drafter="model")
    want, jsch = _run("jax", fw, submits, prefill_chunk=0, spec=True,
                      spec_k=4, drafter="model")
    assert got == want and sch.drafter == jsch.drafter == "ngram"
    assert "model" not in sch.metrics()["spec_accept_rate_by_drafter"]
    for cls, c in ((JaxScheduler, fw), (InferenceScheduler, chain)):
        extra = {} if cls is JaxScheduler else {"device": "cpu"}
        with pytest.raises(ValueError):
            cls(c, max_slots=2, window=WINDOW, spec=True, drafter="banana",
                warm_buckets=False, **extra)
    for cls, head_cls, c in ((JaxScheduler, JaxHead, fw),
                             (InferenceScheduler, MedusaDraftHead, chain)):
        extra = {} if cls is JaxScheduler else {"device": "cpu"}
        with pytest.raises(ValueError):
            cls(c, max_slots=2, window=WINDOW, spec=True, spec_k=4,
                drafter="model", draft_head=head_cls(4, 8, 12),
                warm_buckets=False, **extra)
