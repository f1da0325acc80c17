"""LM training in the PyTorch port held against the JAX package on the
CPU, on the same weights and minibatches.

- Modules: ``mha_apply`` (the ``MultiHeadAttention`` unit) and
  ``TransformerBlock.apply`` forward and parameter gradients with the
  FlashAttention core (``attn_impl="pallas"``: the JAX kernels in
  interpret mode, the port's plain versions); the losses and metrics
  of the evaluators; the four solvers; the five schedules; the
  loader's shuffle and span schedule; ``markov_corpus``.
- Trainer: ``GradientDescent`` built as ``bench.py``'s ``bench_lm``
  builds it (d=32, 2 blocks of 2 heads, seq 16, vocab 32, f32) takes
  one validation minibatch and 3 train steps on both sides (with
  per-layer learning-rate and momentum overrides) — SGD with
  momentum, and Adam under a cosine schedule continued from a state
  carried over with ``convert.set_trainer_state`` — plus a
  ``skip_step`` run in which one minibatch turns non-finite.  Losses,
  ``n_err``, the health vector, ``epoch_acc`` and the parameters must
  agree.

Tolerances (float32 throughout; the frameworks sum in other orders):
2e-5 on forward outputs, losses and parameters, 1e-4 on gradients, the
solvers' states and the health vector's norms."""

import jax
import jax.numpy as jnp
import numpy
import pytest
import torch

from veles_tpu.config import root

from tests.test_torch_transformer import jax_params

pytestmark = pytest.mark.torch_port

OUT, GRAD = 2e-5, 1e-4
VOCAB, DIM, BLOCKS, HEADS, SEQ, MB = 32, 32, 2, 2, 16, 4


@pytest.fixture
def f32():
    saved = root.common.precision.get("compute_dtype", "bfloat16")
    root.common.precision.compute_dtype = "float32"
    yield
    root.common.precision.compute_dtype = saved


def _numpy_device():
    from veles_tpu.backends import Device
    return Device(backend="numpy")


def _close(got, want, tol):
    got = got.detach().numpy() if torch.is_tensor(got) else got
    numpy.testing.assert_allclose(numpy.asarray(got, numpy.float64),
                                  numpy.asarray(want, numpy.float64),
                                  rtol=tol, atol=tol)


# -- modules ------------------------------------------------------------------

@pytest.mark.parametrize("kind,causal", [("attention", False),
                                         ("transformer_block", True)])
def test_unit_forward_and_param_gradients(f32, kind, causal):
    from veles_tpu.accelerated_units import AcceleratedWorkflow
    from veles_tpu.memory import Array
    from veles_tpu.models.standard import make_forwards as jax_make
    from veles_tpu_torch.models.standard import make_forwards
    rng = numpy.random.default_rng(3)
    x = rng.standard_normal((2, 13, DIM)).astype(numpy.float32)
    g = rng.standard_normal((2, 13, DIM)).astype(numpy.float32)
    spec = [{"type": kind, "heads": HEADS, "causal": causal,
             "attn_impl": "pallas"}]
    (ju,) = jax_make(AcceleratedWorkflow(None, name="t"), Array(x), spec)
    ju.initialize(device=_numpy_device())
    params = {n: jnp.asarray(a.mem) for n, a in ju.param_arrays().items()}

    def f(p):
        return jnp.sum(ju.apply(p, jnp.asarray(x)) * g)

    want_y = ju.apply(params, jnp.asarray(x))
    want_g = jax.grad(f)(params)
    (pu,) = make_forwards(spec, device="cpu", dtype="float32")
    pu.load_params({n: numpy.asarray(a) for n, a in params.items()})
    for t in pu.params.values():
        t.requires_grad_(True)
    y = pu.apply(torch.as_tensor(x))
    _close(y, want_y, OUT)
    (y * torch.as_tensor(g)).sum().backward()
    for n, t in pu.params.items():
        _close(t.grad, want_g[n], GRAD)


def test_derived_cache_follows_training(f32):
    """A cast cached while serving is not served once the weights train
    (it would hold no graph and the old values)."""
    from veles_tpu_torch.models.transformer import TokenProjection
    u = TokenProjection(vocab=5, device="cpu", dtype="bfloat16")
    u.load_params({"weights": numpy.ones((3, 5), numpy.float32),
                   "bias": numpy.zeros(5, numpy.float32)})
    x = torch.ones((1, 2, 3))
    assert float(u.apply(x).sum()) == 30.0            # cached cast
    u.params["weights"].requires_grad_(True)
    y = u.apply(x)
    y.sum().backward()                                # a graph reached it
    assert float(u.params["weights"].grad.sum()) == 30.0
    with torch.no_grad():
        u.params["weights"].mul_(2.0)                 # an in-place update
        assert float(u.apply(x).sum()) == 60.0
    u.apply(x).sum().backward()                       # a second backward
    u.params["weights"].requires_grad_(False)
    with torch.no_grad():
        u.params["weights"].mul_(0.5)
    assert float(u.apply(x).sum()) == 30.0


def test_evaluator_losses_and_metrics():
    from veles_tpu.accelerated_units import AcceleratedWorkflow
    from veles_tpu.models.evaluator import (
        EvaluatorNextToken as JaxNext, EvaluatorSoftmax as JaxSoftmax,
        masked_ce_from_logits as jax_ce)
    from veles_tpu_torch.models.evaluator import (
        EvaluatorNextToken, EvaluatorSoftmax, masked_ce_from_logits)
    rng = numpy.random.default_rng(4)
    y = (rng.standard_normal((5, 7, 11)) * 3).astype(numpy.float32)
    toks = rng.integers(0, 11, (5, 7)).astype(numpy.int32)
    labels = toks[:, 0].copy()
    labels[1] = -1                                    # clipped to class 0
    wf = AcceleratedWorkflow(None, name="t")
    jev, pev = JaxNext(wf), EvaluatorNextToken()
    yt, tt = torch.as_tensor(y), torch.as_tensor(toks)
    for size in (5, 3, 0):
        _close(pev.loss(yt, tt, size), jev.loss(jnp.asarray(y), toks,
                                                jnp.int32(size)), OUT)
        assert int(pev.train_metrics(yt, tt, size)) == int(
            jev.train_metrics(jnp.asarray(y), toks, jnp.int32(size)))
        _close(EvaluatorSoftmax.loss_from_logits(
            yt[:, 0], torch.as_tensor(labels), size),
            JaxSoftmax.loss_from_logits(jnp.asarray(y[:, 0]), labels,
                                        jnp.int32(size)), OUT)
        _close(masked_ce_from_logits(yt, tt, size, 7),
               jax_ce(jnp.asarray(y), toks, jnp.int32(size), 7), OUT)
    assert pev.metric_units(tt) == jev.metric_units(toks) == 6
    assert EvaluatorNextToken.TARGET_IS_INPUT and JaxNext.TARGET_IS_INPUT


@pytest.mark.parametrize("name", ["sgd", "adagrad", "adadelta", "adam"])
def test_solvers(name):
    from veles_tpu.models import solvers as jsol
    from veles_tpu_torch.models import solvers as psol
    rng = numpy.random.default_rng(5)
    p0 = rng.standard_normal((4, 6)).astype(numpy.float32)
    grads = rng.standard_normal((3, 4, 6)).astype(numpy.float32)
    hp = {"lr": 0.05, "decay": 0.01, "l1_vs_l2": 0.3, "moment": 0.9}
    js, ps = jsol.get_solver(name), psol.get_solver(name)
    jp, pp = jnp.asarray(p0), torch.as_tensor(p0)
    jst, pst = js.init(jp), ps.init(pp)
    for g in grads:
        jp, jst = js.update(jp, jnp.asarray(g), jst, hp)
        pp, pst = ps.update(pp, torch.as_tensor(g), pst, hp)
    _close(pp, jp, OUT)
    assert sorted(pst) == sorted(jst)
    for s in jst:
        _close(pst[s], jst[s], GRAD)


@pytest.mark.parametrize("name,kwargs", [
    ("constant", {}), ("step", {"gamma": 0.5, "step_size": 3}),
    ("exp", {"gamma": 0.97}), ("inv", {"gamma": 0.01, "power": 0.75}),
    ("cosine", {"total_steps": 20, "floor": 0.1, "warmup": 4}),
    ("cosine", {"total_steps": 20})])
def test_schedules(name, kwargs):
    from veles_tpu.models.lr_adjust import get_schedule as jax_get
    from veles_tpu_torch.models.lr_adjust import get_schedule
    js, ps = jax_get(name, **kwargs), get_schedule(name, **kwargs)
    for step in (0, 1, 3, 4, 7, 19, 20, 25):
        want = numpy.float32(js(jnp.float32(step)))
        got = numpy.float32(ps(torch.tensor(float(step))))
        assert abs(float(got) - float(want)) <= 1e-6 * max(1.0, abs(want))


def _token_loader(wf, tokens, class_lengths, mb, seed):
    from veles_tpu import prng
    from veles_tpu.loader.fullbatch import FullBatchLoader

    class TokenLoader(FullBatchLoader):
        def load_data(self):
            self.class_lengths[:] = class_lengths
            self.original_data = tokens
            self.original_labels = [0] * len(tokens)

    prng.get("loader").seed(seed)
    loader = TokenLoader(wf, minibatch_size=mb, normalization_type="none")
    loader.span_serving = True
    loader.initialize(device=_numpy_device())
    return loader


def test_loader_span_schedule_matches():
    """The shuffle order and the span schedule over three epochs."""
    from veles_tpu.accelerated_units import AcceleratedWorkflow
    from veles_tpu_torch.loader import FullBatchLoader
    tokens = numpy.arange(23 * 3, dtype=numpy.int32).reshape(23, 3)
    lengths = [2, 5, 16]
    jl = _token_loader(AcceleratedWorkflow(None, name="t"), tokens, lengths,
                       6, 77)
    pl = FullBatchLoader(tokens, None, lengths, minibatch_size=6, seed=77,
                         device="cpu")
    for _ in range(9):
        jl.run()
        assert jl.span_fresh_
        jl.span_fresh_ = False
        idx, sizes, cls = pl.serve_span()
        assert cls == jl.span_class_
        assert numpy.array_equal(idx, jl.span_indices_)
        assert numpy.array_equal(sizes, jl.span_sizes_)
        assert (pl.epoch_number, pl.train_ended) == (
            jl.epoch_number, bool(jl.train_ended))


def test_markov_corpus_identical():
    from veles_tpu.samples.lm import markov_corpus as jax_corpus
    from veles_tpu_torch.samples.lm import markov_corpus
    want = jax_corpus(40, 24, 16, seed=3)
    got = markov_corpus(40, 24, 16, seed=3)
    assert numpy.array_equal(got[0], want[0]) and got[1:] == want[1:]


# -- the trainer --------------------------------------------------------------

def _lm_spec():
    """``bench_lm``'s chain at test width, with per-layer overrides the
    trainer resolves (``hyperparams()``)."""
    from veles_tpu_torch.samples.lm import lm_spec
    spec = lm_spec(VOCAB, DIM, BLOCKS, HEADS, attn_impl="pallas")
    spec[1]["gradient_moment"] = 0.5
    spec[-1]["learning_rate_bias"] = 0.05
    return spec


def _tokens(seed=6, poison=None):
    """4 validation + 12 train sequences; ``poison`` puts token 0 in
    one train sequence and nowhere else (the tests make embedding row 0
    non-finite)."""
    toks = numpy.random.default_rng(seed).integers(
        1, VOCAB, (16, SEQ)).astype(numpy.int32)
    if poison is not None:
        toks[poison, 5] = 0
    return toks


def _jax_trainer(tokens, seed, **gd_kwargs):
    from veles_tpu.accelerated_units import AcceleratedWorkflow
    from veles_tpu.models.evaluator import EvaluatorNextToken
    from veles_tpu.models.gd import GradientDescent
    from veles_tpu.models.standard import make_forwards
    wf = AcceleratedWorkflow(None, name="torch-train-parity")
    loader = _token_loader(wf, tokens, [0, 4, 12], MB, seed)
    forwards = make_forwards(wf, loader.minibatch_data, _lm_spec())
    dev = _numpy_device()
    for u in forwards:
        u.initialize(device=dev)
    ev = EvaluatorNextToken(wf)
    ev.output = forwards[-1].output
    ev.tokens = loader.minibatch_data
    ev.loader = loader
    ev.initialize(device=dev)
    gd = GradientDescent(wf, forwards=forwards, evaluator=ev, loader=loader,
                         **gd_kwargs)
    gd.initialize(device=dev)
    healths = []
    gd._observe_health = lambda health, force=False: healths.append(
        numpy.asarray(health))
    return loader, forwards, gd, healths


def _jax_span(loader, gd):
    loader.run()
    assert loader.span_fresh_
    gd.run()


def _port_trainer(tokens, params, seed, **gd_kwargs):
    from veles_tpu_torch.convert import params_from_numpy
    from veles_tpu_torch.loader import FullBatchLoader
    from veles_tpu_torch.models.evaluator import EvaluatorNextToken
    from veles_tpu_torch.models.gd import GradientDescent
    chain = params_from_numpy(_lm_spec(), params, device="cpu",
                              dtype="float32")
    loader = FullBatchLoader(tokens, None, [0, 4, 12], minibatch_size=MB,
                             seed=seed, device="cpu")
    return loader, chain, GradientDescent(chain, EvaluatorNextToken(),
                                          **gd_kwargs)


def _compare(jgd, jfw, healths, pgd, pchain, health):
    from veles_tpu_torch.convert import params_to_numpy
    _close(pgd.loss, jgd.loss.map_read().mem, OUT)
    assert int(pgd.n_err) == int(jgd.n_err.map_read().mem)
    _close(pgd.epoch_acc, jgd.epoch_acc.map_read().mem, OUT)
    _close(health, healths[-1], GRAD)
    got, want = params_to_numpy(pchain), jax_params(jfw)
    for i in want:
        for n in want[i]:
            _close(got[i][n], want[i][n], OUT)
    assert pgd.global_step == jgd.global_step


def test_trainer_sgd_momentum_three_steps(f32):
    kw = dict(solver="sgd", learning_rate=0.01, gradient_moment=0.9)
    tokens = _tokens()
    jl, jfw, jgd, healths = _jax_trainer(tokens, 11, **kw)
    pl, pchain, pgd = _port_trainer(tokens, jax_params(jfw), 11, **kw)
    for _ in range(2):                      # the validation span, then train
        _jax_span(jl, jgd)
        pl.serve_span()
        _, _, health = pgd.run_span(pl)
    assert pgd.global_step == 3
    _compare(jgd, jfw, healths, pgd, pchain, health)


def test_trainer_adam_cosine_from_carried_state(f32):
    """Adam under a warm-up + cosine schedule: both trainers take an
    epoch, then the port's state is set from the JAX trainer's
    (``convert.set_trainer_state``) and both take the next epoch."""
    from veles_tpu_torch.convert import set_trainer_state
    kw = dict(solver="adam", learning_rate=3e-3, lr_schedule="cosine",
              lr_schedule_params={"total_steps": 8, "floor": 0.1,
                                  "warmup": 2},
              weights_decay=1e-3)
    tokens = _tokens(8)
    jl, jfw, jgd, healths = _jax_trainer(tokens, 5, **kw)
    for _ in range(2):
        _jax_span(jl, jgd)
    pl, pchain, pgd = _port_trainer(tokens, jax_params(jfw), 5, **kw)
    set_trainer_state(pgd, {i: {n: {s: a.map_read().mem
                                    for s, a in slots.items()}
                                for n, slots in layer.items()}
                            for i, layer in jgd.opt_state.items()},
                      jgd.global_step)
    pgd.epoch_acc.copy_(torch.as_tensor(
        numpy.array(jgd.epoch_acc.map_read().mem)))
    for _ in range(2):                      # advance the port's loader
        pl.serve_span()
    for _ in range(2):
        _jax_span(jl, jgd)
        pl.serve_span()
        _, _, health = pgd.run_span(pl)
    assert pgd.global_step == 6
    _compare(jgd, jfw, healths, pgd, pchain, health)


SKIP_KW = dict(solver="sgd", learning_rate=0.01, gradient_moment=0.9)


def _skip_step_child(out):
    """The JAX half of :func:`test_trainer_skip_step_on_a_nonfinite_
    minibatch`, run by ``tests.test_torch_workflow.run_jax_child``: the
    poisoned first weights, then the loss, ``n_err``, the epoch
    accumulator, the last health vector, the step count and the weights
    after the validation span and the train span."""
    from tests.test_torch_workflow import child_jax_setup, pack_params
    child_jax_setup()
    root.common.precision.compute_dtype = "float32"
    root.common.health.policy = "skip_step"
    jl, jfw, jgd, healths = _jax_trainer(_tokens(9, poison=7), 3, **SKIP_KW)
    emb = jfw[0].weights
    emb.map_write()
    emb.mem[0] = numpy.nan
    emb.unmap()
    arrays = pack_params("init", jax_params(jfw))
    for _ in range(2):
        _jax_span(jl, jgd)
    arrays.update(pack_params("final", jax_params(jfw)))
    numpy.savez(out, loss=numpy.array(jgd.loss.map_read().mem),
                n_err=numpy.array(jgd.n_err.map_read().mem),
                epoch_acc=numpy.array(jgd.epoch_acc.map_read().mem),
                health=numpy.asarray(healths[-1]),
                global_step=numpy.array(jgd.global_step), **arrays)


def test_trainer_skip_step_on_a_nonfinite_minibatch(f32, tmp_path):
    """Embedding row 0 is NaN and token 0 appears in one train sequence:
    that minibatch's loss is NaN, so ``skip_step`` keeps the weights and
    slots it had and books only its size; the other two steps train.
    The JAX side runs in a child process of fixed environment
    (``tests.test_torch_workflow.run_jax_child``): its first weights
    come from the JAX package's process-wide generator."""
    from tests.test_torch_workflow import run_jax_child, unpack_params
    from veles_tpu_torch.convert import params_to_numpy
    rec = run_jax_child(_skip_step_child, tmp_path / "jax.npz")
    pl, pchain, pgd = _port_trainer(_tokens(9, poison=7),
                                    unpack_params(rec, "init"), 3,
                                    health_policy="skip_step", **SKIP_KW)
    for _ in range(2):
        pl.serve_span()
        _, _, health = pgd.run_span(pl)
    assert float(health[3]) == float(rec["health"][3]) == 1.0
    assert pgd.skipped_steps == pgd.nonfinite_steps == 1
    acc = pgd.epoch_acc.numpy()
    assert acc[2, 2] == 12.0 and numpy.isfinite(acc).all()
    _close(pgd.loss, rec["loss"], OUT)
    assert int(pgd.n_err) == int(rec["n_err"])
    _close(pgd.epoch_acc, rec["epoch_acc"], OUT)
    _close(health, rec["health"], GRAD)
    got, want = params_to_numpy(pchain), unpack_params(rec, "final")
    for i in want:
        for n in want[i]:
            _close(got[i][n], want[i][n], OUT)
    assert pgd.global_step == int(rec["global_step"])
