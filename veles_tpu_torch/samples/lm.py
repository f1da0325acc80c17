"""Language-model training — the port of ``veles_tpu/samples/lm.py``
and of the chain ``bench.py``'s ``bench_lm`` trains:

    Embedding → TransformerBlock × N → TokenProjection →
    EvaluatorNextToken → GradientDescent

over a :class:`MarkovLoader` (the procedural order-2 Markov corpus with
its analytic unigram/bigram cross-entropy anchors) or any
``FullBatchLoader`` of token sequences.  :func:`build_lm` wires the
chain, evaluator, trainer and loader (``device=`` defaults to the
card); :func:`train_lm` runs epochs of class spans and returns the
per-epoch validation and train metrics.

    from veles_tpu_torch.samples.lm import build_lm, train_lm
    lm = build_lm(dim=256, heads=2, blocks=2, device="cpu")
    history = train_lm(lm, epochs=4)

:class:`LMWorkflow` is the same training as a ``StandardWorkflow`` (the
reference sample's face; its ``root.lm_tpu`` keys are keyword arguments
of the same names and defaults):

    wf = LMWorkflow(dim=256, heads=2, blocks=2, max_epochs=4)
    wf.initialize(device="cpu"); wf.run()
    wf.decision.history        # one row per epoch, train_lm's keys

Its ``corpus="random"`` trains on uniform random tokens (a port knob:
the Markov corpus's transition tensor is vocab³ floats, beyond a card
at ``bench_lm``'s vocabulary of 32768).  ``text_path`` trains on a
text file instead, through a byte-level BPE vocabulary
(``loader/text.py``): loaded from ``vocab_path`` when that file
exists, else trained on the file to ``vocab_size`` ids (and saved to
``vocab_path`` when one is given); the embedding and logits width is
the vocabulary's true size, and ``seq``/``stride``/``valid_fraction``
shape the windows.
"""

import collections
import os

import numpy

from veles_tpu_torch.convert import init_params
from veles_tpu_torch.loader import TRAIN, VALID, FullBatchLoader
from veles_tpu_torch.loader.base import unit_form
from veles_tpu_torch.models.evaluator import EvaluatorNextToken
from veles_tpu_torch.models.gd import GradientDescent
from veles_tpu_torch.models.standard import StandardWorkflow
from veles_tpu_torch.result_provider import IResultProvider


def markov_corpus(n_seq, seq, vocab, seed=0, temp=1.5):
    """Order-2 Markov token stream: logits[a, b, :] from a planted
    low-rank tensor → transition matrix; returns tokens [n_seq, seq]
    plus the analytic unigram/bigram cross-entropy anchors (nats).
    The JAX package's generator, array for array."""
    rng = numpy.random.default_rng(seed)
    r = 8
    u = rng.standard_normal((vocab, r))
    v = rng.standard_normal((vocab, r))
    w = rng.standard_normal((r, vocab))
    logits = numpy.einsum("ar,br,rc->abc", u, v, w) / numpy.sqrt(r)
    logits *= temp / logits.std()
    p = numpy.exp(logits - logits.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)                    # [V, V, V]
    toks = numpy.empty((n_seq, seq), numpy.int32)
    toks[:, 0] = rng.integers(0, vocab, n_seq)
    toks[:, 1] = rng.integers(0, vocab, n_seq)
    for t in range(2, seq):
        rows = p[toks[:, t - 2], toks[:, t - 1]]     # [n_seq, V]
        cdf = rows.cumsum(axis=1)
        draws = rng.random((n_seq, 1))
        toks[:, t] = (draws > cdf[:, :-1]).sum(axis=1)
    flat = toks.reshape(-1)
    uni = numpy.bincount(flat, minlength=vocab).astype(numpy.float64)
    uni /= uni.sum()
    h_uni = -(uni * numpy.log(numpy.clip(uni, 1e-12, None))).sum()
    h_cond = -(p * numpy.log(numpy.clip(p, 1e-12, None))).sum(-1)
    pairs = toks[:, :-1] * vocab + toks[:, 1:]
    big = numpy.bincount(pairs.reshape(-1),
                         minlength=vocab * vocab).astype(numpy.float64)
    big /= big.sum()
    h_big = (big.reshape(vocab, vocab) * h_cond).sum()
    return toks, float(h_uni), float(h_big)


class MarkovLoader(FullBatchLoader, IResultProvider):
    """Token sequences with planted Markov structure: ``n_valid``
    validation then ``n_train`` train sequences (labels unused — the
    next-token evaluator scores against the input).

    ``MarkovLoader(seq=128, vocab=64, n_train=8192, n_valid=512,
    minibatch_size=128, device=None)`` is ready at once;
    ``MarkovLoader(workflow, seq=..., vocab=..., synthetic_train=...,
    synthetic_valid=..., corpus_seed=0, **loader_kwargs)`` is the unit,
    loading at ``initialize``."""

    def __init__(self, *args, **kwargs):
        if args and unit_form(args[0]):
            self._init_unit(*args, **kwargs)
        else:
            self._init_plain(*args, **kwargs)

    def _init_unit(self, workflow, seq=128, vocab=64, synthetic_train=8192,
                   synthetic_valid=512, corpus_seed=0, **kwargs):
        FullBatchLoader.__init__(self, workflow, **kwargs)
        self.seq, self.vocab = int(seq), int(vocab)
        self.n_train, self.n_valid = int(synthetic_train), \
            int(synthetic_valid)
        self.corpus_seed = int(corpus_seed)

    def _init_plain(self, seq=128, vocab=64, n_train=8192, n_valid=512,
                    minibatch_size=128, device=None):
        self._init_unit(None, seq, vocab, n_train, n_valid,
                        minibatch_size=minibatch_size)
        self.initialize(device=device)

    def load_data(self):
        toks, h_uni, h_big = self.corpus()
        self.class_lengths[:] = [0, self.n_valid, self.n_train]
        self.original_data = toks
        self.original_labels = [0] * len(toks)
        #: a trained model's per-token CE should land between these
        self.h_unigram_ = h_uni
        self.h_bigram_ = h_big

    def corpus(self):
        """(tokens, h_unigram, h_bigram) of this loader's corpus."""
        return markov_corpus(self.n_train + self.n_valid, self.seq,
                             self.vocab, seed=self.corpus_seed)

    def get_metric_values(self):
        return {"h_unigram_nats": self.h_unigram_,
                "h_bigram_nats": self.h_bigram_}


class RandomTokenLoader(MarkovLoader):
    """Uniform random tokens ``default_rng(corpus_seed).integers(0,
    vocab, (n_valid + n_train, seq))`` (no anchors: both are NaN)."""

    def corpus(self):
        toks = numpy.random.default_rng(self.corpus_seed).integers(
            0, self.vocab, (self.n_valid + self.n_train, self.seq))
        return toks.astype(numpy.int32), float("nan"), float("nan")


def lm_spec(vocab, dim, blocks, heads, **block):
    """The layer spec of the LM chain (``samples/lm.py``, ``bench_lm``)."""
    spec = [{"type": "embedding", "vocab": vocab, "dim": dim}]
    spec += [dict({"type": "transformer_block", "heads": heads,
                   "causal": True}, **block) for _ in range(blocks)]
    return spec + [{"type": "token_logits", "vocab": vocab}]


LM = collections.namedtuple("LM", "chain evaluator trainer loader")


def build_lm(vocab=64, dim=128, blocks=2, heads=4, seq=128, loader=None,
             n_train=8192, n_valid=512, minibatch_size=128, solver="adam",
             learning_rate=1e-3, lr_schedule="cosine", lr_schedule_params=None,
             device=None, dtype=None, **trainer_kwargs):
    """The LM workflow's pieces: a chain with fresh weights from seed 0
    (positional table ``seq`` rows), the next-token
    evaluator, the trainer (the sample's defaults: Adam, lr 1e-3,
    cosine over 3800 steps to 0.05 after 150 warm-up steps) and
    ``loader`` (default: a :class:`MarkovLoader` of ``n_train`` +
    ``n_valid`` sequences)."""
    if loader is None:
        loader = MarkovLoader(seq, vocab, n_train, n_valid,
                              minibatch_size=minibatch_size, device=device)
    chain = init_params(lm_spec(vocab, dim, blocks, heads), 0, seq,
                        device=device, dtype=dtype)
    if lr_schedule_params is None and lr_schedule == "cosine":
        lr_schedule_params = {"total_steps": 3800, "floor": 0.05,
                              "warmup": 150}
    evaluator = EvaluatorNextToken()
    trainer = GradientDescent(chain, evaluator, solver=solver,
                              learning_rate=learning_rate,
                              lr_schedule=lr_schedule,
                              lr_schedule_params=lr_schedule_params,
                              **trainer_kwargs)
    return LM(chain, evaluator, trainer, loader)


def train_lm(lm, epochs):
    """Run ``epochs`` epochs (every class span of the loader once, in
    the order test, validation, train); returns one dict per epoch
    with the per-token ``validation_loss`` / ``train_loss`` (nats) and
    error percentages where the epoch had such samples.  Stops early
    when the trainer's health policy halts."""
    loader, trainer = lm.loader, lm.trainer
    history = []
    for _ in range(epochs):
        while True:
            loader.serve_span()
            trainer.run_span(loader)
            if loader.train_ended or trainer.halted:
                break
        acc = trainer.read_epoch_acc(reset_classes=(0, 1, 2))
        row = {"epoch": int(loader.epoch_number),
               "step": trainer.global_step}
        for cls, name in ((VALID, "validation"), (TRAIN, "train")):
            n_err, loss_sum, samples = acc[cls]
            if samples:
                row[name + "_loss"] = loss_sum / samples
                row[name + "_error_pct"] = 100.0 * n_err / samples
        history.append(row)
        if trainer.halted:
            break
    return history


class LMWorkflow(StandardWorkflow):
    """Next-token LM on the planted-Markov corpus (the reference's
    ``samples/lm.py:105``), its keyword arguments the reference's
    ``root.lm_tpu`` keys with their defaults; ``decision_config`` and
    ``snapshotter_config`` entries override the sample's, other keyword
    arguments go to ``StandardWorkflow`` and the trainer."""

    def __init__(self, workflow=None, dim=128, blocks=2, heads=4, vocab=64,
                 seq=128, synthetic_train=8192, synthetic_valid=512, seed=0,
                 minibatch_size=128, solver="adam", learning_rate=1e-3,
                 lr_schedule="cosine", lr_schedule_params=None,
                 fail_iterations=60, max_epochs=None, snapshot_prefix="lm",
                 snapshot_time_interval=60.0, text_path=None,
                 vocab_path=None, vocab_size=512, stride=None,
                 valid_fraction=0.1, corpus="markov", decision_config=None,
                 snapshotter_config=None, **kwargs):
        if text_path:
            from veles_tpu_torch.loader.text import (
                BytePairVocab, FullBatchTextLM)
            # the vocabulary is resolved here so the embedding and
            # logits width is its true size (a stale vocab_path file or
            # an early min_freq stop never leaves the model another
            # width than the ids the loader emits)
            if vocab_path and os.path.exists(vocab_path):
                bpe = BytePairVocab.load(vocab_path)
            else:
                with open(text_path, encoding="utf-8") as f:
                    bpe = BytePairVocab.train(f.read(), int(vocab_size),
                                              specials=("<eos>",))
                if vocab_path:
                    bpe.save(vocab_path)
            vocab = bpe.size
            factory = FullBatchTextLM
            loader_config = {"path": text_path, "vocab": bpe,
                             "seq_len": int(seq), "stride": stride,
                             "valid_fraction": float(valid_fraction)}
        else:
            factory = {"markov": MarkovLoader,
                       "random": RandomTokenLoader}[corpus]
            loader_config = {
                "seq": seq, "vocab": vocab,
                "synthetic_train": synthetic_train,
                "synthetic_valid": synthetic_valid, "corpus_seed": seed}
        loader_config.update({"minibatch_size": int(minibatch_size),
                              "normalization_type": "none"})
        super(LMWorkflow, self).__init__(
            workflow, name="LM", loader_factory=factory,
            loader_config=loader_config,
            layers=lm_spec(int(vocab), int(dim), int(blocks), int(heads)),
            loss="next_token", solver=solver,
            learning_rate=float(learning_rate), lr_schedule=lr_schedule,
            lr_schedule_params=lr_schedule_params or {
                "total_steps": 3800, "floor": 0.05, "warmup": 150},
            decision_config=dict({
                "fail_iterations": int(fail_iterations),
                "max_epochs": max_epochs}, **(decision_config or {})),
            snapshotter_config=dict({
                "prefix": snapshot_prefix,
                "time_interval": float(snapshot_time_interval)},
                **(snapshotter_config or {})),
            **kwargs)
