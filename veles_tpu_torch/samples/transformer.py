"""Transformer sequence-classification workflow — the port of
``veles_tpu/samples/transformer.py`` (Embedding → TransformerBlock × N
→ mean-pool → softmax head) on the induction task: every sequence holds
exactly one MARKER token, and the label is the token right after it.
Its keyword arguments are the reference's ``root.transformer_tpu`` keys
with their defaults.  ``mesh`` — an axis dict such as ``{"dp": 2, "sp":
4}`` (dp splits the batch, sp sequence-shards attention through the
ring) or a Mesh — shards the trainer's step.

    wf = TransformerWorkflow(synthetic_train=256, synthetic_valid=64,
                             max_epochs=2, dtype="float32")
    wf.initialize(device="cpu"); wf.run()

At head dim 128 (``dim`` 512, 4 heads) the blocks' attention runs
through the FlashAttention kernels on the card.
"""

import numpy

from veles_tpu_torch.loader.fullbatch import FullBatchLoader
from veles_tpu_torch.models.standard import StandardWorkflow

MARKER = 0  # token reserved as the lookup marker


class InductionLoader(FullBatchLoader):
    """Sequences [N, seq] over a vocab; label = token after the single
    MARKER occurrence."""

    def __init__(self, workflow, vocab=16, seq=32, synthetic_train=8192,
                 synthetic_valid=1024, seed=99, **kwargs):
        super(InductionLoader, self).__init__(workflow, **kwargs)
        self.vocab, self.seq = int(vocab), int(seq)
        self.n_train, self.n_valid = int(synthetic_train), \
            int(synthetic_valid)
        self.data_seed = int(seed)

    def load_data(self):
        vocab, seq = self.vocab, self.seq
        tot = self.n_train + self.n_valid
        rng = numpy.random.default_rng(self.data_seed)
        # tokens 1..vocab-1; MARKER inserted at a random position with
        # a random payload token after it
        data = rng.integers(1, vocab, (tot, seq))
        pos = rng.integers(0, seq - 1, tot)
        payload = rng.integers(1, vocab, tot)
        data[numpy.arange(tot), pos] = MARKER
        data[numpy.arange(tot), pos + 1] = payload
        self.class_lengths[:] = [0, self.n_valid, self.n_train]
        self.original_data = data.astype(numpy.int32)
        self.original_labels = payload.tolist()


class TransformerWorkflow(StandardWorkflow):
    """Embedding → blocks → mean-pool → softmax over the vocab."""

    def __init__(self, workflow=None, vocab=16, dim=64, blocks=2, heads=4,
                 n_experts=0, top_k=2, causal=False, attn_impl=None,
                 attn_block_size=None, seq=32, synthetic_train=8192,
                 synthetic_valid=1024, seed=99, minibatch_size=128,
                 solver="adam", learning_rate=1e-3, gradient_moment=0.9,
                 weights_decay=0.0, fail_iterations=15, max_epochs=None,
                 snapshot_prefix="transformer",
                 snapshot_time_interval=1e9, decision_config=None,
                 snapshotter_config=None, mesh=None, **kwargs):
        vocab = int(vocab)
        if hasattr(mesh, "__content__"):    # a config subtree
            mesh = dict(mesh.__content__())
        if isinstance(mesh, dict) and not mesh:
            mesh = None
        spec = [{"type": "embedding", "vocab": vocab, "dim": int(dim)}]
        spec += [{"type": "transformer_block", "heads": int(heads),
                  "causal": bool(causal), "n_experts": int(n_experts),
                  "top_k": int(top_k), "attn_impl": attn_impl,
                  "attn_block_size": (int(attn_block_size)
                                      if attn_block_size else None)}
                 for _ in range(int(blocks))]
        spec += [{"type": "mean_pool_seq"},
                 {"type": "softmax", "output_sample_shape": (vocab,)}]
        super(TransformerWorkflow, self).__init__(
            workflow, name="Transformer", loader_factory=InductionLoader,
            loader_config={
                "vocab": vocab, "seq": seq,
                "synthetic_train": synthetic_train,
                "synthetic_valid": synthetic_valid, "seed": seed,
                "minibatch_size": int(minibatch_size),
                "normalization_type": "none"},
            layers=spec, solver=solver, learning_rate=float(learning_rate),
            gradient_moment=float(gradient_moment),
            weights_decay=float(weights_decay),
            decision_config=dict({
                "fail_iterations": int(fail_iterations),
                "max_epochs": max_epochs}, **(decision_config or {})),
            snapshotter_config=dict({
                "prefix": snapshot_prefix,
                "time_interval": float(snapshot_time_interval)},
                **(snapshotter_config or {})),
            mesh=dict(mesh) if isinstance(mesh, dict) else mesh,
            **kwargs)

    @classmethod
    def jax_kwargs(cls, rec):
        """The chain's shape of a JAX transformer record (the
        embedding's vocab and dim, the blocks' count and settings, the
        sequence length) and the data seed from ``root.transformer_tpu``
        (as the JAX loader read it)."""
        from veles_tpu_torch.config import root
        fwd = rec.get("forwards")
        blocks = [u for u in fwd if u.jax_name.endswith(".TransformerBlock")]
        kw = {"vocab": int(fwd[0].get("vocab")),
              "dim": int(fwd[0].get("dim")), "blocks": len(blocks),
              "seed": int(root.transformer_tpu.get("seed", 99))}
        if blocks:
            b = blocks[0]
            kw.update(heads=int(b.get("heads")), causal=bool(b.get("causal")),
                      n_experts=int(b.get("n_experts") or 0),
                      top_k=int(b.get("top_k") or 2),
                      attn_impl=b.get("attn_impl"),
                      attn_block_size=b.get("attn_block_size"))
        inp = fwd[0].get("input")
        if inp is not None and inp.get("_mem") is not None:
            kw["seq"] = int(inp.get("_mem").shape[1])
        return kw


def run(load, main):
    """The command line's entry: the workflow from ``root.transformer_tpu``."""
    from veles_tpu_torch.config import root
    from veles_tpu_torch.samples import config_kwargs
    load(TransformerWorkflow, **config_kwargs(TransformerWorkflow, root.transformer_tpu))
    main()
