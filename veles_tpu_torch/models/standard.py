"""Chain builder — the port of ``veles_tpu/models/standard.make_forwards``
with all of the reference's layer types: the LM chain's (embedding,
transformer blocks with dense or MoE FFNs, the logits head), attention,
the MoE layer, the sequence pools, the recurrent units and the conv-net
family (convolutions, the transposed convolution, pooling and
depooling, LRN, dropout, fully-connected layers and the softmax
head) — and :class:`StandardWorkflow`, the config-driven training graph
the samples build (the port of ``veles_tpu/models/standard.py:120``)."""

from veles_tpu_torch.accelerated_units import AcceleratedWorkflow
from veles_tpu_torch.models.all2all import (
    All2All, All2AllRELU, All2AllSigmoid, All2AllSoftmax, All2AllStrictRELU,
    All2AllTanh)
from veles_tpu_torch.models.attention import MultiHeadAttention
from veles_tpu_torch.models.conv import (
    Conv, ConvRELU, ConvStrictRELU, ConvTanh, Deconv)
from veles_tpu_torch.models.dropout import DropoutForward
from veles_tpu_torch.models.embedding import Embedding
from veles_tpu_torch.models.lrn import LRNormalizerForward
from veles_tpu_torch.models.moe import MoE
from veles_tpu_torch.models.pooling import AvgPooling, Depooling, MaxPooling
from veles_tpu_torch.models.recurrent import LSTM, LastTimestep, SimpleRNN
from veles_tpu_torch.models.transformer import (
    MeanPoolSeq, TokenProjection, TransformerBlock)

#: layer-type names (the JAX package's spec keys) → unit classes
LAYER_TYPES = {
    "all2all": All2All,
    "all2all_tanh": All2AllTanh,
    "all2all_relu": All2AllRELU,
    "all2all_str": All2AllStrictRELU,
    "all2all_sigmoid": All2AllSigmoid,
    "softmax": All2AllSoftmax,
    "conv": Conv,
    "conv_tanh": ConvTanh,
    "conv_relu": ConvRELU,
    "conv_str": ConvStrictRELU,
    "deconv": Deconv,
    "max_pooling": MaxPooling,
    "avg_pooling": AvgPooling,
    "depooling": Depooling,
    "dropout": DropoutForward,
    "norm": LRNormalizerForward,
    "attention": MultiHeadAttention,
    "moe": MoE,
    "embedding": Embedding,
    "transformer_block": TransformerBlock,
    "mean_pool_seq": MeanPoolSeq,
    "rnn": SimpleRNN,
    "lstm": LSTM,
    "last_timestep": LastTimestep,
    "token_logits": TokenProjection,
}


def make_forwards(layers, device=None, dtype=None, in_shape=None):
    """Instantiate the unit chain from a znicz-style ``layers`` spec
    (``{"type": ..., **kwargs}`` dicts; ``"->"``/``"<-"`` merge extra
    kwargs as in the JAX package), each named ``<type><index>`` as the
    JAX package names them.  Units come without parameters —
    see ``convert.params_from_numpy`` / ``convert.init_params``.  Given
    the chain input's sample shape ``in_shape`` (no batch axis), each
    unit records the sample shape of its own input as ``in_shape``."""
    units = []
    shape = None if in_shape is None else tuple(in_shape)
    for i, spec in enumerate(dict(s) for s in layers):
        ltype = spec.pop("type")
        kwargs = dict(spec.pop("->", {}))
        kwargs.update(spec.pop("<-", {}))
        kwargs.update(spec)
        try:
            cls = LAYER_TYPES[ltype]
        except KeyError:
            raise ValueError("layer type %r is not ported (have %s)"
                             % (ltype, sorted(LAYER_TYPES)))
        unit = cls(device=device, dtype=dtype, **kwargs)
        unit.name = "%s%d" % (ltype, i)
        unit.in_shape = shape
        if shape is not None:
            shape = tuple(unit.out_shape(shape))
        units.append(unit)
    return units


def build_mlp_classifier(device, loader, hidden=(100,), classes=10,
                         mesh=None, workflow=None, name="mlp",
                         hidden_type="all2all_tanh", dtype=None,
                         **gd_kwargs):
    """loader (constructed, not yet initialized) → ``hidden_type``
    hidden layers → softmax head → evaluator → trainer, each unit of
    ``workflow`` (a new one named ``name`` by default), the trainer on
    ``mesh`` when given.  Returns (workflow, layers, evaluator,
    trainer)."""
    from veles_tpu_torch.models.evaluator import EvaluatorSoftmax
    from veles_tpu_torch.models.gd import GradientDescent
    wf = workflow or AcceleratedWorkflow(None, name=name)
    loader.initialize(device=device)
    spec = [{"type": hidden_type, "output_sample_shape": (w,)}
            for w in hidden]
    spec.append({"type": "softmax", "output_sample_shape": (classes,)})
    layers = make_forwards(spec, device="cpu", dtype=dtype)
    for i, unit in enumerate(layers[:-1]):    # the JAX package's names
        unit.name = "fc%d" % i
    layers[-1].name = "head"
    ev = EvaluatorSoftmax()
    gd_kwargs.setdefault("solver", "sgd")
    gd_kwargs.setdefault("learning_rate", 0.05)
    gd = GradientDescent(wf, forwards=layers, evaluator=ev, loader=loader,
                         mesh=mesh, name="gd", **gd_kwargs)
    gd.initialize(device=device)
    return wf, layers, ev, gd


class StandardWorkflow(AcceleratedWorkflow):
    """The config-driven training graph (znicz StandardWorkflow role):

        start → repeater → loader → trainer → decision ─┬→ repeater
                                                        ├→ snapshotter
                                                        └→ end

    with ``loader.gate_block = decision.complete`` and the end point
    gated on ``~decision.complete`` (ref: standard.py:154-220).

    - ``loader_factory(workflow, **loader_config)`` builds the loader
      (or pass a ready ``loader`` instance);
    - ``layers`` — the forward-chain spec (see :func:`make_forwards`),
      whose units are sized from the loader's sample shape and filled
      from ``default_rng(weights_seed)`` by the trainer's
      ``initialize``, in compute dtype ``dtype``;
    - ``loss`` — "softmax" | "mse" | "next_token" selects the evaluator
      (the head's f32 logits feed "softmax");
    - ``decision_config`` / ``snapshotter_config`` (``enabled`` False
      builds none) / the trainer's keyword arguments;
    - ``trace_run``, ``timings``: the reference's ``root.common`` keys
      (see :mod:`veles_tpu_torch.units`).

    ``mesh`` (a Mesh or an axis dict) shards the trainer's step
    (:mod:`~veles_tpu_torch.models.gd_mesh`).  ``plotters=True`` builds
    the reference's live plots (``wf.plotters``): the validation error
    per epoch (``error_curve``) and the train loss (``loss_curve``),
    both after the decision; their payloads are built only when a
    graphics server is attached (:mod:`veles_tpu_torch.plotter`).
    """

    def __init__(self, workflow=None, loader_factory=None, loader=None,
                 loader_config=None, layers=(), loss="softmax",
                 decision_config=None, snapshotter_config=None, mesh=None,
                 name="StandardWorkflow", plotters=True, dtype=None,
                 weights_seed=0, trace_run=False, timings=False,
                 **trainer_kwargs):
        from veles_tpu_torch.models.decision import DecisionGD
        from veles_tpu_torch.models.evaluator import (
            EvaluatorMSE, EvaluatorNextToken, EvaluatorSoftmax)
        from veles_tpu_torch.models.gd import GradientDescent
        from veles_tpu_torch.plumbing import Repeater
        from veles_tpu_torch.snapshotter import Snapshotter

        super(StandardWorkflow, self).__init__(
            workflow, name=name, trace_run=trace_run, timings=timings)
        self.repeater = Repeater(self)
        self.repeater.link_from(self.start_point)

        if loader is None:
            loader = loader_factory(self, **(loader_config or {}))
        self.loader = loader
        self.loader.link_from(self.repeater)

        self.layers = [dict(s) for s in layers]
        # units without parameters yet: the trainer fills them on the
        # workflow's device at initialize
        self.forwards = make_forwards(self.layers, device="cpu",
                                      dtype=dtype)

        if loss == "mse":
            self.evaluator = EvaluatorMSE()
        elif loss == "next_token":
            self.evaluator = EvaluatorNextToken()
        elif loss == "softmax":
            self.evaluator = EvaluatorSoftmax()
        else:
            raise ValueError("loss must be softmax, mse or next_token, "
                             "not %r" % (loss,))

        self.gd = GradientDescent(
            self, forwards=self.forwards, evaluator=self.evaluator,
            loader=self.loader, weights_seed=weights_seed, mesh=mesh,
            **trainer_kwargs)
        self.gd.link_from(self.loader)

        self.decision = DecisionGD(self, **(decision_config or {}))
        self.decision.loader = self.loader
        self.decision.trainer = self.gd
        self.decision.link_from(self.gd)

        snapshotter_config = dict(snapshotter_config or {})
        if snapshotter_config.pop("enabled", True):
            self.snapshotter = Snapshotter(self, **snapshotter_config)
            self.snapshotter.decision = self.decision
            self.snapshotter.link_from(self.decision)
        else:
            self.snapshotter = None

        # live plots: payloads publish only when a graphics server is
        # attached to the launcher
        self.plotters = []
        if plotters:
            from veles_tpu_torch.plotting_units import AccumulatingPlotter
            err_plot = AccumulatingPlotter(
                self, obj=self.decision, attr="validation_error_pct",
                label="validation error", ylabel="%",
                name="error_curve")
            err_plot.gate_skip = ~self.loader.epoch_ended
            loss_plot = AccumulatingPlotter(
                self, obj=self.gd, attr="loss", label="train loss",
                ylabel="loss", name="loss_curve")
            for plot in (err_plot, loss_plot):
                plot.link_from(self.decision)
                self.plotters.append(plot)

        self.repeater.link_from(self.decision)
        self.loader.gate_block = self.decision.complete
        self.end_point.link_from(self.decision)
        self.end_point.gate_block = ~self.decision.complete

    # -- resuming a snapshot of the JAX package -------------------------------

    @classmethod
    def jax_kwargs(cls, rec):
        """The constructor's keyword arguments a sample reads from a JAX
        workflow record beyond :func:`~veles_tpu_torch.jax_snapshot.
        standard_kwargs`'s (its layer widths; samples override)."""
        return {}

    @classmethod
    def from_jax(cls, rec):
        """This workflow built from the record of a JAX package
        snapshot (:mod:`veles_tpu_torch.jax_snapshot`): constructed with
        the record's keyword arguments, then given the record's
        training state unit by unit."""
        from veles_tpu_torch import jax_snapshot
        kw = dict(jax_snapshot.standard_kwargs(rec), **cls.jax_kwargs(rec))
        wf = cls(None, **jax_snapshot.filter_kwargs(cls, kw))
        return jax_snapshot.take_state(wf, rec)
