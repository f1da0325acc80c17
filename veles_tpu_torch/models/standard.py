"""Chain builder — the port of ``veles_tpu/models/standard.make_forwards``
with all of the reference's layer types: the LM chain's (embedding,
transformer blocks with dense or MoE FFNs, the logits head), attention,
the MoE layer, the sequence pools, the recurrent units and the conv-net
family (convolutions, the transposed convolution, pooling and
depooling, LRN, dropout, fully-connected layers and the softmax
head)."""

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
    kwargs as in the JAX package).  Units come without parameters —
    see ``convert.params_from_numpy`` / ``convert.init_params``.  Given
    the chain input's sample shape ``in_shape`` (no batch axis), each
    unit records the sample shape of its own input as ``in_shape``."""
    units = []
    shape = None if in_shape is None else tuple(in_shape)
    for spec in (dict(s) for s in layers):
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
        unit.in_shape = shape
        if shape is not None:
            shape = tuple(unit.out_shape(shape))
        units.append(unit)
    return units
