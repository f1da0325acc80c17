"""Chain builder — the port of ``veles_tpu/models/standard.make_forwards``
for the LM chain's layer types, multi-head attention and the conv-net
family (convolutions, pooling, LRN, dropout, fully-connected layers and
the softmax head)."""

from veles_tpu_torch.models.all2all import (
    All2All, All2AllRELU, All2AllSigmoid, All2AllSoftmax, All2AllStrictRELU,
    All2AllTanh)
from veles_tpu_torch.models.attention import MultiHeadAttention
from veles_tpu_torch.models.conv import (
    Conv, ConvRELU, ConvStrictRELU, ConvTanh)
from veles_tpu_torch.models.dropout import DropoutForward
from veles_tpu_torch.models.embedding import Embedding
from veles_tpu_torch.models.lrn import LRNormalizerForward
from veles_tpu_torch.models.pooling import AvgPooling, MaxPooling
from veles_tpu_torch.models.transformer import TokenProjection, TransformerBlock

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
    "max_pooling": MaxPooling,
    "avg_pooling": AvgPooling,
    "dropout": DropoutForward,
    "norm": LRNormalizerForward,
    "attention": MultiHeadAttention,
    "embedding": Embedding,
    "transformer_block": TransformerBlock,
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
