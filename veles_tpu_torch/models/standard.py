"""Chain builder — the port of ``veles_tpu/models/standard.make_forwards``
for the LM chain's layer types and multi-head attention."""

from veles_tpu_torch.models.attention import MultiHeadAttention
from veles_tpu_torch.models.embedding import Embedding
from veles_tpu_torch.models.transformer import TokenProjection, TransformerBlock

#: layer-type names (the JAX package's spec keys) → unit classes
LAYER_TYPES = {
    "attention": MultiHeadAttention,
    "embedding": Embedding,
    "transformer_block": TransformerBlock,
    "token_logits": TokenProjection,
}


def make_forwards(layers, device=None, dtype=None):
    """Instantiate the unit chain from a znicz-style ``layers`` spec
    (``{"type": ..., **kwargs}`` dicts; ``"->"``/``"<-"`` merge extra
    kwargs as in the JAX package).  Units come without parameters —
    see ``convert.params_from_numpy`` / ``convert.init_params``."""
    units = []
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
        units.append(cls(device=device, dtype=dtype, **kwargs))
    return units
