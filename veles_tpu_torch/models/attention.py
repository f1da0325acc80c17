"""Multi-head attention — the port of ``veles_tpu/models/attention.py``
(single device: no ``sp`` ring).

:func:`attention_core` selects the core by :func:`select_core`, the
JAX package's rule (``mha_apply``): an explicit ``attn_impl`` wins; by
default a CUDA device takes the FlashAttention kernels
(``ops/flash_attention.py``), anything else the blockwise core when
``block_size`` is set, else the dense one.  One point differs: the JAX
rule sends every ``head_dim % 128 == 0`` to its kernel, the port only
the head dims its kernels are built for (:data:`KERNEL_HEAD_DIMS`).
``"pallas"`` and ``"flash"`` both name the kernels: the port has one
for both, and an explicit one raises on the card for a head dim they
are not built for.
"""

from veles_tpu_torch.models.nn_units import ForwardBase
from veles_tpu_torch.ops.attention import attention, blockwise_attention
from veles_tpu_torch.ops.flash import flash_attention
from veles_tpu_torch.ops.flash_attention import KERNEL_HEAD_DIMS


def select_core(device_type, head_dim, block_size=None, attn_impl=None):
    """The core ``attn_impl`` names — ``"pallas"``, ``"flash"``,
    ``"blockwise"`` or ``"dense"`` — for q on ``device_type`` with
    ``head_dim``; ``None``/``"auto"`` picks one."""
    impl = attn_impl or "auto"
    if impl != "auto":
        return impl
    if device_type == "cuda" and head_dim in KERNEL_HEAD_DIMS:
        return "pallas"
    return "blockwise" if block_size else "dense"


def attention_core(q, k, v, causal, block_size=None, attn_impl=None):
    """The attention core over q/k/v [b, s, h, hd] (compute dtype) →
    [b, s, h, hd]."""
    impl = select_core(q.device.type, q.shape[-1], block_size, attn_impl)
    if impl in ("pallas", "flash"):
        return flash_attention(q, k, v, causal=causal)
    if impl == "dense":
        return attention(q, k, v, causal=causal)
    if impl == "blockwise":
        return blockwise_attention(q, k, v, block_size or 512,
                                   causal=causal)
    raise ValueError("unknown attn_impl %r" % (attn_impl,))


def mha_apply(unit, x, heads, causal, block_size=None, attn_impl=None):
    """Multi-head attention over x [b, s, d] with the ``wq``/``wk``/
    ``wv``/``wo`` parameters of ``unit`` (projections through
    :meth:`ForwardBase.linear`: compute-dtype operands, f32 sums);
    returns [b, s, d] in x's dtype."""
    b, s, d = x.shape
    hd = d // heads
    q, k, v = (unit.linear(x, n).to(unit.dtype).reshape(b, s, heads, hd)
               for n in ("wq", "wk", "wv"))
    o = attention_core(q, k, v, causal, block_size, attn_impl)
    return unit.linear(o.reshape(b, s, d), "wo").to(x.dtype)


class MultiHeadAttention(ForwardBase):
    """y = (softmax(QKᵀ/sqrt(hd)) V) Wo with Q/K/V = x·Wq/Wk/Wv, x
    [batch, seq, model_dim]."""

    PARAMS = ("wq", "wk", "wv", "wo")

    def __init__(self, heads=4, causal=False, block_size=None,
                 attn_impl=None, device=None, dtype=None, **hyper):
        super().__init__(device=device, dtype=dtype, **hyper)
        self.heads = int(heads)
        self.causal = bool(causal)
        self.block_size = block_size
        self.attn_impl = attn_impl

    def param_shapes(self, in_shape, window):
        d = in_shape[-1]
        if d % self.heads:
            raise ValueError("model dim %d not divisible by %d heads"
                             % (d, self.heads))
        return {n: (d, d) for n in self.PARAMS}

    def apply(self, x):
        return mha_apply(self, x, self.heads, self.causal, self.block_size,
                         self.attn_impl)
