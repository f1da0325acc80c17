"""Multi-head attention — the port of ``veles_tpu/models/attention.py``.

Under a mesh with an ``sp`` axis the trainer hands each unit the mesh
(``sp_mesh_``) and the ring devices of the minibatch slice it runs
(``sp_ring_``); the attention core is then the ring
(:func:`_ring_mha`), which overrides every other core, the
FlashAttention kernels included, as in the reference.

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

import torch

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


def _ring_mha(mesh, q, k, v, causal, devices=None):
    """The sp-sharded attention core: q/k/v [batch, seq, heads, hd]
    cut along seq into one slice per ring position (``devices``,
    default the ``sp`` positions at the mesh's origin); K/V rotate
    around the ring (``ops.attention.ring_attention``) and the slices
    come back together on q's device."""
    from veles_tpu_torch.ops.attention import ring_attention
    if devices is None:
        devices = [mesh.device(p) for p in mesh.along(0, "sp")]
    n = len(devices)

    def split(t):
        return [c.to(dev) for c, dev in zip(torch.chunk(t, n, dim=1),
                                             devices)]

    out = ring_attention(split(q), split(k), split(v), causal=causal)
    return torch.cat([o.to(q.device) for o in out], dim=1)


def sp_core(unit, q, k, v, causal, block_size=None, attn_impl=None):
    """The attention core of ``unit``: the ring when the trainer handed
    it an ``sp`` mesh wider than 1, else :func:`attention_core`."""
    mesh = getattr(unit, "sp_mesh_", None)
    if mesh is not None and mesh.shape.get("sp", 1) > 1:
        return _ring_mha(mesh, q, k, v, causal,
                         getattr(unit, "sp_ring_", None))
    return attention_core(q, k, v, causal, block_size, attn_impl)


def mha_apply(unit, x, heads, causal, block_size=None, attn_impl=None):
    """Multi-head attention over x [b, s, d] with the ``wq``/``wk``/
    ``wv``/``wo`` parameters of ``unit`` (projections through
    :meth:`ForwardBase.linear`: compute-dtype operands, f32 sums);
    returns [b, s, d] in x's dtype.  The core is :func:`sp_core`'s."""
    b, s, d = x.shape
    hd = d // heads
    q, k, v = (unit.linear(x, n).to(unit.dtype).reshape(b, s, heads, hd)
               for n in ("wq", "wk", "wv"))
    o = sp_core(unit, q, k, v, causal, block_size, attn_impl)
    return unit.linear(o.reshape(b, s, d), "wo").to(x.dtype)


class MultiHeadAttention(ForwardBase):
    """y = (softmax(QKᵀ/sqrt(hd)) V) Wo with Q/K/V = x·Wq/Wk/Wv, x
    [batch, seq, model_dim]."""

    #: dim 1 of the input is a sequence (a mesh shards it over ``sp``)
    SEQ_DIM1_INPUT = True

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

    def export_config(self):
        cfg = {"heads": self.heads, "causal": self.causal}
        if self.block_size:  # a v2 key: omitted when unused
            cfg["block_size"] = int(self.block_size)
        if self.attn_impl:
            cfg["attn_impl"] = self.attn_impl
        return cfg

    def apply(self, x):
        return mha_apply(self, x, self.heads, self.causal, self.block_size,
                         self.attn_impl)
