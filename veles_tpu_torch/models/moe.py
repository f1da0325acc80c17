"""Mixture-of-experts FFN — the port of ``veles_tpu/models/moe.py``.

Top-k gating over the last axis with **dense dispatch**, the
reference's design: every expert runs on every token and the combine
weights zero the experts a token did not choose, so the layer costs
``n_experts`` dense FFNs.  The products are the dtype policy's
(operands in the compute dtype, f32 sums), as the reference's XLA dots
are; no kernel of the port runs here.

The rounding points follow :func:`veles_tpu.models.moe.moe_apply`, so
the two packages choose the same experts in bfloat16 too:

- the gate logits are rounded to the compute dtype before the choice;
- ties go to the lower expert index (``jax.lax.top_k``'s order, a
  stable descending sort here);
- the softmax over the k chosen logits runs in the compute dtype, its
  combine weights are cast to f32 for the final contraction;
- the hidden activation is applied in the compute dtype.

Over an ``ep`` mesh axis (``ep_shards``: the trainer hands each MoE
unit its experts' slices, one per ``ep`` position) every position runs
its experts' share of the dense dispatch on its own device, and the
combine is an explicit sum of the positions' partial outputs in
position order.
"""

import torch

from veles_tpu_torch.models.activations import get_activation
from veles_tpu_torch.models.nn_units import ForwardBase
from veles_tpu_torch.ops import softmax

#: the MoE parameters, expert-major
MOE_PARAMS = ("gate", "expert_w1", "expert_b1", "expert_w2", "expert_b2")
#: the stacked per-expert biases (filled as zeros)
MOE_BIASES = ("expert_b1", "expert_b2")


def top_k(logits, k):
    """(values, indices) of the ``k`` largest entries of the last axis,
    largest first and ties to the lower index (``jax.lax.top_k``)."""
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_shapes(d, n_experts, hidden):
    """name → shape of the MoE parameters at model dim ``d``."""
    e, h = n_experts, hidden
    return {"gate": (d, e), "expert_w1": (e, d, h), "expert_b1": (e, h),
            "expert_w2": (e, h, d), "expert_b2": (e, d)}


def moe_fans(shape):
    """(fan_in, fan_out) of a MoE weight: each expert's slice is filled
    with its own fans, as the reference fills it."""
    return (shape[1], shape[2]) if len(shape) == 3 else (shape[0], shape[1])


def _experts(xw, c, w1, b1, w2, b2, act, dtype):
    """The dense dispatch of experts ``w1``.. [e, ...] over tokens
    ``xw`` [b, d] (f32 of the compute dtype) with combine weights ``c``
    [b, e] (f32): [b, d] f32."""
    f32 = torch.float32
    h1 = torch.matmul(xw[None], w1)                            # [e, b, h]
    h1 = act((h1 + b1.to(f32)[:, None, :]).to(dtype))
    y = torch.matmul(h1.to(f32), w2)                           # [e, b, d]
    y = y + b2.to(f32)[:, None, :]
    return torch.einsum("be,ebd->bd", c, y)


def moe_apply(params, x, k, activation, dtype, weight=None,
              ep_shards=None):
    """The MoE forward over the last axis of ``x`` (leading axes are
    batch-like), each token through its ``k`` chosen experts.
    ``params`` holds ``gate`` [d, E] and the expert-major ``expert_*``
    tensors; ``dtype`` is the compute dtype; ``weight(name)`` gives a
    weight rounded to it, in f32 (default: rounded here).
    ``ep_shards`` — ``[(device, {expert_*: slice})]`` in ``ep`` order —
    runs each position's experts on its device and sums the partial
    outputs (``params`` then needs only ``gate``)."""
    f32 = torch.float32
    if weight is None:
        def weight(name):
            return params[name].to(dtype).to(f32)
    d = x.shape[-1]
    xf = x.reshape(-1, d).to(dtype)
    xw = xf.to(f32)
    logits = torch.matmul(xw, weight("gate")).to(dtype)
    n_experts = logits.shape[-1]
    vals, idx = top_k(logits, k)
    probs = softmax(vals)
    c = torch.zeros((xf.shape[0], n_experts), dtype=dtype, device=x.device)
    c = c.scatter(1, idx, probs).to(f32)
    act = get_activation(activation)
    if ep_shards is None:
        out = _experts(xw, c, weight("expert_w1"), params["expert_b1"],
                       weight("expert_w2"), params["expert_b2"], act,
                       dtype)
        return out.to(x.dtype).reshape(x.shape)
    out, lo = None, 0
    for dev, p in ep_shards:
        e = p["expert_w1"].shape[0]
        part = _experts(xw.to(dev), c[:, lo:lo + e].to(dev),
                        p["expert_w1"].to(dtype).to(f32), p["expert_b1"],
                        p["expert_w2"].to(dtype).to(f32), p["expert_b2"],
                        act, dtype).to(x.device)
        out = part if out is None else out + part
        lo += e
    return out.to(x.dtype).reshape(x.shape)


class MoE(ForwardBase):
    """Top-k gated mixture of 2-layer expert FFNs (d → hidden → d) over
    the last feature axis; ``hidden`` None means 4·d."""

    PARAMS = MOE_PARAMS
    VECTORS = MOE_BIASES
    ACTIVATION = "strict_relu"   # max(0, x): znicz's "relu" is softplus

    def __init__(self, n_experts=4, top_k=2, hidden=None, activation=None,
                 device=None, dtype=None, **hyper):
        super().__init__(device=device, dtype=dtype, **hyper)
        self.n_experts = int(n_experts)
        self.top_k = int(top_k)
        if self.top_k > self.n_experts:
            raise ValueError("top_k %d > n_experts %d"
                             % (self.top_k, self.n_experts))
        self.hidden = hidden
        self.activation = activation or self.ACTIVATION

    def param_shapes(self, in_shape, window):
        d = int(in_shape[-1])
        return moe_shapes(d, self.n_experts, int(self.hidden or 4 * d))

    def fans(self, shape):
        return moe_fans(shape)

    def load_params(self, arrays):
        super().load_params(arrays)
        self.hidden = int(self.params["expert_w1"].shape[2])

    def export_config(self):
        hidden = self.params["expert_w1"].shape[2] \
            if "expert_w1" in self.params else self.hidden
        return {"n_experts": self.n_experts, "top_k": self.top_k,
                "hidden": int(hidden), "activation": self.activation}

    def apply(self, x):
        return moe_apply(self.params, x, self.top_k, self.activation,
                         self.dtype, self.mm_weight,
                         getattr(self, "ep_shards_", None))
