"""Recurrent layers — the port of ``veles_tpu/models/recurrent.py``:
``SimpleRNN``, ``LSTM`` and ``LastTimestep``.

x: [batch, time, features] → [batch, time, hidden].  The time loop is a
Python loop over the steps, which autograd records (the reference's
``lax.scan``).  Each step's products are the dtype policy's
(``ForwardBase.linear``: operands rounded to the compute dtype, an f32
sum) cast to the input's dtype before the bias is added, as the
reference's ``matmul(xt, w, out_dtype=xt.dtype)``.
"""

import torch

from veles_tpu_torch.models.nn_units import ForwardBase


class _Recurrent(ForwardBase):
    #: dim 1 of the input is a sequence (a mesh shards it over ``sp``)
    SEQ_DIM1_INPUT = True

    def __init__(self, hidden=None, device=None, dtype=None, **hyper):
        super().__init__(device=device, dtype=dtype, **hyper)
        if hidden is None:
            raise ValueError("hidden is required")
        self.hidden = int(hidden)

    def out_shape(self, in_shape):
        return (in_shape[0], self.hidden)

    def _mm(self, x, name):
        return self.linear(x, name).to(x.dtype)


class SimpleRNN(_Recurrent):
    """h_t = tanh(x_t·Wx + h_{t-1}·Wh + b)."""

    PARAMS = ("wx", "wh", "bias")

    def param_shapes(self, in_shape, window):
        f, h = in_shape[-1], self.hidden
        return {"wx": (f, h), "wh": (h, h), "bias": (h,)}

    def apply(self, x):
        h = torch.zeros((x.shape[0], self.hidden), dtype=x.dtype,
                        device=x.device)
        ys = []
        for t in range(x.shape[1]):
            xt = x[:, t]
            h = torch.tanh(self._mm(xt, "wx") + self._mm(h, "wh")
                           + self.params["bias"])
            ys.append(h)
        return torch.stack(ys, dim=1)


class LSTM(_Recurrent):
    """The LSTM of gates i, f, g, o: one [f+h, 4h] product per step over
    ``[x_t, h]``; ``forget_bias`` is added to f before its sigmoid."""

    PARAMS = ("weights", "bias")

    def __init__(self, hidden=None, forget_bias=1.0, device=None,
                 dtype=None, **hyper):
        super().__init__(hidden, device=device, dtype=dtype, **hyper)
        self.forget_bias = float(forget_bias)

    def param_shapes(self, in_shape, window):
        f, h = in_shape[-1], self.hidden
        return {"weights": (f + h, 4 * h), "bias": (4 * h,)}

    def apply(self, x):
        h = c = torch.zeros((x.shape[0], self.hidden), dtype=x.dtype,
                            device=x.device)
        ys = []
        for t in range(x.shape[1]):
            xt = x[:, t]
            z = self._mm(torch.cat([xt, h], dim=1), "weights") \
                + self.params["bias"]
            i, f, g, o = torch.chunk(z, 4, dim=1)
            c = torch.sigmoid(f + self.forget_bias) * c \
                + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            ys.append(h)
        return torch.stack(ys, dim=1)


class LastTimestep(ForwardBase):
    """[batch, time, h] → [batch, h]: the last step's state."""

    def out_shape(self, in_shape):
        return (in_shape[-1],)

    def apply(self, x):
        return x[:, -1, :]
