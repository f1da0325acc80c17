"""Gradient-descent solvers — the port of ``veles_tpu/models/solvers.py``:
SGD with momentum, AdaGrad, AdaDelta and Adam, each a pair of
functions over one parameter tensor:

- ``init(param) -> state`` (dict of tensors);
- ``update(param, grad, state, hp) -> (new_param, new_state)``.

``hp`` carries ``lr`` (a float32 value), ``decay`` and ``l1_vs_l2``
(weight decay joins the gradient before the step) and ``moment``.
The functions are pure, as in the JAX package; the trainer writes
their results into the parameters and slots in place.
"""

import torch


def _decayed_grad(param, grad, hp):
    """grad + weights_decay · d/dw (the l2/l1 mix)."""
    decay = hp.get("decay", 0.0)
    l1_vs_l2 = hp.get("l1_vs_l2", 0.0)
    if decay:
        reg = l1_vs_l2 * torch.sign(param) + (1.0 - l1_vs_l2) * param
        grad = grad + decay * reg
    return grad


class SGD:
    """Plain / momentum SGD."""

    name = "sgd"

    @staticmethod
    def init(param):
        return {"v": torch.zeros_like(param)}

    @staticmethod
    def update(param, grad, state, hp):
        grad = _decayed_grad(param, grad, hp)
        v = hp.get("moment", 0.0) * state["v"] - hp["lr"] * grad
        return param + v, {"v": v}


class AdaGrad:
    name = "adagrad"
    EPS = 1e-8

    @staticmethod
    def init(param):
        return {"g2": torch.zeros_like(param)}

    @staticmethod
    def update(param, grad, state, hp):
        grad = _decayed_grad(param, grad, hp)
        g2 = state["g2"] + grad * grad
        step = hp["lr"] * grad / (torch.sqrt(g2) + AdaGrad.EPS)
        return param - step, {"g2": g2}


class AdaDelta:
    name = "adadelta"
    RHO = 0.95
    EPS = 1e-6

    @staticmethod
    def init(param):
        return {"g2": torch.zeros_like(param), "x2": torch.zeros_like(param)}

    @staticmethod
    def update(param, grad, state, hp):
        grad = _decayed_grad(param, grad, hp)
        rho, eps = AdaDelta.RHO, AdaDelta.EPS
        g2 = rho * state["g2"] + (1 - rho) * grad * grad
        dx = -torch.sqrt(state["x2"] + eps) / torch.sqrt(g2 + eps) * grad
        x2 = rho * state["x2"] + (1 - rho) * dx * dx
        # lr scales the adapted step (1.0 = classic AdaDelta)
        return param + hp["lr"] * dx, {"g2": g2, "x2": x2}


class Adam:
    name = "adam"
    B1 = 0.9
    B2 = 0.999
    EPS = 1e-8

    @staticmethod
    def init(param):
        return {"m": torch.zeros_like(param), "v": torch.zeros_like(param),
                "t": torch.zeros((), dtype=torch.float32,
                                 device=param.device)}

    @staticmethod
    def update(param, grad, state, hp):
        grad = _decayed_grad(param, grad, hp)
        b1, b2, eps = Adam.B1, Adam.B2, Adam.EPS
        t = state["t"] + 1
        m = b1 * state["m"] + (1 - b1) * grad
        v = b2 * state["v"] + (1 - b2) * grad * grad
        mhat = m / (1 - torch.pow(b1, t))
        vhat = v / (1 - torch.pow(b2, t))
        return (param - hp["lr"] * mhat / (torch.sqrt(vhat) + eps),
                {"m": m, "v": v, "t": t})


SOLVERS = {c.name: c for c in (SGD, AdaGrad, AdaDelta, Adam)}


def get_solver(name):
    if isinstance(name, type):
        return name
    try:
        return SOLVERS[name]
    except KeyError:
        raise KeyError("unknown solver %r (have: %s)"
                       % (name, sorted(SOLVERS)))
