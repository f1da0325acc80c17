"""Activation functions — the port of ``veles_tpu/models/activations.py``
(the functions; the standalone ``Activation`` unit waits for the
workflow graph).

The names are znicz's, and two of them are not what PyTorch's names
suggest: ``"relu"`` is **softplus**, ``log(1 + exp(x))`` (computed as
``logaddexp(x, 0)``, safe from overflow), and ``"tanh"`` is LeCun's
scaled ``1.7159 · tanh(0.6666 · x)``.  ``"strict_relu"`` is
``max(x, 0)``.
"""

import torch


def linear(x):
    return x


def tanh(x):
    return 1.7159 * torch.tanh(0.6666 * x)


def relu(x):
    return torch.logaddexp(x, torch.zeros_like(x))


def strict_relu(x):
    # jnp.maximum's gradient at a tie is 0.5 to each side; clamp would
    # pass 1 at x == 0 (an input exactly 0: a conv over a cutout box)
    return torch.maximum(x, torch.zeros((), dtype=x.dtype, device=x.device))


def sigmoid(x):
    return 1.0 / (1.0 + torch.exp(-x))


def sincos(x):
    """Even feature indices get sin, odd get cos."""
    even = torch.arange(x.shape[-1], device=x.device) % 2 == 0
    return torch.where(even, torch.sin(x), torch.cos(x))


ACTIVATIONS = {
    "linear": linear,
    "tanh": tanh,
    "relu": relu,
    "strict_relu": strict_relu,
    "sigmoid": sigmoid,
    "sincos": sincos,
}


def get_activation(name):
    if callable(name):
        return name
    try:
        return ACTIVATIONS[name]
    except KeyError:
        raise KeyError("unknown activation %r (have: %s)"
                       % (name, sorted(ACTIVATIONS)))
