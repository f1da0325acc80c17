"""Weights into the port's chain: from the JAX package's numpy
parameters, or fresh from a seed.

``params_from_numpy(spec, params)`` takes ``{chain index: {name: numpy
array}}`` — exactly ``{i: {n: a.mem for n, a in
u.param_arrays().items()}}`` of a JAX ``make_forwards`` chain — and
returns the port's chain holding the same weights.  The layouts are the
JAX package's (``[d_in, d_out]`` matrices, HWIO convolution kernels,
HWOI transposed-convolution kernels, logical ``[ky, kx, C, O]`` kernels
of space-to-depth stems, expert-major MoE tensors), so nothing is
transposed.  Kohonen maps and RBMs are not chain units: their arrays
go to ``KohonenTrainer(weights=)`` and ``BernoulliRBM.load_params``.
:func:`params_to_numpy` reads a chain back in the same form,
:func:`set_trainer_state` gives the port's ``GradientDescent`` the
solver slots and step count of a JAX trainer, and
:func:`load_workflow_params` carries a JAX workflow's parameters into
an initialized port workflow.
"""

import numpy
import torch

from veles_tpu_torch.models.standard import make_forwards


def params_from_numpy(spec, params, device=None, dtype=None):
    """The port's chain for layer spec ``spec`` with ``params``
    (chain index → name → array) on ``device`` (default ``cuda``) in
    compute dtype ``dtype`` (default bfloat16)."""
    chain = make_forwards(spec, device=device, dtype=dtype)
    if len(params) != len(chain):
        raise ValueError("params hold %d units, the spec %d"
                         % (len(params), len(chain)))
    for i, unit in enumerate(chain):
        unit.load_params(params[i])
    return chain


def init_params(spec, seed, window=None, device=None, dtype=None,
                in_shape=None):
    """The port's chain for ``spec`` with fresh weights drawn from
    ``numpy.random.default_rng(seed)`` (the JAX package's default
    filling), each unit sized from the sample shape its input has when
    the chain's input has sample shape ``in_shape`` (default: a
    sequence of ``window`` tokens, whose positional table is ``window``
    rows long)."""
    rng = numpy.random.default_rng(seed)
    if in_shape is None:
        in_shape = (window,)
    chain = make_forwards(spec, device=device, dtype=dtype,
                          in_shape=in_shape)
    for unit in chain:
        unit.load_params(unit.fill_arrays(rng, unit.in_shape, window))
    return chain


def params_to_numpy(chain):
    """``{chain index: {name: float32 numpy array}}`` of the port's
    chain (the form :func:`params_from_numpy` takes)."""
    return {i: {n: t.detach().cpu().numpy().copy()
                for n, t in unit.params.items()}
            for i, unit in enumerate(chain)}


def set_trainer_state(trainer, opt_state, global_step):
    """Set ``trainer``'s solver slots from ``opt_state`` — ``{chain
    index: {name: {slot: numpy array}}}``, the JAX trainer's
    ``opt_state`` read to numpy — and its ``global_step``."""
    _, slots = trainer.state_tensors()
    trainer.write_state(opt_state={
        (i, name): {s: numpy.array(opt_state[i][name][s], numpy.float32)
                    for s in got}
        for (i, name), got in slots.items()})
    trainer.global_step = int(global_step)


def load_workflow_params(workflow, params):
    """Load ``params`` — ``{chain index: {name: numpy array}}``, a JAX
    workflow's forward units' parameters (``{i: {n: u.<n>.mem}}``) —
    into an initialized port workflow's chain (``workflow.gd.forwards``,
    or ``workflow.forwards``) in place, and zero its trainer's solver
    slots, as a fresh JAX trainer's are."""
    trainer = getattr(workflow, "gd", None)
    chain = trainer.forwards if trainer is not None else workflow.forwards
    if len(params) != len(chain):
        raise ValueError("params hold %d units, the chain %d"
                         % (len(params), len(chain)))
    for i, unit in enumerate(chain):
        if sorted(params[i]) != sorted(unit.params):
            raise ValueError("unit %d: params %s, the chain's %s"
                             % (i, sorted(params[i]), sorted(unit.params)))
    whole = {i: {n: numpy.asarray(params[i][n], numpy.float32)
                 for n in unit.params} for i, unit in enumerate(chain)}
    if trainer is None:
        with torch.no_grad():
            for i, unit in enumerate(chain):
                for name, t in unit.params.items():
                    t.copy_(torch.as_tensor(whole[i][name]))
        return chain
    _, slots = trainer.state_tensors()
    trainer.write_state(whole, {k: {s: torch.zeros_like(t)
                                    for s, t in got.items()}
                                for k, got in slots.items()})
    return chain
