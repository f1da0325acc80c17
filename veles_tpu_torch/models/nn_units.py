"""ForwardBase — the common base of the port's parameterized units.

The JAX package's units keep their parameters in ``Array``s and hand
them to a pure ``apply(params, x)``.  Here a unit is an ``nn.Module``
that owns its parameters as a plain name → tensor dict (float32
masters on the unit's device, the JAX package's layouts: ``[d_in,
d_out]`` matrices, HWIO convolution kernels) and whose methods take
activations only.  Units size their parameters from the input's sample
shape (``param_shapes``, ``out_shape``), as the JAX units size them from
their input array.

Tensors derived from the parameters (compute-dtype copies, int8
quantizations) are cached while the weights stay as they are, which is
how serving uses them.  Training changes that in two ways, and
:meth:`ForwardBase.derived` handles both: a derived tensor built while
autograd records (it holds a graph back to a trainable parameter) is
never cached, and a cached one is dropped once any parameter has been
written in place (the solver's update), so no stale copy is served.

A unit pickles with its tensors as host copies and without its module
hooks or derived caches (a workflow snapshot); :meth:`ForwardBase.to_device`
puts it back on a device.
"""

import numpy
import torch
from torch import nn

from veles_tpu_torch import dtypes
from veles_tpu_torch.backends import resolve_device
from veles_tpu_torch.distributable import host_state

#: per-layer hyper-parameters a trainer consults; None = inherit the
#: trainer's global value (the JAX package's names)
HYPERPARAMS = ("learning_rate", "learning_rate_bias", "weights_decay",
               "weights_decay_bias", "l1_vs_l2", "gradient_moment",
               "gradient_moment_bias")


class ForwardBase(nn.Module):
    """A unit with parameters ``PARAMS`` (subclasses name them and say
    how they are shaped and filled)."""

    PARAMS = ()
    #: parameters filled as vectors are (zeros, ones for ``*_scale``)
    #: whatever their rank: stacked per-expert biases
    VECTORS = ()

    def __init__(self, device=None, dtype=None, **hyper):
        super().__init__()
        unknown = set(hyper) - set(HYPERPARAMS)
        if unknown:
            raise TypeError("%s: unknown arguments %s"
                            % (type(self).__name__, sorted(unknown)))
        self.device = resolve_device(device)
        #: compute dtype of matmul operands and activations
        self.dtype = dtypes.resolve(dtype)
        self.params = {}
        self._derived = {}
        for h in HYPERPARAMS:
            setattr(self, h, hyper.get(h))

    def hyperparams(self):
        """Per-layer overrides, None meaning 'inherit'."""
        return {h: getattr(self, h) for h in HYPERPARAMS}

    # -- parameters ----------------------------------------------------------

    def param_shapes(self, in_shape, window):
        """name → shape of every parameter, given the input sample shape
        (a tuple without the batch axis) and the serving window."""
        return {}

    def out_shape(self, in_shape):
        """The output sample shape for input sample shape ``in_shape``."""
        return in_shape

    def export_config(self):
        """The constructor keyword arguments a package records for this
        unit, key for key those of the JAX package's class of the same
        name (this base: that package's base unit's, which the recurrent
        units keep)."""
        return {"weights_filling": "uniform", "include_bias": True}

    def fans(self, shape):
        """(fan_in, fan_out) of a weight of ``shape`` (``[d_in, d_out]``
        matrices; units with other layouts say theirs)."""
        return shape[0], shape[1]

    def fill_arrays(self, rng, in_shape, window):
        """Fresh numpy parameters from ``rng``: Glorot-uniform weights
        (the JAX package's ``_fill``: uniform in ±sqrt(6 / (fan_in +
        fan_out))), unit scales and zero biases."""
        out = {}
        for name, shape in self.param_shapes(in_shape, window).items():
            if len(shape) == 1 or name in self.VECTORS:
                fill = 1.0 if name.endswith("_scale") else 0.0
                out[name] = numpy.full(shape, fill, numpy.float32)
            else:
                fan_in, fan_out = self.fans(shape)
                lim = numpy.sqrt(6.0 / (fan_in + fan_out))
                out[name] = rng.uniform(-lim, lim, shape).astype(
                    numpy.float32)
        return out

    def fill_reference(self, gen, in_shape, window):
        """Fresh numpy parameters drawn from the process-wide generator
        ``gen`` (a :class:`~veles_tpu_torch.prng.RandomGenerator`) in the
        order the JAX package's workflow units draw them from
        ``prng.get()``: each weight Glorot-uniform by ``gen.fill``; a
        ``bias`` filled uniform in ±0, which draws its length from the
        stream and leaves zeros; other vectors are zeros (ones for
        ``*_scale``) and draw nothing."""
        out = {}
        for name, shape in self.param_shapes(in_shape, window).items():
            arr = numpy.zeros(shape, numpy.float32)
            if name == "bias":
                gen.fill(arr, -0.0, 0.0)
            elif len(shape) == 1 or name in self.VECTORS:
                arr[...] = 1.0 if name.endswith("_scale") else 0.0
            else:
                fan_in, fan_out = self.fans(shape)
                lim = numpy.sqrt(6.0 / (fan_in + fan_out))
                gen.fill(arr, -lim, lim)
            out[name] = arr
        return out

    def load_params(self, arrays):
        """Take parameters (name → numpy array) onto the unit's device
        as float32 masters (copies: training updates them in place);
        drops derived caches."""
        missing = [n for n in self.PARAMS if n not in arrays]
        if missing:
            raise ValueError("%s: missing parameters %s"
                             % (type(self).__name__, missing))
        self.params = {
            n: torch.as_tensor(numpy.array(arrays[n], numpy.float32))
            .to(self.device) for n in self.PARAMS}
        self._derived = {}

    def to_device(self, device):
        """Move the parameters to ``device`` (resolved as every entry
        point resolves it) and drop the derived caches."""
        self.device = resolve_device(device)
        self.params = {n: t.detach().to(self.device)
                       for n, t in self.params.items()}
        self._derived = {}
        return self

    #: volatile attributes a mesh trainer hands the unit per step
    MESH_VOLATILE = ("sp_mesh_", "sp_ring_", "ep_shards_", "ep_route_")

    def __getstate__(self):
        state = {k: v for k, v in self.__dict__.items()
                 if "hooks" not in k and k not in self.MESH_VOLATILE}
        state["_derived"] = {}
        # a mesh trainer's units read their shards gathered whole
        state["params"] = dict(self.params.items())
        return host_state(state)

    def __setstate__(self, state):
        for k, v in nn.Module().__dict__.items():
            state.setdefault(k, v)
        self.__dict__.update(state)

    def derived(self, key, make):
        """``make()``, cached while no parameter changes.  While autograd
        records through trainable parameters the result is built anew
        and never cached: it holds this step's graph."""
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in self.params.values()):
            return make()
        version = tuple(t._version for t in self.params.values())
        got = self._derived.get(key)
        if got is None or got[0] != version:
            got = self._derived[key] = (version, make())
        return got[1]

    def cast(self, name):
        """Parameter ``name`` in the compute dtype."""
        return self.derived(("cast", name),
                            lambda: self.params[name].to(self.dtype))

    def mm_weight(self, name):
        """Parameter ``name`` rounded to the compute dtype, in f32: the
        operand of a policy product (exact products, an f32 sum)."""
        return self.derived(("mm", name), lambda: self.params[name].to(
            self.dtype).to(torch.float32))

    def linear(self, x, name):
        """``x @ params[name]`` under the dtype policy: operands
        rounded to the compute dtype, an f32 sum and result."""
        return torch.matmul(x.to(self.dtype).to(torch.float32),
                            self.mm_weight(name))

    def forward(self, x):
        return self.apply(x)
