"""ForwardBase — the common base of the port's parameterized units.

The JAX package's units keep their parameters in ``Array``s and hand
them to a pure ``apply(params, x)``.  Here a unit is an ``nn.Module``
that owns its parameters as a plain name → tensor dict (float32
masters on the unit's device, ``[d_in, d_out]`` layouts as in the JAX
package) and whose methods take activations only.  Serving freezes the
weights, so tensors derived from them (compute-dtype copies, int8
quantizations) are computed once and cached until the next
:meth:`load_params`.
"""

import numpy
import torch
from torch import nn

from veles_tpu_torch import dtypes
from veles_tpu_torch.backends import resolve_device


class ForwardBase(nn.Module):
    """A unit with parameters ``PARAMS`` (subclasses name them and say
    how they are shaped and filled)."""

    PARAMS = ()

    def __init__(self, device=None, dtype=None):
        super().__init__()
        self.device = resolve_device(device)
        #: compute dtype of matmul operands and activations
        self.dtype = dtypes.resolve(dtype)
        self.params = {}
        self._derived = {}

    # -- parameters ----------------------------------------------------------

    def param_shapes(self, d_in, window):
        """name → shape of every parameter, given the input width and
        the serving window."""
        raise NotImplementedError()

    def out_dim(self, d_in):
        """Width of the unit's output for input width ``d_in``."""
        return d_in

    def fill_arrays(self, rng, d_in, window):
        """Fresh numpy parameters from ``rng``: Glorot-uniform
        matrices, unit scales and zero biases (the JAX package's
        default filling)."""
        out = {}
        for name, shape in self.param_shapes(d_in, window).items():
            if len(shape) == 1:
                fill = 1.0 if name.endswith("_scale") else 0.0
                out[name] = numpy.full(shape, fill, numpy.float32)
            else:
                lim = numpy.sqrt(6.0 / (shape[0] + shape[1]))
                out[name] = rng.uniform(-lim, lim, shape).astype(
                    numpy.float32)
        return out

    def load_params(self, arrays):
        """Take parameters (name → numpy array or tensor) onto the
        unit's device as float32 masters; drops derived caches."""
        missing = [n for n in self.PARAMS if n not in arrays]
        if missing:
            raise ValueError("%s: missing parameters %s"
                             % (type(self).__name__, missing))
        self.params = {
            n: torch.as_tensor(numpy.asarray(arrays[n], numpy.float32))
            .to(self.device) for n in self.PARAMS}
        self._derived = {}

    def derived(self, key, make):
        """``make()`` once per parameter load (frozen serving weights)."""
        got = self._derived.get(key)
        if got is None:
            got = self._derived[key] = make()
        return got

    def cast(self, name):
        """Parameter ``name`` in the compute dtype."""
        return self.derived(("cast", name),
                            lambda: self.params[name].to(self.dtype))

    def linear(self, x, name):
        """``x @ params[name]`` under the dtype policy: operands
        rounded to the compute dtype, an f32 sum and result."""
        w = self.derived(("mm", name), lambda: self.params[name].to(
            self.dtype).to(torch.float32))
        return torch.matmul(x.to(self.dtype).to(torch.float32), w)

    def forward(self, x):
        return self.apply(x)
