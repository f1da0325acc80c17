"""MeanDispNormalizer — ``out = (x - mean) * rdisp`` (the port of
``veles_tpu/ops/normalize.py``).

An elementwise expression in plain PyTorch: the reference deliberately
has no hand-written kernel for it (``veles_tpu/ops/normalize.py:1-7``),
and neither has the port.
"""

import numpy

from veles_tpu_torch import dtypes
from veles_tpu_torch.accelerated_units import AcceleratedUnit
from veles_tpu_torch.memory import Array
from veles_tpu_torch.units import MissingDemand


def mean_disp_normalize(x, mean, rdisp, out_dtype=None):
    """``(x - mean) * rdisp`` broadcast over the leading (batch) axes, in
    ``out_dtype`` (default: the compute dtype)."""
    out = (x - mean) * rdisp
    return out.to(dtypes.resolve(out_dtype))


class MeanDispNormalizer(AcceleratedUnit):
    """Unit form (ref: veles/mean_disp_normalizer.py:50): normalizes
    ``input`` with per-feature ``mean`` and reciprocal dispersion
    ``rdisp``, writing ``output`` in the compute dtype ``dtype``."""

    READS = ("input", "mean", "rdisp")
    WRITES = ("output",)

    def __init__(self, workflow, dtype=None, **kwargs):
        super(MeanDispNormalizer, self).__init__(workflow, **kwargs)
        self.input = None
        self.mean = None
        self.rdisp = None
        self.dtype = dtype
        self.output = Array()
        self.demand("input", "mean", "rdisp")

    def initialize(self, device=None, **kwargs):
        if not all(isinstance(getattr(self, a, None), Array) and
                   bool(getattr(self, a))
                   for a in ("input", "mean", "rdisp")):
            raise MissingDemand(self, {"input", "mean", "rdisp"})
        self.output.reset(numpy.zeros(self.input.shape, numpy.float32))
        super(MeanDispNormalizer, self).initialize(device=device, **kwargs)

    def step(self, input, mean, rdisp):
        return {"output": mean_disp_normalize(input, mean, rdisp,
                                              self.dtype)}
