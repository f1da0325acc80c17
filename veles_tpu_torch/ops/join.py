"""InputJoiner — concatenate N inputs along the feature axis (the port
of ``veles_tpu/ops/join.py``): each input is flattened past its batch
axis and the rows are joined with ``torch.cat``."""

import numpy
import torch

from veles_tpu_torch.accelerated_units import AcceleratedUnit
from veles_tpu_torch.memory import Array
from veles_tpu_torch.units import MissingDemand


class InputJoiner(AcceleratedUnit):
    """Joins ``inputs`` (a list of Arrays) into ``output`` along axis
    1, flattening trailing dims (ref: veles/input_joiner.py:49)."""

    WRITES = ("output",)

    def __init__(self, workflow=None, inputs=None, **kwargs):
        super(InputJoiner, self).__init__(workflow, **kwargs)
        self.inputs = list(inputs) if inputs else []
        self.output = Array()
        for i, arr in enumerate(self.inputs):
            setattr(self, "input_%d" % i, arr)

    @property
    def reads(self):
        return tuple("input_%d" % i for i in range(len(self.inputs)))

    def link_inputs(self, other, *attrs):
        """Append ``other``'s attrs to the join list."""
        for a in attrs:
            arr = getattr(other, a)
            setattr(self, "input_%d" % len(self.inputs), arr)
            self.inputs.append(arr)
        return self

    def initialize(self, device=None, **kwargs):
        if not self.inputs or not all(bool(a) for a in self.inputs):
            raise MissingDemand(self, {"inputs"})
        batch = self.inputs[0].shape[0]
        width = sum(int(numpy.prod(a.shape[1:])) for a in self.inputs)
        self.output.reset(numpy.zeros((batch, width),
                                      self.inputs[0].dtype))
        super(InputJoiner, self).initialize(device=device, **kwargs)

    def step(self, **tensors):
        flat = [tensors["input_%d" % i].reshape(
            tensors["input_%d" % i].shape[0], -1)
            for i in range(len(self.inputs))]
        return {"output": torch.cat(flat, dim=1)}
