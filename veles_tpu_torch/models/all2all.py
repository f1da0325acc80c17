"""Fully-connected layers — the port of ``veles_tpu/models/all2all.py``.

``x`` is flattened to ``[batch, features]`` in its own (NHWC) order, so
the ``[in, out]`` weights line up with the JAX package's.  Hidden layers
return the compute dtype (``ops.gemm.matmul``: operands in the compute
dtype, an f32 sum); the softmax head keeps the f32 product for its
logits, from which the trainer's loss is taken.
"""

import numpy
import torch

from veles_tpu_torch.models.activations import get_activation
from veles_tpu_torch.models.nn_units import ForwardBase
from veles_tpu_torch.ops.gemm import matmul


class All2All(ForwardBase):
    """``y = activation(x @ W + b)``."""

    ACTIVATION = "linear"
    PARAMS = ("weights", "bias")

    def __init__(self, output_sample_shape=None, output_samples_number=None,
                 activation=None, device=None, dtype=None, **hyper):
        super().__init__(device=device, dtype=dtype, **hyper)
        if output_sample_shape is None and output_samples_number is None:
            raise ValueError("output_sample_shape is required")
        self.output_sample_shape = tuple(numpy.atleast_1d(
            output_sample_shape or output_samples_number).tolist())
        self.activation = activation or self.ACTIVATION

    @property
    def neurons_number(self):
        return int(numpy.prod(self.output_sample_shape))

    def param_shapes(self, in_shape, window):
        return {"weights": (int(numpy.prod(in_shape)), self.neurons_number),
                "bias": (self.neurons_number,)}

    def out_shape(self, in_shape):
        return self.output_sample_shape

    def export_config(self):
        return {"output_sample_shape": list(self.output_sample_shape),
                "activation": self.activation, "include_bias": True}

    def apply(self, x):
        y = matmul(x.reshape(x.shape[0], -1), self.params["weights"],
                   self.dtype, out_dtype=self.dtype) + self.cast("bias")
        y = get_activation(self.activation)(y)
        return y.reshape((x.shape[0],) + self.output_sample_shape)


class All2AllTanh(All2All):
    ACTIVATION = "tanh"


class All2AllRELU(All2All):
    ACTIVATION = "relu"


class All2AllStrictRELU(All2All):
    ACTIVATION = "strict_relu"


class All2AllSigmoid(All2All):
    ACTIVATION = "sigmoid"


class All2AllSoftmax(All2All):
    """The classifier head: :meth:`logits` (f32) for the trainer's
    loss, :meth:`apply` the probabilities."""

    def logits(self, x):
        z = matmul(x.reshape(x.shape[0], -1), self.params["weights"],
                   self.dtype) + self.params["bias"]
        z = get_activation(self.activation)(z)
        return z.reshape((x.shape[0],) + self.output_sample_shape)

    def apply(self, x):
        z = self.logits(x)
        e = torch.exp(z - z.amax(dim=-1, keepdim=True))
        return e / e.sum(dim=-1, keepdim=True)
