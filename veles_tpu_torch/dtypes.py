"""Dtype policy: the compute dtype feeds matmul operands (bfloat16 by
default, float32 for parity tests), the accumulate dtype is float32.

The JAX package reads these from ``root.common.precision``; the port
takes the compute dtype as an explicit argument (``dtype=`` on the chain
builders).  Its sums and master parameters are float32 and its f32
products exact, so :func:`check_precision` refuses, by key, a tree that
asks for anything else.
"""

import torch

# A float32 matrix product or convolution on the card must run in full
# float32, as it does on the CPU and in the JAX reference: TF32 keeps
# about three decimal digits and would break f32 parity.  Matmuls
# already default to full precision; cuDNN convolutions do not.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

COMPUTE_DTYPE = torch.bfloat16
ACCUM_DTYPE = torch.float32

_NAMES = {
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
}


def resolve(dtype=None):
    """``None`` → the default compute dtype; a name or a torch dtype
    → that dtype."""
    if dtype is None:
        return COMPUTE_DTYPE
    if isinstance(dtype, str):
        try:
            return _NAMES[dtype]
        except KeyError:
            raise ValueError("unknown compute dtype %r" % dtype)
    if dtype not in _NAMES.values():
        raise ValueError("unsupported compute dtype %r" % (dtype,))
    return dtype


#: ``root.common.precision`` values the port computes: float32 sums and
#: master parameters; ``level`` 0 (the backend's default, exact float32
#: on the CPU and on the card with TF32 off) or 2 (``highest``).  Level 1
#: (the TPU's bf16x3 passes) is not taken.
PRECISION_TAKEN = {"accum_dtype": ("float32",),
                   "param_dtype": ("float32",),
                   "level": (0, 2)}


def check_precision():
    """Raise ``ValueError`` naming the key when ``root.common.precision``
    asks for a sum, parameter dtype or matmul precision the port does
    not compute (the reference's ``dtypes.accum_dtype``,
    ``param_dtype`` and ``matmul_precision`` read them)."""
    from veles_tpu_torch.config import root
    prec = root.common.precision
    for key, taken in PRECISION_TAKEN.items():
        value = prec.get(key, taken[0])
        if value not in taken:
            raise ValueError(
                "root.common.precision.%s = %r: the port computes %s "
                "only" % (key, value, " or ".join(map(repr, taken))))
