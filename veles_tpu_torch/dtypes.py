"""Dtype policy: the compute dtype feeds matmul operands (bfloat16 by
default, float32 for parity tests), the accumulate dtype is float32.

The JAX package reads these from ``root.common.precision``; the port
takes them as explicit arguments (``dtype=`` on the chain builders)
and keeps only the defaults here.
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
