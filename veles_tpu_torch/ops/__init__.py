"""Tensor ops of the port: plain PyTorch where the JAX package used
jnp, and a hand-written Hopper kernel (``csrc/``) where it used
Pallas.  Each kernel wrapper takes its plain PyTorch version for CPU
tensors and launches the kernel (or raises) for CUDA tensors."""

import ctypes

import torch

#: element-type codes of the kernels' C interface (csrc/common.cuh)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def ptr(t):
    """A tensor's device address as a ctypes pointer (None → null)."""
    return ctypes.c_void_p(t.data_ptr() if t is not None else 0)


def stream_ptr(device):
    """PyTorch's current stream on ``device``, for a kernel launch."""
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def softmax(x):
    """Softmax over the last axis with the JAX package's rounding
    points (``jax.nn.softmax``): ``exp(x - max)`` rounded to ``x``'s
    dtype, its sum taken in f32 and rounded, then the quotient.  In
    bfloat16 that rounds the exponentials once more than
    ``torch.softmax``, which would put the two packages an ulp apart."""
    e = torch.exp(x - x.amax(dim=-1, keepdim=True))
    return e / e.to(torch.float32).sum(dim=-1, keepdim=True).to(e.dtype)


def require(cond, msg, *args):
    if not cond:
        raise ValueError(msg % args if args else msg)


def check_cuda_inputs(what, device, **tensors):
    """Device and contiguity checks every kernel wrapper runs before a
    launch (None entries are skipped)."""
    for name, t in tensors.items():
        if t is None:
            continue
        require(t.device == device, "%s: %s lies on %s, not %s", what,
                name, t.device, device)
        require(t.is_contiguous(), "%s: %s must be contiguous", what, name)


def kernel_launches():
    """Every kernel wrapper's launch count in this process, by kernel
    name (what a worker reports when it stops)."""
    from veles_tpu_torch.ops import (
        flash_attention, gemm, lrn, paged_attend, random)
    out = {"paged_attend": paged_attend.launches,
           "int8_gemm": gemm.launches, "matmul": gemm.matmul_launches,
           "uniform_fill": random.launches}
    out.update(flash_attention.launches)
    out.update(lrn.launches)
    return out
