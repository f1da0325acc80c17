"""GEMM under the dtype policy, and the weight-only int8 GEMM — the
port of ``veles_tpu/ops/gemm.py``.

- :func:`matmul` is the policy matmul: operands rounded to the compute
  dtype, products summed in float32, an f32 result (what the JAX
  package's ``preferred_element_type=f32`` dot returns).
- :func:`int8_matmul` is the weight-only int8 product with the
  per-column dequant fused into the store: ``csrc/int8_gemm.cu`` for
  CUDA tensors, :func:`int8_matmul_plain` for CPU tensors.  It replaces
  ``pallas_matmul``'s ``col_scale`` epilogue path that
  ``int8_matmul`` takes in the JAX package.
"""

import ctypes

import torch

from veles_tpu_torch import _build
from veles_tpu_torch.ops import (
    DTYPE_CODES, check_cuda_inputs, ptr, require, stream_ptr)

#: symmetric int8 range of the per-column weight quantization
INT8_QMAX = 127.0

#: kernel launches so far (a plain count: the wrapper adds one per
#: launch and nothing else touches it but a caller resetting it)
launches = 0

_argtypes_set = False


def matmul(a, b, compute_dtype, out_dtype=None):
    """``a @ b`` with both operands rounded to ``compute_dtype`` and an
    f32 accumulation and result (cast to ``out_dtype`` if given)."""
    f32 = torch.float32
    out = torch.matmul(a.to(compute_dtype).to(f32),
                       b.to(compute_dtype).to(f32))
    return out.to(out_dtype) if out_dtype is not None else out


def int8_weight_quantize(w):
    """Per-output-column symmetric int8 quantization: ``w`` [k, n] →
    ``(wq int8 [k, n], scale f32 [n])`` with ``wq * scale ~= w``
    (absmax per column; an all-zero column gets scale 0 and
    dequantizes to exact zeros).  Bit-equal to the JAX function."""
    wf = w.to(torch.float32)
    amax = wf.abs().amax(dim=0)
    scale = amax / INT8_QMAX
    q = torch.where(scale[None, :] > 0.0,
                    wf / torch.clamp(scale[None, :], min=1e-30),
                    torch.zeros_like(wf))
    q = torch.clamp(torch.round(q), -INT8_QMAX, INT8_QMAX)
    return q.to(torch.int8), scale


def int8_matmul_plain(a, wq, scale, out_dtype=torch.float32):
    """Plain PyTorch version: ``(a @ wq) * scale`` in f32 — ``a``
    [m, k] f32/bf16 (exact in f32), ``wq`` [k, n] int8, ``scale`` [n]
    f32."""
    acc = torch.matmul(a.to(torch.float32), wq.to(torch.float32))
    return (acc * scale.to(torch.float32)[None, :]).to(out_dtype)


def _lib():
    global _argtypes_set
    lib = _build.library("int8_gemm")
    if not _argtypes_set:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.veles_int8_gemm.argtypes = [vp, ci, vp, vp, vp, ci, ci, ci, vp]
        lib.veles_int8_gemm.restype = ci
        lib.veles_int8_gemm_plan.argtypes = [ci, ci, ci, ci,
                                             ctypes.POINTER(ci)]
        lib.veles_int8_gemm_plan.restype = None
        _argtypes_set = True
    return lib


def plan(m, k, n, dtype):
    """The kernel's launch plan for ``a`` [m, k] of ``dtype`` by ``wq``
    [k, n]: output columns per CTA, the cluster size along k, the k
    rows per cluster rank, and the activation rows per CTA.  Needs the
    built library (the card's machine)."""
    out = (ctypes.c_int * 4)()
    _lib().veles_int8_gemm_plan(m, k, n, DTYPE_CODES[dtype], out)
    return dict(zip(("cols", "cluster", "k_per_rank", "rows"), out))


def int8_matmul(a, wq, scale, out_dtype=torch.float32):
    """Weight-only int8 GEMM ``(a @ wq) * scale`` (signature of
    :func:`int8_matmul_plain`): the plain version for CPU tensors, the
    ``sm_90a`` kernel for CUDA tensors.  Every shape is taken (ragged
    edges are masked in the kernel).  Raises on anything the kernel
    does not take."""
    global launches
    if a.device.type == "cpu":
        return int8_matmul_plain(a, wq, scale, out_dtype=out_dtype)
    require(a.device.type == "cuda", "int8_matmul: unsupported device %s",
            a.device)
    require(a.dim() == 2 and wq.dim() == 2 and a.shape[1] == wq.shape[0],
            "int8_matmul: %s @ %s", tuple(a.shape), tuple(wq.shape))
    m, k = a.shape
    n = wq.shape[1]
    require(a.dtype in (torch.float32, torch.bfloat16),
            "int8_matmul: activation dtype %s", a.dtype)
    require(wq.dtype == torch.int8, "int8_matmul: weights must be int8")
    require(scale.dtype == torch.float32 and tuple(scale.shape) == (n,),
            "int8_matmul: scale must be f32 [%d]", n)
    check_cuda_inputs("int8_matmul", a.device, a=a, wq=wq, scale=scale)
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    if m and n:
        rc = _lib().veles_int8_gemm(
            ptr(a), DTYPE_CODES[a.dtype], ptr(wq), ptr(scale), ptr(out),
            m, k, n, stream_ptr(a.device))
        _build.check(rc, "int8_gemm launch")
        launches += 1
    return out if out_dtype == torch.float32 else out.to(out_dtype)
