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
- :func:`pallas_matmul` is the general form of that kernel, with the
  JAX function's signature: ``epilogue(a @ b [* col_scale])`` summed
  in f32, ``csrc/matmul.cu`` for CUDA tensors and
  :func:`pallas_matmul_plain` for CPU tensors.
"""

import ctypes

import torch

from veles_tpu_torch import _build
from veles_tpu_torch.ops import (
    DTYPE_CODES, check_cuda_inputs, ptr, require, stream_ptr)

#: symmetric int8 range of the per-column weight quantization
INT8_QMAX = 127.0

#: kernel launches so far (a plain count: the wrapper adds one per
#: launch and nothing else touches it but a caller resetting it):
#: ``int8_gemm``'s, and ``matmul``'s (:func:`pallas_matmul`)
launches = 0
matmul_launches = 0

_argtypes_set = False
_mm_argtypes_set = False

#: epilogues the matmul kernel fuses into its store (as ReLU)
_RELU = {"relu", torch.relu, torch.nn.functional.relu}


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


# -- the general tiled GEMM ---------------------------------------------------

def _mm_lib():
    global _mm_argtypes_set
    lib = _build.library("matmul")
    if not _mm_argtypes_set:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.veles_matmul.argtypes = [vp, ci, vp, ci, vp, vp, ci, ci, ci, ci,
                                     ci, ci, vp]
        lib.veles_matmul.restype = ci
        lib.veles_matmul_plan.argtypes = [vp, ci, vp, ci, ci, ci, ci, ci,
                                          ctypes.POINTER(ci)]
        lib.veles_matmul_plan.restype = None
        _mm_argtypes_set = True
    return lib


def _check_matmul(a, b, block_m, block_n, block_k, precision, col_scale):
    """The JAX function's preconditions: ``a`` [m, k] f32/bf16, ``b``
    [k, n] of ``a``'s type or int8, ``m``, ``n`` and ``k`` tiling evenly
    by ``min(block, dim)``; ``precision`` None or "highest" (f32 sums
    are always exact f32); ``col_scale`` f32 [n]."""
    require(a.dim() == 2 and b.dim() == 2 and a.shape[1] == b.shape[0],
            "pallas_matmul: %s @ %s", tuple(a.shape), tuple(b.shape))
    require(a.dtype in (torch.float32, torch.bfloat16),
            "pallas_matmul: a must be float32 or bfloat16, not %s", a.dtype)
    require(b.dtype in (a.dtype, torch.int8),
            "pallas_matmul: b must be %s or int8, not %s", a.dtype, b.dtype)
    m, k = a.shape
    n = b.shape[1]
    bm, bn, bk = min(block_m, m), min(block_n, n), min(block_k, k)
    require(bm > 0 and bn > 0 and bk > 0
            and m % bm == 0 and n % bn == 0 and k % bk == 0,
            "pallas_matmul: shapes must tile evenly; pad first (%s @ %s at "
            "blocks %d/%d/%d)", tuple(a.shape), tuple(b.shape), block_m,
            block_n, block_k)
    require(precision is None or str(precision).lower() == "highest",
            "pallas_matmul: precision must be None or 'highest', not %r",
            precision)
    require(col_scale is None or (col_scale.dtype == torch.float32
                                  and tuple(col_scale.shape) == (n,)),
            "pallas_matmul: col_scale must be f32 [%d]", n)


def _epilogue_out(acc, epilogue, out_dtype):
    if epilogue is not None:
        acc = epilogue(acc)
    return acc.to(out_dtype)


def pallas_matmul_plain(a, b, block_m=256, block_n=256, block_k=512,
                        epilogue=None, out_dtype=torch.float32,
                        precision=None, col_scale=None):
    """Plain PyTorch version of :func:`pallas_matmul`: ``a @ b`` in f32
    (``b`` widened to ``a``'s type first, as the TPU kernel does; both
    products are exact in f32), times ``col_scale``, then ``epilogue``
    (``"relu"`` or a callable), cast to ``out_dtype``."""
    _check_matmul(a, b, block_m, block_n, block_k, precision, col_scale)
    if epilogue == "relu":
        epilogue = torch.relu
    acc = torch.matmul(a.to(torch.float32),
                       b.to(a.dtype).to(torch.float32))
    if col_scale is not None:
        acc = acc * col_scale[None, :]
    return _epilogue_out(acc, epilogue, out_dtype)


#: the kernel's variants, in the order of ``enum Variant`` in
#: ``csrc/matmul.cu``
MATMUL_VARIANTS = ("tc_big", "tc_small", "simt_big", "simt_small", "wgmma",
                   "split_k", "simt_pipe")

#: the C entry's own error codes (beside ``cudaError_t``)
_MM_ERRORS = {-1: "unsupported types", -3: "the forced variant does not "
              "take these operands", -4: "no cuTensorMapEncodeTiled in "
              "libcuda", -5: "libcuda refused a tensor map"}


def matmul_plan(a, b, variant=None):
    """The matmul kernel's launch plan for these operands: variant
    (``wgmma`` — TMA and ``wgmma`` — for bf16 ``a`` and ``b`` with k
    and n multiples of 8 and 16-byte aligned bases at large m and n,
    ``split_k`` for those at small m, ``simt_pipe`` for f32 ``a`` and
    ``b`` with n a multiple of 4 and ``b`` 16-byte aligned; else the
    register-staged ``tc_big``/``tc_small`` for bf16 ``a`` and
    ``simt_big``/``simt_small`` for f32), tile rows and columns, k per
    tile, threads per CTA, whether it takes the vector loads, stages in
    flight, the cluster size along k and the k rows per cluster rank
    (``split_k``), and the CTAs launched.
    ``variant`` (``"wgmma"`` or ``"split_k"``) asks for the plan that
    variant makes for these operands instead (:func:`matmul_variant`);
    its ``variant`` is None where these operands cannot take it.  Needs
    the built library (the card's machine)."""
    out = (ctypes.c_int * 10)()
    m, k = a.shape
    code = -1 if variant is None else MATMUL_VARIANTS.index(variant)
    _mm_lib().veles_matmul_plan(ptr(a), DTYPE_CODES[a.dtype], ptr(b),
                                DTYPE_CODES[b.dtype], m, k, b.shape[1],
                                code, out)
    return dict(zip(("variant", "bm", "bn", "bk", "threads", "aligned",
                     "stages", "cluster", "k_per_rank", "ctas"),
                    [MATMUL_VARIANTS[out[0]] if out[0] >= 0 else None]
                    + list(out[1:5]) + [bool(out[5])] + list(out[6:10])))


def _mm_launch(a, b, col_scale, store, relu, variant):
    global matmul_launches
    m, k = a.shape
    n = b.shape[1]
    out = torch.empty((m, n), dtype=store, device=a.device)
    if m and n:
        rc = _mm_lib().veles_matmul(
            ptr(a), DTYPE_CODES[a.dtype], ptr(b), DTYPE_CODES[b.dtype],
            ptr(col_scale), ptr(out), int(store == torch.bfloat16),
            int(relu), m, k, n, variant, stream_ptr(a.device))
        if rc in _MM_ERRORS:
            raise RuntimeError("matmul launch failed: " + _MM_ERRORS[rc])
        _build.check(rc, "matmul launch")
        matmul_launches += 1
    return out


def matmul_variant(a, b, variant):
    """``a @ b`` (f32 result) on ``variant``, ``"wgmma"`` or
    ``"split_k"``, whichever the plan would pick — for timing the two
    across their crossover in m.  CUDA tensors only; raises where the
    variant does not take them."""
    require(a.device.type == "cuda", "matmul_variant: CUDA tensors only")
    _check_matmul(a, b, 1 << 30, 1 << 30, 1 << 30, None, None)
    check_cuda_inputs("matmul_variant", a.device, a=a, b=b)
    return _mm_launch(a, b, None, torch.float32, False,
                      MATMUL_VARIANTS.index(variant))


def pallas_matmul(a, b, block_m=256, block_n=256, block_k=512,
                  epilogue=None, out_dtype=torch.float32, precision=None,
                  col_scale=None):
    """Tiled GEMM with a fused epilogue — the port of the JAX
    ``pallas_matmul`` (signature of :func:`pallas_matmul_plain`): the
    plain version for CPU tensors, ``csrc/matmul.cu`` for CUDA tensors.

    ``a`` [m, k] f32 or bf16; ``b`` [k, n] of ``a``'s type or int8
    (widened to ``a``'s type); products summed in f32 — for f32
    operands always exact f32 (``precision`` None or "highest"; never
    TF32).  ``col_scale`` ([n] f32) multiplies each column before
    ``epilogue``.  The kernel fuses ``epilogue`` None, ``"relu"``,
    ``torch.relu`` and ``torch.nn.functional.relu`` into its store;
    any other callable is applied to the kernel's f32 result and then
    cast to ``out_dtype``: the same values, only the fusion is lost.
    ``m``, ``n`` and ``k`` must tile evenly by ``min(block, dim)`` as in
    the JAX function (``block_*`` only check that; the kernel picks its
    own tiles, :func:`matmul_plan`).  Raises on anything else.

    Two calls on the same operands give the same bits.  The plan also
    reads the card's SM count and whether the operands' addresses are
    16-byte aligned, so bit equality holds only for operands of the same
    shape and alignment on the same card: a view one element into its
    buffer runs another variant, which sums in another order."""
    if a.device.type == "cpu":
        return pallas_matmul_plain(a, b, block_m, block_n, block_k,
                                   epilogue, out_dtype, precision,
                                   col_scale)
    require(a.device.type == "cuda", "pallas_matmul: unsupported device %s",
            a.device)
    _check_matmul(a, b, block_m, block_n, block_k, precision, col_scale)
    check_cuda_inputs("pallas_matmul", a.device, a=a, b=b,
                      col_scale=col_scale)
    fused = epilogue is None or epilogue in _RELU
    store = out_dtype if fused else torch.float32
    require(store in (torch.float32, torch.bfloat16),
            "pallas_matmul: out_dtype %s (the kernel stores f32 or bf16)",
            store)
    out = _mm_launch(a, b, col_scale, store,
                     fused and epilogue is not None, -1)
    return out if fused else _epilogue_out(out, epilogue, out_dtype)
