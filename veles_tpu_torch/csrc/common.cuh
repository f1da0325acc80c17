// Shared helpers of the port's kernels: element-type codes the Python
// wrappers pass across the C interface, and widening loads to float.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace veles {

// dtype codes (DTYPE_CODES in veles_tpu_torch/ops/__init__.py)
enum DType : int { kF32 = 0, kBF16 = 1, kI8 = 2 };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(int8_t x) {
  return static_cast<float>(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

}  // namespace veles
