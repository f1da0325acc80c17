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

// 4 int8 in a word -> their exact values in f32, without I2F: the byte
// biased by 128 becomes the low mantissa byte of 2^23 (0x4B0000uu =
// 2^23 + u), and one subtraction of 2^23 + 128 leaves u - 128 = x
__device__ __forceinline__ void widen4(uint32_t w, float (&f)[4]) {
  const uint32_t u = w ^ 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 | i))
        - 8388736.0f;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

}  // namespace veles
