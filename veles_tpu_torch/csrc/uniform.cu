// Uniform [0, 1) float32 fill: jax.random.uniform(key, shape) bit for bit.
//
// Replaces: veles_tpu/ops/random.py::pallas_uniform (Pallas body
// _pallas_uniform_kernel), which reads the TPU's hardware PRNG.  Those
// bits have no specification off the TPU, and every path this kernel
// stands in for on the card (the synthetic ImageNet dataset drawn with
// key(42), the dropout masks bernoulli(key, keep) = uniform(key) < keep)
// draws jax.random.uniform's Threefry stream.  So the kernel computes that
// stream: element i (row-major, 64-bit) hashes the count words
// (i >> 32, i & 0xFFFFFFFF) with Threefry-2x32 (20 rounds) under the
// key, XORs the two output words, puts the top 23 bits in the mantissa of
// a float in [1, 2) and subtracts 1.  It meets the TPU kernel's contract
// (uniform in [0, 1) from a seed) and is strictly tighter.
//
// What bounds it on the card: integer operations.  Each element costs
// about 78 32-bit operations (20 rounds of add, rotate and xor, 5 key
// injections, the initial key add, the final xor, shift, or and float
// subtract) against 4 bytes written; at the SM's issue limit of 128
// lanes per clock the work takes ~2x longer than the write.  What the
// design does about it: the rotations are single funnel shifts, the key
// schedule is computed once per thread, and each thread writes 4
// consecutive floats with one 16-byte store; a grid-stride loop keeps
// every SM busy at any size.
//
// Trap: the index is 64-bit.  The count's high word becomes nonzero past
// 2**32 elements; `offset` shifts the whole index range so a check can
// reach that word without allocating 2**32 floats.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;   // floats per thread per iteration

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

__device__ __forceinline__ float threefry_uniform(uint32_t k0, uint32_t k1,
                                                  uint32_t k2,
                                                  uint64_t idx) {
  uint32_t x0 = static_cast<uint32_t>(idx >> 32) + k0;
  uint32_t x1 = static_cast<uint32_t>(idx) + k1;
  const uint32_t ks[3] = {k0, k1, k2};
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const int r0 = (i % 2) ? 17 : 13, r1 = (i % 2) ? 29 : 15;
    const int r2 = (i % 2) ? 16 : 26, r3 = (i % 2) ? 24 : 6;
    x0 += x1; x1 = rotl(x1, r0) ^ x0;
    x0 += x1; x1 = rotl(x1, r1) ^ x0;
    x0 += x1; x1 = rotl(x1, r2) ^ x0;
    x0 += x1; x1 = rotl(x1, r3) ^ x0;
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
  const uint32_t bits = (x0 ^ x1) >> 9 | 0x3F800000u;
  return __uint_as_float(bits) - 1.0f;
}

__global__ void __launch_bounds__(kThreads) uniform_fill_kernel(
    uint32_t k0, uint32_t k1, uint64_t offset, int64_t n,
    float* __restrict__ out) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  const int64_t groups = (n + kVec - 1) / kVec;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t g = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       g < groups; g += stride) {
    const int64_t i0 = g * kVec;
    if (i0 + kVec <= n) {
      float4 v;
      v.x = threefry_uniform(k0, k1, k2, offset + i0);
      v.y = threefry_uniform(k0, k1, k2, offset + i0 + 1);
      v.z = threefry_uniform(k0, k1, k2, offset + i0 + 2);
      v.w = threefry_uniform(k0, k1, k2, offset + i0 + 3);
      *reinterpret_cast<float4*>(out + i0) = v;
    } else {
      for (int64_t i = i0; i < n; ++i)
        out[i] = threefry_uniform(k0, k1, k2, offset + i);
    }
  }
}

}  // namespace

// out [n] f32, 16-byte aligned; element i gets the uniform of count
// offset + i under key (k0, k1).  Returns cudaGetLastError() after the
// launch.
extern "C" int veles_uniform_fill(uint32_t k0, uint32_t k1, uint64_t offset,
                                  int64_t n, void* out, void* stream) {
  int sms = 0, dev = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int64_t groups = (n + kVec - 1) / kVec;
  int64_t blocks = (groups + kThreads - 1) / kThreads;
  const int64_t cap = static_cast<int64_t>(sms > 0 ? sms : 132) * 8;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  uniform_fill_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      k0, k1, offset, n, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
