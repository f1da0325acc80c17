// Weight-only int8 GEMM with the per-column dequant scale fused into the
// store: out[m, n] = (sum_k a[m, k] * w[k, n]) * scale[n], in f32.
//
// Replaces: veles_tpu/ops/gemm.py::pallas_matmul (Pallas body _mm_kernel)
// as int8_matmul calls it — int8 weight tiles widened to the activation
// dtype, an f32 accumulator, and the col_scale multiply on the last K
// step before the store.  Int8 -> bf16/f32 is exact for |v| <= 127, so
// every product equals the TPU kernel's; only the order of the sum
// differs.
//
// What bounds it on the card: bytes.  On the decode path m is the
// occupancy bucket (<= 8 rows), so each weight byte feeds at most 8
// multiply-adds: the k*n int8 weights dominate the traffic and the time
// floor is k*n bytes over HBM bandwidth.  What the design does about it:
// the weights are read once, as int8 (a quarter of the f32 bytes a
// dequantize-first product would move), coalesced along n; the m <= 8
// activation rows are staged in shared memory and reused by every
// weight; the scale is applied once per output instead of rescaling the
// weight matrix.  A GEMV-like shape, so no tensor cores are needed yet.
//
// Layout: each CTA owns a strip of 32 output columns and up to 8 rows.
// Its 256 threads form 8 column groups (4 adjacent columns each, one
// 4-byte load per k) by 32 k-slices; the slices' partial sums meet in
// shared memory for the epilogue.  Ragged m, n and k are masked, so
// every shape is taken (the JAX package falls back to an XLA dot for
// shapes that do not tile; the same function, so no fallback here).
#include "common.cuh"

namespace {

using veles::to_f;

constexpr int kCols = 32;     // output columns per CTA
constexpr int kRows = 8;      // activation rows per CTA
constexpr int kSlices = 32;   // k-slices per CTA
constexpr int kTileK = 256;   // k staged in shared memory per pass
constexpr int kThreads = (kCols / 4) * kSlices;   // 256

template <typename AT>
__global__ void __launch_bounds__(kThreads) int8_gemm_kernel(
    const AT* __restrict__ a, const int8_t* __restrict__ w,
    const float* __restrict__ scale, float* __restrict__ out, int m, int k,
    int n) {
  __shared__ float a_s[kRows][kTileK];
  __shared__ float red[kSlices][kRows][kCols];

  const int tid = threadIdx.x;
  const int cg = tid % (kCols / 4);
  const int slice = tid / (kCols / 4);
  const int n0 = blockIdx.x * kCols + cg * 4;
  const int m0 = blockIdx.y * kRows;
  const int rows = min(kRows, m - m0);
  // 4-byte weight loads need n % 4 == 0 (row starts stay aligned) and a
  // whole group of columns inside the matrix
  const bool vec = (n % 4 == 0) && (n0 + 3 < n);

  float acc[kRows][4];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[i][q] = 0.f;

  for (int k0 = 0; k0 < k; k0 += kTileK) {
    const int kt = min(kTileK, k - k0);
    for (int i = tid; i < kRows * kTileK; i += kThreads) {
      const int mm = i / kTileK;
      const int kk = i - mm * kTileK;
      a_s[mm][kk] = (mm < rows && kk < kt)
          ? to_f(a[static_cast<size_t>(m0 + mm) * k + k0 + kk]) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = slice; kk < kt; kk += kSlices) {
      const int8_t* wr = w + static_cast<size_t>(k0 + kk) * n;
      float wv[4];
      if (vec) {
        const char4 c4 = *reinterpret_cast<const char4*>(wr + n0);
        wv[0] = c4.x; wv[1] = c4.y; wv[2] = c4.z; wv[3] = c4.w;
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          wv[q] = (n0 + q < n) ? static_cast<float>(wr[n0 + q]) : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float av = a_s[i][kk];
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][q] = fmaf(av, wv[q], acc[i][q]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) red[slice][i][cg * 4 + q] = acc[i][q];
  __syncthreads();
  // epilogue: one output per thread (8 rows x 32 columns = 256)
  const int i = tid / kCols;
  const int cc = tid - i * kCols;
  const int colg = blockIdx.x * kCols + cc;
  if (i < rows && colg < n) {
    float s = 0.f;
#pragma unroll 8
    for (int sl = 0; sl < kSlices; ++sl) s += red[sl][i][cc];
    out[static_cast<size_t>(m0 + i) * n + colg] = s * scale[colg];
  }
}

}  // namespace

// a [m, k] (f32 or bf16), w [k, n] int8, scale [n] f32, out [m, n] f32;
// all contiguous.  Returns cudaGetLastError() after the launch (-1:
// unknown dtype).
extern "C" int veles_int8_gemm(const void* a, int a_dtype, const void* w,
                               const void* scale, void* out, int m, int k,
                               int n, void* stream) {
  const dim3 grid((n + kCols - 1) / kCols, (m + kRows - 1) / kRows);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* wp = static_cast<const int8_t*>(w);
  const float* sp = static_cast<const float*>(scale);
  float* op = static_cast<float*>(out);
  switch (a_dtype) {
    case veles::kF32:
      int8_gemm_kernel<float><<<grid, kThreads, 0, st>>>(
          static_cast<const float*>(a), wp, sp, op, m, k, n);
      break;
    case veles::kBF16:
      int8_gemm_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
          static_cast<const __nv_bfloat16*>(a), wp, sp, op, m, k, n);
      break;
    default:
      return -1;
  }
  return static_cast<int>(cudaGetLastError());
}
