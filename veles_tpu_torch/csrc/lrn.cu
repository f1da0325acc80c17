// Cross-channel local response normalization over the last axis of
// [R, C] rows (NHWC activations flattened), forward and recompute
// backward:
//
//   s_c = k + alpha * sum_{j in [c - half, c + n - 1 - half]} x_j^2
//   y_c = x_c * s_c^-beta
//   dx_i = dy_i * p_i - 2*alpha*beta * x_i * u_i,   p = s^-beta,
//   u_i  = sum_{c : i in window(c)} t_c,  t_c = dy_c * x_c * p_c / s_c
//
// with half = n / 2 and the window clipped to the row's channels.
//
// Replaces: veles_tpu/ops/lrn.py::lrn_pallas (forward _lrn_fwd_kernel,
// backward _lrn_bwd_kernel under the custom VJP _lrn_rows).  The TPU
// kernels sum each window as a band matmul on the MXU and pack narrow
// rows to lane multiples; neither trick exists here.  The rounding
// points are the TPU kernel's: the squares in x's type (bf16 rounds
// them), window sums and the power in f32, t rounded to x's type before
// the transposed window sum, one rounding of y and dx to x's type.  For
// beta = 0.75 the power is rsqrt(s) * sqrt(rsqrt(s)) as in the JAX
// package.
//
// The transposed window: i lies in window(c) iff
// c in [i - (n - 1 - half), i + half].  For odd n that is the same
// window; for even n it is its mirror image.
//
// What bounds it on the card: bytes.  A handful of flops per element
// against 4 (forward, bf16: x in, y out) or 6 bytes (backward: x, dy in,
// dx out).  What the design does about it: each CTA owns a contiguous
// tile of kTile elements of the flattened array and stages it, with a
// halo of n - 1 elements on each side, in shared memory, so every input
// byte is read from device memory about once and every window sum reads
// shared memory only.  Windows never leave their row: the channel of
// each element bounds its window, so tiles need not align to rows and
// any C works.  The backward recomputes s from x (the TPU kernel's
// choice): the residual is x alone.
#include "common.cuh"

namespace {

using veles::to_f;

constexpr int kThreads = 256;
constexpr int kTile = 2048;   // output elements per CTA

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// v rounded to T and widened back (the TPU kernel's rounding points)
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

struct Params {
  float alpha, beta, k, c2ab;   // c2ab = 2 * alpha * beta
  int n, half, is075;
  int C;
  int64_t total;                // R * C
};

__device__ __forceinline__ float power(float s, const Params& p) {
  if (p.is075) {
    const float r = rsqrtf(s);
    return __fmul_rn(r, sqrtf(r));
  }
  return powf(s, -p.beta);
}

// s of the element at local position `pos` of a staged square array
// `sq` whose index 0 is the element at global index `base`; `ch` is the
// element's channel.
__device__ __forceinline__ float window_s(const float* sq, int pos, int ch,
                                          const Params& p) {
  const int lo = max(0, ch - p.half);
  const int hi = min(p.C - 1, ch + p.n - 1 - p.half);
  float acc = 0.f;
  for (int j = lo; j <= hi; ++j) acc = __fadd_rn(acc, sq[pos + j - ch]);
  return __fadd_rn(p.k, __fmul_rn(p.alpha, acc));
}

// Stage x (widened) and its rounded square for global indices
// [lo, lo + len) into xs / sq (zeros outside the array).
template <typename T>
__device__ __forceinline__ void stage(const T* __restrict__ x, int64_t lo,
                                      int len, const Params& p, float* xs,
                                      float* sq) {
  for (int i = threadIdx.x; i < len; i += kThreads) {
    const int64_t g = lo + i;
    float v = 0.f;
    if (g >= 0 && g < p.total) v = to_f(x[g]);
    xs[i] = v;
    sq[i] = round_to<T>(v * v);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) lrn_fwd_kernel(
    const T* __restrict__ x, T* __restrict__ y, Params p) {
  extern __shared__ float smem[];
  const int64_t e0 = static_cast<int64_t>(blockIdx.x) * kTile;
  const int len = kTile + p.n - 1;          // tile + halo
  float* xs = smem;
  float* sq = smem + len;
  stage<T>(x, e0 - p.half, len, p, xs, sq);
  __syncthreads();
  const int c0 = static_cast<int>(e0 % p.C);
  for (int l = threadIdx.x; l < kTile; l += kThreads) {
    const int64_t e = e0 + l;
    if (e >= p.total) break;
    const int ch = (c0 + l) % p.C;
    const int pos = l + p.half;
    const float s = window_s(sq, pos, ch, p);
    y[e] = from_f<T>(__fmul_rn(xs[pos], power(s, p)));
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) lrn_bwd_kernel(
    const T* __restrict__ x, const T* __restrict__ dy, T* __restrict__ dx,
    Params p) {
  extern __shared__ float smem[];
  const int64_t e0 = static_cast<int64_t>(blockIdx.x) * kTile;
  const int h = p.n - 1;
  const int len = kTile + 2 * h;            // squares: [e0 - h, e0 + kTile + h)
  const int tlen = kTile + h;               // t: [e0 - (h - half), ... + half)
  float* xs = smem;
  float* sq = xs + len;
  float* ts = sq + len;
  stage<T>(x, e0 - h, len, p, xs, sq);
  __syncthreads();
  const int tlo = h - p.half;               // t's first element is e0 - tlo
  const int64_t row0 = e0 - tlo;
  const int ct = static_cast<int>(((row0 % p.C) + p.C) % p.C);
  for (int q = threadIdx.x; q < tlen; q += kThreads) {
    const int64_t g = row0 + q;
    float t = 0.f;
    if (g >= 0 && g < p.total) {
      const int ch = (ct + q) % p.C;
      const int pos = q + p.half;           // position of g in xs / sq
      const float s = window_s(sq, pos, ch, p);
      const float pw = power(s, p);
      const float d = to_f(dy[g]);
      t = round_to<T>(__fmul_rn(__fmul_rn(d, xs[pos]), __fdiv_rn(pw, s)));
    }
    ts[q] = t;
  }
  __syncthreads();
  const int c0 = static_cast<int>(e0 % p.C);
  for (int l = threadIdx.x; l < kTile; l += kThreads) {
    const int64_t e = e0 + l;
    if (e >= p.total) break;
    const int ch = (c0 + l) % p.C;
    const int pos = l + h;
    const float s = window_s(sq, pos, ch, p);
    const float pw = power(s, p);
    // u: t over c in [ch - (h - half), ch + half], clipped to the row
    const int lo = max(0, ch - (h - p.half));
    const int hi = min(p.C - 1, ch + p.half);
    const int tq = l + tlo;                 // position of e in ts
    float u = 0.f;
    for (int c = lo; c <= hi; ++c) u = __fadd_rn(u, ts[tq + c - ch]);
    const float d = to_f(dy[e]);
    const float v = __fsub_rn(__fmul_rn(d, pw),
                              __fmul_rn(__fmul_rn(p.c2ab, xs[pos]), u));
    dx[e] = from_f<T>(v);
  }
}

Params make_params(int64_t rows, int c, int n, float alpha, float beta,
                   float k, float c2ab, int is075) {
  Params p;
  p.alpha = alpha; p.beta = beta; p.k = k; p.c2ab = c2ab;
  p.n = n; p.half = n / 2; p.is075 = is075; p.C = c;
  p.total = rows * c;
  return p;
}

unsigned grid_of(const Params& p) {
  return static_cast<unsigned>((p.total + kTile - 1) / kTile);
}

}  // namespace

// x, y [rows, c] of one dtype (0 f32, 1 bf16), contiguous; 1 <= n <= 64.
// Returns cudaGetLastError() after the launch (-1: unknown dtype).
extern "C" int veles_lrn_fwd(const void* x, void* y, int dtype, int64_t rows,
                             int c, int n, float alpha, float beta, float k,
                             int is075, void* stream) {
  const Params p = make_params(rows, c, n, alpha, beta, k, 0.f, is075);
  const size_t smem = 2 * sizeof(float) * (kTile + n - 1);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case veles::kF32:
      lrn_fwd_kernel<float><<<grid_of(p), kThreads, smem, st>>>(
          static_cast<const float*>(x), static_cast<float*>(y), p);
      break;
    case veles::kBF16:
      lrn_fwd_kernel<__nv_bfloat16><<<grid_of(p), kThreads, smem, st>>>(
          static_cast<const __nv_bfloat16*>(x),
          static_cast<__nv_bfloat16*>(y), p);
      break;
    default:
      return -1;
  }
  return static_cast<int>(cudaGetLastError());
}

// x, dy, dx [rows, c] of one dtype, contiguous; c2ab = 2 * alpha * beta
// rounded to f32 once on the host.
extern "C" int veles_lrn_bwd(const void* x, const void* dy, void* dx,
                             int dtype, int64_t rows, int c, int n,
                             float alpha, float beta, float k, float c2ab,
                             int is075, void* stream) {
  const Params p = make_params(rows, c, n, alpha, beta, k, c2ab, is075);
  const size_t smem =
      sizeof(float) * (2 * (kTile + 2 * (n - 1)) + kTile + n - 1);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case veles::kF32:
      lrn_bwd_kernel<float><<<grid_of(p), kThreads, smem, st>>>(
          static_cast<const float*>(x), static_cast<const float*>(dy),
          static_cast<float*>(dx), p);
      break;
    case veles::kBF16:
      lrn_bwd_kernel<__nv_bfloat16><<<grid_of(p), kThreads, smem, st>>>(
          static_cast<const __nv_bfloat16*>(x),
          static_cast<const __nv_bfloat16*>(dy),
          static_cast<__nv_bfloat16*>(dx), p);
      break;
    default:
      return -1;
  }
  return static_cast<int>(cudaGetLastError());
}
