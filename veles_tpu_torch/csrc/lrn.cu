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
// package.  Every window is summed in ascending channel order with
// round-to-nearest adds and no contraction, as the plain version sums
// it, so the two agree bit for bit where the card's rsqrt matches.
//
// The transposed window: i lies in window(c) iff
// c in [i - (n - 1 - half), i + half].  For odd n that is the same
// window; for even n it is its mirror image.
//
// What bounds it on the card: bytes.  A few dozen instructions per
// element against 4 (forward, bf16: x in, y out) or 6 bytes (backward:
// x, dy in, dx out).  Two variants; ops/lrn.py::plan picks one by shape
// and pointer alignment only.
//
// The row kernels (lrn_fwd_rows, lrn_bwd_rows) take C % 8 == 0,
// n <= kRowsMaxN and 16-byte-aligned x, dy and outputs.  A lane owns
// whole chunks of 8 consecutive channels of one row (C % 8 == 0, so a
// chunk never straddles a row), loaded and stored 16 bytes at a time
// (two per chunk in f32), its channel found once per chunk, never per
// element.  A warp holds 32 consecutive chunks; the squares (and in the
// backward t) of the chunks on either side come from the neighbouring
// lanes by __shfl_up/down_sync, so no block-wide barrier stands between
// loads and compute and nothing goes through shared memory.  The
// outermost H lanes of a warp (H = 1, or 2 for a backward window wider
// than 9) only supply halo: 32 - 2H of the 32 chunks are written, and
// the halo chunks are read again by the neighbouring tile, mostly from
// L1/L2.  Each lane loads U chunks before it computes any (U = 4
// forward, 2 backward of x and dy: 64 B of bf16 per lane in flight
// either way), in a persistent grid-stride loop over warp tiles sized
// to the SMs' occupancy: at 1024 resident threads an SM has ~64 KB in
// flight, above the ~15-20 KB that 3.35 TB/s needs by Little's law
// (the tile kernel below: 2048 threads x one 2-byte load, ~4 KB, and a
// barrier between a CTA's load and compute).  The backward computes s,
// p and t once per element (the tile kernel: s and p twice) and keeps
// p / s as an IEEE-rounded division.  Shared-memory traffic per
// element: tile kernel ~32 B forward, ~80 B backward (~1.3 ms of the
// card's ~30 TB/s for AlexNet's two layers, more than the backward's
// byte bound); row kernels 0.
//
// The tile kernels (lrn_fwd_kernel, lrn_bwd_kernel) take the rest: any
// C, 1 <= n <= 64, any alignment.  Each CTA owns a contiguous tile of
// kTile elements of the flattened array and stages it, with a halo of
// n - 1 elements on each side, in shared memory; the channel of each
// element bounds its window, so tiles need not align to rows.  Both
// variants recompute s from x in the backward (the TPU kernel's
// choice): the residual is x alone.
#include <initializer_list>

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

// ---------------------------------------------------------------------------
// Tile kernels: any C, any n, any alignment.

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

// ---------------------------------------------------------------------------
// Row kernels: C % 8 == 0, n <= kRowsMaxN, 16-byte-aligned pointers.

constexpr unsigned kFull = 0xffffffffu;
constexpr int kRowsThreads = 256;
constexpr int kRowsWarps = kRowsThreads / 32;
constexpr int kRowsMaxN = 17;     // half <= 8: one chunk of halo a side
constexpr int kFwdUnroll = 4;     // chunks per lane per warp tile
constexpr int kBwdUnroll = 2;

// One chunk (8 consecutive elements) as loaded: 16 bytes of bf16, or
// 32 bytes of f32.
template <typename T> struct Raw;
template <> struct Raw<__nv_bfloat16> { uint4 w; };
template <> struct Raw<float> { float4 a, b; };

__device__ __forceinline__ void load_raw(const __nv_bfloat16* p,
                                         Raw<__nv_bfloat16>& r) {
  r.w = __ldg(reinterpret_cast<const uint4*>(p));
}
__device__ __forceinline__ void load_raw(const float* p, Raw<float>& r) {
  const float4* q = reinterpret_cast<const float4*>(p);
  r.a = __ldg(q);
  r.b = __ldg(q + 1);
}
__device__ __forceinline__ void zero_raw(Raw<__nv_bfloat16>& r) {
  r.w = make_uint4(0u, 0u, 0u, 0u);
}
__device__ __forceinline__ void zero_raw(Raw<float>& r) {
  r.a = r.b = make_float4(0.f, 0.f, 0.f, 0.f);
}

// element 2i in the low half of word i (little-endian)
__device__ __forceinline__ void widen(const Raw<__nv_bfloat16>& r,
                                      float v[8]) {
  const uint32_t w[4] = {r.w.x, r.w.y, r.w.z, r.w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void widen(const Raw<float>& r, float v[8]) {
  v[0] = r.a.x; v[1] = r.a.y; v[2] = r.a.z; v[3] = r.a.w;
  v[4] = r.b.x; v[5] = r.b.y; v[6] = r.b.z; v[7] = r.b.w;
}

__device__ __forceinline__ uint32_t bf16_bits(float v) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(v)));
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float v[8]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w[i] = bf16_bits(v[2 * i]) | (bf16_bits(v[2 * i + 1]) << 16);
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}
__device__ __forceinline__ void store8(float* p, const float v[8]) {
  float4* q = reinterpret_cast<float4*>(p);
  q[0] = make_float4(v[0], v[1], v[2], v[3]);
  q[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// The chunk before (l) and after (r) this lane's, from lanes -1 and +1:
// only the R channels a window can reach, zero where the neighbour is
// in another row.  Every lane of the warp takes part.
template <int R>
__device__ __forceinline__ void exchange(const float v[8], bool has_l,
                                         bool has_r, float l[8],
                                         float r[8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    l[i] = r[i] = 0.f;
    if (i >= 8 - R) {
      const float a = __shfl_up_sync(kFull, v[i], 1);
      l[i] = has_l ? a : 0.f;
    }
    if (i < R) {
      const float b = __shfl_down_sync(kFull, v[i], 1);
      r[i] = has_r ? b : 0.f;
    }
  }
}

// Sum of channels [i - lo, i + hi] of the 24 channels l | m | r around
// this chunk, in ascending order (lo, hi <= R; i, o unrolled, so every
// index is known at compile time and the arrays stay in registers).
template <int R>
__device__ __forceinline__ float window_sum(const float l[8],
                                            const float m[8],
                                            const float r[8], int i, int lo,
                                            int hi) {
  float acc = 0.f;
#pragma unroll
  for (int o = -R; o <= R; ++o) {
    const int pos = i + o;
    const float v = pos < 0 ? l[(pos + 8) & 7] : pos >= 8 ? r[pos & 7]
                                                          : m[pos & 7];
    if (o >= -lo && o <= hi) acc = __fadd_rn(acc, v);
  }
  return acc;
}

// Position of this lane's chunk in its warp tile: tile t covers output
// chunks [t * U * W, (t + 1) * U * W); sub-tile j's lane l holds chunk
// t * U * W + j * W + l - H, W = 32 - 2H output chunks per sub-tile.
struct RowsGeom {
  int64_t chunks;   // total / 8
  int cq;           // chunks per row, C / 8
};

template <int U, int H>
struct TileWalk {
  static constexpr int W = 32 - 2 * H;
  static constexpr int kChunks = U * W;
  int64_t t, tiles, stride;
  int r0, rstep;    // (t * kChunks) % cq and (stride * kChunks) % cq

  __device__ TileWalk(const RowsGeom& g) {
    t = static_cast<int64_t>(blockIdx.x) * kRowsWarps + threadIdx.x / 32;
    stride = static_cast<int64_t>(gridDim.x) * kRowsWarps;
    tiles = (g.chunks + kChunks - 1) / kChunks;
    r0 = static_cast<int>((t * kChunks) % g.cq);
    rstep = static_cast<int>((stride * kChunks) % g.cq);
  }
  __device__ bool more() const { return t < tiles; }
  __device__ void next(int cq) {
    t += stride;
    r0 += rstep;
    if (r0 >= cq) r0 -= cq;
  }
};

template <typename T, int R>
__global__ void __launch_bounds__(kRowsThreads) lrn_fwd_rows(
    const T* __restrict__ x, T* __restrict__ y, Params p, RowsGeom g) {
  constexpr int U = kFwdUnroll, H = 1;
  using Walk = TileWalk<U, H>;
  const int lane = threadIdx.x & 31;
  const int lo = p.half, hi = p.n - 1 - p.half;
  for (Walk w(g); w.more(); w.next(g.cq)) {
    const int64_t q0 = w.t * Walk::kChunks;
    Raw<T> raw[U];
#pragma unroll
    for (int j = 0; j < U; ++j) {
      const int64_t q = q0 + j * Walk::W + lane - H;
      if (q >= 0 && q < g.chunks) load_raw(x + 8 * q, raw[j]);
      else zero_raw(raw[j]);
    }
#pragma unroll
    for (int j = 0; j < U; ++j) {
      const int off = j * Walk::W + lane - H;
      const int64_t q = q0 + off;
      const int c = static_cast<int>(
          static_cast<unsigned>(w.r0 + off + g.cq) %
          static_cast<unsigned>(g.cq));
      float v[8], sq[8], l[8], r[8], out[8];
      widen(raw[j], v);
#pragma unroll
      for (int i = 0; i < 8; ++i) sq[i] = round_to<T>(__fmul_rn(v[i], v[i]));
      exchange<R>(sq, c > 0, c < g.cq - 1, l, r);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float s = __fadd_rn(
            p.k, __fmul_rn(p.alpha, window_sum<R>(l, sq, r, i, lo, hi)));
        out[i] = __fmul_rn(v[i], power(s, p));
      }
      if (lane >= H && lane < 32 - H && q < g.chunks) store8(y + 8 * q, out);
    }
  }
}

// dx reaches t one chunk away, and t reaches squares one more chunk
// away when the window is wider than 9: then two halo lanes a side
template <int R>
__host__ __device__ constexpr int bwd_halo() { return R > 4 ? 2 : 1; }

template <typename T, int R>
__global__ void __launch_bounds__(kRowsThreads) lrn_bwd_rows(
    const T* __restrict__ x, const T* __restrict__ dy, T* __restrict__ dx,
    Params p, RowsGeom g) {
  constexpr int U = kBwdUnroll, H = bwd_halo<R>();
  using Walk = TileWalk<U, H>;
  const int lane = threadIdx.x & 31;
  const int lo = p.half, hi = p.n - 1 - p.half;
  for (Walk w(g); w.more(); w.next(g.cq)) {
    const int64_t q0 = w.t * Walk::kChunks;
    Raw<T> rx[U], rd[U];
#pragma unroll
    for (int j = 0; j < U; ++j) {
      const int64_t q = q0 + j * Walk::W + lane - H;
      if (q >= 0 && q < g.chunks) {
        load_raw(x + 8 * q, rx[j]);
        load_raw(dy + 8 * q, rd[j]);
      } else {
        zero_raw(rx[j]);
        zero_raw(rd[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < U; ++j) {
      const int off = j * Walk::W + lane - H;
      const int64_t q = q0 + off;
      const int c = static_cast<int>(
          static_cast<unsigned>(w.r0 + off + g.cq) %
          static_cast<unsigned>(g.cq));
      const bool has_l = c > 0, has_r = c < g.cq - 1;
      float v[8], d[8], sq[8], l[8], r[8], pw[8], t[8];
      widen(rx[j], v);
      widen(rd[j], d);
#pragma unroll
      for (int i = 0; i < 8; ++i) sq[i] = round_to<T>(__fmul_rn(v[i], v[i]));
      exchange<R>(sq, has_l, has_r, l, r);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float s = __fadd_rn(
            p.k, __fmul_rn(p.alpha, window_sum<R>(l, sq, r, i, lo, hi)));
        pw[i] = power(s, p);
        t[i] = round_to<T>(
            __fmul_rn(__fmul_rn(d[i], v[i]), __fdiv_rn(pw[i], s)));
      }
      exchange<R>(t, has_l, has_r, l, r);
      float out[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        // the transposed window: [i - hi, i + lo]
        const float u = window_sum<R>(l, t, r, i, hi, lo);
        out[i] = __fsub_rn(__fmul_rn(d[i], pw[i]),
                           __fmul_rn(__fmul_rn(p.c2ab, v[i]), u));
      }
      if (lane >= H && lane < 32 - H && q < g.chunks) store8(dx + 8 * q, out);
    }
  }
}

// Persistent grid: as many CTAs as fit on the card at once, no more
// than there are warp tiles.
template <typename K>
unsigned rows_grid(K kernel, int64_t tiles) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                kRowsThreads, 0);
  const int64_t full = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  const int64_t need = (tiles + kRowsWarps - 1) / kRowsWarps;
  return static_cast<unsigned>(need < full ? need : full);
}

template <typename T, int R>
void launch_fwd_rows(const void* x, void* y, const Params& p,
                     const RowsGeom& g, cudaStream_t st) {
  constexpr int64_t per_tile = TileWalk<kFwdUnroll, 1>::kChunks;
  const int64_t tiles = (g.chunks + per_tile - 1) / per_tile;
  lrn_fwd_rows<T, R><<<rows_grid(lrn_fwd_rows<T, R>, tiles), kRowsThreads,
                       0, st>>>(static_cast<const T*>(x),
                                static_cast<T*>(y), p, g);
}

template <typename T, int R>
void launch_bwd_rows(const void* x, const void* dy, void* dx,
                     const Params& p, const RowsGeom& g, cudaStream_t st) {
  constexpr int64_t per_tile = TileWalk<kBwdUnroll, bwd_halo<R>()>::kChunks;
  const int64_t tiles = (g.chunks + per_tile - 1) / per_tile;
  lrn_bwd_rows<T, R><<<rows_grid(lrn_bwd_rows<T, R>, tiles), kRowsThreads,
                       0, st>>>(static_cast<const T*>(x),
                                static_cast<const T*>(dy),
                                static_cast<T*>(dx), p, g);
}

// The window's reach bucket R (half <= R) of the row kernels: 2, 4 or 8.
int reach_of(int n) { return n <= 5 ? 2 : n <= 9 ? 4 : 8; }

bool rows_take(int c, int n, std::initializer_list<const void*> ptrs) {
  if (c % 8 || n < 1 || n > kRowsMaxN) return false;
  for (const void* q : ptrs)
    if (reinterpret_cast<uintptr_t>(q) % 16) return false;
  return true;
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
// `rows_kernel` 1 launches the row kernel, which needs c % 8 == 0,
// n <= 17 and 16-byte-aligned pointers (ops/lrn.py::plan); 0 the tile
// kernel.  Returns cudaGetLastError() after the launch (-1: unknown
// dtype, -2: the row kernel asked for where it does not apply).
extern "C" int veles_lrn_fwd(const void* x, void* y, int dtype, int64_t rows,
                             int c, int n, float alpha, float beta, float k,
                             int is075, int rows_kernel, void* stream) {
  const Params p = make_params(rows, c, n, alpha, beta, k, 0.f, is075);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype != veles::kF32 && dtype != veles::kBF16) return -1;
  if (rows_kernel) {
    if (!rows_take(c, n, {x, y})) return -2;
    const RowsGeom g{p.total / 8, c / 8};
    const bool bf = dtype == veles::kBF16;
    switch (reach_of(n)) {
      case 2:
        bf ? launch_fwd_rows<__nv_bfloat16, 2>(x, y, p, g, st)
           : launch_fwd_rows<float, 2>(x, y, p, g, st);
        break;
      case 4:
        bf ? launch_fwd_rows<__nv_bfloat16, 4>(x, y, p, g, st)
           : launch_fwd_rows<float, 4>(x, y, p, g, st);
        break;
      default:
        bf ? launch_fwd_rows<__nv_bfloat16, 8>(x, y, p, g, st)
           : launch_fwd_rows<float, 8>(x, y, p, g, st);
    }
    return static_cast<int>(cudaGetLastError());
  }
  const size_t smem = 2 * sizeof(float) * (kTile + n - 1);
  if (dtype == veles::kF32)
    lrn_fwd_kernel<float><<<grid_of(p), kThreads, smem, st>>>(
        static_cast<const float*>(x), static_cast<float*>(y), p);
  else
    lrn_fwd_kernel<__nv_bfloat16><<<grid_of(p), kThreads, smem, st>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<__nv_bfloat16*>(y), p);
  return static_cast<int>(cudaGetLastError());
}

// x, dy, dx [rows, c] of one dtype, contiguous; c2ab = 2 * alpha * beta
// rounded to f32 once on the host; `rows_kernel` as for veles_lrn_fwd
// (dy and dx 16-byte-aligned too).
extern "C" int veles_lrn_bwd(const void* x, const void* dy, void* dx,
                             int dtype, int64_t rows, int c, int n,
                             float alpha, float beta, float k, float c2ab,
                             int is075, int rows_kernel, void* stream) {
  const Params p = make_params(rows, c, n, alpha, beta, k, c2ab, is075);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype != veles::kF32 && dtype != veles::kBF16) return -1;
  if (rows_kernel) {
    if (!rows_take(c, n, {x, dy, dx})) return -2;
    const RowsGeom g{p.total / 8, c / 8};
    const bool bf = dtype == veles::kBF16;
    switch (reach_of(n)) {
      case 2:
        bf ? launch_bwd_rows<__nv_bfloat16, 2>(x, dy, dx, p, g, st)
           : launch_bwd_rows<float, 2>(x, dy, dx, p, g, st);
        break;
      case 4:
        bf ? launch_bwd_rows<__nv_bfloat16, 4>(x, dy, dx, p, g, st)
           : launch_bwd_rows<float, 4>(x, dy, dx, p, g, st);
        break;
      default:
        bf ? launch_bwd_rows<__nv_bfloat16, 8>(x, dy, dx, p, g, st)
           : launch_bwd_rows<float, 8>(x, dy, dx, p, g, st);
    }
    return static_cast<int>(cudaGetLastError());
  }
  const size_t smem =
      sizeof(float) * (2 * (kTile + 2 * (n - 1)) + kTile + n - 1);
  if (dtype == veles::kF32)
    lrn_bwd_kernel<float><<<grid_of(p), kThreads, smem, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(dy),
        static_cast<float*>(dx), p);
  else
    lrn_bwd_kernel<__nv_bfloat16><<<grid_of(p), kThreads, smem, st>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(dy),
        static_cast<__nv_bfloat16*>(dx), p);
  return static_cast<int>(cudaGetLastError());
}
