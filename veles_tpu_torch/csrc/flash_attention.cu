// FlashAttention-2 forward and backward over [batch, seq, heads, hd]
// tensors: three kernels (forward, dq, dk/dv) with f32 scores, softmax
// statistics and accumulators, in f32 or bf16 inputs.
//
// Replaces: veles_tpu/ops/pallas_attention.py::pallas_attention — its
// forward _fwd_kernel (O and the per-row logsumexp), _bwd_dq_kernel and
// _bwd_dkv_kernel (P recomputed from the LSE, delta = rowsum(dO*O) in
// f32, ds = P*(dP - delta)*scale), wired by the custom VJP _mha.  Same
// function and rounding points: masked scores are the finite -1e30, the
// causal mask is top-left aligned (col <= row, also when sq != sk), P is
// rounded to the input type before P*V, dP^T*dO and ds*K / ds^T*Q, the
// sum l is clamped at 1e-30 before O = acc / l and lse = m + log(l).
//
// What bounds it on the card: operations.  At the training shapes (s =
// 2048, hd = 128) attention does ~2*s*hd flops per K/V byte, far above
// the H100's ~295 flop/byte ridge; the bytes it must move are q/k/v/o
// once.  What the design does about it: the [s, s] score matrix never
// exists in device memory — a CTA keeps one Q (or K/V) tile in shared
// memory and streams the other operand's tiles past it, skipping tiles
// that the causal mask or the sequence end leaves empty.  The products
// are SIMT FMAs on a 4x4 register tile per thread (256 threads as a
// 16x16 grid, row i of the tile owned by thread row ty + 16*i), which
// caps it at the f32 CUDA-core rate; tensor-core mma/wgmma tiles are
// the later step.
//
// Unlike the TPU kernels, whose grid runs in order on one core with the
// accumulators in scratch memory across grid steps, each CTA here loops
// over the streamed tiles itself: the forward and dq kernels own one
// query tile of one (batch, head) and walk key tiles; the dk/dv kernel
// owns one key tile and walks query tiles.  The backward stays split in
// two so that no tile is written by two CTAs: no atomics, and the
// gradients are deterministic.  Tails (rows or columns past the real
// lengths) are masked in the kernel; nothing is padded on the host.
#include "common.cuh"

namespace {

using veles::to_f;
using veles::warp_sum;

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;

// tile rows per head dim: both fit one CTA's shared memory (opt-in
// above 48 KB) with every tile kept as f32
template <int D> struct Tile;
template <> struct Tile<128> { static constexpr int BQ = 64, BK = 64; };
template <> struct Tile<256> { static constexpr int BQ = 32, BK = 32; };

template <typename T> __device__ __forceinline__ float round_to(float x);
template <> __device__ __forceinline__ float round_to<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(
    float x) {
  return __bfloat162float(__float2bfloat16(x));
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// element (bb, row, hh, c) of a contiguous [b, s, h, D] tensor
__device__ __forceinline__ size_t at(int bb, int row, int hh, int c, int s,
                                     int h, int d) {
  return ((static_cast<size_t>(bb) * s + row) * h + hh) * d + c;
}

// rows [row0, row0 + ROWS) of head hh of batch bb into an f32 tile with
// row stride D + 1 (no bank conflicts on column walks); rows at or past
// s read 0
template <typename T, int D, int ROWS>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int bb,
                                          int hh, int h, int s, int row0) {
  for (int i = threadIdx.x; i < ROWS * D; i += kThreads) {
    const int r = i / D, c = i % D;
    const int row = row0 + r;
    dst[r * (D + 1) + c] = row < s ? to_f(src[at(bb, row, hh, c, s, h, D)])
                                   : 0.f;
  }
}

// per-row lse and delta = rowsum(dO * O) of the query tile at q0 (dO
// already in shared memory); one warp per row, lanes across columns
template <typename T, int D, int BQ>
__device__ __forceinline__ void row_stats(float* lse_s, float* delta_s,
                                          const float* dos, const T* o,
                                          const float* lse, int bb, int hh,
                                          int h, int sq, int q0) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < BQ; r += kThreads / 32) {
    const int row = q0 + r;
    float acc = 0.f;
    if (row < sq)
      for (int c = lane; c < D; c += 32)
        acc += dos[r * (D + 1) + c] * to_f(o[at(bb, row, hh, c, sq, h, D)]);
    acc = warp_sum(acc);
    if (lane == 0) {
      delta_s[r] = acc;
      lse_s[r] = row < sq ? lse[(static_cast<size_t>(bb) * h + hh) * sq + row]
                          : 0.f;
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
    int h, int sq, int sk, int causal, float scale) {
  constexpr int BQ = Tile<D>::BQ, BK = Tile<D>::BK, LD = D + 1, PL = BK + 1;
  constexpr int RQ = BQ / 16, CK = BK / 16, CD = D / 16;
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + BQ * LD;
  float* vs = ks + BK * LD;
  float* ps = vs + BK * LD;  // [BQ][PL]

  const int bb = blockIdx.y / h, hh = blockIdx.y % h;
  const int q0 = blockIdx.x * BQ;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  load_tile<T, D, BQ>(qs, q, bb, hh, h, sq, q0);

  float acc[RQ][CD], m[RQ], l[RQ];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CD; ++c) acc[i][c] = 0.f;
  }
  // key tiles past the diagonal of the tile's last row hold no kept col
  const int k_end = causal ? min(sk, q0 + BQ) : sk;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();
    load_tile<T, D, BK>(ks, k, bb, hh, h, sk, k0);
    load_tile<T, D, BK>(vs, v, bb, hh, h, sk, k0);
    __syncthreads();
    float s[RQ][CK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < CK; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[RQ], kv[CK];
#pragma unroll
      for (int i = 0; i < RQ; ++i) qv[i] = qs[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < CK; ++j) kv[j] = ks[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < CK; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        const int col = k0 + tx + 16 * j;
        const bool keep = col < sk && (!causal || col <= row);
        s[i][j] = keep ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_cur = fmaxf(m[i], half_warp_max(mx));
      const float alpha = expf(m[i] - m_cur);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        const float p = expf(s[i][j] - m_cur);
        rs += p;
        ps[(ty + 16 * i) * PL + tx + 16 * j] = round_to<T>(p);
      }
      l[i] = l[i] * alpha + half_warp_sum(rs);
      m[i] = m_cur;
#pragma unroll
      for (int c = 0; c < CD; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[RQ], vv[CD];
#pragma unroll
      for (int i = 0; i < RQ; ++i) pv[i] = ps[(ty + 16 * i) * PL + c];
#pragma unroll
      for (int j = 0; j < CD; ++j) vv[j] = vs[c * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < CD; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= sq) continue;
    const float li = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < CD; ++c)
      o[at(bb, row, hh, tx + 16 * c, sq, h, D)] = from_f<T>(acc[i][c] / li);
    if (tx == 0)
      lse[(static_cast<size_t>(bb) * h + hh) * sq + row] = m[i] + logf(li);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const T* __restrict__ o, const float* __restrict__ lse,
    T* __restrict__ dq, int h, int sq, int sk, int causal, float scale) {
  constexpr int BQ = Tile<D>::BQ, BK = Tile<D>::BK, LD = D + 1, PL = BK + 1;
  constexpr int RQ = BQ / 16, CK = BK / 16, CD = D / 16;
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + BQ * LD;
  float* ks = dos + BQ * LD;
  float* vs = ks + BK * LD;
  float* dss = vs + BK * LD;  // [BQ][PL]
  float* lse_s = dss + BQ * PL;
  float* delta_s = lse_s + BQ;

  const int bb = blockIdx.y / h, hh = blockIdx.y % h;
  const int q0 = blockIdx.x * BQ;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  load_tile<T, D, BQ>(qs, q, bb, hh, h, sq, q0);
  load_tile<T, D, BQ>(dos, dout, bb, hh, h, sq, q0);
  __syncthreads();
  row_stats<T, D, BQ>(lse_s, delta_s, dos, o, lse, bb, hh, h, sq, q0);

  float acc[RQ][CD];
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int c = 0; c < CD; ++c) acc[i][c] = 0.f;
  const int k_end = causal ? min(sk, q0 + BQ) : sk;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();
    load_tile<T, D, BK>(ks, k, bb, hh, h, sk, k0);
    load_tile<T, D, BK>(vs, v, bb, hh, h, sk, k0);
    __syncthreads();
    float s[RQ][CK], dp[RQ][CK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < CK; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[RQ], dov[RQ], kv[CK], vv[CK];
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        qv[i] = qs[(ty + 16 * i) * LD + d];
        dov[i] = dos[(ty + 16 * i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        kv[j] = ks[(tx + 16 * j) * LD + d];
        vv[j] = vs[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < CK; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(dov[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int r = ty + 16 * i, row = q0 + r;
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        const int col = k0 + tx + 16 * j;
        const bool keep = col < sk && row < sq && (!causal || col <= row);
        const float p = expf((keep ? s[i][j] * scale : kNegInf) - lse_s[r]);
        dss[r * PL + tx + 16 * j] =
            round_to<T>(p * (dp[i][j] - delta_s[r]) * scale);
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float dv[RQ], kv[CD];
#pragma unroll
      for (int i = 0; i < RQ; ++i) dv[i] = dss[(ty + 16 * i) * PL + c];
#pragma unroll
      for (int j = 0; j < CD; ++j) kv[j] = ks[c * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < CD; ++j) acc[i][j] = fmaf(dv[i], kv[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= sq) continue;
#pragma unroll
    for (int c = 0; c < CD; ++c)
      dq[at(bb, row, hh, tx + 16 * c, sq, h, D)] = from_f<T>(acc[i][c]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const T* __restrict__ o, const float* __restrict__ lse,
    T* __restrict__ dk, T* __restrict__ dv, int h, int sq, int sk,
    int causal, float scale) {
  constexpr int BQ = Tile<D>::BQ, BK = Tile<D>::BK, LD = D + 1, PL = BQ + 1;
  constexpr int RK = BK / 16, CQ = BQ / 16, CD = D / 16;
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + BK * LD;
  float* qs = vs + BK * LD;
  float* dos = qs + BQ * LD;
  float* ps = dos + BQ * LD;   // [BK][PL]
  float* dss = ps + BK * PL;   // [BK][PL]
  float* lse_s = dss + BK * PL;
  float* delta_s = lse_s + BQ;

  const int bb = blockIdx.y / h, hh = blockIdx.y % h;
  const int k0 = blockIdx.x * BK;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  load_tile<T, D, BK>(ks, k, bb, hh, h, sk, k0);
  load_tile<T, D, BK>(vs, v, bb, hh, h, sk, k0);

  float dk_acc[RK][CD], dv_acc[RK][CD];
#pragma unroll
  for (int i = 0; i < RK; ++i)
#pragma unroll
    for (int c = 0; c < CD; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;
  // query tiles whose last row lies before k0 hold no kept entry
  const int q_start = causal ? (k0 / BQ) * BQ : 0;
  for (int q0 = q_start; q0 < sq; q0 += BQ) {
    __syncthreads();
    load_tile<T, D, BQ>(qs, q, bb, hh, h, sq, q0);
    load_tile<T, D, BQ>(dos, dout, bb, hh, h, sq, q0);
    __syncthreads();
    row_stats<T, D, BQ>(lse_s, delta_s, dos, o, lse, bb, hh, h, sq, q0);
    __syncthreads();
    float s[RK][CQ], dp[RK][CQ];
#pragma unroll
    for (int i = 0; i < RK; ++i)
#pragma unroll
      for (int j = 0; j < CQ; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float kv[RK], vv[RK], qv[CQ], dov[CQ];
#pragma unroll
      for (int i = 0; i < RK; ++i) {
        kv[i] = ks[(ty + 16 * i) * LD + d];
        vv[i] = vs[(ty + 16 * i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < CQ; ++j) {
        qv[j] = qs[(tx + 16 * j) * LD + d];
        dov[j] = dos[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < RK; ++i)
#pragma unroll
        for (int j = 0; j < CQ; ++j) {
          s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
          dp[i][j] = fmaf(vv[i], dov[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < RK; ++i) {
      const int c = ty + 16 * i, col = k0 + c;
#pragma unroll
      for (int j = 0; j < CQ; ++j) {
        const int r = tx + 16 * j, row = q0 + r;
        const bool keep = col < sk && row < sq && (!causal || col <= row);
        const float p = expf((keep ? s[i][j] * scale : kNegInf) - lse_s[r]);
        ps[c * PL + r] = round_to<T>(p);
        dss[c * PL + r] = round_to<T>(p * (dp[i][j] - delta_s[r]) * scale);
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int r = 0; r < BQ; ++r) {
      float pv[RK], dsv[RK], dov[CD], qv[CD];
#pragma unroll
      for (int i = 0; i < RK; ++i) {
        pv[i] = ps[(ty + 16 * i) * PL + r];
        dsv[i] = dss[(ty + 16 * i) * PL + r];
      }
#pragma unroll
      for (int j = 0; j < CD; ++j) {
        dov[j] = dos[r * LD + tx + 16 * j];
        qv[j] = qs[r * LD + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < RK; ++i)
#pragma unroll
        for (int j = 0; j < CD; ++j) {
          dv_acc[i][j] = fmaf(pv[i], dov[j], dv_acc[i][j]);
          dk_acc[i][j] = fmaf(dsv[i], qv[j], dk_acc[i][j]);
        }
    }
  }
#pragma unroll
  for (int i = 0; i < RK; ++i) {
    const int col = k0 + ty + 16 * i;
    if (col >= sk) continue;
#pragma unroll
    for (int c = 0; c < CD; ++c) {
      const size_t idx = at(bb, col, hh, tx + 16 * c, sk, h, D);
      dk[idx] = from_f<T>(dk_acc[i][c]);
      dv[idx] = from_f<T>(dv_acc[i][c]);
    }
  }
}

// shared-memory bytes of each kernel's CTA
template <int D> constexpr size_t fwd_smem() {
  return sizeof(float) * ((Tile<D>::BQ + 2 * Tile<D>::BK) * (D + 1)
                          + Tile<D>::BQ * (Tile<D>::BK + 1));
}
template <int D> constexpr size_t dq_smem() {
  return sizeof(float) * (2 * (Tile<D>::BQ + Tile<D>::BK) * (D + 1)
                          + Tile<D>::BQ * (Tile<D>::BK + 1)
                          + 2 * Tile<D>::BQ);
}
template <int D> constexpr size_t dkv_smem() {
  return sizeof(float) * (2 * (Tile<D>::BQ + Tile<D>::BK) * (D + 1)
                          + 2 * Tile<D>::BK * (Tile<D>::BQ + 1)
                          + 2 * Tile<D>::BQ);
}

// every CTA takes more than the default 48 KB: opt in before the launch
template <typename K>
cudaError_t opt_in(K kernel, size_t smem) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
}

struct Args {
  const void *q, *k, *v, *dout, *o;
  void *out, *out2;
  float* lse;
  int b, h, sq, sk, causal;
  float scale;
  cudaStream_t stream;
};

template <typename T, int D>
cudaError_t run_fwd(const Args& a) {
  constexpr size_t smem = fwd_smem<D>();
  cudaError_t e = opt_in(flash_fwd_kernel<T, D>, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((a.sq + Tile<D>::BQ - 1) / Tile<D>::BQ, a.b * a.h);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<T*>(a.out), a.lse, a.h, a.sq,
      a.sk, a.causal, a.scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t run_dq(const Args& a) {
  constexpr size_t smem = dq_smem<D>();
  cudaError_t e = opt_in(flash_bwd_dq_kernel<T, D>, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((a.sq + Tile<D>::BQ - 1) / Tile<D>::BQ, a.b * a.h);
  flash_bwd_dq_kernel<T, D><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const T*>(a.o), a.lse, static_cast<T*>(a.out), a.h, a.sq,
      a.sk, a.causal, a.scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t run_dkv(const Args& a) {
  constexpr size_t smem = dkv_smem<D>();
  cudaError_t e = opt_in(flash_bwd_dkv_kernel<T, D>, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((a.sk + Tile<D>::BK - 1) / Tile<D>::BK, a.b * a.h);
  flash_bwd_dkv_kernel<T, D><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const T*>(a.o), a.lse, static_cast<T*>(a.out),
      static_cast<T*>(a.out2), a.h, a.sq, a.sk, a.causal, a.scale);
  return cudaGetLastError();
}

// the built (dtype, head dim) variants; anything else is refused
template <template <typename, int> class Run>
int dispatch(int dtype, int d, const Args& a) {
  using veles::kBF16;
  using veles::kF32;
  if (dtype == kF32 && d == 128) return Run<float, 128>::go(a);
  if (dtype == kF32 && d == 256) return Run<float, 256>::go(a);
  if (dtype == kBF16 && d == 128) return Run<__nv_bfloat16, 128>::go(a);
  if (dtype == kBF16 && d == 256) return Run<__nv_bfloat16, 256>::go(a);
  return cudaErrorInvalidValue;
}

template <typename T, int D> struct Fwd {
  static int go(const Args& a) { return run_fwd<T, D>(a); }
};
template <typename T, int D> struct Dq {
  static int go(const Args& a) { return run_dq<T, D>(a); }
};
template <typename T, int D> struct Dkv {
  static int go(const Args& a) { return run_dkv<T, D>(a); }
};

}  // namespace

// q [b, sq, h, d], k/v [b, sk, h, d] → o [b, sq, h, d] (input type) and
// lse [b, h, sq] f32
extern "C" int veles_flash_fwd(const void* q, const void* k, const void* v,
                               void* o, float* lse, int dtype, int b, int h,
                               int sq, int sk, int d, int causal,
                               float scale, void* stream) {
  Args a{q, k, v, nullptr, nullptr, o, nullptr, lse, b, h, sq, sk, causal,
         scale, static_cast<cudaStream_t>(stream)};
  return dispatch<Fwd>(dtype, d, a);
}

// dq [b, sq, h, d] from q, k, v, dO, O and the forward's lse
extern "C" int veles_flash_bwd_dq(const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const void* o, const float* lse, void* dq,
                                  int dtype, int b, int h, int sq, int sk,
                                  int d, int causal, float scale,
                                  void* stream) {
  Args a{q, k, v, dout, o, dq, nullptr, const_cast<float*>(lse), b, h, sq,
         sk, causal, scale, static_cast<cudaStream_t>(stream)};
  return dispatch<Dq>(dtype, d, a);
}

// dk, dv [b, sk, h, d] from q, k, v, dO, O and the forward's lse
extern "C" int veles_flash_bwd_dkv(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* o, const float* lse, void* dk,
                                   void* dv, int dtype, int b, int h, int sq,
                                   int sk, int d, int causal, float scale,
                                   void* stream) {
  Args a{q, k, v, dout, o, dk, dv, const_cast<float*>(lse), b, h, sq, sk,
         causal, scale, static_cast<cudaStream_t>(stream)};
  return dispatch<Dkv>(dtype, d, a);
}
