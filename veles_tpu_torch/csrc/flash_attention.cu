// FlashAttention-2 forward and backward over [batch, seq, heads, hd]
// tensors: three kernels (forward, dq, dk/dv) with f32 scores, softmax
// statistics and accumulators, in f32 or bf16 inputs.
//
// Replaces: veles_tpu/ops/pallas_attention.py::pallas_attention — its
// forward _fwd_kernel (O and the per-row logsumexp; pallas_call :179),
// _bwd_dq_kernel (:330) and _bwd_dkv_kernel (:352) (P recomputed from
// the LSE, delta = rowsum(dO*O) in f32, ds = P*(dP - delta)*scale),
// wired by the custom VJP _mha.  Same function and rounding points:
// masked scores are the finite -1e30, the causal mask is top-left
// aligned (col <= row, also when sq != sk), P is rounded to the input
// type at each key tile's running max before P*V, the sum l is taken
// over the unrounded f32 P and clamped at 1e-30 before O = acc / l and
// lse = m + log(l); P and ds are rounded to the input type before
// dP^T*dO, ds*K and ds^T*Q.
//
// What bounds it on the card: operations.  At the training shapes (s =
// 2048, hd = 128) attention does ~2*s*hd flops per K/V byte, far above
// the H100's ~295 flop/byte ridge; the bytes it must move are q/k/v/o
// once.  The [s, s] score matrix never exists in device memory: a CTA
// keeps one Q (or K/V) tile in shared memory and streams the other
// operand's tiles past it, skipping tiles that the causal mask or the
// sequence end leaves empty.  Unlike the TPU kernels, whose grid runs
// in order on one core with the accumulators in scratch memory across
// grid steps, each CTA loops over the streamed tiles itself: the
// forward and dq kernels own one query tile of one (batch, head) and
// walk key tiles; the dk/dv kernel owns one key tile and walks query
// tiles.  The backward stays split in two so that no tile is written
// by two CTAs: no atomics, and the gradients are bit-equal from run to
// run.  Tails (rows or columns past the real lengths) are masked in the
// kernel; nothing is padded on the host.
//
// bf16 (the training type) runs on the tensor cores.  Each CTA is four
// warps; a warp owns 16 rows of the CTA's tile and computes its
// products with mma.sync m16n8k16 (bf16 in, f32 out).  Tiles stay bf16
// in shared memory, rows padded by 16 bytes so that ldmatrix reads
// them without bank conflicts; they arrive by 16-byte cp.async, and
// the streamed tiles are double-buffered so that the next tile's copy
// overlaps this tile's products.  The online softmax runs on the
// score accumulators in registers (row max and sum by quad shuffles,
// the -1e30 mask only on diagonal and tail tiles, the scale, the
// subtraction and expf rounded op by op as the plain version rounds
// them), and P (or ds) is rounded to bf16 in registers and fed back as
// the A operand of the next product, so the score tile never touches
// shared memory.  The dq kernel computes
// delta once per query row and writes it beside dq; the dk/dv kernel
// reads it there and never reads O.  At head dim 256 the dk/dv kernel
// splits the output columns over two CTAs (each recomputes the scores)
// to keep its two accumulators in registers.
//
// f32 stays on the CUDA cores (SIMT FMAs on a 4x4 register tile per
// thread, 256 threads as a 16x16 grid, f32 tiles in shared memory): it
// is the parity path (the f32 witness chains and the odd f32 cases are
// held to 1e-4), and TF32 tensor-core products, which keep 10 bits of
// mantissa, would break those limits.
#include "common.cuh"

namespace {

using veles::warp_sum;

constexpr float kNegInf = -1e30f;

// ---------------------------------------------------------------------------
// f32: SIMT kernels
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;

// tile rows per head dim: both fit one CTA's shared memory (opt-in
// above 48 KB) with every tile kept as f32
template <int D> struct Tile;
template <> struct Tile<128> { static constexpr int BQ = 64, BK = 64; };
template <> struct Tile<256> { static constexpr int BQ = 32, BK = 32; };

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
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int bb, int hh, int h, int s,
                                          int row0) {
  for (int i = threadIdx.x; i < ROWS * D; i += kThreads) {
    const int r = i / D, c = i % D;
    const int row = row0 + r;
    dst[r * (D + 1) + c] = row < s ? src[at(bb, row, hh, c, s, h, D)] : 0.f;
  }
}

// per-row lse and delta = rowsum(dO * O) of the query tile at q0 (dO
// already in shared memory; one warp per row, lanes across columns);
// delta also goes to device memory for the dk/dv kernel
template <int D, int BQ>
__device__ __forceinline__ void row_stats(float* lse_s, float* delta_s,
                                          float* delta, const float* dos,
                                          const float* o, const float* lse,
                                          int bb, int hh, int h, int sq,
                                          int q0) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < BQ; r += kThreads / 32) {
    const int row = q0 + r;
    float acc = 0.f;
    if (row < sq)
      for (int c = lane; c < D; c += 32)
        acc += dos[r * (D + 1) + c] * o[at(bb, row, hh, c, sq, h, D)];
    acc = warp_sum(acc);
    if (lane == 0) {
      const size_t i = (static_cast<size_t>(bb) * h + hh) * sq + row;
      delta_s[r] = acc;
      lse_s[r] = row < sq ? lse[i] : 0.f;
      if (row < sq) delta[i] = acc;
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ o,
    float* __restrict__ lse, int h, int sq, int sk, int causal,
    float scale) {
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
  load_tile<D, BQ>(qs, q, bb, hh, h, sq, q0);

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
    load_tile<D, BK>(ks, k, bb, hh, h, sk, k0);
    load_tile<D, BK>(vs, v, bb, hh, h, sk, k0);
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
        ps[(ty + 16 * i) * PL + tx + 16 * j] = p;
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
      o[at(bb, row, hh, tx + 16 * c, sq, h, D)] = acc[i][c] / li;
    if (tx == 0)
      lse[(static_cast<size_t>(bb) * h + hh) * sq + row] = m[i] + logf(li);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ o, const float* __restrict__ lse,
    float* __restrict__ dq, float* __restrict__ delta, int h, int sq,
    int sk, int causal, float scale) {
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
  load_tile<D, BQ>(qs, q, bb, hh, h, sq, q0);
  load_tile<D, BQ>(dos, dout, bb, hh, h, sq, q0);
  __syncthreads();
  row_stats<D, BQ>(lse_s, delta_s, delta, dos, o, lse, bb, hh, h, sq, q0);

  float acc[RQ][CD];
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int c = 0; c < CD; ++c) acc[i][c] = 0.f;
  const int k_end = causal ? min(sk, q0 + BQ) : sk;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();
    load_tile<D, BK>(ks, k, bb, hh, h, sk, k0);
    load_tile<D, BK>(vs, v, bb, hh, h, sk, k0);
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
        dss[r * PL + tx + 16 * j] = p * (dp[i][j] - delta_s[r]) * scale;
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
      dq[at(bb, row, hh, tx + 16 * c, sq, h, D)] = acc[i][c];
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dk, float* __restrict__ dv, int h, int sq, int sk,
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
  load_tile<D, BK>(ks, k, bb, hh, h, sk, k0);
  load_tile<D, BK>(vs, v, bb, hh, h, sk, k0);

  float dk_acc[RK][CD], dv_acc[RK][CD];
#pragma unroll
  for (int i = 0; i < RK; ++i)
#pragma unroll
    for (int c = 0; c < CD; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;
  // query tiles whose last row lies before k0 hold no kept entry
  const int q_start = causal ? (k0 / BQ) * BQ : 0;
  for (int q0 = q_start; q0 < sq; q0 += BQ) {
    __syncthreads();
    load_tile<D, BQ>(qs, q, bb, hh, h, sq, q0);
    load_tile<D, BQ>(dos, dout, bb, hh, h, sq, q0);
    for (int r = threadIdx.x; r < BQ; r += kThreads) {
      const int row = q0 + r;
      const size_t i = (static_cast<size_t>(bb) * h + hh) * sq + row;
      lse_s[r] = row < sq ? lse[i] : 0.f;
      delta_s[r] = row < sq ? delta[i] : 0.f;
    }
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
        ps[c * PL + r] = p;
        dss[c * PL + r] = p * (dp[i][j] - delta_s[r]) * scale;
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
      dk[idx] = dk_acc[i][c];
      dv[idx] = dv_acc[i][c];
    }
  }
}

// shared-memory bytes of each SIMT kernel's CTA
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

// ---------------------------------------------------------------------------
// bf16: tensor-core kernels
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4, kTcThreads = 32 * kWarps;
constexpr int kRows = 16;  // rows of a tile each warp owns (the mma's M)

// tile sizes of the tensor-core kernels by head dim: the forward's key
// tile, the dq kernel's key tile, the dk/dv kernel's query tile and the
// output columns one dk/dv CTA owns.  The CTA's own tile is always
// kWarps * kRows = 64 rows.  Two CTAs fit an SM (shared memory <= 105 KB,
// <= 255 registers a thread).
template <int D> struct TcTile;
template <> struct TcTile<128> {
  static constexpr int FWD_BK = 64, DQ_BK = 64, DKV_BQ = 32, DKV_DC = 128;
};
template <> struct TcTile<256> {
  static constexpr int FWD_BK = 32, DQ_BK = 16, DKV_BQ = 16, DKV_DC = 128;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (or, with the .ca form, 4) bytes global -> shared; a copy that is
// not ok reads nothing and fills zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most N of this thread's copy groups are in flight
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// four 8x8 b16 matrices; lane i gives the address of row i % 8 of
// matrix i / 8 and receives, in register j, row lane / 4, columns
// 2 (lane % 4) and 2 (lane % 4) + 1 of matrix j (transposed: .trans)
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c[16 x 8] += a[16 x 16] . b[16 x 8], bf16 in, f32 sums.  Lane (g, t)
// = (lane / 4, lane % 4) holds c rows g (c[0], c[1]) and g + 8 (c[2],
// c[3]) at columns 2t, 2t + 1
__device__ __forceinline__ void mma16816(float (&c)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ds = P * (dP - delta) * scale, rounded op by op as the plain version
// rounds it (no fused multiply-adds)
__device__ __forceinline__ float ds_of(float p, float dp, float delta,
                                       float scale) {
  return __fmul_rn(__fmul_rn(p, __fsub_rn(dp, delta)), scale);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ldmatrix addresses in a row-major tile with row stride ld.  a_addr:
// the A fragment of rows r0..r0+15, columns c0..c0+15 — and, with
// .trans, the B fragments of two 8-column blocks (c0, c0 + 8) of a B
// stored [k][n] at k rows r0..r0+15.  b_addr: the B fragments of two
// 8-column blocks of a B stored [n][k] (rows n0..n0+15), k at c0..c0+15
__device__ __forceinline__ const bf16* a_addr(const bf16* tile, int ld,
                                              int r0, int c0, int lane) {
  return tile + (r0 + (lane & 15)) * ld + c0 + (lane >> 4) * 8;
}
__device__ __forceinline__ const bf16* b_addr(const bf16* tile, int ld,
                                              int n0, int c0, int lane) {
  return tile + (n0 + (lane & 7) + ((lane >> 4) << 3)) * ld + c0
         + ((lane >> 3) & 1) * 8;
}

// rows [row0, row0 + ROWS) of one head's [s, D] rows (src: its row 0,
// row stride `stride`) into a [ROWS][D + 8] shared tile by 16-byte
// cp.async; rows at or past s are zero-filled
template <int ROWS, int D>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          size_t stride, int row0, int s) {
  constexpr int CH = D / 8, LDS = D + 8;
  static_assert(ROWS * CH % kTcThreads == 0, "tile rows");
#pragma unroll
  for (int it = 0; it < ROWS * CH / kTcThreads; ++it) {
    const int i = it * kTcThreads + threadIdx.x;
    const int r = i / CH, c = i % CH, row = row0 + r;
    const bool ok = row < s;
    cp_async16(dst + r * LDS + c * 8,
               src + static_cast<size_t>(ok ? row : 0) * stride + c * 8, ok);
  }
}

// s[16 x N] = A[ra..ra+15, 0..D) . B[0..N, 0..D)^T for row-major shared
// tiles A and B (both [.][D + 8]).  A tensor-core chain of products
// over all of D sums less exactly than f32 adds: often enough for the
// training shapes' check to catch it, P (or ds) then rounds to the other
// bf16 neighbour of the plain version's in a row of few keys, one bf16
// step of a weight that such a row cannot average away.  So each 32
// products sum in a fresh chain and the chains add in f32 with rounding
// to nearest (chip_smoke.py prints the scores' distance from their exact
// sums: a one-key row's LSE is its scaled score)
template <int D, int N>
__device__ __forceinline__ void qk_product(float (&s)[N / 8][4],
                                           const bf16* a, int ra,
                                           const bf16* b, int lane) {
  constexpr int LDS = D + 8;
  static_assert(D % 32 == 0, "head dim");
#pragma unroll
  for (int j = 0; j < N / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D; kk += 32) {
    uint32_t a0[4], a1[4];
    ldsm_x4(a0, a_addr(a, LDS, ra, kk, lane));
    ldsm_x4(a1, a_addr(a, LDS, ra, kk + 16, lane));
#pragma unroll
    for (int n0 = 0; n0 < N; n0 += 16) {
      uint32_t b0[4], b1[4];
      ldsm_x4(b0, b_addr(b, LDS, n0, kk, lane));
      ldsm_x4(b1, b_addr(b, LDS, n0, kk + 16, lane));
      float t0[4] = {0.f, 0.f, 0.f, 0.f}, t1[4] = {0.f, 0.f, 0.f, 0.f};
      mma16816(t0, a0, b0[0], b0[1]);
      mma16816(t1, a0, b0[2], b0[3]);
      mma16816(t0, a1, b1[0], b1[1]);
      mma16816(t1, a1, b1[2], b1[3]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n0 / 8][e] = __fadd_rn(s[n0 / 8][e], t0[e]);
        s[n0 / 8 + 1][e] = __fadd_rn(s[n0 / 8 + 1][e], t1[e]);
      }
    }
  }
}

// the [16 x N] f32 accumulator tile p, rounded to bf16, as the A
// fragments of a product over its N columns (pf[j]: columns 16j..16j+15)
template <int N>
__device__ __forceinline__ void to_a_frags(uint32_t (&pf)[N / 16][4],
                                           const float (&p)[N / 8][4]) {
#pragma unroll
  for (int j = 0; j < N / 16; ++j) {
    pf[j][0] = pack_bf16(p[2 * j][0], p[2 * j][1]);
    pf[j][1] = pack_bf16(p[2 * j][2], p[2 * j][3]);
    pf[j][2] = pack_bf16(p[2 * j + 1][0], p[2 * j + 1][1]);
    pf[j][3] = pack_bf16(p[2 * j + 1][2], p[2 * j + 1][3]);
  }
}

// acc[16 x DC] += P[16 x N] . V[0..N, c0..c0+DC) with P as A fragments
// and V a row-major shared tile ([.][D + 8], read by ldmatrix.trans)
template <int D, int N, int DC>
__device__ __forceinline__ void pv_product(float (&acc)[DC / 8][4],
                                           const uint32_t (&pf)[N / 16][4],
                                           const bf16* v, int c0, int lane) {
  constexpr int LDS = D + 8;
#pragma unroll
  for (int j = 0; j < N / 16; ++j)
#pragma unroll
    for (int d0 = 0; d0 < DC; d0 += 16) {
      uint32_t bf[4];
      ldsm_x4_t(bf, a_addr(v, LDS, 16 * j, c0 + d0, lane));
      mma16816(acc[d0 / 8], pf[j], bf[0], bf[1]);
      mma16816(acc[d0 / 8 + 1], pf[j], bf[2], bf[3]);
    }
}

// a warp's [16 x DC] f32 accumulator, rounded to bf16, into columns
// c0..c0+DC of rows r0..r0+15 of dst (row stride `stride`; rows at or
// past s are skipped), staged through `stage`, 16 rows of a shared tile
// ([.][D + 8]) that only this warp reads, for 16-byte stores
template <int D, int DC>
__device__ __forceinline__ void store_rows(bf16* dst, size_t stride, int r0,
                                           int s, int c0,
                                           const float (&acc)[DC / 8][4],
                                           bf16* stage, int lane) {
  constexpr int LDS = D + 8, CH = DC / 8;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < DC / 8; ++j) {
    *reinterpret_cast<uint32_t*>(stage + g * LDS + j * 8 + 2 * t) =
        pack_bf16(acc[j][0], acc[j][1]);
    *reinterpret_cast<uint32_t*>(stage + (g + 8) * LDS + j * 8 + 2 * t) =
        pack_bf16(acc[j][2], acc[j][3]);
  }
  __syncwarp();
#pragma unroll
  for (int it = 0; it < kRows * CH / 32; ++it) {
    const int i = it * 32 + lane;
    const int r = i / CH, c = i % CH, row = r0 + r;
    if (row < s)
      *reinterpret_cast<uint4*>(dst + row * stride + c0 + c * 8) =
          *reinterpret_cast<const uint4*>(stage + r * LDS + c * 8);
  }
}

template <int D, int BK>
__global__ void __launch_bounds__(kTcThreads, 2) flash_fwd_tc(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, bf16* __restrict__ o,
    float* __restrict__ lse, int h, int sq, int sk, int causal,
    float scale) {
  constexpr int BQ = kWarps * kRows, LDS = D + 8, NB = BK / 8;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* qs = reinterpret_cast<bf16*>(tc_smem);  // [BQ][LDS]
  bf16* ks = qs + BQ * LDS;                     // [2][BK][LDS]
  bf16* vs = ks + 2 * BK * LDS;                 // [2][BK][LDS]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, bb = bh / h, hh = bh % h;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // longest rows first
  const size_t stride = static_cast<size_t>(h) * D;
  const bf16* kg = k + (static_cast<size_t>(bb) * sk * h + hh) * D;
  const bf16* vg = v + (static_cast<size_t>(bb) * sk * h + hh) * D;
  const size_t qoff = (static_cast<size_t>(bb) * sq * h + hh) * D;

  // key tiles past the diagonal of the tile's last row hold no kept col
  const int k_end = causal ? min(sk, q0 + BQ) : sk;
  const int nkt = (k_end + BK - 1) / BK;
  load_rows<BQ, D>(qs, q + qoff, stride, q0, sq);
  load_rows<BK, D>(ks, kg, stride, 0, sk);
  load_rows<BK, D>(vs, vg, stride, 0, sk);
  cp_async_commit();

  const int r0 = warp * kRows, row_lo = q0 + r0;
  float acc[D / 8][4] = {};
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * BK;
    if (kt + 1 < nkt) {
      const int nb = (kt + 1) & 1;
      load_rows<BK, D>(ks + nb * BK * LDS, kg, stride, k0 + BK, sk);
      load_rows<BK, D>(vs + nb * BK * LDS, vg, stride, k0 + BK, sk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* kb = ks + (kt & 1) * BK * LDS;
    const bf16* vb = vs + (kt & 1) * BK * LDS;
    if (!causal || k0 <= row_lo + kRows - 1) {  // the warp keeps a column
      float s[NB][4];
      qk_product<D, BK>(s, qs, r0, kb, lane);
      const bool edge = (causal && k0 + BK - 1 > row_lo) || k0 + BK > sk;
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = __fmul_rn(s[j][e], scale);
          if (edge) {
            const int row = row_lo + g + (e >> 1) * 8;
            const int col = k0 + j * 8 + 2 * t + (e & 1);
            if (col >= sk || (causal && col > row)) x = kNegInf;
          }
          s[j][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m[i], mx[i]);
        alpha[i] = expf(__fsub_rn(m[i], m_new));
        m[i] = m_new;
      }
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = expf(__fsub_rn(s[j][e], m[e >> 1]));
          rs[e >> 1] += p;
          s[j][e] = p;
        }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 1);
        rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 2);
        l[i] = l[i] * alpha[i] + rs[i];
      }
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        acc[j][0] *= alpha[0];
        acc[j][1] *= alpha[0];
        acc[j][2] *= alpha[1];
        acc[j][3] *= alpha[1];
      }
      uint32_t pf[BK / 16][4];
      to_a_frags<BK>(pf, s);
      pv_product<D, BK, D>(acc, pf, vb, 0, lane);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) l[i] = fmaxf(l[i], 1e-30f);
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    acc[j][0] /= l[0];
    acc[j][1] /= l[0];
    acc[j][2] /= l[1];
    acc[j][3] /= l[1];
  }
  store_rows<D, D>(o + qoff, stride, row_lo, sq, 0, acc, qs + r0 * LDS,
                   lane);
  if (t == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row_lo + g + 8 * i;
      if (row < sq)
        lse[static_cast<size_t>(bh) * sq + row] = m[i] + logf(l[i]);
    }
  }
}

template <int D, int BK>
__global__ void __launch_bounds__(kTcThreads, 2) flash_dq_tc(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const bf16* __restrict__ o, const float* __restrict__ lse,
    bf16* __restrict__ dq, float* __restrict__ delta, int h, int sq,
    int sk, int causal, float scale) {
  constexpr int BQ = kWarps * kRows, LDS = D + 8, NB = BK / 8;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* qs = reinterpret_cast<bf16*>(tc_smem);  // [BQ][LDS]
  bf16* dos = qs + BQ * LDS;                    // [BQ][LDS]
  bf16* ks = dos + BQ * LDS;                    // [2][BK][LDS]
  bf16* vs = ks + 2 * BK * LDS;                 // [2][BK][LDS]
  float* stat = reinterpret_cast<float*>(vs + 2 * BK * LDS);  // [BQ][2]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, bb = bh / h, hh = bh % h;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // longest rows first
  const size_t stride = static_cast<size_t>(h) * D;
  const bf16* kg = k + (static_cast<size_t>(bb) * sk * h + hh) * D;
  const bf16* vg = v + (static_cast<size_t>(bb) * sk * h + hh) * D;
  const size_t qoff = (static_cast<size_t>(bb) * sq * h + hh) * D;

  const int k_end = causal ? min(sk, q0 + BQ) : sk;
  const int nkt = (k_end + BK - 1) / BK;
  load_rows<BQ, D>(qs, q + qoff, stride, q0, sq);
  load_rows<BQ, D>(dos, dout + qoff, stride, q0, sq);
  cp_async_commit();
  load_rows<BK, D>(ks, kg, stride, 0, sk);
  load_rows<BK, D>(vs, vg, stride, 0, sk);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  // delta = rowsum(dO * O) of the warp's rows, once, in f32 (and to
  // device memory for the dk/dv kernel)
  const int r0 = warp * kRows, row_lo = q0 + r0;
  for (int r = 0; r < kRows; ++r) {
    const int row = row_lo + r;
    float sum = 0.f;
    if (row < sq) {
      const bf16* orow = o + qoff + row * stride;
      const bf16* drow = dos + (r0 + r) * LDS;
      for (int c = 2 * lane; c < D; c += 64) {
        const float2 of = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(orow + c));
        const float2 df = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(drow + c));
        sum += df.x * of.x + df.y * of.y;
      }
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      const size_t i = static_cast<size_t>(bh) * sq + row;
      stat[2 * (r0 + r)] = row < sq ? lse[i] : 0.f;
      stat[2 * (r0 + r) + 1] = sum;
      if (row < sq) delta[i] = sum;
    }
  }
  __syncwarp();
  float ls[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    ls[i] = stat[2 * (r0 + g + 8 * i)];
    dl[i] = stat[2 * (r0 + g + 8 * i) + 1];
  }

  float acc[D / 8][4] = {};
  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * BK;
    if (kt + 1 < nkt) {
      const int nb = (kt + 1) & 1;
      load_rows<BK, D>(ks + nb * BK * LDS, kg, stride, k0 + BK, sk);
      load_rows<BK, D>(vs + nb * BK * LDS, vg, stride, k0 + BK, sk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* kb = ks + (kt & 1) * BK * LDS;
    const bf16* vb = vs + (kt & 1) * BK * LDS;
    if (!causal || k0 <= row_lo + kRows - 1) {  // the warp keeps a column
      float s[NB][4], dp[NB][4];
      qk_product<D, BK>(s, qs, r0, kb, lane);    // S = Q K^T
      qk_product<D, BK>(dp, dos, r0, vb, lane);  // dP = dO V^T
      const bool edge = (causal && k0 + BK - 1 > row_lo) || k0 + BK > sk;
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = __fmul_rn(s[j][e], scale);
          if (edge) {
            const int row = row_lo + g + (e >> 1) * 8;
            const int col = k0 + j * 8 + 2 * t + (e & 1);
            if (col >= sk || (causal && col > row)) x = kNegInf;
          }
          s[j][e] = ds_of(expf(__fsub_rn(x, ls[e >> 1])), dp[j][e],
                          dl[e >> 1], scale);
        }
      uint32_t pf[BK / 16][4];
      to_a_frags<BK>(pf, s);
      pv_product<D, BK, D>(acc, pf, kb, 0, lane);  // dq += ds K
    }
    __syncthreads();
  }
  store_rows<D, D>(dq + qoff, stride, row_lo, sq, 0, acc, qs + r0 * LDS,
                   lane);
}

template <int D, int BQ, int DC>
__global__ void __launch_bounds__(kTcThreads, 2) flash_dkv_tc(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int h, int sq, int sk,
    int causal, float scale) {
  constexpr int BK = kWarps * kRows, LDS = D + 8, NB = BQ / 8;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* ks = reinterpret_cast<bf16*>(tc_smem);  // [BK][LDS]
  bf16* vs = ks + BK * LDS;                     // [BK][LDS]
  bf16* qs = vs + BK * LDS;                     // [2][BQ][LDS]
  bf16* dos = qs + 2 * BQ * LDS;                // [2][BQ][LDS]
  float* lse_s = reinterpret_cast<float*>(dos + 2 * BQ * LDS);  // [2][BQ]
  float* delta_s = lse_s + 2 * BQ;                              // [2][BQ]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, bb = bh / h, hh = bh % h;
  const int k0 = blockIdx.x * BK, c0 = blockIdx.z * DC;
  const size_t stride = static_cast<size_t>(h) * D;
  const bf16* qg = q + (static_cast<size_t>(bb) * sq * h + hh) * D;
  const bf16* dog = dout + (static_cast<size_t>(bb) * sq * h + hh) * D;
  const float* lg = lse + static_cast<size_t>(bh) * sq;
  const float* dg = delta + static_cast<size_t>(bh) * sq;
  const size_t koff = (static_cast<size_t>(bb) * sk * h + hh) * D;

  // one query tile's rows, with their lse and delta, into buffer buf
  auto load_q = [&](int buf, int q0) {
    load_rows<BQ, D>(qs + buf * BQ * LDS, qg, stride, q0, sq);
    load_rows<BQ, D>(dos + buf * BQ * LDS, dog, stride, q0, sq);
    if (threadIdx.x < 2 * BQ) {
      const int r = threadIdx.x % BQ, row = q0 + r;
      const bool ok = row < sq;
      if (threadIdx.x < BQ)
        cp_async4(lse_s + buf * BQ + r, lg + (ok ? row : 0), ok);
      else
        cp_async4(delta_s + buf * BQ + r, dg + (ok ? row : 0), ok);
    }
  };

  // query tiles whose last row lies before k0 hold no kept entry
  const int q_start = causal ? (k0 / BQ) * BQ : 0;
  const int nqt = q_start < sq ? (sq - q_start + BQ - 1) / BQ : 0;
  load_rows<BK, D>(ks, k + koff, stride, k0, sk);
  load_rows<BK, D>(vs, v + koff, stride, k0, sk);
  if (nqt > 0) load_q(0, q_start);
  cp_async_commit();

  const int r0 = warp * kRows, key_lo = k0 + r0;
  float dk_acc[DC / 8][4] = {}, dv_acc[DC / 8][4] = {};
  for (int it = 0; it < nqt; ++it) {
    const int q0 = q_start + it * BQ, buf = it & 1;
    if (it + 1 < nqt) {
      load_q(buf ^ 1, q0 + BQ);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* qb = qs + buf * BQ * LDS;
    const bf16* dob = dos + buf * BQ * LDS;
    const float* ls = lse_s + buf * BQ;
    const float* ds = delta_s + buf * BQ;
    if (!causal || key_lo <= q0 + BQ - 1) {  // a row here keeps a key
      float s[NB][4], dp[NB][4];
      qk_product<D, BQ>(s, ks, r0, qb, lane);    // S^T = K Q^T
      qk_product<D, BQ>(dp, vs, r0, dob, lane);  // dP^T = V dO^T
      const bool edge = (causal && key_lo + kRows - 1 > q0)
                        || q0 + BQ > sq || k0 + BK > sk;
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = j * 8 + 2 * t + (e & 1);  // the query in the tile
          float x = __fmul_rn(s[j][e], scale);
          if (edge) {
            const int key = key_lo + g + (e >> 1) * 8, row = q0 + c;
            if (key >= sk || row >= sq || (causal && key > row))
              x = kNegInf;
          }
          const float p = expf(__fsub_rn(x, ls[c]));
          dp[j][e] = ds_of(p, dp[j][e], ds[c], scale);  // ds^T
          s[j][e] = p;                                  // P^T
        }
      uint32_t pf[BQ / 16][4];
      to_a_frags<BQ>(pf, s);
      pv_product<D, BQ, DC>(dv_acc, pf, dob, c0, lane);  // dv += P^T dO
      to_a_frags<BQ>(pf, dp);
      pv_product<D, BQ, DC>(dk_acc, pf, qb, c0, lane);   // dk += ds^T Q
    }
    __syncthreads();
  }
  if (nqt == 0) {  // no query keeps these keys: dk = dv = 0
    cp_async_wait<0>();
    __syncthreads();
  }
  store_rows<D, DC>(dk + koff, stride, key_lo, sk, c0, dk_acc,
                    ks + r0 * LDS, lane);
  store_rows<D, DC>(dv + koff, stride, key_lo, sk, c0, dv_acc,
                    vs + r0 * LDS, lane);
}

template <int D> constexpr size_t fwd_tc_smem() {
  return sizeof(bf16) * (kWarps * kRows + 4 * TcTile<D>::FWD_BK) * (D + 8);
}
template <int D> constexpr size_t dq_tc_smem() {
  return sizeof(bf16) * (2 * kWarps * kRows + 4 * TcTile<D>::DQ_BK) * (D + 8)
         + sizeof(float) * 2 * kWarps * kRows;
}
template <int D> constexpr size_t dkv_tc_smem() {
  return sizeof(bf16) * (2 * kWarps * kRows + 4 * TcTile<D>::DKV_BQ)
             * (D + 8)
         + sizeof(float) * 4 * TcTile<D>::DKV_BQ;
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

// every CTA takes more than the default 48 KB of shared memory: opt in
// before the launch
template <typename K, typename... P>
cudaError_t launch(K kernel, dim3 grid, int threads, size_t smem,
                   cudaStream_t stream, P... args) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  kernel<<<grid, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

struct Args {
  const void *q, *k, *v, *dout, *o;
  void *out, *out2;
  float *lse, *delta;
  int b, h, sq, sk, causal;
  float scale;
  cudaStream_t stream;
};

int cdiv(int a, int b) { return (a + b - 1) / b; }

template <typename T> const T* in(const void* p) {
  return static_cast<const T*>(p);
}
template <typename T> T* out(void* p) { return static_cast<T*>(p); }

enum Kind { kFwd, kDq, kDkv };

template <int D>
int run_f32(Kind kind, const Args& a) {
  using F = float;
  constexpr int BQ = Tile<D>::BQ, BK = Tile<D>::BK;
  switch (kind) {
    case kFwd:
      return launch(flash_fwd_kernel<D>, dim3(cdiv(a.sq, BQ), a.b * a.h),
                    kThreads, fwd_smem<D>(), a.stream, in<F>(a.q),
                    in<F>(a.k), in<F>(a.v), out<F>(a.out), a.lse, a.h, a.sq,
                    a.sk, a.causal, a.scale);
    case kDq:
      return launch(flash_bwd_dq_kernel<D>, dim3(cdiv(a.sq, BQ), a.b * a.h),
                    kThreads, dq_smem<D>(), a.stream, in<F>(a.q), in<F>(a.k),
                    in<F>(a.v), in<F>(a.dout), in<F>(a.o),
                    static_cast<const float*>(a.lse), out<F>(a.out), a.delta,
                    a.h, a.sq, a.sk, a.causal, a.scale);
    case kDkv:
      return launch(flash_bwd_dkv_kernel<D>,
                    dim3(cdiv(a.sk, BK), a.b * a.h), kThreads, dkv_smem<D>(),
                    a.stream, in<F>(a.q), in<F>(a.k), in<F>(a.v),
                    in<F>(a.dout), static_cast<const float*>(a.lse),
                    static_cast<const float*>(a.delta), out<F>(a.out),
                    out<F>(a.out2), a.h, a.sq, a.sk, a.causal, a.scale);
  }
  return cudaErrorInvalidValue;
}

template <int D>
int run_bf16(Kind kind, const Args& a) {
  using B = bf16;
  using TT = TcTile<D>;
  constexpr int BQ = kWarps * kRows;
  switch (kind) {
    case kFwd:
      return launch(flash_fwd_tc<D, TT::FWD_BK>,
                    dim3(cdiv(a.sq, BQ), a.b * a.h), kTcThreads,
                    fwd_tc_smem<D>(), a.stream, in<B>(a.q), in<B>(a.k),
                    in<B>(a.v), out<B>(a.out), a.lse, a.h, a.sq, a.sk,
                    a.causal, a.scale);
    case kDq:
      return launch(flash_dq_tc<D, TT::DQ_BK>,
                    dim3(cdiv(a.sq, BQ), a.b * a.h), kTcThreads,
                    dq_tc_smem<D>(), a.stream, in<B>(a.q), in<B>(a.k),
                    in<B>(a.v), in<B>(a.dout), in<B>(a.o),
                    static_cast<const float*>(a.lse), out<B>(a.out), a.delta,
                    a.h, a.sq, a.sk, a.causal, a.scale);
    case kDkv:
      return launch(flash_dkv_tc<D, TT::DKV_BQ, TT::DKV_DC>,
                    dim3(cdiv(a.sk, kWarps * kRows), a.b * a.h,
                         D / TT::DKV_DC),
                    kTcThreads, dkv_tc_smem<D>(), a.stream, in<B>(a.q),
                    in<B>(a.k), in<B>(a.v), in<B>(a.dout),
                    static_cast<const float*>(a.lse),
                    static_cast<const float*>(a.delta), out<B>(a.out),
                    out<B>(a.out2), a.h, a.sq, a.sk, a.causal, a.scale);
  }
  return cudaErrorInvalidValue;
}

// the built (dtype, head dim) variants; anything else is refused
int dispatch(Kind kind, int dtype, int d, const Args& a) {
  using veles::kBF16;
  using veles::kF32;
  if (dtype == kF32 && d == 128) return run_f32<128>(kind, a);
  if (dtype == kF32 && d == 256) return run_f32<256>(kind, a);
  if (dtype == kBF16 && d == 128) return run_bf16<128>(kind, a);
  if (dtype == kBF16 && d == 256) return run_bf16<256>(kind, a);
  return cudaErrorInvalidValue;
}

}  // namespace

// q [b, sq, h, d], k/v [b, sk, h, d] → o [b, sq, h, d] (input type) and
// lse [b, h, sq] f32
extern "C" int veles_flash_fwd(const void* q, const void* k, const void* v,
                               void* o, float* lse, int dtype, int b, int h,
                               int sq, int sk, int d, int causal,
                               float scale, void* stream) {
  Args a{q, k, v, nullptr, nullptr, o, nullptr, lse, nullptr, b, h, sq, sk,
         causal, scale, static_cast<cudaStream_t>(stream)};
  return dispatch(kFwd, dtype, d, a);
}

// dq [b, sq, h, d] and delta = rowsum(dO * O) [b, h, sq] f32 from q, k,
// v, dO, O and the forward's lse
extern "C" int veles_flash_bwd_dq(const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const void* o, const float* lse, void* dq,
                                  float* delta, int dtype, int b, int h,
                                  int sq, int sk, int d, int causal,
                                  float scale, void* stream) {
  Args a{q, k, v, dout, o, dq, nullptr, const_cast<float*>(lse), delta, b,
         h, sq, sk, causal, scale, static_cast<cudaStream_t>(stream)};
  return dispatch(kDq, dtype, d, a);
}

// dk, dv [b, sk, h, d] from q, k, v, dO, the forward's lse and the dq
// kernel's delta
extern "C" int veles_flash_bwd_dkv(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const float* lse, const float* delta,
                                   void* dk, void* dv, int dtype, int b,
                                   int h, int sq, int sk, int d, int causal,
                                   float scale, void* stream) {
  Args a{q, k, v, dout, nullptr, dk, dv, const_cast<float*>(lse),
         const_cast<float*>(delta), b, h, sq, sk, causal, scale,
         static_cast<cudaStream_t>(stream)};
  return dispatch(kDkv, dtype, d, a);
}
