// Block-table (paged) decode attention over an fp32, bf16 or int8 KV
// pool, with the int8 dequant fused into the loads.
//
// Replaces: veles_tpu/ops/pallas_paged.py::pallas_paged_attend (the
// Pallas body _attend_kernel).  Same function: for each row b and query
// j at position qpos[b, j], walk the physical blocks tables[b, t] of the
// pool, dequantize int8 rows by their per-row scales, mask
// t*bs + col <= qpos[b, j] with the finite -1e30, fold each block into an
// online softmax, and write the f32 context [B, K1, d].  A query at a
// negative position masks every key, so each score is -1e30 and its
// context is the mean of all T*bs V rows of the table: a row with such a
// query walks every block (the TPU kernel's grid always does).
//
// What bounds it on the card: bytes.  A decode step does ~4 flops per
// K/V byte it reads, far below the H100's ~295 flop/byte ridge, so the
// time floor is the K/V blocks of the table up to the deepest query
// (int8: d bytes per row per tensor, plus a 4-byte scale) over HBM
// bandwidth: 2.2 MB, 0.7 us, for the serving model's decode step at
// positions 128-159; 14.5 MB, 4.3 us, at a 1024-token window.  Both are
// below a launch's fixed latency, so the design is about bytes in flight
// and about few dependent steps per CTA.
//
// Two kernels; ops/paged_attend.py::plan picks one from the shape alone:
//
// - paged_split_kernel, split-K ("flash decoding") over a thread-block
//   cluster, for every head row of a multiple of 16 bytes on 16-byte
//   aligned pools.  The grid is (split rank, head, row) with the ranks of
//   a (row, head) in one cluster of up to 8 CTAs (the portable size).
//   Each CTA reads the row's positions and table itself, in one round
//   trip, so the host never reads them back: a row walks its blocks up
//   to its deepest query's (all of them if a query is negative), split
//   in equal shares over the ranks.  A rank stages its share's K rows
//   (and scales) and V rows in shared memory with 16-byte cp.async
//   copies, K in one copy group and V in a second, every copy issued
//   before any is waited on (32 KB of K/V per tile at most); then a
//   group of lanes per key row (8 lanes for a 128-wide int8 head, each
//   holding its 16 query features in registers when K1 = 1) takes the
//   row's dot products with the queries, reduced by shuffles, while V is
//   still in flight; one warp per query folds the tile's scores into the
//   running max and sum; and each thread accumulates 4 features of the
//   context over a subset of the tile's rows, the subsets added in a
//   fixed order at the end.  The ranks' partials (m, l, acc) meet
//   through distributed shared memory: each rank pushes its (m, l) to
//   every rank and each of its outputs to the rank that merges it
//   (remote stores, so one visible cluster barrier and no remote round
//   trip; the barrier that remote stores need, that every CTA has
//   started, is arrived at on entry and waited on before the pushes),
//   and each rank merges its slice of the K1 x hd outputs in rank order,
//   rescaling each partial by exp(m_rank - M).  No atomics, so two runs
//   are bit-equal.  A rank whose share is empty (past the deepest query)
//   loads nothing and pushes m = -1e30, l = 0 and no outputs, and the
//   merge skips partials with l = 0: a rank whose keys are all masked
//   has l > 0 (its local softmax weighs each masked key exp(0) = 1),
//   which the merge drops exactly when M is finite (exp(-1e30 - M) = 0)
//   and keeps when every score of the query is masked (M = -1e30).
//   Registers decide the speed at the serving shapes: a cluster of 8
//   must find 8 free CTA slots in one GPC, so the K1 = 1 kernel is held
//   to 64 registers (launch bounds); at 99 it took 0.0138 ms per launch
//   at T = 16 instead of 0.0093 on an H100.
// - paged_column_kernel, the first design, for other head widths or
//   misaligned pools: one CTA per (row, head), one thread per feature
//   column, scores reduced across the CTA by shuffles and shared memory
//   one key row at a time.  Latency-bound (64 CTAs at B = 8, each a
//   chain of dependent load -> reduce steps), kept because it takes any
//   shape.
//
// The C entry refuses (-2) a split launch whose shape, alignment, cluster
// or shared memory it cannot take; it never switches kernels.
#include <cooperative_groups.h>
#include <limits.h>

#include <atomic>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

using veles::to_f;
using veles::warp_sum;
using veles::widen4;

constexpr float kNegInf = -1e30f;
constexpr int kMaxCluster = 8;       // the portable cluster size
constexpr int kMaxThreads = 256;
constexpr int kSmemMax = 232448;     // the 227 KB a CTA may opt into
constexpr int kRefused = -2;
constexpr int kMaxDevices = 64;      // devices whose opt-in is remembered

// -- the column kernel ------------------------------------------------------

template <typename QT, typename PT, bool QUANT, int KMAX>
__global__ void paged_column_kernel(
    const QT* __restrict__ q, const PT* __restrict__ pool_k,
    const PT* __restrict__ pool_v, const float* __restrict__ scale_k,
    const float* __restrict__ scale_v, const int* __restrict__ tables,
    const int* __restrict__ qpos, float* __restrict__ out, int k1, int d,
    int hd, int bs, int nt, float scale) {
  extern __shared__ float smem[];
  const int nw = blockDim.x >> 5;
  const int nsc = k1 * bs;
  float* red = smem;                                 // [nw][k1*bs]
  float* sc = red + nw * nsc;                        // [k1*bs]
  int* qp = reinterpret_cast<int*>(sc + nsc);        // [k1]

  const int b = blockIdx.x;
  const int head = blockIdx.y;
  const int c = threadIdx.x;
  const int lane = c & 31;
  const int warp = c >> 5;
  const bool own = c < hd;
  const int col = head * hd + (own ? c : 0);

  for (int j = c; j < k1; j += blockDim.x) qp[j] = qpos[b * k1 + j];
  __syncthreads();
  int minq = qp[0], maxq = qp[0];
  for (int j = 1; j < k1; ++j) {
    minq = min(minq, qp[j]);
    maxq = max(maxq, qp[j]);
  }
  // a block whose first column lies past every query adds exactly
  // nothing (its probabilities are exp(-1e30 - m) = 0 and alpha = 1),
  // so the walk stops at the deepest query's block; a query at a
  // negative position averages every block
  const int live = minq < 0 ? nt : min(nt, maxq / bs + 1);

  float qv[KMAX], acc[KMAX], m[KMAX], l[KMAX];
#pragma unroll
  for (int j = 0; j < KMAX; ++j) {
    qv[j] = (own && j < k1)
        ? to_f(q[(static_cast<size_t>(b) * k1 + j) * d + col]) : 0.f;
    acc[j] = 0.f;
    m[j] = kNegInf;
    l[j] = 0.f;
  }

  for (int t = 0; t < live; ++t) {
    const size_t row0 = static_cast<size_t>(tables[b * nt + t]) * bs;
#pragma unroll 4
    for (int r = 0; r < bs; ++r) {
      float kv = own ? to_f(pool_k[(row0 + r) * d + col]) : 0.f;
      if (QUANT) kv *= scale_k[row0 + r];
#pragma unroll
      for (int j = 0; j < KMAX; ++j) {
        if (j < k1) {
          const float p = warp_sum(qv[j] * kv);
          if (lane == 0) red[warp * nsc + j * bs + r] = p;
        }
      }
    }
    __syncthreads();
    for (int i = c; i < nsc; i += blockDim.x) {
      float s = 0.f;
      for (int w = 0; w < nw; ++w) s += red[w * nsc + i];
      const int j = i / bs;
      const int r = i - j * bs;
      sc[i] = (t * bs + r <= qp[j]) ? s * scale : kNegInf;
    }
    __syncthreads();
    float mc[KMAX], lsum[KMAX], a[KMAX];
#pragma unroll
    for (int j = 0; j < KMAX; ++j) {
      mc[j] = m[j];
      lsum[j] = 0.f;
      a[j] = 0.f;
      if (j < k1)
        for (int r = 0; r < bs; ++r) mc[j] = fmaxf(mc[j], sc[j * bs + r]);
    }
#pragma unroll 4
    for (int r = 0; r < bs; ++r) {
      float vv = own ? to_f(pool_v[(row0 + r) * d + col]) : 0.f;
      if (QUANT) vv *= scale_v[row0 + r];
#pragma unroll
      for (int j = 0; j < KMAX; ++j) {
        if (j < k1) {
          const float p = expf(sc[j * bs + r] - mc[j]);
          lsum[j] += p;
          a[j] += p * vv;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < KMAX; ++j) {
      if (j < k1) {
        const float alpha = expf(m[j] - mc[j]);
        l[j] = l[j] * alpha + lsum[j];
        acc[j] = acc[j] * alpha + a[j];
        m[j] = mc[j];
      }
    }
  }
  if (own) {
#pragma unroll
    for (int j = 0; j < KMAX; ++j)
      if (j < k1)
        out[(static_cast<size_t>(b) * k1 + j) * d + col] =
            acc[j] / fmaxf(l[j], 1e-30f);
  }
}

// -- the split kernel -------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n"
               ::: "memory");
}

// 16 bytes of a pool row -> 16 / sizeof(PT) floats (int8 unscaled)
__device__ __forceinline__ void widen16(const uint4& w, float (&f)[16]) {
  const uint32_t x[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float g[4];
    widen4(x[i], g);
#pragma unroll
    for (int e = 0; e < 4; ++e) f[4 * i + e] = g[e];
  }
}
__device__ __forceinline__ void widen16(const uint4& w, float (&f)[8]) {
  const uint32_t x[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(x[i] << 16);
    f[2 * i + 1] = __uint_as_float(x[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void widen16(const uint4& w, float (&f)[4]) {
  f[0] = __uint_as_float(w.x);
  f[1] = __uint_as_float(w.y);
  f[2] = __uint_as_float(w.z);
  f[3] = __uint_as_float(w.w);
}

// 4 consecutive pool elements from shared memory -> floats
__device__ __forceinline__ void load4(const int8_t* p, float (&f)[4]) {
  widen4(*reinterpret_cast<const uint32_t*>(p), f);
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p,
                                      float (&f)[4]) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  f[0] = __uint_as_float(w.x << 16);
  f[1] = __uint_as_float(w.x & 0xffff0000u);
  f[2] = __uint_as_float(w.y << 16);
  f[3] = __uint_as_float(w.y & 0xffff0000u);
}
__device__ __forceinline__ void load4(const float* p, float (&f)[4]) {
  const float4 w = *reinterpret_cast<const float4*>(p);
  f[0] = w.x; f[1] = w.y; f[2] = w.z; f[3] = w.w;
}

struct SplitParams {
  const void* q;
  const void* pool_k;
  const void* pool_v;
  const float* scale_k;
  const float* scale_v;
  const int* tables;
  const int* qpos;
  float* out;
  int k1, d, hd, bs, nt, tile, q_bf16;
  float scale;
};

// threads of a split CTA: one per 4 features of the head, at least 128
__host__ __device__ inline int split_threads(int hd) {
  return hd / 4 <= 128 ? 128 : kMaxThreads;
}

// shared memory of a split CTA (ops/paged_attend.py::split_smem mirrors
// it): m, l, alpha, positions [KMAX], merge weights and the ranks' m and
// l [3][8][KMAX]; the table row [nt4]; K and V tiles [tile][hd]; scales
// [2][tile4]; scores [k1][tile4]; queries [k1][hd] f32; the row subsets'
// contexts [subsets][k1][hd] f32; the ranks' pushed slices [k1*hd + 8]
__host__ __device__ inline size_t split_smem(int kmax, int k1, int hd,
                                             int elem, int tile, int nt,
                                             bool quant) {
  const int tile4 = (tile + 3) / 4 * 4;
  const int nt4 = (nt + 3) / 4 * 4;
  const int subsets = split_threads(hd) / (hd / 4);
  return static_cast<size_t>(4 + 3 * kMaxCluster) * kmax * 4 + 4ull * nt4
      + 2ull * tile * hd * elem + (quant ? 8ull * tile4 : 0)
      + 4ull * k1 * tile4 + 4ull * k1 * hd + 4ull * subsets * k1 * hd
      + 4ull * (k1 * hd + kMaxCluster);
}

template <typename PT, bool QUANT, int KMAX>
__global__ void __launch_bounds__(kMaxThreads, KMAX == 1 ? 4 : 1)
paged_split_kernel(const SplitParams p) {
  constexpr int kVec = 16 / sizeof(PT);        // elements per 16 bytes
  // one query whose lanes take one chunk each keeps its chunk in
  // registers
  constexpr int kQRegs = KMAX == 1 ? kVec : 1;
  extern __shared__ __align__(16) unsigned char sbuf[];
  // every CTA of the cluster must have started before another writes
  // its shared memory: arrive now, wait before the first remote store
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int csize = static_cast<int>(gridDim.x);   // the cluster spans x
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int k1 = p.k1, hd = p.hd, bs = p.bs, nt = p.nt, tile = p.tile;
  const int rowb = hd * static_cast<int>(sizeof(PT));
  const int chunks = rowb / 16;                    // 16-byte chunks a row
  const int tile4 = (tile + 3) / 4 * 4;
  const int nt4 = (nt + 3) / 4 * 4;
  const int cv = hd / 4;                           // 4-feature columns
  const int subsets = nthr / cv;
  const int n_out = k1 * hd;
  const int per = (n_out + csize - 1) / csize;     // outputs a rank merges

  float* m_s = reinterpret_cast<float*>(sbuf);     // [KMAX] running max
  float* l_s = m_s + KMAX;                         // [KMAX] running sum
  float* a_s = l_s + KMAX;                         // [KMAX] alpha, then L
  int* qp_s = reinterpret_cast<int*>(a_s + KMAX);  // [KMAX] positions
  float* w_s = reinterpret_cast<float*>(qp_s + KMAX);  // [8][KMAX]
  float* rm_s = w_s + kMaxCluster * KMAX;          // [8][KMAX] ranks' m
  float* rl_s = rm_s + kMaxCluster * KMAX;         // [8][KMAX] ranks' l
  int* tbl_s = reinterpret_cast<int*>(rl_s + kMaxCluster * KMAX);  // [nt4]
  unsigned char* kt = reinterpret_cast<unsigned char*>(tbl_s + nt4);
  unsigned char* vt = kt + tile * rowb;            // [tile][rowb]
  float* sk = reinterpret_cast<float*>(vt + tile * rowb);  // [tile4]
  float* sv = sk + (QUANT ? tile4 : 0);            // [tile4]
  float* s_s = sv + (QUANT ? tile4 : 0);           // [k1][tile4]
  float* q_s = s_s + k1 * tile4;                   // [k1][hd]
  float* red = q_s + k1 * hd;                      // [subsets][k1][hd]
  float* recv = red + subsets * n_out;             // [csize][per]

  // the row's positions and table, in one round trip
  for (int j = tid; j < KMAX; j += nthr) {
    qp_s[j] = j < k1 ? p.qpos[b * k1 + j] : 0;
    m_s[j] = kNegInf;
    l_s[j] = 0.f;
  }
  const int* table = p.tables + static_cast<size_t>(b) * nt;
  for (int i = tid; i < nt; i += nthr) tbl_s[i] = table[i];
  __syncthreads();
  int minq = qp_s[0], maxq = qp_s[0];
  for (int j = 1; j < k1; ++j) {
    minq = min(minq, qp_s[j]);
    maxq = max(maxq, qp_s[j]);
  }
  // the row's walk (blocks past every query add exactly nothing), this
  // rank's share of it, and its rows: none past the deepest query
  const int live = minq < 0 ? nt : min(nt, maxq / bs + 1);
  const int share = (live + csize - 1) / csize;
  const int row0 = min(live, rank * share) * bs;
  int row1 = min(live, (rank + 1) * share) * bs;
  if (minq >= 0) row1 = min(row1, maxq + 1);

  // scores: a group of g lanes per key row, each lane nch chunks of it
  int g = 1;
  while (g < chunks && g < 32) g *= 2;
  const int nch = (chunks + g - 1) / g;
  const bool q_regs = KMAX == 1 && nch == 1;
  const int groups = nthr / g;
  const int gi = tid / g;
  const int gl = tid - gi * g;
  // context: thread (subset ps, column pc) owns features 4pc .. 4pc + 3
  // over the tile's rows ps, ps + subsets, ...
  const int ps = tid / cv;
  const int pc = tid - ps * cv;
  const bool pv = ps < subsets;

  float acc[KMAX][4];
#pragma unroll
  for (int j = 0; j < KMAX; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
  float qr[kQRegs];

  const size_t rstride = static_cast<size_t>(p.d) * sizeof(PT);
  const char* gk = static_cast<const char*>(p.pool_k) + head * rowb;
  const char* gv = static_cast<const char*>(p.pool_v) + head * rowb;
  for (int t0 = row0; t0 < row1; t0 += tile) {
    const int tr = min(tile, row1 - t0);
    // every copy of the tile in flight before any is waited on: K (and
    // its scales) in one group, V in a second, waited on only after the
    // scores
    for (int i = tid; i < tr * chunks; i += nthr) {
      const int r = i / chunks;
      const int pos = t0 + r;
      const size_t prow =
          static_cast<size_t>(tbl_s[pos / bs]) * bs + pos % bs;
      const int off = (i - r * chunks) * 16;
      cp_async16(kt + r * rowb + off, gk + prow * rstride + off);
    }
    if (QUANT) {
      for (int r = tid; r < tr; r += nthr) {
        const int pos = t0 + r;
        cp_async4(sk + r, p.scale_k
                  + static_cast<size_t>(tbl_s[pos / bs]) * bs + pos % bs);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    for (int i = tid; i < tr * chunks; i += nthr) {
      const int r = i / chunks;
      const int pos = t0 + r;
      const size_t prow =
          static_cast<size_t>(tbl_s[pos / bs]) * bs + pos % bs;
      const int off = (i - r * chunks) * 16;
      cp_async16(vt + r * rowb + off, gv + prow * rstride + off);
    }
    if (QUANT) {
      for (int r = tid; r < tr; r += nthr) {
        const int pos = t0 + r;
        cp_async4(sv + r, p.scale_v
                  + static_cast<size_t>(tbl_s[pos / bs]) * bs + pos % bs);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    if (t0 == row0) {                 // the queries, while the copies fly
      const size_t qb = static_cast<size_t>(b) * k1 * p.d + head * hd;
      for (int i = tid; i < n_out; i += nthr) {
        const int j = i / hd;
        const size_t at = qb + static_cast<size_t>(j) * p.d + (i - j * hd);
        q_s[i] = p.q_bf16
            ? __bfloat162float(static_cast<const __nv_bfloat16*>(p.q)[at])
            : static_cast<const float*>(p.q)[at];
      }
    }
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();
    if (q_regs && t0 == row0) {
#pragma unroll
      for (int e = 0; e < kQRegs; ++e)
        qr[e] = gl < chunks ? q_s[gl * kVec + e] : 0.f;
    }

    // scores s[j][r]; every lane of a warp runs the same trip count
    for (int rb = 0; rb < tr; rb += groups) {
      const int r = rb + gi;
      const bool valid = r < tr;
      float dot[KMAX];
#pragma unroll
      for (int j = 0; j < KMAX; ++j) dot[j] = 0.f;
      if (valid) {
        if (q_regs) {
          if (gl < chunks) {
            float kf[kVec];
            widen16(*reinterpret_cast<const uint4*>(kt + r * rowb + gl * 16),
                    kf);
#pragma unroll
            for (int e = 0; e < kVec; ++e)
              dot[0] = fmaf(qr[e], kf[e], dot[0]);
          }
        } else {
          for (int u = 0; u < nch; ++u) {
            const int ch = gl + u * g;
            if (ch >= chunks) break;
            float kf[kVec];
            widen16(*reinterpret_cast<const uint4*>(kt + r * rowb + ch * 16),
                    kf);
#pragma unroll
            for (int j = 0; j < KMAX; ++j) {
              if (j < k1) {
                const float* qq = q_s + j * hd + ch * kVec;
#pragma unroll
                for (int e = 0; e < kVec; ++e)
                  dot[j] = fmaf(qq[e], kf[e], dot[j]);
              }
            }
          }
        }
      }
#pragma unroll
      for (int j = 0; j < KMAX; ++j) {
        if (j < k1) {
          for (int off = g / 2; off > 0; off >>= 1)
            dot[j] += __shfl_xor_sync(0xffffffffu, dot[j], off);
        }
      }
      if (valid && gl == 0) {
        const float ks = QUANT ? sk[r] : 1.f;
#pragma unroll
        for (int j = 0; j < KMAX; ++j)
          if (j < k1)
            s_s[j * tile4 + r] = t0 + r <= qp_s[j]
                ? (QUANT ? dot[j] * ks : dot[j]) * p.scale : kNegInf;
      }
    }
    __syncthreads();

    // one warp per query: fold the tile into the running max and sum,
    // the scores become the tile's probabilities
    for (int j = warp; j < k1; j += nthr / 32) {
      float* sj = s_s + j * tile4;
      float mx = kNegInf;
      for (int r = lane; r < tr; r += 32) mx = fmaxf(mx, sj[r]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[j];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int r = lane; r < tr; r += 32) {
        const float e = expf(sj[r] - m_new);
        sj[r] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[j] = alpha;
        l_s[j] = l_s[j] * alpha + sum;
        m_s[j] = m_new;
      }
    }
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();

    if (pv) {
#pragma unroll
      for (int j = 0; j < KMAX; ++j) {
        if (j < k1) {
          const float alpha = a_s[j];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[j][i] *= alpha;
        }
      }
      const PT* vcol = reinterpret_cast<const PT*>(vt) + 4 * pc;
      for (int r = ps; r < tr; r += subsets) {
        float v[4];
        load4(vcol + r * hd, v);
        if (QUANT) {
          const float s = sv[r];
#pragma unroll
          for (int i = 0; i < 4; ++i) v[i] *= s;
        }
#pragma unroll
        for (int j = 0; j < KMAX; ++j) {
          if (j < k1) {
            const float pj = s_s[j * tile4 + r];
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[j][i] = fmaf(pj, v[i], acc[j][i]);
          }
        }
      }
    }
    __syncthreads();                // the next tile overwrites the tiles
  }

  // this rank's context: the subsets' sums added in subset order
  if (pv) {
#pragma unroll
    for (int j = 0; j < KMAX; ++j)
      if (j < k1)
        *reinterpret_cast<float4*>(red + (ps * k1 + j) * hd + 4 * pc) =
            make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
  }
  __syncthreads();
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  // push (m, l) to every rank and each output to the rank that merges
  // it; a rank without rows for a query (l = 0) pushes no outputs of it,
  // which the merge never reads
  for (int i = tid; i < csize * k1; i += nthr) {
    const int x = i / k1;
    const int j = i - x * k1;
    cluster.map_shared_rank(rm_s, x)[rank * KMAX + j] = m_s[j];
    cluster.map_shared_rank(rl_s, x)[rank * KMAX + j] = l_s[j];
  }
  for (int e = tid; e < n_out; e += nthr) {
    const int j = e / hd;
    if (!(l_s[j] > 0.f)) continue;
    float v = red[e];
    for (int s = 1; s < subsets; ++s) v += red[s * n_out + e];
    const int x = e / per;
    cluster.map_shared_rank(recv, x)[rank * per + e - x * per] = v;
  }
  cluster.sync();                   // every push has landed

  // merge weights: exp(m_x - M) for the ranks that hold rows (l > 0),
  // and the merged sum L in a_s
  for (int j = tid; j < k1; j += nthr) {
    float big = kNegInf;
    for (int x = 0; x < csize; ++x)
      if (rl_s[x * KMAX + j] > 0.f) big = fmaxf(big, rm_s[x * KMAX + j]);
    float total = 0.f;
    for (int x = 0; x < csize; ++x) {
      const float lx = rl_s[x * KMAX + j];
      const float w = lx > 0.f ? expf(rm_s[x * KMAX + j] - big) : 0.f;
      w_s[x * KMAX + j] = w;
      total += lx * w;
    }
    a_s[j] = total;
  }
  __syncthreads();
  // this rank's slice of the outputs, the ranks' partials in rank order
  const int e1 = min(n_out, (rank + 1) * per);
  for (int e = rank * per + tid; e < e1; e += nthr) {
    const int j = e / hd;
    const int i = e - rank * per;
    float v = 0.f;
    for (int x = 0; x < csize; ++x) {
      const float w = w_s[x * KMAX + j];
      if (w != 0.f) v = fmaf(w, recv[x * per + i], v);
    }
    p.out[(static_cast<size_t>(b) * k1 + j) * p.d + head * hd + e - j * hd] =
        v / fmaxf(a_s[j], 1e-30f);
  }
}

// -- launches ---------------------------------------------------------------

struct Args {
  const void* q;
  const void* pool_k;
  const void* pool_v;
  const float* scale_k;
  const float* scale_v;
  const int* tables;
  const int* qpos;
  float* out;
  int q_dtype, batch, k1, d, heads, bs, nt, cluster, tile;
  float scale;
  cudaStream_t stream;
};

template <typename QT, typename PT, bool QUANT>
int launch_column(const Args& a) {
  const int hd = a.d / a.heads;
  const int threads = (hd + 31) / 32 * 32;
  const size_t smem =
      (static_cast<size_t>(threads / 32 + 1) * a.k1 * a.bs + a.k1) *
      sizeof(float);
  const dim3 grid(a.batch, a.heads);
  const QT* q = static_cast<const QT*>(a.q);
  const PT* pk = static_cast<const PT*>(a.pool_k);
  const PT* pv = static_cast<const PT*>(a.pool_v);
  if (a.k1 == 1) {
    paged_column_kernel<QT, PT, QUANT, 1><<<grid, threads, smem, a.stream>>>(
        q, pk, pv, a.scale_k, a.scale_v, a.tables, a.qpos, a.out, a.k1, a.d,
        hd, a.bs, a.nt, a.scale);
  } else {
    paged_column_kernel<QT, PT, QUANT, 16><<<grid, threads, smem, a.stream>>>(
        q, pk, pv, a.scale_k, a.scale_v, a.tables, a.qpos, a.out, a.k1, a.d,
        hd, a.bs, a.nt, a.scale);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename PT, bool QUANT, int KMAX>
int launch_split(const Args& a) {
  const int hd = a.d / a.heads;
  const int elem = static_cast<int>(sizeof(PT));
  if (hd * elem % 16 || a.cluster < 1 || a.cluster > kMaxCluster
      || a.tile < 1 || a.k1 > KMAX
      || reinterpret_cast<uintptr_t>(a.pool_k) % 16
      || reinterpret_cast<uintptr_t>(a.pool_v) % 16)
    return kRefused;
  const size_t smem =
      split_smem(KMAX, a.k1, hd, elem, a.tile, a.nt, QUANT);
  if (smem > kSmemMax) return kRefused;
  auto kernel = paged_split_kernel<PT, QUANT, KMAX>;
  // the shared-memory opt-in, once per kernel and device, not per call
  // (the attribute belongs to the device current at the launch)
  static std::atomic<bool> opted_in[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= kMaxDevices || !opted_in[dev].load(std::memory_order_acquire)) {
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev < kMaxDevices) opted_in[dev].store(true, std::memory_order_release);
  }
  const SplitParams p{a.q, a.pool_k, a.pool_v, a.scale_k, a.scale_v,
                      a.tables, a.qpos, a.out, a.k1, a.d, hd, a.bs, a.nt,
                      a.tile, a.q_dtype == veles::kBF16, a.scale};
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.cluster, a.heads, a.batch);
  cfg.blockDim = dim3(split_threads(hd));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = a.stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, p);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

template <typename PT, bool QUANT>
int by_variant(int variant, const Args& a) {
  if (variant == 1)
    return a.k1 == 1 ? launch_split<PT, QUANT, 1>(a)
                     : launch_split<PT, QUANT, 16>(a);
  switch (a.q_dtype) {
    case veles::kF32: return launch_column<float, PT, QUANT>(a);
    case veles::kBF16: return launch_column<__nv_bfloat16, PT, QUANT>(a);
  }
  return -1;
}

}  // namespace

// q [B, K1, d] (f32 or bf16); pools [NB, bs, d]; scales [NB, bs] f32
// (int8 pools only, else null); tables [B, T] and qpos [B, K1] int32;
// out [B, K1, d] f32.  All contiguous.  K1 <= 16, d / heads <= 1024.
// variant 0: the column kernel; 1: the split kernel over a cluster of
// `cluster` CTAs staging `tile` key rows at a time (ops/paged_attend.py
// ::plan).  Returns the launch's error, else cudaGetLastError() (-1: an
// unknown dtype or variant, -2: a split launch the kernel cannot take).
extern "C" int veles_paged_attend(
    const void* q, int q_dtype, const void* pool_k, const void* pool_v,
    int pool_dtype, const void* scale_k, const void* scale_v,
    const void* tables, const void* qpos, void* out, int batch, int k1, int d,
    int heads, int bs, int nt, float scale, int variant, int cluster,
    int tile, void* stream) {
  const Args a{q, pool_k, pool_v, static_cast<const float*>(scale_k),
               static_cast<const float*>(scale_v),
               static_cast<const int*>(tables), static_cast<const int*>(qpos),
               static_cast<float*>(out), q_dtype, batch, k1, d, heads, bs, nt,
               cluster, tile, scale, static_cast<cudaStream_t>(stream)};
  if ((q_dtype != veles::kF32 && q_dtype != veles::kBF16)
      || (variant != 0 && variant != 1))
    return -1;
  switch (pool_dtype) {
    case veles::kF32: return by_variant<float, false>(variant, a);
    case veles::kBF16: return by_variant<__nv_bfloat16, false>(variant, a);
    case veles::kI8: return by_variant<int8_t, true>(variant, a);
  }
  return -1;
}
