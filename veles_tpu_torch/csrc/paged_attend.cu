// Block-table (paged) decode attention over an fp32, bf16 or int8 KV
// pool, with the int8 dequant fused into the loads.
//
// Replaces: veles_tpu/ops/pallas_paged.py::pallas_paged_attend (the
// Pallas body _attend_kernel).  Same function: for each row b and query
// j at position qpos[b, j], walk the physical blocks tables[b, t] of the
// pool, dequantize int8 rows by their per-row scales, mask
// t*bs + col <= qpos[b, j] with the finite -1e30, fold each block into an
// online softmax, and write the f32 context [B, K1, d].
//
// What bounds it on the card: bytes.  A decode step does ~4 flops per
// K/V byte it reads, far below the H100's ~295 flop/byte ridge, so the
// time floor is the K/V blocks of the table (int8: d bytes per row per
// tensor, plus a 4-byte scale) over HBM bandwidth.  What the design does
// about it: it reads only the table's blocks, straight from the pool,
// and only up to the deepest query's block — the [B, T*bs, d] gather
// (dequantized) that the plain version materializes never exists, so an
// int8 pool costs int8 traffic.  Each thread owns one feature column of
// one head, so every K and V element is loaded exactly once, by the
// thread that uses it, as a coalesced row segment across the warp.
//
// Unlike the TPU kernel, which loops over heads inside one program per
// row (its grid runs in order on one core), this launches one CTA per
// (row, head): Hopper needs parallel CTAs.  At B = 8, h = 8 that is 64
// CTAs for 132 SMs; splitting T across CTAs (split-K decode, with a
// second pass merging the partial softmaxes) is the later fix.
//
// Per block: q·k partial products reduce within each warp by shuffles
// and across warps through shared memory (K1*bs scores), then every
// thread updates the running max m, sum l and its column's accumulator
// in registers.
#include "common.cuh"

namespace {

using veles::to_f;
using veles::warp_sum;

constexpr float kNegInf = -1e30f;

template <typename QT, typename PT, bool QUANT, int KMAX>
__global__ void paged_attend_kernel(
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
  int maxq = qp[0];
  for (int j = 1; j < k1; ++j) maxq = max(maxq, qp[j]);
  // a block whose first column lies past every query adds exactly
  // nothing (its probabilities are exp(-1e30 - m) = 0 and alpha = 1),
  // so the walk stops at the deepest query's block
  const int live = maxq < 0 ? 1 : min(nt, maxq / bs + 1);

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

struct Args {
  const void* q;
  const void* pool_k;
  const void* pool_v;
  const float* scale_k;
  const float* scale_v;
  const int* tables;
  const int* qpos;
  float* out;
  int batch, k1, d, heads, bs, nt;
  float scale;
  cudaStream_t stream;
};

template <typename QT, typename PT, bool QUANT>
int launch(const Args& a) {
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
    paged_attend_kernel<QT, PT, QUANT, 1><<<grid, threads, smem, a.stream>>>(
        q, pk, pv, a.scale_k, a.scale_v, a.tables, a.qpos, a.out, a.k1, a.d,
        hd, a.bs, a.nt, a.scale);
  } else {
    paged_attend_kernel<QT, PT, QUANT, 16><<<grid, threads, smem, a.stream>>>(
        q, pk, pv, a.scale_k, a.scale_v, a.tables, a.qpos, a.out, a.k1, a.d,
        hd, a.bs, a.nt, a.scale);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename QT>
int by_pool(int pool_dtype, const Args& a) {
  switch (pool_dtype) {
    case veles::kF32: return launch<QT, float, false>(a);
    case veles::kBF16: return launch<QT, __nv_bfloat16, false>(a);
    case veles::kI8: return launch<QT, int8_t, true>(a);
  }
  return -1;
}

}  // namespace

// q [B, K1, d] (f32 or bf16); pools [NB, bs, d]; scales [NB, bs] f32
// (int8 pools only, else null); tables [B, T] and qpos [B, K1] int32;
// out [B, K1, d] f32.  All contiguous.  K1 <= 16, d / heads <= 1024.
// Returns cudaGetLastError() after the launch (-1: unknown dtype).
extern "C" int veles_paged_attend(
    const void* q, int q_dtype, const void* pool_k, const void* pool_v,
    int pool_dtype, const void* scale_k, const void* scale_v,
    const void* tables, const void* qpos, void* out, int batch, int k1, int d,
    int heads, int bs, int nt, float scale, void* stream) {
  const Args a{q, pool_k, pool_v, static_cast<const float*>(scale_k),
               static_cast<const float*>(scale_v),
               static_cast<const int*>(tables), static_cast<const int*>(qpos),
               static_cast<float*>(out), batch, k1, d, heads, bs, nt, scale,
               static_cast<cudaStream_t>(stream)};
  switch (q_dtype) {
    case veles::kF32: return by_pool<float>(pool_dtype, a);
    case veles::kBF16: return by_pool<__nv_bfloat16>(pool_dtype, a);
  }
  return -1;
}
