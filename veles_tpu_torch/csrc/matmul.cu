// Tiled GEMM with a fused store epilogue:
//   out[m, n] = relu?((sum_k a[m, k] * b[k, n]) * scale?[n])
// summed in f32 and stored as f32 or bf16 (rounded to nearest even).
//
// Replaces: veles_tpu/ops/gemm.py::pallas_matmul (Pallas body _mm_kernel,
// gemm.py:44; _pallas_matmul_body gemm.py:80; pallas_call gemm.py:115)
// in its general form: a f32 or bf16, b of a's type or int8 (widened to
// a's type, gemm.py:62-63; exact for |v| <= 127), an f32 accumulator over
// the k blocks, the optional per-column scale and then the epilogue
// applied before the store (gemm.py:73-77).  f32 operands run at
// Precision.HIGHEST there, i.e. exact f32 products; bf16 ones at the
// default, i.e. exact bf16 products summed in f32.  Every variant here
// computes the same products (f32 by fused multiply-adds on the CUDA
// cores, never TF32; bf16 on the tensor cores with f32 sums), and only
// the order of the sum differs.  Each output element is summed in a fixed
// order (no atomics; split-K partials merged in rank order), so two runs
// are bit-equal.  The Pallas block sizes only tile the problem there;
// here plan() picks the variant and its tiles from the types, the shape
// and the alignment alone.
//
// Variants, in the order plan() tries them (times: CUDA-graph replays of
// 20 back-to-back launches on an H100 80GB HBM3 at 700 W, chip_smoke.py):
//
// - wgmma (bf16 a and b, k and n multiples of 8, both bases 16-byte
//   aligned: TMA's rules; m past kSplitMaxM, n at least kWgmmaMinN).
//   Bound by operations at large m and n (4096^3: 0.139 ms at 989
//   TFLOP/s), and only wgmma reaches the tensor cores' full rate.  A CTA
//   owns a [128 x BN] output tile: one producer thread issues TMA loads
//   (128-byte swizzle) of a [128 x 64] tile of a and a [64 x BN] tile of b
//   into a ring of stages (192 KB), each with a full and an empty
//   mbarrier; two consumer warpgroups each run wgmma.m64nBNk16 on their 64
//   rows from shared memory with the sums in registers (setmaxnreg moves
//   registers from the producer's warpgroup to them), leaving one k-tile's
//   wgmma group in flight while the stage before it is released.  b is
//   [k, n] with n contiguous, the MN-major B operand: the transpose
//   immediate, and a descriptor whose leading byte offset steps between
//   64-column swizzle atoms (one TMA box each) and whose stride byte
//   offset steps between 8-row k groups.  TMA's zero fill covers the
//   ragged m, n and k edges of the loads; the epilogue (scale, ReLU, the
//   cast) runs on the accumulator registers and masks its stores per
//   column pair and row.  BN 256 where its tiles fill the SMs (4096^3:
//   0.219 ms, against 0.251 ms at BN 128), else 64 where its CTAs fit one
//   wave (m <= 128 at n 4096: 64 CTAs), else 128.  Where the output
//   tiles outnumber the SMs, persistent CTAs (one per SM) walk them with
//   the ring running on, so the producer loads a CTA's next tile while
//   its consumers store this one.  The tensor maps are encoded on the
//   host for each call (cuTensorMapEncodeTiled, fetched at run time, so
//   nothing links libcuda) and passed by value as __grid_constant__
//   parameters, so a CUDA graph keeps them.
// - split_k (bf16 a and b under the same rules, m up to kSplitMaxM or n
//   under kWgmmaMinN).  Bound by the bytes of b at small m (8 x 1024 x
//   4096: 8 MB, 2.5 us at 3.35 TB/s), and in practice by the latency of a
//   short launch and its cluster merge.  int8_gemm.cu's design with bf16
//   weights, which need no widening: the operands are swapped, so a
//   16-column weight slab is the mma.sync A operand and 8 activation rows
//   fill the n8 side; each lane loads 4 k rows of 8 weight columns
//   (16-byte loads: 8-byte loads of 4 columns took 0.0059 against
//   0.0052 ms at 8 x 1024 x 4096, unlike int8 weights, where they won)
//   and the k slots of the mma are permuted so that the A fragments are
//   byte permutes of those words and the B fragment is one 8-byte load of
//   the activations; a CTA covers RT 8-row tiles and reuses each weight
//   fragment for all of them (at RT 2 the same loads, permutes and mma
//   count as an m16 form with the activations as A, so no such form is
//   built); k is split over a thread-block cluster of up to 8 CTAs (the
//   smallest that fills 7/8 of the SMs: at 8 x 1024 x 4096 clusters of
//   1 / 2 / 4 / 8 took 0.0079 / 0.0052 / 0.0076 / 0.0108 ms), each warp
//   with U = 8 k16 steps (512 weight bytes per lane; U 4: 0.0054 ms) in
//   flight before their first use, and the ranks' partials are merged in
//   rank order through distributed shared memory: the cluster plan,
//   merge and launch are common.cuh's, shared with int8_gemm.cu.  At k
//   1024, n 4096 wgmma's 64-column tile overtakes it past m 16.
// - simt_pipe (f32 a and b, n a multiple of 4, b 16-byte aligned).
//   Bound by the f32 FMA rate (2048^3: 0.256 ms at 67 TFLOP/s).  A ring
//   of 4 cp.async stages: a's tile stored transposed ([k][m], 4-byte
//   copies coalesced along k, +4 floats per k row) and b's as it lies
//   (16-byte copies); a thread's 8 x 16 register tile (4 x 4 for small m
//   or n) is blocks of 4 x 4 read as 16-byte shared loads from rows 32
//   and columns 16 apart, lanes laid 8 x 4, so a warp's loads touch 8 (a)
//   or 4 (b) distinct 16-byte words; the fragments of step kk + 1 are
//   loaded while step kk's FMAs run.  [128 x 256] tiles at k 8 per stage
//   (2048^3: 0.391 ms; k 16: 0.404; [128 x 128] at k 16, two CTAs per SM:
//   0.421).  The cp.async zero fill covers the ragged edges.
// - tc_big / tc_small / simt_big / simt_small (what the three refuse:
//   int8 b, which TMA cannot widen; k or n off 8 (4 for f32); bases off
//   16 bytes).  bf16 on mma.sync.m16n8k16 from shared tiles staged
//   through registers (rows padded by 16 bytes, ldmatrix, int8 widened
//   on the way), f32 on the CUDA cores with 8 x 8 (2 x 4) register tiles;
//   one k-tile in flight; vector loads where k and n are multiples of 8
//   (4) and the bases aligned (the ALIGNED template variant), element
//   loads otherwise.
#include <cuda.h>   // CUtensorMap and its enums (no libcuda link)

#include <algorithm>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBkTc = 32;    // k per tile of the tensor-core kernel
constexpr int kBkSimt = 8;   // k per tile of the f32 kernel

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

// ldmatrix address in a row-major tile with row stride ld: the A
// fragment of rows r0..r0+15, columns c0..c0+15 — and, with .trans, the
// B fragments of two 8-column blocks (c0, c0 + 8) of a B stored [k][n]
// at k rows r0..r0+15
__device__ __forceinline__ const bf16* frag_addr(const bf16* tile, int ld,
                                                 int r0, int c0, int lane) {
  return tile + (r0 + (lane & 15)) * ld + c0 + (lane >> 4) * 8;
}

// 8 consecutive elements of row `row` of a [rows, cols] matrix from
// column `col`, as 8 bf16 (zeros past the matrix).  ALIGNED: cols % 8 ==
// 0 and an aligned base, so a chunk lies wholly inside or outside
template <bool ALIGNED>
__device__ __forceinline__ uint4 chunk8(const bf16* __restrict__ p, int row,
                                        int col, int rows, int cols) {
  if constexpr (ALIGNED) {
    if (row >= rows || col >= cols) return make_uint4(0, 0, 0, 0);
    return __ldg(reinterpret_cast<const uint4*>(
        p + static_cast<size_t>(row) * cols + col));
  } else {
    uint16_t h[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      h[i] = row < rows && col + i < cols
          ? __bfloat16_as_ushort(p[static_cast<size_t>(row) * cols + col + i])
          : 0u;
    return make_uint4(h[0] | h[1] << 16, h[2] | h[3] << 16,
                      h[4] | h[5] << 16, h[6] | h[7] << 16);
  }
}

__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(lo))
         | static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(hi)))
               << 16;
}

// the int8 form: 8 bytes widened to bf16 (exact)
template <bool ALIGNED>
__device__ __forceinline__ uint4 chunk8(const int8_t* __restrict__ p,
                                        int row, int col, int rows,
                                        int cols) {
  float f[8];
  if constexpr (ALIGNED) {
    if (row >= rows || col >= cols) return make_uint4(0, 0, 0, 0);
    const uint2 w = __ldg(reinterpret_cast<const uint2*>(
        p + static_cast<size_t>(row) * cols + col));
    veles::widen4(w.x, *reinterpret_cast<float(*)[4]>(f));
    veles::widen4(w.y, *reinterpret_cast<float(*)[4]>(f + 4));
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      f[i] = row < rows && col + i < cols
          ? static_cast<float>(p[static_cast<size_t>(row) * cols + col + i])
          : 0.f;
  }
  return make_uint4(bf16_pair(f[0], f[1]), bf16_pair(f[2], f[3]),
                    bf16_pair(f[4], f[5]), bf16_pair(f[6], f[7]));
}

// the store: scale, then the epilogue, then the output type
__device__ __forceinline__ void store_out(void* out, bool out_bf16,
                                          const float* __restrict__ scale,
                                          bool relu, int r, int c, int m,
                                          int n, float v) {
  if (r >= m || c >= n) return;
  if (scale != nullptr) v *= __ldg(scale + c);
  if (relu) v = fmaxf(v, 0.f);
  const size_t i = static_cast<size_t>(r) * n + c;
  if (out_bf16)
    static_cast<bf16*>(out)[i] = __float2bfloat16_rn(v);
  else
    static_cast<float*>(out)[i] = v;
}

// -- bf16: tensor cores ------------------------------------------------------

template <int WM, int WN, int MT, int NT>
struct TcCfg {
  static constexpr int kThreads = 32 * WM * WN;
  static constexpr int BM = WM * MT * 16, BN = WN * NT * 8;
  static constexpr int LDA = kBkTc + 8, LDB = BN + 8;   // +16 bytes
  static constexpr int kAChunks = BM * kBkTc / 8, kBChunks = kBkTc * BN / 8;
  static constexpr int kAPer = (kAChunks + kThreads - 1) / kThreads;
  static constexpr int kBPer = (kBChunks + kThreads - 1) / kThreads;
  static_assert(NT % 2 == 0, "B fragments come in pairs of 8 columns");
};

template <int WM, int WN, int MT, int NT, typename TB, bool ALIGNED>
__global__ void __launch_bounds__(TcCfg<WM, WN, MT, NT>::kThreads)
mm_tc(const bf16* __restrict__ a, const TB* __restrict__ b,
      const float* __restrict__ scale, void* out, int out_bf16, int relu,
      int m, int k, int n) {
  using C = TcCfg<WM, WN, MT, NT>;
  __shared__ __align__(16) bf16 as[C::BM * C::LDA];
  __shared__ __align__(16) bf16 bs[kBkTc * C::LDB];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WN, wn = warp % WN;
  const int m0 = blockIdx.y * C::BM, n0 = blockIdx.x * C::BN;
  const int tiles = (k + kBkTc - 1) / kBkTc;

  uint4 ra[C::kAPer], rb[C::kBPer];
  auto load = [&](int kt) {
    const int k0 = kt * kBkTc;
#pragma unroll
    for (int i = 0; i < C::kAPer; ++i) {
      const int c = tid + i * C::kThreads;
      if (c < C::kAChunks)   // [BM][4] chunks of 8 along k
        ra[i] = chunk8<ALIGNED>(a, m0 + c / 4, k0 + (c % 4) * 8, m, k);
    }
#pragma unroll
    for (int i = 0; i < C::kBPer; ++i) {
      const int c = tid + i * C::kThreads;
      if (c < C::kBChunks)   // [32][BN / 8] chunks of 8 along n
        rb[i] = chunk8<ALIGNED>(b, k0 + c / (C::BN / 8),
                                n0 + (c % (C::BN / 8)) * 8, k, n);
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  load(0);
  for (int kt = 0; kt < tiles; ++kt) {
    __syncthreads();   // the last tile's fragments are read
#pragma unroll
    for (int i = 0; i < C::kAPer; ++i) {
      const int c = tid + i * C::kThreads;
      if (c < C::kAChunks)
        *reinterpret_cast<uint4*>(as + (c / 4) * C::LDA + (c % 4) * 8) = ra[i];
    }
#pragma unroll
    for (int i = 0; i < C::kBPer; ++i) {
      const int c = tid + i * C::kThreads;
      if (c < C::kBChunks)
        *reinterpret_cast<uint4*>(bs + (c / (C::BN / 8)) * C::LDB
                                  + (c % (C::BN / 8)) * 8) = rb[i];
    }
    __syncthreads();
    if (kt + 1 < tiles) load(kt + 1);
#pragma unroll
    for (int kk = 0; kk < kBkTc; kk += 16) {
      uint32_t af[MT][4], bfr[NT / 2][4];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        ldsm_x4(af[i], frag_addr(as, C::LDA, wm * MT * 16 + i * 16, kk, lane));
#pragma unroll
      for (int j = 0; j < NT / 2; ++j)
        ldsm_x4_t(bfr[j], frag_addr(bs, C::LDB, kk, wn * NT * 8 + j * 16,
                                    lane));
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
          mma16816(acc[i][j], af[i], bfr[j / 2][(j & 1) * 2],
                   bfr[j / 2][(j & 1) * 2 + 1]);
    }
  }

  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int r = m0 + wm * MT * 16 + i * 16 + g;
      const int c = n0 + wn * NT * 8 + j * 8 + 2 * t;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        store_out(out, out_bf16, scale, relu, r + (e >> 1) * 8, c + (e & 1),
                  m, n, acc[i][j][e]);
    }
}

// -- f32: CUDA cores ---------------------------------------------------------

template <int BM, int BN, int TM, int TN>
struct SimtCfg {
  static constexpr int kThreads = (BM / TM) * (BN / TN);
  static constexpr int LDA = BM + 4, LDB = BN + 4;
  static constexpr int kAChunks = BM * kBkSimt / 4;
  static constexpr int kBChunks = kBkSimt * BN / 4;
  static constexpr int kAPer = (kAChunks + kThreads - 1) / kThreads;
  static constexpr int kBPer = (kBChunks + kThreads - 1) / kThreads;
};

// 4 consecutive elements of row `row` from column `col` as floats (zeros
// past the matrix); ALIGNED: cols % 4 == 0 and an aligned base
template <bool ALIGNED>
__device__ __forceinline__ float4 chunk4(const float* __restrict__ p, int row,
                                         int col, int rows, int cols) {
  if constexpr (ALIGNED) {
    if (row >= rows || col >= cols) return make_float4(0.f, 0.f, 0.f, 0.f);
    return __ldg(reinterpret_cast<const float4*>(
        p + static_cast<size_t>(row) * cols + col));
  } else {
    float f[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      f[i] = row < rows && col + i < cols
          ? p[static_cast<size_t>(row) * cols + col + i] : 0.f;
    return make_float4(f[0], f[1], f[2], f[3]);
  }
}
template <bool ALIGNED>
__device__ __forceinline__ float4 chunk4(const int8_t* __restrict__ p,
                                         int row, int col, int rows,
                                         int cols) {
  float f[4];
  if constexpr (ALIGNED) {
    if (row >= rows || col >= cols) return make_float4(0.f, 0.f, 0.f, 0.f);
    veles::widen4(__ldg(reinterpret_cast<const uint32_t*>(
                      p + static_cast<size_t>(row) * cols + col)), f);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      f[i] = row < rows && col + i < cols
          ? static_cast<float>(p[static_cast<size_t>(row) * cols + col + i])
          : 0.f;
  }
  return make_float4(f[0], f[1], f[2], f[3]);
}

template <int BM, int BN, int TM, int TN, typename TB, bool ALIGNED>
__global__ void __launch_bounds__(SimtCfg<BM, BN, TM, TN>::kThreads)
mm_simt(const float* __restrict__ a, const TB* __restrict__ b,
        const float* __restrict__ scale, void* out, int out_bf16, int relu,
        int m, int k, int n) {
  using C = SimtCfg<BM, BN, TM, TN>;
  __shared__ __align__(16) float as[kBkSimt * C::LDA];   // [k][m]
  __shared__ __align__(16) float bs[kBkSimt * C::LDB];   // [k][n]
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN), ty = tid / (BN / TN);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tiles = (k + kBkSimt - 1) / kBkSimt;

  float4 ra[C::kAPer], rb[C::kBPer];
  auto load = [&](int kt) {
    const int k0 = kt * kBkSimt;
#pragma unroll
    for (int i = 0; i < C::kAPer; ++i) {
      const int c = tid + i * C::kThreads;
      if (c < C::kAChunks)   // [BM][2] chunks of 4 along k
        ra[i] = chunk4<ALIGNED>(a, m0 + c / 2, k0 + (c % 2) * 4, m, k);
    }
#pragma unroll
    for (int i = 0; i < C::kBPer; ++i) {
      const int c = tid + i * C::kThreads;
      if (c < C::kBChunks)   // [8][BN / 4] chunks of 4 along n
        rb[i] = chunk4<ALIGNED>(b, k0 + c / (BN / 4), n0 + (c % (BN / 4)) * 4,
                                k, n);
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  load(0);
  for (int kt = 0; kt < tiles; ++kt) {
    __syncthreads();
#pragma unroll
    for (int i = 0; i < C::kAPer; ++i) {
      const int c = tid + i * C::kThreads;
      if (c < C::kAChunks) {
        const int row = c / 2, kc = (c % 2) * 4;
        as[(kc + 0) * C::LDA + row] = ra[i].x;
        as[(kc + 1) * C::LDA + row] = ra[i].y;
        as[(kc + 2) * C::LDA + row] = ra[i].z;
        as[(kc + 3) * C::LDA + row] = ra[i].w;
      }
    }
#pragma unroll
    for (int i = 0; i < C::kBPer; ++i) {
      const int c = tid + i * C::kThreads;
      if (c < C::kBChunks)
        *reinterpret_cast<float4*>(bs + (c / (BN / 4)) * C::LDB
                                   + (c % (BN / 4)) * 4) = rb[i];
    }
    __syncthreads();
    if (kt + 1 < tiles) load(kt + 1);
#pragma unroll
    for (int kk = 0; kk < kBkSimt; ++kk) {
      float av[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = as[kk * C::LDA + ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = bs[kk * C::LDB + tx * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j)
      store_out(out, out_bf16, scale, relu, m0 + ty * TM + i,
                n0 + tx * TN + j, m, n, acc[i][j]);
}

// -- bf16, large m and n: TMA + wgmma ----------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}
// spin until the phase of parity `parity` has completed; a wait that
// never ends (a lost arrival or load) traps, failing the launch, instead
// of holding the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  for (uint32_t spins = 0; !done; ++spins) {
    if (spins == (1u << 26)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  }
}
// a 2-d TMA tile load of the box at (c0 innermost, c1) into dst
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// shared-memory matrix descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (each >> 4)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16
         | static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32
         | 1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// keeps the compiler from moving accumulator reads or writes across an
// asynchronous wgmma
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// d[64 x N] (+)= a[64 x 16] . b[16 x N]: a K-major, b MN-major (transposed),
// both from shared memory; acc 0 overwrites d.  Thread i of the
// warpgroup holds rows 16 (i / 32) + (i % 32) / 4 (+ 8) of d, columns
// 8 j + 2 (i % 4) (+ 1) in d[4 j ..  4 j + 3]
template <int N> struct Wgmma;
template <> struct Wgmma<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], uint64_t da,
                                             uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 1;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(acc));
  }
};

template <> struct Wgmma<128> {
  static __device__ __forceinline__ void mma(float (&d)[64], uint64_t da,
                                             uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 1;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(acc));
  }
};

template <> struct Wgmma<256> {
  static __device__ __forceinline__ void mma(float (&d)[128], uint64_t da,
                                             uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, "
        "%88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, "
        "%104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, "
        "%120, %121, %122, %123, %124, %125, %126, %127}, "
        "%128, %129, p, 1, 1, 0, 1;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
          "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
          "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
          "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
          "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
          "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
          "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
          "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
          "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
          "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
          "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "l"(da), "l"(db), "r"(acc));
  }
};

constexpr int kWgBM = 128;           // output rows per CTA: two warpgroups
constexpr int kWgBK = 64;            // k per stage: one 128-byte swizzle row
constexpr int kWgThreads = 384;      // 2 consumer warpgroups + 1 producer

template <int BN, int STAGES>
struct WgCfg {
  static constexpr int kABytes = kWgBM * kWgBK * 2;       // 16 KB
  static constexpr int kBBox = kWgBK * 64 * 2;            // 8 KB: 64 columns
  static constexpr int kBBytes = kBBox * (BN / 64);
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kSmem = STAGES * kStageBytes + 1024;  // + alignment
  static_assert(BN % 64 == 0 && BN <= 256, "BN: 64-column boxes, <= 256");
};

// A CTA: output tile blockIdx.x of the [128 x BN] tiles (n fastest) over
// all of k, and with PERSIST tiles blockIdx.x + gridDim.x, ... after it.
// Warpgroups 0 and 1 consume (rows 64 w ..), warpgroup 2's first thread
// produces; the ring's stages and phases run on across tiles, so the
// producer loads the next tile while the consumers store this one.
// Without PERSIST the tile loops end after one pass, so no loop is
// compiled (one was slower at one tile per CTA).
template <int BN, int STAGES, bool PERSIST>
__global__ void __launch_bounds__(kWgThreads, 1)
mm_wgmma(__grid_constant__ const CUtensorMap map_a,
         __grid_constant__ const CUtensorMap map_b,
         const float* __restrict__ scale, void* out, int out_bf16, int relu,
         int m, int k, int n) {
  using C = WgCfg<BN, STAGES>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  // 128-byte swizzle atoms are 1024 bytes: stage bases on 1024
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const int wg = threadIdx.x / 128;
  const int tiles_n = (n + BN - 1) / BN;
  const int tiles = tiles_n * ((m + kWgBM - 1) / kWgBM);
  const int ktiles = (k + kWgBK - 1) / kWgBK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);      // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // producer: registers to the consumers, one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 256) {
      int s = 0, phase = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = t / tiles_n * kWgBM, n0 = t % tiles_n * BN;
        for (int kt = 0; kt < ktiles; ++kt) {
          mbar_wait(&empty[s], phase ^ 1);     // the first round passes
          mbar_expect_tx(&full[s], C::kStageBytes);
          const uint32_t sa = base + s * C::kStageBytes;
          tma_load(sa, &map_a, &full[s], kt * kWgBK, m0);
#pragma unroll
          for (int j = 0; j < BN / 64; ++j)
            tma_load(sa + C::kABytes + j * C::kBBox, &map_b, &full[s],
                     n0 + 64 * j, kt * kWgBK);
          if (++s == STAGES) { s = 0; phase ^= 1; }
        }
        if constexpr (!PERSIST) break;
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int lane = threadIdx.x % 32, warp = (threadIdx.x / 32) % 4;
    float acc[BN / 2];
    int s = 0, phase = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int m0 = t / tiles_n * kWgBM, n0 = t % tiles_n * BN;
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
      int prev = 0;
      for (int kt = 0; kt < ktiles; ++kt) {
        mbar_wait(&full[s], phase);
        const uint32_t sa = base + s * C::kStageBytes + wg * 64 * 128;
        const uint32_t sb = base + s * C::kStageBytes + C::kABytes;
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kWgBK / 16; ++kk)
          // a: k16 is 32 bytes along the swizzled row, 8-row groups 1024
          // bytes apart; b: k16 is 16 rows of 128 bytes, 64-column boxes
          // kBBox apart, 8-row groups 1024 bytes apart
          Wgmma<BN>::mma(acc, sw128_desc(sa + 32 * kk, 16, 1024),
                         sw128_desc(sb + 2048 * kk, C::kBBox, 1024), 1);
        wgmma_commit();
        fence_regs(acc);
        // the previous k-tile's group is done: release its stage
        wgmma_wait<1>();
        fence_regs(acc);
        if (kt > 0 && lane == 0) mbar_arrive(&empty[prev]);
        prev = s;
        if (++s == STAGES) { s = 0; phase ^= 1; }
      }
      wgmma_wait<0>();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(&empty[prev]);

      // epilogue from the registers: scale, ReLU, the cast; n % 8 == 0,
      // so a thread's column pair lies wholly inside or outside
      const int r0 = m0 + 64 * wg + 16 * warp + lane / 4;
      const int cb = n0 + 2 * (lane % 4);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int c = cb + 8 * j;
        if (c >= n) continue;
        const float s0 = scale != nullptr ? __ldg(scale + c) : 1.f;
        const float s1 = scale != nullptr ? __ldg(scale + c + 1) : 1.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = r0 + 8 * h;
          if (r >= m) continue;
          // (x * 1 is x: no branch for the unscaled form)
          float v0 = acc[4 * j + 2 * h] * s0;
          float v1 = acc[4 * j + 2 * h + 1] * s1;
          if (relu) {
            v0 = fmaxf(v0, 0.f);
            v1 = fmaxf(v1, 0.f);
          }
          const size_t i = static_cast<size_t>(r) * n + c;
          if (out_bf16)
            *reinterpret_cast<uint32_t*>(static_cast<bf16*>(out) + i) =
                bf16_pair(v0, v1);
          else
            *reinterpret_cast<float2*>(static_cast<float*>(out) + i) =
                make_float2(v0, v1);
        }
      }
      if constexpr (!PERSIST) break;
    }
  }
}

// -- bf16, small m: split-K over a cluster -----------------------------------

constexpr int kSkWarps = 4;
constexpr int kSkThreads = 32 * kSkWarps;
constexpr int kSkCols = 64;          // output columns per CTA: 8 per lane

// RT 8-row activation tiles per CTA; U k16 steps loaded ahead per warp
// (8: 512 weight bytes per lane; 4 at RT 4, whose accumulators and
// activations take more registers)
template <int RT>
struct SkCfg {
  static constexpr int kRows = 8 * RT;
  static constexpr int kTile = kRows * kSkCols;
  static constexpr int U = RT == 4 ? 4 : 8;
};

// what a lane loads for one k16 step: k rows 4t .. 4t + 3 of its 8
// weight columns, and a[8 rt + g][4t .. 4t + 3] for each row tile (the
// mma's B fragment)
template <int RT>
struct SkStep {
  uint32_t w[4][4];
  uint32_t x[RT][2];
};

template <int RT>
__device__ __forceinline__ void sk_load(SkStep<RT>& st,
                                        const bf16* __restrict__ a,
                                        const bf16* __restrict__ w, int step,
                                        int end, int g, int t, int col,
                                        int m0, int m, int k, int n) {
  // k % 8 == 0 and n % 8 == 0: a 4-element chunk of a row and an
  // 8-column chunk of w lie wholly inside or outside; steps past `end`
  // load zeros
  const int k0 = step < end ? step * 16 + 4 * t : k;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const bf16* p = w + static_cast<size_t>(k0 + r) * n + col;
    const uint4 v = k0 + r < k && col < n
        ? __ldg(reinterpret_cast<const uint4*>(p)) : make_uint4(0, 0, 0, 0);
    st.w[r][0] = v.x; st.w[r][1] = v.y; st.w[r][2] = v.z; st.w[r][3] = v.w;
  }
#pragma unroll
  for (int rt = 0; rt < RT; ++rt) {
    const int row = m0 + 8 * rt + g;
    const uint2 v = row < m && k0 < k
        ? __ldg(reinterpret_cast<const uint2*>(
              a + static_cast<size_t>(row) * k + k0))
        : make_uint2(0, 0);
    st.x[rt][0] = v.x; st.x[rt][1] = v.y;
  }
}

// One CTA: kRows x kSkCols outputs over its rank's share of the k16
// steps; the cluster (grid x) spans k.  Lane (g, t) = (lane / 4, lane %
// 4).  Mma q of a row tile covers columns 8 g + 2q (A row g) and 8 g +
// 2q + 1 (A row g + 8): its k slots (2t, 2t + 1, 2t + 8, 2t + 9) stand
// for k rows (4t, 4t + 1, 4t + 2, 4t + 3) in both operands.
template <int RT>
__global__ void __launch_bounds__(kSkThreads)
mm_splitk(const bf16* __restrict__ a, const bf16* __restrict__ w,
          const float* __restrict__ scale, void* out, int out_bf16, int relu,
          int m, int k, int n, int steps_per_rank) {
  using C = SkCfg<RT>;
  __shared__ float red[kSkWarps][C::kTile];   // the warps' partials
  __shared__ float recv[C::kTile];            // the ranks' partials of
                                              // this rank's slice
  veles::cluster_arrive();
  const int rank =
      static_cast<int>(cooperative_groups::this_cluster().block_rank());
  const int csize = static_cast<int>(gridDim.x);   // the cluster spans x
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  const int c0 = blockIdx.y * kSkCols;
  const int col = c0 + 8 * g;
  const int m0 = blockIdx.z * C::kRows;
  const int n_steps = (k + 15) / 16;
  const int sb = min(rank * steps_per_rank, n_steps);
  const int se = min(sb + steps_per_rank, n_steps);

  float acc[RT][4][4];
#pragma unroll
  for (int rt = 0; rt < RT; ++rt)
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[rt][q][e] = 0.f;

  SkStep<RT> buf[C::U];
  int s = sb + warp;
#pragma unroll
  for (int u = 0; u < C::U; ++u)
    sk_load(buf[u], a, w, s + u * kSkWarps, se, g, t, col, m0, m, k, n);
  for (; s < se; s += kSkWarps * C::U) {
#pragma unroll
    for (int u = 0; u < C::U; ++u) {
      if (s + u * kSkWarps >= se) break;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint32_t w0 = buf[u].w[0][q], w1 = buf[u].w[1][q];
        const uint32_t w2 = buf[u].w[2][q], w3 = buf[u].w[3][q];
        // rows 4t, 4t + 1 (then 4t + 2, 4t + 3) of column 8 g + 2q
        // (A row g) and of the next column (A row g + 8)
        const uint32_t af[4] = {__byte_perm(w0, w1, 0x5410),
                                __byte_perm(w0, w1, 0x7632),
                                __byte_perm(w2, w3, 0x5410),
                                __byte_perm(w2, w3, 0x7632)};
#pragma unroll
        for (int rt = 0; rt < RT; ++rt)
          mma16816(acc[rt][q], af, buf[u].x[rt][0], buf[u].x[rt][1]);
      }
    }
    if (s + kSkWarps * C::U < se) {
#pragma unroll
      for (int u = 0; u < C::U; ++u)
        sk_load(buf[u], a, w, s + (C::U + u) * kSkWarps, se, g, t, col, m0,
                m, k, n);
    }
  }

  // this warp's partial tile -> red[warp][row * kSkCols + column]
  float* mine = red[warp];
#pragma unroll
  for (int rt = 0; rt < RT; ++rt)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int cc = 8 * g + 2 * q, row = 8 * rt + 2 * t;
      mine[row * kSkCols + cc] = acc[rt][q][0];
      mine[(row + 1) * kSkCols + cc] = acc[rt][q][1];
      mine[row * kSkCols + cc + 1] = acc[rt][q][2];
      mine[(row + 1) * kSkCols + cc + 1] = acc[rt][q][3];
    }
  // the ranks' partials of this rank's slice in rank order, then the
  // store
  veles::cluster_merge<kSkThreads>(
      red, recv, rank, csize, [&](int e, float v) {
        store_out(out, out_bf16, scale, relu, m0 + e / kSkCols,
                  c0 + e % kSkCols, m, n, v);
      });
}

// -- f32: a cp.async ring on the CUDA cores ----------------------------------


__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(in ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(in ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// WM x WN warps; each lane a (4 SM) x (4 SN) register tile of SM x SN
// blocks of 4 x 4, lanes laid 8 (m) x 4 (n), blocks 32 rows and 16
// columns apart: a warp covers 32 SM rows x 16 SN columns.  MINB CTAs
// per SM (the register cap)
template <int WM, int WN, int SM, int SN, int MINB, int BK_, int STAGES>
struct PipeCfg {
  static constexpr int kPipeBK = BK_, kPipeStages = STAGES;
  static constexpr int kThreads = 32 * WM * WN;
  static constexpr int BM = WM * 32 * SM, BN = WN * 16 * SN;
  static constexpr int TM = 4 * SM, TN = 4 * SN;
  // a stored [k][m]: +4 floats per k row keeps rows 16-byte aligned and
  // spreads a warp's 4-byte copies (16 k rows of one m) over the banks
  static constexpr int LDA = BM + 4;
  static constexpr int kAStage = kPipeBK * LDA, kBStage = kPipeBK * BN;
  static constexpr int kSmem = kPipeStages * (kAStage + kBStage) * 4;
  static constexpr int kAPer = BM * kPipeBK / kThreads;      // 4-byte copies
  static constexpr int kBPer = kPipeBK * BN / 4 / kThreads;  // 16-byte
  static_assert(kAPer * kThreads == BM * kPipeBK
                && kBPer * kThreads * 4 == kPipeBK * BN, "copy split");
};

template <int WM, int WN, int SM, int SN, int MINB, int BK, int STAGES>
__global__ void __launch_bounds__(32 * WM * WN, MINB)
mm_simt_pipe(const float* __restrict__ a, const float* __restrict__ b,
             const float* __restrict__ scale, void* out, int out_bf16,
             int relu, int m, int k, int n) {
  using C = PipeCfg<WM, WN, SM, SN, MINB, BK, STAGES>;
  constexpr int kPipeBK = BK, kPipeStages = STAGES;
  constexpr int TM = C::TM, TN = C::TN;
  extern __shared__ __align__(16) float pipe_smem[];
  float* as_all = pipe_smem;                              // [stage][k][m]
  float* bs_all = pipe_smem + kPipeStages * C::kAStage;   // [stage][k][n]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int lm = lane >> 2, ln = lane & 3;
  const int wm = warp / WN, wn = warp % WN;
  const int m0 = blockIdx.y * C::BM, n0 = blockIdx.x * C::BN;
  const int tiles = (k + kPipeBK - 1) / kPipeBK;

  // stage kt's copies: a element by element along k (coalesced), b in
  // 16-byte chunks along n; zero fill past the matrix
  auto issue = [&](int kt) {
    const int k0 = kt * kPipeBK;
    float* as = as_all + (kt % kPipeStages) * C::kAStage;
    float* bs = bs_all + (kt % kPipeStages) * C::kBStage;
#pragma unroll
    for (int i = 0; i < C::kAPer; ++i) {
      const int e = tid + i * C::kThreads;
      const int kk = e % kPipeBK, row = e / kPipeBK;
      const bool in = m0 + row < m && k0 + kk < k;
      cp_async4(smem_u32(as + kk * C::LDA + row),
                in ? a + static_cast<size_t>(m0 + row) * k + k0 + kk : a, in);
    }
#pragma unroll
    for (int i = 0; i < C::kBPer; ++i) {
      const int e = tid + i * C::kThreads;
      const int kk = e / (C::BN / 4), c = (e % (C::BN / 4)) * 4;
      const bool in = k0 + kk < k && n0 + c < n;
      cp_async16(smem_u32(bs + kk * C::BN + c),
                 in ? b + static_cast<size_t>(k0 + kk) * n + n0 + c : b, in);
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < kPipeStages - 1; ++s) {
    if (s < tiles) issue(s);
    cp_async_commit();
  }
  const int ao = wm * 32 * SM + lm * 4, bo = wn * 16 * SN + ln * 4;
  for (int kt = 0; kt < tiles; ++kt) {
    cp_async_wait<kPipeStages - 2>();   // this thread's copies of stage kt
    __syncthreads();                     // everyone's, and stage kt - 1 read
    if (kt + kPipeStages - 1 < tiles) issue(kt + kPipeStages - 1);
    cp_async_commit();
    const float* as = as_all + (kt % kPipeStages) * C::kAStage + ao;
    const float* bs = bs_all + (kt % kPipeStages) * C::kBStage + bo;
    float fa[2][TM], fb[2][TN];
    auto frags = [&](int buf, int kk) {
#pragma unroll
      for (int s = 0; s < SM; ++s) {
        const float4 x = *reinterpret_cast<const float4*>(
            as + kk * C::LDA + 32 * s);
        fa[buf][4 * s] = x.x; fa[buf][4 * s + 1] = x.y;
        fa[buf][4 * s + 2] = x.z; fa[buf][4 * s + 3] = x.w;
      }
#pragma unroll
      for (int s = 0; s < SN; ++s) {
        const float4 y = *reinterpret_cast<const float4*>(
            bs + kk * C::BN + 16 * s);
        fb[buf][4 * s] = y.x; fb[buf][4 * s + 1] = y.y;
        fb[buf][4 * s + 2] = y.z; fb[buf][4 * s + 3] = y.w;
      }
    };
    frags(0, 0);
#pragma unroll
    for (int kk = 0; kk < kPipeBK; ++kk) {
      if (kk + 1 < kPipeBK) frags((kk + 1) & 1, kk + 1);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          acc[i][j] = fmaf(fa[kk & 1][i], fb[kk & 1][j], acc[i][j]);
    }
  }
  cp_async_wait<0>();

  // row block s, column block t: 4 consecutive columns per store (n % 4
  // == 0: wholly inside or outside)
#pragma unroll
  for (int s = 0; s < SM; ++s)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = m0 + ao + 32 * s + i;
      if (r >= m) continue;
#pragma unroll
      for (int t = 0; t < SN; ++t) {
        const int c = n0 + bo + 16 * t;
        if (c >= n) continue;
        float v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          v[j] = acc[4 * s + i][4 * t + j]
                 * (scale != nullptr ? __ldg(scale + c + j) : 1.f);
          if (relu) v[j] = fmaxf(v[j], 0.f);
        }
        const size_t o = static_cast<size_t>(r) * n + c;
        if (out_bf16)
          *reinterpret_cast<uint2*>(static_cast<bf16*>(out) + o) =
              make_uint2(bf16_pair(v[0], v[1]), bf16_pair(v[2], v[3]));
        else
          *reinterpret_cast<float4*>(static_cast<float*>(out) + o) =
              make_float4(v[0], v[1], v[2], v[3]);
      }
    }
}

// -- plan and launch ---------------------------------------------------------

// the register-staged variants: tensor cores, [128 x 128] tiles of 8
// warps (2 x 8 mma tiles each) or [32 x 32] tiles of 4 warps (1 x 2) for
// small m or n; f32, [128 x 128] tiles of 256 threads (8 x 8 each) or
// [32 x 64] (2 x 4)
using TcBig = TcCfg<4, 2, 2, 8>;
using TcSmall = TcCfg<2, 2, 1, 2>;
using SimtBig = SimtCfg<128, 128, 8, 8>;
using SimtSmall = SimtCfg<32, 64, 2, 4>;
// the f32 ring: [128 x 256] tiles of 256 threads (8 x 16 each, k 8 per
// stage, 4 stages), [32 x 64] of 128 threads (4 x 4, k 16) for small m or
// n
using PipeWide = PipeCfg<2, 4, 2, 4, 1, 8, 4>;
using PipeSmall = PipeCfg<1, 4, 1, 1, 2, 16, 4>;

// ops/gemm.py::matmul_plan names these in this order
enum Variant : int {
  kTcBig = 0,
  kTcSmall = 1,
  kSimtBig = 2,
  kSimtSmall = 3,
  kWgmma = 4,
  kSplitK = 5,
  kSimtPipe = 6
};

// bf16 (TMA-able) at m up to kSplitMaxM, or n under kWgmmaMinN, runs
// split_k, the rest wgmma (the crossover measured at k 1024, n 4096:
// split_k 0.0061 against wgmma's 0.0074 ms at m 16, 0.0087 against 0.0071
// at m 24)
constexpr int kSplitMaxM = 16;
constexpr int kWgmmaMinN = 64;

// C-entry errors besides cudaError_t: unsupported types, a forced
// variant these operands cannot take, no tensor-map encoder in libcuda,
// a tensor map libcuda refused
constexpr int kErrTypes = -1, kErrForced = -3, kErrNoEncoder = -4,
              kErrEncode = -5;

struct Plan {
  int variant, bm, bn, bk, threads, aligned;
  int stages;       // k-tiles (split_k: k16 steps per warp) in flight
  int cluster;      // split_k: CTAs along k
  int k_per_rank;   // split_k: k rows per cluster rank
  int ctas;         // CTAs launched (with_ctas)
};

Plan simple(int variant, int bm, int bn, int bk, int threads, int aligned,
            int stages) {
  return Plan{variant, bm, bn, bk, threads, aligned, stages, 1, 0, 0};
}

bool aligned_to(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// the widest tile whose CTAs fill the SMs; else the 64-column tile where
// its CTAs still fit one wave, else 128 (at m <= 128 and n 4096, 32 CTAs
// of 128 columns leave 100 SMs idle: 0.0081 against 0.0064 ms at m 72)
int wgmma_bn(int m, int n) {
  const int rows = (m + kWgBM - 1) / kWgBM;
  if (rows * ((n + 255) / 256) >= veles::sm_count()) return 256;
  return rows * ((n + 63) / 64) <= veles::sm_count() ? 64 : 128;
}

// stages by tile width: 192 KB of ring in each case
Plan wgmma_plan(int bn) {
  return simple(kWgmma, kWgBM, bn, kWgBK, kWgThreads, 1,
                bn == 256 ? 4 : bn == 128 ? 6 : 8);
}

// 8-row tiles by m (1, 2, 4), the smallest cluster that fills a wave
// (veles::split_cluster)
Plan split_plan(int m, int k, int n) {
  const int rows = m <= 8 ? 8 : m <= 16 ? 16 : 32;
  const int tiles =
      (n + kSkCols - 1) / kSkCols * ((m + rows - 1) / rows);
  const int steps = (k + 15) / 16;
  const int cs = veles::split_cluster(tiles, steps);
  return Plan{kSplitK, rows, kSkCols, 16, kSkThreads, 1,
              rows == 32 ? SkCfg<4>::U : SkCfg<1>::U, cs,
              16 * ((steps + cs - 1) / cs), 0};
}

template <typename C>
Plan pipe_of() {
  return simple(kSimtPipe, C::BM, C::BN, C::kPipeBK, C::kThreads, 1,
                C::kPipeStages);
}

Plan pipe_plan(int m, int n) {
  return m >= 256 && n >= 256 ? pipe_of<PipeWide>() : pipe_of<PipeSmall>();
}

// what the new variants take: bf16 a and b for TMA (k, n multiples of 8,
// 16-byte aligned bases); f32 a and b for the ring (n a multiple of 4, b
// 16-byte aligned: its 16-byte copies)
bool tma_ok(const void* a, int a_dtype, const void* b, int b_dtype, int k,
            int n) {
  return a_dtype == veles::kBF16 && b_dtype == veles::kBF16 && k % 8 == 0
         && n % 8 == 0 && aligned_to(a, 16) && aligned_to(b, 16);
}
bool pipe_ok(int a_dtype, const void* b, int b_dtype, int n) {
  return a_dtype == veles::kF32 && b_dtype == veles::kF32 && n % 4 == 0
         && aligned_to(b, 16);
}

// the CTAs p launches for [m, n]: a cluster per split_k tile, a CTA per
// tile otherwise, wgmma's at most one per SM (persistent CTAs)
Plan with_ctas(Plan p, int m, int n) {
  const int tiles = (n + p.bn - 1) / p.bn * ((m + p.bm - 1) / p.bm);
  p.ctas = p.variant == kSplitK ? p.cluster * tiles
           : p.variant == kWgmma ? std::min(tiles, veles::sm_count())
           : tiles;
  return p;
}

Plan pick(const void* a, int a_dtype, const void* b, int b_dtype, int m,
          int k, int n) {
  if (tma_ok(a, a_dtype, b, b_dtype, k, n))
    return m > kSplitMaxM && n >= kWgmmaMinN
        ? wgmma_plan(wgmma_bn(m, n))
        : split_plan(m, k, n);
  if (pipe_ok(a_dtype, b, b_dtype, n)) return pipe_plan(m, n);
  const bool big = m >= 256 && n >= 256;
  const int vec = a_dtype == veles::kBF16 ? 8 : 4;   // elements per load
  const int b_size =
      b_dtype == veles::kI8 ? 1 : (a_dtype == veles::kBF16 ? 2 : 4);
  const int aligned = k % vec == 0 && n % vec == 0
      && aligned_to(a, vec * (a_dtype == veles::kBF16 ? 2 : 4))
      && aligned_to(b, vec * b_size);
  if (a_dtype == veles::kBF16)
    return big ? simple(kTcBig, TcBig::BM, TcBig::BN, kBkTc, TcBig::kThreads,
                        aligned, 1)
               : simple(kTcSmall, TcSmall::BM, TcSmall::BN, kBkTc,
                        TcSmall::kThreads, aligned, 1);
  return big ? simple(kSimtBig, 128, 128, kBkSimt, SimtBig::kThreads,
                      aligned, 1)
             : simple(kSimtSmall, 32, 64, kBkSimt, SimtSmall::kThreads,
                      aligned, 1);
}

Plan plan(const void* a, int a_dtype, const void* b, int b_dtype, int m,
          int k, int n) {
  return with_ctas(pick(a, a_dtype, b, b_dtype, m, k, n), m, n);
}

// The plan wgmma or split_k (named by the caller) makes for these
// operands, so that the two can be timed against each other across
// their crossover; variant -1 where these operands cannot take it (or
// another variant is named).
Plan forced_plan(int variant, const void* a, int a_dtype, const void* b,
                 int b_dtype, int m, int k, int n) {
  if ((variant != kWgmma && variant != kSplitK)
      || !tma_ok(a, a_dtype, b, b_dtype, k, n))
    return simple(-1, 0, 0, 0, 0, 0, 0);
  return with_ctas(variant == kWgmma ? wgmma_plan(wgmma_bn(m, n))
                                     : split_plan(m, k, n),
                   m, n);
}

// -- launches

template <typename TA, typename TB, typename K0, typename K1>
int launch2(K0 aligned_kernel, K1 ragged_kernel, const Plan& p, const void* a,
            const void* b, const float* scale, void* out, int out_bf16,
            int relu, int m, int k, int n, cudaStream_t st) {
  const dim3 grid((n + p.bn - 1) / p.bn, (m + p.bm - 1) / p.bm);
  const TA* ap = static_cast<const TA*>(a);
  const TB* bp = static_cast<const TB*>(b);
  if (p.aligned)
    aligned_kernel<<<grid, p.threads, 0, st>>>(ap, bp, scale, out, out_bf16,
                                               relu, m, k, n);
  else
    ragged_kernel<<<grid, p.threads, 0, st>>>(ap, bp, scale, out, out_bf16,
                                              relu, m, k, n);
  return static_cast<int>(cudaGetLastError());
}

template <typename TB>
int launch_tc(const Plan& p, const void* a, const void* b, const float* scale,
              void* out, int out_bf16, int relu, int m, int k, int n,
              cudaStream_t st) {
  if (p.variant == kTcBig)
    return launch2<bf16, TB>(mm_tc<4, 2, 2, 8, TB, true>,
                             mm_tc<4, 2, 2, 8, TB, false>, p, a, b, scale,
                             out, out_bf16, relu, m, k, n, st);
  return launch2<bf16, TB>(mm_tc<2, 2, 1, 2, TB, true>,
                           mm_tc<2, 2, 1, 2, TB, false>, p, a, b, scale, out,
                           out_bf16, relu, m, k, n, st);
}

template <typename TB>
int launch_simt(const Plan& p, const void* a, const void* b,
                const float* scale, void* out, int out_bf16, int relu, int m,
                int k, int n, cudaStream_t st) {
  if (p.variant == kSimtBig)
    return launch2<float, TB>(mm_simt<128, 128, 8, 8, TB, true>,
                              mm_simt<128, 128, 8, 8, TB, false>, p, a, b,
                              scale, out, out_bf16, relu, m, k, n, st);
  return launch2<float, TB>(mm_simt<32, 64, 2, 4, TB, true>,
                            mm_simt<32, 64, 2, 4, TB, false>, p, a, b, scale,
                            out, out_bf16, relu, m, k, n, st);
}

using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the libcuda the runtime loaded (null if
// none)
EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess
        ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// a row-major bf16 [outer, inner] matrix in boxes of [box_outer x
// box_inner] (box_inner * 2 = 128 bytes: one swizzle row), 128-byte
// swizzle, zeros past its edges
int encode_2d(CUtensorMap* map, const bf16* p, int inner, int outer,
              int box_inner, int box_outer) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return kErrNoEncoder;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner),
                              static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(inner) * 2};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_inner),
                             static_cast<cuuint32_t>(box_outer)};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                        const_cast<bf16*>(p), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrEncode;
}

template <int BN, int STAGES>
int launch_wgmma(const Plan& p, const void* a, const void* b,
                 const float* scale, void* out, int out_bf16, int relu, int m,
                 int k, int n, cudaStream_t st) {
  using C = WgCfg<BN, STAGES>;
  // persistent CTAs where the tiles outnumber them
  const bool persist =
      p.ctas < (n + BN - 1) / BN * ((m + kWgBM - 1) / kWgBM);
  const auto kernel =
      persist ? mm_wgmma<BN, STAGES, true> : mm_wgmma<BN, STAGES, false>;
  // above 48 KB of dynamic shared memory only after this, once each
  static const cudaError_t attr[2] = {
      cudaFuncSetAttribute(mm_wgmma<BN, STAGES, false>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           C::kSmem),
      cudaFuncSetAttribute(mm_wgmma<BN, STAGES, true>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           C::kSmem)};
  if (attr[persist] != cudaSuccess) return attr[persist];
  CUtensorMap map_a, map_b;
  int rc = encode_2d(&map_a, static_cast<const bf16*>(a), k, m, kWgBK,
                     kWgBM);
  if (rc == 0)
    rc = encode_2d(&map_b, static_cast<const bf16*>(b), n, k, 64, kWgBK);
  if (rc) return rc;
  kernel<<<p.ctas, kWgThreads, C::kSmem, st>>>(
      map_a, map_b, scale, out, out_bf16, relu, m, k, n);
  return static_cast<int>(cudaGetLastError());
}

template <int RT>
int launch_splitk(const Plan& p, const void* a, const void* b,
                  const float* scale, void* out, int out_bf16, int relu,
                  int m, int k, int n, cudaStream_t st) {
  return static_cast<int>(veles::launch_cluster(
      mm_splitk<RT>, p.cluster, (n + kSkCols - 1) / kSkCols,
      (m + p.bm - 1) / p.bm, kSkThreads, st, static_cast<const bf16*>(a),
      static_cast<const bf16*>(b), scale, out, out_bf16, relu, m, k, n,
      p.k_per_rank / 16));
}

template <typename C, typename K>
int launch_pipe(K kernel, const void* a, const void* b, const float* scale,
                void* out, int out_bf16, int relu, int m, int k, int n,
                cudaStream_t st) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((n + C::BN - 1) / C::BN, (m + C::BM - 1) / C::BM);
  kernel<<<grid, C::kThreads, C::kSmem, st>>>(
      static_cast<const float*>(a), static_cast<const float*>(b), scale, out,
      out_bf16, relu, m, k, n);
  return static_cast<int>(cudaGetLastError());
}

int run(const Plan& p, const void* a, int a_dtype, const void* b,
        int b_dtype, const float* sp, void* out, int out_bf16, int relu,
        int m, int k, int n, cudaStream_t st) {
  switch (p.variant) {
    case kWgmma:
      return p.bn == 256
          ? launch_wgmma<256, 4>(p, a, b, sp, out, out_bf16, relu, m, k, n,
                                 st)
          : p.bn == 128
          ? launch_wgmma<128, 6>(p, a, b, sp, out, out_bf16, relu, m, k, n,
                                 st)
          : launch_wgmma<64, 8>(p, a, b, sp, out, out_bf16, relu, m, k, n,
                                st);
    case kSplitK:
      return p.bm == 8
          ? launch_splitk<1>(p, a, b, sp, out, out_bf16, relu, m, k, n, st)
          : p.bm == 16
          ? launch_splitk<2>(p, a, b, sp, out, out_bf16, relu, m, k, n, st)
          : launch_splitk<4>(p, a, b, sp, out, out_bf16, relu, m, k, n, st);
    case kSimtPipe:
      return p.bm == PipeWide::BM
          ? launch_pipe<PipeWide>(mm_simt_pipe<2, 4, 2, 4, 1, 8, 4>, a, b,
                                  sp, out, out_bf16, relu, m, k, n, st)
          : launch_pipe<PipeSmall>(mm_simt_pipe<1, 4, 1, 1, 2, 16, 4>, a, b,
                                   sp, out, out_bf16, relu, m, k, n, st);
    case kTcBig:
    case kTcSmall:
      return b_dtype == veles::kI8
          ? launch_tc<int8_t>(p, a, b, sp, out, out_bf16, relu, m, k, n, st)
          : launch_tc<bf16>(p, a, b, sp, out, out_bf16, relu, m, k, n, st);
    default:
      return b_dtype == veles::kI8
          ? launch_simt<int8_t>(p, a, b, sp, out, out_bf16, relu, m, k, n,
                                st)
          : launch_simt<float>(p, a, b, sp, out, out_bf16, relu, m, k, n,
                               st);
  }
}

bool types_ok(int a_dtype, int b_dtype) {
  return (a_dtype == veles::kF32 || a_dtype == veles::kBF16)
         && (b_dtype == a_dtype || b_dtype == veles::kI8);
}

void plan_out(const Plan& p, int* out10) {
  const int f[10] = {p.variant, p.bm, p.bn, p.bk, p.threads, p.aligned,
                     p.stages, p.cluster, p.k_per_rank, p.ctas};
  for (int i = 0; i < 10; ++i) out10[i] = f[i];
}

}  // namespace

// The launch plan for these operands: variant, tile rows, tile columns,
// k per tile, threads per CTA, whether the vector loads (TMA, cp.async)
// are taken, stages in flight, cluster size, k rows per cluster rank,
// CTAs launched.  With variant >= 0 the plan of that variant
// (forced_plan), variant -1 in out10[0] if these operands cannot take it.
extern "C" void veles_matmul_plan(const void* a, int a_dtype, const void* b,
                                  int b_dtype, int m, int k, int n,
                                  int variant, int* out10) {
  plan_out(variant < 0 ? plan(a, a_dtype, b, b_dtype, m, k, n)
                       : forced_plan(variant, a, a_dtype, b, b_dtype, m, k,
                                     n),
           out10);
}

// a [m, k] f32 or bf16; b [k, n] of a's type or int8; scale [n] f32 or
// null; out [m, n] f32 (out_bf16 0) or bf16 (1); relu 0 or 1.  All
// contiguous, m, n >= 1.  variant -1 runs plan()'s choice, else the
// forced_plan of that variant.  Returns the launch's error, else
// cudaGetLastError(); negative: kErrTypes, kErrForced, kErrNoEncoder,
// kErrEncode.
extern "C" int veles_matmul(const void* a, int a_dtype, const void* b,
                            int b_dtype, const void* scale, void* out,
                            int out_bf16, int relu, int m, int k, int n,
                            int variant, void* stream) {
  if (!types_ok(a_dtype, b_dtype)) return kErrTypes;
  const Plan p = variant < 0
      ? plan(a, a_dtype, b, b_dtype, m, k, n)
      : forced_plan(variant, a, a_dtype, b, b_dtype, m, k, n);
  if (p.variant < 0) return kErrForced;
  return run(p, a, a_dtype, b, b_dtype, static_cast<const float*>(scale),
             out, out_bf16, relu, m, k, n, static_cast<cudaStream_t>(stream));
}
