// Tiled GEMM with a fused store epilogue:
//   out[m, n] = relu?((sum_k a[m, k] * b[k, n]) * scale?[n])
// summed in f32 and stored as f32 or bf16 (rounded to nearest even).
//
// Replaces: veles_tpu/ops/gemm.py::pallas_matmul (Pallas body _mm_kernel,
// gemm.py:44; pallas_call gemm.py:115) in its general form: a f32 or bf16,
// b of a's type or int8 (widened to a's type, gemm.py:62-63; exact for
// |v| <= 127), an f32 accumulator over the k blocks, the optional
// per-column scale and then the epilogue applied before the store
// (gemm.py:73-77).  f32 operands run at Precision.HIGHEST there, i.e.
// exact f32 products; bf16 ones at the default, i.e. exact bf16 products
// summed in f32.  So both variants here compute the same products, and
// only the order of the sum differs:
//
// - bf16 a: the tensor cores, mma.sync.m16n8k16 bf16 -> f32.  A CTA
//   stages a [BM x 32] tile of a and a [32 x BN] tile of b (int8 widened
//   to bf16 on the way) in shared memory, rows padded by 16 bytes so
//   that ldmatrix reads them without bank conflicts (a as the A operand,
//   b through ldmatrix.trans as the B operand), and each warp runs its
//   [MT*16 x NT*8] share of the tile.  The next tile's loads are issued
//   into registers before the current one is multiplied.
// - f32 a: the CUDA cores (TF32 would keep 10 mantissa bits): a
//   [BM x 8] tile of a (stored transposed) and an [8 x BN] tile of b in
//   shared memory, each thread a [TM x TN] register tile of fused
//   multiply-adds in ascending k.
//
// Every output element is summed by one thread in a fixed order (no
// split over k, no atomics), so two runs are bit-equal.  The block
// sizes of the Pallas kernel only tile the problem there; here the
// kernel picks its own tiles (plan()), and ragged edges are masked in
// all three dimensions: 16-byte (8-byte for int8 b) vector loads where k
// and n are multiples of 8 and the pointers aligned (the ALIGNED
// template variant), element loads otherwise.
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

// -- plan and launch ---------------------------------------------------------

// the variants: tensor cores, [128 x 128] tiles of 8 warps (2 x 8 mma
// tiles each) or [32 x 32] tiles of 4 warps (1 x 2) for small m or n;
// f32, [128 x 128] tiles of 256 threads (8 x 8 each) or [32 x 64] (2 x 4)
using TcBig = TcCfg<4, 2, 2, 8>;
using TcSmall = TcCfg<2, 2, 1, 2>;
using SimtBig = SimtCfg<128, 128, 8, 8>;
using SimtSmall = SimtCfg<32, 64, 2, 4>;

enum Variant : int { kTcBig = 0, kTcSmall = 1, kSimtBig = 2, kSimtSmall = 3 };

struct Plan {
  int variant, bm, bn, bk, threads, aligned;
};

bool aligned_to(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

Plan plan(const void* a, int a_dtype, const void* b, int b_dtype, int m,
          int k, int n) {
  const bool big = m >= 256 && n >= 256;
  const int vec = a_dtype == veles::kBF16 ? 8 : 4;   // elements per load
  const int b_size =
      b_dtype == veles::kI8 ? 1 : (a_dtype == veles::kBF16 ? 2 : 4);
  const int aligned = k % vec == 0 && n % vec == 0
      && aligned_to(a, vec * (a_dtype == veles::kBF16 ? 2 : 4))
      && aligned_to(b, vec * b_size);
  if (a_dtype == veles::kBF16)
    return big ? Plan{kTcBig, TcBig::BM, TcBig::BN, kBkTc, TcBig::kThreads,
                      aligned}
               : Plan{kTcSmall, TcSmall::BM, TcSmall::BN, kBkTc,
                      TcSmall::kThreads, aligned};
  return big ? Plan{kSimtBig, 128, 128, kBkSimt, SimtBig::kThreads, aligned}
             : Plan{kSimtSmall, 32, 64, kBkSimt, SimtSmall::kThreads,
                    aligned};
}

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

}  // namespace

// The launch plan for these operands: variant, tile rows, tile columns,
// k per tile, threads per CTA, whether the vector loads are taken.
extern "C" void veles_matmul_plan(const void* a, int a_dtype, const void* b,
                                  int b_dtype, int m, int k, int n,
                                  int* out6) {
  const Plan p = plan(a, a_dtype, b, b_dtype, m, k, n);
  out6[0] = p.variant;
  out6[1] = p.bm;
  out6[2] = p.bn;
  out6[3] = p.bk;
  out6[4] = p.threads;
  out6[5] = p.aligned;
}

// a [m, k] f32 or bf16; b [k, n] of a's type or int8; scale [n] f32 or
// null; out [m, n] f32 (out_bf16 0) or bf16 (1); relu 0 or 1.  All
// contiguous, m, n >= 1.  Returns the launch's error, else
// cudaGetLastError() (-1: an unsupported pair of types).
extern "C" int veles_matmul(const void* a, int a_dtype, const void* b,
                            int b_dtype, const void* scale, void* out,
                            int out_bf16, int relu, int m, int k, int n,
                            void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sp = static_cast<const float*>(scale);
  if (a_dtype != veles::kF32 && a_dtype != veles::kBF16) return -1;
  if (b_dtype != a_dtype && b_dtype != veles::kI8) return -1;
  const Plan p = plan(a, a_dtype, b, b_dtype, m, k, n);
  if (a_dtype == veles::kBF16)
    return b_dtype == veles::kI8
        ? launch_tc<int8_t>(p, a, b, sp, out, out_bf16, relu, m, k, n, st)
        : launch_tc<bf16>(p, a, b, sp, out, out_bf16, relu, m, k, n, st);
  return b_dtype == veles::kI8
      ? launch_simt<int8_t>(p, a, b, sp, out, out_bf16, relu, m, k, n, st)
      : launch_simt<float>(p, a, b, sp, out, out_bf16, relu, m, k, n, st);
}
