// Weight-only int8 GEMM with the per-column dequant scale fused into the
// store: out[m, n] = (sum_k a[m, k] * w[k, n]) * scale[n], in f32.
//
// Replaces: veles_tpu/ops/gemm.py::pallas_matmul (Pallas body _mm_kernel)
// as int8_matmul calls it — int8 weight tiles widened to the activation
// dtype, an f32 accumulator, and the col_scale multiply on the last K
// step before the store.  Int8 -> bf16/f32 is exact for |v| <= 127, and
// a bf16 x bf16 (or f32 x f32 fused) product is exact in f32, so every
// product equals the TPU kernel's; only the order of the sum differs.
//
// What bounds it on the card: bytes.  On the decode path m is the
// occupancy bucket (<= 8 rows) and each weight byte feeds at most 8
// multiply-adds, so the k*n int8 weights are the traffic: 9.4 MB per
// layer of the serving model, 2.9 us at 3.35 TB/s.  Two things stand
// between a simple kernel and that floor:
//
// - Bytes in flight.  Little's law asks for ~16-20 KB in flight per SM
//   to reach the memory rate, over a wave of CTAs.  A CTA owning a
//   strip of columns and the whole of k runs n/32 CTAs at n = 1024 and
//   keeps 4 bytes per thread in flight.  Here the k dimension is split
//   over a thread-block cluster of up to 8 CTAs (one cluster per
//   64-column tile), so (k, n) = (1024, 1024), (1024, 4096) and (4096,
//   1024) each run 128 CTAs (clusters of 8, 2 and 8) streaming 8, 32
//   and 32 KB; each lane loads 8 bytes per weight row with consecutive
//   lanes on consecutive addresses and issues 32 such loads (256 bytes)
//   before it uses any of them.  (16-byte loads with 128-column tiles
//   were measured too: 5-17 % slower per layer on an H100.)
// - Issue.  At the byte bound, 8 multiply-adds per weight byte are 8 x
//   9.4 M FMAs in 2.9 us, ~80 % of the card's 67 TFLOP/s f32 rate, and
//   an int8 -> float conversion (I2F) per byte runs on a quarter-rate
//   pipe.  So the bf16 variant multiplies on the tensor cores
//   (mma.sync m16n8k16, bf16 in, f32 sums) and widens int8 with byte
//   permutes and one f32 add (the 2^23 magic number), not I2F.
//
// The mma's operands are swapped: a 16-column weight slab (k16 x 16
// columns) is the A operand (rows = output columns), the <= 8 activation
// rows are the B operand (columns = m), so m <= 8 fills the n8 side.
// Lane (g, t) = (lane / 4, lane % 4) of a warp loads rows 4t .. 4t + 3
// of each k16 step at columns kVec*g .. kVec*g + kVec - 1 (kVec = 8
// bytes): k-slots (2t, 2t + 1, 2t + 8, 2t + 9) of the mma stand for k
// rows (4t, 4t + 1, 4t + 2, 4t + 3) in both operands, so the A fragment
// is built in registers from the loaded words and the B fragment is
// one 8-byte load of the activations, a[g][4t .. 4t + 3].  Mma j
// of a step covers columns kVec*g + 2j (A row g) and kVec*g + 2j + 1 (A
// row g + 8), so a warp covers kCols = 8*kVec columns with kVec/2 mmas
// per step.
// m > 8 runs further 8-row tiles over grid z.
//
// The f32 variant (the f32 reference chains, held to 1e-5) stays on the
// CUDA cores with exact f32 fused products (TF32 would keep 10 mantissa
// bits): the same loads and widening, FMAs over a 4-row activation tile,
// the quad's four k-row partials added by shuffles.
//
// Activations are read once per CTA, each element by one lane, straight
// into the fragments and issued with the weight loads: no staging in
// shared memory and no barrier before the products (staging the
// k-chunk first cost a serialized round trip and a barrier, ~0.45 us
// of a ~6-9 us launch on an H100).
//
// Reduction, in a fixed order (no atomics: two runs are bit-equal): a
// CTA's warps take its k16 steps round-robin and leave their partial
// tiles in shared memory, summed in warp order; each rank owns a slice
// of the tile and every CTA pushes its sum of each slice into the
// owner's shared memory (distributed shared memory stores, so one
// cluster barrier and no remote round trip); the owner adds the ranks'
// partials in rank order, applies the scale and stores.  The barrier
// that every CTA has started, which remote stores need, is arrived at
// on entry and waited on only before the pushes.  The cluster plan,
// this merge and the launch are common.cuh's, shared with matmul.cu's
// split_k (the same design on bf16 weights).  Ragged m, n and k are
// masked in the kernel (byte loads where a vector load would leave the
// matrix or be misaligned: a template variant, so the aligned kernel
// carries no such code; the same choice as a run-time branch cost ~1 us
// of a 5-7 us launch on an H100), so every shape is taken: the JAX package falls
// back to an XLA dot for shapes that do not tile; this is the same
// function, so no fallback here.
#include "common.cuh"

namespace {

using veles::widen4;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
// weight bytes per lane per row: 8-byte loads, 64 columns per CTA (on an
// H100 16-byte loads and 128-column CTAs took 5-17 % longer per layer)
constexpr int kVec = 8;
constexpr int kCols = 8 * kVec;

template <typename AT> struct Tile;
// bf16: 8 activation rows per CTA (the mma's n8); f32: 4 (registers)
template <> struct Tile<__nv_bfloat16> { static constexpr int kRows = 8; };
template <> struct Tile<float> { static constexpr int kRows = 4; };


// two integral f32 values (exact in bf16) -> a bf16 pair, lo in the low
// half: the high halves of their bit patterns
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// c[16 x 8] += a[16 x 16] . b[16 x 8], bf16 in, f32 sums
__device__ __forceinline__ void mma16816(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// kVec weight bytes of row `row` from column `col` as kVec/4 words; zeros
// past k or n.  ALIGNED (n and the base are multiples of kVec): one
// read-only vector load, which then never straddles the row's end;
// else masked byte loads
template <bool ALIGNED>
__device__ __forceinline__ void load_row(uint32_t (&v)[kVec / 4],
                                         const int8_t* __restrict__ w,
                                         int row, int col, int k, int n) {
#pragma unroll
  for (int q = 0; q < kVec / 4; ++q) v[q] = 0u;
  if (row >= k || col >= n) return;
  const int8_t* p = w + static_cast<size_t>(row) * n + col;
  if constexpr (ALIGNED) {
    const uint2 x = __ldg(reinterpret_cast<const uint2*>(p));
    v[0] = x.x; v[1] = x.y;
  } else {
    for (int c = 0; c < kVec && col + c < n; ++c)
      v[c / 4] |= static_cast<uint32_t>(static_cast<uint8_t>(__ldg(p + c)))
                  << (8 * (c % 4));
  }
}

// a[row][kk .. kk + 3] (zeros past m or k): one 8-byte (bf16) or 16-byte
// (f32) load where `a_vec` (k % 4 == 0 and an aligned base) allows it
__device__ __forceinline__ void load_act(uint32_t (&x)[2],
                                         const __nv_bfloat16* __restrict__ a,
                                         int row, int kk, int m, int k,
                                         bool a_vec) {
  const __nv_bfloat16* p = a + static_cast<size_t>(row) * k + kk;
  if (row < m && a_vec && kk < k) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    x[0] = v.x; x[1] = v.y;
    return;
  }
  uint32_t h[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    h[i] = row < m && kk + i < k ? __bfloat16_as_ushort(p[i]) : 0u;
  x[0] = h[0] | h[1] << 16;
  x[1] = h[2] | h[3] << 16;
}

__device__ __forceinline__ void load_act(float (&x)[4],
                                         const float* __restrict__ a,
                                         int row, int kk, int m, int k,
                                         bool a_vec) {
  const float* p = a + static_cast<size_t>(row) * k + kk;
  if (row < m && a_vec && kk < k) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
    return;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) x[i] = row < m && kk + i < k ? p[i] : 0.f;
}

// What a lane loads for one k16 step: its four weight rows and the
// activations it multiplies them by (bf16: the B fragment, a[g][4t ..
// 4t + 3]; f32: a[i][4t .. 4t + 3] for the CTA's rows i)
template <typename AT> struct Step;
template <> struct Step<__nv_bfloat16> {
  uint32_t w[4][kVec / 4];
  uint32_t b[2];
};
template <> struct Step<float> {
  uint32_t w[4][kVec / 4];
  float b[Tile<float>::kRows][4];
};

// the loads of U of this warp's steps (s, s + kWarps, ...); steps at or
// past `end` load zeros
template <typename AT, bool ALIGNED, int U>
__device__ __forceinline__ void load_steps(
    Step<AT> (&buf)[U], const AT* __restrict__ a,
    const int8_t* __restrict__ w, int s, int end, int g, int t, int col,
    int m0, int m, int k, int n, bool a_vec) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int st = s + u * kWarps;
    const int k0 = st < end ? st * 16 + 4 * t : k;
#pragma unroll
    for (int r = 0; r < 4; ++r)
      load_row<ALIGNED>(buf[u].w[r], w, k0 + r, col, k, n);
    if constexpr (sizeof(AT) == 2) {
      load_act(buf[u].b, a, m0 + g, k0, m, k, a_vec);
    } else {
#pragma unroll
      for (int i = 0; i < Tile<float>::kRows; ++i)
        load_act(buf[u].b[i], a, m0 + i, k0, m, k, a_vec);
    }
  }
}

// One CTA: a tile of kCols output columns x Tile<AT>::kRows rows, over
// its rank's share of the k16 steps; the cluster (grid x) spans k.
template <typename AT, bool ALIGNED>
__global__ void __launch_bounds__(kThreads) int8_gemm_kernel(
    const AT* __restrict__ a, const int8_t* __restrict__ w,
    const float* __restrict__ scale, float* __restrict__ out, int m, int k,
    int n, int steps_per_rank, int a_vec) {
  constexpr bool kTC = sizeof(AT) == 2;          // bf16: tensor cores
  constexpr int kRows = Tile<AT>::kRows;
  constexpr int kTile = kRows * kCols;
  // steps loaded ahead per warp: 256 weight bytes per thread (bf16), 128
  // (f32, whose accumulators take more registers)
  constexpr int U = kTC ? 8 : 4;
  constexpr int kTiles = kVec / 2;                // mmas per step
  __shared__ float red[kWarps][kTile];           // the warps' partials
  __shared__ float recv[kTile];                  // the ranks' partials of
                                                 // this rank's slice
  veles::cluster_arrive();
  const int rank =
      static_cast<int>(cooperative_groups::this_cluster().block_rank());
  const int csize = static_cast<int>(gridDim.x);   // the cluster spans x
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int c0 = blockIdx.y * kCols;
  const int col = c0 + kVec * g;
  const int m0 = blockIdx.z * kRows;
  const int n_steps = (k + 15) / 16;
  const int sb = min(rank * steps_per_rank, n_steps);
  const int se = min(sb + steps_per_rank, n_steps);

  // bf16: acc[j] is mma j's D fragment; f32: acc[i][c], row i, column
  // kVec*g + c, this lane's k rows only
  float acc[kTC ? kTiles : kRows][kTC ? 4 : kVec];
#pragma unroll
  for (int i = 0; i < (kTC ? kTiles : kRows); ++i)
#pragma unroll
    for (int q = 0; q < (kTC ? 4 : kVec); ++q) acc[i][q] = 0.f;

  Step<AT> buf[U];
  int s = sb + warp;
  load_steps<AT, ALIGNED, U>(buf, a, w, s, se, g, t, col, m0, m, k, n,
                                  a_vec);
  for (; s < se; s += kWarps * U) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (s + u * kWarps >= se) break;
      if constexpr (kTC) {
#pragma unroll
        for (int q = 0; q < kVec / 4; ++q) {
          float f[4][4];
#pragma unroll
          for (int r = 0; r < 4; ++r) widen4(buf[u].w[r][q], f[r]);
#pragma unroll
          for (int h = 0; h < 2; ++h)        // mma 2q + h: bytes 2h, 2h + 1
            mma16816(acc[2 * q + h], pack_bf16(f[0][2 * h], f[1][2 * h]),
                     pack_bf16(f[0][2 * h + 1], f[1][2 * h + 1]),
                     pack_bf16(f[2][2 * h], f[3][2 * h]),
                     pack_bf16(f[2][2 * h + 1], f[3][2 * h + 1]),
                     buf[u].b[0], buf[u].b[1]);
        }
      } else {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          float f[kVec];
#pragma unroll
          for (int q = 0; q < kVec / 4; ++q) {
            float f4[4];
            widen4(buf[u].w[r][q], f4);
#pragma unroll
            for (int i = 0; i < 4; ++i) f[4 * q + i] = f4[i];
          }
#pragma unroll
          for (int i = 0; i < kRows; ++i)
#pragma unroll
            for (int c = 0; c < kVec; ++c)
              acc[i][c] = fmaf(buf[u].b[i][r], f[c], acc[i][c]);
        }
      }
    }
    if (s + kWarps * U < se)
      load_steps<AT, ALIGNED, U>(buf, a, w, s + kWarps * U, se, g, t,
                                      col, m0, m, k, n, a_vec);
  }

  // this warp's partial tile -> red[warp][row * kCols + column]
  float* mine = red[warp];
  if constexpr (kTC) {
#pragma unroll
    for (int j = 0; j < kTiles; ++j) {
      const int cc = kVec * g + 2 * j;
      mine[(2 * t) * kCols + cc] = acc[j][0];
      mine[(2 * t + 1) * kCols + cc] = acc[j][1];
      mine[(2 * t) * kCols + cc + 1] = acc[j][2];
      mine[(2 * t + 1) * kCols + cc + 1] = acc[j][3];
    }
  } else {
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int c = 0; c < kVec; ++c) {
        float v = acc[i][c];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        if (t == 0) mine[i * kCols + kVec * g + c] = v;
      }
  }
  // the ranks' partials of this rank's slice in rank order, scaled
  veles::cluster_merge<kThreads>(red, recv, rank, csize, [&](int e, float v) {
    const int row = m0 + e / kCols;
    const int cc = c0 + e % kCols;
    if (row < m && cc < n)
      out[static_cast<size_t>(row) * n + cc] = v * scale[cc];
  });
}

struct Plan {
  int cluster, steps_per_rank, rows;
};

// the smallest cluster that fills a wave (veles::split_cluster)
Plan plan(int m, int k, int n, int a_dtype) {
  const int rows = a_dtype == veles::kBF16 ? Tile<__nv_bfloat16>::kRows
                                           : Tile<float>::kRows;
  const int tiles = (n + kCols - 1) / kCols * ((m + rows - 1) / rows);
  const int steps = (k + 15) / 16;
  const int cs = veles::split_cluster(tiles, steps);
  return {cs, (steps + cs - 1) / cs, rows};
}

template <typename AT, bool ALIGNED>
cudaError_t launch(const Plan& p, const AT* a, const int8_t* w,
                   const float* scale, float* out, int m, int k, int n,
                   cudaStream_t stream) {
  const int a_vec = k % 4 == 0
      && reinterpret_cast<uintptr_t>(a) % (4 * sizeof(AT)) == 0;
  return veles::launch_cluster(
      int8_gemm_kernel<AT, ALIGNED>, p.cluster, (n + kCols - 1) / kCols,
      (m + p.rows - 1) / p.rows, kThreads, stream, a, w, scale, out, m, k,
      n, p.steps_per_rank, a_vec);
}

// the vector-load kernel where n and the weights' base are multiples of
// kVec, else the masked one
template <typename AT>
cudaError_t launch(const void* a, const int8_t* w, const float* scale,
                   float* out, int m, int k, int n, int a_dtype,
                   cudaStream_t stream) {
  const Plan p = plan(m, k, n, a_dtype);
  const AT* ap = static_cast<const AT*>(a);
  return n % kVec == 0 && reinterpret_cast<uintptr_t>(w) % kVec == 0
      ? launch<AT, true>(p, ap, w, scale, out, m, k, n, stream)
      : launch<AT, false>(p, ap, w, scale, out, m, k, n, stream);
}

}  // namespace

// The launch plan of a shape: {output columns per CTA, cluster size
// along k, k rows per cluster rank, activation rows per CTA}.
extern "C" void veles_int8_gemm_plan(int m, int k, int n, int a_dtype,
                                     int* out4) {
  const Plan p = plan(m, k, n, a_dtype);
  out4[0] = kCols;
  out4[1] = p.cluster;
  out4[2] = 16 * p.steps_per_rank;
  out4[3] = p.rows;
}

// a [m, k] (f32 or bf16), w [k, n] int8, scale [n] f32, out [m, n] f32;
// all contiguous, m, n >= 1.  Returns the launch's error, else
// cudaGetLastError() (-1: unknown dtype).
extern "C" int veles_int8_gemm(const void* a, int a_dtype, const void* w,
                               const void* scale, void* out, int m, int k,
                               int n, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* wp = static_cast<const int8_t*>(w);
  const float* sp = static_cast<const float*>(scale);
  float* op = static_cast<float*>(out);
  switch (a_dtype) {
    case veles::kF32:
      return launch<float>(a, wp, sp, op, m, k, n, a_dtype, st);
    case veles::kBF16:
      return launch<__nv_bfloat16>(a, wp, sp, op, m, k, n, a_dtype, st);
    default:
      return -1;
  }
}
