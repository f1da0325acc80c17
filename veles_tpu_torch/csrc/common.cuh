// Shared helpers of the port's kernels: element-type codes the Python
// wrappers pass across the C interface, widening loads to float, and
// the split-K cluster plan, merge and launch of the two GEMMs
// (int8_gemm.cu, matmul.cu's split_k).
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace veles {

// dtype codes (DTYPE_CODES in veles_tpu_torch/ops/__init__.py)
enum DType : int { kF32 = 0, kBF16 = 1, kI8 = 2 };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(int8_t x) {
  return static_cast<float>(x);
}

// 4 int8 in a word -> their exact values in f32, without I2F: the byte
// biased by 128 becomes the low mantissa byte of 2^23 (0x4B0000uu =
// 2^23 + u), and one subtraction of 2^23 + 128 leaves u - 128 = x
__device__ __forceinline__ void widen4(uint32_t w, float (&f)[4]) {
  const uint32_t u = w ^ 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 | i))
        - 8388736.0f;
}

// the card's SM count (132 if the runtime cannot say), read once
inline int sm_count() {
  static int sms = 0;
  if (!sms) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess
        || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)
               != cudaSuccess)
      sms = 132;
  }
  return sms;
}

// -- split-K over a thread-block cluster (one cluster per output tile,
// the cluster spanning grid x and k)

constexpr int kMaxCluster = 8;      // the portable cluster size

// the smallest cluster whose CTAs over `tiles` output tiles fill a wave
// (7/8 of the SMs or more), at most kMaxCluster, at least one of the
// `steps` k16 steps per rank
inline int split_cluster(int tiles, int steps) {
  int cs = 1;
  while (cs < kMaxCluster && 2 * cs <= steps
         && 8 * tiles * cs < 7 * sm_count())
    cs *= 2;
  return cs;
}

// every CTA of the cluster must have started before another writes its
// shared memory: arrive on entry; cluster_merge waits before its first
// remote store
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

// The ranks' partials merged in a fixed order (no atomics: two runs are
// bit-equal).  red[w] is warp w's partial tile; each rank owns a slice
// of the tile, and every CTA pushes its sum (in warp order) of each
// slice into the owner's recv (distributed shared memory stores, so one
// cluster barrier and no remote round trip); the owner adds the ranks'
// partials in rank order and hands element e of the tile, summed, to
// store(e, v).  kThreads threads; csize = the cluster's CTAs.
template <int kThreads, int kWarps, int kTile, typename Store>
__device__ __forceinline__ void cluster_merge(float (&red)[kWarps][kTile],
                                              float (&recv)[kTile],
                                              int rank, int csize,
                                              Store store) {
  cooperative_groups::cluster_group cluster =
      cooperative_groups::this_cluster();
  __syncthreads();
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  const int per = kTile / csize;
  for (int e = threadIdx.x; e < kTile; e += kThreads) {
    float v = red[0][e];
#pragma unroll
    for (int x = 1; x < kWarps; ++x) v += red[x][e];
    const int q = e / per;
    cluster.map_shared_rank(recv, q)[rank * per + e - q * per] = v;
  }
  cluster.sync();                       // every push has landed
  for (int j = threadIdx.x; j < per; j += kThreads) {
    float v = 0.f;
    for (int x = 0; x < csize; ++x) v += recv[x * per + j];
    store(rank * per + j, v);
  }
}

// kernel on a grid of (cluster, gy, gz) CTAs of `threads`, in clusters
// of `cluster` along x; the launch's error, else cudaGetLastError()
template <typename... P, typename... A>
cudaError_t launch_cluster(void (*kernel)(P...), int cluster, int gy,
                           int gz, int threads, cudaStream_t stream,
                           A... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, gy, gz);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  return e != cudaSuccess ? e : cudaGetLastError();
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

}  // namespace veles
