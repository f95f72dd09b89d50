// Barrier and L2 probes for choosing the cluster size of the chunk and tcg
// kernels (cora_tpu_torch/ops/csrc/tnt_kernels.cu). Built and driven by
// scripts/probe_cluster_sync.py; plain C interface, bound with ctypes.
//
//   probe_block_sync    — `iters` __syncthreads() in one CTA of 1024 threads
//   probe_cluster_sync  — `iters` cluster.sync() in one cluster of C CTAs
//                         of 1024 threads (C > 8 needs the non-portable
//                         cluster size attribute)
//   probe_grid_sync     — `iters` grid.sync() in a cooperative launch of
//                         `blocks` CTAs of 1024 threads
//   probe_grid_barrier  — `iters` grid barriers in a cooperative launch
//                         (cudaLaunchKernelEx, the cooperative attribute) of
//                         `blocks` CTAs of 1024 threads, one per SM (each asks
//                         for more than half an SM's shared memory): kind 0
//                         grid.sync(), kind 1 a monotonic counter (a release
//                         add by one thread a CTA, an acquire spin; zeroed by
//                         a memset first). With `check`, each CTA stores the
//                         barrier's index before it and reads its neighbour's
//                         after it through L2; `bad` counts the misses. Its
//                         launch is what a CUDA graph capture is asked to take
//   probe_cluster_sync_smem — cluster.sync() as probe_cluster_sync, each CTA
//                         with `smem` bytes of dynamic shared memory
//   probe_l2_read       — `blocks` CTAs (one per SM: each asks for more than
//                         half an SM's shared memory) stream their shares of
//                         an L2-resident buffer `reps` times with 16-byte
//                         L2-only loads (__ldcg)
//   probe_rows_round    — a model of small_eigh's stream route's round, for
//                         the cost of updating V by index beside A: G CTAs
//                         (one per SM) of a cooperative launch, CTA c owning
//                         the rows of slots [cS, cS + S) of the circle
//                         method's round (two a slot, by index in an np × np
//                         array A), reading each from L2 and writing it back
//                         (__ldcg / __stcg, eight doubles a thread in flight),
//                         with `both` the same rows of a second array V too,
//                         then the counter barrier; `rounds` rounds
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kOneCtaPerSm = 120 * 1024;  // dynamic shared memory, bytes

__global__ void __launch_bounds__(kThreads, 1)
block_sync_kernel(int iters, float* sink) {
  float acc = (float)threadIdx.x;
  for (int i = 0; i < iters; ++i) {
    __syncthreads();
    acc += 1.f;
  }
  if (acc < 0.f) sink[0] = acc;
}

__global__ void __launch_bounds__(kThreads, 1)
cluster_sync_kernel(int iters, float* sink) {
  float acc = (float)threadIdx.x;
  for (int i = 0; i < iters; ++i) {
    cg::this_cluster().sync();
    acc += 1.f;
  }
  if (acc < 0.f) sink[0] = acc;
}

__global__ void __launch_bounds__(kThreads, 1)
grid_sync_kernel(int iters, float* sink) {
  cg::grid_group grid = cg::this_grid();
  float acc = (float)threadIdx.x;
  for (int i = 0; i < iters; ++i) {
    grid.sync();
    acc += 1.f;
  }
  if (acc < 0.f) sink[0] = acc;
}

// a grid barrier on a monotonic count: every CTA's thread 0 adds one
// (release) and waits (acquire) until all `gridDim.x` CTAs have added for
// this barrier
__device__ __forceinline__ void counter_barrier(unsigned* count, unsigned target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;" ::"l"(count) : "memory");
    unsigned v;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(count) : "memory");
    } while (v < target);
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads, 1)
grid_barrier_kernel(int kind, int iters, int check, unsigned* count, int* slot,
                    int* bad) {
  const int G = gridDim.x, b = blockIdx.x;
  int miss = 0;
  for (int i = 0; i < iters; ++i) {
    if (check && threadIdx.x == 0) slot[(i & 1) * G + b] = i;
    if (kind == 0)
      cg::this_grid().sync();
    else
      counter_barrier(count, (unsigned)G * (i + 1));
    if (check && threadIdx.x == 0)
      miss += __ldcg(slot + (i & 1) * G + (b + 1) % G) != i;
  }
  if (threadIdx.x == 0) bad[b] = miss;
}

__global__ void __launch_bounds__(kThreads, 1)
cluster_smem_kernel(int iters, float* sink) {
  extern __shared__ float hold[];
  float acc = (float)threadIdx.x;
  for (int i = 0; i < iters; ++i) {
    cg::this_cluster().sync();
    acc += 1.f;
  }
  if (acc < 0.f) sink[0] = acc + hold[0];
}

__global__ void __launch_bounds__(kThreads, 1)
l2_read_kernel(const float4* buf, int n4, int reps, float* sink) {
  extern __shared__ float hold[];  // only there to keep one CTA per SM
  const int per = (n4 + gridDim.x - 1) / gridDim.x;
  const int a = blockIdx.x * per, b = min(a + per, n4);
  float acc = 0.f;
  for (int rep = 0; rep < reps; ++rep)
    for (int i = a + threadIdx.x; i < b; i += blockDim.x) {
      const float4 v = __ldcg(buf + i);
      acc += v.x + v.y + v.z + v.w;
    }
  if (acc == 12345.f) sink[0] = acc + hold[0];
}

constexpr int kRowThreads = 512;  // small_eigh.cu STREAM_THREADS
constexpr int kMaxRows = 64;      // 2 sides × S ≤ 16 slots × 2 arrays

// the index at (slot i, side) in round rd of the circle method over np =
// m + 1 (small_eigh.cu index_at)
__device__ __forceinline__ int index_at(int rd, int i, int side, int m) {
  if (side == 0) {
    const int a = rd + i;
    return a >= m ? a - m : a;
  }
  if (i == 0) return m;
  const int b = rd - i;
  return b < 0 ? b + m : b;
}

__global__ void __launch_bounds__(kRowThreads, 1)
rows_round_kernel(double* A, double* V, int np, int S, int rounds, int both,
                  unsigned* count) {
  extern __shared__ float hold[];  // only there to keep one CTA per SM
  __shared__ double* base[kMaxRows];
  const int G = gridDim.x, h = np / 2, m = np - 1, T = blockDim.x;
  const int s0 = min(blockIdx.x * S, h), s1 = min(h, s0 + S), own = 2 * (s1 - s0);
  const int rows = own * (1 + both);
  for (int rd = 0; rd < rounds; ++rd) {
    const int r = rd % m;
    for (int x = threadIdx.x; x < rows; x += T) {
      const int y = x % own;
      base[x] = (x < own ? A : V) + (size_t)index_at(r, s0 + y / 2, y & 1, m) * np;
    }
    __syncthreads();
    int row = 0, col = threadIdx.x;  // T ≤ np: a step wraps at most once
    while (row < rows) {
      double x[8];
      double* p[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        p[k] = row < rows ? base[row] + col : nullptr;
        if (p[k]) x[k] = __ldcg(p[k]);
        col += T;
        if (col >= np) {
          col -= np;
          ++row;
        }
      }
#pragma unroll
      for (int k = 0; k < 8; ++k)
        if (p[k]) __stcg(p[k], x[k]);
    }
    counter_barrier(count, (unsigned)G * (rd + 1));
  }
  if (hold[0] == 12345.f) A[0] = 0.0;
}

}  // namespace

extern "C" {

int probe_block_sync(int iters, float* sink, void* stream) {
  block_sync_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(iters, sink);
  return (int)cudaGetLastError();
}

// Also writes how many clusters of C fit on the card at once.
int probe_cluster_sync(int C, int iters, float* sink, int* max_clusters,
                       void* stream) {
  cudaError_t e = cudaFuncSetAttribute(
      (const void*)cluster_sync_kernel,
      cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaOccupancyMaxActiveClusters(max_clusters,
                                     (const void*)cluster_sync_kernel, &cfg);
  if (e != cudaSuccess) return (int)e;
  e = cudaLaunchKernelEx(&cfg, cluster_sync_kernel, iters, sink);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

int probe_grid_sync(int blocks, int iters, float* sink, void* stream) {
  void* args[] = {&iters, &sink};
  cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)grid_sync_kernel, dim3(blocks), dim3(kThreads), args, 0,
      (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// kind 0: grid.sync(), 1: the counter barrier; `count` is zeroed first
int probe_grid_barrier(int kind, int blocks, int iters, int check, unsigned* count,
                       int* slot, int* bad, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaFuncSetAttribute(
      (const void*)grid_barrier_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kOneCtaPerSm);
  if (e != cudaSuccess) return (int)e;
  e = cudaMemsetAsync(count, 0, sizeof(unsigned), st);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = kOneCtaPerSm;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, grid_barrier_kernel, kind, iters, check, count, slot, bad);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// cluster.sync() at C CTAs of `smem` bytes of dynamic shared memory each;
// also writes how many such clusters fit on the card at once
int probe_cluster_sync_smem(int C, int smem, int iters, float* sink, int* max_clusters,
                            void* stream) {
  cudaError_t e = cudaFuncSetAttribute(
      (const void*)cluster_smem_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute((const void*)cluster_smem_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaOccupancyMaxActiveClusters(max_clusters, (const void*)cluster_smem_kernel, &cfg);
  if (e != cudaSuccess) return (int)e;
  e = cudaLaunchKernelEx(&cfg, cluster_smem_kernel, iters, sink);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

int probe_l2_read(int blocks, const float* buf, int n4, int reps, float* sink,
                  void* stream) {
  cudaError_t e = cudaFuncSetAttribute(
      (const void*)l2_read_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kOneCtaPerSm);
  if (e != cudaSuccess) return (int)e;
  l2_read_kernel<<<blocks, kThreads, kOneCtaPerSm, (cudaStream_t)stream>>>(
      (const float4*)buf, n4, reps, sink);
  return (int)cudaGetLastError();
}

// the stream round's model at np on G CTAs of S slots; `count` is zeroed
// first
int probe_rows_round(int G, int np, int S, int rounds, int both, double* A, double* V,
                     unsigned* count, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (np < kRowThreads || 2 * S * 2 > kMaxRows) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      (const void*)rows_round_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kOneCtaPerSm);
  if (e != cudaSuccess) return (int)e;
  e = cudaMemsetAsync(count, 0, sizeof(unsigned), st);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(G, 1, 1);
  cfg.blockDim = dim3(kRowThreads, 1, 1);
  cfg.dynamicSmemBytes = kOneCtaPerSm;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, rows_round_kernel, A, V, np, S, rounds, both, count);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // extern "C"
