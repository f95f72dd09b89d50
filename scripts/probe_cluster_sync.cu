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
//   probe_l2_read       — `blocks` CTAs (one per SM: each asks for more than
//                         half an SM's shared memory) stream their shares of
//                         an L2-resident buffer `reps` times with 16-byte
//                         L2-only loads (__ldcg)
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

}  // extern "C"
