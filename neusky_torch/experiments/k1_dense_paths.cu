// Experiment: three ways to sum one dense hash-grid level's table gradient
// on Hopper (sm_90a), for neusky_torch/experiments/k1_dense_paths.py.
//
//     out[f, rows[i]] += vals[f, i]      i < M, f in {0, 1}, rows < R <= T
//
// mode 0, cluster_dsmem: one cluster of 8 CTAs owns the level; each CTA
//   holds ceil(R / 8) rows of both planes in shared memory, updates go to
//   the owner with mapa + red.shared::cluster.add.f32, then each CTA stores
//   its slice and its share of the zero rows [R, T).
// mode 1, cta_shared: the same cluster, but every CTA reads all M updates
//   and adds the rows of its own slice into its own shared memory.
// mode 2, l2_red: the output zeroed by cudaMemsetAsync, then one
//   red.global.add.f32 per feature per update from a grid-stride loop.
// Not a kernel of the port: K1 (csrc/hashgrid_scatter.cu) is l2_red with
// the warp's runs of equal rows summed first.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kCtas = 8;
constexpr int kSmemBytes = 232448 - 1024;

__global__ void __launch_bounds__(kThreads, 1)
    cluster_kernel(const int32_t* __restrict__ rows, const float* __restrict__ vals,
                   float* __restrict__ out, int m, int t, int extent, int mode) {
  extern __shared__ float acc[];
  cg::cluster_group cluster = cg::this_cluster();
  const uint32_t rank = cluster.block_rank();
  const int s = (extent + kCtas - 1) / kCtas;
  for (int k = threadIdx.x; k < 2 * s; k += blockDim.x) acc[k] = 0.f;
  cluster.sync();
  if (mode == 0) {
    const uint32_t base = (uint32_t)__cvta_generic_to_shared(acc);
    for (int i = rank * blockDim.x + threadIdx.x; i < m; i += kCtas * blockDim.x) {
      const int r = rows[i];
      if (r < 0 || r >= extent) continue;
      const uint32_t owner = (uint32_t)r / (uint32_t)s, off = (uint32_t)r - owner * (uint32_t)s;
      uint32_t a0, a1;
      asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(a0) : "r"(base + 4u * off), "r"(owner));
      asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(a1) : "r"(base + 4u * (s + off)), "r"(owner));
      asm volatile("red.shared::cluster.add.f32 [%0], %1;" ::"r"(a0), "f"(vals[i]) : "memory");
      asm volatile("red.shared::cluster.add.f32 [%0], %1;" ::"r"(a1), "f"(vals[m + i]) : "memory");
    }
  } else {
    const int lo = rank * s;
    for (int i = threadIdx.x; i < m; i += blockDim.x) {
      const int r = rows[i] - lo;
      if (r < 0 || r >= s || r + lo >= extent) continue;
      atomicAdd(acc + r, vals[i]);
      atomicAdd(acc + s + r, vals[m + i]);
    }
  }
  cluster.sync();
  const int lo = rank * s, hi = min(lo + s, extent);
  for (int r = lo + threadIdx.x; r < hi; r += blockDim.x) {
    out[r] = acc[r - lo];
    out[t + r] = acc[s + r - lo];
  }
  for (int r = extent + rank * blockDim.x + threadIdx.x; r < t; r += kCtas * blockDim.x) {
    out[r] = 0.f;
    out[t + r] = 0.f;
  }
}

__global__ void l2_red_kernel(const int32_t* __restrict__ rows, const float* __restrict__ vals,
                              float* __restrict__ out, int m, int t) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < m; i += gridDim.x * blockDim.x) {
    const int r = rows[i];
    if (r < 0 || r >= t) continue;
    atomicAdd(out + r, vals[i]);
    atomicAdd(out + t + r, vals[m + i]);
  }
}

}  // namespace

// rows [M] int32, vals [2, M], out [2, T]; returns 0 or a cudaError.
extern "C" int k1_dense_path(const void* rows, const void* vals, void* out, int m, int t, int extent,
                             int mode, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e;
  if (mode == 2) {
    if ((e = cudaMemsetAsync(out, 0, (size_t)2 * t * sizeof(float), s)) != cudaSuccess) return (int)e;
    int sms = 0, dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const int blocks = min((m + 511) / 512, sms * 4);
    l2_red_kernel<<<blocks, 512, 0, s>>>((const int32_t*)rows, (const float*)vals, (float*)out, m, t);
    return (int)cudaGetLastError();
  }
  const size_t smem = (size_t)2 * ((extent + kCtas - 1) / kCtas) * sizeof(float);
  if (smem > (size_t)kSmemBytes) return (int)cudaErrorInvalidValue;
  if ((e = cudaFuncSetAttribute(cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes)) !=
      cudaSuccess)
    return (int)e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCtas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCtas);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if ((e = cudaLaunchKernelEx(&cfg, cluster_kernel, (const int32_t*)rows, (const float*)vals, (float*)out, m, t,
                              extent, mode)) != cudaSuccess)
    return (int)e;
  return (int)cudaGetLastError();
}
