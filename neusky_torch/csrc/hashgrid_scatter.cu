// K1 — the hash-grid table-gradient scatter, all levels of one encode in one
// launch, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel neusky_tpu/ops/hashgrid_pallas.py::_scatter_kernel
// (:47) and computes the JAX function neusky_tpu/ops/hashgrid.py::
// _scatter_levels (:732), which launches that kernel once per level:
//
//     out[l, f, rows[l, i]] += vals[l, f, i]     l < L, i < M, f in {0, 1}
//
// rows int32 [L, M]; vals fp32 [L, 2, M]; out fp32 [L, 2, T], each level's
// slab 2T contiguous floats (the wrapper allocates it with torch.empty; this
// entry point zeroes it).  Rows outside [0, T) are dropped.  The feature and
// row strides of vals and out are arguments, so the row-major
// [M, 2] -> [T, 2] layout of scatter_add_tablegrad is the L = 1 case.
//
// Bound on this card: bytes.  Each update reads 12 B (an index and two
// values) and the output is written once: 12 L M + 8 L T bytes at
// 3.35 TB/s.  The two fp32 adds per update are far below the fp32 rate.
// What limits it in practice is the rate of fp32 reductions in L2.
//
// Design:
//  - One launch per encode, after one cudaMemsetAsync of the whole
//    [L, 2, T] output: launch, fill and host cost are paid once for all L
//    levels (they were paid per level), and the gradient arrives whole, so
//    autograd stacks no per-level gradients.
//  - One grid-stride loop over (level, update), updates of one level
//    consecutive, so a warp reads 32 consecutive rows and values.
//  - Duplicates are combined in the warp before they reach L2: the
//    encodes order updates ray by ray, so consecutive samples of a ray fall
//    in one cell of the coarse (dense) levels, tens of times a row.  A
//    segmented warp scan sums each run of equal (level, row) keys and only
//    the run's last lane issues the two red.global.add.f32.
//  - Why not shared memory: Hopper has no native fp32 add into shared
//    memory, local or distributed.  atomicAdd there, and red.shared::cluster
//    .add.f32 through mapa, compile to compare-and-swap loops (SASS
//    ATOMS.CAST.SPIN, ATOM.E.CAST.SPIN), which lost to the L2 reductions at
//    every main-path site: neusky_torch/experiments/k1_dense_paths.py.
// No launch falls back: a refused launch returns its cudaError.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr uint32_t kFull = 0xFFFFFFFFu;
constexpr uint32_t kNoKey = 0xFFFFFFFFu;  // a dropped update

struct Params {
  const int32_t* rows;
  const float* vals;
  float* out;
  int64_t vals_fs, vals_rs;  // feature and row stride of vals, in elements
  int64_t out_fs, out_rs;    // feature and row stride of out
  int32_t levels, m, t;
};

__global__ void __launch_bounds__(kThreads)
    scatter_levels_kernel(const Params p) {
  const uint32_t lane = threadIdx.x & 31u;
  const uint32_t total = (uint32_t)p.levels * (uint32_t)p.m;
  const uint32_t stride = gridDim.x * blockDim.x;
  // the warp walks in step, so every lane takes part in the shuffles
  for (uint32_t base = blockIdx.x * blockDim.x + (threadIdx.x & ~31u);
       base < total; base += stride) {
    const uint32_t j = base + lane;
    uint32_t key = kNoKey, l = 0;
    int32_t r = 0;
    float v0 = 0.f, v1 = 0.f;
    if (j < total) {
      l = j / (uint32_t)p.m;
      const uint32_t i = j - l * (uint32_t)p.m;
      r = __ldg(p.rows + j);
      if (r >= 0 && r < p.t) {
        key = l * (uint32_t)p.t + (uint32_t)r;
        const float* v = p.vals + (int64_t)l * 2 * p.m + (int64_t)i * p.vals_rs;
        v0 = __ldg(v);
        v1 = __ldg(v + p.vals_fs);
      }
    }
    // runs of equal keys: a lane heads a run where its key differs from the
    // previous lane's; an inclusive scan inside each run leaves the run's
    // sum in its last lane
    const uint32_t prev = __shfl_up_sync(kFull, key, 1);
    const uint32_t heads = __ballot_sync(kFull, lane == 0 || prev != key);
    const uint32_t start = 31u - __clz(heads & (kFull >> (31u - lane)));
    for (uint32_t d = 1; d < 32; d <<= 1) {
      const float u0 = __shfl_up_sync(kFull, v0, d);
      const float u1 = __shfl_up_sync(kFull, v1, d);
      if (lane >= start + d) {
        v0 += u0;
        v1 += u1;
      }
    }
    const bool last = lane == 31 || ((heads >> (lane + 1)) & 1u);
    if (last && key != kNoKey) {
      float* o = p.out + (int64_t)l * 2 * p.t + (int64_t)r * p.out_rs;
      atomicAdd(o, v0);  // the result is unused: red.global.add.f32
      atomicAdd(o + p.out_fs, v1);
    }
  }
}

}  // namespace

// Zeroes `out` and launches the kernel on `stream`.  Returns 0 or the
// cudaError of the fill, the setup or the launch.
extern "C" int hashgrid_scatter_levels(const void* rows, const void* vals,
                                       void* out, long long levels,
                                       long long m, long long t,
                                       long long vals_fs, long long vals_rs,
                                       long long out_fs, long long out_rs,
                                       void* stream) {
  if (levels <= 0 || m <= 0 || t <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e =
      cudaMemsetAsync(out, 0, (size_t)levels * 2 * t * sizeof(float), s);
  if (e != cudaSuccess) return (int)e;
  // a persistent grid: as many blocks as stay resident, never more than the
  // work needs
  static int resident = 0;
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
    if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
      return (int)e;
    if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, scatter_levels_kernel, kThreads, 0)) != cudaSuccess)
      return (int)e;
    resident = sms * (per_sm > 0 ? per_sm : 1);
  }
  const long long need = (levels * m + kThreads - 1) / kThreads;
  const unsigned blocks = (unsigned)(need < resident ? need : resident);
  Params p = {(const int32_t*)rows, (const float*)vals, (float*)out,
              vals_fs, vals_rs, out_fs, out_rs,
              (int32_t)levels, (int32_t)m, (int32_t)t};
  scatter_levels_kernel<<<blocks, kThreads, 0, s>>>(p);
  return (int)cudaGetLastError();
}
