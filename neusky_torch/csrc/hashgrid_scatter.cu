// K1 — hash-table gradient scatter-add, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel neusky_tpu/ops/hashgrid_pallas.py::_scatter_kernel
// (launched by scatter_add_tablegrad and scatter_add_tablegrad_t).  It sums
// per-sample table-gradient rows into one level's 2-feature gradient table:
//
//     out[idx[i], f] += upd[i, f]      for i < M, f in {0, 1}
//
// One kernel serves both layouts through strides: updates [M, 2] or [2, M]
// in, table [T, 2] or [2, T] out.  Indices outside [0, T) are dropped (the
// JAX scatter's out-of-bounds rule).
//
// Design.  The TPU kernel keeps one accumulator in VMEM and walks the
// updates in grid order; Hopper blocks run in no order, so here the sum goes
// through fp32 atomics resolved in L2 (`red.global.add.f32`, the return
// value is unused).  A grid-stride loop covers any M, so the TPU's M padding
// and T % 128 rules are gone.  The wrapper zero-fills the output with
// torch.zeros and launches on PyTorch's current stream.
//
// Bound on this card: bytes.  Per launch it must read M x 12 B (int32 index
// + two fp32 values) and write the 2T x 4 B table once; the zero-fill adds
// another 2T x 4 B and every update is one 8-byte atomic round trip in L2.
// At the main path's shapes (M up to 262,144, T up to 2^19) that is a few
// MB, i.e. microseconds at 3.35 TB/s, so launch overhead and atomic
// contention dominate.  Left for later: shared-memory accumulation of the
// dense coarse levels (17^3 rows at SDF level 0 take ~49k updates a step,
// which is heavy same-address contention), float2 vector atomics, and one
// launch for all L levels.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
scatter_add_f2_kernel(const int32_t* __restrict__ idx,
                      const float* __restrict__ upd,
                      int64_t upd_row_stride, int64_t upd_feat_stride,
                      float* __restrict__ out,
                      int64_t out_row_stride, int64_t out_feat_stride,
                      int64_t m, int64_t t) {
  const int64_t stride = (int64_t)blockDim.x * gridDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < m;
       i += stride) {
    const int64_t r = __ldg(idx + i);
    if (r < 0 || r >= t) continue;
    const float v0 = __ldg(upd + i * upd_row_stride);
    const float v1 = __ldg(upd + i * upd_row_stride + upd_feat_stride);
    float* row = out + r * out_row_stride;
    atomicAdd(row, v0);
    atomicAdd(row + out_feat_stride, v1);
  }
}

}  // namespace

extern "C" int hashgrid_scatter_add_f2(const void* idx, const void* upd,
                                       long long upd_row_stride,
                                       long long upd_feat_stride, void* out,
                                       long long out_row_stride,
                                       long long out_feat_stride,
                                       long long m, long long t,
                                       void* stream) {
  if (m <= 0) return 0;
  static int max_blocks = 0;
  if (max_blocks == 0) {
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    // 8 resident blocks of 256 threads fill an SM; two waves of those
    max_blocks = (sms > 0 ? sms : 132) * 16;
  }
  long long blocks = (m + kThreads - 1) / kThreads;
  if (blocks > max_blocks) blocks = max_blocks;
  scatter_add_f2_kernel<<<(unsigned)blocks, kThreads, 0,
                          (cudaStream_t)stream>>>(
      (const int32_t*)idx, (const float*)upd, upd_row_stride, upd_feat_stride,
      (float*)out, out_row_stride, out_feat_stride, m, t);
  return (int)cudaGetLastError();
}
