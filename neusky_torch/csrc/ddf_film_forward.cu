// ddf_film_forward — the DDF visibility query's whole FiLM-SIREN forward in
// one launch, hand-written for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves this query to XLA
// (neusky_tpu/fields/ddf.py, neusky_tpu/nets/siren.py::FiLMSiren).  In plain
// PyTorch it is some twenty launches a chunk whose [M, 2·F·256] mapping head
// and every [M, 256] activation go through device memory.  Per query row:
//
//   pos = [o, nerf(o)], dir = [d, nerf(d)]          15 values each (NeRF, 2 freqs)
//   x   = leaky_relu(x W_l + b_l, 0.2)              l < L mapping layers, fp32
//   f_i = x K_out[:, i·256 :] + c_i                 frequency head of FiLM layer i
//   p_i = x K_out[:, F·256 + i·256 :] + c'_i        phase head
//   h   = sin((15 f_i + 30) · (bf16(h) @ bf16(V_i) + v_i) + p_i)    i < F
//   out = scale · sigmoid(h · u + u_0)
//
// with h = dir before the first FiLM layer.  Only ``out`` [M] reaches device
// memory.
//
// Precision is the plain path's, and the products' summation order too:
//  - the mapping products (x W, x K_out) are IEEE fp32 FMA on the CUDA cores,
//    each output summed over k in order from 0 (a SIMT GEMM's order; no TF32,
//    no split products);
//  - the FiLM products are bf16 x bf16 -> fp32 on the tensor cores
//    (mma.sync m16n8k16, k in order), their inputs rounded to nearest even;
//  - the elementwise tail is torch's: __fmul_rn / __fadd_rn one operation at a
//    time (no contraction), precise sinf and expf (built without fast math:
//    the sine's arguments reach |45|).
//  The 256 -> 1 output product is summed in another order than cuBLAS's.
//
// Bound on this card: fp32 FMA.  A row takes 15·256 + (L−1)·256² + 256·2F·256
// FMAs of the mapping network (0.921 M at L = F = 5) on 132 SMs x 128 lanes,
// and 256·(15 + (F−1)·256) bf16 MACs (0.266 M) on the tensor cores; it reads
// 24 B and writes 4 B.
//
// Design:
//  - A persistent grid, one 256-thread block per SM, walks tiles of 64 rows.
//    A tile's activations live in shared memory: the mapping activation x
//    transposed (fp32 [256][64]), the FiLM layer's product (fp32 [64][256])
//    and its bf16 input h ([64][256]).  x stays for every FiLM layer, whose
//    frequency and phase heads are computed from it 256 columns at a time.
//  - Every weight reaches shared memory through one ring of three 16 KB
//    stages filled by cp.async.  The wrapper packs the weights into 16 KB
//    chunks in exactly the order a tile consumes them, so the producer only
//    streams chunk after chunk (wrapping at each tile) and runs two chunks
//    ahead of the consumer; one __syncthreads a chunk hands a stage over.
//  - fp32 products: each thread owns 8 rows x 8 columns (two groups of 4
//    columns, 128 apart), reads 2 + 2 float4 a k step for 64 FFMAs; a warp
//    spans 4 row groups x 8 column groups, so its loads are one wavefront
//    each.
//  - bf16 products: each warp owns 32 columns of all 64 rows, A fragments by
//    ldmatrix from h, B fragments packed by the wrapper in mma lane order.
//  - The heads' elementwise tail is applied in the fp32 layout: 15 f + 30
//    times the FiLM product is kept in place of that product until the phase
//    head is done, so no more than 64 accumulators are live at once.
// No launch falls back: a refused launch returns its cudaError.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;     // rows a tile
constexpr int kWidth = 256;   // FiLM and mapping width
constexpr int kThreads = 256;
constexpr int kStages = 3;
constexpr int kChunk = 16384;        // bytes a weight chunk
constexpr int kChunkK = 16;          // fp32 weight rows a chunk
constexpr int kEnc = 15;             // [v, NeRF(v)] of a 3-vector
constexpr int kXS = kRows + 4;       // row stride of x^T (floats)
constexpr int kLS = kWidth + 4;      // row stride of the FiLM product (floats)
constexpr int kHS = kWidth + 8;      // row stride of h (bf16)
constexpr int kRingBytes = kStages * kChunk;
constexpr int kXBytes = kWidth * kXS * 4;
constexpr int kLinBytes = kRows * kLS * 4;
constexpr int kHBytes = kRows * kHS * 2;
constexpr int kRedBytes = 4 * kRows * 4;
constexpr int kSmem = kRingBytes + kXBytes + kLinBytes + kHBytes + kRedBytes;
static_assert(kSmem <= 232448, "shared memory of one block");
static_assert(kChunkK * kXS * 4 <= kLinBytes, "the position encoding fits the FiLM product's buffer");

// torch's roundings of the scalars 2*pi and pi/2 (a CUDA float tensor times a
// Python float multiplies by the float nearest it)
constexpr float kTwoPi = 6.28318548202514648f;
constexpr float kHalfPi = 1.57079637050628662f;

struct Params {
  const float* origins;  // [M, 3]
  const float* dirs;     // [M, 3], local
  const char* packed;    // chunks, in a tile's order
  const float* biases;   // mapping [L][256], heads [2F·256], FiLM [F][256], output [256], [1]
  float* out;            // [M]
  long long m;
  long long tiles;
  int chunks;            // a tile's
  int nm, nf;            // mapping and FiLM layers
  float scale;           // 2 · ddf_radius
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

// The weight ring: chunk g of this block sits in stage g % kStages.
struct Ring {
  char* base;
  const char* src;
  long long fetched, total, g;
  int chunks;

  __device__ void fetch() {
    if (fetched < total) {
      const char* s = src + (long long)(fetched % chunks) * kChunk;
      char* d = base + (int)(fetched % kStages) * kChunk;
#pragma unroll
      for (int i = 0; i < kChunk / 16 / kThreads; ++i) {
        const int o = 16 * (threadIdx.x + i * kThreads);
        cp_async16(d + o, s + o);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    ++fetched;
  }

  // Wait for chunk g, hand the stage of chunk g - 1 to chunk g + 2.
  __device__ const char* acquire() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2) : "memory");
    __syncthreads();
    fetch();
    return base + (int)(g++ % kStages) * kChunk;
  }
};

__device__ __forceinline__ void zero(float (&acc)[8][8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
}

// column of a thread's j-th accumulator
__device__ __forceinline__ int col(int cg, int j) { return (j < 4 ? 0 : 128 - 4) + cg * 4 + j; }

// acc[i][j] += sum_k a[k][rg·8 + i] · w[k][col(j)], k = 0 .. K−1 in order
template <int K>
__device__ __forceinline__ void ffma_chunk(float (&acc)[8][8], const float* a, const float* w, int rg, int cg) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const float4 a0 = *reinterpret_cast<const float4*>(a + k * kXS + rg * 8);
    const float4 a1 = *reinterpret_cast<const float4*>(a + k * kXS + rg * 8 + 4);
    const float4 b0 = *reinterpret_cast<const float4*>(w + k * kWidth + cg * 4);
    const float4 b1 = *reinterpret_cast<const float4*>(w + k * kWidth + 128 + cg * 4);
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// 16 chunks of a 256-deep fp32 product from x^T
__device__ __forceinline__ void ffma_layer(float (&acc)[8][8], Ring& ring, const float* xt, int rg, int cg) {
  zero(acc);
  for (int c = 0; c < kWidth / kChunkK; ++c) {
    const float* w = reinterpret_cast<const float*>(ring.acquire());
    ffma_chunk<kChunkK>(acc, xt + c * kChunkK * kXS, w, rg, cg);
  }
}

// x^T[col][row] = leaky_relu(acc + b, 0.2), once every thread has read x^T
__device__ __forceinline__ void mapping_out(const float (&acc)[8][8], float* xt, const float* b, int rg, int cg) {
  __syncthreads();
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = col(cg, j);
    const float bj = __ldg(b + c);
    float v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float y = __fadd_rn(acc[i][j], bj);
      v[i] = y > 0.f ? y : __fmul_rn(y, 0.2f);
    }
    *reinterpret_cast<float4*>(xt + c * kXS + rg * 8) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(xt + c * kXS + rg * 8 + 4) = make_float4(v[4], v[5], v[6], v[7]);
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One 16-deep step of the FiLM product for this warp's 32 columns: k tile kt
// of h against the chunk's k tile ktl (packed [kt][32 n tiles][32 lanes][4]).
__device__ __forceinline__ void mma_ktile(float (&c)[4][4][4], const __nv_bfloat16* h, int kt, const char* stage,
                                          int ktl, int warp, int lane) {
  uint32_t a[4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
    const int r = mt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
    ldmatrix_x4(a[mt], h + r * kHS + kt * 16 + (lane >> 4) * 8);
  }
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const uint2 b = *reinterpret_cast<const uint2*>(stage + (((ktl * 32) + warp * 4 + nt) * 32 + lane) * 8);
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) mma_bf16(c[mt][nt], a[mt], b.x, b.y);
  }
}

// [v, sin(2πv), sin(8πv), sin(2πv + π/2), sin(8πv + π/2)] per component, as
// ops/encodings.py::nerf_encoding rounds it on the card
__device__ __forceinline__ void nerf(const float (&v)[3], float (&e)[kEnc]) {
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    e[d] = v[d];
    const float s0 = __fmul_rn(v[d], kTwoPi);
    const float s1 = __fmul_rn(s0, 4.f);
    e[3 + 4 * d + 0] = sinf(s0);
    e[3 + 4 * d + 1] = sinf(s1);
    e[3 + 4 * d + 2] = sinf(__fadd_rn(s0, kHalfPi));
    e[3 + 4 * d + 3] = sinf(__fadd_rn(s1, kHalfPi));
  }
}

__global__ void __launch_bounds__(kThreads, 1) ddf_film_forward_kernel(const Params p) {
  extern __shared__ __align__(16) char smem[];
  float* xt = reinterpret_cast<float*>(smem + kRingBytes);                          // [256][kXS]
  float* lin = reinterpret_cast<float*>(smem + kRingBytes + kXBytes);               // [64][kLS]
  __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(smem + kRingBytes + kXBytes + kLinBytes);  // [64][kHS]
  float* red = reinterpret_cast<float*>(smem + kRingBytes + kXBytes + kLinBytes + kHBytes);      // [4][64]
  float* pt = lin;  // the position encoding, transposed [16][kXS], before the first FiLM layer

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rg = (warp >> 2) * 4 + (lane >> 3);  // row group: rows rg·8 .. +8
  const int cg = (warp & 3) * 8 + (lane & 7);    // column group: col(cg, 0 .. 7)
  const float* map_b = p.biases;
  const float* head_b = map_b + p.nm * kWidth;
  const float* film_b = head_b + 2 * p.nf * kWidth;
  const float* out_w = film_b + p.nf * kWidth;
  const float out_b = __ldg(out_w + kWidth);

  const long long my_tiles = (p.tiles - blockIdx.x + gridDim.x - 1) / gridDim.x;
  Ring ring{smem, p.packed, 0, my_tiles * p.chunks, 0, p.chunks};
  for (int s = 0; s < kStages - 1; ++s) ring.fetch();

  float acc[8][8];
  for (long long tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
    const long long row0 = tile * kRows;
    __syncthreads();  // the last tile's reads of every buffer are done
    if (tid < 2 * kRows) {
      const int r = tid & (kRows - 1);
      const long long row = row0 + r;
      const float* src = tid < kRows ? p.origins : p.dirs;
      float v[3] = {0.f, 0.f, 0.f}, e[kEnc];
      if (row < p.m) {
#pragma unroll
        for (int d = 0; d < 3; ++d) v[d] = __ldg(src + row * 3 + d);
      }
      nerf(v, e);
      if (tid < kRows) {
#pragma unroll
        for (int k = 0; k < kEnc; ++k) pt[k * kXS + r] = e[k];
        pt[kEnc * kXS + r] = 0.f;
      } else {
#pragma unroll
        for (int k = 0; k < kEnc; ++k) h[r * kHS + k] = __float2bfloat16_rn(e[k]);
        h[r * kHS + kEnc] = __float2bfloat16_rn(0.f);
      }
    }

    // the mapping network
    zero(acc);
    ffma_chunk<kEnc>(acc, pt, reinterpret_cast<const float*>(ring.acquire()), rg, cg);
    mapping_out(acc, xt, map_b, rg, cg);
    for (int l = 1; l < p.nm; ++l) {
      ffma_layer(acc, ring, xt, rg, cg);
      mapping_out(acc, xt, map_b + l * kWidth, rg, cg);
    }

    // the FiLM layers
    for (int i = 0; i < p.nf; ++i) {
      {
        float c[4][4][4];
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int q = 0; q < 4; ++q) c[mt][nt][q] = 0.f;
        if (i == 0) {
          mma_ktile(c, h, 0, ring.acquire(), 0, warp, lane);
        } else {
          for (int ch = 0; ch < kWidth / 32; ++ch) {
            const char* st = ring.acquire();
            mma_ktile(c, h, 2 * ch, st, 0, warp, lane);
            mma_ktile(c, h, 2 * ch + 1, st, 1, warp, lane);
          }
        }
        // lin = product + v_i, in [row][col]
        const float* vb = film_b + i * kWidth;
        const int g = lane >> 2, t = lane & 3;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int cc = warp * 32 + nt * 8 + 2 * t;
          const float b0 = __ldg(vb + cc), b1 = __ldg(vb + cc + 1);
#pragma unroll
          for (int mt = 0; mt < 4; ++mt) {
            const int r = mt * 16 + g;
            *reinterpret_cast<float2*>(lin + r * kLS + cc) =
                make_float2(__fadd_rn(c[mt][nt][0], b0), __fadd_rn(c[mt][nt][1], b1));
            *reinterpret_cast<float2*>(lin + (r + 8) * kLS + cc) =
                make_float2(__fadd_rn(c[mt][nt][2], b0), __fadd_rn(c[mt][nt][3], b1));
          }
        }
      }

      // frequencies: lin <- (15 f + 30) · lin
      ffma_layer(acc, ring, xt, rg, cg);
      const float* fb = head_b + i * kWidth;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int c0 = half * 128 + cg * 4;
        const float4 bq = __ldg(reinterpret_cast<const float4*>(fb + c0));
        const float bv[4] = {bq.x, bq.y, bq.z, bq.w};
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          float4* lp = reinterpret_cast<float4*>(lin + (rg * 8 + r) * kLS + c0);
          float4 l = *lp;
          float* lv = reinterpret_cast<float*>(&l);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float f = __fadd_rn(acc[r][half * 4 + q], bv[q]);
            lv[q] = __fmul_rn(__fadd_rn(__fmul_rn(f, 15.f), 30.f), lv[q]);
          }
          *lp = l;
        }
      }

      // phases: h = sin(lin + p)
      ffma_layer(acc, ring, xt, rg, cg);
      const float* pb = head_b + (p.nf + i) * kWidth;
      const bool last = i == p.nf - 1;
      float part[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int c0 = half * 128 + cg * 4;
        const float4 bq = __ldg(reinterpret_cast<const float4*>(pb + c0));
        const float bv[4] = {bq.x, bq.y, bq.z, bq.w};
        const float4 uq = __ldg(reinterpret_cast<const float4*>(out_w + c0));
        const float uv[4] = {uq.x, uq.y, uq.z, uq.w};
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const float4 l = *reinterpret_cast<const float4*>(lin + (rg * 8 + r) * kLS + c0);
          const float lv[4] = {l.x, l.y, l.z, l.w};
          float hv[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) hv[q] = sinf(__fadd_rn(lv[q], __fadd_rn(acc[r][half * 4 + q], bv[q])));
          if (last) {
#pragma unroll
            for (int q = 0; q < 4; ++q) part[r] = fmaf(hv[q], uv[q], part[r]);
          } else {
            __nv_bfloat162 lo = __floats2bfloat162_rn(hv[0], hv[1]);
            __nv_bfloat162 hi = __floats2bfloat162_rn(hv[2], hv[3]);
            uint2 pk;
            pk.x = *reinterpret_cast<uint32_t*>(&lo);
            pk.y = *reinterpret_cast<uint32_t*>(&hi);
            *reinterpret_cast<uint2*>(h + (rg * 8 + r) * kHS + c0) = pk;
          }
        }
      }
      if (last) {
        // the output layer: the 8 column groups of a warp's row group, then
        // the 4 warps that share its rows
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          float v = part[r];
          v += __shfl_xor_sync(0xFFFFFFFFu, v, 1);
          v += __shfl_xor_sync(0xFFFFFFFFu, v, 2);
          v += __shfl_xor_sync(0xFFFFFFFFu, v, 4);
          if ((lane & 7) == 0) red[(warp & 3) * kRows + rg * 8 + r] = v;
        }
        __syncthreads();
        if (tid < kRows) {
          const float raw = __fadd_rn(
              __fadd_rn(__fadd_rn(__fadd_rn(red[tid], red[kRows + tid]), red[2 * kRows + tid]), red[3 * kRows + tid]),
              out_b);
          const float s = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-raw)));
          const long long row = row0 + tid;
          if (row < p.m) p.out[row] = __fmul_rn(s, p.scale);
        }
      }
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

}  // namespace

// origins, dirs: fp32 [m, 3] contiguous; packed: the wrapper's chunks (chunks
// a tile); biases: fp32 as Params says; out: fp32 [m].  nm, nf >= 1.
extern "C" int ddf_film_forward(const void* origins, const void* dirs, const void* packed, const void* biases,
                                void* out, long long m, int chunks, int nm, int nf, float scale, void* stream) {
  if (m <= 0 || nm < 1 || nf < 1) return (int)cudaErrorInvalidValue;
  if (chunks != 1 + 16 * (nm - 1) + 1 + 32 + (nf - 1) * (8 + 32)) return (int)cudaErrorInvalidValue;
  // the shared-memory attribute holds for one device: set it, and read the SM
  // count, once a device
  constexpr int kMaxDevices = 64;
  static int sms_of[kMaxDevices] = {};
  cudaError_t e;
  int dev = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  int& sms = sms_of[dev];
  if (sms == 0) {
    if ((e = cudaFuncSetAttribute(ddf_film_forward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem)) !=
        cudaSuccess)
      return (int)e;
    int n = 0;
    if ((e = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return (int)e;
    sms = n;
  }
  Params p;
  p.origins = (const float*)origins;
  p.dirs = (const float*)dirs;
  p.packed = (const char*)packed;
  p.biases = (const float*)biases;
  p.out = (float*)out;
  p.m = m;
  p.tiles = (m + kRows - 1) / kRows;
  p.chunks = chunks;
  p.nm = nm;
  p.nf = nf;
  p.scale = scale;
  const unsigned blocks = (unsigned)(p.tiles < sms ? p.tiles : sms);
  ddf_film_forward_kernel<<<blocks, kThreads, kSmem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
