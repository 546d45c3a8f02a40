// Fused transformer MLP tail for Hopper (sm_90a), bf16 activations:
//
//     xn = LN(x) * lns + lnb                 fp32 statistics, raw E[x^2] - mu^2 variance, eps 1e-6, rounded to bf16
//     a  = bf16(xn . wh + bh)    g = bf16(xn . wg + bg)          fp32 accumulation, fp32 bias
//     h  = bf16(a * gelu_erf(g))                                  exact erf, fp32
//     y  = bf16(h . wo)                                           fp32 accumulation; no bias, no residual
//
// Replaces the TPU kernel clip_codec_tpu/ops/pallas_mlp.py:_mlp_kernel
// (entered there through _mlp_pallas and transformer_mlp). Same contract: the
// caller adds x + y + bo. CUDA has erff, so the TPU kernel's Eigen erf
// polynomial is not carried over.
//
// What bounds it on an H100: three products of 2*C*F FLOP per row (F = 4C)
// against 4*C bytes of x and y per row, far above the card's ~295 bf16
// FLOP/byte ridge, so it is bound by the tensor cores and by what feeds
// them. Unfused, the (rows, F) hidden pair a, g and the product h each make
// a round trip through device memory (at rows = 8192, C = 320: ~100 MB per
// MLP); here the hidden never leaves the block.
//
// Design (mma.sync m16n8k16 tensor cores; no TMA or wgmma yet):
//   * a block owns TM = 16*MT rows and ALL C output columns; the fp32
//     output accumulator (TM x C) lives in registers, split over 10 warps
//     (C/10 columns each) -- TM is chosen per width so that it is 64 floats
//     a thread: 64 rows at C = 320, 32 at 640, 16 at 1280;
//   * the LayerNorm runs once per row tile, into shared memory as bf16;
//   * the hidden axis F is walked in chunks of 160 (16 columns a warp): each
//     warp computes its a and g columns over the full C depth, applies the
//     bias, the roundings and the GELU gate in registers, and writes h to a
//     small shared tile; all warps then multiply that (TM x 160) h tile by
//     the matching 160 rows of wo into their accumulators;
//   * weights are pre-packed on the host (``ops/mlp.py: pack_weights``) in
//     mma fragment order, so each warp reads its B fragments straight from
//     device memory (L2) with one coalesced 16-byte load per lane, no
//     shared-memory staging and no block barrier;
//   * when the row tiles alone would leave most SMs idle (few rows), the
//     hidden chunks are split across blocks (grid y) as far as one wave
//     holds them; each split writes fp32 partial outputs and a second small
//     kernel sums them in a fixed order and rounds to bf16 (deterministic).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 10;
constexpr int THREADS = WARPS * 32;
constexpr int TF = WARPS * 16;  // hidden columns per chunk
constexpr int LDH = TF + 8;     // h tile row stride (bf16): 336 B, ldmatrix conflict-free
constexpr float LN_EPS = 1e-6f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float gelu_erf(float g) {
  return g * 0.5f * (1.0f + erff(g * 0.70710678118654752f));
}

// MT: 16-row m-tiles per block; NP: 16-column output pairs per warp (C = 160 * NP).
template <int MT, int NP>
struct Cfg {
  static constexpr int C = 16 * WARPS * NP;
  static constexpr int TM = 16 * MT;
  static constexpr int LDX = C + 8;  // xn row stride (bf16): an odd multiple of 16 bytes
  static constexpr int SMEM = 2 * (TM * LDX + TM * LDH);
};

// whp, wgp: (F/16, C/16, 32, 8) and wop: (C/16, F/16, 32, 8), bf16 in fragment order.
template <int MT, int NP>
__global__ void __launch_bounds__(THREADS, 1)
mlp_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ lns,
           const float* __restrict__ lnb, const uint4* __restrict__ whp,
           const float* __restrict__ bh, const uint4* __restrict__ wgp,
           const float* __restrict__ bg, const uint4* __restrict__ wop,
           __nv_bfloat16* __restrict__ y, float* __restrict__ part, int R, int F,
           int chunks_per_split) {
  using Q = Cfg<MT, NP>;
  constexpr int C = Q::C, TM = Q::TM, KC = C / 16;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* sX = reinterpret_cast<__nv_bfloat16*>(smem);  // [TM][LDX]
  __nv_bfloat16* sH = sX + TM * Q::LDX;                        // [TM][LDH]

  const int row0 = blockIdx.x * TM, split = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int KF = F / 16;

  // LayerNorm of the row tile (rows past R are zeros: finite, never stored).
  for (int r = warp; r < TM; r += WARPS) {
    const int gr = row0 + r;
    const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)gr * C);
    float sum = 0.0f, sq = 0.0f;
    for (int cv = lane; cv < C / 8; cv += 32) {
      const uint4 raw = gr < R ? __ldg(xr + cv) : make_uint4(0, 0, 0, 0);
      const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(p[e]);
        sum += f.x + f.y;
        sq += f.x * f.x + f.y * f.y;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
      sq += __shfl_xor_sync(0xffffffffu, sq, o);
    }
    const float mu = sum / C;
    const float rs = rsqrtf(sq / C - mu * mu + LN_EPS);
    for (int cv = lane; cv < C / 8; cv += 32) {
      const uint4 raw = gr < R ? __ldg(xr + cv) : make_uint4(0, 0, 0, 0);
      const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
      uint4 outv;
      __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&outv);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(p[e]);
        const int c = cv * 8 + 2 * e;
        o[e] = __floats2bfloat162_rn((f.x - mu) * rs * lns[c] + lnb[c],
                                     (f.y - mu) * rs * lns[c + 1] + lnb[c + 1]);
      }
      *reinterpret_cast<uint4*>(sX + r * Q::LDX + cv * 8) = outv;
    }
  }
  __syncthreads();

  float acc[MT][2 * NP][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < 2 * NP; ++n) acc[m][n][0] = acc[m][n][1] = acc[m][n][2] = acc[m][n][3] = 0.0f;

  const uint32_t x_addr = smem_u32(sX + (lane & 15) * Q::LDX + (lane >> 4) * 8);
  const uint32_t h_addr = smem_u32(sH + (lane & 15) * LDH + (lane >> 4) * 8);
  const int nchunks = F / TF;
  const int c_begin = split * chunks_per_split;
  const int c_end = min(nchunks, c_begin + chunks_per_split);

  for (int ch = c_begin; ch < c_end; ++ch) {
    const int f0 = ch * TF;
    // Phase A: this warp's 16 hidden columns of a and g over the full depth C.
    float a[MT][2][4], gt[MT][2][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) a[m][n][e] = gt[m][n][e] = 0.0f;
    const uint4* wh_w = whp + (size_t)(f0 / 16 + warp) * KC * 32 + lane;
    const uint4* wg_w = wgp + (size_t)(f0 / 16 + warp) * KC * 32 + lane;
#pragma unroll 2
    for (int kt = 0; kt < KC; ++kt) {
      const uint4 bw = __ldg(wh_w + kt * 32);
      const uint4 bv = __ldg(wg_w + kt * 32);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        uint32_t af[4];
        ldsm_x4(x_addr + (m * 16 * Q::LDX + kt * 16) * 2, af);
        mma_bf16(a[m][0], af, bw.x, bw.y);
        mma_bf16(a[m][1], af, bw.z, bw.w);
        mma_bf16(gt[m][0], af, bv.x, bv.y);
        mma_bf16(gt[m][1], af, bv.z, bv.w);
      }
    }
    // Bias, the module path's roundings and the GELU gate; h to shared memory.
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const int fl = warp * 16 + n * 8 + 2 * t;  // column within the chunk
      const float bh0 = bh[f0 + fl], bh1 = bh[f0 + fl + 1];
      const float bg0 = bg[f0 + fl], bg1 = bg[f0 + fl + 1];
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const float a0 = round_bf16(a[m][n][2 * hh] + bh0);
          const float a1 = round_bf16(a[m][n][2 * hh + 1] + bh1);
          const float g0 = round_bf16(gt[m][n][2 * hh] + bg0);
          const float g1 = round_bf16(gt[m][n][2 * hh + 1] + bg1);
          *reinterpret_cast<__nv_bfloat162*>(sH + (m * 16 + g + 8 * hh) * LDH + fl) =
              __floats2bfloat162_rn(a0 * gelu_erf(g0), a1 * gelu_erf(g1));
        }
    }
    __syncthreads();
    // Phase B: acc += h (TM x 160) . wo[f0 : f0 + 160, this warp's columns].
#pragma unroll 2
    for (int kk = 0; kk < TF / 16; ++kk) {
      uint32_t af[MT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m) ldsm_x4(h_addr + (m * 16 * LDH + kk * 16) * 2, af[m]);
#pragma unroll
      for (int j = 0; j < NP; ++j) {
        const uint4 b = __ldg(wop + ((size_t)(warp * NP + j) * KF + f0 / 16 + kk) * 32 + lane);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          mma_bf16(acc[m][2 * j], af[m], b.x, b.y);
          mma_bf16(acc[m][2 * j + 1], af[m], b.z, b.w);
        }
      }
    }
    __syncthreads();  // sH is rewritten by the next chunk
  }

#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = row0 + m * 16 + g + 8 * hh;
      if (row >= R) continue;
#pragma unroll
      for (int n = 0; n < 2 * NP; ++n) {
        const int col = warp * NP * 16 + n * 8 + 2 * t;
        const float v0 = acc[m][n][2 * hh], v1 = acc[m][n][2 * hh + 1];
        if (part == nullptr)
          *reinterpret_cast<__nv_bfloat162*>(y + (size_t)row * C + col) = __floats2bfloat162_rn(v0, v1);
        else
          *reinterpret_cast<float2*>(part + ((size_t)split * R + row) * C + col) = make_float2(v0, v1);
      }
    }
}

// y[i] = bf16(sum over splits of part[s][i]), in split order.
__global__ void sum_splits_kernel(const float* __restrict__ part, __nv_bfloat16* __restrict__ y,
                                  long long n, int splits) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float s = 0.0f;
    for (int k = 0; k < splits; ++k) s += part[k * n + i];
    y[i] = __float2bfloat16(s);
  }
}

typedef void (*KernelFn)(const __nv_bfloat16*, const float*, const float*, const uint4*,
                         const float*, const uint4*, const float*, const uint4*,
                         __nv_bfloat16*, float*, int, int, int);

template <int MT, int NP>
int launch(const void* x, const void* lns, const void* lnb, const void* whp, const void* bh,
           const void* wgp, const void* bg, const void* wop, void* y, void* part, int R, int F,
           int splits, cudaStream_t stream) {
  const KernelFn fn = mlp_kernel<MT, NP>;
  const int smem = Cfg<MT, NP>::SMEM;
  cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int nchunks = F / TF;
  const int cps = (nchunks + splits - 1) / splits;
  const dim3 grid((R + Cfg<MT, NP>::TM - 1) / Cfg<MT, NP>::TM, splits);
  fn<<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(lns),
      static_cast<const float*>(lnb), static_cast<const uint4*>(whp),
      static_cast<const float*>(bh), static_cast<const uint4*>(wgp),
      static_cast<const float*>(bg), static_cast<const uint4*>(wop),
      static_cast<__nv_bfloat16*>(y), static_cast<float*>(part), R, F, cps);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return (int)e;
  const long long n = (long long)R * Cfg<MT, NP>::C;
  const int blocks = (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
  sum_splits_kernel<<<blocks, 256, 0, stream>>>(static_cast<const float*>(part),
                                                static_cast<__nv_bfloat16*>(y), n, splits);
  return (int)cudaGetLastError();
}

int rows_per_block(int C) {
  switch (C) {
    case 320: return 64;
    case 640: return 32;
    case 1280: return 16;
    default: return 0;
  }
}

}  // namespace

// How many blocks share the hidden chunks of one row tile (1: no fp32
// partials): as many as fit in one wave over `sms` SMs, at most one chunk
// each. A block's time is set by its share of the weights it reads from L2,
// so splitting pays only while the blocks run at once; past one wave the
// partials' round trip and the sum kernel cost more (measured on an H100 at
// the SD-1.5 shapes: PERF.md). 0 when (R, C, F) is not supported: C in
// {320, 640, 1280} (SD-1.5's widths), F a positive multiple of 160.
extern "C" int transformer_mlp_splits(int R, int C, int F, int sms) {
  const int tm = rows_per_block(C);
  if (tm == 0 || R <= 0 || F <= 0 || F % TF != 0) return 0;
  const int nchunks = F / TF;
  const int row_blocks = (R + tm - 1) / tm;
  int splits = sms / row_blocks;
  if (splits < 1) splits = 1;
  if (splits > nchunks) splits = nchunks;
  const int cps = (nchunks + splits - 1) / splits;
  return (nchunks + cps - 1) / cps;  // no empty split
}

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// x, y: (R, C) bf16; lns, lnb: (C,) fp32; bh, bg: (F,) fp32; whp, wgp, wop:
// packed bf16 weights (see the kernel); part: (splits, R, C) fp32 scratch,
// or null when splits == 1. splits must be transformer_mlp_splits(...).
extern "C" int transformer_mlp_bf16(const void* x, const void* lns, const void* lnb,
                                    const void* whp, const void* bh, const void* wgp,
                                    const void* bg, const void* wop, void* y, void* part,
                                    int R, int C, int F, int splits, void* stream_) {
  if (R <= 0 || F <= 0 || F % TF != 0 || splits < 1 || (splits > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream_);
  void* p = splits > 1 ? part : nullptr;
  switch (C) {
    case 320: return launch<4, 2>(x, lns, lnb, whp, bh, wgp, bg, wop, y, p, R, F, splits, s);
    case 640: return launch<2, 4>(x, lns, lnb, whp, bh, wgp, bg, wop, y, p, R, F, splits, s);
    case 1280: return launch<1, 8>(x, lns, lnb, whp, bh, wgp, bg, wop, y, p, R, F, splits, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
