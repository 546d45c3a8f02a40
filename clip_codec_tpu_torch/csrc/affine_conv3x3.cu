// Fused ResBlock convolution for Hopper (sm_90a), bf16 NHWC:
//
//     y = conv3x3(act(x * A[b,c] + B[b,c])) + bias (+ add)      act = SiLU or identity
//     mom[b, tile, 0/1, n] = fp32 sum / sum of squares of y over the tile's pixels
//
// Replaces the TPU kernel clip_codec_tpu/ops/pallas_resblock.py:_kernel
// (entered there through affine_silu_conv3x3 and, with linear=True,
// affine_conv3x3). Same contract: the per-(batch, channel) affine and the
// activation run in fp32, taps outside the image are zero AFTER the prologue
// (zero padding of act, not of x), the activation is rounded to bf16 before
// the tensor-core product, and bias, the residual and the moments are taken
// from the fp32 accumulator before the bf16 store.
//
// What bounds it on an H100: at the slice's shapes (Cin = Cout = 128..512) a
// 3x3 conv does 18*Cin FLOP per output element against 2*(Cin+Cout) bytes
// of x and y, i.e. 1000+ FLOP per byte, far above the card's ~295 bf16
// FLOP/byte ridge, so it is bound by the tensor cores and by the work that
// feeds them; the head (Cout = 3) is bound by reading x. The unfused form
// would spend four extra passes over device memory (GN output, SiLU output,
// conv output, residual sum) per conv. The prologue is ALU work on every
// element of the input tile: applied once per tap it outweighs the MMAs,
// so this kernel applies it once per (tile, channel chunk).
//
// Design (mma.sync tensor cores; no TMA, wgmma or persistence yet):
//   * implicit GEMM over a spatial tile of 8 x 16 output pixels of ONE image
//     (M = 128; a block never spans two images, so the moments partials are
//     per image), N = 64 or 128 output channels, K = 9 * Cin walked in
//     32-channel chunks;
//   * per chunk, the block loads the 10 x 18 halo of its tile once, applies
//     the affine + SiLU in registers and stores bf16 to shared memory; all
//     nine taps then read shifted windows of that halo (ldmatrix), so the
//     prologue runs ~1.4x per input element instead of 9x;
//   * the chunk's weights for all nine taps stream in with cp.async into a
//     second buffer while the current chunk computes, and the next chunk's
//     halo loads are in flight during the MMAs (two stages, one barrier per
//     chunk);
//   * the epilogue stages the fp32 accumulators in shared memory, adds bias
//     and the residual with 16-byte loads and stores along channels, and
//     reduces each column in a fixed order, so the moments are deterministic (the
//     wrapper sums the per-tile partials, as the TPU kernel's (B, nH, 2,
//     Cout) partials are summed).
// Cout that is not a multiple of the N tile (the 3-channel head) is masked;
// weights with Cout % 8 != 0 are loaded element by element.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TH = 8, TW = 16, BM = TH * TW;   // output pixels per block
constexpr int HALO_H = TH + 2, HALO_W = TW + 2, HALO_PIX = HALO_H * HALO_W;
constexpr int BK = 32;                         // input channels per chunk
constexpr int LDA = BK + 8;                    // halo row stride (bf16): 80 B, ldmatrix conflict-free
constexpr int THREADS = 256;                   // 8 warps
constexpr int HALO_VECS = HALO_PIX * BK / 8;   // 16-byte vectors per halo
constexpr int HALO_ITERS = (HALO_VECS + THREADS - 1) / THREADS;
constexpr int HALO_BYTES = HALO_PIX * LDA * 2;

template <int BN>
struct Cfg {
  static constexpr int LDB = BN + 8;           // weight row stride (bf16)
  static constexpr int WN = BN / 64;           // warps along N, 64 columns each
  static constexpr int WM = 8 / WN;            // warps along M
  static constexpr int MI = BM / WM / 16;      // 16-pixel rows (one image row each) per warp
  static constexpr int WBUF_BYTES = 9 * BK * LDB * 2;
  static constexpr int W_ITERS = 9 * BK * BN / 8 / THREADS;
  static constexpr int LDC = BN + 4;           // fp32 staging of the accumulators
  static constexpr int VPR = BN / 8;           // epilogue: 8-channel vectors per row
  static constexpr int RPP = THREADS / VPR;    // epilogue: rows per pass
  static constexpr int PASSES = BM / RPP;
  static constexpr int SMEM_FIXED = 2 * HALO_BYTES + 2 * WBUF_BYTES;
  static_assert(9 * BK * BN / 8 % THREADS == 0, "weight chunk split");
  static_assert(BM % RPP == 0, "epilogue passes");
  static_assert(BM * LDC * 4 + 2 * RPP * BN * 4 <= 2 * WBUF_BYTES, "epilogue staging fits");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  const int n = valid ? 16 : 0;  // 0 source bytes: the 16 destination bytes are zeroed
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(n));
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
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

__device__ __forceinline__ uint4 prologue(uint4 raw, const float* scale, const float* shift,
                                          bool linear) {
  const __nv_bfloat162* in = reinterpret_cast<const __nv_bfloat162*>(&raw);
  uint4 out;
  __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(in[e]);
    float a = f.x * scale[2 * e] + shift[2 * e];
    float b = f.y * scale[2 * e + 1] + shift[2 * e + 1];
    if (!linear) {
      a = a / (1.0f + __expf(-a));
      b = b / (1.0f + __expf(-b));
    }
    o[e] = __floats2bfloat162_rn(a, b);
  }
  return out;
}

template <int BN, bool LINEAR, bool HAS_ADD, bool MOMENTS>
__global__ void __launch_bounds__(THREADS, 1)
affine_conv3x3_kernel(const __nv_bfloat16* __restrict__ x,
                      const float* __restrict__ A, const float* __restrict__ Bsh,
                      const __nv_bfloat16* __restrict__ w9,
                      const float* __restrict__ bias,
                      const __nv_bfloat16* __restrict__ add,
                      __nv_bfloat16* __restrict__ y, float* __restrict__ mom,
                      int H, int W, int Cin, int Cout) {
  using C = Cfg<BN>;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* halo = reinterpret_cast<__nv_bfloat16*>(smem);  // [2][HALO_PIX][LDA]
  __nv_bfloat16* wbuf = reinterpret_cast<__nv_bfloat16*>(smem + 2 * HALO_BYTES);  // [2][9*BK][LDB]
  float* sScale = reinterpret_cast<float*>(smem + C::SMEM_FIXED);  // [Cin]
  float* sShift = sScale + Cin;                                    // [Cin]
  float* stage = reinterpret_cast<float*>(smem + 2 * HALO_BYTES);  // [BM][LDC], after the K loop
  float* mstage = stage + BM * C::LDC;                             // [2][RPP][BN]

  const int tilesW = (W + TW - 1) / TW;
  const int h0 = (blockIdx.x / tilesW) * TH, w0 = (blockIdx.x % tilesW) * TW;
  const int n0 = blockIdx.y * BN, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp % C::WM, wn = warp / C::WM;
  const bool vecW = (Cout % 8) == 0;

  for (int c = tid; c < Cin; c += THREADS) {
    sScale[c] = A[(size_t)b * Cin + c];
    sShift[c] = Bsh[(size_t)b * Cin + c];
  }

  // Halo vectors of this thread: all share channel vector cv (THREADS % 4 == 0).
  const __nv_bfloat16* xb = x + (size_t)b * H * W * Cin;
  const int cv = tid % (BK / 8);
  long long hsrc[HALO_ITERS];  // element offset in xb without the chunk's c0; -1: outside the image
  int hdst[HALO_ITERS];        // element offset in a halo buffer; -1: no vector
#pragma unroll
  for (int i = 0; i < HALO_ITERS; ++i) {
    const int v = tid + i * THREADS;
    hdst[i] = -1;
    hsrc[i] = -1;
    if (v < HALO_VECS) {
      const int hp = v / (BK / 8);
      const int h = h0 - 1 + hp / HALO_W, w = w0 - 1 + hp % HALO_W;
      hdst[i] = hp * LDA + cv * 8;
      if (h >= 0 && h < H && w >= 0 && w < W) hsrc[i] = ((long long)h * W + w) * Cin + cv * 8;
    }
  }
  uint4 raw[HALO_ITERS];

  auto load_halo = [&](int c0) {
#pragma unroll
    for (int i = 0; i < HALO_ITERS; ++i)
      raw[i] = hsrc[i] >= 0 ? __ldg(reinterpret_cast<const uint4*>(xb + hsrc[i] + c0))
                            : make_uint4(0, 0, 0, 0);
  };
  auto store_halo = [&](int s, int c0) {
    __nv_bfloat16* hb = halo + s * HALO_PIX * LDA;
#pragma unroll
    for (int i = 0; i < HALO_ITERS; ++i)
      if (hdst[i] >= 0)
        *reinterpret_cast<uint4*>(hb + hdst[i]) =
            hsrc[i] >= 0 ? prologue(raw[i], sScale + c0 + cv * 8, sShift + c0 + cv * 8, LINEAR)
                         : make_uint4(0, 0, 0, 0);
  };
  auto load_weights = [&](int s, int c0) {
    __nv_bfloat16* wb = wbuf + s * 9 * BK * C::LDB;
#pragma unroll
    for (int it = 0; it < C::W_ITERS; ++it) {
      const int v = tid + it * THREADS;
      const int row = v / (BN / 8), n = n0 + (v % (BN / 8)) * 8;  // row = tap * BK + k
      const int tap = row / BK, k = row % BK;
      const __nv_bfloat16* src = w9 + ((size_t)tap * Cin + c0 + k) * Cout + n;
      __nv_bfloat16* dst = wb + row * C::LDB + (v % (BN / 8)) * 8;
      if (vecW) {
        cp_async16(smem_u32(dst), n < Cout ? src : w9, n < Cout);
      } else {
#pragma unroll
        for (int q = 0; q < 8; ++q) dst[q] = n + q < Cout ? src[q] : __float2bfloat16(0.0f);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  float acc[C::MI][8][4];
#pragma unroll
  for (int i = 0; i < C::MI; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  const int KC = Cin / BK;
  load_weights(0, 0);
  load_halo(0);
  __syncthreads();  // sScale / sShift ready
  store_halo(0, 0);
  for (int c = 0; c < KC; ++c) {
    const int s = c & 1;
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();  // chunk c's halo and weights visible; chunk c-1's reads done
    if (c + 1 < KC) {
      load_weights(s ^ 1, (c + 1) * BK);
      load_halo((c + 1) * BK);
    }
    const uint32_t hbase = smem_u32(halo + s * HALO_PIX * LDA);
    const uint32_t wbase = smem_u32(wbuf + s * 9 * BK * C::LDB);
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        uint32_t a[C::MI][4];
#pragma unroll
        for (int i = 0; i < C::MI; ++i) {
          const int pix = (wm * C::MI + i + dy) * HALO_W + (lane & 15) + dx;
          ldsm_x4(hbase + (pix * LDA + kk + (lane >> 4) * 8) * 2, a[i]);
        }
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          uint32_t bf[4];
          const int row = tap * BK + kk + (lane & 15);
          const int col = wn * 64 + jj * 16 + (lane >> 4) * 8;
          ldsm_x4_trans(wbase + (row * C::LDB + col) * 2, bf);
#pragma unroll
          for (int i = 0; i < C::MI; ++i) {
            mma_bf16(acc[i][2 * jj], a[i], bf[0], bf[1]);
            mma_bf16(acc[i][2 * jj + 1], a[i], bf[2], bf[3]);
          }
        }
      }
    }
    if (c + 1 < KC) store_halo(s ^ 1, (c + 1) * BK);
  }
  __syncthreads();  // every warp is done with the weight buffers the staging reuses

  // Epilogue: stage the accumulators, then thread t owns the 8 channels
  // 8 * (t % VPR) .. + 7 of rows t / VPR, + RPP, ... (16-byte loads/stores).
#pragma unroll
  for (int i = 0; i < C::MI; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int m = (wm * C::MI + i) * 16 + (lane >> 2);
      const int n = wn * 64 + j * 8 + 2 * (lane & 3);
      *reinterpret_cast<float2*>(stage + m * C::LDC + n) = make_float2(acc[i][j][0], acc[i][j][1]);
      *reinterpret_cast<float2*>(stage + (m + 8) * C::LDC + n) =
          make_float2(acc[i][j][2], acc[i][j][3]);
    }
  __syncthreads();
  const int col = (tid % C::VPR) * 8, r0 = tid / C::VPR, n = n0 + col;
  float bv[8], s[8], ss[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    bv[e] = n + e < Cout ? bias[n + e] : 0.0f;
    s[e] = 0.0f;
    ss[e] = 0.0f;
  }
#pragma unroll
  for (int p = 0; p < C::PASSES; ++p) {
    const int m = r0 + p * C::RPP;
    const int h = h0 + m / TW, w = w0 + m % TW;
    if (n < Cout && h < H && w < W) {
      const size_t o = (((size_t)b * H + h) * W + w) * Cout + n;
      const float4 lo = *reinterpret_cast<const float4*>(stage + m * C::LDC + col);
      const float4 hi = *reinterpret_cast<const float4*>(stage + m * C::LDC + col + 4);
      float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
      if (vecW) {
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] += bv[e];
        if (HAS_ADD) {
          const uint4 a = *reinterpret_cast<const uint4*>(add + o);
          const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 f = __bfloat1622float2(a2[e]);
            v[2 * e] += f.x;
            v[2 * e + 1] += f.y;
          }
        }
        uint4 out;
        __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
        for (int e = 0; e < 4; ++e) o2[e] = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
        *reinterpret_cast<uint4*>(y + o) = out;
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (n + e < Cout) {
            v[e] += bv[e];
            if (HAS_ADD) v[e] += __bfloat162float(add[o + e]);
            y[o + e] = __float2bfloat16(v[e]);
          }
      }
      if (MOMENTS) {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (n + e < Cout) {
            s[e] += v[e];
            ss[e] += v[e] * v[e];
          }
      }
    }
  }
  if (MOMENTS) {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      mstage[r0 * BN + col + e] = s[e];
      mstage[(C::RPP + r0) * BN + col + e] = ss[e];
    }
    __syncthreads();
    if (tid < BN && n0 + tid < Cout) {
      float ts = 0.0f, tss = 0.0f;
#pragma unroll
      for (int r = 0; r < C::RPP; ++r) {
        ts += mstage[r * BN + tid];
        tss += mstage[(C::RPP + r) * BN + tid];
      }
      float* out = mom + ((size_t)b * gridDim.x + blockIdx.x) * 2 * Cout + n0 + tid;
      out[0] = ts;
      out[Cout] = tss;
    }
  }
}

typedef void (*KernelFn)(const __nv_bfloat16*, const float*, const float*,
                         const __nv_bfloat16*, const float*, const __nv_bfloat16*,
                         __nv_bfloat16*, float*, int, int, int, int);

template <int BN>
KernelFn select(int linear, bool has_add, bool moments) {
  static const KernelFn table[8] = {
      affine_conv3x3_kernel<BN, false, false, false>, affine_conv3x3_kernel<BN, false, false, true>,
      affine_conv3x3_kernel<BN, false, true, false>,  affine_conv3x3_kernel<BN, false, true, true>,
      affine_conv3x3_kernel<BN, true, false, false>,  affine_conv3x3_kernel<BN, true, false, true>,
      affine_conv3x3_kernel<BN, true, true, false>,   affine_conv3x3_kernel<BN, true, true, true>,
  };
  return table[(linear ? 4 : 0) + (has_add ? 2 : 0) + (moments ? 1 : 0)];
}

}  // namespace

// Tiles per image: the moments partials are (B, tiles, 2, Cout).
extern "C" int affine_conv3x3_tiles(int H, int W) {
  return ((H + TH - 1) / TH) * ((W + TW - 1) / TW);
}

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// Pointers are device pointers; add and mom may be null. x, w9, add and y are
// bf16; A, B (batch, Cin), bias and mom are fp32. Cin must be a multiple of 32.
extern "C" int affine_conv3x3_bf16(const void* x, const void* A, const void* B,
                                   const void* w9, const void* bias, const void* add,
                                   void* y, void* mom, int batch, int H, int W,
                                   int Cin, int Cout, int linear, void* stream) {
  if (Cin % BK != 0 || Cin <= 0 || Cout <= 0 || H <= 0 || W <= 0 || batch <= 0)
    return (int)cudaErrorInvalidValue;
  const bool wide = Cout > 64;
  const int bn = wide ? 128 : 64;
  const KernelFn fn = wide ? select<128>(linear, add, mom) : select<64>(linear, add, mom);
  const size_t smem = (wide ? Cfg<128>::SMEM_FIXED : Cfg<64>::SMEM_FIXED) +
                      2 * (size_t)Cin * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(affine_conv3x3_tiles(H, W), (Cout + bn - 1) / bn, batch);
  fn<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(A),
      static_cast<const float*>(B), static_cast<const __nv_bfloat16*>(w9),
      static_cast<const float*>(bias), static_cast<const __nv_bfloat16*>(add),
      static_cast<__nv_bfloat16*>(y), static_cast<float*>(mom), H, W, Cin, Cout);
  return (int)cudaGetLastError();
}
