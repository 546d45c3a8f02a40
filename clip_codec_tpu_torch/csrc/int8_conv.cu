// int8 serving convolutions for Hopper (sm_90a): an implicit-GEMM int8
// convolution on the tensor cores and the two passes that make its activation
// codes.
//
//   int8_conv_nhwc: y[b, ho, wo, o] = epilogue(sum_{r, c, i} xq[b, ho*s-p+r, wo*s-p+c, i] * wq[o, r, c, i])
//       xq (B, H, W, Cin) int8 NHWC, wq (Cout, kh, kw, Cin) int8 (K-contiguous),
//       int32 accumulation; the epilogue is the JAX package's,
//       float(acc) * (w_scale[o] * s), then + bias[o], then the cast to bf16
//       or fp32 (or, for checks, the raw int32 accumulator). kh = kw in {1, 3},
//       stride in {1, 2}, symmetric zero padding; a Linear is the 1x1 case over
//       (M, 1, 1, K) rows.
//   int8_quantize: xq = clamp(rint(x / s), -127, 127), s = max(absmax, 1e-12) / 127,
//       x bf16 or fp32; also writes s for the conv to read.
//   absmax: max |x| over a whole tensor into one fp32 device scalar.
//
// Counterparts of XLA programs, not of Pallas kernels: clip_codec_tpu/ops/int8.py's
// dynamic_int8_conv / static_int8_conv (:51, :80) and Int8Dense (:164) run
// lax.conv_general_dilated / dot_general on int8 operands with
// preferred_element_type=int32, which XLA lowers itself. PyTorch has no int8
// convolution on CUDA, so the port needs its own.
//
// What bounds it on an H100: at the pixel decoder's hottest shape, (16, 256^2,
// 128 -> 128) 3x3, the product is 3.1e11 integer operations, 0.16 ms at 1,979
// dense int8 TOP/s, against 0.13 ms for its 134 MB of codes in and 268 MB of
// bf16 out at 3.35 TB/s: the tensor cores bound it, barely. The quantize and
// absmax passes are bytes-bound elementwise work. This first version is simple
// and right: mma.sync.m16n8k32 (not wgmma), tiles from shared memory through a
// four-stage cp.async ring, no TMA, and the quantization is a separate pass.
//
// The design:
//   * A block computes a 128 x 128 tile of (output pixels) x (Cout) with 8
//     warps (2 along M, 4 along N), each 64 x 32: 4 x 4 mma tiles, 64 int32
//     accumulators a thread.
//   * The K loop walks 32 bytes of K at a time; Cin % 32 == 0, so a step stays
//     inside one (r, c) tap, and a tile row is 32 contiguous bytes of one input
//     pixel, copied with two 16-byte cp.async. A row whose input pixel lies in
//     the padding halo (or past M) is zero-filled by the copy (src-size 0), so
//     padding is read as 0 and never stored anywhere.
//   * The two 16-byte halves of a row are swapped in shared memory on every
//     other group of four rows, so the 32-bit fragment reads of a warp hit 32
//     distinct banks.
//   * The epilogue rounds as the plain version does: __int2float_rn,
//     __fmul_rn(w_scale[o], s), __fmul_rn, __fadd_rn (so nvcc's default FMA
//     contraction cannot fuse two roundings), __float2bfloat16_rn.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128, kBN = 128, kBK = 32, kStages = 4, kThreads = 256;
constexpr int kTileBytes = kBM * kBK;  // A and B tiles are the same size
constexpr int kSmemBytes = kStages * 2 * kTileBytes;

enum OutKind { kOutBf16 = 0, kOutF32 = 1, kOutI32 = 2 };

struct ConvParams {
  const int8_t* x;        // (B, H, W, Cin)
  const int8_t* w;        // (Cout, KH, KW, Cin)
  const float* w_scale;   // (Cout,)
  const float* s;         // () activation scale
  const float* bias;      // (Cout,) or null
  void* y;                // (B, Ho, Wo, Cout)
  int B, H, W, Cin, Cout, KH, KW, stride, pad, Ho, Wo;
  long long M;            // B * Ho * Wo
  int K;                  // KH * KW * Cin
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Byte offset of 16-byte half h of tile row r: the halves swap on every other
// group of four rows.
__device__ __forceinline__ int swz(int r, int h) { return r * kBK + ((h ^ ((r >> 2) & 1)) << 4); }

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int OUT>
__device__ __forceinline__ void store_pair(const ConvParams& p, long long m, int n, int a0, int a1, float sc0,
                                           float sc1, float b0, float b1) {
  const long long off = m * p.Cout + n;
  if (OUT == kOutI32) {
    *reinterpret_cast<int2*>(static_cast<int*>(p.y) + off) = make_int2(a0, a1);
    return;
  }
  float y0 = __fmul_rn(__int2float_rn(a0), sc0), y1 = __fmul_rn(__int2float_rn(a1), sc1);
  if (p.bias) {
    y0 = __fadd_rn(y0, b0);
    y1 = __fadd_rn(y1, b1);
  }
  if (OUT == kOutF32) {
    *reinterpret_cast<float2*>(static_cast<float*>(p.y) + off) = make_float2(y0, y1);
  } else {
    __nv_bfloat162 v;
    v.x = __float2bfloat16_rn(y0);
    v.y = __float2bfloat16_rn(y1);
    *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(p.y) + off) = v;
  }
}

template <int OUT>
__global__ void __launch_bounds__(kThreads) int8_conv_kernel(const ConvParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long m0 = static_cast<long long>(blockIdx.x) * kBM;
  const int n0 = blockIdx.y * kBN;

  // The row of each tile this thread copies (both tiles: 128 rows x 2 halves = 256 copies).
  const int lr = tid >> 1, lh = tid & 1;
  const long long am = m0 + lr;
  const bool a_row = am < p.M;
  int ab = 0, hi0 = 0, wi0 = 0;
  if (a_row) {
    const long long hw = static_cast<long long>(p.Ho) * p.Wo;
    ab = static_cast<int>(am / hw);
    const int rem = static_cast<int>(am - static_cast<long long>(ab) * hw);
    hi0 = (rem / p.Wo) * p.stride - p.pad;
    wi0 = (rem % p.Wo) * p.stride - p.pad;
  }
  const int bn = n0 + lr;
  const bool b_row = bn < p.Cout;
  const int8_t* wrow = p.w + static_cast<long long>(b_row ? bn : 0) * p.K + lh * 16;
  const int ksteps = p.K / kBK;

  auto load = [&](int kt, int stage) {
    const int k0 = kt * kBK;
    const int tap = k0 / p.Cin, ci = k0 - tap * p.Cin;
    const int hi = hi0 + tap / p.KW, wi = wi0 + tap % p.KW;
    const bool ok = a_row && hi >= 0 && hi < p.H && wi >= 0 && wi < p.W;
    const int8_t* asrc =
        ok ? p.x + ((static_cast<long long>(ab) * p.H + hi) * p.W + wi) * p.Cin + ci + lh * 16 : p.x;
    unsigned char* a_tile = smem + stage * 2 * kTileBytes;
    cp_async16(smem_u32(a_tile + swz(lr, lh)), asrc, ok ? 16 : 0);
    cp_async16(smem_u32(a_tile + kTileBytes + swz(lr, lh)), b_row ? wrow + k0 : p.w, b_row ? 16 : 0);
  };

  const int wm = warp >> 2, wn = warp & 3;  // warp tile: rows wm*64.., cols wn*32..
  const int g = lane >> 2, t = lane & 3;
  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < ksteps) load(st, st);
    cp_async_commit();
  }
  for (int kt = 0; kt < ksteps; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    {  // refill the stage every warp finished reading at the previous step
      const int nk = kt + kStages - 1;
      if (nk < ksteps) load(nk, nk % kStages);
      cp_async_commit();
    }
    const unsigned char* a_tile = smem + (kt % kStages) * 2 * kTileBytes;
    const unsigned char* b_tile = a_tile + kTileBytes;
    uint32_t af[4][4], bf[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = wm * 64 + i * 16 + g;
      af[i][0] = *reinterpret_cast<const uint32_t*>(a_tile + swz(r, 0) + t * 4);
      af[i][1] = *reinterpret_cast<const uint32_t*>(a_tile + swz(r + 8, 0) + t * 4);
      af[i][2] = *reinterpret_cast<const uint32_t*>(a_tile + swz(r, 1) + t * 4);
      af[i][3] = *reinterpret_cast<const uint32_t*>(a_tile + swz(r + 8, 1) + t * 4);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = wn * 32 + j * 8 + g;
      bf[j][0] = *reinterpret_cast<const uint32_t*>(b_tile + swz(r, 0) + t * 4);
      bf[j][1] = *reinterpret_cast<const uint32_t*>(b_tile + swz(r, 1) + t * 4);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], af[i], bf[j][0], bf[j][1]);
  }
  cp_async_wait<0>();

  const float s = OUT == kOutI32 ? 0.f : *p.s;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = n0 + wn * 32 + j * 8 + t * 2;
    if (n >= p.Cout) continue;  // Cout % 8 == 0: an 8-column tile is all in or all out
    float sc0 = 0.f, sc1 = 0.f, b0 = 0.f, b1 = 0.f;
    if (OUT != kOutI32) {
      sc0 = __fmul_rn(p.w_scale[n], s);
      sc1 = __fmul_rn(p.w_scale[n + 1], s);
      if (p.bias) {
        b0 = p.bias[n];
        b1 = p.bias[n + 1];
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long m = m0 + wm * 64 + i * 16 + g;
      if (m < p.M) store_pair<OUT>(p, m, n, acc[i][j][0], acc[i][j][1], sc0, sc1, b0, b1);
      if (m + 8 < p.M) store_pair<OUT>(p, m + 8, n, acc[i][j][2], acc[i][j][3], sc0, sc1, b0, b1);
    }
  }
}

// ------------------------------------------------------------ quantize, absmax

constexpr int kEwThreads = 256;

__device__ __forceinline__ float act_scale(const float* absmax) {
  return __fdiv_rn(fmaxf(*absmax, 1e-12f), 127.0f);
}

__device__ __forceinline__ int8_t code(float x, float s) {
  return static_cast<int8_t>(fminf(fmaxf(rintf(__fdiv_rn(x, s)), -127.0f), 127.0f));
}

// 8 elements a thread at a time: n % 8 == 0, x 16-byte aligned for bf16 (32 for fp32).
__device__ __forceinline__ void load8(const void* x, bool bf16, long long i, float (&v)[8]) {
  if (bf16) {
    const uint4 u = reinterpret_cast<const uint4*>(static_cast<const __nv_bfloat16*>(x) + i)[0];
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(h[e]);
      v[2 * e] = f.x;
      v[2 * e + 1] = f.y;
    }
  } else {
    const float4* f = reinterpret_cast<const float4*>(static_cast<const float*>(x) + i);
    const float4 a = f[0], b = f[1];
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
  }
}

__global__ void __launch_bounds__(kEwThreads) quantize_kernel(const void* x, bool bf16, long long n8,
                                                              const float* absmax, int8_t* xq, float* s_out) {
  const float s = act_scale(absmax);
  if (blockIdx.x == 0 && threadIdx.x == 0) *s_out = s;
  for (long long k = blockIdx.x * static_cast<long long>(kEwThreads) + threadIdx.x; k < n8;
       k += static_cast<long long>(gridDim.x) * kEwThreads) {
    float v[8];
    load8(x, bf16, k * 8, v);
    uint32_t w0 = 0, w1 = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      w0 |= static_cast<uint32_t>(static_cast<uint8_t>(code(v[e], s))) << (8 * e);
      w1 |= static_cast<uint32_t>(static_cast<uint8_t>(code(v[4 + e], s))) << (8 * e);
    }
    reinterpret_cast<uint2*>(xq)[k] = make_uint2(w0, w1);
  }
}

// max |x| is a max of non-negative floats, whose bit patterns order as the
// floats do: one atomicMax on the bits per block, exact and order-free.
__global__ void __launch_bounds__(kEwThreads) absmax_kernel(const void* x, bool bf16, long long n8, float* out) {
  float m = 0.f;
  for (long long k = blockIdx.x * static_cast<long long>(kEwThreads) + threadIdx.x; k < n8;
       k += static_cast<long long>(gridDim.x) * kEwThreads) {
    float v[8];
    load8(x, bf16, k * 8, v);
#pragma unroll
    for (int e = 0; e < 8; ++e) m = fmaxf(m, fabsf(v[e]));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  __shared__ float red[kEwThreads / 32];
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 1; w < kEwThreads / 32; ++w) m = fmaxf(m, red[w]);
    atomicMax(reinterpret_cast<unsigned int*>(out), __float_as_uint(m));
  }
}

int ew_blocks(long long n8) {
  int sms = 132;
  int dev = 0;
  if (cudaGetDevice(&dev) == cudaSuccess) cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long want = (n8 + kEwThreads - 1) / kEwThreads;
  const long long cap = static_cast<long long>(sms) * 8;
  return static_cast<int>(want < cap ? (want > 0 ? want : 1) : cap);
}

template <int OUT>
int launch_conv(const ConvParams& p, cudaStream_t stream) {
  static_assert(kSmemBytes <= 48 * 1024, "the ring fits the default dynamic shared memory");
  const dim3 grid(static_cast<unsigned>((p.M + kBM - 1) / kBM), static_cast<unsigned>((p.Cout + kBN - 1) / kBN));
  int8_conv_kernel<OUT><<<grid, kThreads, kSmemBytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// y = int8 conv of xq (B, H, W, Cin) with wq (Cout, KH, KW, Cin); out_kind 0 bf16,
// 1 fp32, 2 the raw int32 accumulator (w_scale, s and bias unread). Device
// pointers, xq and wq 16-byte aligned; Cin % 32 == 0, Cout % 8 == 0,
// KH == KW in {1, 3}, stride in {1, 2}, pad in {0, 1}. Launches on `stream`;
// returns 0 or a CUDA error.
extern "C" int int8_conv_nhwc(const void* xq, const void* wq, const void* w_scale, const void* s, const void* bias,
                              void* y, int B, int H, int W, int Cin, int Cout, int KH, int KW, int stride, int pad,
                              int out_kind, void* stream_) {
  if (B <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0 || Cin % kBK || Cout % 8 || KH != KW ||
      (KH != 1 && KH != 3) || (stride != 1 && stride != 2) || pad < 0 || pad > 1 || out_kind < 0 || out_kind > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  ConvParams p;
  p.x = static_cast<const int8_t*>(xq);
  p.w = static_cast<const int8_t*>(wq);
  p.w_scale = static_cast<const float*>(w_scale);
  p.s = static_cast<const float*>(s);
  p.bias = static_cast<const float*>(bias);
  p.y = y;
  p.B = B, p.H = H, p.W = W, p.Cin = Cin, p.Cout = Cout, p.KH = KH, p.KW = KW, p.stride = stride, p.pad = pad;
  p.Ho = (H + 2 * pad - KH) / stride + 1;
  p.Wo = (W + 2 * pad - KW) / stride + 1;
  if (p.Ho <= 0 || p.Wo <= 0) return static_cast<int>(cudaErrorInvalidValue);
  p.M = static_cast<long long>(B) * p.Ho * p.Wo;
  p.K = KH * KW * Cin;
  if ((p.M + kBM - 1) / kBM > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  switch (out_kind) {
    case kOutBf16: return launch_conv<kOutBf16>(p, stream);
    case kOutF32: return launch_conv<kOutF32>(p, stream);
    default: return launch_conv<kOutI32>(p, stream);
  }
}

// xq (n) int8 = clamp(rint(x / s), -127, 127) and s_out = s, with
// s = max(*absmax, 1e-12) / 127; x bf16 (is_bf16 = 1) or fp32, n % 8 == 0,
// x 16-byte aligned, xq 8-byte aligned.
extern "C" int int8_quantize(const void* x, int is_bf16, long long n, const void* absmax, void* xq, void* s_out,
                             void* stream_) {
  if (n <= 0 || n % 8) return static_cast<int>(cudaErrorInvalidValue);
  const long long n8 = n / 8;
  quantize_kernel<<<ew_blocks(n8), kEwThreads, 0, static_cast<cudaStream_t>(stream_)>>>(
      x, is_bf16 != 0, n8, static_cast<const float*>(absmax), static_cast<int8_t*>(xq), static_cast<float*>(s_out));
  return static_cast<int>(cudaGetLastError());
}

// *out (fp32) = max |x| over n elements; x bf16 or fp32 as for int8_quantize.
extern "C" int absmax(const void* x, int is_bf16, long long n, void* out, void* stream_) {
  if (n <= 0 || n % 8) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  cudaError_t e = cudaMemsetAsync(out, 0, sizeof(float), stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long n8 = n / 8;
  absmax_kernel<<<ew_blocks(n8), kEwThreads, 0, stream>>>(x, is_bf16 != 0, n8, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
