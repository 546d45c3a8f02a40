// Fused GroupNorm + SiLU for Hopper (sm_90a), NHWC, bf16 or fp32:
//
//     y = silu((x - mean_g) * rsqrt(var_g + eps) * scale[c] + bias[c])
//
// with per-(sample, group) statistics in fp32 over H*W*(C/G) elements, in the
// raw-moment form mean = S/n, var = SS/n - mean^2 (no clamp), and y stored
// once in x's dtype.
//
// Replaces the TPU kernels clip_codec_tpu/ops/pallas_groupnorm.py:_stats_kernel
// and :_norm_kernel (entered there through group_norm_silu_pallas). As on the
// TPU it is two kernels:
//
//   gn_stats_kernel  grid (row chunks, B): per-(b, chunk) fp32 partial sums
//                    and sums of squares of every channel -> part (B, K, 2, C)
//   gn_norm_kernel   grid (row chunks, B): each block reduces its sample's K
//                    partials to per-group mean and rstd, then streams its
//                    chunk of pixels through the affine and SiLU.
//
// What bounds it on an H100: a handful of flops per element against 2-4
// bytes, far below the card's ~295 flop/byte ridge, so it is bound by device
// memory: the stats pass reads x once, the norm pass reads x and writes y
// (the pair's floor is x read once and y written once; at the smaller
// training shapes x fits in the 50 MB L2 and the norm pass can find it
// there). The design therefore only streams: each thread owns 8 consecutive
// channels, one 16-byte load (bf16) or two (fp32) per pixel, so a warp reads
// contiguous rows of the NHWC tensor; the per-channel coefficients of those 8
// channels sit in registers for the whole chunk. The TPU kernel carried the
// statistics across its sequential grid in VMEM scratch; here blocks run in
// no order, so the stats kernel writes one partial per block and the norm
// kernel sums them in a fixed order (no atomics: every run gives the same
// statistics). The number of chunks K is chosen by the caller from the shape
// alone; it trades blocks in flight against the K*2*C partials every norm
// block re-reads from L2.
//
// Groups of fewer than 8 channels (C/G < 8) split a thread's 8-channel vector
// across groups; the statistics are therefore kept per channel in shared
// memory and each thread reads the mean and rstd of each of its channels.
//
// The C functions return cudaGetLastError() after the launch (0 = launched).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int VEC = 8;                      // channels per thread
constexpr int MAX_C = THREADS * VEC;        // 2048: one vector per thread per pixel row

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float f[VEC]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ void load8(const float* p, float f[VEC]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float f[VEC]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

__device__ __forceinline__ void store8(float* p, const float f[VEC]) {
  *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(f[4], f[5], f[6], f[7]);
}

// Pixels [k*chunk, min((k+1)*chunk, HW)) of sample b. Thread t owns channel
// vector v = t % nvec of pixel lane t / nvec; lanes stride over the chunk.
template <typename T>
__global__ void __launch_bounds__(THREADS)
gn_stats_kernel(const T* __restrict__ x, float* __restrict__ part, int HW, int C, int chunk) {
  __shared__ __align__(16) float s_sum[MAX_C];
  __shared__ __align__(16) float s_sq[MAX_C];
  const int nvec = C / VEC, lanes = THREADS / nvec;
  const int k = blockIdx.x, b = blockIdx.y, K = gridDim.x;
  const int tid = threadIdx.x, v = tid % nvec, lane = tid / nvec;
  const int p0 = k * chunk, p1 = min(p0 + chunk, HW);

  if (lane < lanes) {
    float s[VEC], q[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) s[j] = q[j] = 0.f;
    const T* xb = x + (size_t)b * HW * C + v * VEC;
#pragma unroll 4
    for (int p = p0 + lane; p < p1; p += lanes) {
      float f[VEC];
      load8(xb + (size_t)p * C, f);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        s[j] += f[j];
        q[j] = fmaf(f[j], f[j], q[j]);
      }
    }
    float* ds = s_sum + lane * C + v * VEC;
    float* dq = s_sq + lane * C + v * VEC;
    *reinterpret_cast<float4*>(ds) = make_float4(s[0], s[1], s[2], s[3]);
    *reinterpret_cast<float4*>(ds + 4) = make_float4(s[4], s[5], s[6], s[7]);
    *reinterpret_cast<float4*>(dq) = make_float4(q[0], q[1], q[2], q[3]);
    *reinterpret_cast<float4*>(dq + 4) = make_float4(q[4], q[5], q[6], q[7]);
  }
  __syncthreads();
  // lanes in a fixed order: the same partial in every run
  float* out = part + ((size_t)b * K + k) * 2 * C;
  for (int c = tid; c < C; c += THREADS) {
    float a = 0.f, a2 = 0.f;
    for (int l = 0; l < lanes; ++l) {
      a += s_sum[l * C + c];
      a2 += s_sq[l * C + c];
    }
    out[c] = a;
    out[C + c] = a2;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
gn_norm_kernel(const T* __restrict__ x, const float* __restrict__ part, const float* __restrict__ scale,
               const float* __restrict__ bias, T* __restrict__ y, int HW, int C, int G, int chunk,
               float n, float eps) {
  __shared__ float s_mean[MAX_C];
  __shared__ float s_rstd[MAX_C];
  const int nvec = C / VEC, lanes = THREADS / nvec, cg = C / G;
  const int k = blockIdx.x, b = blockIdx.y, K = gridDim.x;
  const int tid = threadIdx.x, v = tid % nvec, lane = tid / nvec;

  // 1. per-channel totals of sample b over its K chunks, in chunk order
  const float* pb = part + (size_t)b * K * 2 * C;
  for (int c = tid; c < C; c += THREADS) {
    float a = 0.f, a2 = 0.f;
    for (int kk = 0; kk < K; ++kk) {
      a += pb[(size_t)kk * 2 * C + c];
      a2 += pb[(size_t)kk * 2 * C + C + c];
    }
    s_mean[c] = a;
    s_rstd[c] = a2;
  }
  __syncthreads();
  // 2. group statistics, each group's channels in order; the result goes to
  //    the group's first channel slot, which only this thread touches here
  for (int g = tid; g < G; g += THREADS) {
    float S = 0.f, SS = 0.f;
    for (int c = g * cg; c < (g + 1) * cg; ++c) {
      S += s_mean[c];
      SS += s_rstd[c];
    }
    const float mean = S / n;
    const float var = SS / n - mean * mean;
    s_mean[g * cg] = mean;
    s_rstd[g * cg] = rsqrtf(var + eps);
  }
  __syncthreads();
  if (lane >= lanes) return;

  // 3. this thread's 8 channels: coefficients in registers, then stream
  float mu[VEC], rs[VEC], sc[VEC], bi[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    const int c = v * VEC + j, first = (c / cg) * cg;
    mu[j] = s_mean[first];
    rs[j] = s_rstd[first];
    sc[j] = scale[c];
    bi[j] = bias[c];
  }
  const size_t base = (size_t)b * HW * C + v * VEC;
  const int p0 = k * chunk, p1 = min(p0 + chunk, HW);
#pragma unroll 4
  for (int p = p0 + lane; p < p1; p += lanes) {
    float f[VEC];
    load8(x + base + (size_t)p * C, f);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float t = (f[j] - mu[j]) * rs[j] * sc[j] + bi[j];
      f[j] = t / (1.f + expf(-t));
    }
    store8(y + base + (size_t)p * C, f);
  }
}

bool bad_shape(int B, int HW, int C, int K) {
  return B <= 0 || HW <= 0 || K <= 0 || C <= 0 || C % VEC || C > MAX_C;
}

}  // namespace

extern "C" {

// x (B, HW, C) bf16 (is_bf16 = 1) or fp32; part (B, K, 2, C) fp32, written.
int groupnorm_silu_stats(const void* x, float* part, int B, int HW, int C, int K, int is_bf16,
                         cudaStream_t stream) {
  if (bad_shape(B, HW, C, K)) return (int)cudaErrorInvalidValue;
  const int chunk = (HW + K - 1) / K;
  const dim3 grid(K, B);
  if (is_bf16)
    gn_stats_kernel<__nv_bfloat16><<<grid, THREADS, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(x), part, HW, C, chunk);
  else
    gn_stats_kernel<float><<<grid, THREADS, 0, stream>>>(static_cast<const float*>(x), part, HW, C, chunk);
  return (int)cudaGetLastError();
}

// y (B, HW, C) in x's dtype from x, the K partials of groupnorm_silu_stats
// and fp32 scale, bias (C,); G groups of C/G channels, n = HW * C / G.
int groupnorm_silu_norm(const void* x, const float* part, const float* scale, const float* bias, void* y,
                        int B, int HW, int C, int G, int K, float eps, int is_bf16, cudaStream_t stream) {
  if (bad_shape(B, HW, C, K) || G <= 0 || C % G) return (int)cudaErrorInvalidValue;
  const int chunk = (HW + K - 1) / K;
  const float n = (float)HW * (float)(C / G);
  const dim3 grid(K, B);
  if (is_bf16)
    gn_norm_kernel<__nv_bfloat16><<<grid, THREADS, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(x), part, scale, bias, static_cast<__nv_bfloat16*>(y), HW, C, G,
        chunk, n, eps);
  else
    gn_norm_kernel<float><<<grid, THREADS, 0, stream>>>(
        static_cast<const float*>(x), part, scale, bias, static_cast<float*>(y), HW, C, G, chunk, n, eps);
  return (int)cudaGetLastError();
}

}  // extern "C"
