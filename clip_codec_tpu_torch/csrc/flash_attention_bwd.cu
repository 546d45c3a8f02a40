// Flash attention backward for Hopper (sm_90a), bf16 in and out, fp32
// accumulation, no mask. From the forward's saved row logsumexp L (natural
// log; the caller passes lse2 = L * log2(e)) and dvec_i = sum_d dO_id O_id:
//
//     P_ij  = exp(q_i . k_j * scale - L_i) = exp2(q_i . k_j * scale * log2(e) - lse2_i)
//     dP_ij = dO_i . v_j
//     dS_ij = P_ij (dP_ij - dvec_i)
//     dq_i  = scale * sum_j bf16(dS_ij) k_j
//     dk_j  = scale * sum_i bf16(dS_ij) q_i
//     dv_j  =         sum_i bf16(P_ij) dO_i                         scale = 1/sqrt(D)
//
// Replaces the TPU kernels clip_codec_tpu/ops/pallas_attention.py
// _bwd_dq_kernel and _bwd_dkv_kernel (entered there through _flash_backward
// from the custom VJPs of flash_attention and flash_attention_heads). Same
// split and numerics: two kernels, dq accumulated over key tiles and dk, dv
// over query tiles; P recomputed in exp2 with log2(e) folded into the fp32
// scale; P and dS rounded to bf16 for the products that accumulate them, fp32
// everywhere else; the outputs rounded to bf16 once at the end. Each block
// owns its output rows, so there are no atomics.
//
// What bounds it on an H100: the backward does 5 products of 2*N*Nk*D flops
// per head (QK^T recomputed, dO V^T, P^T dO, dS K, dS^T Q) against ~10*D bytes
// per row, so it is bound by the tensor cores. The two-kernel split redoes
// QK^T and dO V^T in the second kernel (7 products in all) and in exchange
// needs no atomics and no (N, Nk) intermediate in device memory.
//
// Design (mma.sync m16n8k16, cp.async double buffering; no TMA or wgmma yet):
//   * a block owns 64 rows (queries in dq, keys in dk/dv) of one (batch,
//     head) and one slice of the output head dim; 4 warps, 16 rows each;
//   * the q.k depth is zero-padded in shared memory to DP, a multiple of 16
//     (40 -> 48); the padded columns are never stored;
//   * the streamed operand (keys and values in dq, queries and dO in dk/dv)
//     goes through shared memory in tiles of BT rows, two cp.async stages;
//   * dq computes S and dP with query rows as the MMA's rows; dk/dv computes
//     them transposed (S^T = K Q^T, dP^T = V dO^T), keys as rows. Either way
//     the fp32 accumulators of S and dP are the A fragments of the next
//     product after the bf16 rounding, so P and dS never leave registers and
//     no transpose is needed;
//   * D = 512 (the VAE's single head) does not fit as (64, 512) fp32
//     accumulators, so, as in the forward, the grid's third axis walks
//     128-wide slices of the output head dim (DV = 128) and each slice's block
//     recomputes S and dP over the full depth: 4x the S and dP work;
//   * rows past N or Nk are zero-filled on load and masked: P = 0 for keys
//     past Nk (dq) and for queries past N (lse2 = +inf, dk/dv); rows past the
//     end are not stored.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int BR = 64;        // rows a block owns: queries (dq) or keys (dk, dv)
constexpr int THREADS = 128;  // 4 warps x 16 rows

// DP: q.k depth padded to a multiple of 16; DV: output slice width; BT: rows per streamed tile.
template <int DP, int DV, int BT>
struct Cfg {
  static constexpr int LD = DP + 8;  // bf16 row stride: an odd multiple of 16 bytes, ldmatrix conflict-free
  static constexpr int NS = BT / 8;  // n-tiles of S per warp
  static constexpr int NO = DV / 8;  // n-tiles of the output slice per warp
  static constexpr int OWN = BR * LD;
  static constexpr int TILE = BT * LD;
  // bytes: two owned tiles, two streamed tiles x two stages; then lse2 and dvec x two stages
  static constexpr int SMEM_BF16 = 2 * (2 * OWN + 2 * 2 * TILE);
  static constexpr int SMEM = SMEM_BF16 + 2 * 2 * BT * (int)sizeof(float);
  static_assert(DP % 16 == 0 && DV % 16 == 0 && BT % 16 == 0 && DP % DV == 0, "tile shapes");
};

// Rows [r0, r0 + ROWS) of a (n_rows, D) row-major bf16 matrix into shared
// memory at row stride LD, zero past n_rows and past D (cp.async, uncommitted).
template <int ROWS, int DP, int LD>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, const __nv_bfloat16* src, int r0,
                                          int n_rows, int D, int tid) {
  for (int e = tid; e < ROWS * (DP / 8); e += THREADS) {
    const int r = e / (DP / 8), c = (e % (DP / 8)) * 8;
    const bool ok = r0 + r < n_rows && c < D;
    cp_async16(smem_u32(dst + r * LD + c), ok ? src + (size_t)(r0 + r) * D + c : src, ok);
  }
}

// acc (16 x BT per warp) = A[r0 .. r0+16, :DP] . B[0 .. BT, :DP]^T, both row-major in
// shared memory at stride LD.
template <int DP, int BT, int LD>
__device__ __forceinline__ void mma_abt(float (&acc)[BT / 8][4], const __nv_bfloat16* sA, int r0,
                                        const __nv_bfloat16* sB, int lane) {
#pragma unroll
  for (int i = 0; i < BT / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.0f;
  const uint32_t a_addr = smem_u32(sA + (r0 + (lane & 15)) * LD + (lane >> 4) * 8);
  const int mi = lane >> 3;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4(a_addr + kk * 32, a);
#pragma unroll
    for (int np = 0; np < BT / 16; ++np) {
      // matrices: (rows +0..7, k +0..7), (rows +0..7, k +8..15), (rows +8..15, k +0..7), (rows +8..15, k +8..15)
      const int row = np * 16 + (mi >> 1) * 8 + (lane & 7);
      uint32_t b[4];
      ldsm_x4(smem_u32(sB + row * LD + kk * 16 + (mi & 1) * 8), b);
      mma_bf16(acc[2 * np], a, b[0], b[1]);
      mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// acc (16 x DV per warp) += bf16(p) (16 x BT, registers) . B[0 .. BT, col0 .. col0+DV],
// B row-major in shared memory at stride LD.
template <int BT, int DV, int LD>
__device__ __forceinline__ void mma_pb(float (&acc)[DV / 8][4], const float (&p)[BT / 8][4],
                                       const __nv_bfloat16* sB, int col0, int lane) {
  const int mi = lane >> 3;
#pragma unroll
  for (int j = 0; j < BT / 16; ++j) {
    uint32_t a[4];
    a[0] = pack_bf16(p[2 * j][0], p[2 * j][1]);
    a[1] = pack_bf16(p[2 * j][2], p[2 * j][3]);
    a[2] = pack_bf16(p[2 * j + 1][0], p[2 * j + 1][1]);
    a[3] = pack_bf16(p[2 * j + 1][2], p[2 * j + 1][3]);
#pragma unroll
    for (int np = 0; np < DV / 16; ++np) {
      // matrices: (k +0..7, n +0..7), (k +8..15, n +0..7), (k +0..7, n +8..15), (k +8..15, n +8..15)
      const int row = j * 16 + (mi & 1) * 8 + (lane & 7);
      uint32_t b[4];
      ldsm_x4_trans(smem_u32(sB + row * LD + col0 + np * 16 + (mi >> 1) * 8), b);
      mma_bf16(acc[2 * np], a, b[0], b[1]);
      mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// Stores this warp's 16 rows of acc * mul as bf16: rows past n_rows and
// columns past D (the zero padding of the depth) are not written.
template <int NO>
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, const float (&acc)[NO][4], float mul,
                                           int row0, int n_rows, int d0, int D, int lane) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + (lane >> 2) + 8 * h;
    if (row >= n_rows) continue;
    __nv_bfloat16* out = dst + (size_t)row * D;
#pragma unroll
    for (int i = 0; i < NO; ++i) {
      const int col = d0 + i * 8 + 2 * (lane & 3);
      if (col < D)  // D % 8 == 0: both columns of the pair are in range
        *reinterpret_cast<__nv_bfloat162*>(out + col) =
            __floats2bfloat162_rn(acc[i][2 * h] * mul, acc[i][2 * h + 1] * mul);
    }
  }
}

template <int DP, int DV, int BT>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse2, const float* __restrict__ dvec,
                    __nv_bfloat16* __restrict__ dq, int N, int Nk, int D, float scale_log2,
                    float scale) {
  using C = Cfg<DP, DV, BT>;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sO = sQ + C::OWN;       // dO rows of the block
  __nv_bfloat16* sK = sO + C::OWN;       // [2][BT][LD]
  __nv_bfloat16* sV = sK + 2 * C::TILE;  // [2][BT][LD]

  const int bh = blockIdx.y, q0 = blockIdx.x * BR, d0 = blockIdx.z * DV;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t qoff = (size_t)bh * N * D, koff = (size_t)bh * Nk * D;

  load_rows<BR, DP, C::LD>(sQ, q + qoff, q0, N, D, tid);
  load_rows<BR, DP, C::LD>(sO, dout + qoff, q0, N, D, tid);
  auto load_kv = [&](int s, int j0) {
    load_rows<BT, DP, C::LD>(sK + s * C::TILE, k + koff, j0, Nk, D, tid);
    load_rows<BT, DP, C::LD>(sV + s * C::TILE, v + koff, j0, Nk, D, tid);
    cp_async_commit();
  };

  const int r0 = warp * 16;
  float l2[2], dv[2];  // rows g and g + 8 of this warp; past N, P = exp2(-inf) = 0
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + r0 + (lane >> 2) + 8 * h;
    l2[h] = row < N ? lse2[(size_t)bh * N + row] : INFINITY;
    dv[h] = row < N ? dvec[(size_t)bh * N + row] : 0.0f;
  }
  float acc[C::NO][4];
#pragma unroll
  for (int i = 0; i < C::NO; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.0f;

  const int n_tiles = (Nk + BT - 1) / BT;
  load_kv(0, 0);  // the first group also carries Q and dO
  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      load_kv((t + 1) & 1, (t + 1) * BT);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* cK = sK + (t & 1) * C::TILE;
    const __nv_bfloat16* cV = sV + (t & 1) * C::TILE;

    float s[C::NS][4], dp[C::NS][4];
    mma_abt<DP, BT, C::LD>(s, sQ, r0, cK, lane);   // S = Q K^T
    mma_abt<DP, BT, C::LD>(dp, sO, r0, cV, lane);  // dP = dO V^T
    const int j0 = t * BT;
#pragma unroll
    for (int i = 0; i < C::NS; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j0 + i * 8 + 2 * (lane & 3) + (e & 1);
        const float p = col < Nk ? exp2f(s[i][e] * scale_log2 - l2[e >> 1]) : 0.0f;
        s[i][e] = p * (dp[i][e] - dv[e >> 1]);  // dS
      }
    }
    mma_pb<BT, DV, C::LD>(acc, s, cK, d0, lane);  // dq += bf16(dS) K[:, slice]
    __syncthreads();  // this stage is refilled by the next iteration's loads
  }
  store_rows<C::NO>(dq + qoff, acc, scale, q0 + r0, N, d0, D, lane);
}

template <int DP, int DV, int BT>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ lse2, const float* __restrict__ dvec,
                     __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int N, int Nk,
                     int D, float scale_log2, float scale) {
  using C = Cfg<DP, DV, BT>;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sV = sK + C::OWN;
  __nv_bfloat16* sQ = sV + C::OWN;       // [2][BT][LD]
  __nv_bfloat16* sO = sQ + 2 * C::TILE;  // [2][BT][LD] dO
  float* sL = reinterpret_cast<float*>(smem + C::SMEM_BF16);  // [2][BT] lse2
  float* sD = sL + 2 * BT;                                     // [2][BT] dvec

  const int bh = blockIdx.y, k0 = blockIdx.x * BR, d0 = blockIdx.z * DV;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t qoff = (size_t)bh * N * D, koff = (size_t)bh * Nk * D;

  load_rows<BR, DP, C::LD>(sK, k + koff, k0, Nk, D, tid);
  load_rows<BR, DP, C::LD>(sV, v + koff, k0, Nk, D, tid);
  auto load_q = [&](int s, int i0) {
    load_rows<BT, DP, C::LD>(sQ + s * C::TILE, q + qoff, i0, N, D, tid);
    load_rows<BT, DP, C::LD>(sO + s * C::TILE, dout + qoff, i0, N, D, tid);
    cp_async_commit();
    // Plain stores: this stage was released by the previous iteration's
    // closing barrier, and the next opening barrier publishes them.
    for (int r = tid; r < BT; r += THREADS) {
      const bool ok = i0 + r < N;  // past N, P = exp2(-inf) = 0
      sL[s * BT + r] = ok ? lse2[(size_t)bh * N + i0 + r] : INFINITY;
      sD[s * BT + r] = ok ? dvec[(size_t)bh * N + i0 + r] : 0.0f;
    }
  };

  const int r0 = warp * 16;
  float dka[C::NO][4], dva[C::NO][4];
#pragma unroll
  for (int i = 0; i < C::NO; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[i][e] = dva[i][e] = 0.0f;
  }

  const int n_tiles = (N + BT - 1) / BT;
  load_q(0, 0);  // the first group also carries K and V
  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      load_q((t + 1) & 1, (t + 1) * BT);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* cQ = sQ + (t & 1) * C::TILE;
    const __nv_bfloat16* cO = sO + (t & 1) * C::TILE;
    const float* cL = sL + (t & 1) * BT;
    const float* cD = sD + (t & 1) * BT;

    float s[C::NS][4], dp[C::NS][4];
    mma_abt<DP, BT, C::LD>(s, sK, r0, cQ, lane);  // S^T = K Q^T: keys x queries
#pragma unroll
    for (int i = 0; i < C::NS; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[i][e] = exp2f(s[i][e] * scale_log2 - cL[i * 8 + 2 * (lane & 3) + (e & 1)]);  // P^T
    }
    mma_pb<BT, DV, C::LD>(dva, s, cO, d0, lane);  // dv += bf16(P^T) dO[:, slice]
    mma_abt<DP, BT, C::LD>(dp, sV, r0, cO, lane);  // dP^T = V dO^T
#pragma unroll
    for (int i = 0; i < C::NS; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] *= dp[i][e] - cD[i * 8 + 2 * (lane & 3) + (e & 1)];  // dS^T
    }
    mma_pb<BT, DV, C::LD>(dka, s, cQ, d0, lane);  // dk += bf16(dS^T) Q[:, slice]
    __syncthreads();  // this stage is refilled by the next iteration's loads
  }
  store_rows<C::NO>(dk + koff, dka, scale, k0 + r0, Nk, d0, D, lane);
  store_rows<C::NO>(dv + koff, dva, 1.0f, k0 + r0, Nk, d0, D, lane);
}

template <typename Fn>
int prepare(Fn fn, int smem) {
  return (int)cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <int DP, int DV, int BT>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse2,
              const void* dvec, void* dq, int BH, int N, int Nk, int D, float scale_log2, float scale,
              cudaStream_t stream) {
  const auto fn = flash_bwd_dq_kernel<DP, DV, BT>;
  const int smem = Cfg<DP, DV, BT>::SMEM_BF16;
  if (int e = prepare(fn, smem)) return e;
  const dim3 grid((N + BR - 1) / BR, BH, (D + DV - 1) / DV);
  fn<<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse2), static_cast<const float*>(dvec),
      static_cast<__nv_bfloat16*>(dq), N, Nk, D, scale_log2, scale);
  return (int)cudaGetLastError();
}

template <int DP, int DV, int BT>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse2,
               const void* dvec, void* dk, void* dv, int BH, int N, int Nk, int D, float scale_log2,
               float scale, cudaStream_t stream) {
  const auto fn = flash_bwd_dkv_kernel<DP, DV, BT>;
  const int smem = Cfg<DP, DV, BT>::SMEM;
  if (int e = prepare(fn, smem)) return e;
  const dim3 grid((Nk + BR - 1) / BR, BH, (D + DV - 1) / DV);
  fn<<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse2), static_cast<const float*>(dvec),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), N, Nk, D, scale_log2, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// The padded q.k depth of the instantiation that takes head dim D, as the
// forward's flash_attention_depth: 48 (D = 40, 48), 80 (D = 72, 80), 512.
// 0: D not supported.
extern "C" int flash_attention_bwd_depth(int D) {
  if (D % 8 != 0) return 0;
  if (D > 32 && D <= 48) return 48;
  if (D > 64 && D <= 80) return 80;
  if (D == 512) return 512;
  return 0;
}

// Both launch on `stream` and return cudaGetLastError() (0 on success).
// q, dout: (BH, N, D); k, v: (BH, Nk, D); all bf16 and contiguous. lse2 and
// dvec: (BH, N) fp32, lse2 = lse * log2(e) and dvec = rowsum(dO * O).
// scale = 1/sqrt(D) and scale_log2 = scale * log2(e), rounded to fp32 by the
// caller. dq: (BH, N, D); dk, dv: (BH, Nk, D), bf16.
extern "C" int flash_attention_bwd_dq_bf16(const void* q, const void* k, const void* v,
                                           const void* dout, const void* lse2, const void* dvec,
                                           void* dq, int BH, int N, int Nk, int D,
                                           float scale_log2, float scale, void* stream_) {
  if (BH <= 0 || N <= 0 || Nk <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream_);
  switch (flash_attention_bwd_depth(D)) {
    case 48: return launch_dq<48, 48, 64>(q, k, v, dout, lse2, dvec, dq, BH, N, Nk, D, scale_log2, scale, s);
    case 80: return launch_dq<80, 80, 64>(q, k, v, dout, lse2, dvec, dq, BH, N, Nk, D, scale_log2, scale, s);
    case 512: return launch_dq<512, 128, 16>(q, k, v, dout, lse2, dvec, dq, BH, N, Nk, D, scale_log2, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int flash_attention_bwd_dkv_bf16(const void* q, const void* k, const void* v,
                                            const void* dout, const void* lse2, const void* dvec,
                                            void* dk, void* dv, int BH, int N, int Nk, int D,
                                            float scale_log2, float scale, void* stream_) {
  if (BH <= 0 || N <= 0 || Nk <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream_);
  switch (flash_attention_bwd_depth(D)) {
    case 48:
      return launch_dkv<48, 48, 64>(q, k, v, dout, lse2, dvec, dk, dv, BH, N, Nk, D, scale_log2, scale, s);
    case 80:
      return launch_dkv<80, 80, 32>(q, k, v, dout, lse2, dvec, dk, dv, BH, N, Nk, D, scale_log2, scale, s);
    case 512:
      return launch_dkv<512, 128, 16>(q, k, v, dout, lse2, dvec, dk, dv, BH, N, Nk, D, scale_log2, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
