// Flash attention forward for Hopper (sm_90a), bf16, no mask:
//
//     out[bh, i, :] = softmax_j(q[bh, i, :] . k[bh, j, :] * scale) v[bh, j, :]     scale = 1/sqrt(D)
//     lse[bh, i]    = log sum_j exp(q[bh, i, :] . k[bh, j, :] * scale)               (natural log, fp32)
//
// Replaces the TPU kernel clip_codec_tpu/ops/pallas_attention.py:_flash_kernel
// (entered there through _flash_forward and flash_attention_heads). Same
// numerics: fp32 logits with scale * log2(e) folded in, an online softmax in
// exp2 with fp32 running max and sum, P rounded to v's dtype (bf16) for the
// P.V product with fp32 accumulation, out rounded to bf16 once at the end,
// and lse = (m + log2 l) / log2(e). The lse is kept for the backward (K5).
//
// What bounds it on an H100: at the SD shapes (N = 1024..4096, D = 40..80)
// attention does 4*N*D FLOP per query row against ~4*D bytes of q and out, so
// it is bound by the tensor cores and by the softmax's exp2 and rescale work
// between the two products; the materialized form instead writes and reads an
// (N, N) fp32 matrix per head (64 MB at N = 4096), which is what this kernel
// keeps out of device memory.
//
// Design (mma.sync m16n8k16 tensor cores, FlashAttention-2 order; no TMA,
// wgmma or warp specialisation yet):
//   * a block owns 64 query rows of one (batch, head) and one slice of the
//     output's head dim; 4 warps, 16 query rows each;
//   * the q.k depth D is zero-padded in shared memory to DP, a multiple of
//     16 (40 -> 48): the MMA's K step is 16 and the zeros add nothing;
//   * keys and values stream through shared memory in tiles of BKT rows,
//     two stages with cp.async, the next tile's loads in flight during the
//     current tile's products;
//   * S = Q K^T stays in registers; its accumulator fragments are exactly
//     the A operand of P.V after the bf16 rounding, so P never leaves
//     registers either;
//   * D = 512 (the VAE's single head) does not fit as one (64, 512) fp32
//     accumulator per block, so the grid's third axis walks 128-wide slices
//     of the output head dim (DV = 128) and each slice's block recomputes S
//     over the full depth: 4x the Q.K^T work of one pass, paid once per VAE
//     decode; at D = 40 and 80 there is one slice (DV = DP).
//   * keys past N and query rows past N are masked (logit -inf, no store).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int THREADS = 128;  // 4 warps x 16 rows
constexpr float LOG2E = 1.4426950408889634f;

// DP: q.k depth padded to a multiple of 16; DV: output slice width; BKT: keys per tile.
template <int DP, int DV, int BKT>
struct Cfg {
  static constexpr int LDQ = DP + 8;  // bf16 row strides: odd multiples of 16 bytes, ldmatrix conflict-free
  static constexpr int LDV = DV + 8;
  static constexpr int NS = BKT / 8;  // n-tiles of S per warp
  static constexpr int NO = DV / 8;   // n-tiles of the output slice per warp
  static constexpr int Q_ELEMS = BQ * LDQ;
  static constexpr int K_ELEMS = BKT * LDQ;
  static constexpr int V_ELEMS = BKT * LDV;
  static constexpr int SMEM = 2 * (Q_ELEMS + 2 * K_ELEMS + 2 * V_ELEMS);
  static_assert(DP % 16 == 0 && DV % 16 == 0 && BKT % 16 == 0, "tile shapes");
};

template <int DP, int DV, int BKT>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                 float* __restrict__ lse, int N, int Nk, int D, float scale_log2) {
  using C = Cfg<DP, DV, BKT>;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sK = sQ + C::Q_ELEMS;      // [2][BKT][LDQ]
  __nv_bfloat16* sV = sK + 2 * C::K_ELEMS;  // [2][BKT][LDV]

  const int bh = blockIdx.y, q0 = blockIdx.x * BQ, d0 = blockIdx.z * DV;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const __nv_bfloat16* qb = q + (size_t)bh * N * D;
  const __nv_bfloat16* kb = k + (size_t)bh * Nk * D;
  const __nv_bfloat16* vb = v + (size_t)bh * Nk * D;

  // Q tile, zero past N and past D.
  for (int e = tid; e < BQ * (DP / 8); e += THREADS) {
    const int r = e / (DP / 8), c = (e % (DP / 8)) * 8;
    const bool ok = q0 + r < N && c < D;
    cp_async16(smem_u32(sQ + r * C::LDQ + c), ok ? qb + (size_t)(q0 + r) * D + c : q, ok);
  }
  auto load_kv = [&](int s, int j0) {
    __nv_bfloat16* dk = sK + s * C::K_ELEMS;
    __nv_bfloat16* dv = sV + s * C::V_ELEMS;
    for (int e = tid; e < BKT * (DP / 8); e += THREADS) {
      const int r = e / (DP / 8), c = (e % (DP / 8)) * 8;
      const bool ok = j0 + r < Nk && c < D;
      cp_async16(smem_u32(dk + r * C::LDQ + c), ok ? kb + (size_t)(j0 + r) * D + c : k, ok);
    }
    for (int e = tid; e < BKT * (DV / 8); e += THREADS) {
      const int r = e / (DV / 8), c = (e % (DV / 8)) * 8;
      const bool ok = j0 + r < Nk && d0 + c < D;
      cp_async16(smem_u32(dv + r * C::LDV + c), ok ? vb + (size_t)(j0 + r) * D + d0 + c : v, ok);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  const int n_tiles = (Nk + BKT - 1) / BKT;
  load_kv(0, 0);  // the first group also carries Q

  float o[C::NO][4];
#pragma unroll
  for (int i = 0; i < C::NO; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.0f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.0f, 0.0f};  // this thread's partial row sums (its 2 columns of each n-tile)

  const int r0 = warp * 16;
  const uint32_t q_addr = smem_u32(sQ + (r0 + (lane & 15)) * C::LDQ + (lane >> 4) * 8);

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      load_kv((t + 1) & 1, (t + 1) * BKT);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
    const __nv_bfloat16* cK = sK + (t & 1) * C::K_ELEMS;
    const __nv_bfloat16* cV = sV + (t & 1) * C::V_ELEMS;

    // S = Q K^T (fp32, 16 x BKT per warp)
    float s[C::NS][4];
#pragma unroll
    for (int i = 0; i < C::NS; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4(q_addr + kk * 32, a);
#pragma unroll
      for (int np = 0; np < C::NS / 2; ++np) {
        // matrices: (keys +0..7, d +0..7), (keys +0..7, d +8..15), (keys +8..15, d +0..7), (keys +8..15, d +8..15)
        const int mi = lane >> 3;
        const int key = np * 16 + (mi >> 1) * 8 + (lane & 7);
        uint32_t b[4];
        ldsm_x4(smem_u32(cK + key * C::LDQ + kk * 16 + (mi & 1) * 8), b);
        mma_bf16(s[2 * np], a, b[0], b[1]);
        mma_bf16(s[2 * np + 1], a, b[2], b[3]);
      }
    }

    // Online softmax in the exp2 domain. Rows: g = lane / 4 (elements 0, 1) and g + 8 (2, 3).
    const int j0 = t * BKT;
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int i = 0; i < C::NS; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j0 + i * 8 + 2 * (lane & 3) + (e & 1);
        s[i][e] = col < Nk ? s[i][e] * scale_log2 : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[i][e]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      alpha[h] = exp2f(m_run[h] - mx[h]);  // 0 on the first tile (m_run = -inf)
      m_run[h] = mx[h];
      l_run[h] *= alpha[h];
    }
#pragma unroll
    for (int i = 0; i < C::NS; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[i][e] = exp2f(s[i][e] - mx[e >> 1]);
        l_run[e >> 1] += s[i][e];
      }
    }
#pragma unroll
    for (int i = 0; i < C::NO; ++i) {
      o[i][0] *= alpha[0];
      o[i][1] *= alpha[0];
      o[i][2] *= alpha[1];
      o[i][3] *= alpha[1];
    }

    // O += P V, P rounded to bf16 (the S fragments of two n-tiles are one A fragment)
#pragma unroll
    for (int j = 0; j < BKT / 16; ++j) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * j][0], s[2 * j][1]);
      a[1] = pack_bf16(s[2 * j][2], s[2 * j][3]);
      a[2] = pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]);
      a[3] = pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3]);
#pragma unroll
      for (int np = 0; np < C::NO / 2; ++np) {
        // matrices: (keys +0..7, d +0..7), (keys +8..15, d +0..7), (keys +0..7, d +8..15), (keys +8..15, d +8..15)
        const int mi = lane >> 3;
        const int key = j * 16 + (mi & 1) * 8 + (lane & 7);
        uint32_t b[4];
        ldsm_x4_trans(smem_u32(cV + key * C::LDV + np * 16 + (mi >> 1) * 8), b);
        mma_bf16(o[2 * np], a, b[0], b[1]);
        mma_bf16(o[2 * np + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();  // this stage is refilled by the next iteration's loads
  }

  // Epilogue: full row sums, normalise, store bf16; slice 0 stores the lse.
  const int g = lane >> 2;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 1);
    l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 2);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + r0 + g + 8 * h;
    if (row >= N) continue;
    const float inv = 1.0f / l_run[h];
    __nv_bfloat16* orow = out + ((size_t)bh * N + row) * D;
#pragma unroll
    for (int i = 0; i < C::NO; ++i) {
      const int col = d0 + i * 8 + 2 * (lane & 3);
      if (col < D)  // D % 8 == 0: both columns of the pair are in range
        *reinterpret_cast<__nv_bfloat162*>(orow + col) =
            __floats2bfloat162_rn(o[i][2 * h] * inv, o[i][2 * h + 1] * inv);
    }
    if (blockIdx.z == 0 && (lane & 3) == 0)
      lse[(size_t)bh * N + row] = (m_run[h] + log2f(l_run[h])) * (1.0f / LOG2E);
  }
}

typedef void (*KernelFn)(const __nv_bfloat16*, const __nv_bfloat16*, const __nv_bfloat16*,
                         __nv_bfloat16*, float*, int, int, int, float);

template <int DP, int DV, int BKT>
int launch(const void* q, const void* k, const void* v, void* out, void* lse, int BH, int N,
           int Nk, int D, float scale_log2, cudaStream_t stream) {
  const KernelFn fn = flash_fwd_kernel<DP, DV, BKT>;
  const int smem = Cfg<DP, DV, BKT>::SMEM;
  cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((N + BQ - 1) / BQ, BH, (D + DV - 1) / DV);
  fn<<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(lse), N, Nk, D, scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace

// The padded q.k depth of the instantiation that takes head dim D: 48 for
// SD-1.5's D = 40 (and 48), 80 for its D = 80 (and 72), 512 for the VAE's
// single head. 0: D not supported.
extern "C" int flash_attention_depth(int D) {
  if (D % 8 != 0) return 0;
  if (D > 32 && D <= 48) return 48;
  if (D > 64 && D <= 80) return 80;
  if (D == 512) return 512;
  return 0;
}

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// q: (BH, N, D), k and v: (BH, Nk, D), out: (BH, N, D), all bf16 and
// contiguous; lse: (BH, N) fp32. D must be one that flash_attention_depth
// takes. scale_log2 = log2(e) / sqrt(D), rounded to fp32 by the caller.
extern "C" int flash_attention_fwd_bf16(const void* q, const void* k, const void* v, void* out,
                                        void* lse, int BH, int N, int Nk, int D,
                                        float scale_log2, void* stream_) {
  if (BH <= 0 || N <= 0 || Nk <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream_);
  switch (flash_attention_depth(D)) {
    case 48: return launch<48, 48, 64>(q, k, v, out, lse, BH, N, Nk, D, scale_log2, s);
    case 80: return launch<80, 80, 64>(q, k, v, out, lse, BH, N, Nk, D, scale_log2, s);
    case 512: return launch<512, 128, 32>(q, k, v, out, lse, BH, N, Nk, D, scale_log2, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
