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
// everywhere else; the outputs rounded to bf16 once at the end.
//
// Why two kernels: each block owns its output rows, so every sum is taken in
// one fixed order and the gradients are the same from run to run. The fused
// single kernel of FlashAttention-2 and -3 (dk, dv per key block, dq added
// into fp32 with atomics from every key block) does 5 products where this
// split does 7 (the dk/dv kernel recomputes S and dP), but its dq sums in the
// order the blocks happen to finish, which changes from run to run.
//
// What bounds it on an H100: the backward does 5 products of 2*N*Nk*D flops
// per head (QK^T recomputed, dO V^T, P^T dO, dS K, dS^T Q) against ~10*D
// bytes per row, so it is bound by the tensor cores, and at D = 40 nearly as
// much by the exp unit (one exp2 per score in each kernel).
//
// Design (wgmma fed by TMA, warp-specialised; the layouts are sm90.cuh's):
//   * a block owns BR = 64 * NWG rows (queries in dq, keys in dk/dv) of one
//     (batch, head) and one slice of the output head dim: NWG consumer
//     warpgroups of 64 rows each and one producer warp;
//   * the producer loads the owned operands once (Q and dO in dq, K and V in
//     dk/dv) and streams the other two (K and V; Q and dO, with lse2 and dvec
//     by 1-D maps) in tiles of BT rows through a ring of STAGES stages with
//     TMA, on full and empty mbarriers;
//   * dq: S = Q K^T and dP = dO V^T take K-major B; dQ += bf16(dS) K takes
//     K's tile as an MN-major B. dk/dv works transposed, keys as rows:
//     S^T = K Q^T and dP^T = V dO^T take K-major B, dV += bf16(P^T) dO and
//     dK += bf16(dS^T) Q take MN-major B. In both the fp32 accumulators of S
//     and dP become register A operands after the bf16 rounding, so P and dS
//     never touch shared memory;
//   * each warpgroup issues S and dP of tile t + 1 before the products that
//     accumulate tile t, and computes P and dS of tile t + 1 while those
//     run; a tile's stage is held for two steps, so the ring has 4 stages
//     (3 at D = 512) to keep a load in flight;
//   * the depth is padded to a multiple of 16 by TMA's zero fill (40 -> 48);
//   * D = 512 (the VAE's single head): one consumer warpgroup (two would need
//     256 KB for the owned operands alone) and 16-row tiles; the output head
//     dim in slices of DV = 256 in dq (wgmma's widest N: S and dP recomputed
//     2x) and 128 in dk/dv, whose two (64, DV) fp32 accumulators must fit
//     one thread's 255 registers (4x);
//   * TMA's zero fill would give P = exp2(0 - lse2) != 0 on rows past the
//     end, so the kernels mask by index: keys past Nk get P = 0 in dq,
//     queries past N get P = 0 in dk/dv; rows past the end are not stored.

#include <math.h>

#include "sm90.cuh"

namespace {

using namespace sm90;

// DP: q.k depth padded to a multiple of 16; DV: output slice width; BT: rows
// per streamed tile; NWG: consumer warpgroups; STAGES: ring depth.
template <int DP, int DV, int BT, int NWG, int STAGES>
struct Cfg {
  static constexpr int BR = 64 * NWG;
  static constexpr int NCB = (DP + 63) / 64;
  static constexpr int OWN = NCB * BR * 128;   // bytes of one owned operand
  static constexpr int TILE = NCB * BT * 128;  // of one streamed operand
  // One streamed lse2 or dvec tile: TMA starts a box at a 16-byte aligned
  // value, so a tile of BT values is loaded as BT + 4 from the aligned-down start.
  static constexpr int VBOX = BT + 4;
  static constexpr int VEC = (VBOX * 4 + 127) / 128 * 128;
  static constexpr int STAGE_DQ = 2 * TILE;
  static constexpr int STAGE_DKV = 2 * TILE;  // + 2 VEC of lse2 and dvec in a region of their own
  static constexpr int TILES_DQ = 2 * OWN + STAGES * STAGE_DQ;
  static constexpr int TILES_DKV = 2 * OWN + STAGES * (STAGE_DKV + 2 * VEC);
  static constexpr int BARS = (2 * STAGES + 1) * 8;
  static constexpr int SMEM_DQ = 1024 + TILES_DQ + BARS;
  static constexpr int SMEM_DKV = 1024 + TILES_DKV + BARS;
  static constexpr int THREADS = (NWG + 1) * WARPGROUP;
  static_assert(DP % 16 == 0 && (DV % 64 == 0 || DV == DP), "output slices are whole column blocks");
  static_assert(BT % 16 == 0 && SMEM_DKV <= 232448 && SMEM_DQ <= 232448, "tile shapes");
};

// Barriers [full x STAGES][empty x STAGES][own] after the tiles; thread 0 inits.
template <int STAGES, int NWG>
__device__ __forceinline__ uint64_t* init_barriers(unsigned char* at) {
  uint64_t* bars = reinterpret_cast<uint64_t*>(at);
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&bars[s], 1);
      mbar_init(&bars[STAGES + s], NWG * 4);  // one arrival per consumer warp
    }
    mbar_init(&bars[2 * STAGES], 1);
    mbar_init_fence();
  }
  __syncthreads();
  return bars;
}

// This thread's rows of a (64, DV) fp32 accumulator times mul, as bf16: rows
// past n_rows and columns past D (the depth's zero padding) are not written.
template <int DV>
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, const float (&acc)[DV / 2], float mul, int row0,
                                           int n_rows, int d0, int D, int lane) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + (lane >> 2) + 8 * h;
    if (row >= n_rows) continue;
    __nv_bfloat16* out = dst + (size_t)row * D;
#pragma unroll
    for (int c = 0; c < DV / 8; ++c) {
      const int col = d0 + 8 * c + 2 * (lane & 3);
      if (col < D)  // D % 8 == 0: both columns of the pair are in range
        *reinterpret_cast<__nv_bfloat162*>(out + col) =
            __floats2bfloat162_rn(acc[4 * c + 2 * h] * mul, acc[4 * c + 2 * h + 1] * mul);
    }
  }
}

// acc (m64 x BT) = A (64 rows of an owned tile) . B^T (a streamed tile), both K-major.
template <int DP, int BT>
__device__ __forceinline__ void product_abt(float (&acc)[BT / 2], const unsigned char* a, int a_rows,
                                            const unsigned char* b) {
  a = in_place(a);
  Wgmma<BT>::template ss0<0>(acc, desc_k(a, a_rows, 0), desc_k(b, BT, 0));
#pragma unroll
  for (int kk = 1; kk < DP / 16; ++kk) Wgmma<BT>::template ss<0>(acc, desc_k(a, a_rows, kk), desc_k(b, BT, kk));
}

// acc (m64 x DV) += bf16 frags (m64 x BT) . B[:, slice], B a streamed tile read MN-major.
template <int DV, int BT>
__device__ __forceinline__ void product_pb(float (&acc)[DV / 2], const uint32_t (&a)[BT / 16][4],
                                           const unsigned char* b, int cb0) {
#pragma unroll
  for (int j = 0; j < BT / 16; ++j) Wgmma<DV>::template rs<1>(acc, a[j], desc_mn(b, BT, cb0, j));
}

template <int DP, int DV, int BT, int NWG, int STAGES>
__global__ void __launch_bounds__(Cfg<DP, DV, BT, NWG, STAGES>::THREADS, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
                    const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                    const float* __restrict__ lse2, const float* __restrict__ dvec, __nv_bfloat16* __restrict__ dq,
                    int N, int Nk, int D, float scale_log2, float scale) {
  using C = Cfg<DP, DV, BT, NWG, STAGES>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sQ = align1024(smem_raw);
  unsigned char* sO = sQ + C::OWN;        // dO rows of the block
  unsigned char* sS = sO + C::OWN;        // [STAGES][K tile, V tile]
  uint64_t* bars = init_barriers<STAGES, NWG>(sQ + C::TILES_DQ);
  uint64_t *full = bars, *empty = bars + STAGES, *own = bars + 2 * STAGES;

  const int bh = blockIdx.y, q0 = blockIdx.x * C::BR, d0 = blockIdx.z * DV;
  const int n_tiles = (Nk + BT - 1) / BT;
  const int wg = threadIdx.x / WARPGROUP, tid = threadIdx.x % WARPGROUP;

  if (wg == NWG) {
    if constexpr (NWG > 1) reg_dealloc<24>();
    if (tid == 0) {
      mbar_expect_tx(own, 2 * C::OWN);
      for (int cb = 0; cb < C::NCB; ++cb) {
        tma_load_3d(sQ + cb * C::BR * 128, &tq, own, cb * 64, q0, bh);
        tma_load_3d(sO + cb * C::BR * 128, &tdo, own, cb * 64, q0, bh);
      }
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % STAGES;
        mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[s], C::STAGE_DQ);
        unsigned char* st = sS + s * C::STAGE_DQ;
        for (int cb = 0; cb < C::NCB; ++cb) {
          tma_load_3d(st + cb * BT * 128, &tk, &full[s], cb * 64, i * BT, bh);
          tma_load_3d(st + C::TILE + cb * BT * 128, &tv, &full[s], cb * 64, i * BT, bh);
        }
      }
    }
  } else {
    if constexpr (NWG > 1) reg_alloc<240>();
    const int warp = tid / 32, lane = tid % 32, quad = lane & 3;
    const int row0 = q0 + wg * 64 + warp * 16;
    float l2[2], dv[2];  // rows g and g + 8; past N, P = exp2(-inf) = 0
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + (lane >> 2) + 8 * h;
      l2[h] = row < N ? lse2[(size_t)bh * N + row] : INFINITY;
      dv[h] = row < N ? dvec[(size_t)bh * N + row] : 0.0f;
    }
    float acc[DV / 2];
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) acc[i] = 0.0f;
    const unsigned char* myQ = sQ + wg * 64 * 128;
    const unsigned char* myO = sO + wg * 64 * 128;

    float sc[BT / 2], dp[BT / 2];
    uint32_t a[BT / 16][4];
    auto stage = [&](int t) { return sS + (t % STAGES) * C::STAGE_DQ; };  // K tile, then V tile
    auto s_dp = [&](int t) {
      mbar_wait(&full[t % STAGES], (t / STAGES) & 1);
      product_abt<DP, BT>(sc, myQ, C::BR, stage(t));            // S = Q K^T
      product_abt<DP, BT>(dp, myO, C::BR, stage(t) + C::TILE);  // dP = dO V^T
    };
    auto ds = [&](int t) {  // dS of tile t, in place in sc
      fence_regs(sc);
      fence_regs(dp);
      const int j0 = t * BT;
      const bool ragged = j0 + BT > Nk;
#pragma unroll
      for (int i = 0; i < BT / 2; ++i) {
        const int h = (i >> 1) & 1;
        float p = ex2(fmaf(sc[i], scale_log2, -l2[h]));
        if (ragged && j0 + 8 * (i / 4) + 2 * quad + (i & 1) >= Nk) p = 0.0f;
        sc[i] = p * (dp[i] - dv[h]);
      }
    };

    // Tile 0 alone; then S, dP of tile t + 1 issued before dq += bf16(dS) K
    // of tile t, and dS(t + 1) computed while that product runs.
    mbar_wait(own, 0);
    wgmma_fence();
    s_dp(0);
    wgmma_commit();
    wgmma_wait<0>();
    ds(0);
    to_a_frags<BT>(sc, a);
    for (int t = 0; t + 1 < n_tiles; ++t) {
      wgmma_fence();
      s_dp(t + 1);
      wgmma_commit();
      product_pb<DV, BT>(acc, a, stage(t), d0 / 64);  // dq += bf16(dS) K[:, slice]
      wgmma_commit();
      wgmma_wait<1>();
      ds(t + 1);
      wgmma_wait<0>();
      fence_regs(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[t % STAGES]);
      to_a_frags<BT>(sc, a);
    }
    wgmma_fence();
    product_pb<DV, BT>(acc, a, stage(n_tiles - 1), d0 / 64);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    store_rows<DV>(dq + (size_t)bh * N * D, acc, scale, row0, N, d0, D, lane);
  }
}

template <int DP, int DV, int BT, int NWG, int STAGES>
__global__ void __launch_bounds__(Cfg<DP, DV, BT, NWG, STAGES>::THREADS, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
                     const __grid_constant__ CUtensorMap tl, const __grid_constant__ CUtensorMap tdv,
                     __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int N, int Nk, int D,
                     float scale_log2, float scale) {
  using C = Cfg<DP, DV, BT, NWG, STAGES>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sK = align1024(smem_raw);
  unsigned char* sV = sK + C::OWN;
  unsigned char* sS = sV + C::OWN;                    // [STAGES][Q tile, dO tile]
  unsigned char* sVec = sS + STAGES * C::STAGE_DKV;   // [STAGES][lse2, dvec]
  uint64_t* bars = init_barriers<STAGES, NWG>(sK + C::TILES_DKV);
  uint64_t *full = bars, *empty = bars + STAGES, *own = bars + 2 * STAGES;

  const int bh = blockIdx.y, k0 = blockIdx.x * C::BR, d0 = blockIdx.z * DV;
  const int n_tiles = (N + BT - 1) / BT;
  const int wg = threadIdx.x / WARPGROUP, tid = threadIdx.x % WARPGROUP;

  if (wg == NWG) {
    if constexpr (NWG > 1) reg_dealloc<24>();
    if (tid == 0) {
      mbar_expect_tx(own, 2 * C::OWN);
      for (int cb = 0; cb < C::NCB; ++cb) {
        tma_load_3d(sK + cb * C::BR * 128, &tk, own, cb * 64, k0, bh);
        tma_load_3d(sV + cb * C::BR * 128, &tv, own, cb * 64, k0, bh);
      }
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % STAGES;
        mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[s], C::STAGE_DKV + 2 * C::VBOX * 4);
        unsigned char* st = sS + s * C::STAGE_DKV;
        for (int cb = 0; cb < C::NCB; ++cb) {
          tma_load_3d(st + cb * BT * 128, &tq, &full[s], cb * 64, i * BT, bh);
          tma_load_3d(st + C::TILE + cb * BT * 128, &tdo, &full[s], cb * 64, i * BT, bh);
        }
        // lse2 and dvec as flat (BH * N) vectors: the values past this head's
        // N are the next head's (or zero), and the consumers mask them
        const int v0 = (bh * N + i * BT) & ~3;
        tma_load_1d(sVec + s * 2 * C::VEC, &tl, &full[s], v0);
        tma_load_1d(sVec + s * 2 * C::VEC + C::VEC, &tdv, &full[s], v0);
      }
    }
  } else {
    if constexpr (NWG > 1) reg_alloc<240>();
    const int warp = tid / 32, lane = tid % 32, quad = lane & 3;
    const int row0 = k0 + wg * 64 + warp * 16;
    float dka[DV / 2], dva[DV / 2];
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) dka[i] = dva[i] = 0.0f;
    const unsigned char* myK = sK + wg * 64 * 128;
    const unsigned char* myV = sV + wg * 64 * 128;

    float sc[BT / 2], dp[BT / 2];
    uint32_t pa[BT / 16][4], da[BT / 16][4];
    auto stage = [&](int t) { return sS + (t % STAGES) * C::STAGE_DKV; };  // Q tile, then dO tile
    auto s_dp = [&](int t) {
      mbar_wait(&full[t % STAGES], (t / STAGES) & 1);
      product_abt<DP, BT>(sc, myK, C::BR, stage(t));            // S^T = K Q^T: keys x queries
      product_abt<DP, BT>(dp, myV, C::BR, stage(t) + C::TILE);  // dP^T = V dO^T
    };
    auto p_ds = [&](int t) {  // P^T in place in sc, dS^T in dp
      fence_regs(sc);
      fence_regs(dp);
      const int i0 = t * BT, skip = (bh * N + i0) & 3;  // values before the tile in the aligned box
      const float* cL = reinterpret_cast<const float*>(sVec + (t % STAGES) * 2 * C::VEC) + skip;
      const float* cD = reinterpret_cast<const float*>(sVec + (t % STAGES) * 2 * C::VEC + C::VEC) + skip;
      const bool ragged = i0 + BT > N;
#pragma unroll
      for (int i = 0; i < BT / 2; ++i) {
        const int col = 8 * (i / 4) + 2 * quad + (i & 1);
        float p = ex2(fmaf(sc[i], scale_log2, -cL[col]));
        if (ragged && i0 + col >= N) p = 0.0f;
        sc[i] = p;
        dp[i] = p * (dp[i] - cD[col]);
      }
    };
    auto dkv_products = [&](int t) {
      product_pb<DV, BT>(dva, pa, stage(t) + C::TILE, d0 / 64);  // dv += bf16(P^T) dO[:, slice]
      product_pb<DV, BT>(dka, da, stage(t), d0 / 64);            // dk += bf16(dS^T) Q[:, slice]
    };

    // Tile 0 alone; then S^T, dP^T of tile t + 1 issued before the dv and dk
    // products of tile t, and P^T, dS^T(t + 1) computed while those run.
    mbar_wait(own, 0);
    wgmma_fence();
    s_dp(0);
    wgmma_commit();
    wgmma_wait<0>();
    p_ds(0);
    to_a_frags<BT>(sc, pa);
    to_a_frags<BT>(dp, da);
    for (int t = 0; t + 1 < n_tiles; ++t) {
      wgmma_fence();
      s_dp(t + 1);
      wgmma_commit();
      dkv_products(t);
      wgmma_commit();
      wgmma_wait<1>();
      p_ds(t + 1);
      wgmma_wait<0>();
      fence_regs(dva);
      fence_regs(dka);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[t % STAGES]);
      to_a_frags<BT>(sc, pa);
      to_a_frags<BT>(dp, da);
    }
    wgmma_fence();
    dkv_products(n_tiles - 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dva);
    fence_regs(dka);
    const size_t koff = (size_t)bh * Nk * D;
    store_rows<DV>(dk + koff, dka, scale, row0, Nk, d0, D, lane);
    store_rows<DV>(dv + koff, dva, 1.0f, row0, Nk, d0, D, lane);
  }
}

template <int DP, int DV, int BT, int NWG, int STAGES>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse2, const void* dvec,
              void* dq, int BH, int N, int Nk, int D, float scale_log2, float scale, cudaStream_t stream) {
  using C = Cfg<DP, DV, BT, NWG, STAGES>;
  CUtensorMap tq, tdo, tk, tv;
  if (int e = tmap_rows_bf16(&tq, q, BH, N, D, C::BR)) return e;
  if (int e = tmap_rows_bf16(&tdo, dout, BH, N, D, C::BR)) return e;
  if (int e = tmap_rows_bf16(&tk, k, BH, Nk, D, BT)) return e;
  if (int e = tmap_rows_bf16(&tv, v, BH, Nk, D, BT)) return e;
  const auto fn = flash_bwd_dq_kernel<DP, DV, BT, NWG, STAGES>;
  cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM_DQ);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((N + C::BR - 1) / C::BR, BH, (D + DV - 1) / DV);
  fn<<<grid, C::THREADS, C::SMEM_DQ, stream>>>(tq, tdo, tk, tv, static_cast<const float*>(lse2),
                                               static_cast<const float*>(dvec), static_cast<__nv_bfloat16*>(dq),
                                               N, Nk, D, scale_log2, scale);
  return (int)cudaGetLastError();
}

template <int DP, int DV, int BT, int NWG, int STAGES>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse2, const void* dvec,
               void* dk, void* dv, int BH, int N, int Nk, int D, float scale_log2, float scale,
               cudaStream_t stream) {
  using C = Cfg<DP, DV, BT, NWG, STAGES>;
  CUtensorMap tk, tv, tq, tdo, tl, tdv;
  if (int e = tmap_rows_bf16(&tk, k, BH, Nk, D, C::BR)) return e;
  if (int e = tmap_rows_bf16(&tv, v, BH, Nk, D, C::BR)) return e;
  if (int e = tmap_rows_bf16(&tq, q, BH, N, D, BT)) return e;
  if (int e = tmap_rows_bf16(&tdo, dout, BH, N, D, BT)) return e;
  if (int e = tmap_vec_f32(&tl, lse2, (long long)BH * N, C::VBOX)) return e;
  if (int e = tmap_vec_f32(&tdv, dvec, (long long)BH * N, C::VBOX)) return e;
  const auto fn = flash_bwd_dkv_kernel<DP, DV, BT, NWG, STAGES>;
  cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM_DKV);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Nk + C::BR - 1) / C::BR, BH, (D + DV - 1) / DV);
  fn<<<grid, C::THREADS, C::SMEM_DKV, stream>>>(tk, tv, tq, tdo, tl, tdv, static_cast<__nv_bfloat16*>(dk),
                                                static_cast<__nv_bfloat16*>(dv), N, Nk, D, scale_log2, scale);
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

// Both launch on `stream` and return 0, a CUDA error, or one of sm90.cuh's
// tensor-map codes (>= 9000). q, dout: (BH, N, D); k, v: (BH, Nk, D); all
// bf16, contiguous and 16-byte aligned. lse2 and dvec: (BH, N) fp32,
// lse2 = lse * log2(e) and dvec = rowsum(dO * O). scale = 1/sqrt(D) and
// scale_log2 = scale * log2(e), rounded to fp32 by the caller. dq: (BH, N,
// D); dk, dv: (BH, Nk, D), bf16.
extern "C" int flash_attention_bwd_dq_bf16(const void* q, const void* k, const void* v, const void* dout,
                                           const void* lse2, const void* dvec, void* dq, int BH, int N, int Nk,
                                           int D, float scale_log2, float scale, void* stream_) {
  if (BH <= 0 || N <= 0 || Nk <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream_);
  switch (flash_attention_bwd_depth(D)) {
    case 48: return launch_dq<48, 48, 64, 2, 4>(q, k, v, dout, lse2, dvec, dq, BH, N, Nk, D, scale_log2, scale, s);
    case 80: return launch_dq<80, 80, 64, 2, 4>(q, k, v, dout, lse2, dvec, dq, BH, N, Nk, D, scale_log2, scale, s);
    case 512:
      return launch_dq<512, 256, 16, 1, 3>(q, k, v, dout, lse2, dvec, dq, BH, N, Nk, D, scale_log2, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int flash_attention_bwd_dkv_bf16(const void* q, const void* k, const void* v, const void* dout,
                                            const void* lse2, const void* dvec, void* dk, void* dv, int BH, int N,
                                            int Nk, int D, float scale_log2, float scale, void* stream_) {
  if (BH <= 0 || N <= 0 || Nk <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream_);
  switch (flash_attention_bwd_depth(D)) {
    case 48:
      return launch_dkv<48, 48, 64, 2, 4>(q, k, v, dout, lse2, dvec, dk, dv, BH, N, Nk, D, scale_log2, scale, s);
    case 80:
      return launch_dkv<80, 80, 64, 2, 4>(q, k, v, dout, lse2, dvec, dk, dv, BH, N, Nk, D, scale_log2, scale, s);
    case 512:
      return launch_dkv<512, 128, 16, 1, 3>(q, k, v, dout, lse2, dvec, dk, dv, BH, N, Nk, D, scale_log2, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
