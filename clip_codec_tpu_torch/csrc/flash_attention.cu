// Flash attention forward for Hopper (sm_90a), bf16, no mask:
//
//     out[bh, i, :] = softmax_j(q[bh, i, :] . k[bh, j, :] * scale) v[bh, j, :]     scale = 1/sqrt(D)
//     lse[bh, i]    = log sum_j exp(q[bh, i, :] . k[bh, j, :] * scale)               (natural log, fp32)
//
// Replaces the TPU kernel clip_codec_tpu/ops/pallas_attention.py:_flash_kernel
// (entered there through _flash_forward and flash_attention_heads). Same
// numerics: fp32 logits with scale * log2(e) folded into one fp32 multiply
// (fused with the max's subtraction), an online softmax in exp2 with fp32
// running max and sum, P rounded to bf16 for the P.V product with fp32
// accumulation, out rounded to bf16 once at the end, and
// lse = (m + log2 l) / log2(e). The lse is kept for the backward (K5).
//
// What bounds it on an H100: at the SD shapes (N = 1024..4096, D = 40..80)
// one exponential per score on the exp unit (16 a clock per SM) takes longer
// than the 4 N D flops per score on the tensor cores, and the softmax's other
// per-score instructions (max, subtract, sum, bf16 pack) share the issue slots
// with it; the materialized form instead writes and reads an (N, N) fp32
// matrix per head, which this kernel keeps out of device memory.
//
// Design (wgmma fed by TMA, warp-specialised; the layouts are sm90.cuh's):
//   * a block owns BQ = 64 * NWG query rows of one (batch, head) and one
//     slice of the output's head dim: NWG consumer warpgroups of 64 rows
//     each and one producer warp, whose warpgroup gives its registers to the
//     consumers with setmaxnreg. D = 40 runs three consumer warpgroups (192
//     rows, 160 registers each): the softmax's dependent max and sum chains
//     need more warps per scheduler to hide their latency than two give;
//     D = 80 and 512 run two (240 registers);
//   * the producer loads Q once and streams K and V tiles of BKT keys through
//     a ring of STAGES shared-memory stages with TMA (3-D maps, so the rows
//     past N or Nk of a head read as zero), each stage's arrival on a full
//     mbarrier, its release by the consumers on an empty one;
//   * S = Q K^T is one wgmma chain per warpgroup (A = Q, B = K, both
//     K-major; the depth padded to a multiple of 16 by TMA's zero fill,
//     40 -> 48); the softmax runs on S's fp32 accumulator, and P, rounded to
//     bf16, is the register A operand of O += P V (B = V, MN-major), so P
//     never touches shared memory;
//   * each warpgroup issues S(t) and P(t-1) V(t-1) together and runs the
//     softmax of tile t while P V is in flight; the warpgroups take turns to
//     issue (named barriers, round robin), so one's softmax on the exp unit
//     overlaps another's products on the tensor cores;
//   * D = 512 (the VAE's single head) does not fit as one (64, 512) fp32
//     accumulator per warpgroup, so the grid's third axis walks DV = 256-wide
//     slices of the output head dim (wgmma's widest N) and each slice's block
//     recomputes S over the full depth: 2x the Q.K^T work of one pass, paid
//     once per VAE decode; at D = 40 and 80 there is one slice (DV = D);
//   * keys past Nk are masked (logit -inf); query rows past N are not stored.

#include <math.h>

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr float LOG2E = 1.4426950408889634f;

// DP: q.k depth padded to a multiple of 16; DV: output slice width; BKT: keys
// per tile; NWG: consumer warpgroups (64 query rows each); STAGES: ring depth.
template <int DP, int DV, int BKT, int NWG, int STAGES>
struct Cfg {
  static constexpr int BQ = 64 * NWG;
  static constexpr int NCB = (DP + 63) / 64;   // 64-column blocks of the q.k depth
  static constexpr int NCBV = (DV + 63) / 64;  // of the output slice
  static constexpr int Q_BYTES = NCB * BQ * 128;
  static constexpr int K_BYTES = NCB * BKT * 128;
  static constexpr int V_BYTES = NCBV * BKT * 128;
  static constexpr int TILES = Q_BYTES + STAGES * (K_BYTES + V_BYTES);
  static constexpr int SMEM = 1024 + TILES + (2 * STAGES + 1) * 8;  // alignment slack, tiles, barriers
  static constexpr int THREADS = (NWG + 1) * WARPGROUP;
  static_assert(DP % 16 == 0 && DV % 8 == 0 && BKT % 16 == 0 && SMEM <= 232448, "tile shapes");
  static_assert(NWG == 2 || NWG == 3, "warpgroups taking turns; registers split 24/240 or 32/160");
};

template <int DP, int DV, int BKT, int NWG, int STAGES>
__global__ void __launch_bounds__(Cfg<DP, DV, BKT, NWG, STAGES>::THREADS, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ out,
                 float* __restrict__ lse, int N, int Nk, int D, float scale_log2) {
  using C = Cfg<DP, DV, BKT, NWG, STAGES>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sQ = align1024(smem_raw);
  unsigned char* sK = sQ + C::Q_BYTES;               // [STAGES][NCB][BKT][64]
  unsigned char* sV = sK + STAGES * C::K_BYTES;      // [STAGES][NCBV][BKT][64]
  uint64_t* full = reinterpret_cast<uint64_t*>(sQ + C::TILES);
  uint64_t* empty = full + STAGES;
  uint64_t* qbar = empty + STAGES;

  const int bh = blockIdx.y, q0 = blockIdx.x * C::BQ, d0 = blockIdx.z * DV;
  const int n_tiles = (Nk + BKT - 1) / BKT;
  const int wg = threadIdx.x / WARPGROUP, tid = threadIdx.x % WARPGROUP;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NWG * 4);  // one arrival per consumer warp
    }
    mbar_init(qbar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == NWG) {
    // ---------------------------------------------------------- producer
    reg_dealloc<NWG == 2 ? 24 : 32>();
    if (tid == 0) {
      mbar_expect_tx(qbar, C::Q_BYTES);
      for (int cb = 0; cb < C::NCB; ++cb) tma_load_3d(sQ + cb * C::BQ * 128, &tq, qbar, cb * 64, q0, bh);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % STAGES;
        mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);  // the first round passes: the ring starts empty
        mbar_expect_tx(&full[s], C::K_BYTES + C::V_BYTES);
        unsigned char* k = sK + s * C::K_BYTES;
        unsigned char* v = sV + s * C::V_BYTES;
        for (int cb = 0; cb < C::NCB; ++cb) tma_load_3d(k + cb * BKT * 128, &tk, &full[s], cb * 64, i * BKT, bh);
        for (int cb = 0; cb < C::NCBV; ++cb)
          tma_load_3d(v + cb * BKT * 128, &tv, &full[s], d0 + cb * 64, i * BKT, bh);
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    reg_alloc<NWG == 2 ? 240 : 160>();
    const int warp = tid / 32, lane = tid % 32, quad = lane & 3;
    const unsigned char* myQ = sQ + wg * 64 * 128;  // this warpgroup's 64 rows of each column block

    float o[DV / 2];
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) o[i] = 0.0f;
    float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.0f, 0.0f};  // l_run: this thread's partial row sums
    float s[BKT / 2];
    uint32_t p[BKT / 16][4];  // P of the tile whose P V is next, as bf16 A fragments

    auto qk = [&](int stage) {
      const unsigned char* k = sK + stage * C::K_BYTES;
      const unsigned char* q = in_place(myQ);
      Wgmma<BKT>::template ss0<0>(s, desc_k(q, C::BQ, 0), desc_k(k, BKT, 0));
#pragma unroll
      for (int kk = 1; kk < DP / 16; ++kk) Wgmma<BKT>::template ss<0>(s, desc_k(q, C::BQ, kk), desc_k(k, BKT, kk));
    };
    auto pv = [&](int stage) {
      const unsigned char* v = sV + stage * C::V_BYTES;
#pragma unroll
      for (int j = 0; j < BKT / 16; ++j) Wgmma<DV>::template rs<1>(o, p[j], desc_mn(v, BKT, 0, j));
    };
    // Online softmax of tile `t` in the exp2 domain, in place on s: returns
    // each row's rescale of the earlier tiles' sums in alpha.
    auto softmax = [&](int t, float (&alpha)[2]) {
      const int j0 = t * BKT;
      if (j0 + BKT > Nk) {
#pragma unroll
        for (int i = 0; i < BKT / 2; ++i)
          if (j0 + 8 * (i / 4) + 2 * quad + (i & 1) >= Nk) s[i] = -INFINITY;
      }
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < BKT / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_new = t == 0 ? mx[h] * scale_log2 : fmaxf(m_run[h], mx[h] * scale_log2);
        alpha[h] = t == 0 ? 0.0f : ex2(m_run[h] - m_new);
        m_run[h] = m_new;
        l_run[h] *= alpha[h];
      }
#pragma unroll
      for (int i = 0; i < BKT / 2; ++i) {
        const int h = (i >> 1) & 1;
        s[i] = ex2(fmaf(s[i], scale_log2, -m_run[h]));
        l_run[h] += s[i];
      }
    };

    // The warpgroups take turns, round robin, to issue their products (named
    // barrier 1 + wg, passed on to the next warpgroup's), so that one's
    // softmax runs while another's products hold the tensor cores. Each
    // issues n_tiles + 1 times; the last warpgroup opens the first turn and
    // passes none after its own last.
    auto my_turn = [&]() { bar_sync(1 + wg, 2 * WARPGROUP); };
    auto your_turn = [&](bool last) {
      if (!(last && wg == NWG - 1)) bar_arrive(1 + (wg + 1) % NWG, 2 * WARPGROUP);
    };
    if (wg == NWG - 1) bar_arrive(1, 2 * WARPGROUP);

    // Tile 0 alone; then S(t) and P(t-1) V(t-1) issued together, the
    // softmax of tile t run while P V is in flight, and O rescaled and P
    // rounded once P V has retired (no register of an in-flight product is
    // written).
    mbar_wait(qbar, 0);
    mbar_wait(&full[0], 0);
    my_turn();
    wgmma_fence();
    qk(0);
    wgmma_commit();
    your_turn(false);
    wgmma_wait<0>();
    fence_regs(s);
    {
      float alpha[2];
      softmax(0, alpha);
    }
    to_a_frags<BKT>(s, p);
    for (int t = 1; t < n_tiles; ++t) {
      const int st = t % STAGES;
      mbar_wait(&full[st], (t / STAGES) & 1);
      my_turn();
      wgmma_fence();
      qk(st);
      wgmma_commit();
      pv((t - 1) % STAGES);
      wgmma_commit();
      your_turn(false);
      wgmma_wait<1>();  // S(t) is in; P(t-1) V(t-1) may still run
      fence_regs(s);
      float alpha[2];
      softmax(t, alpha);
      wgmma_wait<0>();
      fence_regs(o);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[(t - 1) % STAGES]);
#pragma unroll
      for (int i = 0; i < DV / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
      to_a_frags<BKT>(s, p);
    }
    my_turn();
    wgmma_fence();
    pv((n_tiles - 1) % STAGES);
    wgmma_commit();
    your_turn(true);
    wgmma_wait<0>();
    fence_regs(o);

    // Epilogue: full row sums, normalise, store bf16; slice 0 stores the lse.
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 1);
      l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 2);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = q0 + wg * 64 + warp * 16 + (lane >> 2) + 8 * h;
      if (row >= N) continue;
      const float inv = 1.0f / l_run[h];
      __nv_bfloat16* orow = out + ((size_t)bh * N + row) * D;
#pragma unroll
      for (int c = 0; c < DV / 8; ++c) {
        const int col = d0 + 8 * c + 2 * quad;
        if (col < D)  // D % 8 == 0: both columns of the pair are in range
          *reinterpret_cast<__nv_bfloat162*>(orow + col) =
              __floats2bfloat162_rn(o[4 * c + 2 * h] * inv, o[4 * c + 2 * h + 1] * inv);
      }
      if (blockIdx.z == 0 && quad == 0) lse[(size_t)bh * N + row] = (m_run[h] + log2f(l_run[h])) * (1.0f / LOG2E);
    }
  }
}

template <int DP, int DV, int BKT, int NWG, int STAGES>
int launch(const void* q, const void* k, const void* v, void* out, void* lse, int BH, int N, int Nk, int D,
           float scale_log2, cudaStream_t stream) {
  using C = Cfg<DP, DV, BKT, NWG, STAGES>;
  CUtensorMap tq, tk, tv;
  if (int e = tmap_rows_bf16(&tq, q, BH, N, D, C::BQ)) return e;
  if (int e = tmap_rows_bf16(&tk, k, BH, Nk, D, BKT)) return e;
  if (int e = tmap_rows_bf16(&tv, v, BH, Nk, D, BKT)) return e;
  const auto fn = flash_fwd_kernel<DP, DV, BKT, NWG, STAGES>;
  cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((N + C::BQ - 1) / C::BQ, BH, (D + DV - 1) / DV);
  fn<<<grid, C::THREADS, C::SMEM, stream>>>(tq, tk, tv, static_cast<__nv_bfloat16*>(out),
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

// Launches on `stream` and returns 0, a CUDA error, or one of sm90.cuh's
// tensor-map codes (>= 9000). q: (BH, N, D), k and v: (BH, Nk, D), out:
// (BH, N, D), all bf16, contiguous and 16-byte aligned; lse: (BH, N) fp32. D
// must be one that flash_attention_depth takes. scale_log2 = log2(e) /
// sqrt(D), rounded to fp32 by the caller.
extern "C" int flash_attention_fwd_bf16(const void* q, const void* k, const void* v, void* out, void* lse,
                                        int BH, int N, int Nk, int D, float scale_log2, void* stream_) {
  if (BH <= 0 || N <= 0 || Nk <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream_);
  switch (flash_attention_depth(D)) {
    case 48: return launch<48, 48, 128, 3, 4>(q, k, v, out, lse, BH, N, Nk, D, scale_log2, s);
    case 80: return launch<80, 80, 64, 2, 3>(q, k, v, out, lse, BH, N, Nk, D, scale_log2, s);
    case 512: return launch<512, 256, 32, 2, 2>(q, k, v, out, lse, BH, N, Nk, D, scale_log2, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
