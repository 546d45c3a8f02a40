// Attention probe kernels for Hopper (sm_90a), bf16, no mask: variants of
// the flash-attention forward (csrc/flash_attention.cu, K4) that take one
// piece of its work away at a time, so that timing them says where its time
// goes.
//
// Replaces the three TPU kernels of bench_attn_probe.py:
//   P1  _kernel (:103, entered through flash_variant :161): the online
//       softmax in six modes, selected at compile time:
//         full     s*scale, running max, expf, rescale by alpha (production);
//         exp2     no scale multiply (the caller folded scale*log2(e) into q
//                  in bf16), exp2f;
//         noscale  full without the scale multiply;
//         nomax    p = expf(s*scale), no max, no rescale (overflows at large
//                  logits by design);
//         noexp    alpha = m_prev - m_cur, p = s*scale - m_cur: no exp (the
//                  output depends on the key-tile width);
//         dotonly  acc += bf16(s*scale) v, no softmax.
//   P2  _fast_kernel (:214, through fast_flash :255): the exp2-domain forward
//       with the logits scaled by scale*log2(e) in fp32, p from a polynomial
//       exp2 of degree 2 or 3 on the FMA pipe (or exp2f), alpha always exp2f,
//       and the row sum carried by the P.V product through the ones column
//       the caller appended to v (mxu-sum: it sums the bf16-rounded p) or
//       summed from the fp32 p (vpu-sum); writes the raw fp32 (BH, N, D+1)
//       accumulator, whose last column is the row sum (the caller divides).
//   P3  _sp_kernel (:281, through single_pass :293): the softmax with the
//       exact row max over all N keys and no online rescale.
// In every form p is rounded to bf16 for the P.V product, the accumulator
// is fp32, and the running max starts at the finite -1e30, as in the TPU
// kernels. expf and exp2f are the accurate library forms (no fast-math, not
// sm90.cuh's ex2.approx): the probe measures what each form costs, so P1
// `full` against K4 is "expf and a separate scale multiply" against
// "ex2.approx on one fused multiply-add".
//
// What bounds them on an H100: at SD-1.5's head dim 40 one score costs
// 4*D = 160 FLOP on the tensor cores (~6.2e12 scores/s at 989 TFLOP/s) and
// one exponential on the exp unit, which issues 16 ex2 per clock per SM
// (~4.2e12/s over 132 SMs at 1.98 GHz): the exp unit is the tighter limit,
// the tensor cores next; the softmax's other instructions per score (max,
// subtract, sum, bf16 pack, and expf's range reduction) share the SM's 128
// issue lanes a clock. q, k, v and out are ~4*D bytes per query row, far
// below either. P2's polynomial moves the exponential off the exp unit:
// poly_exp2 is 5 + DEG FP32 and integer instructions a score, none of them
// a conversion, so P2 is bound by the issue of its softmax's instructions.
//
// Design: K4's (wgmma fed by TMA, warp-specialised, on sm90.cuh; see
// flash_attention.cu), one kernel template for P1, P2 and P3 with the
// form's softmax in place of K4's:
//   * a block owns BQ = 64 * NWG query rows of one (batch, head): NWG = 2 or
//     3 consumer warpgroups of 64 rows each and one producer warp, whose
//     warpgroup gives its registers to the consumers with setmaxnreg;
//   * the producer loads Q once and streams tiles of BKT keys through a ring
//     of STAGES shared-memory stages with TMA (3-D maps: the q.k depth and
//     the P.V width are padded from 40 to 48 by TMA's zero fill, and query
//     rows past N read as zero and are not stored, so the last query tile
//     may be partial; N % 128 == 0 keeps every key tile full). The ring holds
//     128 KB: STAGES = 4 at BKT = 128, 8 at BKT = 64;
//   * S = Q K^T is one wgmma chain per warpgroup; the mode's softmax runs on
//     S's fp32 accumulator; P, rounded to bf16, is the register A operand of
//     O += P V (N = PVN = 48), so P never touches shared memory;
//   * each warpgroup issues S(t) and P(t-1) V(t-1) together and runs the
//     softmax of tile t while P V is in flight, touching O (alpha's rescale)
//     only after it has retired; the warpgroups take turns to issue (named
//     barriers, round robin), so one's softmax overlaps another's products;
//   * P3 cannot hold a head's 4096 x 4096 scores on chip, so it computes the
//     same function in two sweeps within the kernel, on one ring: sweep 1
//     streams K alone (half the bytes) for S and each thread's running max
//     (fmaxf, no exp; the quad's max and the scale once at the end, which
//     is the max of the scaled logits: the scale is positive and rounding
//     monotonic); sweep 2 streams K and V for S again and p = expf(s*scale -
//     m), l += p, O += bf16(p) V: K4's loop without a rescale. The ring's
//     stage index and parity run on across the sweeps (2 N / BKT loads);
//   * P2 (FAST) maps v at its own width ldv, so the caller's ones column
//     (column D of ldv = D + 1 rounded up to 8) lands in the P.V product's
//     zero padding: at D = 40 column 40 of 48, for no extra tensor-core
//     work; at D = 48 the product widens to PVN = 64. The ones column is
//     rescaled with the rest of O, so the mxu-sum's row sum costs no
//     instruction; the vpu-sum keeps fp32 partial sums as P1 does. The
//     polynomial exp2 (poly_exp2) issues no conversion instruction. The
//     epilogue writes the raw fp32 accumulator row by row, element-wise:
//     its (D + 1) * 4-byte rows are only 4-byte aligned.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr float NEG_INF = -1e30f;

// P1 modes, in the order of MODES in ops/attention_probe.py, P3's softmax
// as a seventh and P2's as an eighth.
enum Mode { FULL = 0, EXP2 = 1, NOSCALE = 2, NOMAX = 3, NOEXP = 4, DOTONLY = 5, SINGLE_PASS = 6, FAST = 7 };

namespace hopper {

using namespace sm90;

constexpr int DP = 48;  // q.k depth and P.V width, TMA's zero fill past D = 40

// 2^x as bench_attn_probe.py's fast_exp2 (:200-211): the exponent bits of
// floor(x), clamped at -126, times a degree-DEG polynomial of x - floor(x)
// (so x < -126 gives 2^-126 p(frac x), not 0). floorf and an int
// conversion would issue FRND and F2I, 16 a clock per SM like the exp unit
// the polynomial is there to spare; here every instruction is an FP32 or
// integer add, FMA or max. t = x + 1.5 * 2^23 rounded down is
// 1.5 * 2^23 + floor(x) exactly for |x| <= 2^22, so its bits are
// MAGIC's plus floor(x), and MAGIC's bits shifted by 23 are 0: t's bits
// << 23 are floor(x) << 23, added to p's exponent (p in [1, 2]; the clamp
// keeps the sum a normal float). Unsigned, so the shift out of the top bit
// and the wrapping add are defined. Below -2^22 (no logit gets there) the
// fraction may be off, and the result stays in [2^-126, 2^-125].
template <int DEG>
__device__ __forceinline__ float poly_exp2(float x) {
  constexpr float MAGIC = 12582912.0f;  // 1.5 * 2^23
  const float t = __fadd_rd(x, MAGIC);
  const float f = x - (t - MAGIC);  // exact: x's own fraction bits
  float p;
  if (DEG == 2) {
    p = 0.34382616f;
    p = p * f + 0.65617384f;
    p = p * f + 1.0f;
  } else {
    p = 0.07806503f;
    p = p * f + 0.22610143f;
    p = p * f + 0.69583354f;
    p = p * f + 1.0f;
  }
  const float tc = fmaxf(t, MAGIC - 126.0f);
  return __uint_as_float(__float_as_uint(p) + (__float_as_uint(tc) << 23));
}

// BKT: keys per tile; NWG: consumer warpgroups (64 query rows each); STAGES: ring depth.
template <int BKT, int NWG, int STAGES>
struct Cfg {
  static constexpr int BQ = 64 * NWG;
  static constexpr int Q_BYTES = BQ * 128;  // one 64-column block: DP <= 64
  static constexpr int K_BYTES = BKT * 128;
  static constexpr int V_BYTES = BKT * 128;
  static constexpr int TILES = Q_BYTES + STAGES * (K_BYTES + V_BYTES);
  static constexpr int SMEM = 1024 + TILES + (2 * STAGES + 1) * 8;  // alignment slack, tiles, barriers
  static constexpr int THREADS = (NWG + 1) * WARPGROUP;
  static_assert(BKT % 16 == 0 && SMEM <= 232448, "tile shapes");
  static_assert(NWG == 2 || NWG == 3, "warpgroups taking turns; registers split 24/240 or 32/160");
};

// q, k: (BH, N, D) through the maps tq, tk; v through tv: (BH, N, D), or
// for P2 (BH, N, ldv) with, under MXU, ones in column D. out: P1 and P3
// (BH, N, D) bf16; P2 the raw (BH, N, D + 1) fp32 accumulator, whose
// column D is the row sum (from v's ones column under MXU, else from the
// fp32 p). scale: 1/sqrt(D) (unused by noscale and exp2), P2 log2(e)/sqrt(D).
// PVN: the P.V width (48; P2 64 when D + 1 > 48). DEG: P2's exp2, 0 (exp2f),
// 2 or 3 (poly_exp2).
template <int MODE, int BKT, int NWG, int STAGES, int PVN, int DEG, bool MXU>
__global__ void __launch_bounds__(Cfg<BKT, NWG, STAGES>::THREADS, 1)
probe_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
             const __grid_constant__ CUtensorMap tv, void* __restrict__ out, int N, int D, float scale) {
  using C = Cfg<BKT, NWG, STAGES>;
  constexpr bool P3 = MODE == SINGLE_PASS, P2 = MODE == FAST;
  constexpr bool SCALED = MODE != NOSCALE && MODE != EXP2;
  constexpr bool RESCALE = MODE == FULL || MODE == EXP2 || MODE == NOSCALE || MODE == NOEXP || P2;  // online max, alpha
  constexpr bool ROW_SUM = MODE != DOTONLY && !(P2 && MXU);  // l summed from p in registers
  static_assert(PVN == DP || (P2 && MXU && PVN == 64), "P.V width");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sQ = align1024(smem_raw);
  unsigned char* sK = sQ + C::Q_BYTES;           // [STAGES][BKT][64]
  unsigned char* sV = sK + STAGES * C::K_BYTES;  // [STAGES][BKT][64]
  uint64_t* full = reinterpret_cast<uint64_t*>(sQ + C::TILES);
  uint64_t* empty = full + STAGES;
  uint64_t* qbar = empty + STAGES;

  const int bh = blockIdx.y, q0 = blockIdx.x * C::BQ;
  const int n_tiles = N / BKT;
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
      tma_load_3d(sQ, &tq, qbar, 0, q0, bh);
      // P3: n_tiles loads of K alone (sweep 1), then n_tiles of K and V.
      const int loads = P3 ? 2 * n_tiles : n_tiles;
      for (int i = 0; i < loads; ++i) {
        const int s = i % STAGES, key0 = (i % n_tiles) * BKT;
        const bool with_v = !P3 || i >= n_tiles;
        mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);  // the first round passes: the ring starts empty
        mbar_expect_tx(&full[s], with_v ? C::K_BYTES + C::V_BYTES : C::K_BYTES);
        tma_load_3d(sK + s * C::K_BYTES, &tk, &full[s], 0, key0, bh);
        if (with_v) tma_load_3d(sV + s * C::V_BYTES, &tv, &full[s], 0, key0, bh);
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    reg_alloc<NWG == 2 ? 240 : 160>();
    const int warp = tid / 32, lane = tid % 32;
    const unsigned char* myQ = sQ + wg * 64 * 128;  // this warpgroup's 64 rows

    float o[PVN / 2];
#pragma unroll
    for (int i = 0; i < PVN / 2; ++i) o[i] = 0.0f;
    float m_run[2] = {NEG_INF, NEG_INF}, l_run[2] = {0.0f, 0.0f};  // l_run: this thread's partial row sums
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
      for (int j = 0; j < BKT / 16; ++j) Wgmma<PVN>::template rs<1>(o, p[j], desc_mn(v, BKT, 0, j));
    };
    // The mode's softmax of one tile, in place on s (s[i] holds row
    // (i >> 1) & 1 of this thread's two); alpha: the rescale of the earlier
    // tiles' sums (RESCALE modes). Touches neither o nor p.
    auto softmax = [&](float (&alpha)[2]) {
      if (SCALED) {
#pragma unroll
        for (int i = 0; i < BKT / 2; ++i) s[i] *= scale;
      }
      if (P3) {
#pragma unroll
        for (int i = 0; i < BKT / 2; ++i) {
          const int h = (i >> 1) & 1;
          s[i] = expf(s[i] - m_run[h]);
          l_run[h] += s[i];
        }
      } else if (MODE == NOMAX) {
#pragma unroll
        for (int i = 0; i < BKT / 2; ++i) {
          s[i] = expf(s[i]);
          l_run[(i >> 1) & 1] += s[i];
        }
      } else if (RESCALE) {
        float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
        for (int i = 0; i < BKT / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
          const float d = m_run[h] - mx[h];
          alpha[h] = MODE == NOEXP ? d : MODE == EXP2 || P2 ? exp2f(d) : expf(d);
          m_run[h] = mx[h];
          l_run[h] *= alpha[h];
        }
#pragma unroll
        for (int i = 0; i < BKT / 2; ++i) {
          const int h = (i >> 1) & 1;
          const float x = s[i] - m_run[h];
          s[i] = MODE == NOEXP ? x : P2 && DEG ? poly_exp2<DEG == 3 ? 3 : 2>(x) : MODE == EXP2 || P2 ? exp2f(x) : expf(x);
          if (ROW_SUM) l_run[h] += s[i];
        }
      }  // DOTONLY: p = s * scale
    };

    // The warpgroups take turns, round robin, to issue their products (named
    // barrier 1 + wg, passed on to the next warpgroup's), so that one's
    // softmax runs while another's products hold the tensor cores. Each
    // issues as often as the others (n_tiles + 1 times, P3 2 n_tiles + 1);
    // the last warpgroup opens the first turn and passes none after its own
    // last.
    auto my_turn = [&]() { bar_sync(1 + wg, 2 * WARPGROUP); };
    auto your_turn = [&](bool last) {
      if (!(last && wg == NWG - 1)) bar_arrive(1 + (wg + 1) % NWG, 2 * WARPGROUP);
    };
    if (wg == NWG - 1) bar_arrive(1, 2 * WARPGROUP);
    mbar_wait(qbar, 0);

    int j0 = 0;  // the ring's load index of the first tile of the loop below
    if (P3) {
      // Sweep 1: S and this thread's running max of its two rows; a stage
      // is released as soon as its S is in.
      float mx[2] = {-INFINITY, -INFINITY};
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % STAGES;
        mbar_wait(&full[st], (t / STAGES) & 1);
        my_turn();
        wgmma_fence();
        qk(st);
        wgmma_commit();
        your_turn(false);
        wgmma_wait<0>();
        fence_regs(s);
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[st]);
#pragma unroll
        for (int i = 0; i < BKT / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        m_run[h] = fmaxf(m_run[h], mx[h] * scale);
      }
      j0 = n_tiles;
    }

    // P1, and P3's sweep 2: tile 0 alone; then S(t) and P(t-1) V(t-1)
    // issued together, the softmax of tile t run while P V is in flight,
    // and O rescaled and P rounded once P V has retired (no register of an
    // in-flight product is written).
    mbar_wait(&full[j0 % STAGES], (j0 / STAGES) & 1);
    my_turn();
    wgmma_fence();
    qk(j0 % STAGES);
    wgmma_commit();
    your_turn(false);
    wgmma_wait<0>();
    fence_regs(s);
    {
      float alpha[2];  // o is still zero: no rescale
      softmax(alpha);
    }
    to_a_frags<BKT>(s, p);
    for (int t = 1; t < n_tiles; ++t) {
      const int j = j0 + t, st = j % STAGES, prev = (j - 1) % STAGES;
      mbar_wait(&full[st], (j / STAGES) & 1);
      my_turn();
      wgmma_fence();
      qk(st);
      wgmma_commit();
      pv(prev);
      wgmma_commit();
      your_turn(false);
      wgmma_wait<1>();  // S(t) is in; P(t-1) V(t-1) may still run
      fence_regs(s);
      float alpha[2];
      softmax(alpha);
      wgmma_wait<0>();
      fence_regs(o);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[prev]);
      if (RESCALE) {
#pragma unroll
        for (int i = 0; i < PVN / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
      }
      to_a_frags<BKT>(s, p);
    }
    my_turn();
    wgmma_fence();
    pv((j0 + n_tiles - 1) % STAGES);
    wgmma_commit();
    your_turn(true);
    wgmma_wait<0>();
    fence_regs(o);

    // Epilogue: full row sums; P1 and P3 out = acc / l in bf16, P2 the raw
    // accumulator and (vpu-sum) l in column D. Rows past N are not stored.
    if (ROW_SUM) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 1);
        l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 2);
      }
    }
    const int quad = lane & 3;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = q0 + wg * 64 + warp * 16 + (lane >> 2) + 8 * h;
      if (row >= N) continue;
      if (P2) {
        const int nv = MXU ? D + 1 : D;
        float* orow = static_cast<float*>(out) + ((size_t)bh * N + row) * (D + 1);  // 4-byte aligned rows
#pragma unroll
        for (int c = 0; c < PVN / 8; ++c) {
          const int col = 8 * c + 2 * quad;
          if (col < nv) orow[col] = o[4 * c + 2 * h];
          if (col + 1 < nv) orow[col + 1] = o[4 * c + 2 * h + 1];
        }
        if (!MXU && quad == 0) orow[D] = l_run[h];
        continue;
      }
      const float l = ROW_SUM ? l_run[h] : 1.0f;
      __nv_bfloat16* orow = static_cast<__nv_bfloat16*>(out) + ((size_t)bh * N + row) * D;
#pragma unroll
      for (int c = 0; c < DP / 8; ++c) {
        const int col = 8 * c + 2 * quad;
        if (col < D)  // D % 8 == 0: both columns of the pair are in range
          *reinterpret_cast<__nv_bfloat162*>(orow + col) =
              __floats2bfloat162_rn(o[4 * c + 2 * h] / l, o[4 * c + 2 * h + 1] / l);
      }
    }
  }
}

// v: (BH, N, ldv); the box of 64 columns zero-fills past ldv.
template <int MODE, int BQ, int BKT, int PVN = DP, int DEG = 0, bool MXU = false>
int launch(const void* q, const void* k, const void* v, void* out, int BH, int N, int D, int ldv, float scale,
           cudaStream_t stream) {
  constexpr int NWG = BQ / 64, STAGES = BKT == 128 ? 4 : 8;
  using C = Cfg<BKT, NWG, STAGES>;
  static_assert(C::BQ == BQ, "64 query rows per consumer warpgroup");
  CUtensorMap mq, mk, mv;
  if (int e = tmap_rows_bf16(&mq, q, BH, N, D, BQ)) return e;
  if (int e = tmap_rows_bf16(&mk, k, BH, N, D, BKT)) return e;
  if (int e = tmap_rows_bf16(&mv, v, BH, N, ldv, BKT)) return e;
  const auto fn = probe_kernel<MODE, BKT, NWG, STAGES, PVN, DEG, MXU>;
  cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (e != cudaSuccess) return (int)e;
  fn<<<dim3((N + BQ - 1) / BQ, BH), C::THREADS, C::SMEM, stream>>>(mq, mk, mv, out, N, D, scale);
  return (int)cudaGetLastError();
}

// P2 at the P.V width its nv = D + 1 (MXU) or D columns need.
template <int DEG, bool MXU, int BQ, int BKT>
int launch_fast(const void* q, const void* k, const void* v, void* out, int BH, int N, int D, int ldv, float scale,
                cudaStream_t stream) {
  if ((MXU ? D + 1 : D) <= DP) return launch<FAST, BQ, BKT, DP, DEG, MXU>(q, k, v, out, BH, N, D, ldv, scale, stream);
  if constexpr (MXU) return launch<FAST, BQ, BKT, 64, DEG, MXU>(q, k, v, out, BH, N, D, ldv, scale, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace hopper

bool shape_ok(int BH, int N, int D) {
  return BH > 0 && BH <= 65535 && N > 0 && N % 128 == 0 && (D == 40 || D == 48);
}

}  // namespace

// Each entry point launches on `stream` and returns 0, a CUDA error, one of
// sm90.cuh's tensor-map codes (>= 9000), or cudaErrorInvalidValue for a
// shape or variant with no kernel. q, k, v: (BH, N, D) bf16, contiguous,
// 16-byte aligned; N % 128 == 0, D in (40, 48).

// P1: out (BH, N, D) bf16. mode: 0 full, 1 exp2 (q already holds q * scale *
// log2(e)), 2 noscale, 3 nomax, 4 noexp, 5 dotonly; scale = 1/sqrt(D).
// (bq, bkt): the six modes at (192, 128), K4's own tile; full and exp2 also
// at (128, 128), (192, 64) and (128, 64).
extern "C" int attn_probe_variant_bf16(const void* q, const void* k, const void* v, void* out, int BH,
                                       int N, int D, int bq, int bkt, int mode, float scale,
                                       void* stream_) {
  if (!shape_ok(BH, N, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream_);
#define P1_CASE(M, BQ_, BKT_) \
  if (mode == M && bq == BQ_ && bkt == BKT_) return hopper::launch<M, BQ_, BKT_>(q, k, v, out, BH, N, D, D, scale, s)
  P1_CASE(FULL, 192, 128);
  P1_CASE(EXP2, 192, 128);
  P1_CASE(NOSCALE, 192, 128);
  P1_CASE(NOMAX, 192, 128);
  P1_CASE(NOEXP, 192, 128);
  P1_CASE(DOTONLY, 192, 128);
  P1_CASE(FULL, 128, 128);
  P1_CASE(EXP2, 128, 128);
  P1_CASE(FULL, 192, 64);
  P1_CASE(EXP2, 192, 64);
  P1_CASE(FULL, 128, 64);
  P1_CASE(EXP2, 128, 64);
#undef P1_CASE
  return (int)cudaErrorInvalidValue;
}

// P2: out (BH, N, D + 1) fp32, the raw accumulator. v: (BH, N, ldv); with
// mxu = 1 its column D is ones (ldv = D + 1 rounded up to 8, the padding
// zero), else ldv = D. deg: 0 (exp2f), 2 or 3; scale = log2(e)/sqrt(D).
// (bq, bkt): the four forms (deg, mxu) = (0, 1), (2, 0), (2, 1), (3, 1) at
// (192, 128); (2, 1) also at (128, 128), (192, 64) and (128, 64).
extern "C" int attn_probe_fast_bf16(const void* q, const void* k, const void* v, void* out, int BH, int N,
                                    int D, int ldv, int bq, int bkt, int deg, int mxu, float scale,
                                    void* stream_) {
  if (!shape_ok(BH, N, D)) return (int)cudaErrorInvalidValue;
  if (ldv % 8 != 0 || ldv > 64 || ldv != (mxu ? (D + 8) / 8 * 8 : D)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream_);
#define P2_CASE(DEG_, MXU_, BQ_, BKT_)                        \
  if (deg == DEG_ && mxu == MXU_ && bq == BQ_ && bkt == BKT_) \
  return hopper::launch_fast<DEG_, (MXU_ == 1), BQ_, BKT_>(q, k, v, out, BH, N, D, ldv, scale, s)
  P2_CASE(0, 1, 192, 128);
  P2_CASE(2, 0, 192, 128);
  P2_CASE(2, 1, 192, 128);
  P2_CASE(3, 1, 192, 128);
  P2_CASE(2, 1, 128, 128);
  P2_CASE(2, 1, 192, 64);
  P2_CASE(2, 1, 128, 64);
#undef P2_CASE
  return (int)cudaErrorInvalidValue;
}

// P3: out (BH, N, D) bf16; scale = 1/sqrt(D). bq: 128 or 192 query rows a
// block, over key tiles of 128.
extern "C" int attn_probe_single_pass_bf16(const void* q, const void* k, const void* v, void* out, int BH,
                                           int N, int D, int bq, float scale, void* stream_) {
  if (!shape_ok(BH, N, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream_);
  if (bq == 128) return hopper::launch<SINGLE_PASS, 128, 128>(q, k, v, out, BH, N, D, D, scale, s);
  if (bq == 192) return hopper::launch<SINGLE_PASS, 192, 128>(q, k, v, out, BH, N, D, D, scale, s);
  return (int)cudaErrorInvalidValue;
}
