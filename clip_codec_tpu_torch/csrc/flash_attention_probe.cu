// Attention probe kernels for Hopper (sm_90a), bf16, no mask: variants of
// the flash-attention forward (csrc/flash_attention.cu) that take one piece
// of its work away at a time, so that timing them says where its time goes.
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
// kernels. expf and exp2f are the accurate library forms (no fast-math):
// the probe measures what each form costs.
//
// What bounds them on an H100: at SD-1.5's head dim 40 one score costs
// 4*D = 160 FLOP on the tensor cores (~6.2e12 scores/s at 989 TFLOP/s) and
// one exponential on the exp unit, which issues 16 ex2 per clock per SM
// (~4.2e12/s over 132 SMs at 1.98 GHz): the exp unit is the tighter limit,
// the tensor cores next; q, k, v and out are ~4*D bytes per query row, far
// below either. The variants exist to measure how far each piece of the
// softmax (scale, max, exp, rescale) sits above those limits.
//
// Design: K4's (mma.sync m16n8k16, FlashAttention-2 order; no TMA or wgmma):
//   * a block owns BQ = 64 or 128 query rows of one (batch, head), one warp
//     per 16 rows; keys and values stream through shared memory in tiles of
//     BKT = 64 or 128 rows, two cp.async stages; BQ and BKT are the probe's
//     tile knobs (the TPU kernels' tq and tk);
//   * the q.k depth is zero-padded in shared memory to 48 (D = 40 or 48);
//     the P.V product runs only the 8-column n-tiles the output needs
//     (5 at D = 40, 6 with P2's ones column), so the ones column's cost is
//     one n-tile;
//   * S stays in registers and its fragments, rounded to bf16, are P.V's A
//     operand, as in K4;
//   * P3 cannot hold a head's K and V (786 KB at N = 4096) or its 64 x 4096
//     fp32 scores (1 MB) on chip, so it computes the same function in two
//     sweeps over the key tiles: S and the exact row max, then S again,
//     p = expf(s - m), l += p and acc += bf16(p) v. The extra Q.K^T is the
//     price of dropping the rescale, which is what it measures;
//   * N % 128 == 0 (so every tile is full: no masks), D in (40, 48).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int DP = 48;        // q.k depth, zero-padded to the MMA's k step
constexpr int LDQ = DP + 8;   // bf16 row stride: an odd multiple of 16 bytes (ldmatrix conflict-free)
constexpr float NEG_INF = -1e30f;

enum Kind { P1 = 0, P2 = 1, P3 = 2 };
// P1 modes, in the order of MODES in ops/attention_probe.py.
enum Mode { FULL = 0, EXP2 = 1, NOSCALE = 2, NOMAX = 3, NOEXP = 4, DOTONLY = 5 };

// DVS: V tile columns in shared memory (48 for D <= 48; 64 for P2, whose
// ones column makes the output D + 1 wide).
template <int BQ, int BKT, int DVS>
struct Tiles {
  static constexpr int THREADS = BQ / 16 * 32;
  static constexpr int LDV = DVS + 8;
  static constexpr int NS = BKT / 8;  // n-tiles of S per warp
  static constexpr int NO = DVS / 8;  // n-tiles of the output, at most
  static constexpr int Q_ELEMS = BQ * LDQ;
  static constexpr int K_ELEMS = BKT * LDQ;
  static constexpr int V_ELEMS = BKT * LDV;
  static constexpr int SMEM = 2 * (Q_ELEMS + 2 * K_ELEMS + 2 * V_ELEMS);
  static_assert(BQ % 16 == 0 && BKT % 16 == 0 && DVS % 16 == 0, "tile shapes");
};

// 2^x from the exponent bits of floor(x) and a polynomial of the fraction
// (bench_attn_probe.py:200-211); the exponent is clamped at -126.
template <int DEG>
__device__ __forceinline__ float poly_exp2(float x) {
  const float xi = floorf(x);
  const float f = x - xi;
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
  const int e = ((int)fmaxf(xi, -126.0f) + 127) << 23;
  return __int_as_float(e) * p;
}

// Row max over this thread's two rows (g = lane / 4: elements 0, 1; g + 8:
// 2, 3), reduced over the quad that shares them.
template <int NS>
__device__ __forceinline__ void row_max(const float (&s)[NS][4], float (&mx)[2]) {
#pragma unroll
  for (int i = 0; i < NS; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[i][e]);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
  }
}

// q: (BH, N, D); k: (BH, N, D); v: (BH, N, ldv), of which the P.V product
// uses the first nv columns; out: (BH, N, D) bf16, or for P2 the (BH, N,
// D + 1) fp32 accumulator. scale: 1/sqrt(D), or P2's 1/sqrt(D) * log2(e).
template <int KIND, int MODE, int DEG, bool MXU, int BQ, int BKT>
__global__ void __launch_bounds__(BQ / 16 * 32)
probe_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
             const __nv_bfloat16* __restrict__ v, void* __restrict__ out, int N, int D, int ldv, int nv,
             float scale) {
  constexpr int DVS = KIND == P2 ? 64 : 48;
  using T = Tiles<BQ, BKT, DVS>;
  constexpr bool SOFTMAX_P1 = KIND == P1 && MODE != NOMAX && MODE != DOTONLY;
  constexpr bool ROW_SUM = (KIND == P1 && MODE != DOTONLY) || (KIND == P2 && !MXU) || KIND == P3;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sK = sQ + T::Q_ELEMS;      // [2][BKT][LDQ]
  __nv_bfloat16* sV = sK + 2 * T::K_ELEMS;  // [2][BKT][LDV]

  const int bh = blockIdx.y, q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const __nv_bfloat16* qb = q + (size_t)bh * N * D;
  const __nv_bfloat16* kb = k + (size_t)bh * N * D;
  const __nv_bfloat16* vb = v + (size_t)bh * N * ldv;

  // Q tile, zero past D.
  for (int e = tid; e < BQ * (DP / 8); e += T::THREADS) {
    const int r = e / (DP / 8), c = (e % (DP / 8)) * 8;
    const bool ok = c < D;
    cp_async16(smem_u32(sQ + r * LDQ + c), ok ? qb + (size_t)(q0 + r) * D + c : q, ok);
  }
  auto load_tile = [&](int stage, int j0, bool with_v) {
    __nv_bfloat16* dk = sK + stage * T::K_ELEMS;
    for (int e = tid; e < BKT * (DP / 8); e += T::THREADS) {
      const int r = e / (DP / 8), c = (e % (DP / 8)) * 8;
      const bool ok = c < D;
      cp_async16(smem_u32(dk + r * LDQ + c), ok ? kb + (size_t)(j0 + r) * D + c : k, ok);
    }
    if (with_v) {
      __nv_bfloat16* dv = sV + stage * T::V_ELEMS;
      for (int e = tid; e < BKT * (DVS / 8); e += T::THREADS) {
        const int r = e / (DVS / 8), c = (e % (DVS / 8)) * 8;
        const bool ok = c < ldv;
        cp_async16(smem_u32(dv + r * T::LDV + c), ok ? vb + (size_t)(j0 + r) * ldv + c : v, ok);
      }
    }
    cp_async_commit();
  };

  // P3 walks the keys twice: the first sweep (S and the row max) loads no V.
  const int n_tiles = N / BKT;
  const int total = KIND == P3 ? 2 * n_tiles : n_tiles;
  load_tile(0, 0, KIND != P3);  // the first group also carries Q

  const int no = (nv + 7) / 8;  // output n-tiles this call needs
  float o[T::NO][4];
#pragma unroll
  for (int i = 0; i < T::NO; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.0f;
  float m_run[2] = {NEG_INF, NEG_INF};
  float l_run[2] = {0.0f, 0.0f};  // this thread's partial row sums

  const int r0 = warp * 16;
  const uint32_t q_addr = smem_u32(sQ + (r0 + (lane & 15)) * LDQ + (lane >> 4) * 8);

  for (int t = 0; t < total; ++t) {
    if (t + 1 < total) {
      load_tile((t + 1) & 1, ((t + 1) % n_tiles) * BKT, KIND != P3 || t + 1 >= n_tiles);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* cK = sK + (t & 1) * T::K_ELEMS;
    const __nv_bfloat16* cV = sV + (t & 1) * T::V_ELEMS;

    // S = Q K^T (fp32, 16 x BKT per warp)
    float s[T::NS][4];
#pragma unroll
    for (int i = 0; i < T::NS; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4(q_addr + kk * 32, a);
#pragma unroll
      for (int np = 0; np < T::NS / 2; ++np) {
        const int mi = lane >> 3;
        const int key = np * 16 + (mi >> 1) * 8 + (lane & 7);
        uint32_t b[4];
        ldsm_x4(smem_u32(cK + key * LDQ + kk * 16 + (mi & 1) * 8), b);
        mma_bf16(s[2 * np], a, b[0], b[1]);
        mma_bf16(s[2 * np + 1], a, b[2], b[3]);
      }
    }

    // s becomes p, the A operand of P.V; alpha rescales the accumulator.
    const bool pv = KIND != P3 || t >= n_tiles;
    float alpha[2] = {1.0f, 1.0f};
    const bool scaled = KIND != P1 || (MODE != NOSCALE && MODE != EXP2);
    if (scaled) {
#pragma unroll
      for (int i = 0; i < T::NS; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[i][e] *= scale;
    }
    if (KIND == P3 && !pv) {
      row_max(s, m_run);  // first sweep: the exact row max, nothing else
    } else if (KIND == P3) {
#pragma unroll
      for (int i = 0; i < T::NS; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[i][e] = expf(s[i][e] - m_run[e >> 1]);
          l_run[e >> 1] += s[i][e];
        }
    } else if (KIND == P1 && MODE == NOMAX) {
#pragma unroll
      for (int i = 0; i < T::NS; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[i][e] = expf(s[i][e]);
          l_run[e >> 1] += s[i][e];
        }
    } else if (SOFTMAX_P1 || KIND == P2) {
      float mx[2] = {m_run[0], m_run[1]};
      row_max(s, mx);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float d = m_run[h] - mx[h];
        alpha[h] = (KIND == P1 && MODE == NOEXP) ? d
                   : (KIND == P2 || MODE == EXP2) ? exp2f(d) : expf(d);
        m_run[h] = mx[h];
        l_run[h] *= alpha[h];
      }
#pragma unroll
      for (int i = 0; i < T::NS; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = s[i][e] - mx[e >> 1];
          float p;
          if (KIND == P2)
            p = DEG ? poly_exp2<DEG == 3 ? 3 : 2>(x) : exp2f(x);
          else
            p = MODE == NOEXP ? x : MODE == EXP2 ? exp2f(x) : expf(x);
          s[i][e] = p;
          if (ROW_SUM) l_run[e >> 1] += p;
        }
#pragma unroll
      for (int i = 0; i < T::NO; ++i) {
        o[i][0] *= alpha[0];
        o[i][1] *= alpha[0];
        o[i][2] *= alpha[1];
        o[i][3] *= alpha[1];
      }
    }  // DOTONLY: p = s * scale

    // O += P V over the n-tiles the output needs, P rounded to bf16
    if (pv) {
#pragma unroll
      for (int j = 0; j < BKT / 16; ++j) {
        uint32_t a[4];
        a[0] = pack_bf16(s[2 * j][0], s[2 * j][1]);
        a[1] = pack_bf16(s[2 * j][2], s[2 * j][3]);
        a[2] = pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]);
        a[3] = pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3]);
#pragma unroll
        for (int np = 0; np < T::NO / 2; ++np) {
          if (2 * np >= no) break;
          const int mi = lane >> 3;
          const int key = j * 16 + (mi & 1) * 8 + (lane & 7);
          uint32_t b[4];
          ldsm_x4_trans(smem_u32(cV + key * T::LDV + np * 16 + (mi >> 1) * 8), b);
          mma_bf16(o[2 * np], a, b[0], b[1]);
          if (2 * np + 1 < no) mma_bf16(o[2 * np + 1], a, b[2], b[3]);
        }
      }
    }
    __syncthreads();  // this stage is refilled by the next iteration's loads
  }

  // Epilogue: full row sums; P2 stores the raw accumulator, the others out = acc / l in bf16.
  const int g = lane >> 2;
  if (ROW_SUM) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 1);
      l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 2);
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const size_t row = (size_t)bh * N + q0 + r0 + g + 8 * h;
    if (KIND == P2) {
      float* orow = static_cast<float*>(out) + row * (D + 1);  // 4-byte aligned rows: element-wise stores
#pragma unroll
      for (int i = 0; i < T::NO; ++i) {
        const int col = i * 8 + 2 * (lane & 3);
        if (col < nv) orow[col] = o[i][2 * h];
        if (col + 1 < nv) orow[col + 1] = o[i][2 * h + 1];
      }
      if (!MXU && (lane & 3) == 0) orow[D] = l_run[h];
    } else {
      const float l = ROW_SUM ? l_run[h] : 1.0f;
      __nv_bfloat16* orow = static_cast<__nv_bfloat16*>(out) + row * D;
#pragma unroll
      for (int i = 0; i < T::NO; ++i) {
        const int col = i * 8 + 2 * (lane & 3);
        if (col < D)  // D % 8 == 0: both columns of the pair are in range
          *reinterpret_cast<__nv_bfloat162*>(orow + col) =
              __floats2bfloat162_rn(o[i][2 * h] / l, o[i][2 * h + 1] / l);
      }
    }
  }
}

template <int KIND, int MODE, int DEG, bool MXU, int BQ, int BKT>
int launch(const void* q, const void* k, const void* v, void* out, int BH, int N, int D, int ldv, int nv,
           float scale, cudaStream_t stream) {
  using T = Tiles<BQ, BKT, KIND == P2 ? 64 : 48>;
  const auto fn = probe_kernel<KIND, MODE, DEG, MXU, BQ, BKT>;
  cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (e != cudaSuccess) return (int)e;
  fn<<<dim3(N / BQ, BH), T::THREADS, T::SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), out, N, D, ldv, nv, scale);
  return (int)cudaGetLastError();
}

bool shape_ok(int BH, int N, int D) {
  return BH > 0 && BH <= 65535 && N > 0 && N % 128 == 0 && (D == 40 || D == 48);
}

}  // namespace

// Each entry point launches on `stream` and returns cudaGetLastError() (0 on
// success), or cudaErrorInvalidValue for a shape or variant with no kernel.
// q, k, v: (BH, N, D) bf16, contiguous; N % 128 == 0, D in (40, 48).

// P1: out (BH, N, D) bf16. mode: 0 full, 1 exp2 (q already holds q * scale *
// log2(e)), 2 noscale, 3 nomax, 4 noexp, 5 dotonly; scale = 1/sqrt(D).
extern "C" int attn_probe_variant_bf16(const void* q, const void* k, const void* v, void* out, int BH,
                                       int N, int D, int bq, int bkt, int mode, float scale,
                                       void* stream_) {
  if (!shape_ok(BH, N, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream_);
#define P1_CASE(M, BQ_, BKT_) \
  if (mode == M && bq == BQ_ && bkt == BKT_) return launch<P1, M, 0, false, BQ_, BKT_>(q, k, v, out, BH, N, D, D, D, scale, s)
  P1_CASE(FULL, 64, 64);
  P1_CASE(EXP2, 64, 64);
  P1_CASE(NOSCALE, 64, 64);
  P1_CASE(NOMAX, 64, 64);
  P1_CASE(NOEXP, 64, 64);
  P1_CASE(DOTONLY, 64, 64);
  P1_CASE(FULL, 64, 128);
  P1_CASE(EXP2, 64, 128);
  P1_CASE(FULL, 128, 64);
  P1_CASE(EXP2, 128, 64);
  P1_CASE(FULL, 128, 128);
  P1_CASE(EXP2, 128, 128);
#undef P1_CASE
  return (int)cudaErrorInvalidValue;
}

// P2: out (BH, N, D + 1) fp32, the raw accumulator. v: (BH, N, ldv); with
// mxu = 1 its column D is ones (ldv = D + 1 rounded up to 8, the padding
// zero), else ldv = D. deg: 0 (exp2f), 2 or 3; scale = log2(e)/sqrt(D).
extern "C" int attn_probe_fast_bf16(const void* q, const void* k, const void* v, void* out, int BH, int N,
                                    int D, int ldv, int bq, int bkt, int deg, int mxu, float scale,
                                    void* stream_) {
  if (!shape_ok(BH, N, D)) return (int)cudaErrorInvalidValue;
  const int nv = mxu ? D + 1 : D;
  if (ldv % 8 != 0 || ldv < nv || ldv > 64 || (!mxu && ldv != D)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream_);
#define P2_CASE(DEG_, MXU_, BQ_, BKT_)                                                 \
  if (deg == DEG_ && mxu == MXU_ && bq == BQ_ && bkt == BKT_)                          \
  return launch<P2, 0, DEG_, (MXU_ == 1), BQ_, BKT_>(q, k, v, out, BH, N, D, ldv, nv, scale, s)
  P2_CASE(0, 1, 64, 64);
  P2_CASE(2, 0, 64, 64);
  P2_CASE(2, 1, 64, 64);
  P2_CASE(3, 1, 64, 64);
  P2_CASE(2, 1, 64, 128);
  P2_CASE(2, 1, 128, 64);
  P2_CASE(2, 1, 128, 128);
#undef P2_CASE
  return (int)cudaErrorInvalidValue;
}

// P3: out (BH, N, D) bf16; scale = 1/sqrt(D).
extern "C" int attn_probe_single_pass_bf16(const void* q, const void* k, const void* v, void* out, int BH,
                                           int N, int D, int bq, float scale, void* stream_) {
  if (!shape_ok(BH, N, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream_);
  if (bq == 64) return launch<P3, 0, 0, false, 64, 64>(q, k, v, out, BH, N, D, D, D, scale, s);
  if (bq == 128) return launch<P3, 0, 0, false, 128, 64>(q, k, v, out, BH, N, D, D, D, scale, s);
  return (int)cudaErrorInvalidValue;
}
