// Transformer MLP tail for Hopper (sm_90a), bf16 activations:
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
// What bounds it on an H100: three products of 2 C F FLOP per row (F = 4 C)
// against 4 C bytes of x and y per row, far above the card's ~295 bf16
// FLOP/byte ridge: the tensor cores, and what feeds them. At few rows
// (R = 128) the 3 C F weight bytes bound it instead.
//
// Why the TPU's one fused kernel is two here: the TPU keeps the (rows, C)
// fp32 output accumulator in VMEM beside the hidden tile, so h never leaves
// the core. On Hopper the accumulator lives in registers, and at C = 1280 a
// 128-row tile of it is 640 KB, more than an SM's 256 KB register file; a
// fused kernel has to shrink its row tile until each block streams all of
// the weights for a handful of rows. So the hidden makes one round trip
// through L2 / device memory (2 R F 2 bytes), and every weight tile is
// fetched into shared memory once per 128-row tile:
//
//   mlp_ln_kernel    xn = LN(x), bf16, one warp per row (a pre-pass: normalising
//                    each x tile in place in mlp_up would redo it in every one of
//                    the F / 64 column tiles of a row tile, 20-80 times);
//   mlp_up_kernel    h = GEGLU(xn . [wh | wg]) over 128-row x 128-column tiles of
//                    the packed weights (64 columns of wh, then the same 64 of
//                    wg), so one m64n128 product per 64 rows gives a and g of
//                    64 hidden columns side by side in the accumulator; the
//                    epilogue adds the biases, rounds a and g, gates and
//                    stores bf16 h. Persistent, one block an SM: two consumer
//                    warpgroups take the tiles in turns, so one's epilogue (the
//                    erf GELU of 64 values a thread) overlaps the other's
//                    products;
//   mlp_down_kernel  y = h . wo over 128 x 160 tiles (C / 160 = 2, 4 or 8 column
//                    tiles), one consumer warpgroup a block, two blocks an SM;
//                    where the tiles would leave most SMs idle, the depth F is
//                    split over blocks that write fp32 partials, and
//                    sum_splits_kernel adds them in split order and rounds
//                    (deterministic). The split count is the caller's
//                    (ops/mlp.py: down_splits).
//
// Both products run on wgmma fed by TMA (csrc/sm90.cuh): A (the activations)
// and B (the weights) by descriptor from 128-byte-swizzled shared memory,
// both K-major, two m64 halves per 128-row tile; a producer warpgroup's
// first thread keeps a ring of (A, B) stages of 64-deep boxes in flight on
// full / empty mbarriers, and setmaxnreg moves its registers to the
// consumers.
//
// Weight layouts (ops/mlp.py: pack_weights builds them once per load):
//   wup   (2F, C) bf16, K-major: rows [128 t, 128 t + 64) are wh[:, 64 t : 64 t + 64]
//         transposed, rows [128 t + 64, 128 t + 128) the same columns of wg;
//   wdown (C, F) bf16, K-major: wo transposed (an nn.Linear(F, C) weight as stored).
// Rows past R read as zero (TMA's fill) and are never stored.

#include <math.h>

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr float LN_EPS = 1e-6f;
constexpr int BM = 128;     // rows per tile: two m64 halves
constexpr int BK = 64;      // depth per stage: one 128-byte swizzled row
constexpr int UP_N = 128;   // packed columns per mlp_up tile: 64 hidden columns of a, then of g
constexpr int HID = UP_N / 2;
constexpr int DOWN_N = 160;  // output columns per mlp_down tile
constexpr int DOWN_STAGES = 3;
constexpr int SMEM_LIMIT = 232448;
constexpr int DOWN_THREADS = 2 * WARPGROUP;  // consumer warpgroup, producer warpgroup
constexpr int CONSUMER_WARPS = 4;

template <int N>
struct Gemm {
  static constexpr int A_BYTES = BM * 128;  // (128 rows, 64 deep) bf16
  static constexpr int B_BYTES = N * 128;   // (N rows, 64 deep) bf16
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int SMEM = 1024 + DOWN_STAGES * STAGE_BYTES + 2 * DOWN_STAGES * 8;  // alignment slack, ring, barriers
  static_assert(STAGE_BYTES % 1024 == 0 && 2 * (SMEM + 1024) <= 233472, "two mlp_down blocks per SM");
};

__device__ __forceinline__ float round_bf16(float x) { return __bfloat162float(__float2bfloat16(x)); }

__device__ __forceinline__ float gelu_erf(float g) { return g * 0.5f * (1.0f + erff(g * 0.70710678118654752f)); }

// ---------------------------------------------------------------- LayerNorm

// xn = bf16(LN(x) * lns + lnb), one warp per row, the row held in registers.
template <int C>
__global__ void __launch_bounds__(256) mlp_ln_kernel(const __nv_bfloat16* __restrict__ x,
                                                     const float* __restrict__ lns, const float* __restrict__ lnb,
                                                     __nv_bfloat16* __restrict__ xn, int R) {
  constexpr int NV = C / 8, PER = (NV + 31) / 32;  // 16-byte vectors per row, per lane
  const int row = blockIdx.x * 8 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= R) return;
  const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)row * C);
  uint4 v[PER];
  float sum = 0.0f, sq = 0.0f;
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int cv = lane + 32 * j;
    v[j] = cv < NV ? __ldg(xr + cv) : make_uint4(0, 0, 0, 0);
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v[j]);
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
  uint4* out = reinterpret_cast<uint4*>(xn + (size_t)row * C);
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int cv = lane + 32 * j;
    if (cv >= NV) continue;
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v[j]);
    const float4* s4 = reinterpret_cast<const float4*>(lns + cv * 8);
    const float4* b4 = reinterpret_cast<const float4*>(lnb + cv * 8);
    const float4 s[2] = {__ldg(s4), __ldg(s4 + 1)}, b[2] = {__ldg(b4), __ldg(b4 + 1)};
    const float sc[8] = {s[0].x, s[0].y, s[0].z, s[0].w, s[1].x, s[1].y, s[1].z, s[1].w};
    const float sh[8] = {b[0].x, b[0].y, b[0].z, b[0].w, b[1].x, b[1].y, b[1].z, b[1].w};
    uint4 o;
    __nv_bfloat162* q = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(p[e]);
      q[e] = __floats2bfloat162_rn((f.x - mu) * rs * sc[2 * e] + sh[2 * e],
                                   (f.y - mu) * rs * sc[2 * e + 1] + sh[2 * e + 1]);
    }
    out[cv] = o;
  }
}

// ------------------------------------------------------ the two products

// A ring of `stages` shared-memory stages: stage g % stages holds A's (128,
// 64) box and then B's (N, 64) box, its arrival on full[], its release by
// the consumer warps on empty[].
struct Ring {
  unsigned char* tiles;
  uint64_t* full;
  uint64_t* empty;
  int stages, stage_bytes;

  __device__ __forceinline__ Ring(unsigned char* smem, int n, int bytes) : tiles(smem), stages(n), stage_bytes(bytes) {
    full = reinterpret_cast<uint64_t*>(tiles + stages * stage_bytes);
    empty = full + stages;
  }

  // By one thread, before any other uses the ring.
  __device__ __forceinline__ void init() const {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    mbar_init_fence();
  }
};

// The producer's load of the ring's g-th stage: depth block kb of A's rows
// a_row.. and of B's rows b_row...
template <int N>
__device__ __forceinline__ void load_stage(const Ring& r, int g, const CUtensorMap* ta, const CUtensorMap* tb, int kb,
                                           int a_row, int b_row) {
  const int s = g % r.stages;
  mbar_wait(&r.empty[s], ((g / r.stages) & 1) ^ 1);  // the first round passes: the ring starts empty
  mbar_expect_tx(&r.full[s], Gemm<N>::STAGE_BYTES);
  unsigned char* st = r.tiles + s * r.stage_bytes;
  tma_load_3d(st, ta, &r.full[s], kb * BK, a_row, 0);
  tma_load_3d(st + Gemm<N>::A_BYTES, tb, &r.full[s], kb * BK, b_row, 0);
}

// One consumer warpgroup's tile: acc[half] (rows 64 half.. of the tile, N
// columns) = sum over the ring's stages g0 .. g0 + nkb - 1 of A . B^T. One
// commit group per stage; a stage is released once the group after it is
// issued and it has retired, the last one at the end. pass_to:
// a named barrier the warpgroup arrives on once its last product is issued
// (0: none).
template <int N>
__device__ __forceinline__ void mma_tile(float (&acc)[2][N / 2], const Ring& r, int g0, int nkb, int pass_to = 0) {
  const int lane = threadIdx.x % 32;
  auto release = [&](int g) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&r.empty[g % r.stages]);
  };
#pragma unroll
  for (int hf = 0; hf < 2; ++hf)
#pragma unroll
    for (int j = 0; j < N / 2; ++j) acc[hf][j] = 0.0f;
  for (int i = 0; i < nkb; ++i) {
    const int g = g0 + i, s = g % r.stages;
    mbar_wait(&r.full[s], (g / r.stages) & 1);
    const unsigned char* st = r.tiles + s * r.stage_bytes;
    const unsigned char* a = st;
    const unsigned char* b = st + Gemm<N>::A_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) Wgmma<N>::template ss<0>(acc[hf], desc_k(a + hf * 64 * 128, BM, kk), desc_k(b, N, kk));
    wgmma_commit();
    if (pass_to && i == nkb - 1) bar_arrive(pass_to, 2 * WARPGROUP);
    wgmma_wait<1>();  // the group of stage g - 1 has retired
    if (i > 0) release(g - 1);
  }
  wgmma_wait<0>();
  fence_regs(acc[0]);
  fence_regs(acc[1]);
  if (nkb > 0) release(g0 + nkb - 1);
}

// mlp_up's epilogue for the tile at rows m0.., hidden columns f0..: bias,
// the roundings of a and g, the gate, bf16 h. acc[hf][4 c + e] holds row
// 64 hf + 16 warp + lane / 4 (+ 8 for e >= 2) and packed column 8 c + 2
// (lane % 4) + (e & 1): a for c < 8, g of the same hidden column at c + 8.
// RAGGED checks each row against R; without it (every full tile) no store
// sits behind a branch, so the compiler can interleave the values' GELU
// chains (behind a branch each pair's chain ran alone).
template <bool RAGGED>
__device__ __forceinline__ void store_h(const float (&acc)[2][UP_N / 2], const float* __restrict__ bh,
                                        const float* __restrict__ bg, __nv_bfloat16* __restrict__ h, int R, int F,
                                        int m0, int f0) {
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32, q = lane & 3;
  const int rbase = m0 + 16 * warp + (lane >> 2);
#pragma unroll
  for (int c = 0; c < HID / 8; ++c) {
    const int f = f0 + 8 * c + 2 * q;
    const float2 ba = __ldg(reinterpret_cast<const float2*>(bh + f));
    const float2 bb = __ldg(reinterpret_cast<const float2*>(bg + f));
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = rbase + 64 * hf + 8 * hh;
        const float a0 = round_bf16(acc[hf][4 * c + 2 * hh] + ba.x);
        const float a1 = round_bf16(acc[hf][4 * c + 2 * hh + 1] + ba.y);
        const float g0 = round_bf16(acc[hf][4 * (c + HID / 8) + 2 * hh] + bb.x);
        const float g1 = round_bf16(acc[hf][4 * (c + HID / 8) + 2 * hh + 1] + bb.y);
        if (!RAGGED || row < R)
          *reinterpret_cast<__nv_bfloat162*>(h + (size_t)row * F + f) =
              __floats2bfloat162_rn(a0 * gelu_erf(g0), a1 * gelu_erf(g1));
      }
  }
}

// h (R, F) = GEGLU of xn (R, C) . wup^T over 128 x 128 tiles of the packed
// weights (64 hidden columns). Persistent: a block walks units of one row
// tile and NC = F / 64 / chunks consecutive column tiles (unit u: row tile
// u / chunks, chunk u % chunks, so the blocks in flight share the row tiles'
// xn and all the weights). Its two consumer warpgroups take the tiles in
// turns (ping-pong: one's epilogue overlaps the other's products). A
// warpgroup starts a tile's products only when the other has issued its
// last, so no consumer waits on a stage more than one round of the ring
// ahead of the producer, which a parity wait could not tell from the round
// before. The producer warpgroup's first thread keeps the ring full.
__global__ void __launch_bounds__(3 * WARPGROUP, 1)
mlp_up_kernel(const __grid_constant__ CUtensorMap txn, const __grid_constant__ CUtensorMap twup,
              const float* __restrict__ bh, const float* __restrict__ bg, __nv_bfloat16* __restrict__ h, int R,
              int C, int F, int chunks, int stages) {
  extern __shared__ unsigned char smem_raw[];
  const Ring ring(align1024(smem_raw), stages, Gemm<UP_N>::STAGE_BYTES);
  const int KB = C / BK, NC = F / HID / chunks, units = (R + BM - 1) / BM * chunks;
  if (threadIdx.x == 0) ring.init();
  __syncthreads();
  const int wg = threadIdx.x / WARPGROUP;
  const int my_units = (int)blockIdx.x < units ? (units - 1 - (int)blockIdx.x) / (int)gridDim.x + 1 : 0;

  if (wg == 2) {
    // ------------------------------------------------------------ producer
    reg_dealloc<40>();
    if (threadIdx.x == 2 * WARPGROUP) {
      int g = 0;
      for (int i = 0; i < my_units; ++i) {
        const int u = blockIdx.x + i * gridDim.x, m0 = u / chunks * BM, t0 = u % chunks * NC;
        for (int j = 0; j < NC; ++j)
          for (int kb = 0; kb < KB; ++kb, ++g) load_stage<UP_N>(ring, g, &txn, &twup, kb, m0, (t0 + j) * UP_N);
      }
    }
    return;
  }

  // -------------------------------------------------------------- consumers
  reg_alloc<232>();
  float acc[2][UP_N / 2];
  const int tiles = my_units * NC;
  int g = 0, n = 0;  // the ring's stage and the block's tile count
  for (int i = 0; i < my_units; ++i) {
    const int u = blockIdx.x + i * gridDim.x, m0 = u / chunks * BM, t0 = u % chunks * NC;
    for (int j = 0; j < NC; ++j, ++n, g += KB) {
      if ((n & 1) != wg) continue;
      if (n > 0) bar_sync(1 + wg, 2 * WARPGROUP);  // this warpgroup's turn (named barriers 1, 2)
      mma_tile<UP_N>(acc, ring, g, KB, n + 1 < tiles ? 2 - wg : 0);
      if (m0 + BM <= R)
        store_h<false>(acc, bh, bg, h, R, F, m0, (t0 + j) * HID);
      else
        store_h<true>(acc, bh, bg, h, R, F, m0, (t0 + j) * HID);
    }
  }
}

// y (R, C) = h (R, F) . wdown^T, or split s's fp32 partial over k blocks
// [s kps, s kps + kps) into part[s]; the grid is splits x ceil(R / 128) x C /
// 160 tiles, one consumer and one producer warpgroup a block, two blocks an SM.
__global__ void __launch_bounds__(DOWN_THREADS, 2)
mlp_down_kernel(const __grid_constant__ CUtensorMap th, const __grid_constant__ CUtensorMap twd,
                __nv_bfloat16* __restrict__ y, float* __restrict__ part, int R, int C, int F, int kps,
                int cols_fastest) {
  extern __shared__ unsigned char smem_raw[];
  const Ring ring(align1024(smem_raw), DOWN_STAGES, Gemm<DOWN_N>::STAGE_BYTES);
  const int mt = (R + BM - 1) / BM, nt = C / DOWN_N, nkbt = F / BK;
  const int split = blockIdx.x / (mt * nt), b = blockIdx.x % (mt * nt);
  const int mi = cols_fastest ? b / nt : b % mt, ni = cols_fastest ? b % nt : b / mt;
  const int m0 = mi * BM, n0 = ni * DOWN_N, kb0 = split * kps;
  const int nkb = min(kps, nkbt - kb0);
  if (threadIdx.x == 0) ring.init();
  __syncthreads();

  if (threadIdx.x >= WARPGROUP) {
    reg_dealloc<40>();
    if (threadIdx.x == WARPGROUP)
      for (int i = 0; i < nkb; ++i) load_stage<DOWN_N>(ring, i, &th, &twd, kb0 + i, m0, n0);
    return;
  }
  reg_alloc<216>();
  float acc[2][DOWN_N / 2];
  mma_tile<DOWN_N>(acc, ring, 0, nkb);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, q = lane & 3;
  const int rbase = m0 + 16 * warp + (lane >> 2);
#pragma unroll
  for (int hf = 0; hf < 2; ++hf)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = rbase + 64 * hf + 8 * hh;
      if (row >= R) continue;
#pragma unroll
      for (int c = 0; c < DOWN_N / 8; ++c) {
        const int col = n0 + 8 * c + 2 * q;
        const float v0 = acc[hf][4 * c + 2 * hh], v1 = acc[hf][4 * c + 2 * hh + 1];
        if (part == nullptr)
          *reinterpret_cast<__nv_bfloat162*>(y + (size_t)row * C + col) = __floats2bfloat162_rn(v0, v1);
        else
          *reinterpret_cast<float2*>(part + ((size_t)split * R + row) * C + col) = make_float2(v0, v1);
      }
    }
}

// y[i] = bf16(sum over splits of part[s][i]), in split order; four values a thread.
__global__ void sum_splits_kernel(const float4* __restrict__ part, __nv_bfloat162* __restrict__ y, long long n4,
                                  int splits) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n4; i += (long long)gridDim.x * blockDim.x) {
    float4 s = part[i];
    for (int k = 1; k < splits; ++k) {
      const float4 p = part[k * n4 + i];
      s.x += p.x;
      s.y += p.y;
      s.z += p.z;
      s.w += p.w;
    }
    y[2 * i] = __floats2bfloat162_rn(s.x, s.y);
    y[2 * i + 1] = __floats2bfloat162_rn(s.z, s.w);
  }
}

template <typename Fn>
int prepare(Fn fn, int smem) {
  cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(fn, cudaFuncAttributePreferredSharedMemoryCarveout, (int)cudaSharedmemCarveoutMaxShared);
  return (int)e;
}

bool width_ok(int C) { return C == 320 || C == 640 || C == 1280; }

int sm_count() {
  static int sms[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (sms[dev] == 0 && cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    sms[dev] = 132;
  return sms[dev];
}

// Chunks per row tile for mlp_up: the divisor d of the F / 64 column tiles
// whose units (row tiles x d) leave the fewest column tiles to the busiest
// block, one block an SM; the smallest such d (the fewest xn reloads).
int up_chunks(int mt, int T, int sms) {
  int best = T, cost = 1 << 30;
  for (int d = 1; d <= T; ++d) {
    if (T % d) continue;
    const int c = (mt * d + sms - 1) / sms * (T / d);
    if (c < cost) cost = c, best = d;
  }
  return best;
}

}  // namespace

// Launches mlp_ln_kernel and mlp_up_kernel on `stream` and returns 0, a CUDA
// error, or one of sm90.cuh's tensor-map codes (>= 9000). x, xn: (R, C) bf16
// (xn: scratch the caller allocates); lns, lnb: (C,) fp32; wup: (2F, C) bf16
// in the layout above; bh, bg: (F,) fp32; h: (R, F) bf16. C in {320, 640,
// 1280}, F a positive multiple of 64; pointers 16-byte aligned.
extern "C" int mlp_up_bf16(const void* x, const void* lns, const void* lnb, const void* wup, const void* bh,
                           const void* bg, void* xn, void* h, int R, int C, int F, void* stream_) {
  if (R <= 0 || !width_ok(C) || F <= 0 || F % HID != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream_);
  const int ln_blocks = (R + 7) / 8;
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* sc = static_cast<const float*>(lns);
  const auto* sh = static_cast<const float*>(lnb);
  auto* xo = static_cast<__nv_bfloat16*>(xn);
  switch (C) {
    case 320: mlp_ln_kernel<320><<<ln_blocks, 256, 0, s>>>(xb, sc, sh, xo, R); break;
    case 640: mlp_ln_kernel<640><<<ln_blocks, 256, 0, s>>>(xb, sc, sh, xo, R); break;
    default: mlp_ln_kernel<1280><<<ln_blocks, 256, 0, s>>>(xb, sc, sh, xo, R); break;
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  CUtensorMap txn, tw;
  if (int r = tmap_rows_bf16(&txn, xn, 1, R, C, BM)) return r;
  if (int r = tmap_rows_bf16(&tw, wup, 1, 2 * F, C, UP_N)) return r;
  const int sms = sm_count(), mt = (R + BM - 1) / BM, chunks = up_chunks(mt, F / HID, sms);
  const int stages = (SMEM_LIMIT - 1024 - 256) / Gemm<UP_N>::STAGE_BYTES;  // 7
  const int smem = 1024 + stages * Gemm<UP_N>::STAGE_BYTES + 2 * stages * 8;
  if (int r = prepare(mlp_up_kernel, smem)) return r;
  const int units = mt * chunks;
  mlp_up_kernel<<<units < sms ? units : sms, 3 * WARPGROUP, smem, s>>>(
      txn, tw, static_cast<const float*>(bh), static_cast<const float*>(bg), static_cast<__nv_bfloat16*>(h), R, C, F,
      chunks, stages);
  return (int)cudaGetLastError();
}

// Launches mlp_down_kernel (and, at splits > 1, sum_splits_kernel) on
// `stream`; returns as mlp_up_bf16. h: (R, F) bf16; wdown: (C, F) bf16; y:
// (R, C) bf16; part: (splits, R, C) fp32 scratch, or null at splits == 1.
// C in {320, 640, 1280}, F a positive multiple of 64; `splits` divides the
// F / 64 depth blocks into ceil(F / 64 / splits)-block runs with none
// empty (ops/mlp.py: down_splits).
extern "C" int mlp_down_bf16(const void* h, const void* wdown, void* y, void* part, int R, int C, int F, int splits,
                             void* stream_) {
  if (R <= 0 || !width_ok(C) || F <= 0 || F % BK != 0 || splits < 1 || (splits > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  const int nkb = F / BK, kps = (nkb + splits - 1) / splits;
  if ((nkb + kps - 1) / kps != splits) return (int)cudaErrorInvalidValue;  // an empty split
  cudaStream_t s = static_cast<cudaStream_t>(stream_);
  CUtensorMap th, tw;
  if (int r = tmap_rows_bf16(&th, h, 1, R, F, BM)) return r;
  if (int r = tmap_rows_bf16(&tw, wdown, 1, C, F, DOWN_N)) return r;
  if (int r = prepare(mlp_down_kernel, Gemm<DOWN_N>::SMEM)) return r;
  const int tiles = (R + BM - 1) / BM * (C / DOWN_N);
  mlp_down_kernel<<<splits * tiles, DOWN_THREADS, Gemm<DOWN_N>::SMEM, s>>>(
      th, tw, static_cast<__nv_bfloat16*>(y), splits > 1 ? static_cast<float*>(part) : nullptr, R, C, F, kps, R > C);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return (int)e;
  const long long n4 = (long long)R * C / 4;
  const int blocks = (int)((n4 + 255) / 256 < 4096 ? (n4 + 255) / 256 : 4096);
  sum_splits_kernel<<<blocks, 256, 0, s>>>(static_cast<const float4*>(part), static_cast<__nv_bfloat162*>(y), n4,
                                           splits);
  return (int)cudaGetLastError();
}
