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
// from the fp32 accumulator before the bf16 store. Two kernels:
//
// K2, conv_wgmma_kernel: the U-Net's ResBlock convs, and every call K3
//   does not take.
//   Bound at the pixel path's shapes (B = 4; 18 Cin Cout FLOP per output
//   pixel against 2 (Cin + Cout) bytes of x and y): by the tensor cores.
//     256^2 x 128->128  77.3 GFLOP 0.0782 ms (bytes 0.040, 0.060 with add)
//     128^2 x 128->128, 64^2 x 256->256, 32^2 x 512->512
//                       19.3 GFLOP 0.0196 ms each
//   Design, against the four causes that held the earlier mma.sync design
//   (8 x 16-pixel tiles, one block per SM) at 16% of the tensor-core rate:
//   1. products on wgmma (m64nBNk16, A from registers, B = the weights by
//      descriptor from shared memory, MN-major, 128-byte swizzled); no
//      mma.sync remains. The A operand is a tap's window of the activated
//      halo, pixels shifted by (dy, dx): not a constant-stride row set at
//      W = 32 or at a ragged tile, so it goes through ldmatrix into
//      registers (rs), 16 pixels of one image row per warp;
//   2. warp specialisation and overlap: a block is two MMA warpgroups (128
//      output pixels each, 216 registers a thread by setmaxnreg) and one
//      warpgroup (72 registers) of a producer warp and three prologue warps.
//      The producer keeps TMA loads in flight on mbarrier rings: the raw x
//      halo (4-D box (64 channels, 18, 18, 1), 3 stages, a chunk ahead) and
//      one tap's weights (BN/64 boxes of 64 x 64, 4 stages). The prologue
//      warps apply affine + SiLU to each halo in place as it lands, once per
//      (tile, 64-channel chunk), while the MMA warps run the chunk before:
//      the prologue leaves the MMA warps' instruction stream. A chunk's
//      products are 18 commit groups (a tap, two 16-deep k steps) whose A
//      fragments alternate between two register sets, so no register of a
//      product in flight is written;
//   3. weight reuse: a tile is 16 x 16 = 256 output pixels (before: 128), so
//      each block reads 9 Cin BN weights from L2 per 256 pixels:
//      9 Cin Cout 2 / 256 bytes per output pixel, 1152 B at 128->128 and
//      18432 B at 512->512, half of the 128-pixel tile's 2304 and 36864.
//      A cluster of two blocks sharing each weight load by TMA multicast
//      (half that again) measured no faster on the H100 and is not used;
//   4. persistent grid of min(units, SMs) blocks, each walking work units
//      (pixel tile fastest, then image, then a BN-wide Cout tile): the
//      producer loads the next unit's halo and weights, and the prologue
//      warps activate its first chunk, during a unit's epilogue. BN = 128
//      when that gives at least 7/8 of the SMs a unit, else 64. Units at
//      B = 4 on 132 SMs:
//        256^2 x 128->128: 1024 (BN 128)    128^2 x 128->128: 256 (BN 128)
//        64^2 x 256->256:   128 (BN 128)    32^2 x 512->512:  128 (BN 64)
//      and 4096 at 256^2 x 128->128, B = 16.
//   The epilogue adds bias, then the residual, to the fp32 accumulators,
//   reduces the moments per column in a fixed order (warp shuffles, then the
//   8 warps in shared memory; written per (image, tile), no atomics, so two
//   calls give bit-equal moments), and stages each warp's 16 pixels x 64
//   columns in shared memory, so the residual comes in and y goes out as
//   16-byte vectors.
//
// K3, head_conv_kernel: the GroupNorm -> 3-channel head's function
//   (linear, no residual or moments; Cout <= 8, Cin <= 512; every other
//   call runs K2). 27 Cin MACs per pixel for 2 Cin bytes read is far below the
//   card's ridge: bound by reading x, 0.0205 ms at 256^2 x 128->3, B = 4
//   (67.1 MB of x, 1.6 MB of y). Persistent blocks of 16 warps, one tile
//   row each; the whole weight set, zero-padded to N = 8, is loaded into
//   shared memory once per block; x halos stream by the same 4-D TMA on a
//   ring of 4 stages (3 at Cin > 256: 124 or 83 KB in flight per SM); the
//   affine runs in registers with the zero-after-prologue rule; products on
//   mma.sync m16n8k16 in two accumulator chains (at N = 8 the tensor rate is
//   no limit); the output rows are staged so each warp stores contiguous
//   bytes.
//
// Both read x through a TMA map whose width is Cin: channels past Cin and
// pixels outside the image arrive as zero, and the prologue writes zero for
// every halo pixel outside the image. The weight map's rows past Cin are
// zero too. K2 takes Cout % 8 == 0 (TMA needs 16-byte strides); the
// wrapper pads a narrower Cout with zero weights and takes the columns back.

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int TH = 16, TW = 16;                             // output pixels per tile
constexpr int HH = TH + 2, HW = TW + 2, HPIX = HH * HW;     // the 18 x 18 halo
constexpr int BK = 64;                                      // channels per chunk: one 128-byte row per pixel
constexpr int HALO_BYTES = HPIX * BK * 2;                   // one TMA box
constexpr int HALO_STRIDE = (HALO_BYTES + 1023) / 1024 * 1024;
constexpr int SMEM_LIMIT = 232448;

// ------------------------------------------------------------ shared helpers

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

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Byte offset of 16-byte chunk `c` of halo pixel `pix` in a stage: TMA's
// 128-byte swizzle puts it at chunk c ^ (pix % 8) of the pixel's row.
__device__ __forceinline__ uint32_t halo_off(int pix, int c) { return pix * 128 + ((c ^ (pix & 7)) << 4); }

struct Unit {
  int b, h0, w0, n0, tile;
};

__device__ __forceinline__ Unit unit_of(int u, int tiles, int tilesW, int batch, int bn) {
  Unit r;
  r.tile = u % tiles;
  const int rest = u / tiles;
  r.b = rest % batch;
  r.n0 = rest / batch * bn;
  r.h0 = r.tile / tilesW * TH;
  r.w0 = r.tile % tilesW * TW;
  return r;
}

// The prologue of one thread's share of a halo chunk: channel group cg (8
// channels) of some of its pixels; the group's scale and shift live in
// registers, zero past Cin.
struct Prologue {
  float sc[8], sh[8];
  int h0, w0, cg;

  __device__ __forceinline__ void setup(const float* A, const float* Bsh, const Unit& u, int c0, int Cin, int group) {
    cg = group;
    h0 = u.h0;
    w0 = u.w0;
    const int c = c0 + cg * 8;  // Cin % 8 == 0: a group is all in or all out
#pragma unroll
    for (int e = 0; e < 8; e += 4) {
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
      if (c < Cin) {
        a = __ldg(reinterpret_cast<const float4*>(A + (size_t)u.b * Cin + c + e));
        b = __ldg(reinterpret_cast<const float4*>(Bsh + (size_t)u.b * Cin + c + e));
      }
      sc[e] = a.x, sc[e + 1] = a.y, sc[e + 2] = a.z, sc[e + 3] = a.w;
      sh[e] = b.x, sh[e + 1] = b.y, sh[e + 2] = b.z, sh[e + 3] = b.w;
    }
  }

  // Halo pixel `pix` of the stage at `stage`, in place: act(x A + B) in
  // bf16, or zero outside the image.
  __device__ __forceinline__ void apply(unsigned char* stage, int pix, int H, int W, bool linear) const {
    const int h = h0 - 1 + pix / HW, w = w0 - 1 + pix % HW;
    uint4* p = reinterpret_cast<uint4*>(stage + halo_off(pix, cg));
    uint4 out = make_uint4(0, 0, 0, 0);
    if (h >= 0 && h < H && w >= 0 && w < W) {
      const uint4 raw = *p;
      const __nv_bfloat162* in = reinterpret_cast<const __nv_bfloat162*>(&raw);
      __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(in[e]);
        float a = fmaf(f.x, sc[2 * e], sh[2 * e]);
        float b = fmaf(f.y, sc[2 * e + 1], sh[2 * e + 1]);
        if (!linear) {  // SiLU; the clamp keeps 1 + exp(-a) inside __fdividef's range
          a = __fdividef(a, 1.0f + __expf(fminf(-a, 80.0f)));
          b = __fdividef(b, 1.0f + __expf(fminf(-b, 80.0f)));
        }
        o[e] = __floats2bfloat162_rn(a, b);
      }
    }
    *p = out;
  }
};

// ------------------------------------------------------------------- K2

constexpr int HSTAGES = 3, WSTAGES = 4;
constexpr int MMA_THREADS = 2 * WARPGROUP;
constexpr int PRO_WARPS = 3, PRO_THREADS = PRO_WARPS * 32;  // warps 9-11; warp 8 is the producer
constexpr int GROUPS = 18;                                  // commit groups per chunk: (tap, 2 k steps)
constexpr int ASETS = 2;                                    // A register sets: groups in flight per warpgroup
constexpr int STAGE_WARP = 16 * 64 * 2;                     // epilogue: 16 pixels x 64 columns of bf16 per warp
static_assert(PRO_THREADS % 8 == 0 && HPIX % (PRO_THREADS / 8) == 0, "prologue split");

template <int BN>
struct K2 {
  static constexpr int NCB = BN / 64;
  static constexpr int W_BYTES = BK * BN * 2;  // one tap's weights: NCB swizzled (64, 64) blocks
  static constexpr int MOM_FLOATS = 8 * 2 * BN;
  static constexpr int SMEM = 1024 + HSTAGES * HALO_STRIDE + WSTAGES * W_BYTES + MOM_FLOATS * 4 + 8 * STAGE_WARP +
                              (3 * HSTAGES + 2 * WSTAGES) * 8;
  static constexpr int THREADS = 3 * WARPGROUP;
  static_assert(SMEM <= SMEM_LIMIT, "K2 shared memory");
};

template <int BN>
__global__ void __launch_bounds__(K2<BN>::THREADS, 1)
conv_wgmma_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
                  const float* __restrict__ A, const float* __restrict__ Bsh, const float* __restrict__ bias,
                  const __nv_bfloat16* __restrict__ add, __nv_bfloat16* __restrict__ y, float* __restrict__ mom,
                  int batch, int H, int W, int Cin, int Cout, int linear) {
  using C = K2<BN>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sH = align1024(smem_raw);                              // [HSTAGES][HALO_STRIDE]
  unsigned char* sW = sH + HSTAGES * HALO_STRIDE;                       // [WSTAGES][W_BYTES]
  float* sMom = reinterpret_cast<float*>(sW + WSTAGES * C::W_BYTES);    // [8 warps][2][BN]
  unsigned char* sStage = reinterpret_cast<unsigned char*>(sMom + C::MOM_FLOATS);  // [8 warps][STAGE_WARP]
  uint64_t* hfull = reinterpret_cast<uint64_t*>(sStage + 8 * STAGE_WARP);  // raw halo arrived
  uint64_t* afull = hfull + HSTAGES;                                    // activated in place
  uint64_t* hempty = afull + HSTAGES;                                   // read by every MMA warp
  uint64_t* wfull = hempty + HSTAGES;
  uint64_t* wempty = wfull + WSTAGES;

  const int tilesW = (W + TW - 1) / TW, tiles = (H + TH - 1) / TH * tilesW;
  const int units = tiles * batch * ((Cout + BN - 1) / BN);
  const int KC = (Cin + BK - 1) / BK;
  const int my_units = (int)blockIdx.x < units ? (units - 1 - (int)blockIdx.x) / (int)gridDim.x + 1 : 0;
  const int chunks = my_units * KC;  // this block's stream of (unit, chunk)
  const int wg = threadIdx.x / WARPGROUP, warp_id = threadIdx.x / 32, lane = threadIdx.x % 32;
  auto unit = [&](int g) { return unit_of(blockIdx.x + g / KC * gridDim.x, tiles, tilesW, batch, BN); };

  if (threadIdx.x == 0) {
    for (int s = 0; s < HSTAGES; ++s) {
      mbar_init(&hfull[s], 1);
      mbar_init(&afull[s], PRO_WARPS);
      mbar_init(&hempty[s], 8);  // one arrival per MMA warp
    }
    for (int s = 0; s < WSTAGES; ++s) {
      mbar_init(&wfull[s], 1);
      mbar_init(&wempty[s], 8);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {
    reg_dealloc<72>();
    if (warp_id == 8) {
      // ---------------------------------------------------------- producer
      if (lane == 0) {
        // Halos go a chunk ahead of the weights, so the prologue warps have
        // a chunk's products of time to activate each one.
        auto load_halo = [&](int g) {
          const Unit u = unit(g);
          const int s = g % HSTAGES;
          mbar_wait(&hempty[s], ((g / HSTAGES) & 1) ^ 1);  // the first round passes: the ring starts empty
          mbar_expect_tx(&hfull[s], HALO_BYTES);
          tma_load_4d(sH + s * HALO_STRIDE, &tx, &hfull[s], g % KC * BK, u.w0 - 1, u.h0 - 1, u.b);
        };
        if (chunks > 0) load_halo(0);
        int k = 0;
        for (int g = 0; g < chunks; ++g) {
          if (g + 1 < chunks) load_halo(g + 1);
          const Unit u = unit(g);
          for (int tap = 0; tap < 9; ++tap, ++k) {
            const int ws = k % WSTAGES;
            mbar_wait(&wempty[ws], ((k / WSTAGES) & 1) ^ 1);
            mbar_expect_tx(&wfull[ws], C::W_BYTES);
            for (int cb = 0; cb < C::NCB; ++cb)
              tma_load_3d(sW + ws * C::W_BYTES + cb * BK * 128, &tw, &wfull[ws], u.n0 + cb * 64, g % KC * BK, tap);
          }
        }
      }
    } else {
      // ---------------------------------------------------------- prologue
      // Three warps activate each raw halo in place as it lands, ahead of
      // the MMA warps: thread t owns channel group t % 8 of pixels t / 8 + 12 i.
      const int ptid = threadIdx.x - 9 * 32;
      Prologue pro;
      for (int g = 0; g < chunks; ++g) {
        const int s = g % HSTAGES;
        pro.setup(A, Bsh, unit(g), g % KC * BK, Cin, ptid & 7);
        mbar_wait(&hfull[s], (g / HSTAGES) & 1);
        unsigned char* stage = sH + s * HALO_STRIDE;
#pragma unroll 3
        for (int pix = ptid >> 3; pix < HPIX; pix += PRO_THREADS / 8) pro.apply(stage, pix, H, W, linear);
        fence_proxy_async();
        __syncwarp();
        if (lane == 0) mbar_arrive(&afull[s]);
      }
    }
  } else {
    // ------------------------------------------------------------ MMA warps
    reg_alloc<216>();
    const int ctid = threadIdx.x, warp = warp_id % 4, gw = warp_id;
    float acc[2][BN / 2];      // this warpgroup's two m64 row blocks
    uint32_t a[ASETS][2][2][4];  // A fragments: [register set][m64][k step]

    auto release_w = [&](int ws) {  // this warp is done with weight stage ws
      __syncwarp();
      if (lane == 0) mbar_arrive(&wempty[ws]);
    };

    int g = 0, k = 0;
    for (int ui = 0; ui < my_units; ++ui) {
      const Unit u = unit(g);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < BN / 2; ++j) acc[i][j] = 0.0f;

      for (int c = 0; c < KC; ++c, ++g, k += 9) {
        const int hs = g % HSTAGES;
        mbar_wait(&afull[hs], (g / HSTAGES) & 1);
        const uint32_t hal = smem_u32(sH + hs * HALO_STRIDE);
#pragma unroll
        for (int h = 0; h < GROUPS; ++h) {
          const int tap = h / 2, dy = tap / 3, dx = tap % 3, set = h % ASETS, kh = h & 1;
          const int ws = (k + tap) % WSTAGES;
          if (kh == 0) mbar_wait(&wfull[ws], ((k + tap) / WSTAGES) & 1);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int pix = (8 * wg + 4 * i + warp + dy) * HW + (lane & 15) + dx;
#pragma unroll
            for (int ks = 0; ks < 2; ++ks) ldsm_x4(hal + halo_off(pix, 2 * (2 * kh + ks) + (lane >> 4)), a[set][i][ks]);
          }
          wgmma_fence();
          const unsigned char* wt = sW + ws * C::W_BYTES;
#pragma unroll
          for (int ks = 0; ks < 2; ++ks)
#pragma unroll
            for (int i = 0; i < 2; ++i) Wgmma<BN>::template rs<1>(acc[i], a[set][i][ks], desc_mn(wt, BK, 0, 2 * kh + ks));
          wgmma_commit();
          if (h == GROUPS - 1) {  // this warp's last read of the chunk's halo
            __syncwarp();
            if (lane == 0) mbar_arrive(&hempty[hs]);
          }
          wgmma_wait<ASETS - 1>();  // group r has retired (and the register set of group h + 1 is free)
          const int r = h - (ASETS - 1);
          if (r >= 0 && (r & 1)) release_w((k + r / 2) % WSTAGES);  // both groups of tap r / 2 have retired
        }
        wgmma_wait<0>();
        fence_regs(acc[0]);
        fence_regs(acc[1]);
#pragma unroll
        for (int t = 0; t < 9; ++t)
          if (2 * t + 1 > GROUPS - ASETS) release_w((k + t) % WSTAGES);
      }

      // Epilogue, per warp and per 16-pixel row (m64 i) in 64-column halves
      // staged in shared memory: (a) the residual's rows come in as 16-byte
      // vectors; (b) each thread takes y = acc + bias (+ add) in fp32, in that
      // order, adds its columns' sums and sums of squares over its valid pixels
      // and writes y as bf16 in place; (c) 16-byte vectors go out to y.
      // acc[i][4 c + e]: row 16 warp + gq (+ 8 for e >= 2) of m64 i, i.e. pixel
      // (h0 + 8 wg + 4 i + warp, w0 + gq (+ 8)); column 8 c + 2 q + (e & 1).
      const int gq = lane >> 2, q = lane & 3;
      unsigned char* stg = sStage + gw * STAGE_WARP;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int hy = u.h0 + 8 * wg + 4 * i + warp;
        const size_t row = ((size_t)u.b * H + (hy < H ? hy : 0)) * W + u.w0;  // pixel index of (hy, w0)
        uint4 v[BN / 64][4];  // the row's residual, every half's loads in flight together
        if (add != nullptr) {
#pragma unroll
          for (int half = 0; half < BN / 64; ++half)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int px = (lane >> 3) + 4 * j, n = u.n0 + 64 * half + 8 * (lane & 7);
              const bool ok = hy < H && u.w0 + px < W && n < Cout;
              v[half][j] = __ldg(reinterpret_cast<const uint4*>(add + (ok ? (row + px) * Cout + n : 0)));
            }
        }
#pragma unroll
        for (int half = 0; half < BN / 64; ++half) {
          const int nh = u.n0 + 64 * half;
          if (add != nullptr) {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int px = (lane >> 3) + 4 * j;
              *reinterpret_cast<uint4*>(stg + halo_off(px, lane & 7)) = v[half][j];
            }
            __syncwarp();
          }
#pragma unroll
          for (int c8 = 0; c8 < 8; ++c8) {
            const int cc = 8 * half + c8, n = nh + 8 * c8 + 2 * q;
            float2 b = __ldg(reinterpret_cast<const float2*>(bias + (n < Cout ? n : 0)));
            float s0 = 0.f, s1 = 0.f, q0 = 0.f, q1 = 0.f;
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const int px = gq + 8 * hh;
              __nv_bfloat162* sp = reinterpret_cast<__nv_bfloat162*>(stg + halo_off(px, c8) + 4 * q);
              float y0 = acc[i][4 * cc + 2 * hh] + b.x, y1 = acc[i][4 * cc + 2 * hh + 1] + b.y;
              if (add != nullptr) {
                const float2 r = __bfloat1622float2(*sp);
                y0 += r.x;
                y1 += r.y;
              }
              *sp = __floats2bfloat162_rn(y0, y1);
              if (hy < H && u.w0 + px < W && n < Cout) {
                s0 += y0;
                q0 += y0 * y0;
                s1 += y1;
                q1 += y1 * y1;
              }
            }
            if (mom != nullptr) {
#pragma unroll
              for (int m = 4; m < 32; m <<= 1) {
                s0 += __shfl_xor_sync(0xffffffffu, s0, m);
                s1 += __shfl_xor_sync(0xffffffffu, s1, m);
                q0 += __shfl_xor_sync(0xffffffffu, q0, m);
                q1 += __shfl_xor_sync(0xffffffffu, q1, m);
              }
              if (gq == 0) {  // this warp's two rows, in order
                float* sm = sMom + gw * 2 * BN + 8 * cc + 2 * q;
                if (i == 0) {
                  sm[0] = s0, sm[1] = s1, sm[BN] = q0, sm[BN + 1] = q1;
                } else {
                  sm[0] += s0, sm[1] += s1, sm[BN] += q0, sm[BN + 1] += q1;
                }
              }
            }
          }
          __syncwarp();
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int px = (lane >> 3) + 4 * j, ch = lane & 7;
            if (hy < H && u.w0 + px < W && nh + 8 * ch < Cout)
              *reinterpret_cast<uint4*>(y + (row + px) * Cout + nh + 8 * ch) =
                  *reinterpret_cast<const uint4*>(stg + halo_off(px, ch));
          }
          __syncwarp();
        }
      }
      if (mom != nullptr) {
        bar_sync(1, MMA_THREADS);
        if (ctid < BN && u.n0 + ctid < Cout) {
          float ts = 0.f, tq = 0.f;
          for (int w8 = 0; w8 < 8; ++w8) {
            ts += sMom[w8 * 2 * BN + ctid];
            tq += sMom[w8 * 2 * BN + BN + ctid];
          }
          float* out = mom + ((size_t)u.b * tiles + u.tile) * 2 * Cout + u.n0 + ctid;
          out[0] = ts;
          out[Cout] = tq;
        }
        bar_sync(1, MMA_THREADS);  // sMom is free for the next unit
      }
    }
  }
}

// ------------------------------------------------------------------- K3

constexpr int K3_WARPS = 16, K3_THREADS = K3_WARPS * 32;  // warp w: tile row w
constexpr int K3_MAX_CIN = 512;
constexpr int K3_FIXED = 1024 + K3_WARPS * 16 * 8 * 4;  // alignment, output staging

__host__ __device__ constexpr int k3_weight_bytes(int Cin) { return 9 * ((Cin + BK - 1) / BK * BK) * 8 * 2; }

__global__ void __launch_bounds__(K3_THREADS, 1)
head_conv_kernel(const __grid_constant__ CUtensorMap tx, const float* __restrict__ A, const float* __restrict__ Bsh,
                 const __nv_bfloat16* __restrict__ w9, const float* __restrict__ bias, __nv_bfloat16* __restrict__ y,
                 int batch, int H, int W, int Cin, int Cout, int stages) {
  extern __shared__ unsigned char smem_raw[];
  const int KC = (Cin + BK - 1) / BK, KP = KC * BK;
  unsigned char* sH = align1024(smem_raw);                                           // [stages][HALO_STRIDE]
  __nv_bfloat16* sWt = reinterpret_cast<__nv_bfloat16*>(sH + stages * HALO_STRIDE);  // [9][KP][8]
  float* sOut = reinterpret_cast<float*>(sWt + 9 * KP * 8);                          // [warps][16 px][8]
  uint64_t* full = reinterpret_cast<uint64_t*>(sOut + K3_WARPS * 16 * 8);            // [stages]

  const int tilesW = (W + TW - 1) / TW, tiles = (H + TH - 1) / TH * tilesW, units = tiles * batch;
  const int my_units = (int)blockIdx.x < units ? (units - 1 - (int)blockIdx.x) / (int)gridDim.x + 1 : 0;
  const int chunks = my_units * KC;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  auto unit = [&](int g) { return unit_of(blockIdx.x + g / KC * gridDim.x, tiles, tilesW, batch, 8); };
  auto load = [&](int g) {
    const int s = g % stages;
    mbar_expect_tx(&full[s], HALO_BYTES);
    const Unit u = unit(g);
    tma_load_4d(sH + s * HALO_STRIDE, &tx, &full[s], g % KC * BK, u.w0 - 1, u.h0 - 1, u.b);
  };

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(&full[s], 1);
    mbar_init_fence();
    for (int g = 0; g < stages && g < chunks; ++g) load(g);
  }
  // The weights, once per block: (tap, k, n) zero past Cin and Cout.
  for (int i = tid; i < 9 * KP * 8; i += K3_THREADS) {
    const int n = i & 7, kk = (i >> 3) % KP, tap = (i >> 3) / KP;
    sWt[i] = n < Cout && kk < Cin ? w9[((size_t)tap * Cin + kk) * Cout + n] : __float2bfloat16(0.0f);
  }
  __syncthreads();

  float acc[2][4];  // two chains (even and odd taps), summed at the end
  Prologue pro;
  const uint32_t wbase = smem_u32(sWt);
  for (int g = 0; g < chunks; ++g) {
    const int c = g % KC, s = g % stages;
    const Unit u = unit(g);
    if (c == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][e] = 0.0f;
    }
    unsigned char* stage = sH + s * HALO_STRIDE;
    pro.setup(A, Bsh, u, c * BK, Cin, tid & 7);
    mbar_wait(&full[s], (g / stages) & 1);
    for (int pix = tid >> 3; pix < HPIX; pix += K3_THREADS / 8) pro.apply(stage, pix, H, W, true);
    __syncthreads();  // the activated halo is complete

    const uint32_t hal = smem_u32(stage);
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      const int pix = (warp + dy) * HW + (lane & 15) + dx;
#pragma unroll
      for (int kk = 0; kk < BK; kk += 32) {
        uint32_t b[4];  // k steps kk and kk + 16
        ldsm_x4_trans(wbase + ((tap * KP + c * BK + kk + (lane & 15) + (lane >> 4) * 16) * 8) * 2, b);
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
          uint32_t af[4];
          ldsm_x4(hal + halo_off(pix, (kk + 16 * ks) / 8 + (lane >> 4)), af);
          mma_bf16(acc[tap & 1], af, b[2 * ks], b[2 * ks + 1]);
        }
      }
    }
    fence_proxy_async();
    __syncthreads();  // every read of stage s is done
    if (tid == 0 && g + stages < chunks) load(g + stages);
    if (c != KC - 1) continue;

    // Epilogue of the unit: the warp's row of 16 pixels x 8 columns in fp32,
    // staged, then stored as contiguous bytes.
    float* so = sOut + warp * 16 * 8;
    const int gq = lane >> 2, q = lane & 3;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = 2 * q + (e & 1);
      so[(gq + 8 * (e >> 1)) * 8 + n] = acc[0][e] + acc[1][e] + (n < Cout ? __ldg(bias + n) : 0.0f);
    }
    __syncwarp();
    const int hy = u.h0 + warp, wv = min(TW, W - u.w0);  // valid pixels of the row
    if (hy < H) {
      const size_t row = (((size_t)u.b * H + hy) * W + u.w0) * Cout;
      for (int e = lane; e < wv * Cout; e += 32) {
        const int px = e / Cout;
        y[row + e] = __float2bfloat16(so[px * 8 + e - px * Cout]);
      }
    }
    __syncwarp();  // sOut is free for the next unit
  }
}

int sm_count() {
  static int sms[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (sms[dev] == 0 && cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    sms[dev] = 132;
  return sms[dev];
}

// x as a (Cin, W, H, batch) map with an (64, 18, 18, 1) box, 128-byte swizzled.
int tmap_x(CUtensorMap* map, const void* x, int batch, int H, int W, int Cin) {
  const cuuint64_t dims[4] = {(cuuint64_t)Cin, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)Cin * 2, (cuuint64_t)W * Cin * 2, (cuuint64_t)H * W * Cin * 2};
  const cuuint32_t box[4] = {BK, HW, HH, 1};
  return tmap_tiled_bf16(map, x, 4, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

template <int BN>
int launch_k2(const CUtensorMap& tx, const void* A, const void* B, const void* w9, const void* bias, const void* add,
              void* y, void* mom, int batch, int H, int W, int Cin, int Cout, int linear, int units,
              cudaStream_t stream) {
  using C = K2<BN>;
  CUtensorMap tw;
  const cuuint64_t dims[3] = {(cuuint64_t)Cout, (cuuint64_t)Cin, 9};
  const cuuint64_t strides[2] = {(cuuint64_t)Cout * 2, (cuuint64_t)Cin * Cout * 2};
  const cuuint32_t box[3] = {64, BK, 1};
  if (int e = tmap_tiled_bf16(&tw, w9, 3, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B)) return e;
  const auto fn = conv_wgmma_kernel<BN>;
  cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (e != cudaSuccess) return (int)e;
  const int sms = sm_count();
  fn<<<units < sms ? units : sms, C::THREADS, C::SMEM, stream>>>(
      tx, tw, static_cast<const float*>(A), static_cast<const float*>(B), static_cast<const float*>(bias),
      static_cast<const __nv_bfloat16*>(add), static_cast<__nv_bfloat16*>(y), static_cast<float*>(mom), batch, H, W,
      Cin, Cout, linear);
  return (int)cudaGetLastError();
}

}  // namespace

// Pixel tiles per image: the moments partials are (B, tiles, 2, Cout).
extern "C" int affine_conv3x3_tiles(int H, int W) { return ((H + TH - 1) / TH) * ((W + TW - 1) / TW); }

// 1 if the call runs K3, the head kernel (the head's function: no
// activation, residual or moments, Cout <= 8, Cin <= 512), 0 if K2.
extern "C" int affine_conv3x3_is_head(int Cin, int Cout, int linear, int has_add, int moments) {
  return linear && !has_add && !moments && Cout <= 8 && Cin <= K3_MAX_CIN;
}

// Launches on `stream` and returns 0, a CUDA error, or one of sm90.cuh's
// tensor-map codes (>= 9000). Pointers are device pointers, 16-byte aligned;
// add and mom may be null. x (batch, H, W, Cin), w9 (9, Cin, Cout), add and
// y (batch, H, W, Cout) are bf16; A, B (batch, Cin), bias (Cout) and mom
// (batch, tiles, 2, Cout) are fp32. Cin must be a multiple of 32, and Cout a
// multiple of 8 unless the call runs K3 (affine_conv3x3_is_head).
extern "C" int affine_conv3x3_bf16(const void* x, const void* A, const void* B, const void* w9, const void* bias,
                                   const void* add, void* y, void* mom, int batch, int H, int W, int Cin, int Cout,
                                   int linear, void* stream_) {
  if (Cin % 32 != 0 || Cin <= 0 || Cout <= 0 || H <= 0 || W <= 0 || batch <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  CUtensorMap tx;
  if (int e = tmap_x(&tx, x, batch, H, W, Cin)) return e;
  const int tiles = affine_conv3x3_tiles(H, W), sms = sm_count();
  if (affine_conv3x3_is_head(Cin, Cout, linear, add != nullptr, mom != nullptr)) {
    const int fixed = K3_FIXED + k3_weight_bytes(Cin);
    const int fit = (SMEM_LIMIT - fixed - 4 * 8) / HALO_STRIDE, stages = fit < 4 ? fit : 4;
    const int smem = fixed + stages * HALO_STRIDE + stages * 8;
    cudaError_t e = cudaFuncSetAttribute(head_conv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    head_conv_kernel<<<tiles * batch < sms ? tiles * batch : sms, K3_THREADS, smem, stream>>>(
        tx, static_cast<const float*>(A), static_cast<const float*>(B), static_cast<const __nv_bfloat16*>(w9),
        static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(y), batch, H, W, Cin, Cout, stages);
    return (int)cudaGetLastError();
  }
  if (Cout % 8 != 0) return (int)cudaErrorInvalidValue;
  const int units128 = tiles * batch * ((Cout + 127) / 128);
  if (Cout > 64 && units128 * 8 >= sms * 7)
    return launch_k2<128>(tx, A, B, w9, bias, add, y, mom, batch, H, W, Cin, Cout, linear, units128, stream);
  return launch_k2<64>(tx, A, B, w9, bias, add, y, mom, batch, H, W, Cin, Cout, linear,
                       tiles * batch * ((Cout + 63) / 64), stream);
}
