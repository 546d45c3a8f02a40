// int8 serving convolutions for Hopper (sm_90a): an implicit-GEMM int8
// convolution on the tensor cores, its form that quantizes its own
// activations, and the two passes that make activation codes apart.
//
//   int8_conv_nhwc: y[b, ho, wo, o] = epilogue(sum_{r, c, i} xq[b, ho*s-p+r, wo*s-p+c, i] * wq[o, r, c, i])
//       xq (B, H, W, Cin) int8 NHWC, wq (Cout, kh, kw, Cin) int8 (K-contiguous),
//       int32 accumulation; the epilogue is the JAX package's,
//       float(acc) * (w_scale[o] * s), then + bias[o], then the cast to bf16
//       or fp32 (or, for checks, the raw int32 accumulator). kh = kw in {1, 3},
//       stride in {1, 2}, symmetric zero padding; a Linear is the 1x1 case over
//       (M, 1, 1, K) rows.
//   int8_conv_act_nhwc: the same conv of xq = clamp(rint(x / s), -127, 127),
//       s = max(absmax, 1e-12) / 127, from x (B, H, W, Cin) bf16 or fp32 and
//       the 0-d fp32 absmax: the codes are made in shared memory, in the
//       operand tile wgmma reads, and never reach device memory.
//   int8_quantize: xq = clamp(rint(x / s), -127, 127), s as above, x bf16 or
//       fp32; also writes s for the conv to read.
//   absmax: max |x| over a whole tensor into one fp32 device scalar.
//
// Counterparts of XLA programs, not of Pallas kernels: clip_codec_tpu/ops/int8.py's
// dynamic_int8_conv / static_int8_conv (:51, :80), Int8Conv (:108) and
// Int8Dense (:164) run lax.conv_general_dilated / dot_general on int8
// operands with preferred_element_type=int32, which XLA lowers itself, and
// the quantize before it (:68, :96, :200) as one expression of the same
// program. PyTorch has no int8 convolution on CUDA, so the port needs its own.
//
// What bounds it on an H100 (1,979 dense int8 TOP/s, 3.35 TB/s):
//   * the pixel U-Net's 3x3 convs at B = 16: the tensor cores (0.156 ms at
//     256^2 x 128->128, 0.039 ms at 128^2, 64^2, 32^2), with 4,096 to 256 output
//     tiles of 256 x 128: enough to fill 132 SMs;
//   * SD's 3x3 convs at B = 2 (CFG): the tensor cores too (0.0076 ms), but at
//     16^2 and 8^2 (M = 512, 128; K = 11,520) there are only 20 and 10 output
//     tiles, so without splitting K most SMs idle while a few walk 90 K steps;
//   * SD's 1x1 GEMMs at M = 8192: the bytes (0.002-0.014 ms), a few K steps a
//     tile, so the ring's fill and the epilogue's stores dominate;
//   * the context projections at M = 16: 16 rows cannot fill a 64-row wgmma;
//   * quantize and absmax: bytes-bound elementwise work, a few microseconds,
//     where absmax's launch is most of its time.
//
// The design of int8_conv_nhwc (replacing a first design on mma.sync.m16n8k32
// from a cp.async ring, one non-persistent block a 128 x 128 tile):
//   * products on wgmma.mma_async m64nNk32.s32.s8.s8 (sm90.cuh's WgmmaS8),
//     both operands K-major from 128-byte-swizzled shared memory by
//     descriptor (integer wgmma has no transpose; the weights are packed
//     (Cout, kh, kw, Cin), Cin contiguous). A block is two consumer
//     warpgroups (each 64 MW rows x BN columns, 232 registers by setmaxnreg)
//     and a producer warp (40 registers);
//   * operands by TMA on an mbarrier ring (4-8 stages of 128 bytes of K). A
//     tile is a (TB, TH, TW) block of output pixels, powers of two with the
//     columns first; each K step is one tap and 128 input channels, and the
//     tap's window of the input is then itself a 4-D box (channels, W, H, B)
//     at the corner shifted by (dy, dx), with a traversal stride of 2 along
//     W and H for the stride-2 convs. So every operand tile, 3x3 or 1x1, is
//     a plain K-major tile that ss wgmma reads by descriptor, and the
//     padding, the ragged image edge and the ragged last tile arrive as TMA's
//     zero fill (the choice against K2's halo-and-ldmatrix structure: one
//     code path for both strides, at the cost of reading each input tile
//     from L2 nine times rather than once). A 1x1, stride-1, unpadded conv
//     (a Linear) is a GEMM over M contiguous rows: the same box as (M, 1, 1)
//     pixels. Cin = 320 ends on a 64-channel step: the box is 128 wide and
//     TMA zero-fills the rest, so a sixth of those products is wasted (640,
//     768 and 1280 are whole steps);
//   * a persistent grid of min(units, SMs) blocks walking the units in
//     order, so the producer loads the next unit while the consumers run an
//     epilogue;
//   * the tile shape (MW, BN), the K split and the operand swap come from
//     ops/int8.py's int8_conv_plan, a pure function the CPU tests check;
//     this file runs what it is given and refuses what it cannot;
//   * split-K where the output tiles cannot fill the card: each of a tile's
//     `splits` units walks a contiguous slice of its K steps, stores its
//     int32 partial in a scratch slot of its own and bumps the tile's
//     arrival counter; the last to arrive adds the other slices' partials to
//     its registers (integer sums are exact in any order, so the output is
//     the plain version's bit for bit), resets the counter and runs the
//     epilogue. No atomic touches the data: red.adds of every slice into one
//     shared slot contend in L2 and measured slower. Only the counters need
//     a known start: the caller's scratch is zero when made and left so, and
//     a CUDA-graph replay needs no memset;
//   * M <= 64: the operands swap: the weights are the 128-row A side and
//     the few pixels wgmma's N (8 to 64), and the epilogue writes the
//     transposed tile;
//   * the epilogue rounds as the plain version does: __int2float_rn,
//     __fmul_rn(w_scale[o], s), __fmul_rn, __fadd_rn (so nvcc's default FMA
//     contraction cannot fuse two roundings), __float2bfloat16_rn. It is
//     specialised on the out kind and the bias (a branch a value was most of
//     its instructions), reads the unit's w_scale * s and bias from shared
//     memory (loaded while the products run), and stages each warp's 8 rows
//     x 128 bytes with TMA's 128-byte swizzle for a TMA store, two buffers a
//     warp; rows that are not consecutive pixels (a ragged image edge) leave
//     as 16-byte vectors of the pixels that exist.
// What holds it now: the epilogue of a unit does not overlap its products
// (the consumers run both), and at the GEMMs' 3-10 K steps it is the larger
// part of a unit.
//
// The act form (int8_conv_act_nhwc) folds the quantize pass into the conv
// (no round trip of the codes through device memory, and at SD's small
// shapes no launch of ~4 us against a bound under 1 us). Only where the
// activation operand comes from changes:
//   * TMA loads the tap's window as the same 4-D box, of bf16 or fp32: a
//     128-byte swizzled box is 64 or 32 channels, so a 128-channel K step is
//     2 or 4 boxes side by side in the stage. Padding, the ragged edge and
//     the stride-2 traversal stay TMA's; zero codes to 0, the plain padding;
//   * the consumers convert: each warpgroup turns its own 64 MW rows of the
//     staged window into the int8 K-major tile in place (over the first
//     box), in the same 128-byte swizzle (16-byte chunk c of row r at
//     c ^ (r % 8), 1024-byte-aligned tiles) that the descriptors read; a
//     row's threads are one warp's, so a __syncwarp orders their reads
//     before their writes (a thread that owns a whole row needs none: its
//     writes land on chunks it has read). In the swapped form the
//     activations are the B tile both warpgroups read, so all consumers
//     convert it. Then fence.proxy.async (the generic writes before the
//     async proxy's wgmma reads) and a named barrier. A step converts while
//     the previous step's products run on the tensor cores;
//   * the codes are bit-for-bit quantize_kernel's: s is act_scale(absmax),
//     and each code is int8_codes.cuh's exact_code_bits, RN(x / s) by two
//     fma from 1 / s (no division, no conversion-unit instruction, no
//     branch on the data). The epilogue reads the same s;
//   * a stage holds the staged window and the weights: at MW = 2 and bf16,
//     256 x 256 bytes beside BN x 128, so the ring is shorter (2-3 stages);
//     fp32 windows run MW = 1 tiles only. The plan (int8_conv_plan with the
//     activation's element size) knows this and prices the conversion;
//   * dynamic quantization needs absmax as a launch before it (a global max
//     precedes the first code); split-K slices convert their own steps.
// What holds it: a 3x3 converts, and reads from L2, each input value once a
// tap, nine times, a window twice the codes' width, so it is slower than
// int8_quantize + int8_conv_nhwc at every shape of the int8 paths, which
// therefore keep that pair (PERF.md).

#include <atomic>

#include "int8_codes.cuh"
#include "sm90.cuh"

namespace {

using namespace sm90;
using namespace int8_codes;

constexpr int KSTEP = 128;                         // K bytes a ring stage: one 128-byte swizzled row an operand row
constexpr int SMEM_LIMIT = 232448;
constexpr int MAX_STAGES = 8;
constexpr int STAGE_WARP = 2048;                   // epilogue staging a warp: two 1 KB buffers (8 rows x 128 bytes)
constexpr int SCALES = 2 * 2 * 256 * 4;            // a unit's w_scale * s and bias by column, two units deep
constexpr int UNIT_SLOTS = 2 * MAX_STAGES;         // units' decodes in flight: the producer leads by <= a ring
constexpr int SMEM_FIXED = 1024 + 8 * STAGE_WARP + 2 * MAX_STAGES * 8 + 16 + SCALES + UNIT_SLOTS * 32;
constexpr int THREADS = 3 * WARPGROUP;             // two consumer warpgroups, then the producer's
constexpr int CONSUMERS = 2 * WARPGROUP;
constexpr int SPLIT_TILE_INTS = 256 * 128;         // a split slice's scratch: 128 MW x BN int32 at most

enum OutKind { kOutBf16 = 0, kOutF32 = 1, kOutI32 = 2 };
// The activation operand: int8 codes (int8_conv_nhwc), or bf16 / fp32 values
// the kernel quantizes (int8_conv_act_nhwc). The value is its element size.
enum ActKind { kActS8 = 1, kActBf16 = 2, kActF32 = 4 };

// A stage: the activations' window, NB = ACT boxes of X_ROWS rows x 128
// bytes (the codes, after conversion, in the first), and W_ROWS rows of
// weights; the weights first when swapped, as wgmma's A. Every region is a
// multiple of 1024 bytes, so every tile stays swizzle-aligned.
template <int MW, int BN, bool SWAP, int ACT>
struct Cfg {
  static constexpr int NB = ACT;
  static constexpr int X_ROWS = SWAP ? BN : 128 * MW;  // pixels a tile (wgmma's M side unswapped: 64 MW a warpgroup)
  static constexpr int W_ROWS = SWAP ? 128 : BN;
  static constexpr int X_BOX = X_ROWS * KSTEP, W_BYTES = W_ROWS * KSTEP;
  static constexpr int X_OFF = SWAP ? W_BYTES : 0, W_OFF = SWAP ? 0 : NB * X_BOX;
  static constexpr int A_OFF = SWAP ? W_OFF : X_OFF, B_OFF = SWAP ? X_OFF : W_OFF;  // wgmma's operands
  static constexpr int STAGE = NB * X_BOX + W_BYTES;
  static constexpr int FIT = (SMEM_LIMIT - SMEM_FIXED) / STAGE;
  static constexpr int STAGES = FIT < MAX_STAGES ? FIT : MAX_STAGES;
  static constexpr int SMEM = SMEM_FIXED + STAGES * STAGE;
  static_assert(X_BOX % 1024 == 0 && W_BYTES % 1024 == 0 && STAGES >= 2 && SMEM <= SMEM_LIMIT,
                "int8 conv shared memory");
  static_assert(MW * BN / 2 <= 128, "accumulators a thread");
  static_assert(128 * MW * BN <= SPLIT_TILE_INTS, "a split slice's partial fits its scratch slot");
};

struct Params {
  const float* w_scale;   // (Cout,)
  const float* s;         // () activation scale
  const float* bias;      // (Cout,) or null
  void* y;                // (Bv, Ho, Wo, Cout)
  int* ws;                // split slices' partial sums: SPLIT_TILE_INTS a unit
  int* counters;          // an arrival counter a split tile
  int Bv, Ho, Wo, Cout;   // the output as the kernel walks it ((M, 1, 1) for a GEMM)
  int KW, stride, pad, chunks, k_steps;
  int TB, TH, TW, lTH, lTW, tiles_w, tiles_h, m_tiles, n_width, splits, units;
  int out_kind;
};

struct Unit {
  int tile, split, b0, h0, w0, n0, k0, k1;
};

// Unit u: slice u % splits of tile u / splits; tiles walk the output pixels
// fastest (columns, rows, images), then the channels: ops/int8.py's
// Int8ConvPlan.unit is the same map.
__device__ __forceinline__ Unit unit_of(const Params& p, int u) {
  Unit r;
  const int split = u % p.splits;
  r.split = split;
  r.tile = u / p.splits;
  const int mt = r.tile % p.m_tiles;
  r.n0 = r.tile / p.m_tiles * p.n_width;
  r.w0 = mt % p.tiles_w * p.TW;
  r.h0 = mt / p.tiles_w % p.tiles_h * p.TH;
  r.b0 = mt / (p.tiles_w * p.tiles_h) * p.TB;
  r.k0 = split * p.k_steps / p.splits;
  r.k1 = (split + 1) * p.k_steps / p.splits;
  return r;
}

// Index of tile row r's output pixel, or -1 outside the output.
__device__ __forceinline__ int pixel_of(const Params& p, const Unit& u, int r) {
  const int w = u.w0 + (r & (p.TW - 1)), h = u.h0 + ((r >> p.lTW) & (p.TH - 1)), b = u.b0 + (r >> (p.lTW + p.lTH));
  if (w >= p.Wo || h >= p.Ho || b >= p.Bv) return -1;
  return (b * p.Ho + h) * p.Wo + w;
}

// Element offset of tile row r's output pixel, or -1 outside the output.
__device__ __forceinline__ long long pixel_off(const Params& p, const Unit& u, int r) {
  const int px = pixel_of(p, u, r);
  return px < 0 ? -1 : static_cast<long long>(px) * p.Cout;
}

// One output value as 32 bits: the raw int32 (OUT = kOutI32), or the
// epilogue's fp32 (bf16 is rounded from it as it is staged or stored). The
// epilogue is specialised on OUT and BIAS: a branch per value would be most
// of its instructions.
template <int OUT, bool BIAS>
__device__ __forceinline__ uint32_t out_bits(int a, float sc, float b) {
  if (OUT == kOutI32) return static_cast<uint32_t>(a);
  float v = __fmul_rn(__int2float_rn(a), sc);
  if (BIAS) v = __fadd_rn(v, b);
  return __float_as_uint(v);
}

// Column n's w_scale and bias as stored (0 past Cout, and unread for int32 out).
__device__ __forceinline__ void load_column(const Params& p, int n, float& w, float& b) {
  w = 0.f, b = 0.f;
  if (p.out_kind == kOutI32 || n >= p.Cout) return;
  w = __ldg(p.w_scale + n);
  if (p.bias) b = __ldg(p.bias + n);
}

// 8 staged values (two 16-byte vectors of fp32 bits) as one vector of bf16.
__device__ __forceinline__ uint4 to_bf16x8(uint4 a, uint4 b) {
  uint4 o;
  o.x = pack_bf16(__uint_as_float(a.x), __uint_as_float(a.y));
  o.y = pack_bf16(__uint_as_float(a.z), __uint_as_float(a.w));
  o.z = pack_bf16(__uint_as_float(b.x), __uint_as_float(b.y));
  o.w = pack_bf16(__uint_as_float(b.z), __uint_as_float(b.w));
  return o;
}

// A warp's 16 accumulator rows x BN columns (m64 block i of its warpgroup)
// to y; sc and bi hold the tile's columns' w_scale * s and bias. Where the
// 16 rows are 16 consecutive output pixels (every tile of the main paths),
// each 8 rows x 128 bytes of output are staged (16-byte chunk c of row r at
// c ^ r, TMA's 128-byte swizzle) and leave by a TMA store, double-buffered,
// so the next unit's products start while they drain. Otherwise (a ragged
// image edge) the 16 rows are staged as 32 values of 4 bytes at a time and
// leave as 16-byte vectors of the pixels that exist.
template <int BN, int OUT, bool BIAS>
__device__ __forceinline__ void store_rows(const Params& p, const CUtensorMap* ty, const Unit& u,
                                           const int (&acc)[BN / 2], int rbase, unsigned char* stg, const float* sc,
                                           const float* bi, int lane, int& buf) {
  const int g = lane >> 2, q = lane & 3;
  constexpr bool bf16 = OUT == kOutBf16;
  const int first = pixel_of(p, u, rbase), last = pixel_of(p, u, rbase + 15);
  if (first >= 0 && last == first + 15) {
    constexpr int per = bf16 ? 8 : 4;  // 8-column groups in 128 bytes of output
    // This thread's bytes of row g of a buffer: its 16-byte chunk c (bf16:
    // c8 % 8; 4-byte values: 2 (c8 % 4) + q / 2) lands at c ^ g, so each
    // address is this base XOR (c8's part of c) << 4.
    const uint32_t mine = bf16 ? (g << 7) + (g << 4) + 4 * q : (g << 7) + ((g ^ (q >> 1)) << 4) + (q & 1) * 8;
    const float2* sc2 = reinterpret_cast<const float2*>(sc + 2 * q);
    const float2* bi2 = reinterpret_cast<const float2*>(bi + 2 * q);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
      for (int c8 = 0; c8 < BN / 8; ++c8) {
        if (c8 % per == 0) {  // the store that last read this buffer is done with it
          if (lane == 0) bulk_wait_read<1>();
          __syncwarp();
        }
        const float2 w = OUT == kOutI32 ? make_float2(0.f, 0.f) : sc2[4 * c8];
        const float2 b = BIAS && OUT != kOutI32 ? bi2[4 * c8] : make_float2(0.f, 0.f);
        const uint32_t v0 = out_bits<OUT, BIAS>(acc[4 * c8 + 2 * hh], w.x, b.x);
        const uint32_t v1 = out_bits<OUT, BIAS>(acc[4 * c8 + 2 * hh + 1], w.y, b.y);
        unsigned char* at = stg + buf * 1024 + (mine ^ ((bf16 ? (c8 & 7) : 2 * (c8 & 3)) << 4));
        if (bf16)
          *reinterpret_cast<uint32_t*>(at) = pack_bf16(__uint_as_float(v0), __uint_as_float(v1));
        else
          *reinterpret_cast<uint2*>(at) = make_uint2(v0, v1);
        if ((c8 + 1) % per == 0) {
          fence_proxy_async();
          __syncwarp();
          if (lane == 0) {
            tma_store_2d(ty, stg + buf * 1024, u.n0 + 8 * (c8 + 1 - per), first + 8 * hh);
            bulk_commit();
          }
          buf ^= 1;
        }
      }
    }
    return;
  }
  if (lane == 0) bulk_wait_read<0>();  // both buffers are free
  __syncwarp();
#pragma unroll
  for (int h = 0; h < (BN + 31) / 32; ++h) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int c8 = 4 * h + c;
      if (c8 >= BN / 8) break;
      const int cl = 8 * c8 + 2 * q;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = g + 8 * hh;
        const uint2 v = make_uint2(out_bits<OUT, BIAS>(acc[4 * c8 + 2 * hh], sc[cl], bi[cl]),
                                   out_bits<OUT, BIAS>(acc[4 * c8 + 2 * hh + 1], sc[cl + 1], bi[cl + 1]));
        *reinterpret_cast<uint2*>(stg + r * 128 + (((2 * c + (q >> 1)) ^ (r & 7)) << 4) + (q & 1) * 8) = v;
      }
    }
    __syncwarp();
    const int ncols = BN - 32 * h < 32 ? BN - 32 * h : 32;  // valid columns of this chunk
    if (bf16) {  // 16 rows x 4 vectors of 8 bf16
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int o = lane + 32 * j, r = o >> 2, part = o & 3, n = u.n0 + 32 * h + 8 * part;
        const long long off = pixel_off(p, u, rbase + r);
        if (8 * part < ncols && off >= 0 && n < p.Cout) {
          const uint4 a = *reinterpret_cast<const uint4*>(stg + r * 128 + (((2 * part) ^ (r & 7)) << 4));
          const uint4 b = *reinterpret_cast<const uint4*>(stg + r * 128 + (((2 * part + 1) ^ (r & 7)) << 4));
          *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(p.y) + off + n) = to_bf16x8(a, b);
        }
      }
    } else {  // 16 rows x 8 vectors of 4 fp32 or int32
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int v = lane + 32 * j, r = v >> 3, c16 = v & 7, n = u.n0 + 32 * h + 4 * c16;
        const long long off = pixel_off(p, u, rbase + r);
        if (4 * c16 < ncols && off >= 0 && n < p.Cout)
          *reinterpret_cast<uint4*>(static_cast<uint32_t*>(p.y) + off + n) =
              *reinterpret_cast<const uint4*>(stg + r * 128 + ((c16 ^ (r & 7)) << 4));
      }
    }
    __syncwarp();
  }
}

// The swapped tile: a warp's 16 accumulator rows are output channels
// n0c.., its BN columns tile rows (pixels). Staged as [32 pixels][16
// channels] of 4 bytes, so each pixel's 16 channels leave as 16-byte vectors.
template <int BN, int OUT, bool BIAS>
__device__ __forceinline__ void store_swapped(const Params& p, const Unit& u, const int (&acc)[BN / 2], int n0c,
                                              unsigned char* stg, int lane, float s) {
  const int g = lane >> 2, q = lane & 3;
  constexpr bool bf16 = OUT == kOutBf16;
  float sc[2], b[2];
  for (int e = 0; e < 2; ++e) {
    load_column(p, n0c + g + 8 * e, sc[e], b[e]);
    sc[e] = __fmul_rn(sc[e], s);
  }
#pragma unroll
  for (int h = 0; h < (BN + 31) / 32; ++h) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int c8 = 4 * h + c;
      if (c8 >= BN / 8) break;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int px = 8 * c + 2 * q + (e & 1), ch = g + 8 * (e >> 1);
        *reinterpret_cast<uint32_t*>(stg + px * 64 + ch * 4) = out_bits<OUT, BIAS>(acc[4 * c8 + e], sc[e >> 1], b[e >> 1]);
      }
    }
    __syncwarp();
    const int npx = BN - 32 * h < 32 ? BN - 32 * h : 32;
    if (bf16) {  // 32 pixels x 2 vectors of 8 bf16
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int o = lane + 32 * j, px = o >> 1, part = o & 1, n = n0c + 8 * part;
        const long long off = px < npx ? pixel_off(p, u, 32 * h + px) : -1;
        if (off >= 0 && n < p.Cout) {
          const uint4 a = *reinterpret_cast<const uint4*>(stg + px * 64 + part * 32);
          const uint4 bb = *reinterpret_cast<const uint4*>(stg + px * 64 + part * 32 + 16);
          *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(p.y) + off + n) = to_bf16x8(a, bb);
        }
      }
    } else {  // 32 pixels x 4 vectors of 4 fp32 or int32
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int v = lane + 32 * j, px = v >> 2, part = v & 3, n = n0c + 4 * part;
        const long long off = px < npx ? pixel_off(p, u, 32 * h + px) : -1;
        if (off >= 0 && n < p.Cout)
          *reinterpret_cast<uint4*>(static_cast<uint32_t*>(p.y) + off + n) =
              *reinterpret_cast<const uint4*>(stg + px * 64 + part * 16);
      }
    }
    __syncwarp();
  }
}

// ------------------------------------------------------------------ the codes

// The codes of one 16-byte chunk of the staged window, 8 bf16 or 4 fp32
// values, packed little-endian into 2 words or 1 at `out`.
template <int ACT>
__device__ __forceinline__ void chunk_codes(uint4 u, const Scale& q, uint32_t* out) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
  if (ACT == kActBf16) {
    float v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = __uint_as_float(e & 1 ? w[e >> 1] & 0xffff0000u : w[e >> 1] << 16);
    const uint2 c = codes8(v, q);
    out[0] = c.x;
    out[1] = c.y;
  } else if (q.ok) {
    uint32_t b[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) b[e] = exact_code_bits(__uint_as_float(w[e]), q.s, q.r, q.lim);
    out[0] = pack4(b[0], b[1], b[2], b[3]);
  } else {
    out[0] = divided_codes8(make_float4(__uint_as_float(w[0]), __uint_as_float(w[1]), __uint_as_float(w[2]),
                                        __uint_as_float(w[3])), make_float4(0.f, 0.f, 0.f, 0.f), q.s).x;
  }
}

// The 16 codes of item (row r, 16-byte chunk j) of a staged window `xs`
// (NB = ACT 128-byte-swizzled boxes of x_box bytes): channels 16 j.. of
// the row, logical chunks 2 (j % 4).. of box j / 4 (bf16) or 4 (j % 2)..
// of box j / 2 (fp32), each at its chunk XOR (r % 8).
template <int ACT>
__device__ __forceinline__ uint4 item_codes(const unsigned char* xs, int x_box, int r, int j, const Scale& q) {
  constexpr int CH = ACT == kActBf16 ? 2 : 4;  // source chunks an item
  const unsigned char* row = xs + (ACT == kActBf16 ? j >> 2 : j >> 1) * x_box + r * KSTEP;
  uint32_t out[4];
#pragma unroll
  for (int i = 0; i < CH; ++i) {
    const int ch = (ACT == kActBf16 ? 2 * (j & 3) : 4 * (j & 1)) + i;
    chunk_codes<ACT>(*reinterpret_cast<const uint4*>(row + ((ch ^ (r & 7)) << 4)), q, out + i * (4 / CH));
  }
  return make_uint4(out[0], out[1], out[2], out[3]);
}

// Rows [r0, r0 + R) of a staged window (X_ROWS rows a box) to the int8
// codes' K-major tile in place, over the first box, by NT threads (t): TPR
// threads a row, all in one warp (lane -> row lane % (32 / TPR), items j =
// sub, sub + TPR, ..), so a quarter warp reads 8 consecutive rows' same
// chunk. A row's item j writes chunk j of box 0, which holds the sources of
// items <= j / 2 only: one thread a row in order, or several after a
// __syncwarp.
// Then the async-proxy fence and barrier `bar` of the NT threads, after
// which wgmma may read the tile.
template <int ACT, int R, int X_ROWS, int NT>
__device__ __forceinline__ void convert_rows(unsigned char* xs, int r0, int t, const Scale& q, int bar) {
  constexpr int TPR = NT / R >= 8 ? 8 : NT / R, RPW = 32 / TPR, IPT = 8 / TPR;
  static_assert(NT % R == 0 && R >= RPW, "whole warps of whole rows, one pass");
  const int lane = t & 31, rp = (t >> 5) * RPW + lane % RPW, sub = lane / RPW;
  const int r = r0 + rp;
  unsigned char* dst = xs + r * KSTEP;
  if (rp < R) {
    if (TPR == 1) {
#pragma unroll 1
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<uint4*>(dst + ((j ^ (r & 7)) << 4)) = item_codes<ACT>(xs, X_ROWS * KSTEP, r, j, q);
    } else {
      uint4 c[IPT];
#pragma unroll
      for (int m = 0; m < IPT; ++m)
        c[m] = item_codes<ACT>(xs, X_ROWS * KSTEP, r, sub + TPR * m, q);
      __syncwarp();
#pragma unroll
      for (int m = 0; m < IPT; ++m) *reinterpret_cast<uint4*>(dst + (((sub + TPR * m) ^ (r & 7)) << 4)) = c[m];
    }
  }
  fence_proxy_async();
  bar_sync(bar, NT);
}

// A unit's epilogue, unswapped: its columns' w_scale * s and bias into
// shared memory (parity ui & 1: every consumer passed a barrier since the
// unit before last read it), then each m64 block's rows to y.
template <int MW, int BN>
__device__ __forceinline__ void store_tile(const Params& p, const CUtensorMap* ty, const Unit& u,
                                           int (&acc)[MW][BN / 2], float* scales, int ui, float col_w, float col_b,
                                           float s, int ctid, int wg, int wi, unsigned char* stg, int lane, int& buf) {
  float* sc = scales + (ui & 1) * 512;
  if (ctid < BN) {
    sc[ctid] = __fmul_rn(col_w, s);
    sc[256 + ctid] = col_b;
  }
  bar_sync(1, CONSUMERS);
#pragma unroll
  for (int i = 0; i < MW; ++i) {
    const int rbase = (wg * MW + i) * 64 + 16 * wi;
    switch (p.out_kind * 2 + (p.bias != nullptr)) {
      case 0: store_rows<BN, kOutBf16, false>(p, ty, u, acc[i], rbase, stg, sc, sc + 256, lane, buf); break;
      case 1: store_rows<BN, kOutBf16, true>(p, ty, u, acc[i], rbase, stg, sc, sc + 256, lane, buf); break;
      case 2: store_rows<BN, kOutF32, false>(p, ty, u, acc[i], rbase, stg, sc, sc + 256, lane, buf); break;
      case 3: store_rows<BN, kOutF32, true>(p, ty, u, acc[i], rbase, stg, sc, sc + 256, lane, buf); break;
      default: store_rows<BN, kOutI32, false>(p, ty, u, acc[i], rbase, stg, sc, sc + 256, lane, buf);
    }
  }
}

template <int MW, int BN, bool SWAP, int ACT>
__global__ void __launch_bounds__(THREADS, 1)
int8_conv_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
                 const __grid_constant__ CUtensorMap ty, const Params p) {
  using C = Cfg<MW, BN, SWAP, ACT>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);                            // [STAGES][Cfg's stage]
  unsigned char* stage_out = ring + C::STAGES * C::STAGE;               // [8 warps][STAGE_WARP]
  uint64_t* full = reinterpret_cast<uint64_t*>(stage_out + 8 * STAGE_WARP);
  uint64_t* empty = full + MAX_STAGES;
  int* last_flag = reinterpret_cast<int*>(empty + MAX_STAGES);
  float* scales = reinterpret_cast<float*>(last_flag + 4);              // [2 units][w_scale * s, bias][256]
  Unit* decoded = reinterpret_cast<Unit*>(scales + 2 * 512);              // [UNIT_SLOTS]

  // This block's units; computed in each role after setmaxnreg (ptxas spilled it across the boundary).
  auto units_of_block = [&]() {
    return (int)blockIdx.x < p.units ? (p.units - 1 - (int)blockIdx.x) / (int)gridDim.x + 1 : 0;
  };
  const int wg = threadIdx.x / WARPGROUP, warp_id = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS / 32);  // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {
    // ---------------------------------------------------------------- producer
    reg_dealloc<40>();
    if (warp_id == 8 && lane == 0) {
      int it = 0;
      const int my_units = units_of_block();
      for (int ui = 0; ui < my_units; ++ui) {
        const Unit u = unit_of(p, blockIdx.x + ui * gridDim.x);
        for (int ks = u.k0; ks < u.k1; ++ks, ++it) {
          const int s = it % C::STAGES;
          mbar_wait(&empty[s], ((it / C::STAGES) & 1) ^ 1);  // the first round passes: the ring starts empty
          // The unit's first stage also publishes its decode: the consumers
          // read it after that stage's barrier, which the arrival releases.
          if (ks == u.k0) decoded[ui % UNIT_SLOTS] = u;
          mbar_expect_tx(&full[s], C::STAGE);
          const int tap = ks / p.chunks, c0 = (ks - tap * p.chunks) * KSTEP, dy = tap / p.KW, dx = tap - dy * p.KW;
          unsigned char* st = ring + s * C::STAGE;
#pragma unroll
          for (int b = 0; b < C::NB; ++b)  // the window's 128 channels as NB boxes of 128 bytes
            tma_load_4d(st + C::X_OFF + b * C::X_BOX, &tx, &full[s], c0 + b * (KSTEP / C::NB),
                        u.w0 * p.stride - p.pad + dx, u.h0 * p.stride - p.pad + dy, u.b0);
          tma_load_3d(st + C::W_OFF, &tw, &full[s], c0, tap, u.n0);
        }
      }
    }
    return;
  }

  // ------------------------------------------------------------------ consumers
  reg_alloc<232>();
  const int wi = warp_id % 4, ctid = threadIdx.x;
  unsigned char* stg = stage_out + warp_id * STAGE_WARP;
  // The act form reads absmax and makes s as quantize_kernel does.
  const float s = ACT != kActS8 ? act_scale(p.s) : p.out_kind == kOutI32 ? 0.f : __ldg(p.s);
  const Scale q = scale_of(s);
  auto release = [&](int st) {  // this warp is done reading stage st
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
  };
  int acc[MW][BN / 2];
#pragma unroll
  for (int i = 0; i < MW; ++i)
#pragma unroll
    for (int j = 0; j < BN / 2; ++j) acc[i][j] = 0;

  int it = 0, buf = 0;
  const int my_units = units_of_block();
  for (int ui = 0; ui < my_units; ++ui) {
    mbar_wait(&full[it % C::STAGES], (it / C::STAGES) & 1);
    const Unit u = decoded[ui % UNIT_SLOTS];
    const int nk = u.k1 - u.k0;
    float col_w = 0.f, col_b = 0.f;  // column u.n0 + ctid's, loaded while the products run
    if (!SWAP && ctid < BN) load_column(p, u.n0 + ctid, col_w, col_b);
    for (int k = 0; k < nk; ++k, ++it) {
      const int st = it % C::STAGES;
      if (k > 0) mbar_wait(&full[st], (it / C::STAGES) & 1);
      unsigned char* tile = ring + st * C::STAGE;
      if (ACT != kActS8) {  // the window to codes, while the previous step's products run
        if (SWAP)
          convert_rows<ACT, BN, C::X_ROWS, CONSUMERS>(tile + C::X_OFF, 0, ctid, q, 1);
        else
          convert_rows<ACT, 64 * MW, C::X_ROWS, WARPGROUP>(tile + C::X_OFF, wg * 64 * MW, ctid % WARPGROUP, q, 2 + wg);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KSTEP / 32; ++kk) {  // k32 steps: 32 bytes of each 128-byte row
        const uint64_t db = desc_sw128(tile + C::B_OFF + 32 * kk, 16, 1024);
#pragma unroll
        for (int i = 0; i < MW; ++i)
          WgmmaS8<BN>::ss(acc[i], desc_sw128(tile + C::A_OFF + (wg * MW + i) * 64 * KSTEP + 32 * kk, 16, 1024), db,
                          k > 0 || kk > 0);
      }
      wgmma_commit();
      wgmma_wait<1>();  // the previous step's products have retired
      if (k > 0) release((it - 1) % C::STAGES);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < MW; ++i) fence_regs(acc[i]);
    if (nk > 0) release((it - 1) % C::STAGES);

    if (p.splits > 1) {
      // This slice's partial into its own scratch slot, as 16-byte vectors
      // interleaved by thread (a warp's stores are contiguous), in the
      // register layout every slice shares; the last slice to arrive adds
      // the others' into its registers.
      constexpr int V = BN / 8;  // int4 vectors an m64 block's accumulators make
      const auto slot = [&](int split) {
        return reinterpret_cast<int4*>(p.ws) + (static_cast<long long>(u.tile) * p.splits + split) * (SPLIT_TILE_INTS / 4);
      };
      int4* mine = slot(u.split);
#pragma unroll
      for (int i = 0; i < MW; ++i)
#pragma unroll
        for (int v = 0; v < V; ++v)
          __stcg(mine + (i * V + v) * CONSUMERS + ctid,
                 make_int4(acc[i][4 * v], acc[i][4 * v + 1], acc[i][4 * v + 2], acc[i][4 * v + 3]));
      __threadfence();
      bar_sync(1, CONSUMERS);
      if (ctid == 0) {
        int* count = p.counters + u.tile;
        const int last = atomicAdd(count, 1) == p.splits - 1;
        if (last) *count = 0;  // every slice has arrived: ready for the next launch
        *last_flag = last;
      }
      bar_sync(1, CONSUMERS);
      const int last = *last_flag;
      bar_sync(1, CONSUMERS);  // last_flag is read before the next unit writes it
      if (!last) continue;
      __threadfence();
#pragma unroll 1
      for (int o = 0; o < p.splits; ++o) {  // integer sums: exact in any order
        if (o == u.split) continue;
        const int4* other = slot(o);
#pragma unroll
        for (int i = 0; i < MW; ++i)
#pragma unroll
          for (int v = 0; v < V; ++v) {
            const int4 w = __ldcg(other + (i * V + v) * CONSUMERS + ctid);
            acc[i][4 * v] += w.x, acc[i][4 * v + 1] += w.y, acc[i][4 * v + 2] += w.z, acc[i][4 * v + 3] += w.w;
          }
      }
    }

    if (SWAP) {
      switch (p.out_kind * 2 + (p.bias != nullptr)) {
        case 0: store_swapped<BN, kOutBf16, false>(p, u, acc[0], u.n0 + 64 * wg + 16 * wi, stg, lane, s); break;
        case 1: store_swapped<BN, kOutBf16, true>(p, u, acc[0], u.n0 + 64 * wg + 16 * wi, stg, lane, s); break;
        case 2: store_swapped<BN, kOutF32, false>(p, u, acc[0], u.n0 + 64 * wg + 16 * wi, stg, lane, s); break;
        case 3: store_swapped<BN, kOutF32, true>(p, u, acc[0], u.n0 + 64 * wg + 16 * wi, stg, lane, s); break;
        default: store_swapped<BN, kOutI32, false>(p, u, acc[0], u.n0 + 64 * wg + 16 * wi, stg, lane, s);
      }
    } else {
      store_tile<MW, BN>(p, &ty, u, acc, scales, ui, col_w, col_b, s, ctid, wg, wi, stg, lane, buf);
    }
  }
  if (lane == 0) bulk_wait<0>();  // this warp's stores have left shared memory
}

// ------------------------------------------------------------ quantize, absmax

constexpr int kEwThreads = 256;
constexpr int kAbsmaxUnroll = 4;

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
  const Scale q = scale_of(act_scale(absmax));
  if (blockIdx.x == 0 && threadIdx.x == 0) *s_out = q.s;
  for (long long k = blockIdx.x * static_cast<long long>(kEwThreads) + threadIdx.x; k < n8;
       k += static_cast<long long>(gridDim.x) * kEwThreads) {
    float v[8];
    load8(x, bf16, k * 8, v);
    reinterpret_cast<uint2*>(xq)[k] = codes8(v, q);
  }
}

__device__ __forceinline__ float block_max(float m, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = m;
  __syncthreads();
  m = red[0];
#pragma unroll
  for (int w = 1; w < kEwThreads / 32; ++w) m = fmaxf(m, red[w]);
  return m;
}

// max |x| in one launch: each block's max into partial[block]; the last
// block to arrive (counter, reset by it) takes the max of the partials. A
// max is exact and order-free, so the result is the plain version's.
__global__ void __launch_bounds__(kEwThreads) absmax_kernel(const void* x, bool bf16, long long n8,
                                                            unsigned int* counter, float* partial, float* out) {
  __shared__ float red[kEwThreads / 32];
  __shared__ int last;
  float m = 0.f;
  const long long step = static_cast<long long>(gridDim.x) * kEwThreads;
  long long k = blockIdx.x * static_cast<long long>(kEwThreads) + threadIdx.x;
  for (; k + (kAbsmaxUnroll - 1) * step < n8; k += kAbsmaxUnroll * step) {  // loads in flight together
    float v[kAbsmaxUnroll][8];
#pragma unroll
    for (int r = 0; r < kAbsmaxUnroll; ++r) load8(x, bf16, (k + r * step) * 8, v[r]);
#pragma unroll
    for (int r = 0; r < kAbsmaxUnroll; ++r)
#pragma unroll
      for (int e = 0; e < 8; ++e) m = fmaxf(m, fabsf(v[r][e]));
  }
  for (; k < n8; k += step) {
    float v[8];
    load8(x, bf16, k * 8, v);
#pragma unroll
    for (int e = 0; e < 8; ++e) m = fmaxf(m, fabsf(v[e]));
  }
  m = block_max(m, red);
  if (threadIdx.x == 0) {
    partial[blockIdx.x] = m;
    __threadfence();
    last = atomicAdd(counter, 1u) == gridDim.x - 1;
    if (last) *counter = 0;  // every block has arrived: ready for the next launch
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  m = 0.f;
  for (int b = threadIdx.x; b < (int)gridDim.x; b += kEwThreads) m = fmaxf(m, __ldcg(partial + b));
  __syncthreads();  // red is reused
  m = block_max(m, red);
  if (threadIdx.x == 0) *out = m;
}

int ew_blocks(long long n8) {
  int sms = 132;
  int dev = 0;
  if (cudaGetDevice(&dev) == cudaSuccess) cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long want = (n8 + kEwThreads - 1) / kEwThreads;
  const long long cap = static_cast<long long>(sms) * 8;
  return static_cast<int>(want < cap ? (want > 0 ? want : 1) : cap);
}

template <int MW, int BN, bool SWAP, int ACT>
int launch_conv(const CUtensorMap& tx, const CUtensorMap& tw, const CUtensorMap& ty, const Params& p, int stages,
                int blocks, cudaStream_t stream) {
  using C = Cfg<MW, BN, SWAP, ACT>;
  if (stages != C::STAGES) return static_cast<int>(cudaErrorInvalidValue);
  const auto fn = int8_conv_kernel<MW, BN, SWAP, ACT>;
  // The shared-memory attribute is set once a device (bit d of `set_on`):
  // the SD path launches thousands of convs a request.
  static std::atomic<unsigned long long> set_on{0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (!(set_on.load(std::memory_order_relaxed) & bit)) {
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    set_on.fetch_or(bit, std::memory_order_relaxed);
  }
  fn<<<dim3(blocks, 1), THREADS, C::SMEM, stream>>>(tx, tw, ty, p);
  return static_cast<int>(cudaGetLastError());
}

bool pow2(int v) { return v > 0 && (v & (v - 1)) == 0; }

int log2i(int v) {
  int l = 0;
  while ((1 << l) < v) ++l;
  return l;
}

// The plan's tile (mw, bn, swap) for activations of kind ACT: the forms this
// file holds (fp32 windows: MW = 1 only, a 256-row one leaves no second stage).
template <int ACT>
int launch_tile(const CUtensorMap& tx, const CUtensorMap& tw, const CUtensorMap& ty, const Params& p, int mw, int bn,
                int swap, int stages, int blocks, cudaStream_t stream) {
  const int inval = static_cast<int>(cudaErrorInvalidValue);
  if (swap) {
    if (mw != 1) return inval;
    switch (bn) {
      case 8: return launch_conv<1, 8, true, ACT>(tx, tw, ty, p, stages, blocks, stream);
      case 16: return launch_conv<1, 16, true, ACT>(tx, tw, ty, p, stages, blocks, stream);
      case 32: return launch_conv<1, 32, true, ACT>(tx, tw, ty, p, stages, blocks, stream);
      case 64: return launch_conv<1, 64, true, ACT>(tx, tw, ty, p, stages, blocks, stream);
      default: return inval;
    }
  }
  switch (mw * 1000 + bn) {
    case 1064: return launch_conv<1, 64, false, ACT>(tx, tw, ty, p, stages, blocks, stream);
    case 1128: return launch_conv<1, 128, false, ACT>(tx, tw, ty, p, stages, blocks, stream);
    case 1256: return launch_conv<1, 256, false, ACT>(tx, tw, ty, p, stages, blocks, stream);
    default: break;
  }
  if constexpr (ACT == kActF32) {
    return inval;
  } else {
    switch (mw * 1000 + bn) {
      case 2064: return launch_conv<2, 64, false, ACT>(tx, tw, ty, p, stages, blocks, stream);
      case 2128: return launch_conv<2, 128, false, ACT>(tx, tw, ty, p, stages, blocks, stream);
      default: return inval;
    }
  }
}

// Both entry points: `act` the activation kind (kActS8: x holds the codes
// and `scale` s; otherwise x holds bf16 or fp32 values and `scale` their
// absmax).
int conv_entry(int act, const void* x, const void* wq, const void* w_scale, const void* scale,
               const void* bias, void* y, void* ws, long long ws_bytes, int B, int H, int W, int Cin, int Cout,
               int KH, int KW, int stride, int pad, int out_kind, int mw, int bn, int splits, int swap, int gemm,
               int tb, int th, int tw, int blocks, int stages, int sms, void* stream_) {
  const int inval = static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0 || Cin % 32 || Cout % 8 || KH != KW ||
      (KH != 1 && KH != 3) || (stride != 1 && stride != 2) || pad < 0 || pad > 1 || out_kind < 0 || out_kind > 2 ||
      (act != kActS8 && act != kActBf16 && act != kActF32))
    return inval;
  const int Ho = (H + 2 * pad - KH) / stride + 1, Wo = (W + 2 * pad - KW) / stride + 1;
  if (Ho <= 0 || Wo <= 0) return inval;
  if (gemm && (KH != 1 || stride != 1 || pad != 0)) return inval;
  const long long M = static_cast<long long>(B) * Ho * Wo;
  if (M > 0x7fffffffLL) return inval;
  const int rows = swap ? bn : 128 * mw;
  if (!pow2(tb) || !pow2(th) || !pow2(tw) || tb * th * tw != rows || tb > 256 || th * stride > 256 ||
      tw * stride > 256)
    return inval;
  Params p;
  p.w_scale = static_cast<const float*>(w_scale);
  p.s = static_cast<const float*>(scale);
  p.bias = static_cast<const float*>(bias);
  p.y = y;
  p.ws = static_cast<int*>(ws);
  p.counters = ws == nullptr ? nullptr : p.ws + 2LL * sms * SPLIT_TILE_INTS;
  p.Bv = gemm ? static_cast<int>(M) : B, p.Ho = gemm ? 1 : Ho, p.Wo = gemm ? 1 : Wo, p.Cout = Cout;
  p.KW = KW, p.stride = stride, p.pad = pad, p.chunks = (Cin + KSTEP - 1) / KSTEP, p.k_steps = KH * KW * p.chunks;
  p.TB = tb, p.TH = th, p.TW = tw, p.lTH = log2i(th), p.lTW = log2i(tw);
  p.tiles_w = (p.Wo + tw - 1) / tw, p.tiles_h = (p.Ho + th - 1) / th;
  const long long m_tiles = static_cast<long long>((p.Bv + tb - 1) / tb) * p.tiles_h * p.tiles_w;
  p.n_width = swap ? 128 : bn;
  const long long tiles = m_tiles * ((Cout + p.n_width - 1) / p.n_width);
  const long long ws_need = (2LL * sms * SPLIT_TILE_INTS + sms) * static_cast<long long>(sizeof(int));
  if (splits < 1 || splits > p.k_steps ||
      (splits > 1 && (tiles >= sms || tiles * splits > 2 * sms || !ws || ws_bytes < ws_need)) ||
      tiles * splits > 0x7fffffffLL || blocks < 1 || blocks > tiles * splits)
    return inval;
  p.m_tiles = static_cast<int>(m_tiles), p.splits = splits, p.units = static_cast<int>(tiles * splits);
  p.out_kind = out_kind;

  // The activations: (Cin, W, H, B) with the tile's box at the tap's corner
  // and traversal stride `stride` along W and H; a GEMM's rows as (Cin, 1, 1, M).
  // A box is 128 bytes of channels (128 codes, 64 bf16, 32 fp32).
  const int esz = act;
  CUtensorMap tx, twm;
  const cuuint64_t xdims[4] = {(cuuint64_t)Cin, gemm ? 1u : (cuuint64_t)W, gemm ? 1u : (cuuint64_t)H,
                               gemm ? (cuuint64_t)M : (cuuint64_t)B};
  const cuuint64_t row = (cuuint64_t)Cin * esz;
  const cuuint64_t xstrides[3] = {row, gemm ? row : (cuuint64_t)W * row, gemm ? row : (cuuint64_t)H * W * row};
  const cuuint32_t xbox[4] = {(cuuint32_t)(KSTEP / esz), (cuuint32_t)(tw * stride), (cuuint32_t)(th * stride),
                              (cuuint32_t)tb};
  const cuuint32_t xelem[4] = {1, (cuuint32_t)stride, (cuuint32_t)stride, 1};
  const CUtensorMapDataType xtype = act == kActS8     ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                                    : act == kActBf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                                      : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  if (int e = tmap_tiled(&tx, xtype, x, 4, xdims, xstrides, xbox, xelem, CU_TENSOR_MAP_SWIZZLE_128B)) return e;
  // The weights: (Cin, taps, Cout), a box of one tap's 128 channels of 128 (swap) or bn output channels.
  const cuuint64_t wdims[3] = {(cuuint64_t)Cin, (cuuint64_t)(KH * KW), (cuuint64_t)Cout};
  const cuuint64_t wstrides[2] = {(cuuint64_t)Cin, (cuuint64_t)KH * KW * Cin};
  const cuuint32_t wbox[3] = {KSTEP, 1, (cuuint32_t)(swap ? 128 : bn)};
  const cuuint32_t welem[3] = {1, 1, 1};
  if (int e = tmap_tiled(&twm, CU_TENSOR_MAP_DATA_TYPE_UINT8, wq, 3, wdims, wstrides, wbox, welem,
                         CU_TENSOR_MAP_SWIZZLE_128B))
    return e;
  // The output: (Cout, M) pixels, stored 8 pixels x 128 bytes at a time.
  CUtensorMap ty;
  const int ysz = out_kind == kOutBf16 ? 2 : 4;
  const CUtensorMapDataType ytype = out_kind == kOutBf16  ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                    : out_kind == kOutF32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                                          : CU_TENSOR_MAP_DATA_TYPE_INT32;
  const cuuint64_t ydims[2] = {(cuuint64_t)Cout, (cuuint64_t)M};
  const cuuint64_t ystrides[1] = {(cuuint64_t)Cout * ysz};
  const cuuint32_t ybox[2] = {(cuuint32_t)(128 / ysz), 8};
  const cuuint32_t yelem[2] = {1, 1};
  if (int e = tmap_tiled(&ty, ytype, y, 2, ydims, ystrides, ybox, yelem, CU_TENSOR_MAP_SWIZZLE_128B)) return e;

  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  switch (act) {
    case kActS8: return launch_tile<kActS8>(tx, twm, ty, p, mw, bn, swap, stages, blocks, stream);
    case kActBf16: return launch_tile<kActBf16>(tx, twm, ty, p, mw, bn, swap, stages, blocks, stream);
    default: return launch_tile<kActF32>(tx, twm, ty, p, mw, bn, swap, stages, blocks, stream);
  }
}

}  // namespace

// y = int8 conv of xq (B, H, W, Cin) with wq (Cout, KH, KW, Cin); out_kind 0 bf16,
// 1 fp32, 2 the raw int32 accumulator (w_scale, s and bias unread). Device
// pointers, xq and wq 16-byte aligned; Cin % 32 == 0, Cout % 8 == 0,
// KH == KW in {1, 3}, stride in {1, 2}, pad in {0, 1}. The plan (ops/int8.py's
// int8_conv_plan): (mw, bn) the tile, `splits` K slices a tile, `swap` the
// operands, `gemm` the (M, 1, 1) view (1x1, stride 1, pad 0 only), (tb, th,
// tw) a tile's pixels, `blocks` persistent blocks, `stages` the ring (must be
// this build's), `sms` the card's SM count. `ws`, of `ws_bytes`: the scratch,
// 2 sms x SPLIT_TILE_INTS int32 partials then sms counters (zero, and left
// zero), needed when splits > 1, which takes fewer tiles than sms and at most
// 2 sms units; a launch it could not hold is refused. Launches on `stream`;
// returns 0, a CUDA error or one of sm90.cuh's tensor-map codes.
extern "C" int int8_conv_nhwc(const void* xq, const void* wq, const void* w_scale, const void* s, const void* bias,
                              void* y, void* ws, long long ws_bytes, int B, int H, int W, int Cin, int Cout, int KH,
                              int KW, int stride, int pad, int out_kind, int mw, int bn, int splits, int swap, int gemm,
                              int tb, int th, int tw, int blocks, int stages, int sms, void* stream_) {
  return conv_entry(kActS8, xq, wq, w_scale, s, bias, y, ws, ws_bytes, B, H, W, Cin, Cout, KH, KW, stride, pad,
                    out_kind, mw, bn, splits, swap, gemm, tb, th, tw, blocks, stages, sms, stream_);
}

// int8_conv_nhwc of the codes of x (B, H, W, Cin), bf16 (act_bytes 2) or fp32
// (4), 16-byte aligned, made in shared memory against the 0-d fp32 `absmax`
// (s = max(absmax, 1e-12) / 127, as int8_quantize); the plan is the one for
// this activation kind (its `stages`; fp32 takes mw = 1 only).
extern "C" int int8_conv_act_nhwc(const void* x, int act_bytes, const void* wq, const void* w_scale,
                                  const void* absmax, const void* bias, void* y, void* ws, long long ws_bytes, int B,
                                  int H, int W, int Cin, int Cout, int KH, int KW, int stride, int pad, int out_kind,
                                  int mw, int bn, int splits, int swap, int gemm, int tb, int th, int tw, int blocks,
                                  int stages, int sms, void* stream_) {
  if (act_bytes != kActBf16 && act_bytes != kActF32) return static_cast<int>(cudaErrorInvalidValue);
  return conv_entry(act_bytes, x, wq, w_scale, absmax, bias, y, ws, ws_bytes, B, H, W, Cin, Cout, KH, KW,
                    stride, pad, out_kind, mw, bn, splits, swap, gemm, tb, th, tw, blocks, stages, sms, stream_);
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
// `scratch`, of `scratch_bytes`: a counter (zero, left zero) padded to 16
// bytes, then a float a block; `sms` the card's SM count (at most 2 blocks a
// SM). A launch whose blocks the scratch could not hold is refused.
extern "C" int absmax(const void* x, int is_bf16, long long n, void* out, void* scratch, long long scratch_bytes,
                      int sms, void* stream_) {
  if (n <= 0 || n % 8 || scratch == nullptr || sms <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long n8 = n / 8, want = (n8 + kEwThreads * kAbsmaxUnroll - 1) / (kEwThreads * kAbsmaxUnroll);
  const int blocks = static_cast<int>(want < 2LL * sms ? want : 2LL * sms);
  if (scratch_bytes < 16 + 4LL * blocks) return static_cast<int>(cudaErrorInvalidValue);
  unsigned int* counter = static_cast<unsigned int*>(scratch);
  absmax_kernel<<<blocks, kEwThreads, 0, static_cast<cudaStream_t>(stream_)>>>(
      x, is_bf16 != 0, n8, counter, reinterpret_cast<float*>(counter + 4), static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

