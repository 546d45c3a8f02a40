// Fused GroupNorm + SiLU for Hopper (sm_90a), NHWC, bf16 or fp32:
//
//     y = silu((x - mean_g) * rsqrt(var_g + eps) * scale[c] + bias[c])
//
// with per-(sample, group) statistics in fp32 over H*W*(C/G) elements, in the
// raw-moment form mean = S/n, var = SS/n - mean^2 (no clamp), and y stored
// once in x's dtype.
//
// Replaces the TPU kernels clip_codec_tpu/ops/pallas_groupnorm.py:_stats_kernel
// and :_norm_kernel (entered there through group_norm_silu_pallas), which read
// x twice: once for the statistics, once to normalise.
//
// What bounds it on an H100: a handful of flops per element against 2-4
// bytes, far below the card's ~295 flop/byte ridge, so device memory: the
// least traffic is x read once and y written once. A statistics pass and a
// normalising pass read x twice, and at the largest training shape (8, 256,
// 256, 128) bf16 x is 134 MB, well past the 50 MB L2. So this is ONE
// persistent launch that reads x from device memory once:
//
//   * Slabs. Each sample's H*W rows are cut into chunks of up to 32 KB (one
//     bulk copy, one buffer) and the chunks into slabs of 1 to 4 chunks
//     (the last of a sample ragged): the unit of the statistics and of the
//     work. The cut is a function of the shape alone (ops/groupnorm.py
//     `slab_cut`, which the plain version shares), never of the SM count.
//     The rest of the plan, below, is `make_plan`'s.
//   * Rounds. One block an SM (grid <= the SM count), each with a ring of
//     `ring` chunk buffers in shared memory. A round takes as many whole
//     samples as (ring - 1) / chunks slabs a block hold (a buffer is left
//     for the next round's first loads); its slab i goes to block i % grid,
//     slot i / grid. A sample larger than a round keeps the first of its
//     slabs in the buffers, and its other slabs ("overflow") are read from
//     device memory in both passes.
//   * One producer warp a block issues every TMA bulk copy: the chunks'
//     loads on a full-barrier ring, and each normalised chunk's store
//     straight from its buffer. A buffer is refilled with the block's next
//     chunk (the next round's, once this round's are all resident) as soon
//     as the store has read it, so loads and stores of consecutive rounds
//     overlap.
//   * Eight compute warps, per round: each slab's per-group fp32 sum and
//     sum of squares as its chunks land (8 channels a thread, rows split
//     among the lanes; see `publish` for the order) -> 2 G floats in a
//     global workspace (B, S, 2, G); one grid barrier; the group mean and
//     rstd of each of the block's samples from its slab partials, summed
//     in an order fixed by S and G (`sample_stats`), in raw moments; every
//     chunk normalised in place (affine, SiLU) and released to the producer.
//   * The SiLU is t / (1 + 2^(-t log2 e)): 2^u on the exp unit (ex2.approx),
//     the reciprocal approximate, on the exp unit for half the channels and
//     by two Newton steps on the FMA pipe for the other half. No accurate
//     expf, no IEEE divide.
//
// The same x therefore gives bit-equal y in every run, every graph replay
// and on any SM count: a slab's partial does not depend on which block sums
// it or whether it sat in shared memory, and the partials are summed in an
// order fixed by the shape.
//
// The grid barrier needs every block resident at once: the launch is
// cooperative (cudaLaunchAttributeCooperative, which CUDA refuses
// rather than run a grid that cannot be co-resident, and which
// torch.cuda.graph captures as a cooperative kernel node), with one block an
// SM (its shared memory allows no second). Its state, four words in a
// device buffer that the caller zeroes once, is left as found by every
// launch (`grid_sync`), so no launch needs a memset and a replayed CUDA
// graph stays correct. Calls on one device share the buffer, so they must
// not run concurrently on two streams. A wait (mbarrier or grid barrier)
// that makes no progress for 10 s traps: the launch fails with an error
// rather than hang the card.
//
// Groups of fewer than 8 channels (C/G < 8) split a thread's 8-channel vector
// across groups; each thread keeps the group of each of its channels.
//
// The split form (groupnorm_silu_stats, groupnorm_silu_apply): the same
// statistics and normalisation in two ordinary launches, for a caller that
// has to combine the statistics of several tensors between the two, as a
// U-Net whose image height is split over ranks sums its GroupNorm totals
// over them (models/unet.py, the spatial form). No grid barrier can span two
// ranks, so the one launch above cannot serve it; the TPU original is two
// pallas_calls for the same reason. One block a slab (grid (S, B)):
//   * gn_stats_kernel sums its slab chunk by chunk in row order, as the one
//     launch's `accumulate` does, and `publish`es -> the (B, S, 2, G)
//     partials; with no shift they are the one launch's bits for the same
//     slab cut. With a shift (B, G) it sums x - shift and its squares: the
//     shifted-data form of the variance, which a caller that can pass a
//     mean estimate (the spatial U-Net: the mean from a first, unshifted
//     pass) uses to keep the raw-moment difference SS/n - mean^2 from
//     cancelling where |mean| >> std;
//   * gn_apply_kernel takes (B, 2, G) fp32 totals over n elements a group
//     (the caller sums the partials, and across ranks) of x - shift (shift
//     0 when none is given), forms mean = shift + S/n and rstd in raw
//     moments of the shifted data, and normalises its slab with the one
//     launch's `normalise`, x to y.
// Bound: memory. The unshifted pair reads x twice and writes y once (the
// one launch reads x once), the shifted form reads it three times; at the
// spatial U-Net's shapes the extra passes cost what the cross-rank sums
// between them need.
//
// The codes-out form (groupnorm_silu_int8): the same launch, for the pixel
// U-Net's static int8 path, where K1's output is only ever read by the int8
// conv after it. Each normalised value is rounded as the one launch stores it
// (to bf16 for bf16 x), then turned into its int8 code against the layer's
// calibrated absmax (int8_codes.cuh: s = max(absmax, 1e-12) / 127, read on
// the device, so the launch is captured and replayed like K1's; the code by
// exact_code_bits, as int8_quantize codes: RN(y / s) from 1 / s and two fma,
// with no division and no near-half fallback, so every scale costs the same,
// also a power of two, where many quotients are exact halves), and the codes are stored in place
// of y, with s. So the codes are bit for bit K1 followed by
// int8_quantize, from one read of x and one write of 1 byte an element: the
// pair's 2 + 2 + 2 + 1 bytes an element of traffic become 2 + 1 (bf16).
//   * A chunk's codes are built in its own ring buffer, each over values its
//     own threads have read, so no barrier of the block is needed. The
//     compute threads form units (a warp where C / 8 divides 32; the C / 8
//     threads of a row where 32 divides C / 8; else all 256); unit u takes
//     the chunk's rows [u R, u R + R), 4 k rows a step (k = its threads /
//     (C / 8), so each thread codes 4 rows a step), and writes row j's codes to bytes [j C, j C + C) of its own
//     rows, which hold the values of row j / 2 (j / 4 in fp32), read at or
//     before row j: the unit's threads meet (__syncwarp, or a named barrier)
//     between each step's reads and its writes. The producer's bulk stores
//     then take each unit's first len * C bytes (up to 8 stores a chunk at
//     the pixel shapes). Slabs read from device memory write their codes
//     there directly.
//   * The slab cut, plan, ring and rounds are the one launch's for x's
//     dtype: the statistics, and so the codes, are bit-equal to K1's on any
//     SM count. C % 16 == 0 (16-byte bulk copies of the codes; the int8 conv
//     needs C % 32 == 0 anyway).
// Bound: memory, x read once and the codes written once (3 bytes an element
// in bf16, 5 in fp32).
//
// Development builds: -DGN_TRACE stamps %globaltimer at each round's phases
// (probes/gn_trace.py).
//
// The C function returns cudaGetLastError() after the launch (0 = launched),
// or cudaErrorInvalidValue for arguments the kernel does not take.

#include "int8_codes.cuh"
#include "sm90.cuh"

namespace {

constexpr int COMPUTE = 256;                // threads that sum and normalise
constexpr int THREADS = COMPUTE + 32;       // + the producer warp
constexpr int VEC = 8;                      // channels per thread
constexpr int MAX_C = COMPUTE * VEC;        // 2048: one vector per thread per row
constexpr int CHUNK_BYTES = 32768;          // a chunk's (one bulk copy's, one buffer's) most bytes
constexpr int MAX_CHUNKS = 4;               // chunks a slab
constexpr int SCRATCH = 2 * MAX_C;          // floats: the lanes' sums, or partial segments
constexpr int MAX_RING = 8;
constexpr int BAR_COMPUTE = 1;              // named barrier of the compute threads
constexpr int STEP_ROWS = 4;                // the codes-out form: rows a thread codes between its unit's meetings
constexpr int BAR_UNIT = 2;                 // the codes-out form: named barriers 2.. of its multi-warp units
constexpr float NEG_LOG2E = -1.4426950408889634f;

// Division by a launch constant d >= 1 of 0 <= a < 2^31 as a multiply-high
// and a shift, the magic number made on the host (`fast_div`): the index
// arithmetic of every chunk and of the partials' sums is on the path of
// the stores and of the barrier, where an integer divide costs ~25
// instructions.
struct FastDiv {
  int d;
  unsigned mult, shift;
  __device__ __forceinline__ int div(int a) const {
    return (int)((__umulhi((unsigned)a, mult) + (unsigned)a) >> shift);
  }
  __device__ __forceinline__ int mod(int a) const { return a - div(a) * d; }
};

inline FastDiv fast_div(int d) {
  FastDiv f;
  f.d = d;
  f.shift = 0;
  while ((1ull << f.shift) < (unsigned long long)d) ++f.shift;
  f.mult = (unsigned)(((1ull << 32) * ((1ull << f.shift) - d)) / d + 1);
  return f;
}

struct Params {
  const void* x;
  const float* scale;
  const float* bias;
  void* y;           // y, or the codes (codes-out form)
  const float* absmax;  // the codes-out form: the 0-d calibrated absmax, and where s goes
  float* s_out;
  float* part;       // (B, S, 2, G) slab partials
  unsigned* bar;     // grid barrier: two arrival counts, sense
  int B, HW, C, G;
  int chunk_rows, chunks;  // rows a chunk, chunks a slab
  int slab_rows, S;        // rows a slab (chunks * chunk_rows), slabs a sample
  int per_round, rounds, ring;
  int row_bytes, buf_bytes;
  int group_vecs;    // C / G / 8 where a power of 2 up to 32, else 0
  int grid, lanes;   // blocks; rows a chunk's threads take at once (COMPUTE / (C / 8))
  int slots;         // slabs a block holds a round: (ring - 1) / chunks
  int unit_threads, units, unit_rows;  // the codes-out form's units: threads, units, rows of a chunk each
  int seg_len, segs; // the partials' sums: slabs a segment, segments a column
  // by S, grid, ring, chunk_rows, C / 8, C / G, 2 G, segs * 2 G, G
  FastDiv S_, grid_, ring_, chunk_, nvec_, cg_, cols_, per_, G_;
  float n, eps;
};

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
  u.x = sm90::pack_bf16(f[0], f[1]);
  u.y = sm90::pack_bf16(f[2], f[3]);
  u.z = sm90::pack_bf16(f[4], f[5]);
  u.w = sm90::pack_bf16(f[6], f[7]);
  *reinterpret_cast<uint4*>(p) = u;
}

__device__ __forceinline__ void store8(float* p, const float f[VEC]) {
  *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(f[4], f[5], f[6], f[7]);
}

__device__ __forceinline__ float rcp_approx(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// A wait that cannot hang the card: after WAIT_LIMIT_NS without progress
// the kernel traps, and the launch fails with an error instead.
constexpr unsigned long long WAIT_LIMIT_NS = 10000000000ull;

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

#ifdef GN_TRACE
// Development builds only (-DGN_TRACE, probes/gn_trace.py): %globaltimer
// stamps of thread 0 of every block at each round's phases.
__device__ unsigned long long* g_trace;
#define TRACE(r, k) \
  if (g_trace != nullptr && threadIdx.x == 0) g_trace[((size_t)blockIdx.x * p.rounds + (r)) * 8 + (k)] = global_ns();
#else
#define TRACE(r, k)
#endif

__device__ __forceinline__ bool mbar_try(uint64_t* bar, int parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(sm90::smem_u32(bar)), "r"(parity)
      : "memory");
  return done;
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  if (mbar_try(bar, parity)) return;
  const unsigned long long t0 = global_ns();
  while (!mbar_try(bar, parity))
    if (global_ns() - t0 > WAIT_LIMIT_NS) __trap();
}

// 1 / d for d in [1, 2^126] on the FMA pipe: a first guess from the
// exponent bits (within 5.1%), then two Newton steps (within 1e-5).
__device__ __forceinline__ float rcp_newton(float d) {
  float r = __int_as_float(0x7EF311C3 - __float_as_int(d));
  r = fmaf(r, fmaf(-d, r, 1.f), r);
  return fmaf(r, fmaf(-d, r, 1.f), r);
}

// Slabs [first, first + n) of a round; block c takes slabs c, c + grid, ...
__device__ __forceinline__ int round_first(const Params& p, int r) { return r * p.per_round * p.S; }
__device__ __forceinline__ int round_slabs(const Params& p, int r) {
  return min(p.per_round, p.B - r * p.per_round) * p.S;
}
__device__ __forceinline__ int my_slabs(const Params& p, int n, int cta) {
  return n > cta ? p.grid_.div(n - cta + p.grid - 1) : 0;
}
// A block's slabs of a round that sit in its buffers (the rest, of a
// sample larger than a round, are read from device memory).
__device__ __forceinline__ int resident(const Params& p, int r, int cta) {
  return min(my_slabs(p, round_slabs(p, r), cta), p.slots);
}
__device__ __forceinline__ int slab_rows(const Params& p, int gid) {
  return min(p.slab_rows, p.HW - p.S_.mod(gid) * p.slab_rows);
}
__device__ __forceinline__ int slab_chunks(const Params& p, int rows) { return p.chunk_.div(rows + p.chunk_rows - 1); }
// Slab gid's first row (of B * HW), and its byte offset in x.
__device__ __forceinline__ size_t slab_row(const Params& p, int gid) {
  const int b = p.S_.div(gid);
  return (size_t)b * p.HW + (size_t)(gid - b * p.S) * p.slab_rows;
}
__device__ __forceinline__ size_t slab_offset(const Params& p, int gid) { return slab_row(p, gid) * p.row_bytes; }

// The block's resident chunks in order over all rounds: (round, slot, chunk).
struct Cursor {
  int r, s, c;
};
__device__ __forceinline__ void advance(Cursor& c, const Params& p, int cta) {
  if (c.s >= 0 && ++c.c < slab_chunks(p, slab_rows(p, round_first(p, c.r) + cta + c.s * p.grid))) return;
  c.c = 0;
  ++c.s;
  while (c.r < p.rounds && c.s >= resident(p, c.r, cta)) {
    ++c.r;
    c.s = 0;
  }
}

// Producer: lane 0 of the last warp issues every bulk copy, one a chunk (the
// codes-out form stores one a unit of the chunk).
template <typename T, bool CODES>
__device__ void produce(const Params& p, unsigned char* bufs, uint64_t* full, uint64_t* ready) {
  const int cta = blockIdx.x;
  const unsigned char* x = static_cast<const unsigned char*>(p.x);
  unsigned char* y = static_cast<unsigned char*>(p.y);
  Cursor ld{0, -1, 0}, st{0, -1, 0};
  advance(ld, p, cta);
  advance(st, p, cta);
  // the chunk under a cursor: its first row (of B * HW) and its rows
  auto chunk = [&](const Cursor& c, size_t& row) {
    const int gid = round_first(p, c.r) + cta + c.s * p.grid;
    row = slab_row(p, gid) + (size_t)c.c * p.chunk_rows;
    return min(p.chunk_rows, slab_rows(p, gid) - c.c * p.chunk_rows);
  };
  auto load = [&](int b) {
    size_t row;
    const int bytes = chunk(ld, row) * p.row_bytes;
    sm90::mbar_expect_tx(&full[b], bytes);
    sm90::bulk_load(bufs + (size_t)b * p.buf_bytes, x + row * p.row_bytes, bytes, &full[b]);
    advance(ld, p, cta);
  };
  for (int b = 0; b < p.ring && ld.r < p.rounds; ++b) load(b);
  for (int b = 0, phase = 0; st.r < p.rounds;) {
    size_t row;
    const int rows = chunk(st, row);
    unsigned char* buf = bufs + (size_t)b * p.buf_bytes;
    mbar_wait(&ready[b], phase);
    if (CODES) {  // each unit's codes, at the head of its rows
      for (int u = 0, r0 = 0; u < p.units && r0 < rows; ++u, r0 += p.unit_rows)
        sm90::bulk_store(y + (row + r0) * p.C, buf + (size_t)r0 * p.row_bytes, min(p.unit_rows, rows - r0) * p.C);
    } else {
      sm90::bulk_store(y + row * p.row_bytes, buf, rows * p.row_bytes);
    }
    sm90::bulk_commit();
    sm90::bulk_wait_read<0>();
    if (ld.r < p.rounds) load(b);
    advance(st, p, cta);
    if (++b == p.ring) {
      b = 0;
      phase ^= 1;
    }
  }
  sm90::bulk_wait<0>();
}

// Adds each of this thread's 8 channels over every lanes-th of `rows` rows
// of a chunk, in row order, into s and q (sums and sums of squares).
template <typename T>
__device__ __forceinline__ void accumulate(const Params& p, const T* src, int rows, float s[VEC], float q[VEC]) {
  const int C = p.C, lanes = p.lanes, lane = p.nvec_.div(threadIdx.x), v = threadIdx.x - lane * p.nvec_.d;
  if (lane >= lanes) return;
  const T* row = src + v * VEC;
#pragma unroll 4
  for (int r = lane; r < rows; r += lanes) {
    float f[VEC];
    load8(row + (size_t)r * C, f);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      s[j] += f[j];
      q[j] = fmaf(f[j], f[j], q[j]);
    }
  }
}

// A slab's partials from each thread's sums over its chunks -> out[0, G)
// sums, out[G, 2G) sums of squares. Where a thread's 8 channels share a
// group (p.group_vecs = C/G/8 a power of 2 up to 32), it adds them in
// channel order, the group's group_vecs neighbouring threads add theirs by
// a shuffle tree (each ends with the same total), and the lanes' totals are
// added in lane order: one barrier, on the half of the scratch that `half`
// names, so that the next slab can write the other half while this one is
// read. Otherwise each channel's lanes are added in order, then each
// group's channels.
__device__ void publish(const Params& p, const float s[VEC], const float q[VEC], float* scratch, float* out,
                        int half) {
  const int tid = threadIdx.x, C = p.C, G = p.G, lanes = p.lanes, lane = p.nvec_.div(tid), v = tid - lane * p.nvec_.d;
  if (p.group_vecs > 0) {
    const int m = p.group_vecs;
    float a = 0.f, a2 = 0.f;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      a += s[j];
      a2 += q[j];
    }
    for (int o = 1; o < m; o <<= 1) {
      a += __shfl_xor_sync(0xffffffffu, a, o);
      a2 += __shfl_xor_sync(0xffffffffu, a2, o);
    }
    float* h = scratch + half * (SCRATCH / 2);
    if (lane < lanes && (v & (m - 1)) == 0) {  // m is a power of 2
      const int g = v >> (__ffs(m) - 1);
      h[lane * G + g] = a;
      h[(lanes + lane) * G + g] = a2;
    }
    sm90::bar_sync(BAR_COMPUTE, COMPUTE);
    for (int g = tid; g < G; g += COMPUTE) {
      float S = 0.f, SS = 0.f;
      for (int l = 0; l < lanes; ++l) {
        S += h[l * G + g];
        SS += h[(lanes + l) * G + g];
      }
      out[g] = S;
      out[G + g] = SS;
    }
    return;
  }
  if (lane < lanes) {
    float* ds = scratch + lane * C + v * VEC;
    float* dq = scratch + (lanes + lane) * C + v * VEC;
    *reinterpret_cast<float4*>(ds) = make_float4(s[0], s[1], s[2], s[3]);
    *reinterpret_cast<float4*>(ds + 4) = make_float4(s[4], s[5], s[6], s[7]);
    *reinterpret_cast<float4*>(dq) = make_float4(q[0], q[1], q[2], q[3]);
    *reinterpret_cast<float4*>(dq + 4) = make_float4(q[4], q[5], q[6], q[7]);
  }
  sm90::bar_sync(BAR_COMPUTE, COMPUTE);
  // each channel's total lands in lane 0's slot, which only its thread touches
  for (int c = tid; c < C; c += COMPUTE) {
    float a = 0.f, a2 = 0.f;
    for (int l = 0; l < lanes; ++l) {
      a += scratch[l * C + c];
      a2 += scratch[(lanes + l) * C + c];
    }
    scratch[c] = a;
    scratch[lanes * C + c] = a2;
  }
  sm90::bar_sync(BAR_COMPUTE, COMPUTE);
  const int cg = C / G;
  for (int g = tid; g < G; g += COMPUTE) {
    float a = 0.f, a2 = 0.f;
    for (int c = g * cg; c < (g + 1) * cg; ++c) {
      a += scratch[c];
      a2 += scratch[lanes * C + c];
    }
    out[g] = a;
    out[G + g] = a2;
  }
  sm90::bar_sync(BAR_COMPUTE, COMPUTE);
}

// The t-th distinct sample among a block's m slabs of a round (their
// samples do not decrease), and how many there are.
__device__ __forceinline__ int nth_sample(const Params& p, int first, int m, int t) {
  int last = -1, k = -1;
  for (int s = 0; s < m; ++s) {
    const int b = p.S_.div(first + blockIdx.x + s * p.grid);
    if (b != last) {
      last = b;
      if (++k == t) break;
    }
  }
  return last;
}
__device__ __forceinline__ int count_samples(const Params& p, int first, int m) {
  int last = -1, k = 0;
  for (int s = 0; s < m; ++s) {
    const int b = p.S_.div(first + blockIdx.x + s * p.grid);
    k += b != last;
    last = b;
  }
  return k;
}

// The group mean and rstd of the block's ns samples from their S slab
// partials -> table + 2 G t: [0, G) means, [G, 2G) rstds. Each of a
// sample's 2G columns is cut into segments of seg_len consecutive slabs
// (8, doubled until a sample's segments fit the scratch), each summed in
// slab order, then the segments in order: an order fixed by S and G. Each
// thread issues the loads of 4 segments at once, 8 slabs at a time.
__device__ void sample_stats(const Params& p, int first, int m, int ns, float* scratch, float* table, int r) {
  const int tid = threadIdx.x, G = p.G, cols = 2 * G, seg_len = p.seg_len, segs = p.segs, per = p.per_.d;
  const int batch = SCRATCH / per;
  for (int t0 = 0; t0 < ns; t0 += batch) {
    const int nb = min(batch, ns - t0), n = nb * per;
    for (int i0 = tid; i0 < n; i0 += 4 * COMPUTE) {
      const float* pb[4];
      int j0[4], j1[4];
      float acc[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = min(i0 + u * COMPUTE, n - 1), t = p.per_.div(i), seg = p.cols_.div(i - t * per);
        j0[u] = seg * seg_len;
        j1[u] = i0 + u * COMPUTE < n ? min(p.S, j0[u] + seg_len) : j0[u];
        pb[u] = p.part + (size_t)nth_sample(p, first, m, t0 + t) * p.S * cols + (i - t * per - seg * cols);
        acc[u] = 0.f;
      }
      for (int e0 = 0; e0 < seg_len; e0 += 8) {
        float v[4][8];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const int j = j0[u] + e0 + e;
            v[u][e] = j < j1[u] ? __ldcg(pb[u] + (size_t)j * cols) : 0.f;
          }
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
#pragma unroll
          for (int e = 0; e < 8; ++e)
            if (j0[u] + e0 + e < j1[u]) acc[u] += v[u][e];
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (i0 + u * COMPUTE < n) scratch[i0 + u * COMPUTE] = acc[u];
    }
    TRACE(r, 7);
    sm90::bar_sync(BAR_COMPUTE, COMPUTE);
    TRACE(r, 5);
    for (int i = tid; i < nb * G; i += COMPUTE) {
      const int t = p.G_.div(i), g = i - t * G;
      const float* sc = scratch + t * per;
      float S = 0.f, SS = 0.f;
#pragma unroll 8
      for (int sg = 0; sg < segs; ++sg) {
        S += sc[sg * cols + g];
        SS += sc[sg * cols + G + g];
      }
      const float mean = S / p.n;
      const float var = SS / p.n - mean * mean;
      table[(t0 + t) * cols + g] = mean;
      table[(t0 + t) * cols + G + g] = rsqrtf(var + p.eps);
    }
    sm90::bar_sync(BAR_COMPUTE, COMPUTE);
  }
}

// y = t / (1 + 2^u) with t = x a + b and u = -t log2(e) = x a2 + b2 (the
// affine folded into two FMAs) over a slab's rows, src -> dst (in place for
// a resident slab). The exp unit takes 2^u and, for even channels, the
// reciprocal; odd channels take it on the FMA pipe, so that the exp unit,
// which two ops an element would make the limit, shares the work.
__device__ __forceinline__ void silu8(float f[VEC], const float a[VEC], const float b[VEC], const float a2[VEC],
                                      const float b2[VEC]) {
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    const float t = fmaf(f[j], a[j], b[j]);
    const float d = 1.f + sm90::ex2(fmaf(f[j], a2[j], b2[j]));
    f[j] = t * (j & 1 ? rcp_newton(fminf(d, 0x1p126f)) : rcp_approx(d));
  }
}

template <typename T>
__device__ __forceinline__ void normalise(const Params& p, const T* src, T* dst, int rows, const float a[VEC],
                                          const float b[VEC], const float a2[VEC], const float b2[VEC]) {
  const int C = p.C, lanes = p.lanes, lane = p.nvec_.div(threadIdx.x), v = threadIdx.x - lane * p.nvec_.d;
  if (lane >= lanes) return;
  src += v * VEC;
  dst += v * VEC;
#pragma unroll 4
  for (int r = lane; r < rows; r += lanes) {
    float f[VEC];
    load8(src + (size_t)r * C, f);
    silu8(f, a, b, a2, b2);
    store8(dst + (size_t)r * C, f);
  }
}

// The int8 codes of 8 normalised values, packed little-endian: each value
// rounded as the one launch stores it (bf16 for bf16 x), then coded as
// int8_quantize codes it (int8_codes.cuh).
template <typename T>
__device__ __forceinline__ uint2 codes8(float f[VEC], const int8_codes::Scale& q) {
  if (sizeof(T) == 2) {  // as store8 rounds: two values a conversion
#pragma unroll
    for (int j = 0; j < VEC; j += 2) {
      const float2 h = __bfloat1622float2(__floats2bfloat162_rn(f[j], f[j + 1]));
      f[j] = h.x;
      f[j + 1] = h.y;
    }
  }
  return int8_codes::codes8(f, q);
}

// The codes of a resident chunk of `rows` rows, in its own buffer: unit u's
// rows [u R, u R + len) get their codes at the head of their own bytes (row
// j of the unit at [j C, j C + C) from its first row), over values of rows
// <= j that its threads have read; the unit's threads meet between each
// step's reads and its writes.
template <typename T>
__device__ __forceinline__ void codes_chunk(const Params& p, unsigned char* buf, int rows, const float a[VEC],
                                            const float b[VEC], const float a2[VEC], const float b2[VEC],
                                            const int8_codes::Scale& q) {
  const int ut = p.unit_threads, u = threadIdx.x / ut, w = threadIdx.x - u * ut;
  if (u >= p.units) return;  // whole warps left over from the units
  const int lane = p.nvec_.div(w), v = w - lane * p.nvec_.d, k = ut / p.nvec_.d, C = p.C;
  const int first = u * p.unit_rows, len = max(0, min(p.unit_rows, rows - first));
  unsigned char* head = buf + (size_t)first * p.row_bytes;
  const T* src = reinterpret_cast<const T*>(head) + v * VEC;
  for (int j0 = 0; j0 < len; j0 += STEP_ROWS * k) {
    uint2 c[STEP_ROWS];
#pragma unroll
    for (int i = 0; i < STEP_ROWS; ++i) {
      const int j = j0 + i * k + lane;
      if (lane < k && j < len) {
        float f[VEC];
        load8(src + (size_t)j * C, f);
        silu8(f, a, b, a2, b2);
        c[i] = codes8<T>(f, q);
      }
    }
    if (ut == 32)
      __syncwarp();
    else if (ut == COMPUTE)
      sm90::bar_sync(BAR_COMPUTE, COMPUTE);
    else
      sm90::bar_sync(BAR_UNIT + u, ut);
#pragma unroll
    for (int i = 0; i < STEP_ROWS; ++i) {
      const int j = j0 + i * k + lane;
      if (lane < k && j < len) *reinterpret_cast<uint2*>(head + (size_t)j * C + v * VEC) = c[i];
    }
  }
}

// The codes of `rows` rows read from device memory, to device memory.
template <typename T>
__device__ __forceinline__ void codes_rows(const Params& p, const T* src, unsigned char* dst, int rows,
                                           const float a[VEC], const float b[VEC], const float a2[VEC],
                                           const float b2[VEC], const int8_codes::Scale& q) {
  const int C = p.C, lanes = p.lanes, lane = p.nvec_.div(threadIdx.x), v = threadIdx.x - lane * p.nvec_.d;
  if (lane >= lanes) return;
  src += v * VEC;
  dst += v * VEC;
#pragma unroll 4
  for (int r = lane; r < rows; r += lanes) {
    float f[VEC];
    load8(src + (size_t)r * C, f);
    silu8(f, a, b, a2, b2);
    *reinterpret_cast<uint2*>(dst + (size_t)r * C) = codes8<T>(f, q);
  }
}

// A grid-wide barrier over the compute threads of every block. bar[0] and
// bar[1] count the arrivals at even and odd barriers, bar[2] is the sense;
// thread 0 keeps the sense it waits for. The last block to arrive flips the
// sense, then zeroes its barrier's count: no block adds to that count again
// before the next barrier has completed, which needs this block's next
// arrival. Every launch thus leaves the words as it found them.
__device__ __forceinline__ void grid_sync(unsigned* bar, unsigned& sense, int k) {
  sm90::bar_sync(BAR_COMPUTE, COMPUTE);  // the block's partials are written
  if (threadIdx.x == 0) {
    sense ^= 1u;
    __threadfence();
    if (atomicAdd(&bar[k & 1], 1u) == gridDim.x - 1) {
      __threadfence();
      asm volatile("st.relaxed.gpu.global.u32 [%0], %1;\n" ::"l"(bar + 2), "r"(sense) : "memory");
      asm volatile("st.relaxed.gpu.global.u32 [%0], %1;\n" ::"l"(bar + (k & 1)), "r"(0u) : "memory");
    } else {
      const unsigned long long t0 = global_ns();
      for (int polls = 1;; ++polls) {
        unsigned seen;
        asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(seen) : "l"(bar + 2) : "memory");
        if (seen == sense) break;
        if (polls % 256 == 0 && global_ns() - t0 > WAIT_LIMIT_NS) __trap();
      }
    }
    __threadfence();
  }
  sm90::bar_sync(BAR_COMPUTE, COMPUTE);
}

template <typename T, bool CODES>
__device__ void compute(const Params& p, unsigned char* bufs, uint64_t* full, uint64_t* ready, float* scratch,
                        float* table) {
  const int cta = blockIdx.x, grid = p.grid, tid = threadIdx.x, C = p.C, G = p.G;
  const int c0 = (tid - p.nvec_.div(tid) * p.nvec_.d) * VEC;  // this thread's 8 channels
  const T* x = static_cast<const T*>(p.x);
  T* y = static_cast<T*>(p.y);
  unsigned sense = 0;
  if (tid == 0) asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(sense) : "l"(p.bar + 2) : "memory");
  int8_codes::Scale q{};
  if (CODES) {
    q = int8_codes::scale_of(int8_codes::act_scale(p.absmax));
    if (cta == 0 && tid == 0) *p.s_out = q.s;
  }

  // slab s of a round (first slab `first`, res of its slabs resident, its
  // first chunk the block's kc-th resident chunk): its partials, summed
  // chunk by chunk in row order whether the chunks sit in the buffers or
  // are read from device memory
  auto sum_slab = [&](int first, int res, int kc, int s) {
    const int gid = first + cta + s * grid, rows = slab_rows(p, gid);
    float sm[VEC], sq[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) sm[j] = sq[j] = 0.f;
    for (int c = 0; c * p.chunk_rows < rows; ++c) {
      const int n = min(p.chunk_rows, rows - c * p.chunk_rows);
      if (s < res) {  // two calls, so that each reads through its own address space
        const int turn = p.ring_.div(kc + c), b = kc + c - turn * p.ring;
        mbar_wait(&full[b], turn & 1);
        accumulate<T>(p, reinterpret_cast<const T*>(bufs + (size_t)b * p.buf_bytes), n, sm, sq);
      } else {
        accumulate<T>(p, reinterpret_cast<const T*>(reinterpret_cast<const unsigned char*>(x) + slab_offset(p, gid)) +
                             (size_t)c * p.chunk_rows * C,
                      n, sm, sq);
      }
    }
    publish(p, sm, sq, scratch, p.part + (size_t)gid * 2 * G, s & 1);
    return slab_chunks(p, rows);
  };
  int k = 0;  // resident chunks taken in earlier rounds
  for (int r = 0; r < p.rounds; ++r) {
    const int first = round_first(p, r), m = my_slabs(p, round_slabs(p, r), cta);
    const int res = min(m, p.slots);
    TRACE(r, 0);
    for (int s = 0, kc = k; s < m; ++s) kc += sum_slab(first, res, kc, s) * (s < res);
    TRACE(r, 1);
    grid_sync(p.bar, sense, r);
    TRACE(r, 2);
    // the statistics of the samples this block holds (at most ring - 1)
    sample_stats(p, first, m, count_samples(p, first, m), scratch, table, r);
    TRACE(r, 3);
    int last = -1, t = -1, kc = k;
    float a[VEC], b[VEC], a2[VEC], b2[VEC];
    for (int s = 0; s < m; ++s) {
      const int gid = first + cta + s * grid, rows = slab_rows(p, gid);
      if (p.S_.div(gid) != last) {
        last = p.S_.div(gid);
        ++t;
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const int g = p.cg_.div(c0 + j);
          a[j] = table[t * 2 * G + G + g] * __ldg(p.scale + c0 + j);
          b[j] = fmaf(-table[t * 2 * G + g], a[j], __ldg(p.bias + c0 + j));
          a2[j] = a[j] * NEG_LOG2E;
          b2[j] = b[j] * NEG_LOG2E;
        }
      }
      if (s < res) {
        for (int c = 0; c * p.chunk_rows < rows; ++c, ++kc) {
          const int slot = p.ring_.mod(kc);
          unsigned char* buf = bufs + (size_t)slot * p.buf_bytes;
          const int n = min(p.chunk_rows, rows - c * p.chunk_rows);
          if (CODES)
            codes_chunk<T>(p, buf, n, a, b, a2, b2, q);
          else
            normalise<T>(p, reinterpret_cast<const T*>(buf), reinterpret_cast<T*>(buf), n, a, b, a2, b2);
          sm90::fence_proxy_async();  // this thread's writes, before the producer's bulk store reads them
          __syncwarp();
          if (tid % 32 == 0) sm90::mbar_arrive(&ready[slot]);  // one arrival a warp
        }
        if (s == 0) TRACE(r, 6);
      } else {
        const T* src = reinterpret_cast<const T*>(reinterpret_cast<const unsigned char*>(x) + slab_offset(p, gid));
        unsigned char* dst = reinterpret_cast<unsigned char*>(y) + slab_row(p, gid) * (CODES ? p.C : p.row_bytes);
        if (CODES)
          codes_rows<T>(p, src, dst, rows, a, b, a2, b2, q);
        else
          normalise<T>(p, src, reinterpret_cast<T*>(dst), rows, a, b, a2, b2);
      }
    }
    k = kc;
    TRACE(r, 4);
  }
}

__host__ __device__ constexpr size_t align_up(size_t v, size_t a) { return (v + a - 1) / a * a; }

// The samples' statistics table: a block holds the slabs of at most `slots`
// samples a round (one, where a round is a single sample).
__host__ __device__ inline size_t table_bytes(int slots, int G) { return align_up((size_t)slots * 2 * G * 4, 8); }

// Shared memory: ring buffers, scratch, the samples' statistics, barriers.
inline size_t smem_bytes(int ring, int chunks, int buf_bytes, int G) {
  return (size_t)ring * buf_bytes + SCRATCH * 4 + table_bytes((ring - 1) / chunks, G) + 2 * ring * 8;
}

template <typename T, bool CODES>
__global__ void __launch_bounds__(THREADS, 1) gn_silu_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* bufs = smem;
  float* scratch = reinterpret_cast<float*>(smem + (size_t)p.ring * p.buf_bytes);
  float* table = scratch + SCRATCH;
  uint64_t* full = reinterpret_cast<uint64_t*>(reinterpret_cast<unsigned char*>(table) + table_bytes(p.slots, p.G));
  uint64_t* ready = full + p.ring;
  if (threadIdx.x == 0) {
    for (int b = 0; b < p.ring; ++b) {
      sm90::mbar_init(&full[b], 1);
      sm90::mbar_init(&ready[b], COMPUTE / 32);
    }
    sm90::mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x >= COMPUTE) {
    if (threadIdx.x == COMPUTE) produce<T, CODES>(p, bufs, full, ready);
    return;
  }
  compute<T, CODES>(p, bufs, full, ready, scratch, table);
}

// A call's rounds, grid and ring on `sms` SMs (0: every SM of the device),
// for the slab cut given: the ring as deep as the block's shared memory
// allows, as many whole samples a round as sms * slots slabs hold (at least
// one: the slabs of a larger sample past that are read from device memory),
// the rounds balanced, and no more blocks than a round has slabs. The least
// ring, chunks + 1 buffers of at most CHUNK_BYTES, and a table of one sample
// take at most 5 * 32 KB + 16 KB + 16 KB + 80 B = 192 KB, inside the 227 KB
// a Hopper block may have, so every slab cut the caller may pass has a plan.
struct Plan {
  int ring, per_round, rounds, grid;
  size_t smem;
};

int make_plan(int B, int HW, int C, int G, int chunk_rows, int chunks, int elt, int sms, Plan& pl) {
  if (B <= 0 || HW <= 0 || C <= 0 || C % VEC || C > MAX_C || G <= 0 || C % G || chunk_rows <= 0 ||
      chunk_rows > CHUNK_BYTES / (C * elt) || chunks < 1 || chunks > MAX_CHUNKS || sms < 0)
    return (int)cudaErrorInvalidValue;
  int dev = 0, optin = 0, dev_sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&dev_sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  if (sms == 0) sms = dev_sms;
  if (sms > dev_sms) return (int)cudaErrorInvalidValue;
  const int buf_bytes = (int)align_up((size_t)chunk_rows * C * elt, 128);
  const int S = (HW + chunks * chunk_rows - 1) / (chunks * chunk_rows);
  pl.ring = 0;
  for (int r = MAX_RING; r > chunks && pl.ring == 0; --r)
    if (smem_bytes(r, chunks, buf_bytes, G) <= (size_t)optin) pl.ring = r;
  if (pl.ring == 0) return (int)cudaErrorInvalidValue;
  pl.smem = smem_bytes(pl.ring, chunks, buf_bytes, G);
  const int slots = (pl.ring - 1) / chunks;
  const int most = max(1, (int)((long long)sms * slots / S));
  pl.rounds = (B + most - 1) / most;
  pl.per_round = (B + pl.rounds - 1) / pl.rounds;
  pl.grid = (int)min((long long)sms, (long long)pl.per_round * S);
  return 0;
}

template <typename T, bool CODES>
int launch(const Params& p, size_t smem, cudaStream_t stream) {
  int occ = 0;
  cudaError_t e =
      cudaFuncSetAttribute(gn_silu_kernel<T, CODES>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, gn_silu_kernel<T, CODES>, THREADS, smem);
  if (e != cudaSuccess) return (int)e;
  if (occ < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.grid);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, gn_silu_kernel<T, CODES>, p);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The split form: one block of COMPUTE threads a slab, grid (S, B).
template <typename T>
__global__ void __launch_bounds__(COMPUTE) gn_stats_kernel(const Params p, const float* shift) {
  __shared__ __align__(16) float scratch[SCRATCH];
  const int b = blockIdx.y, gid = b * p.S + blockIdx.x, rows = slab_rows(p, gid);
  const int lanes = p.lanes, lane = p.nvec_.div(threadIdx.x), v = threadIdx.x - lane * p.nvec_.d;
  const T* src = reinterpret_cast<const T*>(static_cast<const unsigned char*>(p.x) + slab_offset(p, gid)) + v * VEC;
  float sm[VEC], sq[VEC], sh[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    sm[j] = sq[j] = 0.f;
    sh[j] = shift != nullptr ? shift[(size_t)b * p.G + p.cg_.div(v * VEC + j)] : 0.f;
  }
  // `accumulate`'s order: chunk by chunk, each thread every lanes-th row of a chunk in row order
  for (int c = 0; lane < lanes && c * p.chunk_rows < rows; ++c) {
    const T* chunk = src + (size_t)c * p.chunk_rows * p.C;
    const int n = min(p.chunk_rows, rows - c * p.chunk_rows);
#pragma unroll 4
    for (int r = lane; r < n; r += lanes) {
      float f[VEC];
      load8(chunk + (size_t)r * p.C, f);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float d = f[j] - sh[j];
        sm[j] += d;
        sq[j] = fmaf(d, d, sq[j]);
      }
    }
  }
  publish(p, sm, sq, scratch, p.part + (size_t)gid * 2 * p.G, 0);
}

template <typename T>
__global__ void __launch_bounds__(COMPUTE) gn_apply_kernel(const Params p, const float* tot, const float* shift) {
  const int b = blockIdx.y, gid = b * p.S + blockIdx.x, G = p.G;
  const int c0 = (threadIdx.x - p.nvec_.div(threadIdx.x) * p.nvec_.d) * VEC;  // this thread's 8 channels
  const float* t = tot + (size_t)b * 2 * G;
  float a[VEC], bb[VEC], a2[VEC], b2[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    const int g = p.cg_.div(c0 + j);
    const float m = t[g] / p.n;  // the mean of x - shift
    const float var = t[G + g] / p.n - m * m;
    const float mean = shift != nullptr ? shift[(size_t)b * G + g] + m : m;
    a[j] = rsqrtf(var + p.eps) * __ldg(p.scale + c0 + j);
    bb[j] = fmaf(-mean, a[j], __ldg(p.bias + c0 + j));
    a2[j] = a[j] * NEG_LOG2E;
    b2[j] = bb[j] * NEG_LOG2E;
  }
  const size_t off = slab_offset(p, gid);
  normalise<T>(p, reinterpret_cast<const T*>(static_cast<const unsigned char*>(p.x) + off),
               reinterpret_cast<T*>(static_cast<unsigned char*>(p.y) + off), slab_rows(p, gid), a, bb, a2, b2);
}

// The fields of Params the split form reads, for the slab cut given; 0 or
// cudaErrorInvalidValue for arguments the kernels do not take.
int split_params(Params& p, int B, int HW, int C, int G, int chunk_rows, int chunks, int elt) {
  if (B <= 0 || B > 65535 || HW <= 0 || C <= 0 || C % VEC || C > MAX_C || G <= 0 || C % G || chunk_rows <= 0 ||
      chunk_rows > CHUNK_BYTES / (C * elt) || chunks < 1 || chunks > MAX_CHUNKS)
    return (int)cudaErrorInvalidValue;
  p = Params{};
  p.B = B;
  p.HW = HW;
  p.C = C;
  p.G = G;
  p.chunk_rows = chunk_rows;
  p.chunks = chunks;
  p.slab_rows = chunks * chunk_rows;
  p.S = (HW + p.slab_rows - 1) / p.slab_rows;
  p.row_bytes = C * elt;
  const int m = C / G % VEC ? 0 : C / G / VEC;
  p.group_vecs = m > 0 && m <= 32 && (m & (m - 1)) == 0 ? m : 0;
  p.lanes = COMPUTE / (C / VEC);
  p.S_ = fast_div(p.S);
  p.nvec_ = fast_div(C / VEC);
  p.cg_ = fast_div(C / G);
  return 0;
}

// The one launch's Params and shared memory for a call (make_plan's plan):
// x of `elt` bytes an element.
int one_launch_params(Params& p, size_t& smem, const void* x, const float* scale, const float* bias, void* y,
                      float* part, unsigned* bar, int B, int HW, int C, int G, int chunk_rows, int chunks, int sms,
                      float eps, int elt) {
  Plan pl;
  const int rc = make_plan(B, HW, C, G, chunk_rows, chunks, elt, sms, pl);
  if (rc != 0) return rc;
  const int slab = chunks * chunk_rows, S = (HW + slab - 1) / slab;
  p = Params{};
  p.x = x;
  p.scale = scale;
  p.bias = bias;
  p.y = y;
  p.part = part;
  p.bar = bar;
  p.B = B;
  p.HW = HW;
  p.C = C;
  p.G = G;
  p.chunk_rows = chunk_rows;
  p.chunks = chunks;
  p.slab_rows = slab;
  p.S = S;
  p.per_round = pl.per_round;
  p.rounds = pl.rounds;
  p.ring = pl.ring;
  p.row_bytes = C * elt;
  p.buf_bytes = (int)align_up((size_t)chunk_rows * C * elt, 128);
  const int m = C / G % VEC ? 0 : C / G / VEC;
  p.group_vecs = m > 0 && m <= 32 && (m & (m - 1)) == 0 ? m : 0;
  p.grid = pl.grid;
  p.lanes = COMPUTE / (C / VEC);
  p.slots = (pl.ring - 1) / chunks;
  // the partials' segments: 8 slabs, doubled until a sample's fit the scratch
  p.seg_len = 8;
  while ((S + p.seg_len - 1) / p.seg_len * 2 * G > SCRATCH) p.seg_len *= 2;
  p.segs = (S + p.seg_len - 1) / p.seg_len;
  p.S_ = fast_div(S);
  p.grid_ = fast_div(pl.grid);
  p.ring_ = fast_div(pl.ring);
  p.chunk_ = fast_div(chunk_rows);
  p.nvec_ = fast_div(C / VEC);
  p.cg_ = fast_div(C / G);
  p.cols_ = fast_div(2 * G);
  p.per_ = fast_div(p.segs * 2 * G);
  p.G_ = fast_div(G);
  p.n = (float)HW * (float)(C / G);
  p.eps = eps;
  smem = pl.smem;
  return 0;
}

}  // namespace

extern "C" {

// The split form's statistics: x (B, HW, C) bf16 (is_bf16 = 1) or fp32 ->
// part (B, S, 2, G) fp32 slab partials of x - shift (shift (B, G) fp32, or
// null for none), for the caller's slab cut.
int groupnorm_silu_stats(const void* x, const float* shift, float* part, int B, int HW, int C, int G,
                         int chunk_rows, int chunks, int is_bf16, cudaStream_t stream) {
  Params p;
  const int rc = split_params(p, B, HW, C, G, chunk_rows, chunks, is_bf16 ? 2 : 4);
  if (rc != 0) return rc;
  p.x = x;
  p.part = part;
  const dim3 grid(p.S, B);
  if (is_bf16)
    gn_stats_kernel<__nv_bfloat16><<<grid, COMPUTE, 0, stream>>>(p, shift);
  else
    gn_stats_kernel<float><<<grid, COMPUTE, 0, stream>>>(p, shift);
  return (int)cudaGetLastError();
}

// The split form's normalisation: y = silu((x - mean) * rstd * scale + bias)
// with mean and rstd from tot (B, 2, G) fp32, the sums and sums of squares
// of x - shift over n elements a group (shift (B, G) fp32, or null for
// none); x, y (B, HW, C) bf16 or fp32, scale and bias (C,) fp32.
int groupnorm_silu_apply(const void* x, const float* tot, const float* shift, const float* scale,
                         const float* bias, void* y, int B, int HW, int C, int G, int chunk_rows, int chunks,
                         float n, float eps, int is_bf16, cudaStream_t stream) {
  Params p;
  const int rc = split_params(p, B, HW, C, G, chunk_rows, chunks, is_bf16 ? 2 : 4);
  if (rc != 0) return rc;
  if (!(n > 0.f)) return (int)cudaErrorInvalidValue;
  p.x = x;
  p.y = y;
  p.scale = scale;
  p.bias = bias;
  p.n = n;
  p.eps = eps;
  const dim3 grid(p.S, B);
  if (is_bf16)
    gn_apply_kernel<__nv_bfloat16><<<grid, COMPUTE, 0, stream>>>(p, tot, shift);
  else
    gn_apply_kernel<float><<<grid, COMPUTE, 0, stream>>>(p, tot, shift);
  return (int)cudaGetLastError();
}

// The plan of a call (see make_plan) -> out: ring, samples a round, rounds,
// grid, shared memory bytes. Returns 0, or cudaErrorInvalidValue for
// arguments the kernel does not take.
int groupnorm_silu_plan(int B, int HW, int C, int G, int chunk_rows, int chunks, int is_bf16, int sms, int* out) {
  Plan pl;
  const int rc = make_plan(B, HW, C, G, chunk_rows, chunks, is_bf16 ? 2 : 4, sms, pl);
  if (rc != 0) return rc;
  out[0] = pl.ring;
  out[1] = pl.per_round;
  out[2] = pl.rounds;
  out[3] = pl.grid;
  out[4] = (int)pl.smem;
  return 0;
}

// x, y (B, HW, C) bf16 (is_bf16 = 1) or fp32; scale, bias (C,) fp32; part
// (B, S, 2, G) fp32 slab partials; bar 4 zeroed words kept between calls.
// The slab cut (chunk_rows rows a chunk, chunks a slab) is the caller's
// (ops/groupnorm.py `slab_cut`, which the plain version shares); the rounds,
// grid and ring are make_plan's on `sms` SMs (0: all).
int groupnorm_silu(const void* x, const float* scale, const float* bias, void* y, float* part, unsigned* bar, int B,
                   int HW, int C, int G, int chunk_rows, int chunks, int sms, float eps, int is_bf16,
                   cudaStream_t stream) {
  Params p;
  size_t smem;
  const int rc = one_launch_params(p, smem, x, scale, bias, y, part, bar, B, HW, C, G, chunk_rows, chunks, sms, eps,
                                   is_bf16 ? 2 : 4);
  if (rc != 0) return rc;
  return is_bf16 ? launch<__nv_bfloat16, false>(p, smem, stream) : launch<float, false>(p, smem, stream);
}

// The codes-out form: as groupnorm_silu, but xq (B, HW, C) int8 gets the
// codes of y against the 0-d fp32 *absmax, clamp(rint(y / s), -127, 127)
// with s = max(*absmax, 1e-12) / 127, y rounded to x's dtype first; *s_out
// = s. C % 16 == 0.
int groupnorm_silu_int8(const void* x, const float* scale, const float* bias, const float* absmax, void* xq,
                        float* s_out, float* part, unsigned* bar, int B, int HW, int C, int G, int chunk_rows,
                        int chunks, int sms, float eps, int is_bf16, cudaStream_t stream) {
  if (C % 16 || absmax == nullptr || s_out == nullptr) return (int)cudaErrorInvalidValue;
  Params p;
  size_t smem;
  const int rc = one_launch_params(p, smem, x, scale, bias, xq, part, bar, B, HW, C, G, chunk_rows, chunks, sms, eps,
                                   is_bf16 ? 2 : 4);
  if (rc != 0) return rc;
  // units: a warp (C / 8 divides 32), a row's threads (32 divides C / 8), or every compute thread
  const int nvec = C / VEC;
  p.unit_threads = 32 % nvec == 0 ? 32 : nvec % 32 == 0 ? nvec : COMPUTE;
  p.units = COMPUTE / p.unit_threads;
  p.unit_rows = (chunk_rows + p.units - 1) / p.units;
  p.absmax = absmax;
  p.s_out = s_out;
  return is_bf16 ? launch<__nv_bfloat16, true>(p, smem, stream) : launch<float, true>(p, smem, stream);
}

#ifdef GN_TRACE
int groupnorm_silu_set_trace(void* trace) { return (int)cudaMemcpyToSymbol(g_trace, &trace, sizeof(trace)); }
#endif

}  // extern "C"
