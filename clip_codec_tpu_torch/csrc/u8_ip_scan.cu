// Inner products of fp32 queries with uint8 code rows, for Hopper (sm_90a):
//
//     s[q, i] = (sum_d qs[q, d] * codes[i, d] + qz[q]) * inv[i]
//
// the score of the uint8-resident retrieval indexes: with x_i = scale * u_i +
// zero and x^_i = x_i / |x_i|, q . x^_i = ((q * scale) . u_i + q . zero) / |x_i|,
// so the (N, D) matrix stays uint8 in device memory and only the (Q, D) query
// work is fp32. Two entry points share one kernel:
//
//   u8_ip_scores: codes (N, D), inv (N)           -> s (Q, N)
//   u8_ip_probe:  lists (nlist, cap, D), list_inv (nlist, cap), probe (Q, nprobe)
//                 -> s (Q, nprobe, cap), query q against the lists it probes,
//                 read where they lie (no gather into a new tensor)
//
// Counterparts of XLA programs, not of Pallas kernels: the JAX package's
// _u8_search_jit (clip_codec_tpu/index/search.py:97) and _ivf_u8_search's
// einsum (clip_codec_tpu/index/ivf.py:117), where XLA fuses the u8 -> f32
// convert into the dot. PyTorch has no product of uint8 and fp32 operands, so
// `codes.float() @ qs.T` would write and read back an (N, D) fp32 copy on
// every search: four times the bytes of the codes, the index's reason to exist.
//
// Products on the tensor cores, exactly. Every code byte is exact in bf16, and
// the fp32 query splits into three bf16 parts, qs = h + m + l, each the bf16
// rounding of what the parts before it leave (residuals taken in fp32, which
// is exact): h keeps 8 significant bits, the residual qs - h is a multiple of
// qs's fp32 ulp below half of h's bf16 ulp, m keeps 8 more, and what is left,
// at most 2^7 fp32 ulps, is exact in l. So h + m + l == qs for every |qs| in
// [2^-103, 2^127) and for zero (every part a normal bf16 or zero), and each
// code x part product is exact in fp32. The products are wgmma m64nNk16 bf16 -> fp32 with
// A = 64 code rows converted in registers (rs) and B = h, m and l of up to
// 8, 16 or 32 query columns side by side (N = 3 x that), each part in its own
// accumulator columns. The tensor cores accumulate in fp32 with truncation,
// so a long chain of products into one accumulator drifts toward zero, past
// the 1e-5 the scores are held to at D in the hundreds; here a chain is one
// 64-byte chunk, 4 k steps, from zero: then partial = (h + m) + l and total
// += partial, both rounded to nearest. Against a float64 reference the
// scores err no more than the plain version's cuBLAS fp32 product
// (tests/test_torch_cuda.py, D = 512 and 2048).
//
// What bounds it on an H100: a code byte feeds 3 x 2 flops per query on the
// tensor cores (989 TFLOP/s) against 1 byte of device memory (3.35 TB/s), so
// a search is bytes-bound up to Q ~ 50 and nearly balanced at Q = 64 (scores
// written in fp32 count too: (64, 1M, 512) needs 0.230 ms of bytes and 0.199
// of products). The design:
//
//   * A persistent grid of min(work items, SMs) blocks, each one producer
//     warpgroup and two consumer warpgroups (setmaxnreg 72 / 216). A work item
//     is a tile of 512, 256 or 128 code rows (tile_rows; of one list in the
//     probe) against a group of up to 64 columns (queries, or the probe's
//     (query, slot) pairs); its D runs as ceil(D / 64) chunks of 64 bytes.
//   * Two rings. Code stages (4 of 32 KB) hold a tile's rows for one chunk
//     (512 rows), two (256) or four (128), one TMA box of a uint8 tensor map
//     (D, rows, lists) a stage (two of 256 rows at 512; rows past a list and
//     columns past D arrive as zero), where D % 16 == 0, else the producer's
//     own loads. A consumer copies its code bytes to registers and releases
//     the stage at once, so loads run while the products do. Part stages (3
//     of 25 KB) hold h, m, l of 64 / width chunks, which the producer's 128
//     threads split from qs (zero past D; no pre-pass), and a header naming
//     the group's columns, rows and output places. Each code byte leaves
//     device memory once per search (per probed list in the probe; a tile's
//     later groups, Q > 64, read it again from L2).
//   * Each consumer warpgroup takes the tile's slabs 2 i + wg of 64 rows. A
//     thread reads its 16 bytes of each of its two rows per slab and chunk
//     with one 16-byte load and turns 4 of them into a k step's A fragment (a
//     byte permute into 2^23 + u, one exact subtract, a bf16x2 pack). The k
//     order is permuted to fit: byte 16 t + 4 j + e of a chunk (thread t =
//     lane % 4) is k index 16 j + {2t, 2t + 1, 2t + 8, 2t + 9}[e] of k step
//     j, and the producer writes B's 128-byte-swizzled rows in the same
//     order. At width <= 16 a code stage's 4 slab-chunks run as one batch of
//     16 products with one wait; at 32 and 64, one slab and chunk (and column
//     group) at a time, the totals taking the registers. No product is in
//     flight across a branch.
//   * The probe groups pairs by list in the kernel, with no host sync. Where
//     the probe names more than 128 ids, the items are
//     the lists' tiles: at its start each block counts, from every probe id,
//     the pairs of the lists it owns (a shared-memory table maps a list to
//     its bucket) and scatters them into buckets by shared-memory atomics
//     (their order within a list changes no score: a column is scored alone);
//     a list past the buckets' room is read by ordered passes. With at most
//     128 ids (one a producer thread: each ordered scan is one round of
//     loads), the items are the probed pairs' list tiles, each kept by the
//     first pair that names its list, whose pairs an ordered pass finds: the
//     blocks then share out only probed lists (a round robin over every
//     list's tile put two probed tiles on one block at Q = 1; with 316 ids
//     the two scans an item cost more than the buckets). Either way a
//     list no query probes costs no code byte, each probed list is read
//     once, and a list that one query's row names twice gets both pairs.
//     Each pair's scores go to out[q, slot, :].
//   * The epilogue is (total + qz[q]) * inv[i], stored from registers (a
//     warp's store covers 8 consecutive rows of 4 columns); inv and qz are
//     loaded at the group's start, and the next tile's loads run meanwhile.
//
// A row's sum runs in one order wherever the row lies: the same chunks, k
// steps and products, partials and adds, at every width, tile and slab and
// in both entry points (the tensor cores compute each output element from
// its own row and column alone: tests/test_torch_cuda.py checks a query's
// scores alone and in batches of 20 and 200 bit-equal). Two identical rows
// therefore get bit-identical scores, and ties stay ties for the ranking.

#include <algorithm>

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int kSlabs = 4;                        // 64-row slabs a consumer warpgroup, at most
constexpr int kMaxTileRows = 2 * kSlabs * 64;    // 512
constexpr int kChunk = 64;                       // code bytes (k values) a row a stage
constexpr int kBoxRows = 256;                    // TMA box rows, the limit
constexpr int kCodeStages = 4;                   // the code ring: a stage is 512 x 64 code bytes
constexpr int kPartStages = 3;                   // the query-part ring: a stage is h, m, l and a header
constexpr int kMaxCols = 64;                     // widest group
constexpr int kCodeBytes = kMaxTileRows * kChunk;  // 32 KB
constexpr int kPartBytes = kMaxCols * 128;       // a part of 64 columns: 64 rows x 64 bf16, 128-byte swizzled
constexpr int kHeaderBytes = 1024;
constexpr int kPartStageBytes = 3 * kPartBytes + kHeaderBytes;
constexpr int kBuckets = 256;                    // probe: a block's items bucketed a window at a time
constexpr int kPairBuf = 2048;                   // probe: pairs the buckets hold at once
constexpr int kPairCap = 256;                    // probe: pairs an ordered pass collects (a list past kPairBuf)
constexpr int kScanIds = 8;                      // probe ids a thread reads a round of an ordered pass
constexpr int kLoadIds = 16;                     // probe ids a thread reads a round of a bucket pass
constexpr int kOwnerLists = 4096;                // probe: lists whose window-0 bucket a table holds
constexpr int kThreads = 3 * WARPGROUP;

struct alignas(16) ProbeShared {
  short owner[kOwnerLists];  // window 0: the bucket of list L, or -1 (lists past kOwnerLists: bucket_of)
  int cnt[kBuckets];   // pairs of each bucket (the first item of each list in the window)
  int off[kBuckets];   // where a bucket's pairs start in `pairs`
  int fill[kBuckets];  // pairs scattered into a bucket so far
  int pairs[kPairBuf];
  int counts[2 * kScanIds * 4];  // an ordered pass's per-warp match counts, two rounds
  int ready;           // window 0 counted (1) and scattered whole (2) by every thread at the start
  int named;           // slot items: an earlier pair names the item's list
};
constexpr int kSmem = 1024 + kCodeStages * kCodeBytes + kPartStages * kPartStageBytes + (int)sizeof(ProbeShared) +
                      16 * (kCodeStages + kPartStages);
static_assert(kSmem <= 232448, "shared memory");

struct Header {
  int end;           // 1: no more work
  int ncols;         // columns of the group
  int width;         // the group's width: 8, 16, 32 or 64 columns
  int nrows;         // valid rows of the tile
  long long obase;   // out index of the tile's row 0 in a column's output row
  long long ibase;   // inv index of the tile's row 0
  int col[kMaxCols]; // output row of each column: its query (scores) or pair (probe)
  int qi[kMaxCols];  // query of each column
};
static_assert(sizeof(Header) <= kHeaderBytes, "header");

struct Params {
  const uint8_t* codes;  // (lists, rows, D)
  const float* inv;      // (lists, rows)
  const float* qs;       // (Q, D)
  const float* qz;       // (Q,)
  const int* probe;      // (Q, nprobe), probe form only
  float* out;            // (Q, N) or (Q * nprobe, cap)
  long long ostride;     // N or cap
  int D, Q, nprobe, rows, lists;  // rows: N or cap; lists: 1 or nlist
  int kc;                // chunks, ceil(D / 64)
  int trows;             // rows of a tile: 128, 256 or 512
  int tiles;             // row tiles a list
  int qgroups;           // scores: ceil(Q / 64); probe: 1
  int items;             // lists * tiles * qgroups, or Q * nprobe * tiles (slot items)
  int slot_items;        // probe: an item is a pair's list tile (Q * nprobe <= 128), else a list's tile
  int tma;               // codes by TMA (D % 16 == 0) or by the producer's loads
  int qs_vec;            // qs read as float4 (D % 4 == 0, 16-byte aligned)
};

// The two rings in shared memory: the n-th code or part stage at n % stages.
struct Rings {
  unsigned char* codes;  // [kCodeStages][512 rows x 64 bytes]
  unsigned char* parts;  // [kPartStages][h | m | l | header]
  uint64_t *cfull, *cempty, *pfull, *pempty;
  __device__ unsigned char* code(int n) const { return codes + n % kCodeStages * kCodeBytes; }
  __device__ unsigned char* part(int n) const { return parts + n % kPartStages * kPartStageBytes; }
};

__device__ __forceinline__ Header* header(unsigned char* part_stage) {
  return reinterpret_cast<Header*>(part_stage + 3 * kPartBytes);
}

__device__ __forceinline__ uint32_t word_of(const uint4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// Byte b of w as a float (2^23 + b by a byte permute, then one exact subtract).
__device__ __forceinline__ float byte_to_float(uint32_t w, uint32_t b) {
  return __fsub_rn(__uint_as_float(__byte_perm(w, 0x4B000000u, 0x7540u | b)), 8388608.0f);
}

// x0, x1 as three bf16x2 parts (low half x0): h + m + l == x exactly (see the header).
__device__ __forceinline__ void split3(float x0, float x1, uint32_t& h, uint32_t& m, uint32_t& l) {
  h = pack_bf16(x0, x1);
  const float r0 = __fsub_rn(x0, __uint_as_float(h << 16)), r1 = __fsub_rn(x1, __uint_as_float(h & 0xFFFF0000u));
  m = pack_bf16(r0, r1);
  l = pack_bf16(__fsub_rn(r0, __uint_as_float(m << 16)), __fsub_rn(r1, __uint_as_float(m & 0xFFFF0000u)));
}

// ------------------------------------------------------------------ producer

// Rows [row0, row0 + nrows) of list `list`, bytes [k0, k0 + 64 chunks) of
// each, into a code stage as the TMA box lays them out (64 chunks bytes a
// row, rows one after another) by the producer's loads (D % 16 != 0: no
// TMA). Bytes past D are zero; rows past nrows are left as they are (their
// scores are never stored, and any byte times a zero query column adds zero).
__device__ void copy_codes(const Params& p, unsigned char* dst, int list, int row0, int nrows, int k0, int chunks,
                           int t) {
  const uint8_t* src = p.codes + ((long long)list * p.rows + row0) * p.D;
  const int segs = 4 * chunks, pitch = kMaxTileRows / p.trows * kChunk;
  for (int seg = t; seg < nrows * segs; seg += WARPGROUP) {
    const int r = seg / segs, d0 = k0 + 16 * (seg % segs);
    const uint8_t* row = src + (long long)r * p.D;
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int d = d0 + 4 * i;
      if ((p.D & 3) == 0) {
        w[i] = d < p.D ? __ldg(reinterpret_cast<const unsigned int*>(row + d)) : 0u;
      } else {
        w[i] = 0;
        for (int b = 0; b < 4; ++b)
          if (d + b < p.D) w[i] |= (uint32_t)__ldg(row + d + b) << (8 * b);
      }
    }
    *reinterpret_cast<uint4*>(dst + r * pitch + 16 * (seg % segs)) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// The three parts of the group's queries, zero past ncols and past D, for
// the chunks c0 .. c0 + 64 / width - 1 (those before kc): a part stage holds
// 64 / width slots of 3 width 128 bytes, one a chunk. In a slot, columns go
// in groups of 8, 16 (width 8, 16) or 32: group cg is one B tile of 3 x 8,
// 16 or 32 rows, h, m and l, so that one wgmma takes all three parts of its
// columns. Rows are 128 bytes in the permuted k order: column n's 16-byte
// chunk 2 j + hf holds, as bf16 pairs, qs[n][64 c + 16 w + 4 j + 2 hf + {0,
// 1}] for w = 0..3, at chunk (2 j + hf) ^ (n % 8). A stage is 256 tasks (slot,
// n, j), two a producer thread: load_parts reads their qs values,
// store_parts splits and stores them.
constexpr int kPartTasks = 2;  // tasks a producer thread takes

template <typename QOf>
__device__ __forceinline__ void load_parts(const Params& p, int width, int ncols, QOf q_of, int c0, int t,
                                           float (&v)[kPartTasks][16]) {
#pragma unroll
  for (int s = 0; s < kPartTasks; ++s) {
    const int task = t + s * WARPGROUP, slot = task / (4 * width), n = task / 4 % width, j = task & 3;
    if (n < ncols && c0 + slot < p.kc) {
      const float* row = p.qs + (long long)q_of(n) * p.D;
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const int d = (c0 + slot) * kChunk + 16 * w + 4 * j;
        if (p.qs_vec) {
          const float4 f = d < p.D ? __ldg(reinterpret_cast<const float4*>(row + d)) : make_float4(0.f, 0.f, 0.f, 0.f);
          v[s][4 * w] = f.x, v[s][4 * w + 1] = f.y, v[s][4 * w + 2] = f.z, v[s][4 * w + 3] = f.w;
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) v[s][4 * w + e] = d + e < p.D ? __ldg(row + d + e) : 0.0f;
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < 16; ++i) v[s][i] = 0.0f;
    }
  }
}

__device__ __forceinline__ void store_parts(unsigned char* parts, int width, int t, const float (&v)[kPartTasks][16]) {
  const int ncg = width <= 16 ? width : 32;
#pragma unroll
  for (int s = 0; s < kPartTasks; ++s) {
    const int task = t + s * WARPGROUP, slot = task / (4 * width), n = task / 4 % width, j = task & 3;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      uint32_t h[4], m[4], l[4];
#pragma unroll
      for (int w = 0; w < 4; ++w) split3(v[s][4 * w + 2 * hf], v[s][4 * w + 2 * hf + 1], h[w], m[w], l[w]);
      const int off = slot * 3 * width * 128 + (n / ncg * 3 * ncg + n % ncg) * 128 + (((2 * j + hf) ^ (n & 7)) << 4);
      *reinterpret_cast<uint4*>(parts + off) = make_uint4(h[0], h[1], h[2], h[3]);
      *reinterpret_cast<uint4*>(parts + off + ncg * 128) = make_uint4(m[0], m[1], m[2], m[3]);
      *reinterpret_cast<uint4*>(parts + off + 2 * ncg * 128) = make_uint4(l[0], l[1], l[2], l[3]);
    }
  }
}

// The probe's work items are the lists' row tiles, item = list * tiles +
// tile; block b takes items b + k G (G blocks), k < its item count. The
// bucket of probe id L in the window [k0, k1) of those k: the first k there
// whose item holds rows of list L, or -1.
__device__ __forceinline__ int bucket_of(const Params& p, int L, int k0, int k1) {
  if (L < 0 || L >= p.lists) return -1;
  const int G = gridDim.x, b = blockIdx.x;
  const int lo = max(L * p.tiles, b + k0 * G);
  const int it = lo + ((b - lo) % G + G) % G;  // the first item >= lo that is this block's
  if (it >= (L + 1) * p.tiles || it >= b + k1 * G || it >= p.items) return -1;
  return (it - b) / G;
}

// The bucket of probe id L in window [k0, k1): from the owner table in window 0.
__device__ __forceinline__ int bucket(const Params& p, const ProbeShared* ps, int L, int k0, int k1) {
  if (k0 == 0 && L >= 0 && L < min(p.lists, kOwnerLists)) return ps->owner[L];
  return bucket_of(p, L, k0, k1);
}

// One pass of `nthreads` threads (this one is t) over every probe id:
// counts each bucket of the window [k0, k1), or scatters the pairs of the
// buckets [kb, ke) into their places (their order within a bucket is the
// atomics', and no score depends on it: a column is scored alone).
template <bool kScatter>
__device__ void bucket_pass(const Params& p, ProbeShared* ps, int k0, int k1, int kb, int ke, int t, int nthreads) {
  const int total = p.Q * p.nprobe;
  for (int start = 0; start < total; start += kLoadIds * nthreads) {
    int id[kLoadIds];
#pragma unroll
    for (int i = 0; i < kLoadIds; ++i) {
      const int e = start + i * nthreads + t;
      id[i] = e < total ? __ldg(p.probe + e) : -1;
    }
#pragma unroll
    for (int i = 0; i < kLoadIds; ++i) {
      const int k = bucket(p, ps, id[i], k0, k1);
      if (k < 0) continue;
      if (!kScatter)
        atomicAdd(&ps->cnt[k - k0], 1);
      else if (k >= kb && k < ke)
        ps->pairs[ps->off[k - k0] + atomicAdd(&ps->fill[k - k0], 1)] = start + i * nthreads + t;
    }
  }
}

// Offsets and fill counts of the buckets [kb, ke) of window k0 (one thread).
__device__ void bucket_offsets(ProbeShared* ps, int k0, int kb, int ke) {
  for (int k = kb, o = 0; k < ke; ++k) {
    ps->off[k - k0] = o;
    ps->fill[k - k0] = 0;
    o += ps->cnt[k - k0];
  }
}

// An ordered pass for `list` (a slot item's, or one whose pairs overflow the
// buckets): the pairs (q * nprobe + slot) naming it, in pair order, ranks
// [lo, lo + kPairCap) into `pairs`. Returns the list's pair count. All 128
// producer threads call it.
__device__ int scan_pairs(const Params& p, int list, int lo, int* pairs, int* counts, int t) {
  const int total = p.Q * p.nprobe, w = t >> 5, lane = t & 31;
  const unsigned lt = (1u << lane) - 1u;
  int seen = 0;
  for (int start = 0, round = 0; start < total; start += kScanIds * WARPGROUP, ++round) {
    int* cnt = counts + (round & 1) * kScanIds * 4;
    int id[kScanIds];
#pragma unroll
    for (int i = 0; i < kScanIds; ++i) {
      const int e = start + i * WARPGROUP + t;
      id[i] = e < total ? __ldg(p.probe + e) : -1;
    }
#pragma unroll
    for (int i = 0; i < kScanIds; ++i) {
      const unsigned m = __ballot_sync(0xFFFFFFFFu, id[i] == list);
      if (lane == 0) cnt[i * 4 + w] = __popc(m);
    }
    bar_sync(1, WARPGROUP);
    int sum = seen;
#pragma unroll
    for (int i = 0; i < kScanIds; ++i) {
      const unsigned m = __ballot_sync(0xFFFFFFFFu, id[i] == list);
#pragma unroll
      for (int w2 = 0; w2 < 4; ++w2) {
        if (w2 == w && id[i] == list) {
          const int r = sum + __popc(m & lt) - lo;
          if (r >= 0 && r < kPairCap) pairs[r] = start + i * WARPGROUP + t;
        }
        sum += cnt[i * 4 + w2];
      }
    }
    seen = sum;
  }
  bar_sync(1, WARPGROUP);  // the pairs, for every producer thread
  return seen;
}

__device__ void produce(const Params& p, const CUtensorMap* tmap, const Rings& rg, ProbeShared* ps) {
  const int t = threadIdx.x - 2 * WARPGROUP;
  int k = 0, kp = 0;  // code and part stages filled: their ring places are k % kCodeStages, kp % kPartStages
  // One group: every chunk of the tile's rows against ncols columns.
  auto emit = [&](int list, int row0, int nrows, int ncols, auto col_of, auto q_of) {
    const int width = ncols <= 8 ? 8 : ncols <= 16 ? 16 : ncols <= 32 ? 32 : 64, cpp = kChunk / width;
    const int cps = kMaxTileRows / p.trows, bh = min(kBoxRows, p.trows);  // chunks a code stage holds; box rows
    for (int c = 0; c < p.kc; ++c) {
      float v[kPartTasks][16];
      if (c % cpp == 0) load_parts(p, width, ncols, q_of, c, t, v);  // in flight during the code load's issue
      if (c % cps == 0) {  // the code stage of chunks c .. c + cps - 1
        uint64_t* cbar = &rg.cfull[k % kCodeStages];
        mbar_wait(&rg.cempty[k % kCodeStages], ((k / kCodeStages) & 1) ^ 1);  // the first round passes
        unsigned char* codes = rg.code(k);
        if (p.tma) {
          if (t == 0) {  // one box of cps chunks x bh rows (two of 256 rows at 512 rows, cps = 1)
            const int boxes = nrows > bh ? 2 : 1;
            mbar_expect_tx(cbar, boxes * cps * bh * kChunk);
            tma_load_3d(codes, tmap, cbar, c * kChunk, row0, list);
            if (boxes == 2) tma_load_3d(codes + bh * kChunk, tmap, cbar, c * kChunk, row0 + bh, list);
          }
        } else {
          if (t == 0) mbar_arrive(cbar);
          copy_codes(p, codes, list, row0, nrows, c * kChunk, min(cps, p.kc - c), t);
        }
        mbar_arrive(cbar);
        ++k;
      }
      if (c % cpp) continue;
      mbar_wait(&rg.pempty[kp % kPartStages], ((kp / kPartStages) & 1) ^ 1);
      unsigned char* parts = rg.part(kp);
      store_parts(parts, width, t, v);
      Header* h = header(parts);
      if (t < ncols) h->col[t] = col_of(t), h->qi[t] = q_of(t);
      if (t == 0) {
        h->end = 0, h->ncols = ncols, h->width = width, h->nrows = nrows;
        h->obase = row0, h->ibase = (long long)list * p.rows + row0;
      }
      fence_proxy_async();  // the parts are read by wgmma (the async proxy)
      mbar_arrive(&rg.pfull[kp++ % kPartStages]);
    }
  };
  const int np = p.nprobe;
  // A probe item against n pairs listed at seg, in groups of up to 64.
  auto emit_pairs = [&](int item, const int* seg, int n) {
    const int list = item / p.tiles, row0 = item % p.tiles * p.trows;
    for (int g = 0; g < n; g += kMaxCols) {
      const int* gp = seg + g;
      emit(list, row0, min(p.trows, p.rows - row0), min(kMaxCols, n - g), [gp](int i) { return gp[i]; },
           [gp, np](int i) { return gp[i] / np; });
    }
  };

  if (p.probe != nullptr && p.slot_items) {
    // At most 128 pairs: item = pair * tiles + tile, the pair's list's tile, kept by the first pair
    // that names the list (an ordered scan then finds all of its pairs), so each probed list is read once
    // and the blocks share out only probed lists.
    for (int item = blockIdx.x; item < p.items; item += gridDim.x) {
      const int pair = item / p.tiles, list = __ldg(p.probe + pair);
      if (list < 0 || list >= p.lists) continue;
      if (t == 0) ps->named = 0;
      bar_sync(1, WARPGROUP);
      for (int e = t; e < pair; e += WARPGROUP)
        if (__ldg(p.probe + e) == list) ps->named = 1;
      bar_sync(1, WARPGROUP);
      const bool first = ps->named == 0;
      bar_sync(1, WARPGROUP);  // every thread has read the flag before the next item resets it
      if (!first) continue;
      for (int lo = 0;; lo += kPairCap) {
        const int n = scan_pairs(p, list, lo, ps->pairs, ps->counts, t);
        emit_pairs(list * p.tiles + item % p.tiles, ps->pairs, min(n - lo, kPairCap));
        if (n <= lo + kPairCap) break;
      }
    }
  } else if (p.probe == nullptr) {  // a row tile against one group of up to 64 queries
    for (int item = blockIdx.x; item < p.items; item += gridDim.x) {
      const int tile = item / p.qgroups, q0 = item % p.qgroups * kMaxCols, row0 = tile * p.trows;
      auto q_of = [q0](int n) { return q0 + n; };
      emit(0, row0, min(p.trows, p.rows - row0), min(kMaxCols, p.Q - q0), q_of, q_of);
    }
  } else {  // each window of this block's items: count, then batches of buckets that fit, scattered and emitted
    const int G = gridDim.x, b = blockIdx.x, nit = b < p.items ? (p.items - 1 - b) / G + 1 : 0;
    auto list_of = [&](int kk) { return (b + kk * G) / p.tiles; };
    for (int k0 = 0; k0 < nit; k0 += kBuckets) {
      const int k1 = min(nit, k0 + kBuckets);
      const bool pre = k0 == 0 && ps->ready > 0, whole = k0 == 0 && ps->ready == 2;
      if (!pre) {
        for (int kk = k0 + t; kk < k1; kk += WARPGROUP) ps->cnt[kk - k0] = 0;
        bar_sync(1, WARPGROUP);
        bucket_pass<false>(p, ps, k0, k1, k0, k1, t, WARPGROUP);
        bar_sync(1, WARPGROUP);
      }
      for (int kb = k0; kb < k1;) {
        int ke = kb + 1;
        if (ps->cnt[kb - k0] > kPairBuf) {  // one list past the buckets: ordered passes, for each of its items
          while (ke < k1 && list_of(ke) == list_of(kb)) ++ke;
          for (int kk = kb; kk < ke; ++kk)
            for (int lo = 0;; lo += kPairCap) {
              const int n = scan_pairs(p, list_of(kk), lo, ps->pairs, ps->counts, t);
              emit_pairs(b + kk * G, ps->pairs, min(n - lo, kPairCap));
              if (n <= lo + kPairCap) break;
            }
          kb = ke;
          continue;
        }
        for (int tot = ps->cnt[kb - k0]; ke < k1 && ps->cnt[ke - k0] <= kPairBuf - tot; ++ke) tot += ps->cnt[ke - k0];
        if (!whole) {
          bar_sync(1, WARPGROUP);  // every thread is done with the last batch's pairs
          if (t == 0) bucket_offsets(ps, k0, kb, ke);
          bar_sync(1, WARPGROUP);
          bucket_pass<true>(p, ps, k0, k1, kb, ke, t, WARPGROUP);
          bar_sync(1, WARPGROUP);
        }
        for (int kk = kb, kr = kb; kk < ke; ++kk) {
          if (list_of(kk) != list_of(kr)) kr = kk;  // the bucket: the list's first item in the window
          emit_pairs(b + kk * G, ps->pairs + ps->off[kr - k0], ps->cnt[kr - k0]);
        }
        kb = ke;
      }
    }
  }
  mbar_wait(&rg.pempty[kp % kPartStages], ((kp / kPartStages) & 1) ^ 1);  // the end
  if (t == 0) header(rg.part(kp))->end = 1;
  mbar_arrive(&rg.pfull[kp % kPartStages]);
}

// Window 0's bucket counts, and its pairs when they all fit, by every thread
// of the block before the roles split (the probe form only). Where every
// probe id fits one round of loads, the scatter reuses them.
__device__ void bucket_window0(const Params& p, ProbeShared* ps) {
  const int G = gridDim.x, b = blockIdx.x, nit = b < p.items ? (p.items - 1 - b) / G + 1 : 0;
  const int k1 = min(nit, kBuckets), total = p.Q * p.nprobe;
  const bool one_round = total <= kLoadIds * kThreads;
  int bk[kLoadIds];  // one round: each id, then its bucket or -1; the loads run while the table is built
#pragma unroll
  for (int i = 0; i < kLoadIds; ++i) {
    const int e = i * kThreads + threadIdx.x;
    bk[i] = one_round && e < total ? __ldg(p.probe + e) : -1;
  }
  for (int kk = threadIdx.x; kk < k1; kk += kThreads) ps->cnt[kk] = 0;
  for (int L = threadIdx.x; L < min(p.lists, kOwnerLists); L += kThreads) ps->owner[L] = (short)bucket_of(p, L, 0, k1);
  __syncthreads();
  if (one_round) {
#pragma unroll
    for (int i = 0; i < kLoadIds; ++i)
      if (bk[i] >= 0) {
        bk[i] = bucket(p, ps, bk[i], 0, k1);
        if (bk[i] >= 0) atomicAdd(&ps->cnt[bk[i]], 1);
      }
  } else {
    bucket_pass<false>(p, ps, 0, k1, 0, k1, threadIdx.x, kThreads);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int tot = 0;
    for (int kk = 0; kk < k1; ++kk) tot += ps->cnt[kk];
    ps->ready = tot <= kPairBuf ? 2 : 1;
    if (ps->ready == 2) bucket_offsets(ps, 0, 0, k1);
  }
  __syncthreads();
  if (ps->ready == 2) {
    if (one_round) {
#pragma unroll
      for (int i = 0; i < kLoadIds; ++i)
        if (bk[i] >= 0) ps->pairs[ps->off[bk[i]] + atomicAdd(&ps->fill[bk[i]], 1)] = i * kThreads + threadIdx.x;
    } else {
      bucket_pass<true>(p, ps, 0, k1, 0, k1, threadIdx.x, kThreads);
    }
    __syncthreads();
  }
}

// ------------------------------------------------------------------ consumers

// One group, its first part stage (index kp) already arrived: every
// chunk's products, the epilogue, and the stages released; k and kp move
// past the group's code and part stages. W: the group's width (8, 16, 32 or
// 64 columns), SL: slabs of 64 rows a warpgroup (tile rows / 128).
template <int W, int SL>
__device__ void run_group(const Params& p, const Rings& rg, int wg, int& k, int& kp) {
  constexpr int NC = W <= 16 ? W : 32, CG = W / NC, N = 3 * NC, NC8 = NC / 8, CPP = kChunk / W;
  const int tid = threadIdx.x % WARPGROUP, warp = tid >> 5, lane = tid & 31, g = lane >> 2, q = lane & 3;
  auto release = [&](uint64_t* bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };
  const Header* h = header(rg.part(kp));  // every part stage of the group holds the same header
  const int nrows = h->nrows, ncols = h->ncols;
  const int nsl = min(SL, ((nrows + 63) / 64 - wg + 1) / 2);  // my slabs with a valid row: 64 (2 i + wg) < nrows
  // The epilogue's operands, loaded now so that their latency passes during the chunks (at W = 64, inv only:
  // registers). iv[i][hh]: inv of row 64 (2 i + wg) + 16 warp + g + 8 hh; column n = 8 cc + 2 q + b.
  constexpr bool kEarly = W <= 32;
  float iv[SL][2], qzv[W / 8][2];
  long long orow[W / 8][2];
  auto columns = [&](const Header* hd) {
#pragma unroll
    for (int cc = 0; cc < W / 8; ++cc)
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const int n = 8 * cc + 2 * q + b;
        qzv[cc][b] = n < ncols ? __ldg(p.qz + hd->qi[n]) : 0.0f;
        orow[cc][b] = n < ncols ? (long long)hd->col[n] * p.ostride + hd->obase : 0;
      }
  };
  {
    const float* inv = p.inv + h->ibase;
#pragma unroll
    for (int i = 0; i < SL; ++i)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = 64 * (2 * i + wg) + 16 * warp + g + 8 * hh;
        iv[i][hh] = r < nrows ? __ldg(inv + r) : 0.0f;
      }
    if (kEarly) columns(h);
  }
  float total[SL][W / 2];
#pragma unroll
  for (int i = 0; i < SL; ++i)
#pragma unroll
    for (int e = 0; e < W / 2; ++e) total[i][e] = 0.0f;
  constexpr int CPS = 4 / SL;                // chunks a code stage holds (512 / tile rows)
  constexpr int kPitch = CPS * kChunk;        // a code stage's row: CPS chunks
  // At W <= 16 a batch is a code stage: its SL slabs x CPS chunks (4 slab-chunks), all their products at
  // once; at W = 32 and 64 one slab of one chunk against one column group.
  constexpr int kBatch = W <= 16 ? 4 : 1;
  float acc[kBatch][N / 2];
  uint32_t a[4][kBatch][4];  // [k step][slab-chunk]

  // This thread's 16 bytes of rows g and g + 8 of slab i.
  auto rows = [&](const unsigned char* codes, int i, uint4(&raw)[2]) {
    const int r = 64 * (2 * i + wg) + 16 * warp + g;
    raw[0] = *reinterpret_cast<const uint4*>(codes + r * kPitch + 16 * q);
    raw[1] = *reinterpret_cast<const uint4*>(codes + (r + 8) * kPitch + 16 * q);
  };
  // The A fragments of every k step of the batch's slab-chunks, from their code bytes.
  auto convert = [&](const uint4(&raw)[kBatch][2]) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const uint32_t x0 = word_of(raw[i][0], j), x1 = word_of(raw[i][1], j);
        a[j][i][0] = pack_bf16(byte_to_float(x0, 0), byte_to_float(x0, 1));
        a[j][i][1] = pack_bf16(byte_to_float(x1, 0), byte_to_float(x1, 1));
        a[j][i][2] = pack_bf16(byte_to_float(x0, 2), byte_to_float(x0, 3));
        a[j][i][3] = pack_bf16(byte_to_float(x1, 2), byte_to_float(x1, 3));
      }
  };
  // Slab-chunk b's products, against the B tile tile[b], run as one batch and retire.
  auto products = [&](const unsigned char* (&tile)[kBatch]) {
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        if (j == 0)
          Wgmma<N>::template rs0<0>(acc[b], a[0][b], desc_k(tile[b], N, 0));
        else
          Wgmma<N>::template rs<0>(acc[b], a[j][b], desc_k(tile[b], N, j));
      }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int b = 0; b < kBatch; ++b) fence_regs(acc[b]);
  };
  // total[i] (column group cg) += slab-chunk b's partial, (h + m) + l.
  auto add = [&](int i, int cg, int b) {
#pragma unroll
    for (int c = 0; c < NC8; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float& t = total[i][4 * (cg * NC8 + c) + e];
        t = __fadd_rn(t, __fadd_rn(__fadd_rn(acc[b][4 * c + e], acc[b][4 * (c + NC8) + e]), acc[b][4 * (c + 2 * NC8) + e]));
      }
  };

  const int last = kp + (p.kc - 1) / CPP;  // the group's last part stage
  // Chunk c's parts: slot c % CPP of part stage kp + c / CPP, waited for at its first chunk and released
  // after its last (the group's last after the epilogue has read its header).
  auto part_of = [&](int c) {
    const int pn = kp + c / CPP;
    if (c > 0 && c % CPP == 0) mbar_wait(&rg.pfull[pn % kPartStages], (pn / kPartStages) & 1);
    return rg.part(pn) + c % CPP * 3 * W * 128;
  };
  auto part_done = [&](int c) {
    const int pn = kp + c / CPP;
    if ((c + 1) % CPP == 0 && pn != last) release(&rg.pempty[pn % kPartStages]);
  };
  for (int c = 0; c < p.kc; c += CPS) {
    const int n = k + c / CPS, nch = min(CPS, p.kc - c);  // the code stage and its chunks
    mbar_wait(&rg.cfull[n % kCodeStages], (n / kCodeStages) & 1);
    const unsigned char* codes = rg.code(n);
    if constexpr (W <= 16) {  // CPP is a multiple of CPS: the stage's chunks share a part stage
      const unsigned char* parts = part_of(c);
      uint4 raw[kBatch][2];
      const unsigned char* tile[kBatch];
#pragma unroll
      for (int s = 0; s < CPS; ++s)
#pragma unroll
        for (int i = 0; i < SL; ++i) {
          rows(codes + s * kChunk, i, raw[s * SL + i]);
          tile[s * SL + i] = in_place(parts + s * 3 * W * 128);
        }
      release(&rg.cempty[n % kCodeStages]);
      convert(raw);
      products(tile);
#pragma unroll
      for (int s = 0; s < CPS; ++s)  // in chunk order
        if (s < nch)
#pragma unroll
          for (int i = 0; i < SL; ++i) add(i, 0, s * SL + i);
      part_done(c + CPS - 1);
    } else {
      if (nsl <= 0) release(&rg.cempty[n % kCodeStages]);
#pragma unroll
      for (int s = 0; s < CPS; ++s)
        if (s < nch) {
          const unsigned char* parts = part_of(c + s);
#pragma unroll
          for (int i = 0; i < SL; ++i)
            if (i < nsl) {
              uint4 raw[1][2];
              rows(codes + s * kChunk, i, raw[0]);
              if (s == nch - 1 && i == nsl - 1) release(&rg.cempty[n % kCodeStages]);
              convert(raw);
#pragma unroll
              for (int cg = 0; cg < CG; ++cg) {
                const unsigned char* tile[1] = {in_place(parts + cg * 3 * NC * 128)};
                products(tile);
                add(i, cg, 0);
              }
            }
          part_done(c + s);
        }
    }
  }

  // Epilogue: total[i][4 cc + e] is row 64 (2 i + wg) + 16 warp + g (+ 8 for
  // e >= 2) of the tile, column 8 cc + 2 q + (e & 1).
  if (!kEarly) columns(header(rg.part(last)));  // the first part stage may be refilled by now
  release(&rg.pempty[last % kPartStages]);
#pragma unroll
  for (int i = 0; i < SL; ++i)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = 64 * (2 * i + wg) + 16 * warp + g + 8 * hh;
      if (r >= nrows) continue;
#pragma unroll
      for (int cc = 0; cc < W / 8; ++cc)
#pragma unroll
        for (int b = 0; b < 2; ++b)
          if (8 * cc + 2 * q + b < ncols)
            p.out[orow[cc][b] + r] = __fmul_rn(__fadd_rn(total[i][4 * cc + 2 * hh + b], qzv[cc][b]), iv[i][hh]);
    }
  k += (p.kc + CPS - 1) / CPS;
  kp = last + 1;
}

// run_group at this launch's tile rows (SL = rows / 128).
template <int W>
__device__ __forceinline__ void dispatch(const Params& p, const Rings& rg, int wg, int& k, int& kp) {
  if (p.trows == 512)
    run_group<W, 4>(p, rg, wg, k, kp);
  else if (p.trows == 256)
    run_group<W, 2>(p, rg, wg, k, kp);
  else
    run_group<W, 1>(p, rg, wg, k, kp);
}

__global__ void __launch_bounds__(kThreads, 1) scan_kernel(const __grid_constant__ CUtensorMap tmap,
                                                            const __grid_constant__ Params p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
  Rings rg;
  rg.codes = base;
  rg.parts = base + kCodeStages * kCodeBytes;
  ProbeShared* ps = reinterpret_cast<ProbeShared*>(rg.parts + kPartStages * kPartStageBytes);
  rg.cfull = reinterpret_cast<uint64_t*>(ps + 1);
  rg.cempty = rg.cfull + kCodeStages;
  rg.pfull = rg.cempty + kCodeStages;
  rg.pempty = rg.pfull + kPartStages;
  if (threadIdx.x == 0) {
    if (p.tma) tma_prefetch_desc(&tmap);  // its first load comes after the probe's bucketing
    for (int s = 0; s < kCodeStages; ++s) {
      mbar_init(&rg.cfull[s], WARPGROUP + 1);  // the producer's threads and its thread 0's load (or arrival)
      mbar_init(&rg.cempty[s], 8);             // one arrival per consumer warp
    }
    for (int s = 0; s < kPartStages; ++s) {
      mbar_init(&rg.pfull[s], WARPGROUP);
      mbar_init(&rg.pempty[s], 8);
    }
    mbar_init_fence();
  }
  __syncthreads();
  if (p.probe != nullptr && !p.slot_items) bucket_window0(p, ps);

  const int wg = threadIdx.x / WARPGROUP;
  if (wg == 2) {
    reg_dealloc<72>();
    produce(p, &tmap, rg, ps);
  } else {
    reg_alloc<216>();
    for (int k = 0, kp = 0;;) {
      mbar_wait(&rg.pfull[kp % kPartStages], (kp / kPartStages) & 1);
      const Header* h = header(rg.part(kp));
      if (h->end) break;
      if (h->width == 64)
        dispatch<64>(p, rg, wg, k, kp);
      else if (h->width == 32)
        dispatch<32>(p, rg, wg, k, kp);
      else if (h->width == 16)
        dispatch<16>(p, rg, wg, k, kp);
      else
        dispatch<8>(p, rg, wg, k, kp);
    }
  }
}

// Rows of a tile, 512, 256 or 128. 512 where Q > 4, so that the queries a
// tile reads from L2 (4 Q bytes a code row) stay within an eighth of its
// code bytes at Q = 64. At Q <= 4, 256 (a code stage then holds two chunks
// and its TMA box rows are 128 bytes, which read device memory better than
// 64), or 128 where 256-row tiles of the lists that can be probed are fewer
// than the SMs (more blocks on a small search; a stage holds four chunks).
int tile_rows(const Params& p, int sms) {
  if (p.Q > 4) return kMaxTileRows;
  const long long lists = p.probe == nullptr ? 1 : std::min<long long>(p.lists, (long long)p.Q * p.nprobe);
  return lists * ((p.rows + 255) / 256) >= sms ? 256 : 128;
}

int launch(Params p, cudaStream_t stream) {
  CUtensorMap tmap{};
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  p.kc = (p.D + kChunk - 1) / kChunk;
  p.trows = tile_rows(p, sms);
  p.tiles = (p.rows + p.trows - 1) / p.trows;
  p.tma = p.D % 16 == 0;
  p.qs_vec = p.D % 4 == 0 && reinterpret_cast<uintptr_t>(p.qs) % 16 == 0;
  p.slot_items = p.probe != nullptr && (long long)p.Q * p.nprobe <= WARPGROUP;
  const long long items = (p.slot_items ? (long long)p.Q * p.nprobe : p.lists) * p.tiles * p.qgroups;
  if (items > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  p.items = (int)items;
  if (p.tma) {
    const cuuint64_t dims[3] = {(cuuint64_t)p.D, (cuuint64_t)p.rows, (cuuint64_t)p.lists};
    const cuuint64_t strides[2] = {(cuuint64_t)p.D, (cuuint64_t)p.rows * p.D};
    const cuuint32_t box[3] = {(cuuint32_t)(kChunk * kMaxTileRows / p.trows), (cuuint32_t)std::min(kBoxRows, p.trows),
                               1},
                     elem[3] = {1, 1, 1};
    const int rc = tmap_tiled(&tmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, p.codes, 3, dims, strides, box, elem,
                              CU_TENSOR_MAP_SWIZZLE_NONE);
    if (rc != 0) return rc;
  }
  e = cudaFuncSetAttribute(scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (e != cudaSuccess) return (int)e;
  scan_kernel<<<(unsigned)(items < sms ? items : sms), kThreads, kSmem, stream>>>(tmap, p);
  return (int)cudaGetLastError();
}

Params make_params(const void* codes, const void* inv, const void* qs, const void* qz, void* out, int D, int Q) {
  Params p{};
  p.codes = static_cast<const uint8_t*>(codes);
  p.inv = static_cast<const float*>(inv);
  p.qs = static_cast<const float*>(qs);
  p.qz = static_cast<const float*>(qz);
  p.out = static_cast<float*>(out);
  p.D = D;
  p.Q = Q;
  return p;
}

}  // namespace

// s (Q, N) fp32 = (qs @ codes^T + qz) * inv. Device pointers: codes (N, D) uint8
// 16-byte aligned, qs (Q, D), qz (Q) and inv (N) fp32. Launches on `stream`;
// returns 0 or an error code (a CUDA error, or sm90.cuh's tensor map codes).
extern "C" int u8_ip_scores(const void* codes, const void* qs, const void* qz, const void* inv, void* out, int N, int D,
                            int Q, void* stream_) {
  if (N <= 0 || Q <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  Params p = make_params(codes, inv, qs, qz, out, D, Q);
  p.rows = N;
  p.lists = 1;
  p.ostride = N;
  p.qgroups = (Q + kMaxCols - 1) / kMaxCols;
  return launch(p, static_cast<cudaStream_t>(stream_));
}

// s (Q, nprobe, cap) fp32: query q against lists[probe[q, j]] for each j, scored
// as u8_ip_scores does. lists (nlist, cap, D) uint8 16-byte aligned, list_inv
// (nlist, cap) fp32, probe (Q, nprobe) int32 in [0, nlist), qs and qz as above.
extern "C" int u8_ip_probe(const void* lists, const void* list_inv, const void* probe, const void* qs, const void* qz,
                           void* out, int nlist, int cap, int D, int Q, int nprobe, void* stream_) {
  if (nlist <= 0 || cap <= 0 || Q <= 0 || nprobe <= 0 || D <= 0 || (long long)Q * nprobe > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  Params p = make_params(lists, list_inv, qs, qz, out, D, Q);
  p.probe = static_cast<const int*>(probe);
  p.nprobe = nprobe;
  p.rows = cap;
  p.lists = nlist;
  p.ostride = cap;
  p.qgroups = 1;
  return launch(p, static_cast<cudaStream_t>(stream_));
}
