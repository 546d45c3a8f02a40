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
// What bounds it on an H100: one query reads each code byte for one FMA, far
// below the ~20 flop/byte at which fp32 FMA (67 TFLOP/s) overtakes device
// memory (3.35 TB/s), so a single query is bytes-bound; at Q = 64 the same byte
// feeds 64 FMAs and the fp32 pipe bounds it. The design:
//
//   * Each block copies a tile of whole rows into shared memory, each code
//     byte leaving device memory once: 16-byte cp.async copies, all in flight
//     together, where D % 16 == 0 (a chunk then never straddles two rows);
//     otherwise 16-byte loads, eight in flight a thread, stored byte by byte.
//     A row sits at a stride of an odd number of 16-byte units, so a warp's
//     16-byte reads of 32 rows take the four wavefronts 512 bytes need.
//   * A warp takes a slab of 32 * TR rows (lane + 32 t) against TQ queries:
//     each 4-byte word of codes is converted once (a byte permute into
//     2^23 + u and one subtract, exact) and feeds TQ FMAs. Q < 8 runs
//     TR = TQ = 1; wider query batches TR = 4, TQ = 8, 32 accumulators a
//     thread (TR = 2 at two blocks an SM spills and runs slower).
//   * The queries are read as float4 through the read-only cache, all lanes
//     of a warp on one query (a broadcast); the wrapper pads qs with zero
//     columns to a multiple of 16.
//   * fp32 FMA on the CUDA cores only: qs in bf16 or TF32 would move scores
//     by ~1e-3 and reorder hits.
//
// A row's sum runs in one order wherever the row lies: acc = 0, then
// acc = fma(qs[d], u[d], acc) for d = 0, 1, ... (zero pad past D), then
// (acc + qz) * inv, in every tile, slab and configuration and in both entry
// points. Two identical rows therefore get bit-identical scores, and ties
// stay ties for the ranking to order.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSmemTarget = 72 * 1024;  // three blocks an SM: one loads while the others compute
constexpr int kSmemLimit = 227 * 1024;
constexpr int kMaxRows = 256;
constexpr int kLoadsInFlight = 8;

struct Params {
  const uint8_t* codes;  // (rows_total, D)
  const float* inv;      // (rows_total,)
  const float* qs;       // (Q, dq), dq = 16 * ceil(D / 16), zero past D
  const float* qz;       // (Q,)
  const int* probe;      // (Q, nprobe) list ids, probe form only
  float* out;
  long long rows_total;  // N, or nlist * cap
  int D, dq, dpw;        // dpw: a row's stride in shared memory in words, 4 * odd
  int rb;                // rows of a block's tile, a multiple of 32 * TR
  int Q, cap, nprobe, tiles;
};

__device__ __forceinline__ float byte_to_float(uint32_t w, uint32_t b) {
  // 0x4B0000uu is 2^23 + u as a float: one permute, one exact subtract
  return __fsub_rn(__uint_as_float(__byte_perm(w, 0x4B000000u, 0x7540u | b)), 8388608.0f);
}

__device__ __forceinline__ float lane_of(const float4& v, int b) {
  return b == 0 ? v.x : b == 1 ? v.y : b == 2 ? v.z : v.w;
}

__device__ __forceinline__ uint32_t word_of(const uint4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

// Rows [row0, row0 + nrows) of the row-major (rows_total, D) uint8 array into
// `tile`, row r at word r * dpw; the bytes from D to dq of each row are zero.
__device__ void load_tile(const Params& p, long long row0, int nrows, uint32_t* tile) {
  const int D = p.D;
  uint8_t* tb = reinterpret_cast<uint8_t*>(tile);
  const long long begin = row0 * D, end = begin + (long long)nrows * D, total = p.rows_total * D;
  const uint4* src = reinterpret_cast<const uint4*>(p.codes);
  if (D % 16 == 0) {  // 16-byte chunks that never straddle a row, to 16-byte aligned places
    for (long long c = begin / 16 + threadIdx.x; c < end / 16; c += blockDim.x) {
      const int off = (int)(c * 16 - begin), r = off / D, d = off % D;
      cp_async16(tile + r * p.dpw + d / 4, src + c);
    }
    asm volatile("cp.async.wait_all;\n" ::);
    return;
  }
  const long long c_end = (end + 15) / 16;
  for (long long c0 = begin / 16 + threadIdx.x; c0 < c_end; c0 += (long long)kLoadsInFlight * blockDim.x) {
    uint4 v[kLoadsInFlight];
#pragma unroll
    for (int u = 0; u < kLoadsInFlight; ++u) {
      const long long c = c0 + (long long)u * blockDim.x;
      if (c < c_end && c * 16 + 16 <= total) {
        v[u] = __ldg(src + c);
      } else {  // past the tile, or the array's ragged last chunk
        uint32_t w[4] = {0, 0, 0, 0};
        for (int i = 0; c < c_end && i < 16; ++i)
          if (c * 16 + i < total) w[i / 4] |= (uint32_t)p.codes[c * 16 + i] << (8 * (i % 4));
        v[u] = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
#pragma unroll
    for (int u = 0; u < kLoadsInFlight; ++u) {
      const long long g = (c0 + (long long)u * blockDim.x) * 16;
#pragma unroll
      for (int i = 0; i < 16; ++i)
        if (g + i >= begin && g + i < end) {
          const int off = (int)(g + i - begin), r = off / D, d = off % D;
          tb[r * p.dpw * 4 + d] = (uint8_t)(word_of(v[u], i / 4) >> (8 * (i % 4)));
        }
    }
  }
  for (int r = threadIdx.x; r < nrows; r += blockDim.x)
    for (int d = D; d < p.dq; ++d) tb[r * p.dpw * 4 + d] = 0;
}

template <int TR, int TQ, bool PROBE>
__global__ void __launch_bounds__(kThreads) scan_kernel(const Params p) {
  extern __shared__ __align__(16) uint32_t tile[];
  long long row0, qstride;
  int nrows, q0, nq;
  float* out;
  if (PROBE) {  // block: one (query, probed list) pair, one tile of that list's rows
    const int pair = blockIdx.x / p.tiles, c0 = (blockIdx.x % p.tiles) * p.rb;
    row0 = (long long)p.probe[pair] * p.cap + c0;
    nrows = min(p.rb, p.cap - c0);
    q0 = pair / p.nprobe, nq = 1, qstride = 0;
    out = p.out + (long long)pair * p.cap + c0;
  } else {  // block: one tile of rows against every query
    row0 = (long long)blockIdx.x * p.rb;
    nrows = (int)min((long long)p.rb, p.rows_total - row0);
    q0 = 0, nq = p.Q, qstride = p.rows_total;
    out = p.out + row0;
  }
  const float* inv = p.inv + row0;
  load_tile(p, row0, nrows, tile);
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, nwarps = blockDim.x / 32;
  const int slabs = (nrows + 32 * TR - 1) / (32 * TR), groups = (nq + TQ - 1) / TQ, d16n = p.dq / 16;
  for (int item = warp; item < slabs * groups; item += nwarps) {
    const int s = item % slabs, g = item / slabs;
    const uint4* rowp[TR];
    const float4* qp[TQ];
#pragma unroll
    for (int t = 0; t < TR; ++t)
      rowp[t] = reinterpret_cast<const uint4*>(tile + min(s * 32 * TR + lane + 32 * t, nrows - 1) * p.dpw);
#pragma unroll
    for (int j = 0; j < TQ; ++j)
      qp[j] = reinterpret_cast<const float4*>(p.qs + (long long)(q0 + min(g * TQ + j, nq - 1)) * p.dq);
    float acc[TR][TQ];
#pragma unroll
    for (int t = 0; t < TR; ++t)
#pragma unroll
      for (int j = 0; j < TQ; ++j) acc[t][j] = 0.0f;
    for (int d16 = 0; d16 < d16n; ++d16) {
      uint4 w[TR];
#pragma unroll
      for (int t = 0; t < TR; ++t) w[t] = rowp[t][d16];
#pragma unroll
      for (int jw = 0; jw < 4; ++jw) {
        float4 qv[TQ];
#pragma unroll
        for (int j = 0; j < TQ; ++j) qv[j] = __ldg(qp[j] + 4 * d16 + jw);
#pragma unroll
        for (int b = 0; b < 4; ++b)
#pragma unroll
          for (int t = 0; t < TR; ++t) {
            const float u = byte_to_float(word_of(w[t], jw), b);
#pragma unroll
            for (int j = 0; j < TQ; ++j) acc[t][j] = __fmaf_rn(lane_of(qv[j], b), u, acc[t][j]);
          }
      }
    }
#pragma unroll
    for (int t = 0; t < TR; ++t) {
      const int r = s * 32 * TR + lane + 32 * t;
      if (r >= nrows) continue;
#pragma unroll
      for (int j = 0; j < TQ; ++j) {
        const int qi = g * TQ + j;
        if (qi < nq) out[(q0 + qi) * qstride + r] = __fmul_rn(__fadd_rn(acc[t][j], p.qz[q0 + qi]), inv[r]);
      }
    }
  }
}

// Rows a block's tile holds: a multiple of 32 * TR, as many as keep the tile
// within kSmemTarget (at least one slab), at most kMaxRows.
int tile_rows(int tr, int dpw) {
  const int slab = 32 * tr, fit = kSmemTarget / (dpw * 4) / slab * slab;
  return fit < slab ? slab : fit > kMaxRows ? kMaxRows : fit;
}

template <int TR, int TQ, bool PROBE>
int launch(Params p, int rows, int pairs, cudaStream_t stream) {
  p.rb = tile_rows(TR, p.dpw);
  const int smem = p.rb * p.dpw * 4;
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  p.tiles = (rows + p.rb - 1) / p.rb;
  const long long blocks = (long long)p.tiles * pairs;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  auto kernel = scan_kernel<TR, TQ, PROBE>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

Params make_params(const void* codes, const void* inv, const void* qs, const void* qz, void* out, long long rows_total,
                   int D, int Q) {
  Params p{};
  p.codes = static_cast<const uint8_t*>(codes);
  p.inv = static_cast<const float*>(inv);
  p.qs = static_cast<const float*>(qs);
  p.qz = static_cast<const float*>(qz);
  p.out = static_cast<float*>(out);
  p.rows_total = rows_total;
  p.D = D;
  p.dq = 16 * ((D + 15) / 16);
  p.dpw = p.dq / 16 % 2 ? p.dq / 4 : p.dq / 4 + 4;  // an odd number of 16-byte units
  p.Q = Q;
  return p;
}

}  // namespace

// The largest D either entry point takes: one slab of 128 rows, each at most
// kSmemLimit / 512 words with its stride pad, in shared memory.
extern "C" int u8_ip_max_dim() { return 16 * ((kSmemLimit / (4 * 128) - 4) / 4); }

// The row stride of qs the kernel reads: D padded with zero columns to a multiple of 16.
extern "C" int u8_ip_qs_stride(int D) { return 16 * ((D + 15) / 16); }

// s (Q, N) fp32 = (qs @ codes^T + qz) * inv. Device pointers: codes (N, D) uint8
// 16-byte aligned, inv (N) and qz (Q) fp32, qs (Q, u8_ip_qs_stride(D)) fp32 zero
// past D, 16-byte aligned. Launches on `stream`; returns 0 or a CUDA error.
extern "C" int u8_ip_scores(const void* codes, const void* qs, const void* qz, const void* inv, void* out, int N, int D,
                            int Q, void* stream_) {
  if (N <= 0 || Q <= 0 || D <= 0 || D > u8_ip_max_dim()) return (int)cudaErrorInvalidValue;
  const Params p = make_params(codes, inv, qs, qz, out, N, D, Q);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  return Q >= 8 ? launch<4, 8, false>(p, N, 1, stream) : launch<1, 1, false>(p, N, 1, stream);
}

// s (Q, nprobe, cap) fp32: query q against lists[probe[q, j]] for each j, scored
// as u8_ip_scores does. lists (nlist, cap, D) uint8 16-byte aligned, list_inv
// (nlist, cap) fp32, probe (Q, nprobe) int32 in [0, nlist), qs and qz as above.
extern "C" int u8_ip_probe(const void* lists, const void* list_inv, const void* probe, const void* qs, const void* qz,
                           void* out, int nlist, int cap, int D, int Q, int nprobe, void* stream_) {
  if (nlist <= 0 || cap <= 0 || Q <= 0 || nprobe <= 0 || D <= 0 || D > u8_ip_max_dim())
    return (int)cudaErrorInvalidValue;
  Params p = make_params(lists, list_inv, qs, qz, out, (long long)nlist * cap, D, Q);
  p.probe = static_cast<const int*>(probe);
  p.cap = cap;
  p.nprobe = nprobe;
  return launch<1, 1, true>(p, cap, Q * nprobe, static_cast<cudaStream_t>(stream_));
}
