// Native store codec: batched .clp framing on libzstd (host C++, no CUDA).
//
// A frame is the magic "CLPF", a little-endian uint32 payload length and the
// zstd level-22 payload of the raw uint8 code vector. The batch entry points
// reuse one ZSTD_CCtx / ZSTD_DCtx across vectors instead of a fresh context
// per record (context setup dominates at level 22 for payloads of a few
// hundred bytes).
//
// The zstd prototypes the file calls are declared here, so it builds on a
// machine that has the shared library libzstd.so.1 and no zstd.h; it is
// linked against that library by its file name (-l:libzstd.so.1).
//
// Built on first use by clip_codec_tpu_torch/ops/_build.py (build_host) and
// bound with ctypes by clip_codec_tpu_torch/io/native.py.

#include <cstddef>
#include <cstdint>
#include <cstring>

extern "C" {
typedef struct ZSTD_CCtx_s ZSTD_CCtx;
typedef struct ZSTD_DCtx_s ZSTD_DCtx;
size_t ZSTD_compressBound(size_t srcSize);
unsigned ZSTD_isError(size_t code);
size_t ZSTD_compress(void* dst, size_t dstCapacity, const void* src, size_t srcSize, int level);
size_t ZSTD_decompress(void* dst, size_t dstCapacity, const void* src, size_t compressedSize);
ZSTD_CCtx* ZSTD_createCCtx(void);
size_t ZSTD_freeCCtx(ZSTD_CCtx* cctx);
size_t ZSTD_compressCCtx(ZSTD_CCtx* cctx, void* dst, size_t dstCapacity, const void* src,
                         size_t srcSize, int level);
ZSTD_DCtx* ZSTD_createDCtx(void);
size_t ZSTD_freeDCtx(ZSTD_DCtx* dctx);
size_t ZSTD_decompressDCtx(ZSTD_DCtx* dctx, void* dst, size_t dstCapacity, const void* src,
                           size_t srcSize);
unsigned long long ZSTD_getFrameContentSize(const void* src, size_t srcSize);
unsigned ZSTD_versionNumber(void);
}

namespace {

constexpr char kMagic[4] = {'C', 'L', 'P', 'F'};
constexpr int kLevel = 22;

inline void put_le32(uint8_t* p, uint32_t v) {
  p[0] = v & 0xff;
  p[1] = (v >> 8) & 0xff;
  p[2] = (v >> 16) & 0xff;
  p[3] = (v >> 24) & 0xff;
}

inline uint32_t get_le32(const uint8_t* p) {
  return uint32_t(p[0]) | (uint32_t(p[1]) << 8) | (uint32_t(p[2]) << 16) |
         (uint32_t(p[3]) << 24);
}

}  // namespace

extern "C" {

// The linked library's version, as ZSTD_versionNumber (10505 for 1.5.5).
unsigned clp_zstd_version(void) { return ZSTD_versionNumber(); }

// Upper bound on one framed record for payloads of `n` bytes.
size_t clp_frame_bound(size_t n) { return 8 + ZSTD_compressBound(n); }

// The content size that a zstd payload of `n` bytes declares in its frame
// header: ZSTD_getFrameContentSize's value, so ULLONG_MAX (unknown) and
// ULLONG_MAX - 1 (not a zstd frame) are passed through.
unsigned long long clp_payload_content_size(const uint8_t* payload, size_t n) {
  return ZSTD_getFrameContentSize(payload, n);
}

// Frame one payload. Returns total frame size or 0 on error.
size_t clp_compress_frame(const uint8_t* in, size_t n, uint8_t* out,
                          size_t out_cap, int level) {
  if (out_cap < 8) return 0;
  size_t c = ZSTD_compress(out + 8, out_cap - 8, in, n,
                           level > 0 ? level : kLevel);
  if (ZSTD_isError(c)) return 0;
  std::memcpy(out, kMagic, 4);
  put_le32(out + 4, static_cast<uint32_t>(c));
  return 8 + c;
}

// Parse one framed record. Returns decoded payload size or 0 on error
// (bad magic, truncation, corrupt payload, output too small).
size_t clp_decompress_frame(const uint8_t* in, size_t n, uint8_t* out,
                            size_t out_cap) {
  if (n < 8 || std::memcmp(in, kMagic, 4) != 0) return 0;
  uint32_t c = get_le32(in + 4);
  if (8 + size_t(c) > n) return 0;
  size_t d = ZSTD_decompress(out, out_cap, in + 8, c);
  if (ZSTD_isError(d)) return 0;
  return d;
}

// Batched framing: `count` vectors of `dim` bytes each (contiguous in `in`).
// Frames are written back-to-back into `out`; `offsets[i]`/`sizes[i]` receive
// each frame's position. Reuses one ZSTD_CCtx. Returns total bytes written,
// 0 on error.
size_t clp_compress_batch(const uint8_t* in, size_t count, size_t dim,
                          uint8_t* out, size_t out_cap, size_t* offsets,
                          size_t* sizes, int level) {
  ZSTD_CCtx* ctx = ZSTD_createCCtx();
  if (!ctx) return 0;
  size_t pos = 0;
  for (size_t i = 0; i < count; ++i) {
    if (pos + 8 > out_cap) {
      ZSTD_freeCCtx(ctx);
      return 0;
    }
    size_t c = ZSTD_compressCCtx(ctx, out + pos + 8, out_cap - pos - 8,
                                 in + i * dim, dim, level > 0 ? level : kLevel);
    if (ZSTD_isError(c)) {
      ZSTD_freeCCtx(ctx);
      return 0;
    }
    std::memcpy(out + pos, kMagic, 4);
    put_le32(out + pos + 4, static_cast<uint32_t>(c));
    offsets[i] = pos;
    sizes[i] = 8 + c;
    pos += 8 + c;
  }
  ZSTD_freeCCtx(ctx);
  return pos;
}

// Batched parse of `count` frames located at offsets[i] (sizes[i] bytes) in
// `in`, each decoding to exactly `dim` bytes written at out + i*dim.
// Returns count on success, the index of the first failing record otherwise.
size_t clp_decompress_batch(const uint8_t* in, const size_t* offsets,
                            const size_t* sizes, size_t count, size_t dim,
                            uint8_t* out) {
  ZSTD_DCtx* ctx = ZSTD_createDCtx();
  if (!ctx) return 0;
  for (size_t i = 0; i < count; ++i) {
    const uint8_t* rec = in + offsets[i];
    size_t n = sizes[i];
    if (n < 8 || std::memcmp(rec, kMagic, 4) != 0) {
      ZSTD_freeDCtx(ctx);
      return i;
    }
    uint32_t c = get_le32(rec + 4);
    if (8 + size_t(c) > n) {
      ZSTD_freeDCtx(ctx);
      return i;
    }
    size_t d = ZSTD_decompressDCtx(ctx, out + i * dim, dim, rec + 8, c);
    if (ZSTD_isError(d) || d != dim) {
      ZSTD_freeDCtx(ctx);
      return i;
    }
  }
  ZSTD_freeDCtx(ctx);
  return count;
}

}  // extern "C"
