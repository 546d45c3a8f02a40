// The int8 activation codes of the serving path, shared by the kernels that
// make them: int8_conv.cu (int8_quantize and the act form of the conv) and
// groupnorm_silu.cu (K1's codes-out form). One definition, so every
// producer writes the same codes for the same value and scale:
//
//   s = max(absmax, 1e-12) / 127 (IEEE divide), code = clamp(rint(x / s), -127, 127)
//
// which is ops/int8.py's quantize_plain (torch.round is half to even, as rint).
// code() is that definition; the kernels compute it as exact_code_bits (one
// algorithm for every producer), through codes8, and take code() itself only
// at a scale exact_code_bits does not hold at (Scale::ok).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace int8_codes {

__device__ __forceinline__ float act_scale(const float* absmax) {
  return __fdiv_rn(fmaxf(*absmax, 1e-12f), 127.0f);
}

__device__ __forceinline__ int8_t code(float x, float s) {
  return static_cast<int8_t>(fminf(fmaxf(rintf(__fdiv_rn(x, s)), -127.0f), 127.0f));
}

__device__ __forceinline__ uint32_t pack4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040), 0x5410);
}

// code(x, s) with no division and no fallback, from r = 1 / s correctly
// rounded (__frcp_rn) and lim = 127 s rounded: x is clamped to [-lim, lim]
// (past lim, x / s > 127 (1 - 2^-24), and so is the quotient of lim, which
// rounds to 127: the clamped code; NaN goes to -lim, so -127, as in code());
// q0 = RN(x r) lies within an ulp of x / s, the residual x - q0 s is exact in
// one fma, and one more fma, q0 + (x - q0 s) r, gives RN(x / s) itself
// (Markstein's correction: r within half an ulp of 1 / s, q0 within one ulp of
// x / s, no underflow, which holds wherever |x / s| >= 1/4 since s >= 2^-47;
// below 1/4 the code is 0 either way). So ties of x / s are seen exactly.
// Adding 1.5 * 2^23 rounds the quotient, now within [-127.5, 127.5), to an
// integer, ties to even as rintf; the low byte of the sum's bits is the code.
// Per value: 6 FP32-pipe instructions, none on the conversion unit, the same
// on every input (an IEEE divide is a subroutine with a slow path).
__device__ __forceinline__ uint32_t exact_code_bits(float x, float s, float r, float lim) {
  x = fminf(fmaxf(x, -lim), lim);
  const float q0 = __fmul_rn(x, r);
  return __float_as_uint(__fadd_rn(__fmaf_rn(__fmaf_rn(-q0, s, x), r, q0), 12582912.0f));
}

// A scale s and what exact_code_bits takes from it: r = 1 / s correctly
// rounded and lim = 127 s rounded. `ok` says whether it holds there: s is at
// least act_scale's 1e-12 / 127 > 2^-47 (fmaxf drops a NaN absmax), and lim
// is finite unless absmax lies within a hair of FLT_MAX (or is inf); where
// it is false the caller codes every value through code(). No calibrated
// scale takes that branch, and it is uniform over the launch.
struct Scale {
  float s, r, lim;
  bool ok;
};

__device__ __forceinline__ Scale scale_of(float s) {
  Scale q;
  q.s = s;
  q.r = __frcp_rn(s);
  q.lim = __fmul_rn(127.0f, s);
  q.ok = s >= 0x1p-47f && q.lim <= 3.4028235e38f;
  return q;
}

// code() for 8 values, packed as codes8 packs them (out of line: no
// calibrated scale takes it).
static __device__ __noinline__ uint2 divided_codes8(float4 lo, float4 hi, float s) {
  auto c = [&](float v) { return static_cast<uint32_t>(static_cast<int>(code(v, s))); };
  return make_uint2(pack4(c(lo.x), c(lo.y), c(lo.z), c(lo.w)), pack4(c(hi.x), c(hi.y), c(hi.z), c(hi.w)));
}

// The codes of 8 values, packed little-endian into two words.
__device__ __forceinline__ uint2 codes8(const float v[8], const Scale& q) {
  if (!q.ok) return divided_codes8(make_float4(v[0], v[1], v[2], v[3]), make_float4(v[4], v[5], v[6], v[7]), q.s);
  uint32_t b[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) b[e] = exact_code_bits(v[e], q.s, q.r, q.lim);
  return make_uint2(pack4(b[0], b[1], b[2], b[3]), pack4(b[4], b[5], b[6], b[7]));
}

}  // namespace int8_codes
