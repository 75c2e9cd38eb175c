// jax's threefry2x32 PRNG and its f32 uniform and normal draws (device side).
//
// Counterpart of src/repro_torch/random.py, bit for bit on the bits and the
// uniforms: jax's default PRNG with jax_threefry_partitionable, where a
// key is two uint32 words, fold_in(key, d) hashes the counter pair (0, d),
// and the draw at flat index i hashes (hi(i), lo(i)) and keeps the xor of
// the two output words.  normal is jax.random.normal in f32:
// sqrt(2) * erf_inv(u) for u uniform on [nextafter(-1, 0), 1), with XLA's
// erf_inv (Giles' single-precision polynomial, each Horner step one fused
// multiply-add).  No fast-math intrinsics: every multiply, add and square
// root rounds to nearest as written (__fmul_rn, __fadd_rn, __fmaf_rn,
// __fsqrt_rn), so the compiler contracts nothing; log1pf is CUDA's
// accurate log1pf, the one source that may differ from XLA's log1p on the
// CPU by an ulp or two.
#pragma once

#include <cstdint>

namespace raca {

constexpr uint32_t kThreefryParity = 0x1BD11BDAu;

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// The threefry2x32 block function, 20 rounds.
__device__ __forceinline__ uint2 threefry2x32(uint32_t k1, uint32_t k2, uint32_t x1,
                                              uint32_t x2) {
  const uint32_t k3 = k1 ^ k2 ^ kThreefryParity;
  x1 += k1;
  x2 += k2;
#define RACA_TF_ROUND(r) \
  x1 += x2;              \
  x2 = rotl32(x2, r) ^ x1;
#define RACA_TF_EVEN RACA_TF_ROUND(13) RACA_TF_ROUND(15) RACA_TF_ROUND(26) RACA_TF_ROUND(6)
#define RACA_TF_ODD RACA_TF_ROUND(17) RACA_TF_ROUND(29) RACA_TF_ROUND(16) RACA_TF_ROUND(24)
  RACA_TF_EVEN x1 += k2; x2 += k3 + 1u;
  RACA_TF_ODD  x1 += k3; x2 += k1 + 2u;
  RACA_TF_EVEN x1 += k1; x2 += k2 + 3u;
  RACA_TF_ODD  x1 += k2; x2 += k3 + 4u;
  RACA_TF_EVEN x1 += k3; x2 += k1 + 5u;
#undef RACA_TF_EVEN
#undef RACA_TF_ODD
#undef RACA_TF_ROUND
  return make_uint2(x1, x2);
}

// jax.random.fold_in(key, d).
__device__ __forceinline__ uint2 fold_in(uint2 key, uint32_t d) {
  return threefry2x32(key.x, key.y, 0u, d);
}

// jax.random.bits at flat index idx (64 bits: the high word is hashed too).
__device__ __forceinline__ uint32_t threefry_bits(uint2 key, uint64_t idx) {
  const uint2 b = threefry2x32(key.x, key.y, static_cast<uint32_t>(idx >> 32),
                               static_cast<uint32_t>(idx));
  return b.x ^ b.y;
}

// jax.random.uniform(key, shape) in f32 (minval 0, maxval 1) of one draw's
// bits: the top 23 bits as a float in [1, 2), minus 1 (exact).
__device__ __forceinline__ float uniform_unit(uint32_t bits) {
  return __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u), 1.0f);
}

// f32(nextafter(-1, 0)) and f32(sqrt(2))
constexpr float kNormalLo = -0.99999994039535522461f;
constexpr float kSqrt2 = 1.41421353816986083984f;

// jax.random.uniform(lo = nextafter(-1, 0), hi = 1) of one draw's bits: the
// top 23 bits as a float in [1, 2), minus 1, times the span f32(1 - lo) =
// 2 (exact), plus lo, rounded once; no less than lo.
__device__ __forceinline__ float uniform_normal_range(uint32_t bits) {
  const float f = __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u), 1.0f);
  return fmaxf(__fmaf_rn(f, 2.0f, kNormalLo), kNormalLo);
}

// XLA's f32 erf_inv: w = -log1p(-x*x); below 5 a polynomial in w - 2.5,
// else in sqrt(w) - 3; +-inf at +-1 and NaN beyond.
__device__ __forceinline__ float erf_inv(float x) {
  float w = -log1pf(-__fmul_rn(x, x));
  float p;
  if (w < 5.0f) {
    w = __fsub_rn(w, 2.5f);
    p = 2.81022636e-08f;
    p = __fmaf_rn(p, w, 3.43273939e-07f);
    p = __fmaf_rn(p, w, -3.5233877e-06f);
    p = __fmaf_rn(p, w, -4.39150654e-06f);
    p = __fmaf_rn(p, w, 0.00021858087f);
    p = __fmaf_rn(p, w, -0.00125372503f);
    p = __fmaf_rn(p, w, -0.00417768164f);
    p = __fmaf_rn(p, w, 0.246640727f);
    p = __fmaf_rn(p, w, 1.50140941f);
  } else {
    w = __fsub_rn(__fsqrt_rn(w), 3.0f);
    p = -0.000200214257f;
    p = __fmaf_rn(p, w, 0.000100950558f);
    p = __fmaf_rn(p, w, 0.00134934322f);
    p = __fmaf_rn(p, w, -0.00367342844f);
    p = __fmaf_rn(p, w, 0.00573950773f);
    p = __fmaf_rn(p, w, -0.0076224613f);
    p = __fmaf_rn(p, w, 0.00943887047f);
    p = __fmaf_rn(p, w, 1.00167406f);
    p = __fmaf_rn(p, w, 2.83297682f);
  }
  return fabsf(x) == 1.0f ? __fmul_rn(x, __int_as_float(0x7f800000)) : __fmul_rn(p, x);
}

// jax.random.normal in f32 from one draw's bits.
__device__ __forceinline__ float normal_from_bits(uint32_t bits) {
  return __fmul_rn(erf_inv(uniform_normal_range(bits)), kSqrt2);
}

}  // namespace raca
