// Counter-based PRNG for the stochastic kernels (device side).
//
// Counterpart of src/repro/kernels/prng.py and of the port's plain version
// src/repro_torch/kernels/prng.py: a splitmix32-style hash of a uint32
// element counter and a uint32 seed.  uint32_t arithmetic wraps exactly as
// the reference's uint32 jnp ops do, so hash_u32 and uniform give the same
// bits as both Python versions.  gaussian uses logf/cosf/sqrtf (never the
// __logf/__cosf intrinsics, never fast math) and explicit round-to-nearest
// multiplies and adds, so no FMA contraction changes a rounding.
#pragma once

#include <cstdint>

namespace raca {

constexpr uint32_t kGolden = 0x9E3779B9u;
constexpr uint32_t kM1 = 0x7FEB352Du;
constexpr uint32_t kM2 = 0x846CA68Bu;
// f32(2 pi) exactly as the reference rounds it: jnp.float32(2.0 * 3.14159265358979)
constexpr float kTwoPi = static_cast<float>(2.0 * 3.14159265358979);

__device__ __forceinline__ uint32_t hash_u32(uint32_t x, uint32_t seed) {
  x = x + seed * kGolden;
  x = (x ^ (x >> 16)) * kM1;
  x = (x ^ (x >> 15)) * kM2;
  return x ^ (x >> 16);
}

// uint32 bits -> f32 uniform in (0, 1): top 24 bits plus a half ulp.  The
// multiply is by a power of two, so it is exact and the add rounds once.
__device__ __forceinline__ float uniform01(uint32_t bits) {
  return __fadd_rn(__fmul_rn(__uint2float_rn(bits >> 8), 1.0f / 16777216.0f),
                   1.0f / 33554432.0f);
}

__device__ __forceinline__ float uniform(uint32_t idx, uint32_t seed) {
  return uniform01(hash_u32(idx, seed));
}

// Box-Muller over two streams (seed, seed + golden), as the reference.
__device__ __forceinline__ float gaussian(uint32_t idx, uint32_t seed) {
  const float u1 = uniform(idx, seed);
  const float u2 = uniform(idx, seed + kGolden);
  const float r = sqrtf(__fmul_rn(-2.0f, logf(u1)));
  return __fmul_rn(r, cosf(__fmul_rn(kTwoPi, u2)));
}

}  // namespace raca
