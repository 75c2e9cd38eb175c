// WTA sampling under threefry noise for Hopper (sm_90a).
//
// No TPU kernel to replace: the reference computes this in jnp,
// src/repro/core/wta.py:50-83 (wta_trials), which its serving sampler
// (src/repro/launch/specs.py:559-629, sample_tokens) calls once per read
// and token.  Per row n of z (N, C) and trial t, every column c draws
// jax.random.normal at the flat counter t * trial_stride + n * row_stride
// + c under the row's key (keys[n] with folds[n] folded in, in order),
// v = z + sigma * normal; the columns with v > vth0 fire (NaN never does),
// the largest fired v wins the trial, the lowest column on a tie, and the
// winner gets one vote; a trial in which nothing fires gives none.
// counts (N, C) and n_decisions (N,) are f32.
//
// What bounds it on this card: the draw.  One threefry2x32 hash (20
// rounds of add, rotate, xor: ~80 integer instructions) and the erf_inv
// polynomial (log1pf, nine FMAs) per trial and column; the 2-6 bytes per
// element of z read and the counts written are nothing beside it.  The
// design is the simple one: one CTA per (row, trial), its threads
// scanning the row's columns in strides (each keeps its largest fired v,
// the first on a tie), then a warp and a block arg-max, and one atomicAdd
// per trial.  Votes are float adds of 1.0 below 2^24, exact in any order,
// so the counts are deterministic.  Each thread folds the row's key
// itself (at most two hashes), so no host-side key work is needed.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "threefry.cuh"

namespace raca {

constexpr int kMaxThreads = 1024;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) { return __bfloat162float(*p); }

// The row's key after its folds (read index, then step).
__device__ __forceinline__ uint2 row_key(const int64_t* keys, const int64_t* folds, int n_folds,
                                         int row) {
  uint2 key = make_uint2(static_cast<uint32_t>(keys[2 * row]),
                         static_cast<uint32_t>(keys[2 * row + 1]));
  for (int f = 0; f < n_folds; ++f) {
    key = fold_in(key, static_cast<uint32_t>(folds[row * n_folds + f]));
  }
  return key;
}

// (best, col) pairs: the larger voltage wins, the lower column on a tie.
__device__ __forceinline__ void take_better(float& best, int& col, float ob, int oc) {
  if (ob > best || (ob == best && oc < col)) {
    best = ob;
    col = oc;
  }
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
wta_sample_kernel(const T* __restrict__ z, const int64_t* __restrict__ keys,
                  const int64_t* __restrict__ folds, int n_folds, float* __restrict__ counts,
                  float* __restrict__ n_dec, int c, int n_trials, long long trial_stride,
                  long long row_stride, float vth0, float sigma) {
  __shared__ float s_best[kMaxThreads / 32];
  __shared__ int s_col[kMaxThreads / 32];
  const int row = blockIdx.x / n_trials;
  const int t = blockIdx.x - row * n_trials;
  const uint2 key = row_key(keys, folds, n_folds, row);
  const uint64_t base = static_cast<uint64_t>(t) * static_cast<uint64_t>(trial_stride) +
                        static_cast<uint64_t>(row) * static_cast<uint64_t>(row_stride);
  const T* zr = z + static_cast<size_t>(row) * c;
  float best = -__int_as_float(0x7f800000);
  int col = INT_MAX;
  for (int j = threadIdx.x; j < c; j += blockDim.x) {
    const float noise = __fmul_rn(normal_from_bits(threefry_bits(key, base + j)), sigma);
    const float v = __fadd_rn(load_f32(zr + j), noise);
    if (v > vth0 && v > best) {   // columns rise, so the first of equal maxima stays
      best = v;
      col = j;
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    take_better(best, col, __shfl_down_sync(0xffffffffu, best, off),
                __shfl_down_sync(0xffffffffu, col, off));
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    s_best[warp] = best;
    s_col[warp] = col;
  }
  __syncthreads();
  if (warp == 0) {
    const int n_warps = blockDim.x >> 5;
    best = lane < n_warps ? s_best[lane] : -__int_as_float(0x7f800000);
    col = lane < n_warps ? s_col[lane] : INT_MAX;
    for (int off = 16; off > 0; off >>= 1) {
      take_better(best, col, __shfl_down_sync(0xffffffffu, best, off),
                  __shfl_down_sync(0xffffffffu, col, off));
    }
    if (lane == 0 && col != INT_MAX) {
      atomicAdd(counts + static_cast<size_t>(row) * c + col, 1.0f);
      atomicAdd(n_dec + row, 1.0f);
    }
  }
}

// The draw alone, one element a thread, for the card's checks and the
// issue estimate: under one key, for the flat counters start + i
// (i < count), the bits, the uniform, and the voltage z[i] + sigma *
// normal where it fires (else -inf).
__global__ void wta_sample_probe_kernel(const float* __restrict__ z, uint32_t k1, uint32_t k2,
                                        unsigned long long start, int count, float vth0,
                                        float sigma, uint32_t* __restrict__ bits_out,
                                        float* __restrict__ u_out, float* __restrict__ v_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  const uint32_t bits = threefry_bits(make_uint2(k1, k2), start + i);
  const float u = uniform_normal_range(bits);
  const float v = __fadd_rn(z[i], __fmul_rn(__fmul_rn(erf_inv(u), kSqrt2), sigma));
  bits_out[i] = bits;
  u_out[i] = u;
  v_out[i] = v > vth0 ? v : -__int_as_float(0x7f800000);
}

}  // namespace raca

extern "C" {

// z (n, c) f32 or bf16 (z_bf16), keys (n, 2) int64, folds (n, n_folds)
// int64 or null; counts (n, c) and n_dec (n,) f32, zeroed by the caller.
int wta_sample_launch(const void* z, int z_bf16, const int64_t* keys, const int64_t* folds,
                      int n_folds, float* counts, float* n_dec, int n, int c, int n_trials,
                      long long trial_stride, long long row_stride, float vth0, float sigma,
                      cudaStream_t stream) {
  if (n <= 0 || c <= 0 || n_trials <= 0) return 0;
  const long long blocks = static_cast<long long>(n) * n_trials;
  if (blocks >= INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  int threads = ((c + 31) / 32) * 32;
  if (threads > raca::kMaxThreads) threads = raca::kMaxThreads;
  if (z_bf16) {
    raca::wta_sample_kernel<__nv_bfloat16><<<static_cast<int>(blocks), threads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(z), keys, folds, n_folds, counts, n_dec, c, n_trials,
        trial_stride, row_stride, vth0, sigma);
  } else {
    raca::wta_sample_kernel<float><<<static_cast<int>(blocks), threads, 0, stream>>>(
        static_cast<const float*>(z), keys, folds, n_folds, counts, n_dec, c, n_trials,
        trial_stride, row_stride, vth0, sigma);
  }
  return static_cast<int>(cudaGetLastError());
}

int wta_sample_probe(const float* z, unsigned int k1, unsigned int k2, unsigned long long start,
                     int count, float vth0, float sigma, uint32_t* bits, float* u, float* v,
                     cudaStream_t stream) {
  if (count <= 0) return 0;
  raca::wta_sample_probe_kernel<<<(count + 255) / 256, 256, 0, stream>>>(
      z, k1, k2, start, count, vth0, sigma, bits, u, v);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
