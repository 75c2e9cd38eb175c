// Stochastic rounding onto the grid {lo + k*step} within [lo, hi], for
// Hopper (sm_90a).
//
// Replaces the TPU kernel stoch_round_pallas
// (src/repro/kernels/stoch_round.py): clip, t = (x - lo) * (1/step),
// q = floor(t) + [uniform(row * n_padded + col, seed) < t - floor(t)],
// out = q * step + lo.  The counter uses the width the reference pads to
// (n_padded) without materialising the padding.  Rows fall into equal
// groups of rows_per_seed rows; group g draws under seeds[g] and its
// counter restarts at row 0, so one launch covers every block of a prefill
// chunk exactly as the reference's per-block calls do.  Seeds are read
// from device memory (int64 holding uint32 values), as the TPU kernel
// reads its seed from SMEM, so the caller never syncs with the host.
//
// Bit-exactness with the plain version: inv_step arrives as the f32
// rounding of the host's double 1/step (never 1.0f/step on the device),
// and every multiply and add is an explicit __fmul_rn/__fadd_rn, so nvcc's
// default FMA contraction cannot fuse q*step + lo.
//
// What bounds it on this card: bytes, 4 read and 4 written per element;
// the hash is a dozen integer operations.  One thread per element,
// neighbouring threads on neighbouring addresses.  The serving path then
// casts to int8 and scatters in further launches; a fused
// quantize-and-scatter kernel is later work.
#include <cuda_runtime.h>

#include <cstdint>

#include "prng.cuh"

namespace raca {

constexpr int kSrThreads = 256;

__global__ void __launch_bounds__(kSrThreads) stoch_round_kernel(
    const float* __restrict__ x, const int64_t* __restrict__ seeds,
    float* __restrict__ out, int64_t total, int n, uint32_t n_padded,
    int rows_per_seed, float step, float inv_step, float lo, float hi) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kSrThreads + threadIdx.x;
  if (i >= total) return;
  const int64_t row = i / n;
  const int col = static_cast<int>(i - row * n);
  const int64_t group = row / rows_per_seed;
  const uint32_t r = static_cast<uint32_t>(row - group * rows_per_seed);
  const uint32_t seed = static_cast<uint32_t>(seeds[group]);
  const float xc = fminf(fmaxf(x[i], lo), hi);
  const float t = __fmul_rn(__fsub_rn(xc, lo), inv_step);
  const float fl = floorf(t);
  const float frac = __fsub_rn(t, fl);
  const float u = uniform(r * n_padded + static_cast<uint32_t>(col), seed);
  const float q = __fadd_rn(fl, u < frac ? 1.0f : 0.0f);
  out[i] = __fadd_rn(__fmul_rn(q, step), lo);
}

}  // namespace raca

// Plain C entry point for ctypes: x and out are (m, n) f32, contiguous;
// seeds holds m / rows_per_seed values.  Returns cudaGetLastError().
extern "C" int stoch_round_launch(const float* x, const int64_t* seeds,
                                  float* out, int m, int n, int n_padded,
                                  int rows_per_seed, float step,
                                  float inv_step, float lo, float hi,
                                  void* stream) {
  using namespace raca;
  const int64_t total = static_cast<int64_t>(m) * n;
  if (total == 0) return 0;
  const int64_t blocks = (total + kSrThreads - 1) / kSrThreads;
  stoch_round_kernel<<<static_cast<unsigned>(blocks), kSrThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      x, seeds, out, total, n, static_cast<uint32_t>(n_padded), rows_per_seed,
      step, inv_step, lo, hi);
  return static_cast<int>(cudaGetLastError());
}
