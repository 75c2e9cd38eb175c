// Winner-take-all vote counts for Hopper (sm_90a).
//
// Replaces the TPU kernel wta_counts_pallas
// (src/repro/kernels/wta_kernel.py), the paper's binary stochastic SoftMax
// (§III-B): per row of z (B, C) and trial t, v = z + sigma * gaussian(idx),
// idx = row * c_pad + col + t * trial_stride (uint32, wrapping); the
// neurons with v > vth0 fire, every fired neuron equal to the row's fired
// maximum wins the trial (exact ties split the vote), and counts[row, col]
// adds one per win.  Columns past C (the reference's padding) never fire,
// so they are never visited.
//
// The TPU kernel keeps a (128, C) block in VMEM and loops over trials.  At
// the full vocabulary (C = 50304) one row does not fit a thread block's
// registers, and a loop over trials inside one block per row would leave
// most SMs idle at a serving batch of 8.  So one block runs one (row,
// trial) pair: each thread draws v for its strided columns, keeps its own
// fired maximum and where it lies, and a block reduction gives the row's
// maximum.  The thread whose maximum equals it adds one vote with an
// atomic add (float adds of 1.0 below 2^24 are exact in any order, so the
// counts are deterministic); only if that thread saw an exact tie within
// its own columns does it draw its columns again to find every winner.
//
// What bounds it on this card: the three transcendentals per trial and
// element (logf, sqrtf, cosf) on the special function units, not the
// 8 bytes per element of z and counts.  Bit-exactness with the plain
// version: explicit __fmul_rn/__fadd_rn (no FMA contraction), logf/cosf
// rather than fast intrinsics.
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "prng.cuh"

namespace raca {

constexpr int kWtaThreads = 256;

__device__ __forceinline__ float wta_voltage(const float* zr, int col,
                                             uint32_t base, uint32_t seed,
                                             float sigma) {
  const float g = gaussian(base + static_cast<uint32_t>(col), seed);
  return __fadd_rn(zr[col], __fmul_rn(g, sigma));
}

__global__ void __launch_bounds__(kWtaThreads) wta_counts_kernel(
    const float* __restrict__ z, const int64_t* __restrict__ seed_p,
    float* __restrict__ counts, int C, uint32_t c_pad, uint32_t trial_stride,
    float vth0, float sigma) {
  __shared__ float warp_max[kWtaThreads / 32];
  const int row = blockIdx.x;
  const uint32_t t = blockIdx.y;
  const uint32_t seed = static_cast<uint32_t>(seed_p[0]);
  const uint32_t base = static_cast<uint32_t>(row) * c_pad + t * trial_stride;
  const float* zr = z + static_cast<int64_t>(row) * C;
  float best = -INFINITY;
  int best_col = -1;
  bool dup = false;
  for (int c = threadIdx.x; c < C; c += kWtaThreads) {
    const float v = wta_voltage(zr, c, base, seed, sigma);
    if (v > vth0) {
      if (v > best) {
        best = v;
        best_col = c;
        dup = false;
      } else if (v == best) {
        dup = true;
      }
    }
  }
  float m = best;
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  float vmax = warp_max[0];
  for (int w = 1; w < kWtaThreads / 32; ++w) vmax = fmaxf(vmax, warp_max[w]);
  if (best_col < 0 || best != vmax) return;  // nothing fired, or not here
  float* cr = counts + static_cast<int64_t>(row) * C;
  if (!dup) {
    atomicAdd(cr + best_col, 1.0f);
    return;
  }
  for (int c = threadIdx.x; c < C; c += kWtaThreads) {
    const float v = wta_voltage(zr, c, base, seed, sigma);
    if (v > vth0 && v == vmax) atomicAdd(cr + c, 1.0f);
  }
}

}  // namespace raca

// Plain C entry point for ctypes: z and counts are (b, c) f32, contiguous,
// counts zeroed by the caller; seed points at one int64 holding a uint32.
// Returns cudaGetLastError().
extern "C" int wta_counts_launch(const float* z, const int64_t* seed,
                                 float* counts, int b, int c, int c_pad,
                                 unsigned trial_stride, int n_trials,
                                 float vth0, float sigma, void* stream) {
  using namespace raca;
  if (b == 0 || c == 0 || n_trials == 0) return 0;
  dim3 grid(b, n_trials);
  wta_counts_kernel<<<grid, kWtaThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      z, seed, counts, c, static_cast<uint32_t>(c_pad), trial_stride, vth0,
      sigma);
  return static_cast<int>(cudaGetLastError());
}
