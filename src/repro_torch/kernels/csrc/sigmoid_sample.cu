// Binary stochastic Sigmoid neurons under threefry noise for Hopper (sm_90a).
//
// No TPU kernel to replace: the reference computes this in jnp,
// src/repro/core/neurons.py:52-84 (stochastic_binarize of
// sigmoid_neuron_calibrated), which analog_dense's bias-folded branch
// (src/repro/core/analog.py:150-160) runs for every hidden layer of the
// paper's FCNN, once per layer and vote in fcnn_predict_raca
// (src/repro/models/fcnn.py:81-114).  Per element i = m * N + n of acc
// (M, N), the product x @ Wq:
//
//   z = acc[i] + b[n]                  the bias folded before the comparator
//   p = 1 / (1 + expf(-(beta * z)))     torch.sigmoid's form on the card
//   u = uniform(bits(offset + i))      jax.random.uniform(key, (M, N))
//   y = u < p ? 1 : 0
//
// Every step rounds as written (__fadd_rn, __fmul_rn, __fdiv_rn, CUDA's
// accurate expf; no fast math), so the plain version
// (ref.sigmoid_sample_ref: torch.sigmoid(beta * (acc + b)), threefry from
// repro_torch/random.py) gives the same bits, uniforms and decisions.
//
// What bounds it on this card: the hash.  threefry2x32 is ~80 integer
// instructions an element on the 16-lane ALU, against 8 bytes of device
// memory (acc read, y written; b stays in L1): at (1024, 500) the bytes
// take ~1.2 us at 3.35 TB/s and the instructions a few us.  The design is
// the simple one: one thread an element, 256 threads a block, neighbouring
// threads on neighbouring f32s, no shared memory, one launch a layer.
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "threefry.cuh"

namespace raca {

constexpr int kThreads = 256;

struct Sample {
  uint32_t bits;
  float u, p, y;
};

__device__ __forceinline__ Sample sample_one(const float* __restrict__ acc,
                                             const float* __restrict__ b, int i, int n,
                                             float beta, uint2 key, unsigned long long offset) {
  const float z = b != nullptr ? __fadd_rn(acc[i], b[i % n]) : acc[i];
  const float x = __fmul_rn(beta, z);
  const float p = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-x)));
  const uint32_t bits = threefry_bits(key, offset + static_cast<unsigned long long>(i));
  const float u = uniform_unit(bits);
  return {bits, u, p, u < p ? 1.0f : 0.0f};
}

__global__ void __launch_bounds__(kThreads)
sigmoid_sample_kernel(const float* __restrict__ acc, const float* __restrict__ b,
                      float* __restrict__ y, int total, int n, float beta, uint32_t k1,
                      uint32_t k2, unsigned long long offset) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= total) return;
  y[i] = sample_one(acc, b, i, n, beta, make_uint2(k1, k2), offset).y;
}

// The same draw with its pieces written out, for the card's checks.
__global__ void __launch_bounds__(kThreads)
sigmoid_sample_probe_kernel(const float* __restrict__ acc, const float* __restrict__ b,
                            int total, int n, float beta, uint32_t k1, uint32_t k2,
                            unsigned long long offset, uint32_t* __restrict__ bits_out,
                            float* __restrict__ u_out, float* __restrict__ p_out,
                            float* __restrict__ y_out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= total) return;
  const Sample s = sample_one(acc, b, i, n, beta, make_uint2(k1, k2), offset);
  bits_out[i] = s.bits;
  u_out[i] = s.u;
  p_out[i] = s.p;
  y_out[i] = s.y;
}

}  // namespace raca

extern "C" {

// acc (m, n) f32, b (n,) f32 or null, y (m, n) f32; m * n < 2^31.
int sigmoid_sample_launch(const float* acc, const float* b, float* y, int m, int n, float beta,
                          unsigned int k1, unsigned int k2, unsigned long long offset,
                          cudaStream_t stream) {
  const long long total = static_cast<long long>(m) * n;
  if (total <= 0) return 0;
  if (total >= INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = static_cast<int>((total + raca::kThreads - 1) / raca::kThreads);
  raca::sigmoid_sample_kernel<<<blocks, raca::kThreads, 0, stream>>>(
      acc, b, y, static_cast<int>(total), n, beta, k1, k2, offset);
  return static_cast<int>(cudaGetLastError());
}

int sigmoid_sample_probe(const float* acc, const float* b, int m, int n, float beta,
                         unsigned int k1, unsigned int k2, unsigned long long offset,
                         uint32_t* bits, float* u, float* p, float* y, cudaStream_t stream) {
  const long long total = static_cast<long long>(m) * n;
  if (total <= 0) return 0;
  if (total >= INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = static_cast<int>((total + raca::kThreads - 1) / raca::kThreads);
  raca::sigmoid_sample_probe_kernel<<<blocks, raca::kThreads, 0, stream>>>(
      acc, b, static_cast<int>(total), n, beta, k1, k2, offset, bits, u, p, y);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
