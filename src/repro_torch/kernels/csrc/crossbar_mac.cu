// The RACA crossbar read, for Hopper (sm_90a): quantize the weights onto
// the conductance grid, multiply, add thermal noise, then read out through
// the comparator or linearly.
//
// Replaces the TPU kernel crossbar_mac_pallas
// (src/repro/kernels/crossbar_mac.py): out = (z + noise > 0) or z + noise,
// z = x @ Wq, Wq = round((clip(W) - w_min) * (1/qstep)) * qstep + w_min
// (round half to even), noise = sigma * gaussian(row * n_padded + col,
// seed).  n_padded is N rounded up to 128, the width the TPU kernel's
// counter runs over, so odd N draws the TPU's noise.  sigma is a device
// scalar (the calibrated read: 1.702 / (beta * s) or linear_sigma) or,
// with the physical noise model, each column's Johnson noise
// sqrt(4kT df * (g0 * sum_k Wq + 2 * k_rows * g_ref)) / (v_read * g0).
//
// What bounds it on this card: operations.  2*M*K*N f32 FMAs on the CUDA
// cores (no TF32, no wgmma: whether a TF32 product keeps the comparator's
// decisions is open), against (M*K + K*N + M*N) * 4 bytes; at the training
// shapes (M = 1024, K and N in {2560, 6912}) the FMAs take 10x longer than
// the bytes at the card's peak rates.
//
// Design: one 256-thread block per 128 x 128 output tile, walking K in
// steps of 8 through double-buffered shared-memory tiles of x (stored
// transposed) and Wq.  W is quantized once, as its tile is staged, so no
// quantized or padded copy of W (or x) exists in device memory; rows past
// K and columns past N are staged as zeros.  The next tile's global loads
// are in registers while the current one is multiplied.  Each thread
// accumulates an 8 x 8 register block with f32 FMAs in ascending k order.
// The epilogue adds the noise, applies the comparator and stores: z never
// leaves the registers.  With the physical noise model, 128 threads also
// sum their column of Wq in ascending k order while the tile is in
// shared memory.
//
// Exactness against the plain version (kernels/ref.py:crossbar_mac_ref):
// the quantizer and the epilogue use explicit __fmul_rn / __fadd_rn (nvcc
// would contract them into FMAs) and the host's f32 rounding of 1/qstep,
// so Wq and the noise are bit-identical; z differs only by the order of
// the f32 sum.
#include <cuda_runtime.h>

#include <cstdint>

#include "prng.cuh"

namespace raca {

constexpr int kBM = 128, kBN = 128, kBK = 8, kCbThreads = 256;

struct QuantParams {
  int quantize;
  float qstep, inv_qstep, w_min, w_max;
};

__device__ __forceinline__ float quantize_w(float w, const QuantParams& q) {
  const float c = fminf(fmaxf(w, q.w_min), q.w_max);
  const float level = rintf(__fmul_rn(__fsub_rn(c, q.w_min), q.inv_qstep));
  return __fadd_rn(__fmul_rn(level, q.qstep), q.w_min);
}

template <bool kVec>
__global__ void __launch_bounds__(kCbThreads, 2) crossbar_mac_kernel(
    const float* __restrict__ x, const float* __restrict__ w,
    const float* __restrict__ sigma_ptr, float* __restrict__ out, int M, int K,
    int N, uint32_t n_padded, uint32_t seed, int binarize, int physical,
    QuantParams qp, float c_g0, float c_ref, float c_ktdf, float c_vg) {
  __shared__ __align__(16) float As[2][kBK][kBM];
  __shared__ __align__(16) float Bs[2][kBK][kBN];
  __shared__ float sigma_s[kBN];

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  // loaders: x row lm, k columns lk..lk+3; W row wk, columns wn..wn+3
  const int lm = tid >> 1, lk = (tid & 1) * 4;
  const int wk = tid >> 5, wn = (tid & 31) * 4;

  float xr[4], wr[4];
  auto load = [&](int k0) {
    const int gm = m0 + lm, gk = k0 + lk;
    const int hk = k0 + wk, hn = n0 + wn;
    if (kVec) {  // K % 4 == 0 and N % 4 == 0: a 4-vector lies wholly in or out
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
      if (gm < M && gk < K)
        a = *reinterpret_cast<const float4*>(x + static_cast<size_t>(gm) * K + gk);
      if (hk < K && hn < N)
        b = *reinterpret_cast<const float4*>(w + static_cast<size_t>(hk) * N + hn);
      xr[0] = a.x; xr[1] = a.y; xr[2] = a.z; xr[3] = a.w;
      wr[0] = b.x; wr[1] = b.y; wr[2] = b.z; wr[3] = b.w;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        xr[i] = (gm < M && gk + i < K) ? x[static_cast<size_t>(gm) * K + gk + i] : 0.f;
        wr[i] = (hk < K && hn + i < N) ? w[static_cast<size_t>(hk) * N + hn + i] : 0.f;
      }
    }
  };
  // stage the loaded registers into buffer buf, quantizing W; rows past K
  // and columns past N stay zero (the grid's level nearest 0 is not 0)
  auto stage = [&](int buf, int k0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) As[buf][lk + i][lm] = xr[i];
    const bool row_ok = k0 + wk < K;
    float q[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bool ok = row_ok && n0 + wn + i < N;
      q[i] = !ok ? 0.f : (qp.quantize ? quantize_w(wr[i], qp) : wr[i]);
    }
    *reinterpret_cast<float4*>(&Bs[buf][wk][wn]) = make_float4(q[0], q[1], q[2], q[3]);
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  float colsum = 0.f;  // thread tid < kBN: sum of Wq over k in column n0 + tid

  const int nk = (K + kBK - 1) / kBK;
  load(0);
  stage(0, 0);
  __syncthreads();
  for (int t = 0; t < nk; ++t) {
    const int buf = t & 1;
    if (t + 1 < nk) load((t + 1) * kBK);
    if (physical && tid < kBN) {
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk) colsum = __fadd_rn(colsum, Bs[buf][kk][tid]);
    }
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[buf][kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[buf][kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[buf][kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[buf][kk][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = __fmaf_rn(a[i], b[j], acc[i][j]);
    }
    if (t + 1 < nk) stage(buf ^ 1, (t + 1) * kBK);
    __syncthreads();
  }

  // per-column sigma: the device scalar, or the column's Johnson noise
  if (tid < kBN) {
    sigma_s[tid] = physical
        ? __fdiv_rn(sqrtf(__fmul_rn(c_ktdf, __fadd_rn(__fmul_rn(c_g0, colsum), c_ref))), c_vg)
        : *sigma_ptr;
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (row >= M) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int c0 = half * 64 + tx * 4;
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t gidx = static_cast<uint32_t>(row) * n_padded +
                              static_cast<uint32_t>(n0 + c0 + j);
        const float noise = __fmul_rn(gaussian(gidx, seed), sigma_s[c0 + j]);
        const float s = __fadd_rn(acc[i][half * 4 + j], noise);
        v[j] = binarize ? (s > 0.f ? 1.f : 0.f) : s;
      }
      float* dst = out + static_cast<size_t>(row) * N + n0 + c0;
      if (kVec && n0 + c0 + 3 < N) {
        *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (n0 + c0 + j < N) dst[j] = v[j];
      }
    }
  }
}

}  // namespace raca

// Plain C entry point for ctypes: x (m, k), w (k, n) and out (m, n) are
// f32, contiguous; sigma is one f32 on the device (read unless physical).
// The physical-noise constants arrive rounded to f32 as the reference's
// weakly typed Python floats round: c_g0 = g0, c_ref = 2 * k_rows * g_ref,
// c_ktdf = 4 k T df, c_vg = v_read * g0.  Returns cudaGetLastError().
extern "C" int crossbar_mac_launch(const float* x, const float* w,
                                   const float* sigma, float* out, int m,
                                   int k, int n, int n_padded, unsigned seed,
                                   int binarize, int physical, int quantize,
                                   float qstep, float inv_qstep, float w_min,
                                   float w_max, float c_g0, float c_ref,
                                   float c_ktdf, float c_vg, void* stream) {
  using namespace raca;
  if (m == 0 || n == 0) return 0;
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  const QuantParams qp{quantize, qstep, inv_qstep, w_min, w_max};
  const auto aligned = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
  };
  const bool vec = k % 4 == 0 && n % 4 == 0 && aligned(x) && aligned(w) && aligned(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec) {
    crossbar_mac_kernel<true><<<grid, kCbThreads, 0, s>>>(
        x, w, sigma, out, m, k, n, static_cast<uint32_t>(n_padded), seed,
        binarize, physical, qp, c_g0, c_ref, c_ktdf, c_vg);
  } else {
    crossbar_mac_kernel<false><<<grid, kCbThreads, 0, s>>>(
        x, w, sigma, out, m, k, n, static_cast<uint32_t>(n_padded), seed,
        binarize, physical, qp, c_g0, c_ref, c_ktdf, c_vg);
  }
  return static_cast<int>(cudaGetLastError());
}
