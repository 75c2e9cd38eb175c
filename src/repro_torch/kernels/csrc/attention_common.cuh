// Shared body of the paged decode and chunked-prefill attention kernels.
//
// One thread block attends a tile of R query rows that all read the same
// kv head, page by page through a block-table row.  The online-softmax
// state (running max m, denominator l, accumulator acc) lives in shared
// memory across the loop over pages, which on Hopper takes the place of
// the TPU kernels' sequential grid axis carrying VMEM scratch.
//
// Pages are read in their stored type (f32, bf16, or int8 codes with f32
// scale planes) and converted to f32 in shared memory; all arithmetic is
// f32.  Masking follows the reference: key position w*bs+t is visible to a
// query at absolute position p iff t_abs <= p and, for a local window,
// t_abs > p - local_window.  Masked scores are the finite NEG_INF of the
// reference, so a row whose first visited page is fully masked carries
// weight-1 garbage only until its first visible key, whose alpha of
// exp(NEG_INF - m) = 0 wipes it (the reference's behaviour exactly).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace raca {

constexpr float NEG_INF = -2.0e38f;
constexpr int kThreads = 128;

enum DType : int { kF32 = 0, kBF16 = 1, kI8 = 2 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }

// Shared-memory floats the tile needs for R rows.
__host__ __device__ inline int smem_floats(int R, int bs, int dh) {
  return R * dh          // q rows, pre-scaled by dh^-0.5
       + R * dh          // acc
       + bs * (dh + 1)   // K page (padded row stride)
       + bs * dh         // V page
       + R * bs          // scores, then probabilities
       + 3 * R           // m, l, alpha
       + 2 * bs;         // k_scale/127, v_scale/127 of the page
}

// Attend R query rows (row i at absolute position pos0 + i*pos_step) over
// pages table[w_lo..w_hi) of kv head kh.  Rows i >= n_valid are padding:
// computed on zeros, never stored.
template <typename TQ, typename TKV>
__device__ void attend_rows(
    const TQ* __restrict__ q, int64_t q_row_stride, int R, int n_valid,
    int pos0, int pos_step,
    const TKV* __restrict__ kp, const TKV* __restrict__ vp,
    const float* __restrict__ ks, const float* __restrict__ vs,
    const int* __restrict__ table, int w_lo, int w_hi,
    int bs, int hkv, int kh, int dh,
    int local, int local_window, float softcap,
    float* __restrict__ out, int64_t out_row_stride, float* smem) {
  const bool int8 = ks != nullptr;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  float* q_s = smem;
  float* acc = q_s + R * dh;
  float* k_s = acc + R * dh;
  float* v_s = k_s + bs * (dh + 1);
  float* s_s = v_s + bs * dh;
  float* m_s = s_s + R * bs;
  float* l_s = m_s + R;
  float* a_s = l_s + R;
  float* ksc = a_s + R;
  float* vsc = ksc + bs;

  const float scale = 1.f / sqrtf(static_cast<float>(dh));
  for (int idx = tid; idx < R * dh; idx += nt) {
    int i = idx / dh, d = idx - i * dh;
    q_s[idx] = i < n_valid ? to_f32(q[i * q_row_stride + d]) * scale : 0.f;
    acc[idx] = 0.f;
  }
  for (int i = tid; i < R; i += nt) {
    m_s[i] = NEG_INF;
    l_s[i] = 0.f;
  }
  __syncthreads();

  for (int w = w_lo; w < w_hi; ++w) {
    int page = table[w];
    page = page < 0 ? 0 : page;  // unassigned ids read the trash page
    const int64_t base = (static_cast<int64_t>(page) * bs * hkv + kh) * dh;
    for (int idx = tid; idx < bs * dh; idx += nt) {
      int t = idx / dh, d = idx - t * dh;
      int64_t off = base + static_cast<int64_t>(t) * hkv * dh + d;
      k_s[t * (dh + 1) + d] = to_f32(kp[off]);
      v_s[t * dh + d] = to_f32(vp[off]);
    }
    if (int8) {
      for (int t = tid; t < bs; t += nt) {
        int64_t off = (static_cast<int64_t>(page) * bs + t) * hkv + kh;
        ksc[t] = ks[off] / 127.f;
        vsc[t] = vs[off] / 127.f;
      }
    }
    __syncthreads();

    for (int idx = tid; idx < R * bs; idx += nt) {
      int i = idx / bs, t = idx - i * bs;
      const float* qi = q_s + i * dh;
      const float* kt = k_s + t * (dh + 1);
      float dot = 0.f;
      for (int d = 0; d < dh; ++d) dot = fmaf(qi[d], kt[d], dot);
      if (int8) dot *= ksc[t];
      if (softcap > 0.f) dot = tanhf(dot / softcap) * softcap;
      int kpos = w * bs + t;
      int qpos = pos0 + i * pos_step;
      bool ok = kpos <= qpos;
      if (local) ok = ok && kpos > qpos - local_window;
      s_s[idx] = ok ? dot : NEG_INF;
    }
    __syncthreads();

    for (int i = tid; i < R; i += nt) {
      float* si = s_s + i * bs;
      float m_prev = m_s[i];
      float mx = m_prev;
      for (int t = 0; t < bs; ++t) mx = fmaxf(mx, si[t]);
      float alpha = expf(m_prev - mx);
      float sum = 0.f;
      for (int t = 0; t < bs; ++t) {
        float p = expf(si[t] - mx);
        sum += p;  // the denominator keeps the unscaled weights
        si[t] = int8 ? p * vsc[t] : p;
      }
      l_s[i] = l_s[i] * alpha + sum;
      m_s[i] = mx;
      a_s[i] = alpha;
    }
    __syncthreads();

    for (int idx = tid; idx < R * dh; idx += nt) {
      int i = idx / dh, d = idx - i * dh;
      const float* pi = s_s + i * bs;
      float a = acc[idx] * a_s[i];
      for (int t = 0; t < bs; ++t) a = fmaf(pi[t], v_s[t * dh + d], a);
      acc[idx] = a;
    }
    __syncthreads();
  }

  for (int idx = tid; idx < R * dh; idx += nt) {
    int i = idx / dh, d = idx - i * dh;
    if (i < n_valid) out[i * out_row_stride + d] = acc[idx] / fmaxf(l_s[i], 1e-30f);
  }
}

// First block of a table row that can hold a visible key for a query at
// absolute position p (local windows skip pages wholly before the band).
__device__ __forceinline__ int first_block(int p, int local, int local_window, int bs) {
  if (!local) return 0;
  int lo = p - local_window + 1;
  return lo <= 0 ? 0 : lo / bs;
}

template <typename Kernel>
inline cudaError_t allow_smem(Kernel k, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace raca
