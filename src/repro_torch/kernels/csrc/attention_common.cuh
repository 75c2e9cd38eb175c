// Shared pieces of the paged decode and chunked-prefill attention kernels.
//
// Masking follows the reference: key position w*bs+t is visible to a
// query at absolute position p iff t_abs <= p and, for a local window,
// t_abs > p - local_window.  Masked scores are the finite NEG_INF of the
// reference (never -inf, which would make NaN of -inf - (-inf)), so a
// softmax state whose visited keys are all masked carries weight-1 garbage
// under m = NEG_INF until a visible key's alpha of exp(NEG_INF - m) = 0
// wipes it (the reference's behaviour exactly).  The cluster and warp
// merges of both kernels rely on the same wipe.
//
// attend_rows is the CUDA-core body that the f32-query prefill route
// keeps: one thread block attends a tile of R query rows that all read
// the same kv head, page by page, with the online-softmax state (m, l,
// acc) in shared memory and pages converted to f32 as they are staged.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tma.cuh"

namespace raca {

constexpr float NEG_INF = -2.0e38f;
constexpr int kThreads = 128;

enum DType : int { kF32 = 0, kBF16 = 1, kI8 = 2 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }

// Byte i of a word of int8 codes as f32, exactly, without an integer
// conversion: the offset byte b ^ 0x80 = code + 128 becomes the low
// mantissa bits of 2^23, and subtracting 2^23 + 128 leaves the code.
__device__ __forceinline__ float i8_at(uint32_t w, int i) {
  return __uint_as_float(__byte_perm(w ^ 0x80808080u, 0x4B000000u, 0x7540 + i)) - 8388736.f;
}

// 4-byte asynchronous copy global -> shared, for scale-plane entries;
// groups are committed and waited on per thread, and a warp barrier after
// the wait publishes the data.
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A page pool (P, bs, Hkv, Dh) as the 3-D tensor (Dh, Hkv, P*bs), whose
// box (Dh, 1, rows) at (0, kh, page*bs + t) is `rows` keys of one kv head.
inline cudaError_t encode_pool_map(CUtensorMap* map, const void* pool, int elem_bytes,
                                   int64_t n_rows, int hkv, int dh, int rows) {
  const CUtensorMapDataType type = elem_bytes == 1   ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                                   : elem_bytes == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                                     : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(dh), static_cast<cuuint64_t>(hkv),
                              static_cast<cuuint64_t>(n_rows)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(dh) * elem_bytes,
                                 static_cast<cuuint64_t>(hkv) * dh * elem_bytes};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(dh), 1u, static_cast<cuuint32_t>(rows)};
  return encode_tiled(map, type, 3, pool, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_NONE);
}

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
