// Paged decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel paged_attention_pallas
// (src/repro/kernels/paged_attention.py): one query token per slot attends
// over the pages its block-table row names, with online softmax across
// pages, GQA, a Dh^-0.5 scale, optional tanh soft-capping, causal plus
// local-window masking, negative page ids reading the trash page 0, and
// int8 pools whose scale planes fold into the scores (k_scale/127) and the
// value weights (v_scale/127) while the denominator stays unscaled.
//
// What bounds it on this card: bytes.  Per (slot, kv head) it reads the
// live pages once, 2*bs*Dh elements per page, against about 4*G*bs*Dh
// flops, far below the ~295 flops/byte the H100 needs before compute
// matters.  The design therefore reads each live page exactly once and in
// its stored type (bf16 or int8, never a whole-pool f32 copy as the TPU
// wrapper made), skips pages past the slot's position (w < pos/bs + 1),
// and keeps the softmax state on chip.  One block per (slot, kv head)
// walks its live pages in a loop, so the G query heads of a group share
// each page read.  Split-W flash-decoding, 16-byte vector loads and
// asynchronous copies are later work; a short table leaves most SMs idle
// at small batch, which is the first thing to fix.
#include "attention_common.cuh"

namespace raca {

template <typename TQ, typename TKV>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(
    const TQ* __restrict__ q,        // (B, H, Dh)
    const TKV* __restrict__ kp,      // (P, bs, Hkv, Dh)
    const TKV* __restrict__ vp,
    const float* __restrict__ ks,    // (P, bs, Hkv) or null
    const float* __restrict__ vs,
    const int* __restrict__ table,   // (B, W)
    const int* __restrict__ pos,     // (B,)
    float* __restrict__ out,         // (B, H, Dh)
    int H, int hkv, int dh, int bs, int W,
    int local, int local_window, float softcap) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int kh = blockIdx.y;
  const int G = H / hkv;
  const int p = pos[b];
  int w_hi = p / bs + 1;
  w_hi = w_hi < W ? w_hi : W;
  const int w_lo = first_block(p, local, local_window, bs);
  const int64_t row0 = (static_cast<int64_t>(b) * H + kh * G) * dh;
  attend_rows<TQ, TKV>(
      q + row0, dh, G, G, p, 0, kp, vp, ks, vs,
      table + static_cast<int64_t>(b) * W, w_lo, w_hi, bs, hkv, kh, dh,
      local, local_window, softcap, out + row0, dh, smem);
}

template <typename TQ, typename TKV>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const float* ks, const float* vs, const int* table,
                   const int* pos, float* out, int B, int H, int hkv, int dh,
                   int bs, int W, int local, int local_window, float softcap,
                   cudaStream_t stream) {
  auto kern = paged_decode_kernel<TQ, TKV>;
  size_t bytes = sizeof(float) * smem_floats(H / hkv, bs, dh);
  cudaError_t err = allow_smem(kern, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(B, hkv);
  kern<<<grid, kThreads, bytes, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(kp),
      static_cast<const TKV*>(vp), ks, vs, table, pos, out, H, hkv, dh, bs, W,
      local, local_window, softcap);
  return cudaGetLastError();
}

}  // namespace raca

// Plain C entry point for ctypes.  q_dtype is f32 or bf16; kv_dtype is f32,
// bf16 or int8 (int8 requires the scale planes).  Returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for a type pair it does not take.
extern "C" int paged_attention_launch(
    const void* q, int q_dtype, const void* kp, const void* vp, int kv_dtype,
    const float* ks, const float* vs, const int* table, const int* pos,
    float* out, int B, int H, int hkv, int dh, int bs, int W, int local,
    int local_window, float softcap, void* stream) {
  using namespace raca;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define RACA_LAUNCH(TQ, TKV)                                                  \
  return static_cast<int>(launch<TQ, TKV>(q, kp, vp, ks, vs, table, pos, out, \
                                          B, H, hkv, dh, bs, W, local,        \
                                          local_window, softcap, st))
  if (q_dtype == kF32 && kv_dtype == kF32) RACA_LAUNCH(float, float);
  if (q_dtype == kBF16 && kv_dtype == kBF16) RACA_LAUNCH(__nv_bfloat16, __nv_bfloat16);
  if (q_dtype == kF32 && kv_dtype == kI8) RACA_LAUNCH(float, int8_t);
  if (q_dtype == kBF16 && kv_dtype == kI8) RACA_LAUNCH(__nv_bfloat16, int8_t);
#undef RACA_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}
