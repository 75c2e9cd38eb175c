// Chunked-prefill (suffix) attention for Hopper (sm_90a).
//
// Replaces the TPU kernel paged_prefill_attention_pallas
// (src/repro/kernels/prefill_attention.py): the S queries of one request's
// suffix chunk, at absolute positions q0+i, attend over that request's
// block-table row (shared prefix pages and the chunk's own fresh pages
// alike), with the same masking, soft-capping, GQA and int8 fused-dequant
// semantics as the decode kernel.
//
// The TPU kernel keeps the whole (S, H, Dh) query tile in VMEM; at S=128,
// H=32, Dh=80 in f32 that is 1.3 MB, far beyond the 227 KB of shared memory
// a Hopper block may use.  Here one block takes a tile of QT=16 queries of
// one head (grid: ceil(S/QT) x H) and walks the pages up to the tile's
// last absolute position, so the tail pages of a short tile are never
// read and pages past q0+S-1 never are.  Pages are read in their stored
// type and converted in shared memory (no whole-pool f32 copy).
//
// What bounds it on this card: at the main path's shapes (S=128, up to 16
// live pages) the work is ~4*S*T*Dh flops per head against 2*T*Dh page
// elements, a few flops per byte even counting reuse, so bytes bound it;
// the loop re-reads each page once per query tile and head from L2, and
// runs its dot products on the CUDA cores.  A wgmma tile over (query
// tile x page) with the kv-head group in one block is the later step.
#include "attention_common.cuh"

namespace raca {

constexpr int kQT = 16;

template <typename TQ, typename TKV>
__global__ void __launch_bounds__(kThreads) paged_prefill_kernel(
    const TQ* __restrict__ q,        // (S, H, Dh)
    const TKV* __restrict__ kp,      // (P, bs, Hkv, Dh)
    const TKV* __restrict__ vp,
    const float* __restrict__ ks,    // (P, bs, Hkv) or null
    const float* __restrict__ vs,
    const int* __restrict__ table,   // (W,)
    float* __restrict__ out,         // (S, H, Dh)
    int S, int q0, int H, int hkv, int dh, int bs, int W,
    int local, int local_window, float softcap) {
  extern __shared__ float smem[];
  const int i0 = blockIdx.x * kQT;
  const int h = blockIdx.y;
  const int kh = h / (H / hkv);
  const int n = S - i0 < kQT ? S - i0 : kQT;
  const int last = q0 + i0 + n - 1;
  int w_hi = last / bs + 1;
  w_hi = w_hi < W ? w_hi : W;
  const int w_lo = first_block(q0 + i0, local, local_window, bs);
  const int64_t row0 = (static_cast<int64_t>(i0) * H + h) * dh;
  attend_rows<TQ, TKV>(
      q + row0, static_cast<int64_t>(H) * dh, kQT, n, q0 + i0, 1, kp, vp,
      ks, vs, table, w_lo, w_hi, bs, hkv, kh, dh, local, local_window,
      softcap, out + row0, static_cast<int64_t>(H) * dh, smem);
}

template <typename TQ, typename TKV>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const float* ks, const float* vs, const int* table,
                   float* out, int S, int q0, int H, int hkv, int dh, int bs,
                   int W, int local, int local_window, float softcap,
                   cudaStream_t stream) {
  auto kern = paged_prefill_kernel<TQ, TKV>;
  size_t bytes = sizeof(float) * smem_floats(kQT, bs, dh);
  cudaError_t err = allow_smem(kern, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((S + kQT - 1) / kQT, H);
  kern<<<grid, kThreads, bytes, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(kp),
      static_cast<const TKV*>(vp), ks, vs, table, out, S, q0, H, hkv, dh, bs,
      W, local, local_window, softcap);
  return cudaGetLastError();
}

}  // namespace raca

// Plain C entry point for ctypes; same type pairs and return convention as
// paged_attention_launch.
extern "C" int paged_prefill_attention_launch(
    const void* q, int q_dtype, const void* kp, const void* vp, int kv_dtype,
    const float* ks, const float* vs, const int* table, float* out, int S,
    int q0, int H, int hkv, int dh, int bs, int W, int local,
    int local_window, float softcap, void* stream) {
  using namespace raca;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define RACA_LAUNCH(TQ, TKV)                                                  \
  return static_cast<int>(launch<TQ, TKV>(q, kp, vp, ks, vs, table, out, S,   \
                                          q0, H, hkv, dh, bs, W, local,       \
                                          local_window, softcap, st))
  if (q_dtype == kF32 && kv_dtype == kF32) RACA_LAUNCH(float, float);
  if (q_dtype == kBF16 && kv_dtype == kBF16) RACA_LAUNCH(__nv_bfloat16, __nv_bfloat16);
  if (q_dtype == kF32 && kv_dtype == kI8) RACA_LAUNCH(float, int8_t);
  if (q_dtype == kBF16 && kv_dtype == kI8) RACA_LAUNCH(__nv_bfloat16, int8_t);
#undef RACA_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}
