// Paged decode attention for Hopper (sm_90a): split-W over a thread block
// cluster, warps owning 32-key chunks, TMA page loads.
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
// matters.  So the design keeps page loads in flight on every SM with few
// requests, keeps the per-key work short, and lets no block walk a long
// page list alone:
//
// - Split-W.  Each (slot, kv head) is a cluster of NS <= 8 CTAs (grid
//   (NS, Hkv, B), compile-time __cluster_dims__).  The host
//   picks NS from W and B*Hkv; CTA r takes the contiguous share
//   [w_lo + n*r/NS, w_lo + n*(r+1)/NS) of the live pages [w_lo, w_hi),
//   n = w_hi - w_lo, computed here from pos.  Each CTA keeps its own
//   (m, l, acc); after cluster.sync() rank 0 reads the others' states
//   through distributed shared memory, combines them with exp(m_r - m*)
//   and writes the rows.  An empty share contributes m = NEG_INF, l = 0,
//   acc = 0; a share whose visited keys are all masked carries weight-1
//   garbage under m = NEG_INF, which exp(NEG_INF - m*) wipes because the
//   key at pos is visible to some CTA.
// - Warps own 32-key chunks (attention_chunks.cuh): warp j walks chunks j,
//   j+4, ... of its CTA's share (two pages at bs=16) with its own online
//   softmax, loading each through TMA page boxes into a two-stage ring, so
//   chunk k+1 is in flight while chunk k is consumed; page ids are read
//   one chunk ahead and the first chunk is requested before q is staged.
//   The warps merge in shared memory once at the end, and the G query
//   rows of a GQA group share each chunk read.
// - Per-key work stays short: one key per lane, its score as a 16-byte
//   vector dot product, the row max and sum as warp shuffles, P.V with
//   each lane owning four dimensions, all in f32 on the CUDA cores.
//   The tensor-core tile of attention_chunks.cuh measured slower here:
//   decode has G query rows per kv head, one at stablelm-3b's MHA, so 15
//   of a 16-row tile's rows would be padding whose scores and
//   exponentials still cost.
//
// Requires Dh * sizeof(pool element) to be a multiple of 16 bytes, Dh at
// most 256 and bs a power of two (the wrapper checks all three).
#include <cooperative_groups.h>

#include "attention_chunks.cuh"

namespace cg = cooperative_groups;

namespace raca {

constexpr int kWarps = kThreads / 32;

// Dynamic shared memory of one CTA: 128 bytes of alignment slack, the
// warps' two-stage rings and mbarriers (16 bytes a warp), then f32 q rows,
// each warp's (32 weights, m, l padded to 16 bytes, acc) and the CTA's
// combined (m, l).
__host__ __device__ inline size_t decode_smem_bytes(int G, int bs, int dh, int kv_bytes,
                                                    bool int8) {
  const int wfl = 32 + (2 * G + 3) / 4 * 4 + G * dh;
  return 128 +
         static_cast<size_t>(kWarps) * (2 * chunk_stage_bytes(bs, dh, kv_bytes, int8) + 16) +
         sizeof(float) * (G * dh + kWarps * wfl + 2 * G);
}

__device__ __forceinline__ unsigned char* align128(unsigned char* p) {
  return p + ((128 - (smem_u32(p) & 127)) & 127);
}

// The live pages of CTA r's share of a slot's window, as keys [k_lo, k_hi).
template <int NS>
__device__ __forceinline__ int2 share_keys(int p, int r, int bs, int W, int local,
                                           int local_window) {
  const int w_hi = min(p / bs + 1, W);
  const int w_lo = first_block(p, local, local_window, bs);
  const int n = max(w_hi - w_lo, 0);
  return make_int2((w_lo + n * r / NS) * bs, (w_lo + n * (r + 1) / NS) * bs);
}

// Rank 0 of the cluster combines the CTAs' (m_c, l_c, acc_c) of n_rows
// rows and writes out_rows[row * dh + d]; with NS = 1 the CTA writes its
// own.  Called by every thread of every CTA of the cluster.
template <int NS>
__device__ __forceinline__ void cluster_combine(float* m_c, float* l_c, float* acc_c,
                                                int acc_stride, int n_rows, int dh,
                                                float* out_rows) {
  if constexpr (NS == 1) {
    for (int idx = threadIdx.x; idx < n_rows * dh; idx += kThreads) {
      const int row = idx / dh, d = idx - row * dh;
      out_rows[idx] = acc_c[row * acc_stride + d] / fmaxf(l_c[row], 1e-30f);
    }
  } else {
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();  // every share's state is in its CTA's shared memory
    if (blockIdx.x == 0) {
      for (int idx = threadIdx.x; idx < n_rows * dh; idx += kThreads) {
        const int row = idx / dh, d = idx - row * dh;
        float mx = NEG_INF;
#pragma unroll
        for (int s = 0; s < NS; ++s) mx = fmaxf(mx, cluster.map_shared_rank(m_c, s)[row]);
        float a = 0.f, l = 0.f;
#pragma unroll
        for (int s = 0; s < NS; ++s) {
          const float wgt = expf(cluster.map_shared_rank(m_c, s)[row] - mx);
          a += cluster.map_shared_rank(acc_c, s)[row * acc_stride + d] * wgt;
          l += cluster.map_shared_rank(l_c, s)[row] * wgt;
        }
        out_rows[idx] = a / fmaxf(l, 1e-30f);
      }
    }
    cluster.sync();  // no CTA leaves while rank 0 still reads its memory
  }
}

// Dot product of 16 bytes of a stored K row with the matching f32 q
// values (16-byte aligned in shared memory); the elements are unpacked
// with bit operations, so the loaded words stay in registers.
__device__ __forceinline__ float dot16(const float* q, const float* k) {
  const float4 v = *reinterpret_cast<const float4*>(k);
  const float4 a = *reinterpret_cast<const float4*>(q);
  return fmaf(a.w, v.w, fmaf(a.z, v.z, fmaf(a.y, v.y, a.x * v.x)));
}
__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }
__device__ __forceinline__ float dot16(const float* q, const __nv_bfloat16* k) {
  const uint4 v = *reinterpret_cast<const uint4*>(k);
  const float4 a = *reinterpret_cast<const float4*>(q);
  const float4 b = *reinterpret_cast<const float4*>(q + 4);
  float s0 = a.x * bf16_lo(v.x), s1 = a.y * bf16_hi(v.x);  // bf16 -> f32: a shift
  s0 = fmaf(a.z, bf16_lo(v.y), s0);
  s1 = fmaf(a.w, bf16_hi(v.y), s1);
  s0 = fmaf(b.x, bf16_lo(v.z), s0);
  s1 = fmaf(b.y, bf16_hi(v.z), s1);
  s0 = fmaf(b.z, bf16_lo(v.w), s0);
  s1 = fmaf(b.w, bf16_hi(v.w), s1);
  return s0 + s1;
}
__device__ __forceinline__ float dot16(const float* q, const int8_t* k) {
  const uint4 v = *reinterpret_cast<const uint4*>(k);
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  float s0 = 0.f, s1 = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 a = *reinterpret_cast<const float4*>(q + 4 * i);
    s0 = fmaf(a.x, i8_at(w[i], 0), s0);
    s1 = fmaf(a.y, i8_at(w[i], 1), s1);
    s0 = fmaf(a.z, i8_at(w[i], 2), s0);
    s1 = fmaf(a.w, i8_at(w[i], 3), s1);
  }
  return s0 + s1;
}

// Four neighbouring elements of a stored V row, as f32.
__device__ __forceinline__ float4 quad_f32(const float* v) {
  return *reinterpret_cast<const float4*>(v);
}
__device__ __forceinline__ float4 quad_f32(const __nv_bfloat16* v) {
  const uint2 w = *reinterpret_cast<const uint2*>(v);
  return make_float4(bf16_lo(w.x), bf16_hi(w.x), bf16_lo(w.y), bf16_hi(w.y));
}
__device__ __forceinline__ float4 quad_f32(const int8_t* v) {
  const uint32_t w = *reinterpret_cast<const uint32_t*>(v);
  return make_float4(i8_at(w, 0), i8_at(w, 1), i8_at(w, 2), i8_at(w, 3));
}

__device__ __forceinline__ void fma4(float4& a, float p, float4 v) {
  a.x = fmaf(p, v.x, a.x);
  a.y = fmaf(p, v.y, a.y);
  a.z = fmaf(p, v.z, a.z);
  a.w = fmaf(p, v.w, a.w);
}

template <typename TQ, typename TKV, int NS>
__device__ __forceinline__ void decode_body(
    const TQ* __restrict__ q, const CUtensorMap* tm_k, const CUtensorMap* tm_v,
    const float* __restrict__ ks, const float* __restrict__ vs,
    const int* __restrict__ table, const int* __restrict__ pos, float* __restrict__ out,
    int H, int hkv, int dh, int bs, int W, int local, int local_window, float softcap) {
  constexpr int VEC = 16 / sizeof(TKV);
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = align128(smem_raw);
  const int r = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int G = H / hkv;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool int8 = ks != nullptr;
  const ChunkRows rr = chunk_rows(bs, dh, sizeof(TKV));
  const int nb = kChunk / rr.rows;
  const int stage_bytes = chunk_stage_bytes(bs, dh, sizeof(TKV), int8);
  unsigned char* ring = smem + warp * 2 * stage_bytes;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + kWarps * 2 * stage_bytes) + 2 * warp;
  float* q_s = reinterpret_cast<float*>(smem + kWarps * (2 * stage_bytes + 16));
  // A warp's state: 32 weights, m[G], l[G] (padded to 16 bytes), acc[G][Dh].
  const int wml = (2 * G + 3) / 4 * 4;
  const int wfl = 32 + wml + G * dh;
  auto w_m = [&](int v) { return q_s + G * dh + v * wfl + 32; };
  auto w_acc = [&](int v) { return q_s + G * dh + v * wfl + 32 + wml; };
  float* p_w = q_s + G * dh + warp * wfl;
  float* m_w = w_m(warp);
  float* l_w = m_w + G;
  float* acc_w = w_acc(warp);
  float* m_c = q_s + G * dh + kWarps * wfl;
  float* l_c = m_c + G;
  if (lane == 0) {
    mbar_init(bars);
    mbar_init(bars + 1);
    mbar_init_fence();
  }
  __syncwarp();

  const int p = pos[b];
  const int2 kr2 = share_keys<NS>(p, r, bs, W, local, local_window);
  const int k_lo = kr2.x, k_hi = kr2.y;
  const int n_chunks = (k_hi - k_lo + kChunk - 1) / kChunk;
  const int n_mine = n_chunks > warp ? (n_chunks - warp + kWarps - 1) / kWarps : 0;
  const int* trow = table + static_cast<int64_t>(b) * W;
  auto key0_of = [&](int i) { return k_lo + (warp + i * kWarps) * kChunk; };
  int id_next = n_mine > 0 ? chunk_page_id(trow, key0_of(0), k_hi, bs, lane) : 0;
  auto issue = [&](int i) {  // the warp's i-th chunk into stage i % 2
    if (i < n_mine) {
      const int id = id_next;
      if (i + 1 < n_mine) id_next = chunk_page_id(trow, key0_of(i + 1), k_hi, bs, lane);
      load_chunk<TKV>(ring + (i % 2) * stage_bytes, bars + i % 2, tm_k, tm_v, ks, vs, id,
                      key0_of(i), k_hi, bs, hkv, kh, dh, lane);
    }
    cp_async_commit();
  };
  issue(0);  // the first chunk flies while q is staged

  const float scale = 1.f / sqrtf(static_cast<float>(dh));
  const int64_t row0 = (static_cast<int64_t>(b) * H + kh * G) * dh;
  for (int i = threadIdx.x; i < G * dh; i += kThreads) q_s[i] = to_f32(q[row0 + i]) * scale;
  for (int i = lane; i < G * dh; i += 32) acc_w[i] = 0.f;
  for (int i = lane; i < G; i += 32) {
    m_w[i] = NEG_INF;
    l_w[i] = 0.f;
  }
  __syncthreads();

  const int cpr = dh / VEC;  // 16-byte pieces per row
  for (int i = 0; i < n_mine; ++i) {
    issue(i + 1);
    mbar_wait(bars + i % 2, (i / 2) & 1);
    cp_async_wait<1>();
    __syncwarp();
    const unsigned char* k_st = ring + (i % 2) * stage_bytes;
    const unsigned char* v_st = k_st + nb * rr.slot;
    const float* sc = reinterpret_cast<const float*>(v_st + nb * rr.slot);
    const int kpos = key0_of(i) + lane;
    bool ok = kpos <= p && kpos < k_hi;  // rows past the share belong to the next CTA
    if (local) ok = ok && kpos > p - local_window;
    const TKV* krow = reinterpret_cast<const TKV*>(k_st + rr.at(lane));
    for (int g = 0; g < G; ++g) {
      const float* qg = q_s + g * dh;
      float d0 = 0.f, d1 = 0.f;
      int j = 0;
      for (; j + 1 < cpr; j += 2) {
        d0 += dot16(qg + j * VEC, krow + j * VEC);
        d1 += dot16(qg + (j + 1) * VEC, krow + (j + 1) * VEC);
      }
      if (j < cpr) d0 += dot16(qg + j * VEC, krow + j * VEC);
      float dot = d0 + d1;
      if (int8) dot *= sc[lane] / 127.f;
      if (softcap > 0.f) dot = tanhf(dot / softcap) * softcap;
      const float s = ok ? dot : NEG_INF;
      float mx = s;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = m_w[g];
      mx = fmaxf(mx, m_prev);
      const float alpha = expf(m_prev - mx);
      const float pr = expf(s - mx);
      float sum = pr;  // the denominator keeps the unscaled weights
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      p_w[lane] = int8 ? pr * (sc[kChunk + lane] / 127.f) : pr;
      __syncwarp();
      // acc += P V: lane owns four dimensions (one pass up to Dh = 128),
      // four keys per weight load, two accumulator chains
      float* ag = acc_w + g * dh;
      for (int d = 4 * lane; d < dh; d += 128) {
        const unsigned char* vd = v_st + d * sizeof(TKV);
        float4 a = *reinterpret_cast<float4*>(ag + d);
        a.x *= alpha;
        a.y *= alpha;
        a.z *= alpha;
        a.w *= alpha;
        float4 c = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int u = 0; u < kChunk; u += 4) {
          const float4 pu = *reinterpret_cast<const float4*>(p_w + u);
          fma4(a, pu.x, quad_f32(reinterpret_cast<const TKV*>(vd + rr.at(u))));
          fma4(c, pu.y, quad_f32(reinterpret_cast<const TKV*>(vd + rr.at(u + 1))));
          fma4(a, pu.z, quad_f32(reinterpret_cast<const TKV*>(vd + rr.at(u + 2))));
          fma4(c, pu.w, quad_f32(reinterpret_cast<const TKV*>(vd + rr.at(u + 3))));
        }
        *reinterpret_cast<float4*>(ag + d) =
            make_float4(a.x + c.x, a.y + c.y, a.z + c.z, a.w + c.w);
      }
      if (lane == 0) {
        m_w[g] = mx;
        l_w[g] = l_w[g] * alpha + sum;
      }
      __syncwarp();
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // Merge the warps into the CTA's state: m_c, l_c, and acc in warp 0's
  // acc (each element is read and written by one thread only).
  float* acc_c = w_acc(0);
  for (int idx = threadIdx.x; idx < G * dh; idx += kThreads) {
    const int g = idx / dh;
    float mx = NEG_INF;
    for (int v = 0; v < kWarps; ++v) mx = fmaxf(mx, w_m(v)[g]);
    float a = 0.f;
    for (int v = 0; v < kWarps; ++v) a += w_acc(v)[idx] * expf(w_m(v)[g] - mx);
    acc_c[idx] = a;
  }
  for (int g = threadIdx.x; g < G; g += kThreads) {
    float mx = NEG_INF, l = 0.f;
    for (int v = 0; v < kWarps; ++v) mx = fmaxf(mx, w_m(v)[g]);
    for (int v = 0; v < kWarps; ++v) l += w_m(v)[G + g] * expf(w_m(v)[g] - mx);
    m_c[g] = mx;
    l_c[g] = l;
  }
  __syncthreads();
  cluster_combine<NS>(m_c, l_c, acc_c, dh, G, dh, out + row0);
}

#define RACA_DECODE_KERNEL(NS)                                                        \
  template <typename TQ, typename TKV>                                                \
  __global__ void __cluster_dims__(NS, 1, 1) __launch_bounds__(kThreads)              \
      paged_decode_kernel_##NS(const TQ* __restrict__ q,                              \
                               const __grid_constant__ CUtensorMap tm_k,              \
                               const __grid_constant__ CUtensorMap tm_v,              \
                               const float* __restrict__ ks,                          \
                               const float* __restrict__ vs,                          \
                               const int* __restrict__ table,                         \
                               const int* __restrict__ pos, float* __restrict__ out,  \
                               int H, int hkv, int dh, int bs, int W, int local,      \
                               int local_window, float softcap) {                     \
    decode_body<TQ, TKV, NS>(q, &tm_k, &tm_v, ks, vs, table, pos, out, H, hkv, dh, bs, \
                             W, local, local_window, softcap);                        \
  }
RACA_DECODE_KERNEL(1)
RACA_DECODE_KERNEL(2)
RACA_DECODE_KERNEL(4)
RACA_DECODE_KERNEL(8)
#undef RACA_DECODE_KERNEL

template <typename TQ, typename TKV, typename Kernel>
cudaError_t launch_ns(Kernel kern, const void* q, const void* kp, const void* vp,
                      const float* ks, const float* vs, const int* table, const int* pos,
                      float* out, int P, int B, int H, int hkv, int dh, int bs, int W,
                      int n_split, int local, int local_window, float softcap,
                      cudaStream_t stream) {
  CUtensorMap tm_k, tm_v;
  const int64_t n_rows = static_cast<int64_t>(P) * bs;
  cudaError_t err = encode_pool_map(&tm_k, kp, sizeof(TKV), n_rows, hkv, dh, box_rows(bs));
  if (err == cudaSuccess)
    err = encode_pool_map(&tm_v, vp, sizeof(TKV), n_rows, hkv, dh, box_rows(bs));
  if (err != cudaSuccess) return err;
  size_t bytes = decode_smem_bytes(H / hkv, bs, dh, sizeof(TKV), ks != nullptr);
  err = allow_smem(kern, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(n_split, hkv, B);
  kern<<<grid, kThreads, bytes, stream>>>(static_cast<const TQ*>(q), tm_k, tm_v, ks, vs, table,
                                          pos, out, H, hkv, dh, bs, W, local, local_window,
                                          softcap);
  return cudaGetLastError();
}

template <typename TQ, typename TKV>
cudaError_t launch(const void* q, const void* kp, const void* vp, const float* ks,
                   const float* vs, const int* table, const int* pos, float* out, int P, int B,
                   int H, int hkv, int dh, int bs, int W, int n_split, int local,
                   int local_window, float softcap, cudaStream_t stream) {
#define RACA_NS(NS)                                                                      \
  if (n_split == NS)                                                                     \
  return launch_ns<TQ, TKV>(paged_decode_kernel_##NS<TQ, TKV>, q, kp, vp, ks, vs, table, \
                            pos, out, P, B, H, hkv, dh, bs, W, n_split, local,           \
                            local_window, softcap, stream)
  RACA_NS(1);
  RACA_NS(2);
  RACA_NS(4);
  RACA_NS(8);
#undef RACA_NS
  return cudaErrorInvalidValue;
}

}  // namespace raca

// Plain C entry point for ctypes.  q_dtype is f32 or bf16; kv_dtype is f32,
// bf16 or int8 (int8 requires the scale planes); P is the pool's page
// count.  n_split (1, 2, 4 or 8) comes from the wrapper's decode_geometry.  Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a type pair, split or shape it does not take.
extern "C" int paged_attention_launch(
    const void* q, int q_dtype, const void* kp, const void* vp, int kv_dtype,
    const float* ks, const float* vs, const int* table, const int* pos,
    float* out, int P, int B, int H, int hkv, int dh, int bs, int W, int n_split, int local,
    int local_window, float softcap, void* stream) {
  using namespace raca;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define RACA_LAUNCH(TQ, TKV)                                                        \
  return static_cast<int>(launch<TQ, TKV>(q, kp, vp, ks, vs, table, pos, out, P, B, \
                                          H, hkv, dh, bs, W, n_split, local,        \
                                          local_window, softcap, st))
  if (q_dtype == kF32 && kv_dtype == kF32) RACA_LAUNCH(float, float);
  if (q_dtype == kBF16 && kv_dtype == kBF16) RACA_LAUNCH(__nv_bfloat16, __nv_bfloat16);
  if (q_dtype == kF32 && kv_dtype == kI8) RACA_LAUNCH(float, int8_t);
  if (q_dtype == kBF16 && kv_dtype == kI8) RACA_LAUNCH(__nv_bfloat16, int8_t);
#undef RACA_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}
