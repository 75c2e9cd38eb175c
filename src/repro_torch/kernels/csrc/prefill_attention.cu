// Chunked-prefill (suffix) attention for Hopper (sm_90a): tensor-core
// flash attention over paged keys, loaded by TMA.
//
// Replaces the TPU kernel paged_prefill_attention_pallas
// (src/repro/kernels/prefill_attention.py): the S queries of one request's
// suffix chunk, at absolute positions q0+i, attend over that request's
// block-table row (shared prefix pages and the chunk's own fresh pages
// alike), with the same masking, soft-capping, GQA and int8 fused-dequant
// semantics as the decode kernel.
//
// What bounds it on this card: at the main path's shapes (S=128, up to 16
// live pages) the work is ~4*S*T*Dh flops per head against 2*T*Dh page
// elements, so bytes bound it; the earlier CUDA-core version was bound by
// latency instead (four block barriers per 16-key page, scalar loads, one
// page in flight).  The routes, by type pair:
//
// - bf16 queries, bf16 or int8 pool (the full-width main path): tensor
//   cores.  A CTA takes 16 query rows of one head (grid ceil(S/16) x H:
//   256 CTAs at S=128, H=32) and splits their keys over 8 warps: warp j
//   walks the 32-key chunks j, j+8, ... of [first_block*bs, last query
//   + 1), so at the main path's shapes every warp has one chunk or two,
//   all of them loading at once, and no block barrier runs before the
//   final merge.  Each warp loads its chunks by TMA page boxes into its
//   own stage (one: a second, for prefetch, would halve the CTAs an SM
//   holds) and runs the tensor-core tile of attention_chunks.cuh on them:
//   Q.K^T and the split-P P.V as mma.sync.m16n8k16 bf16 -> f32 (the tile
//   is compiled per head dim; up to Dh = 80 its registers fit two CTAs
//   an SM),
//   softmax in registers, int8 codes
//   converted exactly to bf16 with k_scale/127 on the f32 scores and
//   v_scale/127 folded into P.  At the end each warp leaves (O, m, l) in
//   its region and the CTA combines them with exp(m_j - m*), which wipes
//   a warp whose keys were all masked for a row (its m is NEG_INF; every
//   row's own key is visible to some warp).  Needs Dh a multiple of 16
//   and at most 128.
// - f32 queries (f32 pools, and f32 queries on int8 pools): the CUDA-core
//   body attend_rows of attention_common.cuh, 16-query tiles, 128 threads.
//
// On both routes the keys past a tile's last query position are never
// read, and local windows start at first_block.
#include "attention_chunks.cuh"

namespace raca {

constexpr int kQT = 16;      // f32 route: query rows per block
constexpr int kTcWarps = 8;  // tensor-core route: warps per CTA, sharing its keys

// Dynamic shared memory of the tensor-core route: 128 bytes of alignment
// slack, the warps' regions (tc_warp_bytes), then their mbarriers.
__host__ __device__ inline size_t prefill_tc_smem_bytes(int bs, int dh, int kv_bytes, bool int8) {
  return 128 + static_cast<size_t>(kTcWarps) * (tc_warp_bytes(bs, dh, kv_bytes, int8) + 8);
}

// Up to Dh = 80 the tile fits 128 registers a thread, so two CTAs share an
// SM; wider heads would spill under that cap and run one CTA an SM.
template <typename TKV, int DH>
__global__ void __launch_bounds__(32 * kTcWarps, DH <= 80 ? 2 : 1) prefill_tc_kernel(
    const __nv_bfloat16* __restrict__ q,  // (S, H, Dh)
    const __grid_constant__ CUtensorMap tm_k,  // the (P, bs, Hkv, Dh) pools
    const __grid_constant__ CUtensorMap tm_v,
    const float* __restrict__ ks,         // (P, bs, Hkv) or null
    const float* __restrict__ vs,
    const int* __restrict__ table,        // (W,)
    float* __restrict__ out,              // (S, H, Dh)
    int S, int q0, int H, int hkv, int bs, int W,
    int local, int local_window, float softcap) {
  constexpr bool kInt8 = sizeof(TKV) == 1;
  constexpr int dh = DH;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((128 - (smem_u32(smem_raw) & 127)) & 127);
  const int i0 = blockIdx.x * 16;
  const int h = blockIdx.y;
  const int kh = h / (H / hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wbytes = tc_warp_bytes(bs, dh, sizeof(TKV), kInt8);
  unsigned char* region = smem + warp * wbytes;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + kTcWarps * wbytes) + warp;
  __nv_bfloat16* work =
      reinterpret_cast<__nv_bfloat16*>(region + chunk_stage_bytes(bs, dh, sizeof(TKV), kInt8));
  if (lane == 0) {
    mbar_init(bar);
    mbar_init_fence();
  }
  __syncwarp();

  // Live keys of the CTA: [j_lo, j_hi) in absolute positions, in chunks
  // c_first, c_first + 1, ...; this warp takes every kTcWarps-th chunk.
  const int n_rows = min(S - i0, 16);
  const int last = q0 + i0 + n_rows - 1;
  const int j_lo = first_block(q0 + i0, local, local_window, bs) * bs;
  const int j_hi = min(W * bs, last + 1);
  const int c_first = j_lo / kChunk;
  const int n_chunks = j_hi > j_lo ? (j_hi - 1) / kChunk - c_first + 1 : 0;
  const int n_mine = n_chunks > warp ? (n_chunks - warp + kTcWarps - 1) / kTcWarps : 0;
  auto key0_of = [&](int i) { return (c_first + warp + i * kTcWarps) * kChunk; };
  int id_next = n_mine > 0 ? chunk_page_id(table, key0_of(0), j_hi, bs, lane) : 0;
  auto issue = [&](int i) {  // the warp's i-th chunk into its stage
    if (i < n_mine) {
      const int id = id_next;
      if (i + 1 < n_mine) id_next = chunk_page_id(table, key0_of(i + 1), j_hi, bs, lane);
      load_chunk<TKV>(region, bar, &tm_k, &tm_v, ks, vs, id, key0_of(i), j_hi, bs, hkv, kh,
                      dh, lane);
    }
    cp_async_commit();
  };

  // The CTA's 16 rows: query i0 + gid and i0 + gid + 8 of head h.  Their
  // loads are issued before the first chunk's, which waits on its page id.
  TcRows<DH> st;
  const int gid = lane >> 2, tg = lane & 3;
  const int ra = i0 + gid, rb = ra + 8;
  const int64_t ldq = static_cast<int64_t>(H) * dh;
  const __nv_bfloat16* qh = q + static_cast<int64_t>(h) * dh;
  st.init(ra < S ? qh + ra * ldq : nullptr, rb < S ? qh + rb * ldq : nullptr, tg);
  issue(0);
  const float scale = 1.f / sqrtf(static_cast<float>(dh));
  const ChunkRows raw = chunk_rows(bs, dh, sizeof(TKV));
  const ChunkRows conv = {0, 5, kChunk, (dh + kPad) * 2};
  const unsigned char* k_st = region;
  const unsigned char* v_st = k_st + (kChunk / raw.rows) * raw.slot;
  const float* sc = reinterpret_cast<const float*>(v_st + (kChunk / raw.rows) * raw.slot);
  const unsigned char* wk = reinterpret_cast<const unsigned char*>(work);
  for (int i = 0; i < n_mine; ++i) {
    mbar_wait(bar, i & 1);
    cp_async_wait<0>();
    __syncwarp();
    if constexpr (kInt8) {
      convert_rows_i8(k_st, raw, work, dh, lane);
      __syncwarp();
      st.scores(wk, conv, sc, sc + kChunk, key0_of(i), j_hi, q0 + ra, q0 + rb, local,
                local_window, softcap, scale, lane);
      __syncwarp();
      convert_rows_i8(v_st, raw, work, dh, lane);
      __syncwarp();
      st.accumulate(wk, conv, lane);
    } else {
      st.scores(k_st, raw, nullptr, nullptr, key0_of(i), j_hi, q0 + ra, q0 + rb, local,
                local_window, softcap, scale, lane);
      st.accumulate(v_st, raw, lane);
    }
    __syncwarp();  // the stage is refilled next
    issue(i + 1);
  }
  cp_async_wait<0>();
  __syncwarp();
  st.store(reinterpret_cast<float*>(region), lane);
  __syncthreads();
  const float* base = reinterpret_cast<const float*>(smem);
  for (int idx = threadIdx.x; idx < n_rows * dh; idx += 32 * kTcWarps) {
    const int row = idx / dh, d = idx - row * dh;
    const float3 m = merge_states(base, wbytes / 4, kTcWarps, dh, row, d);
    out[(i0 + row) * ldq + static_cast<int64_t>(h) * dh + d] = m.x / fmaxf(m.y, 1e-30f);
  }
}

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
  extern __shared__ float smem_f[];
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
      softcap, out + row0, static_cast<int64_t>(H) * dh, smem_f);
}

template <typename TQ, typename TKV>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const float* ks, const float* vs, const int* table,
                   float* out, int P, int S, int q0, int H, int hkv, int dh, int bs,
                   int W, int local, int local_window, float softcap,
                   cudaStream_t stream) {
  if constexpr (sizeof(TQ) == 2) {
    CUtensorMap tm_k, tm_v;
    const int64_t n_rows = static_cast<int64_t>(P) * bs;
    cudaError_t err = encode_pool_map(&tm_k, kp, sizeof(TKV), n_rows, hkv, dh, box_rows(bs));
    if (err == cudaSuccess)
      err = encode_pool_map(&tm_v, vp, sizeof(TKV), n_rows, hkv, dh, box_rows(bs));
    if (err != cudaSuccess) return err;
    auto go = [&](auto kern) {
      size_t bytes = prefill_tc_smem_bytes(bs, dh, sizeof(TKV), sizeof(TKV) == 1);
      cudaError_t e = allow_smem(kern, bytes);
      if (e != cudaSuccess) return e;
      dim3 grid((S + 15) / 16, H);
      kern<<<grid, 32 * kTcWarps, bytes, stream>>>(
          static_cast<const __nv_bfloat16*>(q), tm_k, tm_v, ks, vs, table, out, S, q0, H, hkv,
          bs, W, local, local_window, softcap);
      return cudaGetLastError();
    };
    switch (dh) {  // the tile's register arrays are sized by the head dim
      case 16: return go(prefill_tc_kernel<TKV, 16>);
      case 32: return go(prefill_tc_kernel<TKV, 32>);
      case 48: return go(prefill_tc_kernel<TKV, 48>);
      case 64: return go(prefill_tc_kernel<TKV, 64>);
      case 80: return go(prefill_tc_kernel<TKV, 80>);
      case 96: return go(prefill_tc_kernel<TKV, 96>);
      case 112: return go(prefill_tc_kernel<TKV, 112>);
      case 128: return go(prefill_tc_kernel<TKV, 128>);
      default: return cudaErrorInvalidValue;
    }
  } else {
    auto kern = paged_prefill_kernel<TQ, TKV>;
    size_t bytes = sizeof(float) * smem_floats(kQT, bs, dh);
    cudaError_t err = allow_smem(kern, bytes);
    if (err != cudaSuccess) return err;
    dim3 grid((S + kQT - 1) / kQT, H);
    kern<<<grid, kThreads, bytes, stream>>>(
        static_cast<const TQ*>(q), static_cast<const TKV*>(kp),
        static_cast<const TKV*>(vp), ks, vs, table, out, S, q0, H, hkv, dh, bs,
        W, local, local_window, softcap);
  }
  return cudaGetLastError();
}

}  // namespace raca

// Plain C entry point for ctypes; same type pairs and return convention as
// paged_attention_launch (P is the pool's page count).  bf16 queries take
// the tensor-core route, f32 queries the CUDA-core one.
extern "C" int paged_prefill_attention_launch(
    const void* q, int q_dtype, const void* kp, const void* vp, int kv_dtype,
    const float* ks, const float* vs, const int* table, float* out, int P, int S,
    int q0, int H, int hkv, int dh, int bs, int W, int local,
    int local_window, float softcap, void* stream) {
  using namespace raca;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define RACA_LAUNCH(TQ, TKV)                                                  \
  return static_cast<int>(launch<TQ, TKV>(q, kp, vp, ks, vs, table, out, P,   \
                                          S, q0, H, hkv, dh, bs, W, local,    \
                                          local_window, softcap, st))
  if (q_dtype == kF32 && kv_dtype == kF32) RACA_LAUNCH(float, float);
  if (q_dtype == kBF16 && kv_dtype == kBF16) RACA_LAUNCH(__nv_bfloat16, __nv_bfloat16);
  if (q_dtype == kF32 && kv_dtype == kI8) RACA_LAUNCH(float, int8_t);
  if (q_dtype == kBF16 && kv_dtype == kI8) RACA_LAUNCH(__nv_bfloat16, int8_t);
#undef RACA_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}
