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
// the hash is a dozen integer operations.  A CTA of (tx, ty) threads takes
// ty rows, tx threads across each, so the group, the row within it and the
// counter's row base are found once per row in 32 bits (no per-element
// division).  Each thread keeps kSrUnroll 16-byte loads in flight and
// streams its stores; the first round's loads (the row's seed, its head
// and tail elements, the first vectors) are all issued before any is
// waited on.  A row whose start is not 16-byte aligned (n % 4 != 0, or a
// data pointer that is not) takes its first elements one by one up to the
// next 16-byte boundary, and its last n % 4 past the vectors; where the
// output row is aligned differently from the input row the vectors are
// stored one element at a time.  It serves ops.stoch_round_serving.
//
// write_kv_int8_kernel is the int8 KV pool's whole write of one layer in
// one launch, in place of the reference's quantize_kv_pair_int8
// (src/repro/kernels/ops.py) followed by four page scatters
// (src/repro/models/attention.py, the decode write and the prefill
// insert): per K or V row, scale = max(max|x|, 1e-6), t = x / scale * 127
// (a divide, then a multiply), the same stochastic rounding onto the
// integers of [-127, 127] with counter row_in_group * 512 + col, the int8
// cast, and the scatter of the codes and the f32 scale into the pages.
// V draws under its seed plus the golden-ratio constant.  What bounds it:
// a launch; a decode write moves about 125 KB at stablelm-3b's width.
// One warp per (token, kv head, K or V) row; seeds, table and positions
// are read from device memory, so the host never waits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "prng.cuh"

namespace raca {

constexpr int kSrThreads = 256;
constexpr int kSrUnroll = 4;   // float4 loads in flight per thread

struct SrGrid {
  uint32_t seed, ctr0;     // the row's seed and counter base row_in_group * n_padded
  float step, inv_step, lo, hi;

  __device__ __forceinline__ float operator()(float x, uint32_t col) const {
    const float xc = fminf(fmaxf(x, lo), hi);
    const float t = __fmul_rn(__fsub_rn(xc, lo), inv_step);
    const float fl = floorf(t);
    const float frac = __fsub_rn(t, fl);
    const float u = uniform(ctr0 + col, seed);
    const float q = __fadd_rn(fl, u < frac ? 1.0f : 0.0f);
    return __fadd_rn(__fmul_rn(q, step), lo);
  }
};

__global__ void __launch_bounds__(kSrThreads) stoch_round_kernel(
    const float* __restrict__ x, const int64_t* __restrict__ seeds,
    float* __restrict__ out, int m, int n, uint32_t n_padded, int rows_per_seed,
    float step, float inv_step, float lo, float hi) {
  const int row = blockIdx.x * blockDim.y + threadIdx.y;
  if (row >= m) return;
  const int group = row / rows_per_seed;
  const float* xr = x + static_cast<int64_t>(row) * n;
  float* orow = out + static_cast<int64_t>(row) * n;
  const int tx = blockDim.x, lane = threadIdx.x;
  // scalar head up to xr's next 16-byte boundary, float4 body, scalar tail
  const uintptr_t mis = reinterpret_cast<uintptr_t>(xr) & 15u;
  const int head = min(n, static_cast<int>(((16u - mis) & 15u) >> 2));
  const int nv = (n - head) >> 2;
  const int tail0 = head + 4 * nv;
  const float4* xv = reinterpret_cast<const float4*>(xr + head);
  float4 a[kSrUnroll];
  auto load = [&](int v0) {
#pragma unroll
    for (int u = 0; u < kSrUnroll; ++u)
      if (v0 + u * tx < nv) a[u] = __ldcs(xv + v0 + u * tx);
  };
  // every load of the first round before anything waits on one: the seed,
  // the head and tail elements and the first vectors are in flight together
  const uint32_t seed = static_cast<uint32_t>(seeds[group]);
  const float xh = lane < head ? __ldcs(xr + lane) : 0.0f;
  const float xt = tail0 + lane < n ? __ldcs(xr + tail0 + lane) : 0.0f;
  load(lane);
  const SrGrid g{seed, static_cast<uint32_t>(row - group * rows_per_seed) * n_padded, step,
                 inv_step, lo, hi};
  if (lane < head) __stcs(orow + lane, g(xh, lane));
  if (tail0 + lane < n) __stcs(orow + tail0 + lane, g(xt, tail0 + lane));
  float* ob = orow + head;
  const bool ovec = (reinterpret_cast<uintptr_t>(ob) & 15u) == 0;
  for (int v0 = lane; v0 < nv; v0 += tx * kSrUnroll) {
    if (v0 != lane) load(v0);
#pragma unroll
    for (int u = 0; u < kSrUnroll; ++u) {
      const int v = v0 + u * tx;
      if (v >= nv) break;
      const uint32_t c = static_cast<uint32_t>(head + 4 * v);
      const float4 r = make_float4(g(a[u].x, c), g(a[u].y, c + 1), g(a[u].z, c + 2),
                                   g(a[u].w, c + 3));
      if (ovec) {
        __stcs(reinterpret_cast<float4*>(ob) + v, r);
      } else {
        __stcs(ob + 4 * v, r.x);
        __stcs(ob + 4 * v + 1, r.y);
        __stcs(ob + 4 * v + 2, r.z);
        __stcs(ob + 4 * v + 3, r.w);
      }
    }
  }
}


// One token's destination and seed: decode slots write row pos % bs of
// table[b, clamp(pos // bs)] under seeds[0]; chunk rows j write row j % bs
// of table[b0 + j / bs] under seeds[j / bs].  Ids < 0 go to page 0.
struct WriteTarget {
  int64_t row;         // page * bs + offset
  uint32_t seed;
  uint32_t row_in_group;  // of the token's first kv head
};

__device__ __forceinline__ WriteTarget write_target(int j, int decode, const int* table,
                                                    const int* pos, int table_w, int b0,
                                                    int bs, int hkv,
                                                    const int64_t* seeds) {
  int blk, off, group;
  uint32_t first;
  const int* trow = table;
  if (decode) {
    const int p = pos[j];
    int q = p / bs;
    if (p % bs != 0 && p < 0) --q;   // floor division, as the reference's //
    off = p - q * bs;
    blk = min(max(q, 0), table_w - 1);
    trow = table + static_cast<int64_t>(j) * table_w;
    group = 0;
    first = static_cast<uint32_t>(j * hkv);
  } else {
    blk = b0 + j / bs;
    off = j % bs;
    group = j / bs;
    first = static_cast<uint32_t>(off * hkv);
  }
  const int page = max(trow[blk], 0);
  return {static_cast<int64_t>(page) * bs + off, static_cast<uint32_t>(seeds[group]), first};
}

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) { return __bfloat162float(*p); }

constexpr int kWriteWarps = 8;

template <typename T>
__global__ void __launch_bounds__(kWriteWarps * 32) write_kv_int8_kernel(
    const T* __restrict__ k, const T* __restrict__ v, int8_t* __restrict__ k_pages,
    int8_t* __restrict__ v_pages, float* __restrict__ k_scale, float* __restrict__ v_scale,
    const int64_t* __restrict__ seeds, const int* __restrict__ table,
    const int* __restrict__ pos, int decode, int n_tok, int n_valid, int table_w, int b0,
    int bs, int hkv, int dh, uint32_t n_padded) {
  const int lane = threadIdx.x & 31;
  const int64_t gw = static_cast<int64_t>(blockIdx.x) * kWriteWarps + (threadIdx.x >> 5);
  if (gw >= static_cast<int64_t>(n_tok) * hkv * 2) return;
  const int is_v = static_cast<int>(gw & 1);
  const int rid = static_cast<int>(gw >> 1);
  const int j = rid / hkv, h = rid - j * hkv;
  const WriteTarget tg = write_target(j, decode, table, pos, table_w, b0, bs, hkv, seeds);
  const uint32_t seed = is_v ? tg.seed + kGolden : tg.seed;
  const uint32_t r = tg.row_in_group + static_cast<uint32_t>(h);
  const bool valid = j < n_valid;
  const T* src = (is_v ? v : k) + (static_cast<int64_t>(j) * hkv + h) * dh;
  int8_t* dst = (is_v ? v_pages : k_pages) + (tg.row * hkv + h) * dh;

  float m = 0.f;
  for (int c = lane; c < dh; c += 32) m = fmaxf(m, valid ? fabsf(load_f32(src + c)) : 0.f);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  const float scale = fmaxf(m, 1e-6f);
  for (int c = lane; c < dh; c += 32) {
    const float x = valid ? load_f32(src + c) : 0.f;
    const float t = __fmul_rn(__fdiv_rn(x, scale), 127.f);
    const float xc = fminf(fmaxf(t, -127.f), 127.f);
    const float tt = __fmul_rn(__fsub_rn(xc, -127.f), 1.f);
    const float fl = floorf(tt);
    const float u = uniform(r * n_padded + static_cast<uint32_t>(c), seed);
    const float q = __fadd_rn(fl, u < __fsub_rn(tt, fl) ? 1.f : 0.f);
    dst[c] = static_cast<int8_t>(__fadd_rn(__fmul_rn(q, 1.f), -127.f));
  }
  if (lane == 0) (is_v ? v_scale : k_scale)[tg.row * hkv + h] = scale;
}

}  // namespace raca

// Plain C entry point for ctypes: x and out are (m, n) f32, contiguous;
// seeds holds m / rows_per_seed values; the CTA is (tx, ty) threads, ty
// rows of tx (stoch_round.stoch_round_geometry).  Returns
// cudaGetLastError().
extern "C" int stoch_round_launch(const float* x, const int64_t* seeds,
                                  float* out, int m, int n, int n_padded,
                                  int rows_per_seed, float step,
                                  float inv_step, float lo, float hi, int tx,
                                  int ty, void* stream) {
  using namespace raca;
  if (static_cast<int64_t>(m) * n == 0) return 0;
  if (tx * ty > kSrThreads || tx % 32 != 0 || ty < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = static_cast<unsigned>((m + ty - 1) / ty);
  stoch_round_kernel<<<blocks, dim3(tx, ty), 0, static_cast<cudaStream_t>(stream)>>>(
      x, seeds, out, m, n, static_cast<uint32_t>(n_padded), rows_per_seed, step, inv_step,
      lo, hi);
  return static_cast<int>(cudaGetLastError());
}

// write_kv_int8_launch: k and v hold n_valid tokens of (hkv, dh) rows, f32
// (is_bf16 = 0) or bf16, contiguous; the pools are (P, bs, hkv, dh) int8
// and (P, bs, hkv) f32, written in place.  decode = 1: n_tok = n_valid
// slots, table (n_tok, table_w) and pos (n_tok) int32, one seed.
// decode = 0: a chunk padded to n_tok = nbc * bs tokens, table is the
// request's table row, b0 the chunk's first block, seeds (nbc).  Returns
// cudaGetLastError().
extern "C" int write_kv_int8_launch(const void* k, const void* v, int8_t* k_pages,
                                    int8_t* v_pages, float* k_scale, float* v_scale,
                                    const int64_t* seeds, const int* table, const int* pos,
                                    int is_bf16, int decode, int n_tok, int n_valid,
                                    int table_w, int b0, int bs, int hkv, int dh,
                                    int n_padded, void* stream) {
  using namespace raca;
  const int64_t warps = static_cast<int64_t>(n_tok) * hkv * 2;
  if (warps == 0) return 0;
  const unsigned blocks = static_cast<unsigned>((warps + kWriteWarps - 1) / kWriteWarps);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t np = static_cast<uint32_t>(n_padded);
  if (is_bf16) {
    write_kv_int8_kernel<__nv_bfloat16><<<blocks, kWriteWarps * 32, 0, s>>>(
        static_cast<const __nv_bfloat16*>(k), static_cast<const __nv_bfloat16*>(v), k_pages,
        v_pages, k_scale, v_scale, seeds, table, pos, decode, n_tok, n_valid, table_w, b0, bs,
        hkv, dh, np);
  } else {
    write_kv_int8_kernel<float><<<blocks, kWriteWarps * 32, 0, s>>>(
        static_cast<const float*>(k), static_cast<const float*>(v), k_pages, v_pages, k_scale,
        v_scale, seeds, table, pos, decode, n_tok, n_valid, table_w, b0, bs, hkv, dh, np);
  }
  return static_cast<int>(cudaGetLastError());
}
