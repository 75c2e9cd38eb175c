// Winner-take-all vote counts for Hopper (sm_90a).
//
// Replaces the TPU kernel wta_counts_pallas
// (src/repro/kernels/wta_kernel.py), the paper's binary stochastic SoftMax
// (§III-B): per row of z (B, C) and trial t, v = z + sigma * gaussian(idx),
// idx = row * c_pad + col + t * trial_stride (uint32, wrapping); the
// neurons with v > vth0 fire, every fired neuron equal to the row's fired
// maximum wins the trial (exact ties each get a vote), and counts[row, col]
// adds one per win.  Columns past C (the reference's padding) never fire,
// so they are never visited.
//
// What bounds it on this card: the Box-Muller draw, two hashes and the
// accurate logf, sqrtf and cosf that bit-exactness needs (no fast
// intrinsics, explicit __fmul_rn/__fadd_rn), 119 instructions per trial
// and column on the issue slots (its SASS, counted by chip_smoke.py); the
// 8 bytes per element of z and counts are nothing beside it.  The design
// draws only what can win, exactly:
//
// - |cos| <= 1 and rounding is monotone, so v <= z + r*|sigma| with r =
//   sqrtf(-2 logf(u1)) the draw's radius.  A column whose bound is <= vth0
//   cannot fire; one whose bound is strictly below a fired voltage already
//   seen in this trial cannot win (strict, so exact ties still count).
//   Two bounds, the first cheap: after the first hash every column is
//   bounded by z + R[b]*|sigma|, where R[b] is the largest radius over the
//   8192 values of u1 in its bucket b (the top 11 of its 24 bits), a table
//   the card computes once over all 2^24 values with the same logf and
//   sqrtf (wta_radius_table, which also finds the largest |cosf| over
//   every value of u2 for the caller to check); a survivor is bounded
//   again by its own radius before its angle (the second hash and cosf) is
//   drawn.
// - Lanes prune one by one, so the survivors of the bucket bound (a few
//   percent once a trial has a best) are compacted: a warp ballots them
//   into a ring in shared memory, and a full warp of them checks its
//   bucket bounds again against the latest best, then draws radius and
//   angle.  Each fired candidate at the warp's maximum keeps its column,
//   so the votes need no second pass (a warp with more than kTies columns
//   at its maximum, e.g. sigma = 0 on equal inputs, draws its columns
//   again to vote).  The first hashes of a lane's eight columns are
//   independent, the next step's z is loaded while this step's are drawn,
//   and a step in which no lane keeps a column costs one vote for the
//   whole warp.
// - Parallel work at a serving batch of 8: at wide rows each (row, trial)
//   is a cluster of up to 8 CTAs, each a slice of the columns, whose warps
//   publish every rise of their fired maximum to every CTA of the cluster
//   (atomicMax on distributed shared memory), so all prune against the
//   trial's best so far; after a cluster barrier each CTA's copy holds the
//   trial's fired maximum.  Each CTA stages the radius table in shared
//   memory.  The launch shape (wta_counts.wta_geometry) gives each warp
//   thousands of columns, so that its batch or two of full draws before
//   the trial's best prunes are paid back.
// - At narrow rows (C <= 512) a batch costs about as much as drawing every
//   column, so one warp runs one (row, trial) and draws every column,
//   eight pairs to a CTA over the CTA's rows of z staged in shared memory.
//
// Votes are float adds of 1.0 below 2^24, exact in any order, so the
// counts are deterministic.  The race (bounds, comparator, compaction, the
// shared maximum) is a device function over the draw, which supplies the
// bounds on |noise|: another noise source reuses it with its own draw.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "prng.cuh"

namespace cg = cooperative_groups;

namespace raca {

constexpr int kWtaWarps = 8;
constexpr int kWtaThreads = kWtaWarps * 32;
constexpr int kLaneCols = 8;        // columns a lane takes per step
constexpr int kStepCols = 32 * kLaneCols;   // columns a warp takes per step
constexpr int kRing = 512;          // queued candidates (col, u1 bits): at most 31 + 256
constexpr int kTies = 32;           // columns a warp keeps at its fired maximum
constexpr int kWarpModeMaxC = 512;  // one warp per (row, trial) up to this width
constexpr int kRadiusBuckets = 2048;   // the radius table: the top 11 bits of u1
constexpr int kBucketShift = 32 - 11;  // of the hash's 32 bits
constexpr unsigned kFull = 0xffffffffu;

// An int whose signed order is the float order (NaN never stored).
__device__ __forceinline__ int order_key(float f) {
  const int i = __float_as_int(f);
  return i >= 0 ? i : i ^ 0x7fffffff;
}
__device__ __forceinline__ float order_val(int k) {
  return __int_as_float(k >= 0 ? k : k ^ 0x7fffffff);
}

__device__ __forceinline__ float radius_of(uint32_t bits) {
  return sqrtf(__fmul_rn(-2.0f, logf(uniform01(bits))));
}

// The reference's Box-Muller draw (prng.cuh's gaussian) cut in stages,
// times sigma: noise(col, radius) with radius from bound(first(col)) is
// __fmul_rn(gaussian(base + col, seed), sigma) bit for bit, by the same
// operations in the same order.  bucket_bound(first(col)) >= bound(...)
// >= |noise(col, ...)|.
struct BoxMullerDraw {
  uint32_t base, seed;
  float sigma, abs_sigma;
  const float* rtab;   // kRadiusBuckets largest radii

  // the first hash: u1's bits
  __device__ __forceinline__ uint32_t first(uint32_t col) const {
    return hash_u32(base + col, seed);
  }
  // the largest radius of u1's bucket, times |sigma|
  __device__ __forceinline__ float bucket_bound(uint32_t bits) const {
    return __fmul_rn(rtab[bits >> kBucketShift], abs_sigma);
  }
  // the column's own radius (set), times |sigma|
  __device__ __forceinline__ float bound(uint32_t bits, float& radius) const {
    radius = radius_of(bits);
    return __fmul_rn(radius, abs_sigma);
  }
  __device__ __forceinline__ float noise(uint32_t col, float radius) const {
    const float u2 = uniform(base + col, seed + kGolden);
    return __fmul_rn(__fmul_rn(radius, cosf(__fmul_rn(kTwoPi, u2))), sigma);
  }
};

// A cluster per trial: every CTA holds a copy of the trial's best fired
// voltage (as an order_key), raised by every warp of every CTA.
struct ClusterShare {
  int* word;
  int n_cta;
  __device__ __forceinline__ float prune(float best) const {
    return fmaxf(best, order_val(*reinterpret_cast<volatile int*>(word)));
  }
  __device__ __forceinline__ void publish(float v) const {
    cg::cluster_group cl = cg::this_cluster();
    const int k = order_key(v);
    for (int r = 0; r < n_cta; ++r) atomicMax(cl.map_shared_rank(word, r), k);
  }
};

struct WarpRing {
  int col[kRing];
  uint32_t bits[kRing];
  int ties[kTies];
};

struct RaceResult {
  float best;  // the warp's fired maximum, -inf if none fired
  int n;       // its columns at best (ties[] holds the first kTies)
};

// A lane's kLaneCols columns from c on (4-aligned when vec); past hi they
// are unused.
__device__ __forceinline__ void load_lane(const float* zr, int c, int hi, bool vec,
                                          float (&z)[kLaneCols]) {
  if (vec && c + kLaneCols - 1 < hi) {
#pragma unroll
    for (int q = 0; q < kLaneCols / 4; ++q) {
      const float4 v = *reinterpret_cast<const float4*>(zr + c + 4 * q);
      z[4 * q] = v.x, z[4 * q + 1] = v.y, z[4 * q + 2] = v.z, z[4 * q + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kLaneCols; ++j) z[j] = c + j < hi ? zr[c + j] : 0.0f;
  }
}

__device__ __forceinline__ bool may_win(float ub, float vth0, float best) {
  return ub > vth0 && !(ub < best);
}

// The warp's part of one trial: columns [lo, hi) of the row zr, in steps of
// kStepCols, taking steps s0, s0 + ds, ...  Warp-uniform control flow: the
// ring's head and tail, best and n are the same in every lane.
template <class Draw>
__device__ __forceinline__ RaceResult race(const Draw& d, const ClusterShare& sh,
                                           const float* zr, bool vec, int lo, int hi, int s0,
                                           int ds, float vth0, WarpRing& w, int lane) {
  const unsigned lt = (1u << lane) - 1u;
  float best = -INFINITY;
  int n = 0;
  unsigned head = 0, tail = 0;

  // k queued candidates: their bucket bounds again against the latest
  // best, then radius, its bound and angle; the voltages race
  auto draw = [&](int k) {
    const float p = sh.prune(best);
    int col = 0;
    float z = 0.0f;
    uint32_t bits = 0;
    bool go = false;
    if (lane < k) {
      const unsigned e = (head + lane) & (kRing - 1);
      col = w.col[e];
      z = zr[col];
      bits = w.bits[e];
      go = may_win(__fadd_rn(z, d.bucket_bound(bits)), vth0, p);
    }
    head += k;
    __syncwarp();
    if (!__any_sync(kFull, go)) return;
    float v = -INFINITY;
    bool fired = false;
    if (go) {
      float r;
      if (may_win(__fadd_rn(z, d.bound(bits, r)), vth0, p)) {
        v = __fadd_rn(z, d.noise(static_cast<uint32_t>(col), r));
        fired = v > vth0;
      }
    }
    float m = fired ? v : -INFINITY;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(kFull, m, o));
    if (m > best) {
      best = m;
      n = 0;
      if (lane == 0) sh.publish(m);
    }
    const bool win = fired && v == best;
    const unsigned mk = __ballot_sync(kFull, win);
    const int at = n + __popc(mk & lt);
    if (win && at < kTies) w.ties[at] = col;
    n += __popc(mk);
    __syncwarp();
  };

  float z[kLaneCols];
  if (lo + s0 * kStepCols < hi) load_lane(zr, lo + s0 * kStepCols + lane * kLaneCols, hi, vec, z);
  for (int s = s0; lo + s * kStepCols < hi; s += ds) {
    const int c = lo + s * kStepCols + lane * kLaneCols;
    float zn[kLaneCols];   // the next step's z, in flight while this one is drawn
    if (lo + (s + ds) * kStepCols < hi) load_lane(zr, c + ds * kStepCols, hi, vec, zn);
    float p = __shfl_sync(kFull, sh.prune(best), 0);   // one value for the warp
    bool keep[kLaneCols], any = false;
    uint32_t bits[kLaneCols];
#pragma unroll
    for (int j = 0; j < kLaneCols; ++j) {   // independent first draws, no branches
      bits[j] = d.first(static_cast<uint32_t>(c + j));
      keep[j] = (c + j < hi) & may_win(__fadd_rn(z[j], d.bucket_bound(bits[j])), vth0, p);
      any |= keep[j];
    }
    if (__any_sync(kFull, any)) {
#pragma unroll
      for (int j = 0; j < kLaneCols; ++j) {
        const unsigned mk = __ballot_sync(kFull, keep[j]);
        if (keep[j]) {
          const unsigned e = (tail + __popc(mk & lt)) & (kRing - 1);
          w.col[e] = c + j;
          w.bits[e] = bits[j];
        }
        tail += __popc(mk);
      }
      __syncwarp();
    }
    // full warps of candidates, or whatever is queued while nothing has
    // fired yet, so that a best exists to prune against early
    while (tail - head >= 32 || (p == -INFINITY && tail != head)) {
      draw(min(static_cast<int>(tail - head), 32));
      p = fmaxf(p, best);
    }
#pragma unroll
    for (int j = 0; j < kLaneCols; ++j) z[j] = zn[j];
  }
  while (tail != head) draw(min(static_cast<int>(tail - head), 32));
  return {best, n};
}

// The warp's votes for a trial whose fired maximum is vmax.
template <class Draw>
__device__ __forceinline__ void vote(const Draw& d, const RaceResult& res, const WarpRing& w,
                                     const float* zr, int lo, int hi, int s0, int ds,
                                     float vth0, float vmax, float* cr, int lane) {
  if (res.n == 0 || !(res.best == vmax)) return;   // nothing fired here, or lost
  if (res.n <= kTies) {
    if (lane < res.n) atomicAdd(cr + w.ties[lane], 1.0f);
    return;
  }
  for (int s = s0; lo + s * kStepCols < hi; s += ds) {   // too many ties: draw again
    const int c = lo + s * kStepCols + lane * kLaneCols;
    for (int j = 0; j < kLaneCols && c + j < hi; ++j) {
      float r;
      d.bound(d.first(static_cast<uint32_t>(c + j)), r);
      const float v = __fadd_rn(zr[c + j], d.noise(static_cast<uint32_t>(c + j), r));
      if (v > vth0 && v == vmax) atomicAdd(cr + c + j, 1.0f);
    }
  }
}

// Every column of one trial drawn, one column a lane per step: the race
// at narrow rows, where a compacted batch (which costs about as much as 75
// full draws) cannot pay for itself.
template <class Draw>
__device__ __forceinline__ RaceResult race_all(const Draw& d, const float* zr, int C,
                                               float vth0, int* ties, int lane) {
  const unsigned lt = (1u << lane) - 1u;
  float best = -INFINITY;
  int n = 0;
  for (int c0 = 0; c0 < C; c0 += 32) {
    const int c = c0 + lane;
    float v = -INFINITY;
    if (c < C) {
      float r;
      d.bound(d.first(static_cast<uint32_t>(c)), r);
      v = __fadd_rn(zr[c], d.noise(static_cast<uint32_t>(c), r));
    }
    const bool fired = v > vth0;
    float m = fired ? v : -INFINITY;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(kFull, m, o));
    if (m > best) {
      best = m;
      n = 0;
    }
    const bool win = fired && v == best;
    const unsigned mk = __ballot_sync(kFull, win);
    const int at = n + __popc(mk & lt);
    if (win && at < kTies) ties[at] = c;
    n += __popc(mk);
  }
  __syncwarp();
  return {best, n};
}

// Wide rows: blockIdx.x = row * n_cta + rank, blockIdx.y = trial; the
// cluster (n_cta, 1, 1) is one (row, trial), each CTA of blockDim.x / 32
// warps a slice of cols_per_cta columns (a multiple of 4) read once, as
// float4 where the row is 16-byte aligned.
__global__ void __launch_bounds__(kWtaThreads) wta_cluster_kernel(
    const float* __restrict__ z, const int64_t* __restrict__ seed_p,
    const float* __restrict__ rtab, float* __restrict__ counts, int C, uint32_t c_pad,
    uint32_t trial_stride, int cols_per_cta, float vth0, float sigma) {
  __shared__ WarpRing rings[kWtaWarps];
  __shared__ __align__(16) float rs[kRadiusBuckets];
  __shared__ int best_word;
  cg::cluster_group cl = cg::this_cluster();
  const int n_cta = static_cast<int>(cl.num_blocks());
  const int rank = static_cast<int>(cl.block_rank());
  const int row = blockIdx.x / n_cta;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  for (int i = threadIdx.x; i < kRadiusBuckets / 4; i += blockDim.x)
    reinterpret_cast<float4*>(rs)[i] = reinterpret_cast<const float4*>(rtab)[i];
  const BoxMullerDraw d{static_cast<uint32_t>(row) * c_pad + blockIdx.y * trial_stride,
                        static_cast<uint32_t>(seed_p[0]), sigma, fabsf(sigma), rs};
  const int lo = rank * cols_per_cta, hi = min(C, lo + cols_per_cta);
  const float* zr = z + static_cast<int64_t>(row) * C;
  const bool vec = (reinterpret_cast<uintptr_t>(zr) & 15) == 0;
  if (threadIdx.x == 0) best_word = order_key(-INFINITY);
  cl.sync();   // the table loaded; every copy set before any CTA publishes into it
  const RaceResult res = race(d, ClusterShare{&best_word, n_cta}, zr, vec, lo, hi, warp,
                              warps, vth0, rings[warp], lane);
  cl.sync();   // every publish landed: the copy is the trial's fired maximum
  vote(d, res, rings[warp], zr, lo, hi, warp, warps, vth0, order_val(best_word),
       counts + static_cast<int64_t>(row) * C, lane);
}

// Narrow rows: warp w of CTA b runs pair p = 8b + w, row p / T, trial
// p % T, drawing every column; the CTA's rows of z are staged once in
// shared memory.
__global__ void __launch_bounds__(kWtaThreads) wta_warp_kernel(
    const float* __restrict__ z, const int64_t* __restrict__ seed_p,
    float* __restrict__ counts, int B, int C, uint32_t c_pad, uint32_t trial_stride,
    int n_trials, float vth0, float sigma) {
  constexpr int kStride = kWarpModeMaxC;
  __shared__ int ties[kWtaWarps][kTies];
  __shared__ float zs[kWtaWarps * kStride];
  const int64_t p0 = static_cast<int64_t>(blockIdx.x) * kWtaWarps;
  const int64_t total = static_cast<int64_t>(B) * n_trials;
  const int r0 = static_cast<int>(p0 / n_trials);
  const int r1 = static_cast<int>((min(p0 + kWtaWarps, total) - 1) / n_trials);
  for (int r = r0; r <= r1; ++r)
    for (int c = threadIdx.x; c < C; c += kWtaThreads)
      zs[(r - r0) * kStride + c] = z[static_cast<int64_t>(r) * C + c];
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t p = p0 + warp;
  if (p >= total) return;
  const int row = static_cast<int>(p / n_trials);
  const uint32_t t = static_cast<uint32_t>(p - static_cast<int64_t>(row) * n_trials);
  const BoxMullerDraw d{static_cast<uint32_t>(row) * c_pad + t * trial_stride,
                        static_cast<uint32_t>(seed_p[0]), sigma, fabsf(sigma), nullptr};
  const float* zr = zs + (row - r0) * kStride;
  const RaceResult res = race_all(d, zr, C, vth0, ties[warp], lane);
  float* cr = counts + static_cast<int64_t>(row) * C;
  if (res.n == 0) return;
  if (res.n <= kTies) {
    if (lane < res.n) atomicAdd(cr + ties[warp][lane], 1.0f);
    return;
  }
  for (int c = lane; c < C; c += 32) {   // too many ties: draw again
    float r;
    d.bound(d.first(static_cast<uint32_t>(c)), r);
    const float v = __fadd_rn(zr[c], d.noise(static_cast<uint32_t>(c), r));
    if (v > vth0 && v == res.best) atomicAdd(cr + c, 1.0f);
  }
}

// The radius table, over every value the draw's uniforms can take (2^24
// each): out[b] = the largest sqrtf(-2 logf(u1)) over the 8192 values of u1
// in bucket b, for b < kRadiusBuckets; out[kRadiusBuckets] = the largest
// |cosf(2 pi u2)|, which the bounds need to be <= 1.  out starts zeroed.
__global__ void wta_radius_table_kernel(int* out) {
  const uint32_t k = blockIdx.x * blockDim.x + threadIdx.x;   // u's top 24 bits
  float r = radius_of(k << 8);
  float c = fabsf(cosf(__fmul_rn(kTwoPi, uniform01(k << 8))));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {   // 32 consecutive k share a bucket
    r = fmaxf(r, __shfl_xor_sync(kFull, r, o));
    c = fmaxf(c, __shfl_xor_sync(kFull, c, o));
  }
  if ((threadIdx.x & 31) == 0) {
    atomicMax(out + (k >> (kBucketShift - 8)), __float_as_int(r));   // >= 0: int order
    atomicMax(out + kRadiusBuckets, __float_as_int(c));
  }
}

// Every column of every (row, trial) drawn in full, nothing pruned:
// blockIdx.z = row, blockIdx.y = trial t of gridDim.y, v[(row * T + t) * C
// + col] = the column's voltage where it fires, else -inf, by the same
// operations as the racing kernel.  wta_counts_cuda's exact check
// (wta_counts.full_draw_counts), and the plain per-element path whose SASS
// chip_smoke.py counts for the issue estimate of a trial-element.
__global__ void wta_draw_probe_kernel(const float* __restrict__ z, float* __restrict__ v,
                                      int C, uint32_t c_pad, uint32_t trial_stride,
                                      uint32_t seed, float sigma, float vth0) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= C) return;
  const uint32_t row = blockIdx.z, t = blockIdx.y, c = static_cast<uint32_t>(col);
  const float g = gaussian(row * c_pad + t * trial_stride + c, seed);
  // 32-bit offsets: the caller keeps b * n_trials * C below 2^31
  const float x = __fadd_rn(z[row * C + c], __fmul_rn(g, sigma));
  v[(row * gridDim.y + t) * C + c] = x > vth0 ? x : -INFINITY;
}

}  // namespace raca

// Plain C entry points for ctypes; each returns cudaGetLastError().
//
// wta_counts_launch: z and counts are (b, c) f32, contiguous, counts zeroed
// by the caller; seed points at one int64 holding a uint32; rtab is the
// radius table (wta_radius_table).  n_cta = 0 runs the narrow-row kernel
// (c <= 512), else clusters of n_cta (1..8) CTAs of warps (1..8) warps and
// cols_per_cta columns each (wta_counts.wta_geometry).
extern "C" int wta_counts_launch(const float* z, const int64_t* seed, const float* rtab,
                                 float* counts, int b, int c, int c_pad, unsigned trial_stride,
                                 int n_trials, float vth0, float sigma, int n_cta, int warps,
                                 int cols_per_cta, void* stream) {
  using namespace raca;
  if (b == 0 || c == 0 || n_trials == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_cta == 0) {
    if (c > kWarpModeMaxC) return static_cast<int>(cudaErrorInvalidValue);
    const int64_t blocks = (static_cast<int64_t>(b) * n_trials + kWtaWarps - 1) / kWtaWarps;
    wta_warp_kernel<<<static_cast<unsigned>(blocks), kWtaThreads, 0, s>>>(
        z, seed, counts, b, c, static_cast<uint32_t>(c_pad), trial_stride, n_trials, vth0,
        sigma);
    return static_cast<int>(cudaGetLastError());
  }
  if (warps < 1 || warps > kWtaWarps || n_cta > 8) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(b) * n_cta, n_trials);
  cfg.blockDim = dim3(32 * warps);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_cta;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, wta_cluster_kernel, z, seed, rtab, counts, c, static_cast<uint32_t>(c_pad),
      trial_stride, cols_per_cta, vth0, sigma);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// wta_resident_warps: how many warps of the cluster kernel the card holds
// at once with CTAs of `warps` warps (SMs x CTAs an SM x warps), or -1.
extern "C" int wta_resident_warps(int warps) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, raca::wta_cluster_kernel,
                                                    32 * warps, 0) != cudaSuccess)
    return -1;
  return sms * per_sm * warps;
}

// wta_radius_table: out is kRadiusBuckets + 1 zeroed int32 on the card,
// read as f32 (wta_radius_table_kernel).
extern "C" int wta_radius_table(int* out, void* stream) {
  raca::wta_radius_table_kernel<<<(1u << 24) / 256, 256, 0,
                                  static_cast<cudaStream_t>(stream)>>>(out);
  return static_cast<int>(cudaGetLastError());
}

// wta_draw_probe: z is (b, c) f32, v (b, n_trials, c) f32, both
// contiguous (wta_draw_probe_kernel); b and n_trials below 65536, b *
// n_trials * c below 2^31.
extern "C" int wta_draw_probe(const float* z, float* v, int b, int c, int c_pad,
                              unsigned trial_stride, int n_trials, unsigned seed, float sigma,
                              float vth0, void* stream) {
  if (b == 0 || c == 0 || n_trials == 0) return 0;
  if (b > 65535 || n_trials > 65535 || static_cast<int64_t>(b) * n_trials * c >= (1ll << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((c + 255) / 256, n_trials, b);
  raca::wta_draw_probe_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      z, v, c, static_cast<uint32_t>(c_pad), trial_stride, seed, sigma, vth0);
  return static_cast<int>(cudaGetLastError());
}
