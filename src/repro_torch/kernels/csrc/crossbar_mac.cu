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
// What bounds it on this card: operations.  2*M*K*N multiply-adds, which
// f32 FMAs on the CUDA cores (66.9 TFLOP/s) take 10x longer than the
// bytes; the tensor cores are 14.8x faster in bf16, but one bf16 pass
// rounds x to 8 bits, which the linear readout's gate (f32 summation
// error) cannot absorb.
//
// Design: the product runs in the level domain on the tensor cores.
// Wq = qstep * (C + center) + w_min with C = L - center an integer in
// [-center, center] (L the grid level, center = (levels - 1) / 2), so
//   z = qstep * (x @ C) + c0 * sum_k x,   c0 = w_min + center * qstep,
// and C is exact in bf16.  x splits exactly into three bf16 pieces
// x = x1 + x2 + x3 (x1 = bf16(x), x2 = bf16(x - x1), x3 = x - x1 - x2), so
// the three products xi . C are exact and only the f32 sums round.
//   1. crossbar_prepass_kernel (one launch): blocks 0..M-1 split a row of
//      x into the pieces (3, M, Kp) bf16 and sum it (f32, fixed order);
//      the other blocks quantize 64 x 64 tiles of W into C, transposed to
//      (N, Kp) bf16 so that both operands are K-major, and, with the
//      physical noise model, add each column's integer sum of C
//      (atomics on integers: exact in any order).  Kp is K rounded up to
//      64; the pieces and C are zero past K, so rows past K contribute
//      nothing to z or to sum_k Wq = qstep * sum C + c0 * K.
//   2. crossbar_gemm_kernel<BN>: one 128 x BN output tile per CTA.  A
//      producer warp keeps TMA loads of 64-column k-slices (the three
//      x pieces as one 128 x 64 x 3 box, C as a BN x 64 box, both under
//      the 128-byte swizzle) in flight in a ring of shared-memory stages;
//      two consumer warpgroups (64 rows each) issue 12 bf16 wgmma
//      m64nBNk16 per k-slice into a fresh f32 register tile and add it to
//      the running sum with round-to-nearest f32 adds on the CUDA cores,
//      so the tensor cores' truncating accumulation only ever sums one
//      slice.  Two register tiles alternate: slice k+1's products are
//      issued before slice k's are waited for, so the tensor cores never
//      drain between slices (acc and the two tiles hold 1.5 * BN floats
//      a thread, which bounds BN at 128).  The epilogue computes
//      qstep * acc + c0 * rowsum, adds the noise, applies the comparator
//      and stores from registers: z never leaves them.
// Unquantized reads (the serving canary, (1, 128) x (128, 8)) keep the
// f32 CUDA-core body, crossbar_mac_f32_kernel.
//
// Exactness against the plain version (kernels/ref.py:crossbar_mac_ref):
// the levels use the host's f32 rounding of 1/qstep and explicit
// __fmul_rn / __fsub_rn, so they are bit-identical, and so is the noise;
// z differs only by f32 summation order and by Wq's own f32 rounding.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "prng.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

namespace raca {

// ---------------------------------------------------------------------------
// Prepass: x pieces and row sums, W levels (transposed) and column sums.
// ---------------------------------------------------------------------------

constexpr int kPrepThreads = 256, kWTile = 64, kBK = 64, kPieces = 3;

struct LevelParams {
  float inv_qstep, w_min, w_max, center;
};

__device__ __forceinline__ float centered_level(float w, const LevelParams& q) {
  const float c = fminf(fmaxf(w, q.w_min), q.w_max);
  return __fsub_rn(rintf(__fmul_rn(__fsub_rn(c, q.w_min), q.inv_qstep)), q.center);
}

__device__ __forceinline__ void split3(float v, __nv_bfloat16& h1, __nv_bfloat16& h2,
                                       __nv_bfloat16& h3) {
  h1 = __float2bfloat16_rn(v);
  const float r1 = __fsub_rn(v, __bfloat162float(h1));   // exact
  h2 = __float2bfloat16_rn(r1);
  h3 = __float2bfloat16_rn(__fsub_rn(r1, __bfloat162float(h2)));  // exact: <= 8 bits left
}

// kVec: K % 4 == 0 and N % 4 == 0 with 16-byte aligned rows, so x and W
// are read as float4 (a 4-vector lies wholly in or out of range).
template <bool kVec>
__global__ void __launch_bounds__(kPrepThreads) crossbar_prepass_kernel(
    const float* __restrict__ x, const float* __restrict__ w, __nv_bfloat16* __restrict__ xs,
    float* __restrict__ rowsum, __nv_bfloat16* __restrict__ ct, int* __restrict__ colsum,
    int M, int K, int N, int Kp, int n_tiles_n, int physical, LevelParams lp) {
  __shared__ float red[kPrepThreads / 32];
  __shared__ __align__(16) __nv_bfloat16 tile[kWTile][kWTile + 8];  // [n][k]
  const int tid = threadIdx.x;
  if (blockIdx.x < static_cast<unsigned>(M)) {
    const int r = blockIdx.x;
    const float* xr = x + static_cast<size_t>(r) * K;
    const size_t plane = static_cast<size_t>(M) * Kp;
    __nv_bfloat16* d = xs + static_cast<size_t>(r) * Kp;
    float s = 0.f;
    if (kVec) {
      for (int k = tid * 4; k < Kp; k += kPrepThreads * 4) {
        const float4 v4 = k < K ? *reinterpret_cast<const float4*>(xr + k)
                                : make_float4(0.f, 0.f, 0.f, 0.f);
        const float v[4] = {v4.x, v4.y, v4.z, v4.w};
        __align__(8) __nv_bfloat16 h[3][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s = __fadd_rn(s, v[i]);
          split3(v[i], h[0][i], h[1][i], h[2][i]);
        }
#pragma unroll
        for (int p = 0; p < kPieces; ++p)
          *reinterpret_cast<uint2*>(d + p * plane + k) = *reinterpret_cast<const uint2*>(h[p]);
      }
    } else {
      for (int k = tid; k < Kp; k += kPrepThreads) {
        const float v = k < K ? xr[k] : 0.f;
        s = __fadd_rn(s, v);
        split3(v, d[k], d[plane + k], d[2 * plane + k]);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, o));
    if ((tid & 31) == 0) red[tid >> 5] = s;
    __syncthreads();
    if (tid == 0) {
      float t = 0.f;
#pragma unroll
      for (int i = 0; i < kPrepThreads / 32; ++i) t = __fadd_rn(t, red[i]);
      rowsum[r] = t;
    }
    return;
  }
  const int b = blockIdx.x - M;
  const int n0 = (b % n_tiles_n) * kWTile, k0 = (b / n_tiles_n) * kWTile;
  if (kVec) {  // thread: 4 columns n0 + 4*(tid % 16) .. +3 of rows k0 + tid / 16 + 16 j
    const int nl = (tid & 15) * 4;
#pragma unroll
    for (int j = 0; j < kWTile * kWTile / (4 * kPrepThreads); ++j) {
      const int kl = (tid >> 4) + 16 * j;
      const int gk = k0 + kl, gn = n0 + nl;
      float4 w4 = make_float4(0.f, 0.f, 0.f, 0.f);
      const bool ok = gk < K && gn < N;
      if (ok) w4 = *reinterpret_cast<const float4*>(w + static_cast<size_t>(gk) * N + gn);
      const float v[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
        tile[nl + i][kl] = __float2bfloat16_rn(ok ? centered_level(v[i], lp) : 0.f);
    }
  } else {
    const int nl = tid & (kWTile - 1);
#pragma unroll 4
    for (int j = 0; j < kWTile * kWTile / kPrepThreads; ++j) {
      const int kl = (tid >> 6) + (kPrepThreads / kWTile) * j;
      const int gk = k0 + kl, gn = n0 + nl;
      const float c =
          (gk < K && gn < N) ? centered_level(w[static_cast<size_t>(gk) * N + gn], lp) : 0.f;
      tile[nl][kl] = __float2bfloat16_rn(c);   // an integer of at most 8 bits: exact
    }
  }
  __syncthreads();
  {  // row nl2 of C^T: 64 k values = 128 bytes, four threads of 32 bytes each
    const int nl2 = tid >> 2, part = tid & 3;
    if (n0 + nl2 < N) {
      const uint4* src = reinterpret_cast<const uint4*>(&tile[nl2][part * 16]);
      uint4* dst = reinterpret_cast<uint4*>(ct + static_cast<size_t>(n0 + nl2) * Kp + k0 + part * 16);
      dst[0] = src[0];
      dst[1] = src[1];
    }
  }
  if (physical && tid < kWTile && n0 + tid < N) {
    int s = 0;
    for (int kl = 0; kl < kWTile; ++kl) s += static_cast<int>(__bfloat162float(tile[tid][kl]));
    atomicAdd(colsum + n0 + tid, s);
  }
}

// ---------------------------------------------------------------------------
// The tensor-core GEMM with the fused noise / comparator epilogue.
// ---------------------------------------------------------------------------

constexpr int kBM = 128, kGemmThreads = 384, kConsumerThreads = 256;
constexpr int kSmemLimit = 232448;

template <int BN>
struct GemmShape {
  static constexpr int kABytes = kPieces * kBM * kBK * 2;   // 3 pieces x 128 rows x 128 B
  static constexpr int kBBytes = BN * kBK * 2;              // a multiple of 1024 bytes
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kStagesFit = (kSmemLimit - 2048) / kStageBytes;
  static constexpr int kStages = kStagesFit < 4 ? kStagesFit : 4;
  static constexpr int kSmem = kStages * kStageBytes + 1024;   // + alignment slack
  static_assert(BN % 32 == 0 && BN <= 256, "wgmma N and the B box");
  static_assert(kStages >= 2, "at least a double buffer");
};

struct Epilogue {
  float qstep, c0, c_g0, c_ref, c_ktdf, c_vg;
};

// sum_k Wq of a column from its integer sum of C, then its Johnson noise
__device__ __forceinline__ float column_sigma(int sum_c, int K, const Epilogue& e) {
  const float sum_wq = __fadd_rn(__fmul_rn(e.qstep, static_cast<float>(sum_c)),
                                 __fmul_rn(e.c0, static_cast<float>(K)));
  return __fdiv_rn(sqrtf(__fmul_rn(e.c_ktdf, __fadd_rn(__fmul_rn(e.c_g0, sum_wq), e.c_ref))),
                   e.c_vg);
}

template <int BN>
__global__ void __launch_bounds__(kGemmThreads, 1) crossbar_gemm_kernel(
    const __grid_constant__ CUtensorMap tm_a, const __grid_constant__ CUtensorMap tm_b,
    const float* __restrict__ rowsum, const int* __restrict__ colsum,
    const float* __restrict__ sigma_ptr, float* __restrict__ out, int M, int N, int K, int nk,
    uint32_t n_padded, uint32_t seed, int binarize, int physical, Epilogue ep) {
  using S = GemmShape<BN>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  __shared__ uint64_t full[S::kStages], empty[S::kStages];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * BN;
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < S::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerThreads);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= kConsumerThreads) {  // producer warpgroup: one thread issues the loads
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == kConsumerThreads) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % S::kStages;
        if (kt >= S::kStages) mbar_wait(&empty[s], ((kt / S::kStages) - 1) & 1);
        uint8_t* st = smem + s * S::kStageBytes;
        mbar_arrive_expect(&full[s], S::kStageBytes);
        tma_load_3d(st, &tm_a, kt * kBK, m0, 0, &full[s]);
        tma_load_2d(st + S::kABytes, &tm_b, kt * kBK, n0, &full[s]);
      }
    }
  } else {  // two consumer warpgroups, 64 rows each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int wg = tid >> 7;
    float acc[BN / 2], p0[BN / 2], p1[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    // Slice kt's 12 products go into a fresh register tile while slice
    // kt-1's may still be in flight; then wait for kt-1, release its
    // stage and add it to the sum.  The first slice and the tail are
    // peeled so that on every path a tile is read only after a wait that
    // covers its products (else ptxas serializes the wgmma).
    auto issue = [&](int kt, float (&cur)[BN / 2]) {
      const int s = kt % S::kStages;
      mbar_wait(&full[s], (kt / S::kStages) & 1);
      const uint8_t* a = smem + s * S::kStageBytes + wg * 64 * kBK * 2;
      const uint8_t* b = smem + s * S::kStageBytes + S::kABytes;
      fence_operands(cur);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
#pragma unroll
        for (int p = 0; p < kPieces; ++p) {
          wgmma_bf16<BN>(cur, wgmma_desc(a + p * kBM * kBK * 2 + kk * 32),
                         wgmma_desc(b + kk * 32), (kk | p) != 0);
        }
      }
      wgmma_commit();
    };
    auto retire = [&](int kt, float (&prev)[BN / 2]) {
      fence_operands(prev);
      mbar_arrive(&empty[kt % S::kStages]);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = __fadd_rn(acc[i], prev[i]);
    };
    issue(0, p0);
    int kt = 1;
    for (; kt + 1 < nk; kt += 2) {
      issue(kt, p1);
      wgmma_wait<1>();
      retire(kt - 1, p0);
      issue(kt + 1, p0);
      wgmma_wait<1>();
      retire(kt, p1);
    }
    if (kt < nk) {
      issue(kt, p1);
      wgmma_wait<1>();
      retire(kt - 1, p0);
      wgmma_wait<0>();
      retire(kt, p1);
    } else {
      wgmma_wait<0>();
      retire(kt - 1, p0);
    }

    const int t = tid & 127, lane = t & 31;
    const int r0 = m0 + wg * 64 + (t >> 5) * 16 + (lane >> 2);
    const float sig_scalar = physical ? 0.f : *sigma_ptr;
    float rs[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + 8 * h;
      rs[h] = row < M ? __fmul_rn(ep.c0, rowsum[row]) : 0.f;
    }
    const bool pairs = (N & 1) == 0;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = n0 + j * 8 + 2 * (lane & 3);
      float sg[2];
#pragma unroll
      for (int c = 0; c < 2; ++c)
        sg[c] = (physical && col + c < N) ? column_sigma(colsum[col + c], K, ep) : sig_scalar;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r0 + 8 * h;
        if (row >= M || col >= N) continue;
        float v[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float z = __fadd_rn(__fmul_rn(ep.qstep, acc[j * 4 + h * 2 + c]), rs[h]);
          const uint32_t gidx = static_cast<uint32_t>(row) * n_padded + static_cast<uint32_t>(col + c);
          const float sum = __fadd_rn(z, __fmul_rn(gaussian(gidx, seed), sg[c]));
          v[c] = binarize ? (sum > 0.f ? 1.f : 0.f) : sum;
        }
        float* dst = out + static_cast<size_t>(row) * N + col;
        if (pairs) {   // col is even, so col + 1 < N too
          *reinterpret_cast<float2*>(dst) = make_float2(v[0], v[1]);
        } else {
          dst[0] = v[0];
          if (col + 1 < N) dst[1] = v[1];
        }
      }
    }
  }
}

template <int BN>
cudaError_t launch_gemm(const __nv_bfloat16* xs, const __nv_bfloat16* ct, const float* rowsum,
                        const int* colsum, const float* sigma, float* out, int m, int k, int n,
                        int kp, uint32_t n_padded, uint32_t seed, int binarize, int physical,
                        const Epilogue& ep, cudaStream_t stream) {
  using S = GemmShape<BN>;
  CUtensorMap tm_a, tm_b;
  const cuuint64_t dims_a[3] = {static_cast<cuuint64_t>(kp), static_cast<cuuint64_t>(m), kPieces};
  const cuuint64_t strides_a[2] = {static_cast<cuuint64_t>(kp) * 2,
                                   static_cast<cuuint64_t>(kp) * 2 * m};
  const cuuint32_t box_a[3] = {kBK, kBM, kPieces};
  cudaError_t err = encode_tiled(&tm_a, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, xs, dims_a,
                                 strides_a, box_a, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims_b[2] = {static_cast<cuuint64_t>(kp), static_cast<cuuint64_t>(n)};
  const cuuint64_t strides_b[1] = {static_cast<cuuint64_t>(kp) * 2};
  const cuuint32_t box_b[2] = {kBK, BN};
  err = encode_tiled(&tm_b, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, ct, dims_b, strides_b, box_b,
                     CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return err;
  static bool attr_set = false;
  if (!attr_set) {
    err = cudaFuncSetAttribute(crossbar_gemm_kernel<BN>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, S::kSmem);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const dim3 grid((n + BN - 1) / BN, (m + kBM - 1) / kBM);
  crossbar_gemm_kernel<BN><<<grid, kGemmThreads, S::kSmem, stream>>>(
      tm_a, tm_b, rowsum, colsum, sigma, out, m, n, k, kp / kBK, n_padded, seed, binarize,
      physical, ep);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Unquantized reads: f32 FMAs on the CUDA cores.
// ---------------------------------------------------------------------------

constexpr int kFBM = 128, kFBN = 128, kFBK = 8, kF32Threads = 256;

// One 256-thread block per 128 x 128 output tile, K in steps of 8 through
// double-buffered shared-memory tiles of x (stored transposed) and W; rows
// past K and columns past N are staged as zeros; each thread accumulates
// an 8 x 8 register block in ascending k order.
__global__ void __launch_bounds__(kF32Threads, 2) crossbar_mac_f32_kernel(
    const float* __restrict__ x, const float* __restrict__ w,
    const float* __restrict__ sigma_ptr, float* __restrict__ out, int M, int K, int N,
    uint32_t n_padded, uint32_t seed, int binarize, int physical, float c_g0, float c_ref,
    float c_ktdf, float c_vg) {
  __shared__ float As[2][kFBK][kFBM];
  __shared__ float Bs[2][kFBK][kFBN];
  __shared__ float sigma_s[kFBN];

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * kFBM, n0 = blockIdx.x * kFBN;
  // loaders: x row lm, k columns lk..lk+3; W row wk, columns wn..wn+3
  const int lm = tid >> 1, lk = (tid & 1) * 4;
  const int wk = tid >> 5, wn = (tid & 31) * 4;

  float xr[4], wr[4];
  auto load = [&](int k0) {
    const int gm = m0 + lm, gk = k0 + lk;
    const int hk = k0 + wk, hn = n0 + wn;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      xr[i] = (gm < M && gk + i < K) ? x[static_cast<size_t>(gm) * K + gk + i] : 0.f;
      wr[i] = (hk < K && hn + i < N) ? w[static_cast<size_t>(hk) * N + hn + i] : 0.f;
    }
  };
  auto stage = [&](int buf) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      As[buf][lk + i][lm] = xr[i];
      Bs[buf][wk][wn + i] = wr[i];
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  float colsum = 0.f;  // thread tid < kFBN: sum of W over k in column n0 + tid

  const int nk = (K + kFBK - 1) / kFBK;
  load(0);
  stage(0);
  __syncthreads();
  for (int t = 0; t < nk; ++t) {
    const int buf = t & 1;
    if (t + 1 < nk) load((t + 1) * kFBK);
    if (physical && tid < kFBN) {
#pragma unroll
      for (int kk = 0; kk < kFBK; ++kk) colsum = __fadd_rn(colsum, Bs[buf][kk][tid]);
    }
#pragma unroll
    for (int kk = 0; kk < kFBK; ++kk) {
      float a[8], b[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = As[buf][kk][ty * 4 + i];
        a[4 + i] = As[buf][kk][64 + ty * 4 + i];
        b[i] = Bs[buf][kk][tx * 4 + i];
        b[4 + i] = Bs[buf][kk][64 + tx * 4 + i];
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = __fmaf_rn(a[i], b[j], acc[i][j]);
    }
    if (t + 1 < nk) stage(buf ^ 1);
    __syncthreads();
  }

  if (tid < kFBN) {
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
    for (int j = 0; j < 8; ++j) {
      const int c = (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (n0 + c >= N) continue;
      const uint32_t gidx = static_cast<uint32_t>(row) * n_padded + static_cast<uint32_t>(n0 + c);
      const float s = __fadd_rn(acc[i][j], __fmul_rn(gaussian(gidx, seed), sigma_s[c]));
      out[static_cast<size_t>(row) * N + n0 + c] = binarize ? (s > 0.f ? 1.f : 0.f) : s;
    }
  }
}

}  // namespace raca

// Plain C entry points for ctypes.  Each returns cudaGetLastError().
//
// crossbar_prepass_launch: x (m, k) and w (k, n) f32, contiguous; writes
// xs (3, m, kp) bf16, rowsum (m) f32, ct (n, kp) bf16 and, when physical,
// adds into colsum (n) int32, which the caller zeroes.  kp is k rounded up
// to 64.  inv_qstep is the f32 rounding of the host's 1/qstep.
extern "C" int crossbar_prepass_launch(const float* x, const float* w, void* xs, float* rowsum,
                                       void* ct, int* colsum, int m, int k, int n, int kp,
                                       int physical, float inv_qstep, float w_min, float w_max,
                                       float center, void* stream) {
  using namespace raca;
  const int n_tiles_n = (n + kWTile - 1) / kWTile;
  const long long blocks = static_cast<long long>(m) + static_cast<long long>(n_tiles_n) * (kp / kWTile);
  if (blocks == 0) return 0;
  const auto aligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; };
  const bool vec = k % 4 == 0 && n % 4 == 0 && aligned(x) && aligned(w);
  const LevelParams lp{inv_qstep, w_min, w_max, center};
  auto* xs_ = static_cast<__nv_bfloat16*>(xs);
  auto* ct_ = static_cast<__nv_bfloat16*>(ct);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec) {
    crossbar_prepass_kernel<true><<<static_cast<unsigned>(blocks), kPrepThreads, 0, s>>>(
        x, w, xs_, rowsum, ct_, colsum, m, k, n, kp, n_tiles_n, physical, lp);
  } else {
    crossbar_prepass_kernel<false><<<static_cast<unsigned>(blocks), kPrepThreads, 0, s>>>(
        x, w, xs_, rowsum, ct_, colsum, m, k, n, kp, n_tiles_n, physical, lp);
  }
  return static_cast<int>(cudaGetLastError());
}

// crossbar_gemm_launch: the read from the prepass's outputs; out (m, n)
// f32; sigma is one f32 on the device (read unless physical).  tile_n is
// the output tile's width: 64 on every read, 96 and 128 for the tile
// sweep that chose it (chip_smoke.py).  The physical-noise
// constants arrive rounded to f32 as the reference's weakly typed Python
// floats round: c_g0 = g0, c_ref = 2 * k_rows * g_ref, c_ktdf = 4 k T df,
// c_vg = v_read * g0.
extern "C" int crossbar_gemm_launch(const void* xs, const void* ct, const float* rowsum,
                                    const int* colsum, const float* sigma, float* out, int m,
                                    int k, int n, int kp, int n_padded, unsigned seed,
                                    int binarize, int physical, float qstep, float c0,
                                    float c_g0, float c_ref, float c_ktdf, float c_vg,
                                    int tile_n, void* stream) {
  using namespace raca;
  if (m == 0 || n == 0) return 0;
  const auto* a = static_cast<const __nv_bfloat16*>(xs);
  const auto* b = static_cast<const __nv_bfloat16*>(ct);
  const Epilogue ep{qstep, c0, c_g0, c_ref, c_ktdf, c_vg};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t np = static_cast<uint32_t>(n_padded);
  cudaError_t err;
  switch (tile_n) {
    case 64: err = launch_gemm<64>(a, b, rowsum, colsum, sigma, out, m, k, n, kp, np, seed, binarize, physical, ep, s); break;
    case 96: err = launch_gemm<96>(a, b, rowsum, colsum, sigma, out, m, k, n, kp, np, seed, binarize, physical, ep, s); break;
    case 128: err = launch_gemm<128>(a, b, rowsum, colsum, sigma, out, m, k, n, kp, np, seed, binarize, physical, ep, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

// crossbar_mac_f32_launch: the unquantized read, x (m, k), w (k, n), out
// (m, n) f32, contiguous.
extern "C" int crossbar_mac_f32_launch(const float* x, const float* w, const float* sigma,
                                       float* out, int m, int k, int n, int n_padded,
                                       unsigned seed, int binarize, int physical, float c_g0,
                                       float c_ref, float c_ktdf, float c_vg, void* stream) {
  using namespace raca;
  if (m == 0 || n == 0) return 0;
  const dim3 grid((n + kFBN - 1) / kFBN, (m + kFBM - 1) / kFBM);
  crossbar_mac_f32_kernel<<<grid, kF32Threads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, w, sigma, out, m, k, n, static_cast<uint32_t>(n_padded), seed, binarize, physical,
      c_g0, c_ref, c_ktdf, c_vg);
  return static_cast<int>(cudaGetLastError());
}
