// Warp-level pieces of the attention kernels: 32-key chunks loaded as TMA
// page boxes (decode and prefill), and the tensor-core tile that attends
// 16 query rows over one chunk (prefill).
//
// Chunks.  A chunk is kChunk = 32 consecutive keys of one kv head.  With
// the pool (P, bs, Hkv, Dh) seen as the 3-D tensor (Dh, Hkv, P*bs), rows
// = min(bs, 32) keys of one page are the box (Dh, 1, rows), so a chunk is
// nb = 32 / rows boxes of K and of V, one cp.async.bulk.tensor each (lane
// l issues box l), completing on the stage's mbarrier; boxes at or past
// the live end are zero-filled instead.  int8 scale entries come by 4-byte
// cp.async.  One request per box matters: with 16-byte copies per lane,
// or one bulk copy per 160-byte row, issuing a chunk's loads took a warp
// about as long as computing on it.
//
// Tiles.  A warp holds 16 query rows as bf16 A fragments of
// mma.sync.m16n8k16 (row g and g+8 of lane 4g+t).  Q.K^T runs bf16 ->
// f32; the Dh^-0.5 scale multiplies the f32 scores (a scaled bf16 q would
// not be representable), int8 pools multiply k_scale/127 into them, then
// the soft-cap, the absolute-position mask and the online softmax in
// registers (quad shuffles for row max and sum).  P.V splits each f32
// weight (times v_scale/127 for int8) into a bf16 high and a bf16 low
// part, two MMAs that keep ~16 bits of it, with V fragments from
// ldmatrix.trans; the denominator keeps the unscaled sums.  int8 codes
// convert exactly to bf16 (|code| <= 127) into a per-warp work tile, K
// before the scores and V before P.V.
#pragma once

#include "attention_common.cuh"

namespace raca {

constexpr int kChunk = 32;    // keys per warp step
constexpr int kPad = 8;       // bf16 padding of the int8 work tile's rows

__host__ __device__ inline int round128(int b) { return (b + 127) / 128 * 128; }
__host__ __device__ inline int box_rows(int bs) { return bs < kChunk ? bs : kChunk; }
__host__ __device__ inline int box_slot_bytes(int bs, int dh, int kv_bytes) {
  return round128(box_rows(bs) * dh * kv_bytes);
}
// One ring stage: the K boxes, the V boxes, then (int8) the chunk's
// k_scale and v_scale entries; a multiple of 128 bytes.
__host__ __device__ inline int chunk_stage_bytes(int bs, int dh, int kv_bytes, bool int8) {
  return 2 * (kChunk / box_rows(bs)) * box_slot_bytes(bs, dh, kv_bytes) +
         (int8 ? 2 * kChunk * 4 : 0);
}
// A tensor-core warp's region: one stage and (int8) a bf16 work tile of
// kChunk rows, into which K and then V are converted; after its last
// chunk the same bytes hold its f32 (O, m, l).
__host__ __device__ inline int tc_warp_bytes(int bs, int dh, int kv_bytes, bool int8) {
  const int ring = chunk_stage_bytes(bs, dh, kv_bytes, int8) + (int8 ? kChunk * (dh + kPad) * 2 : 0);
  const int state = 16 * dh * 4 + 2 * 16 * 4;
  return round128(ring > state ? ring : state);
}

// Byte offset of key j of a chunk in a stage's K (or V) boxes.
struct ChunkRows {
  int slot, lr, rows, rb;
  __device__ __forceinline__ int at(int j) const {
    return (j >> lr) * slot + (j & (rows - 1)) * rb;
  }
};

__device__ __forceinline__ ChunkRows chunk_rows(int bs, int dh, int kv_bytes) {
  const int rows = box_rows(bs);
  return {box_slot_bytes(bs, dh, kv_bytes), __ffs(rows) - 1, rows, dh * kv_bytes};
}

// Page id of box `lane` of the chunk at key0 (0 for lanes past the chunk
// or boxes at or past key_hi); read one chunk ahead of its load.
__device__ __forceinline__ int chunk_page_id(const int* trow, int key0, int key_hi, int bs,
                                             int lane) {
  const int rows = box_rows(bs);
  const int key = key0 + lane * rows;
  return lane < kChunk / rows && key < key_hi ? trow[key / bs] : 0;
}

// Load keys [key0, key0 + kChunk) of kv head kh into stage `st`: boxes
// that start below key_hi by TMA on `bar` (page id `id` in lane l for box
// l; ids < 0 read the trash page 0), the others zero-filled, and the int8
// scale entries by cp.async (the caller commits the group).
template <typename TKV>
__device__ __forceinline__ void load_chunk(unsigned char* st, uint64_t* bar,
                                           const CUtensorMap* tm_k, const CUtensorMap* tm_v,
                                           const float* ks, const float* vs, int id, int key0,
                                           int key_hi, int bs, int hkv, int kh, int dh,
                                           int lane) {
  const int rows = box_rows(bs), lr = __ffs(rows) - 1, nb = kChunk / rows;
  const int slot = box_slot_bytes(bs, dh, sizeof(TKV));
  unsigned char* v_st = st + nb * slot;
  const int n_box = max(0, min((key_hi - key0 + rows - 1) / rows, nb));
  fence_proxy_async();  // earlier reads of this stage come first
  if (lane == 0) mbar_arrive_expect(bar, 2 * n_box * rows * dh * sizeof(TKV));
  __syncwarp();
  if (lane < n_box) {
    const int c2 = max(id, 0) * bs + (key0 + lane * rows) % bs;
    tma_load_3d(st + lane * slot, tm_k, 0, kh, c2, bar);
    tma_load_3d(v_st + lane * slot, tm_v, 0, kh, c2, bar);
  }
  for (int e = n_box * slot / 16 + lane; e < nb * slot / 16; e += 32) {
    reinterpret_cast<uint4*>(st)[e] = make_uint4(0, 0, 0, 0);
    reinterpret_cast<uint4*>(v_st)[e] = make_uint4(0, 0, 0, 0);
  }
  if (ks != nullptr) {
    float* sc = reinterpret_cast<float*>(v_st + nb * slot);
    const int rid = max(__shfl_sync(0xffffffffu, id, lane >> lr), 0);
    const int key = key0 + lane;
    if ((lane >> lr) < n_box) {
      const int64_t row = (static_cast<int64_t>(rid) * bs + key % bs) * hkv + kh;
      cp_async4(sc + lane, ks + row);
      cp_async4(sc + kChunk + lane, vs + row);
    } else {
      sc[lane] = sc[kChunk + lane] = 0.f;
    }
  }
}

__device__ __forceinline__ uint32_t ld_u32(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// Split two f32 weights into bf16 high and low parts (packed pairs).
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  hi = pack_bf16(h);
  lo = pack_bf16(__floats2bfloat162_rn(x0 - __low2float(h), x1 - __high2float(h)));
}

// kChunk int8 rows of a stage (K or V) -> the bf16 work tile (stride
// dh + kPad); exact, |code| <= 127.  16 codes per step.  The caller syncs
// the warp before and after.
__device__ __forceinline__ uint32_t i8x2_bf16(uint32_t w, int i) {  // bytes i, i + 1
  return pack_bf16(__floats2bfloat162_rn(i8_at(w, i), i8_at(w, i + 1)));
}
__device__ __forceinline__ void convert_rows_i8(const unsigned char* rows, ChunkRows raw,
                                                __nv_bfloat16* work, int dh, int lane) {
  const int per = dh / 16, ldk = dh + kPad;
  for (int c = lane; c < kChunk * per; c += 32) {
    const int j = c / per, e = 16 * (c - j * per);
    const uint4 v = *reinterpret_cast<const uint4*>(rows + raw.at(j) + e);
    uint4* dst = reinterpret_cast<uint4*>(work + j * ldk + e);
    dst[0] = make_uint4(i8x2_bf16(v.x, 0), i8x2_bf16(v.x, 2), i8x2_bf16(v.y, 0),
                        i8x2_bf16(v.y, 2));
    dst[1] = make_uint4(i8x2_bf16(v.z, 0), i8x2_bf16(v.z, 2), i8x2_bf16(v.w, 0),
                        i8x2_bf16(v.w, 2));
  }
}

// A warp's 16 query rows and online-softmax state, in registers, for
// head dim DH (a multiple of 16: prefill_attention.cu compiles the tile
// for each it takes).  Up to Dh = 128 the rows' A fragments stay in
// registers; above it they are read from a query tile in shared memory
// (rows of DH + kPad bf16) at each k-step, which leaves the registers to
// the 16 x DH f32 output.
template <int DH>
struct TcRows {
  static constexpr int kNT = kChunk / 8;  // score n-tiles of a chunk
  static constexpr int kKS = DH / 16;     // k-steps over Dh
  static constexpr int kDT = DH / 8;      // output n-tiles over Dh
  static constexpr bool kQSmem = DH > 128;
  uint32_t qf[kQSmem ? 1 : kKS][4];
  const __nv_bfloat16* q_tile;  // kQSmem: the staged rows
  float o[kDT][4];
  float w[kNT][4];  // the current chunk's scores, then weights
  float m_a, m_b, l_a, l_b;

  __device__ __forceinline__ void zero_state() {
#pragma unroll
    for (int d = 0; d < kDT; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
    m_a = m_b = NEG_INF;
    l_a = l_b = 0.f;
  }

  // kQSmem: the rows are the 16 rows of `tile` (stride DH + kPad).
  __device__ __forceinline__ void init_smem(const __nv_bfloat16* tile) {
    q_tile = tile;
    zero_state();
  }

  // Rows a (gid) and b (gid + 8) of the lane's quad from row pointers
  // (null: a padding row of zeros).
  __device__ __forceinline__ void init(const __nv_bfloat16* qa, const __nv_bfloat16* qb,
                                       int tg) {
#pragma unroll
    for (int s = 0; s < kKS; ++s) {
      const int col = s * 16 + tg * 2;
      qf[s][0] = qa ? ld_u32(qa + col) : 0u;
      qf[s][1] = qb ? ld_u32(qb + col) : 0u;
      qf[s][2] = qa ? ld_u32(qa + col + 8) : 0u;
      qf[s][3] = qb ? ld_u32(qb + col + 8) : 0u;
    }
    zero_state();
  }

  // Scores of one chunk: keys key0 + j (j < kChunk) from bf16 rows at
  // k_rows + rr.at(j); rows a and b sit at absolute positions pa and pb;
  // keys at or past key_hi are masked.  ksc/vsc: the chunk's int8 scale
  // entries, or null.  Updates (m, l), rescales O and leaves the chunk's
  // weights, times v_scale/127 for int8, in w.
  __device__ __forceinline__ void scores(const unsigned char* k_rows, ChunkRows rr,
                                         const float* ksc, const float* vsc, int key0,
                                         int key_hi, int pa, int pb, int local,
                                         int local_window, float softcap, float scale,
                                         int lane) {
    const int gid = lane >> 2, tg = lane & 3;
    if constexpr (kQSmem) {
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) w[nt][0] = w[nt][1] = w[nt][2] = w[nt][3] = 0.f;
      const __nv_bfloat16* qa = q_tile + gid * (DH + kPad) + tg * 2;
      const __nv_bfloat16* qb = qa + 8 * (DH + kPad);
#pragma unroll 4
      for (int s = 0; s < kKS; ++s) {
        const uint32_t a0 = ld_u32(qa + s * 16), a1 = ld_u32(qb + s * 16);
        const uint32_t a2 = ld_u32(qa + s * 16 + 8), a3 = ld_u32(qb + s * 16 + 8);
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
          const unsigned char* kr = k_rows + rr.at(nt * 8 + gid) + tg * 4 + s * 32;
          mma_bf16(w[nt], a0, a1, a2, a3, ld_u32(kr), ld_u32(kr + 16));
        }
      }
    } else {
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        w[nt][0] = w[nt][1] = w[nt][2] = w[nt][3] = 0.f;
        const unsigned char* kr = k_rows + rr.at(nt * 8 + gid) + tg * 4;
#pragma unroll
        for (int s = 0; s < kKS; ++s)
          mma_bf16(w[nt], qf[s][0], qf[s][1], qf[s][2], qf[s][3], ld_u32(kr + s * 32),
                   ld_u32(kr + s * 32 + 16));
      }
    }
    float mx_a = m_a, mx_b = m_b;
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kk = nt * 8 + tg * 2 + (e & 1);
        const int j = key0 + kk;
        const int qp = e < 2 ? pa : pb;
        float x = w[nt][e] * scale;
        if (ksc) x *= ksc[kk] / 127.f;
        if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
        bool ok = j <= qp && j < key_hi;
        if (local) ok = ok && j > qp - local_window;
        x = ok ? x : NEG_INF;
        w[nt][e] = x;
        if (e < 2) mx_a = fmaxf(mx_a, x); else mx_b = fmaxf(mx_b, x);
      }
    }
#pragma unroll
    for (int sh = 1; sh < 4; sh <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, sh));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, sh));
    }
    const float al_a = expf(m_a - mx_a), al_b = expf(m_b - mx_b);
    m_a = mx_a;
    m_b = mx_b;
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pr = expf(w[nt][e] - (e < 2 ? m_a : m_b));
        if (e < 2) sum_a += pr; else sum_b += pr;  // unscaled denominator
        w[nt][e] = vsc ? pr * (vsc[nt * 8 + tg * 2 + (e & 1)] / 127.f) : pr;
      }
    }
    l_a = l_a * al_a + sum_a;  // per-lane partial sums, quad-reduced at the end
    l_b = l_b * al_b + sum_b;
#pragma unroll
    for (int d = 0; d < kDT; ++d) {
      o[d][0] *= al_a;
      o[d][1] *= al_a;
      o[d][2] *= al_b;
      o[d][3] *= al_b;
    }
  }

  // O += w V for the chunk's bf16 V rows at v_rows + rr.at(j), with w
  // split into bf16 high and low parts.
  __device__ __forceinline__ void accumulate(const unsigned char* v_rows, ChunkRows rr,
                                             int lane) {
#pragma unroll
    for (int kk = 0; kk < kChunk / 16; ++kk) {
      uint32_t hi[4], lo[4];
      split_bf16(w[2 * kk][0], w[2 * kk][1], hi[0], lo[0]);
      split_bf16(w[2 * kk][2], w[2 * kk][3], hi[1], lo[1]);
      split_bf16(w[2 * kk + 1][0], w[2 * kk + 1][1], hi[2], lo[2]);
      split_bf16(w[2 * kk + 1][2], w[2 * kk + 1][3], hi[3], lo[3]);
      const unsigned char* vr = v_rows + rr.at(kk * 16 + (lane & 15));
#pragma unroll
      for (int d = 0; d < kDT; ++d) {
        uint32_t b0, b1;
        asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
                     : "=r"(b0), "=r"(b1)
                     : "r"(smem_u32(vr + d * 16)));
        mma_bf16(o[d], hi[0], hi[1], hi[2], hi[3], b0, b1);
        mma_bf16(o[d], lo[0], lo[1], lo[2], lo[3], b0, b1);
      }
    }
  }

  // The warp's (O (16, Dh) row-major, m[16], l[16]) into `region` (f32),
  // after reducing the lane-partial sums over each quad.
  __device__ __forceinline__ void store(float* region, int lane) {
    const int gid = lane >> 2, tg = lane & 3;
#pragma unroll
    for (int sh = 1; sh < 4; sh <<= 1) {
      l_a += __shfl_xor_sync(0xffffffffu, l_a, sh);
      l_b += __shfl_xor_sync(0xffffffffu, l_b, sh);
    }
#pragma unroll
    for (int d = 0; d < kDT; ++d) {
      const int col = d * 8 + tg * 2;
      *reinterpret_cast<float2*>(region + gid * DH + col) = make_float2(o[d][0], o[d][1]);
      *reinterpret_cast<float2*>(region + (gid + 8) * DH + col) = make_float2(o[d][2], o[d][3]);
    }
    if (tg == 0) {
      region[16 * DH + gid] = m_a;
      region[16 * DH + gid + 8] = m_b;
      region[16 * DH + 16 + gid] = l_a;
      region[16 * DH + 16 + gid + 8] = l_b;
    }
  }
};

// Combine element (row, d) of n_warps stored states, `stride` floats
// apart: returns (sum_w O_w e^(m_w - m*), sum_w l_w e^(m_w - m*), m*).
__device__ __forceinline__ float3 merge_states(const float* base, int stride, int n_warps,
                                               int dh, int row, int d) {
  float mx = NEG_INF;
  for (int v = 0; v < n_warps; ++v) mx = fmaxf(mx, base[v * stride + 16 * dh + row]);
  float a = 0.f, l = 0.f;
  for (int v = 0; v < n_warps; ++v) {
    const float* w = base + v * stride;
    const float wgt = expf(w[16 * dh + row] - mx);
    a += w[row * dh + d] * wgt;
    l += w[16 * dh + 16 + row] * wgt;
  }
  return make_float3(a, l, mx);
}

}  // namespace raca
