// Flash attention forward for Hopper (sm_90a).
//
// Replaces faabric_tpu/ops/flash_attention.py::_flash_kernel (the Pallas
// kernel launched by _flash_forward). For q (B, S_q, H, D) and k, v
// (B, S_k, H, D) it writes O (B, S_q, H, D) in the input dtype and the
// per-row log-sum-exp lse (B*H, S_q) in fp32, with the online-softmax
// recurrence: fp32 running max m, sum l and accumulator acc; the (S, S)
// score matrix never reaches device memory.
//
// Semantics kept from the TPU kernel:
//   - the causal mask is end-aligned: query row i sees keys up to
//     i + causal_offset, causal_offset = S_k - S_q (the caller routes
//     causal S_q > S_k to the plain version);
//   - key tiles wholly above the diagonal are never visited (early exit);
//   - masked scores are -1e30, not -inf; p is rounded to the input dtype
//     before P.V while l sums the fp32 p, as the TPU kernel does.
// Ragged S_q and S_k are handled here with bounds masks: rows past S_q
// are not written, keys past S_k get p = 0 and read as zeros.
//
// Bound: at D = 64 a causal forward moves q, k, v and O once (8 B*H*S*64
// bytes) and does 4 * 64 flops per visible (query, key) pair, about S/2
// of them a row, so it does ~S/4 flops a byte: at the serving shape
// (8, 512, 8, 64) the bytes bound it (0.00505 ms at 3.35 TB/s against
// 0.0022 ms of products at 989 TFLOP/s), and the products bound it only
// from S ~ 1200 on (1 x 2048: 0.00434 ms against 0.00252). The
// caller picks one of three bodies (ops/flash_attention.py::_fwd_body); a
// body asked for operands it does not take returns an error:
//   - wgmma (bf16, D = 64, 16-byte aligned bases and strides): one CTA
//     per (batch*head, 64 query rows). A producer warp loads the CTA's Q
//     rows once and the K and V tiles, from key 0 to the causal last one,
//     by TMA into a ring of three 128-byte-swizzled stages signalled on
//     mbarriers (zero fill past S). One consumer warpgroup computes
//     S = Q.K^T on wgmma m64n64k16 from shared memory, the online softmax
//     on its accumulator fragments (row max and sum by quad shuffles, p
//     as one exp2 of the log2-scaled score; lse = (m2 + log2 l) ln 2),
//     and O += P.V with P rounded to bf16 and re-packed in registers as
//     the A operand and V read MN-major. Tile i's S product is issued
//     with tile i - 1's P.V, and tile i's softmax runs while P.V is still
//     on the tensor cores. Only tiles that straddle the causal diagonal
//     or the S_k edge are masked (TMA's zero keys score 0, not -1e30, so
//     the edge tile still is). A softmax step covers 64 keys, three CTAs
//     a SM; where the grid leaves at most two CTAs a SM anyway (one long
//     sequence), it covers 128 keys, which halves the steps of the
//     longest CTA's chain. Nothing here is limited by bytes or products
//     yet: each SM runs two or three warpgroups, each waiting on its own
//     chain of product, softmax and product per tile (PERF.md).
//   - mma (bf16 whose pairs are 4-byte aligned): warp-level tensor-core
//     products, mma.sync m16n8k16 bf16 with fp32 accumulators,
//     FlashAttention-2 style. Four warps own 16 query rows each and keep
//     Q's fragments, the scores of a 64-key tile and the output
//     accumulator in registers; the score accumulators are re-packed in
//     registers as the A operand of P.V. K/V tiles are staged
//     synchronously into shared memory with padded rows, so the fragment
//     loads are free of bank conflicts.
//   - fma (float32, and bf16 whose strides are odd): fp32 FMAs, D/16
//     threads per query row, each owning 16 of the D columns of q and of
//     the accumulator in registers; 32-key K/V tiles staged as fp32 in
//     shared memory and read as float4; the row's partial dot products
//     meet by warp shuffles.
//
// Layout: q, k and v are read through their (batch, seq, head) strides
// (last dim contiguous), so the model's q/k/v views need no copy. O is
// written contiguous.

#include <initializer_list>
#include <type_traits>

#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 32;   // FMA body's key tile

template <typename T, int D>
__global__ void __launch_bounds__(kBlockQ * (D / kColsPerThread))
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int n_heads, int s_q, int s_k,
                 Strides qs, Strides ks, Strides vs, float scale,
                 int causal) {
  constexpr int kTpr = D / kColsPerThread;   // threads per query row
  constexpr int kThreads = kBlockQ * kTpr;
  constexpr int kChunks = kColsPerThread / 4;  // float4 chunks per thread
  __shared__ float4 k_tile[kBlockK][D / 4];
  __shared__ float4 v_tile[kBlockK][D / 4];

  const int bh = blockIdx.x;
  const int b = bh / n_heads;
  const int h = bh % n_heads;
  // Heaviest causal tiles (last rows) are scheduled first
  const int q_tile = gridDim.y - 1 - blockIdx.y;
  const int q0 = q_tile * kBlockQ;
  const int tid = threadIdx.x;
  const int row = tid / kTpr;
  const int g = tid % kTpr;
  const int q_row = q0 + row;
  const bool row_valid = q_row < s_q;
  const int offset = s_k - s_q;

  // Thread g of a row owns float4 chunks g, g + kTpr, g + 2 kTpr, ...
  float qv[kColsPerThread];
  float acc[kColsPerThread];
  const T* qp = q + b * qs.b + int64_t(q_row) * qs.s + h * qs.h;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = 4 * (g + c * kTpr) + e;
      qv[4 * c + e] = row_valid ? to_float(qp[col]) : 0.f;
      acc[4 * c + e] = 0.f;
    }
  }
  float m = kNegInf;
  float l = 0.f;

  const T* kb = k + b * ks.b + h * ks.h;
  const T* vb = v + b * vs.b + h * vs.h;
  int n_tiles = (s_k + kBlockK - 1) / kBlockK;
  if (causal) {
    // Tiles strictly above the (offset) diagonal contribute nothing
    const int last = (q0 + offset + kBlockQ + kBlockK - 1) / kBlockK;
    n_tiles = last < n_tiles ? last : n_tiles;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBlockK;
    __syncthreads();  // the previous tile is no longer read
    float* kt = reinterpret_cast<float*>(k_tile);
    float* vt = reinterpret_cast<float*>(v_tile);
    for (int e = tid; e < kBlockK * D; e += kThreads) {
      const int j = e / D;
      const int col = e % D;
      const bool in = k0 + j < s_k;
      kt[e] = in ? to_float(kb[int64_t(k0 + j) * ks.s + col]) : 0.f;
      vt[e] = in ? to_float(vb[int64_t(k0 + j) * vs.s + col]) : 0.f;
    }
    __syncthreads();

    float s[kBlockK];
    float m_cur = kNegInf;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      float part = 0.f;
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const float4 kk = k_tile[j][g + c * kTpr];
        part += qv[4 * c] * kk.x + qv[4 * c + 1] * kk.y +
                qv[4 * c + 2] * kk.z + qv[4 * c + 3] * kk.w;
      }
#pragma unroll
      for (int off = kTpr / 2; off > 0; off >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      const int key = k0 + j;
      const bool visible = !causal || key <= q_row + offset;
      s[j] = visible ? part * scale : kNegInf;
      m_cur = fmaxf(m_cur, s[j]);
    }

    const float m_new = fmaxf(m, m_cur);
    const float corr = expf(m - m_new);
    float l_tile = 0.f;
#pragma unroll
    for (int c = 0; c < kColsPerThread; ++c) acc[c] *= corr;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      const float p = (k0 + j < s_k) ? expf(s[j] - m_new) : 0.f;
      l_tile += p;
      const float pv = round_like<T>(p);
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const float4 vv = v_tile[j][g + c * kTpr];
        acc[4 * c] += pv * vv.x;
        acc[4 * c + 1] += pv * vv.y;
        acc[4 * c + 2] += pv * vv.z;
        acc[4 * c + 3] += pv * vv.w;
      }
    }
    l = l * corr + l_tile;
    m = m_new;
  }

  if (!row_valid) return;
  T* op = o + ((int64_t(b) * s_q + q_row) * n_heads + h) * D;
  const float inv_l = 1.f / l;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      op[4 * (g + c * kTpr) + e] = from_float<T>(acc[4 * c + e] * inv_l);
  }
  if (g == 0) lse[int64_t(bh) * s_q + q_row] = m + logf(l);
}

// ---------------------------------------------------------------------------
// bf16 tensor-core body
// ---------------------------------------------------------------------------

constexpr int kMmaBlockK = 64;

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Fragment layout of mma.m16n8k16: see flash_common.cuh.
template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                     int n_heads, int s_q, int s_k, Strides qs, Strides ks,
                     Strides vs, float scale, int causal) {
  constexpr int kLd = D + 8;                 // padded shared-memory row
  constexpr int kDChunks = D / 16;           // k-steps of Q.K^T
  constexpr int kDBlocks = D / 8;            // n-blocks of P.V
  constexpr int kKeyBlocks = kMmaBlockK / 8; // n-blocks of Q.K^T
  __shared__ __align__(16) __nv_bfloat16 k_tile[kMmaBlockK * kLd];
  __shared__ __align__(16) __nv_bfloat16 v_tile[kMmaBlockK * kLd];

  const int bh = blockIdx.x;
  const int b = bh / n_heads;
  const int h = bh % n_heads;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockQ;  // heavy tiles first
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int g = (tid & 31) >> 2;
  const int t = tid & 3;
  const int row0 = q0 + warp * 16 + g;
  const int row1 = row0 + 8;
  const int offset = s_k - s_q;

  const __nv_bfloat16* qb = q + b * qs.b + h * qs.h;
  auto q_pair = [&](int row, int col) -> uint32_t {
    if (row >= s_q) return 0u;
    return *reinterpret_cast<const uint32_t*>(qb + int64_t(row) * qs.s + col);
  };
  uint32_t qa[kDChunks][4];
#pragma unroll
  for (int c = 0; c < kDChunks; ++c) {
    qa[c][0] = q_pair(row0, 16 * c + 2 * t);
    qa[c][1] = q_pair(row1, 16 * c + 2 * t);
    qa[c][2] = q_pair(row0, 16 * c + 2 * t + 8);
    qa[c][3] = q_pair(row1, 16 * c + 2 * t + 8);
  }

  float acc[kDBlocks][4];
#pragma unroll
  for (int n = 0; n < kDBlocks; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf;  // rows row0 and row1
  float l0 = 0.f, l1 = 0.f;          // this thread's share of l

  const __nv_bfloat16* kb = k + b * ks.b + h * ks.h;
  const __nv_bfloat16* vb = v + b * vs.b + h * vs.h;
  int n_tiles = (s_k + kMmaBlockK - 1) / kMmaBlockK;
  if (causal) {
    const int last = (q0 + offset + kBlockQ + kMmaBlockK - 1) / kMmaBlockK;
    n_tiles = last < n_tiles ? last : n_tiles;
  }

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * kMmaBlockK;
    __syncthreads();  // the previous tile is no longer read
    for (int w = tid; w < kMmaBlockK * D / 2; w += kMmaThreads) {
      const int j = w / (D / 2);
      const int col = 2 * (w % (D / 2));
      const bool in = k0 + j < s_k;
      const int64_t kr = int64_t(k0 + j);
      *reinterpret_cast<uint32_t*>(&k_tile[j * kLd + col]) =
          in ? *reinterpret_cast<const uint32_t*>(kb + kr * ks.s + col) : 0u;
      *reinterpret_cast<uint32_t*>(&v_tile[j * kLd + col]) =
          in ? *reinterpret_cast<const uint32_t*>(vb + kr * vs.s + col) : 0u;
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows and the tile's 64 keys
    float s[kKeyBlocks][4];
#pragma unroll
    for (int n = 0; n < kKeyBlocks; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      const __nv_bfloat16* kr = &k_tile[(n * 8 + g) * kLd + 2 * t];
#pragma unroll
      for (int c = 0; c < kDChunks; ++c) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(kr + 16 * c);
        const uint32_t b1 =
            *reinterpret_cast<const uint32_t*>(kr + 16 * c + 8);
        mma_bf16(s[n], qa[c], b0, b1);
      }
    }

    float mc0 = kNegInf, mc1 = kNegInf;
#pragma unroll
    for (int n = 0; n < kKeyBlocks; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + n * 8 + 2 * t + (e & 1);
        const int row = e < 2 ? row0 : row1;
        const bool visible = !causal || key <= row + offset;
        s[n][e] = visible ? s[n][e] * scale : kNegInf;
      }
      mc0 = fmaxf(mc0, fmaxf(s[n][0], s[n][1]));
      mc1 = fmaxf(mc1, fmaxf(s[n][2], s[n][3]));
    }
    const float mn0 = fmaxf(m0, quad_max(mc0));
    const float mn1 = fmaxf(m1, quad_max(mc1));
    const float corr0 = expf(m0 - mn0);
    const float corr1 = expf(m1 - mn1);
    float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
    for (int n = 0; n < kKeyBlocks; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + n * 8 + 2 * t + (e & 1);
        const float p =
            key < s_k ? expf(s[n][e] - (e < 2 ? mn0 : mn1)) : 0.f;
        s[n][e] = p;
      }
      ls0 += s[n][0] + s[n][1];
      ls1 += s[n][2] + s[n][3];
    }
    l0 = l0 * corr0 + ls0;
    l1 = l1 * corr1 + ls1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int n = 0; n < kDBlocks; ++n) {
      acc[n][0] *= corr0;
      acc[n][1] *= corr0;
      acc[n][2] *= corr1;
      acc[n][3] *= corr1;
    }

    // O += P V: P (rounded to bf16) is re-packed from the score
    // accumulators as the A operand, 16 keys per k-step
#pragma unroll
    for (int j = 0; j < kMmaBlockK / 16; ++j) {
      const uint32_t pa[4] = {pack_bf16(s[2 * j][0], s[2 * j][1]),
                              pack_bf16(s[2 * j][2], s[2 * j][3]),
                              pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                              pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
      const __nv_bfloat16* vr = &v_tile[(16 * j + 2 * t) * kLd + g];
#pragma unroll
      for (int n = 0; n < kDBlocks; ++n) {
        const __nv_bfloat16* vc = vr + n * 8;
        const uint32_t b0 = pack_bf16(vc[0], vc[kLd]);
        const uint32_t b1 = pack_bf16(vc[8 * kLd], vc[9 * kLd]);
        mma_bf16(acc[n], pa, b0, b1);
      }
    }
  }

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const float inv0 = 1.f / l0;
  const float inv1 = 1.f / l1;
#pragma unroll
  for (int n = 0; n < kDBlocks; ++n) {
    const int col = n * 8 + 2 * t;
    if (row0 < s_q)
      *reinterpret_cast<uint32_t*>(
          o + ((int64_t(b) * s_q + row0) * n_heads + h) * D + col) =
          pack_bf16(acc[n][0] * inv0, acc[n][1] * inv0);
    if (row1 < s_q)
      *reinterpret_cast<uint32_t*>(
          o + ((int64_t(b) * s_q + row1) * n_heads + h) * D + col) =
          pack_bf16(acc[n][2] * inv1, acc[n][3] * inv1);
  }
  if (t == 0) {
    if (row0 < s_q) lse[int64_t(bh) * s_q + row0] = m0 + logf(l0);
    if (row1 < s_q) lse[int64_t(bh) * s_q + row1] = m1 + logf(l1);
  }
}

// ---------------------------------------------------------------------------
// wgmma body (bf16, D = 64; layouts: hopper_common.cuh)
// ---------------------------------------------------------------------------

// K/V stages in the ring: with S issued a tile ahead, a third stage keeps
// the next tile's load from waiting on this tile's P.V (PERF.md)
constexpr int kFwdStages = 3;

using bf16 = __nv_bfloat16;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  int batch, n_heads, s_q, s_k;
  Strides qs, ks, vs;
  float scale;
  int causal;
};

struct FwdMaps {
  CUtensorMap q, k, v;
};

// A stage holds kSub 64-key sub-tiles of K and of V, each a TMA box, back
// to back: a 64 x 16 B operand of S = Q.K^T per sub-tile, and a 16 x 64
// MN-major B operand of P.V every 16 keys across them
template <int kSub>
struct FwdSmem {
  bf16 q[kTileElems];                                            // own rows
  bf16 k[kFwdStages][kSub * kTileElems], v[kFwdStages][kSub * kTileElems];
  uint64_t full[kFwdStages], empty[kFwdStages], own;
};

// Parity to wait for on a stage's barrier at key tile i: the consumers
// wait for fill number i / kFwdStages; the producer, before refilling,
// for the release of the fill before it (the first passes)
__device__ __forceinline__ uint32_t stage_parity(int i) {
  return (i / kFwdStages) & 1;
}

// Key tiles of kKeys the 64 query rows from qw need: up to the causal
// last one
template <int kKeys>
__device__ __forceinline__ int fwd_key_tiles(int qw, int s_k, int offset,
                                             int causal) {
  const int n = (s_k + kKeys - 1) / kKeys;
  if (!causal) return n;
  const int last = (qw + offset + kTileRows + kKeys - 1) / kKeys;
  return last < n ? last : n;
}

// Sub-tiles of the key tile from k0 that hold a key below S_k; the others
// are neither loaded nor read
template <int kSub>
__device__ __forceinline__ int live_subtiles(int k0, int s_k) {
  const int n = (s_k - k0 + kTileRows - 1) / kTileRows;
  return n < kSub ? n : kSub;
}

// Some key of the tile of kKeys from k0 is hidden from some row from qw:
// the tile straddles the causal diagonal or the S_k edge. Rows past S_q
// are never written, so they need no mask.
template <int kKeys>
__device__ __forceinline__ bool fwd_tile_needs_mask(int qw, int k0, int s_k,
                                                    int offset, int causal) {
  return k0 + kKeys > s_k || (causal && k0 + kKeys - 1 > qw + offset);
}

// One key tile of the online softmax on this thread's rows row0 and
// row0 + 8 (keys k0 + 64j + 8n + 2t (+1) in sub-tile j): masks, updates
// the running max m2 (in log2 units of the scaled score) and the thread's
// share of l, returns the accumulator's correction and P rounded to bf16
// as A operands, four a sub-tile
template <bool kMask, int kSub>
__device__ __forceinline__ void softmax_tile(float (&s)[kSub][8][4],
                                             uint32_t (&p)[kSub][4][4],
                                             float (&m2)[2], float (&l)[2],
                                             float (&corr)[2], const Args& a,
                                             int row0, int k0,
                                             float scale_log2, int t) {
  if (kMask) {
    const int offset = a.s_k - a.s_q;
#pragma unroll
    for (int j = 0; j < kSub; ++j)
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + kTileRows * j + 8 * n + 2 * t + (e & 1);
          const int row = row0 + 8 * (e >> 1);
          if (key >= a.s_k || (a.causal && key > row + offset))
            s[j][n][e] = kNegInf;
        }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < kSub; ++j)
#pragma unroll
      for (int n = 0; n < 8; ++n)
        mx = fmaxf(mx, fmaxf(s[j][n][2 * r], s[j][n][2 * r + 1]));
    const float m_new = fmaxf(m2[r], quad_max(mx) * scale_log2);
    corr[r] = exp2f(m2[r] - m_new);
    m2[r] = m_new;
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < kSub; ++j)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        s[j][n][e] = exp2f(fmaf(s[j][n][e], scale_log2, -m2[r]));
        sum[r] += s[j][n][e];
      }
  l[0] = l[0] * corr[0] + sum[0];
  l[1] = l[1] * corr[1] + sum[1];
#pragma unroll
  for (int j = 0; j < kSub; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      a_from_c(p[j][c], s[j][2 * c], s[j][2 * c + 1]);
}

// Issue S = Q.K^T for key tile i once its stage has landed (one commit
// group): one m64n64 product per live sub-tile
template <int kSub>
__device__ __forceinline__ void issue_scores(float (&s)[kSub][8][4],
                                             FwdSmem<kSub>& sm,
                                             uint64_t q_desc, int i,
                                             int live) {
  const int st = i % kFwdStages;
  mbar_wait(&sm.full[st], stage_parity(i));
#pragma unroll
  for (int j = 0; j < kSub; ++j) fence_operands(s[j]);
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < kSub; ++j) {
    if (j >= live) break;
    const uint64_t k_desc = wgmma_desc(sm.k[st] + j * kTileElems);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      wgmma_ss(s[j], q_desc + k_major_step(c), k_desc + k_major_step(c), c);
  }
  wgmma_commit();
}

// Issue O += P.V over the live sub-tiles of the V stage `v` (one commit
// group)
template <int kSub>
__device__ __forceinline__ void issue_pv(float (&acc)[8][4],
                                         const uint32_t (&p)[kSub][4][4],
                                         const bf16* v, int live) {
  fence_operands(acc);
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < kSub; ++j) {
    if (j >= live) break;
    const uint64_t v_desc = wgmma_desc(v + j * kTileElems);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      wgmma_rs_mn(acc, p[j][c], v_desc + mn_major_step(c));
  }
  wgmma_commit();
}

__device__ __forceinline__ void rescale(float (&acc)[8][4],
                                        const float (&corr)[2]) {
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    acc[n][0] *= corr[0];
    acc[n][1] *= corr[0];
    acc[n][2] *= corr[1];
    acc[n][3] *= corr[1];
  }
}

// CTAs a SM the registers allow: three with 64-key steps (at most 136
// registers a thread), two with 128-key steps (at most 204)
constexpr int fwd_min_ctas(int sub) { return sub == 1 ? 3 : 2; }

template <int kSub>
__global__ void __launch_bounds__(kWarpgroupThreads + 32, fwd_min_ctas(kSub))
flash_fwd_wgmma_kernel(const __grid_constant__ FwdMaps maps, Args a) {
  using Smem = FwdSmem<kSub>;
  constexpr int kKeys = kSub * kTileRows;
  Smem& sm = *reinterpret_cast<Smem*>(dynamic_smem_1024());
  const int bh = blockIdx.x;
  const int b = bh / a.n_heads;
  const int h = bh % a.n_heads;
  // Heaviest causal tiles (last rows) are scheduled first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTileRows;
  const int tid = threadIdx.x;
  const int offset = a.s_k - a.s_q;
  const int n_tiles = fwd_key_tiles<kKeys>(q0, a.s_k, offset, a.causal);

  if (tid == 0) {
    for (int s = 0; s < kFwdStages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], kWarpgroupThreads);
    }
    mbar_init(&sm.own, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= kWarpgroupThreads) {  // the producer warp
    if (tid == kWarpgroupThreads) {
      mbar_arrive_expect_tx(&sm.own, kTileBytes);
      tma_load_4d(sm.q, &maps.q, &sm.own, 0, h, q0, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kFwdStages;
        const int live = live_subtiles<kSub>(i * kKeys, a.s_k);
        mbar_wait(&sm.empty[s], stage_parity(i) ^ 1);
        mbar_arrive_expect_tx(&sm.full[s], 2 * live * kTileBytes);
        for (int j = 0; j < live; ++j) {
          const int k0 = i * kKeys + j * kTileRows;
          tma_load_4d(sm.k[s] + j * kTileElems, &maps.k, &sm.full[s], 0, h,
                      k0, b);
          tma_load_4d(sm.v[s] + j * kTileElems, &maps.v, &sm.full[s], 0, h,
                      k0, b);
        }
      }
    }
    return;
  }

  // The consumer warpgroup: this thread's rows row0 and row0 + 8
  const int warp = tid >> 5;
  const int g = (tid & 31) >> 2;
  const int t = tid & 3;
  const int row0 = q0 + warp * 16 + g;
  const float scale_log2 = a.scale * kLog2e;
  float acc[8][4], s[kSub][8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc[n][e] = 0.f;
#pragma unroll
      for (int j = 0; j < kSub; ++j) s[j][n][e] = 0.f;
    }
  float m2[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  float corr[2];
  uint32_t p[kSub][4][4];
  mbar_wait(&sm.own, 0);
  const uint64_t q_desc = wgmma_desc(sm.q);
  auto live = [&](int i) { return live_subtiles<kSub>(i * kKeys, a.s_k); };
  auto softmax = [&](uint32_t (&pt)[kSub][4][4], int i) {
    const int k0 = i * kKeys;
    if (fwd_tile_needs_mask<kKeys>(q0, k0, a.s_k, offset, a.causal))
      softmax_tile<true>(s, pt, m2, l, corr, a, row0, k0, scale_log2, t);
    else
      softmax_tile<false>(s, pt, m2, l, corr, a, row0, k0, scale_log2, t);
  };

  // S(i) and P(i-1).V(i-1) are issued together; tile i's softmax runs
  // while P.V is on the tensor cores, and the accumulator is rescaled
  // once it has retired
  issue_scores(s, sm, q_desc, 0, live(0));
  wgmma_wait_all();
#pragma unroll
  for (int j = 0; j < kSub; ++j) fence_operands(s[j]);
  softmax(p, 0);
  for (int i = 1; i < n_tiles; ++i) {
    issue_scores(s, sm, q_desc, i, live(i));
    issue_pv(acc, p, sm.v[(i - 1) % kFwdStages], live(i - 1));
    wgmma_wait_all_but_newest();  // S(i)
#pragma unroll
    for (int j = 0; j < kSub; ++j) fence_operands(s[j]);
    uint32_t p_next[kSub][4][4];
    softmax(p_next, i);
    wgmma_wait_all();  // P(i-1).V(i-1)
    fence_operands(acc);
    mbar_arrive(&sm.empty[(i - 1) % kFwdStages]);
    rescale(acc, corr);
#pragma unroll
    for (int j = 0; j < kSub; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) p[j][c][e] = p_next[j][c][e];
  }
  issue_pv(acc, p, sm.v[(n_tiles - 1) % kFwdStages], live(n_tiles - 1));
  wgmma_wait_all();
  fence_operands(acc);

  l[0] = quad_sum(l[0]);
  l[1] = quad_sum(l[1]);
  const float inv[2] = {1.f / l[0], 1.f / l[1]};
  rescale(acc, inv);
  store_c<64>(static_cast<bf16*>(a.o), acc, b, row0, a.s_q, a.n_heads, h, t);
  if (t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      // lse = ln(sum exp(score)) = (m2 + log2 l) ln 2
      if (row < a.s_q)
        a.lse[int64_t(bh) * a.s_q + row] =
            (m2[r] + log2f(l[r])) * 0.6931471805599453f;
    }
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

// The tensor-core body reads bf16 pairs as 32-bit words: every pointer
// and stride must keep pairs 4-byte aligned.
bool pairs_aligned(const Args& a) {
  return pair_aligned(a.q, a.qs) && pair_aligned(a.k, a.ks) &&
         pair_aligned(a.v, a.vs);
}

// The card's SM count, read once per device
cudaError_t sm_count(int* sms) {
  static int counts[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int& n = counts[dev & 63];
  if (n == 0)
    err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  *sms = n;
  return err;
}

template <int kSub>
cudaError_t launch_wgmma_steps(const FwdMaps& maps, const Args& a,
                               cudaStream_t stream) {
  const dim3 grid(a.batch * a.n_heads, (a.s_q + kTileRows - 1) / kTileRows);
  const int smem = sizeof(FwdSmem<kSub>) + 1024;
  static uint64_t smem_set = 0;
  const cudaError_t err = allow_smem(
      reinterpret_cast<const void*>(flash_fwd_wgmma_kernel<kSub>), smem,
      smem_set);
  if (err != cudaSuccess) return err;
  flash_fwd_wgmma_kernel<kSub>
      <<<grid, kWarpgroupThreads + 32, smem, stream>>>(maps, a);
  return cudaSuccess;
}

cudaError_t launch_wgmma(const Args& a, cudaStream_t stream) {
  FwdMaps maps{};
  if (!(bshd_tensor_map(&maps.q, a.q, a.batch, a.s_q, a.n_heads, a.qs) &&
        bshd_tensor_map(&maps.k, a.k, a.batch, a.s_k, a.n_heads, a.ks) &&
        bshd_tensor_map(&maps.v, a.v, a.batch, a.s_k, a.n_heads, a.vs)))
    return cudaErrorInvalidValue;
  // 128-key steps take more registers (two CTAs a SM, not three) but
  // halve the steps of the longest CTA's chain: they pay where the grid
  // leaves at most two CTAs a SM anyway
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const int64_t ctas = int64_t(a.batch) * a.n_heads *
                       ((a.s_q + kTileRows - 1) / kTileRows);
  return ctas <= 2 * sms ? launch_wgmma_steps<2>(maps, a, stream)
                         : launch_wgmma_steps<1>(maps, a, stream);
}

template <typename T, int D>
cudaError_t launch(const Args& a, int body, cudaStream_t stream) {
  constexpr bool kTensorCores = std::is_same_v<T, bf16>;
  if (body == kWgmmaBody) {
    if constexpr (kTensorCores && D == 64) return launch_wgmma(a, stream);
    return cudaErrorInvalidValue;
  }
  const dim3 grid(a.batch * a.n_heads, (a.s_q + kBlockQ - 1) / kBlockQ);
  if (body == kMmaBody) {
    if constexpr (kTensorCores) {
      if (!pairs_aligned(a)) return cudaErrorInvalidValue;
      flash_fwd_mma_kernel<D><<<grid, kMmaThreads, 0, stream>>>(
          static_cast<const T*>(a.q), static_cast<const T*>(a.k),
          static_cast<const T*>(a.v), static_cast<T*>(a.o), a.lse, a.n_heads,
          a.s_q, a.s_k, a.qs, a.ks, a.vs, a.scale, a.causal);
      return cudaSuccess;
    }
    return cudaErrorInvalidValue;
  }
  if (body != kFmaBody) return cudaErrorInvalidValue;
  flash_fwd_kernel<T, D><<<grid, kBlockQ * (D / kColsPerThread), 0, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<T*>(a.o), a.lse, a.n_heads,
      a.s_q, a.s_k, a.qs, a.ks, a.vs, a.scale, a.causal);
  return cudaSuccess;
}

template <typename T>
int dispatch_d(int d, const Args& a, int body, cudaStream_t stream) {
  cudaError_t err;
  switch (d) {
    case 16: err = launch<T, 16>(a, body, stream); break;
    case 32: err = launch<T, 32>(a, body, stream); break;
    case 64: err = launch<T, 64>(a, body, stream); break;
    case 128: err = launch<T, 128>(a, body, stream); break;
    default: err = cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. body: 0 = fma, 1 = mma, 2 = wgmma
// (a body that does not take the operands returns an error). Strides are
// in elements. Returns a cudaError_t as int.
extern "C" int faabric_flash_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse,
    int batch, int n_heads, int s_q, int s_k, int d, int64_t q_sb,
    int64_t q_ss, int64_t q_sh, int64_t k_sb, int64_t k_ss, int64_t k_sh,
    int64_t v_sb, int64_t v_ss, int64_t v_sh, float scale, int causal,
    int dtype, int body, void* stream) {
  if (batch <= 0 || n_heads <= 0 || s_q <= 0 || s_k <= 0) return 0;
  if ((s_q + kBlockQ - 1) / kBlockQ > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, o, static_cast<float*>(lse), batch, n_heads, s_q,
               s_k, Strides{q_sb, q_ss, q_sh}, Strides{k_sb, k_ss, k_sh},
               Strides{v_sb, v_ss, v_sh}, scale, causal};
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_d<float>(d, a, body, s);
  if (dtype == 1) return dispatch_d<bf16>(d, a, body, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
