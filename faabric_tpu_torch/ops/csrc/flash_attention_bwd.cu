// Flash attention backward for Hopper (sm_90a): the dQ pass, with the row
// correction fused in, and the dK/dV pass.
//
// Replaces faabric_tpu/ops/flash_attention.py::_flash_bwd_dq_kernel and
// ::_flash_bwd_dkv_kernel (both launched by _run_bwd_kernels). Inputs are
// the forward's q (B, S_q, H, D), k and v (B, S_k, H, D), its output O
// (like q), the output's cotangent dO (like q), the forward's per-row
// log-sum-exp lse (B*H, S_q) fp32 and, optionally, the lse's cotangent
// g_lse (B*H, S_q) fp32.
//
// Two passes and no atomics, as on the TPU, so the result is
// deterministic:
//   - dQ: one CTA per (batch*head, 64-row q tile). It first computes the
//     row correction delta = rowsum(dO * O) - g_lse in fp32 for its rows
//     and writes it out as (B*H, S_q) fp32 (the JAX package computes it
//     outside its kernels); then it streams K/V tiles, recomputes
//     P = exp(s - lse), dP = dO.V^T, dS = P * (dP - delta) * scale and
//     accumulates dQ = sum dS.K;
//   - dK/dV, launched after it on the same stream and reading its delta:
//     one CTA per (batch*head, 64-key tile) streams q tiles from the first
//     one that can see the tile's first key (causal: (k0 - causal_offset)
//     / tile), recomputes P and dS the same way and accumulates
//     dV = sum P^T.dO and dK = sum dS^T.Q.
// The (S_q, S_k) matrices never reach device memory.
//
// Semantics kept from the TPU kernels: the end-aligned causal mask (query
// row i sees keys up to i + causal_offset, causal_offset = S_k - S_q; the
// caller routes causal S_q > S_k to the plain version), masked entries
// give P = 0, and the rounding points: P is recomputed in fp32, P is
// rounded to dO's dtype before P^T.dO, dO is in V's dtype for dO.V^T, dS
// is rounded to K's and Q's dtype before dS.K and dS^T.Q; all sums are
// fp32. Ragged S_q and S_k: rows past S_q and keys past S_k get P = 0 and
// are not written.
//
// Bound: at the training shapes (bf16, D = 64, S = 512) each pass moves
// ~21-25 MB against 3-4 GFLOP, so both are bound by bytes on paper; what
// holds a kernel back is the latency of its chain of loads, products and
// exponentials per tile. The caller picks one of three bodies per pass
// (ops/flash_attention.py::_bwd_body); a body asked for a shape it does not
// take returns an error:
//   - wgmma (bf16, D = 64, 16-byte aligned bases and strides): a producer
//     warp keeps TMA loads of the streamed tiles (K and V for dQ; Q, dO
//     and their 64 lse and delta values for dK/dV) in flight in a ring of
//     two 128-byte-swizzled stages, signalled on mbarriers; the CTA's own
//     64 rows (Q, dO and O for dQ; K and V for dK/dV) arrive once by TMA,
//     which also zero-fills rows past S. One consumer warpgroup runs the
//     products on wgmma m64n64k16: S = Q.K^T and dP = dO.V^T (dQ pass), or
//     S^T = K.Q^T and dP^T = V.dO^T (dK/dV pass), with both operands read
//     from shared memory; then dQ += dS.K, dV += P^T.dO and dK += dS^T.Q
//     with dS, P^T and dS^T re-packed from the accumulators as A operands
//     in registers and K, dO and Q read MN-major. The loop is software
//     pipelined: the next tile's first products are issued behind this
//     tile's second ones, and a stage goes back to the producer once the
//     products that read it have retired. P is exp2 of the score's
//     exponent scaled by log2(e) (one MUFU op; same function and rounding
//     points, last bits of fp32 P may differ from expf's). Only tiles
//     that straddle the causal diagonal or a ragged edge are masked.
//     Registers bound the CTAs a SM (launch bounds below).
//   - mma (bf16, D <= 64, bf16 pairs 4-byte aligned): warp-level
//     mma.sync m16n8k16 with fp32 accumulators; four warps own 16 rows
//     each (query rows in the dQ pass, key rows in the dK/dV pass); the
//     streamed tiles are staged synchronously into padded shared rows.
//   - fma (float32, bf16 whose strides are odd, D = 128): fp32 FMAs, D/16
//     threads per row, each owning 16 columns of the row's operands and
//     accumulators in registers; 32-row tiles of the streamed operands
//     staged as fp32 in shared memory and read as float4; dot products
//     meet by warp shuffles. At D = 128 a tensor-core body would keep 256
//     fp32 values a thread and spill.

#include <cstdint>
#include <type_traits>

#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace {

constexpr int kRows = 64;     // rows a CTA owns: queries (dQ), keys (dK/dV)
constexpr int kFmaTile = 32;  // fma bodies: streamed rows per step
constexpr int kMmaTile = 64;  // mma and wgmma bodies: streamed rows per step

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const void* out;      // dQ pass: O, for delta
  const float* lse;
  const float* g_lse;   // dQ pass: optional lse cotangent (may be null)
  const float* delta;   // dK/dV pass: delta as the dQ pass wrote it
  float* delta_out;     // dQ pass: delta, (B*H, S_q)
  void* dq;
  void* dk;
  void* dv;
  int batch, n_heads, s_q, s_k;
  Strides qs, ks, vs, dos, os;
  float scale;
  int causal;
};

// Query row `row` sees key `key`: both in bounds and, when causal, the key
// at or before the row's end-aligned diagonal
__device__ __forceinline__ bool visible(int row, int key, int s_q, int s_k,
                                        int offset, int causal) {
  return row < s_q && key < s_k && (!causal || key <= row + offset);
}

// A kRows x kMmaTile tile of (query rows from q0, keys from k0) that some
// entry of is not visible: it straddles the diagonal or a ragged edge
__device__ __forceinline__ bool tile_needs_mask(int q0, int k0, int s_q,
                                                int s_k, int offset,
                                                int causal) {
  return q0 + kRows > s_q || k0 + kMmaTile > s_k ||
         (causal && k0 + kMmaTile - 1 > q0 + offset);
}

// Number of streamed key tiles a causal q tile [q0, q0 + kRows) needs
template <int kTile>
__device__ __forceinline__ int key_tiles(int q0, int s_k, int offset,
                                         int causal) {
  const int n = (s_k + kTile - 1) / kTile;
  if (!causal) return n;
  const int last = (q0 + offset + kRows + kTile - 1) / kTile;
  return last < n ? last : n;
}

// First streamed q tile that can see key k0 (the TPU kernel's j_start)
template <int kTile>
__device__ __forceinline__ int first_query_tile(int k0, int offset,
                                                int causal) {
  return (causal && k0 > offset) ? (k0 - offset) / kTile : 0;
}

// Row `row` of delta: rowsum(dO * O) over the row's partial sum `dot`,
// less g_lse; written out once per row (by the thread with `writer`)
__device__ __forceinline__ float finish_delta(const BwdArgs& a, int bh,
                                              int row, float dot,
                                              bool writer) {
  if (row >= a.s_q) return 0.f;
  const int64_t i = int64_t(bh) * a.s_q + row;
  const float delta = a.g_lse != nullptr ? dot - a.g_lse[i] : dot;
  if (writer) a.delta_out[i] = delta;
  return delta;
}

// ---------------------------------------------------------------------------
// fma bodies
// ---------------------------------------------------------------------------

// Row `r` of a (B, S, H, D) operand of this CTA's (b, h), as fp32 into the
// thread's 16 columns (chunks g, g + kTpr, ... of 4), zero past `s`
template <typename T, int kTpr>
__device__ __forceinline__ void load_row(float (&dst)[kColsPerThread],
                                         const T* base, const Strides& st,
                                         int r, int s, int g) {
  const T* p = base + int64_t(r) * st.s;
#pragma unroll
  for (int c = 0; c < kColsPerThread / 4; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      dst[4 * c + e] = r < s ? to_float(p[4 * (g + c * kTpr) + e]) : 0.f;
}

// Rows [r0, r0 + kFmaTile) of an operand into a shared fp32 tile, zero
// past `s`
template <typename T, int D, int kThreads>
__device__ __forceinline__ void stage_rows(float* tile, const T* base,
                                           const Strides& st, int r0, int s,
                                           int tid) {
  for (int e = tid; e < kFmaTile * D; e += kThreads) {
    const int j = e / D;
    const int col = e % D;
    tile[e] = r0 + j < s ? to_float(base[int64_t(r0 + j) * st.s + col]) : 0.f;
  }
}

// Sum of v over the kTpr threads of a row
template <int kTpr>
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = kTpr / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// This thread's share of the dot products of a shared row with two
// register rows, summed over the row's kTpr threads
template <int kTpr>
__device__ __forceinline__ void dot2(const float4* row_a, const float4* row_b,
                                     const float (&x)[kColsPerThread],
                                     const float (&y)[kColsPerThread], int g,
                                     float& xa, float& yb) {
  xa = 0.f;
  yb = 0.f;
#pragma unroll
  for (int c = 0; c < kColsPerThread / 4; ++c) {
    const float4 a = row_a[g + c * kTpr];
    const float4 b = row_b[g + c * kTpr];
    xa += x[4 * c] * a.x + x[4 * c + 1] * a.y + x[4 * c + 2] * a.z +
          x[4 * c + 3] * a.w;
    yb += y[4 * c] * b.x + y[4 * c + 1] * b.y + y[4 * c + 2] * b.z +
          y[4 * c + 3] * b.w;
  }
  xa = row_sum<kTpr>(xa);
  yb = row_sum<kTpr>(yb);
}

template <int kTpr>
__device__ __forceinline__ void axpy(float (&acc)[kColsPerThread], float a,
                                     const float4* row, int g) {
#pragma unroll
  for (int c = 0; c < kColsPerThread / 4; ++c) {
    const float4 x = row[g + c * kTpr];
    acc[4 * c] += a * x.x;
    acc[4 * c + 1] += a * x.y;
    acc[4 * c + 2] += a * x.z;
    acc[4 * c + 3] += a * x.w;
  }
}

// Row `r` of a contiguous (B, S, H, D) output
template <typename T, int kTpr, int D>
__device__ __forceinline__ void store_row(T* out, const float (&acc)[kColsPerThread],
                                          int b, int r, int s, int n_heads,
                                          int h, int g) {
  T* p = out + ((int64_t(b) * s + r) * n_heads + h) * D;
#pragma unroll
  for (int c = 0; c < kColsPerThread / 4; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      p[4 * (g + c * kTpr) + e] = from_float<T>(acc[4 * c + e]);
}

template <typename T, int D>
__global__ void __launch_bounds__(kRows * (D / kColsPerThread))
flash_bwd_dq_kernel(BwdArgs a) {
  constexpr int kTpr = D / kColsPerThread;  // threads per query row
  constexpr int kThreads = kRows * kTpr;
  __shared__ float4 k_tile[kFmaTile][D / 4];
  __shared__ float4 v_tile[kFmaTile][D / 4];

  const int bh = blockIdx.x;
  const int b = bh / a.n_heads;
  const int h = bh % a.n_heads;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;  // heavy tiles first
  const int tid = threadIdx.x;
  const int row = q0 + tid / kTpr;
  const int g = tid % kTpr;
  const int offset = a.s_k - a.s_q;

  const T* qb = static_cast<const T*>(a.q) + b * a.qs.b + h * a.qs.h;
  const T* dob = static_cast<const T*>(a.dout) + b * a.dos.b + h * a.dos.h;
  const T* ob = static_cast<const T*>(a.out) + b * a.os.b + h * a.os.h;
  const T* kb = static_cast<const T*>(a.k) + b * a.ks.b + h * a.ks.h;
  const T* vb = static_cast<const T*>(a.v) + b * a.vs.b + h * a.vs.h;
  float qv[kColsPerThread], dov[kColsPerThread], acc[kColsPerThread];
  load_row<T, kTpr>(qv, qb, a.qs, row, a.s_q, g);
  load_row<T, kTpr>(dov, dob, a.dos, row, a.s_q, g);
  load_row<T, kTpr>(acc, ob, a.os, row, a.s_q, g);  // O, for delta
  float dot = 0.f;
#pragma unroll
  for (int c = 0; c < kColsPerThread; ++c) dot += dov[c] * acc[c];
  const float delta = finish_delta(a, bh, row, row_sum<kTpr>(dot), g == 0);
#pragma unroll
  for (int c = 0; c < kColsPerThread; ++c) acc[c] = 0.f;
  const float lse = row < a.s_q ? a.lse[int64_t(bh) * a.s_q + row] : 0.f;

  const int n_tiles = key_tiles<kFmaTile>(q0, a.s_k, offset, a.causal);
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kFmaTile;
    __syncthreads();  // the previous tile is no longer read
    stage_rows<T, D, kThreads>(reinterpret_cast<float*>(k_tile), kb, a.ks, k0,
                               a.s_k, tid);
    stage_rows<T, D, kThreads>(reinterpret_cast<float*>(v_tile), vb, a.vs, k0,
                               a.s_k, tid);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kFmaTile; ++j) {
      float s, dp;
      dot2<kTpr>(k_tile[j], v_tile[j], qv, dov, g, s, dp);
      const float p = visible(row, k0 + j, a.s_q, a.s_k, offset, a.causal)
                          ? expf(s * a.scale - lse)
                          : 0.f;
      axpy<kTpr>(acc, round_like<T>(p * (dp - delta) * a.scale), k_tile[j], g);
    }
  }
  if (row < a.s_q)
    store_row<T, kTpr, D>(static_cast<T*>(a.dq), acc, b, row, a.s_q,
                          a.n_heads, h, g);
}

template <typename T, int D>
__global__ void __launch_bounds__(kRows * (D / kColsPerThread))
flash_bwd_dkv_kernel(BwdArgs a) {
  constexpr int kTpr = D / kColsPerThread;  // threads per key row
  constexpr int kThreads = kRows * kTpr;
  __shared__ float4 q_tile[kFmaTile][D / 4];
  __shared__ float4 do_tile[kFmaTile][D / 4];
  __shared__ float lse_tile[kFmaTile];
  __shared__ float delta_tile[kFmaTile];

  const int bh = blockIdx.x;
  const int b = bh / a.n_heads;
  const int h = bh % a.n_heads;
  const int k0 = blockIdx.y * kRows;  // causal: early key tiles are heavy
  const int tid = threadIdx.x;
  const int key = k0 + tid / kTpr;
  const int g = tid % kTpr;
  const int offset = a.s_k - a.s_q;

  const T* qb = static_cast<const T*>(a.q) + b * a.qs.b + h * a.qs.h;
  const T* dob = static_cast<const T*>(a.dout) + b * a.dos.b + h * a.dos.h;
  const T* kb = static_cast<const T*>(a.k) + b * a.ks.b + h * a.ks.h;
  const T* vb = static_cast<const T*>(a.v) + b * a.vs.b + h * a.vs.h;
  float kv[kColsPerThread], vv[kColsPerThread];
  float dk[kColsPerThread], dv[kColsPerThread];
  load_row<T, kTpr>(kv, kb, a.ks, key, a.s_k, g);
  load_row<T, kTpr>(vv, vb, a.vs, key, a.s_k, g);
#pragma unroll
  for (int c = 0; c < kColsPerThread; ++c) dk[c] = dv[c] = 0.f;

  const int n_tiles = (a.s_q + kFmaTile - 1) / kFmaTile;
  for (int t = first_query_tile<kFmaTile>(k0, offset, a.causal); t < n_tiles;
       ++t) {
    const int r0 = t * kFmaTile;
    __syncthreads();
    stage_rows<T, D, kThreads>(reinterpret_cast<float*>(q_tile), qb, a.qs, r0,
                               a.s_q, tid);
    stage_rows<T, D, kThreads>(reinterpret_cast<float*>(do_tile), dob, a.dos,
                               r0, a.s_q, tid);
    if (tid < kFmaTile) {
      const bool in = r0 + tid < a.s_q;
      const int64_t i = int64_t(bh) * a.s_q + r0 + tid;
      lse_tile[tid] = in ? a.lse[i] : 0.f;
      delta_tile[tid] = in ? a.delta[i] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int i = 0; i < kFmaTile; ++i) {
      float s, dp;
      dot2<kTpr>(q_tile[i], do_tile[i], kv, vv, g, s, dp);
      const float p = visible(r0 + i, key, a.s_q, a.s_k, offset, a.causal)
                          ? expf(s * a.scale - lse_tile[i])
                          : 0.f;
      axpy<kTpr>(dv, round_like<T>(p), do_tile[i], g);
      axpy<kTpr>(dk, round_like<T>(p * (dp - delta_tile[i]) * a.scale),
                 q_tile[i], g);
    }
  }
  if (key < a.s_k) {
    store_row<T, kTpr, D>(static_cast<T*>(a.dk), dk, b, key, a.s_k,
                          a.n_heads, h, g);
    store_row<T, kTpr, D>(static_cast<T*>(a.dv), dv, b, key, a.s_k,
                          a.n_heads, h, g);
  }
}

// ---------------------------------------------------------------------------
// bf16 tensor-core bodies (mma.sync fragment layout: flash_common.cuh)
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

// Two ways to read a B operand from a bf16 tile in shared memory with rows
// of `ld` elements. For a product X.Y^T, where the tile holds Y's rows
// (k runs along a row): the pair at row n8 + g, columns kc + 2t (+8).
__device__ __forceinline__ uint32_t b_along_row(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
// For a product X.Y, where the tile holds Y's rows (k runs down a column):
// rows kc + 2t and kc + 2t + 1 of column n8 + g, packed.
template <int kLd>
__device__ __forceinline__ uint32_t b_down_col(const __nv_bfloat16* p) {
  return pack_bf16(p[0], p[kLd]);
}

// The A fragments of this warp's 16 rows (r0 = first row + g, r1 = r0 + 8)
// of a (B, S, H, D) operand, zero past `s`
template <int D>
__device__ __forceinline__ void load_a(uint32_t (&a)[D / 16][4],
                                       const bf16* base, const Strides& st,
                                       int r0, int s, int t) {
  auto pair = [&](int r, int col) -> uint32_t {
    if (r >= s) return 0u;
    return *reinterpret_cast<const uint32_t*>(base + int64_t(r) * st.s + col);
  };
#pragma unroll
  for (int c = 0; c < D / 16; ++c) {
    a[c][0] = pair(r0, 16 * c + 2 * t);
    a[c][1] = pair(r0 + 8, 16 * c + 2 * t);
    a[c][2] = pair(r0, 16 * c + 2 * t + 8);
    a[c][3] = pair(r0 + 8, 16 * c + 2 * t + 8);
  }
}

// Rows [r0, r0 + kMmaTile) of an operand into a padded shared bf16 tile
template <int D>
__device__ __forceinline__ void stage_pairs(bf16* tile, const bf16* base,
                                            const Strides& st, int r0, int s,
                                            int tid) {
  constexpr int kLd = D + 8;
  for (int w = tid; w < kMmaTile * D / 2; w += kMmaThreads) {
    const int j = w / (D / 2);
    const int col = 2 * (w % (D / 2));
    *reinterpret_cast<uint32_t*>(&tile[j * kLd + col]) =
        r0 + j < s ? *reinterpret_cast<const uint32_t*>(
                         base + int64_t(r0 + j) * st.s + col)
                   : 0u;
  }
}

// c[n] = X.Y^T for this warp's 16 rows of X (A fragments x) against the
// tile's 64 rows of Y, n = 8-column block of the result
template <int D>
__device__ __forceinline__ void product_nt(float (&c)[kMmaTile / 8][4],
                                           uint32_t (&x)[D / 16][4],
                                           const bf16* tile, int g, int t) {
  constexpr int kLd = D + 8;
#pragma unroll
  for (int n = 0; n < kMmaTile / 8; ++n) {
    c[n][0] = c[n][1] = c[n][2] = c[n][3] = 0.f;
    const bf16* y = &tile[(n * 8 + g) * kLd + 2 * t];
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc)
      mma_bf16(c[n], x[kc], b_along_row(y + 16 * kc),
               b_along_row(y + 16 * kc + 8));
  }
}

// acc += A.Y, A the 16 x 64 matrix in C fragments `m` (rounded to bf16
// here), Y the tile's 64 rows of D columns
template <int D>
__device__ __forceinline__ void product_nn(float (&acc)[D / 8][4],
                                           float (&m)[kMmaTile / 8][4],
                                           const bf16* tile, int g, int t) {
  constexpr int kLd = D + 8;
#pragma unroll
  for (int j = 0; j < kMmaTile / 16; ++j) {
    uint32_t a[4];
    a_from_c(a, m[2 * j], m[2 * j + 1]);
    const bf16* y = &tile[(16 * j + 2 * t) * kLd + g];
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      mma_bf16(acc[n], a, b_down_col<kLd>(y + n * 8),
               b_down_col<kLd>(y + n * 8 + 8 * kLd));
  }
}

// delta of rows [q0, q0 + kRows) into delta_s (and out), from dO and O in
// device memory: two threads per row, D / 2 columns each
template <int D>
__device__ __forceinline__ void delta_from_global(float* delta_s,
                                                  const BwdArgs& a, int bh,
                                                  int b, int h, int q0,
                                                  int tid) {
  const int r = tid >> 1;
  const int row = q0 + r;
  float dot = 0.f;
  if (row < a.s_q) {
    const bf16* dor = static_cast<const bf16*>(a.dout) + b * a.dos.b +
                      h * a.dos.h + int64_t(row) * a.dos.s;
    const bf16* orow = static_cast<const bf16*>(a.out) + b * a.os.b +
                       h * a.os.h + int64_t(row) * a.os.s;
    const int c0 = (tid & 1) * (D / 2);
#pragma unroll
    for (int c = c0; c < c0 + D / 2; ++c)
      dot += to_float(dor[c]) * to_float(orow[c]);
  }
  dot += __shfl_xor_sync(0xffffffffu, dot, 1);
  const float delta = finish_delta(a, bh, row, dot, (tid & 1) == 0);
  if ((tid & 1) == 0) delta_s[r] = delta;
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dq_mma_kernel(BwdArgs a) {
  constexpr int kLd = D + 8;
  __shared__ __align__(16) bf16 k_tile[kMmaTile * kLd];
  __shared__ __align__(16) bf16 v_tile[kMmaTile * kLd];
  __shared__ float delta_s[kRows];

  const int bh = blockIdx.x;
  const int b = bh / a.n_heads;
  const int h = bh % a.n_heads;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;  // heavy tiles first
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int g = (tid & 31) >> 2;
  const int t = tid & 3;
  const int row0 = q0 + warp * 16 + g;
  const int offset = a.s_k - a.s_q;

  delta_from_global<D>(delta_s, a, bh, b, h, q0, tid);
  const bf16* qb = static_cast<const bf16*>(a.q) + b * a.qs.b + h * a.qs.h;
  const bf16* dob =
      static_cast<const bf16*>(a.dout) + b * a.dos.b + h * a.dos.h;
  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.ks.b + h * a.ks.h;
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.vs.b + h * a.vs.h;
  uint32_t qa[D / 16][4], doa[D / 16][4];
  load_a<D>(qa, qb, a.qs, row0, a.s_q, t);
  load_a<D>(doa, dob, a.dos, row0, a.s_q, t);
  __syncthreads();  // delta_s
  float lse[2], delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    lse[r] = row < a.s_q ? a.lse[int64_t(bh) * a.s_q + row] : 0.f;
    delta[r] = delta_s[row - q0];
  }
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  const int n_tiles = key_tiles<kMmaTile>(q0, a.s_k, offset, a.causal);
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * kMmaTile;
    __syncthreads();  // the previous tile is no longer read
    stage_pairs<D>(k_tile, kb, a.ks, k0, a.s_k, tid);
    stage_pairs<D>(v_tile, vb, a.vs, k0, a.s_k, tid);
    __syncthreads();

    float s[kMmaTile / 8][4], dp[kMmaTile / 8][4];
    product_nt<D>(s, qa, k_tile, g, t);   // S = Q.K^T
    product_nt<D>(dp, doa, v_tile, g, t); // dP = dO.V^T
#pragma unroll
    for (int n = 0; n < kMmaTile / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int key = k0 + n * 8 + 2 * t + (e & 1);
        const float p = visible(row0 + 8 * r, key, a.s_q, a.s_k, offset,
                                a.causal)
                            ? expf(s[n][e] * a.scale - lse[r])
                            : 0.f;
        s[n][e] = p * (dp[n][e] - delta[r]) * a.scale;  // dS
      }
    product_nn<D>(acc, s, k_tile, g, t);  // dQ += dS.K
  }
  store_c<D>(static_cast<bf16*>(a.dq), acc, b, row0, a.s_q, a.n_heads, h, t);
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dkv_mma_kernel(BwdArgs a) {
  constexpr int kLd = D + 8;
  __shared__ __align__(16) bf16 q_tile[kMmaTile * kLd];
  __shared__ __align__(16) bf16 do_tile[kMmaTile * kLd];
  __shared__ float lse_tile[kMmaTile];
  __shared__ float delta_tile[kMmaTile];

  const int bh = blockIdx.x;
  const int b = bh / a.n_heads;
  const int h = bh % a.n_heads;
  const int k0 = blockIdx.y * kRows;  // causal: early key tiles are heavy
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int g = (tid & 31) >> 2;
  const int t = tid & 3;
  const int key0 = k0 + warp * 16 + g;
  const int offset = a.s_k - a.s_q;

  const bf16* qb = static_cast<const bf16*>(a.q) + b * a.qs.b + h * a.qs.h;
  const bf16* dob =
      static_cast<const bf16*>(a.dout) + b * a.dos.b + h * a.dos.h;
  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.ks.b + h * a.ks.h;
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.vs.b + h * a.vs.h;
  uint32_t ka[D / 16][4], va[D / 16][4];
  load_a<D>(ka, kb, a.ks, key0, a.s_k, t);
  load_a<D>(va, vb, a.vs, key0, a.s_k, t);
  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  const int n_tiles = (a.s_q + kMmaTile - 1) / kMmaTile;
  for (int tile = first_query_tile<kMmaTile>(k0, offset, a.causal);
       tile < n_tiles; ++tile) {
    const int r0 = tile * kMmaTile;
    __syncthreads();  // the previous tile is no longer read
    stage_pairs<D>(q_tile, qb, a.qs, r0, a.s_q, tid);
    stage_pairs<D>(do_tile, dob, a.dos, r0, a.s_q, tid);
    if (tid < kMmaTile) {
      const bool in = r0 + tid < a.s_q;
      const int64_t i = int64_t(bh) * a.s_q + r0 + tid;
      lse_tile[tid] = in ? a.lse[i] : 0.f;
      delta_tile[tid] = in ? a.delta[i] : 0.f;
    }
    __syncthreads();

    // S^T = K.Q^T and dP^T = V.dO^T: rows are this warp's keys, columns
    // the tile's queries
    float p[kMmaTile / 8][4], ds[kMmaTile / 8][4];
    product_nt<D>(p, ka, q_tile, g, t);
    product_nt<D>(ds, va, do_tile, g, t);
#pragma unroll
    for (int n = 0; n < kMmaTile / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = n * 8 + 2 * t + (e & 1);  // query within the tile
        const int key = key0 + 8 * (e >> 1);
        const float pe = visible(r0 + i, key, a.s_q, a.s_k, offset, a.causal)
                             ? expf(p[n][e] * a.scale - lse_tile[i])
                             : 0.f;
        p[n][e] = pe;
        ds[n][e] = pe * (ds[n][e] - delta_tile[i]) * a.scale;
      }
    product_nn<D>(dv, p, do_tile, g, t);  // dV += P^T.dO
    product_nn<D>(dk, ds, q_tile, g, t);  // dK += dS^T.Q
  }
  store_c<D>(static_cast<bf16*>(a.dk), dk, b, key0, a.s_k, a.n_heads, h, t);
  store_c<D>(static_cast<bf16*>(a.dv), dv, b, key0, a.s_k, a.n_heads, h, t);
}

// ---------------------------------------------------------------------------
// wgmma bodies (bf16, D = 64; layouts: hopper_common.cuh)
// ---------------------------------------------------------------------------

constexpr int kStages = 2;  // streamed tiles in flight
constexpr int kWgmmaThreads = kWarpgroupThreads + 32;  // + the producer warp

// Tensor maps of the operands a pass loads by TMA
struct TmaMaps {
  CUtensorMap q, k, v, dout, out;
};

struct DqSmem {
  bf16 q[kTileElems], dout[kTileElems], out[kTileElems];  // own rows
  bf16 k[kStages][kTileElems], v[kStages][kTileElems];    // streamed
  uint64_t full[kStages], empty[kStages], own;
  float delta[kRows];
};

struct DkvSmem {
  bf16 k[kTileElems], v[kTileElems];                      // own keys
  bf16 q[kStages][kTileElems], dout[kStages][kTileElems]; // streamed
  float lse_log2[kStages][kMmaTile];  // lse * log2(e)
  float delta[kStages][kMmaTile];
  uint64_t full[kStages], empty[kStages], own;
};

// Parity to wait for on a stage's barrier at streamed tile i: the
// consumer waits for fill number i / kStages; the producer, before
// refilling, for the release of the fill before it (the first passes)
__device__ __forceinline__ uint32_t fill_parity(int i) {
  return (i / kStages) & 1;
}

// delta of the 64 own rows from the swizzled dO and O tiles: two
// consumer threads per row, 32 columns (four 16-byte chunks) each
__device__ __forceinline__ float swizzled_row_dot(const bf16* x,
                                                  const bf16* y, int r,
                                                  int half) {
  float dot = 0.f;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int chunk = (half * 4 + c) ^ (r & 7);
    const uint4 xv = *reinterpret_cast<const uint4*>(x + r * 64 + chunk * 8);
    const uint4 yv = *reinterpret_cast<const uint4*>(y + r * 64 + chunk * 8);
    const uint32_t xs[4] = {xv.x, xv.y, xv.z, xv.w};
    const uint32_t ys[4] = {yv.x, yv.y, yv.z, yv.w};
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const float2 xf = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&xs[w]));
      const float2 yf = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&ys[w]));
      dot += xf.x * yf.x;
      dot += xf.y * yf.y;
    }
  }
  return dot;
}

// dS (in place of s) for a tile of the dQ pass: this thread's rows
// row0 and row0 + 8, keys k0 + 8n + 2t (+1). P = exp(s * scale - lse)
// is taken as exp2 of (s * scale - lse) * log2(e), with `lse_log2` =
// lse * log2(e) and `scale_log2` = scale * log2(e).
template <bool kMask>
__device__ __forceinline__ void dq_tile_ds(float (&s)[8][4],
                                           const float (&dp)[8][4],
                                           const BwdArgs& a, int row0, int k0,
                                           float scale_log2,
                                           const float (&lse_log2)[2],
                                           const float (&delta)[2], int t) {
  const int offset = a.s_k - a.s_q;
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      float p = exp2f(fmaf(s[n][e], scale_log2, -lse_log2[r]));
      if (kMask && !visible(row0 + 8 * r, k0 + 8 * n + 2 * t + (e & 1),
                            a.s_q, a.s_k, offset, a.causal))
        p = 0.f;
      s[n][e] = p * (dp[n][e] - delta[r]) * a.scale;
    }
}

// Issue S = Q.K^T and dP = dO.V^T for streamed tile i of the dQ pass,
// once its stage has landed (one commit group)
__device__ __forceinline__ void dq_issue_scores(float (&s)[8][4],
                                                float (&dp)[8][4],
                                                DqSmem& sm, uint64_t q_desc,
                                                uint64_t do_desc, int i) {
  const int st = i % kStages;
  const uint64_t k_desc = wgmma_desc(sm.k[st]);
  const uint64_t v_desc = wgmma_desc(sm.v[st]);
  mbar_wait(&sm.full[st], fill_parity(i));
  fence_operands(s);
  fence_operands(dp);
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < 4; ++j)
    wgmma_ss(s, q_desc + k_major_step(j), k_desc + k_major_step(j), j);
#pragma unroll
  for (int j = 0; j < 4; ++j)
    wgmma_ss(dp, do_desc + k_major_step(j), v_desc + k_major_step(j), j);
  wgmma_commit();
}

// Three CTAs a SM (at most 136 registers a thread) ran faster than two
__global__ void __launch_bounds__(kWgmmaThreads, 3)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ TmaMaps maps, BwdArgs a) {
  DqSmem& sm = *reinterpret_cast<DqSmem*>(dynamic_smem_1024());
  const int bh = blockIdx.x;
  const int b = bh / a.n_heads;
  const int h = bh % a.n_heads;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;  // heavy tiles first
  const int tid = threadIdx.x;
  const int n_tiles = key_tiles<kMmaTile>(q0, a.s_k, a.s_k - a.s_q, a.causal);

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], kWarpgroupThreads);
    }
    mbar_init(&sm.own, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= kWarpgroupThreads) {  // the producer warp
    if (tid == kWarpgroupThreads) {
      mbar_arrive_expect_tx(&sm.own, 3 * kTileBytes);
      tma_load_4d(sm.q, &maps.q, &sm.own, 0, h, q0, b);
      tma_load_4d(sm.dout, &maps.dout, &sm.own, 0, h, q0, b);
      tma_load_4d(sm.out, &maps.out, &sm.own, 0, h, q0, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages;
        mbar_wait(&sm.empty[s], fill_parity(i) ^ 1);
        mbar_arrive_expect_tx(&sm.full[s], 2 * kTileBytes);
        tma_load_4d(sm.k[s], &maps.k, &sm.full[s], 0, h, i * kMmaTile, b);
        tma_load_4d(sm.v[s], &maps.v, &sm.full[s], 0, h, i * kMmaTile, b);
      }
    }
    return;
  }

  // The consumer warpgroup
  const int warp = tid >> 5;
  const int g = (tid & 31) >> 2;
  const int t = tid & 3;
  const int row0 = q0 + warp * 16 + g;
  mbar_wait(&sm.own, 0);
  {
    const int r = tid >> 1;
    float dot = swizzled_row_dot(sm.dout, sm.out, r, tid & 1);
    dot += __shfl_xor_sync(0xffffffffu, dot, 1);
    const float delta = finish_delta(a, bh, q0 + r, dot, (tid & 1) == 0);
    if ((tid & 1) == 0) sm.delta[r] = delta;
  }
  named_barrier_sync(1, kWarpgroupThreads);
  float lse_log2[2], delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    lse_log2[r] =
        row < a.s_q ? a.lse[int64_t(bh) * a.s_q + row] * kLog2e : 0.f;
    delta[r] = sm.delta[row - q0];
  }
  const float scale_log2 = a.scale * kLog2e;

  float acc[8][4], s[8][4], dp[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = s[n][e] = dp[n][e] = 0.f;
  const uint64_t q_desc = wgmma_desc(sm.q);
  const uint64_t do_desc = wgmma_desc(sm.dout);
  // Software-pipelined: tile i + 1's S and dP are issued right behind
  // tile i's dQ product; both retire before tile i + 1's exponentials
  if (n_tiles > 0) dq_issue_scores(s, dp, sm, q_desc, do_desc, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % kStages;
    const int k0 = i * kMmaTile;
    wgmma_wait_all();  // S, dP of tile i; dQ += dS.K of tile i - 1
    fence_operands(s);
    fence_operands(dp);
    fence_operands(acc);
    if (i > 0) mbar_arrive(&sm.empty[(i - 1) % kStages]);
    if (tile_needs_mask(q0, k0, a.s_q, a.s_k, a.s_k - a.s_q, a.causal))
      dq_tile_ds<true>(s, dp, a, row0, k0, scale_log2, lse_log2, delta, t);
    else
      dq_tile_ds<false>(s, dp, a, row0, k0, scale_log2, lse_log2, delta, t);
    // dQ += dS.K, dS rounded to bf16
    uint32_t ds_a[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) a_from_c(ds_a[j], s[2 * j], s[2 * j + 1]);
    const uint64_t k_desc = wgmma_desc(sm.k[st]);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wgmma_rs_mn(acc, ds_a[j], k_desc + mn_major_step(j));
    wgmma_commit();
    if (i + 1 < n_tiles) dq_issue_scores(s, dp, sm, q_desc, do_desc, i + 1);
  }
  wgmma_wait_all();
  fence_operands(acc);
  store_c<64>(static_cast<bf16*>(a.dq), acc, b, row0, a.s_q, a.n_heads, h, t);
}

// P^T and dS^T (in place of pt and dst) for a tile of the dK/dV pass:
// this thread's keys key0 and key0 + 8, queries r0 + 8n + 2t (+1); P as
// in dq_tile_ds, from the stage's lse * log2(e)
template <bool kMask>
__device__ __forceinline__ void dkv_tile_p_ds(float (&pt)[8][4],
                                              float (&dst)[8][4],
                                              const BwdArgs& a,
                                              float scale_log2,
                                              const float* lse_log2,
                                              const float* delta, int key0,
                                              int r0, int t) {
  const int offset = a.s_k - a.s_q;
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = n * 8 + 2 * t + (e & 1);  // query within the tile
      float p = exp2f(fmaf(pt[n][e], scale_log2, -lse_log2[i]));
      if (kMask && !visible(r0 + i, key0 + 8 * (e >> 1), a.s_q, a.s_k,
                            offset, a.causal))
        p = 0.f;
      pt[n][e] = p;
      dst[n][e] = p * (dst[n][e] - delta[i]) * a.scale;
    }
}

// Issue S^T = K.Q^T and dP^T = V.dO^T for streamed tile i of the dK/dV
// pass, once its stage has landed (one commit group)
__device__ __forceinline__ void dkv_issue_scores(float (&pt)[8][4],
                                                 float (&dst)[8][4],
                                                 DkvSmem& sm, uint64_t k_desc,
                                                 uint64_t v_desc, int i) {
  const int st = i % kStages;
  const uint64_t q_desc = wgmma_desc(sm.q[st]);
  const uint64_t do_desc = wgmma_desc(sm.dout[st]);
  mbar_wait(&sm.full[st], fill_parity(i));
  fence_operands(pt);
  fence_operands(dst);
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < 4; ++j)
    wgmma_ss(pt, k_desc + k_major_step(j), q_desc + k_major_step(j), j);
#pragma unroll
  for (int j = 0; j < 4; ++j)
    wgmma_ss(dst, v_desc + k_major_step(j), do_desc + k_major_step(j), j);
  wgmma_commit();
}

// Two CTAs a SM (at most 204 registers a thread): without the bound the
// pipelined body takes more and only one CTA fits
__global__ void __launch_bounds__(kWgmmaThreads, 2)
flash_bwd_dkv_wgmma_kernel(const __grid_constant__ TmaMaps maps, BwdArgs a) {
  DkvSmem& sm = *reinterpret_cast<DkvSmem*>(dynamic_smem_1024());
  const int bh = blockIdx.x;
  const int b = bh / a.n_heads;
  const int h = bh % a.n_heads;
  const int k0 = blockIdx.y * kRows;  // causal: early key tiles are heavy
  const int tid = threadIdx.x;
  const int offset = a.s_k - a.s_q;
  const int first = first_query_tile<kMmaTile>(k0, offset, a.causal);
  const int n_tiles = (a.s_q + kMmaTile - 1) / kMmaTile - first;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.full[s], 32);  // every producer lane stores lse, delta
      mbar_init(&sm.empty[s], kWarpgroupThreads);
    }
    mbar_init(&sm.own, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= kWarpgroupThreads) {  // the producer warp
    const int lane = tid - kWarpgroupThreads;
    if (lane == 0) {
      mbar_arrive_expect_tx(&sm.own, 2 * kTileBytes);
      tma_load_4d(sm.k, &maps.k, &sm.own, 0, h, k0, b);
      tma_load_4d(sm.v, &maps.v, &sm.own, 0, h, k0, b);
    }
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % kStages;
      const int r0 = (first + i) * kMmaTile;
      mbar_wait(&sm.empty[s], fill_parity(i) ^ 1);
      for (int j = lane; j < kMmaTile; j += 32) {
        const bool in = r0 + j < a.s_q;
        const int64_t row = int64_t(bh) * a.s_q + r0 + j;
        sm.lse_log2[s][j] = in ? a.lse[row] * kLog2e : 0.f;
        sm.delta[s][j] = in ? a.delta[row] : 0.f;
      }
      if (lane == 0) {
        mbar_arrive_expect_tx(&sm.full[s], 2 * kTileBytes);
        tma_load_4d(sm.q[s], &maps.q, &sm.full[s], 0, h, r0, b);
        tma_load_4d(sm.dout[s], &maps.dout, &sm.full[s], 0, h, r0, b);
      } else {
        mbar_arrive(&sm.full[s]);
      }
    }
    return;
  }

  // The consumer warpgroup: this thread's keys key0 and key0 + 8
  const int warp = tid >> 5;
  const int g = (tid & 31) >> 2;
  const int t = tid & 3;
  const int key0 = k0 + warp * 16 + g;
  float dk[8][4], dv[8][4], pt[8][4], dst[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = pt[n][e] = dst[n][e] = 0.f;
  mbar_wait(&sm.own, 0);
  const uint64_t k_desc = wgmma_desc(sm.k);
  const uint64_t v_desc = wgmma_desc(sm.v);
  const float scale_log2 = a.scale * kLog2e;
  // Software-pipelined as the dQ pass
  if (n_tiles > 0) dkv_issue_scores(pt, dst, sm, k_desc, v_desc, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % kStages;
    const int r0 = (first + i) * kMmaTile;
    wgmma_wait_all();  // S^T, dP^T of tile i; dV, dK products of tile i - 1
    fence_operands(pt);
    fence_operands(dst);
    fence_operands(dv);
    fence_operands(dk);
    if (i > 0) mbar_arrive(&sm.empty[(i - 1) % kStages]);
    if (tile_needs_mask(r0, k0, a.s_q, a.s_k, offset, a.causal))
      dkv_tile_p_ds<true>(pt, dst, a, scale_log2, sm.lse_log2[st],
                          sm.delta[st], key0, r0, t);
    else
      dkv_tile_p_ds<false>(pt, dst, a, scale_log2, sm.lse_log2[st],
                           sm.delta[st], key0, r0, t);
    // dV += P^T.dO, dK += dS^T.Q, P^T and dS^T rounded to bf16
    uint32_t p_a[4][4], ds_a[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      a_from_c(p_a[j], pt[2 * j], pt[2 * j + 1]);
      a_from_c(ds_a[j], dst[2 * j], dst[2 * j + 1]);
    }
    const uint64_t q_desc = wgmma_desc(sm.q[st]);
    const uint64_t do_desc = wgmma_desc(sm.dout[st]);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wgmma_rs_mn(dv, p_a[j], do_desc + mn_major_step(j));
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wgmma_rs_mn(dk, ds_a[j], q_desc + mn_major_step(j));
    wgmma_commit();
    if (i + 1 < n_tiles) dkv_issue_scores(pt, dst, sm, k_desc, v_desc, i + 1);
  }
  wgmma_wait_all();
  fence_operands(dv);
  fence_operands(dk);
  store_c<64>(static_cast<bf16*>(a.dk), dk, b, key0, a.s_k, a.n_heads, h, t);
  store_c<64>(static_cast<bf16*>(a.dv), dv, b, key0, a.s_k, a.n_heads, h, t);
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

enum class Pass { kDq, kDkv };

cudaError_t launch_wgmma(Pass pass, const BwdArgs& a, cudaStream_t stream) {
  TmaMaps maps{};
  const bool ok =
      bshd_tensor_map(&maps.q, a.q, a.batch, a.s_q, a.n_heads, a.qs) &&
      bshd_tensor_map(&maps.k, a.k, a.batch, a.s_k, a.n_heads, a.ks) &&
      bshd_tensor_map(&maps.v, a.v, a.batch, a.s_k, a.n_heads, a.vs) &&
      bshd_tensor_map(&maps.dout, a.dout, a.batch, a.s_q, a.n_heads, a.dos) &&
      (pass == Pass::kDkv ||
       bshd_tensor_map(&maps.out, a.out, a.batch, a.s_q, a.n_heads, a.os));
  if (!ok) return cudaErrorInvalidValue;
  const int rows = pass == Pass::kDq ? a.s_q : a.s_k;
  const dim3 grid(a.batch * a.n_heads, (rows + kRows - 1) / kRows);
  static uint64_t dq_smem_set = 0, dkv_smem_set = 0;
  if (pass == Pass::kDq) {
    const int smem = sizeof(DqSmem) + 1024;
    const cudaError_t err = allow_smem(
        reinterpret_cast<const void*>(flash_bwd_dq_wgmma_kernel), smem,
        dq_smem_set);
    if (err != cudaSuccess) return err;
    flash_bwd_dq_wgmma_kernel<<<grid, kWgmmaThreads, smem, stream>>>(maps, a);
  } else {
    const int smem = sizeof(DkvSmem) + 1024;
    const cudaError_t err = allow_smem(
        reinterpret_cast<const void*>(flash_bwd_dkv_wgmma_kernel), smem,
        dkv_smem_set);
    if (err != cudaSuccess) return err;
    flash_bwd_dkv_wgmma_kernel<<<grid, kWgmmaThreads, smem, stream>>>(maps, a);
  }
  return cudaSuccess;
}

template <typename T, int D>
cudaError_t launch(Pass pass, const BwdArgs& a, int body,
                   cudaStream_t stream) {
  const int rows = pass == Pass::kDq ? a.s_q : a.s_k;
  const dim3 grid(a.batch * a.n_heads, (rows + kRows - 1) / kRows);
  constexpr bool kTensorCores = std::is_same_v<T, bf16>;
  if (body == kWgmmaBody) {
    if constexpr (kTensorCores && D == 64) return launch_wgmma(pass, a, stream);
    return cudaErrorInvalidValue;
  }
  if (body == kMmaBody) {
    if constexpr (kTensorCores && D <= 64) {
      if (!(pair_aligned(a.q, a.qs) && pair_aligned(a.k, a.ks) &&
            pair_aligned(a.v, a.vs) && pair_aligned(a.dout, a.dos)))
        return cudaErrorInvalidValue;
      if (pass == Pass::kDq)
        flash_bwd_dq_mma_kernel<D><<<grid, kMmaThreads, 0, stream>>>(a);
      else
        flash_bwd_dkv_mma_kernel<D><<<grid, kMmaThreads, 0, stream>>>(a);
      return cudaSuccess;
    }
    return cudaErrorInvalidValue;
  }
  if (body != kFmaBody) return cudaErrorInvalidValue;
  constexpr int kThreads = kRows * (D / kColsPerThread);
  if (pass == Pass::kDq)
    flash_bwd_dq_kernel<T, D><<<grid, kThreads, 0, stream>>>(a);
  else
    flash_bwd_dkv_kernel<T, D><<<grid, kThreads, 0, stream>>>(a);
  return cudaSuccess;
}

template <typename T>
int dispatch_d(int d, Pass pass, const BwdArgs& a, int body,
               cudaStream_t stream) {
  cudaError_t err;
  switch (d) {
    case 16: err = launch<T, 16>(pass, a, body, stream); break;
    case 32: err = launch<T, 32>(pass, a, body, stream); break;
    case 64: err = launch<T, 64>(pass, a, body, stream); break;
    case 128: err = launch<T, 128>(pass, a, body, stream); break;
    default: err = cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

int run(Pass pass, const BwdArgs& a, int d, int dtype, int body,
        void* stream) {
  if (a.batch <= 0 || a.n_heads <= 0 || a.s_q <= 0 || a.s_k <= 0) return 0;
  const int rows = pass == Pass::kDq ? a.s_q : a.s_k;
  if ((rows + kRows - 1) / kRows > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_d<float>(d, pass, a, body, s);
  if (dtype == 1) return dispatch_d<bf16>(d, pass, a, body, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. body: 0 = fma, 1 = mma, 2 = wgmma
// (a body that does not take the shape returns an error). Strides are in
// elements; dq (like q) and delta ((B*H, S_q) fp32) are written
// contiguous; g_lse may be null. Returns a cudaError_t as int.
extern "C" int faabric_flash_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* out, const void* lse, const void* g_lse, void* delta,
    void* dq, int batch, int n_heads, int s_q, int s_k, int d, int64_t q_sb,
    int64_t q_ss, int64_t q_sh, int64_t k_sb, int64_t k_ss, int64_t k_sh,
    int64_t v_sb, int64_t v_ss, int64_t v_sh, int64_t do_sb, int64_t do_ss,
    int64_t do_sh, int64_t o_sb, int64_t o_ss, int64_t o_sh, float scale,
    int causal, int dtype, int body, void* stream) {
  const BwdArgs a{q, k, v, dout, out, static_cast<const float*>(lse),
                  static_cast<const float*>(g_lse), nullptr,
                  static_cast<float*>(delta), dq, nullptr, nullptr, batch,
                  n_heads, s_q, s_k, Strides{q_sb, q_ss, q_sh},
                  Strides{k_sb, k_ss, k_sh}, Strides{v_sb, v_ss, v_sh},
                  Strides{do_sb, do_ss, do_sh}, Strides{o_sb, o_ss, o_sh},
                  scale, causal};
  return run(Pass::kDq, a, d, dtype, body, stream);
}

// delta is the dQ pass's output; dk and dv (like k) are written contiguous
extern "C" int faabric_flash_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int batch,
    int n_heads, int s_q, int s_k, int d, int64_t q_sb, int64_t q_ss,
    int64_t q_sh, int64_t k_sb, int64_t k_ss, int64_t k_sh, int64_t v_sb,
    int64_t v_ss, int64_t v_sh, int64_t do_sb, int64_t do_ss, int64_t do_sh,
    float scale, int causal, int dtype, int body, void* stream) {
  const BwdArgs a{q, k, v, dout, nullptr, static_cast<const float*>(lse),
                  nullptr, static_cast<const float*>(delta), nullptr,
                  nullptr, dk, dv, batch, n_heads, s_q, s_k,
                  Strides{q_sb, q_ss, q_sh}, Strides{k_sb, k_ss, k_sh},
                  Strides{v_sb, v_ss, v_sh}, Strides{do_sb, do_ss, do_sh},
                  Strides{0, 0, 0}, scale, causal};
  return run(Pass::kDkv, a, d, dtype, body, stream);
}
