// Flash attention backward for Hopper (sm_90a): the dQ pass and the
// dK/dV pass.
//
// Replaces faabric_tpu/ops/flash_attention.py::_flash_bwd_dq_kernel and
// ::_flash_bwd_dkv_kernel (both launched by _run_bwd_kernels). Inputs are
// the forward's q (B, S_q, H, D), k and v (B, S_k, H, D), the output's
// cotangent dO (like q), the forward's per-row log-sum-exp lse and the row
// correction delta = rowsum(dO * O) - g_lse, both (B*H, S_q) fp32 and
// computed outside these kernels, as in the JAX package.
//
// Two passes and no atomics, as on the TPU, so the result is
// deterministic:
//   - dQ: one CTA per (batch*head, 64-row q tile) streams K/V tiles,
//     recomputes P = exp(s - lse), dP = dO.V^T, dS = P * (dP - delta) *
//     scale and accumulates dQ = sum dS.K;
//   - dK/dV: one CTA per (batch*head, 64-key tile) streams q tiles from
//     the first one that can see the tile's first key (causal:
//     (k0 - causal_offset) / tile), recomputes P and dS the same way and
//     accumulates dV = sum P^T.dO and dK = sum dS^T.Q.
// The (S_q, S_k) matrices never reach device memory.
//
// Semantics kept from the TPU kernels: the end-aligned causal mask (query
// row i sees keys up to i + causal_offset, causal_offset = S_k - S_q; the
// caller routes causal S_q > S_k to the plain version), masked entries at
// -1e30 so P is 0 there, and the rounding points: P is recomputed in fp32,
// P is rounded to dO's dtype before P^T.dO, dO is in V's dtype for dO.V^T,
// dS is rounded to K's and Q's dtype before dS.K and dS^T.Q; all sums are
// fp32. Ragged S_q and S_k are handled with bounds masks: rows past S_q and
// keys past S_k get P = 0 and are not written.
//
// Bound: at the training shapes (D = 64, S = 512) each pass moves ~21-25 MB
// against 3-4 GFLOP, so both are bound by bytes on paper; a simple kernel
// is far from that. Two bodies per pass:
//   - bf16 with D <= 64 (the model's compute dtype and head dim): warp-level
//     tensor-core products, mma.sync m16n8k16 bf16 with fp32 accumulators.
//     Four warps own 16 rows each (query rows in the dQ pass, key rows in
//     the dK/dV pass) and keep that operand's fragments and their fp32
//     accumulators in registers; the streamed tiles sit in shared memory
//     with padded rows, as in the forward. The dK/dV pass computes S^T =
//     K.Q^T and dP^T = V.dO^T directly, so P^T and dS^T come out in the C
//     layout that re-packs in registers as the A operand of the next
//     product, with no transpose through memory.
//   - float32, bf16 whose strides are not even, and D = 128: fp32 FMAs,
//     D/16 threads per row, each owning 16 columns of the row's operands
//     and accumulators in registers; 32-row tiles of the streamed operands
//     staged as fp32 in shared memory and read as float4; dot products meet
//     by warp shuffles. At D = 128 the tensor-core body would keep 256
//     fp32 values a thread (dK and dV accumulators alone are 128) and
//     spill, so it is not instantiated there.
// No cp.async or TMA pipeline and no wgmma yet: later work.

#include <type_traits>

#include "flash_common.cuh"

namespace {

constexpr int kRows = 64;     // rows a CTA owns: queries (dQ), keys (dK/dV)
constexpr int kFmaTile = 32;  // FMA bodies: streamed rows per step
constexpr int kMmaTile = 64;  // tensor-core bodies: streamed rows per step

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;
  const float* delta;
  void* dq;
  void* dk;
  void* dv;
  int batch, n_heads, s_q, s_k;
  Strides qs, ks, vs, dos;
  float scale;
  int causal;
};

// Query row `row` sees key `key`: both in bounds and, when causal, the key
// at or before the row's end-aligned diagonal
__device__ __forceinline__ bool visible(int row, int key, int s_q, int s_k,
                                        int offset, int causal) {
  return row < s_q && key < s_k && (!causal || key <= row + offset);
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

// ---------------------------------------------------------------------------
// FMA bodies
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
#pragma unroll
  for (int off = kTpr / 2; off > 0; off >>= 1) {
    xa += __shfl_xor_sync(0xffffffffu, xa, off);
    yb += __shfl_xor_sync(0xffffffffu, yb, off);
  }
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
  const T* kb = static_cast<const T*>(a.k) + b * a.ks.b + h * a.ks.h;
  const T* vb = static_cast<const T*>(a.v) + b * a.vs.b + h * a.vs.h;
  float qv[kColsPerThread], dov[kColsPerThread], acc[kColsPerThread];
  load_row<T, kTpr>(qv, qb, a.qs, row, a.s_q, g);
  load_row<T, kTpr>(dov, dob, a.dos, row, a.s_q, g);
#pragma unroll
  for (int c = 0; c < kColsPerThread; ++c) acc[c] = 0.f;
  const bool row_valid = row < a.s_q;
  const float lse = row_valid ? a.lse[int64_t(bh) * a.s_q + row] : 0.f;
  const float delta = row_valid ? a.delta[int64_t(bh) * a.s_q + row] : 0.f;

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
  if (row_valid)
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
// bf16 tensor-core bodies (fragment layout: flash_common.cuh)
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

// The 16 x 16 A operand of key (or query) step j, from the C fragments of
// a 16 x 64 product whose columns are the k dimension: s[2j] and
// s[2j + 1] hold columns 16j .. 16j + 15. Each value is rounded to bf16.
__device__ __forceinline__ void a_from_c(uint32_t (&a)[4],
                                         const float (&lo)[4],
                                         const float (&hi)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
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

// Rows r0 and r0 + 8 of this warp's C fragments into a contiguous
// (B, S, H, D) output
template <int D>
__device__ __forceinline__ void store_c(bf16* out, float (&acc)[D / 8][4],
                                        int b, int r0, int s, int n_heads,
                                        int h, int t) {
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = n * 8 + 2 * t;
    if (r0 < s)
      *reinterpret_cast<uint32_t*>(
          out + ((int64_t(b) * s + r0) * n_heads + h) * D + col) =
          pack_bf16(acc[n][0], acc[n][1]);
    if (r0 + 8 < s)
      *reinterpret_cast<uint32_t*>(
          out + ((int64_t(b) * s + r0 + 8) * n_heads + h) * D + col) =
          pack_bf16(acc[n][2], acc[n][3]);
  }
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dq_mma_kernel(BwdArgs a) {
  constexpr int kLd = D + 8;
  __shared__ __align__(16) bf16 k_tile[kMmaTile * kLd];
  __shared__ __align__(16) bf16 v_tile[kMmaTile * kLd];

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

  const bf16* qb = static_cast<const bf16*>(a.q) + b * a.qs.b + h * a.qs.h;
  const bf16* dob =
      static_cast<const bf16*>(a.dout) + b * a.dos.b + h * a.dos.h;
  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.ks.b + h * a.ks.h;
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.vs.b + h * a.vs.h;
  uint32_t qa[D / 16][4], doa[D / 16][4];
  load_a<D>(qa, qb, a.qs, row0, a.s_q, t);
  load_a<D>(doa, dob, a.dos, row0, a.s_q, t);
  float lse[2], delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    lse[r] = row < a.s_q ? a.lse[int64_t(bh) * a.s_q + row] : 0.f;
    delta[r] = row < a.s_q ? a.delta[int64_t(bh) * a.s_q + row] : 0.f;
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
// Launch
// ---------------------------------------------------------------------------

enum class Pass { kDq, kDkv };

template <typename T, int D>
void launch(Pass pass, const BwdArgs& a, cudaStream_t stream) {
  const int rows = pass == Pass::kDq ? a.s_q : a.s_k;
  const dim3 grid(a.batch * a.n_heads, (rows + kRows - 1) / kRows);
  if constexpr (std::is_same_v<T, bf16> && D <= 64) {
    if (pair_aligned(a.q, a.qs) && pair_aligned(a.k, a.ks) &&
        pair_aligned(a.v, a.vs) && pair_aligned(a.dout, a.dos)) {
      if (pass == Pass::kDq)
        flash_bwd_dq_mma_kernel<D><<<grid, kMmaThreads, 0, stream>>>(a);
      else
        flash_bwd_dkv_mma_kernel<D><<<grid, kMmaThreads, 0, stream>>>(a);
      return;
    }
  }
  constexpr int kThreads = kRows * (D / kColsPerThread);
  if (pass == Pass::kDq)
    flash_bwd_dq_kernel<T, D><<<grid, kThreads, 0, stream>>>(a);
  else
    flash_bwd_dkv_kernel<T, D><<<grid, kThreads, 0, stream>>>(a);
}

template <typename T>
int dispatch_d(int d, Pass pass, const BwdArgs& a, cudaStream_t stream) {
  switch (d) {
    case 16: launch<T, 16>(pass, a, stream); break;
    case 32: launch<T, 32>(pass, a, stream); break;
    case 64: launch<T, 64>(pass, a, stream); break;
    case 128: launch<T, 128>(pass, a, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

int run(Pass pass, const BwdArgs& a, int d, int dtype, void* stream) {
  if (a.batch <= 0 || a.n_heads <= 0 || a.s_q <= 0 || a.s_k <= 0) return 0;
  const int rows = pass == Pass::kDq ? a.s_q : a.s_k;
  if ((rows + kRows - 1) / kRows > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_d<float>(d, pass, a, s);
  if (dtype == 1) return dispatch_d<bf16>(d, pass, a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements; outputs are
// contiguous (B, S, H, D). Returns a cudaError_t as int.
extern "C" int faabric_flash_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int batch, int n_heads,
    int s_q, int s_k, int d, int64_t q_sb, int64_t q_ss, int64_t q_sh,
    int64_t k_sb, int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss,
    int64_t v_sh, int64_t do_sb, int64_t do_ss, int64_t do_sh, float scale,
    int causal, int dtype, void* stream) {
  const BwdArgs a{q, k, v, dout, static_cast<const float*>(lse),
                  static_cast<const float*>(delta), dq, nullptr, nullptr,
                  batch, n_heads, s_q, s_k, Strides{q_sb, q_ss, q_sh},
                  Strides{k_sb, k_ss, k_sh}, Strides{v_sb, v_ss, v_sh},
                  Strides{do_sb, do_ss, do_sh}, scale, causal};
  return run(Pass::kDq, a, d, dtype, stream);
}

extern "C" int faabric_flash_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int batch,
    int n_heads, int s_q, int s_k, int d, int64_t q_sb, int64_t q_ss,
    int64_t q_sh, int64_t k_sb, int64_t k_ss, int64_t k_sh, int64_t v_sb,
    int64_t v_ss, int64_t v_sh, int64_t do_sb, int64_t do_ss, int64_t do_sh,
    float scale, int causal, int dtype, void* stream) {
  const BwdArgs a{q, k, v, dout, static_cast<const float*>(lse),
                  static_cast<const float*>(delta), nullptr, dk, dv,
                  batch, n_heads, s_q, s_k, Strides{q_sb, q_ss, q_sh},
                  Strides{k_sb, k_ss, k_sh}, Strides{v_sb, v_ss, v_sh},
                  Strides{do_sb, do_ss, do_sh}, scale, causal};
  return run(Pass::kDkv, a, d, dtype, stream);
}
