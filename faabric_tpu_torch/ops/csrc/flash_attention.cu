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
// Bound: at the serving shapes (D = 64, S = 512..2048) attention does
// ~S/2 flops per byte it must move, so the tensor cores bound it. Two
// bodies, one CTA per (batch*head, 64-row q tile) in both, Q.K^T and P.V
// computed in the kernel (no library call):
//   - bf16 (the model's compute dtype): warp-level tensor-core products,
//     mma.sync m16n8k16 bf16 with fp32 accumulators, FlashAttention-2
//     style. Four warps own 16 query rows each and keep Q's fragments, the
//     scores of a 64-key tile and the output accumulator in registers;
//     the score accumulators are re-packed in registers as the A operand
//     of P.V. K/V tiles sit in shared memory with padded rows, so the
//     fragment loads are free of bank conflicts.
//   - float32, and bf16 whose strides are not even: fp32 FMAs, D/16
//     threads per query row, each owning 16 of the D columns of q and of
//     the accumulator in registers; 32-key K/V tiles staged as fp32 in
//     shared memory and read as float4; the row's partial dot products
//     meet by warp shuffles.
// Loads are not overlapped with compute (no cp.async or TMA pipeline)
// and Hopper's wgmma is not used yet: both are later work.
//
// Layout: q, k and v are read through their (batch, seq, head) strides
// (last dim contiguous), so the model's q/k/v views need no copy. O is
// written contiguous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>
#include <type_traits>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 32;   // FMA body's key tile
constexpr int kColsPerThread = 16;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
// p in the dtype of V, as the TPU kernel's p.astype(v.dtype)
template <typename T> __device__ __forceinline__ float round_like(float v) {
  return to_float(from_float<T>(v));
}

struct Strides {
  int64_t b, s, h;
};

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
constexpr int kMmaThreads = 128;  // 4 warps x 16 query rows

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  const __nv_bfloat162 v = __halves2bfloat162(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Fragment layout of mma.m16n8k16 (g = lane / 4, t = lane % 4): A holds
// rows g and g + 8, columns 2t, 2t + 1 and 2t + 8, 2t + 9; B holds
// k = 2t, 2t + 1 and 2t + 8, 2t + 9 of column g; C holds rows g and g + 8,
// columns 2t and 2t + 1.
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

// The tensor-core body reads bf16 pairs as 32-bit words: every pointer
// and stride must keep pairs 4-byte aligned.
bool pairs_aligned(const Args& a) {
  const auto even = [](int64_t x) { return x % 2 == 0; };
  for (const void* p : {a.q, a.k, a.v})
    if (reinterpret_cast<uintptr_t>(p) % 4 != 0) return false;
  for (const Strides& st : {a.qs, a.ks, a.vs})
    if (!even(st.b) || !even(st.s) || !even(st.h)) return false;
  return true;
}

template <typename T, int D>
void launch(const Args& a, cudaStream_t stream) {
  const dim3 grid(a.batch * a.n_heads, (a.s_q + kBlockQ - 1) / kBlockQ);
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    if (pairs_aligned(a)) {
      flash_fwd_mma_kernel<D><<<grid, kMmaThreads, 0, stream>>>(
          static_cast<const T*>(a.q), static_cast<const T*>(a.k),
          static_cast<const T*>(a.v), static_cast<T*>(a.o), a.lse, a.n_heads,
          a.s_q, a.s_k, a.qs, a.ks, a.vs, a.scale, a.causal);
      return;
    }
  }
  flash_fwd_kernel<T, D><<<grid, kBlockQ * (D / kColsPerThread), 0, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<T*>(a.o), a.lse, a.n_heads,
      a.s_q, a.s_k, a.qs, a.ks, a.vs, a.scale, a.causal);
}

template <typename T>
int dispatch_d(int d, const Args& a, cudaStream_t stream) {
  switch (d) {
    case 16: launch<T, 16>(a, stream); break;
    case 32: launch<T, 32>(a, stream); break;
    case 64: launch<T, 64>(a, stream); break;
    case 128: launch<T, 128>(a, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements. Returns a
// cudaError_t as int.
extern "C" int faabric_flash_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse,
    int batch, int n_heads, int s_q, int s_k, int d, int64_t q_sb,
    int64_t q_ss, int64_t q_sh, int64_t k_sb, int64_t k_ss, int64_t k_sh,
    int64_t v_sb, int64_t v_ss, int64_t v_sh, float scale, int causal,
    int dtype, void* stream) {
  if (batch <= 0 || n_heads <= 0 || s_q <= 0 || s_k <= 0) return 0;
  if ((s_q + kBlockQ - 1) / kBlockQ > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, o, static_cast<float*>(lse), batch, n_heads, s_q,
               s_k, Strides{q_sb, q_ss, q_sh}, Strides{k_sb, k_ss, k_sh},
               Strides{v_sb, v_ss, v_sh}, scale, causal};
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_d<float>(d, a, s);
  if (dtype == 1) return dispatch_d<__nv_bfloat16>(d, a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
