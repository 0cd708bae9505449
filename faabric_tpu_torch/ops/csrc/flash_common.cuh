// Helpers shared by the flash-attention forward (flash_attention.cu) and
// backward (flash_attention_bwd.cu) kernels: dtype conversions, the
// (batch, seq, head) strides, the bf16 tensor-core product, the re-packing
// of its accumulators and their store, and the body codes.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kColsPerThread = 16;  // FMA bodies: columns of D per thread
constexpr int kMmaThreads = 128;    // tensor-core bodies: 4 warps x 16 rows

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
// v rounded to T and back, as the TPU kernels' x.astype(T) before a product
template <typename T> __device__ __forceinline__ float round_like(float v) {
  return to_float(from_float<T>(v));
}

// Element strides of a (B, S, H, D) tensor whose last dim is contiguous
struct Strides {
  int64_t b, s, h;
};

// Fragment layout of mma.m16n8k16 (g = lane / 4, t = lane % 4): A holds
// rows g and g + 8, columns 2t, 2t + 1 and 2t + 8, 2t + 9; B holds
// k = 2t, 2t + 1 and 2t + 8, 2t + 9 of column g; C holds rows g and g + 8,
// columns 2t and 2t + 1.

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

// The 16 x 16 A operand of key (or query) step j, from the C fragments of
// a 16 x 64 product whose columns are the k dimension: s[2j] and
// s[2j + 1] hold columns 16j .. 16j + 15. Each value is rounded to bf16.
// The wgmma bodies use it too: a warp's rows of a wgmma accumulator and of
// a register A operand have the mma.sync layouts.
__device__ __forceinline__ void a_from_c(uint32_t (&a)[4],
                                         const float (&lo)[4],
                                         const float (&hi)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// Rows r0 and r0 + 8 of this warp's C fragments into a contiguous
// (B, S, H, D) output
template <int D>
__device__ __forceinline__ void store_c(__nv_bfloat16* out,
                                        const float (&acc)[D / 8][4], int b,
                                        int r0, int s, int n_heads, int h,
                                        int t) {
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

// The bodies a launcher takes (ops/flash_attention.py picks one per call)
enum Body : int { kFmaBody = 0, kMmaBody = 1, kWgmmaBody = 2 };

// The 4-byte pair reads of the tensor-core bodies need every base pointer
// and stride to keep bf16 pairs 4-byte aligned.
inline bool pair_aligned(const void* p, const Strides& st) {
  return reinterpret_cast<uintptr_t>(p) % 4 == 0 && st.b % 2 == 0 &&
         st.s % 2 == 0 && st.h % 2 == 0;
}

}  // namespace
