// Hopper (sm_90a) building blocks for kernels that feed wgmma from TMA:
// tensor maps over (B, S, H, 64) bf16 operands, the dynamic shared memory
// limit, mbarriers, the bulk tensor copy, wgmma shared-memory descriptors
// for the 128-byte swizzle, and the m64n64k16 bf16 products with fp32
// accumulators.
//
// Layouts. A tensor map's box is 64 rows of one (b, h), each row the 64
// head-dim values (128 bytes). TMA writes it to shared memory with the
// 128-byte swizzle: the 16-byte chunk c of row r lands at chunk
// c ^ (r % 8), so a tile is 8 KB and must start on a 1024-byte boundary.
// wgmma reads such a tile in two ways:
//   - K-major (the 64 values of a row are the k dimension): A or B of
//     X.Y^T; the k-th 16-value step starts 32 bytes further;
//   - MN-major (the rows are the k dimension, B only, with wgmma's
//     transpose bit): B of X.Y; the k-th 16-row step starts 2048 bytes
//     further.
// Both use 1024 bytes between groups of 8 rows.
//
// Accumulator and register-A fragments of m64nNk16 (warp w of the
// warpgroup, g = lane / 4, t = lane % 4): warp w owns rows 16w + g and
// 16w + g + 8; accumulator d[n][0..1] holds row 16w + g, columns
// 8n + 2t and 8n + 2t + 1, d[n][2..3] the same columns of row
// 16w + g + 8; A's four registers are laid out as mma.sync m16n8k16's.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "flash_common.cuh"

namespace {

constexpr int kTileRows = 64;                      // rows of a TMA box
constexpr int kTileElems = kTileRows * 64;         // bf16 values of a tile
constexpr uint32_t kTileBytes = kTileElems * 2;    // 8 KB
constexpr int kWarpgroupThreads = 128;
constexpr float kLog2e = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// Host: tensor maps
// ---------------------------------------------------------------------------

using EncodeTiledFn = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, reached through the runtime so that
// no build links libcuda; null where the driver lacks it
inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found{};
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

// A map over a bf16 (B, S, H, 64) operand with element strides `st`,
// boxes of kTileRows rows of one (b, h) with the 128-byte swizzle. Rows
// past S read as zeros. A dim of extent 1 is never stepped, so its
// stride is replaced by a well-formed one. False if the driver refuses.
inline bool bshd_tensor_map(CUtensorMap* map, const void* base, int batch,
                            int seq, int n_heads, const Strides& st) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t row = 64 * 2;
  const cuuint64_t h = n_heads > 1 ? cuuint64_t(st.h) * 2 : row;
  const cuuint64_t s = seq > 1 ? cuuint64_t(st.s) * 2 : h * n_heads;
  const cuuint64_t b = batch > 1 ? cuuint64_t(st.b) * 2 : s * seq;
  const cuuint64_t dims[4] = {64, cuuint64_t(n_heads), cuuint64_t(seq),
                              cuuint64_t(batch)};
  const cuuint64_t strides[3] = {h, s, b};  // bytes, of dims 1..3
  const cuuint32_t box[4] = {64, 1, kTileRows, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Lift a kernel's dynamic shared memory limit, once per device (`done`
// holds a bit per device)
inline cudaError_t allow_smem(const void* kernel, int bytes, uint64_t& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = uint64_t(1) << (dev & 63);
  if (done & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess) done |= bit;
  return err;
}

// ---------------------------------------------------------------------------
// Device: shared memory, mbarriers, TMA
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The block's dynamic shared memory from its first 1024-byte boundary
// (the launch asks for 1024 bytes more than it uses)
__device__ __forceinline__ uint8_t* dynamic_smem_1024() {
  extern __shared__ uint8_t smem_raw[];
  return smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

// Makes the initialised barriers visible to the async proxy (TMA)
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(smem_u32(bar)) : "memory");
}

// Arrive and add `bytes` to the transactions the phase waits for
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar,
                                              uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  return done != 0;
}

// Wait for the phase of parity `parity` to complete. A wait that lasts
// ~10 s (2^34 cycles) traps, so a broken pipeline fails its launch
// instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long start = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - start > (1ll << 34)) __trap();
}

// One box of a 4-D tensor map at coordinates (c0, c1, c2, c3), innermost
// first, into shared memory; completion is counted on `bar` in bytes
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Barrier among `count` threads (a multiple of 32) under id `id` (1-15)
__device__ __forceinline__ void named_barrier_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" :: "r"(id), "r"(count) : "memory");
}

// ---------------------------------------------------------------------------
// Device: wgmma
// ---------------------------------------------------------------------------

// Descriptor of a 128-byte-swizzled tile (1024-byte aligned base, or
// base + a k step): start address, 1024 bytes between 8-row groups in
// both offset fields (the leading one is not read at these shapes),
// layout 1 = 128-byte swizzle
__device__ __forceinline__ uint64_t wgmma_desc(const void* tile) {
  const uint64_t addr = smem_u32(tile);
  return ((addr & 0x3FFFFu) >> 4) | (uint64_t(1024 >> 4) << 16) |
         (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}

// Descriptor offsets of k step j (16 values): along a K-major row, or
// down an MN-major tile
__device__ __forceinline__ uint64_t k_major_step(int j) { return 2 * j; }
__device__ __forceinline__ uint64_t mn_major_step(int j) { return 128 * j; }

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// Wait until at most the newest commit group is still in flight
__device__ __forceinline__ void wgmma_wait_all_but_newest() {
  asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
}

// Keeps the compiler from moving reads or writes of the accumulators
// across the asynchronous products
__device__ __forceinline__ void fence_operands(float (&d)[8][4]) {
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[n][e]) :: "memory");
}

#define FAABRIC_WGMMA_ACC(d)                                                 \
  "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),                \
      "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),            \
      "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),            \
      "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),            \
      "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),            \
      "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),            \
      "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),            \
      "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])

// d (+)= A.B^T for a 64 x 16 A and a 64 x 16 B, both K-major tiles in
// shared memory; `accumulate` 0 overwrites d
__device__ __forceinline__ void wgmma_ss(float (&d)[8][4], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : FAABRIC_WGMMA_ACC(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d += A.B for a 64 x 16 A in registers (bf16 pairs, mma.sync A layout)
// and a 16 x 64 B read MN-major from shared memory
__device__ __forceinline__ void wgmma_rs_mn(float (&d)[8][4],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : FAABRIC_WGMMA_ACC(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef FAABRIC_WGMMA_ACC

}  // namespace
