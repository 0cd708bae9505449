// Fused RMS norm forward for Hopper (sm_90a).
//
// Replaces faabric_tpu/ops/rms_norm.py::_rms_kernel (the Pallas kernel
// launched by _rms_forward). Computes, per row of x (rows, D):
//     out = x * rsqrt(mean(x^2) + eps) * scale
// with fp32 statistics and fp32 products, rounded once to x's dtype.
//
// Bound: bytes. Each element is read once and written once and costs a
// handful of flops, far below the card's ~295 flops/byte balance point.
// Design: one block per row; each thread keeps up to ELEMS_PER_THREAD
// elements of its row in registers between the reduction and the write,
// so the row crosses device memory once in each direction. Neighbouring
// threads read neighbouring elements (coalesced). The sum of squares is
// reduced with warp shuffles, then across warps through shared memory.
// Rows of any count; D up to kMaxThreads * ELEMS_PER_THREAD = 8192.
//
// Plain C interface: the host passes raw pointers and the stream, and
// gets cudaGetLastError() back after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kElemsPerThread = 8;
constexpr int kMaxThreads = 1024;

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

template <typename T>
__global__ void rms_norm_kernel(const T* __restrict__ x,
                                const float* __restrict__ scale,
                                T* __restrict__ out, int d, float eps) {
  __shared__ float warp_sums[kMaxThreads / 32];
  const int64_t row = blockIdx.x;
  const T* xr = x + row * d;
  T* outr = out + row * d;

  float vals[kElemsPerThread];
  float sumsq = 0.f;
#pragma unroll
  for (int i = 0; i < kElemsPerThread; ++i) {
    const int col = threadIdx.x + i * blockDim.x;
    vals[i] = col < d ? to_float(xr[col]) : 0.f;
    sumsq += vals[i] * vals[i];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sumsq += __shfl_xor_sync(0xffffffffu, sumsq, off);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  if (lane == 0) warp_sums[warp] = sumsq;
  __syncthreads();
  if (warp == 0) {
    float s = lane < n_warps ? warp_sums[lane] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) warp_sums[0] = s;
  }
  __syncthreads();
  const float inv = rsqrtf(warp_sums[0] / static_cast<float>(d) + eps);

#pragma unroll
  for (int i = 0; i < kElemsPerThread; ++i) {
    const int col = threadIdx.x + i * blockDim.x;
    if (col < d) outr[col] = from_float<T>(vals[i] * inv * scale[col]);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t as int.
extern "C" int faabric_rms_norm_fwd(const void* x, const void* scale,
                                    void* out, int64_t rows, int d,
                                    float eps, int dtype, void* stream) {
  if (rows <= 0) return 0;
  int threads = (d + kElemsPerThread - 1) / kElemsPerThread;
  threads = ((threads + 31) / 32) * 32;
  if (threads < 32) threads = 32;
  if (threads > kMaxThreads || rows > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(rows));
  if (dtype == 0) {
    rms_norm_kernel<float><<<grid, threads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(scale),
        static_cast<float*>(out), d, eps);
  } else if (dtype == 1) {
    rms_norm_kernel<__nv_bfloat16><<<grid, threads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(out), d,
        eps);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
