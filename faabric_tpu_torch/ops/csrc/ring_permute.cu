// One ring hop of the device plane for Hopper (sm_90a).
//
// Replaces faabric_tpu/device_plane/pallas_ring.py:77, the `kernel` of
// _pallas_permute_call: an HBM->HBM remote DMA in which rank r's flat
// (1, m) shard lands in rank (r + shift) % n's output. On the card the
// ranks of one process share a device, so one launch moves every
// rank's shard at once:
//     dst[(r + shift) % n][0:nbytes) = src[r][0:nbytes)   for r < n
// bitwise, for any element type (the copy is in bytes).
//
// Bound: bytes. Each shard is read once and written once, 2 * n * m *
// itemsize bytes over the card's 3.35 TB/s; there is no arithmetic.
// Design: the n source and n destination pointers travel by value in
// the kernel's parameters (at most kMaxRanks of each), so no pointer
// table is copied to the device before the launch. blockIdx.y is the
// rank and blockIdx.x strides over that rank's shard, so every warp
// reads and writes neighbouring addresses. When every pointer is 16-byte
// aligned the body moves 16 bytes a thread (uint4), four loads in
// flight before the four stores, and the last nbytes % 16 bytes are a
// masked byte tail. Otherwise the body moves the widest unit (8, 4, 2
// or 1 bytes) that divides every pointer and the byte count.
//
// Plain C interface: the host passes raw pointers and the stream, and
// gets cudaGetLastError() back after the launch.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxRanks = 64;
constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr int kMaxDevices = 64;

struct RingPtrs {
  const void* src[kMaxRanks];
  void* dst[kMaxRanks];
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ring_permute_kernel(const RingPtrs p, int n, int shift, int64_t count,
                        int tail) {
  const int r = blockIdx.y;
  const T* __restrict__ src = static_cast<const T*>(p.src[r]);
  T* __restrict__ dst = static_cast<T*>(p.dst[(r + shift) % n]);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  for (; i + (kUnroll - 1) * stride < count; i += kUnroll * stride) {
    T v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = src[i + u * stride];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) dst[i + u * stride] = v[u];
  }
  for (; i < count; i += stride) dst[i] = src[i];
  // Bytes past the last whole unit (only the uint4 body leaves any)
  if (tail > 0 && blockIdx.x == 0 && threadIdx.x < tail) {
    const int64_t off = count * static_cast<int64_t>(sizeof(T)) + threadIdx.x;
    static_cast<unsigned char*>(p.dst[(r + shift) % n])[off] =
        static_cast<const unsigned char*>(p.src[r])[off];
  }
}

// The current device's SM count, queried once per device (so that a
// launch being captured into a CUDA graph makes no query)
int sm_count() {
  static int counts[kMaxDevices] = {0};
  int device = 0;
  cudaGetDevice(&device);
  if (device < 0 || device >= kMaxDevices) return 132;
  if (counts[device] == 0) {
    int sms = 132;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    counts[device] = sms;
  }
  return counts[device];
}

template <typename T>
cudaError_t launch(const RingPtrs& p, int n, int shift, int64_t nbytes,
                   cudaStream_t stream) {
  const int64_t count = nbytes / static_cast<int64_t>(sizeof(T));
  const int tail = static_cast<int>(nbytes - count * sizeof(T));
  const int sms = sm_count();
  // About one full wave of 256-thread CTAs over the whole card, split
  // between the ranks; never more CTAs than a rank has units to move
  const int64_t wave = static_cast<int64_t>(sms) * (2048 / kThreads);
  int64_t per_rank = (wave + n - 1) / n;
  const int64_t needed = (count + kThreads - 1) / kThreads;
  if (per_rank > needed) per_rank = needed;
  if (per_rank < 1) per_rank = 1;
  const dim3 grid(static_cast<unsigned>(per_rank), static_cast<unsigned>(n));
  ring_permute_kernel<T><<<grid, kThreads, 0, stream>>>(p, n, shift, count,
                                                         tail);
  return cudaGetLastError();
}

}  // namespace

// srcs, dsts: n device pointers each (host arrays); every shard holds
// nbytes bytes. Returns a cudaError_t as int.
extern "C" int faabric_ring_permute(const void* const* srcs,
                                    void* const* dsts, int n, int shift,
                                    int64_t nbytes, void* stream) {
  if (n < 1 || n > kMaxRanks || shift < 0 || shift >= n || nbytes < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nbytes == 0) return 0;
  RingPtrs p;
  uintptr_t bits = 0;
  for (int r = 0; r < n; ++r) {
    p.src[r] = srcs[r];
    p.dst[r] = dsts[r];
    bits |= reinterpret_cast<uintptr_t>(srcs[r]) |
            reinterpret_cast<uintptr_t>(dsts[r]);
  }
  auto s = static_cast<cudaStream_t>(stream);
  if (bits % 16 == 0) return static_cast<int>(launch<uint4>(p, n, shift, nbytes, s));
  bits |= static_cast<uintptr_t>(nbytes);
  if (bits % 8 == 0) return static_cast<int>(launch<uint2>(p, n, shift, nbytes, s));
  if (bits % 4 == 0) return static_cast<int>(launch<uint32_t>(p, n, shift, nbytes, s));
  if (bits % 2 == 0) return static_cast<int>(launch<uint16_t>(p, n, shift, nbytes, s));
  return static_cast<int>(launch<uint8_t>(p, n, shift, nbytes, s));
}
