// Device windows shared between processes on one card (CUDA IPC).
//
// The cross-process device plane (device_plane/xproc.py) gives each
// process one window that its peers map: the ring-permute kernel
// (ring_permute.cu) writes shards straight into a peer's window, and a
// fold reads the peers' deposits from theirs. A window is cudaMalloc'd
// here, never taken from PyTorch's caching allocator: a block of that
// allocator may be a sub-range of a larger allocation, or (with
// expandable_segments) have no IPC handle at all.
//
// No kernel lives here. Plain C interface, as the kernels': every call
// sets the device, restores the caller's, and returns a cudaError_t as
// int. A handle is CUDA_IPC_HANDLE_SIZE (64) bytes.

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace {

// Runs body on `device`, then restores the caller's current device
template <typename F>
int on_device(int device, F body) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (prev != device) {
    err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const cudaError_t out = body();
  if (prev != device) cudaSetDevice(prev);
  return static_cast<int>(out);
}

}  // namespace

extern "C" int faabric_ipc_handle_size() {
  return static_cast<int>(sizeof(cudaIpcMemHandle_t));
}

extern "C" int faabric_ipc_alloc(int device, int64_t nbytes, void** ptr) {
  return on_device(device, [&] {
    return cudaMalloc(ptr, static_cast<size_t>(nbytes));
  });
}

extern "C" int faabric_ipc_free(int device, void* ptr) {
  return on_device(device, [&] { return cudaFree(ptr); });
}

// out: sizeof(cudaIpcMemHandle_t) bytes
extern "C" int faabric_ipc_get_handle(int device, void* ptr,
                                      unsigned char* out) {
  return on_device(device, [&] {
    cudaIpcMemHandle_t handle;
    const cudaError_t err = cudaIpcGetMemHandle(&handle, ptr);
    if (err == cudaSuccess) std::memcpy(out, &handle, sizeof(handle));
    return err;
  });
}

// Fails (cudaErrorInvalidResourceHandle or similar) on a handle of this
// same process: a process reads its own window directly
extern "C" int faabric_ipc_open(int device, const unsigned char* in,
                                void** ptr) {
  return on_device(device, [&] {
    cudaIpcMemHandle_t handle;
    std::memcpy(&handle, in, sizeof(handle));
    return cudaIpcOpenMemHandle(ptr, handle,
                                cudaIpcMemLazyEnablePeerAccess);
  });
}

extern "C" int faabric_ipc_close(int device, void* ptr) {
  return on_device(device, [&] { return cudaIpcCloseMemHandle(ptr); });
}
