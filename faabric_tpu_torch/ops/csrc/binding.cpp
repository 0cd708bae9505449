// PyTorch binding of the CUDA kernels in this directory.
//
// The only source that includes PyTorch's headers: the kernels keep a
// plain C interface (raw pointers, the stream, a cudaError_t back) so
// that nvcc compiles them without those headers. The Python wrappers
// check device, dtype, shape and contiguity and allocate the outputs;
// this file re-checks what a wrong pointer would turn into a fault,
// launches on PyTorch's current stream and raises on a refused launch.

#include <ATen/cuda/CUDAContext.h>
#include <c10/cuda/CUDAException.h>
#include <c10/cuda/CUDAGuard.h>
#include <torch/extension.h>

#include <cstdint>
#include <initializer_list>
#include <string>
#include <vector>

extern "C" int faabric_rms_norm_fwd(const void* x, const void* scale,
                                    void* out, int64_t rows, int d,
                                    float eps, int dtype, void* stream);
extern "C" int faabric_flash_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse,
    int batch, int n_heads, int s_q, int s_k, int d, int64_t q_sb,
    int64_t q_ss, int64_t q_sh, int64_t k_sb, int64_t k_ss, int64_t k_sh,
    int64_t v_sb, int64_t v_ss, int64_t v_sh, float scale, int causal,
    int dtype, int body, void* stream);
extern "C" int faabric_flash_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* out, const void* lse, const void* g_lse, void* delta,
    void* dq, int batch, int n_heads, int s_q, int s_k, int d, int64_t q_sb,
    int64_t q_ss, int64_t q_sh, int64_t k_sb, int64_t k_ss, int64_t k_sh,
    int64_t v_sb, int64_t v_ss, int64_t v_sh, int64_t do_sb, int64_t do_ss,
    int64_t do_sh, int64_t o_sb, int64_t o_ss, int64_t o_sh, float scale,
    int causal, int dtype, int body, void* stream);
extern "C" int faabric_flash_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int batch,
    int n_heads, int s_q, int s_k, int d, int64_t q_sb, int64_t q_ss,
    int64_t q_sh, int64_t k_sb, int64_t k_ss, int64_t k_sh, int64_t v_sb,
    int64_t v_ss, int64_t v_sh, int64_t do_sb, int64_t do_ss, int64_t do_sh,
    float scale, int causal, int dtype, int body, void* stream);
extern "C" int faabric_ring_permute(const void* const* srcs,
                                    void* const* dsts, int n, int shift,
                                    int64_t nbytes, void* stream);
extern "C" int faabric_ipc_handle_size();
extern "C" int faabric_ipc_alloc(int device, int64_t nbytes, void** ptr);
extern "C" int faabric_ipc_free(int device, void* ptr);
extern "C" int faabric_ipc_get_handle(int device, void* ptr,
                                      unsigned char* out);
extern "C" int faabric_ipc_open(int device, const unsigned char* in,
                                void** ptr);
extern "C" int faabric_ipc_close(int device, void* ptr);

namespace {

int dtype_code(const at::Tensor& t) {
  if (t.scalar_type() == at::kFloat) return 0;
  if (t.scalar_type() == at::kBFloat16) return 1;
  TORCH_CHECK(false, "kernel takes float32 or bfloat16, got ",
              t.scalar_type());
  return -1;
}

void* current_stream(const at::Tensor& t) {
  return at::cuda::getCurrentCUDAStream(t.device().index()).stream();
}

void check_launch(int err) {
  C10_CUDA_CHECK(static_cast<cudaError_t>(err));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// x (rows, D) contiguous, scale (D,) float32, out like x
void rms_norm_fwd(const at::Tensor& x, const at::Tensor& scale,
                  const at::Tensor& out, double eps) {
  TORCH_CHECK(x.is_cuda() && scale.is_cuda() && out.is_cuda(),
              "rms_norm_fwd: CUDA tensors only");
  TORCH_CHECK(x.dim() == 2 && x.is_contiguous() && out.is_contiguous() &&
                  out.sizes() == x.sizes() &&
                  out.scalar_type() == x.scalar_type(),
              "rms_norm_fwd: x and out must be contiguous (rows, D) alike");
  TORCH_CHECK(scale.scalar_type() == at::kFloat && scale.is_contiguous() &&
                  scale.numel() == x.size(1),
              "rms_norm_fwd: scale must be contiguous float32 (D,)");
  const c10::cuda::CUDAGuard guard(x.device());
  check_launch(faabric_rms_norm_fwd(
      x.data_ptr(), scale.data_ptr(), out.data_ptr(), x.size(0),
      static_cast<int>(x.size(1)), static_cast<float>(eps), dtype_code(x),
      current_stream(x)));
}

// q (B, S_q, H, D), k/v (B, S_k, H, D) with unit last stride, on CUDA,
// of one dtype
void check_qkv(const char* name, const at::Tensor& q, const at::Tensor& k,
               const at::Tensor& v) {
  for (const at::Tensor* t : std::initializer_list<const at::Tensor*>{&q, &k, &v})
    TORCH_CHECK(t->is_cuda() && t->dim() == 4, name,
                ": q, k, v are CUDA (B, S, H, D)");
  TORCH_CHECK(q.stride(3) == 1 && k.stride(3) == 1 && v.stride(3) == 1,
              name, ": last dim must be contiguous");
  TORCH_CHECK(k.sizes() == v.sizes() && q.size(0) == k.size(0) &&
                  q.size(2) == k.size(2) && q.size(3) == k.size(3),
              name, ": shape mismatch");
  TORCH_CHECK(k.scalar_type() == q.scalar_type() &&
                  v.scalar_type() == q.scalar_type(),
              name, ": q, k, v must share a dtype");
}

// A contiguous CUDA output of the given shape and dtype
void check_out(const char* name, const at::Tensor& o, at::IntArrayRef sizes,
               at::ScalarType dtype) {
  TORCH_CHECK(o.is_cuda() && o.is_contiguous() && o.sizes() == sizes &&
                  o.scalar_type() == dtype,
              name, ": outputs must be contiguous CUDA tensors of the "
              "input's shape and dtype");
}

// A per-row statistic: contiguous float32 (B*H, S_q) on CUDA
void check_stat(const char* name, const at::Tensor& st, const at::Tensor& q) {
  TORCH_CHECK(st.is_cuda() && st.scalar_type() == at::kFloat &&
                  st.is_contiguous() && st.dim() == 2 &&
                  st.size(0) == q.size(0) * q.size(2) &&
                  st.size(1) == q.size(1),
              name, ": lse, g_lse and delta must be contiguous float32 "
              "(B*H, S_q)");
}

// o contiguous like q; lse (B*H, S_q) float32 contiguous; body: 0 = fma,
// 1 = mma, 2 = wgmma (ops/flash_attention.py::_fwd_body)
void flash_fwd(const at::Tensor& q, const at::Tensor& k, const at::Tensor& v,
               const at::Tensor& o, const at::Tensor& lse, double scale,
               bool causal, int64_t body) {
  check_qkv("flash_fwd", q, k, v);
  check_out("flash_fwd", o, q.sizes(), q.scalar_type());
  check_stat("flash_fwd", lse, q);
  const c10::cuda::CUDAGuard guard(q.device());
  check_launch(faabric_flash_fwd(
      q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
      static_cast<int>(q.size(0)), static_cast<int>(q.size(2)),
      static_cast<int>(q.size(1)), static_cast<int>(k.size(1)),
      static_cast<int>(q.size(3)), q.stride(0), q.stride(1), q.stride(2),
      k.stride(0), k.stride(1), k.stride(2), v.stride(0), v.stride(1),
      v.stride(2), static_cast<float>(scale), causal ? 1 : 0, dtype_code(q),
      static_cast<int>(body), current_stream(q)));
}

// dout like q with unit last stride; lse (B*H, S_q) float32
void check_bwd(const char* name, const at::Tensor& q, const at::Tensor& k,
               const at::Tensor& v, const at::Tensor& dout,
               const at::Tensor& lse) {
  check_qkv(name, q, k, v);
  TORCH_CHECK(dout.is_cuda() && dout.sizes() == q.sizes() &&
                  dout.scalar_type() == q.scalar_type() &&
                  dout.stride(3) == 1,
              name, ": dout must be like q with a contiguous last dim");
  check_stat(name, lse, q);
}

// body: 0 = fma, 1 = mma, 2 = wgmma (ops/flash_attention.py::_bwd_body)
void flash_bwd_dq(const at::Tensor& q, const at::Tensor& k,
                  const at::Tensor& v, const at::Tensor& dout,
                  const at::Tensor& out, const at::Tensor& lse,
                  const c10::optional<at::Tensor>& g_lse,
                  const at::Tensor& delta, const at::Tensor& dq, double scale,
                  bool causal, int64_t body) {
  check_bwd("flash_bwd_dq", q, k, v, dout, lse);
  TORCH_CHECK(out.is_cuda() && out.sizes() == q.sizes() &&
                  out.scalar_type() == q.scalar_type() && out.stride(3) == 1,
              "flash_bwd_dq: out must be like q with a contiguous last dim");
  if (g_lse.has_value()) check_stat("flash_bwd_dq", *g_lse, q);
  check_stat("flash_bwd_dq", delta, q);
  check_out("flash_bwd_dq", dq, q.sizes(), q.scalar_type());
  const c10::cuda::CUDAGuard guard(q.device());
  check_launch(faabric_flash_bwd_dq(
      q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
      out.data_ptr(), lse.data_ptr(),
      g_lse.has_value() ? g_lse->data_ptr() : nullptr, delta.data_ptr(),
      dq.data_ptr(), static_cast<int>(q.size(0)), static_cast<int>(q.size(2)),
      static_cast<int>(q.size(1)), static_cast<int>(k.size(1)),
      static_cast<int>(q.size(3)), q.stride(0), q.stride(1), q.stride(2),
      k.stride(0), k.stride(1), k.stride(2), v.stride(0), v.stride(1),
      v.stride(2), dout.stride(0), dout.stride(1), dout.stride(2),
      out.stride(0), out.stride(1), out.stride(2), static_cast<float>(scale),
      causal ? 1 : 0, dtype_code(q), static_cast<int>(body),
      current_stream(q)));
}

void flash_bwd_dkv(const at::Tensor& q, const at::Tensor& k,
                   const at::Tensor& v, const at::Tensor& dout,
                   const at::Tensor& lse, const at::Tensor& delta,
                   const at::Tensor& dk, const at::Tensor& dv, double scale,
                   bool causal, int64_t body) {
  check_bwd("flash_bwd_dkv", q, k, v, dout, lse);
  check_stat("flash_bwd_dkv", delta, q);
  check_out("flash_bwd_dkv", dk, k.sizes(), k.scalar_type());
  check_out("flash_bwd_dkv", dv, v.sizes(), v.scalar_type());
  const c10::cuda::CUDAGuard guard(q.device());
  check_launch(faabric_flash_bwd_dkv(
      q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
      lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
      static_cast<int>(q.size(0)), static_cast<int>(q.size(2)),
      static_cast<int>(q.size(1)), static_cast<int>(k.size(1)),
      static_cast<int>(q.size(3)), q.stride(0), q.stride(1), q.stride(2),
      k.stride(0), k.stride(1), k.stride(2), v.stride(0), v.stride(1),
      v.stride(2), dout.stride(0), dout.stride(1), dout.stride(2),
      static_cast<float>(scale), causal ? 1 : 0, dtype_code(q),
      static_cast<int>(body), current_stream(q)));
}

// ins, outs: n contiguous CUDA tensors of one dtype, numel and device;
// outs[(r + shift) % n] receives ins[r]
void ring_permute(const std::vector<at::Tensor>& ins,
                  const std::vector<at::Tensor>& outs, int64_t shift) {
  const int64_t n = static_cast<int64_t>(ins.size());
  TORCH_CHECK(n >= 1 && static_cast<int64_t>(outs.size()) == n,
              "ring_permute: as many outputs as inputs, at least one");
  TORCH_CHECK(shift >= 0 && shift < n, "ring_permute: 0 <= shift < n");
  std::vector<const void*> srcs(n);
  std::vector<void*> dsts(n);
  for (int64_t r = 0; r < n; ++r) {
    for (const at::Tensor* t :
         std::initializer_list<const at::Tensor*>{&ins[r], &outs[r]})
      TORCH_CHECK(t->is_cuda() && t->is_contiguous() &&
                      t->device() == ins[0].device() &&
                      t->scalar_type() == ins[0].scalar_type() &&
                      t->numel() == ins[0].numel(),
                  "ring_permute: contiguous CUDA tensors of one device, "
                  "dtype and numel");
    srcs[r] = ins[r].data_ptr();
    dsts[r] = outs[r].data_ptr();
  }
  const c10::cuda::CUDAGuard guard(ins[0].device());
  check_launch(faabric_ring_permute(
      srcs.data(), dsts.data(), static_cast<int>(n), static_cast<int>(shift),
      ins[0].numel() * static_cast<int64_t>(ins[0].element_size()),
      current_stream(ins[0])));
}

// ins: contiguous CUDA tensors of one dtype, numel and device; dsts: one
// raw device pointer per input (a local tensor's or a window mapped from
// another process), each receiving its input's bytes: the kernel's
// shift-0 form, outs[r] = ins[r]
void ring_permute_ptrs(const std::vector<at::Tensor>& ins,
                       const std::vector<int64_t>& dsts) {
  const int64_t n = static_cast<int64_t>(ins.size());
  TORCH_CHECK(n >= 1 && static_cast<int64_t>(dsts.size()) == n,
              "ring_permute_ptrs: one destination per input, at least one");
  std::vector<const void*> srcs(n);
  std::vector<void*> outs(n);
  for (int64_t r = 0; r < n; ++r) {
    TORCH_CHECK(ins[r].is_cuda() && ins[r].is_contiguous() &&
                    ins[r].device() == ins[0].device() &&
                    ins[r].scalar_type() == ins[0].scalar_type() &&
                    ins[r].numel() == ins[0].numel(),
                "ring_permute_ptrs: contiguous CUDA tensors of one device, "
                "dtype and numel");
    TORCH_CHECK(dsts[r] != 0, "ring_permute_ptrs: null destination");
    srcs[r] = ins[r].data_ptr();
    outs[r] = reinterpret_cast<void*>(dsts[r]);
  }
  const c10::cuda::CUDAGuard guard(ins[0].device());
  check_launch(faabric_ring_permute(
      srcs.data(), outs.data(), static_cast<int>(n), 0,
      ins[0].numel() * static_cast<int64_t>(ins[0].element_size()),
      current_stream(ins[0])));
}

int64_t ipc_alloc(int64_t device, int64_t nbytes) {
  void* ptr = nullptr;
  C10_CUDA_CHECK(static_cast<cudaError_t>(
      faabric_ipc_alloc(static_cast<int>(device), nbytes, &ptr)));
  return reinterpret_cast<int64_t>(ptr);
}

void ipc_free(int64_t device, int64_t ptr) {
  C10_CUDA_CHECK(static_cast<cudaError_t>(faabric_ipc_free(
      static_cast<int>(device), reinterpret_cast<void*>(ptr))));
}

pybind11::bytes ipc_handle(int64_t device, int64_t ptr) {
  std::vector<unsigned char> out(faabric_ipc_handle_size());
  C10_CUDA_CHECK(static_cast<cudaError_t>(faabric_ipc_get_handle(
      static_cast<int>(device), reinterpret_cast<void*>(ptr), out.data())));
  return pybind11::bytes(reinterpret_cast<const char*>(out.data()),
                         out.size());
}

int64_t ipc_open(int64_t device, const std::string& handle) {
  TORCH_CHECK(static_cast<int>(handle.size()) == faabric_ipc_handle_size(),
              "ipc_open: a handle is ", faabric_ipc_handle_size(), " bytes");
  void* ptr = nullptr;
  C10_CUDA_CHECK(static_cast<cudaError_t>(faabric_ipc_open(
      static_cast<int>(device),
      reinterpret_cast<const unsigned char*>(handle.data()), &ptr)));
  return reinterpret_cast<int64_t>(ptr);
}

void ipc_close(int64_t device, int64_t ptr) {
  C10_CUDA_CHECK(static_cast<cudaError_t>(faabric_ipc_close(
      static_cast<int>(device), reinterpret_cast<void*>(ptr))));
}

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("rms_norm_fwd", &rms_norm_fwd, "RMS norm forward kernel");
  m.def("flash_fwd", &flash_fwd, "flash attention forward kernel");
  m.def("flash_bwd_dq", &flash_bwd_dq, "flash attention dQ kernel");
  m.def("flash_bwd_dkv", &flash_bwd_dkv, "flash attention dK/dV kernel");
  m.def("ring_permute", &ring_permute, "device-plane ring permute kernel");
  m.def("ring_permute_ptrs", &ring_permute_ptrs,
        "ring permute kernel into raw destination pointers");
  m.def("ipc_alloc", &ipc_alloc, "cudaMalloc a window shared by IPC");
  m.def("ipc_free", &ipc_free, "cudaFree a window");
  m.def("ipc_handle", &ipc_handle, "a window's cudaIpcMemHandle_t bytes");
  m.def("ipc_open", &ipc_open, "map another process's window");
  m.def("ipc_close", &ipc_close, "unmap another process's window");
}
