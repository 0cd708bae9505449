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

extern "C" int faabric_rms_norm_fwd(const void* x, const void* scale,
                                    void* out, int64_t rows, int d,
                                    float eps, int dtype, void* stream);
extern "C" int faabric_flash_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse,
    int batch, int n_heads, int s_q, int s_k, int d, int64_t q_sb,
    int64_t q_ss, int64_t q_sh, int64_t k_sb, int64_t k_ss, int64_t k_sh,
    int64_t v_sb, int64_t v_ss, int64_t v_sh, float scale, int causal,
    int dtype, void* stream);

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

// q (B, S_q, H, D), k/v (B, S_k, H, D) with unit last stride; o
// contiguous like q; lse (B*H, S_q) float32 contiguous
void flash_fwd(const at::Tensor& q, const at::Tensor& k, const at::Tensor& v,
               const at::Tensor& o, const at::Tensor& lse, double scale,
               bool causal) {
  for (const at::Tensor* t :
       std::initializer_list<const at::Tensor*>{&q, &k, &v, &o, &lse})
    TORCH_CHECK(t->is_cuda() && t->dim() >= 2, "flash_fwd: CUDA tensors");
  TORCH_CHECK(q.dim() == 4 && k.dim() == 4 && v.dim() == 4,
              "flash_fwd: q, k, v are (B, S, H, D)");
  TORCH_CHECK(q.stride(3) == 1 && k.stride(3) == 1 && v.stride(3) == 1,
              "flash_fwd: last dim must be contiguous");
  TORCH_CHECK(k.sizes() == v.sizes() && q.size(0) == k.size(0) &&
                  q.size(2) == k.size(2) && q.size(3) == k.size(3),
              "flash_fwd: shape mismatch");
  TORCH_CHECK(k.scalar_type() == q.scalar_type() &&
                  v.scalar_type() == q.scalar_type() &&
                  o.scalar_type() == q.scalar_type(),
              "flash_fwd: q, k, v, o must share a dtype");
  TORCH_CHECK(o.is_contiguous() && o.sizes() == q.sizes(),
              "flash_fwd: o must be contiguous like q");
  TORCH_CHECK(lse.scalar_type() == at::kFloat && lse.is_contiguous() &&
                  lse.dim() == 2 && lse.size(0) == q.size(0) * q.size(2) &&
                  lse.size(1) == q.size(1),
              "flash_fwd: lse must be contiguous float32 (B*H, S_q)");
  const c10::cuda::CUDAGuard guard(q.device());
  check_launch(faabric_flash_fwd(
      q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
      static_cast<int>(q.size(0)), static_cast<int>(q.size(2)),
      static_cast<int>(q.size(1)), static_cast<int>(k.size(1)),
      static_cast<int>(q.size(3)), q.stride(0), q.stride(1), q.stride(2),
      k.stride(0), k.stride(1), k.stride(2), v.stride(0), v.stride(1),
      v.stride(2), static_cast<float>(scale), causal ? 1 : 0, dtype_code(q),
      current_stream(q)));
}

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("rms_norm_fwd", &rms_norm_fwd, "RMS norm forward kernel");
  m.def("flash_fwd", &flash_fwd, "flash attention forward kernel");
}
