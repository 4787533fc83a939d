// PyTorch binding of kron_mul.cu: the operator
//
//   torch.ops.repro_torch.kron_mul(x, A, B) -> y
//
// registered for CUDA tensors only: x (N, p*q), A (p, p), B (q, q), all
// float32 (non-contiguous operands, such as transposed views, are copied
// contiguous first).  The stream is PyTorch's current one, and a failed
// launch raises.
#include <ATen/ATen.h>
#include <ATen/cuda/CUDAContext.h>
#include <c10/cuda/CUDAGuard.h>
#include <torch/library.h>

#include "kron_mul.h"

namespace {

at::Tensor kron_mul(const at::Tensor& x, const at::Tensor& A,
                    const at::Tensor& B) {
  TORCH_CHECK(x.is_cuda() && x.dim() == 2,
              "kron_mul: x must be a (N, p*q) CUDA tensor");
  TORCH_CHECK(A.device() == x.device() && B.device() == x.device(),
              "kron_mul: x, A and B must be on one CUDA device");
  TORCH_CHECK(x.scalar_type() == at::kFloat &&
                  A.scalar_type() == at::kFloat &&
                  B.scalar_type() == at::kFloat,
              "kron_mul: x, A and B must be float32");
  TORCH_CHECK(A.dim() == 2 && A.size(0) == A.size(1) && B.dim() == 2 &&
                  B.size(0) == B.size(1),
              "kron_mul: A and B must be square");
  const int64_t p = A.size(0), q = B.size(0), N = x.size(0);
  TORCH_CHECK(x.size(1) == p * q, "kron_mul: x feature dim ", x.size(1),
              " != p*q = ", p, "*", q);
  TORCH_CHECK(p <= repro_torch::kKronMaxP && q <= repro_torch::kKronMaxQ,
              "kron_mul: factors ", p, " x ", q, " exceed the kernel's ",
              repro_torch::kKronMaxP, " x ", repro_torch::kKronMaxQ);
  const c10::cuda::CUDAGuard guard(x.device());
  const at::Tensor xc = x.contiguous(), Ac = A.contiguous(),
                   Bc = B.contiguous();
  at::Tensor y = at::empty({N, p * q}, x.options());
  if (N == 0) return y;
  const cudaError_t err = repro_torch::kron_mul_launch(
      xc.data_ptr<float>(), Ac.data_ptr<float>(), Bc.data_ptr<float>(),
      y.data_ptr<float>(), static_cast<int>(N), static_cast<int>(p),
      static_cast<int>(q), at::cuda::getCurrentCUDAStream().stream());
  TORCH_CHECK(err == cudaSuccess, "kron_mul launch failed: ",
              cudaGetErrorString(err));
  return y;
}

}  // namespace

TORCH_LIBRARY_FRAGMENT(repro_torch, m) {
  m.def("kron_mul(Tensor x, Tensor A, Tensor B) -> Tensor");
}

TORCH_LIBRARY_IMPL(repro_torch, CUDA, m) {
  m.impl("kron_mul", &kron_mul);
}
