// PyTorch binding of hadamard.cu: the operator
//
//   torch.ops.repro_torch.hadamard(x, signs, signs_after) -> y
//
// registered for CUDA tensors only: x (N, n) and signs (n,) float32, n a
// power of two.  The stream is PyTorch's current one, and a failed launch
// raises.
#include <ATen/ATen.h>
#include <ATen/cuda/CUDAContext.h>
#include <c10/cuda/CUDAGuard.h>
#include <torch/library.h>

#include "hadamard.h"

namespace {

at::Tensor hadamard(const at::Tensor& x, const at::Tensor& signs,
                    bool signs_after) {
  TORCH_CHECK(x.is_cuda() && x.dim() == 2,
              "hadamard: x must be a (N, n) CUDA tensor");
  TORCH_CHECK(signs.device() == x.device(),
              "hadamard: x and signs must be on one CUDA device");
  TORCH_CHECK(x.scalar_type() == at::kFloat &&
                  signs.scalar_type() == at::kFloat,
              "hadamard: x and signs must be float32");
  const int64_t N = x.size(0), n = x.size(1);
  TORCH_CHECK(n >= 2 && (n & (n - 1)) == 0 && n <= repro_torch::kHadamardMaxN,
              "hadamard: dim must be a power of two in [2, ",
              repro_torch::kHadamardMaxN, "], got ", n);
  TORCH_CHECK(signs.dim() == 1 && signs.size(0) == n,
              "hadamard: signs must be (n,)");
  int log2n = 0;
  while ((int64_t{1} << log2n) < n) ++log2n;
  const c10::cuda::CUDAGuard guard(x.device());
  const at::Tensor xc = x.contiguous(), sc = signs.contiguous();
  at::Tensor y = at::empty({N, n}, x.options());
  if (N == 0) return y;
  const cudaError_t err = repro_torch::hadamard_launch(
      xc.data_ptr<float>(), sc.data_ptr<float>(), y.data_ptr<float>(),
      static_cast<int>(N), log2n, signs_after,
      at::cuda::getCurrentCUDAStream().stream());
  TORCH_CHECK(err == cudaSuccess, "hadamard launch failed: ",
              cudaGetErrorString(err));
  return y;
}

}  // namespace

TORCH_LIBRARY_FRAGMENT(repro_torch, m) {
  m.def("hadamard(Tensor x, Tensor signs, bool signs_after) -> Tensor");
}

TORCH_LIBRARY_IMPL(repro_torch, CUDA, m) {
  m.impl("hadamard", &hadamard);
}
