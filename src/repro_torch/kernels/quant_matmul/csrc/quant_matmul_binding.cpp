// PyTorch binding of quant_matmul.cu: the operator
//
//   torch.ops.repro_torch.quant_matmul_partial(x, packed, bits, splits,
//                                              kp_per_split) -> part
//
// registered for CUDA tensors only.  Shapes come from the tensors, the
// stream is PyTorch's current one, and a failed launch raises.
#include <ATen/ATen.h>
#include <ATen/cuda/CUDAContext.h>
#include <c10/cuda/CUDAGuard.h>
#include <torch/library.h>

#include <algorithm>

#include "quant_matmul.h"

namespace {

at::Tensor quant_matmul_partial(const at::Tensor& x, const at::Tensor& packed,
                                int64_t bits, int64_t splits,
                                int64_t kp_per_split) {
  TORCH_CHECK(x.is_cuda() && packed.device() == x.device(),
              "quant_matmul: x and packed must be on one CUDA device");
  TORCH_CHECK(x.dim() == 2 && packed.dim() == 2,
              "quant_matmul: x must be (B, K) and packed (K/vals, M)");
  TORCH_CHECK(x.scalar_type() == at::kFloat ||
                  x.scalar_type() == at::kBFloat16,
              "quant_matmul: x must be float32 or bfloat16");
  TORCH_CHECK(packed.scalar_type() == at::kInt,
              "quant_matmul: packed must be int32");
  TORCH_CHECK(bits == 2 || bits == 3 || bits == 4 || bits == 8,
              "quant_matmul: unsupported bit width ", bits);
  const int64_t B = x.size(0), K = x.size(1), M = packed.size(1);
  const int64_t vals = 32 / bits, Kp = packed.size(0);
  TORCH_CHECK(Kp == (K + vals - 1) / vals, "quant_matmul: packed rows ", Kp,
              " do not cover K=", K, " at ", bits, " bits");
  TORCH_CHECK(splits >= 1 && kp_per_split >= 1 &&
                  (splits - 1) * kp_per_split < std::max<int64_t>(Kp, 1),
              "quant_matmul: bad K split (", splits, " x ", kp_per_split,
              " of ", Kp, " packed rows)");
  const c10::cuda::CUDAGuard guard(x.device());
  const at::Tensor xc = x.contiguous();
  const at::Tensor pc = packed.contiguous();
  at::Tensor part = at::empty({splits, B, M}, x.options().dtype(at::kFloat));
  if (B == 0 || M == 0) return part;
  const cudaError_t err = repro_torch::qmm_launch(
      xc.data_ptr(), x.scalar_type() == at::kBFloat16,
      pc.data_ptr<int32_t>(), part.data_ptr<float>(), static_cast<int>(B),
      static_cast<int>(K), static_cast<int>(M), static_cast<int>(bits),
      static_cast<int>(splits), static_cast<int>(kp_per_split),
      at::cuda::getCurrentCUDAStream().stream());
  TORCH_CHECK(err == cudaSuccess, "quant_matmul launch failed: ",
              cudaGetErrorString(err));
  return part;
}

}  // namespace

TORCH_LIBRARY_FRAGMENT(repro_torch, m) {
  m.def(
      "quant_matmul_partial(Tensor x, Tensor packed, int bits, int splits, "
      "int kp_per_split) -> Tensor");
}

TORCH_LIBRARY_IMPL(repro_torch, CUDA, m) {
  m.impl("quant_matmul_partial", &quant_matmul_partial);
}
