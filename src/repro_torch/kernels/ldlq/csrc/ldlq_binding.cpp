// PyTorch binding of ldlq.cu: the operator
//
//   torch.ops.repro_torch.ldlq_block(W, base, U, noise, maxq) -> (Q, E)
//
// registered for CUDA tensors only.  W, base and noise may be column-block
// views of wider matrices (unit column stride, any row stride); the stream
// is PyTorch's current one, and a failed launch raises.
#include <ATen/ATen.h>
#include <ATen/cuda/CUDAContext.h>
#include <c10/cuda/CUDAGuard.h>
#include <torch/library.h>

#include <optional>
#include <tuple>

#include "ldlq.h"

namespace {

void check_rows(const at::Tensor& t, const at::Tensor& like,
                const char* name) {
  TORCH_CHECK(t.device() == like.device(), "ldlq_block: ", name,
              " must be on W's device");
  TORCH_CHECK(t.scalar_type() == at::kFloat, "ldlq_block: ", name,
              " must be float32");
  TORCH_CHECK(t.dim() == 2 && t.sizes().equals(like.sizes()), "ldlq_block: ",
              name, " must be (M, nb) like W");
  TORCH_CHECK(t.size(1) <= 1 || t.stride(1) == 1, "ldlq_block: ", name,
              " needs a unit column stride");
}

std::tuple<at::Tensor, at::Tensor> ldlq_block(
    const at::Tensor& W, const at::Tensor& base, const at::Tensor& U,
    const std::optional<at::Tensor>& noise, double maxq) {
  TORCH_CHECK(W.is_cuda() && W.dim() == 2,
              "ldlq_block: W must be a (M, nb) CUDA tensor");
  const int64_t M = W.size(0), nb = W.size(1);
  TORCH_CHECK(nb >= 1 && nb <= repro_torch::kLdlqMaxBlock,
              "ldlq_block: block width ", nb, " not in [1, ",
              repro_torch::kLdlqMaxBlock, "]");
  check_rows(W, W, "W");
  check_rows(base, W, "base");
  if (noise.has_value()) check_rows(*noise, W, "noise");
  TORCH_CHECK(U.device() == W.device() && U.scalar_type() == at::kFloat &&
                  U.dim() == 2 && U.size(0) == nb && U.size(1) == nb,
              "ldlq_block: U must be (nb, nb) float32 on W's device");
  const c10::cuda::CUDAGuard guard(W.device());
  const at::Tensor Uc = U.contiguous();
  at::Tensor Q = at::empty({M, nb}, W.options());
  at::Tensor E = at::empty({M, nb}, W.options());
  if (M == 0) return {Q, E};
  const cudaError_t err = repro_torch::ldlq_block_launch(
      W.data_ptr<float>(), static_cast<int>(W.stride(0)),
      base.data_ptr<float>(), static_cast<int>(base.stride(0)),
      Uc.data_ptr<float>(),
      noise.has_value() ? noise->data_ptr<float>() : nullptr,
      noise.has_value() ? static_cast<int>(noise->stride(0)) : 0,
      Q.data_ptr<float>(), E.data_ptr<float>(), static_cast<int>(M),
      static_cast<int>(nb), static_cast<float>(maxq),
      at::cuda::getCurrentCUDAStream().stream());
  TORCH_CHECK(err == cudaSuccess, "ldlq_block launch failed: ",
              cudaGetErrorString(err));
  return {Q, E};
}

}  // namespace

TORCH_LIBRARY_FRAGMENT(repro_torch, m) {
  m.def(
      "ldlq_block(Tensor W, Tensor base, Tensor U, Tensor? noise, float maxq)"
      " -> (Tensor, Tensor)");
}

TORCH_LIBRARY_IMPL(repro_torch, CUDA, m) {
  m.impl("ldlq_block", &ldlq_block);
}
