// PyTorch binding of quant_matmul.cu: the operator
//
//   torch.ops.repro_torch.quant_matmul(x, packed, bits, s, maxq, counters)
//       -> out
//
// registered for CUDA tensors only.  s = None: out (B, M) fp32 is the
// integer-grid sum; s a one-element fp32 tensor on the card: out (B, M) in
// x's dtype is the dequantized product (2s/maxq) acc - s sum_k x.
// counters: int32, zero, at least ceil(M/128) * ceil(B/64) long (reused by
// every launch on the stream; the kernel leaves it zero).  Shapes come from
// the tensors, the stream is PyTorch's current one, the K-split scratch is
// allocated here, and a failed launch raises.  One kernel launch per call.
#include <ATen/ATen.h>
#include <ATen/cuda/CUDAContext.h>
#include <c10/cuda/CUDAGuard.h>
#include <torch/library.h>

#include <optional>

#include "quant_matmul.h"

namespace {

at::Tensor quant_matmul(const at::Tensor& x, const at::Tensor& packed,
                        int64_t bits, const std::optional<at::Tensor>& s,
                        int64_t maxq, const at::Tensor& counters) {
  TORCH_CHECK(x.is_cuda() && packed.device() == x.device() &&
                  counters.device() == x.device(),
              "quant_matmul: x, packed and counters must be on one CUDA "
              "device");
  TORCH_CHECK(x.dim() == 2 && packed.dim() == 2,
              "quant_matmul: x must be (B, K) and packed (K/vals, M)");
  TORCH_CHECK(x.scalar_type() == at::kFloat ||
                  x.scalar_type() == at::kBFloat16,
              "quant_matmul: x must be float32 or bfloat16");
  TORCH_CHECK(packed.scalar_type() == at::kInt,
              "quant_matmul: packed must be int32");
  TORCH_CHECK(counters.scalar_type() == at::kInt && counters.is_contiguous(),
              "quant_matmul: counters must be contiguous int32");
  TORCH_CHECK(bits == 2 || bits == 3 || bits == 4 || bits == 8,
              "quant_matmul: unsupported bit width ", bits);
  const int64_t B = x.size(0), K = x.size(1), M = packed.size(1);
  const int64_t vals = 32 / bits, Kp = packed.size(0);
  TORCH_CHECK(Kp == (K + vals - 1) / vals, "quant_matmul: packed rows ", Kp,
              " do not cover K=", K, " at ", bits, " bits");
  if (s.has_value()) {
    TORCH_CHECK(s->device() == x.device() && s->numel() == 1 &&
                    s->scalar_type() == at::kFloat,
                "quant_matmul: s must be one float32 value on x's device");
    TORCH_CHECK(maxq >= 1 && maxq <= 255, "quant_matmul: maxq ", maxq,
                " out of 1..255");
  }
  const c10::cuda::CUDAGuard guard(x.device());
  const at::Tensor xc = x.contiguous();
  const at::Tensor pc = packed.contiguous();
  const bool x_bf16 = x.scalar_type() == at::kBFloat16;
  at::Tensor out = at::empty(
      {B, M}, x.options().dtype(s.has_value() ? x.scalar_type() : at::kFloat));
  if (B == 0 || M == 0) return out;
  const int sms = at::cuda::getCurrentDeviceProperties()->multiProcessorCount;
  const repro_torch::QmmPlan plan = repro_torch::qmm_plan(
      static_cast<int>(B), static_cast<int>(K), static_cast<int>(M),
      static_cast<int>(bits), x_bf16, sms);
  repro_torch::QmmArgs a{};
  at::Tensor part, rs_part, sc;
  const int64_t n_split = (int64_t)plan.tiles_n * plan.tiles_b - plan.full;
  if (n_split > 0) {
    TORCH_CHECK(counters.numel() >= n_split, "quant_matmul: counters hold ",
                counters.numel(), " tiles, the launch needs ", n_split);
    part = at::empty({n_split * plan.splits * plan.bm * plan.bn},
                     x.options().dtype(at::kFloat));
    a.part = part.data_ptr<float>();
    if (s.has_value()) {
      rs_part = at::empty({n_split * plan.splits * plan.bm},
                          x.options().dtype(at::kFloat));
      a.rs_part = rs_part.data_ptr<float>();
    }
    a.counters = counters.data_ptr<int32_t>();
  }
  if (s.has_value()) {
    sc = s->contiguous();
    a.s = sc.data_ptr<float>();
    a.maxq = static_cast<int>(maxq);
  }
  a.x = xc.data_ptr();
  a.x_bf16 = x_bf16;
  a.packed = pc.data_ptr<int32_t>();
  a.B = static_cast<int>(B);
  a.K = static_cast<int>(K);
  a.M = static_cast<int>(M);
  a.bits = static_cast<int>(bits);
  a.out = out.data_ptr();
  a.out_bf16 = s.has_value() && x_bf16;
  const cudaError_t err = repro_torch::qmm_launch(
      plan, a, at::cuda::getCurrentCUDAStream().stream());
  TORCH_CHECK(err == cudaSuccess, "quant_matmul launch failed: ",
              cudaGetErrorString(err));
  return out;
}

}  // namespace

TORCH_LIBRARY_FRAGMENT(repro_torch, m) {
  m.def(
      "quant_matmul(Tensor x, Tensor packed, int bits, Tensor? s, int maxq, "
      "Tensor counters) -> Tensor");
}

TORCH_LIBRARY_IMPL(repro_torch, CUDA, m) {
  m.impl("quant_matmul", &quant_matmul);
}
