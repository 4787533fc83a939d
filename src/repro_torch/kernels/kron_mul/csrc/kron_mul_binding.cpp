// PyTorch binding of kron_mul.cu: the operator
//
//   torch.ops.repro_torch.kron_mul(x, A, B, perm, inv_perm, scale,
//                                  transpose) -> y
//
// registered for CUDA tensors only.  x (N, p*q) float32 with unit column
// stride (any row stride; otherwise it is copied contiguous), A (p, p) or
// None (p = 1), B (q, q), both float32; perm and inv_perm int64 (p*q,),
// both or neither; scale float32 (p*q,) or None.  transpose = False gives
// y = (A kron B) (x / scale)[perm], transpose = True gives
// y[perm] = (A^T kron B^T) x, reading the factors as stored.  The stream is
// PyTorch's current one, and a failed launch raises.
#include <ATen/ATen.h>
#include <ATen/cuda/CUDAContext.h>
#include <c10/cuda/CUDAGuard.h>
#include <torch/library.h>

#include "kron_mul.h"

namespace {

// a (n,) operand on x's device, of type ``dtype``, contiguous
const at::Tensor& vector_arg(const at::Tensor& t, const at::Tensor& x,
                             int64_t n, at::ScalarType dtype,
                             const char* name) {
  TORCH_CHECK(t.device() == x.device(), "kron_mul: ", name,
              " must be on x's device");
  TORCH_CHECK(t.scalar_type() == dtype && t.dim() == 1 && t.size(0) == n &&
                  t.is_contiguous(),
              "kron_mul: ", name, " must be a contiguous (", n, ",) ",
              dtype == at::kLong ? "int64" : "float32", " tensor");
  return t;
}

at::Tensor kron_mul(const at::Tensor& x, const c10::optional<at::Tensor>& A,
                    const at::Tensor& B,
                    const c10::optional<at::Tensor>& perm,
                    const c10::optional<at::Tensor>& inv_perm,
                    const c10::optional<at::Tensor>& scale, bool transpose) {
  TORCH_CHECK(x.is_cuda() && x.dim() == 2,
              "kron_mul: x must be a (N, p*q) CUDA tensor");
  TORCH_CHECK(B.device() == x.device() && (!A || A->device() == x.device()),
              "kron_mul: x, A and B must be on one CUDA device");
  TORCH_CHECK(x.scalar_type() == at::kFloat && B.scalar_type() == at::kFloat &&
                  (!A || A->scalar_type() == at::kFloat),
              "kron_mul: x, A and B must be float32");
  TORCH_CHECK(B.dim() == 2 && B.size(0) == B.size(1) &&
                  (!A || (A->dim() == 2 && A->size(0) == A->size(1))),
              "kron_mul: A and B must be square");
  const int64_t p = A ? A->size(0) : 1, q = B.size(0), N = x.size(0);
  const int64_t n = p * q;
  TORCH_CHECK(x.size(1) == n, "kron_mul: x feature dim ", x.size(1),
              " != p*q = ", p, "*", q);
  TORCH_CHECK(p <= repro_torch::kKronMaxP && q <= repro_torch::kKronMaxQ,
              "kron_mul: factors ", p, " x ", q, " exceed the kernel's ",
              repro_torch::kKronMaxP, " x ", repro_torch::kKronMaxQ);
  TORCH_CHECK(perm.has_value() == inv_perm.has_value(),
              "kron_mul: perm and inv_perm go together");
  TORCH_CHECK(!(transpose && scale.has_value()),
              "kron_mul: scale divides the input of the forward transform "
              "only (transpose=False)");
  const c10::cuda::CUDAGuard guard(x.device());
  // a row stride is read in place; a column stride is not
  const at::Tensor xc = x.stride(1) == 1 ? x : x.contiguous();
  const at::Tensor Ac = A ? A->contiguous() : at::Tensor();
  const at::Tensor Bc = B.contiguous();
  at::Tensor y = at::empty({N, n}, x.options());
  if (N == 0) return y;
  repro_torch::KronArgs args{};
  args.x = xc.data_ptr<float>();
  args.A = A ? Ac.data_ptr<float>() : nullptr;
  args.B = Bc.data_ptr<float>();
  if (perm) {
    args.perm = vector_arg(*perm, x, n, at::kLong, "perm").data_ptr<int64_t>();
    args.inv_perm =
        vector_arg(*inv_perm, x, n, at::kLong, "inv_perm").data_ptr<int64_t>();
  }
  if (scale)
    args.scale = vector_arg(*scale, x, n, at::kFloat, "scale").data_ptr<float>();
  args.y = y.data_ptr<float>();
  args.ldx = N > 1 ? xc.stride(0) : n;
  args.N = static_cast<int>(N);
  args.p = static_cast<int>(p);
  args.q = static_cast<int>(q);
  args.trans = transpose ? 1 : 0;
  const cudaError_t err = repro_torch::kron_mul_launch(
      args, at::cuda::getCurrentCUDAStream().stream());
  TORCH_CHECK(err == cudaSuccess, "kron_mul launch failed: ",
              cudaGetErrorString(err));
  return y;
}

}  // namespace

TORCH_LIBRARY_FRAGMENT(repro_torch, m) {
  m.def(
      "kron_mul(Tensor x, Tensor? A, Tensor B, Tensor? perm, Tensor? "
      "inv_perm, Tensor? scale, bool transpose) -> Tensor");
}

TORCH_LIBRARY_IMPL(repro_torch, CUDA, m) {
  m.impl("kron_mul", &kron_mul);
}
