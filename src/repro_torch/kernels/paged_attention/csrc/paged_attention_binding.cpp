// PyTorch binding of paged_attention.cu: the operators
//
//   torch.ops.repro_torch.paged_decode(q, k_pages, v_pages, k_scale,
//       v_scale, block_tables, ctx_len, layer) -> (o, m, l)
//   torch.ops.repro_torch.paged_prefill(q, k_chunk, v_chunk, k_pages,
//       v_pages, k_scale, v_scale, k_self, v_self, block_tables, ctx_len,
//       layer) -> o
//
// registered for CUDA tensors only.  Shapes come from the tensors (the
// named-dimension checks stay in kernel.py), the stream is PyTorch's
// current one, and a failed launch raises.
#include <ATen/ATen.h>
#include <ATen/cuda/CUDAContext.h>
#include <c10/cuda/CUDAGuard.h>
#include <torch/library.h>

#include <algorithm>
#include <initializer_list>
#include <optional>
#include <tuple>
#include <vector>

#include "paged_attention.h"

namespace {

using repro_torch::KVDtype;

at::Tensor f32(const at::Tensor& t) {
  return t.to(at::kFloat).contiguous();
}

std::optional<at::Tensor> f32(const std::optional<at::Tensor>& t) {
  if (!t.has_value()) return std::nullopt;
  return f32(*t);
}

const float* ptr(const std::optional<at::Tensor>& t) {
  return t.has_value() ? t->data_ptr<float>() : nullptr;
}

const at::Tensor* opt(const std::optional<at::Tensor>& t) {
  return t.has_value() ? &*t : nullptr;
}

// Every operand given (non-null) lies on q's device.
void check_device(const at::Tensor& q,
                  std::initializer_list<const at::Tensor*> operands) {
  for (const at::Tensor* t : operands)
    TORCH_CHECK(t == nullptr || t->device() == q.device(),
                "paged attention: every operand must be on q's device ",
                q.device());
}

// The pool operands as the launch interface takes them; `keep` holds the
// converted tensors alive until the launch is enqueued.
repro_torch::PagedPool make_pool(const at::Tensor& q,
                                 const at::Tensor& k_pages,
                                 const at::Tensor& v_pages,
                                 const std::optional<at::Tensor>& k_scale,
                                 const std::optional<at::Tensor>& v_scale,
                                 const at::Tensor& block_tables,
                                 const at::Tensor& ctx_len, int64_t layer,
                                 std::vector<at::Tensor>& keep) {
  check_device(q, {&k_pages, &v_pages, &block_tables, &ctx_len, opt(k_scale),
                   opt(v_scale)});
  TORCH_CHECK(k_pages.dim() == 5 &&
                  v_pages.sizes().equals(k_pages.sizes()) &&
                  v_pages.scalar_type() == k_pages.scalar_type(),
              "paged attention: k/v pages must be (L, P, ps, KV, hd) alike");
  TORCH_CHECK(k_pages.is_contiguous() && v_pages.is_contiguous(),
              "paged attention: k/v pages must be contiguous");
  repro_torch::PagedPool pool{};
  switch (k_pages.scalar_type()) {
    case at::kFloat: pool.dtype = KVDtype::kFloat32; break;
    case at::kBFloat16: pool.dtype = KVDtype::kBFloat16; break;
    case at::kChar: pool.dtype = KVDtype::kInt8; break;
    default: TORCH_CHECK(false, "paged attention: unsupported page dtype ",
                         k_pages.scalar_type());
  }
  const bool int8 = pool.dtype == KVDtype::kInt8;
  TORCH_CHECK(int8 == (k_scale.has_value() && v_scale.has_value()),
              "paged attention: int8 pages take k_scale and v_scale, fp "
              "pages none");
  pool.k = k_pages.data_ptr();
  pool.v = v_pages.data_ptr();
  if (int8) {
    keep.push_back(f32(*k_scale));
    pool.ks = keep.back().data_ptr<float>();
    keep.push_back(f32(*v_scale));
    pool.vs = keep.back().data_ptr<float>();
  }
  keep.push_back(block_tables.to(at::kInt).contiguous());
  pool.bt = keep.back().data_ptr<int32_t>();
  keep.push_back(ctx_len.to(at::kInt).contiguous());
  pool.ctx = keep.back().data_ptr<int32_t>();
  pool.P = static_cast<int>(k_pages.size(1));
  pool.ps = static_cast<int>(k_pages.size(2));
  pool.KV = static_cast<int>(k_pages.size(3));
  pool.hd = static_cast<int>(k_pages.size(4));
  pool.Pa = static_cast<int>(block_tables.size(1));
  pool.layer = static_cast<int>(layer);
  TORCH_CHECK(0 <= layer && layer < k_pages.size(0),
              "paged attention: layer ", layer, " out of range");
  TORCH_CHECK(pool.hd <= repro_torch::kMaxHeadDim,
              "paged attention: head_dim ", pool.hd, " exceeds ",
              repro_torch::kMaxHeadDim);
  return pool;
}

std::tuple<at::Tensor, at::Tensor, at::Tensor> paged_decode(
    const at::Tensor& q, const at::Tensor& k_pages,
    const at::Tensor& v_pages, const std::optional<at::Tensor>& k_scale,
    const std::optional<at::Tensor>& v_scale,
    const at::Tensor& block_tables, const at::Tensor& ctx_len,
    int64_t layer) {
  TORCH_CHECK(q.is_cuda() && q.dim() == 4,
              "paged_decode: q must be a (B, KV, G, hd) CUDA tensor");
  const c10::cuda::CUDAGuard guard(q.device());
  std::vector<at::Tensor> keep;
  const repro_torch::PagedPool pool = make_pool(
      q, k_pages, v_pages, k_scale, v_scale, block_tables, ctx_len, layer,
      keep);
  const int64_t B = q.size(0), KV = q.size(1), G = q.size(2), hd = q.size(3);
  TORCH_CHECK(KV == pool.KV && hd == pool.hd,
              "paged_decode: q and the pool disagree on (KV, hd)");
  TORCH_CHECK(G <= repro_torch::kMaxDecodeGroup, "paged_decode: G=", G,
              " exceeds ", repro_torch::kMaxDecodeGroup);
  const at::Tensor qf = f32(q);
  const auto opts = q.options().dtype(at::kFloat);
  at::Tensor o = at::empty({B, KV, G, hd}, opts);
  at::Tensor m = at::empty({B, KV, G, 1}, opts);
  at::Tensor l = at::empty({B, KV, G, 1}, opts);
  if (B == 0) return {o, m, l};
  // split the context until the blocks cover the card about twice, but
  // never below kMinSplitKeys keys per split
  const int64_t sms =
      at::cuda::getCurrentDeviceProperties()->multiProcessorCount;
  const int64_t keys = int64_t{pool.Pa} * pool.ps;
  const int64_t splits = std::max<int64_t>(
      1, std::min((2 * sms + B * KV - 1) / (B * KV),
                  keys / repro_torch::kMinSplitKeys));
  at::Tensor o_part, m_part, l_part;
  if (splits > 1) {
    o_part = at::empty({splits, B, KV, G, hd}, opts);
    m_part = at::empty({splits, B, KV, G}, opts);
    l_part = at::empty({splits, B, KV, G}, opts);
  }
  const auto part = [](const at::Tensor& t) {
    return t.defined() ? t.data_ptr<float>() : nullptr;
  };
  const cudaError_t err = repro_torch::paged_decode_launch(
      pool, qf.data_ptr<float>(), o.data_ptr<float>(), m.data_ptr<float>(),
      l.data_ptr<float>(), part(o_part), part(m_part), part(l_part),
      static_cast<int>(splits), static_cast<int>(B), static_cast<int>(G),
      at::cuda::getCurrentCUDAStream().stream());
  TORCH_CHECK(err == cudaSuccess, "paged_decode launch failed: ",
              cudaGetErrorString(err));
  return {o, m, l};
}

at::Tensor paged_prefill(
    const at::Tensor& q, const at::Tensor& k_chunk, const at::Tensor& v_chunk,
    const at::Tensor& k_pages, const at::Tensor& v_pages,
    const std::optional<at::Tensor>& k_scale,
    const std::optional<at::Tensor>& v_scale,
    const std::optional<at::Tensor>& k_self,
    const std::optional<at::Tensor>& v_self,
    const at::Tensor& block_tables, const at::Tensor& ctx_len,
    int64_t layer) {
  TORCH_CHECK(q.is_cuda() && q.dim() == 5,
              "paged_prefill: q must be a (B, KV, G, C, hd) CUDA tensor");
  const c10::cuda::CUDAGuard guard(q.device());
  std::vector<at::Tensor> keep;
  const repro_torch::PagedPool pool = make_pool(
      q, k_pages, v_pages, k_scale, v_scale, block_tables, ctx_len, layer,
      keep);
  const int64_t B = q.size(0), KV = q.size(1), G = q.size(2), C = q.size(3),
                hd = q.size(4);
  TORCH_CHECK(KV == pool.KV && hd == pool.hd,
              "paged_prefill: q and the pool disagree on (KV, hd)");
  check_device(q, {&k_chunk, &v_chunk, opt(k_self), opt(v_self)});
  const std::vector<int64_t> chunk{B, C, KV, hd};
  TORCH_CHECK(
      k_chunk.sizes().equals(chunk) && v_chunk.sizes().equals(chunk),
              "paged_prefill: k/v_chunk must be (B, C, KV, hd)");
  TORCH_CHECK(k_self.has_value() == v_self.has_value(),
              "paged_prefill: k_self and v_self go together");
  if (k_self.has_value())
    TORCH_CHECK(
        k_self->sizes().equals(chunk) && v_self->sizes().equals(chunk),
        "paged_prefill: k/v_self must be (B, C, KV, hd)");
  const at::Tensor qf = f32(q), kc = f32(k_chunk), vc = f32(v_chunk);
  const std::optional<at::Tensor> ks = f32(k_self), vs = f32(v_self);
  at::Tensor o = at::empty({B, KV, G, C, hd}, q.options().dtype(at::kFloat));
  if (B == 0 || C == 0) return o;
  const cudaError_t err = repro_torch::paged_prefill_launch(
      pool, qf.data_ptr<float>(), kc.data_ptr<float>(), vc.data_ptr<float>(),
      ptr(ks), ptr(vs), o.data_ptr<float>(), static_cast<int>(B),
      static_cast<int>(G), static_cast<int>(C),
      at::cuda::getCurrentCUDAStream().stream());
  TORCH_CHECK(err == cudaSuccess, "paged_prefill launch failed: ",
              cudaGetErrorString(err));
  return o;
}

}  // namespace

TORCH_LIBRARY_FRAGMENT(repro_torch, m) {
  m.def(
      "paged_decode(Tensor q, Tensor k_pages, Tensor v_pages, "
      "Tensor? k_scale, Tensor? v_scale, Tensor block_tables, "
      "Tensor ctx_len, int layer) -> (Tensor, Tensor, Tensor)");
  m.def(
      "paged_prefill(Tensor q, Tensor k_chunk, Tensor v_chunk, "
      "Tensor k_pages, Tensor v_pages, Tensor? k_scale, Tensor? v_scale, "
      "Tensor? k_self, Tensor? v_self, Tensor block_tables, "
      "Tensor ctx_len, int layer) -> Tensor");
}

TORCH_LIBRARY_IMPL(repro_torch, CUDA, m) {
  m.impl("paged_decode", &paged_decode);
  m.impl("paged_prefill", &paged_prefill);
}
