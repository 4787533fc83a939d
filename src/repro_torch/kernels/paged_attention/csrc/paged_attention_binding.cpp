// PyTorch binding of paged_attention.cu: the operators
//
//   torch.ops.repro_torch.paged_decode(q, k_pages, v_pages, k_scale,
//       v_scale, block_tables, ctx_len, layer) -> (o, m, l)
//   torch.ops.repro_torch.paged_decode_self(q, k_new, v_new, k_pages,
//       v_pages, k_scale, v_scale, block_tables, ctx_len, layer) -> out
//   torch.ops.repro_torch.paged_prefill(q, k_chunk, v_chunk, k_pages,
//       v_pages, k_scale, v_scale, k_self, v_self, block_tables, ctx_len,
//       layer) -> o
//   torch.ops.repro_torch.paged_prefill_bchd(<the same operands>) -> out
//
// registered for CUDA tensors only.  paged_decode takes grouped queries
// (B, KV, G, hd) and returns the fp32 online-softmax state; paged_decode_self
// takes the adapter's (B, H, hd) queries and the token's own (B, KV, hd)
// K/V and returns (B, H, hd) in q's dtype.  paged_prefill takes grouped
// chunk queries (B, KV, G, C, hd), any strides, and returns fp32 in that
// layout; paged_prefill_bchd takes and returns the adapter's (B, C, H, hd)
// in q's dtype.  fp32 and bf16 queries, chunks and outputs are read and
// written in place; any other float dtype goes through an fp32 copy.
// Shapes come from the tensors (the named-dimension checks stay in
// kernel.py), the stream is PyTorch's current one, and a failed launch
// raises.
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

const at::Tensor* opt(const std::optional<at::Tensor>& t) {
  return t.has_value() ? &*t : nullptr;
}

bool native(const at::Tensor& t) {
  return t.scalar_type() == at::kFloat || t.scalar_type() == at::kBFloat16;
}

// fp32 or bf16 with a unit last stride as given; anything else as an fp32
// contiguous copy
at::Tensor fp_operand(const at::Tensor& t) {
  if (native(t) && (t.dim() == 0 || t.stride(-1) == 1)) return t;
  return t.to(at::kFloat).contiguous();
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
    keep.push_back(k_scale->to(at::kFloat).contiguous());
    pool.ks = keep.back().data_ptr<float>();
    keep.push_back(v_scale->to(at::kFloat).contiguous());
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

// ---------------------------------------------------------------------------
// decode
// ---------------------------------------------------------------------------

// Launch the split kernel and the merge: `self` with the token's own K/V
// (k_new, v_new) and a (B*KV*G, hd) output `out`, else the fp32 state into
// o / m / l.  q (B, heads, hd) viewed with head = kv*G + g.
void decode(const repro_torch::PagedPool& pool, const at::Tensor& q,
            int64_t B, int64_t G, int64_t q_sb, int64_t q_sh,
            const at::Tensor* k_new, const at::Tensor* v_new,
            at::Tensor* out, at::Tensor* o, at::Tensor* m, at::Tensor* l) {
  const int64_t KV = pool.KV, hd = pool.hd;
  const int64_t splits =
      (int64_t{pool.Pa} * pool.ps + repro_torch::kDecodeSplitKeys - 1) /
      repro_torch::kDecodeSplitKeys;
  const int64_t parts = std::max<int64_t>(splits, 1);
  // o_part (parts, B*KV*G, hd), then m_part and l_part (parts, B*KV*G), in
  // one allocation
  const int64_t n = parts * B * KV * G;
  at::Tensor scratch = at::empty({n * (hd + 2)}, q.options().dtype(at::kFloat));
  repro_torch::DecodeArgs a{};
  a.q = q.data_ptr();
  a.q_bf16 = q.scalar_type() == at::kBFloat16;
  a.q_sb = q_sb;
  a.q_sh = q_sh;
  a.o_part = scratch.data_ptr<float>();
  a.m_part = a.o_part + n * hd;
  a.l_part = a.m_part + n;
  a.splits = static_cast<int>(parts);
  if (out != nullptr) {
    a.k_new = k_new->data_ptr();
    a.v_new = v_new->data_ptr();
    a.new_bf16 = k_new->scalar_type() == at::kBFloat16;
    a.out = out->data_ptr();
    a.out_bf16 = out->scalar_type() == at::kBFloat16;
  } else {
    a.o = o->data_ptr<float>();
    a.m = m->data_ptr<float>();
    a.l = l->data_ptr<float>();
  }
  a.B = static_cast<int>(B);
  a.G = static_cast<int>(G);
  const cudaError_t err = repro_torch::paged_decode_launch(
      pool, a, out != nullptr, at::cuda::getCurrentCUDAStream().stream());
  TORCH_CHECK(err == cudaSuccess, "paged_decode launch failed: ",
              cudaGetErrorString(err));
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
  at::Tensor qx = fp_operand(q);
  if (qx.stride(1) != G * qx.stride(2)) qx = qx.contiguous();
  const auto opts = q.options().dtype(at::kFloat);
  at::Tensor o = at::empty({B, KV, G, hd}, opts);
  at::Tensor m = at::empty({B, KV, G, 1}, opts);
  at::Tensor l = at::empty({B, KV, G, 1}, opts);
  if (B == 0) return {o, m, l};
  decode(pool, qx, B, G, qx.stride(0), qx.stride(2), nullptr, nullptr,
         nullptr, &o, &m, &l);
  return {o, m, l};
}

at::Tensor paged_decode_self(
    const at::Tensor& q, const at::Tensor& k_new, const at::Tensor& v_new,
    const at::Tensor& k_pages, const at::Tensor& v_pages,
    const std::optional<at::Tensor>& k_scale,
    const std::optional<at::Tensor>& v_scale,
    const at::Tensor& block_tables, const at::Tensor& ctx_len,
    int64_t layer) {
  TORCH_CHECK(q.is_cuda() && q.dim() == 3,
              "paged_decode_self: q must be a (B, H, hd) CUDA tensor");
  const c10::cuda::CUDAGuard guard(q.device());
  std::vector<at::Tensor> keep;
  const repro_torch::PagedPool pool = make_pool(
      q, k_pages, v_pages, k_scale, v_scale, block_tables, ctx_len, layer,
      keep);
  check_device(q, {&k_new, &v_new});
  const int64_t B = q.size(0), H = q.size(1), hd = q.size(2);
  const int64_t KV = pool.KV;
  TORCH_CHECK(hd == pool.hd && H % KV == 0,
              "paged_decode_self: q and the pool disagree on (KV, hd)");
  const int64_t G = H / KV;
  TORCH_CHECK(G <= repro_torch::kMaxDecodeGroup, "paged_decode_self: G=", G,
              " exceeds ", repro_torch::kMaxDecodeGroup);
  const std::vector<int64_t> own{B, KV, hd};
  TORCH_CHECK(k_new.sizes().equals(own) && v_new.sizes().equals(own),
              "paged_decode_self: k_new/v_new must be (B, KV, hd)");
  const at::Tensor qx = fp_operand(q);
  at::Tensor kn = k_new.contiguous(), vn = v_new.contiguous();
  if (!native(kn) || kn.scalar_type() != vn.scalar_type()) {
    kn = kn.to(at::kFloat);
    vn = vn.to(at::kFloat);
  }
  at::Tensor out = at::empty({B, H, hd}, native(q) ? q.options()
                                                   : q.options().dtype(at::kFloat));
  if (B == 0) return out.to(q.scalar_type());
  decode(pool, qx, B, G, qx.stride(0), qx.stride(1), &kn, &vn, &out, nullptr,
         nullptr, nullptr);
  return native(q) ? out : out.to(q.scalar_type());
}

// ---------------------------------------------------------------------------
// prefill
// ---------------------------------------------------------------------------

// q grouped (B, KV, G, C, hd) through its strides; out likewise.
void prefill(const repro_torch::PagedPool& pool, const at::Tensor& q,
             const at::Tensor& k_chunk, const at::Tensor& v_chunk,
             const std::optional<at::Tensor>& k_self,
             const std::optional<at::Tensor>& v_self, at::Tensor& out) {
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
  if (B == 0 || C == 0) return;
  // the chunk operands share one dtype, fp32 or bf16, contiguous
  std::vector<at::Tensor> cs{k_chunk, v_chunk};
  if (k_self.has_value()) {
    cs.push_back(*k_self);
    cs.push_back(*v_self);
  }
  bool same = native(k_chunk);
  for (const at::Tensor& t : cs)
    same = same && t.scalar_type() == k_chunk.scalar_type();
  for (at::Tensor& t : cs)
    t = same ? t.contiguous() : t.to(at::kFloat).contiguous();
  const at::Tensor qx = fp_operand(q);
  repro_torch::PrefillArgs a{};
  a.q = qx.data_ptr();
  a.q_bf16 = qx.scalar_type() == at::kBFloat16;
  a.q_sb = qx.stride(0);
  a.q_skv = qx.stride(1);
  a.q_sg = qx.stride(2);
  a.q_sc = qx.stride(3);
  a.kc = cs[0].data_ptr();
  a.vc = cs[1].data_ptr();
  a.kself = k_self.has_value() ? cs[2].data_ptr() : nullptr;
  a.vself = k_self.has_value() ? cs[3].data_ptr() : nullptr;
  a.c_bf16 = cs[0].scalar_type() == at::kBFloat16;
  a.out = out.data_ptr();
  a.o_bf16 = out.scalar_type() == at::kBFloat16;
  a.o_sb = out.stride(0);
  a.o_skv = out.stride(1);
  a.o_sg = out.stride(2);
  a.o_sc = out.stride(3);
  a.B = static_cast<int>(B);
  a.G = static_cast<int>(G);
  a.C = static_cast<int>(C);
  const cudaError_t err = repro_torch::paged_prefill_launch(
      pool, a, at::cuda::getCurrentCUDAStream().stream());
  TORCH_CHECK(err == cudaSuccess, "paged_prefill launch failed: ",
              cudaGetErrorString(err));
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
  at::Tensor out = at::empty(q.sizes(), q.options().dtype(at::kFloat));
  prefill(pool, q, k_chunk, v_chunk, k_self, v_self, out);
  return out;
}

at::Tensor paged_prefill_bchd(
    const at::Tensor& q, const at::Tensor& k_chunk, const at::Tensor& v_chunk,
    const at::Tensor& k_pages, const at::Tensor& v_pages,
    const std::optional<at::Tensor>& k_scale,
    const std::optional<at::Tensor>& v_scale,
    const std::optional<at::Tensor>& k_self,
    const std::optional<at::Tensor>& v_self,
    const at::Tensor& block_tables, const at::Tensor& ctx_len,
    int64_t layer) {
  TORCH_CHECK(q.is_cuda() && q.dim() == 4,
              "paged_prefill_bchd: q must be a (B, C, H, hd) CUDA tensor");
  const c10::cuda::CUDAGuard guard(q.device());
  std::vector<at::Tensor> keep;
  const repro_torch::PagedPool pool = make_pool(
      q, k_pages, v_pages, k_scale, v_scale, block_tables, ctx_len, layer,
      keep);
  const int64_t B = q.size(0), C = q.size(1), H = q.size(2), hd = q.size(3);
  const int64_t KV = pool.KV;
  TORCH_CHECK(H % KV == 0,
              "paged_prefill_bchd: n_heads must be a multiple of the pool's "
              "KV heads");
  const int64_t G = H / KV;
  at::Tensor out = at::empty({B, C, H, hd}, native(q) ? q.options()
                                         : q.options().dtype(at::kFloat));
  // both as (B, KV, G, C, hd) views of the (B, C, H, hd) layout
  const auto grouped = [&](const at::Tensor& t) {
    return t.view({B, C, KV, G, hd}).permute({0, 2, 3, 1, 4});
  };
  const at::Tensor qx = fp_operand(q);
  at::Tensor og = grouped(out);
  prefill(pool, grouped(qx.contiguous()), k_chunk, v_chunk, k_self, v_self,
          og);
  return native(q) ? out : out.to(q.scalar_type());
}

}  // namespace

TORCH_LIBRARY_FRAGMENT(repro_torch, m) {
  m.def(
      "paged_decode(Tensor q, Tensor k_pages, Tensor v_pages, "
      "Tensor? k_scale, Tensor? v_scale, Tensor block_tables, "
      "Tensor ctx_len, int layer) -> (Tensor, Tensor, Tensor)");
  m.def(
      "paged_decode_self(Tensor q, Tensor k_new, Tensor v_new, "
      "Tensor k_pages, Tensor v_pages, Tensor? k_scale, Tensor? v_scale, "
      "Tensor block_tables, Tensor ctx_len, int layer) -> Tensor");
  m.def(
      "paged_prefill(Tensor q, Tensor k_chunk, Tensor v_chunk, "
      "Tensor k_pages, Tensor v_pages, Tensor? k_scale, Tensor? v_scale, "
      "Tensor? k_self, Tensor? v_self, Tensor block_tables, "
      "Tensor ctx_len, int layer) -> Tensor");
  m.def(
      "paged_prefill_bchd(Tensor q, Tensor k_chunk, Tensor v_chunk, "
      "Tensor k_pages, Tensor v_pages, Tensor? k_scale, Tensor? v_scale, "
      "Tensor? k_self, Tensor? v_self, Tensor block_tables, "
      "Tensor ctx_len, int layer) -> Tensor");
}

TORCH_LIBRARY_IMPL(repro_torch, CUDA, m) {
  m.impl("paged_decode", &paged_decode);
  m.impl("paged_decode_self", &paged_decode_self);
  m.impl("paged_prefill", &paged_prefill);
  m.impl("paged_prefill_bchd", &paged_prefill_bchd);
}
