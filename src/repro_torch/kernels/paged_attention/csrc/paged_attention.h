// Launch interface of paged_attention.cu.  The kernel source and its
// PyTorch binding (paged_attention_binding.cpp) both include this header,
// so the two sides are compiled against one signature.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {

enum class KVDtype : int { kFloat32 = 0, kBFloat16 = 1, kInt8 = 2 };

// The page pool one launch attends: k/v (L, P, ps, KV, hd) of `dtype`;
// ks/vs (L, P, ps, KV) fp32 scales for int8 pages, else nullptr; block
// tables bt (B, Pa) int32; prior-context lengths ctx (B,) int32.
struct PagedPool {
  KVDtype dtype;
  const void* k;
  const void* v;
  const float* ks;
  const float* vs;
  const int32_t* bt;
  const int32_t* ctx;
  int P, ps, KV, hd, Pa, layer;
};

// Query rows a decode block holds (a larger group is cut into row slices,
// one block each), the largest group size a decode launch takes, the
// largest head dim, and the context keys one decode block walks (the fixed
// split of the context).
constexpr int kDecodeRows = 8;
constexpr int kMaxDecodeGroup = 128;
constexpr int kMaxHeadDim = 256;
constexpr int kDecodeSplitKeys = 128;

// Decode operands.  q: fp32 or bf16 (q_bf16), element (b, head, d) at
// q[b*q_sb + head*q_sh + d] with head = kv*G + g.  Scratch o_part
// (splits, B*KV*G, hd), m_part / l_part (splits, B*KV*G) fp32, splits =
// ceil(Pa*ps / kDecodeSplitKeys).  Outputs, one of:
//   stats: o (B*KV*G, hd), m, l (B*KV*G) fp32, unnormalized, context only;
//   self:  out (B*KV*G, hd) of q's dtype (out_bf16), normalized over the
//          context and the token's own k_new / v_new (B, KV, hd),
//          fp32 or bf16 (new_bf16), contiguous.
struct DecodeArgs {
  const void* q;
  int q_bf16;
  long long q_sb, q_sh;
  float* o_part;
  float* m_part;
  float* l_part;
  int splits;
  float* o;
  float* m;
  float* l;
  const void* k_new;
  const void* v_new;
  int new_bf16;
  void* out;
  int out_bf16;
  int B, G;
  // row slices of each group (ceil(G / kDecodeRows)) and the rows of a
  // slice (ceil(G / g_slices)); set by paged_decode_launch
  int g_slices, g_rows;
};

// Decode: two launches (the split kernel, then the merge of the splits,
// which in self mode also folds the token's own K/V in and normalizes).
cudaError_t paged_decode_launch(const PagedPool& pool, const DecodeArgs& args,
                                bool self, cudaStream_t stream);

// Chunked-prefill operands.  q: fp32 or bf16, element (b, kv, g, c, d) at
// q[b*q_sb + kv*q_skv + g*q_sg + c*q_sc + d]; k_chunk / v_chunk and the
// optional k_self / v_self (B, C, KV, hd) contiguous, all fp32 or all bf16
// (c_bf16); out, fp32 or bf16 (o_bf16), element (b, kv, g, c, d) at
// out[b*o_sb + kv*o_skv + g*o_sg + c*o_sc + d].  Normalized.
struct PrefillArgs {
  const void* q;
  int q_bf16;
  long long q_sb, q_skv, q_sg, q_sc;
  const void* kc;
  const void* vc;
  const void* kself;
  const void* vself;
  int c_bf16;
  void* out;
  int o_bf16;
  long long o_sb, o_skv, o_sg, o_sc;
  int B, G, C;
};

cudaError_t paged_prefill_launch(const PagedPool& pool,
                                 const PrefillArgs& args,
                                 cudaStream_t stream);

}  // namespace repro_torch
