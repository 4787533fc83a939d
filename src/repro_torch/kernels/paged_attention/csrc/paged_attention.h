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

// Query rows a decode block holds, the largest head dim, and the fewest
// context keys worth a decode split of their own.
constexpr int kMaxDecodeGroup = 8;
constexpr int kMaxHeadDim = 256;
constexpr int kMinSplitKeys = 64;

// Decode: q (B, KV, G, hd) fp32 -> unnormalized o (B, KV, G, hd) and
// running max m / normalizer l (B, KV, G), fp32.  The attended keys
// (Pa * ps) are cut into `splits` spans walked by blocks of their own;
// splits > 1 needs scratch o_part (splits, B, KV, G, hd) and m_part /
// l_part (splits, B, KV, G) fp32.
cudaError_t paged_decode_launch(const PagedPool& pool, const float* q,
                                float* o, float* m, float* l, float* o_part,
                                float* m_part, float* l_part, int splits,
                                int B, int G, cudaStream_t stream);

// Chunked prefill: q (B, KV, G*C, hd) fp32 (rows G-major, chunk position
// minor); kc/vc and optional kself/vself (B, C, KV, hd) fp32 -> normalized
// o (B, KV, G*C, hd) fp32.
cudaError_t paged_prefill_launch(const PagedPool& pool, const float* q,
                                 const float* kc, const float* vc,
                                 const float* kself, const float* vself,
                                 float* o, int B, int G, int C,
                                 cudaStream_t stream);

}  // namespace repro_torch
