// GQA attention directly against the paged KV pool, for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of
// repro/kernels/paged_attention/kernel.py:
//   * paged_decode_kernel  <- paged_attention_kernel (_pa_kernel,
//     _online_update): one query token per lane; returns the unnormalized
//     online-softmax state (o, m, l) over the lane's context pages, and
//     the wrapper folds the token's own K/V in;
//   * paged_prefill_kernel <- paged_prefill_kernel (_prefill_kernel): a
//     chunk of C tokens per lane attends its ragged paged prior context,
//     then the chunk itself causally (optional k_self/v_self diagonal
//     override); returns the normalized output.
//
// Layouts: pool (L, P, ps, KV, hd) fp32/bf16/int8, scales (L, P, ps, KV)
// fp32 for int8 pages, block tables (B, Pa) int32, ctx (B,) int32.  Query
// rows are G-major / chunk-position-minor (row r = g*C + c), as on the TPU.
//
// What bounds it: each block streams its lane's context K/V once (hd
// values per token and head), so it is bound by the bytes of the pool it
// attends.  Design: one block per (row tile, kv head, lane) -- for decode,
// per (kv head, lane, context split), the splits' states merged by a
// second kernel, so that a few lanes still fill the card.  Keys are
// walked in tiles of KT positions; position j lives in page bt[j / ps] at
// offset j % ps, so only the lane's valid positions (j < ctx) are ever
// read — the CUDA counterpart of the TPU kernel's clamp to the last valid
// page.  A tile's K and V are dequantized into shared memory (int8 * per-
// (token, head) scale), scores are one (row, key) pair per thread, and the
// PV product keeps the output rows in registers, one head dimension per
// thread.  All softmax statistics are fp32.  A masked score is exactly
// finfo(float32).min and contributes a probability of exactly 0 (the trap
// exp(NEG - NEG) = 1 is never evaluated for a masked key), so an empty lane
// returns m = NEG, l = 0, o = 0, as the TPU kernel does.
#include "paged_attention.h"

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

using Pool = repro_torch::PagedPool;

constexpr float NEG = -3.402823466e+38f;  // finfo(float32).min
constexpr int THREADS = 128;
constexpr int KT = 16;       // keys per tile
constexpr int MAX_DPT = 2;   // head dims per thread
constexpr int DECODE_RT = repro_torch::kMaxDecodeGroup;  // rows per block
static_assert(MAX_DPT * THREADS == repro_torch::kMaxHeadDim,
              "head dims per block");
constexpr int PREFILL_RT = 16;  // query rows per prefill block

__device__ __forceinline__ float ld(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ float ld(const int8_t* p, size_t i) {
  return static_cast<float>(p[i]);
}

// shared-memory layout (floats): q_s[RT][hd+1] k_s[KT][hd+1] v_s[KT][hd]
// p_s[RT][KT] m_s[RT] l_s[RT] a_s[RT] d_s[RT]
__host__ __device__ inline size_t smem_floats(int RT, int hd) {
  return (size_t)RT * (hd + 1) + (size_t)KT * (hd + 1) + (size_t)KT * hd +
         (size_t)RT * KT + 4 * (size_t)RT;
}

// K/V of context positions key0 .. key0+KT-1 (those < n_keys) of lane b,
// kv head h -> k_s (KT, hd+1) and v_s (KT, hd) in fp32, int8 pages times
// their per-(token, head) scale; dead keys read as zero.  Each key's page
// is looked up once per tile; then every thread issues all of its loads
// before it converts and stores any (16-byte vectors when a token's row
// allows it), so a tile costs about one memory latency.
template <typename KVT>
__device__ void load_ctx_tile(const Pool& pl, int b, int h, int key0,
                              int n_keys, float* k_s, float* v_s) {
  __shared__ long long row_s[KT];  // element offset of key t's row, or -1
  __shared__ float ksc_s[KT], vsc_s[KT];
  const int hd = pl.hd;
  if (threadIdx.x < KT) {
    const int t = threadIdx.x, j = key0 + t;
    long long row = -1;
    float ksc = 1.f, vsc = 1.f;
    if (j < n_keys) {
      const int page = pl.bt[(size_t)b * pl.Pa + j / pl.ps];
      const long long tok =
          (((long long)pl.layer * pl.P + page) * pl.ps + j % pl.ps) * pl.KV +
          h;
      row = tok * hd;
      if (pl.ks != nullptr) {
        ksc = pl.ks[tok];
        vsc = pl.vs[tok];
      }
    }
    row_s[t] = row;
    ksc_s[t] = ksc;
    vsc_s[t] = vsc;
  }
  __syncthreads();
  const KVT* kp = static_cast<const KVT*>(pl.k);
  const KVT* vp = static_cast<const KVT*>(pl.v);
  constexpr int EPV = 16 / sizeof(KVT);  // elements per 16-byte vector
  const bool vec =
      (hd % EPV == 0) &&
      ((reinterpret_cast<uintptr_t>(kp) | reinterpret_cast<uintptr_t>(vp)) %
           16 == 0);
  if (vec) {
    constexpr int MAXV = KT * repro_torch::kMaxHeadDim / EPV / THREADS;
    const int vpr = hd / EPV;  // vectors per row
    uint4 kq[MAXV], vq[MAXV];
#pragma unroll
    for (int i = 0; i < MAXV; ++i) {
      const int vi = threadIdx.x + i * THREADS;
      kq[i] = vq[i] = make_uint4(0u, 0u, 0u, 0u);
      if (vi < KT * vpr) {
        const int t = vi / vpr, c = vi - t * vpr;
        const long long row = row_s[t];
        if (row >= 0) {
          kq[i] = *reinterpret_cast<const uint4*>(kp + row + c * EPV);
          vq[i] = *reinterpret_cast<const uint4*>(vp + row + c * EPV);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < MAXV; ++i) {
      const int vi = threadIdx.x + i * THREADS;
      if (vi < KT * vpr) {
        const int t = vi / vpr, c = vi - t * vpr;
        const KVT* ke = reinterpret_cast<const KVT*>(&kq[i]);
        const KVT* ve = reinterpret_cast<const KVT*>(&vq[i]);
#pragma unroll
        for (int e = 0; e < EPV; ++e) {
          k_s[t * (hd + 1) + c * EPV + e] = ld(ke, e) * ksc_s[t];
          v_s[t * hd + c * EPV + e] = ld(ve, e) * vsc_s[t];
        }
      }
    }
  } else {
    for (int idx = threadIdx.x; idx < KT * hd; idx += THREADS) {
      const int t = idx / hd, d = idx - t * hd;
      const long long row = row_s[t];
      k_s[t * (hd + 1) + d] = row >= 0 ? ld(kp, row + d) * ksc_s[t] : 0.f;
      v_s[t * hd + d] = row >= 0 ? ld(vp, row + d) * vsc_s[t] : 0.f;
    }
  }
}

// one online-softmax step over a tile of KT keys for RT query rows.
// chunk == 0: context keys, valid iff key0 + t < n_keys (all rows alike);
// chunk > 0: the chunk's own keys, valid iff key0 + t <= c_r (the row's
// chunk position) — with d_s (self scores) the diagonal score comes from
// d_s and its value from vself.
template <int RT>
__device__ void attend_tile(const float* q_s, const float* k_s,
                            const float* v_s, float* p_s, float* m_s,
                            float* l_s, float* a_s, const float* d_s,
                            int hd, int n_rows, int row0, int key0,
                            int n_keys, int chunk, const float* vself,
                            size_t vself_row_stride, float scale,
                            float (&o)[RT][MAX_DPT]) {
  const int tid = threadIdx.x;
  for (int pr = tid; pr < RT * KT; pr += THREADS) {
    const int r = pr / KT, t = pr - r * KT;
    const int j = key0 + t;
    const int cr = chunk ? (row0 + r) % chunk : 0;
    const bool valid =
        r < n_rows && (chunk ? (j < chunk && j <= cr) : (j < n_keys));
    float s = NEG;
    if (valid) {
      if (chunk && d_s != nullptr && j == cr) {
        s = d_s[r];
      } else {
        float acc = 0.f;
        const float* qr = q_s + r * (hd + 1);
        const float* kr = k_s + t * (hd + 1);
        for (int d = 0; d < hd; ++d) acc = fmaf(qr[d], kr[d], acc);
        s = acc * scale;
      }
    }
    p_s[r * KT + t] = s;
  }
  __syncthreads();
  if (tid < RT) {
    const int r = tid;
    const float m_prev = m_s[r];
    float m_new = m_prev;
    for (int t = 0; t < KT; ++t) m_new = fmaxf(m_new, p_s[r * KT + t]);
    const float alpha = expf(m_prev - m_new);
    float sum = 0.f;
    for (int t = 0; t < KT; ++t) {
      const float s = p_s[r * KT + t];
      const float p = (s == NEG) ? 0.f : expf(s - m_new);  // masked: 0
      p_s[r * KT + t] = p;
      sum += p;
    }
    l_s[r] = alpha * l_s[r] + sum;
    m_s[r] = m_new;
    a_s[r] = alpha;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < MAX_DPT; ++i) {
    const int d = tid + i * THREADS;
    if (d >= hd) continue;
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      float acc = o[r][i] * a_s[r];
      for (int t = 0; t < KT; ++t)
        acc = fmaf(p_s[r * KT + t], v_s[t * hd + d], acc);
      if (chunk && vself != nullptr && r < n_rows) {
        // the diagonal's value contribution swaps to the override
        const int cr = (row0 + r) % chunk;
        const int t = cr - key0;
        if (t >= 0 && t < KT)
          acc = fmaf(p_s[r * KT + t],
                     vself[(size_t)cr * vself_row_stride + d] - v_s[t * hd + d],
                     acc);
      }
      o[r][i] = acc;
    }
  }
  __syncthreads();
}

template <int RT>
__device__ void init_state(float* m_s, float* l_s, float (&o)[RT][MAX_DPT]) {
  if (threadIdx.x < RT) {
    m_s[threadIdx.x] = NEG;
    l_s[threadIdx.x] = 0.f;
  }
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int i = 0; i < MAX_DPT; ++i) o[r][i] = 0.f;
}

// q rows row0 .. row0+RT-1 of (b, h) from q (B, KV, R, hd) fp32 -> q_s
template <int RT>
__device__ void load_q(const float* q, int b, int h, int KV, int R, int hd,
                       int row0, float* q_s) {
  const float* qb = q + ((size_t)b * KV + h) * R * hd;
  for (int idx = threadIdx.x; idx < RT * hd; idx += THREADS) {
    const int r = idx / hd, d = idx - r * hd;
    q_s[r * (hd + 1) + d] =
        (row0 + r < R) ? qb[(size_t)(row0 + r) * hd + d] : 0.f;
  }
}

// One block per (kv head, lane, context split): the online-softmax state
// of the G query rows over keys [split * span, min(ctx, (split+1) * span)),
// written to (o, m, l)[split].  A split with no keys writes the empty
// state m = NEG, l = 0, o = 0.
template <typename KVT>
__global__ void __launch_bounds__(THREADS)
paged_decode_kernel(Pool pl, const float* __restrict__ q,
                    float* __restrict__ o_out, float* __restrict__ m_out,
                    float* __restrict__ l_out, int G, int span) {
  extern __shared__ float smem[];
  constexpr int RT = DECODE_RT;
  const int hd = pl.hd, h = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  float* q_s = smem;
  float* k_s = q_s + RT * (hd + 1);
  float* v_s = k_s + KT * (hd + 1);
  float* p_s = v_s + KT * hd;
  float* m_s = p_s + RT * KT;
  float* l_s = m_s + RT;
  float* a_s = l_s + RT;

  float o[RT][MAX_DPT];
  init_state<RT>(m_s, l_s, o);
  load_q<RT>(q, b, h, pl.KV, G, hd, 0, q_s);
  const int n_ctx = min(pl.ctx[b], pl.Pa * pl.ps);
  const int k_begin = split * span;
  const int k_end = min(n_ctx, k_begin + span);
  const float scale = 1.0f / sqrtf(static_cast<float>(hd));
  __syncthreads();
  for (int key0 = k_begin; key0 < k_end; key0 += KT) {
    load_ctx_tile<KVT>(pl, b, h, key0, k_end, k_s, v_s);
    __syncthreads();
    attend_tile<RT>(q_s, k_s, v_s, p_s, m_s, l_s, a_s, nullptr, hd, G, 0,
                    key0, k_end, 0, nullptr, 0, scale, o);
  }
  const size_t base = (((size_t)split * gridDim.y + b) * pl.KV + h) * G;
#pragma unroll
  for (int i = 0; i < MAX_DPT; ++i) {
    const int d = threadIdx.x + i * THREADS;
    if (d >= hd) continue;
#pragma unroll
    for (int r = 0; r < RT; ++r)
      if (r < G) o_out[(base + r) * hd + d] = o[r][i];
  }
  if (threadIdx.x < G) {
    m_out[base + threadIdx.x] = m_s[threadIdx.x];
    l_out[base + threadIdx.x] = l_s[threadIdx.x];
  }
}

// Merge the per-split states of each query row (one block per row):
// m = max_s m_s, l = sum_s l_s e^{m_s - m}, o = sum_s o_s e^{m_s - m}.  A
// split with m_s = NEG weighs exactly 0, so a lane with no keys at all
// comes out as m = NEG, l = 0, o = 0.
__global__ void __launch_bounds__(THREADS)
merge_splits_kernel(const float* __restrict__ o_part,
                    const float* __restrict__ m_part,
                    const float* __restrict__ l_part, float* __restrict__ o,
                    float* __restrict__ m, float* __restrict__ l, int splits,
                    int rows, int hd) {
  const int r = blockIdx.x;
  float mx = NEG;
  for (int s = 0; s < splits; ++s)
    mx = fmaxf(mx, m_part[(size_t)s * rows + r]);
  float lsum = 0.f;
  float acc[MAX_DPT];
#pragma unroll
  for (int i = 0; i < MAX_DPT; ++i) acc[i] = 0.f;
  for (int s = 0; s < splits; ++s) {
    const size_t sr = (size_t)s * rows + r;
    const float ms = m_part[sr];
    const float w = (ms == NEG) ? 0.f : expf(ms - mx);
    lsum = fmaf(w, l_part[sr], lsum);
#pragma unroll
    for (int i = 0; i < MAX_DPT; ++i) {
      const int d = threadIdx.x + i * THREADS;
      if (d < hd) acc[i] = fmaf(w, o_part[sr * hd + d], acc[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < MAX_DPT; ++i) {
    const int d = threadIdx.x + i * THREADS;
    if (d < hd) o[(size_t)r * hd + d] = acc[i];
  }
  if (threadIdx.x == 0) {
    m[r] = mx;
    l[r] = lsum;
  }
}

template <typename KVT>
__global__ void __launch_bounds__(THREADS)
paged_prefill_kernel(Pool pl, const float* __restrict__ q,
                     const float* __restrict__ kc,
                     const float* __restrict__ vc,
                     const float* __restrict__ kself,
                     const float* __restrict__ vself,
                     float* __restrict__ o_out, int G, int C) {
  extern __shared__ float smem[];
  constexpr int RT = PREFILL_RT;
  const int hd = pl.hd, KV = pl.KV;
  const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int R = G * C, row0 = tile * RT;
  const int n_rows = min(RT, R - row0);
  float* q_s = smem;
  float* k_s = q_s + RT * (hd + 1);
  float* v_s = k_s + KT * (hd + 1);
  float* p_s = v_s + KT * hd;
  float* m_s = p_s + RT * KT;
  float* l_s = m_s + RT;
  float* a_s = l_s + RT;
  float* d_s = a_s + RT;

  float o[RT][MAX_DPT];
  init_state<RT>(m_s, l_s, o);
  load_q<RT>(q, b, h, KV, R, hd, row0, q_s);
  const int n_keys = min(pl.ctx[b], pl.Pa * pl.ps);
  const float scale = 1.0f / sqrtf(static_cast<float>(hd));
  const size_t row_stride = (size_t)KV * hd;  // (B, C, KV, hd) chunk rows
  const size_t lane = (size_t)b * C * row_stride + (size_t)h * hd;
  __syncthreads();
  if (kself != nullptr && threadIdx.x < n_rows) {
    // diagonal override: each row's score to itself comes from k_self
    const int r = threadIdx.x, cr = (row0 + r) % C;
    const float* kr = kself + lane + (size_t)cr * row_stride;
    float acc = 0.f;
    for (int d = 0; d < hd; ++d) acc = fmaf(q_s[r * (hd + 1) + d], kr[d], acc);
    d_s[r] = acc * scale;
  }
  // the paged prior context: identical to the decode walk
  for (int key0 = 0; key0 < n_keys; key0 += KT) {
    load_ctx_tile<KVT>(pl, b, h, key0, n_keys, k_s, v_s);
    __syncthreads();
    attend_tile<RT>(q_s, k_s, v_s, p_s, m_s, l_s, a_s, nullptr, hd, n_rows,
                    row0, key0, n_keys, 0, nullptr, 0, scale, o);
  }
  // the chunk itself, causally; keys past the tile's last row position
  // are masked for every row of the tile, so stop there
  int max_c = 0;
  for (int r = 0; r < n_rows; ++r) max_c = max(max_c, (row0 + r) % C);
  for (int key0 = 0; key0 <= max_c; key0 += KT) {
    for (int idx = threadIdx.x; idx < KT * hd; idx += THREADS) {
      const int t = idx / hd, d = idx - t * hd;
      const int j = key0 + t;
      const bool in = j < C;
      const size_t off = lane + (size_t)j * row_stride + d;
      k_s[t * (hd + 1) + d] = in ? kc[off] : 0.f;
      v_s[t * hd + d] = in ? vc[off] : 0.f;
    }
    __syncthreads();
    attend_tile<RT>(q_s, k_s, v_s, p_s, m_s, l_s, a_s,
                    kself != nullptr ? d_s : nullptr, hd, n_rows, row0, key0,
                    n_keys, C, vself != nullptr ? vself + lane : nullptr,
                    row_stride, scale, o);
  }
  // normalize (every valid row has at least its own column)
  const size_t base = ((size_t)b * KV + h) * R;
#pragma unroll
  for (int i = 0; i < MAX_DPT; ++i) {
    const int d = threadIdx.x + i * THREADS;
    if (d >= hd) continue;
#pragma unroll
    for (int r = 0; r < RT; ++r)
      if (r < n_rows) o_out[(base + row0 + r) * hd + d] = o[r][i] / l_s[r];
  }
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename KVT>
cudaError_t decode_t(const Pool& pl, const float* q, float* o, float* m,
                     float* l, float* o_part, float* m_part, float* l_part,
                     int splits, int B, int G, cudaStream_t s) {
  const size_t bytes = smem_floats(DECODE_RT, pl.hd) * sizeof(float);
  cudaError_t err = set_smem(paged_decode_kernel<KVT>, bytes);
  if (err != cudaSuccess) return err;
  const int keys = pl.Pa * pl.ps;
  const int span = ((keys + splits - 1) / splits + KT - 1) / KT * KT;
  dim3 grid(pl.KV, B, splits);
  if (splits == 1) {
    paged_decode_kernel<KVT><<<grid, THREADS, bytes, s>>>(pl, q, o, m, l, G,
                                                          span);
    return cudaGetLastError();
  }
  paged_decode_kernel<KVT><<<grid, THREADS, bytes, s>>>(
      pl, q, o_part, m_part, l_part, G, span);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int rows = B * pl.KV * G;
  merge_splits_kernel<<<rows, THREADS, 0, s>>>(o_part, m_part, l_part, o, m,
                                               l, splits, rows, pl.hd);
  return cudaGetLastError();
}

template <typename KVT>
cudaError_t prefill_t(const Pool& pl, const float* q, const float* kc,
                      const float* vc, const float* kself,
                      const float* vself, float* o, int B, int G, int C,
                      cudaStream_t s) {
  const size_t bytes = smem_floats(PREFILL_RT, pl.hd) * sizeof(float);
  cudaError_t err = set_smem(paged_prefill_kernel<KVT>, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((G * C + PREFILL_RT - 1) / PREFILL_RT, pl.KV, B);
  paged_prefill_kernel<KVT><<<grid, THREADS, bytes, s>>>(
      pl, q, kc, vc, kself, vself, o, G, C);
  return cudaGetLastError();
}

}  // namespace

namespace repro_torch {

cudaError_t paged_decode_launch(const PagedPool& pool, const float* q,
                                float* o, float* m, float* l, float* o_part,
                                float* m_part, float* l_part, int splits,
                                int B, int G, cudaStream_t stream) {
  if (G > DECODE_RT || pool.hd > kMaxHeadDim || splits < 1 ||
      (splits > 1 && (o_part == nullptr || m_part == nullptr ||
                      l_part == nullptr)))
    return cudaErrorInvalidValue;
  switch (pool.dtype) {
    case KVDtype::kFloat32:
      return decode_t<float>(pool, q, o, m, l, o_part, m_part, l_part,
                             splits, B, G, stream);
    case KVDtype::kBFloat16:
      return decode_t<__nv_bfloat16>(pool, q, o, m, l, o_part, m_part,
                                     l_part, splits, B, G, stream);
    case KVDtype::kInt8:
      return decode_t<int8_t>(pool, q, o, m, l, o_part, m_part, l_part,
                              splits, B, G, stream);
  }
  return cudaErrorInvalidValue;
}

cudaError_t paged_prefill_launch(const PagedPool& pool, const float* q,
                                 const float* kc, const float* vc,
                                 const float* kself, const float* vself,
                                 float* o, int B, int G, int C,
                                 cudaStream_t stream) {
  if (pool.hd > kMaxHeadDim) return cudaErrorInvalidValue;
  switch (pool.dtype) {
    case KVDtype::kFloat32:
      return prefill_t<float>(pool, q, kc, vc, kself, vself, o, B, G, C,
                              stream);
    case KVDtype::kBFloat16:
      return prefill_t<__nv_bfloat16>(pool, q, kc, vc, kself, vself, o, B,
                                      G, C, stream);
    case KVDtype::kInt8:
      return prefill_t<int8_t>(pool, q, kc, vc, kself, vself, o, B, G, C,
                               stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace repro_torch
