// GQA attention directly against the paged KV pool, for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of
// repro/kernels/paged_attention/kernel.py:
//   * paged_prefill_kernel <- paged_prefill_kernel (_prefill_kernel): a
//     chunk of C tokens per lane attends its ragged paged prior context,
//     then the chunk itself causally (optional k_self/v_self diagonal
//     override, the speculative verifier's call); normalized output;
//   * paged_decode_kernel + decode_merge_kernel <- paged_attention_kernel
//     (_pa_kernel, _online_update): one query token per lane; the
//     unnormalized online-softmax state (o, m, l) over the lane's context
//     pages, or (self mode) the normalized output with the token's own
//     K/V folded in by the merge epilogue.
//
// Layouts: pool (L, P, ps, KV, hd) fp32/bf16/int8, scales (L, P, ps, KV)
// fp32 for int8 pages, block tables (B, Pa) int32, ctx (B,) int32.  Query
// rows are G-major / chunk-position-minor (row r = g*C + c), as on the TPU;
// q and the output are read and written through strides, so the adapter's
// (B, C, H, hd) layout needs no copy.  Key position j of a lane lives in
// page bt[j / ps] at offset j % ps; only positions j < min(ctx, Pa*ps) are
// attended -- the counterpart of the TPU kernel's clamp to the lane's last
// valid page.  A masked score is exactly finfo(float32).min and weighs
// exactly 0, so an empty lane gives m = NEG, l = 0, o = 0 as on the TPU.
//
// PREFILL -- what bounds it: about 320 flops per byte of bf16 K/V per
// (lane, head) at G = 5, C = 64, far above the card's ridge, so it is
// bound by arithmetic, and fp32 CUDA cores cap it at 67 TFLOP/s.  Design:
// FlashAttention-2 on the tensor cores.  A block holds 64 query rows of one
// (lane, kv head) (4 warps x 16 rows) and walks the lane's context in
// tiles of KT keys (64 for hd <= 128: four 16-token pages).  Each tile's
// page rows are copied with 16-byte cp.async into a two-slot ring, so the
// next tile's copy overlaps this tile's products; each thread fetches the
// page number of its key a tile ahead, so no copy waits on a block-table
// load.  Q.K^T and P.V are mma.sync.m16n8k16 (bf16 in, fp32 accumulate)
// with ldmatrix / ldmatrix.trans operands from shared memory; a k-step
// loads all its fragments before its products.  The running max and sum
// stay in registers (quad shuffles, no block barrier inside the softmax),
// in log2 units so that every exponential is one exp2.  Lanes are taken
// longest context first (blockIdx.z is a rank, not a lane), so a long
// lane's blocks start first and the short ones fill in around them.
// mma.sync rather than wgmma: 16-row warp tiles keep a 64-row block
// (320 rows per lane and head here), the register-resident P of
// FlashAttention-2 needs no shared-memory round trip, and the two-term
// operand split below doubles the products anyway.
//
// Precision (the gate is 1e-4 absolute against the fp32 plain version,
// which one bf16 term per operand misses; tests/test_torch_paged_split.py
// shows both): every fp32 operand x is
// split into two bf16 terms, hi = bf16(x), lo = bf16(x - hi), so
// |x - hi - lo| <= 2^-16 |x| (two round-to-nearest steps of 2^-8 relative
// each; 2^-17 in practice).  bf16 pages are exact, int8 pages are exact in
// bf16 (|v| <= 127), so
//   Q.K^T = q_hi.K + q_lo.K             (bf16 and int8 pages)
//   P.V   = p_hi.V + p_lo.V
// and fp32 pages (and the chunk's own fp32 K/V) take three products,
// hi.hi + lo.hi + hi.lo (the dropped lo.lo term is below 2^-16 relative).
// Each product is exact in fp32 and is summed in fp32, so a score is off
// by at most about 2^-15 sum_i |q_i k_i| / sqrt(hd) and an output by
// 2^-15 sum_j p_j |v_j| / l: up to 2.3e-5 at unit-variance data in the CPU
// emulation of this scheme (ref.py, tests/test_torch_paged_split.py),
// inside the gate.  The int8 K scale multiplies the score column and the
// V scale the probability before P.V (p*vs is what is split).  The
// diagonal override takes q.k_self in fp32 CUDA-core arithmetic, and
// v_self enters as an fp32 correction p_cc (v_self - v_chunk) of the row's
// own column.
//
// DECODE -- what bounds it: about 5 flops per byte of K/V, far below the
// ridge: it is bound by the bytes of the pool it reads, so what it needs
// is bytes in flight and few instructions per byte, not arithmetic;
// tensor cores would not help.  Design: the context is cut into fixed
// splits of kDecodeSplitKeys (128) keys; grid (KV, B, ceil(Pa*ps / 128)),
// and a block whose split starts past its lane's ctx exits at once.  A
// block first reads its split's 128 token indices (one block-table load
// per thread), then copies the split in stages of 32 keys (two pages) with
// 16-byte cp.async into a three-stage ring (two stages in flight), small
// enough that three blocks share an SM.  Lane l of warp w owns 8 head dims
// (w*32 + (l%4)*8, per 128) and, of each stage, the keys p*8 + l/4: its
// slice of the G query rows sits in registers, a key's score is the sum of
// a quad (two shuffles) and of the four warps (shared memory) -- no serial
// 128-step chain and no per-key broadcast reads -- then the online softmax
// (shuffles, exp2 units), and P.V into the lane's dims over its keys; the
// eight quads' sums are combined once per split.  All fp32.  The per-row
// arrays are compiled for G in {1, 2, 4, 5, 8}.  The merge kernel combines
// the splits' (o, m, l) and, in self mode, folds the token's own (k_new,
// v_new) in and normalizes (the formula of ops.py's docstring), so one
// decode attention is two launches.
#include "paged_attention.h"

#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace {

using Pool = repro_torch::PagedPool;
using repro_torch::DecodeArgs;
using repro_torch::PrefillArgs;
using bf16 = __nv_bfloat16;

constexpr float NEG = -3.402823466e+38f;  // finfo(float32).min
constexpr int THREADS = 128;              // every kernel: 4 warps
constexpr int PREFILL_RT = 64;            // query rows per prefill block
constexpr int DEC_SPLIT = repro_torch::kDecodeSplitKeys;
constexpr int DEC_KT = 32;                // decode keys per ring stage
constexpr int DEC_MAXG = repro_torch::kDecodeRows;

// ---------------------------------------------------------------------------
// PTX helpers
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy global -> shared; an invalid source writes zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c += a (16x16 bf16, row) * b (16x8 bf16, col), fp32 accumulate
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x0, x1) -> packed bf16 pairs hi = bf16(x), lo = bf16(x - hi)
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(int8_t x) {
  return static_cast<float>(x);
}

// element i of a float or bf16 array
__device__ __forceinline__ float ld_any(const void* p, int is_bf16,
                                        long long i) {
  return is_bf16 ? __bfloat162float(static_cast<const bf16*>(p)[i])
                 : static_cast<const float*>(p)[i];
}

// element i of a T array, as float
template <typename T>
__device__ __forceinline__ float ldf(const void* p, long long i) {
  return to_f(static_cast<const T*>(p)[i]);
}

__device__ __forceinline__ void st_any(void* p, int is_bf16, long long i,
                                       float v) {
  if (is_bf16)
    static_cast<bf16*>(p)[i] = __float2bfloat16_rn(v);
  else
    static_cast<float*>(p)[i] = v;
}

template <int N>
struct RawT;
template <>
struct RawT<1> { using T = uint8_t; };
template <>
struct RawT<2> { using T = uint16_t; };
template <>
struct RawT<4> { using T = uint32_t; };

// ---------------------------------------------------------------------------
// The page walk: copy keys key0 .. key0+KT-1 of lane b, kv head h
// ---------------------------------------------------------------------------

// Token-head index of context position j in page `page`, head h (its row
// in the pool starts at element tok * hd, its scale is ks[tok]), or -1 for
// page -1.
__device__ __forceinline__ long long token_of(const Pool& pl, int page,
                                              int h, int j) {
  if (page < 0) return -1;
  return (((long long)pl.layer * pl.P + page) * pl.ps + j % pl.ps) * pl.KV +
         h;
}

// The page of context position j of lane b (a block-table load), or -1 at
// or past n_keys.
__device__ __forceinline__ int key_page(const Pool& pl, int b, int j,
                                        int n_keys) {
  return j < n_keys ? pl.bt[(size_t)b * pl.Pa + j / pl.ps] : -1;
}

__device__ __forceinline__ long long key_token(const Pool& pl, int b, int h,
                                               int j, int n_keys) {
  return token_of(pl, key_page(pl, b, j, n_keys), h, j);
}

// Issue the copies of the K and V rows of one tile of KT keys into k_dst /
// v_dst (rows of `stride` bytes) and, for int8 pages, their scales into
// ks_dst / vs_dst.  THREADS/KT threads share a key, row kk = tid / (THREADS
// / KT) of the tile; `tok` is that key's token index (key_token), fetched
// ahead by the caller so that no copy waits on a block-table load.  A key
// with tok < 0 reads as zeros.  16-byte cp.async; rows that are not 16-byte
// multiples, or an unaligned pool, are copied synchronously.
template <typename KVT, int KT>
__device__ __forceinline__ void issue_tile(const Pool& pl, long long tok,
                                           unsigned char* k_dst,
                                           unsigned char* v_dst, int stride,
                                           float* ks_dst, float* vs_dst,
                                           bool vec) {
  constexpr int TPK = THREADS / KT;
  static_assert(THREADS % KT == 0, "threads per key");
  const int kk = threadIdx.x / TPK, part = threadIdx.x % TPK;
  const bool valid = tok >= 0;
  if (!valid) tok = 0;
  const int row_bytes = pl.hd * static_cast<int>(sizeof(KVT));
  const unsigned char* kg =
      static_cast<const unsigned char*>(pl.k) + tok * row_bytes;
  const unsigned char* vg =
      static_cast<const unsigned char*>(pl.v) + tok * row_bytes;
  unsigned char* kd = k_dst + kk * stride;
  unsigned char* vd = v_dst + kk * stride;
  if (vec) {
    for (int c = part * 16; c < row_bytes; c += TPK * 16) {
      cp_async16(kd + c, kg + c, valid);
      cp_async16(vd + c, vg + c, valid);
    }
  } else {
    using R = typename RawT<sizeof(KVT)>::T;
    const R* ke = reinterpret_cast<const R*>(kg);
    const R* ve = reinterpret_cast<const R*>(vg);
    for (int e = part; e < pl.hd; e += TPK) {
      reinterpret_cast<R*>(kd)[e] = valid ? ke[e] : R(0);
      reinterpret_cast<R*>(vd)[e] = valid ? ve[e] : R(0);
    }
  }
  if (pl.ks != nullptr && part == 0) {
    cp_async4(ks_dst + kk, pl.ks + tok, valid);
    cp_async4(vs_dst + kk, pl.vs + tok, valid);
  }
}

template <typename KVT>
__device__ __forceinline__ bool vec_pool(const Pool& pl) {
  return (pl.hd * sizeof(KVT)) % 16 == 0 &&
         ((reinterpret_cast<uintptr_t>(pl.k) |
           reinterpret_cast<uintptr_t>(pl.v)) %
          16) == 0;
}

// ---------------------------------------------------------------------------
// Paged prefill: FlashAttention-2 on the tensor cores
// ---------------------------------------------------------------------------

// Tile sizes and the shared-memory layout of one prefill instantiation:
// Q hi / lo (64 rows x QS bf16), the diagonal scores, a two-slot ring of
// raw page rows (K, V, and for int8 their scales), and four bf16 work
// tiles (K hi / lo, V hi / lo) that fp32 and int8 pages are widened into
// and that the chunk's own K/V are split into.  bf16 pages feed the
// tensor cores straight from the ring, so their work tiles alias the ring
// (used only after the context walk).
template <typename KVT, int HD>
struct PrefillCfg {
  static constexpr int ELT = sizeof(KVT) < 2 ? 2 : static_cast<int>(sizeof(KVT));
  static constexpr int KT = HD * ELT <= 256 ? 64 : (HD * ELT <= 512 ? 32 : 16);
  static constexpr int QS = HD + 8;  // bf16 row stride: conflict-free ldmatrix
  static constexpr bool BF16 = std::is_same<KVT, bf16>::value;
  static constexpr bool SPLIT = std::is_same<KVT, float>::value;
  static constexpr int RSB = BF16 ? QS * 2 : HD * static_cast<int>(sizeof(KVT));
  static constexpr int SLOT = 2 * KT * RSB + 2 * KT * 4;
  static constexpr int TILE = KT * QS * 2;
  static constexpr int Q_BYTES = 2 * PREFILL_RT * QS * 2 + PREFILL_RT * 4;
  static constexpr int SMEM = Q_BYTES + 2 * SLOT + (BF16 ? 0 : 4 * TILE);
  static_assert(!BF16 || 2 * SLOT >= 4 * TILE, "work tiles fit the ring");
  static_assert(RSB % 16 == 0 && Q_BYTES % 16 == 0 && SLOT % 16 == 0,
                "16-byte aligned rows");
  static_assert(SMEM <= 227 * 1024, "shared memory of one block");
};

// One tile of KT keys for the warp's 16 query rows (two per thread: rows
// lane/4 and lane/4 + 8 of the warp): scores S = Q.K^T on the tensor cores,
// masked (key < lim[row]; key == diag[row] takes dsc[row]), the online
// softmax in registers, and O += P.V.  kh/kl and vh/vl are bf16 [KT][QS]
// tiles (lo terms only when LO); ksc/vsc the int8 scales of the tile's
// keys, or nullptr.  Scores, m and dsc are in log2 units (scale2 =
// log2(e) / sqrt(hd)), so every exponential is one exp2.  Each k-step
// loads all its B fragments before its products, and the lo products
// follow the hi ones of every n-tile, so no product waits on the one just
// issued.  On return s holds the tile's probabilities (before the V scale).
template <int HD, int KT, bool LO>
__device__ __forceinline__ void attend(
    const bf16* Qh, const bf16* Ql, const bf16* kh, const bf16* kl,
    const bf16* vh, const bf16* vl, const float* ksc, const float* vsc,
    int key0, const int (&lim)[2], const int (&diag)[2],
    const float (&dsc)[2], float scale2, float (&o)[HD / 8][4],
    float (&m)[2], float (&l)[2], float (&s)[KT / 8][4]) {
  constexpr int QS = HD + 8, NS = KT / 8, NO = HD / 8;
  constexpr int DG = NO < 16 ? NO : 16;  // V n-tiles per fragment group
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, tq = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NS; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[nt][i] = 0.f;
  const int q_off = (warp * 16 + (lane & 15)) * QS + (lane >> 4) * 8;
  const int k_off = ((lane & 7) + ((lane >> 4) << 3)) * QS + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    uint32_t ah[4], al[4], bk[NS][2];
    ldsm_x4(ah, Qh + q_off + kk * 16);
    ldsm_x4(al, Ql + q_off + kk * 16);
#pragma unroll
    for (int nt = 0; nt < NS; nt += 2) {
      uint32_t r[4];
      ldsm_x4(r, kh + nt * 8 * QS + kk * 16 + k_off);
      bk[nt][0] = r[0];
      bk[nt][1] = r[1];
      bk[nt + 1][0] = r[2];
      bk[nt + 1][1] = r[3];
    }
#pragma unroll
    for (int nt = 0; nt < NS; ++nt) mma(s[nt], ah, bk[nt][0], bk[nt][1]);
#pragma unroll
    for (int nt = 0; nt < NS; ++nt) mma(s[nt], al, bk[nt][0], bk[nt][1]);
    if constexpr (LO) {
#pragma unroll
      for (int nt = 0; nt < NS; nt += 2) {
        uint32_t r[4];
        ldsm_x4(r, kl + nt * 8 * QS + kk * 16 + k_off);
        bk[nt][0] = r[0];
        bk[nt][1] = r[1];
        bk[nt + 1][0] = r[2];
        bk[nt + 1][1] = r[3];
      }
#pragma unroll
      for (int nt = 0; nt < NS; ++nt) mma(s[nt], ah, bk[nt][0], bk[nt][1]);
    }
  }
  // mask, scale and the running max of the thread's two rows
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int nt = 0; nt < NS; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int half = i >> 1, kt = nt * 8 + 2 * tq + (i & 1);
      const int key = key0 + kt;
      float v = s[nt][i] * scale2;
      if (ksc != nullptr) v *= ksc[kt];
      if (key == diag[half]) v = dsc[half];
      v = key < lim[half] ? v : NEG;
      s[nt][i] = v;
      mx[half] = fmaxf(mx[half], v);
    }
  float alpha[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    mx[half] = fmaxf(mx[half], __shfl_xor_sync(0xffffffffu, mx[half], 1));
    mx[half] = fmaxf(mx[half], __shfl_xor_sync(0xffffffffu, mx[half], 2));
    alpha[half] = exp2f(m[half] - mx[half]);
    l[half] *= alpha[half];
    m[half] = mx[half];
  }
#pragma unroll
  for (int dt = 0; dt < NO; ++dt) {
    o[dt][0] *= alpha[0];
    o[dt][1] *= alpha[0];
    o[dt][2] *= alpha[1];
    o[dt][3] *= alpha[1];
  }
#pragma unroll
  for (int nt = 0; nt < NS; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float v = s[nt][i];
      const float p = v == NEG ? 0.f : exp2f(v - mx[i >> 1]);  // masked: 0
      l[i >> 1] += p;  // this thread's part; the quad sums it at the end
      s[nt][i] = p;
    }
  // O += P.V: the score accumulators of two key n-tiles are the A operand
  // of one k-step (FlashAttention-2's register reuse), split hi + lo
  const int v_off = (lane & 15) * QS + (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < KT / 16; ++kk) {
    float pv[8] = {s[2 * kk][0],     s[2 * kk][1],     s[2 * kk][2],
                   s[2 * kk][3],     s[2 * kk + 1][0], s[2 * kk + 1][1],
                   s[2 * kk + 1][2], s[2 * kk + 1][3]};
    if (vsc != nullptr) {
      const int k0 = kk * 16 + 2 * tq;
#pragma unroll
      for (int i = 0; i < 8; ++i) pv[i] *= vsc[k0 + (i & 1) + ((i >> 2) << 3)];
    }
    uint32_t ph[4], plo[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) split2(pv[2 * i], pv[2 * i + 1], ph[i], plo[i]);
#pragma unroll
    for (int dg = 0; dg < NO; dg += DG) {
      uint32_t bv[DG][2];
#pragma unroll
      for (int dt = 0; dt < DG; dt += 2) {
        uint32_t r[4];
        ldsm_x4_t(r, vh + kk * 16 * QS + (dg + dt) * 8 + v_off);
        bv[dt][0] = r[0];
        bv[dt][1] = r[1];
        bv[dt + 1][0] = r[2];
        bv[dt + 1][1] = r[3];
      }
#pragma unroll
      for (int dt = 0; dt < DG; ++dt) mma(o[dg + dt], ph, bv[dt][0], bv[dt][1]);
#pragma unroll
      for (int dt = 0; dt < DG; ++dt) mma(o[dg + dt], plo, bv[dt][0], bv[dt][1]);
      if constexpr (LO) {
#pragma unroll
        for (int dt = 0; dt < DG; dt += 2) {
          uint32_t r[4];
          ldsm_x4_t(r, vl + kk * 16 * QS + (dg + dt) * 8 + v_off);
          bv[dt][0] = r[0];
          bv[dt][1] = r[1];
          bv[dt + 1][0] = r[2];
          bv[dt + 1][1] = r[3];
        }
#pragma unroll
        for (int dt = 0; dt < DG; ++dt)
          mma(o[dg + dt], ph, bv[dt][0], bv[dt][1]);
      }
    }
  }
}

// Widen the raw fp32 / int8 rows of a ring slot into the bf16 work tiles
// (hi, and for fp32 also lo); columns past hd read as zero.
template <typename KVT, int HD, int KT>
__device__ __forceinline__ void widen_tile(const unsigned char* slot, int hd,
                                           bf16* Kh, bf16* Kl, bf16* Vh,
                                           bf16* Vl) {
  constexpr int QS = HD + 8;
  constexpr bool SPLIT = std::is_same<KVT, float>::value;
  const KVT* kr = reinterpret_cast<const KVT*>(slot);
  const KVT* vr = kr + KT * HD;
  for (int i = threadIdx.x; i < KT * HD / 2; i += THREADS) {
    const int t = i / (HD / 2), d = (i % (HD / 2)) * 2;
    const int src = t * HD + d, dst = t * QS + d;
    const float k0 = d < hd ? to_f(kr[src]) : 0.f;
    const float k1 = d + 1 < hd ? to_f(kr[src + 1]) : 0.f;
    const float v0 = d < hd ? to_f(vr[src]) : 0.f;
    const float v1 = d + 1 < hd ? to_f(vr[src + 1]) : 0.f;
    uint32_t hi, lo;
    split2(k0, k1, hi, lo);
    *reinterpret_cast<uint32_t*>(Kh + dst) = hi;
    if (SPLIT) *reinterpret_cast<uint32_t*>(Kl + dst) = lo;
    split2(v0, v1, hi, lo);
    *reinterpret_cast<uint32_t*>(Vh + dst) = hi;
    if (SPLIT) *reinterpret_cast<uint32_t*>(Vl + dst) = lo;
  }
}

// The chunk's own keys key0 .. key0+KT-1 of (b, h) from (B, C, KV, hd)
// of type T, split hi / lo into the work tiles (a bf16 chunk has lo = 0);
// keys past C and columns past hd read as zero.  Each thread loads a batch
// of element pairs before it converts and stores any.
template <int HD, int KT, typename T>
__device__ __forceinline__ void load_chunk_tile(const PrefillArgs& a, int b,
                                                int h, int KV, int hd,
                                                int key0, bf16* Kh, bf16* Kl,
                                                bf16* Vh, bf16* Vl) {
  constexpr int QS = HD + 8, PAIRS = KT * HD / 2 / THREADS, BATCH = 8;
  static_assert(PAIRS % BATCH == 0, "pairs per thread");
#pragma unroll 1
  for (int p0 = 0; p0 < PAIRS; p0 += BATCH) {
    float x[BATCH][4];
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      const int i = threadIdx.x + (p0 + j) * THREADS;
      const int t = i / (HD / 2), d = (i % (HD / 2)) * 2, key = key0 + t;
      const long long row = (((long long)b * a.C + key) * KV + h) * hd;
      const bool in0 = key < a.C && d < hd, in1 = key < a.C && d + 1 < hd;
      x[j][0] = in0 ? ldf<T>(a.kc, row + d) : 0.f;
      x[j][1] = in1 ? ldf<T>(a.kc, row + d + 1) : 0.f;
      x[j][2] = in0 ? ldf<T>(a.vc, row + d) : 0.f;
      x[j][3] = in1 ? ldf<T>(a.vc, row + d + 1) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      const int i = threadIdx.x + (p0 + j) * THREADS;
      const int dst = (i / (HD / 2)) * QS + (i % (HD / 2)) * 2;
      uint32_t hi, lo;
      split2(x[j][0], x[j][1], hi, lo);
      *reinterpret_cast<uint32_t*>(Kh + dst) = hi;
      *reinterpret_cast<uint32_t*>(Kl + dst) = lo;
      split2(x[j][2], x[j][3], hi, lo);
      *reinterpret_cast<uint32_t*>(Vh + dst) = hi;
      *reinterpret_cast<uint32_t*>(Vl + dst) = lo;
    }
  }
}

// This block's query rows row0 .. row0+63 of (b, h), of type T, split
// hi / lo into Qh / Ql (rows past R and columns past hd are zero); loads
// batched as above.
template <int HD, typename T>
__device__ __forceinline__ void load_q_rows(const PrefillArgs& a, int b,
                                            int h, int row0, int R, int hd,
                                            bf16* Qh, bf16* Ql) {
  constexpr int QS = HD + 8, PAIRS = PREFILL_RT * HD / 2 / THREADS;
  constexpr int BATCH = PAIRS < 32 ? PAIRS : 32;
  static_assert(PAIRS % BATCH == 0, "pairs per thread");
#pragma unroll 1
  for (int p0 = 0; p0 < PAIRS; p0 += BATCH) {
    float x[BATCH][2];
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      const int i = threadIdx.x + (p0 + j) * THREADS;
      const int r = i / (HD / 2), d = (i % (HD / 2)) * 2, row = row0 + r;
      const long long base = b * a.q_sb + h * a.q_skv +
                             (long long)(row / a.C) * a.q_sg +
                             (long long)(row % a.C) * a.q_sc;
      x[j][0] = row < R && d < hd ? ldf<T>(a.q, base + d) : 0.f;
      x[j][1] = row < R && d + 1 < hd ? ldf<T>(a.q, base + d + 1) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      const int i = threadIdx.x + (p0 + j) * THREADS;
      const int dst = (i / (HD / 2)) * QS + (i % (HD / 2)) * 2;
      uint32_t hi, lo;
      split2(x[j][0], x[j][1], hi, lo);
      *reinterpret_cast<uint32_t*>(Qh + dst) = hi;
      *reinterpret_cast<uint32_t*>(Ql + dst) = lo;
    }
  }
}

// The diagonal override's scores: row r's score to its own chunk position
// c_r from k_self, q_r . k_self[c_r] / sqrt(hd) in fp32 (times log2(e),
// the units of attend's scores).  A warp takes a
// row at a time, lanes over the head dims (coalesced), four rows' loads in
// flight together.
template <typename TQ, typename TC>
__device__ __forceinline__ void diag_scores(const PrefillArgs& a, int b,
                                            int h, int KV, int row0, int R,
                                            int hd, float scale2,
                                            float* d_s) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  constexpr int ROWS = 4, EPL = repro_torch::kMaxHeadDim / 32;
#pragma unroll 1
  for (int r0 = warp; r0 < PREFILL_RT; r0 += 4 * ROWS) {
    float acc[ROWS];
#pragma unroll
    for (int j = 0; j < ROWS; ++j) {
      const int r = r0 + 4 * j, row = row0 + r;
      const int c = row % a.C;
      const long long qb = b * a.q_sb + h * a.q_skv +
                           (long long)(row / a.C) * a.q_sg +
                           (long long)c * a.q_sc;
      const long long kb = (((long long)b * a.C + c) * KV + h) * hd;
      acc[j] = 0.f;
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        const int d = lane + 32 * e;
        if (row < R && d < hd)
          acc[j] = fmaf(ldf<TQ>(a.q, qb + d), ldf<TC>(a.kself, kb + d),
                        acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < ROWS; ++j) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], off);
      if (lane == 0) d_s[r0 + 4 * j] = acc[j] * scale2;
    }
  }
}

// The v_self override of the chunk tile at key0: row r's own column c_r
// (if it lies in the tile) swaps its value v_chunk[c_r] for v_self[c_r],
// O[r] += p_{r,c_r} (v_self - v_chunk)[c_r], in fp32.  The probability is
// gathered from the quad that holds it.
template <int HD, int KT, typename T>
__device__ __forceinline__ void vself_fix(const PrefillArgs& a, int b, int h,
                                          int KV, int hd, int key0,
                                          const int (&cpos)[2],
                                          const float (&s)[KT / 8][4],
                                          float (&o)[HD / 8][4]) {
  const int tq = threadIdx.x & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int c = cpos[half];
    float pd = 0.f;
#pragma unroll
    for (int nt = 0; nt < KT / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (key0 + nt * 8 + 2 * tq + e == c) pd = s[nt][2 * half + e];
    pd += __shfl_xor_sync(0xffffffffu, pd, 1);
    pd += __shfl_xor_sync(0xffffffffu, pd, 2);
    if (c < key0 || c >= key0 + KT) continue;
    const long long row = (((long long)b * a.C + c) * KV + h) * hd;
#pragma unroll
    for (int dt = 0; dt < HD / 8; ++dt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = dt * 8 + 2 * tq + e;
        if (d < hd)
          o[dt][2 * half + e] +=
              pd * (ldf<T>(a.vself, row + d) - ldf<T>(a.vc, row + d));
      }
  }
}

// The lane of rank z when the B lanes are ordered by context length,
// longest first (ties by index).  Blocks start in blockIdx order, so the
// lanes with the most tiles start first and the short ones fill in behind
// them, instead of a long lane's blocks starting last.
__device__ __forceinline__ int longest_first(const Pool& pl, int B, int z) {
  __shared__ int lane_s;
  for (int t = threadIdx.x; t < B; t += THREADS) {
    const int ct = pl.ctx[t];
    int rank = 0;
    for (int u = 0; u < B; ++u) {
      const int cu = pl.ctx[u];
      rank += cu > ct || (cu == ct && u < t);
    }
    if (rank == z) lane_s = t;
  }
  __syncthreads();
  return lane_s;
}

// One block per (64-row tile, kv head, lane).
template <typename KVT, int HD>
__global__ void __launch_bounds__(THREADS)
paged_prefill_kernel(Pool pl, PrefillArgs a) {
  using Cfg = PrefillCfg<KVT, HD>;
  constexpr int KT = Cfg::KT, QS = Cfg::QS, RSB = Cfg::RSB;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qh = reinterpret_cast<bf16*>(smem);
  bf16* Ql = Qh + PREFILL_RT * QS;
  float* d_s = reinterpret_cast<float*>(Ql + PREFILL_RT * QS);
  unsigned char* ring = reinterpret_cast<unsigned char*>(d_s + PREFILL_RT);
  bf16* Kh = reinterpret_cast<bf16*>(Cfg::BF16 ? ring : ring + 2 * Cfg::SLOT);
  bf16* Kl = Kh + KT * QS;
  bf16* Vh = Kl + KT * QS;
  bf16* Vl = Vh + KT * QS;

  const int hd = pl.hd, C = a.C, R = a.G * C;
  const int h = blockIdx.y, row0 = blockIdx.x * PREFILL_RT;
  const int b = longest_first(pl, a.B, blockIdx.z);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_ctx = min(pl.ctx[b], pl.Pa * pl.ps);
  const int n_tiles = (n_ctx + KT - 1) / KT;
  const bool vec = vec_pool<KVT>(pl);
  const float scale2 = 1.4426950408889634f / sqrtf(static_cast<float>(hd));

  if (Cfg::BF16 && hd < HD) {  // the ring's columns past hd stay zero
    for (int i = threadIdx.x; i < 2 * Cfg::SLOT / 16; i += THREADS)
      reinterpret_cast<uint4*>(ring)[i] = make_uint4(0u, 0u, 0u, 0u);
    __syncthreads();
  }
  // this thread's key row of every tile; its page is fetched one tile
  // ahead (the token index is formed at the issue)
  const int kk = threadIdx.x / (THREADS / KT);
  auto issue = [&](int tile, long long tok) {
    unsigned char* slot = ring + (tile & 1) * Cfg::SLOT;
    float* sc = reinterpret_cast<float*>(slot + 2 * KT * RSB);
    issue_tile<KVT, KT>(pl, tok, slot, slot + KT * RSB, RSB, sc, sc + KT,
                        vec);
  };
  if (n_tiles > 0) issue(0, key_token(pl, b, h, kk, n_ctx));
  cp_commit();
  int page_next = key_page(pl, b, KT + kk, n_ctx);

  // this block's query rows while the first tile is in flight, and the
  // diagonal override's scores
  if (a.q_bf16)
    load_q_rows<HD, bf16>(a, b, h, row0, R, hd, Qh, Ql);
  else
    load_q_rows<HD, float>(a, b, h, row0, R, hd, Qh, Ql);
  if (a.kself != nullptr) {
    if (a.q_bf16 && a.c_bf16)
      diag_scores<bf16, bf16>(a, b, h, pl.KV, row0, R, hd, scale2, d_s);
    else if (a.q_bf16)
      diag_scores<bf16, float>(a, b, h, pl.KV, row0, R, hd, scale2, d_s);
    else if (a.c_bf16)
      diag_scores<float, bf16>(a, b, h, pl.KV, row0, R, hd, scale2, d_s);
    else
      diag_scores<float, float>(a, b, h, pl.KV, row0, R, hd, scale2, d_s);
  }

  float o[HD / 8][4];
#pragma unroll
  for (int dt = 0; dt < HD / 8; ++dt)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[dt][i] = 0.f;
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
  float s[KT / 8][4];
  const int r_a = row0 + warp * 16 + (lane >> 2);
  const int cpos[2] = {r_a < R ? r_a % C : -1, r_a + 8 < R ? (r_a + 8) % C : -1};

  // the paged prior context: tile i's copy landed, tile i+1's is issued
  // before tile i's products
  {
    const int lim[2] = {n_ctx, n_ctx}, diag[2] = {-1, -1};
    const float dsc[2] = {0.f, 0.f};
    for (int i = 0; i < n_tiles; ++i) {
      cp_wait<0>();
      __syncthreads();
      if (i + 1 < n_tiles)
        issue(i + 1, token_of(pl, page_next, h, (i + 1) * KT + kk));
      cp_commit();
      page_next = key_page(pl, b, (i + 2) * KT + kk, n_ctx);
      const unsigned char* slot = ring + (i & 1) * Cfg::SLOT;
      const float* ksc = pl.ks != nullptr
          ? reinterpret_cast<const float*>(slot + 2 * KT * RSB) : nullptr;
      const float* vsc = ksc != nullptr ? ksc + KT : nullptr;
      if constexpr (Cfg::BF16) {
        const bf16* kt = reinterpret_cast<const bf16*>(slot);
        attend<HD, KT, false>(Qh, Ql, kt, nullptr, kt + KT * QS, nullptr,
                              ksc, vsc, i * KT, lim, diag, dsc, scale2, o, m,
                              l, s);
      } else {
        widen_tile<KVT, HD, KT>(slot, hd, Kh, Kl, Vh, Vl);
        __syncthreads();
        attend<HD, KT, Cfg::SPLIT>(Qh, Ql, Kh, Kl, Vh, Vl, ksc, vsc, i * KT,
                                   lim, diag, dsc, scale2, o, m, l, s);
      }
    }
  }
  // the chunk itself, causally: row r sees chunk keys <= c_r; keys past
  // the block's last chunk position are masked for every row, so stop
  const int r_last = min(row0 + PREFILL_RT, R) - 1;
  const int max_c = (r_last - row0 + 1 >= C || r_last / C != row0 / C)
                        ? C - 1 : r_last % C;
  const int lim[2] = {cpos[0] + 1, cpos[1] + 1};
  const bool kself = a.kself != nullptr;
  const int diag[2] = {kself ? cpos[0] : -1, kself ? cpos[1] : -1};
  for (int key0 = 0; key0 <= max_c; key0 += KT) {
    __syncthreads();  // the ring / work tiles are free; Q and d_s are in
    if (a.c_bf16)
      load_chunk_tile<HD, KT, bf16>(a, b, h, pl.KV, hd, key0, Kh, Kl, Vh, Vl);
    else
      load_chunk_tile<HD, KT, float>(a, b, h, pl.KV, hd, key0, Kh, Kl, Vh,
                                     Vl);
    __syncthreads();
    const int rw = warp * 16 + (lane >> 2);
    const float dsc[2] = {kself ? d_s[rw] : 0.f, kself ? d_s[rw + 8] : 0.f};
    attend<HD, KT, true>(Qh, Ql, Kh, Kl, Vh, Vl, nullptr, nullptr, key0, lim,
                         diag, dsc, scale2, o, m, l, s);
    if (a.vself != nullptr && a.c_bf16)
      vself_fix<HD, KT, bf16>(a, b, h, pl.KV, hd, key0, cpos, s, o);
    else if (a.vself != nullptr)
      vself_fix<HD, KT, float>(a, b, h, pl.KV, hd, key0, cpos, s, o);
  }
  // normalize (every row has at least its own column) and write
  const int tq = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    l[half] += __shfl_xor_sync(0xffffffffu, l[half], 1);
    l[half] += __shfl_xor_sync(0xffffffffu, l[half], 2);
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = r_a + 8 * half;
    if (row >= R) continue;
    const long long base = b * a.o_sb + h * a.o_skv + (row / C) * a.o_sg +
                           (row % C) * a.o_sc;
#pragma unroll
    for (int dt = 0; dt < HD / 8; ++dt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = dt * 8 + 2 * tq + e;
        if (d < hd) st_any(a.out, a.o_bf16, base + d, o[dt][2 * half + e] / l[half]);
      }
  }
}

// ---------------------------------------------------------------------------
// Paged decode: fixed context splits, a cp.async ring, fp32 CUDA cores
// ---------------------------------------------------------------------------

// ring stages per block: two 32-key stages in flight while a third is
// read (fp32 rows: one), so that three blocks fit an SM's shared memory
template <typename KVT>
constexpr int dec_stages() { return sizeof(KVT) == 4 ? 2 : 3; }
constexpr int DEC_BLOCKS_PER_SM = 3;

// padded ring row (bytes): the quads that read neighbouring keys' rows in
// one phase of a shared load hit different banks (the row is offset by the
// bytes a quad reads: 32 for int8, 64 for bf16, 16 per 16-byte load for
// fp32)
__host__ __device__ inline int dec_row_bytes(int hd, int elt) {
  return (hd * elt + 127) / 128 * 128 + (elt == 1 ? 32 : elt == 2 ? 64 : 16);
}

__host__ __device__ inline int dec_slot_bytes(int hd, int elt) {
  return 2 * DEC_KT * dec_row_bytes(hd, elt) + 2 * DEC_KT * 4;
}

// ring, q rows (fp32), the warps' partial scores, the split's token
// indices
__host__ __device__ inline int dec_smem_bytes(int hd, int elt, int stages) {
  return stages * dec_slot_bytes(hd, elt) + DEC_MAXG * hd * 4 +
         DEC_MAXG * 32 * 4 * 4 + DEC_SPLIT * 8;
}

// The G query rows g0 .. g0+G-1 of (b, kv head h) -> q_s (G, hd) fp32;
// every load in flight before the first store.
template <typename T>
__device__ __forceinline__ void load_q_group(const DecodeArgs& a, int b,
                                             int h, int g0, int G, int hd,
                                             float* q_s) {
  constexpr int PER = DEC_MAXG * repro_torch::kMaxHeadDim / THREADS;
  const int n = G * hd;
  float x[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int i = threadIdx.x + j * THREADS, g = i / hd;
    x[j] = i < n ? ldf<T>(a.q, b * a.q_sb +
                                   (long long)(h * a.G + g0 + g) * a.q_sh +
                                   i - g * hd)
                 : 0.f;
  }
#pragma unroll
  for (int j = 0; j < PER; ++j)
    if (static_cast<int>(threadIdx.x) + j * THREADS < n)
      q_s[threadIdx.x + j * THREADS] = x[j];
}

// Eight KVT values of a ring row from element d as fp32 (one 16-, 32- or
// 8-byte load when hd is a multiple of 8), zeros past hd.
template <typename KVT>
__device__ __forceinline__ void load8(const unsigned char* row, int d, int hd,
                                      bool vec8, float (&x)[8]) {
  const KVT* p = reinterpret_cast<const KVT*>(row) + d;
  if (vec8 && d < hd) {
    if constexpr (sizeof(KVT) == 4) {
      const float4 a = reinterpret_cast<const float4*>(p)[0];
      const float4 c = reinterpret_cast<const float4*>(p)[1];
      x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
      x[4] = c.x; x[5] = c.y; x[6] = c.z; x[7] = c.w;
    } else if constexpr (sizeof(KVT) == 2) {
      const uint4 r = *reinterpret_cast<const uint4*>(p);
      const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
        x[2 * i] = f.x;
        x[2 * i + 1] = f.y;
      }
    } else {
      const uint2 r = *reinterpret_cast<const uint2*>(p);
#pragma unroll
      for (int i = 0; i < 8; ++i)
        x[i] = static_cast<float>(static_cast<int8_t>(
            ((i < 4 ? r.x : r.y) >> (8 * (i & 3))) & 0xffu));
    }
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) x[i] = d + i < hd ? to_f(p[i]) : 0.f;
  }
}

// One block per (kv head and row slice, lane, split of DEC_SPLIT keys): the
// online-softmax state of the slice's query rows over the split's keys, written to
// (o, m, l)_part[split].  A split that starts past the lane's context
// exits (the merge reads only the splits a lane has).  Lane l of warp w
// owns the 8 head dims c*128 + w*32 + (l%4)*8 .. +8 (NCH chunks of 128)
// and, of every 32-key stage, the keys p*8 + l/4 (p < 4): its q slice sits
// in registers; a key's score is the quad's sum (two shuffles) of the four
// warps' partials (shared memory); P.V accumulates the lane's dims over
// its keys, and the eight quads' sums are combined once, at the end.  The
// per-row arrays are GT >= G long (GT = G at the common group sizes, so
// that no register or instruction goes to a row that does not exist).
// Scores and m are kept in log2 units (one exp2 per exponential); m is
// written back in natural units.
template <typename KVT, int NCH, int GT>
__global__ void __launch_bounds__(THREADS, DEC_BLOCKS_PER_SM)
paged_decode_kernel(Pool pl, DecodeArgs a) {
  constexpr int NST = dec_stages<KVT>();
  extern __shared__ __align__(16) unsigned char smem[];
  const int h = blockIdx.x / a.g_slices, b = blockIdx.y, split = blockIdx.z;
  // the slice's rows g0 .. g0+G-1 of the group (all of it when G <= 8)
  const int g0 = (blockIdx.x - h * a.g_slices) * a.g_rows;
  const int G = min(a.g_rows, a.G - g0);
  const int n_ctx = min(pl.ctx[b], pl.Pa * pl.ps);
  const int k_begin = split * DEC_SPLIT;
  if (k_begin >= n_ctx) return;
  const int k_end = min(n_ctx, k_begin + DEC_SPLIT);
  const int n_st = (k_end - k_begin + DEC_KT - 1) / DEC_KT;
  const int hd = pl.hd;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int quad = lane >> 2, sub = lane & 3;
  const int RB = dec_row_bytes(hd, sizeof(KVT));
  const int SLOT = dec_slot_bytes(hd, sizeof(KVT));
  unsigned char* ring = smem;
  float* q_s = reinterpret_cast<float*>(ring + NST * SLOT);
  float* part = q_s + G * hd;  // [g][key][warp]
  long long* tok_s = reinterpret_cast<long long*>(part + G * 32 * 4);
  const bool vec = vec_pool<KVT>(pl), vec8 = hd % 8 == 0;
  // the split's token indices, one block-table load per thread, so that no
  // copy waits on one
  static_assert(DEC_SPLIT == THREADS, "one key of the split per thread");
  tok_s[threadIdx.x] = key_token(pl, b, h, k_begin + threadIdx.x, k_end);
  __syncthreads();
  auto issue = [&](int st) {
    unsigned char* slot = ring + (st % NST) * SLOT;
    float* sc = reinterpret_cast<float*>(slot + 2 * DEC_KT * RB);
    issue_tile<KVT, DEC_KT>(
        pl, tok_s[st * DEC_KT + threadIdx.x / (THREADS / DEC_KT)], slot,
        slot + DEC_KT * RB, RB, sc, sc + DEC_KT, vec);
  };
#pragma unroll
  for (int st = 0; st < NST - 1; ++st) {
    if (st < n_st) issue(st);
    cp_commit();
  }
  if (a.q_bf16)
    load_q_group<bf16>(a, b, h, g0, G, hd, q_s);
  else
    load_q_group<float>(a, b, h, g0, G, hd, q_s);
  __syncthreads();
  float qr[NCH][GT][8], o[NCH][GT][8];
  float m[GT], lsum[GT];
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
    const int d0 = c * 128 + warp * 32 + sub * 8;
#pragma unroll
    for (int g = 0; g < GT; ++g)
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        qr[c][g][e] = g < G && d0 + e < hd ? q_s[g * hd + d0 + e] : 0.f;
        o[c][g][e] = 0.f;
      }
  }
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    m[g] = NEG;
    lsum[g] = 0.f;
  }
  const float scale2 = 1.4426950408889634f / sqrtf(static_cast<float>(hd));
  for (int i = 0; i < n_st; ++i) {
    cp_wait<NST - 2>();
    __syncthreads();  // stage i landed; stage i-1's readers are done
    if (i + NST - 1 < n_st) issue(i + NST - 1);
    cp_commit();
    const unsigned char* slot = ring + (i % NST) * SLOT;
    const unsigned char* vrows = slot + DEC_KT * RB;
    const float* ksc = reinterpret_cast<const float*>(slot + 2 * DEC_KT * RB);
    // partial scores of the lane's keys over the warp's dims
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int key = p * 8 + quad;
      float acc[GT];
#pragma unroll
      for (int g = 0; g < GT; ++g) acc[g] = 0.f;
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        float k[8];
        load8<KVT>(slot + key * RB, c * 128 + warp * 32 + sub * 8, hd, vec8,
                   k);
#pragma unroll
        for (int g = 0; g < GT; ++g)
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[g] = fmaf(qr[c][g][e], k[e], acc[g]);
      }
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        acc[g] += __shfl_xor_sync(0xffffffffu, acc[g], 1);
        acc[g] += __shfl_xor_sync(0xffffffffu, acc[g], 2);
        if (sub == 0 && g < G) part[(g * 32 + key) * 4 + warp] = acc[g];
      }
    }
    __syncthreads();
    // the online softmax over the stage's 32 keys: the lane's four keys,
    // then the eight quads (shuffles); every quad lane holds the same
    float sc[4][GT], mx[GT], vscale[4];
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int key = p * 8 + quad;
      const bool valid = k_begin + i * DEC_KT + key < k_end;
      const float kscale = (pl.ks != nullptr ? ksc[key] : 1.f) * scale2;
      vscale[p] = pl.vs != nullptr ? ksc[DEC_KT + key] : 1.f;
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        float sum = 0.f;
        if (g < G) {
          const float4 w4 =
              *reinterpret_cast<const float4*>(part + (g * 32 + key) * 4);
          sum = (w4.x + w4.y) + (w4.z + w4.w);
        }
        sc[p][g] = valid ? sum * kscale : NEG;
      }
    }
#pragma unroll
    for (int g = 0; g < GT; ++g)
      mx[g] = fmaxf(fmaxf(sc[0][g], sc[1][g]), fmaxf(sc[2][g], sc[3][g]));
#pragma unroll
    for (int off = 4; off < 32; off <<= 1)
#pragma unroll
      for (int g = 0; g < GT; ++g)
        mx[g] = fmaxf(mx[g], __shfl_xor_sync(0xffffffffu, mx[g], off));
    float pv[4][GT];
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      mx[g] = fmaxf(mx[g], m[g]);
      const float alpha = exp2f(m[g] - mx[g]);
      lsum[g] *= alpha;
#pragma unroll
      for (int c = 0; c < NCH; ++c)
#pragma unroll
        for (int e = 0; e < 8; ++e) o[c][g][e] *= alpha;
      m[g] = mx[g];
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const float pr =
            sc[p][g] == NEG ? 0.f : exp2f(sc[p][g] - mx[g]);  // masked: 0
        lsum[g] += pr;
        pv[p][g] = pr * vscale[p];
      }
    }
    // P.V: the lane's dims over its four keys
#pragma unroll
    for (int p = 0; p < 4; ++p) {
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        float v[8];
        load8<KVT>(vrows + (p * 8 + quad) * RB, c * 128 + warp * 32 + sub * 8,
                   hd, vec8, v);
#pragma unroll
        for (int g = 0; g < GT; ++g)
#pragma unroll
          for (int e = 0; e < 8; ++e) o[c][g][e] = fmaf(pv[p][g], v[e], o[c][g][e]);
      }
    }
  }
  // combine the eight quads (each summed over its own keys) and write
  const size_t rows = (size_t)a.B * pl.KV * a.G;
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    if (g >= G) break;
    float lt = lsum[g];
#pragma unroll
    for (int off = 4; off < 32; off <<= 1)
      lt += __shfl_xor_sync(0xffffffffu, lt, off);
    const size_t sr = split * rows + ((size_t)b * pl.KV + h) * a.G + g0 + g;
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      const int d0 = c * 128 + warp * 32 + sub * 8;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        float v = o[c][g][e];
#pragma unroll
        for (int off = 4; off < 32; off <<= 1)
          v += __shfl_xor_sync(0xffffffffu, v, off);
        if (quad == 0 && d0 + e < hd) a.o_part[sr * hd + d0 + e] = v;
      }
    }
    if (threadIdx.x == 0) {
      a.m_part[sr] = m[g] == NEG ? NEG : m[g] * 0.6931471805599453f;
      a.l_part[sr] = lt;
    }
  }
}

// Merge the splits of each query row (one block per row): m = max_s m_s,
// l = sum_s l_s e^{m_s - m}, o = sum_s o_s e^{m_s - m} over the splits the
// lane's context has (none: m = NEG, l = 0, o = 0).  SELF folds the
// token's own K/V in and normalizes:
//   s = q.k_new / sqrt(hd);  m' = max(m, s);
//   out = (o e^{m-m'} + v_new e^{s-m'}) / (l e^{m-m'} + e^{s-m'}).
template <bool SELF>
__global__ void __launch_bounds__(THREADS)
decode_merge_kernel(Pool pl, DecodeArgs a) {
  const int row = blockIdx.x;  // (b * KV + kv) * G + g
  const int G = a.G, KV = pl.KV, hd = pl.hd;
  const int b = row / (KV * G), head = row - b * KV * G;
  const size_t rows = (size_t)a.B * KV * G;
  const int n_ctx = min(pl.ctx[b], pl.Pa * pl.ps);
  const int n_sp = (n_ctx + DEC_SPLIT - 1) / DEC_SPLIT;
  // splits read eight at a time, every load of a batch in flight at once
  constexpr int SB = 8;
  float mx = NEG;
  for (int s0 = 0; s0 < n_sp; s0 += SB) {
    float mv[SB];
#pragma unroll
    for (int j = 0; j < SB; ++j)
      mv[j] = s0 + j < n_sp ? a.m_part[(s0 + j) * rows + row] : NEG;
#pragma unroll
    for (int j = 0; j < SB; ++j) mx = fmaxf(mx, mv[j]);
  }
  float lt = 0.f, acc[2] = {0.f, 0.f};
  for (int s0 = 0; s0 < n_sp; s0 += SB) {
    float w[SB], lv[SB], ov[SB][2];
#pragma unroll
    for (int j = 0; j < SB; ++j) {
      const bool in = s0 + j < n_sp;
      const size_t sr = (s0 + j) * rows + row;
      const float ms = in ? a.m_part[sr] : NEG;
      w[j] = ms == NEG ? 0.f : expf(ms - mx);
      lv[j] = in ? a.l_part[sr] : 0.f;
#pragma unroll
      for (int ci = 0; ci < 2; ++ci) {
        const int d = threadIdx.x + ci * THREADS;
        ov[j][ci] = in && d < hd ? a.o_part[sr * hd + d] : 0.f;
      }
    }
#pragma unroll
    for (int j = 0; j < SB; ++j) {
      lt = fmaf(w[j], lv[j], lt);
      acc[0] = fmaf(w[j], ov[j][0], acc[0]);
      acc[1] = fmaf(w[j], ov[j][1], acc[1]);
    }
  }
  if constexpr (!SELF) {
#pragma unroll
    for (int ci = 0; ci < 2; ++ci) {
      const int d = threadIdx.x + ci * THREADS;
      if (d < hd) a.o[(size_t)row * hd + d] = acc[ci];
    }
    if (threadIdx.x == 0) {
      a.m[row] = mx;
      a.l[row] = lt;
    }
  } else {
    __shared__ float red[THREADS / 32];
    const long long qb = b * a.q_sb + (long long)head * a.q_sh;
    const long long nb = ((long long)b * KV + head / G) * hd;
    float dot = 0.f;
    for (int d = threadIdx.x; d < hd; d += THREADS)
      dot = fmaf(ld_any(a.q, a.q_bf16, qb + d),
                 ld_any(a.k_new, a.new_bf16, nb + d), dot);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      dot += __shfl_xor_sync(0xffffffffu, dot, off);
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = dot;
    __syncthreads();
    const float s_self = (red[0] + red[1] + red[2] + red[3]) *
                         (1.0f / sqrtf(static_cast<float>(hd)));
    const float m2 = fmaxf(mx, s_self);
    const float a_ctx = expf(mx - m2), a_self = expf(s_self - m2);
    const float den = lt * a_ctx + a_self;
#pragma unroll
    for (int ci = 0; ci < 2; ++ci) {
      const int d = threadIdx.x + ci * THREADS;
      if (d < hd)
        st_any(a.out, a.out_bf16, (long long)row * hd + d,
               (acc[ci] * a_ctx + ld_any(a.v_new, a.new_bf16, nb + d) * a_self) /
                   den);
    }
  }
}

// Raise a kernel's dynamic shared-memory limit once per device.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, unsigned* done) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 32 && ((*done >> dev) & 1u)) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < 32) *done |= 1u << dev;
  return err;
}

template <typename KVT, int NCH, int GT>
cudaError_t decode_split(const Pool& pl, const DecodeArgs& a, cudaStream_t s) {
  constexpr int NST = dec_stages<KVT>();
  static unsigned done = 0;
  const cudaError_t err = allow_smem(
      paged_decode_kernel<KVT, NCH, GT>,
      dec_smem_bytes(NCH * 128, sizeof(KVT), NST), &done);
  if (err != cudaSuccess) return err;
  const int bytes = dec_smem_bytes(pl.hd, sizeof(KVT), NST);
  paged_decode_kernel<KVT, NCH, GT>
      <<<dim3(pl.KV * a.g_slices, a.B, a.splits), THREADS, bytes, s>>>(pl,
                                                                      a);
  return cudaGetLastError();
}

// query rows per block (a slice of a group larger than DEC_MAXG), rounded
// up to a compiled bucket: exact at the common group sizes (1, 2, 4, 5, 8),
// one bucket for 128 < hd <= 256
template <typename KVT>
cudaError_t decode_rows(const Pool& pl, const DecodeArgs& a, cudaStream_t s) {
  if (pl.hd > 128) return decode_split<KVT, 2, DEC_MAXG>(pl, a, s);
  switch (a.g_rows) {
    case 1: return decode_split<KVT, 1, 1>(pl, a, s);
    case 2: return decode_split<KVT, 1, 2>(pl, a, s);
    case 3:
    case 4: return decode_split<KVT, 1, 4>(pl, a, s);
    case 5: return decode_split<KVT, 1, 5>(pl, a, s);
    default: return decode_split<KVT, 1, DEC_MAXG>(pl, a, s);
  }
}

template <typename KVT>
cudaError_t decode_t(const Pool& pl, const DecodeArgs& a, bool self,
                     cudaStream_t s) {
  cudaError_t err = decode_rows<KVT>(pl, a, s);
  if (err != cudaSuccess) return err;
  const int rows = a.B * pl.KV * a.G;
  if (self)
    decode_merge_kernel<true><<<rows, THREADS, 0, s>>>(pl, a);
  else
    decode_merge_kernel<false><<<rows, THREADS, 0, s>>>(pl, a);
  return cudaGetLastError();
}

template <typename KVT, int HD>
cudaError_t prefill_t(const Pool& pl, const PrefillArgs& a, cudaStream_t s) {
  using Cfg = PrefillCfg<KVT, HD>;
  static unsigned done = 0;
  const cudaError_t err =
      allow_smem(paged_prefill_kernel<KVT, HD>, Cfg::SMEM, &done);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.G * a.C + PREFILL_RT - 1) / PREFILL_RT, pl.KV, a.B);
  paged_prefill_kernel<KVT, HD><<<grid, THREADS, Cfg::SMEM, s>>>(pl, a);
  return cudaGetLastError();
}

// head dims padded to the next of 64, 128, 256 (the padding reads as zero)
template <typename KVT>
cudaError_t prefill_hd(const Pool& pl, const PrefillArgs& a, cudaStream_t s) {
  if (pl.hd <= 64) return prefill_t<KVT, 64>(pl, a, s);
  if (pl.hd <= 128) return prefill_t<KVT, 128>(pl, a, s);
  return prefill_t<KVT, 256>(pl, a, s);
}

}  // namespace

namespace repro_torch {

cudaError_t paged_decode_launch(const PagedPool& pool, const DecodeArgs& a,
                                bool self, cudaStream_t stream) {
  if (a.G < 1 || a.G > kMaxDecodeGroup || pool.hd > kMaxHeadDim ||
      a.splits < 1)
    return cudaErrorInvalidValue;
  // a group of more than kDecodeRows rows is cut into balanced row slices
  // (12 -> 6 + 6), each its own block reading the same keys
  DecodeArgs args = a;
  args.g_slices = (a.G + kDecodeRows - 1) / kDecodeRows;
  args.g_rows = (a.G + args.g_slices - 1) / args.g_slices;
  switch (pool.dtype) {
    case KVDtype::kFloat32: return decode_t<float>(pool, args, self, stream);
    case KVDtype::kBFloat16: return decode_t<bf16>(pool, args, self, stream);
    case KVDtype::kInt8: return decode_t<int8_t>(pool, args, self, stream);
  }
  return cudaErrorInvalidValue;
}

cudaError_t paged_prefill_launch(const PagedPool& pool,
                                 const PrefillArgs& args,
                                 cudaStream_t stream) {
  if (pool.hd > kMaxHeadDim) return cudaErrorInvalidValue;
  switch (pool.dtype) {
    case KVDtype::kFloat32: return prefill_hd<float>(pool, args, stream);
    case KVDtype::kBFloat16: return prefill_hd<bf16>(pool, args, stream);
    case KVDtype::kInt8: return prefill_hd<int8_t>(pool, args, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace repro_torch
