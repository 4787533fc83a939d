// Packed low-bit weight x activation matmul for Hopper (sm_90a), on the
// bf16 tensor cores, with the affine dequant epilogue in the kernel.
//
// Replaces the Pallas TPU kernel repro/kernels/quant_matmul/kernel.py
// (quant_matmul_kernel / _qmm_kernel) and the epilogue of its ops.py.
// Computes
//
//     acc[b, j] = sum_k x[b, k] * code[k, j]
//     out[b, j] = acc[b, j]                                (epilogue off)
//     out[b, j] = (2 s / maxq) acc[b, j] - s sum_k x[b, k]  (epilogue on)
//
// with b-bit codes packed along K (value k = kp*vals + v lives in bits
// [bits*v, bits*(v+1)) of word packed[kp, j]), s read from the device.
//
// Arithmetic.  The codes 0..maxq (maxq <= 255) are exact in bf16, so they
// feed mma.m16n8k16 (bf16 in, fp32 accumulate) unchanged.  A bf16 x is one
// exact term.  An fp32 x is split into bf16 terms, x = hi + mid + lo:
// hi + mid leaves |x - hi - mid| <= 2^-16 |x| (two bf16 roundings of 2^-8
// each), hi + mid + lo is exact.  The kernel's own gate is
// |err| <= K 2^-24 sum_k |x q| (the fp32 sum in any order), so two terms
// keep it, with the tensor cores' fp32 accumulation, when
// 2^-16 <= K 2^-24 / 4, i.e. K >= 1024 (20x headroom at K = 5120); below
// that three terms are used.
//
// Two regimes in one source:
//
//  * rows <= 16 (decode): operands swapped, so that no row is padded: the
//    codes are the mma's A operand (16 output columns x 16 k) and x^T the
//    B operand (16 k x 8 rows).  A pair of codes (k, k+1) of a column
//    always lies in one word (vals is even, k is even), so a thread unpacks
//    its fragment straight from the word to a bf16 pair: OR the two codes
//    into the mantissa of 128.0 (bf16 0x4300 | c is 128 + c) and subtract
//    128; 8-bit codes convert through fp32.  At 2 bits the mma's k slots
//    take the codes in an order that puts each pair 16 bits apart in the
//    word (code_frag), so a pair costs a shift, a mask and the subtract;
//    x is split into its terms in the same order.  Codes and x stream
//    through a three-stage cp.async ring (16 packed rows of 256 columns a
//    stage, 8 warps); K is split over blocks when the column tiles alone
//    cannot fill the card (attn.wk/wv: M = 1024).  Bound by reading the
//    codes once.
//  * rows > 16 (prefill): a tiled GEMM, 64 or 128 rows x 256 columns a
//    block (8 or 16 warps of 64 x 32), 64 k a stage (80 at 3 bits, a whole
//    number of 10-code words), x and codes through a two-slot cp.async
//    ring; the fp32 x tile is split into its bf16 terms once per stage in
//    shared memory and read with ldmatrix.  Each code word is read once
//    per 128 rows, each x value once per 256 columns.  Bound by the tensor
//    cores' rate times the number of terms.
//
// Work units (qmm_plan): output tiles fill whole waves of resident blocks
// undivided; the tiles of the last, partial wave (all tiles when there are
// fewer than a wave) are split in K, so that they spread over SMs that
// would otherwise idle.  Splits are reduced in the kernel: every block of a
// split tile writes its partial sums (and row sums) to scratch, counts
// itself in on the tile's counter, and the last one sums the partials in
// split order 0, 1, ..., so two launches on the same inputs give
// bit-identical output.
#include "quant_matmul.h"

#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;
using repro_torch::QmmArgs;
using repro_torch::QmmPlan;

constexpr int D_NST = 3;           // decode: ring stages
constexpr int D_WARPS = 8;         // decode: warps per block
constexpr int D_THREADS = 32 * D_WARPS;
constexpr int D_BN = 256;          // decode: columns per block (32 a warp)
constexpr int D_WORDS = 16;        // decode: packed rows per stage
constexpr int P_NST = 2;           // prefill: ring stages
constexpr int P_WN = 8;            // prefill: warps along the columns
constexpr int P_BN = 32 * P_WN;    // prefill: columns per block (32 a warp)
constexpr int TPAD = 8;            // row padding of the bf16 term tiles

// row length of a raw x tile in the ring: padded by 16 bytes
template <typename XT>
constexpr int raw_ld(int kstep) { return kstep + 16 / (int)sizeof(XT); }

// ---------------------------------------------------------------------------
// PTX helpers (as in paged_attention.cu)
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16- and 4-byte asynchronous copies global -> shared; an invalid source
// writes zeros
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

// c += a (16x16 bf16, row) * b (16x8 bf16, col), fp32 accumulate
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ __nv_bfloat162 as_bf2(uint32_t v) {
  return *reinterpret_cast<__nv_bfloat162*>(&v);
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ bf16 zero<bf16>() { return __float2bfloat16_rn(0.f); }

// ---------------------------------------------------------------------------
// Codes and terms
// ---------------------------------------------------------------------------

// Codes pos and pos+1 of word w (pos even) as a bf16 pair, exact.
template <int BITS>
__device__ __forceinline__ uint32_t code_pair(uint32_t w, int pos) {
  constexpr uint32_t MASK = (1u << BITS) - 1u;
  const uint32_t s = w >> (BITS * pos);
  if constexpr (BITS == 8) {
    return as_u32(__floats2bfloat162_rn(static_cast<float>(s & MASK),
                                        static_cast<float>((s >> 8) & MASK)));
  } else {
    const uint32_t v = (s & MASK) | ((s << (16 - BITS)) & (MASK << 16)) |
                       0x43004300u;
    return as_u32(__hsub2(as_bf2(v), as_bf2(0x43004300u)));
  }
}

// 2-bit codes at bits (0, 1) and (16, 17) of v -> the bf16 pair, exact
__device__ __forceinline__ uint32_t magic_pair(uint32_t v) {
  return as_u32(__hsub2(as_bf2((v & 0x00030003u) | 0x43004300u),
                        as_bf2(0x43004300u)));
}

// A thread's code fragment of column word(s) c at k16 step s of a stage
// (ws: the stage's words, rows of ldw): lo = mma k slots (2t, 2t+1), hi =
// slots (2t+8, 2t+9).  At 2 bits one word holds the step's 16 codes and the
// slots take the codes in the order of k_slot_2bit: lo = codes (2t, 2t+8),
// hi = (2t+1, 2t+9), each pair 16 bits apart in the word (one shift and
// one mask); x is written in the same order (split_row), so the products
// are the same.  Other widths: slots in code order, pairs read by position.
template <int BITS>
__device__ __forceinline__ void code_frag(const uint32_t* ws, int ldw, int c,
                                          int s, int t, uint32_t& lo,
                                          uint32_t& hi) {
  if constexpr (BITS == 2) {
    const uint32_t w = ws[s * ldw + c] >> (4 * t);
    lo = magic_pair(w);
    hi = magic_pair(w >> 2);
  } else {
    constexpr int VALS = 32 / BITS;
    const int k = s * 16 + 2 * t;
    const int wr0 = k / VALS, p0 = k - wr0 * VALS;
    const int wr1 = (k + 8) / VALS, p1 = k + 8 - wr1 * VALS;
    lo = code_pair<BITS>(ws[wr0 * ldw + c], p0);
    hi = code_pair<BITS>(ws[wr1 * ldw + c], p1);
  }
}

// (x0, x1) -> TERMS packed bf16 pairs with x = t[0] + t[1] + ... (exact at
// three terms); the residual of each term is exact in fp32
template <int TERMS>
__device__ __forceinline__ void split_pair(float x0, float x1,
                                           uint32_t (&t)[TERMS]) {
#pragma unroll
  for (int i = 0; i < TERMS; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    t[i] = as_u32(h);
    const float2 hf = __bfloat1622float2(h);
    x0 -= hf.x;
    x1 -= hf.y;
  }
}

// One raw x row of a stage (n values at xr) -> TERMS bf16 rows at tr (term
// q at tr + q * tstride), in the mma's k-slot order, by the 32 lanes of a
// warp; returns the lane's share of the row's sum.  At 2 bits lane pair p
// takes codes (i, i+8) of 16-value group p/8, i = p%8, and writes them to
// slots (i, i+1) for even i, (i+7, i+8) for odd i (code_frag's order).
template <typename XT, int BITS, int TERMS>
__device__ __forceinline__ float split_row(const XT* xr, bf16* tr,
                                           int tstride, int n, int lane) {
  float sum = 0.f;
  for (int p = lane; p < n / 2; p += 32) {
    int src0, src1, dst;
    if constexpr (BITS == 2) {
      const int i = p & 7;
      src0 = (p >> 3) * 16 + i;
      src1 = src0 + 8;
      dst = src0 + ((i & 1) ? 7 : 0);
    } else {
      src0 = 2 * p;
      src1 = src0 + 1;
      dst = src0;
    }
    const float x0 = to_f(xr[src0]), x1 = to_f(xr[src1]);
    sum += x0;
    sum += x1;
    uint32_t tt[TERMS];
    split_pair<TERMS>(x0, x1, tt);
#pragma unroll
    for (int q = 0; q < TERMS; ++q)
      *reinterpret_cast<uint32_t*>(tr + q * tstride + dst) = tt[q];
  }
  return sum;
}

// the sum over the 32 lanes of a warp (a fixed shuffle tree)
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// ---------------------------------------------------------------------------
// Copies of one stage
// ---------------------------------------------------------------------------

// rows x kstep values of x from (row0, k0) into xs (rows of `ld`
// elements); past B or K reads zero.  16-byte copies when every row starts
// 16-byte aligned (vec), else element by element.
template <typename XT>
__device__ __forceinline__ void load_x(const QmmArgs& a, int row0, int k0,
                                       int rows, int kstep, XT* xs, int ld,
                                       bool vec, int tid, int nthreads) {
  const XT* x = static_cast<const XT*>(a.x);
  if (vec) {
    constexpr int E = 16 / sizeof(XT);
    const int per_row = kstep / E;
    for (int c = tid; c < rows * per_row; c += nthreads) {
      const int r = c / per_row, kk = (c - r * per_row) * E;
      const int b = row0 + r, k = k0 + kk;
      const bool ok = b < a.B && k < a.K;
      cp_async16(xs + r * ld + kk, ok ? x + (size_t)b * a.K + k : x, ok);
    }
  } else {
    for (int e = tid; e < rows * kstep; e += nthreads) {
      const int r = e / kstep, kk = e - r * kstep;
      const int b = row0 + r, k = k0 + kk;
      xs[r * ld + kk] = b < a.B && k < a.K ? x[(size_t)b * a.K + k]
                                           : zero<XT>();
    }
  }
}

// words packed rows w0 .. w0+nw-1 x bn columns from col0 into ws (rows of
// bn words); past Kp or M reads zero
__device__ __forceinline__ void load_codes(const QmmArgs& a, int Kp, int w0,
                                           int nw, int col0, int bn,
                                           uint32_t* ws, bool vec, int tid,
                                           int nthreads) {
  if (vec) {
    const int per_row = bn / 4;
    for (int c = tid; c < nw * per_row; c += nthreads) {
      const int r = c / per_row, jj = (c - r * per_row) * 4;
      const int w = w0 + r, j = col0 + jj;
      const bool ok = w < Kp && j < a.M;
      cp_async16(ws + r * bn + jj,
                 ok ? a.packed + (size_t)w * a.M + j : a.packed, ok);
    }
  } else {
    for (int e = tid; e < nw * bn; e += nthreads) {
      const int r = e / bn, jj = e - r * bn;
      const int w = w0 + r, j = col0 + jj;
      const bool ok = w < Kp && j < a.M;
      cp_async4(ws + e, ok ? a.packed + (size_t)w * a.M + j : a.packed, ok);
    }
  }
}

// ---------------------------------------------------------------------------
// Work units and the end of a block: store, or reduce the K splits
// ---------------------------------------------------------------------------

// What block u computes: units 0 .. full-1 are whole tiles (tile u, all of
// K); the rest split each remaining tile into `splits` K ranges (slot: the
// tile's index among the split ones, which owns its counter and scratch).
struct Work {
  int tile, slot, split, splits, kb, ke;
};

__device__ __forceinline__ Work work_of(int u, const QmmPlan& p, int K) {
  Work w;
  if (u < p.full) {
    w.tile = u;
    w.slot = 0;
    w.split = 0;
    w.splits = 1;
    w.kb = 0;
    w.ke = K;
  } else {
    const int v = u - p.full;
    w.slot = v / p.splits;
    w.tile = p.full + w.slot;
    w.split = v - w.slot * p.splits;
    w.splits = p.splits;
    w.kb = w.split * p.k_per_split;
    w.ke = min(K, w.kb + p.k_per_split);
  }
  return w;
}

__device__ __forceinline__ void store_out(const QmmArgs& a, int b, int j,
                                          float acc, float rs, float c,
                                          float s) {
  const size_t i = (size_t)b * a.M + j;
  if (a.s == nullptr)
    static_cast<float*>(a.out)[i] = acc;
  else if (a.out_bf16)
    static_cast<bf16*>(a.out)[i] = __float2bfloat16_rn(acc * c - s * rs);
  else
    static_cast<float*>(a.out)[i] = acc * c - s * rs;
}

// Count the block in on its tile; true for the tile's last block, which
// then sees every other block's partials.
__device__ __forceinline__ bool last_of_tile(const QmmArgs& a, int slot,
                                             int splits, int* flag) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const int prev = atomicAdd(a.counters + slot, 1);
    *flag = prev == splits - 1;
    if (*flag) a.counters[slot] = 0;  // ready for the next launch
  }
  __syncthreads();
  if (!*flag) return false;
  __threadfence();
  return true;
}

// A split block's partial sums (bm x bn, the tile's own layout) and row
// sums go to the scratch of its slot.
__device__ __forceinline__ float* part_of(const QmmArgs& a, const Work& w,
                                          int bm, int bn) {
  return a.part + ((size_t)w.slot * w.splits + w.split) * bm * bn;
}

// The last block of a tile: sum the splits' partials in split order and
// apply the epilogue, one output element per thread step (coalesced).  The
// rows' sums over the splits go to rs_tile (shared, bm long) first.
__device__ __forceinline__ void reduce_tile(const QmmArgs& a, const Work& w,
                                            int row0, int bm, int col0,
                                            int bn, int nthreads,
                                            float* rs_tile) {
  float c = 0.f, s = 0.f;
  const size_t base = (size_t)w.slot * w.splits;
  if (a.s != nullptr) {
    s = *a.s;
    c = (2.f * s) / static_cast<float>(a.maxq);
    if (static_cast<int>(threadIdx.x) < bm) {
      float rs = 0.f;
      for (int sp = 0; sp < w.splits; ++sp)
        rs += __ldcg(a.rs_part + (base + sp) * bm + threadIdx.x);
      rs_tile[threadIdx.x] = rs;
    }
    __syncthreads();
  }
  for (int e = threadIdx.x; e < bm * bn; e += nthreads) {
    const int r = e / bn, cl = e - r * bn, j = col0 + cl, b = row0 + r;
    if (b >= a.B || j >= a.M) continue;
    float acc = 0.f;
    for (int sp = 0; sp < w.splits; ++sp)
      acc += __ldcg(a.part + (base + sp) * bm * bn + e);
    store_out(a, b, j, acc, a.s != nullptr ? rs_tile[r] : 0.f, c, s);
  }
}

// ---------------------------------------------------------------------------
// Decode: rows <= 16, codes as the A operand
// ---------------------------------------------------------------------------

// One block per (256 columns, K split): warp w owns columns w*32 .. +32
// (two 16-column A tiles), every warp the block's R = 8*NR rows of x (NR
// 8-row B tiles, zero past B).  Each stage's raw x rows are split into
// their bf16 terms once (warp w splits rows w, w+8, and sums them); a
// thread's A fragment is code_frag of columns c and c+8, its B fragment the
// same k slots of x row g.
template <typename XT, int BITS, int NR, int TERMS>
__global__ void __launch_bounds__(D_THREADS)
qmm_rows16_kernel(QmmArgs a, QmmPlan p, bool vec_x, bool vec_w) {
  constexpr int VALS = 32 / BITS, KSTEP = D_WORDS * VALS;
  constexpr int R = 8 * NR, LDR = raw_ld<XT>(KSTEP), TLD = KSTEP + TPAD;
  constexpr int X_BYTES = R * LDR * sizeof(XT);
  constexpr int SLOT = X_BYTES + D_WORDS * D_BN * 4;
  constexpr int TSTRIDE = R * TLD;
  static_assert(X_BYTES % 16 == 0, "16-byte aligned ring slots");
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* terms = reinterpret_cast<bf16*>(smem + D_NST * SLOT);
  __shared__ float rs_s[R];
  __shared__ int flag;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const Work wk = work_of(blockIdx.x, p, a.K);
  const int col0 = wk.tile * D_BN;
  const int Kp = (a.K + VALS - 1) / VALS;
  const int kb = wk.kb, ke = wk.ke;
  const int n_st = ke > kb ? (ke - kb + KSTEP - 1) / KSTEP : 0;

  auto slot_x = [&](int st) {
    return reinterpret_cast<XT*>(smem + (st % D_NST) * SLOT);
  };
  auto slot_w = [&](int st) {
    return reinterpret_cast<uint32_t*>(smem + (st % D_NST) * SLOT +
                                       X_BYTES);
  };
  auto issue = [&](int st) {
    const int k0 = kb + st * KSTEP;
    load_x<XT>(a, 0, k0, R, KSTEP, slot_x(st), LDR, vec_x, tid, D_THREADS);
    load_codes(a, Kp, k0 / VALS, D_WORDS, col0, D_BN, slot_w(st), vec_w, tid,
               D_THREADS);
  };
#pragma unroll
  for (int st = 0; st < D_NST - 1; ++st) {
    if (st < n_st) issue(st);
    cp_commit();
  }

  float acc[2][NR][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int r = 0; r < NR; ++r)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][r][e] = 0.f;
  float rsum[NR];
#pragma unroll
  for (int r = 0; r < NR; ++r) rsum[r] = 0.f;
  const int wcol = warp * 32;

  for (int i = 0; i < n_st; ++i) {
    cp_wait<D_NST - 2>();
    __syncthreads();  // stage i landed; stage i-1's readers are done
    if (i + D_NST - 1 < n_st) issue(i + D_NST - 1);
    cp_commit();
    const XT* xs = slot_x(i);
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      const int row = warp + 8 * r;
      rsum[r] += split_row<XT, BITS, TERMS>(xs + row * LDR, terms + row * TLD,
                                            TSTRIDE, KSTEP, lane);
    }
    __syncthreads();
    const uint32_t* ws = slot_w(i);
#pragma unroll
    for (int s = 0; s < KSTEP / 16; ++s) {
      uint32_t xb[NR][TERMS][2];
#pragma unroll
      for (int r = 0; r < NR; ++r)
#pragma unroll
        for (int q = 0; q < TERMS; ++q) {
          const bf16* tr = terms + q * TSTRIDE + (r * 8 + g) * TLD + s * 16 +
                           2 * t;
          xb[r][q][0] = *reinterpret_cast<const uint32_t*>(tr);
          xb[r][q][1] = *reinterpret_cast<const uint32_t*>(tr + 8);
        }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int c = wcol + mt * 16 + g;
        uint32_t af[4];
        code_frag<BITS>(ws, D_BN, c, s, t, af[0], af[2]);
        code_frag<BITS>(ws, D_BN, c + 8, s, t, af[1], af[3]);
#pragma unroll
        for (int r = 0; r < NR; ++r)
#pragma unroll
          for (int q = 0; q < TERMS; ++q)
            mma(acc[mt][r], af, xb[r][q][0], xb[r][q][1]);
      }
    }
  }
  cp_wait<0>();

#pragma unroll
  for (int r = 0; r < NR; ++r) {
    const float v = warp_sum(rsum[r]);
    if (lane == 0) rs_s[warp + 8 * r] = v;
  }
  __syncthreads();

  // C fragment: e = 0, 1 column c, rows 2t, 2t+1; e = 2, 3 column c+8
  if (wk.splits == 1) {
    float s = 0.f, cf = 0.f;
    if (a.s != nullptr) {
      s = *a.s;
      cf = (2.f * s) / static_cast<float>(a.maxq);
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int r = 0; r < NR; ++r)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = col0 + wcol + mt * 16 + g + (e >= 2 ? 8 : 0);
          const int b = r * 8 + 2 * t + (e & 1);
          if (b < a.B && j < a.M)
            store_out(a, b, j, acc[mt][r][e], rs_s[b], cf, s);
        }
    return;
  }
  float* part = part_of(a, wk, R, D_BN);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int r = 0; r < NR; ++r)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int cl = wcol + mt * 16 + g + (e >= 2 ? 8 : 0);
        const int b = r * 8 + 2 * t + (e & 1);
        if (b < a.B) part[b * D_BN + cl] = acc[mt][r][e];
      }
  if (a.s != nullptr && tid < R)
    a.rs_part[((size_t)wk.slot * wk.splits + wk.split) * R + tid] = rs_s[tid];
  if (!last_of_tile(a, wk.slot, wk.splits, &flag)) return;
  reduce_tile(a, wk, 0, R, col0, D_BN, D_THREADS, rs_s);
}

// ---------------------------------------------------------------------------
// Prefill: rows > 16, a tiled GEMM
// ---------------------------------------------------------------------------

// One block per (BM = 64*WM rows, 256 columns, K split); warp (wm, wn)
// owns rows wm*64 .. +64 (four 16-row A tiles) and columns wn*32 .. +32
// (four 8-column B tiles).  Each stage's x tile lands raw (fp32 or bf16)
// in a two-slot ring; warp w splits rows w, w + NWARPS, ... into TERMS
// bf16 tiles in k-slot order (and sums them), which the warps read with
// ldmatrix.  A thread's B fragment is code_frag of column c.
template <typename XT, int BITS, int TERMS, int WM>
__global__ void __launch_bounds__(32 * P_WN * WM, 2 / WM)
qmm_tiled_kernel(QmmArgs a, QmmPlan p, bool vec_x, bool vec_w) {
  constexpr int NWARPS = P_WN * WM, NT = 32 * NWARPS, BM = 64 * WM;
  constexpr int VALS = 32 / BITS, KSTEP = BITS == 3 ? 80 : 64;
  constexpr int NW = KSTEP / VALS, LDR = raw_ld<XT>(KSTEP);
  constexpr int TLD = KSTEP + TPAD, TSTRIDE = BM * TLD;
  constexpr int X_BYTES = BM * LDR * sizeof(XT);
  constexpr int SLOT = X_BYTES + NW * P_BN * 4;
  constexpr int RPW = BM / NWARPS;  // x rows a warp splits
  static_assert(KSTEP % VALS == 0 && X_BYTES % 16 == 0, "aligned stages");
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* terms = reinterpret_cast<bf16*>(smem + P_NST * SLOT);
  __shared__ float rs_s[BM];
  __shared__ int flag;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / P_WN, wn = warp % P_WN;
  const Work wk = work_of(blockIdx.x, p, a.K);
  const int tb = wk.tile / p.tiles_n;
  const int col0 = (wk.tile - tb * p.tiles_n) * P_BN, row0 = tb * BM;
  const int Kp = (a.K + VALS - 1) / VALS;
  const int kb = wk.kb, ke = wk.ke;
  const int n_st = ke > kb ? (ke - kb + KSTEP - 1) / KSTEP : 0;

  auto slot_x = [&](int st) {
    return reinterpret_cast<XT*>(smem + (st % P_NST) * SLOT);
  };
  auto slot_w = [&](int st) {
    return reinterpret_cast<uint32_t*>(smem + (st % P_NST) * SLOT +
                                       X_BYTES);
  };
  auto issue = [&](int st) {
    const int k0 = kb + st * KSTEP;
    load_x<XT>(a, row0, k0, BM, KSTEP, slot_x(st), LDR, vec_x, tid, NT);
    load_codes(a, Kp, k0 / VALS, NW, col0, P_BN, slot_w(st), vec_w, tid, NT);
  };
#pragma unroll
  for (int st = 0; st < P_NST - 1; ++st) {
    if (st < n_st) issue(st);
    cp_commit();
  }

  float acc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
  float rsum[RPW];
#pragma unroll
  for (int r = 0; r < RPW; ++r) rsum[r] = 0.f;

  for (int i = 0; i < n_st; ++i) {
    cp_wait<P_NST - 2>();
    __syncthreads();  // stage i landed; the last stage's products are done
    if (i + P_NST - 1 < n_st) issue(i + P_NST - 1);
    cp_commit();
    const XT* xs = slot_x(i);
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const int row = warp + NWARPS * r;
      rsum[r] += split_row<XT, BITS, TERMS>(xs + row * LDR, terms + row * TLD,
                                            TSTRIDE, KSTEP, lane);
    }
    __syncthreads();
    const uint32_t* ws = slot_w(i);
#pragma unroll
    for (int s = 0; s < KSTEP / 16; ++s) {
      uint32_t bfr[4][2];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        code_frag<BITS>(ws, P_BN, wn * 32 + nt * 8 + g, s, t, bfr[nt][0],
                        bfr[nt][1]);
#pragma unroll
      for (int q = 0; q < TERMS; ++q) {
        uint32_t af[4][4];
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
          ldsm_x4(af[mt], terms + q * TSTRIDE +
                              (wm * 64 + mt * 16 + (lane & 15)) * TLD +
                              s * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            mma(acc[mt][nt], af[mt], bfr[nt][0], bfr[nt][1]);
      }
    }
  }
  cp_wait<0>();

#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const float v = warp_sum(rsum[r]);
    if (lane == 0) rs_s[warp + NWARPS * r] = v;
  }
  __syncthreads();

  // C fragment: e = 0, 1 row g, columns 2t, 2t+1; e = 2, 3 row g+8
  if (wk.splits == 1) {
    float s = 0.f, cf = 0.f;
    if (a.s != nullptr) {
      s = *a.s;
      cf = (2.f * s) / static_cast<float>(a.maxq);
    }
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = wm * 64 + mt * 16 + g + (e >= 2 ? 8 : 0);
          const int j = col0 + wn * 32 + nt * 8 + 2 * t + (e & 1);
          if (row0 + r < a.B && j < a.M)
            store_out(a, row0 + r, j, acc[mt][nt][e], rs_s[r], cf, s);
        }
    return;
  }
  float* part = part_of(a, wk, BM, P_BN);
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = wm * 64 + mt * 16 + g + (e >= 2 ? 8 : 0);
        const int cl = wn * 32 + nt * 8 + 2 * t + (e & 1);
        if (row0 + r < a.B) part[r * P_BN + cl] = acc[mt][nt][e];
      }
  if (a.s != nullptr && tid < BM)
    a.rs_part[((size_t)wk.slot * wk.splits + wk.split) * BM + tid] = rs_s[tid];
  if (!last_of_tile(a, wk.slot, wk.splits, &flag)) return;
  reduce_tile(a, wk, row0, BM, col0, P_BN, NT, rs_s);
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

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

template <typename XT, int BITS, int NR, int TERMS>
cudaError_t launch_rows16(const QmmPlan& p, const QmmArgs& a, bool vx,
                          bool vw, cudaStream_t st) {
  constexpr int KSTEP = D_WORDS * (32 / BITS), R = 8 * NR;
  constexpr int SMEM =
      D_NST * (R * raw_ld<XT>(KSTEP) * (int)sizeof(XT) + D_WORDS * D_BN * 4) +
      TERMS * R * (KSTEP + TPAD) * 2;
  static unsigned done = 0;
  const cudaError_t err =
      allow_smem(qmm_rows16_kernel<XT, BITS, NR, TERMS>, SMEM, &done);
  if (err != cudaSuccess) return err;
  qmm_rows16_kernel<XT, BITS, NR, TERMS>
      <<<p.units, D_THREADS, SMEM, st>>>(a, p, vx, vw);
  return cudaGetLastError();
}

template <typename XT, int BITS, int TERMS, int WM>
cudaError_t launch_tiled(const QmmPlan& p, const QmmArgs& a, bool vx,
                         bool vw, cudaStream_t st) {
  constexpr int KSTEP = BITS == 3 ? 80 : 64, BM = 64 * WM;
  constexpr int SMEM =
      P_NST * (BM * raw_ld<XT>(KSTEP) * (int)sizeof(XT) +
               KSTEP / (32 / BITS) * P_BN * 4) +
      TERMS * BM * (KSTEP + TPAD) * 2;
  static unsigned done = 0;
  const cudaError_t err =
      allow_smem(qmm_tiled_kernel<XT, BITS, TERMS, WM>, SMEM, &done);
  if (err != cudaSuccess) return err;
  qmm_tiled_kernel<XT, BITS, TERMS, WM>
      <<<p.units, 32 * P_WN * WM, SMEM, st>>>(a, p, vx, vw);
  return cudaGetLastError();
}

template <typename XT, int BITS, int TERMS>
cudaError_t tiled_rows(const QmmPlan& p, const QmmArgs& a, bool vx, bool vw,
                       cudaStream_t st) {
  return p.bm == 64 ? launch_tiled<XT, BITS, TERMS, 1>(p, a, vx, vw, st)
                    : launch_tiled<XT, BITS, TERMS, 2>(p, a, vx, vw, st);
}

template <typename XT, int BITS>
cudaError_t launch_bits(const QmmPlan& p, const QmmArgs& a, bool vx,
                        bool vw, cudaStream_t st) {
  constexpr bool F32 = std::is_same<XT, float>::value;
  if (p.rows16) {
    if constexpr (F32) {
      if (p.terms == 3)
        return p.bm == 8 ? launch_rows16<float, BITS, 1, 3>(p, a, vx, vw, st)
                         : launch_rows16<float, BITS, 2, 3>(p, a, vx, vw, st);
      return p.bm == 8 ? launch_rows16<float, BITS, 1, 2>(p, a, vx, vw, st)
                       : launch_rows16<float, BITS, 2, 2>(p, a, vx, vw, st);
    } else {
      return p.bm == 8 ? launch_rows16<bf16, BITS, 1, 1>(p, a, vx, vw, st)
                       : launch_rows16<bf16, BITS, 2, 1>(p, a, vx, vw, st);
    }
  }
  if constexpr (F32) {
    if (p.terms == 3) return tiled_rows<float, BITS, 3>(p, a, vx, vw, st);
    return tiled_rows<float, BITS, 2>(p, a, vx, vw, st);
  } else {
    return tiled_rows<bf16, BITS, 1>(p, a, vx, vw, st);
  }
}

template <typename XT>
cudaError_t launch_dtype(const QmmPlan& p, const QmmArgs& a, bool vx,
                         bool vw, cudaStream_t st) {
  switch (a.bits) {
    case 2: return launch_bits<XT, 2>(p, a, vx, vw, st);
    case 3: return launch_bits<XT, 3>(p, a, vx, vw, st);
    case 4: return launch_bits<XT, 4>(p, a, vx, vw, st);
    case 8: return launch_bits<XT, 8>(p, a, vx, vw, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

namespace repro_torch {

QmmPlan qmm_plan(int B, int K, int M, int bits, bool x_bf16, int sm_count) {
  QmmPlan p{};
  const int vals = 32 / bits;
  p.rows16 = B <= 16;
  if (p.rows16) {
    p.bm = B <= 8 ? 8 : 16;
    p.bn = D_BN;
    p.kstep = D_WORDS * vals;
  } else {
    p.bm = B <= 64 ? 64 : 128;
    p.bn = P_BN;
    p.kstep = bits == 3 ? 80 : 64;
  }
  p.terms = x_bf16 ? 1 : (K >= 1024 ? 2 : 3);
  p.tiles_n = (M + p.bn - 1) / p.bn;
  p.tiles_b = p.rows16 ? 1 : (B + p.bm - 1) / p.bm;
  // Blocks that fit the card at once (shared memory and registers fit two
  // decode blocks to an SM, one 128-row prefill block, two 64-row ones).
  // Tiles fill whole waves of them undivided; the last, partial wave's
  // tiles (all of them when there are fewer than one wave) are split in K
  // so that they spread over the idle SMs instead of running alone.
  const int tiles = p.tiles_n * p.tiles_b;
  const int nk = K > 0 ? (K + p.kstep - 1) / p.kstep : 1;
  const int fill = sm_count * (p.rows16 || p.bm == 64 ? 2 : 1);
  const int rem = tiles % fill;
  int want = 1;
  if (rem > 0 && p.rows16) {
    want = fill / rem;
  } else if (rem > 0) {
    // the split count whose waves of blocks finish soonest, each split
    // charged a little for its partial sums' traffic: 80 tiles on 132
    // slots take 3 splits, 8 tiles 7
    float best = 2.f;
    for (int sp = 1; sp <= 8; ++sp) {
      const float cost =
          static_cast<float>((rem * sp + fill - 1) / fill) / sp + 0.02f * sp;
      if (cost < best) {
        best = cost;
        want = sp;
      }
    }
  }
  if (want > nk) want = nk;
  const int per = (nk + want - 1) / want;
  p.splits = (nk + per - 1) / per;
  p.k_per_split = per * p.kstep;
  p.full = p.splits == 1 ? tiles : tiles - rem;
  p.units = p.full + (tiles - p.full) * p.splits;
  return p;
}

cudaError_t qmm_launch(const QmmPlan& plan, const QmmArgs& args,
                       cudaStream_t stream) {
  const size_t xe = args.x_bf16 ? 2 : 4;
  const bool vx = reinterpret_cast<uintptr_t>(args.x) % 16 == 0 &&
                  ((size_t)args.K * xe) % 16 == 0;
  const bool vw = reinterpret_cast<uintptr_t>(args.packed) % 16 == 0 &&
                  args.M % 4 == 0;
  return args.x_bf16 ? launch_dtype<bf16>(plan, args, vx, vw, stream)
                     : launch_dtype<float>(plan, args, vx, vw, stream);
}

}  // namespace repro_torch
