// Fused Kronecker-product transform y = (A kron B) x for Hopper (sm_90a),
// on the TF32 tensor cores.
//
// Replaces the Pallas TPU kernel repro/kernels/kron_mul/kernel.py
// (kron_mul_kernel / _kron_kernel).  For every row, with X the row read as
// a row-major (p, q) matrix:
//
//     T = X B^T   (p x q),   Y = A T   (p x q),   y = reshape(Y, p*q)
//
// It also takes what surrounds the transform in the incoherence
// processing (kron_mul.h): the permutation gather and the division by the
// diagonal rescale D are folded into the row's load, the inverse
// permutation into the store, and the transposed factors of the inverse
// transform are read in place (no index_select, division or copy launches
// around it).
//
// Precision: both products run as mma.sync m16n8k8 TF32 with each operand
// split into big = rna(v) and small = rna(v - big), rna the TF32 rounding
// of cvt.rna.tf32.f32 (to nearest, ties away from zero), three products
// small*big + big*small + big*big summed in fp32.  The split keeps 22 of
// fp32's 24 significant bits of every operand and the dropped small*small
// term is below 2^-22 of the product, so each output is off by a few
// 2^-22 of (|A| kron |B|)|x| plus the fp32 sums' own rounding: 0.4-5 % of
// the gate the plain fp32 version is held to, 2 (p + q + 1) 2^-24
// (|A| kron |B|)|x| (chip_smoke.py; emulated on the CPU in
// tests/test_torch_kron_split.py).  LDLQ's codes depend on these values
// (the incoherence processing of W and H runs here): one TF32 product
// would miss that gate (13x at 32 x 32), bf16 hi + lo splits take a
// quarter of it.  Every output is summed by one thread in a fixed order,
// so launches are bit-identical.  The division by D is x times the
// correctly rounded 1 / D, within one ulp of the plain division.
//
// What bounds it: bytes.  A row moves 8 p q bytes and costs 2 p q (p + q)
// flops counted once, (p + q) / 4 flops per byte: 16-66 at the qwen3-14b
// shapes, below the TF32 tensor cores' ridge (495 TFLOP/s over 3.35 TB/s,
// 148 flops per byte).  With the three products the kernel runs, 128 x 136
// (198) is above it and the narrower shapes stay below.
//
// Design: a block walks work items (persistent); an item is one row and a
// slice C of the q output columns.  Columns split exactly: Y[:, C] =
// A (X B^T[:, C]), so a slice needs the whole row X and all of A but only
// its own rows of B, and T never leaves the block.  Rows that fill the
// card take whole rows (one slice); decode's 8 rows take slices (8 x 9
// items of 16 columns at q = 136).  Compute warps tile X, T and Y by 32
// rows (two m-tiles, p padded to 16 with zeros, q to 8) and by column
// groups:
//   - the factors stay resident in shared memory (A whole, B's slice);
//   - the row X arrives by cp.async, into one of two buffers while the
//     previous row computes where two fit; with a permutation it is read
//     in order and written to its permuted place (coalesced reads);
//   - T = X B^T accumulates in registers, goes to the row's buffer
//     transposed (the B operand of the second product), and Y = A T
//     accumulates in registers and is stored, through the buffer when the
//     inverse permutation needs whole rows;
//   - a persistent block also holds inv_perm (16-bit) and 1 / D where they
//     fit, so no row waits on index loads;
//   - the block's 8 warps all copy rows in and out.
// Where A and a row do not fit one block's shared memory together (p > 128:
// 168 x 176, qwen2-72b's d_ff, needs 242 KB), a second layout leaves A in
// global memory and reads the second product's A fragments through the L1
// (kron_mul_kernel<2, NTW, true>): shared memory then holds the row, T^T and
// the B slice, and p pads to a multiple of 32 rows (two m-tiles per warp,
// up to 8 warps of rows); the rows past p read zeros.  The host's plan takes
// it only where no resident-A layout fits, so every shape that fitted keeps
// its layout.
// The mma's k slots (t, t+4) take the adjacent columns (2t, 2t+1), so
// every fragment is one 8-byte shared load; row strides of 8 mod 16 words
// keep those loads free of bank conflicts.  Operands are split into
// big + small in registers as they are loaded (each split fragment of the
// shared operand feeds both m-tiles), never stored split: the factors and
// a row do not fit shared memory twice over.
#include "kron_mul.h"

#include <stdint.h>

namespace {

using repro_torch::KronArgs;

// The shared-memory layout and warp grid of one launch (host-computed).
// Floats, in order: A (Pp rows of lda, when given and held), the B slice
// (rows_b rows of ldb), the reciprocal scale (rs floats, when held),
// inv_perm as 16-bit entries (is floats, when held), and nbuf row buffers
// of buf floats (X, then T^T, then Y).
struct Layout {
  int S;       // column slices per row, of rows_b columns
  int rows_b;  // columns per item, 8 NTW wc
  int wc;      // column groups of warps; warps = wc pw / (16 MT)
  int pw;      // rows of X, T and Y the warps cover (p padded to 16 MT)
  int ag;      // 1: A is read from global memory, not held
  int lda;     // row stride of A (p padded, 8 mod 16)
  int ldb;     // row stride of the B slice (q padded, 8 mod 16)
  int ldt;     // row stride of T^T (pw padded, 8 mod 16)
  int rs;      // floats of the reciprocal scale (0: not held)
  int is;      // floats of inv_perm held as 16-bit entries (0: not held)
  int buf;     // floats of one row buffer
  int nbuf;    // row buffers: 2 prefetch the next row, 1 does not
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// v rounded to TF32 (10 stored mantissa bits) to nearest, ties away from
// zero: the rounding of cvt.rna.tf32.f32, done as half a TF32 ulp added to
// the magnitude bits and the 13 low bits cleared.  The same bits for every
// finite v; PTX's cvt.rna compiles to four instructions that also pass NaN
// and infinity through, and made an earlier layout of this ALU-bound
// kernel 1.3x slower.
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

struct Split {
  uint32_t big, small;
};

__device__ __forceinline__ Split split(float v) {
  const uint32_t big = tf32_rna(v);
  return {big, tf32_rna(v - __uint_as_float(big))};
}

// an A-operand fragment (16 x 8) as big and small terms, from its rows g
// (lo) and g + 8 (hi) at k slots (t, t + 4) = columns (2t, 2t + 1)
struct AFrag {
  uint32_t big[4], small[4];
};

__device__ __forceinline__ AFrag split_a(float2 lo, float2 hi) {
  const Split s0 = split(lo.x), s1 = split(hi.x), s2 = split(lo.y),
              s3 = split(hi.y);
  return {{s0.big, s1.big, s2.big, s3.big},
          {s0.small, s1.small, s2.small, s3.small}};
}

// c += a (16x8 tf32, row) * b (8x8 tf32, col), fp32 accumulate
__device__ __forceinline__ void mma_tf32(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b in 3xTF32 (b0, b1 the fragment's k slots as big and small
// terms): small*big, big*small, then big*big
__device__ __forceinline__ void mma3(float (&c)[4], const AFrag& a,
                                     const Split& b0, const Split& b1) {
  mma_tf32(c, a.small, b0.big, b1.big);
  mma_tf32(c, a.big, b0.small, b1.small);
  mma_tf32(c, a.big, b0.big, b1.big);
}

// entry j of an int64 permutation, read through the read-only path
__device__ __forceinline__ int index_at(const int64_t* perm, int j) {
  return static_cast<int>(__ldg(reinterpret_cast<const long long*>(perm) + j));
}

// inv_perm[j], from its 16-bit copy in shared memory when held (each
// thread reads back the entries j = threadIdx.x + m * kThreads it wrote)
__device__ __forceinline__ int inv_at(const KronArgs& a, const uint16_t* Is,
                                      int j) {
  return Is != nullptr ? Is[j] : index_at(a.inv_perm, j);
}

// A'[r][k] (A, or A^T with trans) from global memory through the L1, zero
// outside p x p: the second product's operand in the layout that does not
// hold A
__device__ __forceinline__ float a_at(const KronArgs& a, int r, int k) {
  if (r >= a.p || k >= a.p) return 0.f;
  return __ldg(a.A + (a.trans ? k * a.p + r : r * a.p + k));
}

// two adjacent floats of shared memory (8-byte aligned unless q is odd)
__device__ __forceinline__ float2 ld2(const float* p, bool odd) {
  return odd ? make_float2(p[0], p[1])
             : *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

constexpr int kThreads = 256;  // every block: 8 warps
constexpr int kBatch = 8;      // independent global loads in flight a thread

// Copy row ``row`` of x into X (X[k] = x'[k], k = i q + t, unpadded), then
// zero [n, pad_end), which the products read past the row.  Without a
// scale, by cp.async: with a permutation, x is read in order and written
// to its permuted place, X[inv_perm[j]] = x[j] (coalesced reads), the
// indices of a batch loaded first.  With a scale (the forward transform),
// through registers: X[inv_perm[j]] = x[j] times the correctly rounded
// 1 / scale[j], within one ulp of the plain version's division.
__device__ __noinline__ void load_row(const KronArgs& a, const uint16_t* Is,
                                     int row, float* X, int pad_end,
                                     bool vec, bool divide) {
  const int n = a.p * a.q;
  const float* xr = a.x + static_cast<size_t>(row) * a.ldx;
  const bool gather = a.inv_perm != nullptr && !a.trans;
  if (divide) {
    for (int j0 = threadIdx.x; j0 < n; j0 += kBatch * kThreads) {
      float v[kBatch], d[kBatch];
      int k[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int j = j0 + u * kThreads;
        const bool in = j < n;
        v[u] = in ? __ldg(xr + j) : 0.f;
        d[u] = in ? __ldg(a.scale + j) : 1.f;
        k[u] = in && gather ? inv_at(a, Is, j) : j;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        if (j0 + u * kThreads < n) X[k[u]] = v[u] * __frcp_rn(d[u]);
    }
  } else if (gather) {
    for (int j0 = threadIdx.x; j0 < n; j0 += kBatch * kThreads) {
      int k[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int j = j0 + u * kThreads;
        k[u] = j < n ? inv_at(a, Is, j) : 0;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int j = j0 + u * kThreads;
        if (j < n) cp_async4(X + k[u], xr + j);
      }
    }
  } else if (vec) {
#pragma unroll 4
    for (int v = threadIdx.x; v < (n >> 2); v += kThreads)
      cp_async16(X + 4 * v, xr + 4 * v);
  } else {
#pragma unroll 4
    for (int j = threadIdx.x; j < n; j += kThreads)
      cp_async4(X + j, xr + j);
  }
  for (int e = n + threadIdx.x; e < pad_end; e += kThreads) X[e] = 0.f;
}

// Is[j] = inv_perm[j] (n < 65536), read back by the thread that wrote it
__device__ __noinline__ void fill_is(const KronArgs& a, uint16_t* Is) {
  const int n = a.p * a.q;
  for (int j0 = threadIdx.x; j0 < n; j0 += kBatch * kThreads) {
    int k[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int j = j0 + u * kThreads;
      k[u] = j < n ? index_at(a.inv_perm, j) : 0;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (j0 + u * kThreads < n) Is[j0 + u * kThreads] = k[u];
  }
}

// Held for a persistent block: Rs[k] = 1 / scale[perm[k]] (correctly
// rounded), and the rows come in by cp.async; x times it is within one ulp
// of the plain version's division.
__device__ __noinline__ void fill_rs(const KronArgs& a, const uint16_t* Is,
                                     float* Rs, int pad_end) {
  const int n = a.p * a.q;
  for (int j0 = threadIdx.x; j0 < n; j0 += kBatch * kThreads) {
    float d[kBatch];
    int k[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int j = j0 + u * kThreads;
      d[u] = j < n ? __ldg(a.scale + j) : 1.f;
      k[u] = j < n && a.inv_perm != nullptr ? inv_at(a, Is, j) : j;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (j0 + u * kThreads < n) Rs[k[u]] = __frcp_rn(d[u]);
  }
  for (int e = n + threadIdx.x; e < pad_end; e += kThreads) Rs[e] = 0.f;
}

// y[j] = Y[inv_perm[j]] for a row staged whole in Ys: coalesced stores,
// permuted shared reads
__device__ __noinline__ void store_staged(const KronArgs& a,
                                          const uint16_t* Is, float* yr,
                                          const float* Ys) {
  const int n = a.p * a.q;
  for (int j0 = threadIdx.x; j0 < n; j0 += kBatch * kThreads) {
    int k[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int j = j0 + u * kThreads;
      k[u] = j < n ? inv_at(a, Is, j) : 0;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int j = j0 + u * kThreads;
      if (j < n) yr[j] = Ys[k[u]];
    }
  }
}

// dst[r * ld + c] (or dst[c * ld + r] with ``trans``) = src[r * lds + c]
// for r < rows, c < cols, by cp.async (16 bytes where rows allow it)
__device__ __forceinline__ void copy_block(float* dst, int ld,
                                           const float* src, int lds,
                                           int rows, int cols, bool trans) {
  if (!trans && (cols & 3) == 0 && (lds & 3) == 0 &&
      (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int c4 = cols >> 2;
    for (int v = threadIdx.x; v < rows * c4; v += kThreads) {
      const int r = v / c4, c = 4 * (v - r * c4);
      cp_async16(dst + r * ld + c, src + static_cast<size_t>(r) * lds + c);
    }
  } else {
    for (int e = threadIdx.x; e < rows * cols; e += kThreads) {
      const int r = e / cols, c = e - r * cols;
      cp_async4(dst + (trans ? c * ld + r : r * ld + c),
                src + static_cast<size_t>(r) * lds + c);
    }
  }
}

// zero dst[r * ld + c] for r < R, c < C outside r < rows, c < cols
__device__ __forceinline__ void zero_pad(float* dst, int ld, int rows,
                                         int cols, int R, int C) {
  for (int e = threadIdx.x; e < (R - rows) * C; e += kThreads)
    dst[(rows + e / C) * ld + e % C] = 0.f;
  const int w = C - cols;
  for (int e = threadIdx.x; e < rows * w; e += kThreads)
    dst[(e / w) * ld + cols + e % w] = 0.f;
}

// MT: m-tiles of 16 rows per warp; NTW: n-tiles of 8 columns per warp;
// AG: A read from global memory (L.ag), not held in shared memory.
// Block: 8 warps, of which the first wc * pw / (16 MT) compute; compute
// warp w takes rows 16 MT (w % WR).. of X, T and Y (WR = pw / (16 MT)) and
// the slice's n-tiles w / WR + wc u, u < NTW.  Each fragment of the shared
// operand (B', then T) is split once and used by the warp's MT m-tiles.
// All 8 warps copy rows in and out.
template <int MT, int NTW, bool AG>
__global__ void __launch_bounds__(kThreads)
kron_mul_kernel(const KronArgs a, const Layout L) {
  extern __shared__ __align__(16) float sm[];
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  const int p = a.p, q = a.q, n = p * q;
  const int Pp = (p + 15) & ~15, Qp = (q + 7) & ~7;
  const int WR = L.pw / (16 * MT), warp = threadIdx.x >> 5;
  const bool computes = warp < WR * L.wc;
  const int r0 = 16 * MT * (warp % WR), nt0 = warp / WR;
  const int rows_b = L.rows_b;
  const bool has_a = a.A != nullptr, odd = q & 1;
  const int c0 = (blockIdx.x % L.S) * rows_b;  // the block's slice
  const int cols = min(q - c0, rows_b);
  float* As = sm;                             // As[j * lda + i] = A'[j][i]
  // Bs[c * ldb + t] = B'[c0 + c][t]
  float* Bs = As + (has_a && !AG ? Pp * L.lda : 0);
  float* Rs = Bs + rows_b * L.ldb;
  uint16_t* Is = L.is != 0 ? reinterpret_cast<uint16_t*>(Rs + L.rs) : nullptr;
  float* bufs = Rs + L.rs + L.is;
  const int pad_end = L.pw * q + 8;

  // The factors, resident for every item, zero-padded: A' = A or A^T and
  // B' = B or B^T (a transposed factor is read along its rows).
  if (has_a && !AG) {
    copy_block(As, L.lda, a.A, p, p, p, a.trans);
    zero_pad(As, L.lda, p, p, Pp, Pp);
  }
  if (a.trans)
    copy_block(Bs, L.ldb, a.B + c0, q, q, cols, true);
  else
    copy_block(Bs, L.ldb, a.B + static_cast<size_t>(c0) * q, q, cols, q,
               false);
  zero_pad(Bs, L.ldb, cols, q, rows_b, Qp);
  if (Is != nullptr) fill_is(a, Is);
  if (L.rs != 0) fill_rs(a, Is, Rs, pad_end);

  const bool vec = (n & 3) == 0 && (a.ldx & 3) == 0 &&
                   (reinterpret_cast<uintptr_t>(a.x) & 15) == 0;
  const bool divide = a.scale != nullptr && L.rs == 0;
  const bool scatter = a.perm != nullptr && a.trans;
  const int rstep = gridDim.x / L.S;  // the grid is a multiple of S
  int row = blockIdx.x / L.S;
  if (row < a.N) load_row(a, Is, row, bufs, pad_end, vec, divide);
  cp_commit();
  for (int it = 0; row < a.N; ++it, row += rstep) {
    // two buffers: the next row is copied in while this one computes
    float* X = bufs + (L.nbuf == 2 ? (it & 1) * L.buf : 0);
    const int next = row + rstep;
    if (L.nbuf == 2) {
      if (next < a.N)
        load_row(a, Is, next, bufs + ((it + 1) & 1) * L.buf, pad_end, vec,
                 divide);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();  // this row's X (and, first, the factors) in place

    // T[r0.., C] = X' B'^T[:, C], X' = X times Rs when held; slice columns
    // past q read zero rows of B'
    float acc[MT][NTW][4];
    if (computes) {
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int u = 0; u < NTW; ++u)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[m][u][e] = 0.f;
      const int xo = (r0 + g) * q + 2 * tq;
      const int bo = (8 * nt0 + g) * L.ldb + 2 * tq, bstep = 8 * L.wc * L.ldb;
      for (int k0 = 0; k0 < Qp; k0 += 8) {
        AFrag f[MT];
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const int o = xo + 16 * m * q + k0;
          float2 lo = ld2(X + o, odd), hi = ld2(X + o + 8 * q, odd);
          if (L.rs != 0) {
            const float2 rl = ld2(Rs + o, odd), rh = ld2(Rs + o + 8 * q, odd);
            lo = make_float2(lo.x * rl.x, lo.y * rl.y);
            hi = make_float2(hi.x * rh.x, hi.y * rh.y);
          }
          f[m] = split_a(lo, hi);
        }
#pragma unroll
        for (int u = 0; u < NTW; ++u) {
          const float2 b = ld2(Bs + bo + u * bstep + k0);
          const Split b0 = split(b.x), b1 = split(b.y);
#pragma unroll
          for (int m = 0; m < MT; ++m) mma3(acc[m][u], f[m], b0, b1);
        }
      }
    }
    if (has_a) {
      __syncthreads();  // every warp done with X: T^T takes its place
      float* Tt = X;    // Tt[c * ldt + i] = T[i][c0 + c]
      if (computes) {
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int u = 0; u < NTW; ++u)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              Tt[(8 * (nt0 + L.wc * u) + 2 * tq + (e & 1)) * L.ldt + r0 +
                 16 * m + g + 8 * (e >> 1)] = acc[m][u][e];
      }
      __syncthreads();
      // Y[r0.., C] = A' T[:, C]
      if (computes) {
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int u = 0; u < NTW; ++u)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[m][u][e] = 0.f;
        const int ao = (r0 + g) * L.lda + 2 * tq;
        const int to = (8 * nt0 + g) * L.ldt + 2 * tq,
                  tstep = 8 * L.wc * L.ldt;
        for (int k0 = 0; k0 < Pp; k0 += 8) {
          AFrag f[MT];
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            if constexpr (AG) {
              const int r = r0 + 16 * m + g, k = k0 + 2 * tq;
              f[m] = split_a(make_float2(a_at(a, r, k), a_at(a, r, k + 1)),
                             make_float2(a_at(a, r + 8, k),
                                         a_at(a, r + 8, k + 1)));
            } else {
              const int o = ao + 16 * m * L.lda + k0;
              f[m] = split_a(ld2(As + o), ld2(As + o + 8 * L.lda));
            }
          }
#pragma unroll
          for (int u = 0; u < NTW; ++u) {
            const float2 b = ld2(Tt + to + u * tstep + k0);
            const Split b0 = split(b.x), b1 = split(b.y);
#pragma unroll
            for (int m = 0; m < MT; ++m) mma3(acc[m][u], f[m], b0, b1);
          }
        }
      }
    }

    // acc[m][u][2h + v] = Y[r0 + 16m + g + 8h][c0 + 8 (nt0 + wc u) + 2tq + v]
    float* yr = a.y + static_cast<size_t>(row) * n;
    const bool staged = scatter && L.S == 1;
    float* Ys = X;
    if (staged) __syncthreads();  // every warp done with T^T: Y takes it
    if (computes) {
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int u = 0; u < NTW; ++u)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int j = r0 + 16 * m + g + 8 * h;
            const int c = 8 * (nt0 + L.wc * u) + 2 * tq;
            if (j >= p || c >= cols) continue;
            const float v0 = acc[m][u][2 * h], v1 = acc[m][u][2 * h + 1];
            const int k = j * q + c0 + c;
            const bool two = c + 1 < cols;
            if (staged) {
              Ys[k] = v0;
              if (two) Ys[k + 1] = v1;
            } else if (scatter) {  // y[perm[k]] = Y[k], slices of a row
              yr[index_at(a.perm, k)] = v0;
              if (two) yr[index_at(a.perm, k + 1)] = v1;
            } else if (!odd) {
              *reinterpret_cast<float2*>(yr + k) = make_float2(v0, v1);
            } else {
              yr[k] = v0;
              if (two) yr[k + 1] = v1;
            }
          }
    }
    if (staged) {
      __syncthreads();
      store_staged(a, Is, yr, Ys);
    }
    __syncthreads();  // this row's buffer is free for the next copy
    if (L.nbuf == 1 && next < a.N)
      load_row(a, Is, next, bufs, pad_end, vec, divide);
    if (L.nbuf == 1) cp_commit();
  }
}

using KernelFn = void (*)(KronArgs, Layout);

constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }

// the least multiple of 8 at or above v (a multiple of 8) that is 8 mod 16:
// 8-byte fragment loads of rows g = 0..3 then hit four disjoint bank groups
constexpr int conflict_free_ld(int v) { return v % 16 == 8 ? v : v + 8; }

// per-warp n-tile counts compiled (kron_mul_kernel<MT, NTW, AG>)
constexpr int kNtw[] = {9, 5, 4, 2, 1};

template <int MT, bool AG>
KernelFn kernel_for(int ntw) {
  switch (ntw) {
    case 9: return kron_mul_kernel<MT, 9, AG>;
    case 5: return kron_mul_kernel<MT, 5, AG>;
    case 4: return kron_mul_kernel<MT, 4, AG>;
    case 2: return kron_mul_kernel<MT, 2, AG>;
    default: return kron_mul_kernel<MT, 1, AG>;
  }
}

// the layouts compiled: A held (MT 1 or 2), A from global memory (MT 2)
KernelFn kernel_of(int MT, bool ag, int ntw) {
  if (ag) return kernel_for<2, true>(ntw);
  return MT == 2 ? kernel_for<2, false>(ntw) : kernel_for<1, false>(ntw);
}

Layout layout_of(const KronArgs& a, int ntw, int wc, int pw, bool ag) {
  const int Pp = round_up(a.p, 16), Qp = round_up(a.q, 8);
  Layout L;
  L.rows_b = 8 * ntw * wc;
  L.S = (Qp + L.rows_b - 1) / L.rows_b;
  L.wc = wc;
  L.pw = pw;
  L.ag = ag ? 1 : 0;
  L.lda = ag ? 0 : conflict_free_ld(Pp);
  L.ldb = conflict_free_ld(Qp);
  L.ldt = conflict_free_ld(pw);
  const int x_words = pw * a.q + 8, t_words = L.rows_b * L.ldt;
  L.rs = 0;
  L.is = 0;
  L.buf = round_up(x_words > t_words ? x_words : t_words, 4);
  L.nbuf = 1;
  return L;
}

size_t smem_bytes(const Layout& L, const KronArgs& a) {
  const size_t a_words = a.A != nullptr && !L.ag
                             ? static_cast<size_t>(round_up(a.p, 16)) * L.lda
                             : 0;
  return (a_words + static_cast<size_t>(L.rows_b) * L.ldb + L.rs + L.is +
          static_cast<size_t>(L.nbuf) * L.buf) *
         sizeof(float);
}

// Resident blocks of ``fn`` with ``bytes`` of shared memory and the SM
// count (0 blocks when the bytes exceed the device's opt-in).  The runtime
// queries run once per thread, kernel, size and device: decode launches
// this kernel hundreds of times per step.
cudaError_t resident(KernelFn fn, size_t bytes, int threads, int* blocks,
                     int* sms) {
  struct Entry {
    KernelFn fn;
    size_t bytes;
    int threads, device, blocks, sms;
  };
  constexpr int kEntries = 64;
  thread_local Entry cache[kEntries];
  thread_local int used = 0, next = 0;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  for (int i = 0; i < used; ++i) {
    const Entry& e = cache[i];
    if (e.fn == fn && e.bytes == bytes && e.threads == threads &&
        e.device == device) {
      *blocks = e.blocks;
      *sms = e.sms;
      return cudaSuccess;
    }
  }
  int n_sm = 0, optin = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  if (err != cudaSuccess) return err;
  if (bytes <= static_cast<size_t>(optin)) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads,
                                                        bytes);
    if (err != cudaSuccess) return err;
  }
  cache[next] = {fn, bytes, threads, device, n_sm * per_sm, n_sm};
  next = (next + 1) % kEntries;
  if (used < kEntries) ++used;
  *blocks = n_sm * per_sm;
  *sms = n_sm;
  return cudaSuccess;
}

// One launch's plan: the warp grid (MT, wc, NTW), the slices, and what
// shared memory holds.
struct Plan {
  KernelFn fn;
  Layout L;
  int threads, grid;
};

// Among the warp grids (two m-tiles per warp where 32 divides p padded,
// one to eight column groups, NTW n-tiles per warp) whose slices waste at
// most a quarter of the row's n-tiles and whose buffers fit: the fewest
// slices per row whose items (rows x slices) give at least half the SMs
// one (else the most slices), then two m-tiles per warp, then the most
// warps.  The layouts that hold A come first; only where none fits, those
// that read A from global memory (p padded to 32 rows).  When the card
// holds every item at once (decode) each gets its own block and one row
// buffer; otherwise a persistent grid walks them, with two row buffers
// where they fit.  The reciprocal scale is held where it fits.
cudaError_t plan(const KronArgs& a, Plan* out) {
  const int Pp = round_up(a.p, 16), nt = round_up(a.q, 8) / 8;
  bool found = false;
  long long best_key = 0;
  for (int ag = 0; ag < 2 && !found; ++ag) {
    if (ag == 1 && a.A == nullptr) break;  // p = 1: nothing to hold
    for (int MT = ag || Pp % 32 == 0 ? 2 : 1; MT >= 1 + ag; --MT) {
      const int pw = round_up(a.p, 16 * MT), WR = pw / (16 * MT);
      for (int wc = 8 / WR; wc >= 1; wc /= 2)
        for (int ntw : kNtw) {
          Layout L = layout_of(a, ntw, wc, pw, ag);
          if (4 * (L.S * ntw * wc - nt) > nt) continue;
          const KernelFn fn = kernel_of(MT, ag, ntw);
          const int threads = kThreads, warps = WR * wc;  // computing warps
          int blocks = 0, sms = 0;
          const cudaError_t err =
              resident(fn, smem_bytes(L, a), threads, &blocks, &sms);
          if (err != cudaSuccess) return err;
          if (blocks < L.S) continue;
          const long long items = static_cast<long long>(a.N) * L.S;
          // fewer slices first (more when items are short), then two
          // m-tiles per warp, then more warps
          const bool enough = 2 * items >= sms;
          const long long key = (static_cast<long long>(!enough) << 40) |
                                (static_cast<long long>(enough ? L.S
                                                               : 64 - L.S)
                                 << 20) |
                                ((MT == 2 ? 0 : 1) << 10) | (8 - warps);
          if (found && key >= best_key) continue;
          found = true;
          best_key = key;
          out->fn = fn;
          out->L = L;
          out->threads = threads;
          out->grid = static_cast<int>(items);
          if (items > blocks) {  // persistent: two buffers if they fit
            int blocks2 = 0;
            Layout L2 = L;
            L2.nbuf = 2;
            if (resident(fn, smem_bytes(L2, a), threads, &blocks2, &sms) ==
                    cudaSuccess &&
                blocks2 >= L.S) {
              out->L = L2;
              blocks = blocks2;
            }
            out->grid = blocks / L.S * L.S;
          }
        }
    }
  }
  if (!found) return cudaErrorInvalidValue;
  // For a persistent grid, extras filled once per block, each only while
  // every block of the grid stays resident: the 16-bit inv_perm (no index
  // loads per row), then 1 / scale (rows by cp.async).
  Layout L = out->L;
  const int n = a.p * a.q;
  const bool persistent = out->grid < a.N * L.S;
  for (int extra = 0; extra < 2 && persistent; ++extra) {
    Layout L2 = L;
    if (extra == 0 && a.inv_perm != nullptr)
      L2.is = round_up((n + 1) / 2, 4);
    else if (extra == 1 && a.scale != nullptr)
      L2.rs = round_up(L.pw * a.q + 8, 4);
    else
      continue;
    int blocks = 0, sms = 0;
    const cudaError_t err =
        resident(out->fn, smem_bytes(L2, a), out->threads, &blocks, &sms);
    if (err != cudaSuccess) return err;
    if (blocks >= out->grid) L = L2;
  }
  out->L = L;
  return cudaSuccess;
}

}  // namespace

namespace repro_torch {

cudaError_t kron_mul_launch(const KronArgs& a, cudaStream_t stream) {
  if (a.N <= 0) return cudaSuccess;
  if (a.p < 1 || a.q < 1 || a.p > kKronMaxP || a.q > kKronMaxQ ||
      (a.A == nullptr && a.p != 1) ||
      (a.perm == nullptr) != (a.inv_perm == nullptr) ||
      (a.trans && a.scale != nullptr))
    return cudaErrorInvalidValue;
  Plan pl;
  const cudaError_t err = plan(a, &pl);
  if (err != cudaSuccess) return err;
  pl.fn<<<pl.grid, pl.threads, smem_bytes(pl.L, a), stream>>>(a, pl.L);
  return cudaGetLastError();
}

}  // namespace repro_torch
