// In-block sequential LDLQ rounding for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/ldlq/kernel.py
// (ldlq_block_kernel / _ldlq_kernel).  For every row r of a (M, nb)
// column block, in column order k = 0 .. nb-1:
//
//     val = (W[r, k] + base[r, k]) + s[r, k]
//     s[r, k] = sum_{j<k} E[r, j] U[j, k]        (ascending j, from 0)
//     Q[r, k] = clip(round(val), 0, maxq);   E[r, k] = W[r, k] - Q[r, k]
//
// The recurrence feeds back W - Q, not W + base - Q.  Rounding is
// half-to-even (as torch.round and jnp.round; roundf would round half away
// from zero, and at 2 bits grid values land on .5 often enough to flip
// codes), or stochastic with caller-drawn uniforms.
//
// What bounds it: neither bytes nor operations.  A block of nb = 128
// columns moves 16 bytes and does 127 multiply-adds per weight, but each
// column depends on the one before: the time is the 128-step chain per
// row, and the instructions and shared-memory reads the card issues for
// the rows it holds at once.
//
// Design: a right-looking recurrence.  Rows are independent; 8 lanes
// serve one row (four rows per warp), lane g owning the 16 columns
// c = 8 t + g (slot t).  Each lane keeps running sums s for its columns.
// When column k is rounded, its owner has the error e_k, one __shfl_sync
// broadcasts it, and every lane adds e_k U[k, c] into its own pending
// columns with one FMA each.  The chain per column is one shuffle, the
// FMA into the next column's sum, then that column's add, round (an add
// and a subtract of 1.5 * 2^23), clamp and subtract: no reduction of
// E . U[:, k] across lanes on it.  The next column's chain is issued
// before the other FMAs of the step, so they fill its latency.  Columns
// are dealt out interleaved, so once the 8 columns of slot t are rounded,
// slot t drops out of every lane's updates: a step updates 16 - t slots,
// not 16.  Every lane rounds its own slot at each step; only the owner's
// result is kept.  The sum of
// column k is taken in ascending j from 0, one correctly rounded fp32 FMA
// per term (__fmaf_rn), so Q and E equal ref.ldlq_block_seq_ref bit for
// bit (it reproduces the FMA exactly in float64).  U is copied once per
// block into shared memory in its natural row-major layout by 16-byte
// cp.async, while the first rows' loads are in flight; a lane reads its
// slot i of row k as the word U[k, 8 i + g], so the 8 lanes of a row read
// 8 consecutive words and the warp's other rows read the same ones.
// Blocks are persistent over the rows, one per SM with as many warps as
// the registers allow (17, or 16 with the uniforms), and deal row groups
// out across blocks first, so a small M still spreads over every SM and
// M = 17408 takes two rounds, not three.  The last row group is masked,
// never padded.
#include "ldlq.h"

namespace {

constexpr int kMaxNb = repro_torch::kLdlqMaxBlock;
constexpr int kG = 8;            // lanes per row
constexpr int kC = kMaxNb / kG;  // columns per lane
constexpr int kRows = 32 / kG;   // rows per warp
// warps per block, one block per SM: as many as the registers allow (at
// most 120 each for 17 warps; the uniforms take 16 more per thread)
template <bool STOCH>
constexpr int kWarps = STOCH ? 16 : 17;
constexpr unsigned kFull = 0xffffffffu;
// (x + 1.5 * 2^23) - 1.5 * 2^23 is x rounded half to even for |x| < 2^22;
// after the clamp to [0, maxq] it equals clamp(rint(x)) for every x
constexpr float kRound = 12582912.f;

// One row in one lane: slot t is column 8 t + g of the row.
struct Row {
  float w[kC];   // W, then E once the slot is rounded
  float wb[kC];  // W + base, then Q
  float s[kC];   // the running sum
  float u[kC];   // the uniforms of stochastic rounding
};

// Asynchronous copies into shared memory of 16 and of 4 bytes; ``bytes``
// below the copy's size fills the rest with zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes));
}

// U (nb, nb) row-major -> shared memory rows of kMaxNb floats, columns >=
// nb zero.  Warp w copies rows w, w + WARPS, ...; lane l the 4 columns
// from 4 l, by one 16-byte cp.async where the row is 16-byte aligned.
// Ends with a barrier.
template <int WARPS>
__device__ __forceinline__ void stage_u(float* __restrict__ us,
                                        const float* __restrict__ U, int nb) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool whole = (reinterpret_cast<size_t>(U) & 15) == 0 &&
                     nb % 4 == 0 && 4 * lane < nb;
  for (int k = warp; k < nb; k += WARPS) {
    const float* src = U + k * nb + 4 * lane;
    float* dst = us + k * kMaxNb + 4 * lane;
    if (whole) {
      cp_async16(dst, src);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = 4 * lane + e < nb;
        cp_async4(dst + e, ok ? src + e : U, ok ? 4 : 0);
      }
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
}

// Issue the loads of one row: W into w, base into wb (finish_row adds W),
// uniforms into u; zero past M and nb.  The running sums start at 0.
template <bool STOCH>
__device__ __forceinline__ void load_row(Row& r, const float* __restrict__ W,
                                         int ldw,
                                         const float* __restrict__ base,
                                         int ldb,
                                         const float* __restrict__ noise,
                                         int ldn, int row, bool live, int g,
                                         int nb) {
#pragma unroll
  for (int t = 0; t < kC; ++t) {
    const int c = kG * t + g;
    const bool ok = live && c < nb;
    r.w[t] = ok ? W[(size_t)row * ldw + c] : 0.f;
    r.wb[t] = ok ? base[(size_t)row * ldb + c] : 0.f;
    r.u[t] = (STOCH && ok) ? noise[(size_t)row * ldn + c] : 0.f;
    r.s[t] = 0.f;
  }
}

__device__ __forceinline__ void finish_row(Row& r) {
#pragma unroll
  for (int t = 0; t < kC; ++t) r.wb[t] = __fadd_rn(r.w[t], r.wb[t]);
}

// This lane's candidate code and error for the column of its slot t (the
// column's owner holds the real ones).
template <bool STOCH>
__device__ __forceinline__ void candidate(const Row& r, int t, float maxq,
                                          float& q, float& e) {
  const float val = __fadd_rn(r.wb[t], r.s[t]);
  if (STOCH) {
    const float lo = floorf(val);
    q = __fadd_rn(lo, r.u[t] < __fsub_rn(val, lo) ? 1.f : 0.f);
  } else {
    q = __fsub_rn(__fadd_rn(val, kRound), kRound);
  }
  q = fminf(fmaxf(q, 0.f), maxq);
  e = __fsub_rn(r.w[t], q);
}

// Column k = 8 t + j, whose code and error (q, e) lane j computed in the
// step before: broadcast the error, keep lane j's pair in slot t, push the
// error into the next column's slot tn (t, t + 1, or -1 for none), take
// this lane's candidate for the next column, then push it into the other
// pending slots t .. 15.  The next column's chain comes first, so the
// other FMAs fill its latency.  ``uk`` points at U[k, g] in shared
// memory: lane g's slot i of row k is uk[8 i]; the 8 lanes of a row read
// 8 consecutive words, and the warp's other rows read the same ones.
template <bool STOCH>
__device__ __forceinline__ void step(Row& r, int t, int j, int tn, int g,
                                     const float* __restrict__ uk,
                                     float maxq, float& q, float& e) {
  float ur[kC];
#pragma unroll
  for (int i = t; i < kC; ++i) ur[i] = uk[kG * i];
  const float ek = __shfl_sync(kFull, e, j, kG);
  if (g == j) {  // slot t of lane j is done: wb keeps Q, w keeps E
    r.wb[t] = q;
    r.w[t] = e;
  }
  if (tn >= 0) {
    r.s[tn] = __fmaf_rn(ek, ur[tn], r.s[tn]);
    candidate<STOCH>(r, tn, maxq, q, e);
  }
#pragma unroll
  for (int i = t; i < kC; ++i)
    if (i != tn) r.s[i] = __fmaf_rn(ek, ur[i], r.s[i]);
}

// A warp serves 4 rows: lane l takes row l / 8 of its row group
// (``unit``), at columns 8 t + l % 8.
template <bool STOCH>
__global__ void __launch_bounds__(kWarps<STOCH> * 32)
ldlq_rows_kernel(const float* __restrict__ W, int ldw,
                 const float* __restrict__ base, int ldb,
                 const float* __restrict__ U,
                 const float* __restrict__ noise, int ldn,
                 float* __restrict__ Q, float* __restrict__ E, int M, int nb,
                 float maxq) {
  constexpr int kW = kWarps<STOCH>;
  // U: nb rows of kMaxNb floats (float4: 16-byte aligned for cp.async)
  extern __shared__ float4 us4[];
  float* us = reinterpret_cast<float*>(us4);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane % kG;
  const int units = (M + kRows - 1) / kRows;  // row groups
  int unit = blockIdx.x + gridDim.x * warp;
  int row = unit * kRows + lane / kG;

  Row r;
  // the first row's loads are in flight while U is staged
  if (unit < units)
    load_row<STOCH>(r, W, ldw, base, ldb, noise, ldn, row, row < M, g, nb);
  stage_u<kW>(us, U, nb);

  for (; unit < units; unit += gridDim.x * kW) {
    row = unit * kRows + lane / kG;
    finish_row(r);
    float q, e;
    candidate<STOCH>(r, 0, maxq, q, e);  // column 0
#pragma unroll
    for (int t = 0; t < kC; ++t) {
      if (kG * t >= nb) break;  // uniform across the warp
      const float* uk = us + kG * t * kMaxNb + g;
      if (kG * (t + 1) <= nb) {  // a whole group of 8 columns
        for (int j = 0; j < kG - 1; ++j)
          step<STOCH>(r, t, j, t, g, uk + j * kMaxNb, maxq, q, e);
        const float* ul = uk + (kG - 1) * kMaxNb;
        if (t + 1 < kC && kG * (t + 1) < nb)
          step<STOCH>(r, t, kG - 1, t + 1, g, ul, maxq, q, e);
        else
          step<STOCH>(r, t, kG - 1, -1, g, ul, maxq, q, e);
      } else {  // the block's last columns, fewer than 8
        const int last = nb - kG * t;
        for (int j = 0; j < last - 1; ++j)
          step<STOCH>(r, t, j, t, g, uk + j * kMaxNb, maxq, q, e);
        step<STOCH>(r, t, last - 1, -1, g, uk + (last - 1) * kMaxNb, maxq,
                    q, e);
      }
    }
    if (row < M) {
#pragma unroll
      for (int t = 0; t < kC; ++t) {
        const int c = kG * t + g;
        if (c < nb) {
          Q[(size_t)row * nb + c] = r.wb[t];
          E[(size_t)row * nb + c] = r.w[t];
        }
      }
    }
    const int next = unit + gridDim.x * kW;
    if (next < units) {
      const int nrow = next * kRows + lane / kG;
      load_row<STOCH>(r, W, ldw, base, ldb, noise, ldn, nrow, nrow < M, g,
                      nb);
    }
  }
}

// Blocks of ldlq_rows_kernel<STOCH> the card holds at once with
// ``bytes`` of shared memory (the persistent grid's size).  The runtime
// queries run once per thread, instance, device and size, not on every
// launch.
template <bool STOCH>
cudaError_t resident_blocks(size_t bytes, int* out) {
  thread_local int cached_device = -1, cached_blocks = 0;
  thread_local size_t cached_bytes = 0;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device != cached_device || bytes != cached_bytes) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(ldlq_rows_kernel<STOCH>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxNb * kMaxNb * sizeof(float));
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, ldlq_rows_kernel<STOCH>, kWarps<STOCH> * 32, bytes);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    cached_device = device;
    cached_bytes = bytes;
    cached_blocks = sms * per_sm;
  }
  *out = cached_blocks;
  return cudaSuccess;
}

template <bool STOCH>
cudaError_t launch(const float* W, int ldw, const float* base, int ldb,
                   const float* U, const float* noise, int ldn, float* Q,
                   float* E, int M, int nb, float maxq, cudaStream_t stream) {
  const size_t bytes = (size_t)nb * kMaxNb * sizeof(float);
  int blocks = 0;
  const cudaError_t err = resident_blocks<STOCH>(bytes, &blocks);
  if (err != cudaSuccess) return err;
  const int units = (M + kRows - 1) / kRows;
  const int grid = units < blocks ? units : blocks;
  ldlq_rows_kernel<STOCH><<<grid, kWarps<STOCH> * 32, bytes, stream>>>(
      W, ldw, base, ldb, U, noise, ldn, Q, E, M, nb, maxq);
  return cudaGetLastError();
}

}  // namespace

namespace repro_torch {

cudaError_t ldlq_block_launch(const float* W, int ldw, const float* base,
                              int ldb, const float* U, const float* noise,
                              int ldn, float* Q, float* E, int M, int nb,
                              float maxq, cudaStream_t stream) {
  if (M <= 0) return cudaSuccess;
  if (nb < 1 || nb > kLdlqMaxBlock) return cudaErrorInvalidValue;
  if (noise != nullptr)
    return launch<true>(W, ldw, base, ldb, U, noise, ldn, Q, E, M, nb, maxq,
                        stream);
  return launch<false>(W, ldw, base, ldb, U, noise, ldn, Q, E, M, nb, maxq,
                       stream);
}

}  // namespace repro_torch
