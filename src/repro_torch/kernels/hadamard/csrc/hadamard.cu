// Randomized Hadamard transform y = H_n (s * x) / sqrt(n) for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/hadamard/kernel.py
// (hadamard_kernel / _had_kernel).  The TPU kernel evaluates the transform
// as two dense products with Sylvester factors, H_a X H_b^T, because a
// butterfly's strided shuffles are slow on its vector unit; on the H100
// the butterfly is the cheap form, so this kernel runs the O(n log n) fast
// Walsh-Hadamard transform.  Its stages are those of the plain version
// (ref.fwht_ref): index bit 0 first, then bit 1, ..., each pair (j, j + h)
// becoming (a + b, a - b) with a the element whose bit is clear.  Every
// addition is the plain version's, in the same order, and the sign and
// 1/sqrt(n) products are separate roundings (__fmul_rn, never contracted
// into an FMA), so the output equals ref.hadamard_ref bit for bit.
//
// What bounds it: bytes.  A row is read once and written once (8 n bytes)
// for n log2 n additions, 1.25 operations per byte at n = 1024, where the
// fp32 cores would need 20 to be the limit.
//
// Design, n <= 2048 (hadamard_warp_kernel; the main path's n = 1024): the
// row lives in one warp's registers, with no shared memory and no
// barrier.  Lane l holds V = 4 consecutive values (one 16-byte load) at
// V (G i + l) for i = 0 .. R - 1, so index bits 0-1 lie within a lane's
// vector, bits 2-6 across the G = 32 lanes and bits 7 and up across i:
// at n = 1024 a lane issues 8 coalesced 16-byte loads at once, and many
// warps per SM keep the bytes in flight.  The stages over bits 0-1 and
// 7-9 are register butterflies; those over bits 2-6 are __shfl_xor_sync
// exchanges (the lower lane keeps a + b, the upper one computes a - b from
// its partner's a).  Narrower rows (n < 128) put 32 / G rows in a warp.
// The sign flip is fused into the load (or, for the transpose, into the
// store), and x and y are streamed past L1 (__ldcs / __stcs).
//
// n > 2048 (hadamard_smem_kernel): one block per row, persistent over the
// rows, the row in shared memory, log2 n butterfly stages with one barrier
// each (pairs (j, j + h) taken by consecutive threads).  It is off the
// main path (check (c)'s rows are 1024 wide).
#include "hadamard.h"

#include <math.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 8;
constexpr int kMaxThreads = 512;  // the shared-memory kernel

template <int V>
struct Vec;
template <>
struct Vec<2> {
  using type = float2;
};
template <>
struct Vec<4> {
  using type = float4;
};

__device__ __forceinline__ void butterfly(float& a, float& b) {
  const float x = a, y = b;
  a = __fadd_rn(x, y);
  b = __fsub_rn(x, y);
}

// One warp per row of n = 2^LOG2N <= 2048 (32 / G rows per warp for
// n < 128): V values per lane, G lanes per row, R vectors per lane.
template <int LOG2N, bool SIGNS_AFTER>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
hadamard_warp_kernel(const float* __restrict__ x, const float* __restrict__ s,
                     float* __restrict__ y, int N, float scale) {
  constexpr int n = 1 << LOG2N;
  constexpr int V = n < 4 ? n : 4;
  constexpr int G = n / V < 32 ? n / V : 32;
  constexpr int R = n / (V * G);
  constexpr int kRows = 32 / G;  // rows per warp
  using VT = typename Vec<V>::type;

  const int lane = threadIdx.x & 31, l = lane % G;
  const long long first =
      ((long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5)) * kRows;
  if (first >= N) return;  // whole warps: the shuffles below stay full-warp
  const long long row = first + lane / G;
  const bool live = row < N;

  float r[R][V];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int off = (i * G + l) * V;
    VT xv;
    if (live) {
      xv = __ldcs(reinterpret_cast<const VT*>(x + row * n + off));
    } else {
      xv = VT{};
    }
    const float* xs = reinterpret_cast<const float*>(&xv);
    if (SIGNS_AFTER) {
#pragma unroll
      for (int v = 0; v < V; ++v) r[i][v] = xs[v];
    } else {
      const VT sv = __ldg(reinterpret_cast<const VT*>(s + off));
      const float* ss = reinterpret_cast<const float*>(&sv);
#pragma unroll
      for (int v = 0; v < V; ++v) r[i][v] = __fmul_rn(xs[v], ss[v]);
    }
  }

  // index bits 0 .. log2 V - 1: within a lane's vector
#pragma unroll
  for (int h = 1; h < V; h <<= 1)
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int v = 0; v < V; ++v)
        if (!(v & h)) butterfly(r[i][v], r[i][v + h]);

  // the next log2 G bits: across the row's lanes
#pragma unroll
  for (int h = 1; h < G; h <<= 1) {
    const bool upper = (l & h) != 0;
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float p = __shfl_xor_sync(kFull, r[i][v], h);
        r[i][v] = upper ? __fsub_rn(p, r[i][v]) : __fadd_rn(r[i][v], p);
      }
  }

  // the rest: across a lane's vectors
#pragma unroll
  for (int h = 1; h < R; h <<= 1)
#pragma unroll
    for (int i = 0; i < R; ++i)
      if (!(i & h))
#pragma unroll
        for (int v = 0; v < V; ++v) butterfly(r[i][v], r[i + h][v]);

  if (!live) return;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int off = (i * G + l) * V;
    VT yv;
    float* ys = reinterpret_cast<float*>(&yv);
    if (SIGNS_AFTER) {
      const VT sv = __ldg(reinterpret_cast<const VT*>(s + off));
      const float* ss = reinterpret_cast<const float*>(&sv);
#pragma unroll
      for (int v = 0; v < V; ++v)
        ys[v] = __fmul_rn(__fmul_rn(r[i][v], scale), ss[v]);
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v) ys[v] = __fmul_rn(r[i][v], scale);
    }
    __stcs(reinterpret_cast<VT*>(y + row * n + off), yv);
  }
}

// n > 2048: one block per row (persistent over the rows), the row in
// shared memory, one barrier per stage.
template <bool SIGNS_AFTER>
__global__ void __launch_bounds__(kMaxThreads)
hadamard_smem_kernel(const float* __restrict__ x, const float* __restrict__ s,
                     float* __restrict__ y, int N, int log2n, float scale) {
  extern __shared__ float buf[];
  const int n = 1 << log2n, half = n >> 1;
  for (int row = blockIdx.x; row < N; row += gridDim.x) {
    const float* xr = x + (size_t)row * n;
    for (int i = threadIdx.x; i < n; i += blockDim.x)
      buf[i] = SIGNS_AFTER ? xr[i] : __fmul_rn(xr[i], s[i]);
    __syncthreads();
    for (int h = 1; h < n; h <<= 1) {
      for (int pr = threadIdx.x; pr < half; pr += blockDim.x) {
        const int j = ((pr & ~(h - 1)) << 1) | (pr & (h - 1));
        butterfly(buf[j], buf[j + h]);
      }
      __syncthreads();
    }
    float* yr = y + (size_t)row * n;
    for (int i = threadIdx.x; i < n; i += blockDim.x)
      yr[i] = SIGNS_AFTER ? __fmul_rn(__fmul_rn(buf[i], scale), s[i])
                          : __fmul_rn(buf[i], scale);
    __syncthreads();  // the buffer is reused by the next row
  }
}

// Resident blocks the card holds of hadamard_smem_kernel<SIGNS_AFTER> with
// ``threads`` threads and ``bytes`` of shared memory (the persistent grid's
// size).  The runtime queries run once per thread, instance, device and
// size, not on every launch; the shared-memory opt-in is raised to the
// device's maximum, so it never needs lowering for another size.
template <bool SIGNS_AFTER>
cudaError_t resident_blocks(int threads, size_t bytes, int* out) {
  thread_local int cached_device = -1, cached_threads = 0, cached_blocks = 0;
  thread_local size_t cached_bytes = 0;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device != cached_device || bytes != cached_bytes ||
      threads != cached_threads) {
    int sms = 0, optin = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                 device);
    if (err != cudaSuccess) return err;
    if (bytes > static_cast<size_t>(optin)) return cudaErrorInvalidValue;
    err = cudaFuncSetAttribute(hadamard_smem_kernel<SIGNS_AFTER>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, hadamard_smem_kernel<SIGNS_AFTER>, threads, bytes);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    cached_device = device;
    cached_threads = threads;
    cached_bytes = bytes;
    cached_blocks = sms * per_sm;
  }
  *out = cached_blocks;
  return cudaSuccess;
}

template <bool SIGNS_AFTER>
cudaError_t launch_smem(const float* x, const float* s, float* y, int N,
                        int log2n, float scale, cudaStream_t stream) {
  const int n = 1 << log2n;
  const size_t bytes = (size_t)n * sizeof(float);
  const int threads = n / 2 < kMaxThreads ? n / 2 : kMaxThreads;
  int blocks = 0;
  const cudaError_t err =
      resident_blocks<SIGNS_AFTER>(threads, bytes, &blocks);
  if (err != cudaSuccess) return err;
  const int grid = N < blocks ? N : blocks;
  hadamard_smem_kernel<SIGNS_AFTER><<<grid, threads, bytes, stream>>>(
      x, s, y, N, log2n, scale);
  return cudaGetLastError();
}

template <int LOG2N, bool SIGNS_AFTER>
cudaError_t launch_warp(const float* x, const float* s, float* y, int N,
                        float scale, cudaStream_t stream) {
  constexpr int n = 1 << LOG2N;
  constexpr int V = n < 4 ? n : 4;
  constexpr int G = n / V < 32 ? n / V : 32;
  constexpr long long kRowsPerBlock = kWarpsPerBlock * (32 / G);
  const long long grid = (N + kRowsPerBlock - 1) / kRowsPerBlock;
  hadamard_warp_kernel<LOG2N, SIGNS_AFTER>
      <<<static_cast<unsigned>(grid), kWarpsPerBlock * 32, 0, stream>>>(
          x, s, y, N, scale);
  return cudaGetLastError();
}

template <bool SIGNS_AFTER>
cudaError_t launch(const float* x, const float* s, float* y, int N,
                   int log2n, cudaStream_t stream) {
  const float scale = 1.0f / sqrtf(static_cast<float>(1 << log2n));
  switch (log2n) {  // n <= 2048: a row in one warp
#define REPRO_HADAMARD_CASE(L) \
  case L:                      \
    return launch_warp<L, SIGNS_AFTER>(x, s, y, N, scale, stream);
    REPRO_HADAMARD_CASE(1)
    REPRO_HADAMARD_CASE(2)
    REPRO_HADAMARD_CASE(3)
    REPRO_HADAMARD_CASE(4)
    REPRO_HADAMARD_CASE(5)
    REPRO_HADAMARD_CASE(6)
    REPRO_HADAMARD_CASE(7)
    REPRO_HADAMARD_CASE(8)
    REPRO_HADAMARD_CASE(9)
    REPRO_HADAMARD_CASE(10)
    REPRO_HADAMARD_CASE(11)
#undef REPRO_HADAMARD_CASE
    default:
      return launch_smem<SIGNS_AFTER>(x, s, y, N, log2n, scale, stream);
  }
}

}  // namespace

namespace repro_torch {

cudaError_t hadamard_launch(const float* x, const float* s, float* y, int N,
                            int log2n, bool signs_after,
                            cudaStream_t stream) {
  if (N <= 0) return cudaSuccess;
  if (log2n < 1 || (1 << log2n) > kHadamardMaxN) return cudaErrorInvalidValue;
  if (signs_after) return launch<true>(x, s, y, N, log2n, stream);
  return launch<false>(x, s, y, N, log2n, stream);
}

}  // namespace repro_torch
