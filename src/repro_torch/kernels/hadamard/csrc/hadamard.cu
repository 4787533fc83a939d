// Randomized Hadamard transform y = H_n (s * x) / sqrt(n) for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/hadamard/kernel.py
// (hadamard_kernel / _had_kernel).  The TPU kernel evaluates the transform
// as two dense products with Sylvester factors, H_a X H_b^T, because a
// butterfly's strided shuffles are slow on its vector unit; on the H100
// the butterfly is the cheap form, so this kernel runs the O(n log n) fast
// Walsh-Hadamard transform, which computes the same function to fp32
// rounding.
//
// What bounds it: bytes.  A row is read once and written once (8 n bytes)
// for n log2 n additions, 1.25 operations per byte at n = 1024.  Design:
// one block per row (persistent over rows), the row in shared memory with
// the sign flip fused into the load (or, for the transpose, into the
// store), log2 n butterfly stages with one barrier each, pairs (j, j + h)
// taken by consecutive threads so a warp touches consecutive words, and
// the 1/sqrt(n) scale fused into the store.
#include "hadamard.h"

#include <math.h>

namespace {

constexpr int kMaxThreads = 512;

template <bool SIGNS_AFTER>
__global__ void __launch_bounds__(kMaxThreads)
hadamard_kernel(const float* __restrict__ x, const float* __restrict__ s,
                float* __restrict__ y, int N, int log2n, float scale) {
  extern __shared__ float buf[];
  const int n = 1 << log2n, half = n >> 1;
  for (int row = blockIdx.x; row < N; row += gridDim.x) {
    const float* xr = x + (size_t)row * n;
    for (int i = threadIdx.x; i < n; i += blockDim.x)
      buf[i] = SIGNS_AFTER ? xr[i] : xr[i] * s[i];
    __syncthreads();
    for (int h = 1; h < n; h <<= 1) {
      for (int pr = threadIdx.x; pr < half; pr += blockDim.x) {
        const int j = ((pr & ~(h - 1)) << 1) | (pr & (h - 1));
        const float a = buf[j], b = buf[j + h];
        buf[j] = a + b;
        buf[j + h] = a - b;
      }
      __syncthreads();
    }
    float* yr = y + (size_t)row * n;
    for (int i = threadIdx.x; i < n; i += blockDim.x)
      yr[i] = SIGNS_AFTER ? buf[i] * scale * s[i] : buf[i] * scale;
    __syncthreads();  // the buffer is reused by the next row
  }
}

// Resident blocks the card holds of hadamard_kernel<SIGNS_AFTER> with
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
    err = cudaFuncSetAttribute(hadamard_kernel<SIGNS_AFTER>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, hadamard_kernel<SIGNS_AFTER>, threads, bytes);
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
cudaError_t launch(const float* x, const float* s, float* y, int N,
                   int log2n, cudaStream_t stream) {
  const int n = 1 << log2n;
  const size_t bytes = (size_t)n * sizeof(float);
  int threads = n / 2 < kMaxThreads ? n / 2 : kMaxThreads;
  if (threads < 32) threads = 32;
  int blocks = 0;
  const cudaError_t err =
      resident_blocks<SIGNS_AFTER>(threads, bytes, &blocks);
  if (err != cudaSuccess) return err;
  const int grid = N < blocks ? N : blocks;
  const float scale = 1.0f / sqrtf(static_cast<float>(n));
  hadamard_kernel<SIGNS_AFTER><<<grid, threads, bytes, stream>>>(
      x, s, y, N, log2n, scale);
  return cudaGetLastError();
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
