// Fused Kronecker-product transform y = (A kron B) x for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/kron_mul/kernel.py
// (kron_mul_kernel / _kron_kernel).  For every row, with X = reshape(x,
// (p, q)):
//
//     T = X B^T   (p x q),   Y = A T   (p x q),   y = reshape(Y, p*q)
//
// in fp32 FMAs on the CUDA cores: no TF32, since LDLQ's codes depend on
// these values (the incoherence preprocessing of W and H runs here).
//
// What bounds it: operations.  A row costs 2 p q (p + q) flops against
// 8 p q bytes, 36 flops per byte at 1024 = 32 x 32 and 66 at 17408 =
// 128 x 136, above the H100's fp32 ridge (67 TFLOP/s over 3.35 TB/s = 20).
//
// Design: a block walks work items (persistent); an item is one row and a
// slice C of the q output columns.  Columns split exactly: Y[:, C] =
// A (X B^T[:, C]), so a slice needs the whole row X and all of A but only
// its own rows of B.  The block keeps A and its slice of B^T in shared
// memory across items (reloading B^T only when the slice changes); the row
// X is loaded into shared memory, T[:, C] = X B^T[:, C] is computed into
// registers and written back over X, and Y[:, C] = A T[:, C] is computed
// into registers and stored straight to device memory.  T never leaves the
// block.  X, T, A and B need at most p q + p^2 + q^2 floats: 204 KB at
// 128 x 136, inside the 227 KB a block may use (the TPU kernel's 256-row
// VMEM tile does not carry over).
//
// Two layouts of the 512 threads, each a register tile of rows ty + TY a
// and columns tx + TX b of the (p, |C|) output, TX x TY = 512:
//   - rows that fill the card (the Hessians, prefill): an item is a whole
//     row, TX = 32, so a warp shares its row operand (one broadcast load)
//     and reads 32 consecutive words of the column operand;
//   - fewer rows (decode: N = 8): slices of 8, 16 or 32 columns, TX = 8,
//     the narrowest whose items all run at once (8 rows of 128 x 136: nine
//     16-column slices, 72 blocks, instead of 8 blocks).  A warp then reads
//     4 rows of its left operand, so A and X are held with an odd row
//     stride (p + 1, q + 1) that puts those rows in different banks.
// Factors and rows are copied to shared memory with 16-byte loads, several
// in flight per thread.
//
// Host side: the shared-memory opt-in, the SM count and the occupancy are
// queried once per kernel instance, device and shape (thread-local cache),
// not on every launch: decode launches this kernel hundreds of times per
// step.
#include "kron_mul.h"

#include <stdint.h>

namespace {

constexpr int kThreads = 512;

// acc[a][b] = sum_t L[r_a, t] * R[t, c_b] over t < K, r_a = ty + TY a,
// c_b = tx + TX b; L row-major with row stride ldl, R row-major with row
// stride ldr (both in shared memory).
template <int TX, int RA, int CB>
__device__ __forceinline__ void tile_product(const float* L, int ldl,
                                             const float* R, int ldr, int K,
                                             int rows, int cols, int ty,
                                             int tx, float (&acc)[RA][CB]) {
  constexpr int TY = kThreads / TX;
#pragma unroll
  for (int a = 0; a < RA; ++a)
#pragma unroll
    for (int b = 0; b < CB; ++b) acc[a][b] = 0.f;
  for (int t = 0; t < K; ++t) {
    float l[RA], r[CB];
#pragma unroll
    for (int a = 0; a < RA; ++a) {
      const int i = ty + TY * a;
      l[a] = i < rows ? L[i * ldl + t] : 0.f;
    }
#pragma unroll
    for (int b = 0; b < CB; ++b) {
      const int c = tx + TX * b;
      r[b] = c < cols ? R[t * ldr + c] : 0.f;
    }
#pragma unroll
    for (int a = 0; a < RA; ++a)
#pragma unroll
      for (int b = 0; b < CB; ++b) acc[a][b] = fmaf(l[a], r[b], acc[a][b]);
  }
}

// dst[r * (w + PAD) + c] = src[r * w + c] for a (rows, w) row-major src in
// device memory: 16-byte loads when src is 16-byte aligned and w a
// multiple of 4 (one row per float4), else word loads.
template <int PAD>
__device__ __forceinline__ void copy_to_shared(float* dst,
                                               const float* __restrict__ src,
                                               int rows, int w) {
  const int n = rows * w;
  if ((w & 3) == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
    const int w4 = w >> 2;
#pragma unroll 4
    for (int v = threadIdx.x; v < (n >> 2); v += kThreads) {
      const float4 f = s4[v];
      float* d = dst + 4 * v + (PAD ? v / w4 : 0);
      d[0] = f.x;
      d[1] = f.y;
      d[2] = f.z;
      d[3] = f.w;
    }
  } else {
#pragma unroll 4
    for (int e = threadIdx.x; e < n; e += kThreads)
      dst[e + (PAD ? e / w : 0)] = src[e];
  }
}

// Columns of B^T a block holds: one slice of TX * CB columns (all q when a
// slice covers the row).
template <int TX, int CB>
__host__ __device__ __forceinline__ int slice_width(int q) {
  return q < TX * CB ? q : TX * CB;
}

// A (p rows of stride p + PAD), the slice of B^T, and X (p rows of stride
// q + PAD); PAD = 1 in the 8-column layout.
template <int TX, int CB>
size_t smem_bytes(int p, int q) {
  constexpr int PAD = TX != 32;
  return (static_cast<size_t>(p) * (p + PAD) +
          static_cast<size_t>(q) * slice_width<TX, CB>(q) +
          static_cast<size_t>(p) * (q + PAD)) * sizeof(float);
}

// S = slices per row, each of TX * CB columns (the last one ragged).
template <int TX, int RA, int CB>
__global__ void __launch_bounds__(kThreads)
kron_mul_kernel(const float* __restrict__ x, const float* __restrict__ A,
                const float* __restrict__ B, float* __restrict__ y, int N,
                int p, int q, int S) {
  constexpr int TY = kThreads / TX;
  // TX = 32: an item is a whole row (S = 1, launch_cb picks CB so), and
  // every width below is q itself, which the compiler then knows
  constexpr bool WHOLE = TX == 32;
  constexpr int PAD = !WHOLE;
  extern __shared__ float sm[];
  const int wb = WHOLE ? q : slice_width<TX, CB>(q);
  const int lda = p + PAD, ldx = q + PAD;
  float* As = sm;            // As[j * lda + i] = A[j, i]
  float* Bs = As + p * lda;  // Bs[t * wb + c] = B[c0 + c, t]
  float* Xs = Bs + q * wb;   // X[i, t] at i * ldx + t, then T[:, C]
  const int n = p * q;
  copy_to_shared<PAD>(As, A, p, p);
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  float acc[RA][CB];
  int held_c0 = -1;  // the slice of B^T in shared memory
  const int items = N * S;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int row = WHOLE ? item : item / S;
    const int c0 = WHOLE ? 0 : (item - row * S) * (TX * CB);
    const int cols = WHOLE ? q : min(q - c0, TX * CB);
    __syncthreads();  // the previous item's T and B^T slice consumed
    if (c0 != held_c0) {
      for (int idx = threadIdx.x; idx < cols * q; idx += kThreads) {
        const int c = idx / q, t = idx - c * q;
        Bs[t * wb + c] = B[(size_t)(c0 + c) * q + t];
      }
      held_c0 = c0;
    }
    copy_to_shared<PAD>(Xs, x + (size_t)row * n, p, q);
    __syncthreads();
    // T[:, C] = X B^T[:, C]: L = X (p x q), R = the slice (q x cols)
    tile_product<TX, RA, CB>(Xs, ldx, Bs, wb, q, p, cols, ty, tx, acc);
    __syncthreads();  // every thread is done reading X
#pragma unroll
    for (int a = 0; a < RA; ++a)
#pragma unroll
      for (int b = 0; b < CB; ++b) {
        const int i = ty + TY * a, c = tx + TX * b;
        if (i < p && c < cols) Xs[i * cols + c] = acc[a][b];
      }
    __syncthreads();
    // Y[:, C] = A T[:, C]: L = A (p x p), R = T[:, C] (p x cols)
    tile_product<TX, RA, CB>(As, lda, Xs, cols, p, p, cols, ty, tx, acc);
    float* yr = y + (size_t)row * n + c0;
#pragma unroll
    for (int a = 0; a < RA; ++a)
#pragma unroll
      for (int b = 0; b < CB; ++b) {
        const int j = ty + TY * a, c = tx + TX * b;
        if (j < p && c < cols) yr[j * q + c] = acc[a][b];
      }
  }
}

// Resident blocks the card holds of kron_mul_kernel<TX, RA, CB> with
// ``bytes`` of shared memory (the persistent grid's size).  The runtime
// queries run once per thread, instance, device and size; the
// shared-memory opt-in is raised to the device's maximum, so it never
// needs lowering for another shape.
template <int TX, int RA, int CB>
cudaError_t resident_blocks(int p, int q, int* out) {
  thread_local int cached_device = -1, cached_blocks = 0;
  thread_local size_t cached_bytes = 0;
  const size_t bytes = smem_bytes<TX, CB>(p, q);
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device != cached_device || bytes != cached_bytes) {
    int sms = 0, optin = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                 device);
    if (err != cudaSuccess) return err;
    if (bytes > static_cast<size_t>(optin)) return cudaErrorInvalidValue;
    err = cudaFuncSetAttribute(kron_mul_kernel<TX, RA, CB>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kron_mul_kernel<TX, RA, CB>, kThreads, bytes);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    cached_device = device;
    cached_bytes = bytes;
    cached_blocks = sms * per_sm;
  }
  *out = cached_blocks;
  return cudaSuccess;
}

template <int TX, int RA, int CB>
cudaError_t launch(const float* x, const float* A, const float* B, float* y,
                   int N, int p, int q, int blocks, cudaStream_t stream) {
  const int S = (q + TX * CB - 1) / (TX * CB);
  const int items = N * S;
  const int grid = items < blocks ? items : blocks;
  kron_mul_kernel<TX, RA, CB>
      <<<grid, kThreads, smem_bytes<TX, CB>(p, q), stream>>>(x, A, B, y, N,
                                                             p, q, S);
  return cudaGetLastError();
}

// Slices of 8 << k columns in the 8-column layout (64 row groups,
// p <= 128): the narrowest whose N * S items the card holds at once.
template <int RA>
cudaError_t launch_slices(const float* x, const float* A, const float* B,
                          float* y, int N, int p, int q,
                          cudaStream_t stream) {
  int blocks = 0;
  cudaError_t err = resident_blocks<8, RA, 1>(p, q, &blocks);
  if (err != cudaSuccess) return err;
  if (N * ((q + 7) / 8) <= blocks)
    return launch<8, RA, 1>(x, A, B, y, N, p, q, blocks, stream);
  if ((err = resident_blocks<8, RA, 2>(p, q, &blocks)) != cudaSuccess)
    return err;
  if (N * ((q + 15) / 16) <= blocks)
    return launch<8, RA, 2>(x, A, B, y, N, p, q, blocks, stream);
  if ((err = resident_blocks<8, RA, 4>(p, q, &blocks)) != cudaSuccess)
    return err;
  return launch<8, RA, 4>(x, A, B, y, N, p, q, blocks, stream);
}

// A whole row per item (TX = 32, CB covering q) when the rows fill the
// card's resident blocks, else column slices.
template <int RA, int CB>
cudaError_t launch_rows_or_slices(const float* x, const float* A,
                                  const float* B, float* y, int N, int p,
                                  int q, cudaStream_t stream) {
  int blocks = 0;
  const cudaError_t err = resident_blocks<32, RA, CB>(p, q, &blocks);
  if (err != cudaSuccess) return err;
  if (N >= blocks) return launch<32, RA, CB>(x, A, B, y, N, p, q, blocks,
                                             stream);
  if (p <= 64) return launch_slices<1>(x, A, B, y, N, p, q, stream);
  return launch_slices<2>(x, A, B, y, N, p, q, stream);
}

template <int RA>
cudaError_t launch_cb(const float* x, const float* A, const float* B,
                      float* y, int N, int p, int q, cudaStream_t stream) {
  if (q <= 32) return launch_rows_or_slices<RA, 1>(x, A, B, y, N, p, q, stream);
  if (q <= 64) return launch_rows_or_slices<RA, 2>(x, A, B, y, N, p, q, stream);
  if (q <= 96) return launch_rows_or_slices<RA, 3>(x, A, B, y, N, p, q, stream);
  return launch_rows_or_slices<RA, 5>(x, A, B, y, N, p, q, stream);
}

}  // namespace

namespace repro_torch {

cudaError_t kron_mul_launch(const float* x, const float* A, const float* B,
                            float* y, int N, int p, int q,
                            cudaStream_t stream) {
  if (N <= 0) return cudaSuccess;
  if (p < 1 || q < 1 || p > kKronMaxP || q > kKronMaxQ)
    return cudaErrorInvalidValue;
  // whole-row layout: 16 row groups of RA rows
  if (p <= 16) return launch_cb<1>(x, A, B, y, N, p, q, stream);
  if (p <= 32) return launch_cb<2>(x, A, B, y, N, p, q, stream);
  if (p <= 64) return launch_cb<4>(x, A, B, y, N, p, q, stream);
  return launch_cb<8>(x, A, B, y, N, p, q, stream);
}

}  // namespace repro_torch
