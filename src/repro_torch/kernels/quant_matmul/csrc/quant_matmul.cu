// Packed low-bit weight x activation matmul for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/quant_matmul/kernel.py
// (quant_matmul_kernel / _qmm_kernel).  Computes, for one split of the
// reduction dimension,
//
//     part[split, b, j] = sum_{k in split} x[b, k] * unpack(packed)[k, j]
//
// with b-bit grid values packed along K (value k = kp*vals + v lives in
// bits [bits*v, bits*(v+1)) of word packed[kp, j]).  The affine dequant
// and the sum over splits stay in the PyTorch wrapper (ops.py).
//
// What bounds it: at decode (B <= 8) the packed words are read once and
// each 4-byte word feeds vals*B FMAs, so the kernel is bound by the bytes
// of the codes (2 bits per weight).  Design: one thread per output column
// j, so a warp reads 32 consecutive words of one packed row (coalesced);
// the activation tile sits in shared memory and is read as a broadcast;
// RB rows of x share every unpacked code (RB picked from B); and when the
// (row, column) grid is too small to fill the card, K is split over
// gridDim.z, each split writing its own partial slice (no atomics, so the
// result does not depend on scheduling).  Unpacking shifts an unsigned
// word: a signed shift would smear bit 31 into the top field.
#include "quant_matmul.h"

#include <cuda_bf16.h>

namespace {

constexpr int THREADS = 256;  // output columns per block
constexpr int KPT = 32;       // packed words per shared-memory tile

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename XT, int BITS, int RB>
__global__ void __launch_bounds__(THREADS)
qmm_kernel(const XT* __restrict__ x, const int32_t* __restrict__ packed,
           float* __restrict__ part, int B, int K, int M, int kp_per_split) {
  constexpr int VALS = 32 / BITS;
  constexpr unsigned MASK = (1u << BITS) - 1u;
  constexpr int KT = KPT * VALS;  // reduction values per tile
  __shared__ float xs[RB * KT];

  const int j = blockIdx.x * THREADS + threadIdx.x;
  const int b0 = blockIdx.y * RB;
  const int split = blockIdx.z;
  const int Kp = (K + VALS - 1) / VALS;
  const int kp0 = split * kp_per_split;
  const int kp1 = min(Kp, kp0 + kp_per_split);

  float acc[RB];
#pragma unroll
  for (int r = 0; r < RB; ++r) acc[r] = 0.f;

  for (int kt = kp0; kt < kp1; kt += KPT) {
    const int nw = min(KPT, kp1 - kt);
    const int kbase = kt * VALS;
    for (int idx = threadIdx.x; idx < RB * KT; idx += THREADS) {
      const int r = idx / KT, kk = idx - r * KT;
      const int b = b0 + r, k = kbase + kk;
      // values past K (the tail word's padding) and past this split's
      // last word read as zero
      xs[idx] = (b < B && k < K && kk < nw * VALS)
                    ? to_f32(x[(size_t)b * K + k]) : 0.f;
    }
    __syncthreads();
    if (j < M) {
      for (int w = 0; w < nw; ++w) {
        const unsigned word =
            static_cast<unsigned>(packed[(size_t)(kt + w) * M + j]);
#pragma unroll
        for (int v = 0; v < VALS; ++v) {
          const float q = static_cast<float>((word >> (BITS * v)) & MASK);
#pragma unroll
          for (int r = 0; r < RB; ++r)
            acc[r] = fmaf(xs[r * KT + w * VALS + v], q, acc[r]);
        }
      }
    }
    __syncthreads();
  }
  if (j < M) {
#pragma unroll
    for (int r = 0; r < RB; ++r)
      if (b0 + r < B) part[((size_t)split * B + b0 + r) * M + j] = acc[r];
  }
}

template <typename XT, int BITS, int RB>
cudaError_t launch_rb(const void* x, const int32_t* packed, float* part,
                      int B, int K, int M, int splits, int kp_per_split,
                      cudaStream_t stream) {
  dim3 grid((M + THREADS - 1) / THREADS, (B + RB - 1) / RB, splits);
  qmm_kernel<XT, BITS, RB><<<grid, THREADS, 0, stream>>>(
      static_cast<const XT*>(x), packed, part, B, K, M, kp_per_split);
  return cudaGetLastError();
}

template <typename XT, int BITS>
cudaError_t launch_bits(const void* x, const int32_t* packed, float* part,
                        int B, int K, int M, int splits, int kp_per_split,
                        cudaStream_t stream) {
  if (B <= 1)
    return launch_rb<XT, BITS, 1>(x, packed, part, B, K, M, splits,
                                  kp_per_split, stream);
  if (B <= 2)
    return launch_rb<XT, BITS, 2>(x, packed, part, B, K, M, splits,
                                  kp_per_split, stream);
  if (B <= 4)
    return launch_rb<XT, BITS, 4>(x, packed, part, B, K, M, splits,
                                  kp_per_split, stream);
  return launch_rb<XT, BITS, 8>(x, packed, part, B, K, M, splits,
                                kp_per_split, stream);
}

template <typename XT>
cudaError_t launch_dtype(const void* x, const int32_t* packed, float* part,
                         int B, int K, int M, int bits, int splits,
                         int kp_per_split, cudaStream_t stream) {
  switch (bits) {
    case 2: return launch_bits<XT, 2>(x, packed, part, B, K, M, splits,
                                      kp_per_split, stream);
    case 3: return launch_bits<XT, 3>(x, packed, part, B, K, M, splits,
                                      kp_per_split, stream);
    case 4: return launch_bits<XT, 4>(x, packed, part, B, K, M, splits,
                                      kp_per_split, stream);
    case 8: return launch_bits<XT, 8>(x, packed, part, B, K, M, splits,
                                      kp_per_split, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

namespace repro_torch {

cudaError_t qmm_launch(const void* x, bool x_bf16, const int32_t* packed,
                       float* part, int B, int K, int M, int bits,
                       int splits, int kp_per_split, cudaStream_t stream) {
  return x_bf16 ? launch_dtype<__nv_bfloat16>(x, packed, part, B, K, M, bits,
                                              splits, kp_per_split, stream)
                : launch_dtype<float>(x, packed, part, B, K, M, bits, splits,
                                      kp_per_split, stream);
}

}  // namespace repro_torch
