// In-block sequential LDLQ rounding for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/ldlq/kernel.py
// (ldlq_block_kernel / _ldlq_kernel).  For every row r of a (M, nb)
// column block, in column order k = 0 .. nb-1:
//
//     val = (W[r, k] + base[r, k]) + E[r, :] . U[:, k]
//     Q[r, k] = clip(round(val), 0, maxq);   E[r, k] = W[r, k] - Q[r, k]
//
// The recurrence feeds back W - Q, not W + base - Q.  Rounding is
// half-to-even (rintf, as torch.round and jnp.round; roundf would round
// half away from zero, and at 2 bits grid values land on .5 often enough
// to flip codes), or stochastic with caller-drawn uniforms.
//
// What bounds it: neither bytes nor operations.  A block of nb = 128
// columns moves 16 bytes and does 127 FMAs per weight, but each column
// depends on the previous one, so the time is the 128-step dependency
// chain.  Design: rows are independent, so the kernel parallelises over
// them, one warp per row: each lane keeps E for 4 of the 128 columns in
// registers (column j in lane j % 32, slot j / 32), a step is 4 FMAs per
// lane and a 5-level xor-shuffle reduction of E . U[:, k] (every lane ends
// with the same bits), and the owning lane stores the new E.  A warp per
// row rather than a thread per row keeps the card full at the narrow
// shapes: m = 1024 (attn.wk/wv) gives 1024 warps over 132 SMs instead of
// 32.  U[:, k] is read from shared memory stored transposed (ut[k][j]), so
// the 32 lanes read 32 consecutive words.  The last row tile is masked
// (warps past M exit after the shared-memory load), never padded.
#include "ldlq.h"

namespace {

constexpr int kWarps = 8;  // rows per block
constexpr int kThreads = kWarps * 32;
constexpr int kSlots = repro_torch::kLdlqMaxBlock / 32;
constexpr unsigned kFull = 0xffffffffu;

template <bool STOCH>
__global__ void __launch_bounds__(kThreads)
ldlq_block_kernel(const float* __restrict__ W, int ldw,
                  const float* __restrict__ base, int ldb,
                  const float* __restrict__ U,
                  const float* __restrict__ noise, int ldn,
                  float* __restrict__ Q, float* __restrict__ E, int M, int nb,
                  float maxq) {
  extern __shared__ float ut[];  // ut[k * nb + j] = U[j, k]
  for (int idx = threadIdx.x; idx < nb * nb; idx += kThreads) {
    const int j = idx / nb, k = idx - j * nb;
    ut[k * nb + j] = U[idx];
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= M) return;  // whole warps: the shuffles below stay full-warp

  float w[kSlots], wb[kSlots], u[kSlots], e[kSlots], q[kSlots];
#pragma unroll
  for (int t = 0; t < kSlots; ++t) {
    const int j = lane + 32 * t;
    const bool ok = j < nb;
    w[t] = ok ? W[(size_t)row * ldw + j] : 0.f;
    wb[t] = w[t] + (ok ? base[(size_t)row * ldb + j] : 0.f);
    u[t] = (STOCH && ok) ? noise[(size_t)row * ldn + j] : 0.f;
    e[t] = 0.f;
    q[t] = 0.f;
  }

#pragma unroll
  for (int t = 0; t < kSlots; ++t) {
    for (int kk = 0; kk < 32; ++kk) {
      const int k = 32 * t + kk;
      if (k >= nb) break;  // uniform across the warp
      const float* uk = ut + k * nb;
      float part = 0.f;
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        const int j = lane + 32 * s;
        if (j < nb) part = fmaf(e[s], uk[j], part);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        part += __shfl_xor_sync(kFull, part, off);
      const float val = __shfl_sync(kFull, wb[t], kk) + part;
      float qv;
      if (STOCH) {
        const float lo = floorf(val);
        const float r = __shfl_sync(kFull, u[t], kk);
        qv = lo + (r < val - lo ? 1.f : 0.f);
      } else {
        qv = rintf(val);
      }
      qv = fminf(fmaxf(qv, 0.f), maxq);
      if (lane == kk) {
        q[t] = qv;
        e[t] = w[t] - qv;
      }
    }
  }

#pragma unroll
  for (int t = 0; t < kSlots; ++t) {
    const int j = lane + 32 * t;
    if (j < nb) {
      Q[(size_t)row * nb + j] = q[t];
      E[(size_t)row * nb + j] = e[t];
    }
  }
}

// Allow the widest block's shared memory (64 KB at nb = 128), once per
// thread, instance and device rather than on every launch.
template <bool STOCH>
cudaError_t allow_smem() {
  constexpr int kMaxBytes =
      repro_torch::kLdlqMaxBlock * repro_torch::kLdlqMaxBlock * sizeof(float);
  thread_local int cached_device = -1;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess || device == cached_device) return err;
  err = cudaFuncSetAttribute(ldlq_block_kernel<STOCH>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxBytes);
  if (err == cudaSuccess) cached_device = device;
  return err;
}

template <bool STOCH>
cudaError_t launch(const float* W, int ldw, const float* base, int ldb,
                   const float* U, const float* noise, int ldn, float* Q,
                   float* E, int M, int nb, float maxq, cudaStream_t stream) {
  const size_t bytes = (size_t)nb * nb * sizeof(float);
  const cudaError_t err = allow_smem<STOCH>();
  if (err != cudaSuccess) return err;
  const int grid = (M + kWarps - 1) / kWarps;
  ldlq_block_kernel<STOCH><<<grid, kThreads, bytes, stream>>>(
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
