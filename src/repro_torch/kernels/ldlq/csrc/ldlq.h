// Launch interface of ldlq.cu.  The kernel source and its PyTorch binding
// (ldlq_binding.cpp) both include this header, so the two sides are
// compiled against one signature.
#pragma once

#include <cuda_runtime.h>

namespace repro_torch {

// Widest LDLQ block (columns) the kernel takes: 16 columns per lane, 8
// lanes per row.
constexpr int kLdlqMaxBlock = 128;

// In-block LDLQ rounding of M independent rows over nb <= 128 columns:
//
//   val_k = (W[r, k] + base[r, k]) + sum_j E[r, j] * U[j, k]
//   Q[r, k] = clip(round(val_k), 0, maxq),  E[r, k] = W[r, k] - Q[r, k]
//
// round is half-to-even (nearest) or, when noise is given, stochastic:
// floor(val) + (noise[r, k] < val - floor(val)).  The sum over j is taken
// in ascending j from 0, one correctly rounded fp32 FMA per term
// (ref.ldlq_block_seq_ref's order).  W, base and noise are
// (M, nb) fp32 with unit column stride and row strides ldw, ldb, ldn
// (elements); U is (nb, nb) fp32 row-major, strictly upper triangular; Q
// and E are (M, nb) fp32 contiguous.  Returns the cudaError_t of the
// launch.
cudaError_t ldlq_block_launch(const float* W, int ldw, const float* base,
                              int ldb, const float* U, const float* noise,
                              int ldn, float* Q, float* E, int M, int nb,
                              float maxq, cudaStream_t stream);

}  // namespace repro_torch
