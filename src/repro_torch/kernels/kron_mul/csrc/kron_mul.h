// Launch interface of kron_mul.cu.  The kernel source and its PyTorch
// binding (kron_mul_binding.cpp) both include this header, so the two
// sides are compiled against one signature.
#pragma once

#include <cuda_runtime.h>

namespace repro_torch {

// Largest factors the kernel takes (A, B and one row of x must fit one
// block's shared memory together; qwen3-14b's widest is 128 x 136).
constexpr int kKronMaxP = 128;
constexpr int kKronMaxQ = 160;

// y[r] = (A kron B) x[r] for every row r of x (N, p*q) fp32 contiguous:
// with X = x[r] as a row-major (p, q) matrix, y[r] = A X B^T.  A (p, p)
// and B (q, q) fp32 row-major contiguous; y (N, p*q) fp32 contiguous.
// Returns the cudaError_t of the launch.
cudaError_t kron_mul_launch(const float* x, const float* A, const float* B,
                            float* y, int N, int p, int q,
                            cudaStream_t stream);

}  // namespace repro_torch
