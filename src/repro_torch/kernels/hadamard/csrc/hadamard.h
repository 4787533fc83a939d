// Launch interface of hadamard.cu.  The kernel source and its PyTorch
// binding (hadamard_binding.cpp) both include this header, so the two
// sides are compiled against one signature.
#pragma once

#include <cuda_runtime.h>

namespace repro_torch {

// Longest row the kernel takes: a row lives in shared memory (128 KB).
constexpr int kHadamardMaxN = 32768;

// Randomized Hadamard transform of every row r of x (N, n) fp32
// contiguous, n = 2^log2n:
//
//   signs_after = false:  y[r] = H_n (s * x[r]) / sqrt(n)
//   signs_after = true:   y[r] = s * (H_n x[r]) / sqrt(n)   (the transpose)
//
// with H_n the Sylvester-ordered (natural) +-1 Hadamard matrix and s (n,)
// fp32.  y (N, n) fp32 contiguous.  Returns the cudaError_t of the launch.
cudaError_t hadamard_launch(const float* x, const float* s, float* y, int N,
                            int log2n, bool signs_after,
                            cudaStream_t stream);

}  // namespace repro_torch
