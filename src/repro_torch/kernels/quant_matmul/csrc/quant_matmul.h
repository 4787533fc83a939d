// Launch interface of quant_matmul.cu.  The kernel source and its
// PyTorch binding (quant_matmul_binding.cpp) both include this header,
// so the two sides are compiled against one signature.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {

// part[split, b, j] = sum over split's packed rows of x[b, k] * code[k, j].
// x (B, K) fp32 (x_bf16 = false) or bf16, row-major contiguous; packed
// (ceil(K / vals), M) int32 with vals = 32 / bits codes per word along K;
// part (splits, B, M) fp32; split s covers packed rows
// [s * kp_per_split, min(Kp, (s + 1) * kp_per_split)).  Returns the
// cudaError_t of the launch.
cudaError_t qmm_launch(const void* x, bool x_bf16, const int32_t* packed,
                       float* part, int B, int K, int M, int bits,
                       int splits, int kp_per_split, cudaStream_t stream);

}  // namespace repro_torch
