// Launch interface of kron_mul.cu.  The kernel source and its PyTorch
// binding (kron_mul_binding.cpp) both include this header, so the two
// sides are compiled against one signature.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {

// Largest factors the kernel takes: one row of x (p padded to 32 rows)
// and a slice of B must fit one block's shared memory, with A beside them
// up to p = 128 and read from global memory above.  The dense family's
// widest are 128 x 224 (d_ff 28672) and 168 x 176 (d_ff 29568).
constexpr int kKronMaxP = 192;
constexpr int kKronMaxQ = 256;

// The operands of one launch.  For every row r of x (N rows of n = p*q
// fp32 values, row stride ldx, unit column stride), with the factors
// read as stored (trans = 0) or transposed (trans = 1), y (N, n) fp32
// contiguous is
//   trans = 0:  y[r] = (A kron B) x'[r],  x'[r][k] = x[r][perm[k]] / scale[perm[k]]
//   trans = 1:  y[r][perm[k]] = ((A^T kron B^T) x[r])[k]
// A (p, p) and B (q, q) fp32 row-major contiguous; A = nullptr is p = 1.
// perm and inv_perm (its inverse, both int64, n entries) are both given
// or both nullptr; scale (n fp32) may be nullptr, and is nullptr when
// trans = 1.
struct KronArgs {
  const float* x;
  const float* A;
  const float* B;
  const int64_t* perm;
  const int64_t* inv_perm;
  const float* scale;
  float* y;
  int64_t ldx;
  int N, p, q, trans;
};

// Returns the cudaError_t of the launch.
cudaError_t kron_mul_launch(const KronArgs& args, cudaStream_t stream);

}  // namespace repro_torch
