// Launch interface of quant_matmul.cu.  The kernel source and its
// PyTorch binding (quant_matmul_binding.cpp) both include this header,
// so the two sides are compiled against one signature.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {

// How one launch tiles (B, K) x (K, M): output tiles of bm rows x bn
// columns (tiles_n x tiles_b of them, tile = row tile * tiles_n + column
// tile), the reduction walked in stages of kstep values.  Tiles
// 0 .. full-1 are one block each over all of K; each later tile is cut into
// `splits` ranges of k_per_split values (a multiple of kstep), one block
// each: units blocks in all.  rows16: the decode kernel (B <= 16), else
// the tiled one.
struct QmmPlan {
  bool rows16;
  int bm, bn, kstep;
  int tiles_n, tiles_b;
  int full, splits, k_per_split, units;
  int terms;  // bf16 terms one fp32 x value is split into (1 for bf16 x)
};

QmmPlan qmm_plan(int B, int K, int M, int bits, bool x_bf16, int sm_count);

// Operands.  x (B, K) fp32 or bf16 (x_bf16), row-major contiguous; packed
// (ceil(K / vals), M) int32, vals = 32 / bits codes per word along K.
// Epilogue off (s == nullptr): out (B, M) fp32 = sum_k x[b,k] code[k,j].
// Epilogue on: out (B, M) of x's dtype (out_bf16) =
//   (2 s / maxq) acc[b,j] - s sum_k x[b,k],   s read from the device.
// With split tiles (n = tiles_n * tiles_b - full of them): part
// (n * splits * bm * bn) fp32 and, with the epilogue, rs_part
// (n * splits * bm) fp32 are scratch, and counters (>= n) int32 are zero
// before the launch and zero again after it (the last block of a tile
// resets its counter).
struct QmmArgs {
  const void* x;
  int x_bf16;
  const int32_t* packed;
  int B, K, M, bits;
  const float* s;
  int maxq;
  void* out;
  int out_bf16;
  float* part;
  float* rs_part;
  int* counters;
};

// One launch; returns its cudaError_t.
cudaError_t qmm_launch(const QmmPlan& plan, const QmmArgs& args,
                       cudaStream_t stream);

}  // namespace repro_torch
