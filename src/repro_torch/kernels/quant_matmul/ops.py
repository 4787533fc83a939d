"""Public wrapper around the quant_matmul kernel.

Handles arbitrary leading batch dims.  Dispatch is by device: a CUDA
tensor goes to the hand-written kernel with its affine dequant epilogue
``z = (2s/maxq)·acc − s·Σ_k x`` and the store in x's dtype inside the one
launch (``kernel.quant_matmul_fused``); a CPU tensor goes to the plain
version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.quant_matmul.kernel import quant_matmul_fused
from repro_torch.kernels.quant_matmul.ref import quant_matmul_ref


def quant_matmul(
    x: torch.Tensor,
    packed: torch.Tensor,
    bits: int,
    n: int,
    s: torch.Tensor,
    maxq: int,
) -> torch.Tensor:
    """z = x @ deq(Wq)^T; x: (..., n); packed: (rows, m) int32 → (..., m)."""
    if not x.is_cuda:
        return quant_matmul_ref(x, packed, bits, n, s, maxq)
    lead = x.shape[:-1]
    z = quant_matmul_fused(x.reshape(-1, n), packed, bits, s, maxq)
    return z.reshape(*lead, packed.shape[1])
