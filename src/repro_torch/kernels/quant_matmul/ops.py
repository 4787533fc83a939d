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
from repro_torch.runtime.op_analysis import register_kernel


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


# the op analysis's FLOP formula (``runtime/op_analysis.py``): the grid
# matmul 2·B·K·M, and with ``s`` the affine epilogue's row sums (B·K) and
# its scale and subtract per output (2·B·M)
@register_kernel("quant_matmul", "quant_matmul", launched=lambda *a: True)
def _quant_matmul_flops(x, packed, bits, s, maxq, counters) -> float:
    B, K = x.shape
    M = packed.shape[1]
    return 2.0 * B * K * M + (B * K + 2.0 * B * M if s is not None else 0.0)
