"""Public wrapper around the quant_matmul kernel.

Handles arbitrary leading batch dims, the affine dequant correction
``z = (2s/maxq)·acc − s·Σ_k x`` (the kernel stays a pure integer-grid
matmul) and dtype restoration.  Dispatch is by device: a CUDA tensor goes
to the hand-written kernel, a CPU tensor to the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.quant_matmul.kernel import quant_matmul_kernel
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
    x2 = x.reshape(-1, n)
    acc = quant_matmul_kernel(x2, packed, bits=bits)
    hsum = torch.sum(x2.to(torch.float32), dim=-1, keepdim=True)
    sf = s.to(torch.float32)
    z = acc * (2.0 * sf / maxq) - sf * hsum
    return z.to(x.dtype).reshape(*lead, packed.shape[1])
