"""Plain PyTorch versions of the packed quantized matmul.

Written as explicit unpack + dense matmul, independent of the kernel's
tiling: the tests hold them against the JAX package, and the CPU dispatch
in ``ops.py`` runs them.
"""
from __future__ import annotations

import torch

from repro_torch.core import packing
from repro_torch.core.incoherence import from_grid


def quant_matmul_ref(
    x: torch.Tensor,
    packed: torch.Tensor,
    bits: int,
    n: int,
    s: torch.Tensor,
    maxq: int,
) -> torch.Tensor:
    """z = x @ deq(Wq)^T via explicit unpack + dense matmul (fp32)."""
    Wq = packing.unpack(packed, bits, n).to(torch.float32)  # (m, n)
    Wd = from_grid(Wq, torch.as_tensor(s, dtype=torch.float32,
                                       device=Wq.device), maxq)
    return (x.to(torch.float32) @ Wd.T).to(x.dtype)


def grid_matmul_ref(x: torch.Tensor, packed: torch.Tensor, bits: int,
                    n: int) -> torch.Tensor:
    """Integer-grid matmul only (what the kernel itself computes), fp32."""
    Wq = packing.unpack(packed, bits, n).to(torch.float32)
    return x.to(torch.float32) @ Wq.T
