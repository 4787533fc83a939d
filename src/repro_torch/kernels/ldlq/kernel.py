"""Launch wrapper of the hand-written CUDA in-block LDLQ kernel.

``ldlq_block_kernel(Wb, base, Ub, maxq=...)`` computes one column block of
blocked LDLQ — what the Pallas kernel
``repro/kernels/ldlq/kernel.py:ldlq_block_kernel`` computes.  A CUDA tensor
launches ``csrc/ldlq.cu`` through ``torch.ops.repro_torch.ldlq_block``
(and raises if it cannot); a CPU tensor runs the plain version
``ref.ldlq_block_ref``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ldlq.ref import ldlq_block_ref

__all__ = ["ldlq_block_kernel", "COUNTS", "MAX_BLOCK"]

# launches of the CUDA kernel (chip_smoke.py reads and resets this)
COUNTS = {"ldlq": 0}
MAX_BLOCK = 128  # csrc/ldlq.h kLdlqMaxBlock


def _check(Wb, base, Ub, noise) -> None:
    if Wb.ndim != 2:
        raise ValueError(f"W block must be (M, nb), got {tuple(Wb.shape)}")
    M, nb = Wb.shape
    if tuple(base.shape) != (M, nb):
        raise ValueError(
            f"base {tuple(base.shape)} must match the W block ({M}, {nb})")
    if tuple(Ub.shape) != (nb, nb):
        raise ValueError(
            f"W block has {nb} columns but U block is {tuple(Ub.shape)}")
    if noise is not None and tuple(noise.shape) != (M, nb):
        raise ValueError(
            f"noise {tuple(noise.shape)} must match the W block ({M}, {nb})")


def ldlq_block_kernel(
    Wb: torch.Tensor,
    base: torch.Tensor,
    Ub: torch.Tensor,
    *,
    maxq: int,
    noise: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Wb, base (M, nb) fp32; Ub (nb, nb) strictly upper; nb <= 128.

    Returns (Q, E): the rounded block and its error W_block − Q."""
    _check(Wb, base, Ub, noise)
    if not Wb.is_cuda:
        return ldlq_block_ref(Wb, base, Ub, maxq=maxq, noise=noise)
    ops = [Wb, base, Ub] + ([] if noise is None else [noise])
    if any(t.dtype != torch.float32 for t in ops):
        raise ValueError("the LDLQ kernel takes float32 operands only")
    if any(t.device != Wb.device for t in ops):
        raise ValueError("the LDLQ operands must be on one CUDA device")
    if Wb.shape[1] > MAX_BLOCK:
        raise ValueError(
            f"LDLQ block width {Wb.shape[1]} exceeds the kernel's "
            f"{MAX_BLOCK}")
    Q, E = _build.ops().ldlq_block(Wb, base, Ub, noise, float(maxq))
    if Wb.shape[0]:
        COUNTS["ldlq"] += 1
    return Q, E
