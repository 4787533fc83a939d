"""Launch wrapper of the hand-written CUDA randomized-Hadamard kernel.

``hadamard_kernel(x, signs)`` computes ``y = H_n (signs ⊙ x)/√n`` per row
of x (N, n), n a power of two — what the Pallas kernel
``repro/kernels/hadamard/kernel.py:hadamard_kernel`` computes (with
``transpose=True`` the transpose, ``signs ⊙ (H_n x)/√n``).  A CUDA tensor
launches ``csrc/hadamard.cu`` through ``torch.ops.repro_torch.hadamard``
(and raises if it cannot); a CPU tensor runs the plain version
``ref.hadamard_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.hadamard.ref import hadamard_ref

__all__ = ["hadamard_kernel", "check_dim", "COUNTS", "MAX_N"]

# launches of the CUDA kernel (chip_smoke.py reads and resets this)
COUNTS = {"hadamard": 0}
MAX_N = 32768  # csrc/hadamard.h kHadamardMaxN


def check_dim(n: int) -> None:
    if n < 2 or n & (n - 1):
        raise ValueError(
            f"Hadamard transform dim must be a power of two >= 2, got {n}")


def hadamard_kernel(x: torch.Tensor, signs: torch.Tensor, *,
                    transpose: bool = False) -> torch.Tensor:
    """x (N, n), signs (n,) fp32 -> (N, n) fp32."""
    if x.ndim != 2:
        raise ValueError(f"x must be (N, n), got {tuple(x.shape)}")
    n = x.shape[1]
    check_dim(n)
    if tuple(signs.shape) != (n,):
        raise ValueError(f"signs {tuple(signs.shape)} must be ({n},)")
    if not x.is_cuda:
        return hadamard_ref(x, signs, transpose=transpose)
    if x.dtype != torch.float32 or signs.dtype != torch.float32:
        raise ValueError("the Hadamard kernel takes float32 operands only")
    if n > MAX_N:
        raise ValueError(f"Hadamard dim {n} exceeds the kernel's {MAX_N}")
    y = _build.ops().hadamard(x, signs, transpose)
    if x.shape[0]:
        COUNTS["hadamard"] += 1
    return y
