"""Launch wrapper of the hand-written CUDA Kronecker-transform kernel.

``kron_mul_kernel(x, A, B)`` computes ``y = (A ⊗ B) x`` per row of x
(N, p*q) — what the Pallas kernel
``repro/kernels/kron_mul/kernel.py:kron_mul_kernel`` computes — with what
surrounds it in the incoherence processing folded in: ``perm`` gathers the
input (``transpose=False``) or scatters the output (``transpose=True``,
which applies ``Aᵀ ⊗ Bᵀ``, the inverse), and ``scale`` divides the input
(see ``ref.kron_mul_ref``).  A CUDA tensor launches ``csrc/kron_mul.cu``
through ``torch.ops.repro_torch.kron_mul`` (and raises if it cannot); a
CPU tensor runs the plain version ``ref.kron_mul_ref``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.kron_mul.ref import kron_mul_ref

__all__ = ["kron_mul_kernel", "check_factors", "COUNTS", "MAX_P", "MAX_Q"]

# launches of the CUDA kernel (chip_smoke.py reads and resets this)
COUNTS = {"kron_mul": 0}
MAX_P, MAX_Q = 192, 256  # csrc/kron_mul.h kKronMaxP / kKronMaxQ


def check_factors(p: int, q: int) -> None:
    """Raise the named ``ValueError`` for factors the CUDA kernel does not
    take (p > MAX_P or q > MAX_Q)."""
    if p > MAX_P or q > MAX_Q:
        raise ValueError(
            f"kron_mul factors {p} x {q} exceed the kernel's {MAX_P} x "
            f"{MAX_Q}")


def kron_mul_kernel(x: torch.Tensor, A: Optional[torch.Tensor],
                    B: torch.Tensor, *, perm: Optional[torch.Tensor] = None,
                    inv_perm: Optional[torch.Tensor] = None,
                    scale: Optional[torch.Tensor] = None,
                    transpose: bool = False) -> torch.Tensor:
    """x (N, p*q), A (p, p) or None (p = 1), B (q, q), fp32 -> (N, p*q)
    fp32; ``perm``/``inv_perm`` int64 (p*q,), ``scale`` fp32 (p*q,)."""
    if B.ndim != 2 or B.shape[0] != B.shape[1] or (
            A is not None and (A.ndim != 2 or A.shape[0] != A.shape[1])):
        raise ValueError(
            f"A and B must be square, got "
            f"{None if A is None else tuple(A.shape)} and {tuple(B.shape)}")
    p, q = (1 if A is None else A.shape[0]), B.shape[0]
    if x.ndim != 2 or x.shape[1] != p * q:
        raise ValueError(
            f"x feature dim {x.shape[-1]} != p*q = {p}*{q} = {p * q}")
    if transpose and scale is not None:
        raise ValueError("scale divides the input of the forward transform "
                         "only (transpose=False)")
    if not x.is_cuda:
        return kron_mul_ref(x, A, B, perm=perm, inv_perm=inv_perm,
                            scale=scale, transpose=transpose)
    if any(t is not None and t.dtype != torch.float32
           for t in (x, A, B, scale)):
        raise ValueError("the kron_mul kernel takes float32 operands only")
    check_factors(p, q)
    if perm is not None and inv_perm is None:
        inv_perm = torch.argsort(perm)
    y = _build.ops().kron_mul(x, A, B, perm, inv_perm, scale, transpose)
    if x.shape[0]:
        COUNTS["kron_mul"] += 1
    return y
