"""Plain PyTorch versions of the Kronecker-product transform.

``kron_mul_ref`` is the two-matmul arithmetic ``apply_transform`` has
always run on the CPU (``A·X`` then ``·Bᵀ`` on the (p, q) view of each
row), so the CPU path stays bit-for-bit what it was; ``kron_mul_dense_ref``
materializes ``A ⊗ B`` (the thing the kernel avoids).
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["kron_mul_ref", "kron_mul_dense_ref"]


def kron_mul_ref(x: torch.Tensor, A: Optional[torch.Tensor],
                 B: torch.Tensor) -> torch.Tensor:
    """y = (A ⊗ B) x along the last axis of x (..., p*q); ``A=None`` is
    the p = 1 case (y = B x)."""
    p = 1 if A is None else A.shape[0]
    q = B.shape[0]
    lead = x.shape[:-1]
    xm = x.reshape(*lead, p, q)
    if A is not None:
        xm = torch.matmul(A, xm)  # A X
    xm = torch.matmul(xm, B.T)  # X B^T
    return xm.reshape(*lead, p * q)


def kron_mul_dense_ref(x: torch.Tensor, A: Optional[torch.Tensor],
                       B: torch.Tensor) -> torch.Tensor:
    """Materialized ``(A ⊗ B)`` matmul."""
    K = B if A is None else torch.kron(A, B)
    return x @ K.T
