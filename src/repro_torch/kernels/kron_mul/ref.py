"""Plain PyTorch versions of the Kronecker-product transform.

``kron_mul_ref`` runs the operations ``apply_transform`` and
``QuantizedLinear.forward`` have always run on the CPU, in their order —
the division by ``scale``, the ``index_select`` by ``perm``, ``A·X`` and
``·Bᵀ`` on the (p, q) view of each row, and for the transposed transform
the ``index_select`` by the inverse permutation — so every CPU result
stays bit for bit what it was; ``kron_mul_dense_ref`` materializes
``A ⊗ B`` (the thing the kernel avoids).
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["kron_mul_ref", "kron_mul_dense_ref"]


def kron_mul_ref(x: torch.Tensor, A: Optional[torch.Tensor],
                 B: torch.Tensor, *, perm: Optional[torch.Tensor] = None,
                 inv_perm: Optional[torch.Tensor] = None,
                 scale: Optional[torch.Tensor] = None,
                 transpose: bool = False) -> torch.Tensor:
    """Along the last axis of x (..., p*q); ``A=None`` is the p = 1 case.

    ``transpose=False``: y = (A ⊗ B)·(x / scale)[perm].
    ``transpose=True``:  y[perm] = (Aᵀ ⊗ Bᵀ)·x (``scale`` not taken).
    ``inv_perm`` is ``perm``'s inverse (computed when not given).
    """
    if transpose and scale is not None:
        raise ValueError("scale divides the input of the forward transform "
                         "only (transpose=False)")
    p = 1 if A is None else A.shape[0]
    q = B.shape[0]
    lead = x.shape[:-1]
    if scale is not None:
        x = x / scale
    if perm is not None and not transpose:
        x = torch.index_select(x, -1, perm)
    if transpose:
        A = None if A is None else A.T
        B = B.T
    xm = x.reshape(*lead, p, q)
    if A is not None:
        xm = torch.matmul(A, xm)  # A X
    y = torch.matmul(xm, B.T).reshape(*lead, p * q)  # X B^T
    if perm is not None and transpose:
        if inv_perm is None:
            inv_perm = torch.argsort(perm)
        y = torch.index_select(y, -1, inv_perm)
    return y


def kron_mul_dense_ref(x: torch.Tensor, A: Optional[torch.Tensor],
                       B: torch.Tensor) -> torch.Tensor:
    """Materialized ``(A ⊗ B)`` matmul."""
    K = B if A is None else torch.kron(A, B)
    return x @ K.T
