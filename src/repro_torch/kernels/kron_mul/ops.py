"""Public wrapper of the Kronecker-transform kernel.

``kron_mul(x, A, B)`` applies ``y = (A ⊗ B) x`` along the last axis of x
with any leading dims; ``A=None`` is the p = 1 case.  A CUDA tensor goes to
the hand-written kernel, a CPU tensor to the plain version.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.kron_mul.kernel import kron_mul_kernel
from repro_torch.kernels.kron_mul.ref import kron_mul_ref

__all__ = ["kron_mul"]


def kron_mul(x: torch.Tensor, A: Optional[torch.Tensor],
             B: torch.Tensor) -> torch.Tensor:
    """y = (A ⊗ B) x along the last axis; x (..., p*q)."""
    if not x.is_cuda:
        return kron_mul_ref(x, A, B)
    if A is None:
        A = torch.ones((1, 1), dtype=B.dtype, device=B.device)
    n = A.shape[0] * B.shape[0]
    lead = x.shape[:-1]
    return kron_mul_kernel(x.reshape(-1, n), A, B).reshape(*lead, n)
