"""Public wrapper of the Kronecker-transform kernel.

``kron_mul(x, A, B, perm=, inv_perm=, scale=, transpose=)`` applies
``y = (A ⊗ B)·(x / scale)[perm]`` (or, transposed, ``y[perm] = (Aᵀ ⊗ Bᵀ)·x``)
along the last axis of x with any leading dims; ``A=None`` is the p = 1
case.  A CUDA tensor goes to the hand-written kernel (one launch: the
gather, the division and the scatter are in it), a CPU tensor to the plain
version.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.kron_mul.kernel import kron_mul_kernel
from repro_torch.kernels.kron_mul.ref import kron_mul_ref
from repro_torch.runtime.op_analysis import register_kernel

__all__ = ["kron_mul"]


def kron_mul(x: torch.Tensor, A: Optional[torch.Tensor], B: torch.Tensor,
             *, perm: Optional[torch.Tensor] = None,
             inv_perm: Optional[torch.Tensor] = None,
             scale: Optional[torch.Tensor] = None,
             transpose: bool = False) -> torch.Tensor:
    """The transform along the last axis; x (..., p*q)."""
    kw = dict(perm=perm, inv_perm=inv_perm, scale=scale, transpose=transpose)
    if not x.is_cuda:
        return kron_mul_ref(x, A, B, **kw)
    n = x.shape[-1]
    lead = x.shape[:-1]
    return kron_mul_kernel(x.reshape(-1, n), A, B, **kw).reshape(*lead, n)


# the op analysis's FLOP formula (``runtime/op_analysis.py``): A·X·Bᵀ per
# row, 2·N·(p+q)·p·q
@register_kernel("kron_mul", "kron_mul", launched=lambda x, *a: x.shape[0] > 0)
def _kron_mul_flops(x, A, B, perm, inv_perm, scale, transpose) -> float:
    p, q = (1 if A is None else A.shape[0]), B.shape[0]
    return 2.0 * x.shape[0] * (p + q) * p * q
