"""Public wrapper of the randomized-Hadamard kernel.

``hadamard_transform(x, signs)`` applies ``y = H_n (signs ⊙ x)/√n`` along
the last axis of x with any leading dims (``transpose=True``: ``signs ⊙
(H_n x)/√n``).  A CUDA tensor goes to the hand-written kernel, a CPU tensor
to the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.hadamard.kernel import check_dim, hadamard_kernel
from repro_torch.kernels.hadamard.ref import hadamard_ref

__all__ = ["hadamard_transform"]


def hadamard_transform(x: torch.Tensor, signs: torch.Tensor, *,
                       transpose: bool = False) -> torch.Tensor:
    """y = H (signs ⊙ x)/√n along the last axis (power-of-two dim)."""
    n = x.shape[-1]
    check_dim(n)
    if not x.is_cuda:
        return hadamard_ref(x, signs, transpose=transpose)
    lead = x.shape[:-1]
    return hadamard_kernel(x.reshape(-1, n), signs,
                           transpose=transpose).reshape(*lead, n)
