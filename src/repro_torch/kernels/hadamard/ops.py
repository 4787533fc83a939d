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
from repro_torch.runtime.op_analysis import register_kernel

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


# the op analysis's FLOP formula (``runtime/op_analysis.py``): log2(n)
# butterfly stages of n adds a row, the signs and the 1/√n scale
@register_kernel("hadamard", "hadamard", launched=lambda x, *a: x.shape[0] > 0)
def _hadamard_flops(x, signs, signs_after) -> float:
    N, n = x.shape
    return float(N * n * (int(n).bit_length() - 1 + 2))
