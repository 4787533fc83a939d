"""Plain PyTorch versions of the randomized Hadamard transform.

``fwht_ref`` is the butterfly ``apply_transform`` has always run on the
CPU (adjacent pairs to sums and differences, log2 n times), so the CPU path
stays bit-for-bit what it was; ``hadamard_dense_ref`` multiplies by the
materialized ``H_n·diag(s)/√n``.
"""
from __future__ import annotations

import torch

__all__ = ["sylvester", "fwht_ref", "hadamard_ref", "hadamard_dense_ref"]


def sylvester(n: int, *, dtype=torch.float32, device=None) -> torch.Tensor:
    """Unnormalized H_n (n a power of two) via Sylvester's construction."""
    if n <= 0 or n & (n - 1):
        raise ValueError(f"Hadamard order must be a power of two, got {n}")
    H = torch.ones((1, 1), dtype=dtype, device=device)
    while H.shape[0] < n:
        H = torch.cat([torch.cat([H, H], 1), torch.cat([H, -H], 1)], 0)
    return H


def fwht_ref(x: torch.Tensor) -> torch.Tensor:
    """Normalized fast Walsh–Hadamard transform along the last axis (pow2)."""
    n = x.shape[-1]
    stages = n.bit_length() - 1
    shape = x.shape
    y = x.reshape(-1, n)
    for _ in range(stages):
        y = y.reshape(y.shape[0], -1, 2)
        a, b = y[..., 0], y[..., 1]
        y = torch.cat([a + b, a - b], dim=-1)
    return (y * (n ** -0.5)).reshape(shape)


def hadamard_ref(x: torch.Tensor, signs: torch.Tensor, *,
                 transpose: bool = False) -> torch.Tensor:
    """y = H (signs ⊙ x)/√n, or with ``transpose`` signs ⊙ (H x)/√n."""
    if transpose:
        return fwht_ref(x) * signs
    return fwht_ref(x * signs)


def hadamard_dense_ref(x: torch.Tensor, signs: torch.Tensor) -> torch.Tensor:
    """y = x @ (H_n diag(signs) / √n)ᵀ with the matrix materialized."""
    n = x.shape[-1]
    M = sylvester(n, dtype=x.dtype, device=x.device) * signs * n ** -0.5
    return x @ M.T
