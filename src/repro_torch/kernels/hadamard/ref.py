"""Plain PyTorch versions of the randomized Hadamard transform.

``fwht_ref`` is the butterfly ``apply_transform`` has always run on the
CPU (adjacent pairs to sums and differences, log2 n times), so the CPU path
stays bit-for-bit what it was; ``hadamard_dense_ref`` multiplies by the
materialized ``H_n·diag(s)/√n``; ``hadamard_kernel_order_ref`` writes out
the CUDA kernel's data layout and stage grouping (registers, lane
shuffles, registers) in plain PyTorch, to show that they give
``hadamard_ref``'s bits.
"""
from __future__ import annotations

import torch

__all__ = ["sylvester", "fwht_ref", "hadamard_ref", "hadamard_dense_ref",
           "warp_layout", "hadamard_kernel_order_ref", "WARP_MAX_N"]

# rows up to this width live in one warp's registers (csrc/hadamard.cu)
WARP_MAX_N = 2048


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


def warp_layout(n: int) -> tuple[int, int, int]:
    """(R, G, V) of csrc/hadamard.cu's one-warp kernel for a row of n <=
    ``WARP_MAX_N``: element ``V·(G·i + l) + v`` sits in lane l's vector i,
    slot v (R vectors of V values per lane, G lanes per row)."""
    V = min(4, n)
    G = min(32, n // V)
    return n // (V * G), G, V


def _butterflies(y: torch.Tensor, dim: int, size: int) -> torch.Tensor:
    """Every stage over the index bits of ``dim`` (length ``size``), lowest
    bit first: pairs (j, j + h) -> (a + b, a - b)."""
    h = 1
    while h < size:
        shape = y.shape
        z = y.reshape(*shape[:dim], size // (2 * h), 2, h, *shape[dim + 1:])
        a, b = z.select(dim + 1, 0), z.select(dim + 1, 1)
        y = torch.stack([a + b, a - b], dim=dim + 1).reshape(shape)
        h *= 2
    return y


def _lane_shuffles(y: torch.Tensor, G: int) -> torch.Tensor:
    """The ``__shfl_xor_sync`` stages over the lane axis (-2): the lower
    lane keeps own + partner, the upper one partner − own."""
    lane = torch.arange(G, device=y.device)
    h = 1
    while h < G:
        partner = y.index_select(-2, lane ^ h)
        upper = ((lane & h) != 0)[:, None]
        y = torch.where(upper, partner - y, y + partner)
        h *= 2
    return y


def hadamard_kernel_order_ref(x: torch.Tensor, signs: torch.Tensor, *,
                              transpose: bool = False) -> torch.Tensor:
    """``hadamard_ref`` computed in the CUDA kernel's order: for n <=
    ``WARP_MAX_N`` a row as (R, G, V) registers, the stages over the
    vector slots, then the lanes by shuffles, then the vectors; above it,
    the shared-memory kernel's butterflies over the whole row.  Each sign
    and the 1/√n scale is its own fp32 product."""
    n = x.shape[-1]
    lead = x.shape[:-1]
    y = x.reshape(-1, n)
    if not transpose:
        y = y * signs
    if n > WARP_MAX_N:
        y = _butterflies(y, 1, n)
    else:
        R, G, V = warp_layout(n)
        y = y.reshape(-1, R, G, V)
        y = _butterflies(y, 3, V)
        y = _lane_shuffles(y, G)
        y = _butterflies(y, 1, R)
        y = y.reshape(-1, n)
    y = y * (n ** -0.5)
    if transpose:
        y = y * signs
    return y.reshape(*lead, n)
