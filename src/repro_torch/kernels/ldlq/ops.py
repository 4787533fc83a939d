"""Blocked LDLQ with the CUDA in-block kernel.

The outer schedule is ``core.ldlq.blocked_schedule``, the one the plain
``ldlq_blocked`` runs: the trailing feedback ``base = Err @ U_panel`` is one
``torch.matmul`` per block (the JAX package also computes it outside its
Pallas kernel), and the sequential in-block recurrence runs in the CUDA
kernel, parallel over rows.  A CUDA tensor goes to the kernel; a CPU tensor
runs the plain ``ldlq_blocked``, as the JAX package's ``ldlq_pallas`` does
off the TPU.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.ldlq import blocked_schedule, ldlq_blocked
from repro_torch.kernels.ldlq.kernel import ldlq_block_kernel
from repro_torch.runtime.op_analysis import register_kernel

__all__ = ["ldlq"]


def ldlq(
    W: torch.Tensor,
    Udot: torch.Tensor,
    maxq: int,
    *,
    block: int = 128,
    noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """LDLQ codes of W (m, n) on the grid [0, maxq] with feedback Udot;
    ``noise`` (m, n) uniforms select stochastic rounding.  ``block`` is any
    divisor of n up to the kernel's 128."""
    if not W.is_cuda:
        return ldlq_blocked(W, Udot, maxq, block=min(block, W.shape[1]),
                            noise=noise)
    return blocked_schedule(W, Udot, maxq, block=block,
                            step=ldlq_block_kernel, noise=noise)


# the op analysis's FLOP formula (``runtime/op_analysis.py``): each of a
# row's nb columns feeds its error forward to the columns after it, one
# FMA each: M·nb·(nb−1)
@register_kernel("ldlq_block", "ldlq", launched=lambda W, *a: W.shape[0] > 0)
def _ldlq_flops(W, base, U, noise, maxq) -> float:
    M, nb = W.shape
    return float(M * nb * (nb - 1))
