"""Plain PyTorch version of the in-block LDLQ step.

``ldlq_block_ref`` computes what the CUDA kernel (and the JAX package's
Pallas ``ldlq_block_kernel``) computes for one column block, column by
column, in the kernels' summation order ``(W + base) + E·U``.  The outer
blocked schedule is ``core.ldlq.blocked_schedule``, shared by the plain
``ldlq_blocked`` and the kernel driver ``ops.ldlq``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.ldlq import quantize_nearest, quantize_with_noise

__all__ = ["ldlq_block_ref"]


def ldlq_block_ref(
    Wb: torch.Tensor,
    base: torch.Tensor,
    Ub: torch.Tensor,
    *,
    maxq: int,
    noise: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(Q, E) of one (M, nb) block: ``q_k = clip(round(W_k + base_k +
    E·Ub[:, k]), 0, maxq)``, ``E_k = W_k − q_k`` (the feedback is W − Q,
    not W + base − Q).  ``noise`` (M, nb) uniforms switch to stochastic
    rounding."""
    Q = torch.zeros_like(Wb)
    E = torch.zeros_like(Wb)
    for k in range(Wb.shape[1]):
        val = (Wb[:, k] + base[:, k]) + E @ Ub[:, k]
        q = (quantize_nearest(val, maxq) if noise is None
             else quantize_with_noise(val, maxq, noise[:, k]))
        Q[:, k] = q
        E[:, k] = Wb[:, k] - q
    return Q, E
