"""Plain PyTorch version of the in-block LDLQ step.

``ldlq_block_ref`` computes what the CUDA kernel (and the JAX package's
Pallas ``ldlq_block_kernel``) computes for one column block, column by
column, as ``(W + base) + E·U[:, k]``.  ``ldlq_block_seq_ref`` is the same
function in the CUDA kernel's own order (each error pushed forward into
running sums once it is known), which the kernel reproduces bit for bit.
The outer blocked schedule is ``core.ldlq.blocked_schedule``, shared by the
plain ``ldlq_blocked`` and the kernel driver ``ops.ldlq``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.ldlq import quantize_nearest, quantize_with_noise

__all__ = ["ldlq_block_ref", "ldlq_block_seq_ref", "fma32"]


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


def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """fp32 ``a·b + c`` rounded once to nearest even, as the card's FMA
    (``__fmaf_rn``), for finite fp32 operands on any device.  The product is
    exact in float64 (24 + 24 bits); the sum is taken in float64 and then
    rounded to odd (its exact error from TwoSum, and the odd neighbour
    where that error is not 0 and the sum's last bit is even), and
    rounding a value rounded to odd at 53 bits to 24 bits is the correctly
    rounded result (Boldo and Melquiond, 2008)."""
    p = a.double() * b.double()
    c = c.double()
    t = p + c
    bv = t - p
    err = (p - (t - bv)) + (c - bv)
    fix = (err != 0) & ((t.view(torch.int64) & 1) == 0)
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(t.dtype)
    return torch.where(fix, torch.nextafter(t, toward), t).float()


def ldlq_block_seq_ref(
    Wb: torch.Tensor,
    base: torch.Tensor,
    Ub: torch.Tensor,
    *,
    maxq: int,
    noise: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`ldlq_block_ref` in csrc/ldlq.cu's summation order:
    ``val_k = (W_k + base_k) + s_k`` with ``s_k = Σ_{j<k} E_j·Ub[j, k]``
    summed in ascending j from 0, one fp32 FMA per term (:func:`fma32`).
    Running sums for every column take each error as soon as it is known;
    a column's sum is read once, before its own error arrives, so the
    later terms added to it do not matter."""
    wb = Wb + base
    s = torch.zeros_like(Wb)
    Q = torch.zeros_like(Wb)
    E = torch.zeros_like(Wb)
    for k in range(Wb.shape[1]):
        val = wb[:, k] + s[:, k]
        q = (quantize_nearest(val, maxq) if noise is None
             else quantize_with_noise(val, maxq, noise[:, k]))
        Q[:, k] = q
        E[:, k] = Wb[:, k] - q
        s = fma32(E[:, k, None], Ub[k], s)
    return Q, E
