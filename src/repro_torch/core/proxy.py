"""Adaptive-rounding proxy objective (Eq. 1) and related diagnostics."""
from __future__ import annotations

import torch

__all__ = ["proxy_loss", "trD_trH"]


def proxy_loss(What: torch.Tensor, W: torch.Tensor,
               H: torch.Tensor) -> torch.Tensor:
    """ℓ(What) = tr((What - W) H (What - W)^T)."""
    E = (What - W).to(torch.float32)
    return torch.einsum("ij,jk,ik->", E, H.to(torch.float32), E)


def trD_trH(H: torch.Tensor) -> torch.Tensor:
    """tr(D)/tr(H) for the LDL decomposition of H (Table 6 statistic)."""
    from repro_torch.core.ldlq import ldl_decomposition

    _, D = ldl_decomposition(H)
    return torch.sum(D) / torch.trace(H)
