"""Greedy local search (QuIP Sec. 4.2 / Supplement B.2, Algorithm 4).

Coordinate descent on the proxy loss restricted to the quantization grid.
Stand-alone it is adaptive rounding with linear feedback
``U = (H ⊙ M) diag(H)^{-1}``; as a post-pass after LDLQ it additionally
carries the initial guess through ``V = W - (Wtil - W)(H ⊙ M^T) diag(H)^{-1}``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.ldlq import quantize_nearest

__all__ = ["greedy_pass", "greedy"]


def greedy_pass(W: torch.Tensor, H: torch.Tensor, Wtil: torch.Tensor,
                maxq: int) -> torch.Tensor:
    """One pass of Algorithm 4 (columns in LDLQ order).

    W: (m, n) target weights on the grid domain; Wtil: initial guess
    (= W for stand-alone use).  Returns the updated quantized guess.
    """
    n = H.shape[0]
    dinv = 1.0 / torch.diagonal(H)
    mask_u = torch.triu(torch.ones((n, n), dtype=H.dtype, device=H.device),
                        diagonal=1)  # strictly upper M
    U = (H * mask_u) * dinv[None, :]
    # V = W - (Wtil - W) (H ⊙ M^T) diag(H)^-1
    V = W - (Wtil - W) @ ((H * mask_u.T) * dinv[None, :])
    What = Wtil.clone()
    for k in range(n):
        corr = (W - What) @ U[:, k]
        What[:, k] = quantize_nearest(V[:, k] + corr, maxq)
    return What


def greedy(W: torch.Tensor, H: torch.Tensor, maxq: int, *, passes: int = 10,
           init: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Multi-pass greedy updates (paper: 10 passes; 5 for 30B/66B).

    ``init=None`` runs stand-alone greedy (the first pass from Wtil = W is
    not a descent step: the initial point is off-grid); otherwise
    post-processes ``init`` (each pass is then a descent step).
    """
    What = W if init is None else init
    for _ in range(passes):
        What = greedy_pass(W, H, What, maxq)
    return What
