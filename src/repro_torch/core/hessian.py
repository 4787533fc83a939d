"""Proxy-Hessian estimation H = E[x x^T] from calibration activations.

The paper computes H per linear layer from 128×2048-token calibration
segments, one transformer block at a time, feeding each block the *already
quantized* prefix of the network (Sec. 6 "Setup").  ``HessianAccumulator``
is the building block; ``repro_torch.launch.quantize`` owns the
block-by-block schedule.  Sums are fp32 (``XᵀX`` as one ``torch.matmul``,
in full fp32 on the card: the quantize entry point turns TF32 off).  MoE
layers keep one H per expert over its *routed* tokens
(:func:`expert_hessians`), falling back to the layer-shared H for starved
experts.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.device import DEFAULT_DEVICE, resolve_device

__all__ = ["HessianAccumulator", "damp", "expert_hessians"]


@dataclasses.dataclass
class HessianAccumulator:
    """Running second-moment accumulator (fp32)."""

    H: torch.Tensor  # (n, n) running sum of x x^T
    count: torch.Tensor  # scalar token count

    @classmethod
    def create(cls, n: int, *,
               device=DEFAULT_DEVICE) -> "HessianAccumulator":
        device = resolve_device(device)
        return cls(H=torch.zeros((n, n), dtype=torch.float32, device=device),
                   count=torch.zeros((), dtype=torch.float32, device=device))

    def update(self, X: torch.Tensor,
               mask: Optional[torch.Tensor] = None) -> "HessianAccumulator":
        """X: (..., n) activations; mask: optional (...,) validity weights."""
        Xf = X.reshape(-1, X.shape[-1]).to(torch.float32)
        if mask is not None:
            mf = mask.reshape(-1).to(torch.float32)
            Xf = Xf * mf[:, None]
            cnt = torch.sum(mf)
        else:
            cnt = torch.tensor(float(Xf.shape[0]), device=Xf.device)
        return HessianAccumulator(H=self.H + Xf.T @ Xf,
                                  count=self.count + cnt)

    def update_segments(self, X: torch.Tensor) -> "HessianAccumulator":
        """Fold a batch of calibration segments in, ONE update per segment
        (X: (B, S, n)), so the final H is the same left-fold of identical
        (S, n) products for every chunking of the calibration batch."""
        acc = self
        for seg in range(X.shape[0]):
            acc = acc.update(X[seg])
        return acc

    def finalize(self) -> torch.Tensor:
        """Mean second moment; damping is applied later (Alg. 1 line 1)."""
        return self.H / torch.clamp(self.count, min=1.0)


def damp(H: torch.Tensor, alpha: float) -> torch.Tensor:
    """OPTQ-style damping: H + alpha * mean(diag(H)) * I."""
    n = H.shape[0]
    return H + alpha * torch.mean(torch.diagonal(H)) * torch.eye(
        n, dtype=H.dtype, device=H.device)


def expert_hessians(X: torch.Tensor, expert_idx: torch.Tensor,
                    num_experts: int, *, min_tokens: int = 64
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-expert proxy Hessians from routed calibration activations.

    X: (T, n) token activations entering the MoE block; ``expert_idx``:
    (T, k) top-k routing decisions (or (T,)).  Returns ``(Hs (E, n, n),
    counts (E,))``: expert e's ``Σ_t w_te x_t x_tᵀ / count_e``, with
    ``w_te`` the number of t's choices that are e.  An expert with fewer
    than ``min_tokens`` routed tokens gets the shared (all-token) H
    instead: a starved expert has no reliable curvature estimate, and the
    shared H is the right prior.  The tokens are grouped by expert, one
    fp32 matmul an expert (no (T, E, n, n) temporary)."""
    Xf = X.to(torch.float32)
    T, n = Xf.shape
    idx = expert_idx.reshape(T, -1).long()
    weights = torch.zeros((T, num_experts), dtype=torch.float32,
                          device=Xf.device)
    weights.scatter_add_(1, idx, torch.ones(idx.shape, dtype=torch.float32,
                                            device=Xf.device))
    counts = weights.sum(0)
    H_shared = Xf.T @ Xf / T
    Hs = torch.empty((num_experts, n, n), dtype=torch.float32,
                     device=Xf.device)
    for e in range(num_experts):
        if float(counts[e]) < min_tokens:
            Hs[e] = H_shared
            continue
        rows = torch.nonzero(weights[:, e]).reshape(-1)
        Xe = Xf[rows]
        Hs[e] = ((Xe * weights[rows, e][:, None]).T @ Xe
                 / torch.clamp(counts[e], min=1.0))
    return Hs, counts
