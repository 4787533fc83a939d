"""Proxy-Hessian estimation H = E[x x^T] from calibration activations.

The paper computes H per linear layer from 128×2048-token calibration
segments, one transformer block at a time, feeding each block the *already
quantized* prefix of the network (Sec. 6 "Setup").  ``HessianAccumulator``
is the building block; ``repro_torch.launch.quantize`` owns the
block-by-block schedule.  Sums are fp32 (``XᵀX`` as one ``torch.matmul``,
in full fp32 on the card: the quantize entry point turns TF32 off).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.device import DEFAULT_DEVICE, resolve_device

__all__ = ["HessianAccumulator", "damp"]


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
