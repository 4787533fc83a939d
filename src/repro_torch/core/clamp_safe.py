"""Algorithm 5: clamp-safe rounding via the convex program of Eq. (7).

    minimize    tr(H L^T L)
    over        L unit upper triangular
    subject to  e_i^T L^T L e_i <= 1 + c   for all i

solved with projected gradient descent (the constraint set is a product of
per-column norm balls on the strictly-upper part: ||L e_i||^2 = 1 +
||u_i||^2 <= 1 + c  <=>  ||u_i|| <= sqrt(c)), then QuIP rounding with
STOCHASTIC Q and U = L^{-1} - I in place of the LDL factor.

Theorem 7: with suitable (c, rho) all quantized weights stay in range
w.h.p. and the proxy loss is O~(tr(H^{1/2})^2 ||W||_F^2 / (n^2 4^b)).
As c -> inf the solution is the LDL factor and this reduces to base QuIP.
The paper found base QuIP preferable in practice; this module closes the
theory.  The solve is deterministic and runs in float32, or in float64 for
a float64 H; the rounding draws from an explicit ``torch.Generator``
(its bits cannot match ``jax.random``).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.ldlq import ldl_decomposition, quantize_stoch

__all__ = ["solve_clamp_safe_L", "clamp_safe_round"]


def _upper_inverse(M: torch.Tensor) -> torch.Tensor:
    eye = torch.eye(M.shape[0], dtype=M.dtype, device=M.device)
    return torch.linalg.solve_triangular(M, eye, upper=True)


def solve_clamp_safe_L(H: torch.Tensor, c: float, *, iters: int = 300,
                       lr: Optional[float] = None) -> torch.Tensor:
    """Projected gradient descent on Eq. (7).  Returns L (unit upper)."""
    n = H.shape[0]
    dt = torch.float64 if H.dtype == torch.float64 else torch.float32
    Hf = H.to(dt)
    eye = torch.eye(n, dtype=dt, device=H.device)
    mask = torch.triu(torch.ones(n, n, dtype=dt, device=H.device), 1)

    # warm start from the (unconstrained) LDL solution, projected:
    # L^{-1} = I + Udot  =>  L = (I + Udot)^{-1}
    Udot, _ = ldl_decomposition(Hf)
    U0 = (_upper_inverse(eye + Udot) - eye) * mask

    step = lr if lr is not None else 0.5 / (float(torch.trace(Hf)) / n
                                            + 1e-9)
    sqrt_c = c ** 0.5

    def project(U):
        norms = torch.sqrt(torch.sum(U * U, dim=0) + 1e-12)  # per column
        return U * torch.clamp(sqrt_c / norms, max=1.0)[None, :]

    U = project(U0)
    for _ in range(iters):
        grad = 2.0 * ((eye + U) @ Hf) * mask  # d/dU tr(H L^T L), upper part
        U = project(U - step * grad)
    return eye + U


def clamp_safe_round(W: torch.Tensor, H: torch.Tensor, maxq: int,
                     generator: torch.Generator, *, c: float = 0.5,
                     iters: int = 300) -> torch.Tensor:
    """Algorithm 5 rounding: stochastic Q with U = L^{-1} - I feedback.

    W on the grid domain [0, maxq]; returns the rounded grid weights."""
    n = H.shape[0]
    L = solve_clamp_safe_L(H, c, iters=iters)
    eye = torch.eye(n, dtype=L.dtype, device=L.device)
    U = ((_upper_inverse(L) - eye) * torch.triu(torch.ones_like(L), 1)).to(
        torch.float32)
    W = W.to(torch.float32)
    What = W.clone()
    for k in range(n):
        val = W[:, k] + (W - What) @ U[:, k]
        What[:, k] = quantize_stoch(val, maxq, generator)
    return What
