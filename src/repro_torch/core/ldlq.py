"""LDLQ: adaptive rounding with linear feedback (QuIP Sec. 3).

Implements the family of rounding methods

    What = Q(W + (W - What) @ U)                                  (Eq. 2)

with ``U`` strictly upper triangular, and the optimal LDL assignment

    H = (Udot + I) D (Udot + I)^T                                 (Eq. 4)

plus the OPTQ/GPTQ reference algorithm (the tests' oracle for Theorem 6:
OPTQ is exactly LDLQ) and the nearest / stochastic baselines.

All routines operate on the *integer quantization grid* ``[0, 2^b - 1]``;
scaling in and out of that grid is :mod:`repro_torch.core.incoherence`'s
job.  These are the plain versions; on the card the blocked schedule's
in-block recurrence runs in the CUDA kernel (``repro_torch.kernels.ldlq``).
Stochastic rounding draws from an explicit ``torch.Generator`` (its bits
cannot match ``jax.random``), or takes pre-drawn uniforms (``noise``) so
that two implementations can be fed the same random numbers.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

__all__ = [
    "ldl_decomposition",
    "quantize_nearest",
    "quantize_stoch",
    "quantize_with_noise",
    "uniform_noise",
    "ldlq",
    "blocked_schedule",
    "ldlq_block_step",
    "ldlq_blocked",
    "optq_reference",
]


def ldl_decomposition(H: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """UDU^T ("upper") LDL decomposition used by QuIP.

    Returns ``(Udot, D)`` with ``Udot`` *strictly* upper triangular and ``D``
    the non-negative diagonal (as a vector) such that

        H = (Udot + I) diag(D) (Udot + I)^T.

    Computed from a Cholesky factorization of the index-reversed matrix:
    if P is the flip permutation and P H P = L L^T, then U = P L P is upper
    triangular and H = U U^T; unit-normalizing columns of U gives the result.
    """
    Hr = torch.flip(H, (0, 1))
    L = torch.linalg.cholesky(Hr)
    U = torch.flip(L, (0, 1))  # upper triangular, H = U @ U.T
    d = torch.diagonal(U)
    Ut = U / d[None, :]  # unit upper triangular
    D = d * d
    n = H.shape[0]
    Udot = Ut - torch.eye(n, dtype=H.dtype, device=H.device)
    return Udot, D


def quantize_nearest(z: torch.Tensor, maxq: int) -> torch.Tensor:
    """Nearest rounding (half to even) to the grid {0, ..., maxq}."""
    return torch.clamp(torch.round(z), 0, maxq)


def quantize_with_noise(z: torch.Tensor, maxq: int,
                        noise: torch.Tensor) -> torch.Tensor:
    """Stochastic rounding with given uniforms in [0, 1): round up iff
    ``noise < z - floor(z)``, so E[Q(z)] = z inside the grid."""
    lo = torch.floor(z)
    return torch.clamp(lo + (noise < z - lo).to(z.dtype), 0, maxq)


def uniform_noise(z: torch.Tensor,
                  generator: Optional[torch.Generator]) -> torch.Tensor:
    """Uniforms of z's shape for stochastic rounding."""
    if generator is None:
        raise ValueError("stochastic rounding requires a torch.Generator")
    return torch.rand(z.shape, generator=generator, dtype=z.dtype,
                      device=z.device)


def quantize_stoch(z: torch.Tensor, maxq: int,
                   generator: Optional[torch.Generator]) -> torch.Tensor:
    """Unbiased stochastic rounding to the grid {0, ..., maxq}: E[Q(z)] = z."""
    return quantize_with_noise(z, maxq, uniform_noise(z, generator))


def _noise(W, stochastic, generator, noise):
    if noise is not None or not stochastic:
        return noise
    return uniform_noise(W, generator)


def _q(val, maxq, noise):
    if noise is None:
        return quantize_nearest(val, maxq)
    return quantize_with_noise(val, maxq, noise)


def ldlq(
    W: torch.Tensor,
    Udot: torch.Tensor,
    maxq: int,
    *,
    stochastic: bool = False,
    generator: Optional[torch.Generator] = None,
    noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Reference LDLQ: sequential column rounding with linear feedback.

    ``W``: (m, n) weights already mapped onto the quantization grid domain.
    ``Udot``: (n, n) strictly upper triangular linear feedback.  O(m n^2);
    the production path is :func:`ldlq_blocked` / ``kernels.ldlq``.
    """
    noise = _noise(W, stochastic, generator, noise)
    What = W.clone()
    for k in range(W.shape[1]):
        # (W - What) is zero for columns >= k (still unquantized), and
        # Udot[:, k] is supported on rows < k
        corr = (W - What) @ Udot[:, k]
        val = W[:, k] + corr
        What[:, k] = _q(val, maxq, None if noise is None else noise[:, k])
    return What


def blocked_schedule(
    W: torch.Tensor,
    Udot: torch.Tensor,
    maxq: int,
    *,
    block: int,
    step: Callable,
    noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The blocked (GPTQ-style two-level) LDLQ schedule over ``n / block``
    column blocks: the feedback from earlier blocks is one matmul
    ``Err @ Udot[:, blk]``, the in-block recurrence is ``step(Wb, base,
    Ub, maxq=, noise=) -> (Q, E)`` — :func:`ldlq_block_step` here, the CUDA
    kernel in ``kernels.ldlq.ops``."""
    m, n = W.shape
    if n % block:
        raise ValueError(
            f"W column count n={n} must be a multiple of the LDLQ block "
            f"size {block}"
        )
    W = W.contiguous()
    What = torch.empty_like(W)
    Err = torch.zeros_like(W)
    for c0 in range(0, n, block):
        c1 = c0 + block
        base = Err @ Udot[:, c0:c1]  # cross-block feedback, one matmul
        Q, E = step(W[:, c0:c1], base, Udot[c0:c1, c0:c1], maxq=maxq,
                    noise=None if noise is None else noise[:, c0:c1])
        What[:, c0:c1] = Q
        Err[:, c0:c1] = E
    return What


def ldlq_block_step(
    Wb: torch.Tensor,
    base: torch.Tensor,
    Ub: torch.Tensor,
    *,
    maxq: int,
    noise: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(Q, E) of one (m, block) column block, in the JAX package's
    ``ldlq_blocked`` summation order ``W + (base + E·Ub[:, k])``."""
    Q = torch.empty_like(Wb)
    E = torch.zeros_like(Wb)
    for k in range(Wb.shape[1]):
        val = Wb[:, k] + (base[:, k] + E @ Ub[:, k])
        qv = _q(val, maxq, None if noise is None else noise[:, k])
        Q[:, k] = qv
        E[:, k] = Wb[:, k] - qv
    return Q, E


def ldlq_blocked(
    W: torch.Tensor,
    Udot: torch.Tensor,
    maxq: int,
    *,
    block: int = 128,
    stochastic: bool = False,
    generator: Optional[torch.Generator] = None,
    noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Blocked LDLQ, plain version: :func:`blocked_schedule` over
    :func:`ldlq_block_step`.  Mathematically identical to :func:`ldlq` (the
    feedback is linear).  n must be divisible by ``block``."""
    noise = _noise(W, stochastic, generator, noise)
    return blocked_schedule(W, Udot, maxq, block=block, step=ldlq_block_step,
                            noise=noise)


def optq_reference(W: torch.Tensor, H: torch.Tensor,
                   maxq: int) -> torch.Tensor:
    """Textbook OPTQ/GPTQ (Frantar et al. 2023), a test oracle.

    After quantizing column t it updates every remaining column with the
    scaled error via the Cholesky factor of H^{-1}.  Per Theorem 6 this is
    exactly LDLQ.
    """
    n = H.shape[0]
    Hinv = torch.linalg.inv(H)
    C = torch.linalg.cholesky(Hinv, upper=True)  # Hinv = C^T C
    idx = torch.arange(n, device=W.device)
    Wcur = W.clone()
    for k in range(n):
        qv = quantize_nearest(Wcur[:, k], maxq)
        err = (Wcur[:, k] - qv) / C[k, k]
        mask = (idx > k).to(Wcur.dtype)
        Wcur = Wcur - torch.outer(err, C[k, :] * mask)
        Wcur[:, k] = qv
    return Wcur
