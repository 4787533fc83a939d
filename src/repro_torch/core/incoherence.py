"""Incoherence processing (QuIP Sec. 4), inference half.

The JAX package regenerates each transform from ``(kind, n, seed)`` with
``jax.random``; torch cannot reproduce those bits, so the port carries the
materialized factors (``A``, ``B``, ``signs``, ``perm``) in its artifacts
(see :mod:`repro_torch.serve.artifacts`).  What is left here is applying
them: ``y = T x`` and its transpose along the last axis, never as a dense
``n x n`` matrix.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Literal, Optional

import torch

__all__ = [
    "kron_factors",
    "random_orthogonal",
    "OrthogonalTransform",
    "apply_transform",
    "from_grid",
    "incoherence_postprocess",
    "PreprocessState",
]

TransformKind = Literal["kronecker", "hadamard", "none"]


def kron_factors(n: int) -> tuple[int, int]:
    """Factor n = p*q with p <= q and p the largest divisor <= sqrt(n)."""
    p = 1
    for d in range(1, int(math.isqrt(n)) + 1):
        if n % d == 0:
            p = d
    return p, n // p


def random_orthogonal(
    n: int, generator: torch.Generator, *, device=None,
    dtype=torch.float32,
) -> torch.Tensor:
    """Haar-distributed random orthogonal matrix (QR with sign fix).  Same
    construction as the JAX package; the bits differ (another RNG)."""
    g = torch.randn(n, n, generator=generator, device=device,
                    dtype=torch.float32)
    q, r = torch.linalg.qr(g)
    q = q * torch.sign(torch.diagonal(r))[None, :]
    return q.to(dtype)


@dataclasses.dataclass
class OrthogonalTransform:
    """A structured orthogonal operator on R^n with materialized factors.

    kind = "kronecker": y = (A ⊗ B) P x;
    kind = "hadamard":  y = (A_odd ⊗ H_{2^k} S) P x (S random signs);
    kind = "none":      identity.
    """

    kind: TransformKind
    n: int
    A: Optional[torch.Tensor] = None  # (p, p)
    B: Optional[torch.Tensor] = None  # (q, q)
    signs: Optional[torch.Tensor] = None  # (2^k,) for hadamard
    perm: Optional[torch.Tensor] = None  # (n,) int64
    inv_perm: Optional[torch.Tensor] = None

    def __post_init__(self):
        if self.perm is not None and self.inv_perm is None:
            self.inv_perm = torch.argsort(self.perm)

    @property
    def p(self) -> int:
        return 1 if self.A is None else self.A.shape[0]

    @property
    def q(self) -> int:
        return self.n // self.p

    def tensors(self) -> dict:
        """The materialized factors (what a port artifact stores)."""
        out = {"A": self.A, "B": self.B, "signs": self.signs, "perm": self.perm}
        return {k: v for k, v in out.items() if v is not None}


def _fwht(x: torch.Tensor) -> torch.Tensor:
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


def apply_transform(
    t: OrthogonalTransform, x: torch.Tensor, *, inverse: bool = False
) -> torch.Tensor:
    """Apply y = T x (or T^T x with ``inverse``) along the last axis."""
    if t.kind == "none":
        return x
    lead = x.shape[:-1]
    if t.kind == "kronecker":
        p, q = t.p, t.q
        if not inverse:
            if t.perm is not None:
                x = torch.index_select(x, -1, t.perm)
            xm = x.reshape(*lead, p, q)
            if t.A is not None:
                xm = torch.matmul(t.A, xm)  # A X
            xm = torch.matmul(xm, t.B.T)  # X B^T
            return xm.reshape(*lead, t.n)
        xm = x.reshape(*lead, p, q)
        if t.A is not None:
            xm = torch.matmul(t.A.T, xm)
        xm = torch.matmul(xm, t.B)
        y = xm.reshape(*lead, t.n)
        if t.inv_perm is not None:
            y = torch.index_select(y, -1, t.inv_perm)
        return y
    if t.kind != "hadamard":
        raise ValueError(f"unknown transform kind: {t.kind}")
    odd = 1 if t.A is None else t.A.shape[0]
    pow2 = t.n // odd
    if not inverse:
        if t.perm is not None:
            x = torch.index_select(x, -1, t.perm)
        xm = x.reshape(*lead, odd, pow2) * t.signs
        xm = _fwht(xm)
        if t.A is not None:
            xm = torch.matmul(t.A, xm)
        return xm.reshape(*lead, t.n)
    xm = x.reshape(*lead, odd, pow2)
    if t.A is not None:
        xm = torch.matmul(t.A.T, xm)
    xm = _fwht(xm) * t.signs
    y = xm.reshape(*lead, t.n)
    if t.inv_perm is not None:
        y = torch.index_select(y, -1, t.inv_perm)
    return y


def from_grid(Wq: torch.Tensor, s: torch.Tensor, maxq: int) -> torch.Tensor:
    """Alg. 2 line 2: W <- s * ((Wq / maxq) * 2 - 1)."""
    return s * (Wq * (2.0 / maxq) - 1.0)


@dataclasses.dataclass
class PreprocessState:
    """Everything needed to revert Algorithm 1 (and to run inference)."""

    U: OrthogonalTransform  # m side
    V: OrthogonalTransform  # n side
    D: Optional[torch.Tensor]  # (n,) diagonal rescale, or None
    s: torch.Tensor  # scalar quantization range
    maxq: int


def incoherence_postprocess(
    Wq: torch.Tensor, state: PreprocessState
) -> torch.Tensor:
    """Algorithm 2: revert grid scale, transforms and diagonal rescale."""
    W = from_grid(Wq, state.s, state.maxq)
    W = apply_transform(state.U, W.T, inverse=True).T  # U^T W
    W = apply_transform(state.V, W, inverse=True)  # W V
    if state.D is not None:
        W = W / state.D[None, :]
    return W
