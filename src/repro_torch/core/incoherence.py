"""Incoherence processing (QuIP Sec. 4): Algorithms 1 and 2.

Pre-processing conjugates (W, H) by seeded random orthogonal matrices built
as Kronecker products of two small factors (Lemma 5), with a random
permutation folded in (Table 5 ablation), after an optional diagonal rescale
(Sec. B.1).  Post-processing reverts everything.  The quantization range is
spectrum-based: ``s = rho * ||W||_F / sqrt(mn)`` (Sec. 4.2), not max-abs.

The JAX package regenerates each transform from ``(kind, n, seed)`` with
``jax.random``; torch cannot reproduce those bits, so the port builds its
transforms from a ``torch.Generator`` with the same construction and
carries the materialized factors (``A``, ``B``, ``signs``, ``perm``) in its
artifacts (see :mod:`repro_torch.serve.artifacts`).  Transforms are applied
along the last axis, never as a dense ``n x n`` matrix: the Kronecker
family through ``kernels.kron_mul`` and the Hadamard family through
``kernels.hadamard`` (the CUDA kernels for a CUDA tensor).  ``plain=True``
takes the kernels' plain versions on any device: the recompute oracle and
the dense ``dequantize()`` use it, so they check the kernels instead of
sharing them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Literal, Optional

import torch

from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.kernels.hadamard.ops import hadamard_transform
from repro_torch.kernels.hadamard.ref import hadamard_ref
from repro_torch.kernels.kron_mul.ops import kron_mul
from repro_torch.kernels.kron_mul.ref import kron_mul_ref

__all__ = [
    "kron_factors",
    "random_orthogonal",
    "OrthogonalTransform",
    "make_transform",
    "seeded_transform",
    "apply_transform",
    "diag_rescale",
    "quant_range",
    "to_grid",
    "from_grid",
    "incoherence_preprocess",
    "incoherence_postprocess",
    "mu_weight",
    "mu_hessian",
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
    n: int, generator: torch.Generator, *, device=DEFAULT_DEVICE,
    dtype=torch.float32,
) -> torch.Tensor:
    """Haar-distributed random orthogonal matrix (QR with sign fix).  Same
    construction as the JAX package; the bits differ (another RNG).
    ``generator`` must live on ``device``."""
    g = torch.randn(n, n, generator=generator, device=resolve_device(device),
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


def _pow2_split(n: int) -> tuple[int, int]:
    """n = odd * 2^k; returns (odd, 2^k)."""
    k = 0
    while n % 2 == 0:
        n //= 2
        k += 1
    return n, 1 << k


def make_transform(
    kind: TransformKind,
    n: int,
    generator: Optional[torch.Generator] = None,
    *,
    permute: bool = True,
    dtype=torch.float32,
) -> OrthogonalTransform:
    """A random structured orthogonal transform on R^n drawn from
    ``generator`` (on the generator's device), with the JAX package's
    construction: a random permutation (if ``permute``), then for
    ``kronecker`` Haar factors A (p×p, if p > 1) and B (q×q) with n = p·q
    (:func:`kron_factors`), for ``hadamard`` a Haar factor A on the odd
    part of n (if > 1) and ±1 signs on its power-of-two part."""
    if kind == "none":
        return OrthogonalTransform("none", n)
    if kind not in ("kronecker", "hadamard"):
        raise ValueError(f"unknown transform kind: {kind}")
    if generator is None:
        raise ValueError(f"a {kind} transform needs a torch.Generator")
    g = generator
    dev = g.device
    perm = torch.randperm(n, generator=g, device=dev) if permute else None
    if kind == "kronecker":
        p, q = kron_factors(n)
        A = random_orthogonal(p, g, device=dev, dtype=dtype) if p > 1 else None
        B = random_orthogonal(q, g, device=dev, dtype=dtype)
        return OrthogonalTransform(kind, n, A, B, None, perm)
    odd, pow2 = _pow2_split(n)
    if pow2 == 1:
        raise ValueError(f"hadamard transform needs an even dim, got {n}")
    A = random_orthogonal(odd, g, device=dev, dtype=dtype) if odd > 1 else None
    signs = (torch.randint(0, 2, (pow2,), generator=g, device=dev) * 2
             - 1).to(dtype)
    return OrthogonalTransform(kind, n, A, None, signs, perm)


def seeded_transform(kind: TransformKind, n: int, seed: int, *,
                     permute: bool = True, device=DEFAULT_DEVICE,
                     dtype=torch.float32) -> OrthogonalTransform:
    """:func:`make_transform` from a fresh generator seeded ``seed`` on
    ``device`` (the port's counterpart of the JAX package's
    ``make_transform(kind, n, seed)``; the factors differ, the
    construction does not).  Raises without a card unless given
    ``device="cpu"``."""
    g = torch.Generator(device=resolve_device(device))
    g.manual_seed(seed)
    return make_transform(kind, n, g, permute=permute, dtype=dtype)


def apply_transform(
    t: OrthogonalTransform, x: torch.Tensor, *, inverse: bool = False,
    plain: bool = False, scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Apply y = T (x / scale) (or T^T x with ``inverse``) along the last
    axis; ``plain`` runs the kernels' plain versions on any device.  The
    Kronecker family is one ``kron_mul`` call: its kernel takes the
    permutation, the division by ``scale`` and the transposed factors."""
    if inverse and scale is not None:
        raise ValueError("scale divides the input of the forward transform "
                         "only")
    if t.kind == "kronecker":
        kron_mul_ = kron_mul_ref if plain else kron_mul
        # (A ⊗ B) P (x / scale), or P^T (A^T ⊗ B^T) x
        return kron_mul_(x, t.A, t.B, perm=t.perm, inv_perm=t.inv_perm,
                         scale=scale, transpose=inverse)
    if scale is not None:
        x = x / scale
    if t.kind == "none":
        return x
    lead = x.shape[:-1]
    hadamard_ = hadamard_ref if plain else hadamard_transform
    if t.kind != "hadamard":
        raise ValueError(f"unknown transform kind: {t.kind}")
    odd = 1 if t.A is None else t.A.shape[0]
    pow2 = t.n // odd
    if not inverse:
        if t.perm is not None:
            x = torch.index_select(x, -1, t.perm)
        xm = hadamard_(x.reshape(*lead, odd, pow2), t.signs)  # H S
        if t.A is not None:
            xm = torch.matmul(t.A, xm)
        return xm.reshape(*lead, t.n)
    xm = x.reshape(*lead, odd, pow2)
    if t.A is not None:
        xm = torch.matmul(t.A.T, xm)
    xm = hadamard_(xm, t.signs, transpose=True)  # S^T H^T = S H
    y = xm.reshape(*lead, t.n)
    if t.inv_perm is not None:
        y = torch.index_select(y, -1, t.inv_perm)
    return y


# ---------------------------------------------------------------------------
# Algorithm 1 / 2 pieces
# ---------------------------------------------------------------------------


def diag_rescale(W: torch.Tensor, H: torch.Tensor, eps: float = 1e-12):
    """Sec. B.1 diagonal rescale minimizing tr(D^-1 H D^-1) ||W D||_F^2.

    D_i ∝ H_ii^{1/4} / ||W_{:,i}||^{1/2}.  Returns (W D, D^-1 H D^-1, D).
    """
    col_norm = torch.sqrt(torch.sum(W * W, dim=0) + eps)
    D = (torch.diagonal(H) + eps) ** 0.25 / torch.sqrt(col_norm)
    Wr = W * D[None, :]
    Hr = H / (D[:, None] * D[None, :])
    return Wr, Hr, D


def quant_range(W: torch.Tensor, rho: float) -> torch.Tensor:
    """Spectrum-based symmetric quantization range s = rho*||W||_F/sqrt(mn)."""
    m, n = W.shape
    return rho * torch.linalg.norm(W) / math.sqrt(m * n)


def to_grid(W: torch.Tensor, s: torch.Tensor, maxq: int) -> torch.Tensor:
    """Map [-s, s] -> [0, maxq] (continuous; rounding happens in LDLQ)."""
    return (W / s + 1.0) * (maxq / 2.0)


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
    Wq: torch.Tensor, state: PreprocessState, *, plain: bool = False
) -> torch.Tensor:
    """Algorithm 2: revert grid scale, transforms and diagonal rescale."""
    W = from_grid(Wq, state.s, state.maxq)
    W = apply_transform(state.U, W.T, inverse=True, plain=plain).T  # U^T W
    W = apply_transform(state.V, W, inverse=True, plain=plain)  # W V
    if state.D is not None:
        W = W / state.D[None, :]
    return W


TransformFactory = Callable[[str, int, int, bool], OrthogonalTransform]


def incoherence_preprocess(
    W: torch.Tensor,
    H: torch.Tensor,
    *,
    bits: int,
    seed: int,
    rho: float = 2.4,
    alpha: float = 0.01,
    kind: TransformKind = "kronecker",
    rescale: bool = True,
    permute: bool = True,
    spectrum_range: bool = True,
    transforms: Optional[TransformFactory] = None,
):
    """Algorithm 1.  Returns (W_grid, H_tilde, state).

    W_grid lives on the continuous grid domain [0, maxq]; H_tilde is the
    conjugated Hessian to feed LDLQ.  The U (m side) and V (n side)
    transforms come from ``transforms(kind, n, seed, permute)`` with seeds
    ``2·seed + 1`` and ``2·seed + 2`` (default :func:`seeded_transform` on
    W's device; the tests pass the JAX package's factors instead).
    """
    m, n = W.shape
    maxq = 2**bits - 1
    # line: H <- H + alpha mean(diag H) I   (OPTQ damping, kept under IncP)
    H = H + alpha * torch.mean(torch.diagonal(H)) * torch.eye(
        n, dtype=H.dtype, device=H.device)
    D = None
    if rescale:
        W, H, D = diag_rescale(W, H)
    if transforms is None:
        def transforms(kind_, n_, seed_, permute_):
            return seeded_transform(kind_, n_, seed_, permute=permute_,
                                    device=W.device, dtype=W.dtype)
    U = transforms(kind, m, seed * 2 + 1, permute)
    V = transforms(kind, n, seed * 2 + 2, permute)
    # W <- U W V^T ; H <- V H V^T, all via structured ops
    W = apply_transform(V, W)  # rows: W V^T
    W = apply_transform(U, W.T).T  # cols: U W
    H = apply_transform(V, H)  # H V^T
    H = apply_transform(V, H.T).T  # V H V^T
    H = (H + H.T) * 0.5  # re-symmetrize fp error
    if spectrum_range:
        s = quant_range(W, rho)
    else:
        s = torch.max(torch.abs(W))
    Wg = to_grid(W, s, maxq)
    return Wg, H, PreprocessState(U=U, V=V, D=D, s=s, maxq=maxq)


# ---------------------------------------------------------------------------
# Incoherence measurement (Figures 2/3)
# ---------------------------------------------------------------------------


def mu_weight(W: torch.Tensor) -> torch.Tensor:
    """µ_W such that max|W_ij| = µ ||W||_F / sqrt(mn) (Def. 1)."""
    m, n = W.shape
    return torch.max(torch.abs(W)) * math.sqrt(m * n) / torch.linalg.norm(W)


def eigh_sym(H: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Eigendecomposition of the symmetrized H, (H + Hᵀ)/2, as
    ``jnp.linalg.eigh`` computes it by default."""
    return torch.linalg.eigh((H + H.T) / 2)


def mu_hessian(H: torch.Tensor) -> torch.Tensor:
    """µ_H such that max|Q_ij| = µ/sqrt(n) for eigvecs Q of H (Def. 1)."""
    n = H.shape[0]
    _, Q = eigh_sym(H)
    return torch.max(torch.abs(Q)) * math.sqrt(n)
