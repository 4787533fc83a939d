"""QuIP Algorithm 3: the per-layer quantization pipeline and the packed
inference representation.

``quantize_layer`` = Alg. 1 (incoherence pre-processing) → rounding method
(LDLQ et al.) → packing, with the per-layer quality report.  The result is
a :class:`QuantizedLinear`: packed 2/3/4-bit integers plus the transform
factors.  Inference never materializes the dequantized matrix:

    y = x·D^{-1} →(V)→ quant_matmul(packed) →(U^T)→ y

mirroring the paper's "multiply by W = U^T Ŵ V" factorization (Sec. 4.1).
The transforms and the grid matmul's epilogue run in fp32 whatever the
activation dtype (the factors are fp32).  The output has the dtype the JAX
package's layer returns: its fp32 ``D`` and factors promote the result, so
a bf16 input gives fp32 whenever ``D`` or a transform other than ``none``
is present, and keeps its dtype only through identity transforms.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from typing import Callable, Optional

import torch
from torch import nn

from repro_torch.core import incoherence as inc
from repro_torch.core import packing
from repro_torch.core.hessian import damp
from repro_torch.core.methods import round_weights
from repro_torch.core.proxy import proxy_loss

__all__ = ["QuipConfig", "QuantizedLinear", "quantize_layer"]

_FACTORS = ("A", "B", "signs", "perm")


@dataclasses.dataclass(frozen=True)
class QuipConfig:
    bits: int = 2
    method: str = "ldlq"  # near | stoch | ldlq | ldlq_stoch | ldlq_rg | greedy
    incoherence: bool = True
    transform: inc.TransformKind = "kronecker"  # | "hadamard" | "none"
    rho: float = 2.4
    alpha: float = 0.01
    rescale: bool = True
    permute: bool = True
    spectrum_range: Optional[bool] = None  # default: == incoherence
    greedy_passes: int = 10
    block: int = 128
    use_kernel: bool = True  # quant_matmul on the inference path

    @property
    def maxq(self) -> int:
        return 2**self.bits - 1

    def label(self) -> str:
        return f"{self.method}{'+incp' if self.incoherence else ''}@{self.bits}b"


class QuantizedLinear(nn.Module):
    """Inference-ready quantized linear layer: y = x @ W_eff^T.

    ``packed``: (packed_rows(n), m) int32 along the reduction dim; ``s`` the
    scalar range, ``D`` the optional (n,) diagonal rescale, and the
    materialized factors of the m-side ``U`` and n-side ``V`` transforms —
    all registered buffers, so ``.to(device)`` moves the whole layer.
    """

    def __init__(self, packed: torch.Tensor, bits: int, m: int, n: int,
                 state: inc.PreprocessState, use_kernel: bool = True):
        super().__init__()
        if tuple(packed.shape) != packing.packed_shape(m, n, bits):
            raise ValueError(
                f"packed weight shape {tuple(packed.shape)} != expected "
                f"{packing.packed_shape(m, n, bits)} for ({m}, {n}) @ {bits}b"
            )
        self.bits, self.m, self.n = bits, m, n
        self.maxq = state.maxq
        self.use_kernel = use_kernel
        self.register_buffer("packed", packed.to(torch.int32))
        self.register_buffer("s", torch.as_tensor(state.s, dtype=torch.float32))
        self.register_buffer(
            "D", None if state.D is None else state.D.to(torch.float32))
        self._kinds = {}
        for side, t in (("U", state.U), ("V", state.V)):
            self._kinds[side] = t.kind
            for key in _FACTORS:
                val = getattr(t, key)
                if val is not None and key != "perm":
                    val = val.to(torch.float32)
                self.register_buffer(f"{side}_{key}", val)
            self.register_buffer(f"{side}_inv_perm", t.inv_perm)

    def transform(self, side: str) -> inc.OrthogonalTransform:
        g = lambda k: getattr(self, f"{side}_{k}")
        n = self.m if side == "U" else self.n
        return inc.OrthogonalTransform(
            self._kinds[side], n, g("A"), g("B"), g("signs"), g("perm"),
            g("inv_perm"),
        )

    @property
    def state(self) -> inc.PreprocessState:
        return inc.PreprocessState(
            U=self.transform("U"), V=self.transform("V"), D=self.D, s=self.s,
            maxq=self.maxq,
        )

    def dequantize(self, *, plain: bool = False) -> torch.Tensor:
        """Materialize W_eff (m, n) fp32 — tests/export only; ``plain``
        reverts the transforms with the kernels' plain versions."""
        Wq = packing.unpack(self.packed, self.bits, self.n).to(torch.float32)
        return inc.incoherence_postprocess(Wq, self.state, plain=plain)

    def forward(self, x: torch.Tensor, *, use_kernel: Optional[bool] = None,
                plain: bool = False) -> torch.Tensor:
        """y = x @ W_eff^T with x (..., n) — structured inference path.

        ``use_kernel`` overrides the layer default for this call: the
        serving adapter's paged paths pass ``True`` so every projection
        goes through ``quant_matmul`` (the CUDA kernel for a CUDA tensor).
        ``plain`` runs every step as plain PyTorch on any device (the
        transforms and the grid matmul): the recompute oracle's path.
        """
        if plain:
            use_kernel = False
        h = inc.apply_transform(self.transform("V"), x.to(torch.float32),
                                plain=plain, scale=self.D)  # V D^-1 x
        z = self._matmul(h, use_kernel=use_kernel)
        y = inc.apply_transform(self.transform("U"), z, inverse=True,
                                plain=plain)
        return y.to(self.out_dtype(x.dtype))

    def out_dtype(self, dtype: torch.dtype) -> torch.dtype:
        """The JAX package's result dtype for an input of ``dtype``: its
        fp32 ``D`` and transform factors promote the activations."""
        if self.D is None and self._kinds["U"] == self._kinds["V"] == "none":
            return dtype
        return torch.promote_types(dtype, torch.float32)

    def _matmul(self, h: torch.Tensor,
                use_kernel: Optional[bool] = None) -> torch.Tensor:
        """z = h @ deq(Wq)^T, deq(q) = (2s/maxq)·q − s."""
        uk = self.use_kernel if use_kernel is None else use_kernel
        if uk:
            from repro_torch.kernels.quant_matmul import ops as qmm

            return qmm.quant_matmul(
                h, self.packed, self.bits, self.n, self.s, self.maxq
            )
        Wq = packing.unpack(self.packed, self.bits, self.n)
        Wd = inc.from_grid(Wq.to(h.dtype), self.s.to(h.dtype), self.maxq)
        return h @ Wd.T


def quantize_layer(
    W: torch.Tensor,
    H: torch.Tensor,
    cfg: QuipConfig,
    *,
    seed: int = 0,
    generator: Optional[torch.Generator] = None,
    collect_stats: bool = True,
    transforms: Optional[inc.TransformFactory] = None,
    phases: Optional[Callable] = None,
) -> tuple[QuantizedLinear, dict]:
    """Algorithm 3 on one layer.  W: (m, n), H: (n, n) SPD proxy Hessian.

    With ``collect_stats`` the returned dict is the per-layer quality
    report the JAX package writes: µ(W)/µ(H) before and after
    preprocessing, the raw Hessian's spectrum extremes and condition
    number, the absolute and H-relative proxy loss, weight-error norms and
    the wall-clock spent in this call.  The µ(H) measurements
    eigendecompose H twice.  ``transforms`` overrides the seeded U/V
    transforms (see ``incoherence_preprocess``); ``generator`` the draws
    of the stochastic methods (default seeded ``seed ^ 0x5EED``);
    ``phases(name)``, if given, returns a context manager timing each step.
    """
    t0 = time.perf_counter()
    phase = phases or (lambda name: contextlib.nullcontext())
    m, n = W.shape
    W = W.to(torch.float32)
    H = H.to(torch.float32)
    spectrum = (cfg.spectrum_range if cfg.spectrum_range is not None
                else cfg.incoherence)
    with phase("preprocess"):
        if cfg.incoherence:
            Wg, Ht, state = inc.incoherence_preprocess(
                W, H, bits=cfg.bits, seed=seed, rho=cfg.rho,
                alpha=cfg.alpha, kind=cfg.transform, rescale=cfg.rescale,
                permute=cfg.permute, spectrum_range=spectrum,
                transforms=transforms,
            )
        else:
            # baseline processing: damping only, identity transforms
            Ht = damp(H, cfg.alpha)
            s = (inc.quant_range(W, cfg.rho) if spectrum
                 else torch.max(torch.abs(W)))
            state = inc.PreprocessState(
                U=inc.OrthogonalTransform("none", m),
                V=inc.OrthogonalTransform("none", n),
                D=None, s=s, maxq=cfg.maxq,
            )
            Wg = inc.to_grid(W, s, cfg.maxq)

    kw = {}
    if cfg.method in ("ldlq", "ldlq_stoch"):
        kw["block"] = cfg.block
    if cfg.method in ("ldlq_rg", "greedy"):
        kw["greedy_passes"] = cfg.greedy_passes
    if generator is None:
        generator = torch.Generator(device=W.device)
        generator.manual_seed(seed ^ 0x5EED)
    with phase("round"):
        Wq = round_weights(cfg.method, Wg, Ht, cfg.maxq, generator, **kw)
    with phase("pack"):
        packed = packing.pack(Wq.to(torch.int32), cfg.bits)
        layer = QuantizedLinear(packed, cfg.bits, m, n, state,
                                use_kernel=cfg.use_kernel)
    stats: dict = {}
    if collect_stats:
        with phase("stats_eigh"):
            evals_pre, Q_pre = inc.eigh_sym(H)
            _, Q_post = inc.eigh_sym(Ht)
        with phase("stats"):
            What = layer.dequantize()
            err = What - W
            # post-incoherence W on its native scale: invert only the grid
            # map, leaving the U·W·Vᵀ conjugation in place — µ of exactly
            # what the rounding method saw
            W_post = inc.from_grid(Wg, state.s, state.maxq)
            lmin = float(torch.min(evals_pre))
            lmax = float(torch.max(evals_pre))
            ploss = float(proxy_loss(What, W, H))
            # H-relative proxy loss: tr(ΔW H ΔWᵀ) / tr(W H Wᵀ), scale-free
            whw = float(torch.einsum("ij,jk,ik->", W, H, W))
            stats = {
                "proxy_loss": ploss,
                "proxy_rel": ploss / whw if whw > 0 else 0.0,
                "frob_rel_err": float(
                    torch.linalg.norm(err) / torch.linalg.norm(W)),
                "max_abs_err": float(torch.max(torch.abs(err))),
                "s": float(state.s),
                "mu_w_pre": float(inc.mu_weight(W)),
                "mu_w_post": float(inc.mu_weight(W_post)),
                "mu_h_pre": float(torch.max(torch.abs(Q_pre))
                                  * math.sqrt(n)),
                "mu_h_post": float(torch.max(torch.abs(Q_post))
                                   * math.sqrt(n)),
                "h_lambda_min": lmin,
                "h_lambda_max": lmax,
                "h_cond": lmax / max(lmin, 1e-30),
                "m": m,
                "n": n,
                "bits": cfg.bits,
                "method": cfg.label(),
                "wall_s": time.perf_counter() - t0,
            }
    return layer, stats
