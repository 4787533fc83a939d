"""QuIP inference representation: the packed :class:`QuantizedLinear`.

Inference never materializes the dequantized matrix:

    y = x·D^{-1} →(V)→ quant_matmul(packed) →(U^T)→ y

mirroring the paper's "multiply by W = U^T Ŵ V" factorization (Sec. 4.1).
The transforms and the grid matmul's epilogue run in fp32 whatever the
activation dtype (the factors are fp32); the result is cast back to the
input's dtype.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from repro_torch.core import incoherence as inc
from repro_torch.core import packing

__all__ = ["QuipConfig", "QuantizedLinear"]

_FACTORS = ("A", "B", "signs", "perm")


@dataclasses.dataclass(frozen=True)
class QuipConfig:
    """The quantization settings an artifact records (serving reads bits)."""

    bits: int = 2
    method: str = "ldlq"
    transform: str = "kronecker"

    @property
    def maxq(self) -> int:
        return 2**self.bits - 1


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

    def dequantize(self) -> torch.Tensor:
        """Materialize W_eff (m, n) fp32 — tests/export only."""
        Wq = packing.unpack(self.packed, self.bits, self.n).to(torch.float32)
        return inc.incoherence_postprocess(Wq, self.state)

    def forward(self, x: torch.Tensor, *,
                use_kernel: Optional[bool] = None) -> torch.Tensor:
        """y = x @ W_eff^T with x (..., n) — structured inference path.

        ``use_kernel`` overrides the layer default for this call: the
        serving adapter's paged paths pass ``True`` so every projection
        goes through ``quant_matmul`` (the CUDA kernel for a CUDA tensor).
        """
        h = x.to(torch.float32)
        if self.D is not None:
            h = h / self.D
        h = inc.apply_transform(self.transform("V"), h)
        z = self._matmul(h, use_kernel=use_kernel)
        return inc.apply_transform(
            self.transform("U"), z, inverse=True).to(x.dtype)

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
