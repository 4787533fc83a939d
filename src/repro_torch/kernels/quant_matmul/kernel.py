"""Launch wrapper of the hand-written CUDA quant_matmul kernel.

``quant_matmul_kernel(x, packed, bits=...)`` computes the fp32 grid matmul
``acc[b, j] = Σ_k x[b, k] · unpack(packed)[k, j]`` — what the Pallas kernel
``repro/kernels/quant_matmul/kernel.py:quant_matmul_kernel`` computes.
``quant_matmul_fused(x, packed, bits, s, maxq)`` is the same launch with
the affine epilogue on: ``(2s/maxq)·acc − s·Σ_k x[b, k]`` in x's dtype,
the row sum, the sum over K splits and ``s`` (read on the card) all inside
the one kernel.  A CUDA tensor launches ``csrc/quant_matmul.cu`` through
the operator ``torch.ops.repro_torch.quant_matmul`` (and raises if it
cannot); a CPU tensor runs the plain versions in ``ref.py``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.quant_matmul.ref import (
    grid_matmul_ref,
    quant_matmul_ref,
)

__all__ = ["quant_matmul_kernel", "quant_matmul_fused", "x_terms", "COUNTS"]

# launches of the CUDA kernel (chip_smoke.py reads and resets this)
COUNTS = {"quant_matmul": 0}

# device -> int32 zeros: the kernel's per-tile K-split counters (each launch
# leaves them zero again)
_COUNTERS: dict = {}


def x_terms(K: int, dtype: torch.dtype) -> int:
    """bf16 terms the kernel splits one x value into (csrc ``qmm_plan``):
    a bf16 x is one exact term; an fp32 x three (exact) below K = 1024,
    else two (|x - hi - mid| <= 2^-16 |x|, inside the K·2^-24 gate with 4x
    to spare from K = 1024)."""
    if dtype == torch.bfloat16:
        return 1
    return 3 if K < 1024 else 2


def _check(x: torch.Tensor, packed: torch.Tensor, bits: int) -> None:
    if bits not in (2, 3, 4, 8):
        raise ValueError(f"unsupported bit width: {bits}")
    if x.ndim != 2 or packed.ndim != 2:
        raise ValueError(
            f"x must be (B, K) and packed (K/vals, M); got x {tuple(x.shape)}"
            f", packed {tuple(packed.shape)}"
        )
    vals = 32 // bits
    K = x.shape[1]
    Kp = packed.shape[0]
    if Kp != (K + vals - 1) // vals:
        raise ValueError(
            f"packed rows {Kp} x {vals} vals/word = {Kp * vals} does not "
            f"cover the reduction dim K={K} of x {tuple(x.shape)} at "
            f"{bits} bits"
        )
    if packed.dtype != torch.int32:
        raise ValueError(f"packed must be int32, got {packed.dtype}")


def _tile_counters(device: torch.device, B: int, M: int) -> torch.Tensor:
    need = -(-M // 128) * -(-max(B, 1) // 64)
    buf = _COUNTERS.get(device)
    if buf is None or buf.numel() < need:
        buf = torch.zeros(max(need, 1024), dtype=torch.int32, device=device)
        _COUNTERS[device] = buf
    return buf


def _launch(x, packed, bits, s, maxq, out_dtype):
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    if not packed.is_cuda or packed.device != x.device:
        raise ValueError("x and packed must be on the same CUDA device")
    B, M = x.shape[0], packed.shape[1]
    if B == 0 or M == 0:
        return torch.zeros((B, M), dtype=out_dtype, device=x.device)
    out = _build.ops().quant_matmul(x, packed, bits, s, maxq,
                                    _tile_counters(x.device, B, M))
    COUNTS["quant_matmul"] += 1
    return out


def quant_matmul_kernel(x: torch.Tensor, packed: torch.Tensor, *,
                        bits: int) -> torch.Tensor:
    """x (B, K) fp32/bf16; packed (ceil(K/vals), M) int32 -> (B, M) fp32."""
    _check(x, packed, bits)
    if not x.is_cuda:
        return grid_matmul_ref(x, packed, bits, x.shape[1])
    return _launch(x, packed, bits, None, 0, torch.float32)


def quant_matmul_fused(x: torch.Tensor, packed: torch.Tensor, bits: int,
                       s: torch.Tensor, maxq: int) -> torch.Tensor:
    """x (B, K) fp32/bf16 -> (B, M) in x's dtype, the dequantized product
    (2s/maxq)·acc − s·Σ_k x (one launch on the card)."""
    _check(x, packed, bits)
    if not x.is_cuda:
        return quant_matmul_ref(x, packed, bits, x.shape[1], s, maxq)
    s = torch.as_tensor(s).to(device=x.device, dtype=torch.float32)
    return _launch(x, packed, bits, s, maxq, x.dtype)
