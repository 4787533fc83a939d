"""Launch wrapper of the hand-written CUDA quant_matmul kernel.

``quant_matmul_kernel(x, packed, bits=...)`` computes the fp32 grid matmul
``acc[b, j] = Σ_k x[b, k] · unpack(packed)[k, j]`` — what the Pallas kernel
``repro/kernels/quant_matmul/kernel.py:quant_matmul_kernel`` computes.  A
CUDA tensor launches ``csrc/quant_matmul.cu`` through the operator
``torch.ops.repro_torch.quant_matmul_partial`` (and raises if it cannot); a
CPU tensor runs the plain version ``ref.grid_matmul_ref``.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.quant_matmul.ref import grid_matmul_ref

__all__ = ["quant_matmul_kernel", "COUNTS"]

# launches of the CUDA kernel (chip_smoke.py reads and resets this)
COUNTS = {"quant_matmul": 0}


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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


def _splits(B: int, M: int, Kp: int, device: torch.device) -> int:
    """Split K when the (rows, columns) grid alone cannot fill the card:
    aim for two blocks per SM, keeping >= 8 packed words per split."""
    blocks = -(-M // 256) * max(1, -(-B // 8))
    target = 2 * _sm_count(device.index or 0)
    want = -(-target // blocks)
    return max(1, min(want, Kp // 8))


def quant_matmul_kernel(x: torch.Tensor, packed: torch.Tensor, *,
                        bits: int) -> torch.Tensor:
    """x (B, K) fp32/bf16; packed (ceil(K/vals), M) int32 -> (B, M) fp32."""
    _check(x, packed, bits)
    if not x.is_cuda:
        return grid_matmul_ref(x, packed, bits, x.shape[1])
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    if not packed.is_cuda or packed.device != x.device:
        raise ValueError("x and packed must be on the same CUDA device")
    B = x.shape[0]
    Kp, M = packed.shape
    splits = _splits(B, M, Kp, x.device)
    kp_per = -(-max(Kp, 1) // splits)
    splits = -(-max(Kp, 1) // kp_per)
    if B == 0 or M == 0:
        return torch.zeros((B, M), dtype=torch.float32, device=x.device)
    part = _build.ops().quant_matmul_partial(x, packed, bits, splits, kp_per)
    COUNTS["quant_matmul"] += 1
    return part[0] if splits == 1 else part.sum(0)
