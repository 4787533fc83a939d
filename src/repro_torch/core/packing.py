"""Bit-packing of quantized integer weights (same layout as ``repro``).

  * the logical quantized weight is ``Wq (m, n)`` with values in
    ``[0, 2^b - 1]``;
  * it is stored transposed and packed along the reduction dimension:
    ``packed (ceil(n / vals), m) int32`` with ``vals = 32 // b`` values per
    word.  Value ``j`` of word ``i`` holds ``Wq[:, i*vals + j]`` in bits
    ``[b*j, b*(j+1))``.

torch has no uint32 arithmetic, so words are assembled in int64 and
reinterpreted as int32; unpacking masks after every shift because int32
``>>`` is arithmetic (the top field of a word with bit 31 set would
otherwise come back sign-extended).
"""
from __future__ import annotations

import torch

__all__ = ["vals_per_word", "pack", "unpack", "packed_rows", "packed_shape"]


def vals_per_word(bits: int) -> int:
    if bits not in (2, 3, 4, 8):
        raise ValueError(f"unsupported bit width: {bits}")
    return 32 // bits


def packed_rows(n: int, bits: int) -> int:
    v = vals_per_word(bits)
    return (n + v - 1) // v


def packed_shape(m: int, n: int, bits: int) -> tuple[int, int]:
    """Stored shape of a packed (m, n) weight."""
    return packed_rows(n, bits), m


def pack(Wq: torch.Tensor, bits: int) -> torch.Tensor:
    """Pack integer grid weights Wq (m, n) -> (packed_rows(n), m) int32."""
    m, n = Wq.shape
    v = vals_per_word(bits)
    rows = packed_rows(n, bits)
    Wt = Wq.T.to(torch.int64)  # (n, m)
    pad = rows * v - n
    if pad:
        Wt = torch.nn.functional.pad(Wt, (0, 0, 0, pad))
    Wt = Wt.reshape(rows, v, m)
    shifts = (torch.arange(v, device=Wq.device, dtype=torch.int64) * bits)
    words = torch.sum(Wt << shifts[None, :, None], dim=1)  # < 2^32
    words = torch.where(words >= 2**31, words - 2**32, words)
    return words.to(torch.int32)


def unpack(packed: torch.Tensor, bits: int, n: int) -> torch.Tensor:
    """Inverse of :func:`pack`: (rows, m) int32 -> (m, n) int32 grid values."""
    rows, m = packed.shape
    v = vals_per_word(bits)
    mask = 2**bits - 1
    words = packed.to(torch.int32)[:, None, :]  # (rows, 1, m)
    shifts = (torch.arange(v, device=packed.device, dtype=torch.int32) * bits)
    vals = (words >> shifts[None, :, None]) & mask  # (rows, v, m)
    Wt = vals.reshape(rows * v, m)[:n]
    return Wt.T.contiguous()
