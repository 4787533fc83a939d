"""Slot-based paged KV-cache pool (vLLM-style).

Physical storage is one tensor per K/V of shape

    (n_layers, n_pages, page_size, n_kv_heads, head_dim)

and each admitted sequence owns a *slot*: a row of a block table mapping
logical page index -> physical page.  Pages are claimed lazily as the
sequence grows (``extend``) and returned on ``release``, so the pool can
overcommit; the engine resolves page exhaustion by evicting a victim.

Physical page 0 is reserved as a scratch page: padded batch lanes and
padded prefill tokens scatter their (ignored) writes there, and an empty
lane's block table points there.  Keys are stored post-RoPE.

Pages may be stored int8 (``dtype=torch.int8``): values are quantized
per-(token, head) on scatter (symmetric, scale = max|x|/127) with fp32
scales in parallel ``(L, P, ps, KV)`` tensors.  ``gather`` dequantizes;
the paged-attention kernels read int8 pages + scales directly.

The host-side bookkeeping is the JAX package's, decision for decision
(free-list order included), so block tables match it exactly.  Writes are
in place (``index_put_`` on the pool tensors) where the JAX package used a
donated functional update.  The prefix-cache trie and ``truncate`` are not
ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.models.layers import quantize_kv

__all__ = ["PagedKVPool", "pages_needed", "page_bucket"]


def pages_needed(n_tokens: int, page_size: int) -> int:
    return -(-n_tokens // page_size)


def page_bucket(n_pages: int, cap: int) -> int:
    """Round a page count up to a power of two, clamped to ``cap``."""
    b = 1
    while b < max(1, n_pages):
        b *= 2
    return min(b, cap)


@dataclasses.dataclass
class _Slot:
    pages: list  # physical page ids, logical order
    length: int  # valid tokens written


class PagedKVPool:
    """Page accounting (host) + paged K/V storage (device).

    ``admit(n_tokens)`` -> slot id or None (not enough free pages/slots);
    ``extend(slot, new_len)`` -> bool (claims pages to cover ``new_len``);
    ``release(slot)`` returns all pages.
    """

    def __init__(
        self,
        cfg: ArchConfig,
        *,
        n_pages: int,
        page_size: int,
        n_slots: int,
        max_pages_per_seq: int,
        dtype: Optional[torch.dtype] = None,
        device=DEFAULT_DEVICE,
    ):
        if n_pages < 2:
            raise ValueError("need >= 2 pages (page 0 is reserved scratch)")
        self.cfg = cfg
        self.page_size = page_size
        self.n_pages = n_pages
        self.n_slots = n_slots
        self.max_pages_per_seq = max_pages_per_seq
        self.device = resolve_device(device)
        fp = getattr(torch, cfg.dtype)
        dt = fp if dtype is None else dtype
        # fp dtype handed out by gather (and used for dequantized int8 reads)
        self._fp_dtype = fp if dt == torch.int8 else dt
        shape = (cfg.n_layers, n_pages, page_size, cfg.n_kv_heads,
                 cfg.head_dim)
        self.k = torch.zeros(shape, dtype=dt, device=self.device)
        self.v = torch.zeros(shape, dtype=dt, device=self.device)
        if dt == torch.int8:
            self.k_scale = torch.zeros(shape[:-1], dtype=torch.float32,
                                       device=self.device)
            self.v_scale = torch.zeros_like(self.k_scale)
        else:
            self.k_scale = self.v_scale = None
        self._free_pages = list(range(n_pages - 1, 0, -1))  # pop() -> low ids
        self._free_slots = list(range(n_slots - 1, -1, -1))
        self._slots: dict[int, _Slot] = {}
        self.peak_pages_in_use = 0

    # ---- accounting -----------------------------------------------------

    @property
    def pages_in_use(self) -> int:
        return (self.n_pages - 1) - len(self._free_pages)

    @property
    def is_int8(self) -> bool:
        return self.k_scale is not None

    def seq_capacity_tokens(self) -> int:
        return self.max_pages_per_seq * self.page_size

    def admit(self, n_tokens: int) -> Optional[int]:
        """Claim a slot + pages for a sequence of ``n_tokens``."""
        need = max(1, pages_needed(n_tokens, self.page_size))
        if not self._free_slots or need > self.max_pages_per_seq:
            return None
        if need > len(self._free_pages):
            return None
        slot = self._free_slots.pop()
        self._slots[slot] = _Slot(
            pages=[self._free_pages.pop() for _ in range(need)], length=0)
        self.peak_pages_in_use = max(self.peak_pages_in_use, self.pages_in_use)
        return slot

    def extend(self, slot: int, new_len: int) -> bool:
        """Claim pages so the slot can hold ``new_len`` tokens."""
        st = self._slots[slot]
        need = pages_needed(new_len, self.page_size) - len(st.pages)
        if need <= 0:
            return True
        if len(st.pages) + need > self.max_pages_per_seq:
            return False
        if need > len(self._free_pages):
            return False
        for _ in range(need):
            st.pages.append(self._free_pages.pop())
        self.peak_pages_in_use = max(self.peak_pages_in_use, self.pages_in_use)
        return True

    def release(self, slot: int) -> None:
        self._free_pages.extend(self._slots.pop(slot).pages)
        self._free_slots.append(slot)

    def length(self, slot: int) -> int:
        return self._slots[slot].length

    # ---- addressing -----------------------------------------------------

    def block_table(self, slot_ids: list[Optional[int]]) -> np.ndarray:
        """(B, max_pages_per_seq) int32; missing slots/pages -> scratch 0."""
        bt = np.zeros((len(slot_ids), self.max_pages_per_seq), np.int32)
        for b, s in enumerate(slot_ids):
            if s is None:
                continue
            pages = self._slots[s].pages
            bt[b, : len(pages)] = pages
        return bt

    def _addr(self, slot: Optional[int], pos: int) -> tuple[int, int]:
        if slot is None:
            return 0, 0  # scratch
        st = self._slots[slot]
        return st.pages[pos // self.page_size], pos % self.page_size

    def addresses(
        self, slot_ids: list[Optional[int]], positions: list[int]
    ) -> tuple[np.ndarray, np.ndarray]:
        """Physical (pages, offsets) int32 for one token per lane; ``None``
        lanes resolve to the scratch page.  Pair with :meth:`note_written`."""
        pages = np.zeros(len(slot_ids), np.int32)
        offs = np.zeros(len(slot_ids), np.int32)
        for b, (s, p) in enumerate(zip(slot_ids, positions)):
            pages[b], offs[b] = self._addr(s, p)
        return pages, offs

    def span_addresses(
        self,
        slot_ids: list[Optional[int]],
        starts: list[int],
        n_valids: list[int],
        width: int,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Physical (pages, offsets), each (B, width) int32, for one prefill
        chunk per lane at positions ``starts[b] .. starts[b] + n_valids[b]
        - 1``; the padded tail (and ``None`` lanes) resolves to the scratch
        page.  Pair with :meth:`note_span_written`."""
        B = len(slot_ids)
        pages = np.zeros((B, width), np.int32)
        offs = np.zeros((B, width), np.int32)
        for b, (s, start, n) in enumerate(zip(slot_ids, starts, n_valids)):
            if s is None or n <= 0:
                continue
            for t in range(n):
                pages[b, t], offs[b, t] = self._addr(s, start + t)
        return pages, offs

    def note_span_written(self, slot_ids, starts, n_valids) -> None:
        """Host-side length accounting for prefill chunks a fused step
        already scattered into the pool."""
        for s, start, n in zip(slot_ids, starts, n_valids):
            if s is not None and n > 0:
                st = self._slots[s]
                st.length = max(st.length, start + n)

    def note_written(self, slot_ids, positions) -> None:
        """Host-side length accounting for tokens a fused step already
        scattered into the pool."""
        for s, p in zip(slot_ids, positions):
            if s is not None:
                self._slots[s].length = max(self._slots[s].length, p + 1)

    # ---- device ops -----------------------------------------------------

    def scatter(self, pages, offs, k_new: torch.Tensor,
                v_new: torch.Tensor) -> None:
        """In-place write of new K/V at physical (pages, offs): index arrays
        of any shape S, values (L, *S, KV, hd)."""
        pages = torch.as_tensor(pages, dtype=torch.int64, device=self.device)
        offs = torch.as_tensor(offs, dtype=torch.int64, device=self.device)
        if self.is_int8:
            for store, scales, vals in ((self.k, self.k_scale, k_new),
                                        (self.v, self.v_scale, v_new)):
                q, sc = quantize_kv(vals)
                store[:, pages, offs] = q
                scales[:, pages, offs] = sc
        else:
            self.k[:, pages, offs] = k_new.to(self.k.dtype)
            self.v[:, pages, offs] = v_new.to(self.v.dtype)

    def gather(self, slot_ids: list[Optional[int]]):
        """-> (k, v) each (L, B, max_pages_per_seq*page_size, KV, hd) in the
        pool's fp dtype (int8 pools dequantize on the way out)."""
        bt = torch.as_tensor(self.block_table(slot_ids), dtype=torch.int64,
                             device=self.device)
        out = []
        for store, scales in ((self.k, self.k_scale), (self.v, self.v_scale)):
            g = store[:, bt]  # (L, B, Pmax, ps, KV, hd)
            if scales is not None:
                g = (g.to(torch.float32) * scales[:, bt][..., None]).to(
                    self._fp_dtype)
            L, B = g.shape[:2]
            out.append(g.reshape(L, B, -1, *store.shape[-2:]))
        return out[0], out[1]

    def write(self, slot_ids, positions, k_new, v_new) -> None:
        """Scatter one token per lane: k_new/v_new (L, B, KV, hd); advances
        each written slot's valid length to ``positions[b] + 1``."""
        pages, offs = self.addresses(slot_ids, positions)
        self.scatter(pages, offs, k_new, v_new)
        self.note_written(slot_ids, positions)

    def write_span(self, slot: int, start: int, n_valid: int, k_new,
                   v_new) -> None:
        """Scatter a prefill chunk: k_new/v_new (L, T, KV, hd); the first
        ``n_valid`` tokens land at positions start..start+n_valid-1, the
        padded tail goes to the scratch page."""
        T = k_new.shape[1]
        pages, offs = self.span_addresses([slot], [start], [n_valid], T)
        self.scatter(pages[0], offs[0], k_new, v_new)
        self.note_span_written([slot], [start], [n_valid])
