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

Prefix caching (``prefix_cache=True``): every physical page carries a
refcount, and a trie over FULL pages of prompt tokens maps token blocks to
pages already holding their K/V.  ``admit(tokens=...)`` maps matched pages
into the new slot (refcount + 1) instead of claiming fresh ones, and the
engine starts prefill at ``length(slot)``.  Shared pages are immutable: a
write resolving into a page with refcount > 1 copies it first
(copy-on-write), and a full-prefix hit maps a private copy of its last
page at admission (copy-on-admit) so the engine can recompute the final
prompt token in place.  The trie holds its own reference on cached pages,
so they outlive their owner and are reclaimed LRU-first under pressure.

The host-side bookkeeping is the JAX package's, decision for decision
(free-list order, refcounts, trie contents and LRU order), so block tables
match it exactly.  Writes and page copies are in place on the pool
tensors where the JAX package used donated functional updates.

Under tensor parallelism (``serve/distributed.py``) each rank's tensors
hold only its KV heads (``kv_shards`` ranks split them): ``device_bytes``
is one rank's share, ``total_bytes`` the whole pool's.  The device-side
steps the host calls outside a dispatch — a page copy, a gather, the
gather-dense path's write — each go through one method
(``_copy_page``, ``gather_table``, ``_write_scatter``) that the
distributed pool replays on every rank.
"""
from __future__ import annotations

import dataclasses
import operator
from collections import OrderedDict
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.models.layers import quantize_kv
from repro_torch.serve.faults import NO_FAULTS
from repro_torch.serve.telemetry import weak_gauge

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


@dataclasses.dataclass
class _PrefixNode:
    """One full page of cached prompt tokens in the prefix trie."""

    key: tuple  # (parent node id, token-block bytes) — the trie dict key
    page: int  # physical page holding this block's K/V
    parent: int  # parent node id (0 = root)
    children: set = dataclasses.field(default_factory=set)  # child node ids


class PagedKVPool:
    """Page accounting (host) + paged K/V storage (device).

    ``admit(n_tokens, tokens=)`` -> slot id or None (not enough free
    pages/slots); ``extend(slot, new_len)`` -> bool (claims pages to cover
    ``new_len``); ``release(slot)`` drops the slot's page references.
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
        prefix_cache: bool = False,
        device=DEFAULT_DEVICE,
        kv_shards: int = 1,
    ):
        if n_pages < 2:
            raise ValueError("need >= 2 pages (page 0 is reserved scratch)")
        self.cfg = cfg
        self.page_size = page_size
        self.n_pages = n_pages
        self.n_slots = n_slots
        self.max_pages_per_seq = max_pages_per_seq
        self.device = resolve_device(device)
        self.kv_shards = kv_shards
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
        # ---- prefix cache state (inert when prefix_cache is False) ----
        self.prefix_cache = bool(prefix_cache)
        self._page_ref = np.zeros(n_pages, np.int32)  # 0 = free/scratch
        self._trie: OrderedDict[tuple, int] = OrderedDict()  # key -> node id
        self._nodes: dict[int, _PrefixNode] = {
            0: _PrefixNode(key=(), page=0, parent=0)  # root (no page)
        }
        self._next_node = 1
        self.cow_copies = 0  # pages copied before a write (COW + admit)
        self.prefix_hit_pages = 0  # pages mapped from the trie at admit
        # fault-injection hooks (serve/faults.py); the engine points this
        # at its plan — the inert default iterates an empty rule list
        self.faults = NO_FAULTS

    # ---- accounting -----------------------------------------------------

    @property
    def pages_in_use(self) -> int:
        return (self.n_pages - 1) - len(self._free_pages)

    @property
    def occupancy(self) -> float:
        return self.pages_in_use / (self.n_pages - 1)

    @property
    def is_int8(self) -> bool:
        return self.k_scale is not None

    def seq_capacity_tokens(self) -> int:
        return self.max_pages_per_seq * self.page_size

    def fits(self, n_tokens: int) -> bool:
        """Whether a sequence of n_tokens can EVER be resident."""
        return (
            n_tokens <= self.seq_capacity_tokens()
            and pages_needed(n_tokens, self.page_size) <= self.n_pages - 1
        )

    def _claim(self) -> int:
        page = self._free_pages.pop()
        self._page_ref[page] = 1
        return page

    def _decref(self, page: int) -> None:
        self._page_ref[page] -= 1
        if self._page_ref[page] == 0:
            self._free_pages.append(page)

    def _available(self, need: int) -> bool:
        """Whether ``need`` pages can be produced, reclaiming cache-only
        pages (LRU-first) if the free list alone cannot cover it."""
        if need <= len(self._free_pages):
            return True
        return self._reclaim(need - len(self._free_pages))

    def admit(self, n_tokens: int, tokens=None) -> Optional[int]:
        """Claim a slot + pages for a sequence of ``n_tokens``.

        With the prefix cache on and ``tokens`` (the request's prefix)
        given, full leading pages found in the trie are mapped shared
        (refcount + 1) and the slot's ``length`` starts at the cached token
        count.  A hit covering the WHOLE sequence maps a private copy of
        its last page and caps ``length`` at ``n_tokens - 1``: the engine
        still computes the final token, whose logits seed generation.
        """
        need_total = max(1, pages_needed(n_tokens, self.page_size))
        if not self._free_slots or need_total > self.max_pages_per_seq:
            return None
        if self.faults.rules and self.faults.fire("pool_exhausted"):
            return None  # injected transient exhaustion (admission defers)
        shared: list[int] = []
        if self.prefix_cache and tokens is not None:
            shared = [
                self._nodes[nid].page
                for nid in self._prefix_lookup(np.asarray(tokens, np.int32))
            ]
            shared = shared[:need_total]
        full_hit = len(shared) * self.page_size >= n_tokens
        fresh = need_total - len(shared) + (1 if full_hit else 0)
        pages = []
        for pg in shared:  # pin BEFORE any reclaim can free cache-only pages
            self._page_ref[pg] += 1
            pages.append(pg)
        if not self._available(fresh):
            for pg in shared:
                self._decref(pg)  # the trie still holds one ref
            return None
        slot = self._free_slots.pop()
        if full_hit:
            # copy-on-admit: the engine rewrites this page's final token,
            # and shared pages are immutable
            last = pages.pop()
            pages.append(self._copy_into_fresh(last))
            self._page_ref[last] -= 1
        while len(pages) < need_total:
            pages.append(self._claim())
        cached_len = min(len(shared) * self.page_size, n_tokens - 1)
        self._slots[slot] = _Slot(pages=pages, length=cached_len)
        self.prefix_hit_pages += len(shared)
        self.peak_pages_in_use = max(self.peak_pages_in_use, self.pages_in_use)
        return slot

    def extend(self, slot: int, new_len: int) -> bool:
        """Claim pages so the slot can hold ``new_len`` tokens."""
        st = self._slots[slot]
        need = pages_needed(new_len, self.page_size) - len(st.pages)
        if need <= 0:
            return True
        if self.faults.rules and self.faults.fire("pool_exhausted"):
            return False  # injected transient exhaustion (evict/requeue)
        if len(st.pages) + need > self.max_pages_per_seq:
            return False
        if not self._available(need):
            return False
        for _ in range(need):
            st.pages.append(self._claim())
        self.peak_pages_in_use = max(self.peak_pages_in_use, self.pages_in_use)
        return True

    def release(self, slot: int) -> None:
        st = self._slots.pop(slot)
        for page in st.pages:
            self._decref(page)
        self._free_slots.append(slot)

    def truncate(self, slot: int, new_len: int) -> int:
        """Roll a slot back to ``new_len`` valid tokens: wholly invalid
        trailing pages are unmapped (refcount decrement — a page the trie
        or a sibling still holds survives) and the valid length drops.
        Page contents are never touched; readers mask past ``ctx_len``.
        Returns the number of pages unmapped."""
        st = self._slots[slot]
        if new_len < 0 or new_len > st.length:
            raise ValueError(
                f"truncate to {new_len} outside [0, {st.length}] "
                f"(slot {slot})"
            )
        keep = max(1, pages_needed(new_len, self.page_size))
        dropped = 0
        while len(st.pages) > keep:
            self._decref(st.pages.pop())
            dropped += 1
        st.length = new_len
        return dropped

    def length(self, slot: int) -> int:
        return self._slots[slot].length

    # ---- prefix cache ---------------------------------------------------

    def _page_key(self, parent: int, tokens: np.ndarray, i: int) -> tuple:
        ps = self.page_size
        return (parent, tokens[i * ps : (i + 1) * ps].tobytes())

    def cached_prefix_pages(self, tokens) -> int:
        """How many full leading pages of ``tokens`` the trie holds now —
        the pages an admission would map instead of claiming (the walk
        refreshes the chain's LRU position, as admission would)."""
        if not self.prefix_cache:
            return 0
        return len(self._prefix_lookup(np.asarray(tokens, np.int32)))

    def _prefix_lookup(self, tokens: np.ndarray) -> list[int]:
        """Longest chain of cached full pages matching ``tokens``: trie
        node ids (root excluded), each moved to the LRU's young end."""
        out: list[int] = []
        parent = 0
        for i in range(len(tokens) // self.page_size):
            key = self._page_key(parent, tokens, i)
            nid = self._trie.get(key)
            if nid is None:
                break
            self._trie.move_to_end(key)
            out.append(nid)
            parent = nid
        return out

    def register_prefix(self, slot: int, tokens) -> None:
        """Insert the slot's fully written leading pages of ``tokens`` into
        the trie; each new node takes its own reference on the page."""
        if not self.prefix_cache:
            return
        tokens = np.asarray(tokens, np.int32)
        st = self._slots[slot]
        parent = 0
        for i in range(min(len(tokens), st.length) // self.page_size):
            key = self._page_key(parent, tokens, i)
            nid = self._trie.get(key)
            if nid is None:
                page = st.pages[i]
                nid = self._next_node
                self._next_node += 1
                self._trie[key] = nid
                self._nodes[nid] = _PrefixNode(key=key, page=page,
                                               parent=parent)
                self._nodes[parent].children.add(nid)
                self._page_ref[page] += 1
            parent = nid

    def _remove_node(self, nid: int) -> None:
        node = self._nodes.pop(nid)
        del self._trie[node.key]
        self._nodes[node.parent].children.discard(nid)
        self._decref(node.page)

    def _reclaim(self, need: int) -> bool:
        """Free ``need`` pages by dropping cache-only trie leaves (no live
        slot maps the page, no children), oldest first; dropping a leaf
        may expose its parent, so loop until satisfied or stuck."""
        if not self.prefix_cache or need <= 0:
            return need <= 0
        freed = 0
        progress = True
        while freed < need and progress:
            progress = False
            for key, nid in list(self._trie.items()):
                node = self._nodes[nid]
                if node.children or self._page_ref[node.page] != 1:
                    continue
                self._remove_node(nid)
                freed += 1
                progress = True
                if freed >= need:
                    break
        return freed >= need

    def _copy_into_fresh(self, src: int) -> int:
        """Claim a free page and copy ``src`` into it across all layers
        (a plain in-place tensor copy on the pool's device)."""
        dst = self._claim()
        self._copy_page(src, dst)
        self.cow_copies += 1
        return dst

    def _copy_page(self, src: int, dst: int) -> None:
        for store in self._storage():
            store[:, dst].copy_(store[:, src])

    def _ensure_private(self, slot: int, logical_page: int) -> int:
        """Copy-on-write guard: if the slot's logical page is mapped by
        anyone else (refcount > 1), swap in a private copy first."""
        st = self._slots[slot]
        page = st.pages[logical_page]
        if self._page_ref[page] <= 1:
            return page
        if not self._available(1):
            raise RuntimeError(
                "copy-on-write needs a free page but the pool is exhausted "
                "(evict a sequence or grow n_pages)"
            )
        dst = self._copy_into_fresh(page)
        st.pages[logical_page] = dst
        self._page_ref[page] -= 1
        return dst

    # ---- gauges ---------------------------------------------------------

    @property
    def shared_pages(self) -> int:
        """Physical pages currently mapped by more than one owner."""
        return int(np.sum(self._page_ref > 1))

    @property
    def cached_pages(self) -> int:
        """Full prompt pages resident in the prefix trie."""
        return len(self._trie)

    @property
    def max_page_ref(self) -> int:
        return int(self._page_ref.max())

    def metrics_gauges(self) -> dict:
        """Name -> zero-arg callback for every pool gauge, as
        :class:`repro_torch.serve.telemetry.MetricsRegistry` registers
        them: read at snapshot time, so the engine's registry reports live
        pool state without the pool knowing about telemetry.  Each holds
        the pool weakly (:func:`~repro_torch.serve.telemetry.weak_gauge`)."""
        def attr(name):
            return weak_gauge(self, operator.attrgetter(name))

        return {
            "pages_in_use": attr("pages_in_use"),
            "peak_pages_in_use": attr("peak_pages_in_use"),
            "occupancy": attr("occupancy"),
            "peak_occupancy": weak_gauge(
                self, lambda p: p.peak_pages_in_use / max(1, p.n_pages - 1)),
            "shared_pages": attr("shared_pages"),
            "cached_pages": attr("cached_pages"),
            "max_page_ref": attr("max_page_ref"),
            "cow_copies": attr("cow_copies"),
            "prefix_hit_pages": attr("prefix_hit_pages"),
        }

    def _storage(self) -> list:
        out = [self.k, self.v]
        if self.is_int8:
            out += [self.k_scale, self.v_scale]
        return out

    def device_bytes(self) -> int:
        """Bytes of KV page storage (values and int8 scales) on this
        process's device."""
        return sum(t.numel() * t.element_size() for t in self._storage())

    def total_bytes(self) -> int:
        """Bytes of the whole pool, over every rank that holds a share of
        its KV heads."""
        return self.device_bytes() * self.kv_shards

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
        lanes resolve to the scratch page.  Pair with :meth:`note_written`.
        Write intent: shared target pages are copy-on-write resolved."""
        pages = np.zeros(len(slot_ids), np.int32)
        offs = np.zeros(len(slot_ids), np.int32)
        for b, (s, p) in enumerate(zip(slot_ids, positions)):
            if s is not None:
                self._ensure_private(s, p // self.page_size)
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
        page.  Pair with :meth:`note_span_written`.  Write intent: shared
        target pages are copy-on-write resolved."""
        B = len(slot_ids)
        pages = np.zeros((B, width), np.int32)
        offs = np.zeros((B, width), np.int32)
        for b, (s, start, n) in enumerate(zip(slot_ids, starts, n_valids)):
            if s is None or n <= 0:
                continue
            for lp in range(start // self.page_size,
                            (start + n - 1) // self.page_size + 1):
                self._ensure_private(s, lp)
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
        return self.gather_table(self.block_table(slot_ids))

    def gather_table(self, block_table: np.ndarray):
        """:meth:`gather` of the pages a ``(B, Pa)`` block table names."""
        bt = torch.as_tensor(block_table, dtype=torch.int64,
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
        self._write_scatter(pages, offs, k_new, v_new)
        self.note_written(slot_ids, positions)

    def write_span(self, slot: int, start: int, n_valid: int, k_new,
                   v_new) -> None:
        """Scatter a prefill chunk: k_new/v_new (L, T, KV, hd); the first
        ``n_valid`` tokens land at positions start..start+n_valid-1, the
        padded tail goes to the scratch page."""
        T = k_new.shape[1]
        pages, offs = self.span_addresses([slot], [start], [n_valid], T)
        self._write_scatter(pages[0], offs[0], k_new, v_new)
        self.note_span_written([slot], [start], [n_valid])

    def _write_scatter(self, pages, offs, k_new, v_new) -> None:
        """The scatter of :meth:`write` and :meth:`write_span`: values the
        gather-dense forward returned."""
        self.scatter(pages, offs, k_new, v_new)
