"""Sticky prefix-affinity routing.

Each replica's prefix-cache trie is per-process: a shared prompt header
only pays off when its requests land on the replica that already holds
the pages.  The router hashes the prompt HEADER (the first
``header_len`` tokens — page-aligned workloads share exactly these) and
picks a replica by rendezvous (highest-random-weight) hashing:

- stable: the same header always prefers the same replica, across
  router restarts and regardless of replica health churn (the
  preference is computed over ALL replica slots, healthy or not, so a
  replica that bounces gets its old traffic back);
- minimally disruptive: when the preferred replica is out, only ITS
  headers move (to their second-choice replica) — rendezvous hashing's
  defining property, no ring to rebuild.

Hashes are ``zlib.crc32`` — process-stable (``hash()`` is salted by
PYTHONHASHSEED) and already the repo's idiom for cross-process
determinism (shadow selection, param init).
"""
from __future__ import annotations

import zlib

import numpy as np

__all__ = ["prefix_key", "rendezvous_rank"]


def prefix_key(prompt, header_len: int = 16) -> int:
    """Affinity key for a prompt: crc32 over its first ``header_len``
    token ids (int32 little-endian bytes).  Prompts sharing a header at
    least that long share a key — the same prefix granularity the trie
    caches at page size 16."""
    head = np.asarray(prompt, np.int32).reshape(-1)[:header_len]
    return zlib.crc32(head.astype("<i4").tobytes())


def rendezvous_rank(key: int, n: int) -> list:
    """Replica indices ranked by rendezvous weight for ``key`` (best
    first): each (key, replica) pair gets an independent crc32 score;
    the ranking is stable per key and uniform across keys.  ``n`` is the
    fleet's replica-slot count — rank over ALL slots and let the caller
    skip unavailable ones, so stickiness survives a bounce."""
    if n < 1:
        raise ValueError(f"need at least one replica slot, got {n}")
    scores = [
        (zlib.crc32(f"{key}:{i}".encode()), i) for i in range(n)
    ]
    scores.sort(key=lambda s: (-s[0], s[1]))
    return [i for _, i in scores]
