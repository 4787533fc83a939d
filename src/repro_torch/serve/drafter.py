"""Self-drafting proposal sources for speculative decode.

A drafter proposes up to K likely next tokens for a lane from nothing but
that lane's own token history (prompt + generated so far) — no second
model, no extra device work.  The engine feeds the proposals to the
verifier (``CachedDecoder.verify_paged``), which accepts the longest
prefix matching what the target model would have emitted anyway.
Wrong proposals cost one rolled-back page write, never a wrong token, so
a drafter only ever trades wasted verify FLOPs for accepted tokens.

:class:`NgramDrafter` is prompt-lookup decoding: find the most recent
earlier occurrence of the lane's trailing n-gram and propose its
continuation, one token at a time — each drafted token is appended to a
hypothetical history before the next lookup, so a periodic stream
(repeated spans, code/JSON boilerplate, retrieval-echoed prompt text)
drafts at full depth K instead of truncating at the history's edge.
"""
from __future__ import annotations

import numpy as np

__all__ = ["NgramDrafter", "make_drafter"]


class NgramDrafter:
    """Prompt-lookup drafter over a lane's own token history.

    ``max_ngram`` bounds the pattern length tried (longest first — longer
    matches are more specific, so their continuations are more likely to
    be accepted); the minimum is a single-token match.
    """

    def __init__(self, k: int, max_ngram: int = 3):
        if k < 1:
            raise ValueError(f"draft depth k must be >= 1, got {k}")
        if max_ngram < 1:
            raise ValueError(f"max_ngram must be >= 1, got {max_ngram}")
        self.k = k
        self.max_ngram = max_ngram

    @staticmethod
    def _lookup_next(hist: np.ndarray, N: int, max_ngram: int):
        """Token following the most recent earlier occurrence of the
        trailing n-gram of ``hist[:N]`` (longest n first), or None.
        Shifted-slice compares, no window materialization — this runs
        per lane per drafted token on the engine's hot path."""
        for n in range(min(max_ngram, N - 1), 0, -1):
            # candidate starts j in [0, N-1-n]: the continuation
            # hist[j+n] always exists, and the trailing n-gram itself
            # (j == N-n) is excluded by the range
            m = hist[0 : N - n] == hist[N - n]
            for i in range(1, n):
                m &= hist[i : N - n + i] == hist[N - n + i]
            hit = np.flatnonzero(m)
            if hit.size:
                return int(hist[hit[-1] + n])
        return None

    def propose(self, history, k: int | None = None) -> np.ndarray:
        """Up to ``k`` (default: the drafter's depth) proposed tokens for
        the given history; may return fewer (or none) when no n-gram
        matches.  Iterative: each drafted token extends the hypothetical
        history before the next lookup, so periodic tails draft at full
        depth rather than stopping at the history's end."""
        k = self.k if k is None else min(k, self.k)
        src = np.asarray(history, np.int32).reshape(-1)
        N = len(src)
        hist = np.empty(N + k, np.int32)
        hist[:N] = src
        drafted = 0
        while drafted < k:
            nxt = self._lookup_next(hist, N + drafted, self.max_ngram)
            if nxt is None:
                break
            hist[N + drafted] = nxt
            drafted += 1
        return hist[N : N + drafted].copy()


def make_drafter(kind: str, k: int, **kw):
    """Build a drafter by name (``launch/serve.py --draft``)."""
    if kind == "ngram":
        return NgramDrafter(k, **kw)
    raise ValueError(f"unknown drafter {kind!r} (available: ngram)")
