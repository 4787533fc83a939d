"""The failover journal: per-request emitted-token records the router
keeps so a replica crash mid-stream is recoverable.

The router appends every token it relays; when the upstream replica
dies before the ``done`` frame, :meth:`JournalEntry.resume_body` builds
the resubmission — the ORIGINAL request body plus ``resume_tokens`` —
and the replacement replica replays prompt+emitted and continues at the
same emission index.  Because greedy decode is argmax and on-device
sampling keys on ``fold_in(seed, emission_index)``, the spliced
continuation is token-identical to an uninterrupted run; the journal
never needs to store anything but the tokens themselves.

Entries are dropped on completion (the journal holds live requests
only); lifetime counters survive for ``/metricsz``.
"""
from __future__ import annotations

import itertools
from typing import Optional

__all__ = ["JournalEntry", "RequestJournal"]


class JournalEntry:
    """One live request's failover state."""

    __slots__ = ("jid", "body", "tokens", "attempts", "replica", "done",
                 "finish_reason", "stream", "head_sent")

    def __init__(self, jid: int, body: dict, stream: bool):
        self.jid = jid  # router-side id (replica rids are per-process)
        self.body = body  # original parsed JSON body, never mutated
        self.tokens: list[int] = []  # every token relayed to the client
        self.attempts: list[int] = []  # replica indices tried, in order
        self.replica: Optional[int] = None  # current assignment
        self.done = False
        self.finish_reason: Optional[str] = None
        self.stream = stream
        self.head_sent = False  # client HTTP/SSE head already written
        #   (a failover splice must never re-send it)

    @property
    def n_failovers(self) -> int:
        return max(0, len(self.attempts) - 1)

    def assign(self, replica: int) -> None:
        self.attempts.append(replica)
        self.replica = replica

    def record(self, index: int, token: int) -> None:
        """Journal one relayed token.  ``index`` is the global emission
        index from the SSE frame; it must equal the journal length — a
        gap or overlap means the resume splice lost sync."""
        if index != len(self.tokens):
            raise ValueError(
                f"journal splice out of sync: frame index {index}, "
                f"journal holds {len(self.tokens)}")
        self.tokens.append(int(token))

    def resume_body(self) -> dict:
        """The resubmission body: the original request with the
        journaled emissions as ``resume_tokens``.  Everything else —
        seed, max_new, stop_tokens, tenant — rides along unchanged, so
        the continuation draws the same keys the dead replica would
        have."""
        body = dict(self.body)
        body["resume_tokens"] = list(self.tokens)
        return body


class RequestJournal:
    """jid → :class:`JournalEntry` for every in-flight routed request,
    plus lifetime counters (opened/completed/failed/failovers)."""

    def __init__(self):
        self._entries: dict[int, JournalEntry] = {}
        self._ids = itertools.count()
        self.opened = 0
        self.completed = 0
        self.failed = 0
        self.failovers = 0

    def __len__(self) -> int:
        return len(self._entries)

    def open(self, body: dict, stream: bool = True) -> JournalEntry:
        e = JournalEntry(next(self._ids), body, stream)
        self._entries[e.jid] = e
        self.opened += 1
        return e

    def note_failover(self, entry: JournalEntry) -> None:
        self.failovers += 1

    def close(self, entry: JournalEntry, *,
              finish_reason: Optional[str]) -> None:
        """Retire a finished (or abandoned) entry; the tokens are the
        client's now — the journal keeps only counters."""
        entry.done = finish_reason is not None
        entry.finish_reason = finish_reason
        if finish_reason is None:
            self.failed += 1
        else:
            self.completed += 1
        self._entries.pop(entry.jid, None)

    def live(self) -> list:
        return list(self._entries.values())
