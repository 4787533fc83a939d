"""SSE encoding and the cursor-diff token stream.

Why a cursor diff instead of a token queue: the engine ticks on its own
thread, so a tick may emit tokens BETWEEN ``Engine.submit`` returning
and the handler registering its stream on the event loop.  A queue
filled by tick dispatch would silently drop those tokens; a
:class:`TokenStream` instead keeps a ``sent`` cursor and diffs it
against the request's append-only ``out_tokens`` each wake-up, so a
late registration (or a coalesced burst of notifications) never loses
or duplicates a token.  Tick dispatch only ever *nudges* the stream —
correctness never depends on one nudge per token.
"""
from __future__ import annotations

import asyncio
import json
from typing import TYPE_CHECKING, AsyncIterator, Optional

if TYPE_CHECKING:  # pragma: no cover - typing only
    from repro_torch.serve.scheduler import Request

__all__ = ["TokenStream", "sse_event", "sse_headers"]


def sse_event(event: str, data: dict) -> bytes:
    """One Server-Sent-Events frame."""
    return (f"event: {event}\ndata: {json.dumps(data)}\n\n").encode()


def sse_headers() -> list:
    return [
        ("Content-Type", "text/event-stream"),
        ("Cache-Control", "no-store"),
        ("X-Accel-Buffering", "no"),
    ]


class TokenStream:
    """Fan-out endpoint for one request's tokens.

    The tick task calls :meth:`nudge` (same event loop — no locking)
    whenever a tick emitted for, or terminalized, this request;
    :meth:`pump` is the handler-side async iterator yielding each new
    token exactly once, then a final ``(None, request)`` sentinel when
    the request is terminal and fully drained.
    """

    def __init__(self, req: "Request", sent: int = 0):
        self.req = req
        # out_tokens[:sent] already yielded — nonzero for a failover
        # resubmission, whose resumed prefix the ORIGINAL stream already
        # delivered (the router splices; re-sending would duplicate)
        self.sent = sent
        self._wake = asyncio.Event()
        # catch up work that happened before registration
        if len(req.out_tokens) > sent or req.state.terminal:
            self._wake.set()

    def nudge(self) -> None:
        self._wake.set()

    @property
    def drained(self) -> bool:
        return self.req.state.terminal and self.sent >= len(
            self.req.out_tokens
        )

    async def pump(
        self, idle_timeout_s: Optional[float] = None
    ) -> AsyncIterator[tuple]:
        """Yield ``(token, None)`` per fresh token, then ``(None, req)``
        once terminal.  ``idle_timeout_s`` bounds the wait between
        wake-ups (a dead tick loop must not wedge handlers forever);
        expiry raises :class:`TimeoutError`."""
        req = self.req
        while True:
            # reading len() + indexing an append-only list is safe
            # across the engine-thread boundary (GIL-atomic)
            toks = req.out_tokens
            while self.sent < len(toks):
                tok = toks[self.sent]
                self.sent += 1
                yield int(tok), None
            if req.state.terminal:
                if self.sent >= len(req.out_tokens):
                    yield None, req
                    return
                continue  # tokens landed after the terminal check
            self._wake.clear()
            # re-check after clear: a nudge between the len() read and
            # clear() would otherwise be lost
            if len(req.out_tokens) > self.sent or req.state.terminal:
                continue
            if idle_timeout_s is None:
                await self._wake.wait()
            else:
                await asyncio.wait_for(self._wake.wait(), idle_timeout_s)


class StreamTable:
    """rid -> TokenStream registry the tick task fans results into."""

    def __init__(self):
        self._streams: dict[int, TokenStream] = {}

    def register(self, req: "Request", sent: int = 0) -> TokenStream:
        ts = TokenStream(req, sent=sent)
        self._streams[req.rid] = ts
        return ts

    def unregister(self, rid: int) -> None:
        self._streams.pop(rid, None)

    def __len__(self) -> int:
        return len(self._streams)

    def dispatch(self, tick_result) -> None:
        """Nudge every stream a tick touched (event-loop side)."""
        touched = set()
        for req, _tok in tick_result.emitted:
            touched.add(req.rid)
        for req in tick_result.finished:
            touched.add(req.rid)
        for rid in touched:
            ts = self._streams.get(rid)
            if ts is not None:
                ts.nudge()

    def nudge_all(self) -> None:
        for ts in self._streams.values():
            ts.nudge()
