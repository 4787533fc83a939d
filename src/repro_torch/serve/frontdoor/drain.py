"""Graceful-drain accounting and the KV-pool leak gate.

Drain protocol: on SIGTERM/SIGINT the front door stops
admitting (readyz flips 503, generate returns 503 ``draining``), keeps
ticking until every in-flight lane is terminal, and past
``--drain-timeout-s`` cancels the stragglers.  The exit gate is the
same invariant ``launch/serve.py`` enforces: zero leaked pages — every
page still resident must be accounted to the prefix cache, and no
sequence slot may remain mapped.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING

if TYPE_CHECKING:  # pragma: no cover - typing only
    from repro_torch.serve.engine import Engine

__all__ = ["DrainReport", "leak_gate"]


def leak_gate(pool) -> tuple:
    """(leaked_pages, residual_slots): pages in use beyond what the
    prefix cache holds, and sequence slots still mapped.  Both must be
    zero after a clean drain."""
    return pool.pages_in_use - pool.cached_pages, len(pool._slots)


@dataclasses.dataclass
class DrainReport:
    """What a drain did — the front door's exit value."""

    reason: str  # "sigterm" | "sigint" | "requested"
    duration_s: float
    completed: int  # requests that finished naturally during the drain
    cancelled: int  # in-flight requests cancelled at the deadline
    deadline_hit: bool
    leaked_pages: int
    residual_slots: int
    served_total: int  # requests finished over the server's lifetime

    @property
    def clean(self) -> bool:
        return self.leaked_pages == 0 and self.residual_slots == 0

    @property
    def exit_code(self) -> int:
        return 0 if self.clean else 1

    def lines(self) -> list:
        """Human-readable summary (the CLI prints these verbatim)."""
        out = [
            f"drain[{self.reason}] finished in {self.duration_s:.3f}s: "
            f"{self.completed} completed, {self.cancelled} cancelled"
            + (" (deadline hit)" if self.deadline_hit else ""),
            f"served {self.served_total} requests total",
        ]
        if self.clean:
            out.append("leak gate: clean (0 leaked pages, 0 mapped slots)")
        else:
            out.append(
                f"leak gate: FAILED ({self.leaked_pages} leaked pages, "
                f"{self.residual_slots} mapped slots)"
            )
        return out


def capture(engine: "Engine", *, reason: str, t0: float, completed: int,
            cancelled: int, deadline_hit: bool) -> DrainReport:
    leaked, slots = leak_gate(engine.pool)
    return DrainReport(
        reason=reason, duration_s=engine.now() - t0, completed=completed,
        cancelled=cancelled, deadline_hit=deadline_hit,
        leaked_pages=leaked, residual_slots=slots,
        served_total=len(engine.finished),
    )
