"""Load-shedding degradation ladder.

Under sustained pressure the front door degrades throughput-enhancing
but non-essential work BEFORE refusing traffic, one reversible rung at
a time:

    level 0  normal
    level 1  spec_half — halve the speculative draft depth K
    level 2  spec_off  — disable speculation (plain one-token ticks)
    level 3  shed_low  — refuse admission for the lowest priority class

Rungs that don't apply to the engine (K <= 1, or no speculation at all)
are simply absent, so a non-speculative engine has a one-rung ladder
(shed_low).  Pressure is ``max(queue fill fraction, KV-pool occupancy)``
— the two resources a burst exhausts.  Escalation requires pressure to
hold above ``high_water`` for ``sustain_s`` (one slow tick doesn't shed
anyone); de-escalation requires pressure below ``low_water`` for
``cooloff_s`` (no flapping at the boundary).  Every transition bumps
``ladder_escalations``/``ladder_deescalations``, moves the
``ladder_level`` gauge, and records a ``ladder_transition`` trace event.

The ladder runs on the ENGINE thread (observe() is called between
ticks), so mutating the live speculative depth via
:meth:`Engine.set_speculative_k` is race-free; the front door reads the
``shedding`` flag from the event loop, which is a benign cross-thread
bool read.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Optional

if TYPE_CHECKING:  # pragma: no cover - typing only
    from repro_torch.serve.engine import Engine

__all__ = ["DegradationLadder", "LadderConfig"]


@dataclasses.dataclass(frozen=True)
class LadderConfig:
    high_water: float = 0.85  # pressure >= this (sustained) escalates
    low_water: float = 0.50  # pressure <= this (sustained) de-escalates
    sustain_s: float = 0.25  # how long high pressure must hold
    cooloff_s: float = 1.0  # how long low pressure must hold

    def __post_init__(self):
        if not 0.0 < self.low_water < self.high_water <= 1.0:
            raise ValueError(
                f"need 0 < low_water < high_water <= 1, got "
                f"{self.low_water}/{self.high_water}"
            )
        if self.sustain_s < 0 or self.cooloff_s < 0:
            raise ValueError("sustain_s and cooloff_s must be >= 0")


class DegradationLadder:
    """Reversible pressure-relief state machine over a live engine."""

    def __init__(self, engine: "Engine",
                 cfg: Optional[LadderConfig] = None):
        self.engine = engine
        self.cfg = cfg or LadderConfig()
        k = engine.ecfg.speculative_k
        self.actions: list[str] = []
        if k > 1:
            self.actions.append("spec_half")
        if k > 0:
            self.actions.append("spec_off")
        self.actions.append("shed_low")
        self.level = 0
        self.shedding = False  # admission gate read by the front door
        self._high_since: Optional[float] = None
        self._low_since: Optional[float] = None
        engine.metrics.counter("ladder_escalations")
        engine.metrics.counter("ladder_deescalations")
        engine.metrics.gauge("ladder_level").set(0)

    # ---- pressure -------------------------------------------------------

    def pressure(self) -> float:
        """max(queue fill fraction, pool occupancy) in [0, 1].  With an
        unbounded queue the queue term saturates against the engine's
        lane count instead — ``pending / (4 * n_slots)`` — so pressure
        still registers before latency does."""
        eng = self.engine
        pending = eng.scheduler.pending
        cap = eng.ecfg.max_queue or 4 * eng.ecfg.n_slots
        return max(min(1.0, pending / cap), eng.pool.occupancy)

    # ---- transitions ----------------------------------------------------

    def observe(self, now: float) -> Optional[str]:
        """Called between ticks on the engine thread.  Returns the action
        applied this call ("spec_half", "+spec_half" for a restore, ...)
        or None.  One rung per call — a saturating burst walks the
        ladder one sustained window at a time, each step visible."""
        p = self.pressure()
        cfg = self.cfg
        if p >= cfg.high_water:
            self._low_since = None
            if self._high_since is None:
                self._high_since = now
            elif (now - self._high_since >= cfg.sustain_s
                  and self.level < len(self.actions)):
                self._high_since = now  # re-sustain before the next rung
                return self._escalate(now, p)
        elif p <= cfg.low_water:
            self._high_since = None
            if self._low_since is None:
                self._low_since = now
            elif now - self._low_since >= cfg.cooloff_s and self.level > 0:
                self._low_since = now
                return self._deescalate(now, p)
        else:  # hysteresis band: hold the level, reset both timers
            self._high_since = self._low_since = None
        return None

    def _apply(self, action: str) -> None:
        eng = self.engine
        k = eng.ecfg.speculative_k
        if action == "spec_half":
            eng.set_speculative_k(max(1, k // 2))
        elif action == "spec_off":
            eng.set_speculative_k(0)
        elif action == "shed_low":
            self.shedding = True

    def _revert(self, action: str) -> None:
        eng = self.engine
        k = eng.ecfg.speculative_k
        if action == "spec_half":
            eng.set_speculative_k(k)
        elif action == "spec_off":
            # fall back to the next rung down's state
            eng.set_speculative_k(max(1, k // 2) if "spec_half"
                                  in self.actions else k)
        elif action == "shed_low":
            self.shedding = False

    def _transition(self, now: float, pressure: float, new_level: int,
                    action: str, counter: str) -> str:
        eng = self.engine
        old = self.level
        self.level = new_level
        eng.metrics.inc(counter)
        eng.metrics.gauge("ladder_level").set(new_level)
        eng.tracer.event(
            "ladder_transition", t=now, level_from=old, level_to=new_level,
            action=action, pressure=round(pressure, 4),
        )
        return action

    def _escalate(self, now: float, pressure: float) -> str:
        action = self.actions[self.level]
        self._apply(action)
        return self._transition(
            now, pressure, self.level + 1, action, "ladder_escalations"
        )

    def _deescalate(self, now: float, pressure: float) -> str:
        action = self.actions[self.level - 1]
        self._revert(action)
        return self._transition(
            now, pressure, self.level - 1, "+" + action,
            "ladder_deescalations",
        )
