"""Engine driver: the loop that decides WHEN to tick.

The engine owns no loop — :meth:`Engine.tick` is a pure unit of work and
``idle`` / ``next_arrival`` are the predicates a driver needs.
"""
from __future__ import annotations

import time
from typing import TYPE_CHECKING, Optional

if TYPE_CHECKING:  # pragma: no cover - typing only
    from repro_torch.serve.engine import Engine
    from repro_torch.serve.scheduler import Request

__all__ = ["run_to_completion"]


def run_to_completion(engine: "Engine", max_steps: Optional[int] = None,
                      metrics_every: Optional[float] = None
                      ) -> list["Request"]:
    """Drive ``engine`` until every submitted request is terminal
    (FINISHED, CANCELLED or FAILED: each lands in ``engine.finished``).

    ``max_steps`` bounds ticks that DID work (a runaway-loop backstop);
    idle iterations waiting on future arrivals don't consume it.
    ``metrics_every`` (seconds of engine time) emits a one-line metrics
    snapshot to stderr at that period.  With ``canary_every`` configured
    and a canary set attached, a canary probe runs at the start and then
    at that period.
    """
    sch = engine.scheduler
    todo = sch.pending + len(engine.running)
    budget_tokens = sum(
        r.max_new + len(r.prefix)
        for r in (*sch.waiting, *sch.queue, *engine.running)
    )
    max_steps = max_steps or 1000 + 20 * budget_tokens
    done0 = len(engine.finished)
    worked_steps = stalls = 0
    next_metrics = (engine.now() + metrics_every if metrics_every
                    else float("inf"))
    canary_on = (engine.ecfg.canary_every is not None
                 and engine.canary_tokens is not None)
    if canary_on:
        engine._run_canary()
    next_canary = (engine.now() + engine.ecfg.canary_every if canary_on
                   else float("inf"))
    while not engine.idle:
        if engine.tick().worked:
            worked_steps, stalls = worked_steps + 1, 0
            if worked_steps > max_steps:
                raise RuntimeError(
                    f"engine did not drain in {max_steps} working steps")
        else:
            arrival = engine.next_arrival()
            if arrival is not None:
                # idle until the next virtual arrival
                time.sleep(max(0.0, min(0.01, arrival - engine.now())))
            else:
                stalls += 1  # arrived work exists but nothing progressed
                if stalls > 10_000:
                    raise RuntimeError(
                        "engine stalled: pending requests but no step "
                        "makes progress (pool misconfigured?)")
        if engine.now() >= next_metrics:
            engine._emit_metrics_snapshot()
            next_metrics = engine.now() + metrics_every
        if engine.now() >= next_canary:
            engine._run_canary()
            next_canary = engine.now() + engine.ecfg.canary_every
    if len(engine.finished) - done0 != todo:
        raise RuntimeError("run ended with requests not terminal")
    return engine.finished[done0:]
