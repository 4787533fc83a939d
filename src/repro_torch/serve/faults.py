"""Deterministic fault injection for the serving stack.

A :class:`FaultPlan` is a small list of trigger→fault rules that the
engine, pool, adapter, and artifact loader consult at well-defined
points.  The default plan is empty and every hook degrades to an
iteration over an empty list, so the hot path pays nothing when no
faults are armed.

Fault kinds
-----------

``alloc_fail``
    The engine's per-tick page claim for a decode lane fails.  The
    targeted request FAILS with ``finish_reason="alloc_fail"``; nothing
    else is touched.
``pool_exhausted``
    One :meth:`PagedKVPool.extend`/:meth:`admit` call reports no pages.
    Transient: the engine recovers through its normal evict/requeue or
    defer paths, so no request fails — this exercises the recovery
    machinery itself.
``nan_logits``
    The adapter poisons the targeted request's lane of the returned
    logits with NaN *after* the fused dispatch — exactly what a corrupt
    artifact or a numerically unstable kernel would produce.  With
    ``EngineConfig.screen_logits`` the lane is quarantined (FAILED,
    ``finish_reason="nan_logits"``) while co-batched lanes keep their
    exact token streams.
``dispatch_error``
    The adapter raises :class:`FaultInjected` at the entry of a fused
    dispatch, before any pool buffer is touched.  The engine fails only
    the targeted request; surviving lanes retry next tick and stay
    token-identical to a fault-free run.
``corrupt_shard``
    Artifact loading sees a checksum mismatch on the given shard and
    raises :class:`~repro_torch.checkpoint.store.ArtifactCorruption`.
``cancel``
    The engine calls :meth:`Engine.cancel` on the given request id at
    the given tick boundary — deterministic mid-flight cancellation
    from CLI fault plans and benchmarks.
``slow_client``
    The front door stalls the targeted request's SSE write path for
    ``ms`` milliseconds per consult — a client that stops reading.
``disconnect``
    The front door drops the targeted request's connection once
    ``tokens`` tokens have streamed (default 1) — exercising the
    disconnect → :meth:`Engine.cancel` path without a real client
    misbehaving on cue.
``admission_burst``
    The front door injects ``n`` synthetic low-priority admissions at
    the matching tick — a retry storm on demand, driving the admission
    backpressure and degradation-ladder machinery.
``replica_kill``
    The replica process exits IMMEDIATELY (``os._exit(137)``) at the
    matching tick boundary — indistinguishable from a ``kill -9`` to
    the fleet supervisor and to every client streaming from it.  Fired
    by the front door's tick loop, so it composes with ``tick=``.
``replica_hang``
    The engine thread sleeps forever at the matching tick boundary: a
    wedged dispatch.  The event loop stays alive (``/healthz`` still
    answers — flipping to 503 once ``last_tick_age_s`` passes the
    stall threshold), so this exercises the watchdog-then-hard-kill
    path rather than crash detection.
``replica_slow``
    The engine thread sleeps ``ms`` milliseconds per matching tick
    (``times`` firings) — a degraded replica that stays healthy but
    falls behind, driving the router's over-pressure fallback.

Rule triggers: ``tick`` (engine step index, from the steps counter),
``rid`` (request id), ``shard`` (artifact shard index), ``times`` (how
often the rule fires before disarming; default once).  Network-layer
parameters: ``tokens`` (disconnect threshold), ``ms`` (slow-client
stall / replica_slow tick delay), ``n`` (burst size).  A rule with no
``tick`` fires at the first opportunity; a rule with no ``rid`` binds
to the first live lane of the dispatch it fires on.

The plan string grammar (``--fault-plan``)::

    kind[@key=val[,key=val...]][;rule...]

e.g. ``"alloc_fail@rid=0;nan_logits@rid=2;cancel@rid=4,tick=6"``.

The kinds, the rules, the plan's hooks and the grammar are the JAX
package's, copied (the port imports nothing of it).  The network- and
replica-level hooks (``stall_ms``, ``disconnect_after``,
``replica_disruption``, ``admission_burst``) are pure data: the port's
front door and fleet are not written yet.  In the port the ``nan_logits``
poison is written into the returned logits tensor in place, on its device.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.checkpoint.store import ArtifactCorruption

__all__ = [
    "FAULT_KINDS",
    "AdmissionRejected",
    "ArtifactCorruption",
    "FaultInjected",
    "FaultPlan",
    "FaultRule",
    "NO_FAULTS",
    "parse_fault_plan",
]

FAULT_KINDS = (
    "alloc_fail",
    "pool_exhausted",
    "nan_logits",
    "dispatch_error",
    "corrupt_shard",
    "cancel",
    # ---- network-layer faults (serve/frontdoor, DESIGN.md §14) ----
    "slow_client",  # stall the SSE write path for the targeted stream
    "disconnect",  # drop the client connection mid-stream
    "admission_burst",  # inject a burst of synthetic admissions at a tick
    # ---- replica-level faults (serve/fleet, DESIGN.md §15) ----
    "replica_kill",  # the replica process exits abruptly (as if kill -9)
    "replica_hang",  # the engine thread wedges forever (watchdog food)
    "replica_slow",  # the engine thread stalls ms per tick (degraded)
)


class AdmissionRejected(ValueError):
    """Structured admission backpressure from :meth:`Engine.submit`.

    ``retryable=True`` means the rejection is transient (bounded queue
    full, tenant rate limit, load shed): back off — for
    ``retry_after_s`` seconds when set — and resubmit.
    ``retryable=False`` means this engine can never serve the request
    (it exceeds per-sequence or total pool capacity) and resubmitting
    is pointless.

    ``str()`` carries every actionable detail (reason, needed/available
    pages, queue occupancy, retry-after, the retryable flag) so CLI
    errors and HTTP response bodies never need to reach into the
    attributes; :meth:`to_dict` is the structured form the front door
    serializes, and :attr:`http_status` the HTTP mapping (429 for
    retryable backpressure, 413 for a request that can never fit).

    Subclasses :class:`ValueError` so callers of the old bare-ValueError
    contract keep working.
    """

    def __init__(self, reason: str, *, retryable: bool,
                 needed_pages: Optional[int] = None,
                 available_pages: Optional[int] = None,
                 pending: Optional[int] = None,
                 limit: Optional[int] = None,
                 retry_after_s: Optional[float] = None,
                 tenant: Optional[str] = None):
        self.reason = reason
        self.retryable = retryable
        self.needed_pages = needed_pages
        self.available_pages = available_pages
        self.pending = pending
        self.limit = limit
        self.retry_after_s = retry_after_s
        self.tenant = tenant
        parts = [f"admission rejected ({reason})"]
        if tenant is not None:
            parts.append(f"tenant {tenant!r}")
        if needed_pages is not None:
            parts.append(f"needs {needed_pages} pages, "
                         f"{available_pages} available")
        if limit is not None:
            parts.append(f"{pending} pending >= max_queue {limit}")
        if retry_after_s is not None:
            parts.append(f"retry after {retry_after_s:.3g}s")
        parts.append("retryable" if retryable else "not retryable")
        super().__init__("; ".join(parts))

    @property
    def http_status(self) -> int:
        """HTTP mapping: 413 (payload too large) for a request this pool
        can NEVER hold, 429 (too many requests) for every transient
        rejection — queue_full, rate_limited, shed."""
        return 413 if self.reason == "over_capacity" else 429

    def to_dict(self) -> dict:
        """JSON-serializable body for HTTP error responses (None fields
        omitted so clients see only the relevant context)."""
        out = {"error": self.reason, "retryable": self.retryable,
               "detail": str(self)}
        for key in ("needed_pages", "available_pages", "pending", "limit",
                    "retry_after_s", "tenant"):
            v = getattr(self, key)
            if v is not None:
                out[key] = v
        return out


class FaultInjected(RuntimeError):
    """Raised by an armed ``dispatch_error`` rule at an adapter entry."""

    def __init__(self, rule: "FaultRule", rid: Optional[int] = None):
        self.rule = rule
        self.rid = rid
        super().__init__(f"injected dispatch fault (rid={rid}, rule={rule})")


@dataclasses.dataclass
class FaultRule:
    kind: str
    tick: Optional[int] = None
    rid: Optional[int] = None
    shard: Optional[int] = None
    times: int = 1
    # ---- network-layer rule parameters (serve/frontdoor) ----
    tokens: Optional[int] = None  # disconnect: after this many streamed
    #   tokens (default: the first one)
    ms: Optional[int] = None  # slow_client: stall per consult, milliseconds
    n: Optional[int] = None  # admission_burst: synthetic submits per firing
    fired: int = 0

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; expected one of "
                f"{', '.join(FAULT_KINDS)}")
        if self.times < 1:
            raise ValueError(f"times must be >= 1, got {self.times}")
        if self.kind == "cancel" and self.rid is None:
            raise ValueError("cancel rules must name a rid")
        if self.kind == "slow_client" and self.ms is None:
            raise ValueError("slow_client rules must set ms= (stall length)")
        if self.kind == "replica_slow" and self.ms is None:
            raise ValueError("replica_slow rules must set ms= (tick delay)")
        if self.kind == "admission_burst" and (self.n is None or self.n < 1):
            raise ValueError("admission_burst rules must set n= (burst size)")

    @property
    def armed(self) -> bool:
        return self.fired < self.times


class FaultPlan:
    """An ordered set of :class:`FaultRule` plus the dispatch context the
    engine maintains (current ``tick``, ``lane_rids`` of the in-flight
    dispatch).  ``log`` records every firing for telemetry/tests."""

    def __init__(self, rules=()):
        self.rules = [r if isinstance(r, FaultRule) else FaultRule(**r)
                      for r in rules]
        self.tick = 0
        self.lane_rids: tuple = ()
        # lanes whose logits this dispatch actually CONSUMES (decode,
        # verify, and prefill chunks reaching the prompt boundary) —
        # nan_logits only fires there, so the poison is always observable
        # by the screen instead of vanishing with a discarded chunk
        self.poison_rids: tuple = ()
        self.log: list = []

    def __repr__(self):
        return f"FaultPlan({self.rules!r}, tick={self.tick})"

    @property
    def active(self) -> bool:
        return any(r.armed for r in self.rules)

    def _record(self, rule: FaultRule, **ctx) -> FaultRule:
        rule.fired += 1
        self.log.append({"tick": self.tick, "kind": rule.kind, **ctx})
        return rule

    def _tick_match(self, rule: FaultRule) -> bool:
        return rule.tick is None or rule.tick == self.tick

    def fire(self, kind: str, rid: Optional[int] = None,
             shard: Optional[int] = None) -> Optional[FaultRule]:
        """Consume and return the first armed rule of ``kind`` matching
        the given context, or None.  A rule pinned to a rid only fires
        when that rid is offered."""
        for rule in self.rules:
            if rule.kind != kind or not rule.armed:
                continue
            if not self._tick_match(rule):
                continue
            if rule.rid is not None and rule.rid != rid:
                continue
            if rule.shard is not None and rule.shard != shard:
                continue
            return self._record(rule, rid=rid, shard=shard)
        return None

    # ------------------------------------------------------------------
    # adapter-side hooks (lane_rids is set by the engine per dispatch)

    def check_dispatch(self) -> None:
        """Raise :class:`FaultInjected` if a ``dispatch_error`` rule is
        armed for this dispatch.  Called at the entry of every fused
        forward, before any donated pool buffer is consumed."""
        for rule in self.rules:
            if rule.kind != "dispatch_error" or not rule.armed:
                continue
            if not self._tick_match(rule):
                continue
            rid = rule.rid
            if rid is not None and rid not in self.lane_rids:
                continue
            if rid is None:
                rid = next((r for r in self.lane_rids if r is not None),
                           None)
            self._record(rule, rid=rid)
            raise FaultInjected(rule, rid=rid)

    def nan_lanes(self) -> list:
        """Lane indices of the current dispatch to poison with NaN
        (consumes matching ``nan_logits`` rules)."""
        lanes = []
        for rule in self.rules:
            if rule.kind != "nan_logits" or not rule.armed:
                continue
            if not self._tick_match(rule):
                continue
            if rule.rid is not None:
                if rule.rid not in self.poison_rids:
                    continue
                lane = self.lane_rids.index(rule.rid)
            else:
                lane = next((i for i, r in enumerate(self.lane_rids)
                             if r is not None and r in self.poison_rids),
                            None)
                if lane is None:
                    continue
            self._record(rule, rid=self.lane_rids[lane], lane=lane)
            lanes.append(lane)
        return lanes

    # ------------------------------------------------------------------
    # engine / loader hooks

    def cancel_rids(self) -> list:
        """Request ids whose ``cancel`` rules fire at the current tick."""
        rids = []
        for rule in self.rules:
            if rule.kind != "cancel" or not rule.armed:
                continue
            if not self._tick_match(rule):
                continue
            self._record(rule, rid=rule.rid)
            rids.append(rule.rid)
        return rids

    # ------------------------------------------------------------------
    # front-door (router/stream) hooks — serve/frontdoor consults these
    # on the network path, so chaos plans cover slow clients, mid-stream
    # disconnects, and synthetic admission bursts without a real client
    # misbehaving on cue

    def stall_ms(self, rid: Optional[int] = None) -> Optional[int]:
        """Milliseconds to stall the stream write for ``rid`` (consumes a
        matching ``slow_client`` rule), or None."""
        for rule in self.rules:
            if rule.kind != "slow_client" or not rule.armed:
                continue
            if not self._tick_match(rule):
                continue
            if rule.rid is not None and rule.rid != rid:
                continue
            self._record(rule, rid=rid, ms=rule.ms)
            return rule.ms
        return None

    def disconnect_after(self, rid: Optional[int], n_sent: int) -> bool:
        """Whether the stream for ``rid`` should be forcibly dropped now,
        ``n_sent`` tokens in (consumes a matching ``disconnect`` rule once
        the stream has shipped ``rule.tokens`` tokens; default 1)."""
        for rule in self.rules:
            if rule.kind != "disconnect" or not rule.armed:
                continue
            if not self._tick_match(rule):
                continue
            if rule.rid is not None and rule.rid != rid:
                continue
            if n_sent < (rule.tokens if rule.tokens is not None else 1):
                continue
            self._record(rule, rid=rid, tokens=n_sent)
            return True
        return False

    def replica_disruption(self) -> Optional[FaultRule]:
        """The replica-level fault to apply at this tick boundary, or
        None.  Consulted by the front door's tick loop BEFORE the tick
        runs, with ``self.tick`` set to the count of completed ticks —
        so ``tick=N`` disrupts after exactly N clean ticks.  Kills and
        hangs are terminal for the process; ``replica_slow`` fires up
        to ``times`` and sleeps ``ms`` per firing."""
        for rule in self.rules:
            if rule.kind not in ("replica_kill", "replica_hang",
                                 "replica_slow") or not rule.armed:
                continue
            if not self._tick_match(rule):
                continue
            return self._record(rule, ms=rule.ms)
        return None

    def admission_burst(self) -> int:
        """Synthetic admissions the router should inject this tick
        (consumes matching ``admission_burst`` rules; 0 when none fire)."""
        total = 0
        for rule in self.rules:
            if rule.kind != "admission_burst" or not rule.armed:
                continue
            if not self._tick_match(rule):
                continue
            self._record(rule, n=rule.n)
            total += rule.n
        return total

    def corrupt_shards(self) -> set:
        """Shard indices whose manifest digests the loader should treat
        as mismatched (consumes ``corrupt_shard`` rules)."""
        shards = set()
        for rule in self.rules:
            if rule.kind != "corrupt_shard" or not rule.armed:
                continue
            self._record(rule, shard=rule.shard)
            shards.add(0 if rule.shard is None else rule.shard)
        return shards


#: Shared inert default: hooks that consult it iterate an empty rule
#: list.  Never mutate it — engines build their own plan.
NO_FAULTS = FaultPlan()


def parse_fault_plan(spec: str) -> FaultPlan:
    """Parse the ``--fault-plan`` grammar (see module docstring)."""
    rules = []
    for part in (p.strip() for p in spec.split(";")):
        if not part:
            continue
        kind, _, argstr = part.partition("@")
        kw = {}
        if argstr:
            for item in argstr.split(","):
                key, eq, val = item.partition("=")
                key = key.strip()
                if not eq or key not in ("tick", "rid", "shard", "times",
                                         "tokens", "ms", "n"):
                    raise ValueError(
                        f"bad fault rule argument {item!r} in {part!r}; "
                        "expected tick=/rid=/shard=/times=/tokens=/ms=/n=")
                try:
                    kw[key] = int(val)
                except ValueError:
                    raise ValueError(
                        f"fault rule argument {item!r} is not an integer")
        rules.append(FaultRule(kind=kind.strip(), **kw))
    if not rules:
        raise ValueError(f"empty fault plan {spec!r}")
    return FaultPlan(rules)
