"""Request lifecycle + token-budget FCFS scheduling with chunked prefill.

Lifecycle::

    QUEUED -> PREFILL -> DECODE -> FINISHED
       ^________|__________|           (eviction under page pressure
        \\_______|__________|______     requeues with the generated
                                   \\   prefix intact)
                       CANCELLED / FAILED

Terminal states carry a ``finish_reason`` on the request: ``"length"``
or ``"stop"`` for FINISHED, ``"cancelled"`` for CANCELLED, and a failure
(``"deadline"``, ``"eviction_storm"``, ``"capacity"``) for FAILED.

Each engine step has a token budget.  Running decode sequences cost one
token each and are served first; leftover budget goes to prefill chunks —
first to sequences mid-prefill, then to admitting queued requests whose
pages fit.  Admission is strict head-of-queue: a request that does not
fit blocks later arrivals (no starvation).  Prefix-cache hits start
prefill past the cached tokens, which never charge the budget.

Multi-tenant admission: every request carries a ``tenant`` and a
``priority`` class (0 = highest).  A :class:`TenantPolicy` gives each
tenant a token-bucket rate limit and a default class; a submit that
overdraws its tenant's bucket is rejected with a retryable
:class:`AdmissionRejected` (``"rate_limited"``, with ``retry_after_s``).
The arrived queue orders by effective priority — ``priority -
floor(wait / aging_s)``, clamped at 0 — then FCFS within a class; with
every request in class 0 it stays the plain FCFS deque.

Speculative decode charges the tokens a verify tick accepted beyond
one per lane against the next step's budget (:meth:`TokenBudgetFCFS.
charge_accepted`).  These host-side decisions are the JAX package's, step
for step (pure numpy and Python).
"""
from __future__ import annotations

import dataclasses
import enum
import itertools
from collections import deque
from typing import Optional

import numpy as np

from repro_torch.serve.faults import AdmissionRejected
from repro_torch.serve.telemetry import NULL_TRACER

__all__ = [
    "AdmissionRejected",
    "Request",
    "RequestState",
    "SamplingParams",
    "StepPlan",
    "TenantPolicy",
    "TokenBucket",
    "TokenBudgetFCFS",
]

_ids = itertools.count()


@dataclasses.dataclass(frozen=True)
class TenantPolicy:
    """Per-tenant admission policy: ``rate`` admissions per second into a
    bucket of depth ``burst`` (None = unlimited), and the default
    ``priority`` class (0 = highest)."""

    rate: Optional[float] = None
    burst: int = 4
    priority: int = 0

    def __post_init__(self):
        if self.rate is not None and self.rate <= 0:
            raise ValueError(f"rate must be > 0 (or None), got {self.rate}")
        if self.burst < 1:
            raise ValueError(f"burst must be >= 1, got {self.burst}")
        if self.priority < 0:
            raise ValueError(f"priority must be >= 0, got {self.priority}")


class TokenBucket:
    """``rate`` tokens/s refill, capped at ``burst``.  :meth:`try_take`
    returns None on success or the seconds until a token is available."""

    __slots__ = ("rate", "burst", "tokens", "_t")

    def __init__(self, rate: float, burst: int):
        if rate <= 0 or burst < 1:
            raise ValueError(f"need rate > 0 and burst >= 1, "
                             f"got rate={rate} burst={burst}")
        self.rate = float(rate)
        self.burst = float(burst)
        self.tokens = float(burst)
        self._t: Optional[float] = None

    def _refill(self, now: float) -> None:
        if self._t is not None and now > self._t:
            self.tokens = min(self.burst,
                              self.tokens + (now - self._t) * self.rate)
        if self._t is None or now > self._t:
            self._t = now

    def try_take(self, now: float, cost: float = 1.0) -> Optional[float]:
        self._refill(now)
        if self.tokens >= cost:
            self.tokens -= cost
            return None
        return (cost - self.tokens) / self.rate


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request decoding controls.

    ``temperature == 0`` is exact greedy (argmax: the default and the
    ``--check`` path).  Otherwise logits are scaled by 1/T, nucleus-
    filtered to the smallest set with mass >= ``top_p``, and sampled from
    ``seed``: on the host with a per-request numpy generator, on the device
    keyed by (seed, emission index), so a stream does not depend on batch
    composition, scheduling order or eviction/replay.
    """

    temperature: float = 0.0
    top_p: float = 1.0
    seed: int = 0

    def __post_init__(self):
        if self.temperature < 0.0:
            raise ValueError(
                f"temperature must be >= 0, got {self.temperature}")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")

    @property
    def greedy(self) -> bool:
        return self.temperature == 0.0


class RequestState(enum.Enum):
    QUEUED = "queued"
    PREFILL = "prefill"
    DECODE = "decode"
    FINISHED = "finished"
    CANCELLED = "cancelled"
    FAILED = "failed"

    @property
    def terminal(self) -> bool:
        return self in (RequestState.FINISHED, RequestState.CANCELLED,
                        RequestState.FAILED)


@dataclasses.dataclass(eq=False)  # identity semantics: ndarray fields +
class Request:                    # list.remove/in on running queues
    prompt: np.ndarray  # (S,) int32
    max_new: int
    arrival: float = 0.0
    sampling: SamplingParams = dataclasses.field(default_factory=SamplingParams)
    stop_tokens: tuple = ()  # emitting any of these finishes the request
    rid: int = dataclasses.field(default_factory=lambda: next(_ids))
    # seconds from ``arrival``, enforced at tick boundaries (None = none)
    deadline_s: Optional[float] = None
    # the tenant the request bills against, and its class (None = the
    # tenant policy's, resolved at scheduler.submit)
    tenant: str = "default"
    priority: Optional[int] = None

    state: RequestState = RequestState.QUEUED
    # why the request reached its terminal state; None while live
    finish_reason: Optional[str] = None
    slot: Optional[int] = None
    prefill_pos: int = 0  # tokens of ``prefix`` already written to pages
    out_tokens: list = dataclasses.field(default_factory=list)
    n_evictions: int = 0
    # tokens a previous attempt on another replica already emitted (fleet
    # failover, ``Engine.submit(resume_tokens=...)``): ``out_tokens`` starts
    # with them, so emission indices, and the device draw's keys folded
    # from them, go on where the dead replica stopped.  The stream layer
    # does not send the first ``resumed`` again.
    resumed: int = 0

    # timing (engine-relative seconds); ``t_admitted`` is the FIRST
    # admission — an evicted request keeps it
    t_admitted: Optional[float] = None
    t_first: Optional[float] = None
    t_finish: Optional[float] = None
    token_times: list = dataclasses.field(default_factory=list)
    # per-emission last-token logits, kept under --check (record_logits)
    # and for shadow-sampled requests, whose drift the oracle re-scores
    step_logits: list = dataclasses.field(default_factory=list)
    # picked for shadow drift sampling (--shadow-rate) at submit
    shadow: bool = False
    # the host draw's numpy generator, made on first use; it survives
    # eviction (the replayed request continues its draw sequence)
    _rng: Optional[np.random.Generator] = dataclasses.field(
        default=None, repr=False)

    @property
    def rng(self) -> np.random.Generator:
        if self._rng is None:
            self._rng = np.random.default_rng(self.sampling.seed)
        return self._rng

    @property
    def prefix(self) -> np.ndarray:
        """Tokens whose KV must be resident: prompt + generated so far."""
        if not self.out_tokens:
            return self.prompt
        return np.concatenate(
            [self.prompt, np.asarray(self.out_tokens, np.int32)]
        )

    @property
    def done(self) -> bool:
        if len(self.out_tokens) >= self.max_new:
            return True
        return bool(self.out_tokens) and self.out_tokens[-1] in self.stop_tokens

    def emit(self, token: int, now: float, logits=None) -> None:
        if self.t_first is None:
            self.t_first = now
        self.out_tokens.append(int(token))
        self.token_times.append(now)
        if logits is not None:
            self.step_logits.append(np.asarray(logits))


@dataclasses.dataclass
class StepPlan:
    decode: list  # Requests in DECODE taking one token this step
    # One co-batchable prefill group: (Request, n_tokens) chunks, each
    # request at most once, every chunk <= prefill_chunk wide
    prefill: list
    # prompt tokens admission skipped this step via prefix-cache hits
    prefix_hit_tokens: int = 0


class TokenBudgetFCFS:
    """Priority/FCFS queue + per-step token budgeting against a
    PagedKVPool.  With no tenant policies and every request in class 0
    (the defaults), behaviour is strict FCFS."""

    #: policy applied to tenants absent from the configured map
    DEFAULT_POLICY = TenantPolicy()

    def __init__(self, *, token_budget: int, prefill_chunk: int,
                 max_queue: Optional[int] = None,
                 tenants: Optional[dict] = None,
                 aging_s: float = 2.0):
        if token_budget < 1 or prefill_chunk < 1:
            raise ValueError("token_budget and prefill_chunk must be >= 1")
        if max_queue is not None and max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        if aging_s <= 0:
            raise ValueError(f"aging_s must be > 0 seconds, got {aging_s}")
        self.token_budget = token_budget
        self.prefill_chunk = prefill_chunk
        self.max_queue = max_queue
        self.tenants: dict[str, TenantPolicy] = dict(tenants or {})
        self.aging_s = aging_s
        self._buckets: dict[str, TokenBucket] = {}
        self.waiting: list[Request] = []  # not yet arrived (virtual clock)
        # arrived; kept sorted by (effective priority, arrival, rid)
        self.queue: deque[Request] = deque()
        # speculative accept debt: tokens emitted beyond the one planned
        # per decode lane, charged against the NEXT step's budget
        self._accept_debt = 0
        # lifecycle telemetry sink; the engine swaps in its live tracer
        self.tracer = NULL_TRACER

    def charge_accepted(self, n_tokens: int) -> None:
        """Charge ``n_tokens`` accepted speculative tokens (beyond one per
        lane) against the next step's budget; rejected drafts are never
        charged."""
        if n_tokens < 0:
            raise ValueError(
                f"accepted token charge must be >= 0, got {n_tokens}")
        self._accept_debt += n_tokens

    # ---- multi-tenant admission -----------------------------------------

    def policy(self, tenant: str) -> TenantPolicy:
        """The tenant's policy (unknown tenants: unlimited, class 0)."""
        return self.tenants.get(tenant, self.DEFAULT_POLICY)

    def shed_priority(self) -> int:
        """The class a load shedder drops first: the lowest configured
        class (largest number), never class 0."""
        classes = [p.priority for p in self.tenants.values()]
        return max(1, max(classes, default=1))

    def _charge_bucket(self, req: Request) -> None:
        pol = self.policy(req.tenant)
        if pol.rate is None:
            return
        bucket = self._buckets.get(req.tenant)
        if bucket is None:
            bucket = self._buckets[req.tenant] = TokenBucket(
                pol.rate, pol.burst)
        retry_after = bucket.try_take(req.arrival)
        if retry_after is not None:
            raise AdmissionRejected(
                "rate_limited", retryable=True, tenant=req.tenant,
                retry_after_s=retry_after)

    def effective_priority(self, req: Request, now: float) -> int:
        """Every ``aging_s`` seconds of queue wait promotes a request one
        class, clamped at 0."""
        pri = req.priority or 0
        if pri <= 0:
            return 0
        return max(0, pri - int((now - req.arrival) / self.aging_s))

    def _sort_queue(self, now: float) -> None:
        """Re-rank the arrived queue by (effective priority, arrival, rid);
        skipped while every queued request is in class 0."""
        if any(r.priority for r in self.queue):
            self.queue = deque(sorted(
                self.queue,
                key=lambda r: (self.effective_priority(r, now),
                               r.arrival, r.rid),
            ))

    def submit(self, req: Request) -> None:
        if req.priority is None:
            req.priority = self.policy(req.tenant).priority
        elif req.priority < 0:
            raise ValueError(f"priority must be >= 0, got {req.priority}")
        # rate limit before the queue bound: a rate-limited tenant cannot
        # turn its excess into queue_full rejections for everyone else
        self._charge_bucket(req)
        if self.max_queue is not None and self.pending >= self.max_queue:
            raise AdmissionRejected(
                "queue_full", retryable=True,
                pending=self.pending, limit=self.max_queue)
        self.waiting.append(req)
        self.waiting.sort(key=lambda r: (r.arrival, r.rid))

    def admit_arrivals(self, now: float) -> None:
        moved = False
        while self.waiting and self.waiting[0].arrival <= now:
            self.queue.append(self.waiting.pop(0))
            moved = True
        if moved or self.queue:
            self._sort_queue(now)

    def requeue(self, req: Request) -> None:
        """Evicted request: back to the head (it predates queued arrivals)."""
        req.state = RequestState.QUEUED
        req.slot = None
        req.prefill_pos = 0
        req.n_evictions += 1
        self.queue.appendleft(req)

    @property
    def pending(self) -> int:
        return len(self.waiting) + len(self.queue)

    def plan(self, running: list[Request], pool, now: float = 0.0) -> StepPlan:
        self._sort_queue(now)  # aging may have promoted a queued class
        decode = [r for r in running if r.state is RequestState.DECODE]
        # settle last tick's accept debt first: a negative remainder plans
        # no prefill; decode always runs
        budget = self.token_budget - self._accept_debt - len(decode)
        self._accept_debt = 0
        prefill: list[tuple[Request, int]] = []
        hit_tokens = 0
        # continue sequences already mid-prefill (best class first, FCFS
        # within it)
        for r in sorted(
            (r for r in running if r.state is RequestState.PREFILL),
            key=lambda r: (self.effective_priority(r, now), r.arrival, r.rid),
        ):
            if budget <= 0:
                break
            n = min(self.prefill_chunk, len(r.prefix) - r.prefill_pos, budget)
            if n > 0:
                prefill.append((r, n))
                budget -= n
        # admit new requests while pages + budget allow (head of queue)
        while budget > 0 and self.queue:
            r = self.queue[0]
            slot = pool.admit(len(r.prefix), tokens=r.prefix)
            if slot is None:
                break
            self.queue.popleft()
            r.slot = slot
            r.state = RequestState.PREFILL
            r.prefill_pos = pool.length(slot)
            hit_tokens += r.prefill_pos
            if r.t_admitted is None:
                r.t_admitted = now
            self.tracer.event(
                "request_admitted", rid=r.rid, queue_s=now - r.arrival,
                prompt_tokens=len(r.prefix), cached_tokens=r.prefill_pos,
                replay=r.n_evictions > 0, tenant=r.tenant,
                priority=r.priority or 0,
            )
            running.append(r)
            n = min(self.prefill_chunk, len(r.prefix) - r.prefill_pos, budget)
            prefill.append((r, n))
            budget -= n
        return StepPlan(decode=decode, prefill=prefill,
                        prefix_hit_tokens=hit_tokens)
