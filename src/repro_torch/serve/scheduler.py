"""Request lifecycle + token-budget FCFS scheduling with chunked prefill.

Lifecycle::

    QUEUED -> PREFILL -> DECODE -> FINISHED
       ^________|__________|        (eviction under page pressure requeues
                                     with the generated prefix intact)
                          FAILED

Each engine step has a token budget.  Running decode sequences cost one
token each and are served first; leftover budget goes to prefill chunks —
first to sequences mid-prefill, then to admitting queued requests whose
pages fit.  Admission is strict FCFS: a head-of-queue request that does
not fit blocks later arrivals (no starvation).  These host-side decisions
are the JAX package's, step for step; its tenant policies, priority
classes and speculative accept debt are not ported yet.
"""
from __future__ import annotations

import dataclasses
import enum
import itertools
from collections import deque
from typing import Optional

import numpy as np

__all__ = [
    "AdmissionRejected",
    "Request",
    "RequestState",
    "SamplingParams",
    "StepPlan",
    "TokenBudgetFCFS",
]

_ids = itertools.count()


class AdmissionRejected(ValueError):
    """A submit the engine can never serve (``reason``, with details)."""

    def __init__(self, reason: str, **details):
        self.reason = reason
        self.details = details
        super().__init__(f"admission rejected: {reason} {details}")


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request decoding controls; the port serves greedy only
    (``temperature == 0``, an exact argmax)."""

    temperature: float = 0.0

    def __post_init__(self):
        if self.temperature != 0.0:
            raise ValueError(
                f"only greedy decoding (temperature 0) is ported, got "
                f"{self.temperature}"
            )


class RequestState(enum.Enum):
    QUEUED = "queued"
    PREFILL = "prefill"
    DECODE = "decode"
    FINISHED = "finished"
    FAILED = "failed"

    @property
    def terminal(self) -> bool:
        return self in (RequestState.FINISHED, RequestState.FAILED)


@dataclasses.dataclass(eq=False)  # identity semantics: ndarray fields +
class Request:                    # list.remove/in on running queues
    prompt: np.ndarray  # (S,) int32
    max_new: int
    arrival: float = 0.0
    sampling: SamplingParams = dataclasses.field(default_factory=SamplingParams)
    rid: int = dataclasses.field(default_factory=lambda: next(_ids))

    state: RequestState = RequestState.QUEUED
    # why the request reached its terminal state ("length" or a failure)
    finish_reason: Optional[str] = None
    slot: Optional[int] = None
    prefill_pos: int = 0  # tokens of ``prefix`` already written to pages
    out_tokens: list = dataclasses.field(default_factory=list)
    n_evictions: int = 0

    # timing (engine-relative seconds)
    t_first: Optional[float] = None
    t_finish: Optional[float] = None
    token_times: list = dataclasses.field(default_factory=list)
    # optional per-emission last-token logits (tests/--check)
    step_logits: list = dataclasses.field(default_factory=list)

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
        return len(self.out_tokens) >= self.max_new

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


class TokenBudgetFCFS:
    """FCFS queue + per-step token budgeting against a PagedKVPool."""

    def __init__(self, *, token_budget: int, prefill_chunk: int):
        if token_budget < 1 or prefill_chunk < 1:
            raise ValueError("token_budget and prefill_chunk must be >= 1")
        self.token_budget = token_budget
        self.prefill_chunk = prefill_chunk
        self.waiting: list[Request] = []  # not yet arrived (virtual clock)
        self.queue: deque[Request] = deque()  # arrived, FCFS

    def submit(self, req: Request) -> None:
        self.waiting.append(req)
        self.waiting.sort(key=lambda r: (r.arrival, r.rid))

    def admit_arrivals(self, now: float) -> None:
        while self.waiting and self.waiting[0].arrival <= now:
            self.queue.append(self.waiting.pop(0))

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

    def plan(self, running: list[Request], pool) -> StepPlan:
        decode = [r for r in running if r.state is RequestState.DECODE]
        budget = self.token_budget - len(decode)
        prefill: list[tuple[Request, int]] = []
        # continue sequences already mid-prefill (FCFS)
        for r in sorted(
            (r for r in running if r.state is RequestState.PREFILL),
            key=lambda r: (r.arrival, r.rid),
        ):
            if budget <= 0:
                break
            n = min(self.prefill_chunk, len(r.prefix) - r.prefill_pos, budget)
            if n > 0:
                prefill.append((r, n))
                budget -= n
        # admit new requests while pages + budget allow (strict FCFS)
        while budget > 0 and self.queue:
            r = self.queue[0]
            slot = pool.admit(len(r.prefix))
            if slot is None:
                break
            self.queue.popleft()
            r.slot = slot
            r.state = RequestState.PREFILL
            r.prefill_pos = pool.length(slot)
            running.append(r)
            n = min(self.prefill_chunk, len(r.prefix) - r.prefill_pos, budget)
            prefill.append((r, n))
            budget -= n
        return StepPlan(decode=decode, prefill=prefill)
