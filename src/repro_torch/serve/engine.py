"""Continuous-batching engine: per-step batch assembly over paged KV.

Each :meth:`Engine.tick`:

  1. moves arrived requests into the FCFS queue;
  2. plans the step under the token budget (decode-prioritized, chunked
     prefill with leftover budget; admission claims pages);
  3. ensures every decode lane has a page for its next token, evicting the
     newest running sequence under page pressure (evicted requests requeue
     and later re-prefill their prompt + generated prefix);
  4. executes the step's prefill group — one batched paged dispatch over
     all planned chunks (``paged_prefill``), or a B=1 gather-dense loop
     (the oracle) — and one batched decode forward (fixed ``n_slots``
     lanes, per-lane positions) XOR one speculative verify
     (``speculative_k``), writing new K/V into the pool and appending the
     selected tokens.

Decode runs one of two adapter paths: gather-dense (the reference oracle:
every context page copied into a dense window per step) or **paged**
(``EngineConfig.paged_decode``: per-lane block tables + context lengths,
the paged-attention kernel reads the pool in place).  Block tables are
bucketed to the next power of two of the attended page count, as in the
JAX package, so both take the same decisions step for step.

``EngineConfig.prefix_cache`` maps full pages of previously seen prompt
prefixes into newly admitted slots (refcounted, copy-on-write), so shared
prompt headers are admitted at ``prefill_pos > 0`` and never recomputed;
``kv_int8`` stores the pages int8 with per-(token, head) scales.  The
request lifecycle — stop tokens, :meth:`Engine.cancel` from any live
state, deadlines enforced at tick boundaries, a bounded queue and tenant
rate limits with priority classes — takes the JAX package's decisions.

Selection is greedy (argmax) at temperature 0, else a temperature /
top-p draw: on the host from the request's numpy generator, or with
``device_sample`` on the device inside the paged dispatch, keyed by (seed,
emission index) so the stream survives batching, eviction and
speculative grouping.  ``speculative_k = K`` drafts up to K tokens per
lane from its own history (``serve/drafter.py``), verifies every lane's
``[last_emitted, drafts...]`` chunk in one ``(B, K+1)`` dispatch through
the chunked-prefill kernel, emits the accepted prefix plus one token, and
truncates the rejected tail's K/V.

Telemetry, faults and quality are the JAX package's: a
:class:`MetricsRegistry` holds the counters (``stats`` is a read view),
the pool gauges, ``last_tick_age_s`` and the TTFT/ITL/queue/e2e
histograms; :meth:`Engine.attach_tracer` wires one span tracer through the
engine (a ``step`` root per tick over ``schedule``/``prefill``/``decode``/
``verify``), the adapter and the scheduler; a :class:`FaultPlan` injects
``alloc_fail``, ``pool_exhausted``, ``nan_logits``, ``dispatch_error``
and ``cancel`` at their hooks, each firing counted as ``fault:<kind>``;
``screen_logits`` quarantines a lane whose logits carry NaN/Inf after one
``isfinite`` reduction on the device, of which only a ``(B,)`` bool
reaches the host; ``canary_every`` and ``shadow_rate`` run the quality
probes of ``serve/quality.py``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.serve.adapter import CachedDecoder, sample_tokens
from repro_torch.serve.drafter import make_drafter
from repro_torch.serve.faults import AdmissionRejected, FaultInjected, FaultPlan
from repro_torch.serve.kv_cache import page_bucket, pages_needed
from repro_torch.serve.quality import ShadowSampler, canary_probe
from repro_torch.serve.scheduler import (
    Request,
    RequestState,
    SamplingParams,
    StepPlan,
    TokenBudgetFCFS,
)
from repro_torch.serve.telemetry import (
    NULL_TRACER,
    MetricsRegistry,
    Tracer,
    emit_metrics_line,
)

__all__ = ["Engine", "EngineConfig", "TickResult"]

# counters the engine bumps on the hot path, in reporting order; the
# ``stats`` mapping is a read view over exactly these
_STAT_COUNTERS = (
    "steps",
    "decode_tokens",
    "prefill_tokens",
    "evictions",
    "prefill_batches",
    "prefill_batch_size",  # widest co-batched prefill group seen
    "prefix_hit_tokens",  # prompt tokens admitted from the prefix cache
    "spec_ticks",  # verify dispatches run
    "spec_lanes",  # lane verifications (lanes summed over ticks)
    "draft_tokens",  # tokens the drafter proposed
    "accepted_tokens",  # proposed tokens the verifier accepted
    "rolled_back_tokens",  # fed tokens whose K/V was truncated again
    "cancelled",  # requests reaching CANCELLED
    "failed",  # requests reaching FAILED (any reason)
    "deadline_missed",  # FAILED specifically for blowing deadline_s
    "quarantined_lanes",  # lanes the NaN/Inf screen pulled mid-batch
    "admission_rejected",  # submits refused with AdmissionRejected
    # ---- quality canaries (serve/quality.py) ----
    "canary_runs",  # out-of-band teacher-forced NLL probes run
    "shadow_samples",  # finished requests the drift sampler re-scored
    "shadow_tokens",  # emissions those samples covered
    "shadow_token_flips",  # emissions whose serving/oracle argmax differ
)


def _lane_finite(logits: torch.Tensor) -> np.ndarray:
    """Per-lane NaN/Inf screen: one ``isfinite`` reduction over a step's
    logits on their device; only the (B,) bool crosses to the host."""
    ok = torch.isfinite(logits).reshape(logits.shape[0], -1).all(dim=1)
    return ok.cpu().numpy()


@dataclasses.dataclass
class TickResult:
    """What one :meth:`Engine.tick` did: every (request, token) emission in
    order, and every request that reached a terminal state since the last
    tick's result was taken (between-tick cancels included)."""

    worked: bool
    t: float
    emitted: list  # [(Request, token), ...]
    finished: list  # [Request, ...] newly terminal


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    max_seq_len: int  # per-sequence token capacity (prompt + generation)
    n_slots: int = 8  # concurrent resident sequences (decode lanes)
    page_size: int = 16
    n_pages: Optional[int] = None  # default: no overcommit (+1 scratch)
    token_budget: int = 64  # tokens processed per step
    prefill_chunk: int = 32
    record_logits: bool = False  # keep per-emission logits (tests/--check)
    paged_decode: bool = False  # decode in place over the page pool
    paged_prefill: bool = False  # batched cross-request prefill over the pool
    prefix_cache: bool = False  # map cached prompt-prefix pages on admit
    kv_int8: bool = False  # int8 KV pages + per-(token, head) scales
    speculative_k: int = 0  # draft depth K (0 = one token per lane per tick)
    draft: str = "ngram"  # self-drafter kind (serve/drafter.py)
    draft_ngram: int = 3  # longest lookup pattern the ngram drafter tries
    device_sample: bool = False  # draw tokens inside the paged dispatch
    # default per-request deadline in seconds from arrival, enforced at
    # tick boundaries (None = none)
    deadline_s: Optional[float] = None
    # bounded admission queue: submits past this many pending requests
    # raise a retryable AdmissionRejected
    max_queue: Optional[int] = None
    # tenant name -> scheduler.TenantPolicy (None = every tenant
    # unlimited in class 0: strict FCFS)
    tenants: Optional[dict] = None
    aging_s: float = 2.0  # queue wait that promotes a request one class
    # eviction-storm guard: a request evicted this many times FAILS
    # ("eviction_storm") instead of replaying its prefix forever
    max_evictions: Optional[int] = 8
    # per-lane NaN/Inf screen on every step's logits: a poisoned lane is
    # quarantined (FAILED, "nan_logits"), co-batched lanes unharmed
    screen_logits: bool = False
    # seconds between teacher-forced NLL probes over the pinned canary set
    # (attach_canary); one probe also fires at run start
    canary_every: Optional[float] = None
    # fraction of requests re-scored against the dense trunk on finish
    # (crc32 selection of (shadow_seed, rid))
    shadow_rate: float = 0.0
    shadow_seed: int = 0

    @property
    def pages_per_seq(self) -> int:
        return pages_needed(self.max_seq_len, self.page_size)

    def total_pages(self) -> int:
        if self.n_pages is not None:
            return self.n_pages
        return self.n_slots * self.pages_per_seq + 1


class Engine:
    def __init__(self, adapter: CachedDecoder, ecfg: EngineConfig,
                 tracer: Optional[Tracer] = None,
                 faults: Optional[FaultPlan] = None):
        self.adapter = adapter
        self.ecfg = ecfg
        self.spec_k = ecfg.speculative_k
        if self.spec_k < 0:
            raise ValueError(f"speculative_k must be >= 0, got {self.spec_k}")
        if self.spec_k and not ecfg.paged_decode:
            raise ValueError(
                "speculative decode verifies drafts over the paged pool "
                "(the chunked-prefill kernel path); enable paged_decode")
        if ecfg.device_sample and not ecfg.paged_decode:
            raise ValueError(
                "on-device sampling runs inside the paged dispatches; "
                "enable paged_decode (or keep host-side sampling)")
        self.drafter = (make_drafter(ecfg.draft, self.spec_k,
                                     max_ngram=ecfg.draft_ngram)
                        if self.spec_k else None)
        self.pool = adapter.make_pool(
            n_pages=ecfg.total_pages(),
            page_size=ecfg.page_size,
            n_slots=ecfg.n_slots,
            max_pages_per_seq=ecfg.pages_per_seq,
            dtype=torch.int8 if ecfg.kv_int8 else None,
            prefix_cache=ecfg.prefix_cache,
        )
        self.scheduler = TokenBudgetFCFS(
            token_budget=ecfg.token_budget, prefill_chunk=ecfg.prefill_chunk,
            max_queue=ecfg.max_queue, tenants=ecfg.tenants,
            aging_s=ecfg.aging_s,
        )
        self.running: list[Request] = []
        self.finished: list[Request] = []
        self._tick_emitted: list = []
        self._tick_finished: list = []
        # the engine owns the plan's dispatch context (tick, lane_rids) and
        # points the pool's and the adapter's hooks at it; the default
        # empty plan makes every hook an iteration over no rule
        self.faults = faults if faults is not None else FaultPlan()
        self.pool.faults = self.faults
        adapter.faults = self.faults
        self._fault_log_pos = 0  # plan.log entries already reconciled
        # deadline sweeps run once any request carries a deadline
        self._deadlines = ecfg.deadline_s is not None
        self.metrics = MetricsRegistry()
        for name in _STAT_COUNTERS:
            self.metrics.counter(name)
        for name, fn in self.pool.metrics_gauges().items():
            self.metrics.gauge(name, fn=fn)
        self.metrics.gauge("finished", fn=lambda: len(self.finished))
        self.metrics.gauge("faults_injected", fn=lambda: len(self.faults.log))
        # tick-stall watchdog: seconds since the last COMPLETED tick
        self._last_tick_t = 0.0
        self.metrics.gauge("last_tick_age_s", fn=self.last_tick_age_s)
        for name in ("ttft_s", "itl_s", "queue_s", "e2e_s"):
            self.metrics.histogram(name)
        self.shadow = (
            ShadowSampler(adapter, ecfg.shadow_rate, seed=ecfg.shadow_seed,
                          metrics=self.metrics, tracer=NULL_TRACER)
            if ecfg.shadow_rate > 0.0 else None)
        if self.shadow is not None:
            for name in ("shadow_max_abs_logit_diff", "shadow_flip_rate"):
                self.metrics.histogram(name)
        if ecfg.canary_every is not None and ecfg.canary_every <= 0:
            raise ValueError(
                f"canary_every must be > 0 seconds, got {ecfg.canary_every}")
        self.canary_tokens: Optional[np.ndarray] = None
        self.tracer = NULL_TRACER
        # engine-relative clock: arrival offsets are measured from here
        self._t0 = time.perf_counter()
        if tracer is not None:
            self.attach_tracer(tracer)

    # ---- submission -----------------------------------------------------

    def submit(self, prompt: np.ndarray, max_new: int, arrival: float = 0.0,
               sampling: Optional[SamplingParams] = None,
               stop_tokens: tuple = (), deadline_s: Optional[float] = None,
               tenant: str = "default",
               priority: Optional[int] = None,
               resume_tokens: tuple = ()) -> Request:
        """Submit a request, or raise a typed :class:`AdmissionRejected`:
        not retryable when it can never fit this pool (per-sequence or
        total capacity, discounting full prompt pages the prefix cache
        already holds), retryable when the tenant's bucket is overdrawn or
        the bounded queue is full.  ``deadline_s`` overrides
        ``EngineConfig.deadline_s``; ``priority`` pins the class (None
        inherits the tenant policy's).

        ``resume_tokens`` are tokens a previous attempt already emitted
        (fleet failover): the request prefills over ``prompt +
        resume_tokens``, as an evicted request replays, and emits on from
        emission index ``len(resume_tokens)``.  ``max_new`` stays the
        whole budget, resumed tokens included, so the admission forecast
        ``prompt + max_new`` already counts them.  Greedy streams and
        device-sampled ones (the draw keys on ``fold_in(seed, emission
        index)``) then equal an uninterrupted run; the host draw's
        generator cannot be fast-forwarded, so it carries no such
        guarantee."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        total = prompt.size + max_new
        if total > self.pool.seq_capacity_tokens():
            self.metrics.inc("admission_rejected")
            raise AdmissionRejected(
                "over_capacity", retryable=False,
                needed_pages=pages_needed(total, self.ecfg.page_size),
                available_pages=self.pool.max_pages_per_seq)
        need = max(1, pages_needed(total, self.ecfg.page_size))
        # -1: even a full-prefix hit claims one copy-on-admit page
        cached = min(self.pool.cached_prefix_pages(prompt), need - 1)
        if need - cached > self.pool.n_pages - 1:
            self.metrics.inc("admission_rejected")
            raise AdmissionRejected(
                "over_capacity", retryable=False,
                needed_pages=need - cached,
                available_pages=self.pool.n_pages - 1)
        resume = [int(t) for t in resume_tokens]
        if resume:
            if len(resume) >= max_new:
                raise ValueError(
                    f"resume_tokens already meets max_new "
                    f"({len(resume)} >= {max_new}); nothing to resume")
            if resume[-1] in tuple(stop_tokens):
                raise ValueError(
                    "resume_tokens ends on a stop token; the original "
                    "stream already finished")
        req = Request(
            prompt=prompt, max_new=max_new, arrival=arrival,
            sampling=sampling or SamplingParams(),
            stop_tokens=tuple(stop_tokens),
            deadline_s=(self.ecfg.deadline_s if deadline_s is None
                        else deadline_s),
            tenant=tenant, priority=priority,
        )
        if resume:
            # the state an eviction leaves: prefill covers req.prefix =
            # prompt + resume, token_times backfilled with the arrival
            req.out_tokens = resume
            req.token_times = [arrival] * len(resume)
            req.resumed = len(resume)
        if self.shadow is not None:
            # decided at submit so the decode paths keep this request's
            # emission logits
            req.shadow = self.shadow.selects(req.rid)
        try:
            self.scheduler.submit(req)
        except AdmissionRejected:
            self.metrics.inc("admission_rejected")
            raise
        if req.deadline_s is not None:
            self._deadlines = True
        return req

    def cancel(self, rid: int) -> bool:
        """Cancel a request by id from any live state (waiting, queued,
        mid-prefill, mid-decode).  Its page references are dropped as a
        finish would drop them; the next tick's result reports it.
        Returns whether a live request was found."""
        now = self.now()
        sch = self.scheduler
        for r in sch.waiting:
            if r.rid == rid:
                sch.waiting.remove(r)
                self._cancel(r, now)
                return True
        for r in sch.queue:
            if r.rid == rid:
                sch.queue.remove(r)
                self._cancel(r, now)
                return True
        for r in self.running:
            if r.rid == rid:
                self._cancel(r, now)  # _terminalize detaches from running
                return True
        return False

    def live_requests(self) -> list[Request]:
        """Every non-terminal request: waiting, queued, and running."""
        sch = self.scheduler
        return [*sch.waiting, *sch.queue, *self.running]

    def cancel_all(self) -> list[Request]:
        """Cancel every live request; returns them."""
        victims = self.live_requests()
        for r in victims:
            self.cancel(r.rid)
        return victims

    def set_speculative_k(self, k: int) -> int:
        """Clamp the live draft depth to ``k``: it can shrink below, or come
        back up to, ``EngineConfig.speculative_k`` (the drafter was built
        for it); 0 runs one-token decode ticks.  Returns the depth in
        effect."""
        if k < 0:
            raise ValueError(f"speculative depth must be >= 0, got {k}")
        self.spec_k = min(k, self.ecfg.speculative_k)
        return self.spec_k

    # ---- telemetry and quality -----------------------------------------

    @property
    def stats(self) -> dict:
        """Read view: the hot-path counters as a plain dict (the registry
        is the source of truth; mutate via ``self.metrics``)."""
        return {n: self.metrics.counter(n).value for n in _STAT_COUNTERS}

    def attach_tracer(self, tracer: Tracer) -> None:
        """Wire a tracer through the engine (phase spans), the adapter
        (dispatch spans) and the scheduler (lifecycle events).  The
        tracer's clock becomes the engine clock, and a ``sync=True``
        tracer without a barrier gets :meth:`_sync_barrier`."""
        tracer.clock = self.now
        if tracer.sync and tracer.sync_fn is None:
            tracer.sync_fn = self._sync_barrier
        tracer.tags.update(self.adapter.trace_tags())
        self.tracer = tracer
        self.adapter.tracer = tracer
        self.scheduler.tracer = tracer
        if self.shadow is not None:
            self.shadow.tracer = tracer

    def attach_canary(self, tokens: np.ndarray) -> None:
        """Pin the canary prompt set: (B, S) int32 token ids scored
        teacher-forced by every canary probe (fixed, so the gauge stays
        comparable across ticks and restarts)."""
        tokens = np.asarray(tokens, np.int32)
        if tokens.ndim == 1:
            tokens = tokens[None]
        if tokens.ndim != 2 or tokens.shape[1] < 2:
            raise ValueError(
                f"canary set must be (B, S>=2) token ids, got {tokens.shape}")
        self.canary_tokens = tokens

    def _run_canary(self) -> None:
        """One out-of-band quality probe over the pinned canary set: the
        NLL and per-layer activation absmax / saturation as gauges.  The
        dense trunk runs with an empty context, so the pool is
        untouched."""
        nll, act = canary_probe(self.adapter, self.canary_tokens)
        m = self.metrics
        m.gauge("canary_nll").set(nll)
        m.inc("canary_runs")
        absmax, sat = act["absmax"], act["sat"]
        m.gauge("act_absmax").set(float(absmax.max()))
        m.gauge("act_sat").set(float(sat.max()))
        for i in range(len(absmax)):
            m.gauge(f"act_absmax:{i}").set(float(absmax[i]))
            m.gauge(f"act_sat:{i}").set(float(sat[i]))
        self.tracer.event(
            "canary_probe", nll=nll,
            act_absmax=float(absmax.max()), act_sat=float(sat.max()),
            prompts=int(self.canary_tokens.shape[0]),
            tokens=int(self.canary_tokens.size),
        )

    def _sync_barrier(self) -> None:
        """Block until every enqueued device step has retired (nothing to
        wait for on the CPU)."""
        if self.pool.device.type == "cuda":
            torch.cuda.synchronize(self.pool.device)

    # ---- main loop ------------------------------------------------------

    def now(self) -> float:
        """Engine-relative seconds (epoch: construction or reset_clock)."""
        return time.perf_counter() - self._t0

    def reset_clock(self) -> None:
        self._t0 = time.perf_counter()
        self._last_tick_t = 0.0

    def last_tick_age_s(self) -> float:
        """Seconds since the last completed :meth:`tick` (since the clock
        epoch if none has): a dispatch wedged inside a tick stops it."""
        return self.now() - self._last_tick_t

    def reset_stats(self) -> None:
        """Zero the counters and latency histograms (after a warm-up run);
        the pool's high-water mark rebases to its current use."""
        self.metrics.reset()
        self.pool.peak_pages_in_use = self.pool.pages_in_use

    @property
    def idle(self) -> bool:
        return not (self.scheduler.pending or self.running)

    def next_arrival(self) -> Optional[float]:
        w = self.scheduler.waiting
        return w[0].arrival if w else None

    def run(self, max_steps: Optional[int] = None,
            metrics_every: Optional[float] = None) -> list[Request]:
        """Drive until every submitted request is finished."""
        from repro_torch.serve.lifecycle import run_to_completion

        return run_to_completion(self, max_steps=max_steps,
                                 metrics_every=metrics_every)

    _METRICS_LINE_KEYS = (
        "steps", "decode_tokens", "prefill_tokens", "evictions",
        "pages_in_use", "occupancy", "finished", "acceptance_rate",
        "ttft_s_p50", "ttft_s_p99", "itl_s_p50", "itl_s_p99",
        "e2e_s_p50", "e2e_s_p99", "canary_nll",
    )

    def _emit_metrics_snapshot(self) -> None:
        emit_metrics_line(self.summary(), t=self.now(),
                          keys=list(self._METRICS_LINE_KEYS))

    def step(self) -> bool:
        return self.tick().worked

    def tick(self) -> TickResult:
        """One engine tick; returns what it emitted and finished.  Spans:
        ``step`` over ``schedule`` (arrivals, planning, page claims and
        eviction), ``prefill`` and ``decode`` XOR ``verify``."""
        tr = self.tracer
        with tr.span("step"):
            now = self.now()
            with tr.span("schedule"):
                if self.faults.rules:
                    self.faults.tick = self.metrics.counter("steps").value
                    for rid in self.faults.cancel_rids():
                        self.cancel(rid)
                self.scheduler.admit_arrivals(now)
                if self._deadlines:
                    self._enforce_deadlines(now)
                plan = self.scheduler.plan(self.running, self.pool, now=now)
                self.metrics.inc("prefix_hit_tokens", plan.prefix_hit_tokens)
                decode = self._ensure_decode_pages(plan, now)
                self._check_queue_head(now)
                # drop chunks whose request the page-ensure pass evicted
                # (or a fault, cancel or deadline terminalized)
                chunks = [(r, n) for r, n in plan.prefill
                          if r.state is RequestState.PREFILL]
            worked = False
            if chunks:
                with tr.span("prefill", lanes=len(chunks),
                             tokens=sum(n for _, n in chunks)):
                    if self.ecfg.paged_prefill:
                        self._run_prefill_batch(chunks, now)
                    else:
                        for req, n in chunks:
                            self._run_prefill_chunk(req, n, now)
                worked = True
            if decode:
                if self.spec_k:
                    with tr.span("verify", lanes=len(decode)):
                        self._run_decode_spec(decode, now)
                else:
                    with tr.span("decode", lanes=len(decode)):
                        self._run_decode(decode, now)
                worked = True
            self.metrics.inc("steps")
            if self.faults.rules:
                self._reconcile_faults()
        result = TickResult(worked=worked, t=now, emitted=self._tick_emitted,
                            finished=self._tick_finished)
        self._tick_emitted = []
        self._tick_finished = []
        self._last_tick_t = self.now()  # watchdog: tick COMPLETED
        return result

    # ---- internals ------------------------------------------------------

    @staticmethod
    def _select_token(req: Request, logits: np.ndarray) -> int:
        """The host draw from last-position logits: the argmax at
        temperature 0, else temperature, nucleus (top-p) filter and one
        draw in float64 from the request's own generator."""
        sp = req.sampling
        if sp.greedy:
            return int(np.argmax(logits))
        z = logits.astype(np.float64) / sp.temperature
        z -= z.max()
        p = np.exp(z)
        p /= p.sum()
        if sp.top_p < 1.0:
            order = np.argsort(-p)
            csum = np.cumsum(p[order])
            # smallest prefix with mass >= top_p (always keeps the head)
            keep = order[: int(np.searchsorted(csum, sp.top_p)) + 1]
            nucleus = np.zeros_like(p)
            nucleus[keep] = p[keep]
            p = nucleus / nucleus.sum()
        return int(req.rng.choice(p.size, p=p))

    def _boundary_token(self, req: Request, logits: np.ndarray) -> int:
        """The first token, at the prefill boundary.  With device sampling
        a non-greedy lane draws with :func:`sample_tokens` on the boundary
        logits, so an evicted and replayed request draws exactly what its
        uncontended run drew."""
        sp = req.sampling
        if not self.ecfg.device_sample or sp.greedy:
            return self._select_token(req, logits)
        dev = self.pool.device
        sel = sample_tokens(
            torch.as_tensor(logits, device=dev)[None, None],
            torch.tensor([sp.temperature], dtype=torch.float32, device=dev),
            torch.tensor([sp.top_p], dtype=torch.float32, device=dev),
            torch.tensor([sp.seed], dtype=torch.int32),
            torch.tensor([len(req.out_tokens)], dtype=torch.int32),
        )
        return int(sel[0, 0])

    def _evict(self, victim: Request, now: float) -> None:
        cap = self.ecfg.max_evictions
        if cap is not None and victim.n_evictions >= cap:
            self._fail(victim, "eviction_storm", now)
            return
        self.pool.release(victim.slot)
        self.running.remove(victim)
        self.scheduler.requeue(victim)
        self.metrics.inc("evictions")
        self.tracer.event(
            "request_evicted", rid=victim.rid,
            generated=len(victim.out_tokens), n_evictions=victim.n_evictions,
        )

    def _ensure_decode_pages(self, plan: StepPlan, now: float) -> list[Request]:
        """Claim a page for each decode lane's next token, evicting under
        pressure.  Lanes are served best-class-oldest-first and the victim
        is always the worst-class NEWEST running request — possibly the
        asking lane itself — so requests already granted pages this step
        are never clawed back, and low classes yield pages to high ones.
        An armed ``alloc_fail`` rule fails the targeted lane's claim
        terminally (FAILED, "alloc_fail")."""
        active = []
        faults = self.faults if self.faults.rules else None
        lane_key = lambda r: (r.priority or 0, r.arrival, r.rid)
        for r in sorted(plan.decode, key=lane_key):
            if r.state is not RequestState.DECODE:
                continue  # evicted (or terminalized) as a side effect
            if faults is not None and faults.fire("alloc_fail", rid=r.rid):
                self._fail(r, "alloc_fail", now)
                continue
            while not self.pool.extend(r.slot, self.pool.length(r.slot) + 1):
                self._evict(max(self.running, key=lane_key), now)
                if r.state is not RequestState.DECODE:
                    break  # r itself was evicted or stormed out
            else:
                active.append(r)
        return active

    def _enforce_deadlines(self, now: float) -> None:
        """Fail queued/running requests past their deadline.  Checked at
        tick boundaries: the tick in flight is never torn down."""
        sch = self.scheduler
        expired = [
            r for r in (*sch.queue, *self.running)
            if r.deadline_s is not None and now - r.arrival > r.deadline_s
        ]
        for r in expired:
            if r in sch.queue:
                sch.queue.remove(r)
            self.metrics.inc("deadline_missed")
            self._fail(r, "deadline", now)

    def _check_queue_head(self, now: float) -> None:
        """Fail a head-of-queue request whose prefix needs more distinct
        pages than the pool owns (cached or not: shared pages still occupy
        residency): it could never be admitted and would starve everything
        behind it."""
        q = self.scheduler.queue
        if not q:
            return
        head = q[0]
        need = max(1, pages_needed(len(head.prefix), self.ecfg.page_size))
        if need > self.pool.n_pages - 1:
            q.popleft()
            self._fail(head, "capacity", now)

    def _reconcile_faults(self) -> None:
        """Turn this tick's fault firings (plan.log) into telemetry: one
        ``fault:<kind>`` counter bump and one trace event each."""
        log = self.faults.log
        for entry in log[self._fault_log_pos:]:
            self.metrics.inc("fault:" + entry["kind"])
            self.tracer.event("fault_injected", **entry)
        self._fault_log_pos = len(log)

    def _screen_lanes(self, lanes: list[Request], logits, now: float) -> None:
        """Quarantine lanes whose logits carry NaN/Inf (:func:`_lane_finite`):
        the poisoned lane FAILS ("nan_logits") while co-batched lanes keep
        their untouched logit rows."""
        ok = _lane_finite(logits)
        for b, r in enumerate(lanes):
            if ok[b] or r.state.terminal:
                continue
            self.metrics.inc("quarantined_lanes")
            self._fail(r, "nan_logits", now)

    def _fail_dispatch(self, lanes, exc: FaultInjected, now: float) -> None:
        """A dispatch_error fired at the adapter entry: nothing ran and no
        pool length advanced.  Fail only the targeted request; surviving
        lanes retry next tick and recompute the identical step."""
        for r in lanes:
            if r is not None and r.rid == exc.rid and not r.state.terminal:
                self._fail(r, "dispatch_error", now)
                return

    def _terminalize(self, req: Request, state: RequestState, reason: str,
                     now: float) -> None:
        req.state = state
        req.finish_reason = reason
        req.t_finish = now
        if req.slot is not None:
            self.pool.release(req.slot)
            req.slot = None
        if req in self.running:
            self.running.remove(req)
        self.finished.append(req)
        self._tick_finished.append(req)
        self.metrics.inc("finish:" + reason)

    def _finish(self, req: Request, now: float) -> None:
        reason = (
            "stop" if req.out_tokens and req.out_tokens[-1] in req.stop_tokens
            else "length"
        )
        self._terminalize(req, RequestState.FINISHED, reason, now)
        # lifecycle latencies of FINISHED requests (a cancelled or failed
        # one has no honest end-to-end time)
        m = self.metrics
        m.histogram("ttft_s").observe(req.t_first - req.arrival)
        m.histogram("e2e_s").observe(now - req.arrival)
        if req.t_admitted is not None:
            m.histogram("queue_s").observe(req.t_admitted - req.arrival)
        itl = m.histogram("itl_s")
        for a, b in zip(req.token_times, req.token_times[1:]):
            itl.observe(b - a)
        self.tracer.event(
            "request_finished", rid=req.rid, tokens=len(req.out_tokens),
            e2e_s=now - req.arrival, n_evictions=req.n_evictions,
        )
        if req.shadow and self.shadow is not None:
            self.shadow.observe(req)

    def _cancel(self, req: Request, now: float) -> None:
        self._terminalize(req, RequestState.CANCELLED, "cancelled", now)
        self.metrics.inc("cancelled")
        self.tracer.event(
            "request_cancelled", rid=req.rid, tokens=len(req.out_tokens),
        )

    def _fail(self, req: Request, reason: str, now: float) -> None:
        if req in self.scheduler.queue:
            self.scheduler.queue.remove(req)
        self._terminalize(req, RequestState.FAILED, reason, now)
        self.metrics.inc("failed")
        self.tracer.event(
            "request_failed", rid=req.rid, reason=reason,
            tokens=len(req.out_tokens), n_evictions=req.n_evictions,
        )

    def _keeps_logits(self, req: Request) -> bool:
        """Whether ``req``'s emission logits are kept: under --check
        (``record_logits``) and for shadow-sampled requests only."""
        return self.ecfg.record_logits or req.shadow

    def _emit(self, req: Request, token: int, logits, now: float) -> None:
        req.emit(token, now, logits if self._keeps_logits(req) else None)
        self._tick_emitted.append((req, token))
        if len(req.out_tokens) == 1:
            self.tracer.event("first_token", rid=req.rid,
                              ttft_s=now - req.arrival)

    def _after_prefill_chunk(self, req: Request, n: int, last_logits,
                             now: float) -> None:
        """Advance, register cached prompt pages, and emit the first
        generated token when the prefix completes."""
        req.prefill_pos += n
        self.metrics.inc("prefill_tokens", n)
        if self.pool.prefix_cache:
            covered = min(req.prefill_pos, len(req.prompt))
            self.pool.register_prefix(req.slot, req.prompt[:covered])
        if req.prefill_pos == len(req.prefix):
            # the boundary row crosses to the host for the first token
            # anyway; the screen reads that copy
            last = last_logits.float().cpu().numpy()
            if self.ecfg.screen_logits and not np.all(np.isfinite(last)):
                self.metrics.inc("quarantined_lanes")
                self._fail(req, "nan_logits", now)
                return
            req.state = RequestState.DECODE
            self._emit(req, self._boundary_token(req, last), last, now)
            if req.done:
                self._finish(req, now)

    def _run_prefill_chunk(self, req: Request, n: int, now: float) -> None:
        prefix = req.prefix
        start = req.prefill_pos
        C = self.ecfg.prefill_chunk
        chunk = np.zeros((1, C), np.int32)
        chunk[0, :n] = prefix[start : start + n]
        positions = (np.arange(C, dtype=np.int32) + start)[None]
        ctx_k, ctx_v = self.pool.gather([req.slot])
        if self.faults.rules:
            self.faults.lane_rids = (req.rid,)
            # only the boundary chunk's last logit is consumed; NaN in an
            # earlier chunk's discarded logits is unobservable
            self.faults.poison_rids = (
                (req.rid,) if start + n == len(prefix) else ())
        try:
            logits, k_new, v_new = self.adapter(
                chunk, positions, ctx_k, ctx_v,
                np.asarray([start], np.int32))
        except FaultInjected as e:
            self._fail_dispatch([req], e, now)
            return  # prefill_pos unchanged: a survivor replans as-is
        self.pool.write_span(req.slot, start, n, k_new[:, 0], v_new[:, 0])
        self._after_prefill_chunk(req, n, logits[0, n - 1], now)

    def _run_prefill_batch(self, chunks, now: float) -> None:
        """One fused dispatch over the step's whole prefill group: lanes
        padded to a power of two, chunk width fixed at ``prefill_chunk``,
        block tables bucketed to the longest prior context.  Padded lanes
        and padded chunk tails scatter to the scratch page."""
        C = self.ecfg.prefill_chunk
        B = page_bucket(len(chunks), 1 << 16)
        tokens = np.zeros((B, C), np.int32)
        positions = np.tile(np.arange(C, dtype=np.int32), (B, 1))
        ctx_len = np.zeros((B,), np.int32)
        slots: list[Optional[int]] = [None] * B
        starts = [0] * B
        ns = [0] * B
        for b, (r, n) in enumerate(chunks):
            start = r.prefill_pos
            tokens[b, :n] = r.prefix[start : start + n]
            positions[b] += start
            ctx_len[b] = start
            slots[b], starts[b], ns[b] = r.slot, start, n
        pages, offs = self.pool.span_addresses(slots, starts, ns, C)
        bt = self.pool.block_table(slots)
        bt = bt[:, : self._active_pages(int(ctx_len.max(initial=1)))]
        if self.faults.rules:
            self.faults.lane_rids = tuple(r.rid for r, _ in chunks)
            self.faults.poison_rids = tuple(
                r.rid for r, n in chunks
                if r.prefill_pos + n == len(r.prefix))
        try:
            logits = self.adapter.prefill_paged(
                tokens, positions, bt, ctx_len, pages, offs, self.pool)
        except FaultInjected as e:
            # lengths never advanced: surviving chunks replan next tick
            # and recompute the identical K/V
            self._fail_dispatch([r for r, _ in chunks], e, now)
            return
        self.pool.note_span_written(slots, starts, ns)
        self.metrics.inc("prefill_batches")
        self.metrics.counter("prefill_batch_size").peak(len(chunks))
        for b, (r, n) in enumerate(chunks):
            self._after_prefill_chunk(r, n, logits[b, n - 1], now)

    def _active_pages(self, max_ctx: int) -> int:
        """Pages to attend this step: covers the longest live context,
        rounded up to a power of two."""
        return page_bucket(
            pages_needed(max_ctx, self.ecfg.page_size),
            self.pool.max_pages_per_seq,
        )

    def _sampling_arrays(self, reqs: list[Request], B: int):
        """(temps, top_ps, seeds, draws) per lane for the device draw;
        ``draws`` is each lane's emission count so far."""
        temps = np.zeros(B, np.float32)
        top_ps = np.ones(B, np.float32)
        seeds = np.zeros(B, np.int32)
        draws = np.zeros(B, np.int32)
        for b, r in enumerate(reqs):
            temps[b] = r.sampling.temperature
            top_ps[b] = r.sampling.top_p
            seeds[b] = r.sampling.seed
            draws[b] = len(r.out_tokens)
        return temps, top_ps, seeds, draws

    def _run_decode(self, decode: list[Request], now: float) -> None:
        B = self.ecfg.n_slots
        if len(decode) > B:
            raise RuntimeError(f"{len(decode)} decode lanes > {B} slots")
        slots: list[Optional[int]] = [None] * B
        tokens = np.zeros((B, 1), np.int32)
        positions = np.zeros((B, 1), np.int32)
        ctx_len = np.zeros((B,), np.int32)
        for b, r in enumerate(decode):
            slots[b] = r.slot
            tokens[b, 0] = r.out_tokens[-1]
            ctx_len[b] = self.pool.length(r.slot)
            positions[b, 0] = ctx_len[b]
        pos_list = [int(p) for p in positions[:, 0]]
        sel = None
        if self.faults.rules:
            self.faults.lane_rids = tuple(r.rid for r in decode)
            self.faults.poison_rids = self.faults.lane_rids
        try:
            if self.ecfg.paged_decode:
                bt = self.pool.block_table(slots)
                bt = bt[:, : self._active_pages(int(ctx_len.max(initial=1)))]
                pages, offs = self.pool.addresses(slots, pos_list)
                if self.ecfg.device_sample:
                    sel, logits = self.adapter.decode_paged_sample(
                        tokens, positions, bt, ctx_len, pages, offs,
                        self._sampling_arrays(decode, B), self.pool)
                    sel = sel[:, 0].cpu().numpy()
                else:
                    logits = self.adapter.decode_paged(
                        tokens, positions, bt, ctx_len, pages, offs,
                        self.pool)
                self.pool.note_written(slots, pos_list)
            else:
                ctx_k, ctx_v = self.pool.gather(slots)
                logits, k_new, v_new = self.adapter(
                    tokens, positions, ctx_k, ctx_v, ctx_len)
                self.pool.write(slots, pos_list, k_new[:, :, 0],
                                v_new[:, :, 0])
        except FaultInjected as e:
            # nothing dispatched, lengths untouched: fail the target only;
            # surviving lanes redo the identical step next tick
            self._fail_dispatch(decode, e, now)
            return
        if self.ecfg.screen_logits:
            self._screen_lanes(decode, logits, now)
        with self.tracer.span("emit", lanes=len(decode)):
            logits_np = None
            if sel is None or any(self._keeps_logits(r) for r in decode):
                logits_np = logits[:, 0].float().cpu().numpy()
            for b, r in enumerate(decode):
                if r.state.terminal:
                    continue  # quarantined by the screen this tick
                tok = (int(sel[b]) if sel is not None
                       else self._select_token(r, logits_np[b]))
                self._emit(r, tok,
                           None if logits_np is None else logits_np[b], now)
                self.metrics.inc("decode_tokens")
                if r.done:
                    self._finish(r, now)

    def _run_decode_spec(self, decode: list[Request], now: float) -> None:
        """One speculative tick: draft up to K tokens per lane, verify every
        lane's ``[last_emitted, drafts...]`` chunk in one padded (B, K+1)
        dispatch, emit each lane's accepted prefix plus one token, and
        roll back the rejected tail's K/V."""
        B, K = self.ecfg.n_slots, self.spec_k
        W = K + 1
        if len(decode) > B:
            raise RuntimeError(f"{len(decode)} decode lanes > {B} slots")
        slots: list[Optional[int]] = [None] * B
        tokens = np.zeros((B, W), np.int32)
        positions = np.tile(np.arange(W, dtype=np.int32), (B, 1))
        ctx_len = np.zeros((B,), np.int32)
        drafts = np.zeros((B, K), np.int32)
        n_drafts = np.zeros((B,), np.int32)
        starts = [0] * B
        widths = [0] * B
        with self.tracer.span("draft", lanes=len(decode)):
            for b, r in enumerate(decode):
                slots[b] = r.slot
                length = self.pool.length(r.slot)
                # opportunistic draft, capped by the request's remaining
                # tokens, the slot's capacity and free pages: drafting
                # never evicts (the +1 page was claimed by
                # _ensure_decode_pages)
                room = min(K, r.max_new - len(r.out_tokens) - 1,
                           self.pool.seq_capacity_tokens() - (length + 1))
                prop = (self.drafter.propose(r.prefix, room) if room > 0
                        else np.zeros(0, np.int32))
                n = len(prop)
                while n > 0 and not self.pool.extend(r.slot, length + 1 + n):
                    n -= 1
                tokens[b, 0] = r.out_tokens[-1]
                tokens[b, 1 : 1 + n] = prop[:n]
                drafts[b, :n] = prop[:n]
                n_drafts[b] = n
                positions[b] += length
                ctx_len[b] = length
                starts[b], widths[b] = length, 1 + n
                self.metrics.inc("draft_tokens", n)
        pages, offs = self.pool.span_addresses(slots, starts, widths, W)
        bt = self.pool.block_table(slots)
        bt = bt[:, : self._active_pages(int(ctx_len.max(initial=1)))]
        sampling = (
            self._sampling_arrays(decode, B) if self.ecfg.device_sample
            # host sampling: zero temps make the device selection greedy;
            # the host re-selects from the logits
            else (np.zeros(B, np.float32), np.ones(B, np.float32),
                  np.zeros(B, np.int32), np.zeros(B, np.int32)))
        if self.faults.rules:
            self.faults.lane_rids = tuple(r.rid for r in decode)
            self.faults.poison_rids = self.faults.lane_rids
        try:
            sel, n_acc, logits = self.adapter.verify_paged(
                tokens, positions, bt, ctx_len, pages, offs, drafts,
                n_drafts, sampling, self.pool)
        except FaultInjected as e:
            self._fail_dispatch(decode, e, now)
            # unmap the opportunistic draft pages: lengths never advanced,
            # so surviving lanes re-draft from ctx_len next tick
            for b, r in enumerate(decode):
                if not r.state.terminal:
                    self.pool.truncate(r.slot, starts[b])
            return
        self.pool.note_span_written(slots, starts, widths)
        if self.ecfg.screen_logits:
            self._screen_lanes(decode, logits, now)
        self.metrics.inc("spec_ticks")
        self.metrics.inc("spec_lanes", len(decode))
        with self.tracer.span("emit", lanes=len(decode)):
            logits_np = None
            if (not self.ecfg.device_sample
                    or any(self._keeps_logits(r) for r in decode)):
                logits_np = logits.float().cpu().numpy()
            sel, n_acc = sel.cpu().numpy(), n_acc.cpu().numpy()
            extra = 0
            for b, r in enumerate(decode):
                if r.state.terminal:
                    continue  # quarantined by the screen; slot freed
                length = int(ctx_len[b])
                emitted = 0
                i = 0
                while True:
                    tok = (int(sel[b, i]) if self.ecfg.device_sample
                           else self._select_token(r, logits_np[b, i]))
                    self._emit(r, tok, None if logits_np is None
                               else logits_np[b, i], now)
                    emitted += 1
                    if self.ecfg.device_sample:
                        if r.done or i >= int(n_acc[b]):
                            break
                    elif r.done or i >= n_drafts[b] or tok != drafts[b, i]:
                        break
                    i += 1
                self.metrics.inc("decode_tokens", emitted)
                self.metrics.inc("accepted_tokens", emitted - 1)
                self.metrics.inc("rolled_back_tokens", widths[b] - emitted)
                extra += emitted - 1
                if r.done:
                    self._finish(r, now)  # releases the slot: no rollback
                else:
                    # the last emitted token's K/V is computed next tick
                    # (it is the new last_emitted), so the valid length is
                    # ctx + emitted
                    self.pool.truncate(r.slot, length + emitted)
        # accepted extras beyond the planned one per lane charge the next
        # step's budget; rejected drafts were never charged
        self.scheduler.charge_accepted(extra)

    # ---- reporting ------------------------------------------------------

    def summary(self) -> dict:
        """One metrics snapshot: every counter, every live pool gauge, the
        latency histograms (``ttft_s_p50`` / ``itl_s_p99`` / ``queue_s_*``
        / ``e2e_s_*``, None until a request finished) and the speculative
        ratios."""
        s = self.metrics.snapshot()
        # speculative health: how often the drafter was right, and tokens
        # one lane emits per verify it takes part in (1 = no benefit)
        s["acceptance_rate"] = s["accepted_tokens"] / max(1, s["draft_tokens"])
        s["accepted_per_tick"] = (s["accepted_tokens"]
                                  / max(1, s["spec_ticks"]))
        s["tokens_per_lane_tick"] = (
            s["decode_tokens"] / max(1, s["spec_lanes"])
            if s["spec_ticks"] else 1.0)
        return s
