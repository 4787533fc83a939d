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
     lanes, per-lane positions), writing new K/V into the pool and
     appending greedy tokens.

Decode runs one of two adapter paths: gather-dense (the reference oracle:
every context page copied into a dense window per step) or **paged**
(``EngineConfig.paged_decode``: per-lane block tables + context lengths,
the paged-attention kernel reads the pool in place).  Block tables are
bucketed to the next power of two of the attended page count, as in the
JAX package, so both take the same decisions step for step.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.serve.adapter import CachedDecoder
from repro_torch.serve.kv_cache import page_bucket, pages_needed
from repro_torch.serve.scheduler import (
    AdmissionRejected,
    Request,
    RequestState,
    SamplingParams,
    StepPlan,
    TokenBudgetFCFS,
)

__all__ = ["Engine", "EngineConfig", "TickResult"]

# counters the engine bumps on the hot path, in reporting order
_STAT_COUNTERS = (
    "steps",
    "decode_tokens",
    "prefill_tokens",
    "evictions",
    "prefill_batches",
    "prefill_batch_size",  # widest co-batched prefill group seen
    "failed",
)


@dataclasses.dataclass
class TickResult:
    """What one :meth:`Engine.tick` did: every (request, token) emission in
    order, and every request that reached a terminal state."""

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
    # eviction-storm guard: a request evicted this many times FAILS
    # ("eviction_storm") instead of replaying its prefix forever
    max_evictions: Optional[int] = 8

    @property
    def pages_per_seq(self) -> int:
        return pages_needed(self.max_seq_len, self.page_size)

    def total_pages(self) -> int:
        if self.n_pages is not None:
            return self.n_pages
        return self.n_slots * self.pages_per_seq + 1


class Engine:
    def __init__(self, adapter: CachedDecoder, ecfg: EngineConfig):
        self.adapter = adapter
        self.ecfg = ecfg
        self.pool = adapter.make_pool(
            n_pages=ecfg.total_pages(),
            page_size=ecfg.page_size,
            n_slots=ecfg.n_slots,
            max_pages_per_seq=ecfg.pages_per_seq,
        )
        self.scheduler = TokenBudgetFCFS(
            token_budget=ecfg.token_budget, prefill_chunk=ecfg.prefill_chunk,
        )
        self.running: list[Request] = []
        self.finished: list[Request] = []
        self.stats = dict.fromkeys(_STAT_COUNTERS, 0)
        self._tick_emitted: list = []
        self._tick_finished: list = []
        # engine-relative clock: arrival offsets are measured from here
        self._t0 = time.perf_counter()

    # ---- submission -----------------------------------------------------

    def submit(self, prompt: np.ndarray, max_new: int, arrival: float = 0.0,
               sampling: Optional[SamplingParams] = None) -> Request:
        """Submit a request, or raise :class:`AdmissionRejected` when it can
        never fit this pool (per-sequence or total capacity)."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        total = prompt.size + max_new
        need = max(1, pages_needed(total, self.ecfg.page_size))
        if total > self.pool.seq_capacity_tokens():
            raise AdmissionRejected("over_capacity", needed_pages=need,
                                    available_pages=self.pool.max_pages_per_seq)
        if need > self.pool.n_pages - 1:
            raise AdmissionRejected("over_capacity", needed_pages=need,
                                    available_pages=self.pool.n_pages - 1)
        req = Request(prompt=prompt, max_new=max_new, arrival=arrival,
                      sampling=sampling or SamplingParams())
        self.scheduler.submit(req)
        return req

    # ---- main loop ------------------------------------------------------

    def now(self) -> float:
        """Engine-relative seconds (epoch: construction or reset_clock)."""
        return time.perf_counter() - self._t0

    def reset_clock(self) -> None:
        self._t0 = time.perf_counter()

    @property
    def idle(self) -> bool:
        return not (self.scheduler.pending or self.running)

    def next_arrival(self) -> Optional[float]:
        w = self.scheduler.waiting
        return w[0].arrival if w else None

    def run(self, max_steps: Optional[int] = None) -> list[Request]:
        """Drive until every submitted request is finished."""
        from repro_torch.serve.lifecycle import run_to_completion

        return run_to_completion(self, max_steps=max_steps)

    def step(self) -> bool:
        return self.tick().worked

    def tick(self) -> TickResult:
        """One engine tick; returns what it emitted and finished."""
        now = self.now()
        self.scheduler.admit_arrivals(now)
        plan = self.scheduler.plan(self.running, self.pool)
        decode = self._ensure_decode_pages(plan, now)
        self._check_queue_head(now)
        # drop chunks whose request the page-ensure pass evicted
        chunks = [(r, n) for r, n in plan.prefill
                  if r.state is RequestState.PREFILL]
        worked = False
        if chunks:
            if self.ecfg.paged_prefill:
                self._run_prefill_batch(chunks, now)
            else:
                for req, n in chunks:
                    self._run_prefill_chunk(req, n, now)
            worked = True
        if decode:
            self._run_decode(decode, now)
            worked = True
        self.stats["steps"] += 1
        result = TickResult(worked=worked, t=now, emitted=self._tick_emitted,
                            finished=self._tick_finished)
        self._tick_emitted = []
        self._tick_finished = []
        return result

    # ---- internals ------------------------------------------------------

    def _sync_barrier(self) -> None:
        """Block until every enqueued device step has retired."""
        if self.pool.device.type == "cuda":
            torch.cuda.synchronize(self.pool.device)

    def _evict(self, victim: Request, now: float) -> None:
        cap = self.ecfg.max_evictions
        if cap is not None and victim.n_evictions >= cap:
            self._fail(victim, "eviction_storm", now)
            return
        self.pool.release(victim.slot)
        self.running.remove(victim)
        self.scheduler.requeue(victim)
        self.stats["evictions"] += 1

    def _ensure_decode_pages(self, plan: StepPlan, now: float) -> list[Request]:
        """Claim a page for each decode lane's next token, evicting under
        pressure.  Lanes are served oldest-first and the victim is always
        the NEWEST running request — possibly the asking lane itself — so
        requests already granted pages this step are never clawed back."""
        active = []
        lane_key = lambda r: (r.arrival, r.rid)
        for r in sorted(plan.decode, key=lane_key):
            if r.state is not RequestState.DECODE:
                continue  # evicted as a side effect
            while not self.pool.extend(r.slot, self.pool.length(r.slot) + 1):
                self._evict(max(self.running, key=lane_key), now)
                if r.state is not RequestState.DECODE:
                    break  # r itself was evicted or stormed out
            else:
                active.append(r)
        return active

    def _check_queue_head(self, now: float) -> None:
        """Fail a head-of-queue request whose prefix needs more distinct
        pages than the pool owns: it could never be admitted and would
        starve everything behind it."""
        q = self.scheduler.queue
        if not q:
            return
        head = q[0]
        need = max(1, pages_needed(len(head.prefix), self.ecfg.page_size))
        if need > self.pool.n_pages - 1:
            q.popleft()
            self._fail(head, "capacity", now)

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

    def _finish(self, req: Request, now: float) -> None:
        self._terminalize(req, RequestState.FINISHED, "length", now)

    def _fail(self, req: Request, reason: str, now: float) -> None:
        if req in self.scheduler.queue:
            self.scheduler.queue.remove(req)
        self._terminalize(req, RequestState.FAILED, reason, now)
        self.stats["failed"] += 1

    def _emit(self, req: Request, token: int, logits, now: float) -> None:
        req.emit(token, now, logits if self.ecfg.record_logits else None)
        self._tick_emitted.append((req, token))

    def _after_prefill_chunk(self, req: Request, n: int, last_logits,
                             now: float) -> None:
        """Advance, and emit the first generated token when the prefix
        completes."""
        req.prefill_pos += n
        self.stats["prefill_tokens"] += n
        if req.prefill_pos == len(req.prefix):
            last = last_logits.float().cpu().numpy()
            req.state = RequestState.DECODE
            self._emit(req, int(np.argmax(last)), last, now)
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
        logits, k_new, v_new = self.adapter(
            chunk, positions, ctx_k, ctx_v, np.asarray([start], np.int32))
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
        logits = self.adapter.prefill_paged(
            tokens, positions, bt, ctx_len, pages, offs, self.pool)
        self.pool.note_span_written(slots, starts, ns)
        self.stats["prefill_batches"] += 1
        self.stats["prefill_batch_size"] = max(
            self.stats["prefill_batch_size"], len(chunks))
        for b, (r, n) in enumerate(chunks):
            self._after_prefill_chunk(r, n, logits[b, n - 1], now)

    def _active_pages(self, max_ctx: int) -> int:
        """Pages to attend this step: covers the longest live context,
        rounded up to a power of two."""
        return page_bucket(
            pages_needed(max_ctx, self.ecfg.page_size),
            self.pool.max_pages_per_seq,
        )

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
        if self.ecfg.paged_decode:
            bt = self.pool.block_table(slots)
            bt = bt[:, : self._active_pages(int(ctx_len.max(initial=1)))]
            pages, offs = self.pool.addresses(slots, pos_list)
            sel, logits = self.adapter.decode_paged_sample(
                tokens, positions, bt, ctx_len, pages, offs, self.pool)
            self.pool.note_written(slots, pos_list)
            sel = sel[:, 0].cpu().numpy()
        else:
            ctx_k, ctx_v = self.pool.gather(slots)
            logits, k_new, v_new = self.adapter(
                tokens, positions, ctx_k, ctx_v, ctx_len)
            self.pool.write(slots, pos_list, k_new[:, :, 0], v_new[:, :, 0])
            sel = None
        logits_np = None
        if sel is None or self.ecfg.record_logits:
            logits_np = logits[:, 0].float().cpu().numpy()
        for b, r in enumerate(decode):
            tok = int(sel[b]) if sel is not None else int(
                np.argmax(logits_np[b]))
            self._emit(r, tok, None if logits_np is None else logits_np[b],
                       now)
            self.stats["decode_tokens"] += 1
            if r.done:
                self._finish(r, now)

    # ---- reporting ------------------------------------------------------

    def summary(self) -> dict:
        """Counters, pool gauges, and latency percentiles (seconds) over
        the finished requests."""
        s = dict(self.stats)
        pool = self.pool
        s["pages_in_use"] = pool.pages_in_use
        s["peak_pages_in_use"] = pool.peak_pages_in_use
        s["peak_occupancy"] = pool.peak_pages_in_use / max(1, pool.n_pages - 1)
        done = [r for r in self.finished if r.state is RequestState.FINISHED]
        ttft = [r.t_first - r.arrival for r in done]
        itl = [b - a for r in done for a, b in zip(r.token_times,
                                                   r.token_times[1:])]
        e2e = [r.t_finish - r.arrival for r in done]
        for name, vals in (("ttft_s", ttft), ("itl_s", itl), ("e2e_s", e2e)):
            for q in (50, 99):
                s[f"{name}_p{q}"] = (float(np.percentile(vals, q))
                                     if vals else None)
        return s
