"""Port parity: the scheduler's multi-tenant admission.

Mirrors ``tests/test_scheduler_fairness.py`` on the port (token-bucket
maths, typed retryable rejections, the rate limit before the queue bound,
FCFS within a class, aging, ``shed_priority``, tenant defaults and
validation), then drives seeded op sequences through both packages'
schedulers against a fake pool: the same plans, queue orders and
rejections at every step."""
from __future__ import annotations

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from repro.serve import scheduler as ref_sched
from repro_torch.serve import scheduler as port_sched
from repro_torch.serve.frontdoor.admission import parse_tenants
from repro_torch.serve.scheduler import (
    AdmissionRejected,
    Request,
    RequestState,
    TenantPolicy,
    TokenBucket,
    TokenBudgetFCFS,
)


class FakePool:
    """The pool surface ``plan()`` touches: bounded slots, and a prefix
    hit of a few tokens decided by the request's first token (so hits
    move prefill starts the way the prefix cache does)."""

    def __init__(self, n_slots: int, hits: bool = False):
        self.n_slots = n_slots
        self.hits = hits
        self._live: dict[int, int] = {}
        self._next = 0

    def admit(self, n_tokens: int, tokens=None):
        if len(self._live) >= self.n_slots:
            return None
        self._next += 1
        hit = 0
        if self.hits and tokens is not None:
            hit = min(4 * (int(tokens[0]) % 3), n_tokens - 1)
        self._live[self._next] = hit
        return self._next

    def length(self, slot: int) -> int:
        return self._live[slot]

    def release(self, slot: int) -> None:
        del self._live[slot]


def _req(arrival=0.0, priority=None, tenant="default", n_prompt=4,
         max_new=4, cls=Request, first=1):
    return cls(prompt=np.arange(first, first + n_prompt, dtype=np.int32),
               max_new=max_new, arrival=arrival, tenant=tenant,
               priority=priority)


def _drive(sched, pool, *, dt=0.25, service_plans=2, max_t=400.0):
    """The engine loop over a fake pool: each running request gets
    ``service_plans`` planning rounds, then finishes.  Returns the time
    each request was admitted at."""
    running: list[Request] = []
    seen_plans: dict[int, int] = {}
    admitted_at: dict[int, float] = {}
    t = 0.0
    while (sched.pending or running) and t < max_t:
        sched.admit_arrivals(t)
        sched.plan(running, pool, now=t)
        for r in list(running):
            admitted_at.setdefault(r.rid, t)
            seen_plans[r.rid] = seen_plans.get(r.rid, 0) + 1
            if seen_plans[r.rid] >= service_plans:
                pool.release(r.slot)
                running.remove(r)
                r.state = RequestState.FINISHED
        t += dt
    return admitted_at


# ---- properties (as the reference's sweeps) -------------------------------


@settings(max_examples=30, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(st.lists(st.tuples(st.integers(0, 3),
                          st.floats(0.0, 4.0, allow_nan=False)),
                min_size=1, max_size=16))
def test_no_starvation_under_mixed_priorities(specs):
    sched = TokenBudgetFCFS(token_budget=8, prefill_chunk=4, aging_s=0.5)
    reqs = [_req(arrival=a, priority=p) for p, a in specs]
    for r in reqs:
        sched.submit(r)
    admitted_at = _drive(sched, FakePool(n_slots=2))
    assert not sched.pending
    assert all(r.rid in admitted_at for r in reqs), "a request starved"


@settings(max_examples=40, deadline=None)
@given(rate=st.floats(0.5, 10.0, allow_nan=False), burst=st.integers(1, 5),
       offsets=st.lists(st.floats(0.0, 8.0, allow_nan=False), min_size=1,
                        max_size=48))
def test_token_bucket_never_exceeds_rate_and_matches_reference(
        rate, burst, offsets):
    """Admissions in any window stay within burst + rate * window, and
    every take answers as the reference's bucket does."""
    bucket, ref = TokenBucket(rate, burst), ref_sched.TokenBucket(rate, burst)
    admitted = []
    for t in sorted(offsets):
        got = bucket.try_take(t)
        assert got == ref.try_take(t)
        if got is None:
            admitted.append(t)
    for i, t0 in enumerate(admitted):
        for j in range(i, len(admitted)):
            assert j - i + 1 <= burst + rate * (admitted[j] - t0) + 1e-6


@settings(max_examples=30, deadline=None)
@given(st.lists(st.floats(0.0, 10.0, allow_nan=False), min_size=1,
                max_size=32))
def test_unlimited_tenant_never_rejected(times):
    sched = TokenBudgetFCFS(token_budget=8, prefill_chunk=4,
                            tenants={"vip": TenantPolicy(rate=None)})
    for t in sorted(times):
        sched.submit(_req(arrival=t, tenant="vip"))
    assert sched.pending == len(times)


# ---- deterministic cases (as the reference's) -----------------------------


def test_token_bucket_refill_math():
    b = TokenBucket(1.0, 2)
    assert b.try_take(0.0) is None
    assert b.try_take(0.0) is None  # burst of 2
    assert b.try_take(0.0) == pytest.approx(1.0)  # one token refills in 1s
    assert b.try_take(0.5) is not None  # still short
    assert b.try_take(1.0) is None  # refilled
    assert b.try_take(0.0) is not None  # a clock going back mints nothing


def test_rate_limited_rejection_is_typed_and_retryable():
    sched = TokenBudgetFCFS(
        token_budget=8, prefill_chunk=4,
        tenants={"free": TenantPolicy(rate=0.5, burst=1)})
    sched.submit(_req(tenant="free"))
    with pytest.raises(AdmissionRejected) as ei:
        sched.submit(_req(tenant="free"))
    e = ei.value
    assert e.reason == "rate_limited" and e.retryable
    assert e.tenant == "free" and e.retry_after_s == pytest.approx(2.0)
    assert isinstance(e, ValueError)
    assert "retry after 2s" in str(e) and "retryable" in str(e)


def test_rate_limit_charged_before_queue_bound():
    sched = TokenBudgetFCFS(
        token_budget=8, prefill_chunk=4, max_queue=1,
        tenants={"free": TenantPolicy(rate=0.001, burst=1)})
    sched.submit(_req(tenant="free"))  # fills the queue
    with pytest.raises(AdmissionRejected) as ei:
        sched.submit(_req(tenant="free"))
    assert ei.value.reason == "rate_limited"
    with pytest.raises(AdmissionRejected) as ei:
        sched.submit(_req(tenant="other"))
    assert ei.value.reason == "queue_full" and ei.value.retryable
    assert ei.value.pending == 1 and ei.value.limit == 1


def test_over_capacity_is_not_retryable():
    e = AdmissionRejected("over_capacity", retryable=False, needed_pages=9,
                          available_pages=4)
    assert not e.retryable
    assert "needs 9 pages, 4 available" in str(e)


def test_priority_orders_queue_fcfs_within_class():
    sched = TokenBudgetFCFS(token_budget=8, prefill_chunk=4)
    lo1 = _req(arrival=0.0, priority=2)
    hi = _req(arrival=0.2, priority=0)
    lo2 = _req(arrival=0.1, priority=2)
    for r in (lo1, hi, lo2):
        sched.submit(r)
    sched.admit_arrivals(0.5)
    assert [r.rid for r in sched.queue] == [hi.rid, lo1.rid, lo2.rid]


def test_all_class_zero_keeps_plain_fcfs_deque():
    sched = TokenBudgetFCFS(token_budget=8, prefill_chunk=4)
    reqs = [_req(arrival=0.1 * i) for i in range(5)]
    for r in reversed(reqs):
        sched.submit(r)
    sched.admit_arrivals(10.0)
    assert [r.rid for r in sched.queue] == [r.rid for r in reqs]


def test_aging_promotes_low_class_to_head():
    sched = TokenBudgetFCFS(token_budget=8, prefill_chunk=4, aging_s=1.0)
    old_lo = _req(arrival=0.0, priority=2)
    fresh_hi = _req(arrival=2.5, priority=0)
    sched.submit(old_lo)
    sched.submit(fresh_hi)
    sched.admit_arrivals(2.6)
    assert sched.effective_priority(old_lo, 2.6) == 0
    assert sched.effective_priority(old_lo, 1.5) == 1
    assert [r.rid for r in sched.queue] == [old_lo.rid, fresh_hi.rid]


def test_shed_priority_is_lowest_configured_class_never_zero():
    assert TokenBudgetFCFS(token_budget=8, prefill_chunk=4
                           ).shed_priority() == 1
    sched = TokenBudgetFCFS(
        token_budget=8, prefill_chunk=4,
        tenants={"paid": TenantPolicy(priority=0),
                 "batch": TenantPolicy(priority=3)})
    assert sched.shed_priority() == 3


def test_tenant_policy_resolves_default_priority():
    sched = TokenBudgetFCFS(token_budget=8, prefill_chunk=4,
                            tenants={"free": TenantPolicy(priority=2)})
    r = _req(tenant="free")
    sched.submit(r)
    assert r.priority == 2  # inherited from the policy
    pinned = _req(tenant="free", priority=0)
    sched.submit(pinned)
    assert pinned.priority == 0  # an explicit pin wins
    with pytest.raises(ValueError):
        sched.submit(_req(priority=-1))
    assert sched.policy("nobody") == TenantPolicy()


@pytest.mark.parametrize("kw", [dict(rate=0.0), dict(rate=-1.0),
                                dict(burst=0), dict(priority=-1)])
def test_tenant_policy_validation(kw):
    with pytest.raises(ValueError):
        TenantPolicy(**kw)


@pytest.mark.parametrize("kw", [dict(token_budget=0), dict(max_queue=0),
                                dict(aging_s=0.0)])
def test_scheduler_validation(kw):
    args = dict(token_budget=8, prefill_chunk=4)
    args.update(kw)
    with pytest.raises(ValueError):
        TokenBudgetFCFS(**args)


@pytest.mark.parametrize("spec", [
    "paid:inf:4:0,free:2.0:4:1,batch:0.5:2:2", "solo", "a:,b::3",
    " x:1.5 , y:inf:2 ",
])
def test_parse_tenants_matches_reference(spec):
    from repro.serve.frontdoor.admission import parse_tenants as ref_parse

    got, want = parse_tenants(spec), ref_parse(spec)
    assert list(got) == list(want)
    for name in want:
        assert (got[name].rate, got[name].burst, got[name].priority) == (
            want[name].rate, want[name].burst, want[name].priority)


@pytest.mark.parametrize("spec", ["", ",", ":1:2", "a:1:2:3:4", "a,a",
                                  "a:0", "a:x", "a:1:0", "a:1:2:-1"])
def test_parse_tenants_refuses_bad_specs(spec):
    with pytest.raises(ValueError):
        parse_tenants(spec)


def test_stop_token_done_and_terminal_states():
    r = _req(max_new=5)
    r.stop_tokens = (7,)
    r.emit(3, 0.0)
    assert not r.done
    r.emit(7, 0.1)
    assert r.done
    assert {s.value for s in RequestState if s.terminal} == {
        "finished", "cancelled", "failed"}


# ---- seeded op sequences against the reference ----------------------------

TENANTS = {"free": (0.8, 2, 1), "paid": (None, 4, 0), "batch": (0.3, 1, 2)}


def _sched(mod, max_queue):
    pols = {n: mod.TenantPolicy(rate=r, burst=b, priority=p)
            for n, (r, b, p) in TENANTS.items()}
    return mod.TokenBudgetFCFS(token_budget=12, prefill_chunk=4,
                               max_queue=max_queue, tenants=pols,
                               aging_s=0.75)


@pytest.mark.parametrize("hits", [False, True])
@pytest.mark.parametrize("seed", range(4))
def test_seeded_op_sequences_plan_as_reference(seed, hits):
    """Submits from several tenants and classes, arrivals, plans, finishes
    and evictions (requeue) in a seeded order: every plan, queue order,
    prefix hit and rejection equals the reference scheduler's."""
    rng = np.random.default_rng(seed)
    impls = [dict(mod=mod, sched=_sched(mod, max_queue=9),
                  pool=FakePool(3, hits), running=[], reqs=[])
             for mod in (ref_sched, port_sched)]
    t = 0.0
    for _ in range(160):
        op = int(rng.integers(0, 5))
        t += float(rng.choice([0.0, 0.1, 0.35]))
        if op == 0:
            tenant = str(rng.choice(["free", "paid", "batch", "default"]))
            pri = [None, 0, 1, 2][int(rng.integers(4))]
            n_prompt = int(rng.integers(1, 14))
            first = int(rng.integers(0, 9))
            arrival = t + float(rng.choice([0.0, 0.2]))
            outs = []
            for im in impls:
                r = _req(arrival=arrival, priority=pri, tenant=tenant,
                         n_prompt=n_prompt, cls=im["mod"].Request,
                         first=first)
                try:
                    im["sched"].submit(r)
                    im["reqs"].append(r)
                    outs.append("ok")
                except ValueError as e:
                    outs.append((e.reason, e.retryable,
                                 getattr(e, "retry_after_s", None)))
            assert outs[0] == outs[1]
        elif op == 1:
            plans = []
            for im in impls:
                im["sched"].admit_arrivals(t)
                p = im["sched"].plan(im["running"], im["pool"], now=t)
                idx = {id(r): i for i, r in enumerate(im["reqs"])}
                plans.append((
                    [idx[id(r)] for r in p.decode],
                    [(idx[id(r)], n) for r, n in p.prefill],
                    p.prefix_hit_tokens,
                    [idx[id(r)] for r in im["sched"].queue],
                    [(idx[id(r)], r.slot, r.prefill_pos, r.t_admitted)
                     for r in im["running"]],
                ))
                for r, n in p.prefill:  # the engine's chunk epilogue
                    r.prefill_pos += n
                    if r.prefill_pos == len(r.prefix):
                        r.state = im["mod"].RequestState.DECODE
            assert plans[0] == plans[1]
        elif op in (2, 3) and impls[0]["running"]:
            k = int(rng.integers(len(impls[0]["running"])))
            for im in impls:
                r = im["running"].pop(k)
                im["pool"].release(r.slot)
                if op == 2:
                    r.state = im["mod"].RequestState.FINISHED
                else:
                    im["sched"].requeue(r)
        else:
            for im in impls:
                im["sched"].admit_arrivals(t)
            orders = [[i for i, r in enumerate(im["reqs"])
                       if any(r is q for q in im["sched"].queue)]
                      for im in impls]
            assert orders[0] == orders[1]
        assert impls[0]["sched"].pending == impls[1]["sched"].pending
