"""Port parity: speculative decode (n-gram drafts, the chunked-prefill
kernel's plain version as verifier, rollback, the accept debt).

The port's speculative engine and the JAX package's take the same
decisions on one tick-counted schedule: equal streams, ticks, finish
states and counters (``spec_ticks``, ``spec_lanes``, ``draft_tokens``,
``accepted_tokens``, ``rolled_back_tokens``, evictions), logits within
``RTOL``/``ATOL``, every page returned.  The prompts are cyclic spans
broken at seeded positions, so drafts are both accepted and rolled back,
and every engine case asserts both.  The port's speculative streams also
equal its own one-token streams (greedy, int8, host-sampled and
device-sampled).  ``NgramDrafter.propose``, ``_accept``, the int8 round
trip and the scheduler's accept debt equal the reference's exactly.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_streams_agree, drive_ticks, fp_decoders

from repro.serve import CachedDecoder as RefDecoder
from repro.serve import Engine as RefEngine
from repro.serve import EngineConfig as RefEngineConfig
from repro.serve import adapter as ref_adapter_mod
from repro.serve.drafter import NgramDrafter as RefDrafter
from repro.serve.drafter import make_drafter as ref_make_drafter
from repro.serve.scheduler import Request as RefRequest
from repro.serve.scheduler import RequestState as RefState
from repro.serve.scheduler import SamplingParams as RefSamplingParams
from repro.serve.scheduler import TokenBudgetFCFS as RefScheduler
from repro_torch.launch import serve as port_serve
from repro_torch.serve import adapter as adapter_mod
from repro_torch.serve.drafter import NgramDrafter, make_drafter
from repro_torch.serve.engine import Engine, EngineConfig
from repro_torch.serve.scheduler import Request, RequestState, SamplingParams
from repro_torch.serve.scheduler import TokenBudgetFCFS

RTOL = ATOL = 2e-3  # engine logits, as the other engine-parity tests
# two float32 softmax + cumsum over the smoke vocabulary (256), summed in
# other orders: each partial sum is off by at most 255·2⁻²⁴ of the mass
EDGE_FLOOR = 2 * 256 * 2.0**-24
SPEC_COUNTERS = ("spec_ticks", "spec_lanes", "draft_tokens",
                 "accepted_tokens", "rolled_back_tokens", "decode_tokens",
                 "prefill_tokens", "evictions", "cancelled", "steps")


def _spec_prompts(n=4, reps=8):
    """Cyclic 4-token spans broken at four seeded positions per prompt:
    the drafter proposes the cycle, which the model follows only in part."""
    out = []
    for i in range(n):
        p = np.tile(np.asarray([7, 91, 33, 150], np.int32), reps)
        rng = np.random.default_rng(i)
        p[rng.choice(p.size, 4, replace=False)] = rng.integers(0, 256, 4)
        out.append(p)
    return out


@pytest.fixture(scope="module")
def decoders():
    return fp_decoders(seed=0)


@pytest.fixture(scope="module")
def prompts():
    return _spec_prompts()


def _knobs(**kw):
    knobs = dict(max_seq_len=48, n_slots=4, page_size=4, token_budget=32,
                 prefill_chunk=8, record_logits=True, paged_decode=True,
                 speculative_k=4, device_sample=True)
    knobs.update(kw)
    return knobs


def _run(adapter, eng_cls, cfg_cls, schedule, *, events=None, **kw):
    eng = eng_cls(adapter, cfg_cls(**_knobs(**kw)))
    run = drive_ticks(eng, schedule, events=events)
    assert eng.pool.pages_in_use - eng.pool.cached_pages == 0
    assert not eng.pool._slots and eng.idle
    return eng, run


def _both(decoders, schedule, *, events=None, **kw):
    """The schedule through the reference engine and the port's; holds
    every decision, stream, counter and logit of the port to the
    reference's.  Returns (port engine, port run, reference engine)."""
    ref_adapter, port_adapter = decoders
    ref_eng, ref = _run(ref_adapter, RefEngine, RefEngineConfig, schedule,
                        events=events, **kw)
    eng, got = _run(port_adapter, Engine, EngineConfig, schedule,
                    events=events, **kw)
    assert got.ticks == ref.ticks
    assert got.admitted == ref.admitted
    for i in ref.reqs:
        assert got.outcome(i) == ref.outcome(i)
        if ref.reqs[i].step_logits:
            np.testing.assert_allclose(np.stack(got.reqs[i].step_logits),
                                       np.stack(ref.reqs[i].step_logits),
                                       rtol=RTOL, atol=ATOL)
    rs, ps = ref_eng.summary(), eng.summary()
    for key in SPEC_COUNTERS:
        assert ps[key] == rs[key], key
    for key in ("acceptance_rate", "accepted_per_tick",
                "tokens_per_lane_tick"):
        assert ps[key] == pytest.approx(rs[key]), key
    return eng, got, ref_eng


def _drafted(eng):
    s = eng.summary()
    assert s["spec_ticks"] > 0
    assert s["accepted_tokens"] > 0  # drafts really land
    assert s["rolled_back_tokens"] > 0  # and some really get rolled back


def _streams(run):
    return {i: list(r.out_tokens) for i, r in run.reqs.items()}


def _sched(prompts, gen=12, arrive=(0, 0, 1, 3), **kw):
    return [(t, dict(prompt=p, max_new=gen, **kw))
            for t, p in zip(arrive, prompts)]


# ---- host-side pieces ------------------------------------------------------


@pytest.mark.parametrize("seed", range(12))
def test_ngram_propose_matches_reference(seed):
    rng = np.random.default_rng(seed)
    for _ in range(20):
        hist = rng.integers(0, int(rng.integers(2, 9)),
                            size=int(rng.integers(1, 40)))
        k, n = int(rng.integers(1, 7)), int(rng.integers(1, 5))
        cap = int(rng.integers(0, k + 2))
        got = NgramDrafter(k, max_ngram=n).propose(hist, cap)
        want = RefDrafter(k, max_ngram=n).propose(hist, cap)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)


def test_drafter_unit_cases():
    d = NgramDrafter(4, max_ngram=3)
    np.testing.assert_array_equal(d.propose(np.tile([5, 9], 6)), [5, 9, 5, 9])
    np.testing.assert_array_equal(d.propose([1, 2, 3, 7, 7, 7]), [7] * 4)
    assert d.propose(np.arange(10)).size == 0
    assert d.propose(np.asarray([1, 2])).size == 0
    for bad in (lambda: NgramDrafter(0), lambda: NgramDrafter(2, 0),
                lambda: make_drafter("oracle", 4)):
        with pytest.raises(ValueError):
            bad()
    for bad in (lambda: RefDrafter(0), lambda: ref_make_drafter("oracle", 4)):
        with pytest.raises(ValueError):
            bad()
    assert make_drafter("ngram", 2).k == 2


@pytest.mark.parametrize("seed", range(4))
def test_accept_matches_reference(seed):
    rng = np.random.default_rng(seed)
    B, K = 16, int(rng.integers(1, 6))
    drafts = rng.integers(0, 3, (B, K)).astype(np.int32)
    sel = rng.integers(0, 3, (B, K + 1)).astype(np.int32)
    sel[:4, :K] = drafts[:4]  # some lanes accept everything they drafted
    n_drafts = rng.integers(0, K + 1, B).astype(np.int32)
    want = np.asarray(RefDecoder._accept(jnp.asarray(sel),
                                         jnp.asarray(drafts),
                                         jnp.asarray(n_drafts)))
    got = adapter_mod._accept(*(torch.as_tensor(a) for a in (
        sel, drafts, n_drafts)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_roundtrip_matches_reference(dtype):
    x = np.random.default_rng(3).standard_normal((2, 3, 5, 2, 16)) * 4
    x[0, 0, 0, 0] = 0.0  # an all-zero head: the scale's floor
    ref = ref_adapter_mod._int8_roundtrip(jnp.asarray(x, dtype))
    got = adapter_mod._int8_roundtrip(torch.as_tensor(x).to(
        getattr(torch, dtype)))
    assert str(got.dtype) == f"torch.{dtype}"
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(ref.astype(jnp.float32)))


def _budget_case(sched_cls, req_cls, state_cls):
    class FakePool:
        def admit(self, n, tokens=None):
            return None

        def length(self, slot):
            return 0

    sched = sched_cls(token_budget=8, prefill_chunk=4)
    running = []
    for _ in range(2):
        r = req_cls(prompt=np.arange(4, dtype=np.int32), max_new=4)
        r.state = state_cls.PREFILL
        running.append(r)
    out = []
    for charge in (0, 5, 0, 9, 2, 0):
        if charge:
            sched.charge_accepted(charge)
        out.append([n for _, n in sched.plan(running, FakePool()).prefill])
    with pytest.raises(ValueError):
        sched.charge_accepted(-1)
    return out


def test_charge_accepted_plans_like_reference():
    got = _budget_case(TokenBudgetFCFS, Request, RequestState)
    assert got == _budget_case(RefScheduler, RefRequest, RefState)
    assert got[:3] == [[4, 4], [3], [4, 4]]


# ---- engines ---------------------------------------------------------------


@pytest.mark.parametrize("paged_prefill", [False, True])
def test_speculative_engine_matches_reference(decoders, prompts,
                                              paged_prefill):
    eng, got, _ = _both(decoders, _sched(prompts),
                        paged_prefill=paged_prefill)
    _drafted(eng)
    # the port's K = 4 streams equal its one-token streams
    _, one = _run(decoders[1], Engine, EngineConfig, _sched(prompts),
                  paged_prefill=paged_prefill, speculative_k=0)
    assert _streams(got) == _streams(one)
    for i in one.reqs:
        np.testing.assert_allclose(np.stack(got.reqs[i].step_logits),
                                   np.stack(one.reqs[i].step_logits),
                                   rtol=RTOL, atol=ATOL)


def test_speculative_int8_matches_reference_and_sequential(decoders,
                                                           prompts):
    eng, got, _ = _both(decoders, _sched(prompts), kv_int8=True)
    _drafted(eng)
    _, one = _run(decoders[1], Engine, EngineConfig, _sched(prompts),
                  kv_int8=True, speculative_k=0)
    assert _streams(got) == _streams(one)


def test_speculative_eviction_under_page_pressure(decoders, prompts):
    """Drafts never evict anyone; eviction and replay keep the streams."""
    eng, got, _ = _both(decoders, _sched(prompts, gen=16), n_slots=3,
                        n_pages=20)
    assert eng.stats["evictions"] > 0
    _drafted(eng)
    _, calm = _run(decoders[1], Engine, EngineConfig,
                   _sched(prompts, gen=16), n_slots=3, speculative_k=0)
    assert _streams(got) == _streams(calm)


def test_speculative_prefix_cache_cow(decoders, prompts):
    """Shared prompt pages are mapped; speculative writes into a shared
    tail copy it first, and rollback unmaps only the lane's view."""
    shared = [prompts[0], prompts[0], prompts[1], prompts[0]]
    eng, got, _ = _both(decoders, _sched(shared, arrive=(0, 2, 2, 5)),
                        paged_prefill=True, prefix_cache=True)
    s = eng.summary()
    assert s["prefix_hit_tokens"] > 0 and s["cached_pages"] > 0
    _drafted(eng)
    _, plain = _run(decoders[1], Engine, EngineConfig,
                    _sched(shared, arrive=(0, 2, 2, 5)), speculative_k=0)
    assert _streams(got) == _streams(plain)


def test_speculative_stop_token_mid_acceptance(decoders, prompts):
    _, one = _run(decoders[1], Engine, EngineConfig, _sched(prompts),
                  speculative_k=0)
    stream = one.reqs[1].out_tokens
    stop = stream[5]
    eng, got, _ = _both(decoders, _sched(prompts, stop_tokens=(stop,)))
    r = got.reqs[1]
    assert r.finish_reason == "stop"
    assert r.out_tokens == stream[: stream.index(stop) + 1]
    assert eng.summary()["accepted_tokens"] > 0


def test_speculative_cancel_between_verify_ticks(decoders, prompts):
    seen = []

    def cancel(engine, run):
        r = run.reqs[0]
        seen.append(r.state.value)
        assert engine.cancel(r.rid)

    eng, got, _ = _both(decoders, _sched(prompts), events={4: cancel})
    assert seen == ["decode", "decode"]  # one per package
    assert got.outcome(0)[:2] == ("cancelled", "cancelled")
    assert eng.stats["cancelled"] == 1 and eng.stats["spec_ticks"] > 0


def test_speculative_host_sample_path(decoders, prompts):
    """Host selection: the verify dispatch's logits are re-selected and
    accepted on the host: the same greedy stream."""
    eng, got, _ = _both(decoders, _sched(prompts), device_sample=False)
    _drafted(eng)
    _, one = _run(decoders[1], Engine, EngineConfig, _sched(prompts),
                  speculative_k=0, device_sample=False)
    assert _streams(got) == _streams(one)


def test_set_speculative_k_matches_reference(decoders, prompts):
    """The ladder hook: K shrinks to 0 mid-run (one-token ticks) and comes
    back, clamped at the configured depth."""
    def shrink(engine, run):
        assert engine.set_speculative_k(0) == 0

    def restore(engine, run):
        assert engine.set_speculative_k(9) == 4

    eng, got, _ = _both(decoders, _sched(prompts),
                        events={3: shrink, 6: restore})
    _drafted(eng)
    with pytest.raises(ValueError):
        eng.set_speculative_k(-1)


def test_sampled_speculative_grouping(decoders, prompts):
    """Device-sampled streams are keyed by emission index: a verify tick
    draws what one-token decode draws, in the port and against the JAX
    speculative engine (at T = 0.2, where this model's drafts land)."""
    def sched(sp_cls):
        return [(t, dict(prompt=p, max_new=12,
                         sampling=sp_cls(temperature=0.2, top_p=0.8,
                                         seed=i)))
                for i, (t, p) in enumerate(zip((0, 0, 1, 3), prompts))]

    ref_eng, ref = _run(decoders[0], RefEngine, RefEngineConfig,
                        sched(RefSamplingParams))
    eng, got = _run(decoders[1], Engine, EngineConfig, sched(SamplingParams))
    _, one = _run(decoders[1], Engine, EngineConfig, sched(SamplingParams),
                  speculative_k=0)
    assert eng.summary()["accepted_tokens"] > 0
    assert len(assert_streams_agree(got, ref, floor=EDGE_FLOOR)) <= 1
    assert not assert_streams_agree(got, one, floor=EDGE_FLOOR)


def test_engine_rejects_speculative_without_paged(decoders):
    port = decoders[1]
    for kw in (dict(speculative_k=2), dict(device_sample=True),
               dict(speculative_k=-1, paged_decode=True)):
        with pytest.raises(ValueError):
            Engine(port, EngineConfig(max_seq_len=16, **kw))


@pytest.mark.parametrize("flags", [[], ["--kv-int8", "--arrival-gap", "0"],
                                   ["--host-sample"]])
def test_cli_speculative_check(flags, capsys):
    rc = port_serve.main(["--device", "cpu", "--smoke", "--paged",
                          "--paged-prefill", "--speculative", "4",
                          "--requests", "4", "--gen", "8", "--check",
                          *flags])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "token agreement 100.00%" in out
    assert "speculative K=4: acceptance_rate=" in out
