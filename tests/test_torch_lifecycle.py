"""Port parity: the request lifecycle in the engine and the serve CLI.

Stop tokens, ``cancel`` from every live state, deadlines, the bounded
queue, tenant rate limits and priority classes (admission order and the
eviction victim) take the reference engine's decisions on the same
tick-counted schedule: equal finish states, ``finish_reason``s,
``out_tokens``, rejections and admission order, logits within
``RTOL``/``ATOL``, and every page returned.  The CLI passes ``--check``
with ``--prefix-cache --kv-int8`` on a converted reference artifact and
refuses what the reference refuses."""
from __future__ import annotations

import numpy as np
import pytest
from torch_parity import drive_ticks, fp_decoders, quantized_tree_numpy

from repro.data import make_calibration as ref_calibration
from repro.serve import Engine as RefEngine
from repro.serve import EngineConfig as RefEngineConfig
from repro.serve.scheduler import TenantPolicy as RefTenantPolicy
from repro_torch import convert
from repro_torch.launch import serve as port_serve
from repro_torch.serve.engine import Engine, EngineConfig
from repro_torch.serve.scheduler import TenantPolicy

RTOL = ATOL = 2e-3
PAID, FREE = (None, 4, 0), (0.5, 2, 1)  # (rate, burst, priority)


@pytest.fixture(scope="module")
def decoders():
    return fp_decoders(seed=2)


@pytest.fixture(scope="module")
def prompts():
    return np.asarray(ref_calibration(256, n_segments=10, seg_len=12,
                                      seed=11).tokens, np.int32)


def _knobs(policy_cls, path="paged", **kw):
    knobs = dict(max_seq_len=24, n_slots=3, page_size=4, n_pages=12,
                 token_budget=16, prefill_chunk=8, record_logits=True,
                 paged_decode=path == "paged",
                 paged_prefill=path == "paged")
    if kw.pop("tenants", False):
        knobs["tenants"] = {"paid": policy_cls(*PAID),
                            "free": policy_cls(*FREE)}
    knobs.update(kw)
    return knobs


def _both(decoders, schedule, *, events=None, path="paged", **kw):
    """The same schedule through the reference engine and the port's:
    returns (port engine, port run, reference run) after holding every
    decision and stream of the port to the reference's."""
    ref_adapter, port_adapter = decoders
    runs = []
    for eng_cls, cfg_cls, pol in ((RefEngine, RefEngineConfig,
                                   RefTenantPolicy),
                                  (Engine, EngineConfig, TenantPolicy)):
        adapter = ref_adapter if eng_cls is RefEngine else port_adapter
        eng = eng_cls(adapter, cfg_cls(**_knobs(pol, path, **kw)))
        runs.append((eng, drive_ticks(eng, schedule, events=events)))
    (ref_eng, ref), (eng, got) = runs
    assert got.rejected == ref.rejected
    assert got.admitted == ref.admitted
    assert got.ticks == ref.ticks
    assert sorted(got.reqs) == sorted(ref.reqs)
    for i in ref.reqs:
        assert got.outcome(i) == ref.outcome(i)
        assert got.reqs[i].n_evictions == ref.reqs[i].n_evictions
        if ref.reqs[i].step_logits:
            np.testing.assert_allclose(np.stack(got.reqs[i].step_logits),
                                       np.stack(ref.reqs[i].step_logits),
                                       rtol=RTOL, atol=ATOL)
    for key in ("evictions", "cancelled", "failed", "deadline_missed",
                "admission_rejected", "prefill_tokens", "decode_tokens"):
        assert eng.stats[key] == ref_eng.stats[key], key
    assert eng.pool.pages_in_use == 0 and not eng.pool._slots
    assert eng.idle and not eng.live_requests()
    return eng, got, ref


def _unstopped(decoders, prompts, i, gen):
    _, port_adapter = decoders
    eng = Engine(port_adapter, EngineConfig(**_knobs(TenantPolicy)))
    run = drive_ticks(eng, [(0, dict(prompt=prompts[i], max_new=gen))])
    return run.reqs[0].out_tokens


@pytest.mark.parametrize("path", ["paged", "dense"])
def test_lifecycle_schedule_matches_reference_engine(decoders, prompts,
                                                     path):
    """One schedule under a pool tight enough to evict, with a stop token,
    cancels while waiting, queued, in prefill and in decode, a request
    with ``deadline_s=0``, ``max_queue`` rejections, and two tenants at
    classes 0 and 1, one of them rate-limited."""
    stop = _unstopped(decoders, prompts, 0, 10)[2]
    P = prompts
    schedule = [
        (0, dict(prompt=P[0], max_new=10, tenant="paid",
                 stop_tokens=(stop,))),
        (0, dict(prompt=P[1], max_new=10, tenant="free")),
        (0, dict(prompt=P[2], max_new=10, tenant="free")),
        (0, dict(prompt=P[3], max_new=10, tenant="free")),  # rate limited
        (0, dict(prompt=P[4], max_new=6, tenant="paid", arrival=40.0)),
        (1, dict(prompt=P[4], max_new=10, tenant="paid", deadline_s=0.0)),
        (2, dict(prompt=P[5], max_new=8, tenant="paid")),
        (3, dict(prompt=P[6], max_new=8, tenant="free")),
        (3, dict(prompt=P[7], max_new=8, tenant="paid")),
        (3, dict(prompt=P[8], max_new=8, tenant="paid")),
        (3, dict(prompt=P[9], max_new=8, tenant="paid")),  # queue full
        (3, dict(prompt=P[3], max_new=8, tenant="paid")),  # queue full
        (9, dict(prompt=P[9], max_new=6, tenant="free")),
    ]
    cancels = {2: 4, 3: 2, 4: 9, 6: 1}  # tick -> schedule index
    seen = {}

    def cancel(tick):
        def fn(engine, run):
            r = run.reqs[cancels[tick]]
            seen[cancels[tick]] = r.state.value
            assert engine.cancel(r.rid)
            assert not engine.cancel(r.rid)  # terminal: left alone
        return fn

    eng, got, _ = _both(decoders, schedule, tenants=True, max_queue=4,
                        path=path,
                        events={t: cancel(t) for t in cancels})
    # 4 is still waiting for its arrival (a waiting request is QUEUED)
    assert seen == {4: "queued", 2: "prefill", 9: "queued", 1: "decode"}
    # each cancel is reported by the tick that follows it
    for tick, i in cancels.items():
        assert i in got.ticks[tick][1]
    assert got.rejected == {3: "rate_limited", 10: "queue_full",
                            11: "queue_full"}
    out = {i: got.outcome(i) for i in got.reqs}
    assert out[0][:2] == ("finished", "stop") and out[0][2][-1] == stop
    assert out[5][:2] == ("failed", "deadline")
    for i in cancels.values():
        assert out[i][:2] == ("cancelled", "cancelled")
    s = eng.summary()
    assert s["evictions"] > 0 and s["cancelled"] == 4
    assert s["deadline_missed"] == 1 and s["admission_rejected"] == 3
    # waiting (arrival 40) was cancelled before it ever arrived
    assert got.reqs[4].t_admitted is None


@pytest.mark.parametrize("at", [1, 2, 3, 5])
def test_stop_token_matches_reference(decoders, prompts, at):
    stream = _unstopped(decoders, prompts, 1, 8)
    stop = stream[at]
    schedule = [(0, dict(prompt=prompts[i], max_new=8,
                         stop_tokens=(stop,) if i == 1 else ()))
                for i in range(3)]
    _, got, _ = _both(decoders, schedule)
    state, reason, toks = got.outcome(1)
    assert (state, reason) == ("finished", "stop")
    assert toks == stream[: stream.index(stop) + 1]


@pytest.mark.parametrize("state,tick,arrival", [
    ("queued", 0, None), ("waiting", 1, 30.0), ("prefill", 1, None),
    ("decode", 4, None)])
def test_cancel_from_each_live_state(decoders, prompts, state, tick,
                                     arrival):
    """``cancel`` between ticks from each live state: CANCELLED, reported
    by the next tick's result, pages back, the others unharmed."""
    long = np.concatenate([prompts[3], prompts[4]])  # three prefill chunks
    # three slots: the fourth request waits in the queue; the target is
    # the fourth, or the first for the states of a running request
    target = 0 if state in ("prefill", "decode") else 3
    schedule = [(0, dict(prompt=prompts[i], max_new=6)) for i in range(4)]
    if state == "prefill":
        schedule[0] = (0, dict(prompt=long, max_new=6))
    if arrival is not None:
        schedule[3] = (0, dict(prompt=prompts[3], max_new=6,
                               arrival=arrival))
    seen = []

    def fn(engine, run):
        r = run.reqs[target]
        seen.append(r.state.value)
        assert engine.cancel(r.rid)

    _, got, _ = _both(decoders, schedule, max_seq_len=32, n_pages=25,
                      events={tick: fn})
    # a request waiting for its arrival is QUEUED too
    assert seen == [{"waiting": "queued"}.get(state, state)] * 2
    assert got.outcome(target)[:2] == ("cancelled", "cancelled")
    assert target in got.ticks[tick][1]
    for i in set(range(4)) - {target}:
        assert got.outcome(i)[:2] == ("finished", "length")


def test_default_deadline_fails_slow_requests(decoders, prompts):
    """``EngineConfig.deadline_s``: requests still live past it fail with
    reason "deadline" at a tick boundary; a per-request ``deadline_s``
    overrides it."""
    schedule = [(0, dict(prompt=prompts[i], max_new=8)) for i in range(5)]
    schedule.append((0, dict(prompt=prompts[5], max_new=8,
                             deadline_s=100.0)))
    eng, got, _ = _both(decoders, schedule, deadline_s=6.0)
    reasons = [got.outcome(i)[1] for i in range(6)]
    assert "deadline" in reasons and reasons[5] == "length"
    assert eng.stats["deadline_missed"] == reasons.count("deadline")


def test_eviction_victim_is_lowest_class(decoders, prompts):
    """Under page pressure the victim is the worst class, newest first:
    the paid (class 0) request is never evicted."""
    schedule = [(0, dict(prompt=prompts[i], max_new=10,
                         tenant="paid" if i == 2 else "free"))
                for i in range(3)]
    eng, got, _ = _both(decoders, schedule, tenants=True, n_pages=10)
    assert eng.stats["evictions"] > 0
    assert got.reqs[2].n_evictions == 0
    assert sum(got.reqs[i].n_evictions for i in (0, 1)) > 0


def test_over_capacity_rejection_is_counted(decoders, prompts):
    _, port_adapter = decoders
    eng = Engine(port_adapter, EngineConfig(**_knobs(TenantPolicy)))
    with pytest.raises(ValueError) as ei:
        eng.submit(np.arange(20, dtype=np.int32), max_new=8)  # 28 > 24
    assert ei.value.reason == "over_capacity" and not ei.value.retryable
    assert eng.stats["admission_rejected"] == 1


def test_cancel_all_drains_every_live_request(decoders, prompts):
    _, port_adapter = decoders
    eng = Engine(port_adapter, EngineConfig(**_knobs(TenantPolicy)))
    reqs = [eng.submit(prompts[i], max_new=6, arrival=float(i > 3) * 9)
            for i in range(6)]
    for _ in range(3):
        eng.tick()
    assert len(eng.live_requests()) == 6
    gone = eng.cancel_all()
    assert {r.rid for r in gone} == {r.rid for r in reqs}
    assert all(r.state.value == "cancelled" for r in reqs)
    assert eng.stats["cancelled"] == 6 and eng.idle
    assert eng.pool.pages_in_use == 0 and not eng.pool._slots
    assert len(eng.tick().finished) == 6  # reported by the next tick


# ---- the CLI ----------------------------------------------------------------


@pytest.fixture(scope="module")
def port_artifact(tmp_path_factory):
    """The reference smoke model quantized to 2 bits by the JAX package
    and converted to a port artifact (once for this file)."""
    import jax

    from repro.configs import get_smoke_config
    from repro.core.quantizer import QuipConfig
    from repro.launch.quantize import quantize_dense_model
    from repro.models import build_model
    from repro.serve.artifacts import load_quantized as ref_load
    from repro.serve.artifacts import save_quantized as ref_save

    cfg = get_smoke_config("qwen3-14b")
    params = build_model(cfg).init(jax.random.PRNGKey(0))
    calib = ref_calibration(cfg.vocab, n_segments=4, seg_len=32, seed=7)
    qcfg = QuipConfig(bits=2, method="ldlq", use_kernel=False)
    qm = quantize_dense_model(params, cfg, qcfg, calib.tokens, seed=0,
                              verbose=False)
    tmp = tmp_path_factory.mktemp("art")
    ref_save(tmp / "ref_art", qm, qcfg)
    loaded, meta = ref_load(tmp / "ref_art")
    convert.write_port_artifact(tmp / "port_art", meta["arch_config"],
                                quantized_tree_numpy(loaded),
                                meta["quip_config"])
    return str(tmp / "port_art")


# int8 pages make a stream depend on where prefill chunks split a prompt
# (tokens of an earlier chunk are read back quantized, those of the same
# chunk in fp), so the int8 oracle — a gather-dense engine with every
# request arriving at once — agrees exactly only when the engine under
# test plans the same chunks: ``--arrival-gap 0``.  The JAX CLI is the
# same (both packages' engines change tokens with the schedule alike).
@pytest.mark.parametrize("flags", [
    ["--prefix-cache", "--kv-int8", "--arrival-gap", "0"],
    ["--prefix-cache", "--kv-int8", "--arrival-gap", "0", "--slots", "4",
     "--page-size", "4", "--pages", "16", "--prompt-len", "16", "--gen",
     "16"],
    ["--prefix-cache"],
])
def test_cli_check_with_prefix_cache_and_int8(port_artifact, flags,
                                              capsys):
    rc = port_serve.main(["--device", "cpu", "--load-quantized",
                          port_artifact, "--paged", "--paged-prefill",
                          "--check", "--requests", "4", *flags])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "token agreement 100.00%" in out
    assert "outcomes: finished=4 cancelled=0 failed=0" in out
    assert "cached_pages=" in out and "cow_copies=" in out
    if "--kv-int8" in flags:
        assert "check vs gather-dense int8 engine" in out


@pytest.mark.parametrize("argv,match", [
    (["--check", "--stop-token", "3"], "drop --stop-token"),
    (["--check", "--kv-int8"], "--kv-int8 --check needs --paged"),
    (["--tenants", "a:1:2:3:4"], "--tenants"),
    (["--tenants", "a,a"], "--tenants"),
    (["--tenants", ":1"], "--tenants"),
    (["--tenants", "a:0"], "--tenants"),
])
def test_cli_refuses(argv, match):
    with pytest.raises(SystemExit, match=match):
        port_serve.main(["--device", "cpu", "--smoke", *argv])


def test_cli_outcomes_line_and_rejections(capsys):
    """Retryable rejections are reported and skipped; deadline failures
    land on the outcomes line; no page leaks."""
    rc = port_serve.main(["--device", "cpu", "--smoke", "--paged",
                          "--paged-prefill", "--requests", "5",
                          "--max-queue", "3", "--deadline-s", "0",
                          "--gen", "4", "--tenants", "default:inf:4:0"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert out.count("rejected (retryable)") == 2
    assert ("outcomes: finished=0 cancelled=0 failed=3 "
            "reasons={'deadline': 3}") in out


def test_cli_stop_token_finishes_early(capsys):
    rc = port_serve.main(["--device", "cpu", "--smoke", "--paged",
                          "--requests", "2", "--gen", "8"])
    assert rc == 0
    rc = port_serve.main(["--device", "cpu", "--smoke", "--paged",
                          "--requests", "2", "--gen", "8", "--prefix-cache",
                          *sum((["--stop-token", str(t)] for t in range(256)),
                               [])])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "outcomes: finished=2 cancelled=0 failed=0" in out
    assert "decode_tokens=0" in out  # every first token is a stop token
