"""Port parity: deterministic fault injection, the NaN/Inf lane screen
and artifact integrity (``repro_torch/serve/faults.py``), mirroring the
fault tests of ``tests/test_chaos.py``.

The invariant asserted after every injected fault: the targeted request
ends in its own state and reason, every other request emits the stream
of a fault-free run, and the pool's pages return.  Beside it, the port is
held to the JAX package on the same inputs: the plan grammar (specs and
errors, all twelve kinds), the plan's hooks and logs, and — driving both
engines one tick at a time on the same schedule
(``torch_parity.drive_ticks``) — the same outcomes, finish reasons,
``fault:<kind>`` counters and survivor streams on the dense, paged and
speculative paths and on packed 2-bit weights.  Survivor logits agree
within ``RTOL``/``ATOL`` (the engines' float32 arithmetic differs in
summation order; tokens are equal).  The CLI prints the JAX CLI's
outcomes line and refuses what it refuses.
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest
import torch
from torch_parity import drive_ticks, fp_decoders

from repro.data import make_calibration as ref_calibration
from repro.serve import Engine as RefEngine
from repro.serve import EngineConfig as RefEngineConfig
from repro.serve import faults as ref_faults
from repro_torch.checkpoint.store import (
    ArtifactCorruption,
    load_arrays,
    save_arrays,
)
from repro_torch.launch import serve as port_serve
from repro_torch.serve import faults
from repro_torch.serve.engine import Engine, EngineConfig
from repro_torch.serve.faults import (
    FAULT_KINDS,
    AdmissionRejected,
    FaultPlan,
    FaultRule,
    parse_fault_plan,
)
from repro_torch.serve.scheduler import RequestState
from repro_torch.serve.telemetry import validate_chrome_trace

RTOL = ATOL = 2e-3
GEN = 8

# engine paths the fault matrix sweeps; greedy selection keeps every path
# token-identical to the dense baseline
PATHS = {
    "dense": dict(),
    "paged": dict(paged_decode=True),
    "spec": dict(paged_decode=True, speculative_k=3),
}


@pytest.fixture(scope="module")
def decoders():
    return fp_decoders(seed=0)


@pytest.fixture(scope="module")
def prompts():
    return np.asarray(ref_calibration(256, n_segments=4, seg_len=10,
                                      seed=3).tokens, np.int32)


def _engine(adapter, *, faults=None, **kw):
    ecfg = dict(max_seq_len=24, n_slots=4, page_size=4, token_budget=32,
                prefill_chunk=8)
    ecfg.update(kw)
    return Engine(adapter, EngineConfig(**ecfg), faults=faults)


def _assert_pool_clean(engine):
    pool = engine.pool
    assert not pool._slots, "live slots after drain"
    assert pool.pages_in_use == pool.cached_pages, "leaked pages"
    free = set(pool._free_pages)
    for p in range(1, pool.n_pages):
        assert (p in free) == (pool._page_ref[p] == 0)


@pytest.fixture(scope="module")
def baseline(decoders, prompts):
    """Fault-free greedy tokens per prompt index, equal to the JAX
    engine's."""
    eng = _engine(decoders[1])
    reqs = [eng.submit(p, max_new=GEN) for p in prompts]
    eng.run()
    assert all(r.finish_reason == "length" for r in reqs)
    ref = RefEngine(decoders[0], RefEngineConfig(
        max_seq_len=24, n_slots=4, page_size=4, token_budget=32,
        prefill_chunk=8))
    rreqs = [ref.submit(p, max_new=GEN) for p in prompts]
    ref.run()
    assert [r.out_tokens for r in reqs] == [r.out_tokens for r in rreqs]
    return [list(r.out_tokens) for r in reqs]


# ---------------------------------------------------------------------------
# fault matrix: every injectable kind x every engine path
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("path", sorted(PATHS))
@pytest.mark.parametrize(
    "kind", ["alloc_fail", "nan_logits", "dispatch_error", "cancel"])
def test_fault_blast_radius_is_one_request(decoders, prompts, baseline,
                                           path, kind):
    target = 2
    plan = FaultPlan()
    eng = _engine(decoders[1], faults=plan,
                  screen_logits=(kind == "nan_logits"), **PATHS[path])
    reqs = [eng.submit(p, max_new=GEN) for p in prompts]
    plan.rules.append(FaultRule(kind=kind, rid=reqs[target].rid,
                                tick=6 if kind == "cancel" else None))
    eng.run()
    victim = reqs[target]
    if kind == "cancel":
        assert victim.state is RequestState.CANCELLED
        assert victim.finish_reason == "cancelled"
        assert eng.stats["cancelled"] == 1
    else:
        assert victim.state is RequestState.FAILED
        assert victim.finish_reason == kind
        assert eng.stats["failed"] == 1
    assert eng.stats["quarantined_lanes"] == (kind == "nan_logits")
    out = list(victim.out_tokens)
    assert out == baseline[target][: len(out)]
    for i, r in enumerate(reqs):
        if i != target:
            assert r.state is RequestState.FINISHED
            assert list(r.out_tokens) == baseline[i], f"survivor {i}"
    assert len(plan.log) == 1 and plan.log[0]["kind"] == kind
    assert eng.metrics.snapshot()[f"fault:{kind}"] == 1
    assert eng.summary()["faults_injected"] == 1
    _assert_pool_clean(eng)


def test_pool_exhausted_fault_is_transient(decoders, prompts, baseline):
    """An injected admit/extend denial is not fatal: the engine's evict /
    requeue machinery absorbs it and every request finishes exactly."""
    plan = FaultPlan(rules=[FaultRule(kind="pool_exhausted", times=2)])
    eng = _engine(decoders[1], faults=plan, paged_decode=True)
    reqs = [eng.submit(p, max_new=GEN) for p in prompts]
    eng.run()
    assert len(plan.log) == 2
    for i, r in enumerate(reqs):
        assert r.state is RequestState.FINISHED
        assert list(r.out_tokens) == baseline[i]
    _assert_pool_clean(eng)


# every kind the engine, the pool and the adapter act on, one request each
# (schedule index -> rule kwargs); pool_exhausted twice, unbound
_PLAN = {0: dict(kind="alloc_fail"), 2: dict(kind="nan_logits"),
         3: dict(kind="dispatch_error"), 4: dict(kind="cancel", tick=6)}


def _drive_both(decoders, schedule, knobs, plan=_PLAN):
    """The schedule through the JAX engine and the port's under the same
    plan (rules bound to each engine's rids once every request is
    submitted): returns both (engine, run) pairs."""
    runs = []
    last = max(t for t, _ in schedule)  # every request submitted by then
    for eng_cls, cfg_cls, rule_cls, adapter in (
            (RefEngine, RefEngineConfig, ref_faults.FaultRule, decoders[0]),
            (Engine, EngineConfig, FaultRule, decoders[1])):
        eng = eng_cls(adapter, cfg_cls(**knobs))

        def arm(engine, run, rule_cls=rule_cls):
            engine.faults.rules += [
                rule_cls(rid=run.reqs[i].rid, **kw) for i, kw in plan.items()]
            engine.faults.rules.append(rule_cls(kind="pool_exhausted",
                                                times=2))

        runs.append((eng, drive_ticks(eng, schedule, events={last: arm})))
    return runs


def _assert_same_outcomes(runs):
    (ref_eng, ref), (eng, got) = runs
    assert got.ticks == ref.ticks
    assert got.admitted == ref.admitted
    for i in ref.reqs:
        assert got.outcome(i) == ref.outcome(i), i
        if ref.reqs[i].step_logits:
            np.testing.assert_allclose(np.stack(got.reqs[i].step_logits),
                                       np.stack(ref.reqs[i].step_logits),
                                       rtol=RTOL, atol=ATOL)
    s, rs = eng.summary(), ref_eng.summary()
    keys = {k for k in rs if k.startswith(("fault:", "finish:"))}
    assert keys and {k for k in s if k.startswith(("fault:", "finish:"))} \
        == keys
    for k in sorted(keys) + ["failed", "cancelled", "quarantined_lanes",
                             "evictions", "decode_tokens", "prefill_tokens",
                             "faults_injected"]:
        assert s[k] == rs[k], k
    index = lambda run: {r.rid: i for i, r in run.reqs.items()}
    log = lambda e, run: [(x["tick"], x["kind"], index(run).get(x.get("rid")))
                          for x in e.faults.log]
    assert log(eng, got) == log(ref_eng, ref)
    _assert_pool_clean(eng)


@pytest.mark.parametrize("path", sorted(PATHS))
def test_fault_plan_outcomes_match_reference_engine(decoders, path):
    """Five fault kinds in one run: the port ends each request as the JAX
    engine does (state, reason, tokens), emits the same tokens at the
    same ticks, and counts the same ``fault:<kind>`` and ``finish:*``."""
    ps = np.asarray(ref_calibration(256, n_segments=6, seg_len=10,
                                    seed=5).tokens, np.int32)
    schedule = [(t, dict(prompt=p, max_new=GEN))
                for t, p in zip((0, 0, 0, 0, 1, 2), ps)]
    knobs = dict(max_seq_len=24, n_slots=4, page_size=4, token_budget=32,
                 prefill_chunk=8, record_logits=True, screen_logits=True,
                 **PATHS[path])
    runs = _drive_both(decoders, schedule, knobs)
    _assert_same_outcomes(runs)
    got = runs[1][1]
    assert [got.reqs[i].finish_reason for i in range(6)] == [
        "alloc_fail", "length", "nan_logits", "dispatch_error", "cancelled",
        "length"]


@pytest.fixture(scope="module")
def quantized_decoders():
    """The reference smoke model quantized to 2 bits by the JAX package,
    and the same weights converted for the port."""
    import jax

    from repro.configs import get_smoke_config
    from repro.core.quantizer import QuipConfig
    from repro.launch.quantize import quantize_dense_model
    from repro.models import build_model
    from repro.serve import CachedDecoder as RefDecoder
    from repro_torch import convert
    from repro_torch.serve.adapter import CachedDecoder
    from torch_parity import quantized_tree_numpy

    cfg = get_smoke_config("qwen3-14b")
    params = build_model(cfg).init(jax.random.PRNGKey(0))
    calib = ref_calibration(cfg.vocab, n_segments=4, seg_len=32, seed=7)
    qm = quantize_dense_model(
        params, cfg, QuipConfig(bits=2, method="ldlq", use_kernel=False),
        calib.tokens, seed=0, verbose=False)
    port_qm = convert.quantized_model_from_numpy(
        dataclasses.asdict(cfg), quantized_tree_numpy(qm), device="cpu")
    return RefDecoder.from_quantized(qm), CachedDecoder.from_quantized(port_qm)


def test_quantized_path_fault_quarantine(quantized_decoders):
    """Packed 2-bit weights: a poisoned lane is quarantined while the
    co-batched lanes keep the fault-free streams, as in the JAX engine."""
    ps = np.asarray(ref_calibration(256, n_segments=3, seg_len=10,
                                    seed=5).tokens, np.int32)
    knobs = dict(max_seq_len=18, n_slots=3, page_size=4, token_budget=32,
                 prefill_chunk=8, paged_decode=True)
    base = _engine(quantized_decoders[1], **knobs)
    breqs = [base.submit(p, max_new=6) for p in ps]
    base.run()
    schedule = [(0, dict(prompt=p, max_new=6)) for p in ps]
    runs = _drive_both(quantized_decoders, schedule,
                       dict(knobs, screen_logits=True),
                       plan={1: dict(kind="nan_logits")})
    _assert_same_outcomes(runs)
    got = runs[1][1]
    assert got.reqs[1].finish_reason == "nan_logits"
    for i in (0, 2):
        assert got.reqs[i].out_tokens == breqs[i].out_tokens


# ---------------------------------------------------------------------------
# the NaN/Inf screen moves a (B,) bool to the host, never the logits
# ---------------------------------------------------------------------------


class _HostWatch(torch.Tensor):
    """Records the shape of every tensor copied to the host (``cpu``,
    ``numpy``, ``tolist``, ``item``) among the logits and what is derived
    from them."""

    copies: list = []

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        name = getattr(func, "__name__", "")
        if name in ("cpu", "numpy", "tolist", "item", "__array__"):
            cls.copies.append(tuple(args[0].shape))
        return super().__torch_function__(func, types, args, kwargs or {})


@pytest.mark.parametrize("record_logits", [False, True])
def test_screen_copies_only_lane_flags_to_host(decoders, prompts, monkeypatch,
                                               record_logits):
    """With the device draw, neither ``record_logits`` nor shadow sampling,
    a screened decode tick copies only the (B,) finite flags of its logits
    to the host; with ``record_logits`` (the positive control) the
    logits' rows are copied too."""
    port = decoders[1]
    orig = port.decode_paged_sample

    def watched(*a, **k):
        sel, logits = orig(*a, **k)
        return sel, logits.as_subclass(_HostWatch)

    monkeypatch.setattr(port, "decode_paged_sample", watched)
    _HostWatch.copies = []
    eng = _engine(port, paged_decode=True, paged_prefill=True,
                  device_sample=True, screen_logits=True,
                  record_logits=record_logits, n_slots=4)
    reqs = [eng.submit(p, max_new=4) for p in prompts]
    eng.run()
    assert all(r.finish_reason == "length" for r in reqs)
    B = eng.ecfg.n_slots
    full = [c for c in _HostWatch.copies if c != (B,)]
    assert (B,) in _HostWatch.copies  # the screen ran on every decode tick
    if record_logits:
        assert (B, 256) in full
    else:
        assert full == [], full


# ---------------------------------------------------------------------------
# artifact integrity (per-shard SHA-256)
# ---------------------------------------------------------------------------


def _save_tiny(tmp_path):
    arrays = {"a": np.arange(8, dtype=np.float32).reshape(2, 4),
              "b/c": np.ones((3,), np.int32)}
    return save_arrays(tmp_path / "ckpt", 0, arrays,
                       extra_meta={"kind": "test"}), arrays


def test_shard_digest_roundtrip_and_corruption(tmp_path):
    step_dir, arrays = _save_tiny(tmp_path)
    manifest = json.loads((step_dir / "manifest.json").read_text())
    assert len(manifest["shard_digests"]) == manifest["n_shards"] >= 1
    got, _, _meta, _ = load_arrays(tmp_path / "ckpt")
    np.testing.assert_array_equal(got["a"], arrays["a"])
    manifest["shard_digests"][0] = "0" * 64
    (step_dir / "manifest.json").write_text(json.dumps(manifest))
    with pytest.raises(ArtifactCorruption) as ei:
        load_arrays(tmp_path / "ckpt")
    assert ei.value.shard == 0
    assert "shard 0" in str(ei.value) and "sha256" in str(ei.value)
    assert isinstance(ei.value, ValueError)
    load_arrays(tmp_path / "ckpt", verify=False)


def test_predigest_manifest_warns_not_fails(tmp_path):
    step_dir, _ = _save_tiny(tmp_path)
    mpath = step_dir / "manifest.json"
    manifest = json.loads(mpath.read_text())
    del manifest["shard_digests"]
    mpath.write_text(json.dumps(manifest))
    with pytest.warns(UserWarning, match="predates shard checksums"):
        load_arrays(tmp_path / "ckpt")


def test_corrupt_shard_fault_injection(tmp_path):
    """``corrupt_shard@shard=0`` fails the load of shard 0, at the store
    and through ``load_quantized(faults=)``; another shard index loads."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.serve.artifacts import load_quantized, save_quantized
    from repro_torch.serve.synthetic import QUIP_CONFIG, synthetic_quantized_model

    _save_tiny(tmp_path)
    plan = parse_fault_plan("corrupt_shard@shard=0")
    with pytest.raises(ArtifactCorruption):
        load_arrays(tmp_path / "ckpt", _corrupt_shards=plan.corrupt_shards())
    assert plan.rules[0].fired == 1

    qm = synthetic_quantized_model(get_smoke_config("qwen3-14b"), seed=0,
                                   device="cpu")
    save_quantized(tmp_path / "art", qm, QUIP_CONFIG)
    with pytest.raises(ArtifactCorruption) as ei:
        load_quantized(tmp_path / "art", device="cpu",
                       faults=parse_fault_plan("corrupt_shard@shard=0"))
    assert ei.value.shard == 0
    load_quantized(tmp_path / "art", device="cpu",
                   faults=parse_fault_plan("corrupt_shard@shard=7"))


# ---------------------------------------------------------------------------
# the plan grammar and hooks, against the JAX package's
# ---------------------------------------------------------------------------


def test_parse_fault_plan_grammar():
    plan = parse_fault_plan(
        "alloc_fail@rid=0;nan_logits@rid=2,times=3;cancel@rid=4,tick=6")
    kinds = [r.kind for r in plan.rules]
    assert kinds == ["alloc_fail", "nan_logits", "cancel"]
    assert plan.rules[1].times == 3
    assert plan.rules[2].tick == 6
    assert all(k in FAULT_KINDS for k in kinds)
    assert FAULT_KINDS == ref_faults.FAULT_KINDS and len(FAULT_KINDS) == 12


@pytest.mark.parametrize("bad", [
    "", "frobnicate", "alloc_fail@bogus=1", "alloc_fail@tick=x",
    "cancel", "alloc_fail@times=0",
])
def test_parse_fault_plan_rejects(bad):
    with pytest.raises(ValueError):
        parse_fault_plan(bad)


_SPECS = [
    "alloc_fail", "pool_exhausted@times=2", "nan_logits@rid=2,tick=3",
    "dispatch_error@rid=1", "corrupt_shard@shard=1", "cancel@rid=4,tick=6",
    "slow_client@ms=250,rid=3", "disconnect@tokens=5",
    "admission_burst@n=8,tick=2", "replica_kill@tick=40",
    "replica_hang@tick=3", "replica_slow@ms=50,times=4",
    " alloc_fail@rid=0 ; cancel@rid=1,tick=2 ;",
    # refused
    "", ";", "frobnicate", "alloc_fail@bogus=1", "alloc_fail@tick=x",
    "alloc_fail@tick", "cancel", "alloc_fail@times=0", "slow_client",
    "replica_slow@tick=1", "admission_burst", "admission_burst@n=0",
]


@pytest.mark.parametrize("spec", _SPECS)
def test_parse_fault_plan_equals_reference(spec):
    """The same rules from every spec (each of the twelve kinds), and the
    same error message from every refused one."""
    got = want = None
    try:
        got = [dataclasses.asdict(r) for r in parse_fault_plan(spec).rules]
    except ValueError as e:
        got = ("error", str(e))
    try:
        want = [dataclasses.asdict(r)
                for r in ref_faults.parse_fault_plan(spec).rules]
    except ValueError as e:
        want = ("error", str(e))
    assert got == want


def test_fault_rules_consume_and_log():
    plan = FaultPlan(rules=[FaultRule(kind="alloc_fail", rid=7, times=2)])
    assert plan.fire("alloc_fail", rid=7)
    assert plan.fire("alloc_fail", rid=7)
    assert not plan.fire("alloc_fail", rid=7)  # consumed
    assert not plan.fire("alloc_fail", rid=8)  # wrong rid never fires
    assert len(plan.log) == 2
    with pytest.raises(ValueError):
        FaultRule(kind="cancel")  # cancel must name a rid
    with pytest.raises(ValueError):
        FaultRule(kind="nope")


def _hook_trace(mod):
    """One sequence of hook calls on a plan of every kind; returns what
    each call gave back and the plan's log."""
    plan = mod.parse_fault_plan(
        "dispatch_error@tick=1;nan_logits;nan_logits@rid=5,tick=2;"
        "cancel@rid=9,tick=2;slow_client@ms=30,rid=4,times=2;"
        "disconnect@rid=4,tokens=3;admission_burst@n=6,tick=3;"
        "replica_slow@ms=20,times=2;replica_kill@tick=4;"
        "corrupt_shard@shard=2;alloc_fail@rid=5;pool_exhausted")
    out = []
    for tick in range(5):
        plan.tick = tick
        plan.lane_rids = (None, 5, 6)
        plan.poison_rids = (5,) if tick != 1 else ()
        try:
            plan.check_dispatch()
            out.append(("dispatch", None))
        except mod.FaultInjected as e:
            out.append(("dispatch", e.rid, str(e)))
        out += [("nan", plan.nan_lanes()), ("cancel", plan.cancel_rids()),
                ("stall", plan.stall_ms(4), plan.stall_ms(3)),
                ("disc", plan.disconnect_after(4, tick)),
                ("burst", plan.admission_burst()),
                ("replica", getattr(plan.replica_disruption(), "kind", None)),
                ("fire", bool(plan.fire("alloc_fail", rid=5)),
                 bool(plan.fire("pool_exhausted")), plan.active)]
    out.append(("shards", sorted(plan.corrupt_shards())))
    return out, plan.log


def test_plan_hooks_equal_reference():
    """Every hook of the plan (the engine's, the adapter's, the loader's,
    and the front door's and fleet's, which are data only in the port)
    returns and logs what the JAX package's does on the same calls."""
    assert _hook_trace(faults) == _hook_trace(ref_faults)
    assert faults.NO_FAULTS.rules == [] and not faults.NO_FAULTS.active


@pytest.mark.parametrize("kw", [
    dict(reason="over_capacity", retryable=False, needed_pages=9,
         available_pages=4),
    dict(reason="queue_full", retryable=True, pending=4, limit=4),
    dict(reason="rate_limited", retryable=True, retry_after_s=0.25,
         tenant="free"),
])
def test_admission_rejected_equals_reference(kw):
    """``AdmissionRejected`` lives in faults.py (the scheduler and the front
    door's admission module re-export it) with the reference's message,
    HTTP status and body."""
    from repro_torch.serve.frontdoor import admission
    from repro_torch.serve import scheduler

    assert scheduler.AdmissionRejected is AdmissionRejected
    assert admission.AdmissionRejected is AdmissionRejected
    got, want = AdmissionRejected(**kw), ref_faults.AdmissionRejected(**kw)
    assert str(got) == str(want)
    assert got.http_status == want.http_status
    assert got.to_dict() == want.to_dict()
    assert isinstance(got, ValueError)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def test_cli_fault_drill_outcomes():
    """The chaos drill of the JAX CLI, on the port: the same outcomes line,
    100 % agreement with the recompute oracle, no leaked page.  Request ids
    count from 0 per process, so the CLI runs in its own."""
    import os
    import pathlib
    import subprocess
    import sys

    root = pathlib.Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    proc = subprocess.run([
        sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
        "--smoke", "--paged", "--screen-logits", "--fault-plan",
        "alloc_fail@rid=0;nan_logits@rid=2;cancel@rid=4,tick=6", "--check",
        "--arrival-gap", "0"], env=env, cwd=root, capture_output=True,
        text=True, timeout=300)
    out = proc.stdout
    assert proc.returncode == 0, out + proc.stderr
    assert "outcomes: finished=3 cancelled=1 failed=2" in out
    assert "faults injected: 3 (alloc_fail; nan_logits; cancel)" in out
    assert "token agreement 100.00%" in out


def test_cli_trace_out_and_metrics_every(tmp_path, capsys):
    path = tmp_path / "trace.json"
    rc = port_serve.main([
        "--device", "cpu", "--smoke", "--paged", "--paged-prefill",
        "--requests", "3", "--gen", "4", "--trace-out", str(path),
        "--trace-sync", "--metrics-every", "1e-6"])
    cap = capsys.readouterr()
    assert rc == 0, cap.out
    assert f"spans -> {path}" in cap.out and "coverage=" in cap.out
    assert validate_chrome_trace(json.loads(path.read_text())) > 0
    assert "[metrics t=" in cap.err and "decode_tokens=" in cap.err


@pytest.mark.parametrize("argv", [
    ["--fault-plan", "frobnicate"],
    ["--fault-plan", "cancel"],
    ["--trace-sync"],
    ["--shadow-rate", "1.5"],
    ["--canary-every", "0"],
    ["--quality-baseline", "base.json"],
    ["--quality-strict"],
])
def test_cli_refuses_like_reference(argv):
    from repro.launch import serve as ref_serve

    msgs = []
    for main, extra in ((port_serve.main, ["--device", "cpu"]),
                        (ref_serve.main, [])):
        with pytest.raises(SystemExit) as ei:
            main([*extra, "--smoke", *argv])
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]
