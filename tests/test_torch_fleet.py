"""Port parity: the replica fleet (``repro_torch/serve/fleet``) and
``Engine.submit(resume_tokens=)``, mirroring ``tests/test_fleet.py``.

Held to the JAX package on the same inputs: ``prefix_key`` and
``rendezvous_rank`` exactly on seeded prompts, the journal's
``resume_body``, the replica fault rules, and resumed requests at every
cut against the JAX engine's uninterrupted stream (greedy and
device-sampled), with the drafter and the prefix cache seeing prompt +
resume as the JAX engine's do.  Then the router end to end over
in-process replicas (a :class:`ThreadReplicaFactory` of port front doors;
a ``disconnect`` fault gives the router what a ``kill -9`` gives it, EOF
before the done frame): balance, typed rejections passed through byte
for byte, greedy and sampled failover splices, 503 with no replica, the
supervisor's restarts and circuit breaker, the healthz watchdog.  One
test runs the CLI's fleet parent with real replica processes and a
``replica_kill`` drill; the CLI refuses what the JAX CLI refuses, with
its texts.
"""
from __future__ import annotations

import json
import os
import pathlib
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
from test_torch_frontdoor import _get_json, _parse_sse, _post
from torch_parity import drive_ticks, fp_decoders

from repro.data import make_calibration as ref_calibration
from repro.launch import serve as ref_serve
from repro.serve import Engine as RefEngine
from repro.serve import EngineConfig as RefEngineConfig
from repro.serve import faults as ref_faults
from repro.serve import fleet as ref_fleet
from repro.serve.scheduler import SamplingParams as RefSamplingParams
from repro_torch.launch import serve as port_serve
from repro_torch.serve.engine import Engine, EngineConfig
from repro_torch.serve.faults import parse_fault_plan
from repro_torch.serve.fleet import (
    FleetRouter,
    RequestJournal,
    Supervisor,
    prefix_key,
    rendezvous_rank,
)
from repro_torch.serve.frontdoor import FrontDoor
from repro_torch.serve.scheduler import SamplingParams

ROOT = pathlib.Path(__file__).resolve().parents[1]
GEN = 8
PROMPT_LEN = 8
_SAMPLED = dict(temperature=0.8, top_p=0.9, seed=7)


@pytest.fixture(scope="module")
def decoders():
    return fp_decoders(seed=0)


@pytest.fixture(scope="module")
def prompts():
    return np.asarray(ref_calibration(256, n_segments=3, seg_len=PROMPT_LEN,
                                      seed=3).tokens, np.int32)


def _knobs(sampled=False, **kw):
    out = dict(max_seq_len=PROMPT_LEN + GEN, n_slots=4, page_size=4,
               token_budget=32, prefill_chunk=8)
    if sampled:
        # the identity guarantee for non-greedy needs the device draw
        out.update(paged_decode=True, device_sample=True)
    out.update(kw)
    return out


def _engine(adapter, *, sampled=False, faults=None, **kw):
    return Engine(adapter, EngineConfig(**_knobs(sampled, **kw)),
                  faults=faults)


def _ref_engine(adapter, *, sampled=False, **kw):
    return RefEngine(adapter, RefEngineConfig(**_knobs(sampled, **kw)))


def _reference(ref_adapter, prompt, *, sampled=False):
    """The JAX engine's uninterrupted single-replica stream: what every
    fleet path of the port must reproduce."""
    eng = _ref_engine(ref_adapter, sampled=sampled)
    sp = RefSamplingParams(**_SAMPLED) if sampled else None
    req = eng.submit(np.asarray(prompt), max_new=GEN, sampling=sp)
    eng.run()
    return [int(t) for t in req.out_tokens]


class ThreadReplicaFactory:
    """The supervisor's factory protocol over in-process replicas: each
    "process" is a fresh port engine (same weights) behind a FrontDoor on
    a daemon thread.  ``fault_for(index, generation)`` arms
    per-incarnation faults, as ``--replica-fault`` does."""

    def __init__(self, adapter, *, sampled=False, fault_for=None):
        self.adapter = adapter
        self.sampled = sampled
        self.fault_for = fault_for or (lambda i, g: None)
        self.spawns = []

    def spawn(self, handle):
        eng = _engine(self.adapter, sampled=self.sampled,
                      faults=self.fault_for(handle.index, handle.generation))
        fd = FrontDoor(eng, port=0, drain_timeout_s=2.0,
                       tick_stall_s=5.0).start_in_thread()
        handle.proc = fd
        handle.port = fd.port
        handle.generation += 1
        self.spawns.append((handle.index, fd))

    def alive(self, handle):
        return handle.proc is not None and handle.proc._thread.is_alive()

    def kill(self, handle):
        fd = handle.proc
        if fd is not None and fd._thread.is_alive():
            fd.drain_and_join("kill", timeout=30)

    def drain(self, handle, timeout_s):
        fd = handle.proc
        if fd is None:
            return None
        if not fd._thread.is_alive():
            return fd.report.exit_code if fd.report is not None else None
        return fd.drain_and_join("fleet", timeout=timeout_s).exit_code


def _fleet(adapter, n=2, *, sampled=False, fault_for=None, max_restarts=3,
           **router_kw):
    factory = ThreadReplicaFactory(adapter, sampled=sampled,
                                   fault_for=fault_for)
    sup = Supervisor(factory, n, probe_interval_s=0.1, fail_threshold=2,
                     start_timeout_s=60, max_restarts=max_restarts,
                     backoff_base_s=0.05, backoff_max_s=0.2,
                     replica_drain_timeout_s=30)
    router = FleetRouter(sup, port=0, drain_timeout_s=10, **router_kw)
    return router.start_in_thread()


def _gen_tokens(port, prompt, *, stream=True, **extra):
    payload = {"prompt": [int(t) for t in prompt], "max_new": GEN,
               "stream": stream, **extra}
    c, r = _post(port, payload)
    try:
        assert r.status == 200, (r.status, r.read())
        raw = r.read()
    finally:
        c.close()
    if not stream:
        return json.loads(raw)["tokens"]
    events = _parse_sse(raw)
    toks = [d["token"] for ev, d in events if ev == "token"]
    done = [d for ev, d in events if ev == "done"]
    assert len(done) == 1 and done[0]["tokens"] == toks
    # contiguous global emission indices: a bad splice shows as a gap or
    # a repeat
    assert [d["i"] for ev, d in events if ev == "token"] == \
        list(range(len(toks)))
    return toks


def _wait(pred, timeout=30, every=0.02):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if pred():
            return True
        time.sleep(every)
    return False


# ---------------------------------------------------------------------------
# affinity, journal, fault grammar: exact against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_prefix_key_and_rendezvous_equal_jax(seed):
    rng = np.random.default_rng(seed)
    for length in (1, 5, 16, 17, 40):
        prompt = rng.integers(0, 152_000, size=length).astype(np.int32)
        key = prefix_key(prompt)
        assert key == ref_fleet.prefix_key(prompt)
        assert prefix_key(prompt, 4) == ref_fleet.prefix_key(prompt, 4)
        for n in (1, 2, 3, 5):
            assert rendezvous_rank(key, n) == ref_fleet.rendezvous_rank(
                key, n)
    assert prefix_key(list(range(100, 116)) + [1]) == prefix_key(
        list(range(100, 116)) + [2, 3])


def test_rendezvous_rank_is_stable_permutation():
    for key in (0, 1, 0xDEADBEEF):
        r = rendezvous_rank(key, 5)
        assert sorted(r) == list(range(5)) and r == rendezvous_rank(key, 5)
    for key in range(50):  # removing the winner keeps the others' order
        r = rendezvous_rank(key, 4)
        assert r[1:] == [i for i in rendezvous_rank(key, 4) if i != r[0]]
    wins = [rendezvous_rank(k, 3)[0] for k in range(300)]
    assert all(wins.count(i) > 30 for i in range(3))
    for n in (0, -1):
        errs = []
        for fn in (rendezvous_rank, ref_fleet.rendezvous_rank):
            with pytest.raises(ValueError) as ei:
                fn(1, n)
            errs.append(str(ei.value))
        assert errs[0] == errs[1]


def test_journal_equals_jax():
    """The same record / assign / close sequence through both journals:
    the same resume bodies, counters, and out-of-sync texts."""
    body = {"prompt": [1, 2], "max_new": 8, "seed": 7, "stop_tokens": [3]}
    outs = []
    for journal in (RequestJournal(), ref_fleet.RequestJournal()):
        e = journal.open(body, stream=True)
        e.assign(0)
        e.record(0, 11)
        e.record(1, 12)
        errs = []
        for idx in (3, 1):  # a gap, a repeat
            with pytest.raises(ValueError) as ei:
                e.record(idx, 14)
            errs.append(str(ei.value))
        e.assign(2)
        rb = e.resume_body()
        journal.note_failover(e)
        journal.close(e, finish_reason="length")
        e2 = journal.open(body, stream=False)
        journal.close(e2, finish_reason=None)
        outs.append((rb, errs, e.n_failovers, e.replica, e.attempts,
                     e.done, e2.done, len(journal), journal.opened,
                     journal.completed, journal.failed, journal.failovers))
    assert outs[0] == outs[1]
    assert outs[0][0] == {**body, "resume_tokens": [11, 12]}
    assert body == {"prompt": [1, 2], "max_new": 8, "seed": 7,
                    "stop_tokens": [3]}  # untouched


def test_replica_fault_rules_equal_jax():
    spec = "replica_kill@tick=5;replica_slow@ms=20,times=3;replica_hang"
    seen = []
    for parse in (parse_fault_plan, ref_faults.parse_fault_plan):
        plan = parse(spec)
        kinds = [r.kind for r in plan.rules]
        fired = []
        for tick in (4, 5, 5, 6):
            plan.tick = tick
            rule = plan.replica_disruption()
            fired.append(None if rule is None else (rule.kind, rule.ms))
        seen.append((kinds, fired, plan.log))
    assert seen[0] == seen[1]
    assert seen[0][0] == ["replica_kill", "replica_slow", "replica_hang"]


# ---------------------------------------------------------------------------
# the mechanism: a resumed request equals the uninterrupted stream
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
@pytest.mark.parametrize("k", [0, 1, 5, GEN - 1])
def test_engine_resume_token_identity(decoders, prompts, sampled, k):
    """``resume_tokens=ref[:k]`` on a fresh port engine (the survivor)
    emits exactly the JAX engine's uninterrupted stream: greedy because
    argmax keeps no state, sampled because the device draw keys on
    fold_in(seed, emission index) and the resumed request goes on at
    index k.  The port's resumed request equals the JAX engine's resumed
    request too (tokens, ``resumed``, ``token_times`` backfill)."""
    ref = _reference(decoders[0], prompts[0], sampled=sampled)
    assert len(ref) == GEN
    outs = []
    for eng, sp in ((_engine(decoders[1], sampled=sampled),
                     SamplingParams(**_SAMPLED) if sampled else None),
                    (_ref_engine(decoders[0], sampled=sampled),
                     RefSamplingParams(**_SAMPLED) if sampled else None)):
        req = eng.submit(np.asarray(prompts[0]), max_new=GEN, sampling=sp,
                         resume_tokens=tuple(ref[:k]), arrival=0.5)
        assert req.resumed == k and req.token_times == [0.5] * k
        eng.run()
        outs.append([int(t) for t in req.out_tokens])
    assert outs[0] == outs[1] == ref


def test_resume_token_validation_equals_jax(decoders, prompts):
    cases = [dict(max_new=4, resume_tokens=(1, 2, 3, 4)),
             dict(max_new=3, resume_tokens=(1, 2, 3, 4)),
             dict(max_new=8, stop_tokens=(3,), resume_tokens=(1, 2, 3))]
    for kw in cases:
        errs = []
        for eng in (_engine(decoders[1]), _ref_engine(decoders[0])):
            with pytest.raises(ValueError) as ei:
                eng.submit(np.asarray(prompts[0]), **kw)
            errs.append(str(ei.value))
        assert errs[0] == errs[1]


def test_resume_counts_in_admission_capacity(decoders):
    """``max_new`` is the whole budget, resumed tokens included: a resume
    does not change the capacity forecast, in both packages alike."""
    for kw in (dict(max_new=9, resume_tokens=(1, 2, 3)),
               dict(max_new=8, resume_tokens=(1, 2, 3, 4, 5, 6, 7))):
        got = []
        for eng in (_engine(decoders[1]), _ref_engine(decoders[0])):
            try:
                r = eng.submit(np.arange(1, 9, dtype=np.int32), **kw)
                got.append(("ok", len(r.prefix), r.resumed))
            except ValueError as e:  # AdmissionRejected in both
                got.append((e.reason, e.to_dict()))
        assert got[0] == got[1]
    assert got[0] == ("ok", 15, 7)


@pytest.mark.parametrize("knobs", [
    dict(paged_decode=True, paged_prefill=True, prefix_cache=True),
    dict(paged_decode=True, paged_prefill=True, speculative_k=3),
], ids=["prefix_cache", "speculative"])
def test_resume_through_prefix_cache_and_drafter_equals_jax(decoders,
                                                            prompts,
                                                            knobs):
    """Resumed requests on a tick schedule with the prefix cache or the
    n-gram drafter on: both see prompt + resume as the JAX engine's do —
    the same ticks, streams, prefix hits, drafts and acceptances."""
    ref = _reference(decoders[0], prompts[0])
    sched = [(0, dict(prompt=prompts[0], max_new=GEN)),
             (2, dict(prompt=prompts[0], max_new=GEN,
                      resume_tokens=tuple(ref[:3]))),
             (3, dict(prompt=prompts[1], max_new=GEN)),
             (6, dict(prompt=prompts[0], max_new=GEN,
                      resume_tokens=tuple(ref[:6])))]
    runs = []
    for eng in (_engine(decoders[1], **knobs),
                _ref_engine(decoders[0], **knobs)):
        run = drive_ticks(eng, sched)
        s = eng.summary()
        runs.append((run.ticks, run.admitted,
                     {i: run.outcome(i) for i in run.reqs},
                     {k: s[k] for k in ("prefix_hit_tokens", "draft_tokens",
                                        "accepted_tokens", "prefill_tokens",
                                        "decode_tokens")}))
    assert runs[0] == runs[1]
    for i in (0, 1, 3):
        assert runs[0][2][i][2] == ref
    if knobs.get("prefix_cache"):
        assert runs[0][3]["prefix_hit_tokens"] > 0
    else:
        assert runs[0][3]["draft_tokens"] > 0


# ---------------------------------------------------------------------------
# the tick-stall watchdog
# ---------------------------------------------------------------------------


def test_healthz_watchdog_flips_on_wedged_executor(decoders):
    """Block the engine thread (a dispatch that never returns): /healthz
    flips to 503 ``wedged`` while the socket answers, then recovers."""
    fd = FrontDoor(_engine(decoders[1]), drain_timeout_s=2.0,
                   tick_stall_s=0.15).start_in_thread()
    try:
        status, h = _get_json(fd.port, "/healthz")
        assert status == 200 and h["status"] == "ok"
        fd._exec.submit(time.sleep, 1.0)  # wedge the engine thread
        assert _wait(lambda: _get_json(fd.port, "/healthz")[0] == 503,
                     timeout=5)
        status, h = _get_json(fd.port, "/healthz")
        if status == 503:  # it may have recovered already
            assert h["status"] == "wedged" and h["last_tick_age_s"] > 0.15
        assert _wait(lambda: _get_json(fd.port, "/healthz")[0] == 200,
                     timeout=5)
    finally:
        assert fd.drain_and_join().exit_code == 0
    assert "last_tick_age_s" in fd.engine.summary()


# ---------------------------------------------------------------------------
# the router end to end
# ---------------------------------------------------------------------------


def test_router_balances_and_stays_token_identical(decoders, prompts):
    refs = [_reference(decoders[0], p) for p in prompts]
    router = _fleet(decoders[1], n=2)
    try:
        status, rz = _get_json(router.port, "/readyz")
        assert status == 200 and rz["available_replicas"] == 2
        got_sse = [_gen_tokens(router.port, p) for p in prompts]
        got_buf = [_gen_tokens(router.port, p, stream=False)
                   for p in prompts]
        assert got_sse == refs and got_buf == refs
        _, fz = _get_json(router.port, "/fleetz")
        assert fz["router"]["affinity_hits"] == 6
        assert fz["router"]["failovers"] == 0
        served = [r["served"] for r in fz["replicas"]]
        want = [0, 0]
        for p in prompts:
            want[ref_fleet.rendezvous_rank(ref_fleet.prefix_key(p), 2)[0]] += 2
        assert served == want
    finally:
        report = router.drain_and_join()
    assert report.exit_code == 0 and report.completed == 6
    assert all(r["exit_code"] == 0 for r in report.replicas)


def test_router_passes_typed_rejections_through(decoders):
    router = _fleet(decoders[1], n=2)
    try:
        body = {"prompt": [1, 2, 3], "max_new": 10_000}
        c, r = _post(router.port, body)
        raw, headers = r.read(), dict(r.getheaders())
        c.close()
        # byte for byte what a replica answers
        replica = router.sup.handles[0].port
        c, rr = _post(replica, body)
        assert (r.status, raw) == (rr.status, rr.read()) and r.status == 413
        c.close()
        assert "Retry-After" not in headers
        assert json.loads(raw)["retryable"] is False
        c, r = _post(router.port, {"max_new": 4})
        body = json.loads(r.read())
        c.close()
        assert r.status == 400 and body["error"] == "bad_request"
        _, fz = _get_json(router.port, "/fleetz")
        assert fz["router"]["rejections_passed"] == 1
    finally:
        assert router.drain_and_join().exit_code == 0


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
def test_router_failover_splices_token_identically(decoders, prompts,
                                                   sampled):
    """The serving replica dies mid-stream; the client's one SSE stream
    carries the JAX engine's uninterrupted tokens, contiguous indices,
    one done frame."""
    prompt = prompts[1] if sampled else prompts[0]
    ref = _reference(decoders[0], prompt, sampled=sampled)
    victim = rendezvous_rank(prefix_key(prompt), 2)[0]
    cut = 2 if sampled else 3

    def fault_for(index, generation):
        if index == victim and generation == 0:
            return parse_fault_plan(f"disconnect@tokens={cut}")
        return None

    router = _fleet(decoders[1], n=2, sampled=sampled, fault_for=fault_for)
    try:
        extra = _SAMPLED if sampled else {}
        assert _gen_tokens(router.port, prompt, **extra) == ref
        _, fz = _get_json(router.port, "/fleetz")
        assert fz["router"]["failovers"] == 1
        assert fz["journal"]["completed"] == 1
        assert [r["served"] for r in fz["replicas"]][1 - victim] == 1
    finally:
        report = router.drain_and_join()
    assert report.exit_code == 0 and report.failovers == 1


def test_router_503_when_no_replica_available(decoders):
    router = _fleet(decoders[1], n=2, max_restarts=0)
    sup = router.sup
    try:
        for h in sup.handles:
            h.proc.drain_and_join("chaos-kill")
        assert _wait(lambda: all(h.state == "gone" for h in sup.handles),
                     timeout=15)
        status, rz = _get_json(router.port, "/readyz")
        assert status == 503 and rz["available_replicas"] == 0
        c, r = _post(router.port, {"prompt": [1, 2, 3], "max_new": 4})
        body = json.loads(r.read())
        assert r.status == 503
        assert body == {"error": "replica_unavailable", "retryable": True}
        assert r.getheader("Retry-After") == "1"
        c.close()
    finally:
        report = router.drain_and_join()
    assert report.exit_code == 0


def test_supervisor_restarts_crashed_replica(decoders, prompts):
    ref = _reference(decoders[0], prompts[2])
    router = _fleet(decoders[1], n=1, max_restarts=2)
    sup = router.sup
    h = sup.handles[0]
    try:
        first_port = h.port
        h.proc.drain_and_join("chaos-kill")
        assert _wait(lambda: h.state == "healthy" and h.restarts == 1)
        assert h.generation == 2 and h.port != first_port
        assert _gen_tokens(router.port, prompts[2]) == ref
        h.proc.drain_and_join("chaos-kill-2")
        assert _wait(lambda: h.state == "healthy" and h.restarts == 2)
        h.proc.drain_and_join("chaos-kill-3")  # the circuit breaker
        assert _wait(lambda: h.state == "gone")
        assert _get_json(router.port, "/readyz")[0] == 503
    finally:
        report = router.drain_and_join()
    assert report.exit_code == 0
    assert report.replicas[0]["restarts"] == 2


def test_fleet_report_lines_equal_jax():
    reps = [{"index": 0, "state": "drained", "served": 3, "restarts": 0,
             "exit_code": 0},
            {"index": 1, "state": "gone", "served": 1, "restarts": 3,
             "exit_code": None}]
    for replicas in (reps, reps[:1] + [dict(reps[1], exit_code=1)]):
        kw = dict(reason="sigterm", duration_s=2.5, routed=4, completed=4,
                  failed=0, failovers=1, aborted_streams=0,
                  replicas=replicas)
        from repro_torch.serve.fleet import FleetReport

        got, want = FleetReport(**kw), ref_fleet.FleetReport(**kw)
        assert got.lines() == want.lines()
        assert got.exit_code == want.exit_code


# ---------------------------------------------------------------------------
# the CLI: real replica processes, a kill -9 drill, and the refusals
# ---------------------------------------------------------------------------


def test_cli_fleet_with_process_replicas_and_kill_drill():
    """``--fleet 2`` spawns two ``python -m repro_torch.launch.serve``
    replicas (the port's CLI, CPU).  Replica 1's first incarnation is
    armed with ``--replica-fault 1:replica_kill@tick=30``: the engine's
    ``steps`` counts idle ticks too, so it dies (``os._exit(137)``) soon
    after it is ready, and the supervisor brings up generation 2 without
    the fault.  Then a stream routed to replica 1 is cut by a SIGKILL of
    its process after 4 tokens; the client's stream goes on token for
    token from replica 0, the supervisor restarts replica 1 again, and
    SIGTERM drains the fleet with every leak gate clean.  Every replica
    runs ``replica_slow@ms=20`` a tick, so the stream outlasts the kill."""
    common = ["--smoke", "--device", "cpu", "--paged", "--paged-prefill",
              "--seed", "0"]
    # the stream a replica serves uninterrupted: an engine built as the
    # replica CLI builds it
    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.quantize import fp_model
    from repro_torch.models.transformer import init_decoder
    from repro_torch.serve.adapter import CachedDecoder

    cfg = get_smoke_config("qwen3-14b")
    g = torch.Generator(device="cpu")
    g.manual_seed(0)
    adapter = CachedDecoder.from_quantized(
        fp_model(init_decoder(cfg, g, device="cpu"), cfg))
    rng = np.random.default_rng(0)
    prompt = next(p for p in (rng.integers(0, cfg.vocab, 16)
                              for _ in range(100))
                  if rendezvous_rank(prefix_key(p), 2)[0] == 1)
    eng = port_serve.build_engine(
        adapter, max_seq_len=48, args=port_serve.parser().parse_args(common))
    req = eng.submit(prompt, max_new=24)
    eng.run()
    ref = [int(t) for t in req.out_tokens]

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", *common,
         "--fault-plan", "replica_slow@ms=20,times=1000000",
         "--fleet", "2", "--probe-interval-s", "0.2",
         "--restart-backoff-s", "0.1",
         "--replica-fault", "1:replica_kill@tick=30"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, cwd=ROOT,
        text=True, start_new_session=True)  # its replicas join its group
    lines = []
    try:
        port = None
        t0 = time.monotonic()
        while port is None and time.monotonic() - t0 < 120:
            line = proc.stdout.readline()
            if not line:
                break
            lines.append(line)
            if line.startswith("[router] listening on "):
                port = int(line.split()[3].rsplit(":", 1)[1])
        assert port is not None, "".join(lines)

        def ready(gen):
            _, fz = _get_json(port, "/fleetz")
            return (fz["replicas"][1]["generation"] == gen
                    and all(r["state"] == "healthy"
                            for r in fz["replicas"]))

        assert _wait(lambda: ready(2), timeout=60)  # replica_kill fired
        pid = _get_json(port, "/fleetz")[1]["replicas"][1]["pid"]
        c, r = _post(port, {"prompt": [int(t) for t in prompt],
                            "max_new": 24})
        assert r.status == 200
        raw = b""
        while raw.count(b"event: token") < 4:
            raw += r.fp.readline()
        os.kill(pid, signal.SIGKILL)
        raw += r.read()
        c.close()
        events = _parse_sse(raw)
        toks = [d["token"] for ev, d in events if ev == "token"]
        assert [d["i"] for ev, d in events if ev == "token"] == \
            list(range(24))
        assert toks == ref and events[-1][1]["tokens"] == ref
        _, fz = _get_json(port, "/fleetz")
        assert fz["router"]["failovers"] == 1
        assert _wait(lambda: ready(3), timeout=60)
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=90)
    finally:
        try:  # whatever is left of the parent and its replicas
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        proc.wait()
    out = "".join(lines) + out
    assert proc.returncode == 0, out
    assert "1 failover(s)" in out
    assert "fleet leak gates: clean on every drained replica" in out
    assert out.count("leak gate: clean (0 leaked pages, 0 mapped slots)") == 2
    assert "replica 0: state=drained served=1 restarts=0 exit=0" in out
    assert "replica 1: state=drained served=0 restarts=2 exit=0" in out


REFUSALS = [
    ["--router-port", "9"],
    ["--replica-fault", "0:replica_kill"],
    ["--fleet", "0"],
    ["--fleet", "2", "--check"],
    ["--fleet", "2", "--http-port", "0"],
    ["--http-port", "0", "--check"],
    ["--fleet", "2", "--replica-fault", "x"],
    ["--fleet", "2", "--replica-fault", "5:replica_kill"],
    ["--fleet", "2", "--replica-fault", "1:bogus@tick=1"],
]


@pytest.mark.parametrize("argv", REFUSALS, ids=lambda a: " ".join(a))
def test_cli_fleet_and_http_refusals_equal_jax(argv):
    texts = []
    for main in (port_serve.main, ref_serve.main):
        with pytest.raises(SystemExit) as ei:
            main(["--smoke", *argv])
        texts.append(str(ei.value.code))
    assert texts[0] == texts[1]


@pytest.mark.parametrize("extra", [["--http-port", "0"], ["--fleet", "2"]])
def test_cli_refuses_mesh_behind_front_door(extra):
    with pytest.raises(SystemExit) as ei:
        port_serve.main(["--smoke", "--device", "cpu", "--mesh", "1,2",
                         *extra])
    assert "the front door and the fleet do not drive a mesh" in str(
        ei.value.code)


@pytest.mark.parametrize("argv", [
    ["--smoke", "--fleet", "2", "--router-port", "8000", "--paged"],
    ["--fleet=3", "--http-host=0.0.0.0", "--replica-fault", "1:x",
     "--gen", "4", "--max-restarts", "1", "--restart-backoff-s", "2",
     "--probe-interval-s", "0.1", "--tick-stall-s", "3"],
])
def test_replica_argv_equals_jax(argv):
    assert port_serve._replica_argv(argv) == ref_serve._replica_argv(argv)
    assert port_serve._FLEET_ONLY_FLAGS == ref_serve._FLEET_ONLY_FLAGS
