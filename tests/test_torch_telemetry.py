"""Port parity: telemetry (``repro_torch/serve/telemetry.py``) and its
engine wiring, mirroring ``tests/test_telemetry.py``.

The tracer, the metrics registry and the trace schema are held to the
JAX package's on the same inputs: the same histogram percentiles and
metrics lines, the same phase breakdown, Chrome traces that validate
under either package's validator, and — driving both engines one tick at
a time on the same schedule (``torch_parity.drive_ticks``) — the same
span names, nesting and lifecycle events.  Times are never compared.
Observing the engine never changes it: streams with a sync tracer equal
streams without one.
"""
from __future__ import annotations

import json
import time

import numpy as np
import pytest
import torch
from torch_parity import drive_ticks, fp_decoders

from repro.data import make_calibration as ref_calibration
from repro.serve import Engine as RefEngine
from repro.serve import EngineConfig as RefEngineConfig
from repro.serve import telemetry as ref_tel
from repro.serve.faults import FaultRule as RefFaultRule
from repro_torch.configs import get_smoke_config
from repro_torch.serve.adapter import CachedDecoder
from repro_torch.serve.engine import Engine, EngineConfig
from repro_torch.serve.faults import FaultRule
from repro_torch.serve.synthetic import synthetic_quantized_model
from repro_torch.serve.telemetry import (
    NULL_TRACER,
    Histogram,
    MetricsRegistry,
    Span,
    Tracer,
    format_metrics_line,
    phase_breakdown,
    validate_chrome_trace,
)

# ---------------------------------------------------------------------------
# tracer unit tests (no model)
# ---------------------------------------------------------------------------


class _FakeClock:
    """Deterministic monotonic clock: one tick per call."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1.0
        return self.t


def test_ring_buffer_wraparound():
    tr = Tracer(capacity=4, clock=_FakeClock())
    for i in range(7):
        tr.event(f"e{i}")
    assert len(tr) == 4
    assert tr.dropped == 3
    assert [s.name for s in tr.spans] == ["e3", "e4", "e5", "e6"]
    t0s = [s.t0 for s in tr.spans]
    assert t0s == sorted(t0s)
    tr.clear()
    assert len(tr) == 0 and tr.dropped == 0 and tr.spans == []


def test_span_nesting_depth_and_attrs():
    tr = Tracer(clock=_FakeClock())
    with tr.span("step"):
        with tr.span("prefill", lanes=3):
            with tr.span("dispatch:prefill_paged"):
                pass
    by_name = {s.name: s for s in tr.spans}
    assert by_name["step"].depth == 0
    assert by_name["prefill"].depth == 1
    assert by_name["dispatch:prefill_paged"].depth == 2
    assert by_name["prefill"].attrs == {"lanes": 3}
    # spans record on exit: children land in the ring before parents
    assert [s.name for s in tr.spans] == [
        "dispatch:prefill_paged", "prefill", "step"]
    for s in tr.spans:
        assert s.t1 > s.t0 and not s.instant


def test_sync_tracer_calls_barrier_at_both_edges():
    calls = []
    tr = Tracer(sync=True, sync_fn=lambda: calls.append(1),
                clock=_FakeClock())
    with tr.span("step"):
        pass
    assert len(calls) == 2  # entry + exit barrier
    tr2 = Tracer(sync=True, clock=_FakeClock())  # no barrier: a no-op
    with tr2.span("step"):
        pass
    assert len(tr2) == 1


def test_spans_open_profiler_ranges():
    """A live tracer's spans are ``torch.profiler`` ranges, nested as the
    spans are; ``annotate=False`` and NULL_TRACER open none."""
    from torch.profiler import ProfilerActivity, profile

    tr = Tracer()
    quiet = Tracer(annotate=False)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tr.span("step"):
            with tr.span("dispatch:decode_paged"):
                torch.ones(4).sum()
        with quiet.span("quiet"), NULL_TRACER.span("null"):
            pass
    names = {e.name for e in prof.events()}
    assert {"step", "dispatch:decode_paged"} <= names
    assert not {"quiet", "null"} & names
    inner = next(e for e in prof.events()
                 if e.name == "dispatch:decode_paged")
    assert inner.cpu_parent is not None and inner.cpu_parent.name == "step"


def test_chrome_export_schema_and_tags(tmp_path):
    tr = Tracer(clock=_FakeClock(), tags={"mesh_model": 2})
    with tr.span("step"):
        with tr.span("decode", lanes=2):
            tr.event("first_token", rid=0)
    path = tmp_path / "trace.json"
    tr.export_chrome_trace(path)
    obj = json.load(open(path))
    assert validate_chrome_trace(obj) == 3
    assert ref_tel.validate_chrome_trace(obj) == 3
    events = {e["name"]: e for e in obj["traceEvents"]}
    assert events["thread_name"]["ph"] == "M"
    assert events["step"]["ph"] == "X" and events["step"]["dur"] > 0
    inst = events["first_token"]
    assert inst["ph"] == "i" and inst["s"] == "t" and "dur" not in inst
    assert events["decode"]["args"] == {"mesh_model": 2, "lanes": 2}
    assert inst["args"] == {"mesh_model": 2, "rid": 0}
    assert obj["otherData"]["dropped_spans"] == 0
    # the JAX tracer's export of the same spans: the same events
    rtr = ref_tel.Tracer(clock=_FakeClock(), tags={"mesh_model": 2})
    with rtr.span("step"):
        with rtr.span("decode", lanes=2):
            rtr.event("first_token", rid=0)
    assert rtr.chrome_events() == tr.chrome_events()


_MALFORMED = [
    [],  # not an object
    {},  # no traceEvents
    {"traceEvents": [{"name": "a", "ph": "Z", "ts": 0, "pid": 0,
                      "tid": 0}]},  # unknown phase
    {"traceEvents": [{"name": "", "ph": "X", "ts": 0, "dur": 1,
                      "pid": 0, "tid": 0}]},  # empty name
    {"traceEvents": [{"name": "a", "ph": "X", "ts": -1, "dur": 1,
                      "pid": 0, "tid": 0}]},  # negative ts
    {"traceEvents": [{"name": "a", "ph": "X", "ts": 0, "pid": 0,
                      "tid": 0}]},  # complete event without dur
    {"traceEvents": [{"name": "a", "ph": "i", "ts": 0, "dur": 1,
                      "pid": 0, "tid": 0}]},  # instant carrying dur
    {"traceEvents": [{"name": "m", "ph": "M", "pid": 0, "tid": 0}]},
]


@pytest.mark.parametrize("i", range(len(_MALFORMED)))
def test_validate_chrome_trace_rejects_malformed(i):
    ok = {"traceEvents": [{"name": "a", "ph": "X", "ts": 0.0, "dur": 1.0,
                           "pid": 0, "tid": 0}]}
    assert validate_chrome_trace(ok) == 1
    errors = []
    for validate in (validate_chrome_trace, ref_tel.validate_chrome_trace):
        with pytest.raises(ValueError) as ei:
            validate(_MALFORMED[i])
        errors.append(str(ei.value))
    assert errors[0] == errors[1]  # the same first violation, worded alike


def test_phase_breakdown_math():
    rows = [("step", 0.0, 10.0, 0, False),
            ("prefill", 0.0, 4.0, 1, False),
            ("decode", 4.0, 9.0, 1, False),
            ("dispatch:decode_paged", 4.0, 8.0, 2, False),  # not a phase
            ("first_token", 5.0, 5.0, 1, True)]  # mark: excluded
    pb = phase_breakdown([Span(n, a, b, d, instant=i)
                          for n, a, b, d, i in rows])
    assert pb["root_s"] == 10.0 and pb["root_count"] == 1
    assert set(pb["phases"]) == {"prefill", "decode"}
    assert pb["phases"]["prefill"]["share"] == pytest.approx(0.4)
    assert pb["coverage"] == pytest.approx(0.9)
    assert phase_breakdown([])["coverage"] == 0.0
    assert pb == ref_tel.phase_breakdown(
        [ref_tel.Span(n, a, b, d, instant=i) for n, a, b, d, i in rows])


def test_null_tracer_records_nothing_and_is_cheap():
    h = NULL_TRACER.span("step", lanes=4)
    assert h is NULL_TRACER.span("decode")  # one shared no-op handle
    NULL_TRACER.event("first_token", rid=1)
    assert len(NULL_TRACER) == 0 and NULL_TRACER.spans == []
    assert not NULL_TRACER.enabled
    n = 50_000
    t0 = time.perf_counter()
    for _ in range(n):
        with NULL_TRACER.span("step"):
            pass
    per_hit = (time.perf_counter() - t0) / n
    assert per_hit < 5e-6, f"disabled span site costs {per_hit * 1e6:.2f}µs"


# ---------------------------------------------------------------------------
# metrics unit tests
# ---------------------------------------------------------------------------


def test_histogram_percentiles_match_numpy_and_empty_is_none():
    h = Histogram("ttft_s")
    assert h.percentile(50) is None and h.summary()["mean"] is None
    xs = [0.5, 0.1, 0.9, 0.3, 0.7]
    for x in xs:
        h.observe(x)
    assert h.count == 5 and h.sum == pytest.approx(2.5)
    for q in (50, 99):
        assert h.percentile(q) == float(np.percentile(np.asarray(xs), q))
    s = h.summary()
    assert s["count"] == 5 and s["p50"] == 0.5
    assert "null" in json.dumps(Histogram("itl_s").summary())


@pytest.mark.parametrize("seed", range(4))
def test_histogram_summary_equals_reference(seed):
    """The same samples give the reference's summary exactly (count, mean,
    p50, p99: equality, not a tolerance)."""
    rng = np.random.default_rng(seed)
    xs = rng.lognormal(size=int(rng.integers(1, 200)))
    h, rh = Histogram("itl_s"), ref_tel.Histogram("itl_s")
    for x in xs:
        h.observe(x)
        rh.observe(x)
    assert h.summary() == rh.summary()
    for q in (1, 25, 50, 90, 99, 100):
        assert h.percentile(q) == rh.percentile(q)


def test_metrics_registry_snapshot_and_reset():
    reg = MetricsRegistry()
    reg.inc("steps")
    reg.inc("decode_tokens", 5)
    reg.counter("prefill_batch_size").peak(3)
    reg.counter("prefill_batch_size").peak(2)  # high-water mark keeps 3
    reg.gauge("occupancy").set(0.5)
    live = {"v": 7}
    reg.gauge("pages_in_use", fn=lambda: live["v"])
    reg.histogram("ttft_s").observe(0.25)
    s = reg.snapshot()
    assert s["steps"] == 1 and s["decode_tokens"] == 5
    assert s["prefill_batch_size"] == 3
    assert s["occupancy"] == 0.5 and s["pages_in_use"] == 7
    assert s["ttft_s_count"] == 1 and s["ttft_s_p50"] == 0.25
    assert reg.counter("steps") is reg.counter("steps")  # idempotent
    reg.reset()
    live["v"] = 9
    s = reg.snapshot()
    assert s["steps"] == 0 and s["occupancy"] == 0
    assert s["pages_in_use"] == 9  # callback gauges track live state
    assert s["ttft_s_count"] == 0 and s["ttft_s_p50"] is None


def test_format_metrics_line_skips_empty_histograms():
    line = format_metrics_line(
        {"steps": 3, "occupancy": 0.25, "itl_s_p50": None},
        t=1.5, keys=["steps", "occupancy", "itl_s_p50", "missing"])
    assert line == "[metrics t=1.5s] steps=3 occupancy=0.25"


@pytest.mark.parametrize("snap,t,keys", [
    ({"steps": 3, "occupancy": 0.25, "itl_s_p50": None}, 1.5, None),
    ({"steps": 12, "ttft_s_p99": 0.0123456, "canary_nll": 5.4321098},
     None, ["canary_nll", "steps", "ttft_s_p99", "absent"]),
    ({"a": 1e-9, "b": 123456.789, "c": True, "d": "x"}, 1234.56, None),
])
def test_format_metrics_line_equals_reference(snap, t, keys):
    assert format_metrics_line(snap, t=t, keys=keys) == \
        ref_tel.format_metrics_line(snap, t=t, keys=keys)


# ---------------------------------------------------------------------------
# engine integration: tracing never changes tokens, and reports honestly
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def decoders():
    return fp_decoders(seed=0)


def _prompts(n, seg_len, seed):
    return np.asarray(ref_calibration(256, n_segments=n, seg_len=seg_len,
                                      seed=seed).tokens, np.int32)


def _run(adapter, prompts, gen, *, tracer=None, **ecfg_kw):
    kw = dict(max_seq_len=prompts.shape[1] + gen, n_slots=4, page_size=4,
              token_budget=32, prefill_chunk=8)
    kw.update(ecfg_kw)
    engine = Engine(adapter, EngineConfig(**kw), tracer=tracer)
    reqs = [engine.submit(p, max_new=gen, arrival=0.01 * i)
            for i, p in enumerate(prompts)]
    engine.run()
    return engine, reqs


def _parity(adapter, prompts, gen, **ecfg_kw):
    """Token streams are identical with and without a sync tracer."""
    _, base = _run(adapter, prompts, gen, **ecfg_kw)
    tr = Tracer(sync=True)
    engine, traced = _run(adapter, prompts, gen, tracer=tr, **ecfg_kw)
    for a, b in zip(base, traced):
        assert a.out_tokens == b.out_tokens
    return engine, tr


def test_tracer_parity_fp_paged(decoders):
    _, tr = _parity(decoders[1], _prompts(3, 10, 3), 5, paged_decode=True,
                    paged_prefill=True)
    names = {s.name for s in tr.spans}
    assert {"step", "schedule", "prefill", "decode",
            "dispatch:prefill_paged", "dispatch:decode_paged"} <= names


def test_tracer_parity_speculative(decoders):
    rng = np.random.default_rng(5)
    base = rng.integers(1, 256, size=(3, 6)).astype(np.int32)
    _, tr = _parity(decoders[1], np.concatenate([base, base], axis=1), 6,
                    paged_decode=True, speculative_k=2, device_sample=True)
    names = {s.name for s in tr.spans}
    assert {"verify", "draft", "dispatch:verify_paged"} <= names


def test_tracer_parity_quantized():
    qm = synthetic_quantized_model(get_smoke_config("qwen3-14b"), seed=0,
                                   device="cpu")
    _parity(CachedDecoder.from_quantized(qm), _prompts(3, 10, 5), 4,
            paged_decode=True)


def test_engine_trace_coverage_lifecycle_and_schema(decoders, tmp_path):
    tr = Tracer(sync=True)
    engine, reqs = _run(decoders[1], _prompts(3, 10, 4), 5, tracer=tr,
                        paged_decode=True, paged_prefill=True)
    pb = phase_breakdown(tr.spans)
    assert pb["root_count"] == engine.stats["steps"]
    assert pb["coverage"] >= 0.95
    events = [s for s in tr.spans if s.instant]
    for kind in ("request_admitted", "first_token", "request_finished"):
        rids = {s.attrs["rid"] for s in events if s.name == kind}
        assert rids == {r.rid for r in reqs}, kind
    path = tmp_path / "engine_trace.json"
    tr.export_chrome_trace(path)
    obj = json.load(open(path))
    assert validate_chrome_trace(obj) == len(tr)
    assert ref_tel.validate_chrome_trace(obj) == len(tr)
    admits = [s for s in events if s.name == "request_admitted"]
    assert all(s.t0 >= 0 for s in admits)
    assert all(s.attrs["queue_s"] >= 0 for s in admits)


def test_engine_native_percentiles_match_external(decoders):
    engine, reqs = _run(decoders[1], _prompts(4, 10, 6), 5,
                        paged_decode=True)
    s = engine.summary()
    done = [r for r in reqs if r.t_first is not None]
    ttft = [r.t_first - r.arrival for r in done]
    itl = [b - a for r in done
           for a, b in zip(r.token_times, r.token_times[1:])]
    e2e = [r.t_finish - r.arrival for r in done]
    for name, ext in (("ttft_s", ttft), ("itl_s", itl), ("e2e_s", e2e)):
        assert s[f"{name}_count"] == len(ext)
        for q in (50, 99):
            assert s[f"{name}_p{q}"] == float(np.percentile(np.asarray(ext),
                                                            q)), name
    json.dumps(s)  # empty histograms are null, never NaN


def test_engine_stats_property_and_clock(decoders):
    engine, reqs = _run(decoders[1], _prompts(2, 8, 7), 3, paged_decode=True)
    stats = engine.stats
    assert stats["steps"] > 0
    assert stats["decode_tokens"] + stats["prefill_tokens"] > 0
    assert all(t > 0 for r in reqs for t in r.token_times)
    assert engine.summary()["last_tick_age_s"] >= 0
    before = engine.now()
    engine.reset_clock()
    assert engine.now() < before
    engine.reset_stats()
    assert engine.stats["steps"] == 0
    assert engine.summary()["ttft_s_count"] == 0


def test_engine_metrics_every_emits_snapshots(decoders, capfd):
    engine = Engine(decoders[1], EngineConfig(
        max_seq_len=11, n_slots=4, page_size=4, token_budget=32,
        prefill_chunk=8, paged_decode=True))
    for i, p in enumerate(_prompts(2, 8, 8)):
        engine.submit(p, max_new=3, arrival=0.01 * i)
    engine.run(metrics_every=1e-6)
    err = capfd.readouterr().err
    assert "[metrics t=" in err and "steps=" in err


# ---------------------------------------------------------------------------
# against the JAX engine: the same span tree on the same schedule
# ---------------------------------------------------------------------------

_PATHS = {
    "paged": dict(paged_decode=True, paged_prefill=True),
    "dense": dict(),
    "spec": dict(paged_decode=True, speculative_k=2, device_sample=True),
}


def _span_tree(tr, rid_index):
    """(name, depth, instant, rid as schedule index) per recorded span."""
    out = []
    for s in tr.spans:
        rid = (s.attrs or {}).get("rid")
        out.append((s.name, s.depth, s.instant,
                    None if rid is None else rid_index[rid]))
    return out


@pytest.mark.parametrize("path", sorted(_PATHS))
def test_span_tree_matches_reference_engine(decoders, path):
    """One traced run of the same tick schedule (with a cancel and a
    quarantined lane) in both packages: the same spans and lifecycle
    events, in the same order, at the same depths, naming the same
    requests; both traces validate under either validator."""
    rng = np.random.default_rng(11)
    spans = rng.integers(1, 256, size=(4, 5)).astype(np.int32)
    prompts = np.concatenate([spans, spans], axis=1)
    schedule = [(t, dict(prompt=p, max_new=6))
                for t, p in zip((0, 0, 1, 3), prompts)]
    trees, objs = [], []
    for eng_cls, cfg_cls, tr_cls, rule_cls, adapter in (
            (RefEngine, RefEngineConfig, ref_tel.Tracer, RefFaultRule,
             decoders[0]),
            (Engine, EngineConfig, Tracer, FaultRule, decoders[1])):
        tr = tr_cls()
        eng = eng_cls(adapter, cfg_cls(
            max_seq_len=16, n_slots=3, page_size=4, token_budget=16,
            prefill_chunk=8, screen_logits=True, **_PATHS[path]),
            tracer=tr)

        def arm(engine, run, rule_cls=rule_cls):
            engine.faults.rules += [
                rule_cls(kind="cancel", rid=run.reqs[1].rid, tick=3),
                rule_cls(kind="nan_logits", rid=run.reqs[2].rid, tick=3)]

        run = drive_ticks(eng, schedule, events={1: arm})
        index = {r.rid: i for i, r in run.reqs.items()}
        trees.append(_span_tree(tr, index))
        objs.append({"traceEvents": tr.chrome_events()})
        assert run.reqs[1].finish_reason == "cancelled"
        assert run.reqs[2].finish_reason == "nan_logits"
    assert trees[1] == trees[0]
    for obj in objs:
        assert validate_chrome_trace(obj) == ref_tel.validate_chrome_trace(obj)
