"""Refcounting frees a served engine: with the cyclic collector off, an
engine, its KV pool and its adapter are gone right after ``del``.

The engine holds its metrics registry and its tracer; their callbacks
(gauges, the tracer's clock and barrier) reach the engine and the pool
through weak references, so no reference cycle keeps the card's memory
(pool pages, the adapter's weights) until ``gc.collect()`` runs.  Four
cases: a plain run; a traced run with canaries and a shadow sampler; a
fault plan; a front door that served a request and drained.
"""
from __future__ import annotations

import gc
import json
import urllib.request
import weakref

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.models.lm import build_model
from repro_torch.serve.adapter import CachedDecoder
from repro_torch.serve.engine import Engine, EngineConfig
from repro_torch.serve.faults import parse_fault_plan
from repro_torch.serve.telemetry import MetricsRegistry, Tracer, weak_gauge

CFG = get_smoke_config("qwen3-14b")
KNOBS = dict(n_slots=4, page_size=4, token_budget=32, prefill_chunk=8,
             paged_decode=True, paged_prefill=True, max_seq_len=24)


@pytest.fixture(scope="module")
def params():
    return build_model(CFG).init(torch.Generator().manual_seed(0),
                                 device="cpu")


def _served(params, case: str) -> Engine:
    adapter = CachedDecoder.from_model(CFG, params)
    knobs, kw = dict(KNOBS), {}
    if case == "observe":
        knobs.update(shadow_rate=1.0, canary_every=0.01, record_logits=True)
        kw["tracer"] = Tracer(sync=True)
    elif case == "faults":
        knobs.update(screen_logits=True)
        kw["faults"] = parse_fault_plan("alloc_fail@tick=2;nan_logits@tick=3")
    engine = Engine(adapter, EngineConfig(**knobs), **kw)
    if case == "observe":
        engine.attach_canary(np.arange(8, dtype=np.int32)[None])
    if case == "frontdoor":
        from repro_torch.serve.frontdoor.server import FrontDoor

        fd = FrontDoor(engine).start_in_thread()
        body = json.dumps({"prompt": [1, 2, 3, 4], "max_new": 4,
                           "stream": False}).encode()
        req = urllib.request.Request(
            f"http://127.0.0.1:{fd.port}/v1/generate", data=body,
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            assert json.loads(r.read())["n_tokens"] == 4
        assert fd.drain_and_join(timeout=60).clean
        return engine
    rng = np.random.default_rng(0)
    for _ in range(3):
        engine.submit(rng.integers(0, CFG.vocab, 12), max_new=6)
    engine.run()
    assert len(engine.finished) == 3
    if case == "observe":
        assert len(engine.tracer) and engine.metrics.snapshot()[
            "shadow_samples"] == 3
    if case == "faults":
        assert engine.faults.log
    return engine


@pytest.mark.parametrize("case", ["plain", "observe", "faults", "frontdoor"])
def test_del_frees_engine_pool_and_adapter_without_gc(params, case):
    gc.collect()
    gc.disable()
    try:
        engine = _served(params, case)
        refs = {"engine": weakref.ref(engine),
                "pool": weakref.ref(engine.pool),
                "adapter": weakref.ref(engine.adapter)}
        del engine
        alive = sorted(k for k, r in refs.items() if r() is not None)
        assert alive == [], f"still held after del: {alive}"
    finally:
        gc.enable()


def test_gauges_of_a_dead_owner_read_none(params):
    """A registry that outlives its engine reports None for the engine's
    and the pool's callback gauges; counters keep their values."""
    gc.disable()
    try:
        engine = _served(params, "plain")
        metrics = engine.metrics
        assert metrics.snapshot()["finished"] == 3
        del engine
        snap = metrics.snapshot()
    finally:
        gc.enable()
    for name in ("finished", "faults_injected", "last_tick_age_s",
                 "pages_in_use", "peak_occupancy", "cached_pages"):
        assert snap[name] is None, name
    assert snap["steps"] > 0


def test_weak_gauge_reads_its_owner_while_it_lives():
    class Owner:
        n = 7

    owner, reg = Owner(), MetricsRegistry()
    reg.gauge("n", fn=weak_gauge(owner, lambda o: o.n))
    assert reg.snapshot()["n"] == 7
    owner.n = 9
    assert reg.snapshot()["n"] == 9
    del owner
    assert reg.snapshot()["n"] is None
