"""The port's tensor-parallel engine on fp weights, held against the JAX
package's single-device engine and the port's on the CPU: the sharded
page pool, token parity on every engine path, tracing, canaries, faults
and the ``--mesh`` CLI.

Each engine case runs the three engines of ``torch_parity.three_engines``
on one tick schedule (streams identical, logits within its tolerance);
one (1, 2) mesh of gloo processes serves the module.
"""
from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch
from torch_parity import (
    drive_ticks,
    run_tokens,
    smoke_prompts,
    three_engines,
    tp_drive,
    tp_knobs,
)

from repro.configs import get_smoke_config as ref_smoke
from repro.models import build_model
from repro.serve import CachedDecoder as RefDecoder
from repro.serve import Engine as RefEngine
from repro.serve import EngineConfig as RefEngineConfig
from repro_torch import convert
from repro_torch.configs import ArchConfig
from repro_torch.launch import serve as port_serve
from repro_torch.serve.adapter import CachedDecoder
from repro_torch.serve.distributed import (
    DistributedCachedDecoder,
    make_serving_mesh,
    pool_tensors,
)
from repro_torch.serve.engine import Engine, EngineConfig

# pool contents after a run, TP against single device (fp32; the K/V of
# layer 1 inherit the row-parallel sums' rounding; read ~1e-7)
POOL_ATOL = 1e-5
# canary NLL (float64 over fp32 logits): TP against single device, and
# against the JAX package's as tests/test_torch_quality.py
NLL_ATOL, REF_NLL_ATOL = 1e-5, 1e-4


@pytest.fixture(scope="module")
def mesh():
    m = make_serving_mesh(1, 2, device="cpu")
    yield m
    m.close()


@pytest.fixture(scope="module")
def smoke():
    cfg = ref_smoke("qwen3-14b")
    return cfg, build_model(cfg)


def _adapters(smoke, mesh, key: int = 0):
    """(JAX single-device, port single-device, port TP) adapters over the
    fp params of ``PRNGKey(key)``."""
    cfg, model = smoke
    params = model.init(jax.random.PRNGKey(key))
    pcfg = ArchConfig.from_dict(dataclasses.asdict(cfg))
    pp = convert.fp_params_from_numpy(jax.tree.map(np.asarray, params),
                                      device="cpu")
    return (RefDecoder.from_model(model, params),
            CachedDecoder.from_model(pcfg, pp),
            DistributedCachedDecoder.from_model(pcfg, pp, mesh=mesh))


# ---------------------------------------------------------------------------
# the sharded page pool
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [None, torch.int8])
def test_sharded_pool_accounting_and_roundtrip(mesh, smoke, dtype):
    """The TP pool keeps the single-device pool's host decisions, holds
    half the KV heads on each rank (device_bytes == total/2), and a write
    of every head round-trips bit for bit."""
    _, plain, dist = _adapters(smoke, mesh)
    kw = dict(n_pages=9, page_size=4, n_slots=3, max_pages_per_seq=4,
              dtype=dtype)
    p0, p1 = plain.make_pool(**kw), dist.make_pool(**kw)
    assert p1.total_bytes() == p0.total_bytes()
    assert p1.device_bytes() == p0.total_bytes() // 2
    assert p1.k.shape[3] * 2 == p0.k.shape[3]
    for pool in (p0, p1):
        a, b = pool.admit(5), pool.admit(9)
        assert (a, b) == (0, 1)
        assert pool.extend(a, 8) and not pool.extend(b, 17)
        pool.release(b)
        assert pool.pages_in_use == 2
    cfg = plain.cfg
    k = torch.randn((cfg.n_layers, 6, cfg.n_kv_heads, cfg.head_dim),
                    generator=torch.Generator().manual_seed(2))
    for pool in (p0, p1):
        pool.write_span(0, 0, 6, k, -k)
    for got, want in zip(pool_tensors(p1), p0._storage()):
        assert torch.equal(got, want)
    for a, b in zip(p0.gather([0]), p1.gather([0])):  # rank 0's own heads
        assert torch.equal(a[..., : cfg.n_kv_heads // 2, :], b)


def test_sharded_pool_bytes_after_prefix_cache_and_eviction(mesh, smoke):
    """Every device-side pool step the host makes outside a dispatch —
    copy-on-admit and copy-on-write page copies, gathers and the
    gather-dense prefill's writes — reaches the worker: after a run with
    the prefix cache under eviction, every rank's pages hold what the
    single-device pool holds."""
    _, port_a, tp_a = _adapters(smoke, mesh)
    prompts = np.concatenate([np.tile(smoke_prompts(1, 8, 5), (3, 1)),
                              smoke_prompts(2, 8, 6)])
    kw = dict(n_slots=3, n_pages=9, prefix_cache=True, arrive=[0, 1, 2, 3, 3])
    e0, r0 = tp_drive(port_a, Engine, EngineConfig, prompts, 8, **kw)
    e1, r1 = tp_drive(tp_a, Engine, EngineConfig, prompts, 8, **kw)
    assert run_tokens(r1) == run_tokens(r0)
    s0, s1 = e0.summary(), e1.summary()
    assert s1["evictions"] == s0["evictions"] > 0
    assert s1["cow_copies"] == s0["cow_copies"] >= 1
    assert s1["prefix_hit_tokens"] == s0["prefix_hit_tokens"] > 0
    assert np.array_equal(e1.pool._page_ref, e0.pool._page_ref)
    for got, want in zip(pool_tensors(e1.pool), e0.pool._storage()):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=POOL_ATOL)


# ---------------------------------------------------------------------------
# token parity on every engine path
# ---------------------------------------------------------------------------


def test_tp_engine_fp_token_parity(mesh, smoke):
    eng, _ = three_engines(_adapters(smoke, mesh), smoke_prompts(3, 10, 3),
                           6)
    assert eng.pool.device_bytes() * 2 == eng.pool.total_bytes()


def test_tp_engine_int8_pages_token_parity(mesh, smoke):
    three_engines(_adapters(smoke, mesh), smoke_prompts(3, 9, 8), 5,
                  kv_int8=True)


def test_tp_engine_eviction_token_parity(mesh, smoke):
    """Eviction and requeue (host scheduling over the sharded pool) and
    re-prefill keep exact tokens."""
    eng, _ = three_engines(_adapters(smoke, mesh, key=1),
                           smoke_prompts(3, 8, 4), 8, n_slots=3, n_pages=10)
    assert eng.stats["evictions"] > 0


def test_tp_engine_batched_prefill_token_parity(mesh, smoke):
    eng, _ = three_engines(_adapters(smoke, mesh), smoke_prompts(3, 10, 3),
                           6, paged_prefill=True)
    assert eng.stats["prefill_batches"] > 0


def test_tp_engine_batched_prefill_int8_token_parity(mesh, smoke):
    three_engines(_adapters(smoke, mesh), smoke_prompts(3, 9, 8), 5,
                  paged_prefill=True, kv_int8=True)


def test_tp_engine_prefix_cache_token_parity(mesh, smoke):
    """Prefix-cache hits over the sharded pool: the copy-on-admit page
    copy runs on every rank."""
    prompts = np.tile(smoke_prompts(1, 8, 5), (3, 1))  # 8 tokens, 2 pages
    eng, _ = three_engines(_adapters(smoke, mesh), prompts, 5,
                           arrive=[0, 1, 2], paged_prefill=True,
                           prefix_cache=True)
    s = eng.summary()
    assert s["prefix_hit_tokens"] > 0 and s["cow_copies"] >= 1


def test_tp_engine_speculative_token_parity(mesh, smoke):
    """Draft-and-verify with the verifier over each rank's KV heads."""
    prompts = np.tile(np.asarray([7, 91, 33, 150], np.int32), (3, 8))
    eng, _ = three_engines(_adapters(smoke, mesh), prompts, 10,
                           speculative_k=4, device_sample=True)
    assert eng.summary()["accepted_tokens"] > 0


def test_tp_engine_speculative_int8_token_parity(mesh, smoke):
    prompts = np.tile(np.asarray([7, 91, 33, 150], np.int32), (3, 8))
    three_engines(_adapters(smoke, mesh), prompts, 8, speculative_k=4,
                  device_sample=True, kv_int8=True)


def test_tp_engine_device_sampled_stream_parity(mesh, smoke):
    """The device draw is layout-independent: the TP engine draws the
    sampled stream of both single-device engines."""
    from repro.serve.scheduler import SamplingParams as RefSampling
    from repro_torch.serve.scheduler import SamplingParams

    prompts = smoke_prompts(3, 8, 2)
    ref_a, port_a, tp_a = _adapters(smoke, mesh)
    knobs = dict(temperature=0.8, top_p=0.9, seed=23)
    _, ref = tp_drive(ref_a, RefEngine, RefEngineConfig, prompts, 6,
                      sampling=RefSampling(**knobs), device_sample=True)
    streams = [run_tokens(tp_drive(a, Engine, EngineConfig, prompts, 6,
                                   sampling=SamplingParams(**knobs),
                                   device_sample=True)[1])
               for a in (port_a, tp_a)]
    assert streams[1] == streams[0] == run_tokens(ref)


# ---------------------------------------------------------------------------
# telemetry and quality
# ---------------------------------------------------------------------------


def test_tp_engine_traced_token_parity_and_mesh_tags(mesh, smoke, tmp_path):
    """A sync tracer on the TP engine leaves the stream alone, and every
    exported span carries the mesh tags."""
    from repro_torch.serve.telemetry import (
        Tracer,
        phase_breakdown,
        validate_chrome_trace,
    )

    prompts = smoke_prompts(3, 10, 9)
    ref_a, _, tp_a = _adapters(smoke, mesh)
    _, ref = tp_drive(ref_a, RefEngine, RefEngineConfig, prompts, 5)
    tracer = Tracer(sync=True)
    eng = Engine(tp_a, EngineConfig(**tp_knobs(prompts, 5)), tracer=tracer)
    got = drive_ticks(eng, [(0, dict(prompt=np.asarray(p), max_new=5))
                            for p in prompts])
    assert run_tokens(got) == run_tokens(ref)
    assert tracer.tags["mesh_model"] == 2
    assert tracer.tags["mesh_data"] == 1
    assert tracer.tags["mesh_devices"] == 2
    assert tracer.tags["pool_sharded"] is True
    obj = tracer.export_chrome_trace(tmp_path / "tp_trace.json")
    validate_chrome_trace(obj)
    spans = [e for e in obj["traceEvents"] if e.get("ph") == "X"]
    assert spans and all(e["args"]["mesh_model"] == 2 for e in spans)
    assert phase_breakdown(tracer.spans)["coverage"] >= 0.95


def test_tp_canary_nll_matches_single_device(mesh, smoke):
    """The teacher-forced canary probe over the sharded trunk scores what
    the single-device trunks score."""
    from repro.serve.quality import teacher_forced_nll as ref_nll
    from repro_torch.serve.quality import teacher_forced_nll

    ref_a, port_a, tp_a = _adapters(smoke, mesh)
    canary = smoke_prompts(2, 12, 99)
    sharded = teacher_forced_nll(tp_a, canary)
    assert abs(sharded - teacher_forced_nll(port_a, canary)) < NLL_ATOL
    assert abs(sharded - ref_nll(ref_a, canary)) < REF_NLL_ATOL


def test_tp_engine_canary_gauge_matches_offline(mesh, smoke):
    """A TP engine's canary gauge equals the offline NLL through the same
    sharded adapter, bit for bit."""
    from repro_torch.serve.quality import teacher_forced_nll

    _, _, tp_a = _adapters(smoke, mesh)
    canary, prompts = smoke_prompts(2, 12, 99), smoke_prompts(2, 8, 3)
    eng = Engine(tp_a, EngineConfig(**tp_knobs(prompts, 3,
                                               canary_every=1e-4)))
    eng.attach_canary(canary)
    for p in prompts:
        eng.submit(np.asarray(p), max_new=3)
    eng.run()
    s = eng.summary()
    assert s["canary_runs"] >= 1
    assert s["canary_nll"] == teacher_forced_nll(tp_a, canary)


# ---------------------------------------------------------------------------
# faults and the CLI
# ---------------------------------------------------------------------------


def test_tp_engine_fault_quarantine(mesh, smoke):
    """Cancel and NaN quarantine on a 2-rank mesh (the fault hooks run on
    rank 0 only): survivors equal the JAX single-device engine's fault-free
    streams (tests/test_chaos.py::test_tp_engine_fault_quarantine)."""
    from repro_torch.serve.faults import FaultPlan, FaultRule
    from repro_torch.serve.scheduler import RequestState

    prompts, gen = smoke_prompts(4, 10, 3), 8
    ref_a, _, tp_a = _adapters(smoke, mesh)
    knobs = dict(max_seq_len=24, n_slots=4, page_size=4, token_budget=32,
                 prefill_chunk=8, paged_decode=True)
    ref = RefEngine(ref_a, RefEngineConfig(**knobs))
    base = [ref.submit(np.asarray(p), max_new=gen) for p in prompts]
    ref.run()
    baseline = [list(map(int, r.out_tokens)) for r in base]
    plan = FaultPlan()
    eng = Engine(tp_a, EngineConfig(**knobs, screen_logits=True),
                 faults=plan)
    reqs = [eng.submit(np.asarray(p), max_new=gen) for p in prompts]
    plan.rules.append(FaultRule(kind="nan_logits", rid=reqs[1].rid))
    plan.rules.append(FaultRule(kind="cancel", rid=reqs[3].rid, tick=7))
    eng.run()
    assert reqs[1].state is RequestState.FAILED
    assert reqs[1].finish_reason == "nan_logits"
    assert reqs[3].state is RequestState.CANCELLED
    assert list(reqs[3].out_tokens) == baseline[3][: len(reqs[3].out_tokens)]
    for i in (0, 2):
        assert list(reqs[i].out_tokens) == baseline[i]
    pool = eng.pool
    assert not pool._slots and pool.pages_in_use == pool.cached_pages


@pytest.mark.parametrize("flags,shards", [
    (["--mesh", "1,2", "--paged", "--paged-prefill"], 2),
    (["--mesh", "1,2", "--paged", "--kv-int8", "--arrival-gap", "0"], 2),
    (["--mesh", "1,4", "--paged"], 1),
])
def test_serve_cli_mesh_check(flags, shards, capsys):
    """``--mesh DP,MP --check`` end to end: rank 0 starts the others, the
    streams pass the oracle (``--kv-int8``: the single-device gather-dense
    int8 engine), and the pool line reports the split (at MP 4 the smoke
    config's 2 KV heads leave it whole: the divisibility fallback)."""
    rc = port_serve.main(["--device", "cpu", "--smoke", "--requests", "4",
                          "--check", *flags])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "token agreement 100.00%" in out
    line = next(ln for ln in out.splitlines() if "KV pool" in ln)
    total, per = (int(w) for w in line.split() if w.isdigit())
    assert total == per * shards


def test_serve_cli_mesh_parse_errors():
    with pytest.raises(SystemExit, match="--mesh expects DP,MP"):
        port_serve.main(["--device", "cpu", "--smoke", "--mesh", "2"])
    with pytest.raises(SystemExit, match="--mesh: mesh 0x2"):
        port_serve.main(["--device", "cpu", "--smoke", "--mesh", "0,2"])


def test_failed_rank_ends_the_run(smoke):
    """A rank that dies ends rank 0's next step with an error (never a
    hang), and the mesh stays broken: every later step raises."""
    with make_serving_mesh(1, 2, device="cpu") as mesh2:
        _, _, tp_a = _adapters(smoke, mesh2)
        prompts = smoke_prompts(2, 8, 3)
        eng = Engine(tp_a, EngineConfig(**tp_knobs(prompts, 4)))
        for p in prompts:
            eng.submit(np.asarray(p), max_new=4)
        mesh2.procs[0].kill()
        mesh2.procs[0].wait()
        with pytest.raises(RuntimeError, match="rank 1 exited"):
            eng.run()
        with pytest.raises(RuntimeError, match="broken"):
            tp_a.make_pool(n_pages=4, page_size=4, n_slots=1,
                           max_pages_per_seq=2)
