"""Port parity: quantization-quality observability
(``repro_torch/serve/quality.py``, ``launch/quality_report.py``),
mirroring ``tests/test_quality.py``.

Held to the JAX package on the same inputs: the quality section and its
baselines (identical regression records, identical report text), shadow
selection (identical for rids 0..999 at three rates), and the canary
probe on the same weights and tokens — NLL within ``NLL_ATOL`` and
per-layer activation absmax within ``ABSMAX_RTOL`` of the JAX
``canary_probe`` (float32 forwards that sum in different orders), with
saturation fractions equal.  Inside the port the online canary gauge
equals the offline teacher-forced NLL bit for bit, canaries never touch
the pool, and the fp gather-dense engine shows zero shadow flips.
"""
from __future__ import annotations

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch
from conftest import make_hessian, make_weights
from torch_parity import fp_decoders, quantized_tree_numpy

from repro.data import make_calibration as ref_calibration
from repro.launch import quality_report as ref_report
from repro.serve import quality as ref_quality
from repro_torch import convert
from repro_torch.core.quantizer import QuipConfig, quantize_layer
from repro_torch.launch import quality_report
from repro_torch.launch import serve as port_serve
from repro_torch.serve.adapter import CachedDecoder
from repro_torch.serve.engine import Engine, EngineConfig
from repro_torch.serve.quality import (
    ShadowSampler,
    build_quality_section,
    canary_probe,
    check_artifact_quality,
    load_baseline,
    teacher_forced_nll,
    write_baseline,
)
from repro_torch.serve.scheduler import Request

# canary NLL (nats) and per-layer activation absmax (relative) against the
# JAX probe on the same weights and tokens: float32 forwards of the smoke
# model that sum in different orders read at most 2.5e-7 and 2.7e-7 apart
# on the fp model; the tolerances leave room for the 2-bit one
NLL_ATOL = 1e-4
ABSMAX_RTOL = 1e-4


@pytest.fixture(scope="module")
def decoders():
    return fp_decoders(seed=0)


def _tokens(n, seg_len, seed):
    return np.asarray(ref_calibration(256, n_segments=n, seg_len=seg_len,
                                      seed=seed).tokens, np.int32)


# ---------------------------------------------------------------------------
# quantize-time quality reports
# ---------------------------------------------------------------------------


def _t(x):
    return torch.tensor(np.array(x), dtype=torch.float32)


def test_quality_report_fields_sane():
    W, H = _t(make_weights(64, 128, seed=3)), _t(make_hessian(128, seed=3))
    _, st = quantize_layer(W, H, QuipConfig(bits=2, method="ldlq"), seed=0)
    for key in ("proxy_loss", "proxy_rel", "frob_rel_err", "max_abs_err",
                "mu_w_pre", "mu_w_post", "mu_h_pre", "mu_h_post",
                "h_lambda_min", "h_lambda_max", "h_cond", "wall_s"):
        assert key in st, key
        assert np.isfinite(st[key]), key
    assert st["proxy_loss"] > 0
    assert 0 < st["proxy_rel"] < 1
    assert st["h_lambda_max"] >= st["h_lambda_min"] > 0
    assert st["h_cond"] == pytest.approx(
        st["h_lambda_max"] / st["h_lambda_min"], rel=1e-6)
    assert st["mu_w_pre"] >= 1.0 and st["mu_w_post"] >= 1.0
    assert st["mu_h_pre"] >= 1.0 and st["mu_h_post"] >= 1.0
    assert st["wall_s"] > 0
    assert (st["m"], st["n"]) == tuple(W.shape)
    assert st["bits"] == 2 and "ldlq" in st["method"]


def test_incoherence_improves_proxy_in_expectation():
    deltas = []
    for seed in range(5):
        W = _t(make_weights(16, 16, seed=seed))
        H = _t(make_hessian(16, seed=seed, tokens=256))
        _, st_on = quantize_layer(
            W, H, QuipConfig(bits=2, method="ldlq", incoherence=True),
            seed=seed)
        _, st_off = quantize_layer(
            W, H, QuipConfig(bits=2, method="ldlq", incoherence=False),
            seed=seed)
        deltas.append(st_off["proxy_loss"] - st_on["proxy_loss"])
        assert st_on["mu_w_post"] < 100
    assert np.mean(deltas) > 0, deltas


# ---------------------------------------------------------------------------
# quality manifest + baselines
# ---------------------------------------------------------------------------


def _fake_stats(n_blocks=2, ploss=1.0):
    st = {
        "proxy_loss": ploss, "proxy_rel": 0.1, "frob_rel_err": 0.5,
        "max_abs_err": 0.2, "s": 1.0, "mu_w_pre": 4.0, "mu_w_post": 3.5,
        "mu_h_pre": 4.0, "mu_h_post": 3.6, "h_lambda_min": 1e-3,
        "h_lambda_max": 10.0, "h_cond": 1e4, "m": 8, "n": 8, "bits": 2,
        "method": "ldlq+incp@2b", "wall_s": 0.1,
    }
    return [{"attn.wq": dict(st), "mlp.wi": dict(st)}
            for _ in range(n_blocks)]


def test_quality_section_and_baseline_roundtrip(tmp_path):
    quality = build_quality_section(_fake_stats())
    assert quality == ref_quality.build_quality_section(_fake_stats())
    assert set(quality["layers"]) == {
        "0/attn.wq", "0/mlp.wi", "1/attn.wq", "1/mlp.wi"}
    assert quality["aggregate"]["total_proxy_loss"] == pytest.approx(4.0)
    path = tmp_path / "base.json"
    write_baseline(path, quality, source="test")
    base = load_baseline(path)
    assert base == ref_quality.load_baseline(path)
    assert base["kind"] == "quip_quality_baseline"
    assert check_artifact_quality(quality, base, threshold=1.2) == []
    worse = build_quality_section(_fake_stats())
    worse["layers"]["1/mlp.wi"]["proxy_loss"] = 1.5
    regs = check_artifact_quality(worse, base, threshold=1.2)
    assert [r["layer"] for r in regs] == ["1/mlp.wi"]
    assert regs[0]["reason"] == "proxy_loss"
    assert regs[0]["ratio"] == pytest.approx(1.5)
    partial = build_quality_section(_fake_stats())
    del partial["layers"]["0/attn.wq"]
    assert [r["reason"] for r in check_artifact_quality(partial, base)] == [
        "missing_layer"]


def _scenario(name):
    quality = build_quality_section(_fake_stats(n_blocks=3))
    layers = quality["layers"]
    if name == "worse":
        layers["1/mlp.wi"]["proxy_loss"] = 1.5
        layers["2/attn.wq"]["proxy_loss"] = 1.19
    elif name == "missing":
        del layers["0/attn.wq"], layers["2/mlp.wi"]
    elif name == "zero_base":
        layers["0/mlp.wi"]["proxy_loss"] = 3.0
    elif name == "halved":
        for st in layers.values():
            st["proxy_loss"] = 2.0
    return quality


@pytest.mark.parametrize("name", ["same", "worse", "missing", "zero_base",
                                  "halved"])
@pytest.mark.parametrize("threshold", [1.0, 1.2, 2.5])
def test_check_artifact_quality_equals_reference(name, threshold):
    baseline = {"kind": "quip_quality_baseline", "format": 1,
                "proxy_loss": {k: (0.0 if name == "zero_base"
                                   and k == "0/mlp.wi" else 1.0)
                               for k in _scenario("same")["layers"]}}
    got = check_artifact_quality(_scenario(name), baseline,
                                 threshold=threshold)
    assert got == ref_quality.check_artifact_quality(
        _scenario(name), baseline, threshold=threshold)


def test_pre_quality_manifest_warns_and_compares_clean(tmp_path):
    path = tmp_path / "base.json"
    write_baseline(path, build_quality_section(_fake_stats()))
    base = load_baseline(path)
    for legacy in (None, {}):
        with pytest.warns(UserWarning, match="no quality section"):
            assert check_artifact_quality(legacy, base) == []
    with pytest.raises(ValueError, match="threshold"):
        check_artifact_quality({"layers": {}}, base, threshold=0)


def test_load_baseline_rejects_wrong_kind(tmp_path):
    path = tmp_path / "not_base.json"
    path.write_text('{"kind": "something_else"}')
    with pytest.raises(ValueError, match="not a quality baseline"):
        load_baseline(path)


@pytest.fixture(scope="module")
def port_artifact(tmp_path_factory):
    """A port artifact written by the port's quantizer at the smoke config,
    with its quality section (``launch/quantize.py --out-dir``)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data.synthetic import make_calibration
    from repro_torch.launch.quantize import quantize_dense_model
    from repro_torch.models.transformer import init_decoder
    from repro_torch.serve.artifacts import save_quantized

    cfg = get_smoke_config("qwen3-14b")
    g = torch.Generator().manual_seed(0)
    params = init_decoder(cfg, g, device="cpu")
    calib = make_calibration(cfg.vocab, n_segments=2, seg_len=16, seed=7)
    qcfg = QuipConfig(bits=2, method="ldlq", use_kernel=False)
    qm = quantize_dense_model(params, cfg, qcfg, calib, seed=0,
                              verbose=False)
    quality = build_quality_section(qm.stats)
    path = tmp_path_factory.mktemp("q") / "art"
    save_quantized(path, qm, qcfg, extra_meta={"quality": quality})
    return path, quality


def test_artifact_manifest_carries_quality_section(port_artifact):
    path, quality = port_artifact
    meta = quality_report.load_manifest(path)
    assert meta["quality"]["aggregate"]["n_layers"] == len(quality["layers"])
    assert meta["quality"] == quality  # JSON round-trip is exact
    assert ref_report.load_manifest(path) == meta


def test_render_quality_equals_reference(port_artifact):
    _, quality = port_artifact
    text = quality_report.render_quality(quality)
    assert text == ref_report.render_quality(quality)
    assert text.splitlines()[0].split()[:3] == ["layer", "proxy",
                                                "proxy_rel"]


def test_quality_report_cli_baseline_roundtrip(port_artifact, tmp_path,
                                               capsys):
    """``--write-baseline`` then ``--baseline``: clean against itself,
    every layer regressed against a baseline with the losses halved; the
    serve CLI's ``--quality-strict`` passes and refuses alike."""
    path, quality = port_artifact
    base = tmp_path / "base.json"
    assert quality_report.main([str(path), "--write-baseline",
                                str(base)]) == 0
    out = capsys.readouterr().out
    assert quality_report.render_quality(quality) in out
    assert quality_report.main([str(path), "--baseline", str(base)]) == 0
    assert "[quality] OK" in capsys.readouterr().out
    obj = load_baseline(base)
    obj["proxy_loss"] = {k: v / 2 for k, v in obj["proxy_loss"].items()}
    halved = tmp_path / "halved.json"
    halved.write_text(json.dumps(obj))
    n = len(obj["proxy_loss"])
    assert quality_report.main([str(path), "--baseline", str(halved)]) == n
    assert capsys.readouterr().out.count("REGRESSION") == n

    serve = ["--device", "cpu", "--load-quantized", str(path), "--paged",
             "--requests", "2", "--gen", "2", "--quality-strict"]
    assert port_serve.main([*serve, "--quality-baseline", str(base)]) == 0
    assert f"quality baseline OK ({n} layers" in capsys.readouterr().out
    with pytest.raises(SystemExit, match=f"refusing to serve: {n} layer"):
        port_serve.main([*serve, "--quality-baseline", str(halved)])


# ---------------------------------------------------------------------------
# serve-time canaries
# ---------------------------------------------------------------------------


def _canary_engine(adapter, prompts, gen, **kw):
    return Engine(adapter, EngineConfig(
        max_seq_len=prompts.shape[1] + gen, n_slots=4, page_size=4,
        token_budget=32, prefill_chunk=8, **kw))


def test_canary_gauge_equals_offline_nll_fp(decoders):
    """The online canary gauge IS the offline teacher-forced value:
    equality, not a tolerance."""
    adapter = decoders[1]
    canary = _tokens(2, 12, 99)
    prompts = _tokens(3, 10, 3)
    engine = _canary_engine(adapter, prompts, 4, canary_every=1e-4)
    engine.attach_canary(canary)
    for p in prompts:
        engine.submit(p, max_new=4)
    engine.run()
    s = engine.summary()
    assert s["canary_runs"] >= 1
    assert s["canary_nll"] == teacher_forced_nll(adapter, canary)
    assert s["act_absmax"] > 0
    assert 0.0 <= s["act_sat"] <= 1.0
    for i in range(adapter.cfg.n_layers + 1):
        assert f"act_absmax:{i}" in s


@pytest.fixture(scope="module")
def quantized_decoders():
    from repro.configs import get_smoke_config
    from repro.launch.quantize import quantize_dense_model
    from repro.models import build_model
    from repro.core.quantizer import QuipConfig as RefQuipConfig
    from repro.serve import CachedDecoder as RefDecoder

    cfg = get_smoke_config("qwen3-14b")
    params = build_model(cfg).init(jax.random.PRNGKey(0))
    calib = ref_calibration(cfg.vocab, n_segments=2, seg_len=16, seed=7)
    qm = quantize_dense_model(
        params, cfg, RefQuipConfig(bits=2, method="ldlq", use_kernel=False),
        calib.tokens, seed=0, verbose=False)
    port_qm = convert.quantized_model_from_numpy(
        dataclasses.asdict(cfg), quantized_tree_numpy(qm), device="cpu")
    return RefDecoder.from_quantized(qm), port_qm


def test_canary_gauge_equals_offline_nll_quantized(quantized_decoders):
    _, qm = quantized_decoders
    canary = _tokens(2, 12, 99)
    prompts = _tokens(2, 8, 3)
    engine = _canary_engine(CachedDecoder.from_quantized(qm), prompts, 3,
                            canary_every=1e-4)
    engine.attach_canary(canary)
    for p in prompts:
        engine.submit(p, max_new=3)
    engine.run()
    offline = teacher_forced_nll(CachedDecoder.from_quantized(qm), canary)
    assert engine.summary()["canary_nll"] == offline


@pytest.mark.parametrize("weights", ["fp", "quantized"])
@pytest.mark.parametrize("shape", [(2, 12), (3, 16), (1, 9)])
def test_canary_probe_matches_reference(decoders, quantized_decoders,
                                        weights, shape):
    """The port's canary probe against the JAX ``canary_probe`` on the same
    weights and tokens (padded to a power of two alike)."""
    if weights == "fp":
        ref, port = decoders
    else:
        ref, port = (quantized_decoders[0],
                     CachedDecoder.from_quantized(quantized_decoders[1]))
    tokens = _tokens(*shape, seed=sum(shape))
    nll, act = canary_probe(port, tokens)
    rnll, ract = ref_quality.canary_probe(ref, tokens)
    assert abs(nll - rnll) <= NLL_ATOL
    np.testing.assert_allclose(act["absmax"], ract["absmax"],
                               rtol=ABSMAX_RTOL)
    np.testing.assert_array_equal(act["sat"], ract["sat"])
    assert act["absmax"].shape == (port.cfg.n_layers + 1,)


def test_canary_is_out_of_band(decoders):
    """Tokens with canaries on equal tokens with canaries off, and the
    probes never touch the pool."""
    adapter = decoders[1]
    prompts = _tokens(3, 10, 3)
    outs = []
    for canary_every in (None, 1e-4):
        engine = _canary_engine(adapter, prompts, 5,
                                canary_every=canary_every)
        if canary_every is not None:
            engine.attach_canary(_tokens(2, 12, 99))
        reqs = [engine.submit(p, max_new=5) for p in prompts]
        engine.run()
        assert engine.pool.pages_in_use == 0
        outs.append([tuple(r.out_tokens) for r in reqs])
    assert outs[0] == outs[1]


def test_canary_requires_attach_and_validates(decoders):
    adapter = decoders[1]
    with pytest.raises(ValueError, match="canary_every"):
        _canary_engine(adapter, np.zeros((1, 8), np.int32), 2,
                       canary_every=-1.0)
    engine = _canary_engine(adapter, np.zeros((1, 8), np.int32), 2)
    with pytest.raises(ValueError, match="canary set"):
        engine.attach_canary(np.zeros((2, 1), np.int32))  # S < 2


# ---------------------------------------------------------------------------
# shadow drift sampling
# ---------------------------------------------------------------------------


def test_shadow_zero_flips_fp_engine(decoders):
    """Gather-dense fp engine: the serving forward is the oracle trunk, so
    drift sampling at rate 1.0 sees no token flip."""
    prompts = _tokens(3, 10, 3)
    engine = _canary_engine(decoders[1], prompts, 5, shadow_rate=1.0)
    reqs = [engine.submit(p, max_new=5) for p in prompts]
    engine.run()
    s = engine.summary()
    assert all(r.shadow for r in reqs)
    assert s["shadow_samples"] == len(reqs)
    assert s["shadow_tokens"] == sum(len(r.out_tokens) for r in reqs)
    assert s["shadow_token_flips"] == 0
    assert s["shadow_flip_rate_p99"] == 0.0
    assert all(len(r.step_logits) == len(r.out_tokens) for r in reqs)


def test_shadow_keeps_logits_of_sampled_requests_only(decoders):
    """At a fractional rate only the selected requests keep their emission
    logits (no --check), and each selected one is re-scored."""
    prompts = _tokens(8, 10, 4)
    engine = _canary_engine(decoders[1], prompts, 3, shadow_rate=0.5,
                            paged_decode=True, device_sample=True)
    reqs = [engine.submit(p, max_new=3) for p in prompts]
    engine.run()
    picked = [r for r in reqs if r.shadow]
    assert 0 < len(picked) < len(reqs)
    assert all(len(r.step_logits) == (3 if r.shadow else 0) for r in reqs)
    assert engine.summary()["shadow_samples"] == len(picked)


def test_shadow_selection_deterministic_and_rate_shaped():
    sampler = ShadowSampler(None, 0.25, seed=3)
    picks = [sampler.selects(rid) for rid in range(2000)]
    assert picks == [sampler.selects(rid) for rid in range(2000)]
    assert 0.15 < np.mean(picks) < 0.35
    assert not any(ShadowSampler(None, 0.0).selects(r) for r in range(50))
    assert all(ShadowSampler(None, 1.0).selects(r) for r in range(50))
    with pytest.raises(ValueError, match="shadow rate"):
        ShadowSampler(None, 1.5)


@pytest.mark.parametrize("rate", [0.05, 0.25, 0.7])
def test_shadow_selection_equals_reference(rate):
    for seed in (0, 17):
        port = ShadowSampler(None, rate, seed=seed)
        ref = ref_quality.ShadowSampler(None, rate, seed=seed)
        assert [port.selects(r) for r in range(1000)] == \
            [ref.selects(r) for r in range(1000)]


def test_shadow_observe_skips_incomplete_logit_streams(decoders):
    sampler = ShadowSampler(decoders[1], 1.0)
    req = Request(prompt=np.arange(4, dtype=np.int32), max_new=3)
    req.out_tokens = [1, 2, 3]
    req.step_logits = []  # nothing recorded
    assert sampler.observe(req) is None
