"""Port parity: ``quantize_layer``, ``quantize_dense_model`` and the
quantize CLI.

The port quantizes with the JAX package's own transform factors injected
(``torch_parity.reference_transforms``), so both sides round the same
numbers.  Codes are compared up to fp32 tie flips (the two sides factor H
with different libraries and sum in different orders; a flipped tie feeds
back along its row): at most ``TIE_FRAC`` of them may differ.  The quality
reports agree within the tolerances below.
"""
from __future__ import annotations

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import make_hessian, make_weights
from torch_parity import linear_numpy, reference_transforms

from repro.configs import get_smoke_config as ref_smoke
from repro.core import packing as ref_packing
from repro.core.quantizer import QuipConfig as RefQuipConfig
from repro.core.quantizer import quantize_layer as ref_quantize_layer
from repro.data import make_calibration as ref_calibration
from repro.launch import quantize as ref_quantize
from repro.models import build_model
from repro_torch import convert
from repro_torch.configs import ArchConfig
from repro_torch.core import packing
from repro_torch.core.quantizer import QuipConfig, quantize_layer
from repro_torch.launch import quantize as port_quantize
from repro_torch.launch import serve as port_serve

TIE_FRAC = 0.02


def T(a):
    return torch.from_numpy(np.array(a))


def _codes(layer) -> np.ndarray:
    return packing.unpack(layer.packed, layer.bits, layer.n).numpy()


def _ref_codes(layer) -> np.ndarray:
    return np.asarray(ref_packing.unpack(layer.packed, layer.bits, layer.n))


def _check_stats(got: dict, want: dict, *, loss_rtol: float) -> None:
    """The quality report: same keys; µ and norms to fp32 tolerance; the
    spectrum to eigh's fp32 accuracy (~1e-4 of λmax); the proxy losses to
    ``loss_rtol`` (flipped codes move them)."""
    assert set(got) == set(want)
    for k in ("m", "n", "bits", "method"):
        assert got[k] == want[k], k
    for k in ("s", "mu_w_pre", "mu_w_post"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    for k in ("mu_h_pre", "mu_h_post"):
        np.testing.assert_allclose(got[k], want[k], rtol=2e-2, err_msg=k)
    lmax = want["h_lambda_max"]
    for k in ("h_lambda_min", "h_lambda_max"):
        np.testing.assert_allclose(got[k], want[k], atol=1e-4 * lmax,
                                   err_msg=k)
    for k in ("proxy_loss", "proxy_rel", "frob_rel_err"):
        np.testing.assert_allclose(got[k], want[k], rtol=loss_rtol,
                                   err_msg=k)
    assert got["wall_s"] > 0


@pytest.mark.parametrize("method,transform,incoherence", [
    ("ldlq", "kronecker", True),
    ("ldlq", "hadamard", True),
    ("near", "kronecker", True),
    ("greedy", "kronecker", True),
    ("ldlq_rg", "kronecker", True),
    ("ldlq", "none", False),
])
def test_quantize_layer_matches_reference(method, transform, incoherence):
    W = np.asarray(make_weights(48, 128, seed=3))
    H = np.asarray(make_hessian(128, seed=3))
    kw = dict(bits=2, method=method, transform=transform,
              incoherence=incoherence, greedy_passes=2, use_kernel=False)
    ref, rst = ref_quantize_layer(jnp.asarray(W), jnp.asarray(H),
                                  RefQuipConfig(**kw), seed=9)
    got, st = quantize_layer(T(W), T(H), QuipConfig(**kw), seed=9,
                             transforms=reference_transforms)
    assert np.mean(_codes(got) != _ref_codes(ref)) < TIE_FRAC
    _check_stats(st, rst, loss_rtol=5e-2)
    # the rest of the layer (scale, D) equals the reference's to fp32
    want = linear_numpy(ref)
    np.testing.assert_allclose(float(got.s), float(want["s"]), rtol=1e-5)
    if want["D"] is not None:
        np.testing.assert_allclose(got.D.numpy(), want["D"], rtol=1e-5)


@pytest.fixture(scope="module")
def smoke_models():
    """The reference quantizes its smoke model; the port quantizes the same
    params on the same calibration tokens with the reference's factors."""
    cfg = ref_smoke("qwen3-14b")
    params = build_model(cfg).init(jax.random.PRNGKey(0))
    calib = ref_calibration(cfg.vocab, n_segments=6, seg_len=24, seed=7)
    qcfg = RefQuipConfig(bits=2, method="ldlq", use_kernel=False)
    ref_qm = ref_quantize.quantize_dense_model(
        params, cfg, qcfg, calib.tokens, seed=1, verbose=False,
        calib_chunk=4)
    port_cfg = ArchConfig.from_dict(dataclasses.asdict(cfg))
    port_params = convert.fp_params_from_numpy(
        jax.tree.map(np.asarray, params), device="cpu")
    qm = port_quantize.quantize_dense_model(
        port_params, port_cfg, QuipConfig(bits=2, method="ldlq",
                                          use_kernel=False),
        np.asarray(calib.tokens), seed=1, verbose=False, calib_chunk=4,
        transforms=reference_transforms)
    return ref_qm, qm, params, port_params


def test_quantize_dense_model_matches_reference(smoke_models):
    ref_qm, qm, _, _ = smoke_models
    assert len(qm.blocks) == len(ref_qm.blocks) == 2
    for blk, rblk, st, rst in zip(qm.blocks, ref_qm.blocks, qm.stats,
                                  ref_qm.stats):
        assert set(st) == set(rst)
        for name in rst:
            frac = np.mean(_codes(blk[name]) != _ref_codes(rblk[name]))
            assert frac < TIE_FRAC, (name, frac)
            _check_stats(st[name], rst[name], loss_rtol=5e-2)


def test_quantized_model_logits_match_reference(smoke_models):
    ref_qm, qm, _, _ = smoke_models
    tokens = np.asarray(ref_calibration(256, n_segments=2, seg_len=12,
                                        seed=3).tokens)
    want = np.asarray(ref_qm.logits(jnp.asarray(tokens)))
    got = qm.logits(T(tokens).long())
    scale = float(np.max(np.abs(want)))
    # a few flipped codes move the logits a little
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=0.05 * scale)


def test_perplexity_matches_reference(smoke_models):
    _, _, params, port_params = smoke_models
    cfg = ref_smoke("qwen3-14b")
    model = build_model(cfg)
    tokens = ref_calibration(cfg.vocab, n_segments=3, seg_len=16,
                             seed=99).tokens
    want = ref_quantize.perplexity(
        lambda t: model.logits(params, model.forward(params,
                                                     {"tokens": t})[0]),
        tokens, batch=2)
    port_cfg = ArchConfig.from_dict(dataclasses.asdict(cfg))
    got = port_quantize.perplexity(
        port_quantize.fp_model(port_params, port_cfg).logits,
        T(np.asarray(tokens)).long(), batch=2)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_quantize_cli_artifact_serves_with_check(tmp_path, capsys):
    out = tmp_path / "art"
    rc = port_quantize.main([
        "--smoke", "--device", "cpu", "--bits", "2", "--calib-segments",
        "4", "--calib-len", "32", "--out-dir", str(out),
        "--out", str(tmp_path / "rec.json")])
    text = capsys.readouterr().out
    assert rc == 0, text
    assert "allow_tf32 = False" in text
    rec = json.loads((tmp_path / "rec.json").read_text())
    assert rec["method"] == "ldlq+incp@2b"
    assert np.isfinite(rec["ppl_quant"]) and np.isfinite(rec["ppl_fp16"])
    meta = json.loads((out / "step_00000000" / "manifest.json").read_text())
    meta = meta.get("meta", meta)
    assert meta["quip_config"] == dataclasses.asdict(
        QuipConfig(bits=2, use_kernel=False))
    assert meta["seed"] == 0 and meta["smoke"] is True
    assert meta["quality"]["format"] == 1
    assert meta["quality"]["aggregate"]["n_layers"] == 14
    assert len(meta["stats"]) == 2
    rc = port_serve.main([
        "--device", "cpu", "--smoke", "--load-quantized", str(out),
        "--paged", "--paged-prefill", "--check", "--requests", "4"])
    text = capsys.readouterr().out
    assert rc == 0, text
    assert "token agreement 100.00%" in text
