"""Port parity: the recompute oracle (QuantizedModel.logits) and the fp
gather-dense CachedDecoder against the reference, plus the port's artifact
store (round trip, SHA-256 integrity, JAX-package format refused)."""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import quantized_tree_numpy

from repro.configs import get_smoke_config as ref_smoke
from repro.core.quantizer import QuipConfig
from repro.data import make_calibration as ref_calibration
from repro.models import build_model
from repro.serve import CachedDecoder as RefDecoder
from repro_torch import convert
from repro_torch.checkpoint.store import ArtifactCorruption
from repro_torch.configs import ArchConfig
from repro_torch.data.synthetic import make_calibration
from repro_torch.serve.adapter import CachedDecoder
from repro_torch.serve.artifacts import load_quantized, save_quantized

RTOL = ATOL = 2e-3  # the reference serving tests' own tolerance


@pytest.fixture(scope="module")
def quantized_smoke():
    from repro.launch.quantize import quantize_dense_model

    cfg = ref_smoke("qwen3-14b")
    model = build_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    calib = ref_calibration(cfg.vocab, n_segments=4, seg_len=32, seed=7)
    qcfg = QuipConfig(bits=2, method="ldlq", use_kernel=False)
    ref_qm = quantize_dense_model(params, cfg, qcfg, calib.tokens, seed=0,
                                  verbose=False)
    qm = convert.quantized_model_from_numpy(
        dataclasses.asdict(cfg), quantized_tree_numpy(ref_qm), device="cpu")
    return ref_qm, qm, qcfg


def test_calibration_prompts_match_reference():
    want = np.asarray(ref_calibration(256, n_segments=3, seg_len=17,
                                      seed=5).tokens)
    np.testing.assert_array_equal(
        make_calibration(256, n_segments=3, seg_len=17, seed=5), want)


def test_quantized_logits_match_reference(quantized_smoke):
    ref_qm, qm, _ = quantized_smoke
    toks = make_calibration(256, n_segments=2, seg_len=12, seed=9)
    want = np.asarray(ref_qm.logits(jnp.asarray(toks)))
    with torch.no_grad():
        got = qm.logits(torch.from_numpy(toks).long())
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_plain_oracle_reaches_no_kernel_wrapper(quantized_smoke, monkeypatch):
    """``logits(plain=True)`` (the recompute oracle) calls none of the
    kernels' wrappers, so on the card it checks them instead of sharing
    them; on the CPU it gives the same logits as the default path."""
    from repro_torch.core import incoherence as inc
    from repro_torch.kernels.quant_matmul import ops as qmm

    _, qm, _ = quantized_smoke
    toks = torch.from_numpy(make_calibration(256, n_segments=2, seg_len=12,
                                             seed=9)).long()
    with torch.no_grad():
        want = qm.logits(toks)

    def no_kernel(*a, **k):
        raise AssertionError("a kernel wrapper was called on the plain path")

    for mod, name in ((inc, "kron_mul"), (inc, "hadamard_transform"),
                      (qmm, "quant_matmul")):
        monkeypatch.setattr(mod, name, no_kernel)
    with torch.no_grad():
        got = qm.logits(toks, plain=True)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_fp_cached_decoder_matches_reference():
    cfg = ref_smoke("qwen3-14b")
    model = build_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    port_params = convert.fp_params_from_numpy(
        jax.tree.map(np.asarray, params), device="cpu")
    port_cfg = ArchConfig.from_dict(dataclasses.asdict(cfg))
    rng = np.random.default_rng(1)
    B, T, S = 2, 3, 8
    L, KV, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    tokens = rng.integers(0, cfg.vocab, (B, T)).astype(np.int32)
    ctx_len = np.array([2, 5], np.int32)
    positions = (ctx_len[:, None] + np.arange(T)[None]).astype(np.int32)
    ck = rng.standard_normal((L, B, S, KV, hd)).astype(np.float32)
    cv = rng.standard_normal((L, B, S, KV, hd)).astype(np.float32)
    want = RefDecoder.from_model(model, params)(
        jnp.asarray(tokens), jnp.asarray(positions), jnp.asarray(ck),
        jnp.asarray(cv), jnp.asarray(ctx_len))
    got = CachedDecoder.from_model(port_cfg, port_params)(
        tokens, positions, torch.from_numpy(ck), torch.from_numpy(cv),
        ctx_len)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)


def test_artifact_round_trip_and_integrity(quantized_smoke, tmp_path):
    _, qm, qcfg = quantized_smoke
    path = save_quantized(tmp_path / "art", qm, dataclasses.asdict(qcfg))
    qm2, meta = load_quantized(tmp_path / "art", device="cpu")
    assert meta["quip_config"]["bits"] == 2 and qm2.cfg == qm.cfg
    toks = torch.from_numpy(
        make_calibration(256, n_segments=1, seg_len=10, seed=2)).long()
    with torch.no_grad():
        np.testing.assert_array_equal(qm2.logits(toks).numpy(),
                                      qm.logits(toks).numpy())
    shard = path / "shard_00000.npz"
    raw = bytearray(shard.read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    shard.write_bytes(bytes(raw))
    with pytest.raises(ArtifactCorruption, match="shard 0"):
        load_quantized(tmp_path / "art", device="cpu")


def test_reference_artifact_format_is_refused(quantized_smoke, tmp_path):
    from repro.serve.artifacts import save_quantized as ref_save

    ref_qm, _, qcfg = quantized_smoke
    ref_save(tmp_path / "ref_art", ref_qm, qcfg)
    with pytest.raises(ValueError, match="convert"):
        load_quantized(tmp_path / "ref_art", device="cpu")
