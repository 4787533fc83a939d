"""The rest of the dense family on the port: llama2-70b, mistral-large-123b,
qwen2-72b (``qkv_bias``) and starcoder2-15b (``qkv_bias``, ``mlp_bias``, the
GeLU MLP), at their smoke configs (2 layers, d 64) on the CPU.

The JAX package's params — with **nonzero** seeded biases, so that a
dropped bias shows — and an artifact written by its quantizer are
converted and served by the port's engine; the greedy token streams must
be identical to the JAX engine's on the same prompts and the logits close
(fp32, rtol = atol = 2e-3, summation orders only).  The block taps and
proxy Hessians are held to the JAX package's within rtol 2e-5 of the
largest entry, which pins the reference's handling of the biases (see
``test_block_taps_keep_the_reference_bias_handling``).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import quantized_tree_numpy

from repro.configs import get_config as ref_config
from repro.configs import get_smoke_config as ref_smoke
from repro.core.quantizer import QuipConfig
from repro.data import make_calibration as ref_calibration
from repro.launch import quantize as ref_quantize
from repro.models import build_model
from repro.models import layers as ref_layers
from repro.models.transformer import unstack_layers
from repro.serve import CachedDecoder as RefDecoder
from repro.serve import Engine as RefEngine
from repro.serve import EngineConfig as RefEngineConfig
from repro_torch import convert
from repro_torch.configs import ArchConfig, get_config, get_smoke_config
from repro_torch.launch import quantize as port_quantize
from repro_torch.launch import serve as port_serve
from repro_torch.models import layers as L
from repro_torch.serve.adapter import CachedDecoder
from repro_torch.serve.artifacts import load_quantized
from repro_torch.serve.engine import Engine, EngineConfig
from repro_torch.serve.synthetic import synthetic_quantized_model

ARCHS = ["llama2-70b", "mistral-large-123b", "qwen2-72b", "starcoder2-15b"]
BIASED = ["qwen2-72b", "starcoder2-15b"]
RTOL = ATOL = 2e-3  # logits, engine against engine
TAP_RTOL = 2e-5  # taps and Hessians, relative to the largest entry
BIAS_STD = 0.5  # seeded biases: large enough to move the greedy tokens
KNOBS = dict(n_slots=4, page_size=4, token_budget=32, prefill_chunk=8,
             paged_decode=True, paged_prefill=True)
PROMPT_LEN, GEN = 12, 6


def _with_biases(params, seed: int):
    """The JAX params (numpy) with every bias drawn N(0, BIAS_STD²)."""
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(np.asarray, params)
    for grp, keys in (("attn", ("bq", "bk", "bv")), ("mlp", ("bi", "bo"))):
        for k in keys:
            if k in tree["layers"][grp]:
                b = tree["layers"][grp][k]
                tree["layers"][grp][k] = (BIAS_STD * rng.standard_normal(
                    b.shape)).astype(b.dtype)
    return tree


@pytest.fixture(scope="module", params=ARCHS)
def family(request):
    """(arch, JAX cfg, model, params with biases (jnp), the same params as
    numpy, the JAX package's 2-bit quantization of them)."""
    cfg = ref_smoke(request.param)
    model = build_model(cfg)
    np_params = _with_biases(model.init(jax.random.PRNGKey(0)), seed=11)
    params = jax.tree.map(jnp.asarray, np_params)
    calib = ref_calibration(cfg.vocab, n_segments=4, seg_len=32, seed=7)
    qcfg = QuipConfig(bits=2, method="ldlq", use_kernel=False)
    qm = ref_quantize.quantize_dense_model(params, cfg, qcfg, calib.tokens,
                                           seed=0, verbose=False)
    return request.param, cfg, model, params, np_params, qm, qcfg


def _run(engine_cls, cfg_cls, adapter, prompts):
    eng = engine_cls(adapter, cfg_cls(max_seq_len=PROMPT_LEN + GEN,
                                      record_logits=True, **KNOBS))
    reqs = [eng.submit(np.asarray(p), max_new=GEN) for p in prompts]
    eng.run()
    return eng, reqs


def _same_streams(ref_adapter, port_adapter, vocab):
    prompts = np.asarray(ref_calibration(vocab, n_segments=6,
                                         seg_len=PROMPT_LEN, seed=3).tokens)
    _, ref_reqs = _run(RefEngine, RefEngineConfig, ref_adapter, prompts)
    eng, reqs = _run(Engine, EngineConfig, port_adapter, prompts)
    for r, rr in zip(reqs, ref_reqs):
        assert r.out_tokens == rr.out_tokens
        np.testing.assert_allclose(np.stack(r.step_logits),
                                   np.stack(rr.step_logits), rtol=RTOL,
                                   atol=ATOL)
    assert eng.pool.pages_in_use == 0
    return [r.out_tokens for r in reqs]


def _port_fp(cfg, np_params):
    port_cfg = ArchConfig.from_dict(dataclasses.asdict(cfg))
    return port_cfg, convert.fp_params_from_numpy(np_params, device="cpu")


def test_fp_engine_streams_match_reference(family):
    """fp weights with nonzero biases: the port's paged engine emits the
    JAX engine's greedy tokens, and dropping the biases would change
    them."""
    arch, cfg, model, params, np_params, _, _ = family
    port_cfg, port_params = _port_fp(cfg, np_params)
    got = _same_streams(RefDecoder.from_model(model, params),
                        CachedDecoder.from_model(port_cfg, port_params),
                        cfg.vocab)
    if arch in BIASED:
        for lp in port_params["layers"]:
            for grp in ("attn", "mlp"):
                for k in [k for k in lp[grp] if k.startswith("b")]:
                    lp[grp][k] = torch.zeros_like(lp[grp][k])
        eng, reqs = _run(Engine, EngineConfig, CachedDecoder.from_model(
            port_cfg, port_params), np.asarray(ref_calibration(
                cfg.vocab, n_segments=6, seg_len=PROMPT_LEN,
                seed=3).tokens))
        assert [r.out_tokens for r in reqs] != got


def test_converted_reference_artifact_streams_match(family, tmp_path):
    """An artifact written by the JAX quantizer (``arch_config`` with the
    bias flags as the config has them) is converted, loaded and served
    without biases, as the reference serves it: identical streams."""
    from repro.serve.artifacts import load_quantized as ref_load
    from repro.serve.artifacts import save_quantized as ref_save

    arch, cfg, _, _, _, qm, qcfg = family
    ref_save(tmp_path / "ref_art", qm, qcfg)
    loaded, meta = ref_load(tmp_path / "ref_art")
    assert meta["arch_config"]["qkv_bias"] == (arch in BIASED)
    convert.write_port_artifact(tmp_path / "port_art", meta["arch_config"],
                                quantized_tree_numpy(loaded),
                                meta["quip_config"])
    port_qm, _ = load_quantized(tmp_path / "port_art", device="cpu")
    assert port_qm.cfg.qkv_bias == cfg.qkv_bias
    assert port_qm.cfg.mlp_bias == cfg.mlp_bias
    assert not any(k.startswith(("attn.b", "mlp.b"))
                   for blk in port_qm.blocks for k in blk)
    _same_streams(RefDecoder.from_quantized(loaded),
                  CachedDecoder.from_quantized(port_qm), cfg.vocab)


@pytest.fixture(scope="module", params=BIASED)
def biased_block(request):
    cfg = ref_smoke(request.param)
    params = jax.tree.map(jnp.asarray, _with_biases(
        build_model(cfg).init(jax.random.PRNGKey(0)), seed=5))
    port_cfg, port_params = _port_fp(cfg, jax.tree.map(np.asarray, params))
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, cfg.vocab, size=(6, 16))
    x = np.array(ref_layers.embed(params["embed"], jnp.asarray(tokens)))
    return cfg, unstack_layers(params)[0], port_cfg, port_params, x


def _close(got: torch.Tensor, want, rtol=TAP_RTOL):
    want = np.asarray(want)
    scale = float(np.max(np.abs(want))) or 1.0
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=rtol * scale)


def test_block_taps_keep_the_reference_bias_handling(biased_block):
    """``_block_taps`` as the JAX package runs it, biases included: the
    attention output and the residual carry ``bq bk bv``; the ``attn.wo``
    tap recomputes q without ``bq`` (k and v keep theirs); the MLP's taps
    and the residual use neither ``bi`` nor ``bo``.  So the residual the
    next block's Hessians see differs from the biased fp block's output."""
    cfg, lp, port_cfg, port_params, x = biased_block
    S = x.shape[1]
    pos = jnp.arange(S, dtype=jnp.int32)
    want_x, want = ref_quantize._block_taps(lp, jnp.asarray(x), cfg, pos)
    plp = port_params["layers"][0]
    tpos = torch.arange(S, dtype=torch.int32)
    got_x, got = port_quantize._block_taps(plp, torch.from_numpy(x),
                                           port_cfg, tpos)
    assert set(got) == set(want)
    for name in want:
        _close(got[name], want[name])
    _close(got_x, want_x)
    # what the biases do there, stated: the taps' residual is not the fp
    # block's (which adds bi and bo), and the wo tap is not the attention
    # output of the biased q
    blk = port_quantize.fp_blocks(port_params, port_cfg)[0]
    fp_x = port_quantize._quantized_block_forward(blk, torch.from_numpy(x),
                                                  port_cfg, tpos)
    if port_cfg.mlp_bias:
        assert not torch.allclose(fp_x, got_x, atol=1e-3)
    q, k, v = L.project_qkv(plp["attn"], L.norm_apply(
        plp["ln1"], torch.from_numpy(x), port_cfg), port_cfg, tpos)
    o = L.attend(q, k, v, tpos, port_cfg).reshape(got["attn.wo"].shape)
    assert not torch.allclose(o, got["attn.wo"], atol=1e-3)


@pytest.mark.parametrize("chunk", [0, 4])
def test_block_hessians_with_biases_match_reference(biased_block, chunk):
    cfg, lp, port_cfg, port_params, x = biased_block
    S = x.shape[1]
    want = ref_quantize.block_hessians(
        lp, jnp.asarray(x), cfg, jnp.arange(S, dtype=jnp.int32), chunk=chunk)
    got = port_quantize.block_hessians(
        port_params["layers"][0], torch.from_numpy(x), port_cfg,
        torch.arange(S, dtype=torch.int32), chunk=chunk)
    assert set(got) == set(want)
    assert ("mlp.wg" in got) == (cfg.mlp == "swiglu")
    for name in want:
        _close(got[name], want[name])


def test_mlp_and_attention_with_biases_match_reference(biased_block):
    cfg, lp, port_cfg, port_params, x = biased_block
    S = x.shape[1]
    plp = port_params["layers"][0]
    _close(L.mlp_apply(plp["mlp"], torch.from_numpy(x), port_cfg),
           ref_layers.mlp_apply(lp["mlp"], jnp.asarray(x), cfg))
    out, (k, v) = ref_layers.attention_full(
        lp["attn"], jnp.asarray(x), cfg,
        positions=jnp.arange(S, dtype=jnp.int32), causal=True,
        return_kv=True)
    got, (gk, gv) = L.attention_full(
        plp["attn"], torch.from_numpy(x), port_cfg,
        positions=torch.arange(S, dtype=torch.int32), causal=True,
        return_kv=True)
    for a, b in ((got, out), (gk, k), (gv, v)):
        _close(a, b)


def test_gelu_is_the_tanh_approximation_of_jax():
    """``jax.nn.gelu`` defaults to the tanh approximation; the port's GeLU
    MLP nonlinearity is ``F.gelu(approximate="tanh")``: fp32, atol 1e-6."""
    x = np.random.default_rng(0).standard_normal(4096).astype(np.float32) * 4
    cfg = get_smoke_config("starcoder2-15b")
    got = L.mlp_act(torch.from_numpy(x), None, cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax.nn.gelu(
        jnp.asarray(x))), rtol=0, atol=1e-6)
    exact = np.asarray(jax.nn.gelu(jnp.asarray(x), approximate=False))
    assert np.abs(got.numpy() - exact).max() > 1e-4


def test_synthetic_gelu_model_has_no_gate():
    cfg = get_smoke_config("starcoder2-15b")
    qm = synthetic_quantized_model(cfg, seed=0, device="cpu")
    for blk in qm.blocks:
        assert "mlp.wg" not in blk
        assert (blk["mlp.wi"].m, blk["mlp.wi"].n) == (cfg.d_ff, cfg.d_model)
        assert (blk["mlp.wo"].m, blk["mlp.wo"].n) == (cfg.d_model, cfg.d_ff)
    tokens = torch.zeros(1, 5, dtype=torch.int64)
    assert torch.isfinite(qm.logits(tokens)).all()
    swiglu = synthetic_quantized_model(get_smoke_config("llama2-70b"),
                                       seed=0, device="cpu")
    assert all("mlp.wg" in blk for blk in swiglu.blocks)


def test_init_decoder_biases_are_zeros():
    from repro_torch.models.transformer import init_decoder

    cfg = get_smoke_config("starcoder2-15b")
    params = init_decoder(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    for lp in params["layers"]:
        for grp, keys in (("attn", ("bq", "bk", "bv")), ("mlp", ("bi", "bo"))):
            for k in keys:
                assert not lp[grp][k].any()
        assert "wg" not in lp["mlp"]
    assert "bq" not in init_decoder(get_smoke_config("llama2-70b"),
                                    torch.Generator(), device="cpu")[
        "layers"][0]["attn"]


@pytest.mark.parametrize("arch", ["qwen3-14b"] + ARCHS)
@pytest.mark.parametrize("size", ["full", "smoke"])
def test_config_from_dict_round_trips(arch, size):
    """Every dense config of the JAX package, as its artifact manifests
    write it, builds the port's config of the same name."""
    ref = ref_config(arch) if size == "full" else ref_smoke(arch)
    want = get_config(arch) if size == "full" else get_smoke_config(arch)
    assert ArchConfig.from_dict(dataclasses.asdict(ref)) == want
    assert ArchConfig.from_dict(dataclasses.asdict(want)) == want


@pytest.mark.parametrize("arch", ["starcoder2-15b", "qwen2-72b"])
def test_serve_cli_quantize_in_process_checks(arch, capsys):
    """``--quantize --bits 2`` quantizes in process (LDLQ, Kronecker
    transforms) and serves with the recompute check."""
    rc = port_serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                          "--quantize", "--bits", "2", "--requests", "3",
                          "--prompt-len", "12", "--gen", "6", "--paged",
                          "--paged-prefill", "--check"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert f"quip-2bit {arch}-smoke" in out
    assert "token agreement 100.00%" in out
