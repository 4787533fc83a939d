"""Port parity at a bf16 configuration: the dtype of a quantized layer's
output, of the recompute oracle's logits and of the engine's.

The JAX package's ``QuantizedLinear`` divides by its fp32 ``D`` and
multiplies by fp32 transform factors, so JAX promotes a bf16 input and the
layer returns fp32; at a bf16 configuration (``qwen3-14b``'s) the residual
stream turns fp32 after the first block's attention.  The port returns the
same dtype and follows the same promotion through the adapter and engine.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import make_hessian, make_weights
from torch_parity import linear_numpy, quantized_tree_numpy

from repro.configs import get_smoke_config as ref_smoke
from repro.core.quantizer import QuipConfig as RefQuipConfig
from repro.core.quantizer import quantize_layer as ref_quantize_layer
from repro.data import make_calibration as ref_calibration
from repro.launch import quantize as ref_quantize
from repro.models import build_model
from repro_torch import convert


def T(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("transform,incoherence", [
    ("kronecker", True), ("hadamard", True), ("none", False)])
def test_quantized_linear_bf16_dtype_matches_reference(transform,
                                                       incoherence):
    """The reference's fp32 D and factors promote a bf16 input: the layer
    returns fp32 unless every transform is the identity and there is no D."""
    W = make_weights(32, 64, seed=4)
    H = make_hessian(64, seed=4)
    ref, _ = ref_quantize_layer(W, H, RefQuipConfig(
        bits=2, transform=transform, incoherence=incoherence,
        use_kernel=False), seed=2, collect_stats=False)
    layer = convert.linear_from_numpy(linear_numpy(ref), device="cpu")
    x = np.random.default_rng(0).standard_normal((2, 3, 64)).astype(
        np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    for uk in (False, True):
        want = ref(xb, use_kernel=uk)
        got = layer(torch.from_numpy(x).to(torch.bfloat16), use_kernel=uk)
        assert str(got.dtype).split(".")[-1] == str(want.dtype), uk
        # fp32 outputs: fp32 tolerance; bf16 outputs (identity transforms):
        # the reference multiplies in bf16, the port in fp32, so two bf16
        # units in the last place (2 * 2^-7 relative)
        tol = 1e-5 if got.dtype == torch.float32 else 2 * 2.0**-7
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), rtol=tol,
                                   atol=tol)


@pytest.fixture(scope="module")
def bf16_models():
    cfg = dataclasses.replace(ref_smoke("qwen3-14b"), dtype="bfloat16")
    params = build_model(cfg).init(jax.random.PRNGKey(0))
    calib = ref_calibration(cfg.vocab, n_segments=4, seg_len=16, seed=7)
    qcfg = RefQuipConfig(bits=2, method="ldlq", use_kernel=False)
    ref_qm = ref_quantize.quantize_dense_model(
        params, cfg, qcfg, calib.tokens, seed=0, verbose=False)
    qm = convert.quantized_model_from_numpy(
        dataclasses.asdict(cfg), quantized_tree_numpy(ref_qm), device="cpu")
    return cfg, ref_qm, qm


def test_bf16_quantized_model_logits_match_reference(bf16_models):
    """A bf16 configuration's residual stream turns fp32 after the first
    quantized projection in the reference: the port's logits have the
    reference's dtype (fp32) and values."""
    cfg, ref_qm, qm = bf16_models
    assert qm.embed["tok"].dtype == torch.bfloat16
    tokens = np.asarray(ref_calibration(cfg.vocab, n_segments=2, seg_len=10,
                                        seed=3).tokens)
    want = ref_qm.logits(jnp.asarray(tokens))
    got = qm.logits(T(tokens).long())
    assert str(want.dtype) == "float32"
    assert got.dtype == torch.float32
    want = np.asarray(want)
    scale = float(np.max(np.abs(want)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-2 * scale)


def test_bf16_engine_logits_follow_reference(bf16_models):
    """The port's paged engine on the bf16 artifact: fp32 logits, tokens
    equal to the reference engine's, logits close."""
    from repro.serve import CachedDecoder as RefDecoder
    from repro.serve import Engine as RefEngine
    from repro.serve import EngineConfig as RefEngineConfig
    from repro_torch.serve.adapter import CachedDecoder
    from repro_torch.serve.engine import Engine, EngineConfig

    cfg, ref_qm, qm = bf16_models
    prompts = np.asarray(ref_calibration(cfg.vocab, n_segments=4, seg_len=12,
                                         seed=3).tokens)
    knobs = dict(n_slots=4, page_size=4, token_budget=32, prefill_chunk=8,
                 paged_decode=True, paged_prefill=True)
    outs = []
    for eng_cls, cfg_cls, adapter in (
            (RefEngine, RefEngineConfig, RefDecoder.from_quantized(ref_qm)),
            (Engine, EngineConfig, CachedDecoder.from_quantized(qm))):
        eng = eng_cls(adapter, cfg_cls(max_seq_len=18, record_logits=True,
                                       **knobs))
        reqs = [eng.submit(np.asarray(p), max_new=6) for p in prompts]
        eng.run()
        outs.append(reqs)
    for r, rr in zip(outs[1], outs[0]):
        assert r.out_tokens == rr.out_tokens
        got, want = np.stack(r.step_logits), np.stack(rr.step_logits)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-2 * np.abs(want).max())
