"""Port parity: proxy Hessians and the proxy objective.

The same numpy activations go through the JAX package's
``HessianAccumulator`` / ``block_hessians`` and the port's.  Tolerance:
fp32 sums in different orders, rtol 1e-5 relative to the largest entry.
Chunk invariance is checked to the same tolerance, not bit for bit:
``tests/test_drivers.py::test_streaming_hessians_bit_identical`` does not
hold in the reference itself on this tree.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import make_hessian, make_weights

from repro.configs import get_smoke_config as ref_smoke
from repro.core import hessian as ref_hessian
from repro.core import proxy as ref_proxy
from repro.launch import quantize as ref_quantize
from repro.models import build_model
from repro.models import layers as ref_layers
from repro.models.transformer import unstack_layers
from repro_torch import convert
from repro_torch.configs import ArchConfig
from repro_torch.core import hessian, proxy
from repro_torch.launch import quantize as port_quantize
from repro_torch.models import layers as L

RTOL = 1e-5


def T(a):
    return torch.from_numpy(np.array(a))


def _close(got: torch.Tensor, want, rtol=RTOL):
    want = np.asarray(want)
    scale = float(np.max(np.abs(want))) or 1.0
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=rtol * scale)


@pytest.mark.parametrize("masked", [False, True])
def test_accumulator_matches_reference(masked):
    rng = np.random.default_rng(1)
    X = rng.standard_normal((3, 5, 24)).astype(np.float32)
    X[..., 0] *= 10.0
    mask = (rng.random((3, 5)) < 0.7).astype(np.float32) if masked else None
    ref = ref_hessian.HessianAccumulator.create(24).update(
        jnp.asarray(X), None if mask is None else jnp.asarray(mask))
    got = hessian.HessianAccumulator.create(24, device="cpu").update(
        T(X), None if mask is None else T(mask))
    _close(got.H, ref.H)
    assert float(got.count) == float(ref.count)
    _close(got.finalize(), ref.finalize())


@pytest.mark.parametrize("chunk", [1, 2, 5])
def test_update_segments_chunked_matches_reference(chunk):
    rng = np.random.default_rng(2)
    X = rng.standard_normal((5, 16, 32)).astype(np.float32)
    want = ref_hessian.HessianAccumulator.create(32).update_segments(
        jnp.asarray(X)).finalize()
    acc = hessian.HessianAccumulator.create(32, device="cpu")
    for i0 in range(0, 5, chunk):
        acc = acc.update_segments(T(X[i0:i0 + chunk]))
    _close(acc.finalize(), want)
    assert float(acc.count) == 5 * 16


def test_damp_matches_reference():
    H = np.asarray(make_hessian(40, seed=3))
    _close(hessian.damp(T(H), 0.01), ref_hessian.damp(jnp.asarray(H), 0.01))


def test_proxy_loss_and_trd_trh_match_reference():
    W = np.asarray(make_weights(16, 40, seed=4))
    H = np.asarray(make_hessian(40, seed=4))
    What = np.round(W * 8) / 8
    _close(proxy.proxy_loss(T(What), T(W), T(H)),
           ref_proxy.proxy_loss(jnp.asarray(What), jnp.asarray(W),
                                jnp.asarray(H)))
    _close(proxy.trD_trH(T(H)), ref_proxy.trD_trH(jnp.asarray(H)), rtol=1e-4)


@pytest.fixture(scope="module")
def smoke_block():
    """The reference smoke model's first block, both packages' params and
    the same calibration activations entering it."""
    cfg = ref_smoke("qwen3-14b")
    params = build_model(cfg).init(jax.random.PRNGKey(0))
    port_params = convert.fp_params_from_numpy(
        jax.tree.map(np.asarray, params), device="cpu")
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, cfg.vocab, size=(6, 16))
    x = np.asarray(ref_quantize.L.embed(params["embed"], jnp.asarray(tokens)))
    port_cfg = ArchConfig.from_dict(dataclasses.asdict(cfg))
    return cfg, unstack_layers(params)[0], port_cfg, port_params, x


@pytest.mark.parametrize("chunk", [0, 4])
def test_block_hessians_match_reference(smoke_block, chunk):
    cfg, lp, port_cfg, port_params, x = smoke_block
    S = x.shape[1]
    want = ref_quantize.block_hessians(
        lp, jnp.asarray(x), cfg, jnp.arange(S, dtype=jnp.int32), chunk=chunk)
    got = port_quantize.block_hessians(
        port_params["layers"][0], T(x), port_cfg,
        torch.arange(S, dtype=torch.int32), chunk=chunk)
    assert set(got) == set(want)
    for name in want:
        _close(got[name], want[name], rtol=2e-5)


def test_block_hessians_chunk_invariant(smoke_block):
    _, _, port_cfg, port_params, x = smoke_block
    pos = torch.arange(x.shape[1], dtype=torch.int32)
    lp = port_params["layers"][0]
    one = port_quantize.block_hessians(lp, T(x), port_cfg, pos, chunk=0)
    for chunk in (1, 4):
        got = port_quantize.block_hessians(lp, T(x), port_cfg, pos,
                                           chunk=chunk)
        for name in one:
            _close(got[name], one[name].numpy())


def test_attention_full_matches_reference(smoke_block):
    cfg, lp, port_cfg, port_params, x = smoke_block
    S = x.shape[1]
    out, (k, v) = ref_layers.attention_full(
        lp["attn"], jnp.asarray(x), cfg,
        positions=jnp.arange(S, dtype=jnp.int32), causal=True,
        return_kv=True)
    got, (gk, gv) = L.attention_full(
        port_params["layers"][0]["attn"], T(x), port_cfg,
        positions=torch.arange(S, dtype=torch.int32), causal=True,
        return_kv=True)
    for a, b in ((got, out), (gk, k), (gv, v)):
        _close(a, b, rtol=2e-5)
