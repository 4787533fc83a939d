"""MoE routing, capacity and dispatch, and per-expert Hessians, held to the
JAX package on the CPU.

At ``capacity_factor`` 1.25 on a batch skewed towards one expert (so that
tokens drop), the port's keep mask, slot positions, top-k choices and
capacity equal the JAX package's exactly, and the layer output and aux
loss agree within rtol = atol = 1e-5 (fp32, summation orders only).
``expert_hessians`` agrees within rtol 1e-5 (atol 1e-6) and takes the
shared H for a starved expert.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke
from repro.core.hessian import expert_hessians as ref_expert_hessians
from repro.models import layers as RL
from repro_torch.configs import ArchConfig
from repro_torch.core.hessian import expert_hessians
from repro_torch.models import layers as L

MOE = ["llama4-scout-17b-a16e", "arctic-480b"]
RTOL = ATOL = 1e-5  # fp32 layer outputs against the JAX package
H_RTOL, H_ATOL = 1e-5, 1e-6  # fp32 second moments


def _layer(arch: str, cf: float, seed: int = 0):
    cfg = dataclasses.replace(ref_smoke(arch), capacity_factor=cf)
    p = RL.init_moe(jax.random.PRNGKey(seed), cfg)
    pp = {k: (torch.from_numpy(np.array(v)) if not isinstance(v, dict)
              else {kk: torch.from_numpy(np.array(vv))
                    for kk, vv in v.items()})
          for k, v in p.items()}
    return cfg, p, ArchConfig.from_dict(dataclasses.asdict(cfg)), pp


def _skewed(cfg, p, T: int, skew: float, seed: int = 1) -> np.ndarray:
    """(2, T/2, D) activations pulled towards expert 0's router column."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, T // 2, cfg.d_model)).astype(np.float32)
    r0 = np.asarray(p["router"])[:, 0]
    return (x + skew * r0 / np.linalg.norm(r0)).astype(np.float32)


def _ref_route(p, x, cfg):
    """The JAX package's routing steps (moe_apply's own lines)."""
    xt = jnp.asarray(x).reshape(-1, cfg.d_model)
    probs = jax.nn.softmax(xt.astype(jnp.float32) @ p["router"], axis=-1)
    top_p, top_e = jax.lax.top_k(probs, cfg.top_k)
    top_p = top_p / jnp.maximum(jnp.sum(top_p, -1, keepdims=True), 1e-9)
    e_flat = top_e.reshape(-1)
    onehot = jax.nn.one_hot(e_flat, cfg.n_experts, dtype=jnp.int32)
    pos = jnp.sum((jnp.cumsum(onehot, axis=0) - onehot) * onehot, axis=-1)
    C = RL.moe_capacity(cfg, xt.shape[0])
    return dict(top_p=top_p, top_e=top_e, pos=pos, keep=pos < C, C=C)


@pytest.mark.parametrize("T", [16, 64, 96])
@pytest.mark.parametrize("arch", MOE)
def test_routing_with_drops_equals_jax(arch, T):
    cfg, p, pcfg, pp = _layer(arch, 1.25)
    x = _skewed(cfg, p, T, skew=6.0)
    want = _ref_route(p, x, cfg)
    got = L.moe_route(pp, torch.from_numpy(x).reshape(T, -1), pcfg)
    assert got["C"] == want["C"]
    assert not bool(np.all(want["keep"])), "the batch must drop tokens"
    np.testing.assert_array_equal(got["keep"].numpy(),
                                  np.asarray(want["keep"]))
    np.testing.assert_array_equal(got["pos"].numpy(), np.asarray(want["pos"]))
    np.testing.assert_array_equal(got["top_e"].numpy(),
                                  np.asarray(want["top_e"]))
    np.testing.assert_allclose(got["top_p"].numpy(), np.asarray(want["top_p"]),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("skew", [0.0, 6.0])
@pytest.mark.parametrize("cf", [1.25, 4.0])
@pytest.mark.parametrize("arch", MOE)
def test_moe_apply_equals_jax(arch, cf, skew):
    """Output and aux loss, with drops (cf 1.25, skewed) and without."""
    cfg, p, pcfg, pp = _layer(arch, cf)
    x = _skewed(cfg, p, 64, skew=skew)
    y_ref, aux_ref = RL.moe_apply(p, jnp.asarray(x), cfg)
    y, aux = L.moe_apply(pp, torch.from_numpy(x), pcfg)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(float(aux), float(aux_ref), rtol=RTOL)


def test_dropped_tokens_get_only_the_dense_residual():
    """arctic at cf 1.25 on a skewed batch: a token dropped from every
    choice contributes only the dense residual MLP."""
    cfg, p, pcfg, pp = _layer("arctic-480b", 1.25)
    x = _skewed(cfg, p, 96, skew=12.0)
    r = L.moe_route(pp, torch.from_numpy(x).reshape(96, -1), pcfg)
    gone = (~r["keep"]).reshape(96, cfg.top_k).all(-1)
    assert bool(gone.any())
    y, _ = L.moe_apply(pp, torch.from_numpy(x), pcfg)
    dense = L.mlp_apply(pp["dense"], torch.from_numpy(x), pcfg)
    np.testing.assert_allclose(y.reshape(96, -1)[gone].numpy(),
                               dense.reshape(96, -1)[gone].numpy(), rtol=0,
                               atol=0)


@pytest.mark.parametrize("tokens", [1, 8, 64, 100, 1280])
@pytest.mark.parametrize("arch", MOE)
def test_moe_capacity_equals_jax(arch, tokens):
    for cf in (1.25, 4.0, 64.0):
        cfg = dataclasses.replace(ref_smoke(arch), capacity_factor=cf)
        assert L.moe_capacity(ArchConfig.from_dict(dataclasses.asdict(cfg)),
                              tokens) == RL.moe_capacity(cfg, tokens)


def test_top_k_ties_go_to_the_lower_expert():
    """Equal router probabilities pick the lower expert index, as
    ``jax.lax.top_k`` does."""
    cfg, p, pcfg, pp = _layer("arctic-480b", 1.25)
    pp["router"] = torch.zeros_like(pp["router"])  # every prob 1/E
    x = torch.randn(10, cfg.d_model,
                    generator=torch.Generator().manual_seed(0))
    r = L.moe_route(pp, x, pcfg)
    assert r["top_e"].tolist() == [[0, 1]] * 10
    p0 = {**p, "router": jnp.zeros_like(p["router"])}
    np.testing.assert_array_equal(
        r["top_e"].numpy(),
        np.asarray(_ref_route(p0, x.numpy(), cfg)["top_e"]))


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("min_tokens", [8, 64])
def test_expert_hessians_equal_jax(k, min_tokens):
    rng = np.random.default_rng(k)
    X = rng.standard_normal((200, 16)).astype(np.float32)
    idx = rng.integers(0, 6, (200, k)).astype(np.int32)
    idx[:, 0] = np.where(idx[:, 0] == 5, 0, idx[:, 0])  # expert 5 starved
    Hs_ref, c_ref = ref_expert_hessians(jnp.asarray(X), jnp.asarray(idx), 6,
                                        min_tokens=min_tokens)
    Hs, c = expert_hessians(torch.from_numpy(X), torch.from_numpy(idx), 6,
                            min_tokens=min_tokens)
    np.testing.assert_array_equal(c.numpy(), np.asarray(c_ref))
    np.testing.assert_allclose(Hs.numpy(), np.asarray(Hs_ref), rtol=H_RTOL,
                               atol=H_ATOL)


def test_expert_hessians_starved_fallback():
    """The port of the JAX package's test: everything routed to expert 0
    (top-2, so counted twice); the starved experts carry the shared H."""
    X = torch.from_numpy(np.array(
        jax.random.normal(jax.random.PRNGKey(3), (256, 16))))
    idx = torch.zeros((256, 2), dtype=torch.int32)
    Hs, counts = expert_hessians(X, idx, num_experts=4, min_tokens=8)
    shared = (X.T @ X / 256).numpy()
    for e in (1, 2, 3):
        np.testing.assert_allclose(Hs[e].numpy(), shared, rtol=H_RTOL)
    assert float(counts[0]) == 512.0  # top-2 double count
    # expert 0 saw everything twice: its H is the same second moment
    np.testing.assert_allclose(Hs[0].numpy(), shared, rtol=H_RTOL,
                               atol=H_ATOL)
    assert counts.tolist() == [512.0, 0.0, 0.0, 0.0]


def test_expert_hessians_of_routed_layer_activations():
    """Routed activations of a smoke MoE layer: the counts are the
    routing's integer counts and each H is its experts' plain XᵀX."""
    cfg, p, pcfg, pp = _layer("llama4-scout-17b-a16e", 1.25)
    x = torch.from_numpy(_skewed(cfg, p, 96, skew=2.0)).reshape(96, -1)
    top_e = L.moe_route(pp, x, pcfg)["top_e"]
    Hs, counts = expert_hessians(x, top_e, cfg.n_experts, min_tokens=4)
    for e in range(cfg.n_experts):
        sel = x[(top_e == e).any(-1)]
        assert counts[e] == len(sel)
        if len(sel) >= 4:
            np.testing.assert_allclose(Hs[e].numpy(),
                                       (sel.T @ sel / len(sel)).numpy(),
                                       rtol=H_RTOL, atol=H_ATOL)
