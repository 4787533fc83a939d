"""Mamba2 and RWKV6 on the port, held to the JAX package on the CPU.

The chunked scans at chunks 3, 4 and 12 agree with the port's per-step
oracles (``*_scan_ref``) within atol 1e-4 (the JAX package's own
test_models.py tolerance) and with the JAX package's chunked scans, their
``return_state`` states included, within rtol = atol = 1e-5 (fp32 on both
sides: summation orders only).  The decode steps, the token shift, the
channel mix, the clamped log decay and the causal conv agree within the
same 1e-5.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.configs import get_smoke_config as ref_smoke
from repro.models import recurrent as RR
from repro.models import ssm as RS
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import recurrent as R
from repro_torch.models import ssm

CHUNKS = [3, 4, 12]
ORACLE_ATOL = 1e-4  # chunked against per-step, as the JAX package holds it
RTOL = ATOL = 1e-5  # port against JAX, fp32


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)


def _torch(tree):
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _x(cfg, T: int = 12, seed: int = 1) -> np.ndarray:
    return (0.5 * np.random.default_rng(seed).standard_normal(
        (2, T, cfg.d_model))).astype(np.float32)


@pytest.fixture(scope="module")
def mamba():
    cfg = ref_smoke("zamba2-7b")
    p = RS.init_mamba2(jax.random.PRNGKey(0), cfg)
    return cfg, p, get_smoke_config("zamba2-7b"), _torch(p)


@pytest.fixture(scope="module")
def rwkv():
    cfg = ref_smoke("rwkv6-1.6b")
    p = RS.init_rwkv6(jax.random.PRNGKey(0), cfg)
    # a nonzero bonus and decay base, so that both terms show
    rng = np.random.default_rng(7)
    p = dict(p, bonus=jnp.asarray(rng.standard_normal(p["bonus"].shape),
                                  jnp.float32),
             w0=jnp.asarray(rng.standard_normal(p["w0"].shape), jnp.float32))
    return cfg, p, get_smoke_config("rwkv6-1.6b"), _torch(p)


# ---------------------------------------------------------------------------
# Mamba2
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chunk", CHUNKS)
def test_mamba2_chunked_matches_scan_oracle(mamba, chunk):
    _, _, cfg, p = mamba
    u = torch.from_numpy(_x(cfg))
    _close(ssm.mamba2_forward(p, u, cfg, chunk=chunk),
           ssm.mamba2_scan_ref(p, u, cfg).numpy(), rtol=0, atol=ORACLE_ATOL)


@pytest.mark.parametrize("chunk", CHUNKS)
def test_mamba2_chunked_and_state_match_jax(mamba, chunk):
    rcfg, rp, cfg, p = mamba
    u = _x(cfg)
    y_ref, st_ref = RS.mamba2_forward(rp, jnp.asarray(u), rcfg, chunk=chunk,
                                      return_state=True)
    y, st = ssm.mamba2_forward(p, torch.from_numpy(u), cfg, chunk=chunk,
                               return_state=True)
    _close(y, y_ref)
    _close(st["ssm"], st_ref["ssm"])
    _close(st["conv"], st_ref["conv"])
    _close(st["conv"], RS.xBC_tail_state(rp, rcfg, jnp.asarray(u)))
    _close(ssm.xBC_tail_state(p, cfg, torch.from_numpy(u)), st_ref["conv"])


def test_mamba2_decode_steps_match_jax(mamba):
    """Prefill 9 tokens, then three decode steps on each side."""
    rcfg, rp, cfg, p = mamba
    u = _x(cfg)
    _, st_ref = RS.mamba2_forward(rp, jnp.asarray(u[:, :9]), rcfg,
                                  return_state=True)
    _, st = ssm.mamba2_forward(p, torch.from_numpy(u[:, :9]), cfg,
                               return_state=True)
    for t in range(9, 12):
        y_ref, st_ref = RS.mamba2_decode_step(rp, jnp.asarray(u[:, t:t + 1]),
                                              rcfg, st_ref)
        y, st = ssm.mamba2_decode_step(p, torch.from_numpy(u[:, t:t + 1]),
                                       cfg, st)
        _close(y, y_ref)
        _close(st["ssm"], st_ref["ssm"])
        _close(st["conv"], st_ref["conv"])


def test_mamba2_scan_ref_matches_jax(mamba):
    rcfg, rp, cfg, p = mamba
    u = _x(cfg)
    _close(ssm.mamba2_scan_ref(p, torch.from_numpy(u), cfg),
           RS.mamba2_scan_ref(rp, jnp.asarray(u), rcfg))


def test_causal_conv_matches_jax(mamba):
    rcfg, rp, cfg, p = mamba
    x = _x(cfg)[..., :1] * np.ones((1, 1, rp["conv_w"].shape[1]), np.float32)
    x = x + np.random.default_rng(3).standard_normal(x.shape).astype(
        np.float32)
    _close(ssm._causal_conv(torch.from_numpy(x), p["conv_w"], p["conv_b"]),
           RS._causal_conv(jnp.asarray(x), rp["conv_w"], rp["conv_b"]))


# ---------------------------------------------------------------------------
# RWKV6
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chunk", CHUNKS)
def test_rwkv6_chunked_matches_scan_oracle(rwkv, chunk):
    _, _, cfg, p = rwkv
    x = torch.from_numpy(_x(cfg))
    _close(ssm.rwkv6_time_mix(p, x, cfg, chunk=chunk),
           ssm.rwkv6_scan_ref(p, x, cfg).numpy(), rtol=0, atol=ORACLE_ATOL)


@pytest.mark.parametrize("chunk", CHUNKS)
def test_rwkv6_chunked_and_state_match_jax(rwkv, chunk):
    rcfg, rp, cfg, p = rwkv
    x = _x(cfg)
    y_ref, sh_ref, S_ref = RS.rwkv6_time_mix(rp, jnp.asarray(x), rcfg,
                                             chunk=chunk, return_state=True)
    y, sh, S = ssm.rwkv6_time_mix(p, torch.from_numpy(x), cfg, chunk=chunk,
                                  return_state=True)
    _close(y, y_ref)
    _close(sh, sh_ref)
    _close(S, S_ref)


@pytest.mark.parametrize("chunk", CHUNKS)
def test_rwkv6_continues_from_its_state(rwkv, chunk):
    """The first 8 tokens with ``return_state``, then the last 4 from that
    shift and wkv state, equal the 12 tokens in one call (and the JAX
    package's continuation)."""
    rcfg, rp, cfg, p = rwkv
    x = torch.from_numpy(_x(cfg))
    whole = ssm.rwkv6_time_mix(p, x, cfg, chunk=chunk)
    _, sh, S = ssm.rwkv6_time_mix(p, x[:, :8], cfg, chunk=chunk,
                                  return_state=True)
    tail = ssm.rwkv6_time_mix(p, x[:, 8:], cfg, chunk=chunk, shift_state=sh,
                              wkv_state=S)
    _close(tail, whole[:, 8:].numpy(), rtol=0, atol=ORACLE_ATOL)
    _, sh_r, S_r = RS.rwkv6_time_mix(rp, jnp.asarray(x[:, :8].numpy()), rcfg,
                                     chunk=chunk, return_state=True)
    _close(tail, RS.rwkv6_time_mix(rp, jnp.asarray(x[:, 8:].numpy()), rcfg,
                                   chunk=chunk, shift_state=sh_r,
                                   wkv_state=S_r))


def test_rwkv6_time_mix_steps_match_jax(rwkv):
    rcfg, rp, cfg, p = rwkv
    x = _x(cfg)
    sh_r = jnp.zeros((2, 1, cfg.d_model))
    S_r = jnp.zeros((2, cfg.d_model // cfg.rwkv_head_size,
                     cfg.rwkv_head_size, cfg.rwkv_head_size))
    sh, S = torch.from_numpy(np.array(sh_r)), torch.from_numpy(np.array(S_r))
    for t in range(4):
        y_r, sh_r, S_r = RS.rwkv6_time_mix_step(
            rp, jnp.asarray(x[:, t:t + 1]), rcfg, sh_r, S_r)
        y, sh, S = ssm.rwkv6_time_mix_step(p, torch.from_numpy(x[:, t:t + 1]),
                                           cfg, sh, S)
        _close(y, y_r)
        _close(S, S_r)


def test_rwkv6_scan_ref_matches_jax(rwkv):
    rcfg, rp, cfg, p = rwkv
    x = _x(cfg)
    _close(ssm.rwkv6_scan_ref(p, torch.from_numpy(x), cfg),
           RS.rwkv6_scan_ref(rp, jnp.asarray(x), rcfg))


@pytest.mark.parametrize("scale", [1.0, 30.0])
def test_rwkv_logw_clamps_as_jax(rwkv, scale):
    """The log decay: -exp(clip(z, -12, log 4)), then clamped at -4; at
    scale 30 the clamps bite."""
    rcfg, rp, cfg, p = rwkv
    xw = _x(cfg) * scale
    got = ssm._rwkv_logw(p, torch.from_numpy(xw))
    want = RS._rwkv_logw(rp, jnp.asarray(xw))
    _close(got, want)
    assert float(got.min()) >= -4.0 and float(got.max()) < 0.0
    if scale > 1:
        assert bool((got == -4.0).any())


def test_channel_mix_matches_jax():
    rcfg = ref_smoke("rwkv6-1.6b")
    rp = RS.init_channel_mix(jax.random.PRNGKey(2), rcfg)
    p = _torch(rp)
    x = _x(rcfg)
    y_r, sh_r = RS.channel_mix(rp, jnp.asarray(x[:, :8]), return_state=True)
    y, sh = ssm.channel_mix(p, torch.from_numpy(x[:, :8]), return_state=True)
    _close(y, y_r)
    _close(sh, sh_r)
    y_r, _ = RS.channel_mix_step(rp, jnp.asarray(x[:, 8:9]), sh_r)
    y, _ = ssm.channel_mix_step(p, torch.from_numpy(x[:, 8:9]), sh)
    _close(y, y_r)


# ---------------------------------------------------------------------------
# the hybrid's layout
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("size", ["full", "smoke"])
def test_hybrid_counts_match_jax(size):
    ref = ref_config("zamba2-7b") if size == "full" else ref_smoke("zamba2-7b")
    cfg = get_config("zamba2-7b") if size == "full" else get_smoke_config(
        "zamba2-7b")
    assert R._hybrid_counts(cfg) == RR._hybrid_counts(ref)
    if size == "full":
        assert R._hybrid_counts(cfg) == (13, 5, 68, 3)


def test_zamba2_layer_order():
    """13 superblocks of 5 Mamba2 layers and the shared block, then the 3
    tail layers: 81 steps, the shared block 13 times."""
    order = R._order(get_config("zamba2-7b"))
    assert len(order) == 81
    assert order[:6] == [("mamba", i) for i in range(5)] + [("shared", 0)]
    assert order[-4:] == [("shared", 12), ("mamba", 65), ("mamba", 66),
                          ("mamba", 67)]
    assert [i for k, i in order if k == "mamba"] == list(range(68))
