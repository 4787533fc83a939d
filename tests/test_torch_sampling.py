"""Port parity: per-request sampling, on the host and on the device.

* the device uniform is ``jax.random.uniform(fold_in(PRNGKey(seed), i))``
  bit for bit;
* ``sample_tokens`` draws the JAX function's tokens on the same logits;
  a token may differ only where ``u·Σps`` lies within ``EDGE_FLOOR`` of a
  bucket edge (float32 rounding of two V-term softmax/cumsum in another
  order), and such partings are at most 1 % of the draws; the greedy path
  is exact, and the draws follow the nucleus distribution (χ² over 12,000
  seeds);
* the host draw ``Engine._select_token`` equals the JAX package's token for
  token; ``SamplingParams`` validates as the reference does;
* engines: the port's sampled streams (device and host draws) equal the
  JAX engine's on one tick-counted schedule, a stream parting only where
  :func:`torch_parity.draw_explained` admits it (``delta`` = the max
  |Δlogit| of the two runs over the positions before the parting, logits
  otherwise within ``RTOL``/``ATOL``); they do not depend on batching or
  on eviction and replay;
* the serve CLI's sampling and speculative refusals equal the
  reference's.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats
from torch_parity import (
    assert_streams_agree,
    draw_explained,
    drive_ticks,
    fp_decoders,
)

from repro.data import make_calibration as ref_calibration
from repro.launch import serve as ref_serve
from repro.serve import Engine as RefEngine
from repro.serve import EngineConfig as RefEngineConfig
from repro.serve.adapter import sample_tokens as ref_sample_tokens
from repro.serve.scheduler import Request as RefRequest
from repro.serve.scheduler import SamplingParams as RefSamplingParams
from repro_torch.launch import serve as port_serve
from repro_torch.serve.adapter import sample_tokens, uniform
from repro_torch.serve.engine import Engine, EngineConfig
from repro_torch.serve.scheduler import Request, SamplingParams

V_DRAW = 512  # vocabulary of the unit draws
# two float32 softmax + cumsum over V terms, summed in other orders: each
# partial sum is off by at most (V − 1)·2⁻²⁴ of the mass
EDGE_FLOOR = 2 * V_DRAW * 2.0**-24
ENGINE_FLOOR = 2 * 256 * 2.0**-24  # the same over the smoke vocabulary
SEED_GRID = [0, 1, 2, 17, 2**16 + 3, 2**31 - 1, *np.random.default_rng(
    21).integers(0, 2**31, 6).tolist()]


@pytest.mark.parametrize("seed", SEED_GRID)
def test_uniform_bit_identical_to_jax_random(seed):
    idx = np.arange(4096, dtype=np.int32)
    want = np.asarray(jax.vmap(lambda i: jax.random.uniform(
        jax.random.fold_in(jax.random.PRNGKey(seed), i)))(jnp.asarray(idx)))
    got = uniform(torch.tensor(seed, dtype=torch.int32),
                  torch.as_tensor(idx)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def _draw_inputs(seed, B=64, T=8, V=V_DRAW):
    rng = np.random.default_rng(seed)
    scale = rng.choice([0.5, 2.0, 6.0], size=(B, 1, 1))
    logits = (rng.standard_normal((B, T, V)) * scale).astype(np.float32)
    temps = rng.choice([0.0, 0.7, 1.3], size=B).astype(np.float32)
    top_ps = rng.choice([1.0, 0.9, 0.5], size=B).astype(np.float32)
    seeds = rng.integers(0, 2**31, size=B).astype(np.int32)
    draws = rng.integers(0, 200, size=B).astype(np.int32)
    return logits, temps, top_ps, seeds, draws


def _both_draws(logits, temps, top_ps, seeds, draws, greedy_only=False):
    want = np.asarray(ref_sample_tokens(
        jnp.asarray(logits), jnp.asarray(temps), jnp.asarray(top_ps),
        jnp.asarray(seeds), jnp.asarray(draws), greedy_only))
    got = sample_tokens(*(torch.as_tensor(a) for a in (
        logits, temps, top_ps, seeds, draws)), greedy_only=greedy_only)
    assert got.dtype == torch.int32
    return got.numpy(), want


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_sample_tokens_matches_jax(seed):
    logits, temps, top_ps, seeds, draws = _draw_inputs(seed)
    got, want = _both_draws(logits, temps, top_ps, seeds, draws)
    B, T = got.shape
    greedy = temps == 0
    np.testing.assert_array_equal(got[greedy], logits[greedy].argmax(-1))
    partings = []
    for b, t in zip(*np.nonzero(got != want)):
        u = float(uniform(torch.tensor(int(seeds[b])),
                          torch.tensor(int(draws[b]) + t)))
        args = (logits[b, t], temps[b], top_ps[b], u)
        # each package's token is a draw the other's arithmetic can give
        assert draw_explained(*args, got[b, t], floor=EDGE_FLOOR)
        assert draw_explained(*args, want[b, t], floor=EDGE_FLOOR)
        partings.append((b, t))
    assert len(partings) <= 0.01 * B * T, partings


def test_draw_explained_rule():
    """The parting rule the sampled gates use (``chip_smoke.py``): the
    drawn token is admitted, a far token is not; a token past a bucket
    edge is admitted only within ``floor`` of it; a logit move reorders
    near-ties only."""
    lg = np.log(np.asarray([0.5, 0.3, 0.15, 0.05]))
    u = 0.6  # x = 0.6 lies in token 1's bucket [0.5, 0.8)
    assert draw_explained(lg, 1.0, 1.0, u, 1)
    assert not draw_explained(lg, 1.0, 1.0, u, 3)
    assert not draw_explained(lg, 1.0, 1.0, 0.501, 0)
    assert draw_explained(lg, 1.0, 1.0, 0.501, 0, floor=2e-3)
    # top-p 0.4 keeps token 0 alone: every u draws it
    assert draw_explained(lg, 1.0, 0.4, 0.9, 0)
    assert not draw_explained(lg, 1.0, 0.4, 0.9, 1)
    tie = np.asarray([2.0, 1.0, 1.0 - 1e-4, -3.0])
    x_in_2 = float(np.exp(tie[:2]).sum() / np.exp(tie).sum()) + 1e-3
    assert not draw_explained(tie, 1.0, 1.0, x_in_2, 1)
    assert draw_explained(tie, 1.0, 1.0, x_in_2, 1, delta=1e-4)
    assert not draw_explained(tie, 1.0, 1.0, x_in_2, 0, delta=1e-4)


def test_sample_tokens_greedy_only_exact():
    logits, temps, top_ps, seeds, draws = _draw_inputs(7)
    logits[0, 0, :4] = logits[0, 0].max() + 1.0  # a tie: first index wins
    got, want = _both_draws(logits, np.zeros_like(temps), top_ps, seeds,
                            draws, greedy_only=True)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, logits.argmax(-1))
    assert got[0, 0] == 0


def test_sample_tokens_chi_square_against_nucleus():
    """12,000 seeds draw one token each from one logit row: the counts
    follow the nucleus distribution (top-p 0.9 at T = 1.3)."""
    rng = np.random.default_rng(5)
    V, n, temp, top_p = 12, 12_000, 1.3, 0.9
    row = rng.standard_normal(V).astype(np.float32) * 1.5
    logits = np.broadcast_to(row, (n, 1, V)).copy()
    got = sample_tokens(
        torch.as_tensor(logits), torch.full((n,), temp),
        torch.full((n,), top_p), torch.arange(n, dtype=torch.int32),
        torch.zeros(n, dtype=torch.int32))[:, 0].numpy()
    z = row.astype(np.float64) / temp
    p = np.exp(z - z.max())
    p = p / p.sum()
    order = np.argsort(-p, kind="stable")
    keep = order[np.cumsum(p[order]) - p[order] < top_p]
    assert set(np.unique(got)) <= set(keep)
    expected = p[keep] / p[keep].sum() * n
    observed = np.bincount(got, minlength=V)[keep]
    assert stats.chisquare(observed, expected).pvalue > 1e-3


def test_sample_tokens_unit_cases():
    """The reference's unit checks: greedy lanes take the argmax, a tiny
    top-p collapses to it, and draws stay inside the nucleus."""
    V = 16
    mono = torch.linspace(0, 3, V)[None, None]
    one = lambda v, dt: torch.tensor([v], dtype=dt)
    args = lambda t, p, s=3, d=0: (one(t, torch.float32),
                                   one(p, torch.float32),
                                   one(s, torch.int32), one(d, torch.int32))
    assert int(sample_tokens(mono, *args(0.0, 1.0))[0, 0]) == V - 1
    assert int(sample_tokens(mono, *args(0.7, 1e-6))[0, 0]) == V - 1
    peaked = torch.tensor([0, 0, 0, 8, 9], dtype=torch.float32)[None, None]
    for idx in range(24):
        assert int(sample_tokens(peaked, *args(1.0, 0.9, 5, idx))[0, 0]) in (
            3, 4)


@pytest.mark.parametrize("temp,top_p", [(0.0, 1.0), (0.7, 1.0), (1.0, 0.9),
                                        (1.4, 0.5)])
def test_host_select_token_matches_reference(temp, top_p):
    rng = np.random.default_rng(int(temp * 10 + top_p * 100))
    ref_req = RefRequest(prompt=np.zeros(1, np.int32), max_new=1,
                         sampling=RefSamplingParams(temp, top_p, seed=9))
    req = Request(prompt=np.zeros(1, np.int32), max_new=1,
                  sampling=SamplingParams(temp, top_p, seed=9))
    for _ in range(200):
        logits = (rng.standard_normal(64) * 3).astype(np.float32)
        assert (Engine._select_token(req, logits)
                == RefEngine._select_token(ref_req, logits))


@pytest.mark.parametrize("kw", [
    dict(), dict(temperature=0.5), dict(temperature=-0.1),
    dict(top_p=0.0), dict(top_p=1.5), dict(top_p=0.3, seed=4),
    dict(temperature=0.0, top_p=0.5),
])
def test_sampling_params_validation_matches_reference(kw):
    def make(cls):
        try:
            sp = cls(**kw)
        except ValueError as e:
            return str(e)
        return (sp.temperature, sp.top_p, sp.seed, sp.greedy)

    assert make(SamplingParams) == make(RefSamplingParams)


# ---- engines ---------------------------------------------------------------


@pytest.fixture(scope="module")
def decoders():
    return fp_decoders(seed=1)


@pytest.fixture(scope="module")
def prompts():
    return np.asarray(ref_calibration(256, n_segments=6, seg_len=10,
                                      seed=4).tokens, np.int32)


def _knobs(**kw):
    knobs = dict(max_seq_len=24, n_slots=4, page_size=4, token_budget=32,
                 prefill_chunk=8, record_logits=True, paged_decode=True,
                 paged_prefill=True, device_sample=True)
    knobs.update(kw)
    return knobs


def _schedule(sp_cls, prompts, idx, *, gen=10, temp=0.9, top_p=0.9,
              seed0=40, arrive=None):
    arrive = arrive or [0] * len(idx)
    return [(t, dict(prompt=prompts[i], max_new=gen,
                     sampling=sp_cls(temperature=temp, top_p=top_p,
                                     seed=seed0 + i)))
            for t, i in zip(arrive, idx)]


def _run(adapter, eng_cls, cfg_cls, sched, **kw):
    eng = eng_cls(adapter, cfg_cls(**_knobs(**kw)))
    run = drive_ticks(eng, sched)
    assert eng.pool.pages_in_use == 0 and not eng.pool._slots
    return eng, run


@pytest.mark.parametrize("device_sample", [True, False])
def test_sampled_streams_match_reference_engine(decoders, prompts,
                                                device_sample):
    ref_adapter, port_adapter = decoders
    idx = list(range(6))
    arrive = [0, 0, 1, 2, 4, 4]
    ref_eng, ref = _run(ref_adapter, RefEngine, RefEngineConfig,
                        _schedule(RefSamplingParams, prompts, idx,
                                  arrive=arrive),
                        device_sample=device_sample)
    eng, got = _run(port_adapter, Engine, EngineConfig,
                    _schedule(SamplingParams, prompts, idx, arrive=arrive),
                    device_sample=device_sample)
    partings = assert_streams_agree(got, ref, floor=ENGINE_FLOOR,
                                    draws_on_device=device_sample)
    assert len(partings) <= 1
    if not partings:
        assert got.ticks == ref.ticks
        for key in ("prefill_tokens", "decode_tokens", "steps"):
            assert eng.stats[key] == ref_eng.stats[key], key
    # the draw is real: not the greedy stream
    greedy = _run(port_adapter, Engine, EngineConfig,
                  _schedule(SamplingParams, prompts, idx, temp=0.0,
                            top_p=1.0, arrive=arrive))[1]
    assert any(got.reqs[i].out_tokens != greedy.reqs[i].out_tokens
               for i in idx)


def test_device_sampling_reproducible_across_batching(decoders, prompts):
    _, port_adapter = decoders
    solo = _run(port_adapter, Engine, EngineConfig,
                _schedule(SamplingParams, prompts, [2]))[1]
    batch = _run(port_adapter, Engine, EngineConfig,
                 _schedule(SamplingParams, prompts, [0, 1, 2, 3]))[1]
    solo.reqs = {2: solo.reqs[0]}
    batch.reqs = {2: batch.reqs[2]}
    assert not assert_streams_agree(solo, batch, floor=ENGINE_FLOOR)
    other = _run(port_adapter, Engine, EngineConfig,
                 _schedule(SamplingParams, prompts, [2], seed0=41))[1]
    assert other.reqs[0].out_tokens != solo.reqs[2].out_tokens


def test_device_sampling_survives_eviction_replay(decoders, prompts):
    """An evicted, replayed request draws the uncontended stream: every
    draw, the prefill-boundary one included, is keyed by (seed, index)."""
    _, port_adapter = decoders
    idx = [0, 1, 2]
    calm = _run(port_adapter, Engine, EngineConfig,
                _schedule(SamplingParams, prompts, idx, gen=12),
                n_slots=3, max_seq_len=22)[1]
    eng, pressed = _run(port_adapter, Engine, EngineConfig,
                        _schedule(SamplingParams, prompts, idx, gen=12),
                        n_slots=3, max_seq_len=22, n_pages=10)
    assert eng.stats["evictions"] > 0
    assert not assert_streams_agree(pressed, calm,
                                  floor=ENGINE_FLOOR)


@pytest.mark.parametrize("argv,match", [
    (["--speculative", "2"], "add --paged"),
    (["--paged", "--speculative", "-1"], "must be >= 0"),
    (["--top-p", "0.5"], "--top-p only applies"),
    (["--check", "--temperature", "0.5"], "drop --temperature"),
    (["--paged", "--temperature", "-1"], "bad sampling flags"),
    (["--paged", "--temperature", "1", "--top-p", "0"], "bad sampling flags"),
])
def test_cli_refusals_match_reference(argv, match):
    msgs = []
    for main in (port_serve.main, ref_serve.main):
        with pytest.raises(SystemExit, match=match) as e:
            main(["--smoke", "--requests", "2", "--gen", "2", *argv]
                 + (["--device", "cpu"] if main is port_serve.main else []))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("flags", [
    ["--temperature", "0.8", "--top-p", "0.9", "--sample-seed", "3"],
    ["--temperature", "0.8", "--host-sample"],
])
def test_cli_samples(flags, capsys):
    rc = port_serve.main(["--device", "cpu", "--smoke", "--paged",
                          "--paged-prefill", "--requests", "3", "--gen", "6",
                          *flags])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "outcomes: finished=3 cancelled=0 failed=0" in out
