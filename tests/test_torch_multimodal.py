"""The encdec (whisper-small) and vlm (llama-3.2-vision-90b) families on the
port, held to the JAX package at the smoke configs (2 + 2 and 4 layers, d
64) on the CPU.

Inputs come from a numpy seed: tokens (B, S), frames (B, S_ENC, d) and
patches (B, n_patches, d).  A fresh init sets every vlm gate (``xattn.gate``,
``mlp_gate``) to 0, which leaves the cross path inert, so both param trees
here carry seeded gates in [0.3, 0.9] with random signs
(:func:`_with_gates`).  Forward hidden states, losses, prefill logits and
both caches, decode logits and caches agree within rtol = atol = 1e-4
(fp32 on both sides, summation orders only: correct runs read at most
2.5e-6); greedy streams are equal token for token; the JAX package's own
equivalences (prefill = forward within 2e-4, decode = forward within 3e-4)
hold on the port.  ``weight_bits = 2``: the JAX package's prefill raises
in its ``_cross_kv`` (a packed leaf multiplied directly), so the port's
packed prefill and decode are held to the JAX *forward*.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import family_models, stack_port_cache

from repro.configs import get_config as ref_config
from repro.configs import get_smoke_config as ref_smoke
from repro.models import build_model as ref_build
from repro.models import layers as ref_layers
from repro_torch import convert
from repro_torch.configs import ArchConfig, get_config, get_smoke_config
from repro_torch.launch import serve as port_serve
from repro_torch.models import layers as L
from repro_torch.models import multimodal as MM
from repro_torch.models.lm import build_model

ARCHS = ["whisper-small", "llama-3.2-vision-90b"]
RTOL = ATOL = 1e-4  # port against JAX, fp32
PREFILL_ATOL, DECODE_ATOL = 2e-4, 3e-4  # the JAX package's equivalences
B, S, P, GEN = 2, 12, 8, 5  # batch, sequence, prefill prefix, greedy tokens
S_ENC = 20  # whisper frames (the vlm takes its config's n_patches)
STACKS = ("enc_layers", "dec_layers", "self_layers", "cross_layers")
# a vlm with a tail: 2 superblocks of (1 self + 1 cross), then 1 self layer
TAIL = dict(n_layers=5, cross_every=2)


def _close(got, want, rtol=RTOL, atol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


def _embed_key(cfg) -> str:
    return "frames" if cfg.family == "encdec" else "patches"


def _inputs(cfg, seed: int = 5) -> dict:
    """Seeded numpy tokens and the family's stub embeddings."""
    rng = np.random.default_rng(seed)
    n = S_ENC if cfg.family == "encdec" else cfg.n_patches
    return {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
            _embed_key(cfg): rng.standard_normal((B, n, cfg.d_model))
            .astype(np.float32)}


def _with_gates(rp: dict, seed: int = 11) -> dict:
    """The JAX vlm tree with every cross layer's ``xattn.gate`` and
    ``mlp_gate`` set to seeded values of magnitude 0.3-0.9."""
    rng = np.random.default_rng(seed)
    cl = rp["cross_layers"]
    n = cl["mlp_gate"].shape[0]

    def draw():
        v = rng.uniform(0.3, 0.9, n) * rng.choice([-1.0, 1.0], n)
        return jnp.asarray(v, cl["mlp_gate"].dtype)

    return {**rp, "cross_layers": {**cl, "mlp_gate": draw(),
                                   "xattn": {**cl["xattn"], "gate": draw()}}}


@functools.lru_cache(maxsize=None)
def _models(arch: str, weight_bits: int = 0, tail: bool = False,
            attn_bf16_probs: bool = False):
    """(ref model, ref params, port model, port params); vlm gates set."""
    over = dict(weight_bits=weight_bits, attn_bf16_probs=attn_bf16_probs)
    if tail:
        over.update(TAIL)
    ref, rp, port, pp = family_models(arch, **over)
    if ref.cfg.family == "vlm":
        rp = _with_gates(rp)
        pp = convert.fp_params_from_numpy(jax.tree.map(np.asarray, rp),
                                          device="cpu")
    return ref, rp, port, pp


def _batches(inp: dict, n: int = S):
    """The numpy inputs cut to n tokens, as a JAX and a port batch."""
    cut = {k: (v[:, :n] if k == "tokens" else v) for k, v in inp.items()}
    return ({k: jnp.asarray(v) for k, v in cut.items()},
            {k: torch.from_numpy(v) for k, v in cut.items()})


def _ref_greedy(model, params, batch, gen):
    logits, cache = model.prefill(params, batch, max_len=P + gen)
    out = []
    for i in range(gen):
        tok = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
        out.append(tok)
        if i + 1 < gen:
            logits, cache = model.decode_step(params, tok, cache,
                                              jnp.int32(P + i))
    return np.asarray(jnp.concatenate(out, 1))


def _port_greedy(model, params, batch, gen):
    logits, cache = model.prefill(params, batch, max_len=P + gen)
    out = []
    for i in range(gen):
        tok = torch.argmax(logits, -1)[:, None]
        out.append(tok)
        if i + 1 < gen:
            logits, cache = model.decode_step(params, tok, cache, P + i)
    return torch.cat(out, 1).numpy()


@functools.lru_cache(maxsize=None)
def _run(arch: str, weight_bits: int = 0, kv: str = "fp",
         tail: bool = False) -> dict:
    """Both packages on the same params and inputs: forward, loss, prefill
    of the first P tokens (room for S), teacher-forced decode of the rest,
    greedy streams.  ``kv="int8"`` stores the self caches int8.  Packed
    runs skip the JAX prefill and decode (they raise)."""
    ref, rp, port, pp = _models(arch, weight_bits, tail)
    inp = _inputs(ref.cfg)
    jb, pb = _batches(inp)
    kvj = jnp.int8 if kv == "int8" else None
    kvp = torch.int8 if kv == "int8" else None
    out = {"ref": ref, "rp": rp, "port": port, "pp": pp, "inp": inp}
    out["fwd"] = ref.forward(rp, jb), port.forward(pp, pb)
    out["loss"] = ref.loss(rp, jb), port.loss(pp, pb)
    jp, pp_b = _batches(inp, P)
    out["port_prefill"] = pl, pc = port.prefill(pp, pp_b, kv_dtype=kvp,
                                                max_len=S)
    psteps = []
    for i in range(P, S):
        lg, pc = port.decode_step(pp, pb["tokens"][:, i:i + 1], pc, i)
        psteps.append(lg)
    out["port_decode"] = psteps, pc
    out["port_greedy"] = _port_greedy(port, pp, pp_b, GEN)
    if weight_bits:
        return out
    out["ref_prefill"] = rl, rc = ref.prefill(rp, jp, kv_dtype=kvj,
                                              max_len=S)
    rsteps = []
    for i in range(P, S):
        lg, rc = ref.decode_step(rp, jb["tokens"][:, i:i + 1], rc,
                                 jnp.int32(i))
        rsteps.append(lg)
    out["ref_decode"] = rsteps, rc
    out["ref_greedy"] = _ref_greedy(ref, rp, jp, GEN)
    return out


RUNS = [(a, False) for a in ARCHS] + [("llama-3.2-vision-90b", True)]
RUN_IDS = ["whisper", "vlm", "vlm-tail"]


@pytest.mark.parametrize("arch,tail", RUNS, ids=RUN_IDS)
def test_forward_hidden_matches_jax(arch, tail):
    (rh, raux), (ph, paux) = _run(arch, tail=tail)["fwd"]
    assert ph.shape == (B, S, get_smoke_config(arch).d_model)
    _close(ph, rh)
    _close(paux, raux)


@pytest.mark.parametrize("arch,tail", RUNS, ids=RUN_IDS)
def test_loss_matches_jax(arch, tail):
    (rl, rm), (pl, pm) = _run(arch, tail=tail)["loss"]
    _close(pl, rl)
    _close(pm["ce"], rm["ce"])


@pytest.mark.parametrize("arch,tail", RUNS, ids=RUN_IDS)
def test_prefill_logits_and_both_caches_match_jax(arch, tail):
    r = _run(arch, tail=tail)
    (rl, rc), (pl, pc) = r["ref_prefill"], r["port_prefill"]
    _close(pl, rl)
    got, want = stack_port_cache(pc), jax.tree.map(np.asarray, rc)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    assert set(got) == {"self", "cross"}
    jax.tree.map(_close, got, want)


@pytest.mark.parametrize("arch,tail", RUNS, ids=RUN_IDS)
def test_decode_step_logits_and_caches_match_jax(arch, tail):
    r = _run(arch, tail=tail)
    (rsteps, rc), (psteps, pc) = r["ref_decode"], r["port_decode"]
    for rl, pl in zip(rsteps, psteps):
        _close(pl, rl)
    jax.tree.map(_close, stack_port_cache(pc), jax.tree.map(np.asarray, rc))


@pytest.mark.parametrize("arch,tail", RUNS, ids=RUN_IDS)
def test_greedy_streams_equal_jax(arch, tail):
    r = _run(arch, tail=tail)
    assert r["port_greedy"].shape == (B, GEN)
    np.testing.assert_array_equal(r["port_greedy"], r["ref_greedy"])


# one int8 code step (max |k| / 127 of a token's head) in one position
INT8_ATOL = 1e-3


def _codes_equal_but_near_ties(got, want, unrounded):
    """int8 codes equal, but where the unrounded value lies within 1e-3 of
    a rounding tie (x.5): there the two packages' fp32 K/V, equal to a few
    ulps, may round to neighbouring codes."""
    differ = got != want
    tie = np.abs(np.abs(unrounded - np.floor(unrounded)) - 0.5) < 1e-3
    assert not (differ & ~tie).any()
    assert np.abs(got.astype(int) - want).max(initial=0) <= 1
    assert differ.mean() < 1e-3


@pytest.mark.parametrize("arch", ARCHS)
def test_int8_self_cache_prefill_and_decode_match_jax(arch):
    """int8 self caches: the JAX package's codes (but at rounding ties) and
    scales; the cross caches stay in the model's dtype.  Logits within
    ``INT8_ATOL``: whisper's prefill rounds one code of 3,072 the other way
    at a tie, which moves its decode logits by up to 3.2e-4."""
    r = _run(arch, kv="int8")
    (rl, rc), (pl, pc) = r["ref_prefill"], r["port_prefill"]
    _close(pl, rl)
    got, want = stack_port_cache(pc), jax.tree.map(np.asarray, rc)
    assert got["self"]["k"].dtype == np.int8
    assert got["cross"]["k"].dtype == np.float32
    fp = stack_port_cache(_run(arch)["port_prefill"][1])["self"]
    for n in ("k", "v"):
        _codes_equal_but_near_ties(got["self"][n], want["self"][n],
                                   fp[n] / want["self"][f"{n}_scale"][
                                       ..., None])
    _close(got["self"]["k_scale"], want["self"]["k_scale"])
    _close(got["cross"]["k"], want["cross"]["k"])
    for rl, pl in zip(r["ref_decode"][0], r["port_decode"][0]):
        _close(pl, rl, atol=INT8_ATOL)
    np.testing.assert_array_equal(r["port_greedy"], r["ref_greedy"])


# ---------------------------------------------------------------------------
# the port's own equivalences
# ---------------------------------------------------------------------------


def _port_forward_logits(r, n):
    port, pp = r["port"], r["pp"]
    h, _ = port.forward(pp, _batches(r["inp"], n)[1])
    return port.logits(pp, h)


@pytest.mark.parametrize("weight_bits", [0, 2])
@pytest.mark.parametrize("arch,tail", RUNS, ids=RUN_IDS)
def test_prefill_equals_forward_on_the_port(arch, tail, weight_bits):
    r = _run(arch, weight_bits, tail=tail)
    pl, _ = r["port_prefill"]
    _close(pl, _port_forward_logits(r, P)[:, P - 1].numpy(), rtol=0,
           atol=PREFILL_ATOL)


@pytest.mark.parametrize("weight_bits", [0, 2])
@pytest.mark.parametrize("arch,tail", RUNS, ids=RUN_IDS)
def test_decode_equals_forward_on_the_port(arch, tail, weight_bits):
    r = _run(arch, weight_bits, tail=tail)
    full = _port_forward_logits(r, S)
    for j, pl in enumerate(r["port_decode"][0]):
        _close(pl, full[:, P + j].numpy(), rtol=0, atol=DECODE_ATOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_rolled_embeddings_move_the_logits(arch):
    """The guard of the cross path: the same tokens beside another row's
    frames / patches move the forward logits by far more than the
    tolerance (the vlm's gates are live)."""
    r = _run(arch)
    port, pp, inp = r["port"], r["pp"], r["inp"]
    key = _embed_key(port.cfg)
    _, pb = _batches(inp)
    rolled = {**pb, key: torch.roll(pb[key], 1, dims=0)}
    d = (port.logits(pp, port.forward(pp, rolled)[0])
         - port.logits(pp, port.forward(pp, pb)[0])).abs().max()
    assert float(d) > 100 * ATOL, float(d)


def test_fresh_vlm_gates_leave_the_cross_path_inert():
    """At init (gates 0) the patches change nothing, on both packages: why
    the parity runs here set the gates."""
    ref, rp, port, pp = family_models("llama-3.2-vision-90b")
    inp = _inputs(ref.cfg)
    jb, pb = _batches(inp)
    rolled = {**pb, "patches": torch.roll(pb["patches"], 1, dims=0)}
    a, _ = port.forward(pp, pb)
    b, _ = port.forward(pp, rolled)
    assert torch.equal(a, b)
    _close(a, ref.forward(rp, jb)[0])


# ---------------------------------------------------------------------------
# packed weight_bits projections
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_packed_forward_matches_jax(arch):
    r = _run(arch, weight_bits=2)
    layer = r["pp"]["dec_layers" if "dec_layers" in r["pp"]
                    else "cross_layers"][0]
    assert layer["xattn"]["wk"]["packed"].dtype == torch.int32
    (rh, _), (ph, _) = r["fwd"]
    _close(ph, rh)
    (rl, _), (pl, _) = r["loss"]
    _close(pl, rl)


@pytest.mark.parametrize("arch", ARCHS)
def test_packed_prefill_and_decode_match_the_jax_forward(arch):
    """The JAX package's packed prefill raises (reference caveat), so the
    port's packed prefill and teacher-forced decode are held to the JAX
    forward logits at the same positions."""
    r = _run(arch, weight_bits=2)
    ref, rp, inp = r["ref"], r["rp"], r["inp"]
    jp, _ = _batches(inp, P)
    with pytest.raises(TypeError, match="unsupported operand"):
        ref.prefill(rp, jp, max_len=S)
    pre = ref.logits(rp, ref.forward(rp, jp)[0])[:, P - 1]
    _close(r["port_prefill"][0], pre, rtol=0, atol=PREFILL_ATOL)
    full = ref.logits(rp, ref.forward(rp, _batches(inp)[0])[0])
    for j, pl in enumerate(r["port_decode"][0]):
        _close(pl, full[:, P + j], rtol=0, atol=DECODE_ATOL)


def test_packed_cross_kv_goes_through_quant_matmul(monkeypatch):
    """Every projection of a packed prefill, the cross K/V included, runs
    through quant_matmul (here its plain version, on the CPU): the
    encoder's 6, and per decoder layer 4 self, 4 cross and 2 MLP."""
    r = _run("whisper-small", weight_bits=2)
    calls = []
    orig = L.quant_matmul

    def counted(x, *a, **k):
        calls.append(tuple(x.shape))
        return orig(x, *a, **k)

    monkeypatch.setattr(L, "quant_matmul", counted)
    cfg = r["port"].cfg
    r["port"].prefill(r["pp"], _batches(r["inp"], P)[1], max_len=S)
    assert len(calls) == 6 * cfg.n_enc_layers + 10 * cfg.n_dec_layers
    # rows of the encoder's length: its wq wk wv wo wi, and the cross K/V
    # once per decoder layer
    assert calls.count((B, S_ENC, cfg.d_model)) == (
        5 * cfg.n_enc_layers + 2 * cfg.n_dec_layers)


# ---------------------------------------------------------------------------
# attn_bf16_probs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen3-14b", "llama-3.2-vision-90b"])
def test_attn_bf16_probs_forward_matches_jax(arch):
    """The bf16-probabilities forward against the JAX package's, run op by
    op (``jax.disable_jit``) at rtol = atol = 1e-4 (read 1.4e-6 and
    1.7e-6).  Under jit, XLA's CPU compiler keeps excess precision and
    skips the bf16 roundings (its own jit and eager runs differ by 1.1e-2,
    0.7 of the branch's whole effect), so only the op-by-op run is the
    function as written."""
    if arch == "qwen3-14b":
        ref, rp, port, pp = family_models(arch, attn_bf16_probs=True)
    else:
        ref, rp, port, pp = _models(arch, attn_bf16_probs=True)
    assert port.cfg.attn_bf16_probs
    inp = _inputs(ref.cfg)
    if ref.cfg.family != "vlm":
        inp = {"tokens": inp["tokens"]}
    jb, pb = _batches(inp)
    with jax.disable_jit():
        rh, _ = ref.forward(rp, jb)
    ph, _ = port.forward(pp, pb)
    _close(ph, rh)
    # the branch is live: fp32 probabilities give other hidden states
    fp32 = build_model(dataclasses.replace(port.cfg, attn_bf16_probs=False))
    assert float((fp32.forward(pp, pb)[0] - ph).abs().max()) > 0


def test_bf16_softmax_matches_jax_branch():
    """The branch alone on seeded scores: the JAX package's expression
    (fp32 max and sum, bf16 exp and probabilities)."""
    s = np.random.default_rng(2).standard_normal((3, 4, 17)).astype(
        np.float32) * 4
    js = jnp.asarray(s)
    m = jnp.max(js, axis=-1, keepdims=True)
    p = jnp.exp(js - m).astype(jnp.bfloat16)
    want = p / jnp.sum(p.astype(jnp.float32), -1, keepdims=True).astype(
        jnp.bfloat16)
    got = L._bf16_softmax(torch.from_numpy(s))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=2**-7,
                               atol=0)


# ---------------------------------------------------------------------------
# the facade, configs and the CLI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_params_and_init_have_the_jax_shapes(arch):
    model = build_model(get_smoke_config(arch))
    ref = jax.tree.map(np.asarray, family_models(arch)[1])
    want = {k: (jax.tree.map(lambda a: a[0], v) if k in STACKS else v)
            for k, v in ref.items()}
    g = torch.Generator().manual_seed(0)
    for tree in (model.abstract_params(), model.init(g, device="cpu")):
        got = dict(tree)
        for key in STACKS:
            if key in got:
                assert len(got[key]) == len(
                    next(iter(jax.tree.leaves(ref[key]))))
                got[key] = got[key][0]
        assert jax.tree.structure(got) == jax.tree.structure(want)
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            assert tuple(a.shape) == b.shape
            assert str(a.dtype).replace("torch.", "") == str(b.dtype)


def _unstack(ax):
    return jax.tree.map(lambda a: a[1:], ax, is_leaf=lambda v: (
        isinstance(v, tuple) and all(isinstance(e, (str, type(None)))
                                     for e in v)))


@pytest.mark.parametrize("weight_bits", [0, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_cache_axes_match_jax(arch, weight_bits):
    cfg = dataclasses.replace(get_smoke_config(arch), weight_bits=weight_bits)
    ref = ref_build(dataclasses.replace(ref_smoke(arch),
                                        weight_bits=weight_bits))
    want = {k: (_unstack(v) if k in STACKS else v)
            for k, v in ref.param_axes().items()}
    assert build_model(cfg).param_axes() == want
    for int8 in (False, True):
        want_c = {k: _unstack(v) for k, v in ref.cache_axes(int8).items()}
        assert build_model(cfg).cache_axes(int8) == want_c


@pytest.mark.parametrize("kv", [None, "int8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_matches_jax_shapes(arch, kv):
    ref = family_models(arch)[0]
    want = jax.tree.map(np.asarray, ref.init_cache(
        2, 10, jnp.int8 if kv else None))
    got = stack_port_cache(build_model(get_smoke_config(arch)).init_cache(
        2, 10, torch.int8 if kv else None, device="cpu"))
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert a.shape == b.shape and a.dtype == b.dtype and not a.any()


def test_vlm_counts_match_jax():
    from repro.models.multimodal import _vlm_counts as ref_counts

    for n, every in ((4, 2), (5, 2), (100, 5), (7, 3)):
        cfg = dataclasses.replace(get_smoke_config("llama-3.2-vision-90b"),
                                  n_layers=n, cross_every=every)
        want = ref_counts(dataclasses.replace(
            ref_smoke("llama-3.2-vision-90b"), n_layers=n, cross_every=every))
        assert MM._vlm_counts(cfg) == want
    assert MM._vlm_counts(get_config("llama-3.2-vision-90b")) == (20, 4, 80, 0)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("size", ["full", "smoke"])
def test_config_from_dict_round_trips(arch, size):
    ref = ref_config(arch) if size == "full" else ref_smoke(arch)
    want = get_config(arch) if size == "full" else get_smoke_config(arch)
    assert ArchConfig.from_dict(dataclasses.asdict(ref)) == want
    for f in ("n_enc_layers", "n_dec_layers", "cross_every", "n_patches",
              "q_dim", "kv_dim", "mlp", "mlp_bias", "rope_theta"):
        assert getattr(want, f) == getattr(ref, f)


NEW_FIELDS = {"n_enc_layers": 3, "n_dec_layers": 5, "cross_every": 4,
              "n_patches": 48, "attn_bf16_probs": True}


@pytest.mark.parametrize("field", sorted(NEW_FIELDS))
def test_config_from_dict_carries_each_new_field(field):
    d = dataclasses.asdict(ref_smoke("whisper-small"))
    d[field] = NEW_FIELDS[field]
    cfg = ArchConfig.from_dict(d)
    assert getattr(cfg, field) == NEW_FIELDS[field]
    assert cfg == dataclasses.replace(get_smoke_config("whisper-small"),
                                      **{field: NEW_FIELDS[field]})


@pytest.mark.parametrize("arch", ARCHS)
def test_config_from_dict_refuses_qk_norm_on_the_cross_families(arch):
    d = dataclasses.asdict(ref_smoke(arch))
    d["qk_norm"] = True
    with pytest.raises(ValueError, match="^qk_norm=True .*k_norm"):
        ArchConfig.from_dict(d)
    # the same flag on a decoder-only family is modelled
    d = dataclasses.asdict(ref_smoke("llama2-70b"))
    d["qk_norm"] = True
    assert ArchConfig.from_dict(d).qk_norm


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_refuses_the_families_with_the_reason(arch):
    want = "frames" if arch == "whisper-small" else "patches"
    for smoke in (["--smoke"], []):
        with pytest.raises(SystemExit) as e:
            port_serve.main(["--arch", arch, *smoke, "--device", "cpu",
                             "--requests", "2"])
        assert str(e.value).startswith(f"--arch {arch}: the ")
        assert f"needs {want} embeddings" in str(e.value)


def test_cross_attention_decode_reads_the_cache_unmasked():
    """attention_decode(cross=True) over a stored cache equals the full
    cross attention of one query against x_kv, at any position."""
    cfg = get_smoke_config("llama-3.2-vision-90b")
    g = torch.Generator().manual_seed(3)
    p = L.init_attention(g, cfg, device="cpu", cross=True)
    p["gate"] = torch.tensor(0.6)
    x = torch.randn(B, 1, cfg.d_model, generator=g)
    kv = torch.randn(B, 9, cfg.d_model, generator=g)
    want, (k, v) = L.attention_full(p, x, cfg, positions=torch.zeros(
        1, dtype=torch.int32), causal=False, x_kv=kv, return_kv=True)
    for pos in (0, 7):
        got, c = L.attention_decode(p, x, cfg, {"k": k, "v": v}, pos,
                                    cross=True)
        _close(got, want.numpy(), rtol=1e-5, atol=1e-6)
        assert c["k"] is k
    # and against the JAX package's attention_decode(cross=True)
    rcfg = ref_smoke("llama-3.2-vision-90b")
    rp = {n: jnp.asarray(t.numpy()) for n, t in p.items()}
    rwant, _ = ref_layers.attention_decode(
        rp, jnp.asarray(x.numpy()), rcfg,
        {"k": jnp.asarray(k.numpy()), "v": jnp.asarray(v.numpy())},
        jnp.int32(7), cross=True)
    _close(got, rwant)
