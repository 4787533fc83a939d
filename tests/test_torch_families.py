"""The Model facade and the moe, rwkv and hybrid families on the port, held
to the JAX package at the smoke configs (2–7 layers, d 64) on the CPU.

The JAX package's ``model.init`` params are converted
(``convert.fp_params_from_numpy``); forward hidden states, aux losses,
losses, prefill logits and caches, decode logits and caches agree within
rtol = atol = 1e-4 (fp32 on both sides, summation orders only: correct
runs read at most 4.2e-6), greedy streams are equal token for token, and
the JAX package's own equivalences (prefill = forward at S-1 within 2e-4,
prefill + decode = forward within 3e-4, its test_models.py tolerances)
hold on the port.  ``weight_bits = 2`` variants of llama4-scout, arctic
and zamba2 pack their projections exactly as the JAX package does (bit
for bit) and serve them through quant_matmul's plain version.
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
from repro.launch import serve as ref_serve
from repro.models import layers as ref_layers
from repro_torch.configs import ARCH_IDS, ArchConfig, get_config
from repro_torch.configs import get_smoke_config
from repro_torch.launch import serve as port_serve
from repro_torch.models import layers as L
from repro_torch.models.lm import build_model

ARCHS = ["llama4-scout-17b-a16e", "arctic-480b", "rwkv6-1.6b", "zamba2-7b"]
PACKED = ["llama4-scout-17b-a16e", "arctic-480b", "zamba2-7b"]
RTOL = ATOL = 1e-4  # port against JAX, fp32
PREFILL_ATOL, DECODE_ATOL = 2e-4, 3e-4  # the JAX package's equivalences
B, S, P, GEN = 2, 12, 8, 5  # batch, sequence, prefill prefix, greedy tokens


def _close(got, want, rtol=RTOL, atol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


def _tokens(vocab: int, seed: int = 5) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)


@functools.lru_cache(maxsize=None)
def _run(arch: str, weight_bits: int = 0, kv: str = "fp") -> dict:
    """Both packages on the same params and tokens: forward, loss, prefill
    of the first P tokens (room for S), teacher-forced decode of the rest,
    greedy streams.  ``kv="int8"`` stores the caches int8."""
    ref, rp, port, pp = family_models(arch, weight_bits=weight_bits)
    toks = _tokens(ref.cfg.vocab)
    jt, pt = jnp.asarray(toks), torch.from_numpy(toks)
    kvj = jnp.int8 if kv == "int8" else None
    kvp = torch.int8 if kv == "int8" else None
    out = {"ref": ref, "rp": rp, "port": port, "pp": pp, "toks": toks}
    out["fwd"] = (ref.forward(rp, {"tokens": jt}),
                  port.forward(pp, {"tokens": pt}))
    out["loss"] = (ref.loss(rp, {"tokens": jt}),
                   port.loss(pp, {"tokens": pt}))
    rl, rc = ref.prefill(rp, {"tokens": jt[:, :P]}, kv_dtype=kvj, max_len=S)
    pl, pc = port.prefill(pp, {"tokens": pt[:, :P]}, kv_dtype=kvp,
                          max_len=S)
    out["prefill"] = ((rl, rc), (pl, pc))
    steps = []
    for i in range(P, S):
        rl, rc = ref.decode_step(rp, jt[:, i:i + 1], rc, jnp.int32(i))
        pl, pc = port.decode_step(pp, pt[:, i:i + 1], pc, i)
        steps.append((rl, pl))
    out["decode"] = (steps, rc, pc)
    out["greedy"] = (ref_serve.greedy_generate(ref, rp, jt[:, :P], GEN),
                     port_serve.greedy_generate(port, pp, pt[:, :P], GEN))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_hidden_and_aux_match_jax(arch):
    (rh, raux), (ph, paux) = _run(arch)["fwd"]
    assert ph.shape == (B, S, get_smoke_config(arch).d_model)
    _close(ph, rh)
    _close(paux, raux)
    if get_smoke_config(arch).family == "moe":
        assert float(paux) > 0  # the load-balancing loss is live


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_matches_jax(arch):
    (rl, rm), (pl, pm) = _run(arch)["loss"]
    _close(pl, rl)
    _close(pm["ce"], rm["ce"])
    _close(pm["aux"], rm["aux"])


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_and_cache_match_jax(arch):
    (rl, rc), (pl, pc) = _run(arch)["prefill"]
    _close(pl, rl)
    got = stack_port_cache(pc)
    want = jax.tree.map(np.asarray, rc)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    jax.tree.map(_close, got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_logits_and_cache_match_jax(arch):
    steps, rc, pc = _run(arch)["decode"]
    for rl, pl in steps:
        _close(pl, rl)
    jax.tree.map(_close, stack_port_cache(pc), jax.tree.map(np.asarray, rc))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_equals_forward_on_the_port(arch):
    """The JAX package's equivalence, on the port: prefill logits = the
    forward logits at the prompt's last position."""
    r = _run(arch)
    port, pp = r["port"], r["pp"]
    (_, _), (pl, _) = r["prefill"]
    h, _ = port.forward(pp, {"tokens": torch.from_numpy(r["toks"][:, :P])})
    _close(pl, port.logits(pp, h)[:, P - 1].numpy(), rtol=0,
           atol=PREFILL_ATOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_equals_forward_on_the_port(arch):
    """prefill(P) + teacher-forced decode = forward logits at every later
    position."""
    r = _run(arch)
    port, pp = r["port"], r["pp"]
    h, _ = port.forward(pp, {"tokens": torch.from_numpy(r["toks"])})
    full = port.logits(pp, h)
    for j, (_, pl) in enumerate(r["decode"][0]):
        _close(pl, full[:, P + j].numpy(), rtol=0, atol=DECODE_ATOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_generate_streams_equal_jax(arch):
    want, got = _run(arch)["greedy"]
    assert got.shape == (B, GEN)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", ["arctic-480b", "zamba2-7b"])
def test_int8_kv_prefill_and_decode_match_jax(arch):
    """The int8 dense cache: the same codes and scales as the JAX
    package's, and the same logits."""
    r = _run(arch, kv="int8")
    (rl, rc), (pl, pc) = r["prefill"]
    _close(pl, rl)
    got = stack_port_cache(pc)
    want = jax.tree.map(np.asarray, rc)
    kv_got = got["kv"] if "kv" in got else got
    kv_want = want["kv"] if "kv" in want else want
    assert kv_got["k"].dtype == np.int8
    np.testing.assert_array_equal(kv_got["k"], kv_want["k"])
    np.testing.assert_array_equal(kv_got["v"], kv_want["v"])
    for rl, pl in r["decode"][0]:
        _close(pl, rl)
    np.testing.assert_array_equal(r["greedy"][1].numpy(),
                                  np.asarray(r["greedy"][0]))


# ---------------------------------------------------------------------------
# packed weight_bits projections
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", PACKED)
def test_packed_forward_decode_and_greedy_match_jax(arch):
    r = _run(arch, weight_bits=2)
    attn = r["pp"]["layers" if "layers" in r["pp"] else "shared"]
    attn = attn[0]["attn"] if isinstance(attn, list) else attn["attn"]
    assert attn["wq"]["packed"].dtype == torch.int32
    (rh, _), (ph, _) = r["fwd"]
    _close(ph, rh)
    for rl, pl in r["decode"][0]:
        _close(pl, rl)
    np.testing.assert_array_equal(r["greedy"][1].numpy(),
                                  np.asarray(r["greedy"][0]))


@pytest.mark.parametrize("arch", PACKED)
def test_packed_words_bit_identical_to_jax(arch):
    """``pack_w`` of the JAX package's own fp32 draw gives its ``init_w``
    words and scale bit for bit, for each projection shape of the arch."""
    cfg = dataclasses.replace(ref_smoke(arch), weight_bits=2)
    shapes = [(cfg.d_model, cfg.q_dim), (cfg.d_model, cfg.kv_dim),
              (cfg.q_dim, cfg.d_model), (cfg.d_model, cfg.d_ff),
              (cfg.d_ff, cfg.d_model)]
    for i, shape in enumerate(shapes):
        key = jax.random.PRNGKey(i)
        want = ref_layers.init_w(key, cfg, shape, jnp.float32)
        W = ref_layers._init_dense(key, shape, jnp.float32)
        got = L.pack_w(torch.from_numpy(np.array(W)), 2)
        np.testing.assert_array_equal(got["packed"].numpy(),
                                      np.asarray(want["packed"]))
        assert got["scale"].item() == float(want["scale"])


@pytest.mark.parametrize("bits", [2, 4])
@pytest.mark.parametrize("shape", [(64, 32), (128, 64), (64, 128)])
def test_apply_w_packed_matches_jax(shape, bits):
    cfg = dataclasses.replace(ref_smoke("arctic-480b"), weight_bits=bits)
    leaf = ref_layers.init_w(jax.random.PRNGKey(3), cfg, shape, jnp.float32)
    x = np.random.default_rng(1).standard_normal((3, 5, shape[0])).astype(
        np.float32)
    want = ref_layers.apply_w(leaf, jnp.asarray(x), cfg)
    pcfg = ArchConfig.from_dict(dataclasses.asdict(cfg))
    pleaf = {k: torch.from_numpy(np.array(v)) for k, v in leaf.items()}
    for plain in (False, True):
        got = L.apply_w(pleaf, torch.from_numpy(x), pcfg, plain=plain)
        assert got.shape == (3, 5, shape[1]) and got.dtype == torch.float32
        _close(got, want)


def test_init_w_refuses_an_unpackable_width():
    cfg = dataclasses.replace(get_smoke_config("arctic-480b"), weight_bits=2)
    with pytest.raises(ValueError, match="not a multiple of 16"):
        L.init_w(torch.Generator(), cfg, (40, 8), torch.float32,
                 device="cpu")


# ---------------------------------------------------------------------------
# the facade
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS + ["qwen3-14b"])
def test_abstract_params_and_init_have_the_jax_shapes(arch):
    """``abstract_params`` (meta tensors) and a seeded ``init`` both have
    the JAX package's leaf shapes and dtypes, per layer."""
    model = build_model(get_smoke_config(arch))
    ref = jax.tree.map(np.asarray, family_models(arch)[1])
    g = torch.Generator().manual_seed(0)
    for tree in (model.abstract_params(), model.init(g, device="cpu")):
        got = {k: v for k, v in tree.items()}
        for key in ("layers", "mamba_layers"):
            if key in got:
                assert len(got[key]) == len(
                    next(iter(jax.tree.leaves(ref[key]))))
                got[key] = got[key][0]
        want = {k: (jax.tree.map(lambda a: a[0], v)
                    if k in ("layers", "mamba_layers") else v)
                for k, v in ref.items()}
        assert jax.tree.structure(got) == jax.tree.structure(want)
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            assert tuple(a.shape) == b.shape
            assert str(a.dtype).replace("torch.", "") == str(b.dtype)
    assert model.abstract_params()["embed"]["tok"].device.type == "meta"


@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_cache_axes_match_jax(arch):
    """The logical axes: the JAX package's, without the leading
    ``layers`` axis of its stacks (the port keeps layers unstacked)."""
    from repro.models import build_model as ref_build

    def unstack(ax):
        return jax.tree.map(lambda a: a[1:], ax, is_leaf=lambda v: (
            isinstance(v, tuple) and all(isinstance(e, (str, type(None)))
                                         for e in v)))

    cfg = get_smoke_config(arch)
    ref = ref_build(ref_smoke(arch))
    want = dict(ref.param_axes())
    for key in ("layers", "mamba_layers"):
        if key in want:
            want[key] = unstack(want[key])
    assert build_model(cfg).param_axes() == want
    rc = ref.cache_axes()
    want_c = ({k: unstack(v) for k, v in rc.items()}
              if cfg.family == "hybrid" else unstack(rc))
    assert build_model(cfg).cache_axes() == want_c


@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_matches_jax_shapes(arch):
    ref = family_models(arch)[0]
    want = jax.tree.map(np.asarray, ref.init_cache(2, 10))
    got = stack_port_cache(build_model(get_smoke_config(arch)).init_cache(
        2, 10, device="cpu"))
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert a.shape == b.shape and a.dtype == b.dtype and not a.any()


def test_registry_orders_arch_ids_as_jax():
    from repro.configs import ARCH_IDS as REF_IDS
    from repro.configs import _MODULES as REF_MODULES
    from repro_torch.configs import ARCHS

    assert ARCH_IDS == REF_IDS
    assert list(ARCHS) == list(REF_MODULES)
    for arch in ARCHS:
        assert build_model(get_config(arch)).cfg.name == arch
    with pytest.raises(KeyError):
        get_config("whisper-medium")


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("size", ["full", "smoke"])
def test_config_from_dict_round_trips(arch, size):
    ref = ref_config(arch) if size == "full" else ref_smoke(arch)
    want = get_config(arch) if size == "full" else get_smoke_config(arch)
    assert ArchConfig.from_dict(dataclasses.asdict(ref)) == want
    assert ArchConfig.from_dict(dataclasses.asdict(want)) == want
    for f in ("d_inner", "ssm_heads", "q_dim", "kv_dim"):
        assert getattr(want, f) == getattr(ref, f)


NEW_FIELDS = {"n_experts": 7, "top_k": 3, "dense_residual": True,
              "capacity_factor": 2.5, "ssm_state": 12, "ssm_conv": 3,
              "ssm_expand": 3, "ssm_head_dim": 16, "shared_attn_period": 4,
              "rwkv_head_size": 8, "rwkv_decay_lora": 5, "rwkv_mix_lora": 6,
              "weight_bits": 2}


@pytest.mark.parametrize("field", sorted(NEW_FIELDS))
def test_config_from_dict_carries_each_new_field(field):
    d = dataclasses.asdict(ref_smoke("arctic-480b"))
    d[field] = NEW_FIELDS[field]
    cfg = ArchConfig.from_dict(d)
    assert getattr(cfg, field) == NEW_FIELDS[field]
    assert cfg == dataclasses.replace(get_smoke_config("arctic-480b"),
                                      **{field: NEW_FIELDS[field]})


# ---------------------------------------------------------------------------
# the serve CLI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_serves_through_the_batch_fallback(arch, capsys):
    rc = port_serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                          "--requests", "3", "--prompt-len", "8", "--gen",
                          "4"])
    out = capsys.readouterr().out
    assert rc == 0
    assert (f"[serve] fp {arch}-smoke (batch fallback, family="
            f"{get_smoke_config(arch).family}): 12 tokens in ") in out


def _refusal(main, argv) -> str:
    with pytest.raises(SystemExit) as e:
        main(argv)
    return str(e.value)


@pytest.mark.parametrize("flags", [["--quantize"], ["--check"],
                                   ["--mesh", "1,1"]])
def test_serve_cli_refusals_equal_jax(flags):
    """A non-dense arch refuses the dense engine's flags with the JAX
    CLI's texts (the port refuses ``--mesh`` before it starts any rank)."""
    argv = ["--arch", "zamba2-7b", "--smoke", "--requests", "2", *flags]
    want = _refusal(ref_serve.main, argv)
    got = _refusal(port_serve.main, argv + ["--device", "cpu"])
    assert got == want
    assert "dense" in got


def test_serve_cli_fp_check_runs_the_prefill_decode_oracle(capsys):
    rc = port_serve.main(["--smoke", "--device", "cpu", "--requests", "3",
                          "--prompt-len", "8", "--gen", "6", "--paged",
                          "--paged-prefill", "--check"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert ("check vs fp prefill/decode: token agreement 100.00% over 18 "
            "tokens") in out
