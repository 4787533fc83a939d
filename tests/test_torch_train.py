"""The port's training slice against the JAX package: ``token_batches``,
``make_train_step`` (over the JAX init converted into the stacked layout),
remat in every family's forward, and the fault-tolerant train CLI.

Tolerances (fp32 on both sides; read on this CPU):
* ``loss`` and ``grad_norm`` after each step: relative 1e-5 (read
  ≤ 2.9e-6);
* every leaf of the new params and optimizer state: max |Δ| ≤ 5e-4 ·
  max |leaf| (read ≤ 1.3e-4, adamw's moments of the MoE router);
* remat ``none`` / ``full`` / ``dots``: gradients equal bit for bit (the
  recomputed forward runs the same ops on the same inputs);
* the CLI's fault drill: the final checkpoint equals an uninterrupted
  run's bit for bit.
"""
from __future__ import annotations

import dataclasses
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro import optim as RO
from repro.checkpoint.store import _flatten_with_paths as ref_flatten
from repro.data import token_batches as ref_token_batches
from repro.launch.steps import make_train_step as ref_make_train_step
from repro_torch import optim as PO
from repro_torch.checkpoint.store import latest_step, load_arrays
from repro_torch.configs import get_smoke_config
from repro_torch.convert import layer_views, stack_layers
from repro_torch.data.synthetic import token_batches
from repro_torch.launch import train as tr
from repro_torch.launch.steps import (make_decode_step, make_prefill_step,
                                      make_train_step, split_microbatches)
from repro_torch.models.lm import build_model
from repro_torch.tree import flatten_with_paths, unflatten
from torch_parity import family_models

ROOT = pathlib.Path(__file__).resolve().parents[1]
LOSS_RTOL = 1e-5
LEAF_RTOL = 5e-4

OPTS = {
    "sgd": (lambda m: m.sgd(0.1)),
    "adamw": (lambda m: m.adamw(m.cosine_schedule(3e-4, 8, 1))),
}


def _np32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


# ---------------------------------------------------------------------------
# token_batches
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("vocab,batch,seq,seed,start", [
    (256, 4, 16, 0, 0), (512, 2, 33, 3, 5), (151936, 2, 8, 1, 1000)])
def test_token_batches_equal_the_jax_stream(vocab, batch, seq, seed, start):
    ref = ref_token_batches(vocab, batch, seq, seed=seed, start_step=start)
    port = token_batches(vocab, batch, seq, seed=seed, start_step=start,
                         device="cpu")
    for _ in range(3):
        r, p = next(ref), next(port)
        for k in ("tokens", "targets"):
            assert p[k].dtype == torch.int32 and p[k].device.type == "cpu"
            np.testing.assert_array_equal(p[k].numpy(), np.asarray(r[k]))


def test_token_stream_resumes_and_targets_shift():
    a = token_batches(512, 4, 32, seed=3, device="cpu")
    x = [next(a) for _ in range(4)]
    c = next(token_batches(512, 4, 32, seed=3, start_step=3, device="cpu"))
    assert torch.equal(c["tokens"], x[3]["tokens"])
    assert torch.equal(x[0]["tokens"][:, 1:], x[0]["targets"][:, :-1])
    assert tuple(x[0]["targets"].shape) == (4, 32)


def test_split_microbatches():
    b = {"tokens": torch.arange(24).reshape(4, 6)}
    m = split_microbatches(b, 2)
    assert tuple(m["tokens"].shape) == (2, 2, 6)
    assert torch.equal(m["tokens"][1], b["tokens"][2:])
    with pytest.raises(ValueError):
        split_microbatches(b, 3)


# ---------------------------------------------------------------------------
# make_train_step against the JAX package's jitted step
# ---------------------------------------------------------------------------


def _step_cases():
    cases = [("qwen3-14b", o, n) for o in OPTS for n in (1, 2)]
    cases += [(a, "sgd", 2) for a in ("llama4-scout-17b-a16e", "rwkv6-1.6b",
                                      "zamba2-7b")]
    return cases


@pytest.mark.parametrize("arch,opt,n_micro", _step_cases())
def test_train_step_matches_jax(arch, opt, n_micro):
    ref_model, rp, port_model, pp = family_models(arch)
    pp = stack_layers(pp)
    ro, po = OPTS[opt](RO), OPTS[opt](PO)
    rs, ps = ro.init(rp), po.init(pp)
    rstep = jax.jit(ref_make_train_step(ref_model, ro, n_micro=n_micro))
    pstep = make_train_step(port_model, po, n_micro=n_micro)
    vocab = ref_model.cfg.vocab
    rb = ref_token_batches(vocab, 4, 16, seed=1)
    pb = token_batches(vocab, 4, 16, seed=1, device="cpu")
    for step in range(2):
        rp, rs, rm = rstep(rp, rs, next(rb), jnp.int32(step))
        pp, ps, pm = pstep(pp, ps, next(pb), step)
        for k in ("loss", "grad_norm"):
            assert pm[k].dtype == torch.float32 and pm[k].shape == ()
            np.testing.assert_allclose(float(pm[k]), float(rm[k]),
                                       rtol=LOSS_RTOL, err_msg=k)
    want = dict(ref_flatten({"params": rp, "opt": rs})[0])
    got = dict(flatten_with_paths({"params": pp, "opt": ps}))
    assert list(got) == list(want)
    for k, w in want.items():
        b = _np32(w)
        assert tuple(got[k].shape) == b.shape, k
        np.testing.assert_allclose(
            _np32(got[k]), b, rtol=0,
            atol=LEAF_RTOL * (float(np.abs(b).max()) or 1.0), err_msg=k)


def test_train_step_sums_fp32_microbatch_grads_of_bf16_params():
    """bf16 params: each microbatch's bf16 gradient is cast to fp32 before
    it is added, as the JAX package's scan does — not summed in bf16."""
    cfg = dataclasses.replace(get_smoke_config("qwen3-14b"),
                              dtype="bfloat16")
    model = build_model(cfg)
    g = torch.Generator().manual_seed(0)
    params = stack_layers(model.init(g, device="cpu"))
    batch = next(token_batches(cfg.vocab, 4, 16, seed=2, device="cpu"))
    seen = []

    def update(grads, state, p, step):
        seen.append(grads)
        return p, state, {"grad_norm": PO.global_norm(grads)}

    step = make_train_step(model, PO.Optimizer(init=lambda p: {},
                                               update=update), n_micro=2)
    _, _, m = step(params, {}, batch, 0)
    grads = seen[0]
    want = {}
    leaves = [p.detach().requires_grad_() for _, p in
              flatten_with_paths(params)]
    keys = [k for k, _ in flatten_with_paths(params)]
    views = layer_views(unflatten(params, dict(zip(keys, leaves))))
    for i in range(2):
        mb = {k: v[2 * i:2 * i + 2] for k, v in batch.items()}
        loss, _ = model.loss(views, mb)
        for k, gr in zip(keys, torch.autograd.grad(loss, leaves)):
            assert gr.dtype == torch.bfloat16
            want[k] = want.get(k, 0) + gr.float()
    for k, gr in flatten_with_paths(grads):
        assert gr.dtype == torch.float32
        assert torch.equal(gr, want[k] / 2), k
    assert m["loss"].dtype == torch.float32


def test_prefill_and_decode_steps_take_the_stacked_state():
    ref_model, rp, port_model, pp = family_models("qwen3-14b")
    toks = next(token_batches(256, 2, 8, seed=4, device="cpu"))["tokens"]
    want, _ = port_model.prefill(pp, {"tokens": toks}, max_len=10)
    got, cache = make_prefill_step(port_model)(stack_layers(pp),
                                               {"tokens": toks})
    assert torch.equal(got, want)
    lg, _ = make_decode_step(port_model)(stack_layers(pp), toks[:, :1],
                                         port_model.prefill(
                                             pp, {"tokens": toks},
                                             max_len=10)[1], 8)
    assert lg.shape == (2, 256) and bool(torch.isfinite(lg).all())


# ---------------------------------------------------------------------------
# remat
# ---------------------------------------------------------------------------

REMAT_ARCHS = ["qwen3-14b", "llama4-scout-17b-a16e", "rwkv6-1.6b",
               "zamba2-7b", "whisper-small", "llama-3.2-vision-90b"]


def _family_batch(cfg, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 12),
                                         dtype=np.int32))
    batch = {"tokens": toks}
    if cfg.family == "encdec":
        batch["frames"] = torch.from_numpy(
            rng.standard_normal((2, 10, cfg.d_model)).astype(np.float32))
    if cfg.family == "vlm":
        batch["patches"] = torch.from_numpy(rng.standard_normal(
            (2, cfg.n_patches, cfg.d_model)).astype(np.float32))
    return batch


class _CountMM(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.n += 1
        return func(*args, **(kwargs or {}))


def _remat_grads(arch: str, remat: str):
    cfg = dataclasses.replace(get_smoke_config(arch), remat=remat)
    model = build_model(cfg)
    g = torch.Generator().manual_seed(3)
    params = stack_layers(model.init(g, device="cpu"))
    if cfg.family == "vlm":  # a fresh init's gates of 0 leave cross inert
        cl = params["cross_layers"]
        cl["mlp_gate"] = torch.full_like(cl["mlp_gate"], 0.5)
        cl["xattn"]["gate"] = torch.full_like(cl["xattn"]["gate"], -0.7)
    keys = [k for k, _ in flatten_with_paths(params)]
    leaves = [p.requires_grad_() for _, p in flatten_with_paths(params)]
    views = layer_views(unflatten(params, dict(zip(keys, leaves))))
    with _CountMM() as mm:
        loss, _ = model.loss(views, _family_batch(cfg))
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), dict(zip(keys, grads)), mm.n


@pytest.mark.parametrize("arch", REMAT_ARCHS)
def test_remat_modes_give_equal_gradients(arch):
    loss0, g0, mm0 = _remat_grads(arch, "none")
    for mode in ("full", "dots"):
        loss, g, mm = _remat_grads(arch, mode)
        assert torch.equal(loss, loss0), mode
        for k, v in g0.items():
            if v is None:
                assert g[k] is None, (mode, k)
            else:
                assert torch.equal(g[k], v), (mode, k)
        if mode == "full":
            assert mm > mm0, (mm, mm0)  # the blocks' matmuls run again
        else:
            assert mm == mm0, (mm, mm0)  # their outputs were kept
    assert any(v is not None and bool(v.abs().sum() > 0)
               for v in g0.values())


def test_remat_is_off_under_no_grad_and_refuses_unknown_modes():
    from repro_torch.models.transformer import remat_wrap

    cfg = dataclasses.replace(get_smoke_config("qwen3-14b"), remat="full")
    calls = []
    f = remat_wrap(lambda x: calls.append(1) or torch.exp(x), cfg)
    x = torch.ones(3, requires_grad=True)
    with torch.no_grad():
        f(x)
    f(x).sum().backward()
    assert len(calls) == 3  # no_grad once, then forward + recompute
    with pytest.raises(ValueError):
        remat_wrap(f, dataclasses.replace(cfg, remat="some"))


# ---------------------------------------------------------------------------
# the train CLI
# ---------------------------------------------------------------------------

DRILL = ["--arch", "qwen3-14b", "--smoke", "--device", "cpu", "--steps",
         "8", "--global-batch", "4", "--seq-len", "16", "--save-every", "3",
         "--log-every", "1"]


def _leaves(directory, step):
    arrays, _, _, _ = load_arrays(directory, step=step)
    return arrays


def test_cli_fault_drill_ends_bit_identical(tmp_path, capsys):
    """Phase 14 (c) of chip_smoke.py on the CPU: an uninterrupted run, the
    same run with a fault at step 5, then the faulted run extended."""
    a, b = tmp_path / "a", tmp_path / "b"
    assert tr.main(DRILL + ["--ckpt-dir", str(a)]) == 0
    out_a = capsys.readouterr().out
    assert tr.main(DRILL + ["--ckpt-dir", str(b), "--fail-at", "5"]) == 0
    out_b = capsys.readouterr().out
    assert "[train] fresh start" in out_a and "[train] fresh start" in out_b
    assert out_b.count("FAILED (injected node failure); restoring") == 1
    assert "[train] step 5 FAILED" in out_b
    assert "[train] restored to step 3, continuing" in out_b
    assert "[train] done at step 8" in out_b
    assert latest_step(a) == latest_step(b) == 8
    la, lb = _leaves(a, 8), _leaves(b, 8)
    assert list(la) == list(lb) and any(k.startswith("opt/m/") for k in la)
    for k in la:
        assert la[k].dtype == lb[k].dtype
        assert la[k].tobytes() == lb[k].tobytes(), k
    # the loss lines of the replayed steps equal the uninterrupted run's
    loss = lambda out: re.findall(r"step (\d+) loss=(\S+) gnorm=(\S+)", out)
    assert sorted(set(loss(out_b))) == sorted(set(loss(out_a)))
    args = DRILL + ["--ckpt-dir", str(b), "--fail-at", "5"]
    args[args.index("--steps") + 1] = "10"
    assert tr.main(args) == 0
    out_c = capsys.readouterr().out
    assert "[train] resumed from step 8" in out_c
    assert "FAILED" not in out_c and latest_step(b) == 10


def test_cli_failure_before_any_checkpoint_restarts_from_scratch(tmp_path,
                                                                 capsys):
    args = DRILL + ["--ckpt-dir", str(tmp_path), "--fail-at", "1",
                    "--steps", "3"]
    assert tr.main(args) == 0
    out = capsys.readouterr().out
    assert "[train] no checkpoint yet; restarting from scratch" in out
    assert latest_step(tmp_path) == 3


def test_cli_raises_the_fourth_consecutive_failure(tmp_path, monkeypatch):
    def broken(*a, **k):
        def step(*args):
            raise RuntimeError("device lost")
        return step

    monkeypatch.setattr(tr, "make_train_step", broken)
    with pytest.raises(RuntimeError, match="device lost"):
        tr.main(DRILL + ["--ckpt-dir", str(tmp_path)])


# the JAX package's driver arg sets (tests/test_drivers.py), on the port


def test_train_driver_failure_recovery(tmp_path):
    rc = tr.main([
        "--arch", "qwen3-14b", "--smoke", "--device", "cpu", "--steps", "8",
        "--global-batch", "2", "--seq-len", "16",
        "--save-every", "3", "--fail-at", "5",
        "--ckpt-dir", str(tmp_path), "--log-every", "2",
    ])
    assert rc == 0
    assert latest_step(tmp_path) == 8


def test_train_driver_resume(tmp_path):
    args = [
        "--arch", "qwen3-14b", "--smoke", "--device", "cpu", "--steps", "4",
        "--global-batch", "2", "--seq-len", "16",
        "--save-every", "2", "--ckpt-dir", str(tmp_path),
    ]
    assert tr.main(args) == 0
    args[args.index("--steps") + 1] = "6"
    assert tr.main(args) == 0
    assert latest_step(tmp_path) == 6


def test_cli_flags_are_the_jax_clis_plus_device():
    flags = lambda p: re.findall(r'add_argument\(\s*"(--[a-z-]+)"',
                                 p.read_text())
    ref = flags(ROOT / "src/repro/launch/train.py")
    port = flags(ROOT / "src/repro_torch/launch/train.py")
    assert port == ref + ["--device", "--devices"]


@pytest.mark.parametrize("arch,what", [("whisper-small", "frames"),
                                       ("llama-3.2-vision-90b", "patches")])
def test_cli_refuses_embedded_families(arch, what, tmp_path):
    with pytest.raises(SystemExit, match=what):
        tr.main(["--arch", arch, "--smoke", "--device", "cpu",
                 "--ckpt-dir", str(tmp_path)])
