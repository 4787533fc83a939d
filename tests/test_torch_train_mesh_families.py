"""Every model family trained over a (data, model) mesh of gloo ranks on
the CPU, held to the one-device port step and, on (1, 2), to the JAX
package's step.

The smoke configs of ``llama4-scout-17b-a16e`` and ``arctic-480b`` (moe:
4 and 8 experts, arctic top-2 with its dense residual), ``rwkv6-1.6b``,
``zamba2-7b`` (hybrid: Mamba2 layers and a shared attention block),
``whisper-small`` (encdec, with seeded frames) and
``llama-3.2-vision-90b`` (vlm, with seeded patches and seeded non-zero
gates: a fresh init's gates of 0 leave the cross path inert), in fp32, 3
sgd steps of 4 × 16 tokens in 2 microbatches, each from a step-0
checkpoint of the JAX package's init converted.  Every mesh of ``MESHES``
runs every family, (1, 3) the moe configs (no expert count divides by 3:
the experts replicate); one spawn a mesh shape serves every family
(``runs``).  ``scout-cf1.25`` is llama4-scout at capacity factor 1.25,
where the routing drops tokens: on data ranks the capacity and the slots
are the whole microbatch's; ``-remat`` the same under remat "full".

The step takes sgd because its update is linear in the gradient, so the
leaves compare the gradients at the CPU tolerance; adamw's normalized
update turns an ulp of a near-zero gradient into up to lr a step (see
``test_torch_train_mesh.py``'s ragged test).

Tolerances (``test_torch_train_mesh.py``'s, read on this CPU):
* ``loss`` and ``grad_norm`` against the one-device port run: relative
  1e-5 (read ≤ 4.0e-6, rwkv6's first grad norm on (1, 2));
* every leaf after step 3: ``|Δ| ≤ 1e-5·|ref| + 1e-6`` elementwise;
* against the JAX package's jitted step: ``test_torch_train.py``'s (loss
  relative 1e-5, leaves 5e-4 · max |leaf|);
* the dropped (token, choice) pairs: exact.
"""
from __future__ import annotations

import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as RO
from repro.checkpoint.store import _flatten_with_paths as ref_flatten
from repro.launch.steps import make_train_step as ref_make_train_step
from repro_torch.checkpoint.store import load_arrays, save_checkpoint
from repro_torch.configs import ArchConfig, get_config, get_smoke_config
from repro_torch.convert import (fp_params_from_numpy, shard_params,
                                 stack_layers)
from repro_torch.data.synthetic import token_batches
from repro_torch.launch import train as tr
from repro_torch.models import layers as L
from repro_torch.models.lm import build_model
from repro_torch.runtime.train_mesh import ShardPlan, TrainMesh
from repro_torch.tree import flatten_with_paths
from torch_parity import family_models

OPTS = tr.TrainOptions(steps=3, global_batch=4, seq_len=16, device="cpu",
                       log_every=1)
OPT = "sgd"
ARCHS = {"scout": ("llama4-scout-17b-a16e", {}),
         "arctic": ("arctic-480b", {}),
         "rwkv": ("rwkv6-1.6b", {}),
         "zamba": ("zamba2-7b", {}),
         "whisper": ("whisper-small", {}),
         "vlm": ("llama-3.2-vision-90b", {}),
         "scout-cf1.25": ("llama4-scout-17b-a16e",
                          {"capacity_factor": 1.25}),
         "scout-cf1.25-remat": ("llama4-scout-17b-a16e",
                                {"capacity_factor": 1.25, "remat": "full"})}
MOE = ("scout", "arctic", "scout-cf1.25", "scout-cf1.25-remat")
MESHES = [(1, 2), (2, 1), (2, 2)]
LOSS_RTOL = 1e-5
LEAF_RTOL, LEAF_ATOL = 1e-5, 1e-6
JAX_LEAF_RTOL = 5e-4
FRAMES = 10


def _tags(shape):
    return MOE if shape == (1, 3) else tuple(ARCHS)


CASES = [(s, t) for s in MESHES + [(1, 3)] for t in _tags(s)]
CASE_IDS = [f"{d}x{m}-{t}" for (d, m), t in CASES]


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


def _batches(cfg) -> list:
    """The token stream's first steps, with seeded frames (encdec) or
    patches (vlm) beside the tokens."""
    rng = np.random.default_rng(7)
    stream = token_batches(cfg.vocab, OPTS.global_batch, OPTS.seq_len,
                           seed=OPTS.seed, device="cpu")
    out = []
    for _ in range(OPTS.steps):
        b = next(stream)
        B, D = OPTS.global_batch, cfg.d_model
        if cfg.family == "encdec":
            b["frames"] = torch.from_numpy(
                rng.standard_normal((B, FRAMES, D)).astype(np.float32))
        if cfg.family == "vlm":
            b["patches"] = torch.from_numpy(rng.standard_normal(
                (B, cfg.n_patches, D)).astype(np.float32))
        out.append(b)
    return out


@pytest.fixture(scope="module")
def families(tmp_path_factory):
    """tag -> (port cfg, JAX model, JAX init, batches, the directory of
    its step-0 checkpoint of the converted JAX init)."""
    out = {}
    for tag, (arch, over) in ARCHS.items():
        ref_model, rp, _, _ = family_models(arch, **over)
        if ref_model.cfg.family == "vlm":
            rp = _with_gates(rp)
        pp = stack_layers(fp_params_from_numpy(
            jax.tree.map(np.asarray, rp), device="cpu"))
        d = tmp_path_factory.mktemp(f"init-{tag}")
        save_checkpoint(d, 0, {"params": pp, "opt": {}})
        cfg = ArchConfig.from_dict(dataclasses.asdict(ref_model.cfg))
        out[tag] = (cfg, ref_model, rp, _batches(cfg), d)
    return out


@pytest.fixture(scope="module")
def runs(families, tmp_path_factory):
    """(dp, mp) -> {tag: the run of that family on that mesh} (``(1, 1)``:
    one device), every family of the mesh in one spawn."""
    cache = {}

    def get(shape):
        if shape not in cache:
            tags = _tags(shape) if shape != (1, 1) else tuple(ARCHS)
            jobs = []
            for tag in tags:
                cfg, _, _, batches, init = families[tag]
                d = tmp_path_factory.mktemp(f"{tag}-{shape[0]}x{shape[1]}")
                shutil.copytree(init, d, dirs_exist_ok=True)
                jobs.append(tr.Job(cfg, dataclasses.replace(
                    OPTS, ckpt_dir=str(d)), keep=("params",),
                    optimizer=OPT, batches=batches))
            outs = tr.train_jobs(jobs, dp=shape[0], mp=shape[1])
            cache[shape] = dict(zip(tags, outs))
        return cache[shape]

    return get


# ---------------------------------------------------------------------------
# every family on every mesh against the one-device port step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,tag", CASES, ids=CASE_IDS)
def test_family_losses_equal_one_device(runs, shape, tag):
    ref, got = runs((1, 1))[tag], runs(shape)[tag]
    assert len(got["history"]) == OPTS.steps
    for s, (r, g) in enumerate(zip(ref["history"], got["history"])):
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(g[k], r[k], rtol=LOSS_RTOL,
                                       err_msg=f"step {s} {k}")


@pytest.mark.parametrize("shape,tag", CASES, ids=CASE_IDS)
def test_family_leaves_equal_one_device(runs, shape, tag):
    want = dict(flatten_with_paths(runs((1, 1))[tag]["state"]))
    got = dict(flatten_with_paths(runs(shape)[tag]["state"]))
    assert list(got) == list(want)
    for k, w in want.items():
        assert got[k].shape == w.shape and got[k].dtype == w.dtype, k
        np.testing.assert_allclose(got[k].numpy(), w.numpy(),
                                   rtol=LEAF_RTOL, atol=LEAF_ATOL, err_msg=k)


@pytest.mark.parametrize("tag", ["scout-cf1.25", "scout-cf1.25-remat"])
@pytest.mark.parametrize("shape", [(2, 1), (2, 2)], ids=["2x1", "2x2"])
def test_moe_drops_and_aux_equal_one_device(runs, shape, tag):
    """At capacity factor 1.25 the routing drops tokens; on data ranks the
    capacity, the slots (and so which tokens drop) and the aux's fractions
    are the whole microbatch's, as on one device — also under remat
    "full", whose backward runs each block's forward, and its data-axis
    collectives, again (counted once)."""
    ref = runs((1, 1))[tag]["history"]
    got = runs(shape)[tag]["history"]
    assert sum(h["dropped"] for h in ref) > 0  # 13 pairs at step 1
    assert [h["dropped"] for h in got] == [h["dropped"] for h in ref]
    np.testing.assert_allclose([h["aux"] for h in got],
                               [h["aux"] for h in ref], rtol=LOSS_RTOL)
    # the smoke config's capacity factor 4.0 drops nothing
    assert all(h["dropped"] == 0 for h in runs(shape)["scout"]["history"])


# ---------------------------------------------------------------------------
# (1, 2) against the JAX package's step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tag", list(ARCHS)[:6])
def test_family_1x2_matches_the_jax_step(families, runs, tag):
    _, ref_model, rp, batches, _ = families[tag]
    out = runs((1, 2))[tag]
    ro = RO.sgd(RO.cosine_schedule(OPTS.lr, OPTS.steps, 1))
    rs = ro.init(rp)
    rstep = jax.jit(ref_make_train_step(ref_model, ro, n_micro=2))
    for step, b in enumerate(batches):
        rb = {k: jnp.asarray(v.numpy()) for k, v in b.items()}
        rp, rs, rm = rstep(rp, rs, rb, jnp.int32(step))
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(out["history"][step][k],
                                       float(rm[k]), rtol=LOSS_RTOL,
                                       err_msg=f"step {step} {k}")
    want = dict(ref_flatten({"params": rp})[0])
    got = dict(flatten_with_paths(out["state"]))
    assert list(got) == list(want)
    for k, w in want.items():
        b = np.asarray(jnp.asarray(w).astype(jnp.float32))
        np.testing.assert_allclose(
            got[k].numpy(), b, rtol=0,
            atol=JAX_LEAF_RTOL * (float(np.abs(b).max()) or 1.0), err_msg=k)


# ---------------------------------------------------------------------------
# expert parallelism
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,mp,local", [
    ("llama4-scout-17b-a16e", 2, 2), ("llama4-scout-17b-a16e", 4, 1),
    ("arctic-480b", 2, 4), ("arctic-480b", 4, 2),
    ("llama4-scout-17b-a16e", 3, 4), ("arctic-480b", 3, 8)])
def test_ranks_hold_and_compute_only_their_experts(arch, mp, local):
    """With ``E % mp == 0`` each rank's compute tree holds its ``E/mp``
    experts — its block, no other rank's — and its MoE's expert products
    run over those alone; with experts that do not divide, every rank holds
    and computes all of them."""
    cfg = get_smoke_config(arch)
    E = cfg.n_experts
    g = torch.Generator().manual_seed(5)
    params = stack_layers(build_model(cfg).init(g, device="cpu"))
    x = torch.randn(2, 8, cfg.d_model, generator=g)
    for rank in range(mp):
        mesh = TrainMesh(dp=1, mp=mp, rank=rank)
        plan = ShardPlan(cfg, mesh)
        assert plan.parallel("act_experts") is (E % mp == 0)
        blocks = shard_params(params, mesh, plan.specs)["layers"]["moe"]
        specs = plan.specs["layers"]["moe"]
        moe = {k: plan._compute_leaf(("layers", "moe", k), blocks[k],
                                     specs[k])
               for k in ("router", "wi", "wg", "wo")}
        lo = rank * local if E % mp == 0 else 0
        for w in ("wi", "wg", "wo"):
            assert moe[w].shape[1] == local
            assert torch.equal(moe[w], params["layers"]["moe"][w][
                :, lo:lo + local])
        seen = []
        with _bmm_shapes(seen), _rank_context(rank, E % mp == 0):
            L.moe_apply({k: v[0] for k, v in moe.items()}, x, cfg)
        assert seen and all(s[0] == local for s in seen)


class _rank_context:
    """A mesh context of one rank whose collectives are identities (what
    ``constrain`` asks: the expert split, the rank, no communicator)."""

    def __init__(self, rank, experts):
        self.model_rank, self.comm, self.data_comm = rank, None, None
        self._experts = experts

    def parallel(self, name):
        return name == "act_experts" and self._experts

    def __enter__(self):
        from repro_torch.runtime.sharding import mesh_context

        self._cm = mesh_context(self)
        return self._cm.__enter__()

    def __exit__(self, *exc):
        return self._cm.__exit__(*exc)


class _bmm_shapes:
    """Records the shape of the left operand of every batched matmul."""

    def __init__(self, seen):
        self.seen = seen

    def __enter__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        seen = self.seen

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                if func in (torch.ops.aten.bmm.default,):
                    seen.append(tuple(args[0].shape))
                return func(*args, **(kwargs or {}))

        self._mode = Mode()
        return self._mode.__enter__()

    def __exit__(self, *exc):
        return self._mode.__exit__(*exc)


@pytest.mark.parametrize("shape", [(1, 1), (1, 2)], ids=["1x1", "1x2"])
def test_init_values_set_the_vlm_gates(families, shape):
    """``init_values`` sets leaves of a fresh init to constants (the vlm's
    gates, 0 in an init), on one device and on every rank of a mesh."""
    cfg = families["vlm"][0]
    vals = {"cross_layers/mlp_gate": 0.5, "cross_layers/xattn/gate": -0.7}
    out = tr.train(cfg, dataclasses.replace(OPTS, steps=0), dp=shape[0],
                   mp=shape[1], keep=("params",), optimizer=OPT, batches=[],
                   init_values=vals)
    got = dict(flatten_with_paths(out["state"]))
    for k, v in vals.items():
        t = got[f"params/{k}"]
        assert t.numel() and torch.equal(t, torch.full_like(t, v)), k


# ---------------------------------------------------------------------------
# the plan of every config
# ---------------------------------------------------------------------------

ALL_ARCHS = ["qwen3-14b", "llama2-70b", "mistral-large-123b", "qwen2-72b",
             "starcoder2-15b", "llama4-scout-17b-a16e", "arctic-480b",
             "rwkv6-1.6b", "zamba2-7b", "whisper-small",
             "llama-3.2-vision-90b"]


@pytest.mark.parametrize("shape", MESHES, ids=[f"{d}x{m}" for d, m in MESHES])
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_every_config_is_planned(arch, shape):
    """Each of the eleven configs at its full width: a plan on the first
    and the last rank (the flags do not depend on the rank), each region
    parallel exactly where its split dim divides over ``model``."""
    cfg = get_config(arch)
    dp, mp = shape
    H = (cfg.d_model // cfg.rwkv_head_size if cfg.family == "rwkv"
         else cfg.n_heads)
    for rank in (0, dp * mp - 1):
        plan = ShardPlan(cfg, TrainMesh(dp=dp, mp=mp, rank=rank))
        want = {"act_heads": H % mp == 0,
                "act_ff": cfg.d_ff % mp == 0 and (
                    not cfg.n_experts or cfg.dense_residual),
                "act_experts": bool(cfg.n_experts)
                and cfg.n_experts % mp == 0,
                "vocab": cfg.vocab % mp == 0}
        for name, on in want.items():
            assert plan.parallel(name) is on, (name, rank)
        if plan.parallel("act_heads") and cfg.family != "rwkv":
            assert plan.local_cfg.n_heads == cfg.n_heads // mp


@pytest.mark.parametrize("arch", ["llama4-scout-17b-a16e", "rwkv6-1.6b",
                                  "zamba2-7b"])
def test_cli_trains_the_token_only_families_on_a_mesh(arch, tmp_path,
                                                      capsys):
    """``--devices 2`` takes every token-only family (dense, moe, rwkv,
    hybrid) and writes its logical checkpoint."""
    assert tr.main(["--arch", arch, "--smoke", "--device", "cpu",
                    "--steps", "2", "--global-batch", "4", "--seq-len", "16",
                    "--log-every", "1", "--devices", "2", "--ckpt-dir",
                    str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "mesh data=1 model=2" in out and "done at step 2" in out
    arrays, step, meta, _ = load_arrays(tmp_path)
    assert step == 2 and len(meta["metrics"]) == 2
    assert all(np.isfinite(m["loss"]) for m in meta["metrics"])
    want = stack_layers(build_model(get_smoke_config(arch))
                        .abstract_params())
    assert {f"params/{k}" for k, _ in flatten_with_paths(want)} <= set(arrays)
