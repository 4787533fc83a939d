"""Training over a (data, model) mesh of gloo ranks on the CPU, held to the
one-device port step and, on (1, 2), to the JAX package's step.

The smoke qwen3-14b in fp32 (4 heads, 2 KV heads of 16, d_ff 128, vocab
256), 3 adamw steps of 4 × 16 tokens in 2 microbatches, on each mesh of
``MESHES``: (1, 2) shards everything on whole heads; (1, 4) shards the
query heads while the KV shard (8 columns) would split a head, so K/V are
gathered; (1, 3) replicates everything (no dim divides by 3); (2, 1) is
the data axis with ``embed`` as FSDP; (2, 2) both.  One spawn per mesh
shape serves every check of it (``runs``).

Tolerances (read on this CPU, PR 31):
* ``loss`` and ``grad_norm`` of every step against the one-device port
  run: relative 1e-5 (read ≤ 1.5e-7; (1, 3) equal);
* every gathered leaf of params and adamw state after step 3:
  ``|Δ| ≤ 1e-5·|ref| + 1e-6`` elementwise (the worst read 4.4e-7 under
  it);
* a ragged KV grouping (12 query heads over 3 KV heads on 2 ranks):
  ``RAGGED_LEAF_ATOL`` (its test says why);
* against the JAX package's jitted step on the same converted params:
  ``test_torch_train.py``'s (loss relative 1e-5, leaves 5e-4 · max
  |leaf|);
* replicated blocks, checkpoints and the fault drill: bit for bit.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as RO
from repro.checkpoint.store import _flatten_with_paths as ref_flatten
from repro.data import token_batches as ref_token_batches
from repro.launch.steps import make_train_step as ref_make_train_step
from repro_torch import optim as PO
from repro_torch.checkpoint.store import (load_arrays, load_checkpoint,
                                          save_checkpoint)
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.convert import local_block, shard_params, stack_layers
from repro_torch.launch import train as tr
from repro_torch.launch.steps import make_train_step
from repro_torch.models.lm import build_model
from repro_torch.runtime.train_mesh import ShardPlan, TrainMesh
from repro_torch.tree import flatten_with_paths, tree_map
from torch_parity import family_models

CFG = get_smoke_config("qwen3-14b")
OPTS = tr.TrainOptions(steps=3, global_batch=4, seq_len=16, device="cpu",
                       log_every=1)
MESHES = [(1, 2), (1, 4), (1, 3), (2, 1), (2, 2)]
LOSS_RTOL = 1e-5
LEAF_RTOL, LEAF_ATOL = 1e-5, 1e-6
JAX_LEAF_RTOL = 5e-4
# 1 % of adamw's largest possible move over the run (lr a step)
RAGGED_LEAF_ATOL = 1e-2 * OPTS.lr * OPTS.steps
IDS = [f"{d}x{m}" for d, m in MESHES]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(dp, mp) -> the run on that mesh (``(1, 1)``: one device), each
    with a final checkpoint in its own directory ("ckpt")."""
    cache = {}

    def get(shape):
        if shape not in cache:
            d = tmp_path_factory.mktemp(f"mesh{shape[0]}x{shape[1]}")
            out = tr.train(CFG, dataclasses.replace(OPTS, ckpt_dir=str(d)),
                           dp=shape[0], mp=shape[1], keep=("params", "opt"))
            cache[shape] = {**out, "ckpt": d}
        return cache[shape]

    return get


def _state_specs(dp, mp, rank=0):
    plan = ShardPlan(CFG, TrainMesh(dp=dp, mp=mp, rank=rank))
    out = {}
    for pre in ("params", "opt/master", "opt/m", "opt/v"):
        out.update({f"{pre}/{k}": s for k, s in plan.spec_by_key.items()})
    return out


# ---------------------------------------------------------------------------
# the step on every mesh against the one-device port step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", MESHES, ids=IDS)
def test_mesh_losses_equal_one_device(runs, shape):
    ref, got = runs((1, 1)), runs(shape)
    assert len(got["history"]) == OPTS.steps
    for s, (r, g) in enumerate(zip(ref["history"], got["history"])):
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(g[k], r[k], rtol=LOSS_RTOL,
                                       err_msg=f"step {s} {k}")


@pytest.mark.parametrize("shape", MESHES, ids=IDS)
def test_mesh_leaves_equal_one_device(runs, shape):
    want = dict(flatten_with_paths(runs((1, 1))["state"]))
    got = dict(flatten_with_paths(runs(shape)["state"]))
    assert list(got) == list(want)
    for k, w in want.items():
        assert got[k].shape == w.shape and got[k].dtype == w.dtype, k
        np.testing.assert_allclose(got[k].numpy(), w.numpy(),
                                   rtol=LEAF_RTOL, atol=LEAF_ATOL, err_msg=k)


@pytest.mark.parametrize("shape", MESHES, ids=IDS)
def test_mesh_replicas_bit_identical(runs, shape):
    """Ranks that hold the same block of a leaf (equal coordinates on the
    axes its spec names) hold the same bits after step 3."""
    dp, mp = shape
    specs = _state_specs(dp, mp)
    sha = runs(shape)["block_sha"]
    assert set(sha) == set(specs)
    replicated = 0
    for k, digests in sha.items():
        groups = {}
        for r, h in enumerate(digests):
            d, m = divmod(r, mp)
            where = tuple(d if ax == "data" else m for ax in specs[k]
                          if ax is not None)
            groups.setdefault(where, set()).add(h)
        assert all(len(v) == 1 for v in groups.values()), k
        replicated += any(ax is None for ax in specs[k]) or not specs[k]
    assert replicated > 0


@pytest.mark.parametrize("shape", MESHES, ids=IDS)
def test_mesh_reports_every_ranks_step_ms(runs, shape):
    ms = runs(shape)["ms_by_rank"]
    assert len(ms) == shape[0] * shape[1]
    assert all(len(m) == OPTS.steps and all(t > 0 for t in m) for m in ms)


# ---------------------------------------------------------------------------
# (1, 2) against the JAX package's step
# ---------------------------------------------------------------------------


def test_mesh_1x2_matches_the_jax_step(tmp_path):
    """The JAX init, converted, written as a step-0 checkpoint: the (1, 2)
    run resumes from it and is held to the JAX package's jitted step."""
    ref_model, rp, _, pp = family_models("qwen3-14b")
    stacked = stack_layers(pp)
    popt = PO.adamw(PO.cosine_schedule(OPTS.lr, OPTS.steps, 1))
    save_checkpoint(tmp_path, 0, {"params": stacked,
                                  "opt": popt.init(stacked)})
    out = tr.train(CFG, dataclasses.replace(OPTS, ckpt_dir=str(tmp_path)),
                   dp=1, mp=2, keep=("params", "opt"))
    ro = RO.adamw(RO.cosine_schedule(OPTS.lr, OPTS.steps, 1))
    rs = ro.init(rp)
    rstep = jax.jit(ref_make_train_step(ref_model, ro, n_micro=2))
    rb = ref_token_batches(CFG.vocab, OPTS.global_batch, OPTS.seq_len,
                           seed=OPTS.seed)
    for step in range(OPTS.steps):
        rp, rs, rm = rstep(rp, rs, next(rb), jnp.int32(step))
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(out["history"][step][k],
                                       float(rm[k]), rtol=LOSS_RTOL,
                                       err_msg=f"step {step} {k}")
    want = dict(ref_flatten({"params": rp, "opt": rs})[0])
    got = dict(flatten_with_paths(out["state"]))
    assert list(got) == list(want)
    for k, w in want.items():
        b = np.asarray(jnp.asarray(w).astype(jnp.float32))
        np.testing.assert_allclose(
            got[k].numpy(), b, rtol=0,
            atol=JAX_LEAF_RTOL * (float(np.abs(b).max()) or 1.0), err_msg=k)


# ---------------------------------------------------------------------------
# logical checkpoints
# ---------------------------------------------------------------------------


def test_mesh_checkpoint_is_the_gathered_state(runs):
    run = runs((1, 2))
    arrays, step, meta, _ = load_arrays(run["ckpt"])
    got = dict(flatten_with_paths(run["state"]))
    assert step == OPTS.steps and list(arrays) == list(got)
    for k, t in got.items():
        assert arrays[k].dtype == t.numpy().dtype, k
        assert arrays[k].tobytes() == t.numpy().tobytes(), k
    assert [m["loss"] for m in meta["metrics"]] == [
        h["loss"] for h in run["history"]]


def test_mesh_checkpoint_loads_into_one_device_run(runs, tmp_path):
    run = runs((1, 2))
    model = build_model(CFG)
    params = stack_layers(model.abstract_params())
    like = {"params": params, "opt": PO.adamw(1e-3).init(params)}
    restored, step, _ = load_checkpoint(run["ckpt"], like, device="cpu")
    arrays, _, _, _ = load_arrays(run["ckpt"])
    for k, t in flatten_with_paths(restored):
        assert t.numpy().tobytes() == arrays[k].tobytes(), k
    # and a one-device run goes on from it
    import shutil

    shutil.copytree(run["ckpt"], tmp_path / "ck")
    out = tr.train(CFG, dataclasses.replace(
        OPTS, steps=OPTS.steps + 1, ckpt_dir=str(tmp_path / "ck")))
    assert out["step"] == OPTS.steps + 1
    assert [h["loss"] for h in out["history"][:OPTS.steps]] == [
        h["loss"] for h in run["history"]]


@pytest.mark.parametrize("shape", MESHES + [(4, 1)],
                         ids=IDS + ["4x1"])
def test_restore_takes_each_ranks_block(runs, shape):
    """Every rank of a mesh restores its block of the (1, 2) run's logical
    checkpoint: the block ``shard_params`` cuts, bit for bit."""
    run = runs((1, 2))
    dp, mp = shape
    for rank in range(dp * mp):
        mesh = TrainMesh(dp=dp, mp=mp, rank=rank)
        plan = ShardPlan(CFG, mesh)
        specs = {"params": plan.specs,
                 "opt": {k: plan.specs for k in ("m", "master", "v")}}
        want = shard_params(run["state"], mesh, specs)
        like = tree_map(lambda t: torch.empty_like(t, device="meta"), want)
        by_key = {f"{pre}/{k}": s for pre in ("params", "opt/master",
                                               "opt/m", "opt/v")
                  for k, s in plan.spec_by_key.items()}

        got, _, _ = load_checkpoint(
            run["ckpt"], like, device="cpu",
            block=lambda key, a: local_block(a, by_key[key], mesh))
        w = dict(flatten_with_paths(want))
        for k, t in flatten_with_paths(got):
            assert t.shape == w[k].shape, k
            assert t.numpy().tobytes() == w[k].numpy().tobytes(), (rank, k)


@pytest.mark.parametrize("shape", MESHES, ids=IDS)
def test_shard_params_blocks_tile_the_leaf(shape):
    """The ranks' blocks, put back together in rank order along each
    sharded dim, are the logical leaf."""
    dp, mp = shape
    model = build_model(CFG)
    g = torch.Generator().manual_seed(3)
    params = stack_layers(model.init(g, device="cpu"))
    blocks = []
    for rank in range(dp * mp):
        mesh = TrainMesh(dp=dp, mp=mp, rank=rank)
        blocks.append(dict(flatten_with_paths(
            shard_params(params, mesh, ShardPlan(CFG, mesh).specs))))
    specs = ShardPlan(CFG, TrainMesh(dp=dp, mp=mp)).spec_by_key
    for k, leaf in flatten_with_paths(params):
        spec = specs[k]
        rows = [torch.cat([blocks[d * mp + m][k] for m in range(mp)],
                          dim=spec.index("model"))
                if "model" in spec else blocks[d * mp][k] for d in range(dp)]
        whole = (torch.cat(rows, dim=spec.index("data")) if "data" in spec
                 else rows[0])
        assert torch.equal(whole, leaf), k


# ---------------------------------------------------------------------------
# the fault drill on a mesh
# ---------------------------------------------------------------------------


def test_mesh_fault_drill_ends_bit_identical(runs, tmp_path, capsys):
    """The CLI on (1, 2) with ``--fail-at 2`` (every rank raises at step 2
    and restores step 2's checkpoint) ends bit-identical to the (1, 2) run
    without it."""
    rc = tr.main(["--arch", "qwen3-14b", "--smoke", "--device", "cpu",
                  "--devices", "2", "--steps", str(OPTS.steps),
                  "--global-batch", str(OPTS.global_batch),
                  "--seq-len", str(OPTS.seq_len), "--save-every", "1",
                  "--fail-at", "2", "--log-every", "1",
                  "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert rc == 0
    assert "mesh data=1 model=2" in out
    assert out.count("FAILED (injected node failure)") == 1
    assert "restored to step 2, continuing" in out
    a, _, _, _ = load_arrays(tmp_path, step=OPTS.steps)
    b, _, _, _ = load_arrays(runs((1, 2))["ckpt"], step=OPTS.steps)
    assert list(a) == list(b)
    for k in a:
        assert a[k].tobytes() == b[k].tobytes(), k


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,heads,kv_local,kv_heads,ff,vocab", [
    ((1, 2), True, True, None, True, True),
    ((1, 4), True, False, "h//2", True, True),
    ((1, 3), False, False, None, False, False),
    ((2, 1), True, True, None, True, True),
])
def test_plan_of_the_smoke_config(shape, heads, kv_local, kv_heads, ff,
                                  vocab):
    dp, mp = shape
    for rank in range(dp * mp):
        plan = ShardPlan(CFG, TrainMesh(dp=dp, mp=mp, rank=rank))
        assert plan.parallel("act_heads") is heads
        assert plan.kv_local is kv_local
        assert plan.parallel("act_ff") is ff and plan.parallel("vocab") is vocab
        m = rank % mp
        if kv_heads == "h//2":  # one query head a rank, its KV head
            assert plan.kv_heads == [m // 2]
            assert (plan.local_cfg.n_heads, plan.local_cfg.n_kv_heads) == (1, 1)
        else:
            assert plan.kv_heads is None
        if not heads:
            assert plan.local_cfg == CFG


@pytest.mark.parametrize("mp,heads,ff,vocab", [
    (2, True, True, True), (4, True, True, True), (8, True, True, True),
    (16, False, True, True), (3, False, False, False)])
def test_plan_of_qwen3_14b(mp, heads, ff, vocab):
    """qwen3-14b (40 query heads, 8 KV heads of 128): on 16 ranks the query
    shard (320 columns) splits heads and attention replicates; on 3 every
    dim falls back to replication."""
    cfg = get_config("qwen3-14b")
    plan = ShardPlan(cfg, TrainMesh(dp=1, mp=mp))
    assert plan.parallel("act_heads") is heads
    assert plan.parallel("act_ff") is ff and plan.parallel("vocab") is vocab
    if mp == 3:
        assert all("model" not in s for s in plan.spec_by_key.values())


@pytest.mark.parametrize("H,KV,mp,rank,kv_heads,local", [
    # 12 query heads over 2 KV heads on 3 ranks: rank 1's heads 4..7 meet
    # KV heads 0, 0, 1, 1 — two groups of two
    (12, 2, 3, 1, [0, 1], (4, 2)),
    # 12 over 3 on 2 ranks: rank 0's heads 0..5 meet 0, 0, 0, 0, 1, 1 —
    # ragged, so one KV head (repeated) a query head
    (12, 3, 2, 0, [0, 0, 0, 0, 1, 1], (6, 6)),
    (12, 3, 2, 1, [1, 1, 2, 2, 2, 2], (6, 6)),
])
def test_plan_maps_query_heads_to_their_kv_heads(H, KV, mp, rank, kv_heads,
                                                 local):
    cfg = dataclasses.replace(CFG, n_heads=H, n_kv_heads=KV, d_model=96,
                              head_dim=8)
    plan = ShardPlan(cfg, TrainMesh(dp=1, mp=mp, rank=rank))
    assert plan.parallel("act_heads") and not plan.kv_local
    assert plan.kv_heads == kv_heads
    assert (plan.local_cfg.n_heads, plan.local_cfg.n_kv_heads) == local


def test_ragged_kv_groups_step_equals_one_device():
    """The ragged plan's attention batches its einsums one KV head a query
    head, so its scores differ from the one-device run's in the last bits;
    adamw's normalized update turns that into up to ~lr a step where a
    gradient is near zero, so leaves are held to ``RAGGED_LEAF_ATOL``
    (read 1.9e-6 on 2 of 24,576 elements of ``mlp/wg``'s master)."""
    cfg = dataclasses.replace(CFG, n_heads=12, n_kv_heads=3, d_model=96,
                              head_dim=8)
    ref = tr.train(cfg, OPTS, keep=("params", "opt"))
    got = tr.train(cfg, OPTS, dp=1, mp=2, keep=("params", "opt"))
    for r, g in zip(ref["history"], got["history"]):
        np.testing.assert_allclose(g["loss"], r["loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(g["grad_norm"], r["grad_norm"],
                                   rtol=LOSS_RTOL)
    want = dict(flatten_with_paths(ref["state"]))
    for k, t in flatten_with_paths(got["state"]):
        np.testing.assert_allclose(t.numpy(), want[k].numpy(),
                                   rtol=LEAF_RTOL, atol=RAGGED_LEAF_ATOL,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# refusals (every family and optimizer trains on a mesh:
# test_torch_train_mesh_families.py, test_torch_train_mesh_adafactor.py)
# ---------------------------------------------------------------------------


def test_mesh_refuses_a_batch_the_data_ranks_cannot_split():
    with pytest.raises(ValueError, match="does not split over 4 data"):
        tr.train(CFG, dataclasses.replace(OPTS, global_batch=4), dp=4, mp=1)
