"""adafactor over a (data, model) mesh of gloo ranks on the CPU, held to the
one-device port step; its checkpoints are logical.

The smoke qwen3-14b in fp32, 3 adafactor steps of 4 × 16 tokens in 2
microbatches (``test_torch_train_mesh.py``'s run with adafactor for
adamw), on (1, 2), (2, 1) and (2, 2): the factored moments reduce over a
leaf's last two dims, which ``default_rules`` shard (``embed`` over
``data``, heads, ``ff`` and vocab over ``model``), so a mean over a
sharded dim is summed over that axis; the row moment is stored under the
leaf's spec without its last dim, the column moment without its
next-to-last.  One spawn a mesh shape serves every check of it (``runs``).

Tolerances (``test_torch_train_mesh.py``'s; read on this CPU):
* ``loss`` and ``grad_norm`` against the one-device run: relative 1e-5
  (read ≤ 2.2e-7);
* every leaf of params and adafactor state after step 3:
  ``|Δ| ≤ 1e-5·|ref| + 1e-6`` elementwise (none outside);
* checkpoints: bit for bit.
"""
from __future__ import annotations

import dataclasses
import shutil

import numpy as np
import pytest
import torch

from repro_torch import optim as PO
from repro_torch.checkpoint.store import load_arrays, load_checkpoint
from repro_torch.configs import get_smoke_config
from repro_torch.convert import local_block, shard_params, stack_layers
from repro_torch.launch import train as tr
from repro_torch.models.lm import build_model
from repro_torch.runtime.train_mesh import ShardPlan, TrainMesh, spec_items
from repro_torch.tree import flatten_with_paths

CFG = get_smoke_config("qwen3-14b")
OPTS = tr.TrainOptions(steps=3, global_batch=4, seq_len=16, device="cpu",
                       log_every=1)
OPT = "adafactor"
MESHES = [(1, 2), (2, 1), (2, 2)]
IDS = [f"{d}x{m}" for d, m in MESHES]
LOSS_RTOL = 1e-5
LEAF_RTOL, LEAF_ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(dp, mp) -> the adafactor run on that mesh (``(1, 1)``: one
    device), with its final checkpoint in "ckpt"."""
    cache = {}

    def get(shape):
        if shape not in cache:
            d = tmp_path_factory.mktemp(f"ada{shape[0]}x{shape[1]}")
            out = tr.train(CFG, dataclasses.replace(OPTS, ckpt_dir=str(d)),
                           dp=shape[0], mp=shape[1], keep=("params", "opt"),
                           optimizer=OPT)
            cache[shape] = {**out, "ckpt": d}
        return cache[shape]

    return get


def _like(params) -> dict:
    return {"params": params, "opt": PO.adafactor(1e-3).init(params)}


def _state_specs(mesh):
    plan = ShardPlan(CFG, mesh)
    like = _like(shard_params(stack_layers(build_model(CFG)
                                           .abstract_params()),
                              mesh, plan.specs))
    specs = plan.state_specs(like)
    return like, specs, {"/".join(map(str, p)): s
                         for p, _, s in spec_items(like, specs)}


@pytest.mark.parametrize("shape", MESHES, ids=IDS)
def test_adafactor_mesh_losses_equal_one_device(runs, shape):
    ref, got = runs((1, 1)), runs(shape)
    assert len(got["history"]) == OPTS.steps
    for s, (r, g) in enumerate(zip(ref["history"], got["history"])):
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(g[k], r[k], rtol=LOSS_RTOL,
                                       err_msg=f"step {s} {k}")


@pytest.mark.parametrize("shape", MESHES, ids=IDS)
def test_adafactor_mesh_leaves_equal_one_device(runs, shape):
    want = dict(flatten_with_paths(runs((1, 1))["state"]))
    got = dict(flatten_with_paths(runs(shape)["state"]))
    assert list(got) == list(want)
    assert any("/moments/" in k for k in want)
    for k, w in want.items():
        assert got[k].shape == w.shape and got[k].dtype == w.dtype, k
        np.testing.assert_allclose(got[k].numpy(), w.numpy(),
                                   rtol=LEAF_RTOL, atol=LEAF_ATOL, err_msg=k)


@pytest.mark.parametrize("shape", MESHES, ids=IDS)
def test_adafactor_replicas_bit_identical(runs, shape):
    """Ranks that hold the same block of a leaf — a factored moment summed
    over the axis its leaf's dim was sharded on among them — hold the same
    bits after step 3."""
    dp, mp = shape
    _, _, by_key = _state_specs(TrainMesh(dp=dp, mp=mp))
    sha = runs(shape)["block_sha"]
    assert set(sha) == set(by_key)
    for k, digests in sha.items():
        groups = {}
        for r, h in enumerate(digests):
            d, m = divmod(r, mp)
            where = tuple(d if ax == "data" else m for ax in by_key[k]
                          if ax is not None)
            groups.setdefault(where, set()).add(h)
        assert all(len(v) == 1 for v in groups.values()), k


def test_moment_specs_drop_the_reduced_dim():
    """The row moment's spec is the leaf's without its last dim, the
    column moment's without its next-to-last; a 1-D leaf's row moment
    takes the leaf's spec."""
    mesh = TrainMesh(dp=2, mp=2)
    plan = ShardPlan(CFG, mesh)
    _, specs, _ = _state_specs(mesh)
    wq = plan.specs["layers"]["attn"]["wq"]
    assert wq == (None, "data", "model")
    row, col = specs["opt"]["moments"]["layers"]["attn"]["wq"]
    assert (row, col) == ((None, "data"), (None, "model"))
    assert specs["opt"]["moments"]["final_norm"]["scale"] == (
        plan.specs["final_norm"]["scale"], None)
    assert specs["opt"]["master"] == plan.specs


@pytest.mark.parametrize("shape", MESHES + [(1, 4)], ids=IDS + ["1x4"])
def test_adafactor_restore_takes_each_ranks_block(runs, shape):
    """Every rank of a mesh restores its block of the (2, 2) run's logical
    checkpoint: the block ``shard_params`` cuts, bit for bit."""
    run = runs((2, 2))
    dp, mp = shape
    for rank in range(dp * mp):
        mesh = TrainMesh(dp=dp, mp=mp, rank=rank)
        like, specs, by_key = _state_specs(mesh)
        want = shard_params(run["state"], mesh, specs)
        got, _, _ = load_checkpoint(
            run["ckpt"], like, device="cpu",
            block=lambda key, a: local_block(a, by_key[key], mesh))
        w = dict(flatten_with_paths(want))
        for k, t in flatten_with_paths(got):
            assert t.shape == w[k].shape, k
            assert t.numpy().tobytes() == w[k].numpy().tobytes(), (rank, k)


def test_adafactor_mesh_checkpoint_is_logical(runs, tmp_path):
    """The (2, 2) run's checkpoint is the gathered state; it loads into a
    one-device run, which goes on from it."""
    run = runs((2, 2))
    arrays, step, _, _ = load_arrays(run["ckpt"])
    got = dict(flatten_with_paths(run["state"]))
    assert step == OPTS.steps and list(arrays) == list(got)
    for k, t in got.items():
        assert arrays[k].tobytes() == t.numpy().tobytes(), k
    restored, _, _ = load_checkpoint(
        run["ckpt"], _like(stack_layers(build_model(CFG).abstract_params())),
        device="cpu")
    for k, t in flatten_with_paths(restored):
        assert t.numpy().tobytes() == arrays[k].tobytes(), k
    shutil.copytree(run["ckpt"], tmp_path / "ck")
    out = tr.train(CFG, dataclasses.replace(
        OPTS, steps=OPTS.steps + 1, ckpt_dir=str(tmp_path / "ck")),
        optimizer=OPT)
    assert out["step"] == OPTS.steps + 1
    assert [h["loss"] for h in out["history"][:OPTS.steps]] == [
        h["loss"] for h in run["history"]]


def test_adafactor_resumes_onto_fewer_ranks(runs, tmp_path):
    """2 steps on (2, 2), its final checkpoint resumed for the third on
    (1, 2): the state equals the one-device 3-step run's."""
    opts = dataclasses.replace(OPTS, ckpt_dir=str(tmp_path))
    first = tr.train(CFG, dataclasses.replace(opts, steps=2), dp=2, mp=2,
                     optimizer=OPT)
    assert first["step"] == 2
    out = tr.train(CFG, opts, dp=1, mp=2, keep=("params", "opt"),
                   optimizer=OPT)
    ref = runs((1, 1))
    assert out["step"] == OPTS.steps
    for r, g in zip(ref["history"], out["history"]):
        np.testing.assert_allclose(g["loss"], r["loss"], rtol=LOSS_RTOL)
    want = dict(flatten_with_paths(ref["state"]))
    for k, t in flatten_with_paths(out["state"]):
        np.testing.assert_allclose(t.numpy(), want[k].numpy(),
                                   rtol=LEAF_RTOL, atol=LEAF_ATOL, err_msg=k)


def test_adafactor_means_over_a_sharded_dim():
    """``_mean`` over a dim no axis shards is ``torch.mean``; with a mesh
    axis of one rank it is the sum divided by the size."""
    from repro_torch.optim.optimizers import _mean
    from repro_torch.runtime.process_group import Communicator
    from repro_torch.runtime.sharding import mesh_context

    x = torch.randn(3, 5, 7, generator=torch.Generator().manual_seed(1))
    assert torch.equal(_mean(x, -1, None), torch.mean(x, dim=-1))
    mesh = TrainMesh(dp=1, mp=1)
    mesh.comm = mesh.data_comm = Communicator(None, 1, "cpu", False)
    with mesh_context(ShardPlan(CFG, mesh)):
        got = _mean(x, -2, "model", keepdim=True)
    torch.testing.assert_close(got, torch.sum(x, -2, keepdim=True) / 5,
                               rtol=0, atol=0)
    assert got.shape == (3, 1, 7)
    with pytest.raises(ValueError, match="several mesh axes"):
        with mesh_context(ShardPlan(CFG, mesh)):
            _mean(x, -1, ("model", "data"))


@pytest.mark.parametrize("shape", [(1, 1), (2, 2)], ids=["1x1", "2x2"])
def test_sampled_state_is_the_gathered_states_sample(runs, shape):
    """``sample=n`` returns n seeded elements of each kept leaf (every
    element of a smaller one), read on the ranks that hold them: bit for
    bit the same elements of the run's gathered state."""
    from repro_torch.launch.train import sample_leaves

    out = tr.train(CFG, OPTS, dp=shape[0], mp=shape[1],
                   keep=("params", "opt"), optimizer=OPT, sample=64)
    assert out["state"] is None
    want = sample_leaves(runs(shape)["state"], 64)
    assert list(out["sample"]) == list(want)
    for k, w in want.items():
        assert w.numel() == min(64, dict(flatten_with_paths(
            runs(shape)["state"]))[k].numel()), k
        assert torch.equal(out["sample"][k], w), k
