"""The dry run's collectives for a train cell on a mesh of more than one
chip: one rank's step traced at its local shapes under the ``fake``
backend, held to a count worked out here from the layer shapes and the
mesh (exact, in bytes and in calls).

Every collective of the training mesh is an all-gather (its sums gather
every rank's buffer and add them in rank order), counted by the op
analysis's convention ``B_result·(g−1)/g`` = operand bytes × (g − 1).
"""
from __future__ import annotations

import dataclasses

import pytest

from repro_torch.configs import SHAPES, ShapeSpec, get_config, get_smoke_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.runtime.sharding import default_rules

F32 = 4
SHAPE = ShapeSpec("train_tiny", 16, 8, "train")


def _expected(cfg, dp: int, mp: int) -> tuple[float, int]:
    """(bytes, calls) of rank 0's step: the smoke qwen3-14b (fp32, remat
    none), every weight's ``embed`` dim over ``data`` and its heads, ``ff``
    and vocab over ``model`` whole where they divide."""
    L, D, H, KV, hd = (cfg.n_layers, cfg.d_model, cfg.n_heads,
                       cfg.n_kv_heads, cfg.head_dim)
    F, V = cfg.d_ff, cfg.vocab
    nm = SHAPE.global_batch // cfg.microbatch
    rows = SHAPE.global_batch // nm // dp * SHAPE.seq_len
    kv_local = KV % mp == 0
    # (numel, computed on the rank's block over model) of each weight with
    # an 'embed' dim; every one is stored in blocks over both axes (the
    # meshes here divide every dim)
    weights = [(V * D, True), (D * V, True), (L * D * H * hd, True),
               (L * D * KV * hd, kv_local), (L * D * KV * hd, kv_local),
               (L * H * hd * D, True), (L * D * F, True), (L * D * F, True),
               (L * F * D, True)]
    nbytes = calls = 0

    def gather(numel, g):
        nonlocal nbytes, calls
        if g > 1:
            nbytes += numel * F32 * (g - 1)
            calls += 1

    for _ in range(nm):
        for numel, _ in weights:  # FSDP over data, both ways
            block = numel // mp // dp
            gather(block, dp)
            gather(block * dp, dp)
        if mp > 1:
            for numel, local in weights:  # a KV head shard: K/V gathered
                if not local:
                    gather(numel // mp, mp)
                    gather(numel, mp)
            # forward: the embedding, each attention and MLP output, the
            # loss's max, sum of exponentials and target logit
            for _ in range(1 + 2 * L):
                gather(rows * D, mp)
            for _ in range(3):
                gather(rows, mp)
            # backward: each attention and MLP input, the logits' input,
            # and q_norm / k_norm (whole leaves in the head-parallel part)
            for _ in range(2 * L + 1):
                gather(rows * D, mp)
            gather(L * hd, mp)
            gather(L * hd, mp)
    # once a step: the data sum of the leaves not sharded over it (ln1,
    # ln2, final_norm, q_norm, k_norm) and of the loss; the norm's sum
    for numel in (L * D, L * D, D, L * hd, L * hd, 1):
        gather(numel, dp)
    gather(1, mp)
    gather(1, dp)
    return float(nbytes), calls


@pytest.mark.parametrize("mesh_shape", [(1, 2), (2, 1), (2, 2), (1, 4)])
def test_train_cell_collectives_equal_the_count(mesh_shape):
    cfg = get_smoke_config("qwen3-14b")
    dp, mp = mesh_shape
    rec = dryrun.analyze_cell(cfg, SHAPE, make_production_mesh(
        shape=mesh_shape), default_rules())
    want_bytes, want_calls = _expected(cfg, dp, mp)
    coll = rec["collectives"]
    assert coll == {"total_bytes": want_bytes,
                    "by_kind": {"all-gather": want_bytes},
                    "counts": {"all-gather": want_calls}}
    assert "collectives_note" not in rec
    r = rec["roofline"]
    assert r["collective_bytes"] == want_bytes
    assert r["collective_s"] == want_bytes / r["hw"]["link_bw"]


def test_remat_replays_the_attention_sum():
    """Under remat "full" each block's forward runs again in the backward
    as far as the backward needs it: through the attention's sum over
    ``model``, not the MLP's (the block's last op, which saves nothing
    for the backward, so the recompute stops before it)."""
    cfg = get_smoke_config("qwen3-14b")
    mesh = make_production_mesh(shape=(1, 2))
    plain = dryrun.analyze_cell(cfg, SHAPE, mesh, default_rules())
    remat = dryrun.analyze_cell(dataclasses.replace(cfg, remat="full"),
                                SHAPE, mesh, default_rules())
    nm = SHAPE.global_batch // cfg.microbatch
    rows = SHAPE.global_batch // nm * SHAPE.seq_len
    extra = nm * cfg.n_layers * rows * cfg.d_model * F32
    assert remat["collectives"]["total_bytes"] == (
        plain["collectives"]["total_bytes"] + extra)


@pytest.mark.parametrize("kind,arch,why", [
    ("decode", "qwen3-14b", "one process's program"),
    ("prefill", "qwen3-14b", "one process's program"),
])
def test_other_multichip_cells_keep_null_with_the_reason(kind, arch, why):
    rec = dryrun.analyze_cell(get_smoke_config(arch),
                              dataclasses.replace(SHAPE, kind=kind,
                                                  name=f"{kind}_tiny"),
                              make_production_mesh(shape=(1, 2)),
                              default_rules())
    assert rec["collectives"] is None and why in rec["collectives_note"]
    assert rec["roofline"]["collective_s"] is None


def test_moe_train_4k_at_1x4_counts_its_collectives():
    """llama4-scout's ``train_4k`` at (1, 4), depth cut to one layer for
    the trace's time: its 16 experts are expert-parallel (4 a rank), so
    one rank's step records all-gathers, among them the combine's sums of
    the rank's part of the MoE output and of the aux loss, not ``null``."""
    cfg = dataclasses.replace(get_config("llama4-scout-17b-a16e"),
                              n_layers=1)
    rec = dryrun.analyze_cell(cfg, SHAPES["train_4k"], make_production_mesh(
        shape=(1, 4)), default_rules())
    coll = rec["collectives"]
    assert "collectives_note" not in rec
    assert set(coll["by_kind"]) == {"all-gather"}
    nm = SHAPES["train_4k"].global_batch // cfg.microbatch
    rows = SHAPES["train_4k"].global_batch // nm * SHAPES["train_4k"].seq_len
    # at least the forward's sum of the MoE output and its backward's sum
    # of the MoE input, each microbatch: rows x d_model fp32, 3 of 4 ranks
    moe = 2 * nm * rows * cfg.d_model * F32 * 3
    assert coll["total_bytes"] > moe
    assert rec["roofline"]["collective_s"] > 0


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "zamba2-7b",
                                  "whisper-small", "llama-3.2-vision-90b",
                                  "arctic-480b"])
def test_every_family_train_cell_counts_collectives(arch):
    """Every family's train cell on a (1, 2) mesh counts one rank's
    collectives (the smoke configs)."""
    rec = dryrun.analyze_cell(get_smoke_config(arch), SHAPE,
                              make_production_mesh(shape=(1, 2)),
                              default_rules())
    assert "collectives_note" not in rec
    assert rec["collectives"]["total_bytes"] > 0
