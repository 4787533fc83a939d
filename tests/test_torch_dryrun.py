"""The port's dry run against the JAX package's: the shape registry,
elastic re-mesh, the rule sets and their specs on production meshes, the
abstract inputs, caches and optimizer state, and the dry-run CLI."""
from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_config as ref_config
from repro.configs import get_smoke_config as ref_smoke
from repro.configs import shapes_for as ref_shapes_for
from repro.launch.specs import abstract_opt_state as ref_opt_state
from repro.launch.specs import input_specs as ref_input_specs
from repro.models import build_model as ref_build
from repro.optim import adamw as ref_adamw
from repro.optim import cosine_schedule as ref_cosine
from repro.runtime import sharding as ref_sharding
from repro.runtime.elastic import best_mesh_shape as ref_best_mesh_shape
from repro_torch.configs import ARCHS, SHAPES, get_config, shapes_for
from repro_torch.configs import get_smoke_config
from repro_torch.convert import (
    stack_axes,
    stack_cache,
    stack_cache_axes,
    stack_layers,
)
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.launch.specs import abstract_opt_state, input_specs
from repro_torch.models.lm import build_model
from repro_torch.optim import adamw, cosine_schedule
from repro_torch.runtime import sharding
from repro_torch.runtime.elastic import best_mesh_shape, remesh

ROOT = pathlib.Path(__file__).resolve().parents[1]
MESHES = [{"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16},
          {"data": 256, "model": 1}, {"data": 1, "model": 4},
          {"data": 4, "model": 1}]


# ---- configs ----------------------------------------------------------------


def test_shape_registry_equals_jax():
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in REF_SHAPES.items()}
    for arch in ARCHS:
        assert get_config(arch).shape_skips == ref_config(arch).shape_skips
        assert [s.name for s in shapes_for(get_config(arch))] == [
            s.name for s in ref_shapes_for(ref_config(arch))]


@pytest.mark.parametrize("smoke", [False, True])
def test_param_counts_equal_jax(smoke):
    get, ref = ((get_smoke_config, ref_smoke) if smoke
                else (get_config, ref_config))
    for arch in ARCHS:
        assert get(arch).param_count() == ref(arch).param_count(), arch
        assert get(arch).active_param_count() == \
            ref(arch).active_param_count(), arch


def test_list_equals_jax(capsys):
    """``--list`` line for line (the JAX CLI in a subprocess: importing
    its module fakes 512 devices for the process)."""
    assert dryrun.main(["--list"]) == 0
    got = capsys.readouterr().out
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    want = subprocess.run([sys.executable, "-m", "repro.launch.dryrun",
                           "--list"], env=env, capture_output=True,
                          text=True, timeout=300, check=True).stdout
    assert got == want
    assert len(got.splitlines()) == 32


# ---- elastic re-mesh ----------------------------------------------------------


@pytest.mark.parametrize("mp", [1, 2, 4, 8, 16])
def test_best_mesh_shape_equals_jax(mp):
    for n in range(1, 1025):
        assert best_mesh_shape(n, model_parallelism=mp) == \
            ref_best_mesh_shape(n, model_parallelism=mp), (n, mp)


@settings(max_examples=40, deadline=None)
@given(n=st.integers(1, 1024), mp=st.sampled_from([1, 2, 4, 8, 16]))
def test_property_best_mesh_never_exceeds_devices(n, mp):
    shape, axes = best_mesh_shape(n, model_parallelism=mp)
    assert 0 < int(np.prod(shape)) <= n
    assert len(shape) == len(axes)
    assert (shape, axes) == ref_best_mesh_shape(n, model_parallelism=mp)


@pytest.mark.parametrize("n", [1, 4, 253, 512])
def test_remesh_over_given_devices(n):
    devices = [f"cuda:{i}" for i in range(n)]
    ctx = remesh(devices=devices)
    shape, axes = best_mesh_shape(n)
    assert ctx.mesh.axis_names == axes
    assert tuple(ctx.mesh.shape.values()) == shape
    assert ctx.mesh.devices == tuple(devices[:ctx.mesh.size])
    assert ctx.rules == sharding.default_rules(multi_pod=len(shape) == 3)


def test_production_meshes_are_descriptions():
    m = make_production_mesh()
    assert m.shape == {"data": 16, "model": 16} and m.size == 256
    m = make_production_mesh(multi_pod=True)
    assert m.axis_names == ("pod", "data", "model") and m.size == 512
    assert make_production_mesh(shape=(256, 1)).shape == {"data": 256,
                                                          "model": 1}
    assert make_host_mesh().size == 1 and m.devices is None
    with pytest.raises(ValueError, match="does not match"):
        make_production_mesh(shape=(2, 16, 16))


# ---- rule sets and specs -------------------------------------------------


@pytest.mark.parametrize("multi_pod", [False, True])
def test_rule_tables_equal_jax(multi_pod):
    assert set(sharding.RULE_SETS) == set(ref_sharding.RULE_SETS)
    for name, fn in sharding.RULE_SETS.items():
        assert fn(multi_pod) == ref_sharding.RULE_SETS[name](multi_pod), name


class _RefCtx(ref_sharding.MeshContext):
    """The JAX ``MeshContext`` with specs in place of ``NamedSharding``s:
    its ``logical_to_pspec`` reads only ``mesh.shape``, so a namespace
    stands in for a mesh."""

    def sharding(self, logical, shape=None):
        return tuple(self.pspec(logical, shape))


def _is_spec(v):
    return isinstance(v, tuple) and all(
        isinstance(e, (str, tuple, type(None))) for e in v)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tuple(tree) if _is_spec(tree) else tree}


_REF_ABSTRACT: dict = {}


def _ref_abstract(arch):
    if arch not in _REF_ABSTRACT:
        m = ref_build(ref_smoke(arch))
        _REF_ABSTRACT[arch] = (m, m.abstract_params())
    return _REF_ABSTRACT[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_cache_specs_equal_jax(arch):
    """Every leaf's spec under every rule set at the production meshes
    and the small ones, the params and both caches (bf16 and int8)."""
    ref, ref_params = _ref_abstract(arch)
    model = build_model(get_smoke_config(arch))
    params = stack_layers(model.abstract_params())
    axes = stack_axes(model.param_axes())
    assert axes == ref.param_axes()
    caches = []
    for kd, jkd in ((None, None), (torch.int8, jnp.int8)):
        rc = ref.abstract_cache(2, 64, jkd)
        caches.append((stack_cache(model.abstract_cache(2, 64, kd)),
                       stack_cache_axes(model.cache_axes(kd is not None)),
                       rc, ref.cache_axes(jkd is not None)))
    n = 0
    for mesh_shape in MESHES:
        ns = types.SimpleNamespace(shape=mesh_shape)
        for multi_pod in (False, True):
            for name, rules_fn in sharding.RULE_SETS.items():
                rules = rules_fn(multi_pod)
                ctx = sharding.ShardingContext(
                    sharding.AbstractMesh(tuple(mesh_shape.items())), rules)
                rctx = _RefCtx(mesh=ns, rules=rules)
                got = _flat(sharding.param_shardings(ctx, params, axes))
                want = _flat(ref_sharding.param_shardings(
                    rctx, ref_params, ref.param_axes()))
                assert got == want, (mesh_shape, name, multi_pod)
                for c, cax, rc, rcax in caches:
                    assert _flat(sharding.param_shardings(ctx, c, cax)) == \
                        _flat(ref_sharding.param_shardings(rctx, rc, rcax))
                n += len(got)
    assert n > 0


@pytest.mark.parametrize("case", [
    (("embed", "heads"), (5120, 5120)),
    ((None, "act_heads", None), (1, 40, 128)),
    (("batch", "seq"), (256, 4096)),
    (("batch", "seq"), (1, 524288)),
    (("experts", "embed", "ff"), (128, 7168, 4864)),
    (("heads", "ff"), (48, 40)),
    (("ff", "heads"), (4096, 4096)),
])
def test_logical_to_pspec_greedy_prefix(case):
    logical, shape = case
    for mesh_shape in MESHES:
        ns = types.SimpleNamespace(shape=mesh_shape)
        for multi_pod in (False, True):
            for rules_fn in sharding.RULE_SETS.values():
                rules = rules_fn(multi_pod)
                for shp in (shape, None):
                    assert sharding.logical_to_pspec(
                        mesh_shape, rules, logical, shp) == tuple(
                        ref_sharding.logical_to_pspec(ns, rules, logical,
                                                      shp))


def test_local_shape_divides_by_the_axes_product():
    mesh = {"pod": 2, "data": 16, "model": 16}
    assert sharding.local_shape((("pod", "data"), "model", None),
                                (64, 32, 5), mesh) == (2, 2, 5)
    assert sharding.local_shape(("model",), (40,), mesh) == (3,)  # padded
    assert sharding.local_shape((), (7, 3), mesh) == (7, 3)


def test_tp_serving_table_departs_only_where_documented():
    """The serving mesh's table resolves the packed codes' and the pool's
    axes as the JAX serving table does; 'vocab' alone has no rule."""
    tp, ref = sharding.tp_serving_rules(), ref_sharding.serving_rules()
    for name in ("heads", "kv_heads", "ff", "embed", "layers", "pages"):
        assert tp[name] == ref[name], name
    assert "vocab" not in tp and ref["vocab"] == "model"


# ---- abstract inputs, caches and optimizer state -----------------------------


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return (tuple(tree.shape), str(tree.dtype).replace("torch.", ""))


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_equal_jax(arch):
    for shape in SHAPES.values():
        got = input_specs(get_smoke_config(arch), shape)
        want = ref_input_specs(ref_smoke(arch), REF_SHAPES[shape.name])
        assert _shapes(got) == _shapes(want), shape.name
        assert all(t.device.type == "meta"
                   for t in jax.tree.leaves(got, is_leaf=torch.is_tensor))


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_cache_and_opt_state_equal_jax(arch):
    ref, ref_params = _ref_abstract(arch)
    model = build_model(get_smoke_config(arch))
    for kd, jkd in ((None, None), (torch.int8, jnp.int8)):
        got = model.abstract_cache(3, 40, kd)
        assert all(t.device.type == "meta"
                   for t in jax.tree.leaves(got, is_leaf=torch.is_tensor))
        assert _shapes(stack_cache(got)) == _shapes(
            ref.abstract_cache(3, 40, jkd))
    opt = abstract_opt_state(adamw(cosine_schedule(3e-4, 10_000, 500)),
                             stack_layers(model.abstract_params()))
    want = ref_opt_state(ref_adamw(ref_cosine(3e-4, 10_000, 500)),
                         ref_params)
    assert _shapes(opt) == _shapes(dict(want))


# ---- the dry run --------------------------------------------------------------


@pytest.mark.parametrize("mesh_shape", [None, (1, 1), (1, 4)])
def test_decode_cell_record(mesh_shape):
    """A qwen3-14b decode cell cut to 2 layers: per-device bytes exact,
    the roofline with the H100's constants, collectives null with the
    reason on more than one chip."""
    rec = dryrun.lower_cell("qwen3-14b", "decode_32k", mesh_shape=mesh_shape,
                            overrides={"n_layers": "2"}, verbose=False)
    cfg = dataclasses.replace(get_config("qwen3-14b"), n_layers=2)
    chips = rec["chips"]
    assert chips == (256 if mesh_shape is None else int(np.prod(mesh_shape)))
    kv = 2 * 2 * 128 * 32768 * cfg.n_kv_heads * cfg.head_dim * 2
    d = rec["per_device_bytes"]
    if chips == 1:
        assert d["cache"] == kv
        params = build_model(cfg).abstract_params()
        assert d["params"] == sum(t.numel() * t.element_size() for t in
                                  jax.tree.leaves(params))
        assert rec["collectives"] == {"total_bytes": 0.0, "by_kind": {},
                                      "counts": {}}
        assert rec["roofline"]["collective_s"] == 0.0
    else:
        assert rec["collectives"] is None
        assert "one process's program" in rec["collectives_note"]
        assert rec["roofline"]["collective_s"] is None
        assert rec["roofline"]["dominant"] in ("compute", "memory")
    assert d["total"] == sum(v for k, v in d.items() if k != "total")
    hw = rec["roofline"]["hw"]
    assert (hw["peak_flops"], hw["hbm_bw"], hw["link_bw"]) == (
        989.4e12, 3.35e12, 450e9)
    oa = rec["op_analysis"]
    assert oa["flops_per_device"] == oa["flops"] / chips > 0
    assert rec["roofline"]["memory_s"] == oa["bytes"] / chips / 3.35e12
    assert rec["fits"] == (rec["per_device_peak_bytes"]
                           <= dryrun.DEVICE_MEMORY_BYTES)
    assert rec["top_ops"]["flops"][0]["op"] in ("aten.bmm", "aten.mm")


def test_cli_writes_the_record(tmp_path):
    rc = dryrun.main(["--arch", "qwen3-14b", "--shape", "decode_32k",
                      "--mesh-shape", "1,4", "--override", "n_layers=1",
                      "--out", str(tmp_path), "--tag", "t"])
    assert rc == 0
    rec = json.loads((tmp_path / "qwen3-14b__decode_32k__pod1.t.json")
                     .read_text())
    assert rec["status"] == "ok" and rec["mesh"] == {"data": 1, "model": 4}
    assert dryrun.main(["--arch", "qwen3-14b", "--shape", "long_500k",
                        "--out", str(tmp_path)]) == 0
    skipped = json.loads((tmp_path / "qwen3-14b__long_500k__pod1.json")
                         .read_text())
    assert skipped["status"] == "skipped"


def test_train_cell_microbatch_covers_dp(capsys):
    rec = dryrun.lower_cell("qwen3-14b", "train_4k", mesh_shape=(32, 8),
                            overrides={"n_layers": "1", "d_model": "256",
                                       "n_heads": "2", "n_kv_heads": "1",
                                       "d_ff": "512", "vocab": "1024"},
                            verbose=False)
    assert rec["microbatch"] == 32
    assert "microbatch 16 -> 32" in capsys.readouterr().out
    d = rec["per_device_bytes"]
    assert d["opt_state"] == 6 * d["params"]  # fp32 master, m, v of bf16
    assert rec["roofline"]["model_flops"] > 0
