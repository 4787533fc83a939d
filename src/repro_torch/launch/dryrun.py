"""Dry run: is a (architecture × input shape × mesh) cell coherent, and
does it fit?

The JAX package's ``launch/dryrun.py`` lowers and compiles each cell's
step for a faked 256- or 512-chip mesh.  The port has no compiler to ask,
so for every cell it

    * builds params, optimizer state, batch and cache as ``meta`` tensors
      (``Model.abstract_params`` / ``abstract_cache``, ``launch/specs.py``:
      nothing is allocated on any device);
    * resolves each leaf's spec under the cell's rule set on the
      production mesh (``runtime/sharding.py``; the mesh is a description,
      ``launch/mesh.py``) and sums one device's block of each
      (``local_shape``): per-device argument bytes, exact;
    * runs the step once on the ``meta`` tensors under the op analysis
      (``runtime/op_analysis.py``): FLOPs, bytes and peak live bytes of the
      traced program, which is one process's whole step (the global batch
      on one device), so per-device numbers divide it evenly over the
      chips;
    * puts FLOPs, bytes and collectives through the roofline with H100
      constants (``runtime/roofline.py``).

The step traced for FLOPs and bytes is one process's program.  A train
cell of any family on a ``(data, model)`` mesh of more than one chip
also traces one rank's step at its local shapes, under
``torch.distributed``'s ``fake`` backend (its collectives return at once,
on ``meta``): the training mesh's step (``runtime/train_mesh.py``), whose
``c10d`` ops the op analysis counts into ``collectives`` and the roofline
into ``collective_s`` (a MoE's include its combine's sums over
``model``).  Other cells on more than one chip (decode and prefill,
whose port step is one process's; a multi-pod mesh; a rule set that
shards a dim over two axes) record
``"collectives": null`` with the reason and a ``null`` ``collective_s``;
``dominant`` is chosen among the terms that were counted.  A one-chip
cell's collectives are counted (none).  Records are JSON under ``--out``.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-14b \\
        --shape train_4k [--multi-pod] [--mesh-shape 1,4] [--out DIR]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --list
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys
import time
import traceback

import torch

from repro_torch.configs import ARCH_IDS, SHAPES, get_config, shapes_for
from repro_torch.convert import (
    shard_params,
    stack_axes,
    stack_cache,
    stack_cache_axes,
    stack_layers,
)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import abstract_opt_state, input_specs
from repro_torch.launch.steps import (
    make_decode_step,
    make_prefill_step,
    make_train_step,
)
from repro_torch.models.lm import build_model
from repro_torch.optim import adamw, cosine_schedule
from repro_torch.runtime.op_analysis import _tensors, analyze_step
from repro_torch.runtime.process_group import Communicator
from repro_torch.runtime.roofline import roofline_terms
from repro_torch.runtime.sharding import (
    RULE_SETS,
    ShardingContext,
    default_rules,
    local_shape,
    param_shardings,
)
from repro_torch.runtime.train_mesh import TrainMesh

__all__ = ["lower_cell", "analyze_cell", "main", "DEVICE_MEMORY_BYTES",
           "DEFAULT_OUT"]

# one card's memory as torch.cuda.get_device_properties(0).total_memory
# reads it on an NVIDIA H100 80GB HBM3 (chip_smoke.py phase 15 holds the
# figure to the card it runs on)
DEVICE_MEMORY_BYTES = 85_017_493_504
DEFAULT_OUT = "build/dryrun"
TOP_OPS = 10

_BATCH_AXES = {
    "tokens": ("batch", "seq"),
    "targets": ("batch", "seq"),
    "frames": ("batch", "seq", "act_embed"),
    "patches": ("batch", None, "act_embed"),
}
_NO_COLLECTIVES = ("not counted: the port's {kind} step is one process's "
                   "program (the global batch on one device) and issues no "
                   "collective; only train cells trace a rank of the "
                   "training mesh")


def _apply_overrides(cfg, overrides: dict):
    if not overrides:
        return cfg
    typed = {}
    for k, v in overrides.items():
        cur = getattr(cfg, k)
        typed[k] = type(cur)(v) if cur is not None else v
    return dataclasses.replace(cfg, **typed)


def _pairs(tree, specs):
    """(tensor, spec) for every leaf of ``tree`` and its spec tree."""
    if isinstance(tree, torch.Tensor):
        yield tree, specs
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _pairs(v, specs[k])
    else:
        for v, s in zip(tree, specs):
            yield from _pairs(v, s)


def _device_bytes(ctx: ShardingContext, tree, axes) -> int:
    """One device's bytes of ``tree`` under ``axes``: each leaf's block,
    exact from its spec."""
    total = 0
    for t, spec in _pairs(tree, param_shardings(ctx, tree, axes)):
        n = 1
        for d in local_shape(spec, tuple(t.shape), ctx.mesh.shape):
            n *= d
        total += n * t.element_size()
    return total


def _global_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


# (cfg, shape name, kv dtype) -> OpStats: the trace does not depend on the
# mesh, only on the step (cells of one arch and shape on two meshes with
# the same microbatch share it)
_TRACES: dict = {}


def _trace(model, cfg, shape, kv_dtype, args):
    key = (cfg, shape.name, kv_dtype)
    if key not in _TRACES:
        fn, fargs = args
        t0 = time.perf_counter()
        stats, _ = analyze_step(fn, *fargs, device="meta")
        _TRACES[key] = (stats, time.perf_counter() - t0)
    return _TRACES[key]


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
               kv_dtype: str = "bf16", rules=None,
               overrides: dict | None = None, tag: str = "",
               mesh_shape=None, verbose: bool = True) -> dict:
    """Trace one cell on ``meta``; returns its record."""
    cfg = _apply_overrides(get_config(arch), overrides or {})
    shape = SHAPES[shape_name]
    if shape not in shapes_for(cfg):
        return {
            "arch": arch, "shape": shape_name, "multi_pod": multi_pod,
            "status": "skipped",
            "reason": "long_500k needs sub-quadratic attention"
            if shape_name == "long_500k" else "not assigned",
        }
    mesh = make_production_mesh(multi_pod=multi_pod, shape=mesh_shape)
    rules = dict(rules or default_rules(multi_pod))
    if shape.kind == "train":
        # the microbatch must cover the data-parallel degree, or the
        # per-microbatch batch axis cannot shard
        dp = mesh.shape.get("pod", 1) * mesh.shape.get("data", 1)
        mb = -(-max(cfg.microbatch, dp) // dp) * dp
        if mb != cfg.microbatch and "microbatch" not in (overrides or {}):
            print(f"[dryrun] microbatch {cfg.microbatch} -> {mb} "
                  f"(must cover dp={dp})")
            cfg = dataclasses.replace(cfg, microbatch=mb)
    rec = {"arch": arch, "shape": shape_name, "kind": shape.kind,
           "multi_pod": multi_pod,
           **analyze_cell(cfg, shape, mesh, rules, kv_dtype=kv_dtype)}
    rec["tag"] = tag
    rec["overrides"] = overrides or {}
    if verbose:
        print(f"== {arch} x {shape_name} (mesh {mesh.shape}) ==")
        print("per_device_bytes:", json.dumps(rec["per_device_bytes"]))
        print(f"per-device peak {rec['per_device_peak_bytes'] / 1e9:.2f} GB,"
              f" fits {rec['fits']} (of {DEVICE_MEMORY_BYTES / 1e9:.2f} GB)")
        print("op_analysis:", json.dumps(rec["op_analysis"]))
        print("roofline:", json.dumps(rec["roofline"]))
    return rec


def analyze_cell(cfg, shape, mesh, rules, *, kv_dtype: str = "bf16") -> dict:
    """The record of one cell: ``cfg`` (microbatch already settled) and
    ``shape`` (a :class:`ShapeSpec`, registered or not) on ``mesh`` under
    ``rules`` — per-device argument bytes, the trace's FLOPs, bytes and
    peak, ``fits``, collectives and the roofline."""
    model = build_model(cfg)
    ctx = ShardingContext(mesh=mesh, rules=dict(rules))
    chips = mesh.size
    t0 = time.perf_counter()

    aparams = stack_layers(model.abstract_params())
    paxes = stack_axes(model.param_axes())
    specs = input_specs(cfg, shape)
    by_dev = {"params": _device_bytes(ctx, aparams, paxes)}
    if shape.kind == "train":
        opt = adamw(cosine_schedule(3e-4, 10_000, 500))
        aopt = abstract_opt_state(opt, aparams)
        batch = specs["batch"]
        by_dev["opt_state"] = sum(_device_bytes(ctx, aopt[k], paxes)
                                  for k in ("master", "m", "v"))
        by_dev["batch"] = sum(
            _device_bytes(ctx, v, _BATCH_AXES[k]) for k, v in batch.items())
        step = (make_train_step(model, opt), (aparams, aopt, batch, 0))
        n_args = _global_bytes([aparams, aopt, batch])
    elif shape.kind == "prefill":
        batch = specs["batch"]
        by_dev["batch"] = sum(
            _device_bytes(ctx, v, _BATCH_AXES[k]) for k, v in batch.items())
        step = (make_prefill_step(model), (aparams, batch))
        n_args = _global_bytes([aparams, batch])
    else:  # decode
        kd = {"bf16": None, "int8": torch.int8}[kv_dtype]
        acache = model.abstract_cache(shape.global_batch, shape.seq_len, kd)
        stacked = stack_cache(acache)
        caxes = stack_cache_axes(model.cache_axes(int8=kd is not None))
        by_dev["cache"] = _device_bytes(ctx, stacked, caxes)
        by_dev["batch"] = _device_bytes(ctx, specs["tokens"],
                                        ("batch", None))
        step = (make_decode_step(model),
                (aparams, specs["tokens"], acache, shape.seq_len - 1))
        n_args = _global_bytes([aparams, acache, specs["tokens"]])
    t_specs = time.perf_counter() - t0
    stats, t_trace = _trace(model, cfg, shape, kv_dtype, step)
    if stats.arg_bytes != n_args:
        raise AssertionError(f"the trace's argument bytes {stats.arg_bytes}"
                             f" != the inputs' {n_args}")
    by_dev["total"] = sum(by_dev.values())
    # the step's temporaries divided evenly over the chips, beside each
    # device's exact argument bytes
    temp = stats.peak_live_bytes - stats.arg_bytes
    peak_dev = by_dev["total"] + temp / chips
    note = None
    if chips == 1:
        coll = stats.collectives.summary()
    else:
        coll, note, t_rank = _rank_collectives(cfg, shape, mesh, rules)
        t_trace += t_rank
    terms = roofline_terms(
        hlo_flops=stats.flops / chips, hlo_bytes=stats.bytes_accessed / chips,
        collective_bytes=None if coll is None else coll["total_bytes"],
        chips=chips, cfg=cfg, shape=shape, flops_are_global=False)

    def top(key):
        rows = sorted(stats.ops.items(), key=lambda kv: -kv[1][key])
        return [{"op": k, **v} for k, v in rows[:TOP_OPS] if v[key] > 0]

    rec = {
        "mesh": mesh.shape,
        "chips": chips,
        "status": "ok",
        "kv_dtype": kv_dtype,
        "microbatch": cfg.microbatch,
        "specs_s": round(t_specs, 1),
        "trace_s": round(t_trace, 1),
        "per_device_bytes": by_dev,
        "arg_bytes": stats.arg_bytes,
        "peak_live_bytes": stats.peak_live_bytes,
        "per_device_peak_bytes": peak_dev,
        "device_memory_bytes": DEVICE_MEMORY_BYTES,
        "fits": peak_dev <= DEVICE_MEMORY_BYTES,
        "op_analysis": {
            "flops": stats.flops,
            "bytes": stats.bytes_accessed,
            "flops_per_device": stats.flops / chips,
            "bytes_per_device": stats.bytes_accessed / chips,
            "ops_traced": sum(v["count"] for v in stats.ops.values()),
        },
        "collectives": coll,
        "roofline": terms.to_dict(),
        "top_ops": {"flops": top("flops"), "bytes": top("bytes")},
        "op_table": stats.ops,
    }
    if coll is None:
        rec["collectives_note"] = note
    return rec


def _rank_collectives(cfg, shape, mesh, rules):
    """(collective summary, None, trace seconds) of rank 0's step on the
    training mesh ``mesh`` at its local shapes (params, optimizer state
    and gradients in its blocks, its rows of each microbatch), traced on
    ``meta`` under the ``fake`` backend; (None, the reason, 0.0) where
    that mesh does not take the cell."""
    if shape.kind != "train":
        return None, _NO_COLLECTIVES.format(kind=shape.kind), 0.0
    if set(mesh.shape) != {"data", "model"}:
        return None, ("not counted: the training mesh has the axes (data, "
                      f"model), not {tuple(mesh.shape)}"), 0.0
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dp, mp = mesh.shape["data"], mesh.shape["model"]
    meta = torch.device("meta")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=dp * mp)
    try:
        tm = TrainMesh(dp=dp, mp=mp, rank=0, device=meta, rules=dict(rules))
        tm.comm = Communicator(dist.new_group(list(range(mp))), mp, meta,
                               False, 0)
        tm.data_comm = Communicator(
            dist.new_group(list(range(0, dp * mp, mp))), dp, meta, False, 0)
        model = build_model(cfg)
        opt = adamw(cosine_schedule(3e-4, 10_000, 500))
        step = make_train_step(model, opt, mesh=tm)
        specs = step.plan.specs
        if any(isinstance(ax, tuple) for s in step.plan.spec_by_key.values()
               for ax in s):
            return None, ("not counted: the rule set shards a dim over "
                          "several mesh axes, which the training mesh does "
                          "not take"), 0.0
        params = shard_params(stack_layers(model.abstract_params()), tm,
                              specs)
        t0 = time.perf_counter()
        stats, _ = analyze_step(step, params, abstract_opt_state(opt, params),
                                input_specs(cfg, shape)["batch"], 0,
                                device="meta")
        return stats.collectives.summary(), None, time.perf_counter() - t0
    finally:
        dist.destroy_process_group()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--kv-dtype", default="bf16", choices=["bf16", "int8"])
    ap.add_argument("--rules", default="default",
                    help="sharding rule set: default|serving|context|fsdp2d")
    ap.add_argument("--mesh-shape", default=None,
                    help="re-slice the chips, e.g. 256,1 (data,model)")
    ap.add_argument("--override", action="append", default=[],
                    help="ArchConfig field override, e.g. attn_q_chunk=32768")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--tag", default="")
    ap.add_argument("--list", action="store_true")
    args = ap.parse_args(argv)

    if args.list:
        for arch in ARCH_IDS:
            for s in shapes_for(get_config(arch)):
                print(f"{arch} {s.name}")
        return 0

    outdir = pathlib.Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    pod = "pod2" if args.multi_pod else "pod1"
    tag = f".{args.tag}" if args.tag else ""
    fname = outdir / f"{args.arch}__{args.shape}__{pod}{tag}.json"
    overrides = dict(kv.split("=", 1) for kv in args.override)
    try:
        rec = lower_cell(
            args.arch, args.shape, multi_pod=args.multi_pod,
            kv_dtype=args.kv_dtype,
            rules=RULE_SETS[args.rules](args.multi_pod),
            overrides=overrides, tag=args.tag,
            mesh_shape=tuple(int(v) for v in args.mesh_shape.split(","))
            if args.mesh_shape else None)
    except Exception as e:
        rec = {
            "arch": args.arch, "shape": args.shape,
            "multi_pod": args.multi_pod, "status": "error",
            "error": f"{type(e).__name__}: {e}",
            "traceback": traceback.format_exc()[-4000:],
        }
        print(rec["traceback"], file=sys.stderr)
    fname.write_text(json.dumps(rec, indent=1, default=str))
    print("wrote", fname)
    return 0 if rec.get("status") in ("ok", "skipped") else 1


if __name__ == "__main__":
    raise SystemExit(main())
