"""Fault-tolerant training driver, on one device or SPMD over a mesh.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-14b \\
        --smoke --device cpu --steps 8 --save-every 3 --fail-at 5 \\
        --ckpt-dir /tmp/ck [--devices 2]

The JAX package's ``launch/train.py`` with its flags, plus ``--device``
(``cuda``, the default, or ``cpu``) and ``--devices N``, the counterpart of
the JAX device count (default: every visible card with ``--device cuda``,
1 with ``--device cpu``):

  * deterministic ``(seed, step)`` data stream (``token_batches``) ->
    exact resume semantics;
  * the train state in the JAX package's layout (layers stacked), adamw
    over a cosine schedule, ``global_batch // cfg.microbatch``
    microbatches;
  * CheckpointManager: atomic save-every-K, keep-k GC, auto-resume, and an
    unconditional final save; each checkpoint's meta holds the ``loss``,
    ``grad_norm`` and step ms of every step before it;
  * failure trap: a step exception restores the latest checkpoint and
    continues from its step with the stream rebuilt there (``--fail-at``
    injects a fault for testing); the 4th consecutive failure is raised;
  * elastic re-mesh on resume: the mesh is the one ``remesh`` picks for
    the devices present, and checkpoints are logical, so a run restarted
    on fewer devices resumes from the latest checkpoint on its new mesh.

**The mesh** (``N`` > 1).  This process is rank 0; it starts ``N − 1``
ranks, which die with it (``runtime/process_group.py``), and every rank
runs the same loop on its own device: one rank per card on NCCL where the
cards suffice, else ranks sharing cards on gloo with collectives staged
through host memory; gloo on the CPU.  Only rank 0 prints.  Every model
family trains there.  Parameters, gradients and optimizer state (adamw's,
adafactor's factored moments, sgd's) are **stored sharded by
``default_rules``**
(``runtime/train_mesh.py``): the JAX driver computes the same specs and
never places anything by them (it keeps every leaf whole on its mesh), so
placing them is this port's design choice.  The step equals the
one-device step (``launch/steps.py``).  Checkpoints are logical: rank 0
gathers each leaf and writes it, every rank then passes a barrier; a
restore reads the logical file on every rank and keeps its block under
the current mesh.  ``--fail-at`` raises on every rank at the same step,
so all ranks restore together; that is the only failure the trap takes on
a mesh.  A rank that dies, or a collective that fails or times out
(``TRAIN_TIMEOUT_S``), ends the run with a non-zero exit and a message
naming the rank: rank 0 watches its ranks, kills the rest when one dies,
and never trains on the survivors.  The elastic path is the JAX one:
start ``train`` again on the devices left.

A fresh start initialises from ``torch.Generator(device).manual_seed(
seed)`` (on a mesh every rank draws the whole init and keeps its block,
one leaf at a time), whose values differ from the JAX package's
``jax.random`` init.  The CLI refuses the encdec and vlm archs: the
stream has no ``frames`` / ``patches`` embeddings (the JAX CLI fails
there with a ``KeyError``).

**From Python**, :func:`train` runs one run and :func:`train_jobs` runs
several :class:`Job` s one after another on one start of the mesh's
processes.  A job takes adamw, adafactor or sgd (:data:`OPTIMIZERS`),
the batches of an encdec or vlm model (tokens beside ``frames`` or
``patches``), constant values for leaves of its fresh init (a vlm's
gates), and returns its final state gathered whole or, for a check of a
run too large to move, :func:`sample_leaves` of it::

    train(cfg, TrainOptions(steps=3, device="cpu"), dp=2, mp=2,
          optimizer="adafactor", keep=("params", "opt"))
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import hashlib
import json
import math
import os
import shutil
import sys
import tempfile
import threading
import time
import traceback
import zlib
from typing import Optional

import torch

from repro_torch.checkpoint.store import CheckpointManager, save_checkpoint
from repro_torch.configs import ArchConfig, get_config, get_smoke_config
from repro_torch.convert import (gather_params, local_block, shard_params,
                                 stack_layers, stack_shard)
from repro_torch.data.synthetic import token_batches
from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_train_step
from repro_torch.models.lm import build_model
from repro_torch.optim import adafactor, adamw, cosine_schedule, sgd
from repro_torch.runtime.elastic import remesh
from repro_torch.runtime.process_group import (die_with_parent, layout,
                                               spawn_workers)
from repro_torch.runtime.train_mesh import (ShardPlan, TrainMesh,
                                            connect_train_mesh, spec_items)
from repro_torch.tree import flatten_with_paths, tree_map

__all__ = ["main", "train", "train_jobs", "Job", "sample_leaves",
           "mesh_shape", "TrainOptions", "RankFailure", "TRAIN_TIMEOUT_S",
           "OPTIMIZERS"]

# the optimizers a run takes (the CLI's is adamw), each over the cosine
# schedule of the run's lr and steps
OPTIMIZERS = {"adamw": adamw, "adafactor": adafactor, "sgd": sgd}

_EMBEDDED = {"encdec": "frames", "vlm": "patches"}

# seconds a collective of the training mesh may wait for its peers (NCCL
# learns of a killed peer only through it); barriers wait longer, while
# rank 0 writes a checkpoint
TRAIN_TIMEOUT_S = 180
CONTROL_TIMEOUT_S = 3600
_POLL_S = 0.2


class RankFailure(RuntimeError):
    """A rank of the training mesh died or failed: the run ends."""


class _InjectedFailure(RuntimeError):
    pass


@dataclasses.dataclass(frozen=True)
class TrainOptions:
    """The CLI's flags (``ckpt_dir`` None: no checkpoints)."""

    steps: int = 100
    global_batch: int = 8
    seq_len: int = 64
    lr: float = 3e-4
    ckpt_dir: Optional[str] = None
    save_every: int = 25
    keep: int = 2
    seed: int = 0
    fail_at: int = -1
    log_every: int = 10
    device: str = "cuda"


@dataclasses.dataclass(frozen=True)
class Job:
    """One training run: ``cfg`` under ``opts`` with ``optimizer`` (a key
    of :data:`OPTIMIZERS`).  ``batches``: the batches of steps ``0 ..
    steps − 1`` (dicts of host tensors, the family's ``frames`` or
    ``patches`` beside the tokens) in place of the token stream.  ``keep``
    names the parts of the final state to return ("params", "opt",
    "opt/m"); with ``sample`` > 0 only ``sample`` seeded elements of each
    of their leaves are returned (:func:`sample_leaves`), not the leaves.
    ``init_values``: leaves of a fresh init set to a constant, by key
    (``cross_layers/mlp_gate``: a vlm's gates, which an init leaves at 0,
    so its cross path is inert)."""

    cfg: ArchConfig
    opts: TrainOptions
    keep: tuple = ()
    optimizer: str = "adamw"
    batches: Optional[list] = None
    sample: int = 0
    init_values: dict = dataclasses.field(default_factory=dict)


def _deterministic_cuda() -> None:
    """Bit-identical replays on the card, which the resume semantics need
    (XLA gives the JAX driver that by default).  The CUDA gather / index
    backward accumulate with atomics, in an order that changes from run
    to run, unless deterministic algorithms are on; cuBLAS needs a fixed
    workspace for them, set before its first call."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-14b")
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--save-every", type=int, default=25)
    ap.add_argument("--keep", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--fail-at", type=int, default=-1,
                    help="inject a failure at this step (fault-tolerance test)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda (the default) or cpu")
    ap.add_argument("--devices", type=int, default=None,
                    help="ranks of the mesh (default: every visible card "
                         "with --device cuda, 1 with --device cpu)")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if cfg.family in _EMBEDDED:
        raise SystemExit(
            f"--arch {args.arch}: the {cfg.family} family's stub frontend "
            f"needs {_EMBEDDED[cfg.family]} embeddings beside the tokens, "
            f"which token_batches does not make")
    n = args.devices
    if n is None:
        n = (torch.cuda.device_count() if args.device == "cuda"
             and torch.cuda.is_available() else 1)
    dp, mp = mesh_shape(n)
    opts = TrainOptions(
        steps=args.steps, global_batch=args.global_batch,
        seq_len=args.seq_len, lr=args.lr, ckpt_dir=args.ckpt_dir,
        save_every=args.save_every, keep=args.keep, seed=args.seed,
        fail_at=args.fail_at, log_every=args.log_every, device=args.device)
    try:
        train(cfg, opts, dp=dp, mp=mp)
    except RankFailure as e:
        print(f"[train] {e}", file=sys.stderr, flush=True)
        return 1
    return 0


def mesh_shape(n_devices: int) -> tuple[int, int]:
    """``(dp, mp)`` of the mesh ``remesh`` picks for ``n_devices`` (every
    axis but 'model' is data; ranks beyond the cards present share them,
    as the layout decides)."""
    shape = remesh(n_devices, devices=[None] * n_devices).mesh.shape
    dp = 1
    for ax, size in shape.items():
        dp *= size if ax != "model" else 1
    return dp, shape["model"]


# ---------------------------------------------------------------------------
# one rank's loop
# ---------------------------------------------------------------------------


def _timer(device):
    """Starts a timer; the returned callable gives the ms since (CUDA
    events on a card, the host clock elsewhere)."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        return lambda: 1e3 * (time.perf_counter() - t0)
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()

    def stop():
        b.record()
        b.synchronize()
        return a.elapsed_time(b)

    return stop


def _run(job: Job, mesh=None) -> dict:
    """The training loop of ``job`` on this rank (every rank runs it).
    Returns {"step", "history" (per step: loss, grad_norm, ms), "ms"
    (this rank's per step), "state" (the parts of the final train state
    that ``job.keep`` names by path — "params", "opt", "opt/m" — logical,
    on the host, rank 0; None without ``keep`` or with ``sample``)}, with
    ``sample`` "sample" (:func:`sample_leaves` of those parts), and on a
    mesh "ms_by_rank" and, with ``keep``, "block_sha"
    (:func:`_block_digests`; with ``sample``, of the leaves that have
    replicas)."""
    cfg, opts, keep = job.cfg, job.opts, job.keep
    lead = mesh is None or mesh.rank == 0
    device = mesh.device if mesh else resolve_device(opts.device)
    if device.type == "cuda":
        _deterministic_cuda()
    say = print if lead else (lambda *a, **k: None)
    model = build_model(cfg)
    opt = OPTIMIZERS[job.optimizer](cosine_schedule(
        opts.lr, opts.steps, max(opts.steps // 20, 1)))
    n_micro = max(1, opts.global_batch // max(cfg.microbatch, 1))
    train_step = make_train_step(model, opt, n_micro=n_micro, mesh=mesh)
    plan = ShardPlan(cfg, mesh) if mesh is not None else None
    mgr = (CheckpointManager(opts.ckpt_dir, keep=opts.keep,
                             save_every=opts.save_every)
           if opts.ckpt_dir else None)

    def fresh():
        g = torch.Generator(device=device)
        g.manual_seed(opts.seed)
        params = model.init(g, device=device)
        params = (stack_shard(params, mesh, plan.specs) if plan
                  else stack_layers(params))
        leaves = dict(flatten_with_paths(params))
        for key, value in job.init_values.items():
            leaves[key].fill_(value)
        return params, opt.init(params)

    def stream_from(step):
        if job.batches is not None:
            return ({k: v.to(device) for k, v in b.items()}
                    for b in job.batches[step:])
        return token_batches(cfg.vocab, opts.global_batch, opts.seq_len,
                             seed=opts.seed, start_step=step, device=device)

    # the state's shapes and dtypes on ``meta``: a restore reads into them,
    # so a resumed run never holds the fresh init beside the restored state
    aparams = stack_layers(model.abstract_params())
    if plan:
        aparams = shard_params(aparams, mesh, plan.specs)
    state_like = {"params": aparams, "opt": opt.init(aparams)}
    specs = plan.state_specs(state_like) if plan else None
    block = None
    if plan:  # each rank keeps its block of each logical leaf it reads
        by_key = {"/".join(map(str, p)): s
                  for p, _, s in spec_items(state_like, specs)}

        def block(key, a):
            return local_block(a, by_key[key], mesh)
    history: list = []
    ms: dict = {}

    def restore():
        restored, step, meta = mgr.restore_latest(state_like, device=device,
                                                  block=block)
        history[:] = meta.get("metrics", [])[:step]
        return restored["params"], restored["opt"], step

    def save(step, final=False):
        state = {"params": params, "opt": opt_state}
        if plan:
            state = gather_params(state, mesh, specs,
                                  to="cpu" if lead else "meta")
        if lead:
            meta = {"metrics": history[:step]}
            if final:
                save_checkpoint(opts.ckpt_dir, step, state, extra_meta=meta)
            else:
                mgr.save(step, state, **meta)
        if plan:
            mesh.barrier()

    start = 0
    try:
        if mgr is None:
            raise FileNotFoundError
        params, opt_state, start = restore()
        say(f"[train] resumed from step {start}")
    except FileNotFoundError:
        params, opt_state = fresh()
        say("[train] fresh start")
    if plan:
        say(f"[train] mesh data={mesh.dp} model={mesh.mp}: {mesh.size} "
            f"ranks, backend {mesh.backend}"
            + ("; collectives on CUDA tensors staged through host memory"
               if mesh.staged else ""))

    stream = stream_from(start)
    step = start
    injected = False
    consecutive_failures = 0
    while step < opts.steps:
        batch = next(stream)
        try:
            if step == opts.fail_at and not injected:
                injected = True
                raise _InjectedFailure("injected node failure")
            t0 = time.time()
            stop = _timer(device)
            params, opt_state, metrics = train_step(params, opt_state, batch,
                                                    step)
            ms[step] = stop()
            loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
            history[step:] = [{"loss": loss, "grad_norm": gnorm,
                               "ms": ms[step],
                               **{k: metrics[k].item() for k in
                                  ("aux", "dropped") if k in metrics}}]
            if step % opts.log_every == 0:
                say(f"[train] step {step} loss={loss:.4f} gnorm={gnorm:.3f} "
                    f"dt={time.time() - t0:.2f}s")
            step += 1
            consecutive_failures = 0
            if mgr is not None and mgr.due(step):
                save(step)
        except Exception as e:  # failure trap: restore + continue
            if plan and not isinstance(e, _InjectedFailure):
                raise  # one rank's failure: the mesh cannot agree on it
            consecutive_failures += 1
            if consecutive_failures > 3:
                raise  # persistent failure: surface it, don't spin
            say(f"[train] step {step} FAILED ({e}); restoring…", flush=True)
            params = opt_state = None  # not held beside the restored state
            try:
                if mgr is None:
                    raise FileNotFoundError
                params, opt_state, step = restore()
                stream = stream_from(step)
                say(f"[train] restored to step {step}, continuing")
            except FileNotFoundError:
                say("[train] no checkpoint yet; restarting from scratch")
                params, opt_state = fresh()
                history.clear()
                step = 0
                stream = stream_from(0)
    if mgr is not None:
        save(step, final=True)
    say(f"[train] done at step {step}")
    out = {"step": step, "history": history,
           "ms": [ms.get(s, float("nan")) for s in range(opts.steps)],
           "state": None}
    if keep:
        state = _select({"params": params, "opt": opt_state}, keep)
        kept = _select(specs, keep) if plan else None
        if job.sample:
            out["sample"] = sample_leaves(state, job.sample, kept, mesh)
        else:
            out["state"] = (gather_params(state, mesh, kept,
                                          to="cpu" if lead else "meta")
                            if plan else tree_map(lambda t: t.cpu(), state))
        if plan:
            out["block_sha"] = _block_digests(
                state, mesh, kept if job.sample else None)
    if plan:  # every rank's step ms, in rank order
        out["ms_by_rank"] = [p.tolist() for p in mesh.control.all_gather(
            torch.tensor(out["ms"], dtype=torch.float64))]
    return out


def _select(tree: dict, paths) -> dict:
    """The subtrees of ``tree`` at ``paths`` ("params", "opt/m"), in a
    tree of their own."""
    out: dict = {}
    for path in paths:
        *head, last = path.split("/")
        src, dst = tree, out
        for k in head:
            src, dst = src[k], dst.setdefault(k, {})
        dst[last] = src[last]
    return out


def _block_digests(state, mesh, specs=None) -> dict:
    """{key: every rank's SHA-256 of its block of that leaf, in rank
    order}: replicas of a leaf hold the same bits when their digests
    agree.  With ``specs``, only of the leaves some rank holds a replica
    of (not sharded over every axis of more than one rank)."""
    flat = flatten_with_paths(state)
    if specs is not None:
        axes = {a for a, n in mesh.shape.items() if n > 1}
        flat = [(k, t) for (k, t), (_, _, spec) in zip(
            flat, spec_items(state, specs)) if not axes <= set(spec)]
    mine = b"".join(hashlib.sha256(t.detach().reshape(-1).cpu()
                                   .view(torch.uint8).numpy()).digest()
                    for _, t in flat)
    parts = [p.numpy().tobytes() for p in mesh.control.all_gather(
        torch.frombuffer(bytearray(mine), dtype=torch.uint8))]
    return {k: [p[32 * i:32 * (i + 1)].hex() for p in parts]
            for i, (k, _) in enumerate(flat)}


def sample_leaves(tree, n: int, specs=None, mesh=None) -> dict:
    """{key: the values, fp32 on the host, of ``n`` seeded elements of the
    logical leaf (every element of a leaf of at most ``n``)}: the same
    elements of the same tree wherever it is held, so a check of a large
    run reads these instead of moving its state.  On a mesh ``tree`` is
    this rank's blocks under ``specs``; each element is read by the one
    rank that holds it at coordinate 0 of the axes its leaf replicates
    over, and the ranks' vectors are added over the mesh (one holder an
    element: the sum is exact)."""
    items = (list(spec_items(tree, specs)) if mesh is not None else
             [(tuple(k.split("/")), t, (None,) * t.ndim)
              for k, t in flatten_with_paths(tree)])
    keys, parts, sizes = [], [], []
    for path, t, spec in items:
        key = "/".join(map(str, path))
        shape = [s * (mesh.shape[ax] if ax else 1)
                 for s, ax in zip(t.shape, spec)]
        numel = math.prod(shape)
        if numel <= n:
            idx = torch.arange(numel)
        else:
            g = torch.Generator().manual_seed(zlib.crc32(key.encode()))
            idx = torch.randint(numel, (n,), generator=g)
        coords = torch.unravel_index(idx, tuple(shape)) if shape else ()
        held = torch.ones(idx.shape, dtype=torch.bool)
        local = torch.zeros_like(idx)
        for d, (c, ax) in enumerate(zip(coords, spec)):
            lo = 0
            if ax is not None:
                lo, hi = mesh.local_range(shape[d], ax)
                held &= (c >= lo) & (c < hi)
            local = local * t.shape[d] + (c - lo).clamp(0, t.shape[d] - 1)
        if mesh is not None and not all(  # replicas: coordinate 0 reads
                r == 0 for ax, r in (("model", mesh.model_rank),
                                     ("data", mesh.data_rank))
                if ax not in spec):
            held[:] = False
        vals = torch.zeros(idx.shape, dtype=torch.float32)
        pick = local[held].to(t.device)
        vals[held] = t.reshape(-1)[pick].to(torch.float32).cpu()
        keys.append(key)
        parts.append(vals)
        sizes.append(vals.numel())
    flat = torch.cat(parts) if parts else torch.zeros(0)
    if mesh is not None:
        flat = mesh.sum_over_mesh(flat.to(mesh.device)).cpu()
    return dict(zip(keys, torch.split(flat, sizes)))


# ---------------------------------------------------------------------------
# the mesh: rank 0 here, the others in processes of their own
# ---------------------------------------------------------------------------


def _dead(procs) -> list:
    """(rank, exit code) of the ranks that ended with a non-zero code,
    those killed by a signal first."""
    dead = [(r, p.poll()) for r, p in enumerate(procs, start=1)]
    dead = [(r, rc) for r, rc in dead if rc not in (None, 0)]
    return sorted(dead, key=lambda d: (d[1] >= 0, d[0]))


def _describe(dead) -> str:
    return "; ".join(f"rank {r} was killed by signal {-rc}" if rc < 0
                     else f"rank {r} exited with code {rc}" for r, rc in dead)


class _Watch:
    """Rank 0's watch over the other ranks: the first that dies ends the
    others (no rank trains on without it) and aborts the mesh's NCCL
    groups, so that rank 0's pending collectives fail."""

    def __init__(self, procs):
        self.procs, self.reason, self.mesh = procs, None, None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="train-mesh-watch")
        self._thread.start()

    def _loop(self):
        while not self._stop.wait(_POLL_S):
            dead = _dead(self.procs)
            if dead:
                self.reason = _describe(dead)
                # said at once: rank 0 may itself be ended next (NCCL's
                # watchdog) before its failed collective raises
                print(f"[train] {self.reason}; ending the run",
                      file=sys.stderr, flush=True)
                _kill(self.procs)
                if self.mesh is not None:
                    self.mesh.abort()
                return

    def stop(self):
        self._stop.set()
        self._thread.join()


def _kill(procs) -> None:
    for p in procs:
        if p.poll() is None:
            p.kill()


def train(cfg: ArchConfig, opts: TrainOptions, *, dp: int = 1, mp: int = 1,
          keep: tuple = (), optimizer: str = "adamw", batches=None,
          sample: int = 0, init_values=None) -> dict:
    """Train ``cfg`` on a ``(dp, mp)`` mesh (one device for (1, 1)), this
    process rank 0: :func:`train_jobs` of one :class:`Job`."""
    return train_jobs([Job(cfg, opts, keep=keep, optimizer=optimizer,
                           batches=batches, sample=sample,
                           init_values=init_values or {})],
                      dp=dp, mp=mp)[0]


def _check(job: Job, dp: int, mp: int) -> None:
    if job.optimizer not in OPTIMIZERS:
        raise ValueError(f"optimizer {job.optimizer!r}: one of "
                         f"{', '.join(OPTIMIZERS)}")
    if job.batches is None and job.cfg.family in _EMBEDDED:
        raise ValueError(
            f"{job.cfg.name}: the {job.cfg.family} family's batches need "
            f"{_EMBEDDED[job.cfg.family]} beside the tokens; pass batches")
    if job.batches is not None and len(job.batches) < job.opts.steps:
        raise ValueError(f"{len(job.batches)} batches for "
                         f"{job.opts.steps} steps")
    if dp * mp == 1:
        return
    ShardPlan(job.cfg, TrainMesh(dp=dp, mp=mp))
    n_micro = max(1, job.opts.global_batch // max(job.cfg.microbatch, 1))
    if (job.opts.global_batch // n_micro) % dp:
        raise ValueError(
            f"a microbatch of {job.opts.global_batch // n_micro} rows "
            f"(global batch {job.opts.global_batch} in {n_micro}) does not "
            f"split over {dp} data ranks")


def train_jobs(jobs: list, *, dp: int = 1, mp: int = 1) -> list:
    """Run each :class:`Job` in turn on a ``(dp, mp)`` mesh (one device for
    (1, 1)), this process rank 0; the mesh's processes and groups are
    started once for all of them.  Returns rank 0's :func:`_run` result of
    each, with ``"ms_by_rank"`` on a mesh.  Raises :class:`RankFailure`
    naming the rank when a rank dies or fails."""
    if dp < 1 or mp < 1:
        raise ValueError(f"mesh {dp}x{mp} needs at least one rank on each "
                         f"axis")
    for job in jobs:
        _check(job, dp, mp)
    if dp * mp == 1:
        return [_run(job) for job in jobs]
    if len({job.opts.device for job in jobs}) != 1:
        raise ValueError("the jobs of one mesh run on one device type")
    devices, backend, staged = layout(dp, mp, jobs[0].opts.device)
    workdir = tempfile.mkdtemp(prefix="repro_torch_train_")
    wire = []
    for i, job in enumerate(jobs):
        path = None
        if job.batches is not None:
            path = os.path.join(workdir, f"batches{i}.pt")
            torch.save(job.batches, path)
        wire.append({"cfg": dataclasses.asdict(job.cfg),
                     "opts": dataclasses.asdict(job.opts),
                     "keep": list(job.keep), "optimizer": job.optimizer,
                     "batches": path, "sample": job.sample,
                     "init_values": job.init_values})
    spec = {"dp": dp, "mp": mp, "devices": devices, "backend": backend,
            "staged": staged, "store": os.path.join(workdir, "store"),
            "timeout_s": TRAIN_TIMEOUT_S,
            "control_timeout_s": CONTROL_TIMEOUT_S, "parent": os.getpid(),
            "jobs": wire}
    cpu = devices[0] == "cpu"
    threads = torch.get_num_threads()
    if cpu:  # every CPU rank computes on one thread: replicated work
        torch.set_num_threads(1)  # then gives every rank the same bits
    procs = spawn_workers("repro_torch.launch.train", spec, dp * mp, cpu=cpu)
    watch = _Watch(procs)
    mesh = None
    try:
        mesh = connect_train_mesh(spec, 0)
        watch.mesh = mesh
        outs = []
        for job in jobs:
            outs.append(_run(job, mesh))
            _free(mesh.device)
        for r, p in enumerate(procs, start=1):
            rc = p.wait(timeout=TRAIN_TIMEOUT_S)
            if rc != 0:
                raise RankFailure(f"rank {r} exited with code {rc}")
        return outs
    except Exception as e:
        # a rank's death shows in its exit code within moments of the
        # collective that failed on rank 0
        deadline = time.monotonic() + 2.0
        while watch.reason is None and not _dead(procs) \
                and time.monotonic() < deadline:
            time.sleep(_POLL_S / 4)
        reason = watch.reason or (_describe(_dead(procs)) if _dead(procs)
                                  else None)
        _kill(procs)
        if isinstance(e, RankFailure):
            raise
        if reason:
            raise RankFailure(f"{reason}; the run ends") from e
        raise RankFailure(f"rank 0 failed ({e!r}); the run ends") from e
    finally:
        watch.stop()
        _kill(procs)
        for p in procs:
            p.wait()
        if mesh is not None:
            mesh.close()
        shutil.rmtree(workdir, ignore_errors=True)
        torch.set_num_threads(threads)


def _free(device) -> None:
    """Return a finished job's memory before the next job starts."""
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def worker_main(spec_json: str, rank: int) -> None:
    """Entry point of rank ``rank`` (started by :func:`train_jobs` through
    ``spawn_workers``, which has SIGINT and SIGTERM ignored already):
    every job of the spec in turn."""
    try:
        spec = json.loads(spec_json)
        die_with_parent(spec["parent"])
        mesh = connect_train_mesh(spec, rank)
        for w in spec["jobs"]:
            batches = (None if w["batches"] is None else
                       torch.load(w["batches"], map_location="cpu"))
            _run(Job(ArchConfig.from_dict(w["cfg"]),
                     TrainOptions(**w["opts"]), keep=tuple(w["keep"]),
                     optimizer=w["optimizer"], batches=batches,
                     sample=w["sample"], init_values=w["init_values"]),
                 mesh)
            _free(mesh.device)
        # no NCCL shutdown here: it waits on rank 0's, which comes after
        # rank 0 has waited for this process; os._exit releases it all
    except BaseException:
        print(f"[train] rank {rank} failed:", file=sys.stderr, flush=True)
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)
    sys.stdout.flush()
    os._exit(0)


if __name__ == "__main__":
    raise SystemExit(main())
