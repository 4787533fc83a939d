#!/usr/bin/env python3
"""Training over four cards (NCCL), then a rank SIGKILLed and a resume on
three: the multi-card half of the port's mesh training, measured.

    python3 scripts/train_mesh_drill.py [--drill-layers 1] [--parts mesh,drill]

Needs four visible cards.  At full width, depth cut for memory:

  1. ``chip_smoke.train_mesh_child`` on (1, 4), one rank a card on NCCL,
     of phase 16's runs (a), (b), (d) and (d) bf16: qwen3-14b at 2 layers
     and llama4-scout-17b-a16e at 1 (4 of its 16 experts a rank), each
     fp32 run on one card, then on the mesh, held to each other by phase
     16's gates (``chip_smoke.mesh_gates``), and the bf16 step time (CUDA
     events) on every rank;
  2. qwen3-14b at ``--drill-layers``: ``train`` on the mesh ``remesh``
     picks for the four cards, saving
     every 2 steps, in a process of its own; once step 2's checkpoint is
     written, rank ``KILL_RANK`` is SIGKILLed mid-step: the run must end
     non-zero within ``TRAIN_TIMEOUT_S``, naming the rank, with no rank
     left.  Then ``train`` again with ``CUDA_VISIBLE_DEVICES`` set to three
     cards (``remesh``: (1, 3), every leaf whole on every card) resumes
     from the latest checkpoint k for 2 steps, and, at the same time on
     the fourth card, a one-card run resumes from the same checkpoint
     (hard links of its files); their losses and grad norms must agree
     within phase 16's tolerance.

Prints the card's name and power limit, one line per check, and writes
the record to ``chiprun_out/train_mesh_drill.json``; exits 1 if a check
failed.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pathlib
import shutil
import signal
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as cs  # noqa: E402

KILL_RANK = 2
SAVE_EVERY = 2
OUT = ROOT / "chiprun_out" / "train_mesh_drill.json"
# part 2's runs: this process's child is rank 0, its ranks are its children
RUN_CHILD = r"""
import dataclasses, json, sys
import torch
from repro_torch.configs import ArchConfig
from repro_torch.launch.train import TrainOptions, mesh_shape, train
spec = json.loads(sys.argv[1])
# the cards visible (a CPU rehearsal names its rank count)
n = (torch.cuda.device_count() if spec["opts"]["device"] == "cuda"
     else spec["n"])
dp, mp = mesh_shape(n)
print(json.dumps({"mesh": [dp, mp], "devices": n}), flush=True)
out = train(ArchConfig.from_dict(spec["cfg"]), TrainOptions(**spec["opts"]),
            dp=dp, mp=mp)
print(json.dumps({"history": out["history"],
                  "ms_by_rank": out.get("ms_by_rank")}), flush=True)
"""


def _env(cards: str) -> dict:
    return {**os.environ, "CUDA_VISIBLE_DEVICES": cards,
            "PYTHONPATH": os.pathsep.join(
                [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")])}


def _spawn(cfg, opts, cards: str, log_path: pathlib.Path):
    spec = {"cfg": dataclasses.asdict(cfg), "opts": dataclasses.asdict(opts),
            "n": len(cards.split(","))}
    f = open(log_path, "w")
    p = subprocess.Popen([sys.executable, "-c", RUN_CHILD, json.dumps(spec)],
                         env=_env(cards), cwd=ROOT, stdout=f,
                         stderr=subprocess.STDOUT, text=True)
    return p, f


def _records(path: pathlib.Path) -> list:
    out = []
    for line in path.read_text().splitlines():
        if line.startswith("{"):
            out.append(json.loads(line))
        else:
            cs.log(f"  | {line}")
    return out


def _ranks(pid: int) -> dict:
    kids = pathlib.Path(f"/proc/{pid}/task/{pid}/children").read_text()
    out = {}
    for k in map(int, kids.split()):
        argv = pathlib.Path(f"/proc/{k}/cmdline").read_bytes().split(b"\0")
        out[int(argv[-2])] = k
    return out


def _alive(pid: int) -> bool:
    try:
        return pathlib.Path(f"/proc/{pid}/stat").read_text().split()[2] != "Z"
    except FileNotFoundError:
        return False


MESH_RUNS = ("(a)", "(b)", "(d)", "(d) bf16")


def part_mesh(seed: int, rec: dict, runs=None) -> bool:
    tag = "mesh-4"
    runs = runs or [r for r in cs.mesh_runs() if r["tag"] in MESH_RUNS]
    cs.log(f"[{tag}] runs {', '.join(r['tag'] for r in runs)} on (1, 4) on "
           f"NCCL, {cs.MESH_BATCH} x {cs.MESH_SEQ} tokens in "
           f"{cs.MESH_BATCH // cs.MESH_MICRO} microbatches")
    res = cs.run_mesh_child(runs, 4, seed, tag)
    rec["mesh"] = res
    try:
        cs.mesh_gates(res, runs, 4)
    except AssertionError as e:
        cs.log(f"[{tag}] FAIL: {e}")
        return False
    return True


def part_drill(cfg, seed: int, rec: dict) -> bool:
    from repro_torch.checkpoint.store import latest_step
    from repro_torch.launch.train import TRAIN_TIMEOUT_S, TrainOptions

    tag = "drill"
    work = cs.WORK_DIR / "train_mesh_drill"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    ck, one = work / "ck", work / "one"
    opts = TrainOptions(steps=10**6, global_batch=cs.MESH_BATCH,
                        seq_len=cs.MESH_SEQ, ckpt_dir=str(ck),
                        save_every=SAVE_EVERY, seed=seed, device=cs.DEV,
                        log_every=1)
    checks = {}
    p, f = _spawn(cfg, opts, "0,1,2,3", work / "run4.log")
    ranks = {}
    try:
        t0 = time.monotonic()
        while not (ck / f"step_{SAVE_EVERY:08d}" / "manifest.json").exists():
            if p.poll() is not None or time.monotonic() - t0 > 900:
                raise RuntimeError("the 4-card run ended or stalled before "
                                   "its first checkpoint")
            time.sleep(0.1)
        t_save = time.monotonic() - t0
        ranks = _ranks(p.pid)
        time.sleep(1.0)  # into a later step
        os.kill(ranks[KILL_RANK], signal.SIGKILL)
        t_kill = time.monotonic()
        rc = p.wait(timeout=TRAIN_TIMEOUT_S + 60)
        took = time.monotonic() - t_kill
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()
        f.close()
        for pid in ranks.values():
            if _alive(pid):
                os.kill(pid, signal.SIGKILL)
    log4 = (work / "run4.log").read_text()
    _records(work / "run4.log")
    time.sleep(0.5)
    left = [r for r, pid in ranks.items() if _alive(pid)]
    checks[f"the run ended non-zero ({rc})"] = rc not in (0, None)
    checks[f"its message names rank {KILL_RANK}"] = (
        f"rank {KILL_RANK} was killed by signal 9" in log4)
    checks[f"it ended {took:.2f} s after the kill, within "
           f"{TRAIN_TIMEOUT_S} s"] = took < TRAIN_TIMEOUT_S
    checks[f"no rank left ({left})"] = not left
    k = latest_step(ck)
    rec["drill"] = {"first_save_s": t_save, "exit_s": took, "rc": rc, "k": k}
    cs.log(f"[{tag}] step {SAVE_EVERY}'s checkpoint {t_save:.1f} s after the "
           f"start; rank {KILL_RANK} killed; latest checkpoint: step {k}")

    # the one-card run resumes from step k's files (hard links)
    one.mkdir()
    shutil.copytree(ck / f"step_{k:08d}", one / f"step_{k:08d}",
                    copy_function=os.link)
    steps = k + 2
    runs, procs = {}, {}
    # both resumes at once, on cards of their own (each loads the whole
    # checkpoint and writes a final one)
    t0 = time.monotonic()
    for name, cards, d in (("3 cards", "0,1,2", ck), ("1 card", "3", one)):
        # one save, the final one (a periodic save adds nothing here)
        procs[name] = _spawn(cfg, dataclasses.replace(
            opts, steps=steps, ckpt_dir=str(d), save_every=10**6), cards,
            work / f"run{name[0]}.log")
    for name, (p, f) in procs.items():
        try:
            rc = p.wait(timeout=1800)
        finally:
            if p.poll() is None:
                p.kill()
                p.wait()
            f.close()
        text = (work / f"run{name[0]}.log").read_text()
        cs.log(f"[{tag}] the {name} resume:")
        recs = _records(work / f"run{name[0]}.log")
        runs[name] = {"rc": rc, "mesh": recs[0]["mesh"] if recs else None,
                      "wall_s": time.monotonic() - t0,
                      "resumed": f"resumed from step {k}" in text,
                      **(recs[-1] if len(recs) > 1 else {})}
    rec["resume"] = runs
    a, b = runs["3 cards"], runs["1 card"]
    checks["both resumes exit 0"] = a["rc"] == 0 and b["rc"] == 0
    checks[f"both resumed from step {k}"] = a["resumed"] and b["resumed"]
    checks[f"the 3-card mesh is {a['mesh']}"] = a["mesh"] == [1, 3]
    worst = 0.0
    if checks["both resumes exit 0"]:
        for s in (k, k + 1):
            for key in ("loss", "grad_norm"):
                x, y = a["history"][s][key], b["history"][s][key]
                worst = max(worst, abs(x - y) / abs(y))
                cs.log(f"[{tag}] step {s} {key}: 3 cards {x:.7f}, 1 card "
                       f"{y:.7f}")
        for r, ms in enumerate(a["ms_by_rank"]):
            cs.log(f"[{tag}] 3 cards, rank {r}: fp32 step ms (CUDA events) "
                   + ", ".join(f"{t:.1f}" for t in ms[k:steps]))
    checks[f"losses and grad norms within {cs.MESH_LOSS_RTOL:g} (worst "
           f"{worst:.2e})"] = (checks["both resumes exit 0"]
                               and worst <= cs.MESH_LOSS_RTOL)
    for what, ok in checks.items():
        cs.log(f"[{tag}] {what}: {'OK' if ok else 'FAIL'}")
    rec["drill"]["checks"] = checks
    shutil.rmtree(work, ignore_errors=True)
    return all(checks.values())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--drill-layers", type=int, default=1)
    ap.add_argument("--parts", default="mesh,drill",
                    help="which parts to run: mesh, drill or both")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    parts = set(args.parts.split(","))

    import torch

    from repro_torch.configs import get_config

    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        cs.log("[train-mesh-drill] needs four CUDA cards")
        return 2
    rec = {"device": cs.phase_device(torch)}
    full = get_config(cs.TRAIN_ARCH)
    t0 = time.perf_counter()
    ok = True
    if "mesh" in parts:
        ok &= part_mesh(args.seed, rec)
    if "drill" in parts:
        cs.log(f"[train-mesh-drill] DEPTH CUT: {args.drill_layers} of "
               f"{full.n_layers} layers (memory) for part 2 (three whole "
               f"copies of the state, one a card)")
        ok &= part_drill(dataclasses.replace(
            full, n_layers=args.drill_layers, microbatch=cs.MESH_MICRO,
            dtype="float32"), args.seed, rec)
    rec["wall_s"] = time.perf_counter() - t0
    OUT.parent.mkdir(parents=True, exist_ok=True)
    OUT.write_text(json.dumps(rec, indent=1, default=str))
    cs.log(f"[train-mesh-drill] {'passed' if ok else 'FAILED'} in "
           f"{rec['wall_s']:.1f} s; record in {OUT.relative_to(ROOT)}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
