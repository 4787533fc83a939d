#!/usr/bin/env python3
"""``chip_smoke.py`` phase 11 (d) alone, several times: the front door
over a (1, 2) tensor-parallel mesh sharing one card, then a rank killed.

    python3 scripts/tp_frontdoor_drill.py [--runs 5] [--layers 8]

Builds the kernels, serves phase 4's schedule on one device at
``--layers`` layers (full width) as the reference, then per run starts a
fresh mesh, builds the model on both ranks from its seed and calls
``chip_smoke._tp_frontdoor`` with (d)'s gates.  A client that times out
dumps every rank's mesh command log (the last commands, their send and
ack times) before the run fails.  Prints one line a run and a summary;
exits 1 if any run failed.
"""
from __future__ import annotations

import argparse
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as cs  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--layers", type=int, default=cs.TP_LAYERS)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        cs.log("[tp-drill] torch.cuda.is_available() is False: the drill "
               "needs a CUDA card")
        return 2
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import make_calibration
    from repro_torch.serve.adapter import CachedDecoder
    from repro_torch.serve.distributed import (
        DistributedCachedDecoder,
        make_serving_mesh,
    )
    from repro_torch.serve.synthetic import synthetic_quantized_model

    cs.phase_device(torch)
    cs.phase_build()
    cfg = cs._depth_cut("tp-drill", get_config("qwen3-14b"), args.layers)
    prompt_len, gen = 128, 32
    arrive = (0, 0, 0, 0, 3, 5, 7, 9)
    prompts = make_calibration(cfg.vocab, n_segments=len(arrive),
                               seg_len=prompt_len, seed=args.seed + 3)
    schedule = [(t, dict(prompt=p, max_new=gen))
                for p, t in zip(prompts, arrive)]
    qm = synthetic_quantized_model(cfg, seed=args.seed, device="cuda")
    _, one, _ = cs._serve_schedule(
        torch, f"tp-drill one device {cfg.n_layers} layers",
        CachedDecoder.from_quantized(qm), cs.SERVE_ARGS, schedule,
        max_seq_len=prompt_len + gen, replay=False)
    base = one["reqs"]
    check_max = cs.check_logits(
        torch, qm, prompts, [base[i] for i in range(len(prompts))],
        atol=cs.LOGIT_ATOL, mean_atol=cs.LOGIT_MEAN_ATOL,
        tag="tp-drill one device check")["max_diff"]
    passed = []
    for run in range(args.runs):
        t0 = time.perf_counter()
        mesh = make_serving_mesh(1, 2, device="cuda")
        try:
            dist = DistributedCachedDecoder.from_builder(
                synthetic_quantized_model, mesh=mesh, cfg=cfg,
                seed=args.seed)
            cs._tp_frontdoor(torch, mesh, dist, qm, prompts, base,
                             check_max=check_max, gen=gen,
                             max_seq_len=prompt_len + gen)
            passed.append(True)
        except Exception as e:  # the run's failure is the drill's reading
            cs.log(f"[tp-drill] run {run} failed: {e!r}")
            passed.append(False)
        finally:
            mesh.close()
        cs.log(f"[tp-drill] run {run} at {cfg.n_layers} layers: "
               f"{'passed' if passed[-1] else 'FAILED'} in "
               f"{time.perf_counter() - t0:.1f}s")
    cs.log(f"[tp-drill] {sum(passed)} of {len(passed)} runs passed at "
           f"{cfg.n_layers} layers")
    return 0 if all(passed) else 1


if __name__ == "__main__":
    sys.exit(main())
