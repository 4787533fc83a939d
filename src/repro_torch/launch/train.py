"""Fault-tolerant training driver.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-14b \\
        --smoke --device cpu --steps 8 --save-every 3 --fail-at 5 \\
        --ckpt-dir /tmp/ck

The JAX package's ``launch/train.py`` with its flags, plus ``--device``
(``cuda``, the default, or ``cpu``):

  * deterministic ``(seed, step)`` data stream (``token_batches``) ->
    exact resume semantics;
  * the train state in the JAX package's layout (layers stacked), adamw
    over a cosine schedule, ``global_batch // cfg.microbatch``
    microbatches;
  * CheckpointManager: atomic save-every-K, keep-k GC, auto-resume, and an
    unconditional final save;
  * failure trap: any step exception restores the latest checkpoint and
    continues from its step with the stream rebuilt there (``--fail-at``
    injects a fault for testing); the 4th consecutive failure is raised.

A fresh start initialises from ``torch.Generator(device).manual_seed(
seed)``, whose values differ from the JAX package's ``jax.random`` init.
The encdec and vlm archs are refused: the stream has no ``frames`` /
``patches`` embeddings (the JAX CLI fails there with a ``KeyError``).
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from repro_torch.checkpoint.store import CheckpointManager, save_checkpoint
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.convert import stack_layers
from repro_torch.data.synthetic import token_batches
from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_train_step
from repro_torch.models.lm import build_model
from repro_torch.optim import adamw, cosine_schedule
from repro_torch.tree import tree_map

__all__ = ["main"]

_EMBEDDED = {"encdec": "frames", "vlm": "patches"}


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
    args = ap.parse_args(argv)

    if args.device == "cuda":
        _deterministic_cuda()
    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if cfg.family in _EMBEDDED:
        raise SystemExit(
            f"--arch {args.arch}: the {cfg.family} family's stub frontend "
            f"needs {_EMBEDDED[cfg.family]} embeddings beside the tokens, "
            f"which token_batches does not make")
    model = build_model(cfg)
    opt = adamw(cosine_schedule(args.lr, args.steps, max(args.steps // 20, 1)))
    n_micro = max(1, args.global_batch // max(cfg.microbatch, 1))
    train_step = make_train_step(model, opt, n_micro=n_micro)
    mgr = CheckpointManager(args.ckpt_dir, keep=args.keep,
                            save_every=args.save_every)

    def fresh():
        g = torch.Generator(device=device)
        g.manual_seed(args.seed)
        params = stack_layers(model.init(g, device=device))
        return params, opt.init(params)

    def stream_from(step):
        return token_batches(cfg.vocab, args.global_batch, args.seq_len,
                             seed=args.seed, start_step=step, device=device)

    params, opt_state = fresh()
    # the restore reads only dtypes: hold shapes, not a second state
    state_like = tree_map(lambda t: torch.empty_like(t, device="meta"),
                          {"params": params, "opt": opt_state})
    start = 0
    try:
        restored, step, _ = mgr.restore_latest(state_like, device=device)
        params, opt_state = restored["params"], restored["opt"]
        start = step
        print(f"[train] resumed from step {step}")
    except FileNotFoundError:
        print("[train] fresh start")

    stream = stream_from(start)
    step = start
    injected = False
    consecutive_failures = 0
    while step < args.steps:
        batch = next(stream)
        try:
            if step == args.fail_at and not injected:
                injected = True
                raise RuntimeError("injected node failure")
            t0 = time.time()
            params, opt_state, metrics = train_step(params, opt_state, batch,
                                                    step)
            if step % args.log_every == 0:
                print(f"[train] step {step} "
                      f"loss={float(metrics['loss']):.4f} "
                      f"gnorm={float(metrics['grad_norm']):.3f} "
                      f"dt={time.time() - t0:.2f}s")
            step += 1
            consecutive_failures = 0
            mgr.maybe_save(step, {"params": params, "opt": opt_state})
        except Exception as e:  # failure trap: restore + continue
            consecutive_failures += 1
            if consecutive_failures > 3:
                raise  # persistent failure: surface it, don't spin
            print(f"[train] step {step} FAILED ({e}); restoring…", flush=True)
            try:
                restored, ck_step, _ = mgr.restore_latest(state_like,
                                                          device=device)
                params, opt_state = restored["params"], restored["opt"]
                step = ck_step
                stream = stream_from(step)
                print(f"[train] restored to step {ck_step}, continuing")
            except FileNotFoundError:
                print("[train] no checkpoint yet; restarting from scratch")
                params, opt_state = fresh()
                step = 0
                stream = stream_from(0)
    save_checkpoint(args.ckpt_dir, step, {"params": params, "opt": opt_state})
    print(f"[train] done at step {step}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
