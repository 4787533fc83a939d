#!/usr/bin/env python3
"""The serve CLI's ``--mesh`` on NCCL, and how long rank 0 takes to exit.

    python3 scripts/nccl_exit_check.py     # four CUDA cards

Builds the kernels once (so no rank waits on the build lock), then runs
``python -m repro_torch.launch.serve --smoke --device cuda --paged
--paged-prefill`` with ``--mesh 1,2`` and with ``--mesh 2,2 --check``,
prints every output line stamped with the seconds since that command
started, and the seconds rank 0 took to exit after its last line (an NCCL
group left to the interpreter's exit held it for minutes).  Exits with the
first nonzero exit code of the two commands.
"""
from __future__ import annotations

import os
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

MESHES = (("1,2", []), ("2,2", ["--check"]))


def run(mesh: str, extra: list) -> int:
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--smoke",
           "--device", "cuda", "--mesh", mesh, "--paged", "--paged-prefill",
           "--requests", "8", "--prompt-len", "32", "--gen", "16", *extra]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    p = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
    last = t0
    for line in p.stdout:
        last = time.perf_counter()
        print(f"[{last - t0:8.2f}s] {line.rstrip()}", flush=True)
    rc = p.wait()
    t_end = time.perf_counter()
    print(f"[nccl] --mesh {mesh} {' '.join(extra)}: rc {rc}, last line at "
          f"{last - t0:.2f}s, rank 0 exited {t_end - last:.2f}s after it "
          f"(whole {t_end - t0:.2f}s)", flush=True)
    return rc


def main() -> int:
    import torch

    import chip_smoke

    if torch.cuda.device_count() < 4:
        print(f"[nccl] needs four CUDA cards, found "
              f"{torch.cuda.device_count()}", flush=True)
        return 2
    print(f"[nccl] {chip_smoke.phase_device(torch)['smi']}", flush=True)
    chip_smoke.phase_build()
    rcs = [run(mesh, extra) for mesh, extra in MESHES]
    return next((rc for rc in rcs if rc), 0)


if __name__ == "__main__":
    sys.exit(main())
