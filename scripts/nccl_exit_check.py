#!/usr/bin/env python3
"""The serve CLI's ``--mesh`` on NCCL, and how long rank 0 takes to exit.

    python3 scripts/nccl_exit_check.py     # four CUDA cards

Builds the kernels once (so no rank waits on the build lock), then runs
``python -m repro_torch.launch.serve --smoke --device cuda --paged
--paged-prefill`` with ``--mesh 1,2`` and with ``--mesh 2,2 --check``,
prints every output line stamped with the seconds since that command
started, and the seconds rank 0 took to exit after its last line (an NCCL
group left to the interpreter's exit held it for minutes).  Then the
front door over the mesh: ``--mesh 1,2 --http-port 0``, one client
request, SIGTERM, and rank 0 must exit 0 within ``EXIT_S`` of its last
line; and again, SIGKILL of rank 0 with its worker idle, and no rank may
be left (``/proc``, ``nvidia-smi``) within ``REAP_S``.  Exits with the
first nonzero exit code, 1 if a limit is missed.
"""
from __future__ import annotations

import http.client
import json
import os
import pathlib
import signal
import subprocess
import sys
import threading
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

MESHES = (("1,2", []), ("2,2", ["--check"]))
# seconds rank 0 may take to exit after its last line (SIGTERM), and its
# ranks to end after a SIGKILL of rank 0
EXIT_S, REAP_S = 5.0, 10.0
SERVE = [sys.executable, "-m", "repro_torch.launch.serve", "--smoke",
         "--device", "cuda", "--paged", "--paged-prefill"]


def run(mesh: str, extra: list) -> int:
    cmd = [*SERVE, "--mesh", mesh, "--requests", "8", "--prompt-len", "32",
           "--gen", "16", *extra]
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


class Served:
    """The CLI's ``--mesh 1,2 --http-port 0`` as a child, every line echoed
    stamped with the seconds since start; ``last`` is the last line's
    time."""

    def __init__(self):
        self.t0 = self.last = time.perf_counter()
        self.port = None
        self.ready = threading.Event()
        self.p = subprocess.Popen(
            [*SERVE, "--mesh", "1,2", "--http-port", "0"], cwd=ROOT,
            env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        self.reader = threading.Thread(target=self._read, daemon=True)
        self.reader.start()
        if not self.ready.wait(600) or self.port is None:
            raise RuntimeError("the front door never listened")

    def _read(self) -> None:
        for line in self.p.stdout:
            self.last = time.perf_counter()
            print(f"[{self.last - self.t0:8.2f}s] {line.rstrip()}",
                  flush=True)
            if line.startswith("[frontdoor] listening on "):
                self.port = int(line.rsplit(":", 1)[1])
                self.ready.set()
        self.ready.set()

    def generate(self) -> list:
        c = http.client.HTTPConnection("127.0.0.1", self.port, timeout=120)
        try:
            c.request("POST", "/v1/generate", json.dumps(
                {"prompt": list(range(1, 33)), "max_new": 16,
                 "stream": False}), {"Content-Type": "application/json"})
            r = c.getresponse()
            body = json.loads(r.read())
        finally:
            c.close()
        if r.status != 200 or len(body.get("tokens", ())) != 16:
            raise RuntimeError(f"generate: {r.status} {body}")
        return body["tokens"]


def _gpu_pids() -> list:
    """The pid of each compute app ``nvidia-smi`` lists on the cards (in a
    container they may be the host's pids, so their count is compared)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    return [int(ln.split(",")[0]) for ln in out.splitlines() if ln.strip()]


def run_http() -> int:
    """SIGTERM after one request: rank 0 exits 0 within ``EXIT_S`` of its
    last line.  Then SIGKILL of rank 0: no rank within ``REAP_S``."""
    from repro_torch.serve.fleet.supervisor import _descendants, _running

    srv = Served()
    toks = srv.generate()
    srv.p.send_signal(signal.SIGTERM)
    rc = srv.p.wait()
    srv.reader.join(30)
    t_exit = time.perf_counter() - srv.last
    print(f"[nccl] --mesh 1,2 --http-port 0: one request ({len(toks)} "
          f"tokens), SIGTERM: rc {rc}, rank 0 exited {t_exit:.2f}s after "
          f"its last line (limit {EXIT_S}s)", flush=True)
    bad = rc or int(t_exit > EXIT_S)

    srv = Served()
    ranks = _descendants(srv.p.pid)
    pids = [srv.p.pid] + [p for p, _ in ranks]
    before = _gpu_pids()

    def held() -> list:
        apps = _gpu_pids()
        return (sorted(set(pids) & set(apps))
                or apps[max(0, len(before) - len(pids)):])

    t_kill = time.perf_counter()
    srv.p.kill()
    srv.p.wait()
    while time.perf_counter() - t_kill < REAP_S and (
            any(map(_running, ranks)) or held()):
        time.sleep(0.05)
    t_gone = time.perf_counter() - t_kill
    left = [proc[0] for proc in ranks if _running(proc)]
    print(f"[nccl] --mesh 1,2 --http-port 0, SIGKILL of rank 0 (pids "
          f"{pids}): ranks left {left}; nvidia-smi lists {len(before)} "
          f"apps before, {len(_gpu_pids())} {t_gone:.2f}s after the kill "
          f"(limit {REAP_S}s)", flush=True)
    return bad or int(bool(left or held()))


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
    rcs.append(run_http())
    return next((rc for rc in rcs if rc), 0)


if __name__ == "__main__":
    sys.exit(main())
