"""The elastic drill of mesh training on the CPU (gloo ranks): a (1, 4)
run of the train CLI saves at step k, one rank is SIGKILLed mid-step, the
survivors end the run naming it, and a restart with ``--devices 3``
(``remesh``: (1, 3), where every leaf of the smoke qwen3-14b replicates)
resumes at k from the logical checkpoint.

Tolerances: the restored leaves, bit for bit (the restart with ``--steps
k`` writes back what it restored); losses and grad norms after the resume
against a one-device run resumed from the same checkpoint, relative 1e-5;
their leaves as ``test_torch_train_mesh.py``'s.
"""
from __future__ import annotations

import os
import pathlib
import shutil
import signal
import subprocess
import sys
import time

import numpy as np

from repro_torch.checkpoint.store import latest_step, load_arrays
from repro_torch.launch import train as tr

ROOT = pathlib.Path(__file__).resolve().parents[1]
LOSS_RTOL = 1e-5
LEAF_RTOL, LEAF_ATOL = 1e-5, 1e-6
KILL_RANK = 2
START_S = 120  # the 4-rank CLI's start, to its step-2 checkpoint
ARGS = ["--arch", "qwen3-14b", "--smoke", "--device", "cpu",
        "--global-batch", "4", "--seq-len", "16", "--log-every", "1"]


def _ranks(pid: int) -> dict:
    """{rank: pid} of the train CLI's worker ranks (their last argv)."""
    kids = pathlib.Path(f"/proc/{pid}/task/{pid}/children").read_text()
    out = {}
    for k in map(int, kids.split()):
        argv = pathlib.Path(f"/proc/{k}/cmdline").read_bytes().split(b"\0")
        out[int(argv[-2])] = k
    return out


def _alive(pid: int) -> bool:
    try:
        state = pathlib.Path(f"/proc/{pid}/stat").read_text().split()[2]
    except FileNotFoundError:
        return False
    return state != "Z"


def test_sigkilled_rank_ends_the_run_and_three_ranks_resume(tmp_path,
                                                            capsys):
    ck, one = tmp_path / "ck", tmp_path / "one"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    p = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", *ARGS,
         "--devices", "4", "--steps", "100000", "--save-every", "2",
         "--ckpt-dir", str(ck)], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env, cwd=ROOT)
    ranks = {}
    try:
        deadline = time.monotonic() + START_S
        while not (ck / "step_00000002" / "manifest.json").exists():
            assert p.poll() is None and time.monotonic() < deadline, \
                p.communicate(timeout=5)
            time.sleep(0.05)
        ranks = _ranks(p.pid)
        assert sorted(ranks) == [1, 2, 3]
        time.sleep(0.2)  # into a later step
        os.kill(ranks[KILL_RANK], signal.SIGKILL)
        t0 = time.monotonic()
        out, err = p.communicate(timeout=tr.TRAIN_TIMEOUT_S)
        took = time.monotonic() - t0
    finally:
        if p.poll() is None:
            p.kill()
            p.communicate()
        for pid in ranks.values():
            if _alive(pid):
                os.kill(pid, signal.SIGKILL)
    assert p.returncode != 0
    assert f"rank {KILL_RANK} was killed by signal 9" in err, err[-2000:]
    assert "the run ends" in err
    assert took < tr.TRAIN_TIMEOUT_S
    time.sleep(0.5)
    assert not [r for r, pid in ranks.items() if _alive(pid)]

    k = latest_step(ck)
    assert k is not None and k >= 2 and k % 2 == 0
    shutil.copytree(ck, one)
    want, _, meta_k, _ = load_arrays(ck, step=k)
    capsys.readouterr()

    # on 3 ranks, no step: the final save writes back what was restored
    assert tr.main([*ARGS, "--devices", "3", "--steps", str(k),
                    "--ckpt-dir", str(ck)]) == 0
    log = capsys.readouterr().out
    assert f"resumed from step {k}" in log
    assert "mesh data=1 model=3" in log
    got, _, _, _ = load_arrays(ck, step=k)
    assert list(got) == list(want)
    for key in want:
        assert got[key].tobytes() == want[key].tobytes(), key

    # two steps on 3 ranks, against one device from the same checkpoint
    assert tr.main([*ARGS, "--devices", "3", "--steps", str(k + 2),
                    "--ckpt-dir", str(ck)]) == 0
    assert tr.main([*ARGS, "--devices", "1", "--steps", str(k + 2),
                    "--ckpt-dir", str(one)]) == 0
    a, _, ma, _ = load_arrays(ck, step=k + 2)
    b, _, mb, _ = load_arrays(one, step=k + 2)
    assert ma["metrics"][:k] == mb["metrics"][:k] == meta_k["metrics"]
    for s in (k, k + 1):
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(ma["metrics"][s][key],
                                       mb["metrics"][s][key], rtol=LOSS_RTOL,
                                       err_msg=f"step {s} {key}")
    assert list(a) == list(b)
    for key in a:
        np.testing.assert_allclose(a[key], b[key], rtol=LEAF_RTOL,
                                   atol=LEAF_ATOL, err_msg=key)
