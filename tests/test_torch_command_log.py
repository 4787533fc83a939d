"""The serving mesh's per-command log (``serve/distributed.py``): each
rank's newest commands with their send and ack times, read by rank 0
from the ranks' files while a rank is stuck, and bounded."""
from __future__ import annotations

import os
import pathlib
import time

import pytest

from repro_torch.serve.distributed import (
    CommandLog,
    make_serving_mesh,
    rank_launch_counts,
    reset_rank_counts,
)


def test_ring_keeps_the_newest(tmp_path):
    log = CommandLog(str(tmp_path / "cmdlog"), 0, slots=4)
    for k in range(6):
        i = log.start(f"cmd{k}")
        if k != 5:
            log.done(i)
    got = CommandLog.read(str(tmp_path / "cmdlog"), 0)
    assert [e[0] for e in got] == [2, 3, 4, 5]
    assert [e[1] for e in got] == [b"cmd2", b"cmd3", b"cmd4", b"cmd5"]
    assert all(e[3] >= e[2] for e in got[:3]) and got[3][3] != got[3][3]
    dump = CommandLog.dump(str(tmp_path / "cmdlog"), 2, last=2)
    assert "rank 0 #4 cmd4: sent -" in dump
    assert "rank 0 #5 cmd5: sent -" in dump and dump.endswith("ack pending")
    assert "rank 1" not in dump  # no file: no entries


def _cmd_sleep(mesh, seconds):
    if mesh.rank != 0:
        time.sleep(seconds)


@pytest.fixture(scope="module")
def mesh():
    # the workers import this module for _cmd_sleep
    here = str(pathlib.Path(__file__).resolve().parent)
    old = os.environ.get("PYTHONPATH")
    os.environ["PYTHONPATH"] = os.pathsep.join([here] + ([old] if old
                                                          else []))
    try:
        m = make_serving_mesh(1, 2, device="cpu")
    finally:
        if old is None:
            del os.environ["PYTHONPATH"]
        else:
            os.environ["PYTHONPATH"] = old
    yield m
    m.close()


def _settled(mesh, last=12, timeout=10.0) -> str:
    """The log once every rank has acked its last command (a worker
    writes its ack just after rank 0's own part returns)."""
    deadline = time.time() + timeout
    while True:
        dump = mesh.command_log(last)
        if "pending" not in dump or time.time() > deadline:
            return dump
        time.sleep(0.02)


def test_every_rank_logs_its_commands(mesh):
    reset_rank_counts(mesh)
    rank_launch_counts(mesh)
    dump = _settled(mesh)
    for r in (0, 1):
        assert f"rank {r} #0 _cmd_reset_counts: sent -" in dump
    assert "rank 0 #1 _cmd_launch_counts" in dump
    assert "pending" not in dump


def test_a_stuck_rank_shows_pending(mesh):
    """A worker still busy with a command: rank 0 has acked its part, the
    worker's entry is pending, and rank 0 reads both without a command."""
    mesh.call(_cmd_sleep, 2.0)
    deadline = time.time() + 10
    while "_cmd_sleep: sent" not in mesh.command_log().split("rank 1")[-1] \
            and time.time() < deadline:
        time.sleep(0.05)
    dump = mesh.command_log(last=1)
    lines = dump.splitlines()
    assert lines[1].startswith("  rank 0 #") and "_cmd_sleep" in lines[1]
    assert "ack pending" not in lines[1]
    assert "_cmd_sleep" in lines[2] and lines[2].endswith("ack pending")
    reset_rank_counts(mesh)  # waits behind the sleeping worker
    assert "pending" not in _settled(mesh, last=1)
