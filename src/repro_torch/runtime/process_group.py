"""Process groups for a mesh of processes, shared by serving and training.

Every rank of a ``(data, model)`` mesh is a process with its own device;
collectives run on ``torch.distributed`` process groups built here without
its global state (:func:`process_group`), so one process may hold several
meshes.  :func:`layout` places the ranks: one per card on NCCL where the
cards suffice, else ranks sharing cards on gloo with every collective on a
CUDA tensor staged through host memory, and gloo on the CPU.  Nothing falls
back from one to the other.

:class:`Communicator` is one group's collectives.  Its sums gather every
rank's buffer and add them in rank order, so every rank holds the same bits
and a rerun replays them whatever the backend's reduction order.  A failed
or timed-out collective raises :class:`CollectiveError`.

Workers are started by :func:`spawn_workers` as ``python -c`` processes of
the same interpreter with this package on their path; each ignores SIGINT
and SIGTERM from its first line on (its rank 0 stops it) and calls
:func:`die_with_parent`, so it is SIGKILLed when rank 0 goes, however rank
0 dies.
"""
from __future__ import annotations

import datetime
import json
import os
import signal
import subprocess
import sys
from typing import Optional

import torch

from repro_torch.device import resolve_device

__all__ = ["MAX_RANKS_PER_CARD", "CollectiveError", "Communicator",
           "process_group", "layout", "die_with_parent", "spawn_workers"]

# ranks a mesh may place on one card when cards are fewer than ranks
MAX_RANKS_PER_CARD = 4

_LOOPBACK = "127.0.0.1"
_PR_SET_PDEATHSIG = 1


class CollectiveError(RuntimeError):
    """A collective failed or timed out: a peer is gone or stuck."""


def process_group(store, rank: int, size: int, backend: str,
                  timeout_s: float):
    """A process group on ``store`` without torch.distributed's global
    state."""
    import torch.distributed as dist

    timeout = datetime.timedelta(seconds=timeout_s)
    if backend == "nccl":
        opts = dist.ProcessGroupNCCL.Options()
        opts._timeout = timeout
        return dist.ProcessGroupNCCL(store, rank, size, opts)
    opts = dist.ProcessGroupGloo._Options()
    opts._devices = [dist.ProcessGroupGloo.create_device(hostname=_LOOPBACK)]
    opts._timeout = timeout
    return dist.ProcessGroupGloo(store, rank, size, opts)


class Communicator:
    """Collectives over one group of ``size`` ranks, this one ``rank``.

    ``staged``: the backend is gloo and the tensors live on a card, so
    every collective copies its buffer to host memory, runs there and
    copies the result back (one copy each way)."""

    def __init__(self, pg, size: int, device: torch.device, staged: bool,
                 rank: int = 0):
        self.pg, self.size, self.rank = pg, size, rank
        self.device, self.staged = device, staged

    def all_gather(self, buf: torch.Tensor) -> list:
        """Every rank's ``buf`` (same shape and dtype), in rank order."""
        x = buf.contiguous()
        # all-gather only moves bytes: 2-byte floats travel as float16,
        # a type both gloo and NCCL take (neither takes int16)
        wire = x.view(torch.float16) if x.element_size() == 2 else x
        if self.staged:
            wire = wire.cpu()
        outs = [torch.empty_like(wire) for _ in range(self.size)]
        try:
            self.pg.allgather([outs], [wire]).wait()
        except RuntimeError as e:
            raise CollectiveError(f"all-gather over {self.size} ranks "
                                  f"failed: {e}") from e
        if self.staged:
            outs = list(torch.stack(outs).to(self.device).unbind(0))
        return [o.view(x.dtype) for o in outs]

    def all_gather_cat(self, tensors: list) -> list:
        """Each (..., m_i) tensor (same leading shape and dtype) -> the
        (..., m_i · size) tensor of every rank's piece in rank order, all
        in one collective."""
        if self.size == 1:
            return list(tensors)
        lead = tensors[0].shape[:-1]
        widths = [t.shape[-1] for t in tensors]
        buf = torch.cat([t.reshape(-1, w) for t, w in zip(tensors, widths)],
                        dim=1)
        parts = self.all_gather(buf)
        out, off = [], 0
        for w in widths:
            out.append(torch.cat([p[:, off:off + w] for p in parts], dim=1)
                       .reshape(*lead, w * self.size))
            off += w
        return out

    def gather_dim(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's block of ``t`` (same shape) concatenated along
        ``dim`` in rank order."""
        if self.size == 1:
            return t
        return torch.cat(self.all_gather(t), dim=dim)

    def all_reduce_sum(self, tensors: list) -> list:
        """The sum over ranks of each tensor, added in rank order (every
        rank holds the same bits), all in one collective."""
        if self.size == 1:
            return list(tensors)
        flat = torch.cat([t.reshape(-1) for t in tensors])
        parts = self.all_gather(flat)
        total = parts[0].clone()
        for p in parts[1:]:
            total += p
        out, off = [], 0
        for t in tensors:
            out.append(total[off:off + t.numel()].reshape(t.shape))
            off += t.numel()
        return out

    def all_reduce_max(self, t: torch.Tensor) -> torch.Tensor:
        """The elementwise max over ranks."""
        if self.size == 1:
            return t
        return torch.stack(self.all_gather(t)).amax(dim=0)

    def reduce_scatter_sum(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's block along ``dim`` of the sum over ranks of ``t``
        (a dim that the group's size divides), added in rank order."""
        if self.size == 1:
            return t
        n = t.shape[dim] // self.size
        parts = self.all_gather(t)
        total = parts[0].narrow(dim, self.rank * n, n).clone()
        for p in parts[1:]:
            total += p.narrow(dim, self.rank * n, n)
        return total


def layout(dp: int, mp: int, device) -> tuple[list, str, bool]:
    """(device of each rank, backend, staged) for a dp x mp mesh."""
    need = dp * mp
    dev = resolve_device(device)
    if dev.type == "cpu":
        return ["cpu"] * need, "gloo", False
    have = torch.cuda.device_count()
    if have >= need:
        return [f"cuda:{r}" for r in range(need)], "nccl", False
    if need > have * MAX_RANKS_PER_CARD:
        raise ValueError(
            f"mesh {dp}x{mp} needs {need} ranks but only {have} CUDA "
            f"device(s) are visible, at most {MAX_RANKS_PER_CARD} ranks "
            f"each")
    return [f"cuda:{r % have}" for r in range(need)], "gloo", True


def die_with_parent(parent: int) -> None:
    """On Linux, SIGKILL this process when the thread that started it
    ends (``PR_SET_PDEATHSIG``); exit now if rank 0 ``parent`` is already
    gone (it died before the request took effect)."""
    if sys.platform.startswith("linux"):
        import ctypes

        libc = ctypes.CDLL(None, use_errno=True)
        if libc.prctl(_PR_SET_PDEATHSIG, signal.SIGKILL, 0, 0, 0) != 0:
            raise OSError(ctypes.get_errno(), "prctl(PR_SET_PDEATHSIG)")
    if os.getppid() != parent:
        os._exit(1)


# a worker ignores SIGINT and SIGTERM from its first line on (before the
# slow imports): rank 0 alone stops it
_WORKER = ("import signal, sys; signal.signal(signal.SIGINT, signal.SIG_IGN);"
           " signal.signal(signal.SIGTERM, signal.SIG_IGN); "
           "from {module} import worker_main; "
           "worker_main(sys.argv[1], int(sys.argv[2]))")


def spawn_workers(module: str, spec: dict, size: int, *,
                  cpu: bool, env: Optional[dict] = None) -> list:
    """Start ranks ``1 .. size-1``: each runs ``module.worker_main(
    json.dumps(spec), rank)``.  ``spec["parent"]`` should be this
    process's pid (the workers' :func:`die_with_parent`).  Call it from a
    thread that lives as long as the mesh: on Linux the workers are
    SIGKILLed when the thread that started them ends."""
    pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ if env is None else env)
    if cpu:
        # CPU ranks share the host's cores with rank 0: one thread each
        env["OMP_NUM_THREADS"] = "1"
    env["PYTHONPATH"] = os.pathsep.join(
        [pkg_root] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    code = _WORKER.format(module=module)
    return [subprocess.Popen([sys.executable, "-c", code, json.dumps(spec),
                              str(r)], env=env)
            for r in range(1, size)]
