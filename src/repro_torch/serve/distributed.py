"""Tensor-parallel serving over a ``(data, model)`` mesh of processes.

The port of the JAX package's ``serve/distributed.py``.  JAX serves one
program over a device mesh and GSPMD places the collectives; here every
rank of the mesh is a process with its own device, and the collectives are
placed by hand.

**One controller.**  Rank 0 owns the :class:`~repro_torch.serve.engine.Engine`,
its scheduler, the pool's host bookkeeping, faults, tracing and the clock.
The other ranks hold only device state.  Every device step — a dispatch
(``decode_paged``, ``decode_paged_sample``, ``prefill_paged``,
``verify_paged``, the gather-dense ``__call__``, ``activation_probe``),
and the pool's page copies, gathers and gather-dense writes — is
broadcast to the workers as a small command (a module function and its
host arrays) and run on every rank.  Logits and selections are
replicated; rank 0 returns them and the workers compute none.

**What shards over the model axis** (:data:`PACKED_AXES`, resolved by the
rules of ``runtime/sharding.py`` with their divisibility fallback):

  * packed codes — column-parallel for ``attn.wq/wk/wv`` and
    ``mlp.wi/wg`` (the ``(packed_rows(n), m)`` words split on ``m``),
    row-parallel for ``attn.wo`` and ``mlp.wo`` (split on the packed
    rows).  ``s``, ``D`` and the transform factors replicate.  The
    incoherence transforms mix the sharded dim, so a column-parallel
    linear runs ``h = V D⁻¹ x`` whole, ``quant_matmul`` on its local codes,
    an all-gather, then ``Uᵀ`` whole; a row-parallel one runs ``V D⁻¹``
    on the whole input, ``quant_matmul`` on its K-slice of it, a sum over
    the model axis, then ``Uᵀ``.  The epilogue's ``−s·Σ_k x`` is linear in
    the K-slice, so the per-rank epilogues sum to the whole one; the pad
    columns of the last rank's words are zero codes against no input;
  * the KV page pool (:data:`POOL_AXES`) — on KV heads, never on pages: a
    rank holds every page for its heads, so block tables resolve locally
    and attention moves no KV bytes between ranks.  Each rank attends its
    query-head group against its KV heads through the same kernels, and
    the attention outputs are all-gathered before ``attn.wo``.  Where the
    KV-head count does not divide the axis the pool replicates and every
    rank attends every head (``_pool_sharded`` is then false).

Sums over the model axis gather every rank's partial and add them in rank
order, so every rank holds the same bits and a run does not depend on
the backend's reduction order.

**Backend.**  One rank per card: NCCL.  Ranks sharing a card (NCCL
refuses two ranks on one device) or on the CPU: gloo, whose collectives on
CUDA tensors are staged through host memory here, explicitly, as the mesh
logs.  Nothing falls back from one to the other.  Commands travel on a
gloo group of all ranks.  Rendezvous is a ``FileStore`` in a temporary
directory.  A worker that fails prints its traceback and exits nonzero;
rank 0 then fails in the next collective or command (its peer is gone)
and kills the rest.  The process groups, the communicator, the layout and
the worker spawn are ``runtime/process_group.py``'s, shared with training.

**Lifetime.**  Rank 0 alone decides when the workers stop: by
:meth:`ServingMesh.close` or :meth:`ServingMesh.abort`.  Workers ignore
SIGINT and SIGTERM (a Ctrl-C reaches the whole foreground group; rank 0's
drain then stops them), and on Linux they die with rank 0: each asks the
kernel for SIGKILL when its parent goes (``PR_SET_PDEATHSIG``), so a
SIGKILLed controller leaves no worker on a card, whatever the worker was
waiting on.  Commands come from one thread: the first to call
:meth:`ServingMesh.call`, or one that takes the mesh over with
:meth:`ServingMesh.adopt` (a front door's engine thread);
:meth:`ServingMesh.broken_reason` polls the workers from any thread
without sending a command.  Every rank logs its newest commands (kind,
sent or received, acked) to a :class:`CommandLog` file, which
:meth:`ServingMesh.command_log` reads from any thread while a rank is
stuck.

    mesh = make_serving_mesh(1, 2, device="cpu")
    dec = DistributedCachedDecoder.from_quantized(qm, mesh=mesh)
    engine = Engine(dec, EngineConfig(...))   # on rank 0, as ever
    ...
    mesh.close()
"""
from __future__ import annotations

import atexit
import dataclasses
import json
import os
import pickle
import shutil
import sys
import tempfile
import threading
import time
import traceback
import weakref
from collections import deque
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.core import packing
from repro_torch.core import incoherence as inc
from repro_torch.core.quantizer import QuantizedLinear
from repro_torch.device import DEFAULT_DEVICE
from repro_torch.models import layers as L
from repro_torch.runtime.process_group import (
    Communicator,
    die_with_parent,
    layout,
    process_group,
    spawn_workers,
)
from repro_torch.runtime.sharding import MeshContext
from repro_torch.serve.adapter import CachedDecoder
from repro_torch.serve.kv_cache import PagedKVPool

__all__ = [
    "DistributedCachedDecoder",
    "MeshThreadError",
    "CommandLog",
    "ServingMesh",
    "make_serving_mesh",
    "shard_quantized_linear",
    "shard_quantized_model",
    "artifact_placer",
    "apply_sharded_linear",
    "pool_tensors",
    "rank_launch_counts",
    "reset_rank_counts",
    "rank_weight_bytes",
    "PACKED_AXES",
    "POOL_AXES",
]

# Logical axes of each QuantizedLinear's packed codes, shaped
# (packed_rows(n), m): axis 0 walks the packed reduction rows (the layer's
# input dim), axis 1 the output features.
PACKED_AXES: dict[str, tuple] = {
    "attn.wq": (None, "heads"),
    "attn.wk": (None, "kv_heads"),
    "attn.wv": (None, "kv_heads"),
    "attn.wo": ("heads", None),
    "mlp.wi": (None, "ff"),
    "mlp.wg": (None, "ff"),
    "mlp.wo": ("ff", None),
}

# Physical page pool (L, P, ps, KV, hd): shard KV heads, never pages.
POOL_AXES: tuple = ("layers", "pages", None, "kv_heads", None)

# seconds a collective inside a dispatch may wait for its peers; the
# command channel waits far longer (rank 0 may sit idle between requests)
COLLECTIVE_TIMEOUT_S = 600
COMMAND_TIMEOUT_S = 24 * 3600
# commands each rank's log keeps (the newest)
COMMAND_LOG_SLOTS = 256



class _Channel:
    """Pickled commands from rank 0 to every rank (gloo, host memory)."""

    def __init__(self, pg):
        import torch.distributed as dist

        self.pg = pg
        self.opts = dist.BroadcastOptions()
        self.opts.rootRank = 0

    def _bcast(self, t: torch.Tensor) -> None:
        self.pg.broadcast([t], self.opts).wait()

    def send(self, obj) -> None:
        payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
        self._bcast(torch.tensor([len(payload)], dtype=torch.int64))
        self._bcast(torch.frombuffer(bytearray(payload), dtype=torch.uint8))

    def recv(self):
        n = torch.zeros(1, dtype=torch.int64)
        self._bcast(n)
        data = torch.empty(int(n), dtype=torch.uint8)
        self._bcast(data)
        return pickle.loads(data.numpy().tobytes())


class CommandLog:
    """The newest ``COMMAND_LOG_SLOTS`` mesh commands one rank saw, in a
    small file beside the mesh's rendezvous store (a ring the rank writes
    and any process reads, so that rank 0 can show where every rank waits
    while one of them is stuck in a collective).  Per command: its number,
    its kind (the command function's name), when it was sent (rank 0) or
    received (a worker), and when that rank was done with it (its ack;
    NaN while pending), on the host's wall clock."""

    DTYPE = np.dtype([("seq", "<i8"), ("kind", "S40"), ("sent", "<f8"),
                      ("done", "<f8")])

    def __init__(self, prefix: str, rank: int,
                 slots: int = COMMAND_LOG_SLOTS):
        self.prefix, self.rank, self.seq = prefix, rank, 0
        self.ring = np.memmap(f"{prefix}.{rank}", dtype=self.DTYPE,
                              mode="w+", shape=(slots,))
        self.ring["seq"] = -1

    def start(self, kind: str) -> int:
        i = self.seq % len(self.ring)
        self.ring[i] = (self.seq, kind.encode()[:40], time.time(), np.nan)
        self.seq += 1
        return i

    def done(self, i: int) -> None:
        self.ring["done"][i] = time.time()

    @classmethod
    def read(cls, prefix: str, rank: int) -> list:
        """Rank ``rank``'s entries, oldest first (empty if it has none)."""
        try:
            ring = np.fromfile(f"{prefix}.{rank}", dtype=cls.DTYPE)
        except OSError:
            return []
        return sorted((e for e in ring.tolist() if e[0] >= 0),
                      key=lambda e: e[0])

    @classmethod
    def dump(cls, prefix: str, ranks: int, last: int = 12) -> str:
        """Every rank's newest ``last`` commands, times in seconds before
        now."""
        now = time.time()
        lines = [f"mesh command log (last {last} a rank, seconds before "
                 f"now):"]
        for r in range(ranks):
            for seq, kind, sent, done in cls.read(prefix, r)[-last:]:
                ack = "pending" if np.isnan(done) else f"-{now - done:.3f}"
                lines.append(f"  rank {r} #{seq} {kind.decode()}: sent "
                             f"-{now - sent:.3f}, ack {ack}")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------

_OPEN_MESHES: "weakref.WeakSet" = weakref.WeakSet()


@atexit.register
def _close_open_meshes() -> None:
    for mesh in list(_OPEN_MESHES):
        mesh.close()


class MeshThreadError(RuntimeError):
    """A mesh command from a thread other than the one that sends them:
    two threads' broadcasts would interleave on the command channel."""


@dataclasses.dataclass(eq=False)
class ServingMesh(MeshContext):
    """A live ``(data, model)`` mesh, as one of its ranks sees it.

    On rank 0 (the controller) :meth:`call` runs a command on every rank;
    on a worker :meth:`serve` runs the commands it receives until told to
    stop.  ``objects`` maps the ids rank 0 hands out to this rank's
    decoders and pools; ``stash`` carries a gather-dense context and its new
    K/V between the commands that use them."""

    backend: str = "gloo"
    staged: bool = False
    channel: Any = None
    objects: dict = dataclasses.field(default_factory=dict)
    stash: dict = dataclasses.field(default_factory=dict)
    procs: list = dataclasses.field(default_factory=list)
    workdir: Optional[str] = None
    _next_id: int = 0
    _drops: deque = dataclasses.field(default_factory=deque)
    _broken: Optional[str] = None
    _closed: bool = False
    _owner: Optional[int] = None  # ident of the thread that sends commands
    cmdlog: Optional[CommandLog] = None

    __hash__ = object.__hash__  # one mesh is one live set of processes

    def describe(self) -> str:
        stage = ("; collectives on CUDA tensors staged through host memory"
                 if self.staged else "")
        return (f"mesh data={self.dp} model={self.mp}: {self.size} ranks on "
                f"{self.device}, backend {self.backend}{stage}")

    # ---- controller --------------------------------------------------

    def new_id(self) -> int:
        self._next_id += 1
        return self._next_id

    def drop_later(self, oid: int) -> None:
        """Forget object ``oid`` on every rank with the next command (safe
        from a finalizer on any thread: sends nothing itself)."""
        self._drops.append(oid)

    def adopt(self) -> None:
        """Make the calling thread the one that sends this mesh's commands
        (a front door's engine thread takes over from the thread that
        built the engine).  No command may be in flight."""
        self._owner = threading.get_ident()

    def release(self) -> None:
        """Let the next thread to :meth:`call` take the mesh over (the
        engine thread that adopted it has ended)."""
        self._owner = None

    def _dead_rank(self, grace: float = 0.0) -> Optional[str]:
        """The first worker that has exited, waiting up to ``grace``
        seconds for one to show: a send or a collective fails moments
        after a peer dies, and meanwhile another thread's ``wait`` on that
        process may hold its exit status (``poll`` then answers None)."""
        deadline = time.monotonic() + grace
        while True:
            for r, p in enumerate(self.procs, start=1):
                rc = p.poll()
                if rc is not None:
                    return f"rank {r} exited with code {rc}"
            if time.monotonic() >= deadline:
                return None
            time.sleep(0.02)

    def broken_reason(self) -> Optional[str]:
        """Why this mesh can serve no more, or None: broken, closed, or a
        worker gone.  Host only — it polls the worker processes and sends
        nothing — so any thread may ask (a front door's ``/healthz``)."""
        if self._broken:
            return self._broken
        if self._closed:
            return "closed"
        return self._dead_rank()

    def _check(self) -> None:
        if self._broken:
            raise RuntimeError(f"serving mesh is broken: {self._broken}")
        if self._closed:
            raise RuntimeError("serving mesh is closed")
        dead = self._dead_rank()
        if dead:
            self.abort(dead)
            raise RuntimeError(f"serving mesh is broken: {self._broken}")

    def _claim(self) -> None:
        me = threading.get_ident()
        if self._owner is None:
            self._owner = me
        elif self._owner != me:
            raise MeshThreadError(
                f"serving mesh commands come from one thread (id "
                f"{self._owner}); thread {threading.current_thread().name!r}"
                f" may not send one")

    def call(self, fn: Callable, *args):
        """Run ``fn(mesh, *args)`` on every rank (``fn`` a module-level
        function, ``args`` picklable host values); returns rank 0's
        result.  Only the mesh's command thread may call (else
        :class:`MeshThreadError`).  A failure after the command went out
        breaks the mesh: the workers are stopped and every later call
        raises."""
        if self.rank != 0:
            raise RuntimeError("only rank 0 sends commands")
        self._claim()
        self._check()
        drops = []
        while self._drops:  # popleft is atomic against drop_later
            drops.append(self._drops.popleft())
        entry = self.cmdlog.start(fn.__name__) if self.cmdlog else None
        try:
            self.channel.send((drops, fn, args))
        except BaseException as e:  # a rank that died is the cause
            self.abort(self._dead_rank(grace=2.0)
                       or f"sending a command failed: {e!r}")
            raise
        try:
            _drop(self, drops)
            out = fn(self, *args)
            if entry is not None:
                self.cmdlog.done(entry)
            return out
        except BaseException as e:
            self.abort(self._dead_rank(grace=2.0)
                       or f"rank 0 failed in {fn.__name__}: {e!r}")
            raise

    def command_log(self, last: int = 12) -> str:
        """Every rank's newest ``last`` commands (:class:`CommandLog`),
        read from their files: safe from any thread, and while a rank is
        stuck.  Empty once the mesh is closed (its directory is gone)."""
        if self.cmdlog is None:
            return ""
        return CommandLog.dump(self.cmdlog.prefix, self.size, last)

    def abort(self, reason: str) -> None:
        """Mark the mesh broken and end every worker."""
        if self._broken is None:
            self._broken = reason
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            p.wait()
        self._cleanup(abort=True)

    def close(self) -> None:
        """Stop the workers and wait for them (rank 0).  Idempotent."""
        if self.rank != 0 or self._closed:
            return
        dead = None if self._broken else self._dead_rank()
        if dead:  # a stop command would go to a rank that is gone
            self.abort(dead)
        if self._broken is None:
            try:
                self.channel.send(([], _cmd_stop, ()))
                for p in self.procs:
                    p.wait(timeout=60)
            except BaseException as e:  # a worker that will not stop
                self.abort(f"close failed: {e!r}")
        self._closed = True
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        self._cleanup()

    def _cleanup(self, abort: bool = False) -> None:
        self.objects.clear()
        self.stash.clear()
        _OPEN_MESHES.discard(self)
        if self.backend == "nccl" and self.comm.pg is not None:
            # an NCCL group left to the interpreter's exit holds it for
            # minutes (its watchdog threads); end it while its store exists
            pg, self.comm.pg = self.comm.pg, None
            if abort:
                pg.abort()
            else:  # `shutdown` in recent torch, `_shutdown` before it
                (getattr(pg, "shutdown", None) or pg._shutdown)()
        if self.workdir:
            shutil.rmtree(self.workdir, ignore_errors=True)
            self.workdir = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ---- worker ------------------------------------------------------

    def serve(self) -> None:
        while True:
            drops, fn, args = self.channel.recv()
            entry = self.cmdlog.start(fn.__name__) if self.cmdlog else None
            _drop(self, drops)
            if fn is _cmd_stop:
                return
            fn(self, *args)
            if entry is not None:
                self.cmdlog.done(entry)


def _drop(mesh: ServingMesh, oids) -> None:
    for oid in oids:
        mesh.objects.pop(oid, None)


def _cmd_stop(mesh: ServingMesh) -> None:
    pass


def _connect(spec: dict, rank: int) -> ServingMesh:
    """Join the mesh ``spec`` describes as ``rank``."""
    import torch.distributed as dist

    dp, mp = spec["dp"], spec["mp"]
    device = torch.device(spec["devices"][rank])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    store = dist.FileStore(spec["store"], dp * mp)
    control = process_group(dist.PrefixStore("control", store), rank,
                             dp * mp, "gloo", COMMAND_TIMEOUT_S)
    mesh = ServingMesh(dp=dp, mp=mp, rank=rank, device=device,
                       backend=spec["backend"], staged=spec["staged"],
                       channel=_Channel(control),
                       cmdlog=CommandLog(spec["cmdlog"], rank))
    if rank == 0:
        # the caller owns rank 0's decoders and pools: when it drops one,
        # its finalizer tells the workers to drop theirs
        mesh.objects = weakref.WeakValueDictionary()
    pg = None
    if mp > 1:
        row = rank // mp
        pg = process_group(dist.PrefixStore(f"model{row}", store), rank % mp,
                            mp, spec["backend"], COLLECTIVE_TIMEOUT_S)
    mesh.comm = Communicator(pg, mp, device, spec["staged"],
                             rank % mp)
    return mesh


def worker_main(spec_json: str, rank: int) -> None:
    """Entry point of a worker rank (started by :func:`make_serving_mesh`
    through ``spawn_workers``, which has SIGINT and SIGTERM ignored
    already)."""
    try:
        spec = json.loads(spec_json)
        die_with_parent(spec["parent"])
        mesh = _connect(spec, rank)
        mesh.serve()
    except BaseException:
        print(f"[mesh] rank {rank} failed:", file=sys.stderr, flush=True)
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)
    sys.stdout.flush()
    os._exit(0)


def make_serving_mesh(dp: int, mp: int, *,
                      device=DEFAULT_DEVICE) -> ServingMesh:
    """Start a ``(dp, mp)`` serving mesh: this process becomes rank 0 and
    starts ``dp·mp − 1`` worker processes (``python -c``, the same
    interpreter, this package on their path).  Ranks go one per card with
    NCCL when there are enough cards, else share cards (at most
    ``process_group.MAX_RANKS_PER_CARD`` each) with gloo; on the CPU, gloo.  Raises
    ``ValueError`` for a mesh the devices cannot hold.

    Call it from a thread that lives as long as the mesh (the main
    thread of a CLI, a test's own): on Linux the workers are SIGKILLed
    when the thread that started them ends, so that they die with rank 0
    however it dies."""
    if dp < 1 or mp < 1:
        raise ValueError(f"mesh {dp}x{mp} needs at least one rank on each "
                         f"axis")
    devices, backend, staged = layout(dp, mp, device)
    workdir = tempfile.mkdtemp(prefix="repro_torch_mesh_")
    spec = {"dp": dp, "mp": mp, "devices": devices, "backend": backend,
            "staged": staged, "store": os.path.join(workdir, "store"),
            "cmdlog": os.path.join(workdir, "cmdlog"),
            "parent": os.getpid()}
    procs = spawn_workers("repro_torch.serve.distributed", spec, dp * mp,
                          cpu=devices[0] == "cpu")
    try:
        mesh = _connect(spec, 0)
    except BaseException:
        for p in procs:
            p.kill()
            p.wait()
        shutil.rmtree(workdir, ignore_errors=True)
        raise
    mesh.procs, mesh.workdir = procs, workdir
    _OPEN_MESHES.add(mesh)
    return mesh


# ---------------------------------------------------------------------------
# sharded layers
# ---------------------------------------------------------------------------


def _transform_to(t: inc.OrthogonalTransform, device) -> inc.OrthogonalTransform:
    mv = lambda x: None if x is None else x.to(device)
    return inc.OrthogonalTransform(t.kind, t.n, mv(t.A), mv(t.B),
                                   mv(t.signs), mv(t.perm), mv(t.inv_perm))


def _linear_to(layer: QuantizedLinear, device) -> QuantizedLinear:
    """A new QuantizedLinear with every tensor on ``device`` (the input is
    untouched)."""
    st = layer.state
    state = inc.PreprocessState(
        U=_transform_to(st.U, device), V=_transform_to(st.V, device),
        D=None if st.D is None else st.D.to(device), s=st.s.to(device),
        maxq=st.maxq)
    return QuantizedLinear(layer.packed.to(device), layer.bits, layer.m,
                           layer.n, state, use_kernel=layer.use_kernel)


class ShardedLinear:
    """One rank's part of a :class:`QuantizedLinear`.

    ``mode`` "col": the codes of output columns ``[lo, hi)``; "row": the
    packed rows covering input columns ``[lo, hi)``; ``None``: every code
    (the divisibility fallback).  :meth:`local` is the work before the
    model-axis collective, :meth:`finish` the work after it."""

    def __init__(self, layer: QuantizedLinear, mode: Optional[str], lo: int,
                 hi: int, packed: torch.Tensor, device):
        self.mode, self.lo, self.hi = mode, lo, hi
        self.bits, self.m, self.n = layer.bits, layer.m, layer.n
        self.maxq, self.use_kernel = layer.maxq, layer.use_kernel
        self.s = layer.s.to(device)
        self.D = None if layer.D is None else layer.D.to(device)
        self.U = _transform_to(layer.transform("U"), device)
        self.V = _transform_to(layer.transform("V"), device)
        self.packed = packed.contiguous().to(device)
        self._promotes = not (layer.D is None and self.U.kind == "none"
                              and self.V.kind == "none")

    def out_dtype(self, dtype: torch.dtype) -> torch.dtype:
        return (torch.promote_types(dtype, torch.float32) if self._promotes
                else dtype)

    def _matmul(self, h: torch.Tensor, k: int, kernel: bool) -> torch.Tensor:
        if kernel or self.use_kernel:
            from repro_torch.kernels.quant_matmul import ops as qmm

            return qmm.quant_matmul(h, self.packed, self.bits, k, self.s,
                                    self.maxq)
        Wq = packing.unpack(self.packed, self.bits, k)
        Wd = inc.from_grid(Wq.to(h.dtype), self.s.to(h.dtype), self.maxq)
        return h @ Wd.T

    def local(self, x: torch.Tensor, kernel: bool) -> torch.Tensor:
        h = inc.apply_transform(self.V, x.to(torch.float32),
                                scale=self.D)  # V D^-1 x, whole
        if self.mode == "row":
            h = h[..., self.lo:self.hi].contiguous()
            return self._matmul(h, self.hi - self.lo, kernel)
        z = self._matmul(h, self.n, kernel)
        if self.mode is None:
            return self.finish(z, x.dtype)
        return z

    def finish(self, z: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        y = inc.apply_transform(self.U, z, inverse=True)
        return y.to(self.out_dtype(dtype))


class ShardedDense:
    """One rank's part of an fp linear (``(in, out)`` weight, optional
    bias): "col" keeps output columns ``[lo, hi)`` and their bias, "row"
    input rows ``[lo, hi)`` (its partial products are fp32; the bias is
    added once, after the sum)."""

    def __init__(self, w, b, mode: Optional[str], lo: int, hi: int, device):
        self.mode, self.lo, self.hi = mode, lo, hi
        if mode == "col":
            w, b = w[:, lo:hi], None if b is None else b[lo:hi]
        elif mode == "row":
            w = w[lo:hi]
        self.w = w.contiguous().to(device)
        self.b = None if b is None else b.to(device)

    def local(self, x: torch.Tensor, kernel: bool) -> torch.Tensor:
        if self.mode == "row":
            xs = x[..., self.lo:self.hi].to(torch.float32)
            return xs @ self.w.to(torch.float32)
        y = L.apply_w(self.w, x)
        return y if self.b is None else y + self.b

    def finish(self, z: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        if self.mode != "row":
            return z
        z = z.to(torch.promote_types(dtype, self.w.dtype))
        return z if self.b is None else z + self.b


def shard_quantized_linear(layer: QuantizedLinear, ctx: MeshContext,
                           name: str) -> ShardedLinear:
    """This rank's part of ``layer`` placed as :data:`PACKED_AXES` says,
    the packed words sliced where they lie (the host, for a loaded
    artifact) before they reach ``ctx.device``.  A dim the mesh does not
    divide stays whole (the divisibility fallback), per array."""
    rows = layer.packed.shape[0]
    spec = ctx.pspec(PACKED_AXES[name], tuple(layer.packed.shape))
    if spec[1] is not None:
        lo, hi = ctx.local_range(layer.m, spec[1])
        return ShardedLinear(layer, "col", lo, hi, layer.packed[:, lo:hi],
                             ctx.device)
    if spec[0] is not None:
        r0, r1 = ctx.local_range(rows, spec[0])
        vals = packing.vals_per_word(layer.bits)
        return ShardedLinear(layer, "row", r0 * vals,
                             min(r1 * vals, layer.n), layer.packed[r0:r1],
                             ctx.device)
    return ShardedLinear(layer, None, 0, layer.n, layer.packed, ctx.device)


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


def shard_quantized_model(qm, ctx: MeshContext):
    """This rank's part of a ``QuantizedModel``: each QuantizedLinear as
    its :class:`ShardedLinear`, everything else (embedding, norms) on
    ``ctx.device``.  Returns a new model; the input is untouched."""
    blocks = []
    for blk in qm.blocks:
        blocks.append({
            name: (shard_quantized_linear(val, ctx, name)
                   if isinstance(val, QuantizedLinear)
                   else _to_device(val, ctx.device))
            for name, val in blk.items()})
    return dataclasses.replace(
        qm, embed=_to_device(qm.embed, ctx.device),
        final_norm=_to_device(qm.final_norm, ctx.device), blocks=blocks)


def artifact_placer(ctx: MeshContext):
    """A ``placer`` for ``artifacts.load_quantized``: packed codes stay in
    host memory (:func:`shard_quantized_linear` slices them there, so the
    whole codes never reach the card), every other leaf goes to
    ``ctx.device``."""

    def place(key: str, t: torch.Tensor) -> torch.Tensor:
        parts = key.split("/")
        if (len(parts) == 4 and parts[0] == "blocks"
                and parts[3] == "packed" and parts[2] in PACKED_AXES):
            return t
        return t.to(ctx.device)

    return place


def _shard_fp_blocks(cfg, params: dict, ctx: MeshContext) -> list:
    from repro_torch.models.transformer import decoder_axes

    axes = decoder_axes(cfg)["layers"]
    names = [n for n in PACKED_AXES
             if not (n == "mlp.wg" and cfg.mlp != "swiglu")]
    blocks = []
    for lp in params["layers"]:
        blk = {"ln1": _to_device(lp["ln1"], ctx.device),
               "ln2": _to_device(lp["ln2"], ctx.device)}
        for name in names:
            grp, w = name.split(".")
            weight = lp[grp][w]
            spec = ctx.pspec(axes[grp][w], tuple(weight.shape))
            if spec[1] is not None:
                mode = "col"
                lo, hi = ctx.local_range(weight.shape[1], spec[1])
            elif spec[0] is not None:
                mode = "row"
                lo, hi = ctx.local_range(weight.shape[0], spec[0])
            else:
                mode, lo, hi = None, 0, weight.shape[1]
            blk[name] = ShardedDense(weight, lp[grp].get("b" + w[1:]), mode,
                                     lo, hi, ctx.device)
        if cfg.qk_norm:
            blk["q_norm"] = lp["attn"]["q_norm"].to(ctx.device)
            blk["k_norm"] = lp["attn"]["k_norm"].to(ctx.device)
        blocks.append(blk)
    return blocks


def _host_linear(layer: QuantizedLinear) -> QuantizedLinear:
    return layer if layer.packed.device.type == "cpu" else _linear_to(
        layer, "cpu")


def _host_tree(tree):
    if isinstance(tree, QuantizedLinear):
        return _host_linear(tree)
    if isinstance(tree, dict):
        return {k: _host_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_host_tree(v) for v in tree]
    return tree.cpu()


# ---------------------------------------------------------------------------
# commands (run on every rank; rank 0's result is returned)
# ---------------------------------------------------------------------------


def _register(mesh: ServingMesh, oid: int, dec: "DistributedCachedDecoder"):
    dec.oid = oid
    mesh.objects[oid] = dec
    return dec


def _cmd_build_quantized(mesh, oid, qm):
    sq = shard_quantized_model(qm, mesh)
    return _register(mesh, oid, DistributedCachedDecoder(
        cfg=sq.cfg, embed=sq.embed, final_norm=sq.final_norm,
        blocks=sq.blocks, mesh=mesh))


def _cmd_build_model(mesh, oid, cfg, params):
    return _register(mesh, oid, DistributedCachedDecoder(
        cfg=cfg, embed=_to_device(params["embed"], mesh.device),
        final_norm=_to_device(params["final_norm"], mesh.device),
        blocks=_shard_fp_blocks(cfg, params, mesh), mesh=mesh))


def _cmd_build_with(mesh, oid, builder, kwargs):
    return _cmd_build_quantized(mesh, oid,
                                builder(device=mesh.device, **kwargs))


def _cmd_load(mesh, oid, directory, verify):
    from repro_torch.serve.artifacts import load_quantized

    qm, meta = load_quantized(directory, device=mesh.device, verify=verify,
                              placer=artifact_placer(mesh))
    return _cmd_build_quantized(mesh, oid, qm), meta


def _cmd_make_pool(mesh, oid, pid, kw):
    dec = mesh.objects[oid]
    cfg = dec.cfg
    shape = (cfg.n_layers, kw["n_pages"], kw["page_size"], cfg.n_kv_heads,
             cfg.head_dim)
    sharded = mesh.pspec(POOL_AXES, shape)[3] is not None
    cls = _MirroredKVPool if mesh.rank == 0 else PagedKVPool
    pool = cls(dec._local_cfg if sharded else cfg, device=mesh.device,
               kv_shards=mesh.mp if sharded else 1, **kw)
    pool.oid = pid
    pool.mesh = mesh
    dec._pool_sharded = sharded
    mesh.objects[pid] = pool
    return pool


def _cmd_copy_page(mesh, pid, src, dst):
    PagedKVPool._copy_page(mesh.objects[pid], src, dst)


def _cmd_gather(mesh, pid, block_table):
    ctx = PagedKVPool.gather_table(mesh.objects[pid], block_table)
    mesh.stash["ctx"] = ctx
    return ctx


def _cmd_scatter_new(mesh, pid, pages, offs):
    k, v = mesh.stash.pop("new")
    shape = lambda t: t.reshape(t.shape[0], *pages.shape, *t.shape[-2:])
    PagedKVPool.scatter(mesh.objects[pid], pages, offs, shape(k), shape(v))


def _own_heads(mesh, pool, t: torch.Tensor, axis: int) -> torch.Tensor:
    """This rank's slice of the KV-head ``axis`` of a whole-pool tensor."""
    if pool.kv_shards == 1:
        return t
    n = t.shape[axis] // mesh.mp
    return t.narrow(axis, mesh.model_rank * n, n)


def _cmd_scatter_full(mesh, pid, pages, offs, k, v):
    pool = mesh.objects[pid]
    own = lambda t: _own_heads(mesh, pool, t, t.ndim - 2).to(mesh.device)
    PagedKVPool.scatter(pool, pages, offs, own(k), own(v))


def _all_heads(mesh, pool, t: torch.Tensor, axis: int) -> torch.Tensor:
    """The whole KV-head ``axis`` of a pool tensor from every rank's share
    (``axis`` the last dim, or the one before it)."""
    if pool.kv_shards == 1:
        return t
    if axis == t.ndim - 1:
        return mesh.comm.all_gather_cat([t])[0]
    lead, (kv, hd) = t.shape[:-2], t.shape[-2:]
    full = mesh.comm.all_gather_cat([t.reshape(*lead, kv * hd)])[0]
    return full.reshape(*lead, kv * mesh.mp, hd)


def _cmd_pool_tensors(mesh, pid):
    pool = mesh.objects[pid]
    return [_all_heads(mesh, pool, t, 3).cpu() for t in pool._storage()]


def pool_tensors(pool) -> list:
    """The whole pool's ``[k, v]`` (and int8 scales), every KV head,
    gathered from every rank to rank 0's host memory (tests)."""
    return pool.mesh.call(_cmd_pool_tensors, pool.oid)


def _every_rank(mesh, values: list) -> list:
    """Each rank's list of ints, in rank order (on the command group)."""
    t = torch.tensor(values, dtype=torch.int64)
    outs = [torch.empty_like(t) for _ in range(mesh.size)]
    mesh.channel.pg.allgather([outs], [t]).wait()
    return [o.tolist() for o in outs]


def _cmd_reset_counts(mesh):
    from repro_torch.kernels import reset_counts

    reset_counts()


def _cmd_launch_counts(mesh):
    from repro_torch.kernels import launch_counts

    counts = launch_counts()
    names = sorted(counts)
    return [dict(zip(names, row))
            for row in _every_rank(mesh, [counts[n] for n in names])]


def reset_rank_counts(mesh: ServingMesh) -> None:
    """Set every rank's kernel launch counts to 0."""
    mesh.call(_cmd_reset_counts)


def rank_launch_counts(mesh: ServingMesh) -> list:
    """Each rank's kernel launch counts (``kernels.launch_counts``), in
    rank order: every process counts its own launches."""
    return mesh.call(_cmd_launch_counts)


def _cmd_weight_bytes(mesh, oid):
    dec = mesh.objects[oid]
    packed = sum(lin.packed.numel() * lin.packed.element_size()
                 for blk in dec.blocks for lin in blk.values()
                 if isinstance(lin, ShardedLinear))
    return _every_rank(mesh, [packed])


def rank_weight_bytes(dec: "DistributedCachedDecoder") -> list:
    """Bytes of packed codes each rank holds, in rank order."""
    return [row[0] for row in dec.mesh.call(_cmd_weight_bytes, dec.oid)]


def _cmd_step(mesh, oid, name, pid, args, kw):
    return getattr(CachedDecoder, name)(mesh.objects[oid], *args,
                                        mesh.objects[pid], **kw)


def _cmd_dense(mesh, oid, tokens, positions, ctx_len):
    ck, cv = mesh.stash.pop("ctx")
    out = CachedDecoder._dense_step(mesh.objects[oid], tokens, positions, ck,
                                    cv, ctx_len)
    mesh.stash["new"] = out[1:]
    return out


def _cmd_probe(mesh, oid, padded, positions, S):
    return CachedDecoder._probe_step(mesh.objects[oid], padded, positions, S)


def _cmd_project(mesh, oid, layer, name, x, kernel):
    dec = mesh.objects[oid]
    return dec._project(dec.blocks[layer], (name,), x.to(mesh.device),
                        kernel)[0].cpu()


def _cmd_apply_linear(mesh, layer, name, x, kernel):
    lin = shard_quantized_linear(layer, mesh, name)
    z = lin.local(x.to(mesh.device), kernel)
    if lin.mode == "col":
        z = mesh.comm.all_gather_cat([z])[0]
    elif lin.mode == "row":
        z = mesh.comm.all_reduce_sum([z])[0]
    if lin.mode is not None:
        z = lin.finish(z, x.dtype)
    return lin.mode, z.cpu()


def apply_sharded_linear(mesh: ServingMesh, layer: QuantizedLinear, name: str,
                         x: torch.Tensor, *, kernel: bool = False):
    """``layer(x)`` with ``layer`` sharded over ``mesh`` as ``name`` is:
    each rank runs its part and the collectives.  Returns (mode, y on the
    host)."""
    return mesh.call(_cmd_apply_linear, _host_linear(layer), name, x.cpu(),
                     kernel)


class _MirroredKVPool(PagedKVPool):
    """Rank 0's pool: host bookkeeping plus its own share of the pages;
    the device steps the host makes outside a dispatch are replayed on
    every rank."""

    def _copy_page(self, src: int, dst: int) -> None:
        self.mesh.call(_cmd_copy_page, self.oid, src, dst)

    def gather_table(self, block_table):
        return self.mesh.call(_cmd_gather, self.oid, np.asarray(block_table))

    def _write_scatter(self, pages, offs, k_new, v_new) -> None:
        """The K/V of the last gather-dense dispatch stay on the ranks
        that computed them (each writes its own heads); any other values
        (all heads) travel through host memory."""
        new = self.mesh.stash.get("new")
        pages, offs = np.asarray(pages), np.asarray(offs)
        if new is not None and (k_new.untyped_storage().data_ptr()
                                == new[0].untyped_storage().data_ptr()):
            self.mesh.call(_cmd_scatter_new, self.oid, pages, offs)
            return
        if k_new.shape[-2] != self.k.shape[3] * self.kv_shards:
            raise ValueError(
                f"K/V of {k_new.shape[-2]} heads for a pool of "
                f"{self.k.shape[3] * self.kv_shards}")
        self.mesh.call(_cmd_scatter_full, self.oid, pages, offs,
                       k_new.cpu(), v_new.cpu())


# ---------------------------------------------------------------------------
# the decoder
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DistributedCachedDecoder(CachedDecoder):
    """Tensor-parallel :class:`CachedDecoder` over a :class:`ServingMesh`.

    A drop-in for the engine on rank 0; build it with
    :meth:`from_quantized`, :meth:`from_model`, :meth:`from_builder` or
    :meth:`load`, which build every rank's part.  The hooks of the base
    class carry the distribution: :meth:`_project` (collectives around
    sharded projections), :meth:`_local_heads` / :meth:`_gather_heads`
    (attention over this rank's KV heads) and the dispatches' device steps
    (replayed on every rank)."""

    mesh: Optional[ServingMesh] = None
    oid: int = 0
    # set by make_pool once the pool geometry (and so the divisibility
    # fallback) is known: whether the KV-head axis sharded
    _pool_sharded: bool = dataclasses.field(default=False, repr=False)

    def __post_init__(self):
        if self.mesh is None:
            raise ValueError(
                "DistributedCachedDecoder needs a mesh; build via "
                "from_quantized/from_model/from_builder/load(mesh=...)")
        super().__post_init__()
        cfg, mp = self.cfg, self.mesh.mp
        self._want_logits = self.mesh.rank == 0
        self._local_cfg = (
            dataclasses.replace(cfg, n_heads=cfg.n_heads // mp,
                                n_kv_heads=cfg.n_kv_heads // mp)
            if cfg.n_kv_heads % mp == 0 else cfg)

    # ---- constructors ---------------------------------------------------

    @classmethod
    def _build(cls, mesh: ServingMesh, cmd, *args):
        oid = mesh.new_id()
        out = mesh.call(cmd, oid, *args)
        dec = out[0] if isinstance(out, tuple) else out
        weakref.finalize(dec, mesh.drop_later, oid)
        return out

    @classmethod
    def from_quantized(cls, qm, *, mesh: ServingMesh
                       ) -> "DistributedCachedDecoder":
        """From a ``QuantizedModel`` in this process (sent to every rank
        through host memory: a model of test size)."""
        host = dataclasses.replace(
            qm, embed=_host_tree(qm.embed),
            final_norm=_host_tree(qm.final_norm),
            blocks=_host_tree(qm.blocks), stats=[], profile=[])
        return cls._build(mesh, _cmd_build_quantized, host)

    @classmethod
    def from_model(cls, cfg, params: dict, *, mesh: ServingMesh
                   ) -> "DistributedCachedDecoder":
        """From an fp param tree: the linears sharded by
        ``models.transformer.decoder_axes``, the rest replicated."""
        return cls._build(mesh, _cmd_build_model, cfg, _host_tree(params))

    @classmethod
    def from_builder(cls, builder: Callable, *, mesh: ServingMesh,
                     **kwargs) -> "DistributedCachedDecoder":
        """Every rank calls ``builder(device=<its device>, **kwargs)`` (a
        module-level function returning a ``QuantizedModel``, e.g.
        ``serve.synthetic.synthetic_quantized_model``) and keeps its part:
        no weights cross between processes."""
        return cls._build(mesh, _cmd_build_with, builder, kwargs)

    @classmethod
    def load(cls, directory, *, mesh: ServingMesh, verify: bool = True,
             load_faults=None) -> tuple["DistributedCachedDecoder", dict]:
        """Load a port artifact onto the mesh: every rank reads the shards
        into host memory and moves only its slice of the packed codes to
        its device.  Rank 0 checks the shard digests first (``verify``,
        ``load_faults``'s ``corrupt_shard`` rules), so a corrupt artifact
        raises before any worker reads it.  Returns (adapter, meta)."""
        from repro_torch.checkpoint.store import load_arrays

        corrupt = (load_faults.corrupt_shards() if load_faults is not None
                   else ())
        if verify:
            load_arrays(directory, verify=True, _corrupt_shards=corrupt)
        return cls._build(mesh, _cmd_load, str(directory), False)

    def project(self, layer: int, name: str, x: torch.Tensor, *,
                kernel: bool = False) -> torch.Tensor:
        """Projection ``name`` of block ``layer`` on ``x``, every rank
        running its part; the whole output on the host."""
        return self.mesh.call(_cmd_project, self.oid, layer, name, x.cpu(),
                              kernel)

    # ---- engine hooks ---------------------------------------------------

    def trace_tags(self) -> dict:
        return {
            "mesh_data": self.mesh.dp,
            "mesh_model": self.mesh.mp,
            "mesh_devices": self.mesh.size,
            "pool_sharded": bool(self._pool_sharded),
        }

    def make_pool(self, **kw) -> PagedKVPool:
        """The pool with its pages sharded over KV heads on every rank
        (replicated where the KV-head count does not divide the model
        axis); rank 0's copy keeps the host bookkeeping."""
        pid = self.mesh.new_id()
        pool = self.mesh.call(_cmd_make_pool, self.oid, pid, kw)
        weakref.finalize(pool, self.mesh.drop_later, pid)
        return pool

    @property
    def _attn_cfg(self):
        return self._local_cfg if self._pool_sharded else self.cfg

    def _local_heads(self, q, k, v):
        if not self._pool_sharded:
            return q, k, v
        m, mp = self.mesh.model_rank, self.mesh.mp
        h, kv = q.shape[-2] // mp, k.shape[-2] // mp
        return (q[..., m * h:(m + 1) * h, :].contiguous(),
                k[..., m * kv:(m + 1) * kv, :].contiguous(),
                v[..., m * kv:(m + 1) * kv, :].contiguous())

    def _gather_heads(self, o):
        if not self._pool_sharded:
            return o
        lead = o.shape[:-2]
        full = self.mesh.comm.all_gather_cat([o.reshape(*lead, -1)])[0]
        return full.reshape(*lead, self.cfg.n_heads, self.cfg.head_dim)

    def _project(self, blk, names, h, kernel: bool) -> list:
        """Every rank's part of the projections ``names`` of ``h``, one
        all-gather for the column-parallel ones (by dtype) and one sum
        for the row-parallel ones, then each linear's tail."""
        lins = [blk[n] for n in names]
        zs = [lin.local(h, kernel) for lin in lins]
        comm = self.mesh.comm
        cols: dict = {}
        for i, lin in enumerate(lins):
            if lin.mode == "col":
                cols.setdefault(zs[i].dtype, []).append(i)
        for idx in cols.values():
            for i, z in zip(idx, comm.all_gather_cat([zs[i] for i in idx])):
                zs[i] = z
        rows = [i for i, lin in enumerate(lins) if lin.mode == "row"]
        if rows:
            for i, z in zip(rows, comm.all_reduce_sum([zs[i] for i in rows])):
                zs[i] = z
        return [z if lin.mode is None else lin.finish(z, h.dtype)
                for lin, z in zip(lins, zs)]

    # ---- device steps, on every rank -------------------------------------

    def _decode_trunk(self, tokens, positions, block_tables, ctx_len, pages,
                      offs, pool):
        return self.mesh.call(
            _cmd_step, self.oid, "_decode_trunk", pool.oid,
            (tokens, positions, block_tables, ctx_len, pages, offs), {})

    def _prefill_step(self, tokens, positions, block_tables, ctx_len, pages,
                      offs, pool, *, verify: bool):
        return self.mesh.call(
            _cmd_step, self.oid, "_prefill_step", pool.oid,
            (tokens, positions, block_tables, ctx_len, pages, offs),
            {"verify": verify})

    def _dense_step(self, tokens, positions, ctx_k, ctx_v, ctx_len):
        ctx = self.mesh.stash.get("ctx")
        if ctx is None or ctx_k is not ctx[0]:
            raise ValueError(
                "a tensor-parallel gather-dense dispatch reads the context "
                "of the last pool.gather (every rank gathers its own heads)")
        return self.mesh.call(_cmd_dense, self.oid, np.asarray(tokens),
                              np.asarray(positions), np.asarray(ctx_len))

    def _probe_step(self, padded, positions, S: int):
        return self.mesh.call(_cmd_probe, self.oid, padded, positions, S)
