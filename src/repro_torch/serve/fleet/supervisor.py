"""Replica supervision: spawn N data-parallel FrontDoor processes,
watch them, restart them, give up deliberately.

Detection is two-channel, because replicas fail two ways:

- **crash** — the process dies (``kill -9``, OOM, a bug).  The factory's
  liveness poll catches it immediately; in-flight streams surface as
  connection resets the router fails over.
- **wedge** — the process lives and its sockets answer, but the engine
  executor is stuck inside a dispatch.  ``/healthz`` still responds
  (the event loop is fine) and reports ``last_tick_age_s``; past the
  replica's stall threshold it flips to 503 ``wedged`` and the
  supervisor hard-kills and restarts — a drain would hang forever on
  the wedged executor, so SIGKILL is the correct signal here.

Restarts back off exponentially (``backoff_base_s * 2**restarts``,
capped) and a give-up circuit breaker (``max_restarts``) parks a
flapping replica slot in state ``gone`` instead of crash-looping it;
the router routes around ``gone`` slots and the fleet keeps serving on
the survivors.

The :class:`ReplicaFactory` protocol keeps process management swappable:
:class:`ProcessReplicaFactory` runs real ``launch/serve.py --http-port``
subprocesses (the CLI fleet), while tests implement the same four
methods over in-process thread-hosted FrontDoors — the supervisor and
router logic is identical either way.
"""
from __future__ import annotations

import asyncio
import dataclasses
import os
import signal
import socket
import subprocess
import sys
import threading
from typing import Optional

from repro_torch.serve.frontdoor.wire import get_json

__all__ = [
    "FleetReport",
    "ProcessReplicaFactory",
    "ReplicaHandle",
    "Supervisor",
    "free_port",
    "replica_command",
    "replica_env",
]

# the directory that holds the repro_torch package (the checkout's src/)
_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))))


def replica_command(tail) -> list:
    """The argv of one replica process: this interpreter running the
    port's serve CLI with ``tail`` (the factory appends the bind flags)."""
    return [sys.executable, "-m", "repro_torch.launch.serve", *tail]


def replica_env() -> dict:
    """This process's environment with the port's package first on
    ``PYTHONPATH``, so ``python -m repro_torch.launch.serve`` imports this
    checkout's code (and loads its kernels from its ``build/``) wherever
    the parent was started from."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [_PKG_ROOT] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    return env


def free_port(host: str = "127.0.0.1") -> int:
    """An ephemeral port that was free a moment ago (bind-then-release;
    the tiny reuse race is retried by the replica's startup gate)."""
    with socket.socket() as s:
        s.bind((host, 0))
        return s.getsockname()[1]


class ReplicaHandle:
    """One replica slot's live state — shared between the supervisor
    (which writes health/process fields) and the router (which reads
    them to route and writes its own load accounting).  Single event
    loop: no locking."""

    __slots__ = ("index", "host", "port", "pid", "proc", "state",
                 "generation", "restarts", "consec_fail", "inflight",
                 "served", "routed", "pressure", "last_tick_age_s",
                 "ticks", "last_err", "exit_code", "_restart_task")

    def __init__(self, index: int, host: str):
        self.index = index
        self.host = host
        self.port = 0
        self.pid: Optional[int] = None
        self.proc = None  # factory-owned payload (Popen / FrontDoor)
        self.state = "starting"  # starting|healthy|suspect|wedged|dead
        #   |restarting|gone|drained
        self.generation = 0  # bumped per (re)spawn
        self.restarts = 0
        self.consec_fail = 0  # consecutive failed probes
        self.inflight = 0  # router-side: open proxied requests
        self.served = 0  # router-side: streams completed here
        self.routed = 0  # router-side: requests assigned here
        self.pressure = 0.0  # from /healthz (ladder: queue+pool max)
        self.last_tick_age_s: Optional[float] = None
        self.ticks = 0
        self.last_err: Optional[str] = None
        self.exit_code: Optional[int] = None  # final incarnation's
        self._restart_task: Optional[asyncio.Task] = None

    @property
    def available(self) -> bool:
        return self.state == "healthy"

    def to_dict(self) -> dict:
        return {
            "index": self.index, "port": self.port, "pid": self.pid,
            "state": self.state, "generation": self.generation,
            "restarts": self.restarts, "inflight": self.inflight,
            "served": self.served, "routed": self.routed,
            "pressure": self.pressure,
            "last_tick_age_s": self.last_tick_age_s,
            "ticks": self.ticks, "exit_code": self.exit_code,
        }


class ProcessReplicaFactory:
    """Spawn replicas as real ``launch/serve.py`` subprocesses.

    ``base_argv`` is the full replica command line EXCLUDING the bind
    flags (the factory appends ``--http-port``/``--http-host`` per
    spawn); :func:`replica_command` builds the port's.  The children
    run in :func:`replica_env`.  ``first_spawn_args`` maps replica index
    → extra argv for generation 0 only — per-replica chaos plans
    (``--replica-fault``)
    must not re-arm on the respawned process, or a ``replica_kill``
    would kill every incarnation and trip the circuit breaker by
    design."""

    def __init__(self, base_argv: list, *, host: str = "127.0.0.1",
                 first_spawn_args: Optional[dict] = None,
                 echo: bool = True):
        self.base_argv = list(base_argv)
        self.host = host
        self.first_spawn_args = dict(first_spawn_args or {})
        self.echo = echo

    def _pump(self, handle: ReplicaHandle, pipe) -> None:
        tag = f"[replica {handle.index}]"
        for line in iter(pipe.readline, b""):
            if self.echo:
                print(f"{tag} {line.decode(errors='replace').rstrip()}",
                      flush=True)
        pipe.close()

    def spawn(self, handle: ReplicaHandle) -> None:
        handle.port = free_port(self.host)
        argv = [*self.base_argv, "--http-host", self.host,
                "--http-port", str(handle.port)]
        if handle.generation == 0:
            argv += self.first_spawn_args.get(handle.index, [])
        proc = subprocess.Popen(
            argv, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            env=replica_env(),
        )
        handle.proc = proc
        handle.pid = proc.pid
        handle.generation += 1
        # drain the pipe on a daemon thread (prefix-echoed) so a chatty
        # replica never blocks on a full pipe buffer
        threading.Thread(
            target=self._pump, args=(handle, proc.stdout), daemon=True
        ).start()

    def alive(self, handle: ReplicaHandle) -> bool:
        return handle.proc is not None and handle.proc.poll() is None

    def kill(self, handle: ReplicaHandle) -> None:
        """Hard stop (SIGKILL) — the wedged-replica path, where SIGTERM
        would wait on an executor that never comes back."""
        if handle.proc is not None and handle.proc.poll() is None:
            handle.proc.kill()
            handle.proc.wait()

    def drain(self, handle: ReplicaHandle,
              timeout_s: float) -> Optional[int]:
        """Graceful stop: SIGTERM (the replica's own drain path — leak
        gate, summary lines, exit code), SIGKILL past the budget.
        Returns the exit code, or None when no process was live."""
        proc = handle.proc
        if proc is None or proc.poll() is not None:
            # already dead before the drain started: no drain ran, so
            # there is no leak gate to read — the crash exit code (e.g.
            # -9) is the FAILURE's code, not a gate verdict
            return None
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        return proc.returncode


@dataclasses.dataclass
class FleetReport:
    """What a fleet drain did — the router CLI's exit value.  ``clean``
    aggregates the per-replica leak gates: every replica that was ALIVE
    at drain time must have drained to exit code 0 (a slot whose
    process was already dead or still in restart backoff has no pages
    to leak — the machine is gone)."""

    reason: str
    duration_s: float
    routed: int
    completed: int
    failed: int
    failovers: int
    aborted_streams: int
    replicas: list

    @property
    def clean(self) -> bool:
        return all(r["exit_code"] in (0, None) for r in self.replicas)

    @property
    def exit_code(self) -> int:
        return 0 if self.clean else 1

    def lines(self) -> list:
        out = [
            f"fleet drain[{self.reason}] finished in "
            f"{self.duration_s:.3f}s: {self.completed} completed, "
            f"{self.failed} failed, {self.aborted_streams} aborted",
            f"routed {self.routed} requests, {self.failovers} "
            f"failover(s)",
        ]
        for r in self.replicas:
            out.append(
                f"replica {r['index']}: state={r['state']} "
                f"served={r['served']} restarts={r['restarts']} "
                f"exit={r['exit_code']}")
        out.append("fleet leak gates: " + (
            "clean on every drained replica" if self.clean else "FAILED"))
        return out


class Supervisor:
    """Owns the replica slots: spawn, probe, restart, drain."""

    def __init__(self, factory, n: int, *, host: str = "127.0.0.1",
                 probe_interval_s: float = 0.5,
                 probe_timeout_s: float = 2.0,
                 fail_threshold: int = 3,
                 start_timeout_s: float = 180.0,
                 max_restarts: int = 3,
                 backoff_base_s: float = 0.5,
                 backoff_max_s: float = 10.0,
                 replica_drain_timeout_s: float = 30.0):
        if n < 1:
            raise ValueError(f"fleet needs >= 1 replica, got {n}")
        if max_restarts < 0:
            raise ValueError(f"max_restarts must be >= 0, got {max_restarts}")
        self.factory = factory
        self.host = host
        self.probe_interval_s = probe_interval_s
        self.probe_timeout_s = probe_timeout_s
        self.fail_threshold = fail_threshold
        self.start_timeout_s = start_timeout_s
        self.max_restarts = max_restarts
        self.backoff_base_s = backoff_base_s
        self.backoff_max_s = backoff_max_s
        self.replica_drain_timeout_s = replica_drain_timeout_s
        self.handles = [ReplicaHandle(i, host) for i in range(n)]
        self._draining = False

    # ---- lifecycle -------------------------------------------------------

    async def start(self) -> None:
        """Spawn every replica and wait until each answers /healthz."""
        for h in self.handles:
            self.factory.spawn(h)
        results = await asyncio.gather(
            *(self._wait_ready(h) for h in self.handles))
        if not any(results):
            raise RuntimeError("no replica became healthy at fleet start")

    async def _wait_ready(self, handle: ReplicaHandle) -> bool:
        loop = asyncio.get_running_loop()
        deadline = loop.time() + self.start_timeout_s
        while loop.time() < deadline:
            if self.factory.alive(handle) is False:
                handle.state = "dead"
                handle.last_err = "died during startup"
                return False
            try:
                status, payload = await get_json(
                    handle.host, handle.port, "/healthz",
                    timeout=self.probe_timeout_s)
            except (ConnectionError, OSError, asyncio.TimeoutError):
                await asyncio.sleep(0.1)
                continue
            if status == 200:
                self._mark_healthy(handle, payload)
                return True
            await asyncio.sleep(0.1)
        handle.state = "dead"
        handle.last_err = f"not ready within {self.start_timeout_s}s"
        return False

    def _mark_healthy(self, handle: ReplicaHandle, payload) -> None:
        handle.state = "healthy"
        handle.consec_fail = 0
        handle.last_err = None
        if isinstance(payload, dict):
            handle.ticks = int(payload.get("ticks", handle.ticks))
            handle.pressure = float(payload.get("pressure", 0.0) or 0.0)
            handle.last_tick_age_s = payload.get("last_tick_age_s")

    # ---- probing ---------------------------------------------------------

    async def probe_loop(self) -> None:
        """Heartbeat every replica forever (cancelled at drain)."""
        while True:
            await asyncio.gather(
                *(self.probe_once(h) for h in self.handles))
            await asyncio.sleep(self.probe_interval_s)

    async def probe_once(self, handle: ReplicaHandle) -> None:
        if handle.state in ("restarting", "gone", "drained") \
                or self._draining:
            return
        if self.factory.alive(handle) is False:
            handle.last_err = "process died"
            self._fail(handle, "dead")
            return
        try:
            status, payload = await get_json(
                handle.host, handle.port, "/healthz",
                timeout=self.probe_timeout_s)
        except (ConnectionError, OSError, asyncio.TimeoutError) as e:
            handle.consec_fail += 1
            handle.last_err = f"probe failed: {e!r}"
            if handle.consec_fail >= self.fail_threshold:
                self._fail(handle, "dead")
            elif handle.state == "healthy":
                handle.state = "suspect"
            return
        if status == 200:
            self._mark_healthy(handle, payload)
            return
        wedged = isinstance(payload, dict) \
            and payload.get("status") == "wedged"
        if wedged:
            age = payload.get("last_tick_age_s")
            handle.last_err = f"wedged (last_tick_age_s={age})"
            self._fail(handle, "wedged")
        else:
            # e.g. a draining replica's healthz stays 200; any other
            # non-200 counts toward the failure threshold
            handle.consec_fail += 1
            if handle.consec_fail >= self.fail_threshold:
                self._fail(handle, "dead")

    def _fail(self, handle: ReplicaHandle, state: str) -> None:
        """Mark a replica down and kick off its restart (idempotent)."""
        handle.state = state
        if self._draining or handle._restart_task is not None:
            return
        handle._restart_task = asyncio.get_running_loop().create_task(
            self._restart(handle))

    async def _restart(self, handle: ReplicaHandle) -> None:
        try:
            while not self._draining:
                # hard-kill whatever is left: a wedged process ignores
                # graceful signals by construction
                await asyncio.get_running_loop().run_in_executor(
                    None, self.factory.kill, handle)
                if handle.restarts >= self.max_restarts:
                    handle.state = "gone"  # circuit breaker: give up
                    handle.last_err = (
                        f"gave up after {handle.restarts} restarts")
                    return
                backoff = min(
                    self.backoff_max_s,
                    self.backoff_base_s * (2 ** handle.restarts))
                handle.restarts += 1
                handle.state = "restarting"
                await asyncio.sleep(backoff)
                if self._draining:
                    return
                self.factory.spawn(handle)
                if await self._wait_ready(handle):
                    return  # healthy again; probe loop takes over
                # startup failed: loop — the next lap burns another
                # restart budget slot and doubles the backoff
        finally:
            handle._restart_task = None

    # ---- drain -----------------------------------------------------------

    async def drain(self) -> None:
        """Coordinated fleet drain: stop restarts, SIGTERM every live
        replica concurrently, collect per-replica exit codes (the leak
        gates — each replica exits 0 only if its own gate was clean)."""
        self._draining = True
        for h in self.handles:
            if h._restart_task is not None:
                h._restart_task.cancel()
        loop = asyncio.get_running_loop()

        async def _one(h: ReplicaHandle) -> None:
            if h.state in ("healthy", "suspect"):
                code = await loop.run_in_executor(
                    None, self.factory.drain, h,
                    self.replica_drain_timeout_s)
                h.exit_code = code
                if code is not None:
                    h.state = "drained"
            else:
                # no live serving incarnation (crashed, mid-restart,
                # wedged, gone): there is no leak gate to read — a
                # wedged executor would hang a graceful drain forever
                # and a respawn mid-startup holds no pages yet, so reap
                # whatever is left and record None ("machine is gone")
                await loop.run_in_executor(None, self.factory.kill, h)
                h.exit_code = None

        await asyncio.gather(*(_one(h) for h in self.handles))
