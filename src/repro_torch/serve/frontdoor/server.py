"""The front door: an asyncio HTTP/1.1 + SSE server that OWNS the
engine.

Threading model — one engine thread, one event loop:

- Every engine call (submit, cancel, tick, summary, ladder transitions)
  runs on a single-thread executor, so engine internals never see
  concurrency; the event loop only does I/O and bookkeeping.  On the
  card that thread is the only one that touches a tensor: CUDA's current
  device is per thread, so the executor's initializer sets the engine's
  device before its first call, and the kernels launch on that thread's
  current stream (the default one).  Over a tensor-parallel mesh
  (``serve/distributed.py``) that thread also adopts the mesh: every
  command to the other ranks goes from it, and the mesh is released when
  the server stops.  The loop thread reads host counters only
  (``healthz_payload``), and asks the mesh whether a rank is gone without
  sending it anything.
- The tick task drives :meth:`Engine.tick` on that executor and fans
  each :class:`TickResult` out to registered
  :class:`~repro_torch.serve.frontdoor.streaming.TokenStream` objects on the
  loop.  Handlers never poll the engine — they pump their stream.
- Handlers reading request fields (``out_tokens``, ``state``) across
  the thread boundary rely only on GIL-atomic list/attribute reads.

Overload never reaches the tick loop: typed admission rejections map
to 429/413 before a request touches the engine thread's queue, the
degradation ladder trades speculation for capacity under sustained
pressure, and a drain (SIGTERM/SIGINT or :meth:`FrontDoor.
request_drain`) stops admission, finishes or — past
``drain_timeout_s`` — cancels every in-flight lane, and exits through
the KV-pool leak gate.
"""
from __future__ import annotations

import asyncio
import json
import os
import signal
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np

import torch

from repro_torch.serve.engine import Engine
from repro_torch.serve.faults import AdmissionRejected
from repro_torch.serve.frontdoor import drain as drain_mod
from repro_torch.serve.frontdoor.admission import (
    GenerateParams,
    parse_generate_body,
    rejection_response,
)
from repro_torch.serve.frontdoor.drain import DrainReport
from repro_torch.serve.frontdoor.ladder import DegradationLadder, LadderConfig
from repro_torch.serve.frontdoor.streaming import (
    StreamTable,
    sse_event,
    sse_headers,
)
from repro_torch.serve.frontdoor.wire import read_request, write_response

__all__ = ["FrontDoor", "run_server"]

# how long a replica_hang fault wedges the engine thread: effectively
# forever — the process lives until a supervisor hard-kills it
_HANG_S = 86_400.0


def _mesh(engine: Engine):
    """The serving mesh behind ``engine``'s adapter, or None (one device)."""
    return getattr(engine.adapter, "mesh", None)


def _engine_thread_init(engine: Engine):
    """The executor's initializer: make the engine's card current on the
    engine thread (a new thread starts on card 0, whatever the engine's
    index; nothing to do on the CPU), and hand it the engine's mesh, if
    any."""
    device, mesh = engine.pool.device, _mesh(engine)
    index = None
    if device.type == "cuda":
        index = (device.index if device.index is not None
                 else torch.cuda.current_device())

    def init():
        if index is not None:
            torch.cuda.set_device(index)
        if mesh is not None:
            mesh.adopt()

    return init


class FrontDoor:
    """HTTP/SSE server over one engine.

    Endpoints::

        POST /v1/generate   admit + stream (SSE) or buffer a request
        GET  /healthz       liveness (503 once wedged or a mesh rank is gone)
        GET  /readyz        admission readiness (503 while draining)
        GET  /metricsz      engine summary + server/ladder state (JSON)
    """

    def __init__(self, engine: Engine, *, host: str = "127.0.0.1",
                 port: int = 0, drain_timeout_s: float = 5.0,
                 ladder: bool = True,
                 ladder_cfg: Optional[LadderConfig] = None,
                 idle_sleep_s: float = 0.001,
                 stream_idle_timeout_s: float = 120.0,
                 tick_stall_s: float = 10.0):
        self.engine = engine
        self.metrics = engine.metrics
        self.faults = engine.faults
        self.host = host
        self.port = port  # 0 = ephemeral; rebound once the socket exists
        self.drain_timeout_s = drain_timeout_s
        self.idle_sleep_s = idle_sleep_s
        self.stream_idle_timeout_s = stream_idle_timeout_s
        # tick-stall watchdog: past this, /healthz reports 503 "wedged"
        # (a hung dispatch blocks the engine executor — the event loop
        # stays responsive, so health checks see the wedge instead of a
        # silently frozen-but-listening server)
        self.tick_stall_s = tick_stall_s
        self.ladder = (
            DegradationLadder(engine, ladder_cfg) if ladder else None
        )
        self.streams = StreamTable()
        self.report: Optional[DrainReport] = None
        for name in ("http_requests", "http_rejections", "shed_requests",
                     "client_disconnects", "tick_errors", "burst_admitted",
                     "burst_rejected"):
            self.metrics.counter(name)
        # ALL engine access serializes through this one thread, on the
        # engine's card
        self._exec = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="engine",
            initializer=_engine_thread_init(engine),
        )
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._draining = False
        self._drain_reason = "requested"
        self._drain_t0 = 0.0
        self._drain_completed = 0
        self._drain_cancelled = 0
        self._drain_deadline_hit = False
        self._started = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._thread_error: Optional[BaseException] = None

    # ---- engine-thread trampolines --------------------------------------

    async def _call(self, fn, *args):
        return await self._loop.run_in_executor(self._exec, fn, *args)

    def _tick_once(self):
        if self.faults.rules:
            # replica-level chaos fires at the tick boundary, on the
            # engine thread — a kill takes the whole process down mid-
            # stream exactly like SIGKILL, a hang wedges this executor
            # (the watchdog's food), a slow stretches the tick
            self.faults.tick = self.metrics.counter("steps").value
            rule = self.faults.replica_disruption()
            if rule is not None:
                if rule.kind == "replica_kill":
                    os._exit(137)
                time.sleep(_HANG_S if rule.kind == "replica_hang"
                           else rule.ms / 1000.0)
        if self.ladder is not None:
            self.ladder.observe(self.engine.now())
        return self.engine.tick()

    def _submit(self, p: GenerateParams):
        eng = self.engine
        return eng.submit(
            p.prompt, p.max_new, arrival=eng.now(), sampling=p.sampling,
            stop_tokens=p.stop_tokens, deadline_s=p.deadline_s,
            tenant=p.tenant, priority=p.priority,
            resume_tokens=p.resume_tokens,
        )

    def _burst_submit(self):
        # chaos traffic rides in the lowest (sheddable) class so an
        # injected burst pressures admission without outranking real work
        eng = self.engine
        eng.submit(
            np.ones(8, np.int32), 8, arrival=eng.now(), tenant="burst",
            priority=eng.scheduler.shed_priority(),
        )

    # ---- tick loop ------------------------------------------------------

    async def _tick_loop(self) -> None:
        engine = self.engine
        while True:
            if self._draining:
                if engine.idle:
                    return
                if (engine.now() - self._drain_t0 >= self.drain_timeout_s
                        and not self._drain_deadline_hit):
                    victims = await self._call(engine.cancel_all)
                    self._drain_deadline_hit = True
                    engine.tracer.event(
                        "drain_deadline", cancelled=len(victims)
                    )
            elif self.faults.rules:
                for _ in range(self.faults.admission_burst()):
                    try:
                        await self._call(self._burst_submit)
                        self.metrics.inc("burst_admitted")
                    except AdmissionRejected:
                        self.metrics.inc("burst_rejected")
            try:
                res = await self._call(self._tick_once)
            except Exception:  # a tick must never wedge the loop; on the
                # card a failed launch poisons the context, so every later
                # tick fails too: callers gate on tick_errors == 0
                self.metrics.inc("tick_errors")
                await asyncio.sleep(self.idle_sleep_s)
                continue
            self.streams.dispatch(res)
            if self._draining:
                for r in res.finished:
                    if r.finish_reason == "cancelled":
                        self._drain_cancelled += 1
                    else:
                        self._drain_completed += 1
            if not res.worked and not res.finished:
                await asyncio.sleep(self.idle_sleep_s)

    # ---- drain ----------------------------------------------------------

    def request_drain(self, reason: str = "requested") -> None:
        """Flip to draining (idempotent; loop-thread or threadsafe via
        ``call_soon_threadsafe``): admission stops NOW, the tick loop
        finishes in-flight lanes, cancelling stragglers at the
        deadline."""
        if self._draining:
            return
        self._draining = True
        self._drain_reason = reason
        self._drain_t0 = self.engine.now()
        self.engine.tracer.event("drain_begin", reason=reason)

    # ---- server ---------------------------------------------------------

    async def serve_forever(self, *, install_signals: bool = True
                            ) -> DrainReport:
        """Serve until a drain completes; returns the
        :class:`DrainReport` (whose ``exit_code`` the CLI propagates)."""
        self._loop = asyncio.get_running_loop()
        server = await asyncio.start_server(
            self._handle_conn, self.host, self.port
        )
        self.port = server.sockets[0].getsockname()[1]
        print(f"[frontdoor] listening on {self.host}:{self.port}",
              flush=True)
        if install_signals:
            for sig, why in ((signal.SIGTERM, "sigterm"),
                             (signal.SIGINT, "sigint")):
                try:
                    self._loop.add_signal_handler(
                        sig, self.request_drain, why
                    )
                except NotImplementedError:  # pragma: no cover - win32
                    pass
        self._started.set()
        try:
            await self._tick_loop()
            # give in-flight handlers a beat to ship their done events
            t0 = self._loop.time()
            while len(self.streams) and self._loop.time() - t0 < 2.0:
                await asyncio.sleep(0.01)
        finally:
            server.close()
            await server.wait_closed()
            self._exec.shutdown(wait=True)
            mesh = _mesh(self.engine)
            if mesh is not None:  # the engine thread that adopted it ended
                mesh.release()
        self.report = drain_mod.capture(
            self.engine, reason=self._drain_reason, t0=self._drain_t0,
            completed=self._drain_completed,
            cancelled=self._drain_cancelled,
            deadline_hit=self._drain_deadline_hit,
        )
        return self.report

    # ---- thread hosting (tests / in-process clients) --------------------

    def start_in_thread(self) -> "FrontDoor":
        """Run the server loop on a daemon thread; returns once the
        socket is bound (``self.port`` is then real)."""
        self._thread = threading.Thread(
            target=self._thread_main, name="frontdoor", daemon=True
        )
        self._thread.start()
        if not self._started.wait(60):
            raise RuntimeError("front door failed to start")
        if self._thread_error is not None:
            raise self._thread_error
        return self

    def _thread_main(self) -> None:
        try:
            asyncio.run(self.serve_forever(install_signals=False))
        except BaseException as e:  # surfaced by drain_and_join
            self._thread_error = e
        finally:
            self._started.set()

    def drain_and_join(self, reason: str = "requested",
                       timeout: float = 60.0) -> DrainReport:
        """Threadsafe drain + join for a thread-hosted server."""
        self._loop.call_soon_threadsafe(self.request_drain, reason)
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise RuntimeError("front door did not drain in time")
        if self._thread_error is not None:
            raise self._thread_error
        return self.report

    # ---- HTTP -----------------------------------------------------------

    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        try:
            parsed = await asyncio.wait_for(
                self._read_request(reader), timeout=30.0
            )
            if parsed is None:
                return
            method, path, headers, body = parsed
            await self._route(writer, method, path, headers, body)
        except (asyncio.TimeoutError, ConnectionError, OSError):
            pass
        except Exception as e:  # noqa: BLE001 - last-resort 500
            try:
                self._respond(writer, 500, json.dumps(
                    {"error": "internal", "detail": str(e)}
                ).encode())
            except Exception:
                pass
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass

    async def _read_request(self, reader) -> Optional[tuple]:
        return await read_request(reader)

    def _respond(self, writer, status: int, body: bytes, *,
                 content_type: str = "application/json",
                 extra_headers=()) -> None:
        write_response(writer, status, body, content_type=content_type,
                       extra_headers=extra_headers)

    def healthz_payload(self) -> tuple:
        """(status_code, payload) for ``/healthz``.  Liveness PLUS the
        tick-progress watchdog: once ``last_tick_age_s`` exceeds
        ``tick_stall_s`` the engine executor is wedged (a hung dispatch
        never returns control to the tick loop) and the payload flips to
        503 ``wedged`` — the signal a fleet supervisor hard-restarts on,
        and what distinguishes a frozen server from a merely busy one.
        Also carries the load fields the router's balancer reads:
        ``inflight`` (live engine requests) and ``pressure`` (the
        ladder's max of queue fill and pool occupancy).  Over a mesh, a
        rank that is gone answers 503 ``mesh_broken`` with the mesh's
        reason at once, idle or busy: an idle tick sends the mesh
        nothing, so the watchdog would never see it."""
        eng = self.engine
        age = eng.last_tick_age_s()
        wedged = age > self.tick_stall_s
        mesh = _mesh(eng)
        broken = None if mesh is None else mesh.broken_reason()
        status = "mesh_broken" if broken else "wedged" if wedged else "ok"
        payload = {
            "status": status,
            "ticks": self.metrics.counter("steps").value,
            "last_tick_age_s": round(age, 4),
            "inflight": eng.scheduler.pending + len(eng.running),
            "pressure": (round(self.ladder.pressure(), 4)
                         if self.ladder is not None else 0.0),
            "draining": self._draining,
        }
        if broken:
            payload["mesh"] = broken
        return (200 if status == "ok" else 503), payload

    async def _route(self, writer, method, path, headers, body) -> None:
        path = path.split("?", 1)[0]
        if path == "/healthz" and method == "GET":
            status, payload = self.healthz_payload()
            self._respond(writer, status, json.dumps(payload).encode())
        elif path == "/readyz" and method == "GET":
            if self._draining:
                self._respond(writer, 503, json.dumps(
                    {"ready": False, "draining": True}
                ).encode())
            else:
                payload = {"ready": True}
                if self.ladder is not None:
                    payload["ladder_level"] = self.ladder.level
                self._respond(writer, 200, json.dumps(payload).encode())
        elif path == "/metricsz" and method == "GET":
            summary = await self._call(self.engine.summary)
            summary["server"] = {
                "draining": self._draining,
                "open_streams": len(self.streams),
            }
            if self.ladder is not None:
                summary["server"]["ladder_level"] = self.ladder.level
                summary["server"]["ladder_actions"] = self.ladder.actions
                summary["server"]["pressure"] = round(
                    self.ladder.pressure(), 4
                )
            self._respond(
                writer, 200, json.dumps(summary, default=float).encode()
            )
        elif path == "/v1/generate" and method == "POST":
            await self._handle_generate(writer, body)
        elif path in ("/healthz", "/readyz", "/metricsz", "/v1/generate"):
            self._respond(writer, 405, json.dumps(
                {"error": "method_not_allowed"}
            ).encode())
        else:
            self._respond(writer, 404, json.dumps(
                {"error": "not_found"}
            ).encode())
        await writer.drain()

    # ---- generate -------------------------------------------------------

    async def _handle_generate(self, writer, raw: bytes) -> None:
        self.metrics.inc("http_requests")
        if self._draining:
            self._respond(
                writer, 503,
                json.dumps({"error": "draining", "retryable": True}
                           ).encode(),
                extra_headers=[("Retry-After", "1")],
            )
            return
        try:
            p = parse_generate_body(raw)
        except ValueError as e:
            self._respond(writer, 400, json.dumps(
                {"error": "bad_request", "retryable": False,
                 "detail": str(e)}
            ).encode())
            return
        eng = self.engine
        # ladder rung "shed_low": refuse the lowest class at the door
        pri = (p.priority if p.priority is not None
               else eng.scheduler.policy(p.tenant).priority)
        if (self.ladder is not None and self.ladder.shedding
                and pri >= eng.scheduler.shed_priority()):
            self.metrics.inc("shed_requests")
            exc = AdmissionRejected(
                "shed", retryable=True, tenant=p.tenant,
                retry_after_s=self.ladder.cfg.cooloff_s,
            )
            status, hdrs, body = rejection_response(exc)
            self._respond(writer, status, body, extra_headers=hdrs)
            return
        try:
            req = await self._call(self._submit, p)
        except AdmissionRejected as exc:
            self.metrics.inc("http_rejections")
            status, hdrs, body = rejection_response(exc)
            self._respond(writer, status, body, extra_headers=hdrs)
            return
        except ValueError as e:  # e.g. malformed resume_tokens
            self._respond(writer, 400, json.dumps(
                {"error": "bad_request", "retryable": False,
                 "detail": str(e)}
            ).encode())
            return
        # a failover resubmission's resumed prefix was already delivered
        # by the original stream — start the cursor past it
        stream = self.streams.register(req, sent=req.resumed)
        try:
            if p.stream:
                await self._stream_sse(writer, req, stream)
            else:
                await self._respond_buffered(writer, req, stream)
        except (ConnectionError, OSError, asyncio.TimeoutError):
            # client went away (or the stream idled out): release the
            # lane — cancel is a no-op if the request already finished
            self.metrics.inc("client_disconnects")
            await self._call(eng.cancel, req.rid)
        finally:
            self.streams.unregister(req.rid)

    def _done_payload(self, req) -> dict:
        return {
            "rid": req.rid,
            "tokens": [int(t) for t in req.out_tokens],
            "n_tokens": len(req.out_tokens),
            "finish_reason": req.finish_reason,
        }

    async def _stream_sse(self, writer, req, stream) -> None:
        head = [
            "HTTP/1.1 200 OK",
            *(f"{k}: {v}" for k, v in sse_headers()),
            "Connection: close",
        ]
        writer.write(("\r\n".join(head) + "\r\n\r\n").encode())
        await writer.drain()
        if self.faults.rules:
            ms = self.faults.stall_ms(req.rid)
            if ms:  # chaos: a slow client not draining its socket
                await asyncio.sleep(ms / 1000.0)
        # "i" is the GLOBAL emission index: a resumed request continues
        # from its resumed prefix, so spliced continuations stay
        # contiguous with what the original replica already streamed
        n_sent = stream.sent
        async for tok, done in stream.pump(self.stream_idle_timeout_s):
            if done is not None:
                writer.write(sse_event("done", self._done_payload(done)))
                await writer.drain()
                return
            writer.write(sse_event("token", {"i": n_sent, "token": tok}))
            await writer.drain()
            n_sent += 1
            if (self.faults.rules
                    and self.faults.disconnect_after(req.rid, n_sent)):
                # chaos: the client vanishes mid-stream — abort the
                # transport and take the normal disconnect path
                writer.transport.abort()
                raise ConnectionResetError("fault: disconnect")

    async def _respond_buffered(self, writer, req, stream) -> None:
        async for _tok, done in stream.pump(self.stream_idle_timeout_s):
            if done is not None:
                self._respond(
                    writer, 200,
                    json.dumps(self._done_payload(done)).encode(),
                )
                await writer.drain()
                return


def run_server(engine: Engine, *, host: str = "127.0.0.1", port: int = 0,
               drain_timeout_s: float = 5.0, ladder: bool = True,
               ladder_cfg: Optional[LadderConfig] = None,
               tick_stall_s: float = 10.0) -> DrainReport:
    """Blocking entry point: serve until SIGTERM/SIGINT drains, return
    the :class:`DrainReport`.  SIGINT is handled as a drain — ^C gives
    summary lines and the leak gate, not a traceback."""
    fd = FrontDoor(
        engine, host=host, port=port, drain_timeout_s=drain_timeout_s,
        ladder=ladder, ladder_cfg=ladder_cfg, tick_stall_s=tick_stall_s,
    )
    return asyncio.run(fd.serve_forever())
