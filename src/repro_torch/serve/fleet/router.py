"""The fleet router: one stdlib-asyncio HTTP front in front of N
replica FrontDoors, with journal-backed in-flight failover.

Routing is two-tier: sticky prefix affinity first (rendezvous hash of
the prompt header → the replica whose trie already holds those pages),
least-loaded fallback when the preferred replica is unavailable or
over pressure.  The router never touches an engine — it speaks the
replicas' own HTTP API and relays their SSE frames, so every admission
semantic (typed 429/413 rejections, Retry-After, drain 503s) passes
through unchanged.

Headline mechanism — **in-flight failover**: every relayed token is
journaled; when the upstream replica dies mid-stream (connection reset,
``kill -9``, wedge-kill) the router resubmits the ORIGINAL body plus
``resume_tokens`` to another healthy replica and splices the
continuation into the same client SSE stream.  The replacement engine
replays prompt+emitted (the same machinery eviction restore uses), so
the splice is token-identical by construction: greedy is argmax, and
device-side sampling keys on ``fold_in(seed, emission_index)`` — both
depend only on (weights, prompt, emitted-so-far), all of which the
journal reconstructs.  On the card "identical" holds as the engine's own
determinism does: a replacement replica computes the same logits up to
the kernels' summation order, so a spliced greedy token can differ only
where the top-2 margin is that small.  The host draw (``--host-sample``
or the gather-dense path with a temperature) has no per-emission key and
is outside the guarantee.
"""
from __future__ import annotations

import asyncio
import json
import signal
import threading
from typing import Optional

from repro_torch.serve.fleet.affinity import prefix_key, rendezvous_rank
from repro_torch.serve.fleet.journal import JournalEntry, RequestJournal
from repro_torch.serve.fleet.supervisor import (
    FleetReport,
    ReplicaHandle,
    Supervisor,
)
from repro_torch.serve.frontdoor.admission import parse_generate_body
from repro_torch.serve.frontdoor.streaming import sse_event, sse_headers
from repro_torch.serve.frontdoor.wire import (
    open_http,
    read_body,
    read_request,
    write_response,
)

__all__ = ["FleetRouter"]

_PASSTHROUGH_HEADERS = ("retry-after",)


async def _read_sse_frame(reader: asyncio.StreamReader, *,
                          timeout: float) -> Optional[tuple]:
    """Read one SSE frame off an upstream stream: ``(event, data)`` with
    data JSON-decoded, or None on EOF (including EOF mid-frame — a
    partial frame from a dying replica is dropped, never relayed; the
    journal makes the resume splice re-cover it)."""
    event, data = None, None
    while True:
        line = await asyncio.wait_for(reader.readline(), timeout)
        if not line:
            return None
        if not line.endswith(b"\n"):
            return None  # EOF mid-line: truncated frame
        if line in (b"\n", b"\r\n"):
            if event is not None and data is not None:
                return event, data
            continue  # stray blank line
        if line.startswith(b"event:"):
            event = line[len(b"event:"):].strip().decode()
        elif line.startswith(b"data:"):
            try:
                data = json.loads(line[len(b"data:"):].strip())
            except json.JSONDecodeError:
                return None  # truncated JSON: treat as dead upstream


class _UpstreamDead(Exception):
    """The current replica attempt failed mid-request (connection
    refused/reset, EOF before ``done``, stall past the idle budget) —
    the caller picks another replica and resumes."""


class FleetRouter:
    """Health-checked, affinity-sticky, failover-splicing HTTP router."""

    def __init__(self, supervisor: Supervisor, *,
                 host: str = "127.0.0.1", port: int = 0,
                 drain_timeout_s: float = 30.0,
                 max_failovers: int = 3,
                 over_pressure: float = 0.9,
                 affinity_header_len: int = 16,
                 connect_timeout_s: float = 5.0,
                 stream_idle_timeout_s: float = 60.0,
                 pick_wait_s: float = 2.0):
        self.sup = supervisor
        self.host = host
        self.port = port
        self.drain_timeout_s = drain_timeout_s
        self.max_failovers = max_failovers
        self.over_pressure = over_pressure
        self.affinity_header_len = affinity_header_len
        self.connect_timeout_s = connect_timeout_s
        self.stream_idle_timeout_s = stream_idle_timeout_s
        self.pick_wait_s = pick_wait_s
        self.journal = RequestJournal()
        self.counters = {
            "http_requests": 0, "routed": 0, "affinity_hits": 0,
            "affinity_fallbacks": 0, "failovers": 0,
            "failover_exhausted": 0, "rejections_passed": 0,
            "unavailable_503": 0, "aborted_streams": 0,
            "client_disconnects": 0,
        }
        self._draining = False
        self._drain_reason = "requested"
        self._drain_event: Optional[asyncio.Event] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._conn_tasks: set = set()
        self._started = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._thread_error: Optional[BaseException] = None
        self.report: Optional[FleetReport] = None

    # ---- lifecycle -------------------------------------------------------

    def request_drain(self, reason: str = "requested") -> None:
        """Begin fleet-wide graceful drain (idempotent): the router
        503s new work immediately, in-flight streams get
        ``drain_timeout_s`` to finish, then the supervisor coordinates
        per-replica drains and aggregates their leak gates."""
        if self._draining:
            return
        self._draining = True
        self._drain_reason = reason
        if self._drain_event is not None:
            self._drain_event.set()

    async def serve_forever(self, *, install_signals: bool = True,
                            start_fleet: bool = True) -> FleetReport:
        """Boot the fleet (unless the caller already did), serve until a
        drain completes, return the aggregated :class:`FleetReport`."""
        self._loop = asyncio.get_running_loop()
        self._drain_event = asyncio.Event()
        if self._draining:  # drain requested before boot
            self._drain_event.set()
        if start_fleet:
            await self.sup.start()
        server = await asyncio.start_server(
            self._handle_conn, self.host, self.port)
        self.port = server.sockets[0].getsockname()[1]
        print(f"[router] listening on {self.host}:{self.port} "
              f"({len(self.sup.handles)} replicas)", flush=True)
        if install_signals:
            for sig, why in ((signal.SIGTERM, "sigterm"),
                             (signal.SIGINT, "sigint")):
                try:
                    self._loop.add_signal_handler(
                        sig, self.request_drain, why)
                except NotImplementedError:  # pragma: no cover - win32
                    pass
        probe_task = self._loop.create_task(self.sup.probe_loop())
        self._started.set()
        await self._drain_event.wait()
        t0 = self._loop.time()
        # stop admitting (already flipped), let live streams finish
        deadline = t0 + self.drain_timeout_s
        while self._conn_tasks and self._loop.time() < deadline:
            await asyncio.sleep(0.02)
        if self._conn_tasks:  # deadline: abort the stragglers
            self.counters["aborted_streams"] += len(self._conn_tasks)
            for task in list(self._conn_tasks):
                task.cancel()
            await asyncio.gather(*self._conn_tasks,
                                 return_exceptions=True)
        probe_task.cancel()
        try:
            await probe_task
        except asyncio.CancelledError:
            pass
        server.close()
        await server.wait_closed()
        await self.sup.drain()
        self.report = FleetReport(
            reason=self._drain_reason,
            duration_s=self._loop.time() - t0,
            routed=self.counters["routed"],
            completed=self.journal.completed,
            failed=self.journal.failed,
            failovers=self.counters["failovers"],
            aborted_streams=self.counters["aborted_streams"],
            replicas=[h.to_dict() for h in self.sup.handles],
        )
        for line in self.report.lines():
            print(f"[router] {line}", flush=True)
        return self.report

    # ---- thread hosting (tests / in-process clients) --------------------

    def start_in_thread(self) -> "FleetRouter":
        """Run the router loop on a daemon thread; returns once the
        socket is bound (``self.port`` is then real)."""
        self._thread = threading.Thread(
            target=self._thread_main, name="fleet-router", daemon=True)
        self._thread.start()
        if not self._started.wait(120):
            raise RuntimeError("fleet router failed to start")
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
                       timeout: float = 120.0) -> FleetReport:
        """Threadsafe drain + join for a thread-hosted router."""
        self._loop.call_soon_threadsafe(self.request_drain, reason)
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise RuntimeError("fleet router did not drain in time")
        if self._thread_error is not None:
            raise self._thread_error
        return self.report

    # ---- HTTP ------------------------------------------------------------

    async def _handle_conn(self, reader, writer) -> None:
        task = asyncio.current_task()
        self._conn_tasks.add(task)
        try:
            parsed = await asyncio.wait_for(read_request(reader), 30.0)
            if parsed is None:
                return
            method, path, _headers, body = parsed
            await self._route(writer, method, path, body)
        except asyncio.CancelledError:
            # drain deadline: the client's stream is being aborted
            raise
        except (asyncio.TimeoutError, ConnectionError, OSError):
            pass
        except Exception as e:  # noqa: BLE001 - last-resort 500
            try:
                write_response(writer, 500, json.dumps(
                    {"error": "internal", "detail": str(e)}).encode())
            except Exception:
                pass
        finally:
            self._conn_tasks.discard(task)
            try:
                writer.close()
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass

    async def _route(self, writer, method, path, body) -> None:
        path = path.split("?", 1)[0]
        if path == "/healthz" and method == "GET":
            write_response(writer, 200, json.dumps({
                "status": "ok",
                "replicas": {
                    h.state: sum(1 for x in self.sup.handles
                                 if x.state == h.state)
                    for h in self.sup.handles},
                "draining": self._draining,
            }).encode())
        elif path == "/readyz" and method == "GET":
            n_avail = sum(1 for h in self.sup.handles if h.available)
            ready = n_avail > 0 and not self._draining
            write_response(writer, 200 if ready else 503, json.dumps({
                "ready": ready, "available_replicas": n_avail,
                "draining": self._draining,
            }).encode())
        elif path == "/fleetz" and method == "GET":
            write_response(writer, 200, json.dumps({
                "replicas": [h.to_dict() for h in self.sup.handles],
                "router": dict(self.counters),
                "journal": {
                    "live": len(self.journal),
                    "opened": self.journal.opened,
                    "completed": self.journal.completed,
                    "failed": self.journal.failed,
                    "failovers": self.journal.failovers,
                },
            }).encode())
        elif path == "/metricsz" and method == "GET":
            write_response(writer, 200, json.dumps({
                "router": dict(self.counters),
                "replicas": [h.to_dict() for h in self.sup.handles],
            }).encode())
        elif path == "/v1/generate" and method == "POST":
            await self._handle_generate(writer, body)
        elif path in ("/healthz", "/readyz", "/metricsz", "/fleetz",
                      "/v1/generate"):
            write_response(writer, 405, json.dumps(
                {"error": "method_not_allowed"}).encode())
        else:
            write_response(writer, 404, json.dumps(
                {"error": "not_found"}).encode())
        await writer.drain()

    # ---- routing ---------------------------------------------------------

    def _pick(self, key: int,
              exclude: set) -> Optional[ReplicaHandle]:
        """Choose a replica for an affinity key: the rendezvous-preferred
        slot when it is healthy and under pressure, else the least-loaded
        available slot (ties broken by rendezvous rank, so fallback is
        deterministic too)."""
        handles = self.sup.handles
        ranked = rendezvous_rank(key, len(handles))
        avail = [h for h in handles
                 if h.available and h.index not in exclude]
        if not avail:
            return None
        preferred = handles[ranked[0]]
        if (preferred.available and preferred.index not in exclude
                and preferred.pressure < self.over_pressure):
            self.counters["affinity_hits"] += 1
            return preferred
        rank_pos = {idx: pos for pos, idx in enumerate(ranked)}
        self.counters["affinity_fallbacks"] += 1
        return min(avail, key=lambda h: (h.inflight, rank_pos[h.index]))

    async def _await_replica(self, key: int,
                             tried: set) -> Optional[ReplicaHandle]:
        loop = asyncio.get_running_loop()
        deadline = loop.time() + self.pick_wait_s
        while loop.time() < deadline and not self._draining:
            await asyncio.sleep(0.05)
            handle = self._pick(key, tried)
            if handle is not None:
                return handle
        return None

    # ---- generate proxy --------------------------------------------------

    async def _handle_generate(self, writer, raw: bytes) -> None:
        self.counters["http_requests"] += 1
        if self._draining:
            write_response(
                writer, 503,
                json.dumps({"error": "draining",
                            "retryable": True}).encode(),
                extra_headers=[("Retry-After", "1")])
            return
        # validate locally with the replicas' own parser: garbage fails
        # here with the identical 400 body a replica would produce, and
        # a valid body gives us the prompt (affinity) and stream flag
        try:
            p = parse_generate_body(raw)
            body = json.loads(raw.decode("utf-8"))
        except ValueError as e:
            write_response(writer, 400, json.dumps(
                {"error": "bad_request", "retryable": False,
                 "detail": str(e)}).encode())
            return
        key = prefix_key(p.prompt, self.affinity_header_len)
        entry = self.journal.open(body, p.stream)
        self.counters["routed"] += 1
        try:
            await self._proxy(writer, entry, key)
        finally:
            # safety net for exception paths (cancel at drain deadline,
            # internal errors): anything still journaled failed
            if entry.jid in self.journal._entries:
                self.journal.close(entry, finish_reason=None)

    async def _proxy(self, writer, entry: JournalEntry,
                     key: int) -> None:
        """Run one journaled request to completion across however many
        replica attempts it takes (bounded by ``max_failovers``)."""
        tried: set = set()  # replicas failed since last token progress
        while True:
            handle = self._pick(key, tried)
            if handle is None:
                # transient gap (a suspect awaiting its next probe, a
                # restart in flight): wait briefly before giving up —
                # aborting a live stream over a 100ms health blip would
                # be the worst possible trade
                handle = await self._await_replica(key, tried)
            if handle is None:
                self._no_replica(writer, entry)
                return
            entry.assign(handle.index)
            handle.routed += 1
            handle.inflight += 1
            mark = len(entry.tokens)
            try:
                done = await self._attempt(writer, entry, handle)
            except _UpstreamDead as e:
                # the replica failed us mid-request: flag it for the
                # supervisor (the probe loop confirms and restarts) and
                # fail over — unless the budget is spent
                if len(entry.tokens) > mark:
                    # progress was made: forget earlier failures so a
                    # since-restarted replica is eligible again
                    tried = {handle.index}
                else:
                    tried.add(handle.index)
                if handle.state == "healthy":
                    handle.state = "suspect"
                    handle.last_err = f"router: {e}"
                if entry.n_failovers >= self.max_failovers:
                    self.counters["failover_exhausted"] += 1
                    self._no_replica(writer, entry)
                    return
                self.counters["failovers"] += 1
                self.journal.note_failover(entry)
                continue
            finally:
                handle.inflight -= 1
            if done:
                handle.served += 1
            return

    def _no_replica(self, writer, entry: JournalEntry) -> None:
        """No replica can take (or continue) this request.  Before any
        bytes went out: a typed retryable 503.  Mid-stream: the only
        honest move is to abort the transport — a fabricated ``done``
        would masquerade as a completed generation."""
        self.counters["unavailable_503"] += 1
        self.journal.close(entry, finish_reason=None)
        if entry.head_sent:
            self.counters["aborted_streams"] += 1
            writer.transport.abort()
            return
        write_response(
            writer, 503,
            json.dumps({"error": "replica_unavailable",
                        "retryable": True}).encode(),
            extra_headers=[("Retry-After", "1")])

    async def _attempt(self, writer, entry: JournalEntry,
                       handle: ReplicaHandle) -> bool:
        """One upstream attempt.  Returns True when the request finished
        (done relayed / rejection passed through), False when the client
        vanished; raises :class:`_UpstreamDead` to request failover."""
        body = json.dumps(
            entry.resume_body() if entry.tokens else entry.body
        ).encode()
        try:
            status, headers, up_reader, up_writer = await open_http(
                handle.host, handle.port, "POST", "/v1/generate",
                body=body, timeout=self.connect_timeout_s)
        except (ConnectionError, OSError, asyncio.TimeoutError) as e:
            raise _UpstreamDead(f"connect failed: {e!r}") from None
        try:
            if status != 200:
                return await self._relay_error(
                    writer, entry, handle, status, headers, up_reader)
            if not entry.stream:
                return await self._relay_buffered(
                    writer, entry, headers, up_reader)
            return await self._relay_sse(writer, entry, up_reader)
        finally:
            try:
                up_writer.close()
                await up_writer.wait_closed()
            except (ConnectionError, OSError):
                pass

    async def _relay_error(self, writer, entry, handle, status,
                           headers, up_reader) -> bool:
        """Non-200 from a replica.  Drain 503s mean THAT replica is
        unavailable — retryable elsewhere, so fail over transparently.
        Everything else (429/413/400/500) is a verdict about the
        REQUEST: pass status, body, and Retry-After through unchanged
        (satellite: typed rejections survive the router)."""
        raw = await read_body(up_reader, headers,
                              timeout=self.connect_timeout_s)
        if status == 503:
            raise _UpstreamDead(f"replica {handle.index} unavailable "
                                f"(503)")
        if entry.head_sent:
            # a resumed request bounced (e.g. rejected at admission on
            # the new replica): the stream cannot continue honestly
            raise _UpstreamDead(
                f"resume rejected with {status} by replica "
                f"{handle.index}")
        self.counters["rejections_passed"] += 1
        extra = [(k.title(), v) for k, v in headers.items()
                 if k in _PASSTHROUGH_HEADERS]
        write_response(writer, status, raw, extra_headers=extra)
        self.journal.close(entry, finish_reason=f"rejected_{status}")
        return True

    async def _relay_buffered(self, writer, entry, headers,
                              up_reader) -> bool:
        """Buffered (non-stream) relay: nothing reaches the client until
        the full body is in hand, so replica death here is a clean full
        retry — no splice needed."""
        try:
            raw = await read_body(up_reader, headers,
                                  timeout=self.stream_idle_timeout_s)
            payload = json.loads(raw.decode("utf-8"))
        except (ConnectionError, OSError, asyncio.TimeoutError,
                asyncio.IncompleteReadError, UnicodeDecodeError,
                json.JSONDecodeError) as e:
            raise _UpstreamDead(f"buffered relay failed: {e!r}") \
                from None
        write_response(writer, 200, raw)
        await writer.drain()
        self.journal.close(
            entry, finish_reason=payload.get("finish_reason", "done"))
        return True

    async def _relay_sse(self, writer, entry: JournalEntry,
                         up_reader) -> bool:
        """Stream relay: forward token frames (journaling each), finish
        on the ``done`` frame.  EOF or stall before ``done`` raises for
        failover.  Frames are re-serialized (not byte-forwarded) so a
        torn frame from a dying replica can never reach the client."""
        if not entry.head_sent:
            head = ["HTTP/1.1 200 OK",
                    *(f"{k}: {v}" for k, v in sse_headers()),
                    "Connection: close"]
            writer.write(("\r\n".join(head) + "\r\n\r\n").encode())
            await writer.drain()
            entry.head_sent = True
        while True:
            try:
                frame = await _read_sse_frame(
                    up_reader, timeout=self.stream_idle_timeout_s)
            except (ConnectionError, OSError, asyncio.TimeoutError) as e:
                raise _UpstreamDead(f"stream broke: {e!r}") from None
            if frame is None:
                raise _UpstreamDead("EOF before done frame")
            event, data = frame
            if event == "token":
                # the frame is fully parsed before either side-effect,
                # so journal and relay can't diverge on upstream death;
                # a client-write failure abandons the request entirely
                entry.record(int(data["i"]), int(data["token"]))
                try:
                    writer.write(sse_event("token", data))
                    await writer.drain()
                except (ConnectionError, OSError):
                    self.counters["client_disconnects"] += 1
                    self.journal.close(entry, finish_reason=None)
                    return False
            elif event == "done":
                if (data.get("finish_reason") == "cancelled"
                        and not self._draining):
                    # the REPLICA gave up (its own drain/cancel_all),
                    # not the request: resume on a survivor.  During a
                    # coordinated fleet drain the cancel is honest and
                    # passes through.
                    raise _UpstreamDead("replica cancelled mid-stream")
                try:
                    writer.write(sse_event("done", data))
                    await writer.drain()
                except (ConnectionError, OSError):
                    self.counters["client_disconnects"] += 1
                    self.journal.close(entry, finish_reason=None)
                    return False
                self.journal.close(
                    entry,
                    finish_reason=data.get("finish_reason", "done"))
                return True
            # unknown events: relay-transparent no-op
