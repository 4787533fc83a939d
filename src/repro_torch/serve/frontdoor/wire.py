"""Minimal HTTP/1.1 wire helpers shared by the front door and the
fleet router (stdlib asyncio only — the serving stack takes no HTTP
dependency).

Server side: :func:`read_request` parses one request off a stream
(method, path, headers, body) with header/body size guards;
:func:`write_response` emits a framed ``Connection: close`` response.
Client side: :func:`open_http` sends a request upstream and parses the
status line + headers, leaving the body on the reader — the router
relays SSE frames incrementally; :func:`read_body` drains a
content-length body; :func:`get_json` is the one-shot probe helper the
supervisor's health checks use.
"""
from __future__ import annotations

import asyncio
import json
from typing import Optional

__all__ = [
    "REASONS",
    "get_json",
    "open_http",
    "read_body",
    "read_request",
    "write_response",
]

REASONS = {
    200: "OK", 400: "Bad Request", 404: "Not Found",
    405: "Method Not Allowed", 413: "Payload Too Large",
    429: "Too Many Requests", 431: "Request Header Fields Too Large",
    500: "Internal Server Error", 502: "Bad Gateway",
    503: "Service Unavailable", 504: "Gateway Timeout",
}
MAX_BODY = 8 << 20
MAX_HEADER_LINE = 16 << 10


# ---------------------------------------------------------------------------
# server side
# ---------------------------------------------------------------------------


async def read_request(reader: asyncio.StreamReader) -> Optional[tuple]:
    """Parse one HTTP request: ``(method, path, headers, body)`` with
    header names lowercased, or None on an empty/unparseable request
    line.  Raises ValueError on oversized headers or body."""
    line = await reader.readline()
    if not line:
        return None
    try:
        method, path, _version = line.decode("latin-1").split(None, 2)
    except ValueError:
        return None
    headers = {}
    while True:
        hline = await reader.readline()
        if len(hline) > MAX_HEADER_LINE:
            raise ValueError("header line too long")
        if hline in (b"\r\n", b"\n", b""):
            break
        name, _, value = hline.decode("latin-1").partition(":")
        headers[name.strip().lower()] = value.strip()
    body = b""
    n = int(headers.get("content-length", 0) or 0)
    if n:
        if n > MAX_BODY:
            raise ValueError("body too large")
        body = await reader.readexactly(n)
    return method.upper(), path, headers, body


def write_response(writer: asyncio.StreamWriter, status: int, body: bytes,
                   *, content_type: str = "application/json",
                   extra_headers=()) -> None:
    """Frame and write one ``Connection: close`` response (caller
    drains the writer)."""
    head = [
        f"HTTP/1.1 {status} {REASONS.get(status, 'OK')}",
        f"Content-Type: {content_type}",
        f"Content-Length: {len(body)}",
        "Connection: close",
    ]
    head.extend(f"{k}: {v}" for k, v in extra_headers)
    writer.write(("\r\n".join(head) + "\r\n\r\n").encode() + body)


# ---------------------------------------------------------------------------
# client side (router → replica, supervisor → /healthz)
# ---------------------------------------------------------------------------


async def open_http(host: str, port: int, method: str, path: str, *,
                    body: bytes = b"", timeout: float = 10.0) -> tuple:
    """Open a connection, send one request, and parse the response head.

    Returns ``(status, headers, reader, writer)`` with the body left
    unread on ``reader`` — streaming consumers (the router's SSE relay)
    read incrementally; bounded consumers call :func:`read_body`.  The
    caller owns the writer and must close it."""
    reader, writer = await asyncio.wait_for(
        asyncio.open_connection(host, port), timeout)
    head = [
        f"{method} {path} HTTP/1.1",
        f"Host: {host}:{port}",
        f"Content-Length: {len(body)}",
        "Connection: close",
    ]
    if body:
        head.append("Content-Type: application/json")
    writer.write(("\r\n".join(head) + "\r\n\r\n").encode() + body)
    await writer.drain()
    status_line = await asyncio.wait_for(reader.readline(), timeout)
    parts = status_line.decode("latin-1").split(None, 2)
    if len(parts) < 2 or not parts[1].isdigit():
        raise ConnectionError(f"bad status line {status_line!r}")
    status = int(parts[1])
    headers = {}
    while True:
        hline = await asyncio.wait_for(reader.readline(), timeout)
        if len(hline) > MAX_HEADER_LINE:
            raise ConnectionError("response header line too long")
        if hline in (b"\r\n", b"\n", b""):
            break
        name, _, value = hline.decode("latin-1").partition(":")
        headers[name.strip().lower()] = value.strip()
    return status, headers, reader, writer


async def read_body(reader: asyncio.StreamReader, headers: dict, *,
                    timeout: float = 10.0) -> bytes:
    """Drain a response body: content-length bytes when declared, else
    until EOF (our servers always close per response)."""
    n = int(headers.get("content-length", -1))
    if n >= 0:
        if n > MAX_BODY:
            raise ConnectionError("response body too large")
        return await asyncio.wait_for(reader.readexactly(n), timeout)
    return await asyncio.wait_for(reader.read(MAX_BODY), timeout)


async def get_json(host: str, port: int, path: str, *,
                   timeout: float = 5.0) -> tuple:
    """One-shot GET returning ``(status, parsed-JSON-or-None)`` — the
    supervisor's health-probe primitive.  Connection errors propagate
    (the prober counts them); an unparseable body maps to None."""
    status, headers, reader, writer = await open_http(
        host, port, "GET", path, timeout=timeout)
    try:
        raw = await read_body(reader, headers, timeout=timeout)
    finally:
        writer.close()
        try:
            await writer.wait_closed()
        except (ConnectionError, OSError):
            pass
    try:
        return status, json.loads(raw.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError):
        return status, None
