"""Port parity: the streaming front door (``repro_torch/serve/frontdoor``),
mirroring ``tests/test_frontdoor.py``.

A real port :class:`FrontDoor` serves on an ephemeral localhost port with
its loop on a daemon thread (stdlib ``http.client`` as the client, every
socket call with a timeout of at most 60 s; waits poll a condition, never
a fixed sleep).  Held to the JAX package on the same inputs: the streams
over the wire (SSE and buffered, fp and 2-bit) equal the JAX engine's
in-process streams; the SSE frames equal the JAX front door's over the
wire; ``parse_generate_body``, ``rejection_response`` and ``parse_tenants``
give the JAX functions' results and error texts on one table; 400 / 413 /
429 carry the JAX bodies and ``Retry-After``; the ladder takes the JAX
ladder's transitions on one tick schedule.  Also: disconnect -> cancel
with the pages freed, drain through the leak gate, the network fault
rules, and the CLI's ``--http-port`` branch in a subprocess.
"""
from __future__ import annotations

import asyncio
import dataclasses
import http.client
import json
import os
import pathlib
import signal
import socket
import struct
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
from torch_parity import drive_ticks, fp_decoders, quantized_tree_numpy

from repro.data import make_calibration as ref_calibration
from repro.serve import Engine as RefEngine
from repro.serve import EngineConfig as RefEngineConfig
from repro.serve import faults as ref_faults
from repro.serve.frontdoor import FrontDoor as RefFrontDoor
from repro.serve.frontdoor import admission as ref_admission
from repro.serve.frontdoor import drain as ref_drain
from repro.serve.frontdoor import ladder as ref_ladder
from repro.serve.frontdoor import streaming as ref_streaming
from repro.serve.frontdoor import wire as ref_wire
from repro.serve.scheduler import TenantPolicy as RefTenantPolicy
from repro_torch.serve.engine import Engine, EngineConfig
from repro_torch.serve.faults import AdmissionRejected, parse_fault_plan
from repro_torch.serve.frontdoor import (
    FrontDoor,
    LadderConfig,
    admission,
    drain,
    leak_gate,
    parse_tenants,
    streaming,
    wire,
)
from repro_torch.serve.frontdoor import ladder as port_ladder
from repro_torch.serve.scheduler import TenantPolicy

ROOT = pathlib.Path(__file__).resolve().parents[1]
GEN = 8
TIMEOUT = 30  # seconds, every socket call


@pytest.fixture(scope="module")
def decoders():
    return fp_decoders(seed=0)


@pytest.fixture(scope="module")
def prompts():
    return np.asarray(ref_calibration(256, n_segments=3, seg_len=8,
                                      seed=3).tokens, np.int32)


@pytest.fixture(scope="module")
def quantized():
    """The smoke model quantized to 2 bits by the JAX package: (JAX
    decoder, port decoder over the converted weights)."""
    import jax

    from repro.configs import get_smoke_config
    from repro.core.quantizer import QuipConfig
    from repro.launch.quantize import quantize_dense_model
    from repro.models import build_model
    from repro.serve import CachedDecoder as RefDecoder
    from repro_torch import convert
    from repro_torch.serve.adapter import CachedDecoder

    cfg = get_smoke_config("qwen3-14b")
    params = build_model(cfg).init(jax.random.PRNGKey(0))
    calib = ref_calibration(cfg.vocab, n_segments=4, seg_len=32, seed=7)
    qm = quantize_dense_model(
        params, cfg, QuipConfig(bits=2, method="ldlq", use_kernel=False),
        calib.tokens, seed=0, verbose=False)
    port = convert.quantized_model_from_numpy(
        dataclasses.asdict(cfg), quantized_tree_numpy(qm), device="cpu")
    return RefDecoder.from_quantized(qm), CachedDecoder.from_quantized(port)


def _knobs(gen=GEN, prompt_len=8, **kw):
    out = dict(max_seq_len=prompt_len + gen, n_slots=4, page_size=4,
               token_budget=32, prefill_chunk=8)
    out.update(kw)
    return out


def _engine(adapter, *, faults=None, **kw):
    return Engine(adapter, EngineConfig(**_knobs(**kw)), faults=faults)


def _ref_engine(adapter, *, faults=None, **kw):
    return RefEngine(adapter, RefEngineConfig(**_knobs(**kw)), faults=faults)


def _post(port, payload, timeout=TIMEOUT):
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    body = payload if isinstance(payload, bytes) else json.dumps(payload)
    c.request("POST", "/v1/generate", body,
              {"Content-Type": "application/json"})
    return c, c.getresponse()


def _get_json(port, path, timeout=10):
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    c.request("GET", path)
    r = c.getresponse()
    body = json.loads(r.read())
    c.close()
    return r.status, body


def _parse_sse(raw: bytes):
    events = []
    for block in raw.decode().strip().split("\n\n"):
        lines = dict(ln.split(": ", 1) for ln in block.split("\n"))
        events.append((lines["event"], json.loads(lines["data"])))
    return events


def _call(port, payload):
    """(status, lowercased headers, raw body) of one generate call."""
    c, r = _post(port, payload)
    try:
        return r.status, {k.lower(): v for k, v in r.getheaders()}, r.read()
    finally:
        c.close()


def _gen_tokens(port, prompt, max_new, *, stream=True, **extra):
    """One generate call to completion; its token list (SSE frames
    contiguous from the first index sent)."""
    payload = {"prompt": [int(t) for t in prompt], "max_new": max_new,
               "stream": stream, **extra}
    status, _, raw = _call(port, payload)
    assert status == 200, (status, raw)
    if not stream:
        return json.loads(raw)["tokens"]
    events = _parse_sse(raw)
    toks = [d["token"] for ev, d in events if ev == "token"]
    idx = [d["i"] for ev, d in events if ev == "token"]
    start = len(extra.get("resume_tokens", ()))
    assert idx == list(range(start, start + len(toks)))
    done = [d for ev, d in events if ev == "done"]
    assert len(done) == 1 and done[0]["tokens"][start:] == toks
    assert done[0]["finish_reason"] in ("length", "stop")
    return done[0]["tokens"]


def _wait(pred, timeout=15, every=0.01):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if pred():
            return True
        time.sleep(every)
    return False


def _ref_streams(adapter, prompts, gen=GEN, **kw):
    eng = _ref_engine(adapter, gen=gen, **kw)
    reqs = [eng.submit(np.asarray(p), max_new=gen) for p in prompts]
    eng.run()
    return [[int(t) for t in r.out_tokens] for r in reqs]


# ---------------------------------------------------------------------------
# streams over the wire equal the JAX engine's in-process streams
# ---------------------------------------------------------------------------

PATHS = {"dense": {}, "paged": dict(paged_decode=True, paged_prefill=True)}


@pytest.mark.parametrize("path", sorted(PATHS))
def test_http_token_identity_fp(decoders, prompts, path):
    ref = _ref_streams(decoders[0], prompts, **PATHS[path])
    fd = FrontDoor(_engine(decoders[1], **PATHS[path]),
                   drain_timeout_s=5.0).start_in_thread()
    try:
        got_sse = [_gen_tokens(fd.port, p, GEN) for p in prompts]
        got_buf = [_gen_tokens(fd.port, p, GEN, stream=False)
                   for p in prompts]
    finally:
        report = fd.drain_and_join()
    assert got_sse == ref
    assert got_buf == ref
    assert report.clean and report.exit_code == 0


def test_http_token_identity_quantized(quantized, prompts):
    gen = 6
    ref = _ref_streams(quantized[0], prompts, gen=gen)
    fd = FrontDoor(_engine(quantized[1], gen=gen),
                   drain_timeout_s=5.0).start_in_thread()
    try:
        got = [_gen_tokens(fd.port, p, gen) for p in prompts]
    finally:
        report = fd.drain_and_join()
    assert got == ref
    assert report.clean


# one table of requests through both packages' front doors: greedy,
# buffered, sampled on the device draw, a resume, stop tokens
WIRE_BODIES = [
    {"max_new": GEN},
    {"max_new": GEN, "stream": False},
    {"max_new": GEN, "temperature": 0.8, "top_p": 0.9, "seed": 7},
    {"max_new": GEN, "resume_tokens": "ref[:3]"},
    {"max_new": GEN, "stop_tokens": "ref[4:5]"},
]


def _strip_rid(raw: bytes, stream: bool):
    if not stream:
        d = json.loads(raw)
        d.pop("rid")
        return d
    out = []
    for ev, d in _parse_sse(raw):
        d.pop("rid", None)
        out.append((ev, d))
    return out


def test_sse_frames_equal_the_jax_front_door(decoders, prompts):
    """The same bodies through the JAX front door and the port's: the
    same status, headers and SSE frames (the per-process ``rid`` aside),
    resumed frames starting at the resume's length."""
    knobs = dict(paged_decode=True, paged_prefill=True, device_sample=True)
    ref = _ref_streams(decoders[0], prompts[:1], **knobs)[0]
    bodies = []
    for b in WIRE_BODIES:
        b = {"prompt": [int(t) for t in prompts[0]], **b}
        for k in ("resume_tokens", "stop_tokens"):
            if k in b:
                lo, hi = {"ref[:3]": (0, 3), "ref[4:5]": (4, 5)}[b[k]]
                b[k] = ref[lo:hi]
        bodies.append(b)
    outs = []
    for fd in (RefFrontDoor(_ref_engine(decoders[0], **knobs)),
               FrontDoor(_engine(decoders[1], **knobs))):
        fd.start_in_thread()
        try:
            outs.append([_call(fd.port, b) for b in bodies])
        finally:
            assert fd.drain_and_join().clean
    for b, (rs, rh, rraw), (s, h, raw) in zip(bodies, *outs):
        # a buffered body's length moves with the width of its rid
        rh.pop("content-length", None)
        h.pop("content-length", None)
        assert (s, h) == (rs, rh)
        stream = b.get("stream", True)
        assert _strip_rid(raw, stream) == _strip_rid(rraw, stream), b
    resumed = _parse_sse(outs[1][3][2])
    assert resumed[0] == ("token", {"i": 3, "token": ref[3]})


# ---------------------------------------------------------------------------
# parsing and HTTP mapping on one table, against the JAX functions
# ---------------------------------------------------------------------------

BODIES = [
    {"prompt": [1, 2], "max_new": 4, "tenant": "t", "priority": 1,
     "stream": False, "temperature": 0.5, "top_p": 0.9, "seed": 3,
     "stop_tokens": [7], "deadline_s": 2.0},
    {"prompt": [5], "max_new": 3, "resume_tokens": [1, 2]},
    {"prompt": [1.5], "max_new": 4},
    {"prompt": [True], "max_new": 4},
    {"prompt": [], "max_new": 4},
    {"prompt": [1], "max_new": 0},
    {"prompt": [1], "max_new": True},
    {"max_new": 4},
    {"prompt": [1], "max_new": 4, "bogus": 1},
    {"prompt": [1], "max_new": 4, "tenant": ""},
    {"prompt": [1], "max_new": 4, "priority": -1},
    {"prompt": [1], "max_new": 4, "stream": "yes"},
    {"prompt": [1], "max_new": 4, "top_p": 0.0},
    {"prompt": [1], "max_new": 4, "temperature": -1.0},
    {"prompt": [1], "max_new": 4, "seed": "x"},
    {"prompt": [1], "max_new": 4, "deadline_s": -1},
    {"prompt": [1], "max_new": 4, "stop_tokens": [1, "a"]},
    {"prompt": [1], "max_new": 2, "resume_tokens": [3, 4]},
    b"not json",
    b"\xff\xfe",
    b"[1, 2]",
]


def _parsed(mod, raw):
    try:
        p = mod.parse_generate_body(raw)
    except ValueError as e:
        return ("error", str(e))
    return (p.prompt.tolist(), p.prompt.dtype.str, p.max_new, p.tenant,
            p.priority, p.stream, p.sampling.temperature, p.sampling.top_p,
            p.sampling.seed, p.stop_tokens, p.deadline_s, p.resume_tokens)


@pytest.mark.parametrize("i", range(len(BODIES)))
def test_parse_generate_body_equals_jax(i):
    b = BODIES[i]
    raw = b if isinstance(b, bytes) else json.dumps(b).encode()
    assert _parsed(admission, raw) == _parsed(ref_admission, raw)


REJECTIONS = [
    dict(reason="over_capacity", retryable=False, needed_pages=9,
         available_pages=4),
    dict(reason="rate_limited", retryable=True, tenant="free",
         retry_after_s=2.5),
    dict(reason="queue_full", retryable=True),
    dict(reason="shed", retryable=True, tenant="x", retry_after_s=0.2),
]


@pytest.mark.parametrize("kw", REJECTIONS, ids=lambda kw: kw["reason"])
def test_rejection_response_equals_jax(kw):
    kw = dict(kw)
    reason = kw.pop("reason")
    got = admission.rejection_response(AdmissionRejected(reason, **kw))
    want = ref_admission.rejection_response(
        ref_faults.AdmissionRejected(reason, **kw))
    assert got == want
    assert str(AdmissionRejected(reason, **kw)) == str(
        ref_faults.AdmissionRejected(reason, **kw))


TENANT_SPECS = ["paid:inf:4:0,free:2.0:8:1,batch:0.5", "a", " a:1 , b::2:3 ",
                "", ":1.0", "a:1:2:3:4", "dup:1,dup:2", "a:x", "a:1:y",
                ",,"]


@pytest.mark.parametrize("spec", TENANT_SPECS)
def test_parse_tenants_equals_jax(spec):
    def run(fn):
        try:
            return {k: (v.rate, v.burst, v.priority)
                    for k, v in fn(spec).items()}
        except ValueError as e:
            return ("error", str(e))

    assert run(parse_tenants) == run(ref_admission.parse_tenants)


def test_sse_event_and_headers_equal_jax():
    for ev, data in (("token", {"i": 3, "token": 17}),
                     ("done", {"rid": 1, "tokens": [1, 2], "n_tokens": 2,
                               "finish_reason": "length"})):
        assert streaming.sse_event(ev, data) == ref_streaming.sse_event(
            ev, data)
    assert streaming.sse_headers() == ref_streaming.sse_headers()


class _Sink:
    def __init__(self):
        self.buf = b""

    def write(self, b):
        self.buf += b


def test_wire_framing_equals_jax():
    for kw in (dict(status=200, body=b"{}"),
               dict(status=429, body=b'{"a": 1}',
                    extra_headers=[("Retry-After", "3")]),
               dict(status=404, body=b"", content_type="text/plain"),
               dict(status=599, body=b"x")):
        a, b = _Sink(), _Sink()
        wire.write_response(a, **kw)
        ref_wire.write_response(b, **kw)
        assert a.buf == b.buf
    raw = (b"POST /v1/generate?x=1 HTTP/1.1\r\nHost: h\r\n"
           b"Content-Length: 5\r\nX-Y:  z \r\n\r\nhello")

    async def parse(mod, data):
        r = asyncio.StreamReader()
        r.feed_data(data)
        r.feed_eof()
        try:
            return await mod.read_request(r)
        except ValueError as e:
            return ("error", str(e))

    for data in (raw, b"", b"garbage\r\n\r\n",
                 b"GET / HTTP/1.1\r\nContent-Length: 99999999999\r\n\r\n"):
        assert asyncio.run(parse(wire, data)) == asyncio.run(
            parse(ref_wire, data))


def test_drain_report_lines_equal_jax():
    for kw in (dict(reason="sigterm", duration_s=1.25, completed=3,
                    cancelled=1, deadline_hit=True, leaked_pages=0,
                    residual_slots=0, served_total=9),
               dict(reason="requested", duration_s=0.0, completed=0,
                    cancelled=0, deadline_hit=False, leaked_pages=2,
                    residual_slots=1, served_total=0)):
        got, want = drain.DrainReport(**kw), ref_drain.DrainReport(**kw)
        assert got.lines() == want.lines()
        assert (got.clean, got.exit_code) == (want.clean, want.exit_code)


# ---------------------------------------------------------------------------
# typed admission over HTTP, against the JAX engine's rejection
# ---------------------------------------------------------------------------


def _ref_rejection(engine, **submit):
    with pytest.raises(ref_faults.AdmissionRejected) as ei:
        engine.submit(**submit)
    return ref_admission.rejection_response(ei.value)


def test_http_over_capacity_413(decoders):
    want = _ref_rejection(_ref_engine(decoders[0]),
                          prompt=np.array([1, 2, 3]), max_new=10_000)
    fd = FrontDoor(_engine(decoders[1]), drain_timeout_s=2.0
                   ).start_in_thread()
    try:
        status, headers, raw = _call(fd.port, {"prompt": [1, 2, 3],
                                               "max_new": 10_000})
    finally:
        assert fd.drain_and_join().clean
    assert (status, raw) == (want[0], want[2]) and status == 413
    assert "retry-after" not in headers
    body = json.loads(raw)
    assert body["retryable"] is False
    assert body["needed_pages"] > body["available_pages"]


def test_http_rate_limited_429_with_retry_after(decoders, prompts):
    p = [int(t) for t in prompts[0]]
    ref = _ref_engine(decoders[0], tenants={
        "free": RefTenantPolicy(rate=0.001, burst=1, priority=0)})
    ref.submit(np.asarray(p), max_new=4, tenant="free")
    want = _ref_rejection(ref, prompt=np.asarray(p), max_new=4,
                          tenant="free")
    eng = _engine(decoders[1], tenants={
        "free": TenantPolicy(rate=0.001, burst=1, priority=0)})
    fd = FrontDoor(eng, drain_timeout_s=5.0).start_in_thread()
    try:
        assert _gen_tokens(fd.port, p, 4, tenant="free")  # burst admit
        status, headers, raw = _call(fd.port, {"prompt": p, "max_new": 4,
                                               "tenant": "free"})
    finally:
        assert fd.drain_and_join().clean
    assert status == want[0] == 429
    got, exp = json.loads(raw), json.loads(want[2])
    # the bucket's retry hint (and the detail quoting it) depends on the
    # wall time between submits
    assert got.pop("retry_after_s") > 0 and exp.pop("retry_after_s") > 0
    head = "admission rejected (rate_limited); tenant 'free'; retry after "
    assert got.pop("detail").startswith(head)
    assert exp.pop("detail").startswith(head)
    assert got == exp and got["error"] == "rate_limited"
    assert int(headers["retry-after"]) >= 1


def test_http_queue_full_429_and_drain_under_traffic(decoders, prompts):
    """One lane and a one-deep queue: a third concurrent stream gets the
    JAX body for ``queue_full`` with Retry-After, and a short drain under
    live traffic cancels the in-flight lanes with no page leaked."""
    eng = _engine(decoders[1], gen=256, n_slots=1, max_queue=1,
                  token_budget=8)
    fd = FrontDoor(eng, drain_timeout_s=0.3).start_in_thread()
    p = [int(t) for t in prompts[0]]
    ca, ra = _post(fd.port, {"prompt": p, "max_new": 256})
    assert ra.status == 200 and ra.read(1)  # A admitted and running
    results = {}

    def _b():
        try:
            cb, rb = _post(fd.port, {"prompt": p, "max_new": 256})
            results["b_status"] = rb.status
            rb.read()
            cb.close()
        except (ConnectionError, OSError) as e:  # ended by the drain
            results["b_error"] = str(e)

    tb = threading.Thread(target=_b, daemon=True)
    tb.start()
    assert _wait(lambda: eng.scheduler.pending >= 1), "B never queued"
    status, headers, raw = _call(fd.port, {"prompt": p, "max_new": 256})
    # the JAX engine in the same state: A running, B queued
    ref = _ref_engine(decoders[0], gen=256, n_slots=1, max_queue=1,
                      token_budget=8)
    ref.submit(np.asarray(p), max_new=256)
    ref.tick()
    ref.submit(np.asarray(p), max_new=256)
    want = _ref_rejection(ref, prompt=np.asarray(p), max_new=256)
    assert (status, raw) == (want[0], want[2]) and status == 429
    assert headers["retry-after"] == "1"
    status, health = _get_json(fd.port, "/healthz")
    assert status == 200 and health["status"] == "ok"
    report = fd.drain_and_join(reason="requested")
    ca.close()
    tb.join(TIMEOUT)
    assert report.clean and report.exit_code == 0
    assert report.deadline_hit and report.cancelled >= 1
    assert eng.metrics.counter("finish:cancelled").value >= 1
    assert leak_gate(eng.pool) == (0, 0)


@pytest.mark.parametrize("i", [2, 4, 7, 8, 17, 18])
def test_http_bad_request_400(decoders, i):
    """A malformed body gets 400 with the JAX parser's text as detail."""
    b = BODIES[i]
    raw = b if isinstance(b, bytes) else json.dumps(b).encode()
    want = _parsed(ref_admission, raw)
    assert want[0] == "error"
    fd = FrontDoor(_engine(decoders[1]), drain_timeout_s=2.0
                   ).start_in_thread()
    try:
        status, _, body = _call(fd.port, raw)
        assert (status, json.loads(body)) == (400, {
            "error": "bad_request", "retryable": False, "detail": want[1]})
        assert _get_json(fd.port, "/404-nope")[0] == 404
    finally:
        assert fd.drain_and_join().clean


def test_resume_rejections_are_400_with_engine_text(decoders, prompts):
    """A resume ending on a stop token passes the parser and is refused by
    ``Engine.submit``: 400 with the JAX engine's text."""
    p = [int(t) for t in prompts[0]]
    body = {"prompt": p, "max_new": 8, "stop_tokens": [3],
            "resume_tokens": [1, 2, 3]}
    with pytest.raises(ValueError) as ei:
        _ref_engine(decoders[0]).submit(np.asarray(p), max_new=8,
                                        stop_tokens=(3,),
                                        resume_tokens=(1, 2, 3))
    fd = FrontDoor(_engine(decoders[1]), drain_timeout_s=2.0
                   ).start_in_thread()
    try:
        status, _, raw = _call(fd.port, body)
    finally:
        assert fd.drain_and_join().clean
    assert status == 400 and json.loads(raw)["detail"] == str(ei.value)


# ---------------------------------------------------------------------------
# disconnect -> cancel, endpoints, shed gate
# ---------------------------------------------------------------------------


def test_mid_stream_disconnect_cancels_request(decoders, prompts):
    eng = _engine(decoders[1], gen=128, token_budget=8)
    fd = FrontDoor(eng, drain_timeout_s=2.0).start_in_thread()
    p = [int(t) for t in prompts[0]]
    c, r = _post(fd.port, {"prompt": p, "max_new": 128})
    assert r.status == 200
    assert r.read(16)  # a token frame is in flight
    # the client vanishes with an RST (SO_LINGER 0), not a polite FIN
    sock = r.fp.raw._sock
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                    struct.pack("ii", 1, 0))
    r.close()
    sock.close()
    assert _wait(lambda: eng.metrics.counter("finish:cancelled").value >= 1)
    assert eng.metrics.counter("client_disconnects").value >= 1
    assert _wait(lambda: leak_gate(eng.pool) == (0, 0))  # pages back
    report = fd.drain_and_join()
    assert report.clean


def test_healthz_readyz_metricsz_and_drain_503(decoders, prompts):
    eng = _engine(decoders[1], gen=256, token_budget=8)
    fd = FrontDoor(eng, drain_timeout_s=3.0).start_in_thread()
    status, h = _get_json(fd.port, "/healthz")
    assert status == 200 and h["status"] == "ok"
    assert set(h) == {"status", "ticks", "last_tick_age_s", "inflight",
                      "pressure", "draining"}
    status, rz = _get_json(fd.port, "/readyz")
    assert status == 200 and rz == {"ready": True, "ladder_level": 0}
    status, m = _get_json(fd.port, "/metricsz")
    assert status == 200 and "steps" in m and m["tick_errors"] == 0
    assert m["server"]["ladder_level"] == 0
    assert m["server"]["ladder_actions"] == ["shed_low"]
    assert 0.0 <= m["server"]["pressure"] <= 1.0
    c = http.client.HTTPConnection("127.0.0.1", fd.port, timeout=10)
    c.request("GET", "/v1/generate")
    assert c.getresponse().status == 405
    c.close()
    p = [int(t) for t in prompts[0]]
    c, r = _post(fd.port, {"prompt": p, "max_new": 256})
    assert r.status == 200 and r.read(1)
    fd._loop.call_soon_threadsafe(fd.request_drain, "requested")

    def draining():
        try:
            status, rz = _get_json(fd.port, "/readyz", timeout=2)
        except (ConnectionError, OSError):
            return False
        return status == 503 and rz["draining"]

    assert _wait(draining, timeout=5), "readyz never reported draining"
    status, _, raw = _call(fd.port, {"prompt": p, "max_new": 4})
    assert (status, json.loads(raw)) == (
        503, {"error": "draining", "retryable": True})
    report = fd.drain_and_join()
    c.close()
    assert report.clean


def test_shed_gate_rejects_only_lowest_class(decoders, prompts):
    eng = _engine(decoders[1], tenants={"paid": TenantPolicy(priority=0),
                                        "free": TenantPolicy(priority=1)})
    fd = FrontDoor(eng, drain_timeout_s=2.0).start_in_thread()
    try:
        fd.ladder.shedding = True  # force the shed rung
        p = [int(t) for t in prompts[0]]
        status, headers, raw = _call(fd.port, {"prompt": p, "max_new": 4,
                                               "tenant": "free"})
        want = ref_admission.rejection_response(
            ref_faults.AdmissionRejected("shed", retryable=True,
                                         tenant="free", retry_after_s=1.0))
        assert (status, raw) == (want[0], want[2]) and status == 429
        assert headers["retry-after"] == "1"
        assert len(_gen_tokens(fd.port, p, 4, tenant="paid")) == 4
        assert eng.metrics.counter("shed_requests").value == 1
    finally:
        assert fd.drain_and_join().clean


# ---------------------------------------------------------------------------
# the degradation ladder, against the JAX ladder
# ---------------------------------------------------------------------------


def _pressurize(eng, n):
    """n requests parked in waiting (far-future arrival)."""
    return [eng.submit(np.arange(1, 5, dtype=np.int32), max_new=2,
                       arrival=1e9) for _ in range(n)]


def _ladder_walk(eng, ladder_mod, cfg, n_press, cancel_at, keep, times):
    """Observe ``times``; before observation ``cancel_at`` cancel all but
    ``keep`` of the ``n_press`` parked requests."""
    ladder = ladder_mod.DegradationLadder(eng, cfg)
    reqs = _pressurize(eng, n_press)
    seen = []
    for k, t in enumerate(times):
        if k == cancel_at:
            for r in reqs[keep:]:
                eng.cancel(r.rid)
        seen.append((ladder.observe(t), ladder.level, ladder.shedding,
                     eng.spec_k))
    return ladder.actions, seen, eng.metrics.snapshot()


@pytest.mark.parametrize("case", ["spec", "band"])
def test_ladder_transitions_equal_jax(decoders, case):
    if case == "spec":
        kw = dict(paged_decode=True, speculative_k=4, max_queue=4)
        cfg = dict(sustain_s=0.1, cooloff_s=0.1)
        n_press, cancel_at, keep = 4, 12, 0
        times = [0.11 * k for k in range(24)]
    else:
        kw = dict(max_queue=10)
        cfg = dict(high_water=0.8, low_water=0.3, sustain_s=0.1,
                   cooloff_s=0.1)
        n_press, cancel_at, keep = 10, 2, 4
        times = [0.0, 0.2, 0.4, 0.6, 0.8]
    walk = (n_press, cancel_at, keep, times)
    got = _ladder_walk(_engine(decoders[1], **kw), port_ladder,
                       LadderConfig(**cfg), *walk)
    want = _ladder_walk(_ref_engine(decoders[0], **kw), ref_ladder,
                        ref_ladder.LadderConfig(**cfg), *walk)
    assert got[:2] == want[:2]
    for key in ("ladder_escalations", "ladder_deescalations",
                "ladder_level"):
        assert got[2][key] == want[2][key], key
    if case == "spec":
        acts = [a for a, *_ in got[1] if a]
        assert acts == ["spec_half", "spec_off", "shed_low", "+shed_low",
                        "+spec_off", "+spec_half"]
        assert got[1][-1][1:] == (0, False, 4)
    else:
        assert got[1][-1][1:3] == (1, True)  # held in the band


def test_ladder_on_tick_schedule_equals_jax(decoders, prompts):
    """The ladder observing before every tick of one ``drive_ticks``
    schedule (the clock reads the tick): a burst against ``max_queue``
    walks it up and the drain walks it down, at the same ticks as the
    JAX ladder over the JAX engine, with the same streams."""
    kw = dict(paged_decode=True, paged_prefill=True, speculative_k=4,
              max_queue=3, n_slots=2, gen=12)
    cfg = dict(high_water=0.6, low_water=0.2, sustain_s=1.0, cooloff_s=2.0)
    sched = [(t, dict(prompt=np.asarray(prompts[i % 3]), max_new=12))
             for i, t in enumerate([0, 0, 0, 0, 0, 1, 2, 3, 9, 20, 60])]
    out = []
    for eng, mod, lcfg in (
            (_engine(decoders[1], **kw), port_ladder, LadderConfig(**cfg)),
            (_ref_engine(decoders[0], **kw), ref_ladder,
             ref_ladder.LadderConfig(**cfg))):
        ladder = mod.DegradationLadder(eng, lcfg)
        log = []
        tick = eng.tick

        def observed_tick(eng=eng, ladder=ladder, log=log, tick=tick):
            act = ladder.observe(eng.now())
            if act:
                log.append((eng.now(), act, ladder.level))
            return tick()

        eng.tick = observed_tick
        run = drive_ticks(eng, sched)
        out.append((log, run.rejected, run.ticks,
                    {i: run.outcome(i) for i in run.reqs}))
    assert out[0] == out[1]
    acts = [a for _, a, _ in out[0][0]]
    assert acts[:3] == ["spec_half", "spec_off", "shed_low"]
    assert acts[-3:] == ["+shed_low", "+spec_off", "+spec_half"]


def test_set_speculative_k_clamps(decoders):
    eng = _engine(decoders[1], paged_decode=True, speculative_k=4)
    assert eng.set_speculative_k(2) == 2
    assert eng.set_speculative_k(99) == 4
    assert eng.set_speculative_k(0) == 0
    with pytest.raises(ValueError):
        eng.set_speculative_k(-1)


# ---------------------------------------------------------------------------
# tick()/TickResult and the lifecycle calls the server makes
# ---------------------------------------------------------------------------


def test_tick_result_reports_emissions_and_finishes(decoders, prompts):
    eng = _engine(decoders[1], gen=5)
    reqs = [eng.submit(p, max_new=5) for p in prompts]
    per_rid = {r.rid: [] for r in reqs}
    finished = []
    while not eng.idle:
        res = eng.tick()
        for req, tok in res.emitted:
            per_rid[req.rid].append(tok)
        finished.extend(res.finished)
    assert sorted(r.rid for r in finished) == sorted(r.rid for r in reqs)
    for r in reqs:
        assert per_rid[r.rid] == [int(t) for t in r.out_tokens]
    assert leak_gate(eng.pool) == (0, 0)


def test_between_tick_cancel_reported_by_next_tick(decoders, prompts):
    eng = _engine(decoders[1], gen=64, token_budget=8)
    req = eng.submit(prompts[0], max_new=64)
    while not req.out_tokens:
        eng.tick()
    assert eng.cancel(req.rid)
    res = eng.tick()
    assert req in res.finished and req.finish_reason == "cancelled"
    assert eng.idle and eng.next_arrival() is None
    assert eng.cancel_all() == []


# ---------------------------------------------------------------------------
# the network fault rules
# ---------------------------------------------------------------------------


def test_network_fault_rules_equal_jax():
    spec = "slow_client@ms=50;disconnect@tokens=2;admission_burst@n=3"
    logs = []
    for parse in (parse_fault_plan, ref_faults.parse_fault_plan):
        plan = parse(spec)
        seen = [plan.stall_ms(rid=7), plan.stall_ms(rid=7),
                plan.disconnect_after(5, 1), plan.disconnect_after(5, 2),
                plan.disconnect_after(5, 3), plan.admission_burst(),
                plan.admission_burst()]
        logs.append((seen, plan.log))
    assert logs[0] == logs[1]
    assert logs[0][0] == [50, None, False, True, False, 3, 0]
    for bad in ("slow_client", "admission_burst@n=0", "disconnect@x=1"):
        errs = []
        for parse in (parse_fault_plan, ref_faults.parse_fault_plan):
            with pytest.raises(ValueError) as ei:
                parse(bad)
            errs.append(str(ei.value))
        assert errs[0] == errs[1]


def test_disconnect_fault_injected_over_http(decoders, prompts):
    """An armed disconnect rule drops the SSE stream server-side after 2
    tokens; the request is cancelled and its pages come back."""
    eng = _engine(decoders[1], gen=128, token_budget=8)
    eng.faults.rules.extend(parse_fault_plan("disconnect@tokens=2").rules)
    fd = FrontDoor(eng, drain_timeout_s=2.0).start_in_thread()
    c, r = _post(fd.port, {"prompt": [int(t) for t in prompts[0]],
                           "max_new": 128})
    assert r.status == 200
    raw = b""
    try:
        while True:
            chunk = r.read(64)
            if not chunk:
                break
            raw += chunk
    except (ConnectionError, OSError, http.client.IncompleteRead):
        pass
    c.close()
    assert raw.count(b"event: token") == 2
    assert _wait(lambda: eng.metrics.counter("finish:cancelled").value == 1)
    report = fd.drain_and_join()
    assert report.clean


def test_slow_client_and_admission_burst_over_http(decoders, prompts):
    """``slow_client`` stalls the stream's start without losing a token;
    ``admission_burst`` submits lowest-class traffic the engine admits or
    rejects, each counted."""
    ref = _ref_streams(decoders[0], prompts[:1])[0]
    eng = _engine(decoders[1], max_queue=2)
    eng.faults.rules.extend(parse_fault_plan("slow_client@ms=200").rules)
    fd = FrontDoor(eng, drain_timeout_s=5.0).start_in_thread()
    try:
        t0 = time.monotonic()
        assert _gen_tokens(fd.port, prompts[0], GEN) == ref
        assert time.monotonic() - t0 >= 0.2
        # armed once the queue is empty: four submits against a queue of
        # two, no tick between them
        eng.faults.rules.extend(
            parse_fault_plan("admission_burst@n=4").rules)
        assert _wait(lambda: eng.metrics.counter("burst_admitted").value
                     + eng.metrics.counter("burst_rejected").value == 4)
        assert eng.metrics.counter("burst_rejected").value == 2
    finally:
        report = fd.drain_and_join()
    assert report.clean
    assert [e["kind"] for e in eng.faults.log] == ["slow_client",
                                                    "admission_burst"]


def test_tick_error_is_counted_and_loop_survives(decoders, prompts):
    """A tick that raises is counted in ``tick_errors`` (the number every
    caller gates on) and the loop goes on serving."""
    eng = _engine(decoders[1])
    real = eng.tick
    fail = [1]

    def flaky():
        if fail and eng.scheduler.pending:
            fail.pop()
            raise RuntimeError("injected")
        return real()

    eng.tick = flaky
    fd = FrontDoor(eng, drain_timeout_s=2.0).start_in_thread()
    try:
        assert len(_gen_tokens(fd.port, prompts[0], GEN)) == GEN
        assert _get_json(fd.port, "/metricsz")[1]["tick_errors"] == 1
    finally:
        assert fd.drain_and_join().clean


# ---------------------------------------------------------------------------
# the CLI's --http-port branch
# ---------------------------------------------------------------------------


def test_cli_http_port_serves_and_drains_on_sigterm(decoders):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "--smoke",
         "--device", "cpu", "--paged", "--paged-prefill", "--http-port",
         "0"], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
        cwd=ROOT, text=True)
    try:
        lines = []
        port = None
        t0 = time.monotonic()
        while port is None and time.monotonic() - t0 < 60:
            line = proc.stdout.readline()
            if not line:
                break
            lines.append(line)
            if line.startswith("[frontdoor] listening on "):
                port = int(line.rsplit(":", 1)[1])
        assert port is not None, "".join(lines)
        toks = _gen_tokens(port, list(range(1, 9)), GEN)
        assert len(toks) == GEN
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, out
    assert "leak gate: clean (0 leaked pages, 0 mapped slots)" in out
    assert "[serve] drain[sigterm] finished in" in out
    assert "[serve] http: requests=1 rejections=0 shed=0 disconnects=0" in out
    assert "tick_errors" not in out
