"""The port's front door and replica fleet over a tensor-parallel mesh
(``--mesh DP,MP`` with ``--http-port`` / ``--fleet``), held to the JAX
package's single-device engine and front door on the CPU.

A (1, 2) mesh of gloo processes serves the smoke ``qwen3-14b``; the JAX
streams come from the JAX package's own engine on one device (its mesh
does not build on this jax).  Held exactly: the streams over the wire,
fp and 2-bit, and at ``--speculative 4`` over int8 pages; the SSE frames
of the JAX front door.  Then the mesh's lifetime: a dead worker turns
``/healthz`` 503 at once, idle or busy, and the drain does not hang; a
mesh command from a second thread raises; the CLI drains on SIGTERM and
on a SIGINT to its whole process group with every worker stopped; a
SIGKILLed rank 0 takes its workers with it, even a worker that cannot
see the closed socket (stopped, as one inside an NCCL collective is
deaf to it); and the CLI's fleet of mesh replicas splices a stream cut
by a SIGKILL of replica 1's rank 0 into the JAX engine's stream.
"""
from __future__ import annotations

import dataclasses
import os
import pathlib
import signal
import subprocess
import sys
import threading
import time

import jax
import numpy as np
import pytest
from test_torch_frontdoor import (
    _call,
    _engine,
    _gen_tokens,
    _get_json,
    _parse_sse,
    _post,
    _ref_engine,
    _strip_rid,
    _wait,
)
from torch_parity import quantized_tree_numpy

from repro.configs import get_smoke_config as ref_smoke
from repro.data import make_calibration as ref_calibration
from repro.models import build_model
from repro.serve import CachedDecoder as RefDecoder
from repro.serve import Engine as RefEngine
from repro.serve import EngineConfig as RefEngineConfig
from repro.serve.frontdoor import FrontDoor as RefFrontDoor
from repro_torch import convert
from repro_torch.configs import ArchConfig
from repro_torch.serve.distributed import (
    DistributedCachedDecoder,
    MeshThreadError,
    make_serving_mesh,
    rank_launch_counts,
)
from repro_torch.serve.faults import parse_fault_plan
from repro_torch.serve.fleet import prefix_key, rendezvous_rank
from repro_torch.serve.fleet.supervisor import _descendants, _running
from repro_torch.serve.frontdoor import FrontDoor

ROOT = pathlib.Path(__file__).resolve().parents[1]
GEN = 8
PAGED = dict(paged_decode=True, paged_prefill=True)
ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
# seconds a SIGKILLed rank 0's workers may outlive it
REAP_S = 10.0


@pytest.fixture(scope="module")
def mesh():
    m = make_serving_mesh(1, 2, device="cpu")
    yield m
    m.close()


@pytest.fixture(scope="module")
def fp_params():
    """The JAX smoke model's fp params from ``PRNGKey(0)``: (JAX model,
    JAX params, port config, port params)."""
    cfg = ref_smoke("qwen3-14b")
    model = build_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    return (model, params, ArchConfig.from_dict(dataclasses.asdict(cfg)),
            convert.fp_params_from_numpy(jax.tree.map(np.asarray, params),
                                         device="cpu"))


@pytest.fixture(scope="module")
def fp(fp_params, mesh):
    """(JAX single-device decoder, port decoder on the mesh), fp."""
    model, params, pcfg, pp = fp_params
    return (RefDecoder.from_model(model, params),
            DistributedCachedDecoder.from_model(pcfg, pp, mesh=mesh))


@pytest.fixture(scope="module")
def quantized_pair():
    """The smoke model quantized to 2 bits by the JAX package: (JAX
    quantized model, the port's conversion of it)."""
    from repro.core.quantizer import QuipConfig
    from repro.launch.quantize import quantize_dense_model

    cfg = ref_smoke("qwen3-14b")
    params = build_model(cfg).init(jax.random.PRNGKey(0))
    calib = ref_calibration(cfg.vocab, n_segments=4, seg_len=32, seed=7)
    qm = quantize_dense_model(
        params, cfg, QuipConfig(bits=2, method="ldlq", use_kernel=False),
        calib.tokens, seed=0, verbose=False)
    return qm, convert.quantized_model_from_numpy(
        dataclasses.asdict(cfg), quantized_tree_numpy(qm), device="cpu")


@pytest.fixture(scope="module")
def quantized(quantized_pair, mesh):
    """(JAX single-device decoder, port decoder on the mesh), 2-bit."""
    qm, port = quantized_pair
    return (RefDecoder.from_quantized(qm),
            DistributedCachedDecoder.from_quantized(port, mesh=mesh))


@pytest.fixture(scope="module")
def prompts():
    return np.asarray(ref_calibration(256, n_segments=8, seg_len=8,
                                      seed=3).tokens, np.int32)


def _ref_serial(adapter, prompts, gen=GEN, **kw):
    """The JAX engine's streams with the requests one after another, as
    one HTTP client sends them."""
    eng = _ref_engine(adapter, gen=gen, **kw)
    out = []
    for p in prompts:
        req = eng.submit(np.asarray(p), max_new=gen)
        eng.run()
        out.append([int(t) for t in req.out_tokens])
    return out


# ---------------------------------------------------------------------------
# streams over the wire equal the JAX engine's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("weights", ["fp", "quantized"])
def test_http_streams_over_mesh_equal_jax(request, prompts, weights):
    """Eight greedy prompts from HTTP clients (SSE, one buffered) through
    the front door over the (1, 2) mesh: the JAX engine's streams exactly;
    ``/healthz`` 200 ``ok`` without a mesh key; a clean drain."""
    ref_a, tp_a = request.getfixturevalue(weights)
    want = _ref_serial(ref_a, prompts, **PAGED)
    fd = FrontDoor(_engine(tp_a, **PAGED),
                   drain_timeout_s=5.0).start_in_thread()
    try:
        got = [_gen_tokens(fd.port, p, GEN, stream=i != 5)
               for i, p in enumerate(prompts)]
        health = _get_json(fd.port, "/healthz")
    finally:
        report = fd.drain_and_join()
    assert got == want
    assert health[0] == 200 and health[1]["status"] == "ok"
    assert "mesh" not in health[1]
    assert report.clean and report.exit_code == 0


@pytest.mark.parametrize("body", [{}, {"temperature": 0.8, "top_p": 0.9,
                                       "seed": 7}], ids=["greedy", "sampled"])
def test_sse_frames_over_mesh_equal_the_jax_front_door(fp, prompts, body):
    """One request through the JAX front door (one device) and the port's
    over the mesh: the same status, headers and SSE frames (the
    per-process ``rid`` aside)."""
    knobs = dict(PAGED, device_sample=True)
    body = {"prompt": [int(t) for t in prompts[0]], "max_new": GEN, **body}
    outs = []
    for fd in (RefFrontDoor(_ref_engine(fp[0], **knobs)),
               FrontDoor(_engine(fp[1], **knobs))):
        fd.start_in_thread()
        try:
            outs.append(_call(fd.port, body))
        finally:
            assert fd.drain_and_join().clean
    (rs, rh, rraw), (s, h, raw) = outs
    assert (s, h) == (rs, rh) and s == 200
    assert _strip_rid(raw, True) == _strip_rid(rraw, True)


def test_speculative_int8_over_mesh_equals_jax(fp, prompts):
    """``--speculative 4`` over int8 pages behind the front door on the
    mesh: the JAX engine's streams, with drafts accepted (prompts of a
    repeated span)."""
    knobs = dict(PAGED, kv_int8=True, speculative_k=4)
    cyclic = [np.tile(p[:4], 2) for p in prompts[:4]]
    want = _ref_serial(fp[0], cyclic, **knobs)
    eng = _engine(fp[1], **knobs)
    fd = FrontDoor(eng, drain_timeout_s=5.0).start_in_thread()
    try:
        got = [_gen_tokens(fd.port, p, GEN) for p in cyclic]
    finally:
        report = fd.drain_and_join()
    assert got == want
    assert eng.summary()["accepted_tokens"] > 0
    assert report.clean


# ---------------------------------------------------------------------------
# the mesh's lifetime behind the front door
# ---------------------------------------------------------------------------


def _read_tokens(resp, n: int) -> bytes:
    raw = b""
    while raw.count(b"event: token") < n:
        line = resp.fp.readline()
        assert line, raw
        raw += line
    return raw


@pytest.mark.parametrize("when", ["idle", "busy"])
def test_dead_worker_turns_healthz_503(fp_params, when):
    """A worker killed while the engine idles, or while it streams: the
    next ``/healthz`` answers 503 ``mesh_broken`` with the mesh's reason
    (an idle tick sends the mesh nothing, so no watchdog would see it),
    and the drain ends without a hang: the cut request ends cancelled,
    its pages back in the pool."""
    _, _, pcfg, pp = fp_params
    with make_serving_mesh(1, 2, device="cpu") as m:
        eng = _engine(DistributedCachedDecoder.from_model(pcfg, pp, mesh=m),
                      gen=40, **PAGED,
                      faults=parse_fault_plan("replica_slow@ms=20,"
                                              "times=1000000"))
        fd = FrontDoor(eng, drain_timeout_s=1.0,
                       tick_stall_s=60.0).start_in_thread()
        c = None
        try:
            assert _gen_tokens(fd.port, list(range(1, 9)), 4) is not None
            assert _get_json(fd.port, "/healthz")[0] == 200
            if when == "busy":
                c, r = _post(fd.port, {"prompt": list(range(1, 9)),
                                       "max_new": 40})
                raw = _read_tokens(r, 2)
            m.procs[0].kill()
            m.procs[0].wait()
            status, health = _get_json(fd.port, "/healthz")
        finally:
            report = fd.drain_and_join(timeout=30)
        assert status == 503 and health["status"] == "mesh_broken"
        assert health["mesh"] == "rank 1 exited with code -9"
        if when == "busy":
            events = _parse_sse(raw + r.read())
            c.close()
            assert events[-1][0] == "done"
            assert events[-1][1]["finish_reason"] == "cancelled"
            assert eng.metrics.counter("tick_errors").value >= 1
        else:
            assert eng.metrics.counter("tick_errors").value == 0
        assert report.clean and report.exit_code == 0
        with pytest.raises(RuntimeError, match="rank 1 exited"):
            rank_launch_counts(m)


def test_mesh_call_from_a_second_thread_raises(mesh):
    """Mesh commands come from one thread: another thread's call raises
    :class:`MeshThreadError` and sends nothing, while ``drop_later``
    stays safe from any thread; ``adopt`` hands the mesh over."""
    rank_launch_counts(mesh)  # this thread sends the commands
    errors = []

    def other():
        try:
            rank_launch_counts(mesh)
        except MeshThreadError as e:
            errors.append(str(e))
        mesh.drop_later(10 ** 9)

    th = threading.Thread(target=other, name="intruder")
    th.start()
    th.join()
    assert len(errors) == 1 and "'intruder' may not" in errors[0]
    assert len(rank_launch_counts(mesh)) == 2  # the mesh still serves

    def adopter():
        mesh.adopt()
        errors.append(len(rank_launch_counts(mesh)))
        mesh.release()

    th = threading.Thread(target=adopter)
    th.start()
    th.join()
    assert errors[1] == 2 and mesh.broken_reason() is None


# ---------------------------------------------------------------------------
# the CLI: signals, a SIGKILLed controller, the fleet
# ---------------------------------------------------------------------------


def _spawn(argv, marker: str, timeout: float = 120.0):
    """A process in its own session, read until a line starts with
    ``marker``; returns (process, lines read)."""
    proc = subprocess.Popen(argv, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, env=ENV, cwd=ROOT,
                            text=True, start_new_session=True)
    lines = []
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        line = proc.stdout.readline()
        if not line:
            break
        lines.append(line)
        if line.startswith(marker):
            return proc, lines
    proc.kill()
    proc.wait()
    raise AssertionError("".join(lines))


def _killpg(proc) -> None:
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except ProcessLookupError:
        pass
    proc.wait()


def _all_gone(procs, timeout: float = REAP_S) -> bool:
    return _wait(lambda: not any(map(_running, procs)), timeout=timeout)


HTTP_MESH = [sys.executable, "-m", "repro_torch.launch.serve", "--smoke",
             "--device", "cpu", "--paged", "--paged-prefill", "--mesh", "1,2",
             "--http-port", "0"]


@pytest.mark.parametrize("how", ["sigterm", "sigint_group"])
def test_cli_http_mesh_drains_on_signal(how):
    """``--http-port 0 --mesh 1,2``: the mesh line, one request, then
    SIGTERM to rank 0 or SIGINT to the whole process group (a Ctrl-C):
    rank 0 drains through the leak gate and exits 0, and its worker, which
    ignores both signals, is stopped by rank 0 and gone after the exit."""
    proc, lines = _spawn(HTTP_MESH, "[frontdoor] listening on ")
    try:
        port = int(lines[-1].rsplit(":", 1)[1])
        workers = _descendants(proc.pid)
        assert len(workers) == 1
        assert len(_gen_tokens(port, list(range(1, 9)), GEN)) == GEN
        if how == "sigterm":
            proc.send_signal(signal.SIGTERM)
        else:
            os.killpg(proc.pid, signal.SIGINT)
        out, _ = proc.communicate(timeout=60)
    finally:
        _killpg(proc)
    out = "".join(lines) + out
    assert proc.returncode == 0, out
    assert any(ln.startswith("[serve] mesh data=1 model=2: KV pool ")
               for ln in lines)
    reason = "sigterm" if how == "sigterm" else "sigint"
    assert f"[serve] drain[{reason}] finished in" in out
    assert "leak gate: clean (0 leaked pages, 0 mapped slots)" in out
    assert "KeyboardInterrupt" not in out and "[mesh] rank" not in out
    assert not any(map(_running, workers))


BARE_MESH = ("import time\n"
             "from repro_torch.serve.distributed import make_serving_mesh\n"
             "m = make_serving_mesh(1, 2, device='cpu')\n"
             "print('worker', m.procs[0].pid, flush=True)\n"
             "time.sleep(600)\n")


@pytest.mark.parametrize("rank0", ["bare", "cli"])
def test_sigkilled_rank0_takes_its_workers(rank0):
    """SIGKILL of rank 0 — a bare ``make_serving_mesh`` and a CLI replica
    (``--http-port --mesh``) — leaves no worker within 10 s, also when
    the worker is SIGSTOPped and cannot see its closed socket (as a worker
    inside an NCCL collective waits on its peer, not on the socket)."""
    if rank0 == "bare":
        proc, _ = _spawn([sys.executable, "-c", BARE_MESH], "worker ")
    else:
        proc, _ = _spawn(HTTP_MESH, "[frontdoor] listening on ")
    workers = _descendants(proc.pid)
    try:
        assert len(workers) == 1
        os.kill(workers[0][0], signal.SIGSTOP)
        os.kill(proc.pid, signal.SIGKILL)
        proc.wait()
        assert _all_gone(workers)
    finally:
        for w in workers:
            if _running(w):
                os.kill(w[0], signal.SIGKILL)
        _killpg(proc)


def test_cli_fleet_of_mesh_replicas_and_rank0_kill_drill(quantized_pair,
                                                         tmp_path):
    """``--fleet 2 --mesh 1,2`` over a 2-bit artifact (the JAX package's
    quantization, converted): every replica a (1, 2) mesh.  A stream on
    replica 1 is cut by a SIGKILL of replica 1's rank 0 after 4 tokens;
    the client's stream goes on from replica 0, the spliced stream equals
    the JAX engine's, the killed mesh's worker is gone within 10 s,
    replica 1 comes back as generation 2 with a worker of its own and
    serves a later request (the JAX stream again), and SIGTERM drains the
    fleet with every leak gate clean."""
    from repro_torch.serve.artifacts import save_quantized

    qm, port_qm = quantized_pair
    art = tmp_path / "art"
    save_quantized(art, port_qm, {"bits": 2, "method": "ldlq"})
    gen, prompt_len = 24, 16
    rng = np.random.default_rng(0)
    on1 = [p for p in (rng.integers(0, 256, prompt_len) for _ in range(200))
           if rendezvous_rank(prefix_key(p), 2)[0] == 1][:2]
    ref_eng = RefEngine(RefDecoder.from_quantized(qm), RefEngineConfig(
        max_seq_len=prompt_len + gen, n_slots=8, page_size=16,
        token_budget=64, prefill_chunk=32, paged_decode=True,
        paged_prefill=True, device_sample=True))
    want = []
    for p in on1:
        req = ref_eng.submit(p, max_new=gen)
        ref_eng.run()
        want.append([int(t) for t in req.out_tokens])

    proc, lines = _spawn(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--load-quantized", str(art), "--paged", "--paged-prefill",
         "--mesh", "1,2", "--prompt-len", str(prompt_len), "--gen", str(gen),
         "--fault-plan", "replica_slow@ms=20,times=1000000",
         "--fleet", "2", "--probe-interval-s", "0.2",
         "--restart-backoff-s", "0.1"], "[router] listening on ", 180)
    try:
        port = int(lines[-1].split()[3].rsplit(":", 1)[1])

        def replica(i):
            return _get_json(port, "/fleetz")[1]["replicas"][i]

        assert _wait(lambda: replica(1)["state"] == "healthy", timeout=120)
        pid = replica(1)["pid"]
        workers = _descendants(pid)
        assert len(workers) == 1
        c, r = _post(port, {"prompt": [int(t) for t in on1[0]],
                            "max_new": gen})
        assert r.status == 200
        raw = _read_tokens(r, 4)
        os.kill(pid, signal.SIGKILL)
        raw += r.read()
        c.close()
        assert _all_gone(workers)
        events = _parse_sse(raw)
        toks = [d["token"] for ev, d in events if ev == "token"]
        assert [d["i"] for ev, d in events if ev == "token"] == \
            list(range(gen))
        assert toks == want[0] and events[-1][1]["tokens"] == want[0]
        assert _wait(lambda: replica(1)["generation"] == 2
                     and replica(1)["state"] == "healthy", timeout=120)
        fresh = _descendants(replica(1)["pid"])
        assert len(fresh) == 1 and fresh[0] not in workers
        assert _gen_tokens(port, on1[1], gen) == want[1]
        fz = _get_json(port, "/fleetz")[1]
        assert fz["router"]["failovers"] == 1
        assert fz["replicas"][1]["served"] == 1
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=90)
    finally:
        _killpg(proc)
    out = "".join(lines) + out
    assert proc.returncode == 0, out
    assert "fleet leak gates: clean on every drained replica" in out
    assert "replica 1: state=drained served=1 restarts=1 exit=0" in out
    assert not any(map(_running, fresh))
