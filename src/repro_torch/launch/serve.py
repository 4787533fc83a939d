"""Serving driver: continuous-batching engine over paged KV caches.

    # convert a JAX-package artifact once (tests/test_torch_engine.py shows
    # how), then serve it:
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke \\
        --load-quantized /tmp/port_art --paged --paged-prefill --check
    # or quantize in process first (QuIP, LDLQ, Kronecker transforms):
    PYTHONPATH=src python -m repro_torch.launch.serve --arch starcoder2-15b \\
        --smoke --quantize --bits 2 --paged --paged-prefill --check
    # speculative decode (n-gram drafts, the prefill kernel as verifier),
    # and sampled decoding:
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --paged \\
        --paged-prefill --speculative 4 --check
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --paged \\
        --temperature 0.8 --top-p 0.9 --sample-seed 3

Requests arrive staggered (``--arrival-gap``), join the decode batch while
earlier requests are mid-generation, and decode through the KV-cached
adapter — for quantized models the packed ``D⁻¹ → V → quant_matmul → Uᵀ``
path.  ``--paged`` decodes in place over the page pool (paged-attention
kernel); ``--paged-prefill`` runs each tick's prefill chunks as one batched
dispatch over the pool (chunked-prefill kernel).  ``--prefix-cache`` maps
cached full prompt pages into new requests (refcounted, copy-on-write);
``--kv-int8`` stores the pages int8.  ``--stop-token``, ``--deadline-s``,
``--max-queue`` and ``--tenants`` set the request lifecycle.
``--temperature``, ``--top-p`` and ``--sample-seed`` (request i draws
from seed ``sample_seed + i``) sample instead of the greedy argmax, on the
device inside the paged dispatch unless ``--host-sample``;
``--speculative K`` (with ``--paged``) drafts up to K tokens per lane
(``--draft ngram``) and verifies them in one dispatch.  ``--fault-plan``
injects faults (``serve/faults.py``) and ``--screen-logits`` quarantines a
lane whose logits carry NaN/Inf; ``--trace-out`` (``--trace-sync``) writes
a Chrome/Perfetto trace of the engine's spans and ``--metrics-every``
prints metric snapshots; ``--canary-every`` / ``--canary-prompts`` /
``--canary-len`` and ``--shadow-rate`` run the quality canaries, and
``--quality-baseline`` (``--quality-threshold``, ``--quality-strict``)
audits a loaded artifact's quality section.  ``--mesh DP,MP`` serves
tensor-parallel (``serve/distributed.py``): this process is rank 0 and
starts the other ranks itself; packed codes, the KV pool and attention
shard over the model axis; the other ranks ignore SIGINT and SIGTERM
and die with this one.  ``--http-port PORT`` serves over HTTP/SSE
instead of the fixed workload (``serve/frontdoor/``: ``POST
/v1/generate``, ``/healthz``, ``/readyz``, ``/metricsz``; SIGTERM/SIGINT
drain through the leak gate, ``--drain-timeout-s``, ``--tick-stall-s``,
``--no-ladder``), with ``--mesh`` too: the engine thread sends the
mesh's commands, ``/healthz`` answers 503 once a rank is gone, and the
mesh closes after the drain; ``--fleet N`` serves N such replica
processes of this CLI behind one supervised router on ``--router-port``
(``serve/fleet/``: prefix affinity, typed rejections passed through,
journaled mid-stream failover with ``--probe-interval-s``,
``--max-restarts``, ``--restart-backoff-s``, and ``--replica-fault
IDX:SPEC`` arming a fault plan on one replica's first incarnation, e.g.
``'1:replica_kill@tick=40'``); with ``--mesh DP,MP`` every replica is a
mesh of its own (the fleet parent builds none), and a replica killed or
restarted takes its ranks with it.  ``--check``
verifies the engine's greedy tokens against an oracle — the full-prefix
recompute for quantized weights, ``Model.prefill``/``decode_step`` over a
dense batch cache (``greedy_generate``) for fp weights, with
``--kv-int8`` a gather-dense engine over the same int8 pages, on one
device also under ``--mesh`` — and exits nonzero on divergence; every run
exits nonzero if a page or slot is still held after the drain.

The engine serves the dense family.  The moe, rwkv and hybrid archs
(``--arch arctic-480b``, ``llama4-scout-17b-a16e``, ``rwkv6-1.6b``,
``zamba2-7b``) serve one fixed batch through ``greedy_generate`` instead
(the batch fallback), and refuse ``--quantize``, ``--check`` and
``--mesh`` as the JAX package's CLI does.  whisper-small and
llama-3.2-vision-90b exit with the reason: their stub frontends need
``frames`` / ``patches`` embeddings, which the CLI does not take (the JAX
CLI fails at the same point with a ``KeyError``).

Runs on the GPU (``--device cuda``, the default) through the hand-written
kernels, or on the CPU (``--device cpu``) through their plain versions.
Asking for ``cuda`` where there is none is an error, never a fallback.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.data.synthetic import make_calibration
from repro_torch.device import resolve_device

__all__ = ["resolve_device", "greedy_generate", "quantized_generate",
           "quantize_in_process", "build_engine", "main"]

# flags of the fleet parent (router and supervisor) that must not reach a
# replica process; --http-port/--http-host go too, since the factory
# appends fresh ones per spawn
_FLEET_ONLY_FLAGS = frozenset((
    "--fleet", "--router-port", "--probe-interval-s", "--max-restarts",
    "--restart-backoff-s", "--replica-fault", "--http-port",
    "--http-host",
))


def _replica_argv(argv: list) -> list:
    """A replica's command tail: ``argv`` without the fleet-only flags
    (``--flag value`` and ``--flag=value``).  Flags must be spelled out in
    full on a fleet command line: an argparse abbreviation would slip
    past this filter."""
    out, i = [], 0
    while i < len(argv):
        arg = argv[i]
        if arg.split("=", 1)[0] in _FLEET_ONLY_FLAGS:
            i += 1 if "=" in arg else 2
            continue
        out.append(arg)
        i += 1
    return out


def quantize_in_process(params: dict, cfg, *, bits: int, seed: int,
                        verbose: bool = False):
    """``--quantize``: QuIP over fp params in this process, as the JAX
    package's serve driver runs it — ``QuipConfig(bits, method="ldlq")``
    (Kronecker transforms), 8 x 64 calibration tokens drawn with seed
    ``seed + 7`` — returning the ``QuantizedModel`` to serve."""
    from repro_torch.core.quantizer import QuipConfig
    from repro_torch.launch.quantize import quantize_dense_model

    calib = make_calibration(cfg.vocab, n_segments=8, seg_len=64,
                             seed=seed + 7)
    qcfg = QuipConfig(bits=bits, method="ldlq", use_kernel=False)
    return quantize_dense_model(params, cfg, qcfg, calib, seed=seed,
                                verbose=verbose)


@torch.no_grad()
def greedy_generate(model, params, prompt: torch.Tensor, gen: int,
                    kv_dtype=None) -> torch.Tensor:
    """Reference fp path: ``Model.prefill`` + ``decode_step`` over the
    dense batch cache (the oracle of an fp ``--check``, and how the
    non-dense families serve)."""
    B, S = prompt.shape
    logits, cache = model.prefill(params, {"tokens": prompt},
                                  kv_dtype=kv_dtype, max_len=S + gen)
    toks = [torch.argmax(logits, -1)[:, None]]
    for i in range(gen - 1):
        logits, cache = model.decode_step(params, toks[-1], cache, S + i)
        toks.append(torch.argmax(logits, -1)[:, None])
    return torch.cat(toks, dim=1)


@torch.no_grad()
def quantized_generate(qm, prompt: torch.Tensor, gen: int) -> torch.Tensor:
    """Reference recompute path: full-prefix forward per token (O(S^2) per
    token — the equivalence oracle for the engine's cached decode), in
    plain PyTorch, so it checks the engine's kernels."""
    toks = prompt
    for _ in range(gen):
        logits = qm.logits(toks, plain=True)[:, -1]
        toks = torch.cat([toks, torch.argmax(logits, -1)[:, None]
                          .to(toks.dtype)], dim=1)
    return toks[:, prompt.shape[1]:]


def build_engine(adapter, *, max_seq_len: int, args, record_logits=False,
                 paged=None, paged_prefill=None, prefix_cache=None,
                 speculative=None, robust=True, tenants=None, faults=None):
    """The engine the flags in ``args`` describe.  ``robust=False`` builds
    a reference oracle: no deadlines, queue bound, tenants, fault plan,
    logit screen or quality probes, so it finishes every request."""
    from repro_torch.serve.engine import Engine, EngineConfig

    paged = args.paged if paged is None else paged
    ecfg = EngineConfig(
        max_seq_len=max_seq_len,
        n_slots=args.slots,
        page_size=args.page_size,
        n_pages=args.pages,
        token_budget=args.token_budget,
        prefill_chunk=args.prefill_chunk,
        paged_decode=paged,
        paged_prefill=(args.paged_prefill if paged_prefill is None
                       else paged_prefill),
        prefix_cache=(getattr(args, "prefix_cache", False)
                      if prefix_cache is None else prefix_cache),
        kv_int8=getattr(args, "kv_int8", False),
        speculative_k=(getattr(args, "speculative", 0) if speculative is None
                       else speculative),
        draft=getattr(args, "draft", "ngram"),
        # the device draw is the paged path's default; --host-sample keeps
        # the host's numpy draw
        device_sample=paged and not getattr(args, "host_sample", False),
        record_logits=record_logits,
        deadline_s=getattr(args, "deadline_s", None) if robust else None,
        max_queue=getattr(args, "max_queue", None) if robust else None,
        tenants=tenants if robust else None,
        screen_logits=(getattr(args, "screen_logits", False) if robust
                       else False),
        canary_every=getattr(args, "canary_every", None) if robust else None,
        shadow_rate=getattr(args, "shadow_rate", 0.0) if robust else 0.0,
        shadow_seed=getattr(args, "seed", 0),
    )
    return Engine(adapter, ecfg, faults=faults if robust else None)


# families whose batch carries stub frontend embeddings beside the tokens
_EMBEDDED = {"encdec": "frames", "vlm": "patches"}


def _serve_batch_fallback(model, params, prompts, args) -> int:
    """Non-dense families: the engine adapter is dense-only; serve one
    fixed batch through the family's own ``Model.prefill`` /
    ``decode_step`` path."""
    device = params["embed"]["tok"].device
    t0 = time.time()
    out = greedy_generate(model, params,
                          torch.as_tensor(prompts, device=device),
                          args.gen).cpu()
    dt = time.time() - t0
    total = out.shape[0] * out.shape[1]
    print(f"[serve] fp {model.cfg.name} (batch fallback, family="
          f"{model.cfg.family}): {total} tokens in {dt:.2f}s "
          f"({total/dt:.1f} tok/s)")
    return 0


def _audit_quality(meta: dict, args) -> None:
    """``--quality-baseline``: compare the loaded artifact's quality section
    with the baseline; print each regressed layer, and refuse to serve on
    any under ``--quality-strict``."""
    from repro_torch.serve.quality import check_artifact_quality, load_baseline

    try:
        baseline = load_baseline(args.quality_baseline)
    except (FileNotFoundError, ValueError) as e:
        raise SystemExit(f"--quality-baseline: {e}")
    regressions = check_artifact_quality(meta.get("quality"), baseline,
                                         threshold=args.quality_threshold)
    for r in regressions:
        cur = ("missing" if r["current"] is None
               else format(r["current"], ".4g"))
        print(f"[serve] QUALITY REGRESSION {r['layer']}: proxy "
              f"{r['baseline']:.4g} -> {cur} "
              f"(> {args.quality_threshold:.2f}x baseline)")
    if regressions and args.quality_strict:
        raise SystemExit(
            f"refusing to serve: {len(regressions)} layer(s) regressed "
            f"beyond {args.quality_threshold:.2f}x the quality baseline "
            f"(drop --quality-strict to serve anyway)")
    if not regressions:
        print(f"[serve] quality baseline OK "
              f"({len(baseline['proxy_loss'])} layers within "
              f"{args.quality_threshold:.2f}x)")


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-14b", choices=ARCHS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=6,
                    help="number of concurrent requests to serve")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--arrival-gap", type=float, default=0.02,
                    help="stagger between request arrivals (s)")
    ap.add_argument("--quantize", action="store_true",
                    help="run the QuIP pipeline in-process before serving")
    ap.add_argument("--load-quantized", default=None, metavar="DIR",
                    help="serve packed weights from a port artifact "
                         "(repro_torch.serve.artifacts format)")
    ap.add_argument("--bits", type=int, default=2)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--pages", type=int, default=None,
                    help="physical KV pages (default: no overcommit)")
    ap.add_argument("--token-budget", type=int, default=64)
    ap.add_argument("--prefill-chunk", type=int, default=32)
    ap.add_argument("--paged", action="store_true",
                    help="decode in place over the page pool (paged-"
                         "attention kernel) instead of the gather-dense "
                         "oracle")
    ap.add_argument("--paged-prefill", action="store_true",
                    help="prefill as ONE batched cross-request dispatch per "
                         "engine tick over the page pool (chunked-prefill "
                         "kernel) instead of a B=1 gather-dense loop")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="trie prompt-prefix cache over full KV pages: "
                         "identical prompt prefixes are admitted with their "
                         "pages mapped (refcounted, copy-on-write), not "
                         "recomputed")
    ap.add_argument("--kv-int8", action="store_true",
                    help="store KV pages int8 with per-(token, head) scales")
    ap.add_argument("--speculative", type=int, default=0, metavar="K",
                    help="speculative decode (needs --paged): draft up to "
                         "K tokens per lane per tick and verify them in one "
                         "(B, K+1) dispatch through the chunked-prefill "
                         "kernel; rejected drafts' K/V is rolled back")
    ap.add_argument("--draft", default="ngram", choices=("ngram",),
                    help="self-drafter for --speculative (ngram = prompt "
                         "lookup over each lane's own token history)")
    ap.add_argument("--mesh", default=None, metavar="DP,MP",
                    help="serve tensor-parallel over a (data, model) mesh of "
                         "processes: packed weights + KV page pool + paged "
                         "attention shard over the model axis "
                         "(serve/distributed.py)")
    ap.add_argument("--host-sample", action="store_true",
                    help="draw tokens on the host (numpy softmax/top-p) "
                         "instead of on the device inside the paged "
                         "dispatch")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature (0 = greedy, the default)")
    ap.add_argument("--top-p", type=float, default=1.0,
                    help="nucleus sampling mass (with --temperature > 0)")
    ap.add_argument("--sample-seed", type=int, default=0,
                    help="per-request sampling seed base")
    ap.add_argument("--stop-token", type=int, action="append", default=None,
                    help="finish a request when it emits this token "
                         "(repeatable)")
    ap.add_argument("--deadline-s", type=float, default=None, metavar="SECS",
                    help="per-request deadline from arrival, enforced at "
                         "tick boundaries; an expired request FAILS with "
                         "finish_reason 'deadline'")
    ap.add_argument("--max-queue", type=int, default=None, metavar="N",
                    help="bounded admission queue: submits past N pending "
                         "requests are rejected (retryable)")
    ap.add_argument("--tenants", default=None, metavar="SPEC",
                    help="per-tenant admission policies, comma-separated "
                         "'name:rate:burst:priority' (rate in req/s, empty "
                         "or 'inf' = unlimited; priority 0 = highest), "
                         "e.g. 'paid:inf:4:0,free:2.0:4:1'")
    ap.add_argument("--http-port", type=int, default=None, metavar="PORT",
                    help="serve over HTTP/SSE instead of the fixed batch: "
                         "start the asyncio front door on this port (0 = "
                         "ephemeral), POST /v1/generate + healthz/readyz/"
                         "metricsz; SIGTERM/SIGINT drain gracefully")
    ap.add_argument("--http-host", default="127.0.0.1",
                    help="front-door bind address (default 127.0.0.1)")
    ap.add_argument("--drain-timeout-s", type=float, default=5.0,
                    metavar="SECS",
                    help="graceful-drain budget: in-flight lanes past this "
                         "get cancelled (pages still released exactly)")
    ap.add_argument("--tick-stall-s", type=float, default=10.0,
                    metavar="SECS",
                    help="tick-stall watchdog threshold: /healthz flips "
                         "to 503 'wedged' when the engine has not "
                         "COMPLETED a tick in this long (the supervisor "
                         "hard-restarts wedged replicas)")
    ap.add_argument("--fleet", type=int, default=None, metavar="N",
                    help="serve N data-parallel replica processes (each "
                         "this CLI + an ephemeral --http-port) behind "
                         "one supervised router; implies HTTP serving")
    ap.add_argument("--router-port", type=int, default=0, metavar="PORT",
                    help="fleet router bind port (0 = ephemeral; with "
                         "--fleet)")
    ap.add_argument("--probe-interval-s", type=float, default=0.5,
                    metavar="SECS",
                    help="supervisor health-probe period (with --fleet)")
    ap.add_argument("--max-restarts", type=int, default=3, metavar="N",
                    help="give-up circuit breaker: park a replica slot "
                         "as 'gone' after N restarts (with --fleet)")
    ap.add_argument("--restart-backoff-s", type=float, default=0.5,
                    metavar="SECS",
                    help="base restart backoff, doubling per restart "
                         "(with --fleet)")
    ap.add_argument("--replica-fault", action="append", default=None,
                    metavar="IDX:SPEC",
                    help="arm a --fault-plan SPEC on replica IDX's FIRST "
                         "incarnation only (repeatable; with --fleet) — "
                         "e.g. '1:replica_kill@tick=40' for a crash "
                         "drill whose respawn comes back clean")
    ap.add_argument("--no-ladder", action="store_true",
                    help="disable the load-shedding degradation ladder "
                         "(spec K shrink -> spec off -> shed lowest class)")
    ap.add_argument("--fault-plan", default=None, metavar="SPEC",
                    help="deterministic fault injection for chaos drills: "
                         "'kind[@key=val,...][;rule...]' with kinds "
                         "alloc_fail|pool_exhausted|nan_logits|"
                         "dispatch_error|corrupt_shard|cancel and keys "
                         "tick/rid/shard/times, e.g. "
                         "'alloc_fail@rid=0;cancel@rid=4,tick=6'")
    ap.add_argument("--screen-logits", action="store_true",
                    help="NaN/Inf-screen every step's logits per lane (one "
                         "device reduction); a poisoned lane is quarantined "
                         "(FAILS with finish_reason='nan_logits'), "
                         "co-batched lanes decode on unharmed")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="record per-tick spans (step phases, dispatches, "
                         "request lifecycle events) and write a "
                         "Chrome/Perfetto trace-event JSON here")
    ap.add_argument("--trace-sync", action="store_true",
                    help="synchronize the card at span edges so span "
                         "durations include device time (needs "
                         "--trace-out; slows serving)")
    ap.add_argument("--metrics-every", type=float, default=None,
                    metavar="SECS",
                    help="print a one-line metrics snapshot (counters, pool "
                         "occupancy, TTFT/ITL/e2e p50+p99) to stderr every "
                         "SECS seconds of engine time")
    ap.add_argument("--canary-every", type=float, default=None,
                    metavar="SECS",
                    help="teacher-forced NLL probe over a pinned canary "
                         "prompt set every SECS seconds (plus once at run "
                         "start), out of band over the dense trunk")
    ap.add_argument("--canary-prompts", type=int, default=2,
                    help="canary set size (pinned sequences per probe)")
    ap.add_argument("--canary-len", type=int, default=16,
                    help="canary sequence length (tokens)")
    ap.add_argument("--shadow-rate", type=float, default=0.0, metavar="F",
                    help="re-score this deterministic fraction of finished "
                         "requests against the dense trunk (max-abs-logit-"
                         "diff and token-flip-rate histograms; crc32 "
                         "selection)")
    ap.add_argument("--quality-baseline", default=None, metavar="PATH",
                    help="with --load-quantized: compare the artifact's "
                         "quality section against this baseline JSON "
                         "(launch/quality_report.py --write-baseline) and "
                         "warn on proxy-loss regressions")
    ap.add_argument("--quality-threshold", type=float, default=1.2,
                    help="regression ratio for --quality-baseline "
                         "(default 1.2x)")
    ap.add_argument("--quality-strict", action="store_true",
                    help="refuse to serve (exit nonzero) on any "
                         "--quality-baseline regression instead of warning")
    ap.add_argument("--check", action="store_true",
                    help="verify engine tokens against the recompute path")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--seed", type=int, default=0)
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    from repro_torch.serve.faults import parse_fault_plan

    faults = None
    if args.fault_plan:
        try:
            faults = parse_fault_plan(args.fault_plan)
        except ValueError as e:
            raise SystemExit(f"--fault-plan: {e}")
    tenants = None
    if args.tenants:
        from repro_torch.serve.frontdoor.admission import parse_tenants

        try:
            tenants = parse_tenants(args.tenants)
        except ValueError as e:
            raise SystemExit(f"--tenants: {e}")
    if args.http_port is not None and args.check:
        raise SystemExit(
            "--check drives a fixed in-process workload; the HTTP front "
            "door serves whatever clients send — drop one of the two")
    if args.speculative and not args.paged:
        raise SystemExit(
            "--speculative verifies drafts over the paged pool (the "
            "chunked-prefill kernel path); add --paged")
    if args.speculative < 0:
        raise SystemExit(f"--speculative must be >= 0, got {args.speculative}")
    if args.temperature == 0 and args.top_p < 1.0:
        raise SystemExit(
            "--top-p only applies to non-greedy decoding; pass "
            "--temperature > 0 (temperature 0 is exact greedy argmax)")
    if args.check and args.temperature > 0:
        raise SystemExit(
            "--check verifies greedy tokens against a greedy oracle; "
            "drop --temperature (or --check)")
    if args.check and args.stop_token:
        raise SystemExit(
            "--check compares full fixed-length token streams; the "
            "references don't model early stop — drop --stop-token")
    if args.trace_sync and not args.trace_out:
        raise SystemExit(
            "--trace-sync sharpens span timing for a recorded trace; "
            "add --trace-out PATH")
    if not 0.0 <= args.shadow_rate <= 1.0:
        raise SystemExit(
            f"--shadow-rate must be in [0, 1], got {args.shadow_rate}")
    if args.canary_every is not None and args.canary_every <= 0:
        raise SystemExit(
            f"--canary-every must be > 0 seconds, got {args.canary_every}")
    if args.quality_baseline and not args.load_quantized:
        raise SystemExit(
            "--quality-baseline audits an artifact's quality manifest; "
            "add --load-quantized DIR (quantize with --out-dir first)")
    if args.quality_strict and not args.quality_baseline:
        raise SystemExit(
            "--quality-strict needs a baseline to enforce; add "
            "--quality-baseline PATH")
    if args.fleet is None:
        for flag, val, default in (
                ("--router-port", args.router_port, 0),
                ("--replica-fault", args.replica_fault, None)):
            if val != default:
                raise SystemExit(f"{flag} only applies to a replica "
                                 f"fleet; add --fleet N")
    else:
        if args.fleet < 1:
            raise SystemExit(f"--fleet needs >= 1 replica, got {args.fleet}")
        if args.check:
            raise SystemExit(
                "--check drives a fixed in-process workload; --fleet "
                "serves HTTP replicas — drop one of the two")
        if args.http_port is not None:
            raise SystemExit(
                "--fleet assigns each replica its own ephemeral "
                "--http-port; use --router-port for the client-facing "
                "port")
    if args.check and args.kv_int8 and not (args.paged or args.paged_prefill):
        raise SystemExit(
            "--kv-int8 --check needs --paged (and/or --paged-prefill): "
            "int8 pages are lossy vs the dense references, so the only "
            "independent oracle is the gather-dense engine over the same "
            "int8 page contents — without a paged path that oracle IS the "
            "engine under test")
    if args.fleet is not None:
        return _serve_fleet(args, argv)
    device = resolve_device(args.device)
    if args.mesh and not args.load_quantized and (
            get_smoke_config(args.arch) if args.smoke
            else get_config(args.arch)).family != "dense":
        raise SystemExit(
            "--mesh drives the dense-family engine adapter; other "
            "families serve through the batch fallback (single device)")
    mesh = None
    if args.mesh:
        from repro_torch.serve.distributed import make_serving_mesh

        try:
            dp, mp = (int(x) for x in args.mesh.split(","))
        except ValueError:
            raise SystemExit(f"--mesh expects DP,MP (e.g. 1,2), "
                             f"got {args.mesh!r}")
        try:
            mesh = make_serving_mesh(dp, mp, device=device)
        except ValueError as e:
            raise SystemExit(f"--mesh: {e}")
        print(f"[serve] {mesh.describe()}")
    try:
        return _serve(args, device, faults, tenants, mesh)
    finally:
        if mesh is not None:
            mesh.close()


def _serve_fleet(args, argv) -> int:
    """The fleet parent: builds no model; spawns ``--fleet`` replica
    copies of this CLI (fleet flags stripped, a fresh ``--http-port`` per
    spawn) and serves the router in front of them until a drain."""
    import asyncio

    from repro_torch.serve.faults import parse_fault_plan
    from repro_torch.serve.fleet import (
        FleetRouter,
        ProcessReplicaFactory,
        Supervisor,
        replica_command,
    )

    first_spawn: dict[int, list] = {}
    for spec in args.replica_fault or ():
        idx_s, sep, plan = spec.partition(":")
        if not sep or not idx_s.isdigit():
            raise SystemExit(f"--replica-fault expects IDX:SPEC, got {spec!r}")
        idx = int(idx_s)
        if not 0 <= idx < args.fleet:
            raise SystemExit(
                f"--replica-fault: replica {idx} out of range for "
                f"--fleet {args.fleet}")
        try:  # validated here, where the error is attributable
            parse_fault_plan(plan)
        except ValueError as e:
            raise SystemExit(f"--replica-fault {spec!r}: {e}")
        first_spawn.setdefault(idx, []).extend(["--fault-plan", plan])
    tail = _replica_argv(list(argv) if argv is not None else sys.argv[1:])
    factory = ProcessReplicaFactory(replica_command(tail),
                                    host=args.http_host,
                                    first_spawn_args=first_spawn)
    sup = Supervisor(factory, args.fleet, host=args.http_host,
                     probe_interval_s=args.probe_interval_s,
                     max_restarts=args.max_restarts,
                     backoff_base_s=args.restart_backoff_s,
                     replica_drain_timeout_s=args.drain_timeout_s + 30.0)
    router = FleetRouter(sup, host=args.http_host, port=args.router_port,
                         drain_timeout_s=args.drain_timeout_s)
    report = asyncio.run(router.serve_forever())
    return report.exit_code


def _serve_http(args, engine, tracer) -> int:
    """``--http-port``: the front door over ``engine`` until SIGTERM or
    SIGINT drains it; the exit code is the leak gate's."""
    import asyncio

    from repro_torch.serve.frontdoor import FrontDoor

    fd = FrontDoor(engine, host=args.http_host, port=args.http_port,
                   drain_timeout_s=args.drain_timeout_s,
                   ladder=not args.no_ladder, tick_stall_s=args.tick_stall_s)
    report = asyncio.run(fd.serve_forever())
    s = engine.summary()
    for line in report.lines():
        print(f"[serve] {line}")
    fin = " ".join(f"{k}={v}" for k, v in sorted(s.items())
                   if k.startswith("finish:"))
    if fin:
        print(f"[serve] finish reasons: {fin}")
    print(f"[serve] http: requests={s['http_requests']} "
          f"rejections={s['http_rejections']} "
          f"shed={s['shed_requests']} "
          f"disconnects={s['client_disconnects']} "
          f"ladder_escalations={s.get('ladder_escalations', 0)} "
          f"ladder_deescalations={s.get('ladder_deescalations', 0)}")
    if s["tick_errors"]:
        print(f"[serve] tick_errors={s['tick_errors']}: ticks raised and "
              f"were skipped")
    if tracer is not None:
        tracer.export_chrome_trace(args.trace_out)
        print(f"[serve] trace: {len(tracer)} spans -> {args.trace_out}")
    return report.exit_code


def _serve(args, device, faults, tenants, mesh) -> int:
    from repro_torch.launch.quantize import fp_model
    from repro_torch.serve.adapter import CachedDecoder
    from repro_torch.serve.artifacts import ArtifactCorruption, load_quantized
    from repro_torch.serve.distributed import DistributedCachedDecoder
    from repro_torch.serve.faults import AdmissionRejected
    from repro_torch.serve.scheduler import RequestState, SamplingParams

    adapter = qm = fp_ref = None
    if args.load_quantized:
        try:
            if mesh is not None:
                # every rank slices its packed codes on the host; the
                # single-device copy is the --check oracle's
                adapter, meta = DistributedCachedDecoder.load(
                    args.load_quantized, mesh=mesh, load_faults=faults)
                if args.check:
                    qm, _ = load_quantized(args.load_quantized,
                                           device=device)
            else:
                qm, meta = load_quantized(args.load_quantized, device=device,
                                          faults=faults)
        except ArtifactCorruption as e:
            raise SystemExit(f"--load-quantized: {e}")
        except (FileNotFoundError, ValueError, KeyError) as e:
            raise SystemExit(
                f"--load-quantized: {e} (expected a port artifact directory)")
        cfg = adapter.cfg if qm is None else qm.cfg
        label = f"quip-{meta['quip_config']['bits']}bit[artifact]"
        print(f"[serve] loaded quantized artifact: {cfg.name} "
              f"{meta['quip_config']['bits']}-bit ({args.load_quantized})")
        if args.quality_baseline:
            _audit_quality(meta, args)
    else:
        from repro_torch.models.lm import build_model

        cfg = get_smoke_config(args.arch) if args.smoke else get_config(
            args.arch)
        if cfg.family in _EMBEDDED:
            raise SystemExit(
                f"--arch {args.arch}: the {cfg.family} family's stub "
                f"frontend needs {_EMBEDDED[cfg.family]} embeddings beside "
                f"the prompt tokens, which this CLI does not take; drive "
                f"it through Model.prefill / decode_step (models/lm.py)")
        model = build_model(cfg)
        g = torch.Generator(device=device)
        g.manual_seed(args.seed)
        params = model.init(g, device=device)
        if cfg.family != "dense":
            if args.quantize:
                raise SystemExit(
                    "--quantize drives the dense family; per-layer "
                    "quantization for other families goes through "
                    "repro.core.quantize_layer directly")
            if args.check:
                raise SystemExit(
                    "--check verifies the engine against the reference "
                    "decode path, but non-dense families serve THROUGH "
                    "that reference path (engine adapter is dense-only; "
                    "ROADMAP open item) — nothing to check")
            prompts = make_calibration(
                cfg.vocab, n_segments=args.requests,
                seg_len=args.prompt_len, seed=args.seed + 3)
            return _serve_batch_fallback(model, params, prompts, args)
        if args.quantize:
            # full fp32 products: TF32 would move the codes
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            qm = quantize_in_process(params, cfg, bits=args.bits,
                                     seed=args.seed)
            label = f"quip-{args.bits}bit"
            if mesh is not None:
                adapter = DistributedCachedDecoder.from_quantized(qm,
                                                                  mesh=mesh)
        else:
            qm = fp_model(params, cfg)
            label = "fp"
            fp_ref = (model, params)
            if mesh is not None:
                adapter = DistributedCachedDecoder.from_model(cfg, params,
                                                              mesh=mesh)
    if adapter is None:
        adapter = CachedDecoder.from_quantized(qm)

    prompts = make_calibration(cfg.vocab, n_segments=args.requests,
                               seg_len=args.prompt_len, seed=args.seed + 3)
    max_seq_len = args.prompt_len + args.gen
    engine = build_engine(adapter, max_seq_len=max_seq_len, args=args,
                          tenants=tenants, faults=faults)
    if args.canary_every is not None:
        # pinned off the traffic seed stream: the canary set stays fixed
        # across runs, so the NLL gauge is comparable
        engine.attach_canary(make_calibration(
            cfg.vocab, n_segments=args.canary_prompts,
            seg_len=args.canary_len, seed=args.seed + 1234))
    tracer = None
    if args.trace_out:
        from repro_torch.serve.telemetry import Tracer

        tracer = Tracer(sync=args.trace_sync)
        engine.attach_tracer(tracer)
    if mesh is not None:
        pool = engine.pool
        print(f"[serve] mesh data={mesh.dp} model={mesh.mp}: KV pool "
              f"{pool.total_bytes()} B total, {pool.device_bytes()} B/device")
    if args.http_port is not None:
        return _serve_http(args, engine, tracer)
    stop_tokens = tuple(args.stop_token or ())
    try:  # bad sampling flags fail here, not as a capacity error below
        sampling = [SamplingParams(temperature=args.temperature,
                                   top_p=args.top_p,
                                   seed=args.sample_seed + i)
                    for i in range(args.requests)]
    except ValueError as e:
        raise SystemExit(f"bad sampling flags: {e}")
    submitted = []  # (prompt index, request) of accepted submissions
    for i in range(args.requests):
        try:
            req = engine.submit(prompts[i], max_new=args.gen,
                                arrival=i * args.arrival_gap,
                                sampling=sampling[i],
                                stop_tokens=stop_tokens)
        except AdmissionRejected as e:
            if e.retryable:
                # backpressure: a client would retry later; the fixed
                # workload reports it and goes on
                print(f"[serve] request {i} rejected (retryable): {e}")
                continue
            raise SystemExit(f"cannot admit request: {e} (grow --pages / "
                             f"--page-size or shrink --gen)")
        submitted.append((i, req))
    engine.reset_clock()
    t0 = time.perf_counter()
    done = engine.run(metrics_every=args.metrics_every)
    engine._sync_barrier()
    dt = time.perf_counter() - t0
    s = engine.summary()
    total = sum(len(r.out_tokens) for r in done)
    print(f"[serve] {label} {cfg.name} on {device.type}: {len(done)} "
          f"requests, {total} tokens in {dt:.2f}s ({total / dt:.1f} tok/s)")
    n_fin = sum(1 for r in done if r.state is RequestState.FINISHED)
    n_can = sum(1 for r in done if r.state is RequestState.CANCELLED)
    n_fail = sum(1 for r in done if r.state is RequestState.FAILED)
    outcome = (f"[serve] outcomes: finished={n_fin} cancelled={n_can} "
               f"failed={n_fail}")
    if n_fail:
        reasons: dict[str, int] = {}
        for r in done:
            if r.state is RequestState.FAILED:
                reasons[r.finish_reason] = reasons.get(r.finish_reason, 0) + 1
        outcome += f" reasons={reasons}"
    print(outcome)
    if faults is not None:
        print(f"[serve] faults injected: {len(faults.log)} "
              f"({'; '.join(e['kind'] for e in faults.log)})")
    # every page must be back; the prefix trie keeps its own references
    leaked = engine.pool.pages_in_use - engine.pool.cached_pages
    if leaked != 0 or engine.pool._slots:
        print(f"[serve] FAIL: {leaked} leaked pages, "
              f"{len(engine.pool._slots)} live slots after drain")
        return 1
    print(f"[serve] steps={s['steps']} prefill_tokens={s['prefill_tokens']} "
          f"decode_tokens={s['decode_tokens']} evictions={s['evictions']} "
          f"peak_kv_occupancy={s['peak_occupancy']:.0%}")
    if args.paged_prefill or args.prefix_cache:
        print(f"[serve] prefill_batch_size={s['prefill_batch_size']} "
              f"prefill_batches={s['prefill_batches']} "
              f"prefix_hit_tokens={s['prefix_hit_tokens']} "
              f"cached_pages={s['cached_pages']} "
              f"shared_pages={s['shared_pages']} "
              f"cow_copies={s['cow_copies']}")
    if args.speculative:
        print(f"[serve] speculative K={args.speculative}: "
              f"acceptance_rate={s['acceptance_rate']:.2f} "
              f"accepted_per_tick={s['accepted_per_tick']:.2f} "
              f"tokens_per_lane_tick={s['tokens_per_lane_tick']:.2f} "
              f"rolled_back={s['rolled_back_tokens']}")
    if s["ttft_s_p50"] is not None:
        print(f"[serve] latency: ttft_p50={s['ttft_s_p50'] * 1e3:.1f}ms "
              f"ttft_p99={s['ttft_s_p99'] * 1e3:.1f}ms "
              f"itl_p50={(s['itl_s_p50'] or 0) * 1e3:.2f}ms "
              f"queue_p50={(s['queue_s_p50'] or 0) * 1e3:.1f}ms")
    if args.canary_every is not None:
        print(f"[serve] quality: canary_nll={s['canary_nll']:.6f} "
              f"canary_runs={s['canary_runs']} "
              f"act_absmax={s['act_absmax']:.3g} act_sat={s['act_sat']:.2e}")
    if args.shadow_rate > 0:
        print(f"[serve] shadow: samples={s['shadow_samples']} "
              f"tokens={s['shadow_tokens']} flips={s['shadow_token_flips']} "
              f"max_abs_logit_diff_p99="
              f"{s.get('shadow_max_abs_logit_diff_p99') or 0:.3g} "
              f"flip_rate_p99={s.get('shadow_flip_rate_p99') or 0:.3g}")
    if tracer is not None:
        from repro_torch.serve.telemetry import phase_breakdown

        tracer.export_chrome_trace(args.trace_out)
        pb = phase_breakdown(tracer.spans)
        phases = " ".join(
            f"{name}={p['time_s'] * 1e3:.0f}ms({p['share']:.0%})"
            for name, p in sorted(pb["phases"].items(),
                                  key=lambda kv: -kv[1]["time_s"]))
        print(f"[serve] trace: {len(tracer)} spans -> {args.trace_out} "
              f"(dropped={tracer.dropped}) coverage={pb['coverage']:.0%} "
              f"{phases}")

    if args.check:
        if args.kv_int8:
            # int8 pages are lossy against the dense references: the
            # oracle is a gather-dense engine over the same int8 pages,
            # always on one device (so --mesh is held to the unsharded
            # implementation)
            oracle_adapter = (adapter if mesh is None
                              else CachedDecoder.from_quantized(qm))
            oracle = build_engine(oracle_adapter, max_seq_len=max_seq_len,
                                  args=args, paged=False,
                                  paged_prefill=False, prefix_cache=False,
                                  speculative=0, robust=False)
            oref = [oracle.submit(prompts[i], max_new=args.gen)
                    for i in range(args.requests)]
            oracle.run()
            ref = np.stack([np.asarray(r.out_tokens, np.int32)
                            for r in oref])
            ref_label = "gather-dense int8 engine"
        elif fp_ref is None:
            ref = quantized_generate(
                qm, torch.as_tensor(prompts, device=device), args.gen
            ).cpu().numpy()
            ref_label = "quantized recompute"
        else:
            ref = greedy_generate(
                *fp_ref, torch.as_tensor(prompts, device=device),
                args.gen).cpu().numpy()
            ref_label = "fp prefill/decode"
        # FINISHED rows must equal the oracle at full length; CANCELLED or
        # FAILED rows must be a prefix of it
        total_cmp = matched = 0
        truncated_ok = True
        for i, r in submitted:
            out = np.asarray(r.out_tokens, np.int32)
            exp = np.asarray(ref[i], np.int32)
            if r.state is RequestState.FINISHED:
                if out.size != exp.size:
                    truncated_ok = False
                    continue
            else:
                exp = exp[: out.size]
            total_cmp += exp.size
            matched += int(np.sum(out == exp))
        agree = matched / max(1, total_cmp)
        print(f"[serve] check vs {ref_label}: token agreement "
              f"{agree:.2%} over {total_cmp} tokens")
        if agree < 1.0 or not truncated_ok:
            print(f"[serve] FAIL: engine cached decode diverged from the "
                  f"{ref_label} oracle")
            return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
