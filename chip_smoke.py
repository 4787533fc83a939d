#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py            # one CUDA card; exits nonzero on any failure

Phases, each printing its own lines:

  1. device  — the card's name, its ``nvidia-smi`` name and power limit, and
     the torch / CUDA versions; TF32 off for every fp32 product;
  2. build   — compile every CUDA kernel of the port from the sources in
     this checkout (``torch.utils.cpp_extension.load``, one compiler process
     per source, in parallel);
  3. kernels — each kernel's launch wrapper, and the public wrapper the
     port calls (``ops.py``), against its plain PyTorch version at
     ``qwen3-14b`` shapes and at ragged ones, with the error beside its
     stated tolerance, the kernel's median time over CUDA events (L2
     flushed), the plain version's time, the time of one library call
     computing the same function (a yardstick the port never calls; none
     for LDLQ, which no single PyTorch call computes) and the least time
     the card could take (bytes over 3.35 TB/s or operations over the peak
     of the unit that could do them, whichever is larger: the bf16 tensor
     cores for attention and quant_matmul, the TF32 tensor cores for
     kron_mul, the fp32 cores for the rest).
     Serving: quant_matmul (the grid-sum entry and the fused entry with the
     dequant epilogue, two launches bit-identical, and an fp32 matmul on
     the dequantized W as a second yardstick), paged decode (the kernel
     entry and the adapter's fused entry with the token's own K/V; G 5 and
     12) and prefill (grouped layout, and the
     adapter's (B, C, H, hd) layout in q's dtype), with ragged cases (block
     tables far longer than every context, G*C not a multiple of the row
     tile); quantizing: the in-block LDLQ recurrence (also bit for bit
     against the plain emulation of its own summation order), the
     Kronecker transform (alone, and through the fused
     entries QuantizedLinear and the incoherence processing call:
     permutation, D, transposed factors, both directions) and the
     Hadamard transform (bit for bit against its plain version); two
     launches of each bit-identical;
  4. serve   — a seeded synthetic 2-bit ``qwen3-14b`` artifact at full width
     and depth, saved with the port's store and loaded back (SHA-256
     checked), served through the engine with ``--paged --paged-prefill``:
     8 requests of prompt 128 and gen 32 submitted at fixed engine ticks
     (four at once, then one every other tick), kernel launch counts read
     around the run; then ``torch.profiler`` over one prefill tick (8
     admissions x 64-token chunks) and three decode ticks: device busy,
     kernels per tick, the attention kernels', kron_mul's and
     quant_matmul's share, and the ``index_select`` gathers left;
  5. check   — every emitted position re-run teacher-forced through the
     recompute oracle (``QuantizedModel.logits(plain=True)``: transforms
     and grid matmul as plain PyTorch on the card, no kernel) and compared
     with the engine's logits;
  6. quantize — ``qwen3-14b`` at full width, depth cut to ``--quant-layers``
     blocks, QuIP-quantized on the card (2 bits, LDLQ, Kronecker
     transforms) from 128 x 2048 calibration tokens, with per-linear
     quality, per-block time and kernel launches; checks (a) LDLQ's proxy
     loss below nearest rounding's on block 0's mlp.wo, (b) µ(W) lowered on
     every linear, (c) a Hadamard-transformed linear through the hadamard
     kernel against its dense product dequantized in plain PyTorch, (d)
     every kernel of the path launched; then the artifact is saved, loaded
     back and served as in phases 4 and 5;
  7. dense family — the other dense configs at full width, each served
     through the engine and held to the recompute oracle as in phases 4
     and 5: (a) a synthetic 2-bit ``starcoder2-15b`` (GeLU MLP, G = 12) at
     full depth, phase 4's request schedule, with its tick profile; (b)
     ``starcoder2-15b`` quantized in process by the function
     ``launch/serve.py --quantize`` calls (depth cut to ``SC_QUANT_LAYERS``
     blocks: LDLQ over 24576 columns, kron_mul on the 24576-wide Hessian),
     then served; (c) synthetic ``llama2-70b``, ``qwen2-72b`` and
     ``mistral-large-123b`` (depth cut to ``BIG_LAYERS``: d_ff 28672 =
     128 x 224 and 29568 = 168 x 176, d_model 12288 = 96 x 128 through
     kron_mul, G = 12), each served.  Kernel launches are read per path;
  8. lifecycle — phase 4's model (rebuilt from its seed), full width and
     depth, on tick-counted schedules (the engine's clock reads the tick
     number) with phase 4's flags: (a) the prefix cache: ten requests of
     128 + 32, eight sharing a 96-token prefix, two repeating request 0's
     whole prompt (a page-aligned full hit, copied on admission), with a
     pool holding everything and with ``PREFIX_TIGHT_PAGES`` pages (decode
     evicts, admission reclaims trie leaves), beside the same schedule
     without the cache (prefill launches and tokens); (b) int8 KV: phase
     4's schedule with ``--kv-int8`` held against the gather-dense int8
     engine (the oracle of ``launch/serve.py --kv-int8 --check``) within
     ``INT8_LOGIT_*``, with its distance to the fp recompute oracle, the
     pool's bytes and a tick profile; (c) the request lifecycle: a stop
     token, cancels of a queued and of a decoding request, a request with
     ``deadline_s=0``, ``max_queue`` rejections and two tenants at classes
     0 and 1, one rate-limited, under a pool that evicts.  The host
     decisions of (a) and (c) (counters, finish states and reasons,
     rejections, admission order) equal the same schedule replayed on the
     CPU through the port's engine with a model-free decoder that emits
     the card's tokens; every emitted position passes phase 5's check; no
     page leaks;
  9. speculative and sampling — phase 4's model (rebuilt from its seed),
     full width and depth, phase 4's flags and arrivals, eight prompts of
     seeded repeated spans (half of them broken): (a) greedy speculative
     decode (``--speculative 4 --draft ngram``: the chunked-prefill kernel
     as verifier) against the same schedule at K = 0: streams equal but
     where the K = 0 top-2 margin is below twice the max |Δlogit|, phase
     5's check, drafts both accepted and rolled back, the prefill kernel
     launched once per layer per verify tick; (b) sampled (T 0.8, top-p
     0.9, seeds 0..7): two runs identical, every card draw equal to
     ``sample_tokens`` on the CPU over the card's logits but within the
     measured float32 CDF rounding of a bucket edge, K = 4 against K = 0
     and one request alone against the batch parting only where the
     logits' difference admits it; (c) int8 KV at K = 4 against int8 at
     K = 0 within ``INT8_LOGIT_*``; profiles of a greedy and a sampled
     verify tick and the draw's time at the verify tick's shape;
 10. observability, faults and quality — phase 4's model (rebuilt from its
     seed), flags and schedule: (a) the fault plan ``OBSERVE_PLAN`` (five
     kinds, armed with the requests' real rids) under ``--screen-logits``
     against a fault-free run: each targeted request ends in its own state
     and reason, ``quarantined_lanes`` 1, one ``fault:<kind>`` per firing,
     no page left, survivors' streams equal but where the fault-free
     top-2 margin is below 2 x phase 5's max |diff|, phase 5's check on
     them; a NaN inside a K = 4 verify tick on phase 9's prompts
     quarantined alone; phase 6's artifact with ``corrupt_shard@shard=0``
     refused; (b) phase 4 with a live sync tracer in alternating runs:
     the Chrome trace validates, the step spans' phases cover 90 % of the
     tick wall, the engine's TTFT/ITL percentiles equal those of
     ``token_times``, phase 4's launches, and ``torch.profiler`` puts a
     decode tick's quant_matmul launches inside its
     ``dispatch:decode_paged*`` range; (c) canaries (2 x 16 tokens) and
     ``shadow_rate`` 1.0 through ``run_to_completion``: streams unchanged,
     the canary gauge equal to the offline NLL bit for bit and close to
     the recompute oracle's, shadow drift within phase 5's limit, flips
     only at small margins, and the quality-baseline round trip
     (``quality_report.py --write-baseline``, ``serve.py
     --quality-baseline --quality-strict``) on phase 6's artifact;
 11. tensor parallelism — ``serve/distributed.py`` with ranks sharing the
     card on gloo (collectives staged through host memory; no TP speed is
     measured so): (a) mp = 2, phase 4's model built by every rank from
     its seed, phase 4's flags and schedule: streams equal phase 4's but
     where its top-2 margin is below 2 x phase 5's max |diff|, phase 5's
     check, each rank holding half the pool and half the packed codes and
     launching phase 4's kernels (each rank's counts read through the
     mesh); (b) mp = 2, K = 4 over int8 pages on phase 9's prompts with a
     NaN in request 1's verify tick, against the same on one device
     (``INT8_LOGIT_*``), the NaN lane alone quarantined; (d), after (b),
     the front door over (a)'s mesh and adapter (40 layers) with (12 a)'s
     client traffic: streams equal phase 4's under the margin rule, phase
     5's check, contiguous SSE indices, ``/healthz`` 200, ``tick_errors``
     0, the four serving kernels launched alike on every rank, a clean
     drain, client TTFT and ITL; then rank 1 killed under an idle front
     door: ``/healthz`` non-200 within ``TP_HEALTH_S`` and the mesh
     aborted without a hang; (c) mp = 4 at ``TP4_LAYERS`` layers (2 KV
     heads a rank), phase 5's check;
 12. front door and fleet — (a) phase 4's model (rebuilt from its seed),
     full width and depth, phase 4's flags with ``record_logits``, behind
     ``FrontDoor.start_in_thread`` (the engine on one executor thread
     whose initializer makes the card current): phase 4's eight prompts
     from HTTP clients (seven SSE, one buffered; a burst of four, then one
     every 100 ms), streams equal to phase 4's but where its top-2 margin
     is below 2 x phase 5's max |diff|, phase 5's check on the front
     door's requests, contiguous SSE indices, 413 for an over-capacity
     body, a client reset mid-stream ending ``cancelled``, ``/healthz``
     200, ``tick_errors`` 0, a clean drain, the four serving kernels
     launched; TTFT and ITL at the client socket; (b) the same model
     saved as an artifact and served by two replica processes of
     ``python -m repro_torch.launch.serve --device cuda`` behind an
     in-process ``Supervisor`` and ``FleetRouter``: eight greedy requests
     and one sampled (T 0.8, top-p 0.9), replica 1 killed with SIGKILL
     once every stream it holds is ``FLEET_KILL_AFTER`` tokens in; every
     stream completes with contiguous indices, the spliced greedy streams
     equal (a)'s under the margin rule and the sampled one an
     uninterrupted sampled run on the card but within the CDF rounding of
     a bucket edge; replica 1 restarts (generation 2) and serves a later
     request; ``tick_errors`` 0 on every replica; the fleet drain clean;
     (c) the same fleet over two ``--mesh 1,2`` replicas (four ranks
     sharing the card on gloo) of phase 4's model at ``FLEET_TP_LAYERS``
     layers (a cut for the time limit alone): four greedy requests and
     one sampled, replica 1's rank 0 SIGKILLed mid-stream and its whole
     mesh gone within ``FLEET_REAP_S`` (``/proc``, ``nvidia-smi``), the
     splices held to uninterrupted one-device runs on the card, replica 1
     back as generation 2 serving a later request, a worker of idle
     replica 0 SIGKILLed and replica 0 restarted within ``fail_threshold``
     probes, the backoff and one replica start, a clean drain, no mesh
     process left; each mesh replica's start seconds;
 13. model families — ``build_model`` at full width, one run after another
     with the card freed between them (``FAMILY_RUNS``): llama4-scout
     (moe, top-1) at 4 of 48 layers in bf16 and with ``weight_bits`` 2,
     arctic (moe, top-2, dense residual) at 1 of 35 layers, rwkv6 whole
     and zamba2 (hybrid, the shared block 13 times a token) whole with
     ``weight_bits`` 2.  Each serves eight prompts of 128 tokens, 32
     generated, through ``greedy_generate`` in bf16 (launches counted
     around it; quant_matmul once a projection a call; the real-capacity
     prefill's MoE drops reported; the stream the argmax of the same
     prefill and decode steps teacher-forced), and ``expert_hessians`` on
     llama4-scout's layer-0 routed activations is held to plain
     per-expert XᵀX (``EXPERT_H_RTOL``).  Then the same model in fp32,
     where rounding neither hides a fault nor flips MoE routing, holds
     prefill logits to the forward's at S - 1, teacher-forced decode
     logits to the forward's (MoE at ``capacity_factor`` = experts /
     top-k, where nothing drops) with the greedy stream the forward argmax
     at every position but near ties, packed runs to their ``plain=True``
     logits, and the chunked scans to their per-step oracles on one
     full-width layer (``FAMILY_GATES``); each decode, packed and scan
     gate must also fail a wrong run (a cache fault, a dropped K word, a
     scan restarted every 16 tokens).  The encdec and vlm families follow:
     whisper-small whole in bf16 and with ``weight_bits`` 2, and
     llama-3.2-vision-90b at 2 bits over all 100 layers and in bf16 at 10
     (two superblocks), beside seeded stub embeddings on the card (8 x
     1,500 encoder frames, 8 x 1,024 patches) and with every vlm gate set
     to a seeded non-zero value (a fresh init's gates of 0 leave the cross
     path inert).  ``greedy_generate`` takes no embeddings, so their main
     path is ``Model.prefill`` + ``decode_step`` (``_greedy_batch``); their
     prefill gate also fails a prefill fed another row's embeddings, their
     decode gate a decode whose cross caches are rolled along the batch.
 14. training — ``launch/steps.py`` and ``launch/train.py`` (no kernel:
     the path runs fp weights, and every kernel's launches read 0 around
     it).  ``qwen3-14b`` at full width, depth cut to ``TRAIN_LAYERS`` = 2
     of 40 for memory (the adamw state of 40 layers is ~300 GB): (a) one
     fp32 sgd(1.0) step on a 32 x 64 ``token_batches`` batch with remat
     "full" over 2 microbatches against remat "none" over 1: loss,
     grad_norm and every leaf's update within ``TRAIN_ACCUM_RTOL``, which
     the step with the microbatch sum left undivided must fail; (b) the
     CLI's adamw over its cosine schedule in bf16 with remat "full",
     ``TRAIN_STEPS`` steps of 32 x 64 in 2 microbatches: finite losses and
     grad norms, the last loss below the first, the step and optimizer
     time (CUDA events) and the peak memory; (c) the train CLI's
     fault-and-resume drill at the smoke config in one fresh process
     (deterministic algorithms from its first CUDA call; started beside
     phase 2's build, as its ~20 s are mostly the process's start, and
     checked here): an
     uninterrupted run, the same run with ``--fail-at 5`` (one failure
     trapped, step 3 restored, the final checkpoint equal to the
     uninterrupted run's bit for bit), then that run extended to 10 steps
     (resumed from step 8).
 16. training over a mesh — ``launch/train.py``'s ``train_jobs`` (under
     the CLI's ``--devices``) on a (1, 2) mesh of two ranks sharing the
     card over gloo, collectives staged through host memory (no kernel;
     every kernel's launches read 0 around the mesh runs).  Every run at
     full width, 8 x 64 tokens in 2 microbatches, in one fresh process
     (rank 0; deterministic algorithms from its first CUDA call): each
     gated run first on one device, then every run on the mesh, one start
     of the ranks for all of them.  A gated run keeps only
     ``MESH_SAMPLE`` seeded elements of each leaf of its final state
     (``sample_leaves``), read where they lie, and of its init: (a)
     qwen3-14b at ``MESH_LAYERS`` = 2 of 40 layers (memory), 3 fp32 adamw
     steps: loss and grad norm of every step within ``MESH_LOSS_RTOL``,
     adamw's first moment within ``MESH_M_RTOL`` of its max, every param
     leaf within ``MESH_UPDATE_RTOL`` of the one-device run's move; (b)
     its 4 bf16 steps, each rank's step time (CUDA events); (d)
     llama4-scout-17b-a16e at 1 of 48 layers (memory), 8 of its 16
     experts stored and computed a rank: 3 fp32 sgd steps gated as (a)
     (and the dropped pairs equal), then 4 bf16 steps timed; (e) one fp32
     sgd step of rwkv6-1.6b (1 layer), zamba2-7b (6: five Mamba2 layers
     and the shared block), whisper-small (1 encoder and 1 decoder layer,
     1,500 frames), the 5-layer llama-3.2-vision-90b (4 self and 1 gated
     cross layer, seeded non-zero gates) in bf16, gated on loss and grad
     norm, and 3 adafactor steps of (a)'s model; in every gated run the
     leaves with replicas bit-identical on both ranks; (c) the train CLI
     with ``--devices 2`` at the smoke config (started beside phase 2's
     build): an uninterrupted run and one with ``--fail-at 3``, whose
     final checkpoints are equal bit for bit.  CPU rehearsal:
     ``phase_train_mesh(torch, seed=0, runs=mesh_runs(smoke=True))`` with
     ``DEV = "cpu"`` and ``MESH_BATCH, MESH_SEQ = 8, 16``.

Phase 3 also runs kron_mul at every dense width's factors (16 x 32 to
168 x 176, and 192 x 256, the largest the kernel takes), quant_matmul at
the widest starcoder2-15b and llama2-70b projections and at phase 13's
packed projections (``QMM_FAMILY_SHAPES``), and paged prefill at G = 12;
and one rank's shapes at tensor parallelism 2 and 4 (``QMM_TP_SHAPES``;
paged decode and prefill at 4 and 2 KV heads, the verifier's C = 5 over
int8 pages, each with its SDPA yardstick).

The next-to-last line is a JSON record of the six kernels (each with its
launches on every path, phase 11's by rank, (d)'s too, and phase 14's
``train`` and phase 16's ``train_mesh`` paths with 0 of each); the last
line is
``{"ok": true, "device": {...}}``, printed only when every phase passed.
Nothing of JAX or of the ``repro`` package is imported.
"""
from __future__ import annotations

import argparse
import atexit
import json
import math
import pathlib
import shutil
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_S = 3.35e12  # H100 SXM device memory rate
FP32_FLOP_S = 67e12  # H100 SXM fp32 outside the tensor cores
TC_BF16_FLOP_S = 989e12  # H100 SXM bf16 tensor cores, dense
TC_TF32_FLOP_S = 495e12  # H100 SXM TF32 tensor cores, dense
L2_BYTES = 50 * 2**20
DEV = "cuda"  # every tensor of the run lives on the card
WORK_DIR = ROOT / "build" / "chip_smoke"

# stated tolerances (see the checks below for what each bounds)
EPS32 = 2.0**-24  # fp32 unit roundoff
BF16_ULP = 2.0**-7  # one bf16 unit in the last place, relative to |value|
ATTN_ATOL = 1e-4  # attention outputs, fp32 both sides
# engine vs recompute oracle logits over 40 layers (the residual stream is
# fp32 after the first block, as in the JAX package): about twice the max
# |diff| (0.0189) and mean |diff| (0.0027) read on correct runs
LOGIT_ATOL = 0.05
LOGIT_MEAN_ATOL = 0.006
# the same check on the port-quantized 2-block model: about twice the max
# (0.0304) and mean (0.0045) |diff| read on correct runs
QUANT_LOGIT_ATOL = 0.06
QUANT_LOGIT_MEAN_ATOL = 0.009
# phase 7's depths (width is never cut): starcoder2-15b served whole, one
# block of it quantized in process, llama2-70b, qwen2-72b and
# mistral-large-123b served at 2 of their 80 and 88 layers
SC_LAYERS, SC_QUANT_LAYERS, BIG_LAYERS = 40, 1, 2
# phase 7's models (max, mean |diff|): llama2-70b and qwen2-72b read about
# what qwen3-14b reads (0.0242 / 0.00373 and 0.0252 / 0.00371) and keep
# phase 5's gate; starcoder2-15b reads less and gets its own, about twice
# its reading: 0.0049 / 0.00066 at full depth, 0.0185 / 0.00280 for the
# block it quantizes itself (measured on one H100, every kernel check
# passed)
DENSE_LOGIT_GATES = {
    "starcoder2-15b": (0.01, 0.0013),
    "llama2-70b": (LOGIT_ATOL, LOGIT_MEAN_ATOL),
    "qwen2-72b": (LOGIT_ATOL, LOGIT_MEAN_ATOL),
    "mistral-large-123b": (LOGIT_ATOL, LOGIT_MEAN_ATOL),
    "starcoder2-15b quantized": (0.04, 0.006),
}
# phase 6's fp weights: sparse outliers on the init_decoder draw
OUTLIER_FRAC, OUTLIER_SCALE = 0.005, 25.0
# a hadamard-transformed QuantizedLinear vs x @ dequantize(plain=True).T,
# fp32
HADAMARD_LINEAR_RTOL = 1e-4
# the engine flags of both serve runs
SERVE_ARGS = argparse.Namespace(slots=8, page_size=16, pages=None,
                                token_budget=512, prefill_chunk=64,
                                paged=True, paged_prefill=True)
SERVE_KERNELS = ("quant_matmul", "paged_decode", "paged_prefill", "kron_mul")
QUANT_KERNELS = ("ldlq", "kron_mul")
# depth cuts for the time limit: the serving paths after phase 7 run the
# synthetic qwen3-14b at full width and this depth (phases 3-6 keep all
# 40 layers); every gate there compares against a run at the same depth
LIFECYCLE_LAYERS = 4  # phase 8
SPEC_LAYERS = 4  # phase 9
OBSERVE_LAYERS = 4  # phase 10
TP_LAYERS = 4  # phase 11 (a) and (d)
FRONTDOOR_LAYERS = 8  # phase 12 (a) and (b)

# quant_matmul (K, M) of one rank at tensor parallelism 2 (phase 11):
# column-parallel mlp.wi/wg (M = 17408 / 2), row-parallel mlp.wo and
# attn.wo (K = 17408 / 2, 5120 / 2)
QMM_TP_SHAPES = ((5120, 8704), (8704, 5120), (2560, 5120))
# quant_matmul (K, M, B, bits): the qwen3-14b projections at decode (B 1,
# 8) and prefill (64, 512) rows; the widest projections of starcoder2-15b
# (mlp.wi, mlp.wo) and llama2-70b (mlp.wi) at 8 and 512 rows; 3 and 4 bits;
# and ragged shapes -- K ending in a partial packed word, M not a multiple
# of the 256-column tile, B not a multiple of the row block -- through both
# kernels (B <= 16 and B > 16) at every bit width
QMM_CASES = tuple(
    [(K, M, B, 2) for (K, M) in ((5120, 5120), (5120, 1024), (5120, 17408),
                                 (17408, 5120))
     for B in (1, 8, 64, 512)]
    + [(K, M, B, 2) for (K, M) in ((6144, 24576), (24576, 6144),
                                   (8192, 28672))
       for B in (8, 512)]
    + [(5120, 5120, 8, 3), (5120, 5120, 8, 4)]
    + [(5121, 1000, B, bits) for B in (5, 70) for bits in (2, 3, 4)]
    + [(17, 300, 3, 8), (17, 300, 20, 8)]
    + [(K, M, B, 2) for (K, M) in QMM_TP_SHAPES for B in (8, 512)]
)
# quant_matmul (K, M) of phase 13's packed projections, by model: decode
# rows (B 8) and a prefill's (B 1024 = 8 x 128), 2-bit
QMM_FAMILY_SHAPES = {
    "llama4-scout-17b-a16e": ((5120, 5120), (5120, 1024)),
    "arctic-480b": ((7168, 7168), (7168, 1024), (7168, 4864), (4864, 7168)),
    "zamba2-7b": ((3584, 3584), (3584, 14336), (14336, 3584)),
    "whisper-small": ((768, 768), (768, 3072), (3072, 768)),
    "llama-3.2-vision-90b": ((8192, 8192), (8192, 1024), (8192, 28672),
                             (28672, 8192)),
}
QMM_FAMILY_CASES = {(K, M, B, 2): arch
                    for arch, shapes in QMM_FAMILY_SHAPES.items()
                    for (K, M) in shapes for B in (8, 1024)}
QMM_CASES += tuple(c for c in QMM_FAMILY_CASES if c not in QMM_CASES)
# ldlq (m, n, bits, stochastic): the qwen3-14b linears' (rows, columns) —
# attn.wk/wv, attn.wq/wo, mlp.wi/wg, mlp.wo — at 2 and 4 bits, a ragged
# row count, stochastic rounding, and a column count with no divisor in
# [8, 128] (n = 131: blocks of one column, through the rounding-method
# registry)
LDLQ_CASES = (
    [(m, n, bits, False) for (m, n) in ((1024, 5120), (5120, 5120),
                                        (17408, 5120), (5120, 17408))
     for bits in (2, 4)]
    + [(1000, 5120, 2, False), (1000, 5120, 4, False), (5120, 5120, 2, True),
       (1024, 131, 2, False)]
)
# kernel codes that may differ from the plain version's on the same inputs
# (a near-tie flipped by another fp32 summation order, which in the whole
# driver feeds back into the rest of its row): a few times the most read
# on correct runs, 3.1e-6 for the driver and 0 for one block
LDLQ_DIFF_FRAC = 1e-4
# kron_mul (n, N): the three qwen3-14b widths at decode rows, a prefill
# chunk, and N = n (a Hessian); then ragged factors: 50 x 60 (p not a
# multiple of 16), 1 x 131 (p = 1, q odd), 63 x 65 (both odd) and
# 128 x 160 (column slices at any N); then the other dense widths at decode
# and prefill rows -- 512 = 16 x 32 and 6144 = 64 x 96 (starcoder2-15b),
# 8192 = 64 x 128 (llama2-70b, qwen2-72b), 12288 = 96 x 128
# (mistral-large-123b), 24576 = 128 x 192, 28672 = 128 x 224 and
# 29568 = 168 x 176 (A read from global memory) -- and N = n for 24576 and
# 29568; 131 x 137 (both odd, A from global memory) and 192 x 256 (the
# largest the kernel takes)
KRON_CASES = ([(n, N) for n in (1024, 5120, 17408) for N in (8, 512, n)]
              + [(3000, 37), (131, 300), (4095, 9), (20480, 64)]
              + [(n, N) for n in (512, 6144, 8192, 12288, 24576, 28672,
                                  29568) for N in (8, 512)]
              + [(24576, 24576), (29568, 29568), (17947, 37), (49152, 9)])
# hadamard (n, N): 1024 (the power-of-two part of every qwen3-14b width) at
# 8 rows of a 17-odd view and at an mlp.wo Hessian's 17408 x 17 rows; 128;
# 8 (16 rows per warp, the last warp ragged) and 2048 (the widest row in
# one warp's registers); 4096 and 16384 (the shared-memory kernel)
HADAMARD_CASES = [(1024, 8 * 17), (1024, 17408 * 17), (128, 4096),
                  (8, 1001), (2048, 300), (4096, 32), (16384, 64)]

def _depth_cut(tag: str, cfg, layers: int, why: str = "time limit"):
    """``cfg`` at ``layers`` layers (full width), logged as a depth cut."""
    import dataclasses

    if layers == cfg.n_layers:
        return cfg
    log(f"[{tag}] DEPTH CUT: {layers} of {cfg.n_layers} layers ({why})")
    return dataclasses.replace(cfg, n_layers=layers)


def log(msg: str) -> None:
    print(msg, flush=True)


class Timer:
    """Median time of a callable over CUDA events, with the L2 cache
    flushed before every repetition (the serving path finds weights and
    pages cold)."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(2 * L2_BYTES, dtype=torch.uint8,
                                 device=DEV)

    def __call__(self, fn, reps: int = 20, warmup: int = 3) -> float:
        torch = self.torch
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        if time.perf_counter() - t0 > 0.05:  # a long call: fewer repetitions
            reps, warmup = 5, 0
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(reps):
            self.flush.zero_()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        times.sort()
        return times[len(times) // 2]


def bound_ms(n_bytes: float, n_ops: float,
             flop_s: float = FP32_FLOP_S) -> tuple[float, str]:
    tb, to = n_bytes / HBM_BYTES_S * 1e3, n_ops / flop_s * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


# ---------------------------------------------------------------------------
# phase 1 + 2
# ---------------------------------------------------------------------------


def phase_device(torch) -> dict:
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"[device] torch.cuda.get_device_name: {name}; count "
        f"{torch.cuda.device_count()}")
    log(f"[device] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return {"name": name, "smi": smi}


def phase_build() -> None:
    import re

    from torch.utils.cpp_extension import CUDA_HOME

    from repro_torch.kernels import _build

    secs = _build.build()
    log(f"[build] torch.utils.cpp_extension.load of {len(_build.SOURCES)} "
        f"kernel sources and their bindings ({' '.join(_build.CUDA_FLAGS)})"
        f" in {secs:.1f}s -> {_build.BUILD_DIR}")
    so = _build.BUILD_DIR / f"{_build.NAME}.so"
    res = subprocess.run(
        [str(pathlib.Path(CUDA_HOME or "/usr/local/cuda") / "bin" /
             "cuobjdump"), "-res-usage", str(so)],
        capture_output=True, text=True)
    regs = [int(r) for r in re.findall(r"REG:(\d+)", res.stdout)]
    local = [int(r) for r in re.findall(r"LOCAL:(\d+)", res.stdout)]
    if regs:
        log(f"[build] {len(regs)} kernel instantiations: registers "
            f"{min(regs)}-{max(regs)}, local memory (spills) up to "
            f"{max(local, default=0)} bytes")
    else:
        log("[build] registers: not measured (cuobjdump gave no resource "
            "usage)")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def qmm_cases(torch, timer) -> dict:
    from repro_torch.core import packing
    from repro_torch.core.incoherence import from_grid
    from repro_torch.kernels.quant_matmul import ops as qmm_ops
    from repro_torch.kernels.quant_matmul.kernel import (
        quant_matmul_kernel,
        x_terms,
    )
    from repro_torch.kernels.quant_matmul.ref import (
        grid_matmul_ref,
        quant_matmul_ref,
    )

    g = torch.Generator(device=DEV)
    g.manual_seed(11)
    rep, pre = None, None
    worst = 0.0
    tp, fam = {}, {}
    for K, M, B, bits in QMM_CASES:
        maxq = 2**bits - 1
        codes = torch.randint(0, maxq + 1, (M, K), generator=g,
                              device=DEV, dtype=torch.int32)
        packed = packing.pack(codes, bits)
        x = torch.randn(B, K, generator=g, device=DEV)
        # the kernel: fp32 sums in any order, |err| <= K eps sum_k |x_k q_k|
        bound = K * EPS32 * grid_matmul_ref(x.abs(), packed, bits, K)
        ok, err, same = True, 0.0, True
        for xin in (x, x.to(torch.bfloat16)):
            got = quant_matmul_kernel(xin, packed, bits=bits)
            d = (got - grid_matmul_ref(xin.float(), packed, bits, K)).abs()
            ok = ok and bool((d <= bound).all())
            err = max(err, float(d.max()))
            # deterministic: a second launch is bit-identical
            same = same and torch.equal(
                got, quant_matmul_kernel(xin, packed, bits=bits))
        # the wrapper (one launch: kernel + affine epilogue) with fp32
        # activations, as QuantizedLinear calls it, against the plain
        # dequantize-then-matmul: the kernel's sum scaled by 2s/maxq (2K
        # eps), the row sum (K eps) and the plain matmul (K eps), each times
        # s sum|x|, plus 8 roundings
        s_ = torch.tensor(1.3 / K**0.5, device=DEV)
        z = qmm_ops.quant_matmul(x, packed, bits, K, s_, maxq)
        dz = (z - quant_matmul_ref(x, packed, bits, K, s_, maxq)).abs()
        wbound = (4 * K + 8) * EPS32 * s_ * x.abs().sum(-1, keepdim=True)
        ok_w = bool((dz <= wbound).all()) and z.dtype == x.dtype
        same = same and torch.equal(
            z, qmm_ops.quant_matmul(x, packed, bits, K, s_, maxq))
        t_k = timer(lambda: quant_matmul_kernel(x, packed, bits=bits))
        t_f = timer(lambda: qmm_ops.quant_matmul(x, packed, bits, K, s_,
                                                 maxq))
        t_p = timer(lambda: grid_matmul_ref(x, packed, bits, K))
        W = codes.to(torch.bfloat16)
        xb = x.to(torch.bfloat16)
        t_l = timer(lambda: torch.matmul(xb, W.T))
        del W
        # the same function at the kernel's precision: fp32 x times the
        # fp32 dequantized W, TF32 off
        Wd = from_grid(codes.float(), s_, maxq)
        t_l32 = timer(lambda: torch.matmul(x, Wd.T))
        del Wd
        Kp = packed.shape[0]
        n_bytes = B * K * 4 + Kp * M * 4 + B * M * 4
        # one product per multiply-add at the bf16 tensor cores' peak (the
        # kernel does x_terms of them)
        bms, by = bound_ms(n_bytes, 2.0 * B * K * M, TC_BF16_FLOP_S)
        terms = x_terms(K, x.dtype)
        worst = max(worst, err)
        log(f"[kernel] quant_matmul K={K} M={M} B={B} bits={bits}: "
            f"max_abs_err={err:.3e} (bound max {float(bound.max()):.3e}, "
            f"fp32 and bf16 x) {'OK' if ok else 'FAIL'}; ops.quant_matmul "
            f"max_abs_err={float(dz.max()):.3e} (bound max "
            f"{float(wbound.max()):.3e}) {'OK' if ok_w else 'FAIL'}; "
            f"two launches bit-identical {'yes' if same else 'NO'}"
            f" | kernel {t_k:.4f} ms, ops.quant_matmul (fused) {t_f:.4f} ms,"
            f" plain {t_p:.4f} ms, library(bf16 matmul) {t_l:.4f} ms, "
            f"library(fp32 matmul, dequantized W) {t_l32:.4f} ms, bound "
            f"{bms:.4f} ms ({by}; fp32 x in {terms} bf16 terms)")
        if not (ok and ok_w and same):
            raise AssertionError(f"quant_matmul disagrees at K={K} M={M} "
                                 f"B={B} bits={bits}")
        row = dict(ms=t_k, fused_ms=t_f, plain_ms=t_p, library_ms=t_l,
                   library_fp32_ms=t_l32, bound_ms=bms, bound_by=by,
                   terms=terms)
        if (K, M, B, bits) == (5120, 17408, 8, 2):
            rep = dict(case="K=5120 M=17408 B=8 bits=2 (decode mlp.wi)",
                       **row)
        if (K, M, B, bits) == (5120, 17408, 512, 2):
            pre = dict(case="K=5120 M=17408 B=512 bits=2 (prefill mlp.wi)",
                       **row)
        if (K, M) in QMM_TP_SHAPES and bits == 2:
            tp[f"K={K} M={M} B={B}"] = {k: row[k] for k in (
                "ms", "fused_ms", "plain_ms", "library_ms", "bound_ms")}
        if (K, M, B, bits) in QMM_FAMILY_CASES:
            fam[f"{QMM_FAMILY_CASES[K, M, B, bits]} K={K} M={M} B={B}"] = {
                k: row[k] for k in ("ms", "fused_ms", "plain_ms",
                                    "library_ms", "bound_ms", "bound_by")}
    rep["max_abs_err"] = worst
    rep["prefill"] = pre
    rep["tp_rank"] = tp
    rep["families"] = fam
    return rep


def _pool(torch, g, *, kind, L=2, B=8, Pa=128, ps=16, KV=8, hd=128):
    P = B * Pa + 1
    shape = (L, P, ps, KV, hd)
    if kind == "int8":
        kp = torch.randint(-127, 128, shape, generator=g, device=DEV,
                           dtype=torch.int8)
        vp = torch.randint(-127, 128, shape, generator=g, device=DEV,
                           dtype=torch.int8)
        ks = torch.rand(shape[:-1], generator=g, device=DEV) * 0.02 + 1e-3
        vs = torch.rand(shape[:-1], generator=g, device=DEV) * 0.02 + 1e-3
    else:
        dt = torch.bfloat16 if kind == "bf16" else torch.float32
        kp = torch.randn(shape, generator=g, device=DEV).to(dt)
        vp = torch.randn(shape, generator=g, device=DEV).to(dt)
        ks = vs = None
    # every lane gets distinct physical pages (physical != logical order)
    perm = torch.randperm(P - 1, generator=g, device=DEV) + 1
    bt = perm[: B * Pa].reshape(B, Pa).to(torch.int32)
    return kp, vp, ks, vs, bt


def _kv_bytes(ctx, KV, hd, kind):
    elt = {"int8": 1, "bf16": 2, "fp32": 4}[kind]
    per_tok = KV * hd * elt * 2 + (KV * 4 * 2 if kind == "int8" else 0)
    return sum(ctx) * per_tok


def _model_dtype(torch, kind):
    """The activations' dtype beside each page kind: bf16 (the model's
    dtype) for bf16 and int8 pages, fp32 for fp32 pages."""
    return torch.float32 if kind == "fp32" else torch.bfloat16


def _within(torch, got, want) -> tuple[float, bool]:
    """|got - want| <= ATTN_ATOL, plus one unit in the last place when the
    outputs are bf16 (each side rounds its fp32 result once)."""
    d = (got.float() - want.float()).abs()
    tol = ATTN_ATOL
    if want.dtype == torch.bfloat16:
        tol = tol + BF16_ULP * want.float().abs()
    return float(d.max()), bool((d <= tol).all())


def _dense_kv(torch, kp, vp, ks, vs, bt, layer):
    """Gathered dense K/V (B, S, KV, hd) bf16 for the SDPA yardstick."""
    from repro_torch.kernels.paged_attention.ref import gather_layer

    k = gather_layer(kp, ks, layer, bt).to(torch.bfloat16)
    v = gather_layer(vp, vs, layer, bt).to(torch.bfloat16)
    return k, v


def _sdpa_decode_ms(torch, timer, c, layer) -> float:
    """The library yardstick of a decode case: one
    ``scaled_dot_product_attention`` call (bf16, GQA) over K/V gathered
    dense from the pages, each lane masked to its context."""
    import torch.nn.functional as F

    q, kp, vp, bt, ctx, kw = (c[k] for k in ("q", "kp", "vp", "bt", "ctx",
                                              "kw"))
    B, KV, G, hd = q.shape
    kd, vd = _dense_kv(torch, kp, vp, kw["k_scale"], kw["v_scale"], bt,
                       layer)
    S = kd.shape[1]
    qs = q.reshape(B, KV * G, 1, hd).to(torch.bfloat16)
    kt, vt = kd.transpose(1, 2), vd.transpose(1, 2)  # (B, KV, S, hd)
    mask = (torch.arange(S, device=DEV)[None, :] < ctx[:, None])
    mask = mask[:, None, None, :]
    return timer(lambda: F.scaled_dot_product_attention(
        qs, kt, vt, attn_mask=mask, enable_gqa=True))


def _sdpa_prefill_ms(torch, timer, c, layer) -> float:
    """The library yardstick of a prefill case: one
    ``scaled_dot_product_attention`` call (bf16, GQA) of the chunk's
    queries over the context gathered dense from the pages and the chunk,
    causal within the chunk (the verifier's diagonal override is not
    modelled: the same work)."""
    import torch.nn.functional as F

    q, kc, vc, kp, vp, bt, ctx, kw = (c[k] for k in (
        "q", "kc", "vc", "kp", "vp", "bt", "ctx", "kw"))
    B, KV, G, C, hd = q.shape
    kd, vd = _dense_kv(torch, kp, vp, kw["k_scale"], kw["v_scale"], bt,
                       layer)
    S = kd.shape[1]
    kall = torch.cat([kd, kc.to(torch.bfloat16)], 1).transpose(1, 2)
    vall = torch.cat([vd, vc.to(torch.bfloat16)], 1).transpose(1, 2)
    del kd, vd
    qs = q.reshape(B, KV * G, C, hd).to(torch.bfloat16)
    m_ctx = (torch.arange(S, device=DEV)[None, :] < ctx[:, None])
    m_ctx = m_ctx[:, None, :].expand(B, C, S)
    causal = torch.tril(torch.ones(C, C, dtype=torch.bool, device=DEV))
    mask = torch.cat([m_ctx, causal.expand(B, C, C)], -1)[:, None]
    return timer(lambda: F.scaled_dot_product_attention(
        qs, kall, vall, attn_mask=mask, enable_gqa=True))


def _decode_check(torch, g, kind, *, B, KV, G, hd, ps, Pa, layer,
                  ctx_list):
    """The decode kernel entry's (o, m, l) and the adapter's fused entry
    (ops.paged_gqa_decode: (B, H, hd) queries and the token's own K/V in the
    model dtype) against their plain versions.  Returns the operands, the
    kernel's state and the errors."""
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.paged_attention.kernel import paged_attention_kernel
    from repro_torch.kernels.paged_attention.ref import (
        paged_attention_stats_ref,
        paged_gqa_decode_ref,
    )

    ctx = torch.tensor(ctx_list, dtype=torch.int32, device=DEV)
    kp, vp, ks, vs, bt = _pool(torch, g, kind=kind, B=B, Pa=Pa, ps=ps, KV=KV,
                               hd=hd)
    q = torch.randn(B, KV, G, hd, generator=g, device=DEV)
    kw = dict(layer=layer, k_scale=ks, v_scale=vs)
    o, m, l = paged_attention_kernel(q, kp, vp, bt, ctx, **kw)
    o_r, m_r, l_r = paged_attention_stats_ref(q, kp, vp, bt, ctx, **kw)
    live = ctx > 0
    empty_ok = bool((m[~live] == m_r[~live]).all()
                    and (l[~live] == 0).all() and (o[~live] == 0).all())
    err = max(
        float((o[live] / l[live] - o_r[live] / l_r[live]).abs().max()),
        float((m[live] - m_r[live]).abs().max()),
        float(((l[live] - l_r[live]) / l_r[live]).abs().max()),
    )
    dt = _model_dtype(torch, kind)
    qh = q.reshape(B, KV * G, hd).to(dt)
    k_new = torch.randn(B, KV, hd, generator=g, device=DEV).to(dt)
    v_new = torch.randn(B, KV, hd, generator=g, device=DEV).to(dt)
    got = pa_ops.paged_gqa_decode(qh, k_new, v_new, kp, vp, bt, ctx, **kw)
    w_err, w_ok = _within(
        torch, got, paged_gqa_decode_ref(qh, k_new, v_new, kp, vp, bt, ctx,
                                         **kw))
    w_ok = w_ok and got.dtype == dt and got.shape == qh.shape
    ok = err <= ATTN_ATOL and empty_ok and w_ok
    return dict(q=q, kp=kp, vp=vp, bt=bt, ctx=ctx, kw=kw, o=o, m=m, qh=qh,
                k_new=k_new, v_new=v_new, err=err, empty_ok=empty_ok,
                w_err=w_err, ok=ok, dt=dt)


def decode_cases(torch, timer) -> dict:
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.paged_attention.kernel import paged_attention_kernel
    from repro_torch.kernels.paged_attention.ref import (
        paged_attention_stats_ref,
    )

    g = torch.Generator(device=DEV)
    g.manual_seed(12)
    B, KV, G, hd, ps, Pa, layer = 8, 8, 5, 128, 16, 128, 1
    ctx_list = [0, 1, 17, 100, 511, 1000, 1500, 2048]
    rep, worst = None, 0.0
    for kind in ("bf16", "fp32", "int8"):
        c = _decode_check(torch, g, kind, B=B, KV=KV, G=G, hd=hd, ps=ps,
                          Pa=Pa, layer=layer, ctx_list=ctx_list)
        q, kp, vp, bt, ctx, kw = (c[k] for k in ("q", "kp", "vp", "bt", "ctx",
                                                  "kw"))
        worst = max(worst, c["err"])
        t_k = timer(lambda: paged_attention_kernel(q, kp, vp, bt, ctx, **kw))
        t_f = timer(lambda: pa_ops.paged_gqa_decode(
            c["qh"], c["k_new"], c["v_new"], kp, vp, bt, ctx, **kw))
        t_p = timer(lambda: paged_attention_stats_ref(q, kp, vp, bt, ctx,
                                                      **kw))
        t_l = _sdpa_decode_ms(torch, timer, c, layer)
        n_bytes = (q.numel() * 4 + _kv_bytes(ctx_list, KV, hd, kind)
                   + c["o"].numel() * 4 + 2 * c["m"].numel() * 4
                   + bt.numel() * 4)
        n_ops = 4.0 * sum(ctx_list) * KV * G * hd
        bms, by = bound_ms(n_bytes, n_ops, TC_BF16_FLOP_S)
        log(f"[kernel] paged_decode {kind} pages B={B} KV={KV} G={G} hd={hd} "
            f"ps={ps} ctx={ctx_list}: max_abs_err={c['err']:.3e} (tol "
            f"{ATTN_ATOL}) empty-lane {'OK' if c['empty_ok'] else 'FAIL'}; "
            f"ops.paged_gqa_decode (fused self token, {str(c['dt'])[6:]} "
            f"q/k/v and out) max_abs_err={c['w_err']:.3e} (tol {ATTN_ATOL}"
            f"{' + 1 bf16 ulp' if c['dt'] == torch.bfloat16 else ''}) "
            f"{'OK' if c['ok'] else 'FAIL'} | kernel {t_k:.4f} ms, fused "
            f"entry {t_f:.4f} ms, plain {t_p:.4f} ms, library(SDPA dense) "
            f"{t_l:.4f} ms, bound {bms:.4f} ms ({by})")
        if not c["ok"]:
            raise AssertionError(f"paged_decode ({kind}) disagrees")
        if kind == "bf16":
            rep = dict(case=f"bf16 pages B=8 ctx={ctx_list}", ms=t_k,
                       fused_ms=t_f, plain_ms=t_p, library_ms=t_l,
                       bound_ms=bms, bound_by=by)
    # a block table far longer than every context (Pa*ps = 8192 keys): the
    # splits past each lane's ctx exit at once
    wide = [0, 5, 64, 128, 129, 200, 255, 300]
    for kind in ("bf16", "int8"):
        c = _decode_check(torch, g, kind, B=B, KV=KV, G=G, hd=hd, ps=ps,
                          Pa=512, layer=layer, ctx_list=wide)
        worst = max(worst, c["err"])
        q, kp, vp, bt, ctx, kw = (c[k] for k in ("q", "kp", "vp", "bt", "ctx",
                                                  "kw"))
        t_k = timer(lambda: paged_attention_kernel(q, kp, vp, bt, ctx, **kw))
        log(f"[kernel] paged_decode {kind} pages, Pa*ps=8192 keys, ctx={wide}"
            f": max_abs_err={c['err']:.3e} (tol {ATTN_ATOL}) empty-lane "
            f"{'OK' if c['empty_ok'] else 'FAIL'}; ops.paged_gqa_decode "
            f"max_abs_err={c['w_err']:.3e} {'OK' if c['ok'] else 'FAIL'} | "
            f"kernel {t_k:.4f} ms")
        if not c["ok"]:
            raise AssertionError(f"paged_decode ({kind}, wide table) "
                                 f"disagrees")
        del c
    # G = 12 (mistral-large-123b 96/8, starcoder2-15b 48/4): more query
    # rows than a decode block holds, two row slices of 6 per kv head
    for kind in ("bf16", "int8"):
        c = _decode_check(torch, g, kind, B=B, KV=KV, G=12, hd=hd, ps=ps,
                          Pa=Pa, layer=layer, ctx_list=ctx_list)
        worst = max(worst, c["err"])
        q, kp, vp, bt, ctx, kw = (c[k] for k in ("q", "kp", "vp", "bt", "ctx",
                                                  "kw"))
        t_k = timer(lambda: paged_attention_kernel(q, kp, vp, bt, ctx, **kw))
        t_f = timer(lambda: pa_ops.paged_gqa_decode(
            c["qh"], c["k_new"], c["v_new"], kp, vp, bt, ctx, **kw))
        log(f"[kernel] paged_decode {kind} pages B={B} KV={KV} G=12 hd={hd} "
            f"ctx={ctx_list}: max_abs_err={c['err']:.3e} (tol {ATTN_ATOL}) "
            f"empty-lane {'OK' if c['empty_ok'] else 'FAIL'}; "
            f"ops.paged_gqa_decode max_abs_err={c['w_err']:.3e} "
            f"{'OK' if c['ok'] else 'FAIL'} | kernel {t_k:.4f} ms, fused "
            f"entry {t_f:.4f} ms")
        if not c["ok"]:
            raise AssertionError(f"paged_decode ({kind}, G=12) disagrees")
        del c
    # one rank's KV heads at tensor parallelism 2 and 4 (phase 11): qwen3-14b's
    # 8 KV heads as 4 and 2, G = 5
    rep["tp_rank"] = {}
    for KV_ in (4, 2):
        for kind in ("bf16", "int8"):
            c = _decode_check(torch, g, kind, B=B, KV=KV_, G=G, hd=hd,
                              ps=ps, Pa=Pa, layer=layer, ctx_list=ctx_list)
            worst = max(worst, c["err"])
            q, kp, vp, bt, ctx, kw = (c[k] for k in ("q", "kp", "vp", "bt",
                                                      "ctx", "kw"))
            t_k = timer(lambda: paged_attention_kernel(q, kp, vp, bt, ctx,
                                                       **kw))
            t_p = timer(lambda: paged_attention_stats_ref(q, kp, vp, bt, ctx,
                                                          **kw))
            t_l = _sdpa_decode_ms(torch, timer, c, layer)
            n_bytes = (q.numel() * 4 + _kv_bytes(ctx_list, KV_, hd, kind)
                       + c["o"].numel() * 4 + 2 * c["m"].numel() * 4
                       + bt.numel() * 4)
            bms, by = bound_ms(n_bytes, 4.0 * sum(ctx_list) * KV_ * G * hd,
                               TC_BF16_FLOP_S)
            rep["tp_rank"][f"KV={KV_} {kind}"] = dict(
                ms=t_k, plain_ms=t_p, library_ms=t_l, bound_ms=bms)
            log(f"[kernel] paged_decode {kind} pages B={B} KV={KV_} G={G} "
                f"hd={hd} ctx={ctx_list} (one rank's heads): max_abs_err="
                f"{c['err']:.3e} (tol {ATTN_ATOL}) empty-lane "
                f"{'OK' if c['empty_ok'] else 'FAIL'}; ops.paged_gqa_decode "
                f"max_abs_err={c['w_err']:.3e} {'OK' if c['ok'] else 'FAIL'}"
                f" | kernel {t_k:.4f} ms, plain {t_p:.4f} ms, "
                f"library(SDPA dense) {t_l:.4f} ms, bound {bms:.4f} ms "
                f"({by})")
            if not c["ok"]:
                raise AssertionError(f"paged_decode ({kind}, KV={KV_}) "
                                     f"disagrees")
            del c
    # the kernel's other compiled shapes: head dims padded to 128 and two
    # chunks of 128, group sizes off the exact buckets
    for kind, hd_, G_ in (("bf16", 64, 8), ("fp32", 256, 3), ("int8", 96, 2)):
        c = _decode_check(torch, g, kind, B=4, KV=2, G=G_, hd=hd_, ps=ps,
                          Pa=24, layer=layer, ctx_list=[0, 1, 129, 384])
        worst = max(worst, c["err"])
        log(f"[kernel] paged_decode {kind} pages hd={hd_} G={G_}: "
            f"max_abs_err={c['err']:.3e} (tol {ATTN_ATOL}); "
            f"ops.paged_gqa_decode max_abs_err={c['w_err']:.3e} "
            f"{'OK' if c['ok'] else 'FAIL'}")
        if not c["ok"]:
            raise AssertionError(f"paged_decode ({kind}, hd={hd_}, G={G_}) "
                                 f"disagrees")
        del c
    rep["max_abs_err"] = worst
    return rep


def _prefill_check(torch, g, kind, self_, *, B, KV, G, C, hd, ps, Pa,
                   layer, ctx_list):
    """The prefill kernel entry (grouped (B, KV, G, C, hd) fp32 queries, fp32
    output) and the adapter's entry (ops.paged_gqa_prefill: (B, C, H, hd)
    queries in the model dtype read in place, output in q's dtype) against
    their plain versions."""
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.paged_attention.kernel import paged_prefill_kernel
    from repro_torch.kernels.paged_attention.ref import (
        paged_gqa_prefill_ref,
        paged_prefill_grouped_ref,
    )

    ctx = torch.tensor(ctx_list, dtype=torch.int32, device=DEV)
    kp, vp, ks, vs, bt = _pool(torch, g, kind=kind, B=B, Pa=Pa, ps=ps, KV=KV,
                               hd=hd)
    dt = _model_dtype(torch, kind)
    q = torch.randn(B, KV, G, C, hd, generator=g, device=DEV)
    kc = torch.randn(B, C, KV, hd, generator=g, device=DEV).to(dt)
    vc = torch.randn(B, C, KV, hd, generator=g, device=DEV).to(dt)
    kw = dict(layer=layer, k_scale=ks, v_scale=vs)
    if self_:
        kw["k_self"] = (kc.float() + 0.1 * torch.randn(
            kc.shape, generator=g, device=DEV)).to(dt)
        kw["v_self"] = (vc.float() + 0.1 * torch.randn(
            vc.shape, generator=g, device=DEV)).to(dt)
    got = paged_prefill_kernel(q, kc, vc, kp, vp, bt, ctx, **kw)
    want = paged_prefill_grouped_ref(q, kc, vc, kp, vp, bt, ctx, **kw)
    err = float((got - want).abs().max())
    qh = q.permute(0, 3, 1, 2, 4).reshape(B, C, KV * G, hd).to(dt)
    out = pa_ops.paged_gqa_prefill(qh, kc, vc, kp, vp, bt, ctx, **kw)
    w_err, w_ok = _within(torch, out, paged_gqa_prefill_ref(
        qh, kc, vc, kp, vp, bt, ctx, **kw))
    w_ok = w_ok and out.dtype == dt and out.shape == qh.shape
    ok = err <= ATTN_ATOL and w_ok and got.dtype == torch.float32
    return dict(q=q, kc=kc, vc=vc, kp=kp, vp=vp, bt=bt, ctx=ctx, kw=kw,
                got=got, err=err, w_err=w_err, ok=ok, dt=dt)


def prefill_cases(torch, timer) -> dict:
    from repro_torch.kernels.paged_attention.kernel import paged_prefill_kernel
    from repro_torch.kernels.paged_attention.ref import (
        paged_prefill_grouped_ref,
    )

    g = torch.Generator(device=DEV)
    g.manual_seed(13)
    B, KV, G, C, hd, ps, Pa, layer = 8, 8, 5, 64, 128, 16, 64, 0
    ctx_list = [0, 16, 64, 100, 128, 300, 777, 1024]
    rep, worst = None, 0.0
    for kind in ("bf16", "fp32", "int8"):
        for self_ in (False, True):
            c = _prefill_check(torch, g, kind, self_, B=B, KV=KV, G=G, C=C,
                               hd=hd, ps=ps, Pa=Pa, layer=layer,
                               ctx_list=ctx_list)
            q, kc, vc, kp, vp, bt, ctx, kw = (
                c[k] for k in ("q", "kc", "vc", "kp", "vp", "bt", "ctx",
                               "kw"))
            worst = max(worst, c["err"])
            t_k = timer(lambda: paged_prefill_kernel(q, kc, vc, kp, vp, bt,
                                                     ctx, **kw))
            t_p = timer(lambda: paged_prefill_grouped_ref(q, kc, vc, kp, vp,
                                                          bt, ctx, **kw))
            t_l = _sdpa_prefill_ms(torch, timer, c, layer)
            n_chunk = kc.numel() * kc.element_size() * (4 if self_ else 2)
            n_bytes = (q.numel() * 4 + _kv_bytes(ctx_list, KV, hd, kind)
                       + n_chunk + c["got"].numel() * 4 + bt.numel() * 4)
            n_ops = sum(4.0 * G * C * hd * KV * (cl + (C + 1) / 2)
                        for cl in ctx_list)
            bms, by = bound_ms(n_bytes, n_ops, TC_BF16_FLOP_S)
            case = kind + (" +self" if self_ else "")
            log(f"[kernel] paged_prefill {case} pages B={B} C={C} KV={KV} "
                f"G={G} hd={hd} ctx={ctx_list}: max_abs_err={c['err']:.3e} "
                f"(tol {ATTN_ATOL}); ops.paged_gqa_prefill ((B, C, H, hd) "
                f"{str(c['dt'])[6:]} q/k/v in, {str(c['dt'])[6:]} out) "
                f"max_abs_err={c['w_err']:.3e} (tol {ATTN_ATOL}"
                f"{' + 1 bf16 ulp' if c['dt'] == torch.bfloat16 else ''}) "
                f"{'OK' if c['ok'] else 'FAIL'} | kernel {t_k:.4f} "
                f"ms, plain {t_p:.4f} ms, library(SDPA dense) {t_l:.4f} ms, "
                f"bound {bms:.4f} ms ({by})")
            if not c["ok"]:
                raise AssertionError(f"paged_prefill ({case}) disagrees")
            if kind == "bf16" and not self_:
                rep = dict(case=f"bf16 pages B=8 C=64 ctx={ctx_list}",
                           ms=t_k, plain_ms=t_p, library_ms=t_l,
                           bound_ms=bms, bound_by=by)
            del c
    # G*C = 85 rows: not a multiple of the kernel's 64-row tile, a row tile
    # that spans two query heads, chunk keys past C masked
    for kind in ("bf16", "fp32", "int8"):
        c = _prefill_check(torch, g, kind, True, B=B, KV=KV, G=G, C=17,
                           hd=hd, ps=ps, Pa=Pa, layer=layer,
                           ctx_list=ctx_list)
        worst = max(worst, c["err"])
        log(f"[kernel] paged_prefill {kind} +self pages C=17 (G*C=85): "
            f"max_abs_err={c['err']:.3e} (tol {ATTN_ATOL}); "
            f"ops.paged_gqa_prefill max_abs_err={c['w_err']:.3e} "
            f"{'OK' if c['ok'] else 'FAIL'}")
        if not c["ok"]:
            raise AssertionError(f"paged_prefill ({kind}, C=17) disagrees")
        del c
    # G = 12 (starcoder2-15b 48/4, mistral-large-123b 96/8), as those
    # engines' prefill ticks run it: 768 query rows per kv head
    for KV_ in (4, 8):
        for kind in ("bf16", "int8"):
            c = _prefill_check(torch, g, kind, False, B=B, KV=KV_, G=12, C=C,
                               hd=hd, ps=ps, Pa=Pa, layer=layer,
                               ctx_list=ctx_list)
            worst = max(worst, c["err"])
            log(f"[kernel] paged_prefill {kind} pages B={B} C={C} KV={KV_} "
                f"G=12 hd={hd}: max_abs_err={c['err']:.3e} (tol "
                f"{ATTN_ATOL}); ops.paged_gqa_prefill max_abs_err="
                f"{c['w_err']:.3e} {'OK' if c['ok'] else 'FAIL'}")
            if not c["ok"]:
                raise AssertionError(f"paged_prefill ({kind}, KV={KV_}, "
                                     f"G=12) disagrees")
            del c
    # one rank's KV heads at tensor parallelism 2 and 4 (phase 11), G = 5: a
    # prefill chunk and, over int8 pages, the K = 4 verifier's (C = 5, the
    # chunk's own K/V overridden on the diagonal)
    rep["tp_rank"] = {}
    for KV_ in (4, 2):
        for kind, self_, C_ in (("bf16", False, C), ("int8", True, 5)):
            c = _prefill_check(torch, g, kind, self_, B=B, KV=KV_, G=G, C=C_,
                               hd=hd, ps=ps, Pa=Pa, layer=layer,
                               ctx_list=ctx_list)
            worst = max(worst, c["err"])
            q, kc, vc, kp, vp, bt, ctx, kw = (
                c[k] for k in ("q", "kc", "vc", "kp", "vp", "bt", "ctx",
                               "kw"))
            t_k = timer(lambda: paged_prefill_kernel(q, kc, vc, kp, vp, bt,
                                                     ctx, **kw))
            t_p = timer(lambda: paged_prefill_grouped_ref(q, kc, vc, kp, vp,
                                                          bt, ctx, **kw))
            t_l = _sdpa_prefill_ms(torch, timer, c, layer)
            n_chunk = kc.numel() * kc.element_size() * (4 if self_ else 2)
            n_bytes = (q.numel() * 4 + _kv_bytes(ctx_list, KV_, hd, kind)
                       + n_chunk + c["got"].numel() * 4 + bt.numel() * 4)
            n_ops = sum(4.0 * G * C_ * hd * KV_ * (cl + (C_ + 1) / 2)
                        for cl in ctx_list)
            bms, by = bound_ms(n_bytes, n_ops, TC_BF16_FLOP_S)
            case = f"KV={KV_} C={C_} {kind}" + (" +self" if self_ else "")
            rep["tp_rank"][case] = dict(ms=t_k, plain_ms=t_p, library_ms=t_l,
                                        bound_ms=bms)
            log(f"[kernel] paged_prefill {case} pages B={B} G={G} hd={hd} "
                f"(one rank's heads): max_abs_err={c['err']:.3e} (tol "
                f"{ATTN_ATOL}); ops.paged_gqa_prefill max_abs_err="
                f"{c['w_err']:.3e} {'OK' if c['ok'] else 'FAIL'} | kernel "
                f"{t_k:.4f} ms, plain {t_p:.4f} ms, library(SDPA dense) "
                f"{t_l:.4f} ms, bound {bms:.4f} ms ({by})")
            if not c["ok"]:
                raise AssertionError(f"paged_prefill ({case}) disagrees")
            del c
    # the other head-dim instantiations (64 and 256, padded from 48 and 200)
    for kind, hd_, G_ in (("bf16", 48, 3), ("fp32", 256, 2), ("int8", 200, 4)):
        c = _prefill_check(torch, g, kind, True, B=3, KV=2, G=G_, C=20,
                           hd=hd_, ps=ps, Pa=16, layer=layer,
                           ctx_list=[0, 33, 250])
        worst = max(worst, c["err"])
        log(f"[kernel] paged_prefill {kind} +self pages hd={hd_} G={G_} C=20: "
            f"max_abs_err={c['err']:.3e} (tol {ATTN_ATOL}); "
            f"ops.paged_gqa_prefill max_abs_err={c['w_err']:.3e} "
            f"{'OK' if c['ok'] else 'FAIL'}")
        if not c["ok"]:
            raise AssertionError(f"paged_prefill ({kind}, hd={hd_}) "
                                 f"disagrees")
        del c
    rep["max_abs_err"] = worst
    return rep


def _spd_hessian(torch, g, n: int, tokens: int = 2048):
    """A damped low-rank SPD proxy Hessian with one dominant channel (the
    shape of a calibration Hessian): X^T X / t + 0.01 mean(diag) I."""
    A = torch.randn(n, max(4, n // 8), generator=g, device=DEV)
    X = torch.randn(tokens, A.shape[1], generator=g, device=DEV) @ A.T
    X[:, 0] *= 10.0
    H = X.T @ X / tokens
    return H + 0.01 * H.diagonal().mean() * torch.eye(n, device=DEV)


def _ldlq_near_ties(torch, W, Q, Udot, maxq, noise=None):
    """Codes of one LDLQ run that its own recurrence does not explain.

    With E = W - Q, every column's value is val_k = W_k + (E @ Udot)[:, k]
    (Udot strictly upper).  Recomputed in fp64, clip(round(val)) must equal
    Q except where val lies within the fp32 summation bound of a rounding
    boundary (x.5, or the drawn uniform for stochastic rounding):
    |err| <= (n + 4) eps (|W| + |E| @ |Udot|).  Returns (mismatches,
    unexplained mismatches)."""
    E = (W - Q).double()
    val = W.double() + E @ Udot.double()
    tol = (W.shape[1] + 4) * EPS32 * (W.abs() + E.abs().float()
                                      @ Udot.abs()).double()
    lo = torch.floor(val)
    if noise is None:
        want = torch.clamp(torch.round(val), 0, maxq)
        near = ((val - lo) - 0.5).abs() <= tol
    else:
        frac = val - lo
        want = torch.clamp(lo + (noise.double() < frac).double(), 0, maxq)
        near = (frac - noise.double()).abs() <= tol
    bad = want != Q.double()
    return int(bad.sum()), int((bad & ~near).sum())


def ldlq_cases(torch, timer) -> dict:
    from repro_torch.core.ldlq import blocked_schedule, ldl_decomposition
    from repro_torch.core.methods import pick_block, round_weights
    from repro_torch.kernels.ldlq import ops as ldlq_ops
    from repro_torch.kernels.ldlq.kernel import COUNTS, ldlq_block_kernel
    from repro_torch.kernels.ldlq.ref import (ldlq_block_ref,
                                              ldlq_block_seq_ref)

    g = torch.Generator(device=DEV)
    g.manual_seed(14)
    hess = {}
    rep, worst, worst_frac = None, 0.0, 0.0
    for m, n, bits, stoch in LDLQ_CASES:
        maxq = 2**bits - 1
        if n not in hess:
            H = _spd_hessian(torch, g, n)
            hess[n] = (H, ldl_decomposition(H)[0])
        H, Udot = hess[n]
        blk = pick_block(n)
        W = torch.rand(m, n, generator=g, device=DEV) * maxq
        noise = (torch.rand(m, n, generator=g, device=DEV) if stoch
                 else None)
        t0 = time.perf_counter()
        Qk = ldlq_ops.ldlq(W, Udot, maxq, block=blk, noise=noise)
        torch.cuda.synchronize()
        t_drv = time.perf_counter() - t0
        # the plain version of the same driver: the shared schedule over
        # the kernel's plain in-block step
        t0 = time.perf_counter()
        Qp = blocked_schedule(W, Udot, maxq, block=blk, step=ldlq_block_ref,
                              noise=noise)
        torch.cuda.synchronize()
        t_plain_drv = time.perf_counter() - t0
        differ = int((Qk != Qp).sum())
        frac = differ / Qk.numel()
        miss, unexplained = _ldlq_near_ties(torch, W, Qk, Udot, maxq, noise)
        via = ""
        if not stoch:
            # the rounding-method registry reaches the kernel at any block
            before = COUNTS["ldlq"]
            Qm = round_weights("ldlq", W, H, maxq)
            launched = COUNTS["ldlq"] - before
            reg_differ = int((Qm != Qk).sum())
            reg_ok = (launched == n // blk
                      and reg_differ / Qk.numel() <= LDLQ_DIFF_FRAC)
            via = (f"; round_weights('ldlq') launched the kernel {launched}"
                   f" times (n/block = {n // blk}), codes differing from "
                   f"ops.ldlq's {reg_differ}")
        else:
            reg_ok = True
        # the in-block kernel alone at this row count: the first block
        nb = min(n, 128)
        Wb, Ub = W[:, :nb], Udot[:nb, :nb].contiguous()
        base = torch.randn(m, nb, generator=g, device=DEV)
        nz = None if noise is None else noise[:, :nb]
        Qb, Eb = ldlq_block_kernel(Wb, base, Ub, maxq=maxq, noise=nz)
        Qr, Er = ldlq_block_ref(Wb, base, Ub, maxq=maxq, noise=nz)
        e_ok = bool(torch.equal(Eb, Wb - Qb))
        # bit for bit: the kernel's own summation order emulated in plain
        # PyTorch, and a second launch
        Qs, Es = ldlq_block_seq_ref(Wb, base, Ub, maxq=maxq, noise=nz)
        seq_ok = bool(torch.equal(Qb, Qs) and torch.equal(Eb, Es))
        Q2, E2 = ldlq_block_kernel(Wb, base, Ub, maxq=maxq, noise=nz)
        same = bool(torch.equal(Q2, Qb) and torch.equal(E2, Eb))
        del Qs, Es, Q2, E2
        t_k = timer(lambda: ldlq_block_kernel(Wb, base, Ub, maxq=maxq,
                                              noise=nz))
        t_p = timer(lambda: ldlq_block_ref(Wb, base, Ub, maxq=maxq,
                                           noise=nz))
        n_bytes = (4 + (nz is not None)) * m * nb * 4 + nb * nb * 4
        bms, by = bound_ms(n_bytes, m * nb * (nb - 1.0))
        blk_frac = float((Qb != Qr).float().mean())
        blk_err = max(float((Qb - Qr).abs().max()),
                      float((Eb - Er).abs().max()))
        worst = max(worst, blk_err)
        worst_frac = max(worst_frac, frac, blk_frac)
        ok = (unexplained == 0 and e_ok and reg_ok and frac <= LDLQ_DIFF_FRAC
              and blk_frac <= LDLQ_DIFF_FRAC and seq_ok and same)
        log(f"[kernel] ldlq m={m} n={n} block={blk} bits={bits}"
            f"{' stochastic' if stoch else ''}: codes differing from the "
            f"plain driver {differ} of {Qk.numel()} ({frac:.2e}, tol "
            f"{LDLQ_DIFF_FRAC:g}); kernel codes its own fp64 recurrence does "
            f"not reproduce {miss}, of them away from a tie "
            f"{unexplained} (tol 0); E == W - Q {'yes' if e_ok else 'NO'}"
            f"{via}; block kernel vs plain block: {blk_frac:.2e} of codes "
            f"differ (tol {LDLQ_DIFF_FRAC:g}), max |dQ|, |dE| {blk_err:g}; "
            f"Q and E equal ldlq_block_seq_ref "
            f"{'yes' if seq_ok else 'NO'}, second launch bit-identical "
            f"{'yes' if same else 'NO'} "
            f"{'OK' if ok else 'FAIL'} | block (M={m}, nb={nb}) kernel "
            f"{t_k:.4f} ms, plain {t_p:.4f} ms, library none (no single "
            f"PyTorch call computes it), bound {bms:.4f} ms ({by}); whole "
            f"driver {t_drv * 1e3:.1f} ms (plain driver "
            f"{t_plain_drv * 1e3:.1f} ms), host clock, one run")
        if not ok:
            raise AssertionError(f"ldlq disagrees at m={m} n={n} "
                                 f"bits={bits} stochastic={stoch}")
        if rep is None or (m, n, bits, stoch) == (5120, 17408, 2, False):
            rep = dict(case="block M=5120 nb=128, 2-bit (mlp.wo rows)",
                       ms=t_k, plain_ms=t_p, library_ms=None,
                       bound_ms=bms, bound_by=by)
    del hess
    # the block kernel against the plain block on the same inputs; codes
    # (of the whole driver or one block) may differ at near-ties, a
    # fraction bounded above
    rep["max_abs_err"] = worst
    rep["codes_differ_frac"] = worst_frac
    return rep


def kron_cases(torch, timer) -> dict:
    from repro_torch.core.incoherence import kron_factors, random_orthogonal
    from repro_torch.kernels.kron_mul import ops as kron_ops
    from repro_torch.kernels.kron_mul.kernel import kron_mul_kernel
    from repro_torch.kernels.kron_mul.ref import kron_mul_ref

    g = torch.Generator(device=DEV)
    g.manual_seed(15)
    rows, worst = {}, 0.0
    for n, N in KRON_CASES:
        p, q = kron_factors(n)
        A = random_orthogonal(p, g, device=DEV) if p > 1 else None
        B = random_orthogonal(q, g, device=DEV)
        x = torch.randn(N, n, generator=g, device=DEV)
        perm = torch.randperm(n, generator=g, device=DEV)
        inv = torch.argsort(perm)
        D = torch.rand(n, generator=g, device=DEV) + 0.5
        Aa = None if A is None else A.abs()
        # the three entries the port calls: the transform alone, the
        # forward one of QuantizedLinear (gather and D folded in) and the
        # inverse one (transposed factors, inverse permutation); each
        # against the plain composition, two fp32 products of q then p
        # terms on each side
        entries = {
            "plain": {},
            "forward": dict(perm=perm, inv_perm=inv, scale=D),
            "inverse": dict(perm=perm, inv_perm=inv, transpose=True),
        }
        errs, ok, same = {}, True, True
        for name, kw in entries.items():
            got = kron_mul_kernel(x, A, B, **kw)
            d = (got - kron_mul_ref(x, A, B, **kw)).abs()
            bound = 2 * (p + q + 1) * EPS32 * kron_mul_ref(x.abs(), Aa,
                                                           B.abs(), **kw)
            ok = ok and bool((d <= bound).all())
            errs[name] = (float(d.max()), float((d / bound).max()))
            # deterministic: a second launch is bit-identical
            same = same and torch.equal(got, kron_mul_kernel(x, A, B, **kw))
        # a row-strided x is read in place: the same bits
        xs = torch.empty(N, n + 4, device=DEV)
        xs[:, :n] = x
        same = same and torch.equal(
            kron_mul_kernel(xs[:, :n], A, B, **entries["forward"]),
            kron_mul_kernel(x, A, B, **entries["forward"]))
        del xs
        # the wrapper on a 3-D view with transposed factor views (copied
        # by the binding) against the plain version
        xw = x.reshape(N, 1, n)
        At = None if A is None else A.T
        dw = (kron_ops.kron_mul(xw, At, B.T) - kron_mul_ref(xw, At, B.T))
        ok_w = bool((dw.abs().reshape(N, n) <= 2 * (p + q + 1) * EPS32 *
                     kron_mul_ref(x.abs(), Aa, B.abs()).max()).all())
        err = max(e for e, _ in errs.values())
        worst = max(worst, err)
        fw = entries["forward"]
        t_k = timer(lambda: kron_mul_kernel(x, A, B))
        t_f = timer(lambda: kron_mul_kernel(x, A, B, **fw))
        t_p = timer(lambda: kron_mul_ref(x, A, B))
        t_pf = timer(lambda: kron_mul_ref(x, A, B, **fw))
        K = B if A is None else torch.kron(A, B)
        t_l = timer(lambda: torch.matmul(x, K.T))
        del K
        # x and y once, the factors once; operations counted once per
        # multiply-add at the TF32 tensor cores' peak (the kernel runs
        # three products per multiply-add); the fused forward entry also
        # reads one int64 permutation and D
        n_ops = 2.0 * N * n * (p + q)
        n_bytes = 2 * N * n * 4 + (p * p + q * q) * 4
        bms, by = bound_ms(n_bytes, n_ops, TC_TF32_FLOP_S)
        bms_f, _ = bound_ms(n_bytes + n * 12, n_ops, TC_TF32_FLOP_S)
        log(f"[kernel] kron_mul n={n}={p}x{q} N={N}: max_abs_err "
            + ", ".join(f"{k} {e:.3e} ({r:.4f} of the gate)"
                        for k, (e, r) in errs.items())
            + f"; ops.kron_mul (3-D, transposed factor views) "
            f"max_abs_err={float(dw.abs().max()):.3e}; two launches and a "
            f"row-strided x bit-identical {'yes' if same else 'NO'} "
            f"{'OK' if ok and ok_w and same else 'FAIL'} | kernel "
            f"{t_k:.4f} ms, fused forward {t_f:.4f} ms, plain {t_p:.4f} ms, "
            f"plain composition (divide, gather, two matmuls) {t_pf:.4f} ms, "
            f"library(matmul with dense A⊗B) {t_l:.4f} ms, bound "
            f"{bms:.4f} ms ({by}; fused {bms_f:.4f})")
        if not (ok and ok_w and same):
            raise AssertionError(f"kron_mul disagrees at n={n} N={N}")
        rows[(n, N)] = dict(ms=t_k, fused_ms=t_f, plain_ms=t_p,
                            plain_fused_ms=t_pf, library_ms=t_l,
                            bound_ms=bms, bound_by=by)
    rep = dict(case="n=5120=64x80 N=5120 (a Hessian's rows)",
               **rows[(5120, 5120)])
    rep["decode"] = dict(case="n=17408=128x136 N=8 (decode mlp.wi/wg U)",
                         **rows[(17408, 8)])
    rep["prefill"] = dict(case="n=17408=128x136 N=512 (prefill mlp.wi/wg U)",
                          **rows[(17408, 512)])
    # the other dense widths' factor pairs (PERF.md's kron_mul rows)
    rep["dense_widths"] = {
        f"n={n}={'x'.join(map(str, kron_factors(n)))} N={N}": row
        for (n, N), row in rows.items()
        if n in (512, 6144, 8192, 12288, 24576, 28672, 29568)}
    rep["max_abs_err"] = worst
    return rep


def hadamard_cases(torch, timer) -> dict:
    import math

    from repro_torch.kernels.hadamard import ops as had_ops
    from repro_torch.kernels.hadamard.kernel import hadamard_kernel
    from repro_torch.kernels.hadamard.ref import hadamard_ref, sylvester

    g = torch.Generator(device=DEV)
    g.manual_seed(16)
    rep, worst = None, 0.0
    for n, N in HADAMARD_CASES:
        s = (torch.randint(0, 2, (n,), generator=g, device=DEV) * 2
             - 1).float()
        x = torch.randn(N, n, generator=g, device=DEV)
        # log2(n) rounded additions per output on each side, relative to
        # sum|x|/sqrt(n)
        bound = (2 * (math.log2(n) + 1) * EPS32
                 * x.abs().sum(-1, keepdim=True) / math.sqrt(n))
        ok, err, exact, same = True, 0.0, True, True
        for tr in (False, True):
            got = hadamard_kernel(x, s, transpose=tr)
            want = hadamard_ref(x, s, transpose=tr)
            d = (got - want).abs()
            ok = ok and bool((d <= bound).all())
            err = max(err, float(d.max()))
            # the same additions in the same order: bit for bit, and a
            # second launch too
            exact = exact and bool(torch.equal(got, want))
            same = same and bool(torch.equal(
                got, hadamard_kernel(x, s, transpose=tr)))
            del got, want, d
        odd = 17 if N % 17 == 0 else 1
        xw = x.reshape(N // odd, odd, n)
        ok_w = torch.equal(had_ops.hadamard_transform(xw, s),
                           hadamard_kernel(x, s).reshape(N // odd, odd, n))
        worst = max(worst, err)
        M = sylvester(n, device=DEV) * s * n**-0.5
        t_k = timer(lambda: hadamard_kernel(x, s))
        t_p = timer(lambda: hadamard_ref(x, s))
        t_l = timer(lambda: torch.matmul(x, M.T))
        del M
        bms, by = bound_ms(2 * N * n * 4 + n * 4, N * n * (math.log2(n) + 1))
        log(f"[kernel] hadamard n={n} N={N}: max_abs_err={err:.3e} (bound "
            f"max {float(bound.max()):.3e}, H S x and S H x); equal to "
            f"hadamard_ref, both directions, {'yes' if exact else 'NO'}; "
            f"second launch bit-identical {'yes' if same else 'NO'}; "
            f"ops.hadamard_transform on the (N/{odd}, {odd}, n) view equal "
            f"{'yes' if ok_w else 'NO'} "
            f"{'OK' if ok and ok_w and exact and same else 'FAIL'} | "
            f"kernel {t_k:.4f} ms, plain {t_p:.4f} ms, library(matmul with "
            f"dense diag(s)H/sqrt(n)) {t_l:.4f} ms, bound {bms:.4f} ms "
            f"({by})")
        if not (ok and ok_w and exact and same):
            raise AssertionError(f"hadamard disagrees at n={n} N={N}")
        if rep is None or (n, N) == (1024, 17408 * 17):
            rep = dict(case="n=1024 N=17408*17 (an mlp.wo Hessian's rows)",
                       ms=t_k, plain_ms=t_p, library_ms=t_l, bound_ms=bms,
                       bound_by=by)
    rep["max_abs_err"] = worst
    return rep


def phase_kernels(torch) -> dict:
    timer = Timer(torch)
    reps = {
        "quant_matmul": qmm_cases(torch, timer),
        "paged_decode": decode_cases(torch, timer),
        "paged_prefill": prefill_cases(torch, timer),
        "ldlq": ldlq_cases(torch, timer),
        "kron_mul": kron_cases(torch, timer),
        "hadamard": hadamard_cases(torch, timer),
    }
    del timer
    torch.cuda.empty_cache()
    return reps


# ---------------------------------------------------------------------------
# phase 4 + 5: serve the full model, then check it
# ---------------------------------------------------------------------------


def _counts():
    from repro_torch.kernels import launch_counts

    return launch_counts()


def serve_requests(torch, qm, prompts, *, gen: int, arrive, args,
                   tracer=None) -> tuple:
    """Serve ``prompts`` through the engine (``--paged --paged-prefill``),
    request i submitted just before engine tick ``arrive[i]``.  Arrivals
    count ticks, not wall-clock time, so every run schedules the same ticks
    and launches the same kernels.  ``tracer`` is attached to the engine
    (phase 10).  Returns (adapter, reqs, record), the record with the
    kernel launches of this run alone, the summed host wall of its ticks
    and the engine's summary."""
    from repro_torch.kernels import reset_counts
    from repro_torch.launch.serve import build_engine
    from repro_torch.serve.adapter import CachedDecoder

    n_req, prompt_len = len(arrive), prompts.shape[1]
    adapter = CachedDecoder.from_quantized(qm)
    engine = build_engine(adapter, max_seq_len=prompt_len + gen, args=args,
                          record_logits=True)
    if tracer is not None:
        engine.attach_tracer(tracer)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    decode_ticks = []
    reqs = []
    engine.reset_clock()
    t0 = time.perf_counter()
    tick = 0
    tick_s = 0.0
    while len(reqs) < n_req or not engine.idle:
        while len(reqs) < n_req and arrive[len(reqs)] <= tick:
            reqs.append(engine.submit(prompts[len(reqs)], max_new=gen,
                                      arrival=engine.now()))
        before = _counts()
        t_tick = time.perf_counter()
        engine.tick()
        tick_s += time.perf_counter() - t_tick
        tick += 1
        after = _counts()
        delta = {k: after[k] - before[k] for k in after}
        if delta["paged_decode"] and not delta["paged_prefill"]:
            decode_ticks.append(delta)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _counts()
    s = engine.summary()
    total = sum(len(r.out_tokens) for r in reqs)
    peak = torch.cuda.max_memory_allocated()
    log(f"[serve] {n_req} requests x (prompt {prompt_len} + gen {gen}), "
        f"submitted before ticks {list(arrive)}, --paged --paged-prefill: "
        f"{total} tokens in {wall:.2f}s = {total / wall:.1f} tok/s; ticks "
        f"{tick}, steps {s['steps']}, prefill batches "
        f"{s['prefill_batches']} (widest {s['prefill_batch_size']}), "
        f"evictions {s['evictions']}")
    log(f"[serve] ttft p50 {s['ttft_s_p50'] * 1e3:.1f} ms p99 "
        f"{s['ttft_s_p99'] * 1e3:.1f} ms; itl p50 "
        f"{s['itl_s_p50'] * 1e3:.1f} ms p99 {s['itl_s_p99'] * 1e3:.1f} ms; "
        f"peak torch.cuda.max_memory_allocated {peak / 2**30:.2f} GiB")
    per_tick = {k: sorted({d[k] for d in decode_ticks}) for k in launches}
    log(f"[serve] kernel launches in the run: {launches}; per decode-only "
        f"tick: {per_tick} over {len(decode_ticks)} such ticks")
    bad = [r for r in reqs if len(r.out_tokens) != gen
           or r.finish_reason != "length"]
    if bad or engine.pool.pages_in_use:
        raise AssertionError(f"{len(bad)} requests unfinished, "
                             f"{engine.pool.pages_in_use} pages leaked")
    missing = [k for k in SERVE_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the serve path: "
                             f"{missing}")
    return adapter, reqs, {"launches": launches, "tok_s": total / wall,
                           "tick_s": tick_s, "ticks": tick, "summary": s,
                           "peak_bytes": peak}


def check_logits(torch, qm, prompts, reqs, *, atol, mean_atol,
                 tag: str = "check") -> dict:
    """Every emitted position re-run teacher-forced through the recompute
    oracle (``QuantizedModel.logits(plain=True)``: every linear's
    transforms and grid matmul as plain PyTorch on the card, no kernel)
    and held against the engine's logits: max and mean |diff| within their
    limits, every token the argmax of the engine's own logits, and a token
    differing from the oracle's argmax only where the oracle's top-2 margin
    is below twice the max |diff|.  Requests are batched through the
    oracle in groups of equal prompt length and emitted count (one group
    when every request ran to the same length); a request that emitted
    nothing is skipped.  ``atol=None`` prints the reading without a
    gate."""
    import numpy as np

    t0 = time.perf_counter()
    groups: dict = {}
    for i, r in enumerate(reqs):
        if r.out_tokens:
            groups.setdefault((len(prompts[i]), len(r.out_tokens)),
                              []).append(i)
    parts = []
    for (prompt_len, _), idx in groups.items():
        seqs = np.stack([np.concatenate([prompts[i], reqs[i].out_tokens[:-1]])
                         for i in idx]).astype(np.int64)
        with torch.no_grad():
            want = qm.logits(torch.as_tensor(seqs, device=DEV), plain=True)
            oracle_dtype = str(want.dtype)[6:]
            want = want[:, prompt_len - 1:].float()  # (n, emitted, V)
        got = torch.as_tensor(
            np.stack([np.stack(reqs[i].step_logits) for i in idx]),
            device=DEV).float()
        if got.shape != want.shape:
            raise AssertionError(f"logits {tuple(got.shape)} vs oracle "
                                 f"{tuple(want.shape)}")
        toks = torch.as_tensor(np.stack([reqs[i].out_tokens for i in idx]),
                               device=DEV)
        top2 = torch.topk(want, 2, dim=-1).values
        parts.append({
            "finite": bool(torch.isfinite(got).all()),
            "diff": (got - want).abs(),
            "sq": float(want.pow(2).sum()), "n": want.numel(),
            "own": bool((toks == torch.argmax(got, -1)).all()),
            "margin": top2[..., 0] - top2[..., 1],
            "flips": toks != torch.argmax(want, -1),
        })
    n_pos = sum(p["flips"].numel() for p in parts)
    finite = all(p["finite"] for p in parts)
    max_diff = max(float(p["diff"].max()) for p in parts)
    mean_diff = (sum(float(p["diff"].sum()) for p in parts)
                 / sum(p["diff"].numel() for p in parts))
    rms = (sum(p["sq"] for p in parts) / sum(p["n"] for p in parts)) ** 0.5
    own = all(p["own"] for p in parts)
    n_flips = sum(int(p["flips"].sum()) for p in parts)
    unexplained = sum(int((p["flips"] & (p["margin"] >= 2 * max_diff)).sum())
                      for p in parts)
    gate, mgate = (("no gate: information only", "") if atol is None else
                   (f"tol {atol}", f" (tol {mean_atol})"))
    log(f"[{tag}] {n_pos} positions teacher-forced "
        f"through the recompute oracle in {time.perf_counter() - t0:.1f}s: "
        f"logit max |diff| {max_diff:.4f} ({gate}), mean |diff| "
        f"{mean_diff:.5f}{mgate}, oracle logit rms "
        f"{rms:.3f} ({oracle_dtype}); tokens are "
        f"the argmax of the engine's logits: {'yes' if own else 'NO'}; "
        f"tokens that differ from the oracle argmax: {n_flips} (all at a "
        f"top-2 margin < 2 x max |diff|: "
        f"{'yes' if unexplained == 0 else 'NO'})")
    if atol is not None and (not finite or max_diff > atol
                             or mean_diff > mean_atol or not own
                             or unexplained):
        raise AssertionError(f"[{tag}] engine logits disagree with the "
                             f"oracle")
    return {"max_diff": max_diff, "mean_diff": mean_diff}


def phase_serve(torch, *, seed: int, layers: int) -> dict:
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import make_calibration
    from repro_torch.serve.artifacts import load_quantized, save_quantized
    from repro_torch.serve.synthetic import QUIP_CONFIG, synthetic_quantized_model

    cfg = get_config("qwen3-14b")
    if layers != cfg.n_layers:
        log(f"[serve] DEPTH CUT: {layers} of {cfg.n_layers} layers "
            f"(full width kept)")
        cfg = dataclasses.replace(cfg, n_layers=layers)
    t0 = time.perf_counter()
    qm = synthetic_quantized_model(cfg, seed=seed, device=DEV)
    torch.cuda.synchronize()
    log(f"[serve] synthetic 2-bit {cfg.name}: {cfg.n_layers} layers, "
        f"d_model {cfg.d_model}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, "
        f"{cfg.dtype}; built on the card in {time.perf_counter() - t0:.1f}s")
    art = WORK_DIR / "artifact"
    shutil.rmtree(art, ignore_errors=True)
    t0 = time.perf_counter()
    path = save_quantized(art, qm, QUIP_CONFIG, extra_meta={"seed": seed})
    n_bytes = sum(p.stat().st_size for p in path.iterdir())
    t_save = time.perf_counter() - t0
    del qm
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    qm, meta = load_quantized(art, device=DEV, verify=True)
    torch.cuda.synchronize()
    log(f"[serve] artifact {n_bytes / 1e9:.2f} GB saved in {t_save:.1f}s, "
        f"loaded back with SHA-256 verified in "
        f"{time.perf_counter() - t0:.1f}s ({path})")

    # a burst of four (one batched prefill), then one joining every other
    # tick while the others decode
    prompt_len, gen = 128, 32
    arrive = (0, 0, 0, 0, 3, 5, 7, 9)
    prompts = make_calibration(cfg.vocab, n_segments=len(arrive),
                               seg_len=prompt_len, seed=seed + 3)
    adapter, reqs, rec = serve_requests(torch, qm, prompts, gen=gen,
                                        arrive=arrive, args=SERVE_ARGS)
    # ---- phase 5: teacher-forced recompute oracle on the plain paths ----
    rec["check"] = check_logits(torch, qm, prompts, reqs, atol=LOGIT_ATOL,
                                mean_atol=LOGIT_MEAN_ATOL)
    profile_ticks(torch, adapter, SERVE_ARGS, prompts, dryrun_tick=True)
    shutil.rmtree(art, ignore_errors=True)
    rec["reqs"] = dict(enumerate(reqs))  # phase 11's baseline streams
    return rec


def _add_outliers(torch, params, g) -> None:
    """Give every block linear sparse large outliers, as LLM weights have
    (the repo's tests build their weights the same way:
    ``tests/conftest.py::make_weights``, 0.5 % of entries at 25x the bulk
    std).  A pure Gaussian init already has µ(W) near sqrt(2 ln mn), which
    no rotation lowers, so check (b) would test nothing on it."""
    for lp in params["layers"]:
        for grp in ("attn", "mlp"):
            for key, w in lp[grp].items():
                if key.startswith("w"):
                    hit = torch.rand(w.shape, generator=g,
                                     device=w.device) < OUTLIER_FRAC
                    big = torch.randn(w.shape, generator=g, device=w.device)
                    std = w.float().std()
                    lp[grp][key] = (w.float() + hit * big * OUTLIER_SCALE
                                    * std).to(w.dtype)


def phase_quantize(torch, *, seed: int, layers: int, segments: int,
                   seg_len: int, chunk: int) -> dict:
    """Phase 6: quantize qwen3-14b at full width (depth cut to ``layers``
    blocks) through the port's quantize path, check what the paper claims
    of it, save and reload the artifact, and serve it."""
    import dataclasses
    import math

    from repro_torch.configs import get_config
    from repro_torch.core.proxy import proxy_loss
    from repro_torch.core.quantizer import QuipConfig, quantize_layer
    from repro_torch.data.synthetic import make_calibration
    from repro_torch.kernels import reset_counts
    from repro_torch.launch.quantize import (
        DENSE_LINEARS,
        block_hessians,
        fp_model,
        perplexity,
        quantize_dense_model,
    )
    from repro_torch.models import layers as L
    from repro_torch.models.transformer import init_decoder
    from repro_torch.serve.artifacts import load_quantized, save_quantized
    from repro_torch.serve.quality import build_quality_section

    full = get_config("qwen3-14b")
    cfg = dataclasses.replace(full, n_layers=layers)
    log(f"[quantize] DEPTH CUT: {layers} of {full.n_layers} blocks "
        f"(full width: d_model {cfg.d_model}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab}, {cfg.dtype})")
    if segments != 128 or seg_len != 2048:
        log(f"[quantize] CALIBRATION CUT: {segments} x {seg_len} tokens "
            f"(the paper's 128 x 2048)")
    t0 = time.perf_counter()
    g = torch.Generator(device=DEV)
    g.manual_seed(seed)
    params = init_decoder(cfg, g, device=DEV)
    _add_outliers(torch, params, g)
    calib = make_calibration(cfg.vocab, n_segments=segments,
                             seg_len=seg_len, seed=seed + 7)
    qcfg = QuipConfig(bits=2, method="ldlq", transform="kronecker",
                      use_kernel=False)
    torch.cuda.synchronize()
    log(f"[quantize] fp params (init_decoder, seed {seed}, plus outliers "
        f"in {OUTLIER_FRAC:.1%} of each linear's entries at "
        f"{OUTLIER_SCALE:g}x its std) and "
        f"{segments} x {seg_len} calibration tokens in "
        f"{time.perf_counter() - t0:.1f}s; {qcfg.label()} "
        f"transform={qcfg.transform} calib_chunk={chunk}; TF32 off")

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    qm = quantize_dense_model(params, cfg, qcfg, calib, seed=seed,
                              calib_chunk=chunk, profile=True)
    torch.cuda.synchronize()
    t_quant = time.perf_counter() - t0
    launches = _counts()
    log(f"[quantize] {layers} blocks in {t_quant:.1f}s, peak "
        f"torch.cuda.max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; kernel "
        f"launches {launches}")
    mu_bad = []
    for i, (blk_stats, prof) in enumerate(zip(qm.stats, qm.profile)):
        ph = prof["phases"]
        log(f"[quantize] block {i}: {prof['seconds']:.1f}s = hessians "
            f"{ph['hessians']:.1f} + preprocess {ph['preprocess']:.1f} + "
            f"ldlq {ph['round']:.1f} + pack {ph['pack']:.1f} + stats eigh "
            f"{ph['stats_eigh']:.1f} + stats other {ph['stats']:.1f} + "
            f"calibration forward {ph['forward']:.1f} (s, device-"
            f"synchronized); launches ldlq {prof['launches']['ldlq']}, "
            f"kron_mul {prof['launches']['kron_mul']}")
        for name, st in blk_stats.items():
            log(f"[quantize]   {i}/{name:8s} ({st['m']}x{st['n']}): "
                f"proxy_rel {st['proxy_rel']:.4f}, mu_w {st['mu_w_pre']:.2f}"
                f" -> {st['mu_w_post']:.2f}, mu_h {st['mu_h_pre']:.2f} -> "
                f"{st['mu_h_post']:.2f}, h_cond {st['h_cond']:.3g}, "
                f"wall_s {st['wall_s']:.1f}")
            if not st["mu_w_post"] < st["mu_w_pre"]:
                mu_bad.append(f"{i}/{name}")
    log(f"[quantize] (b) mu_w_post < mu_w_pre on every linear: "
        f"{'yes' if not mu_bad else 'NO ' + str(mu_bad)}")
    if mu_bad:
        raise AssertionError(f"incoherence did not lower mu_w: {mu_bad}")

    art = WORK_DIR / "quantized"
    shutil.rmtree(art, ignore_errors=True)
    t0 = time.perf_counter()
    path = save_quantized(art, qm, qcfg, extra_meta={
        "stats": qm.stats, "seed": seed, "smoke": False,
        "quality": build_quality_section(qm.stats)})
    t_save = time.perf_counter() - t0
    n_bytes = sum(p.stat().st_size for p in path.iterdir())

    eval_tokens = torch.as_tensor(make_calibration(
        cfg.vocab, n_segments=8, seg_len=seg_len, seed=seed + 99),
        dtype=torch.int64, device=DEV)
    t0 = time.perf_counter()
    ppl_fp = perplexity(fp_model(params, cfg).logits, eval_tokens, batch=1)
    ppl_q = perplexity(qm.logits, eval_tokens, batch=1)
    log(f"[quantize] perplexity of the {layers}-block model on 8 x "
        f"{seg_len} eval tokens: fp {ppl_fp:.2f}, quantized {ppl_q:.2f} "
        f"({time.perf_counter() - t0:.1f}s)")
    if not (math.isfinite(ppl_fp) and math.isfinite(ppl_q)):
        raise AssertionError("perplexity is not finite")

    # (a) and (c) on block 0's mlp.wo (n = 17408), from its Hessian
    t0 = time.perf_counter()
    lp0 = params["layers"][0]
    x0 = L.embed(params["embed"], torch.as_tensor(calib, device=DEV))
    pos = torch.arange(seg_len, dtype=torch.int32, device=DEV)
    with torch.no_grad():
        H = block_hessians(lp0, x0, cfg, pos, chunk=chunk)["mlp.wo"]
    del x0
    W = lp0["mlp"]["wo"].T.to(torch.float32)
    lseed = seed * 1000 + DENSE_LINEARS.index("mlp.wo")
    loss = {}
    for method in ("ldlq", "near"):
        layer, _ = quantize_layer(W, H, dataclasses.replace(qcfg,
                                                            method=method),
                                  seed=lseed, collect_stats=False)
        loss[method] = float(proxy_loss(layer.dequantize(), W, H))
    served_rel = qm.stats[0]["mlp.wo"]["proxy_loss"]
    ok_a = loss["ldlq"] < loss["near"]
    log(f"[quantize] (a) block 0 mlp.wo ({W.shape[0]}x{W.shape[1]}), same "
        f"transforms: proxy loss ldlq {loss['ldlq']:.6g} < near "
        f"{loss['near']:.6g}: {'yes' if ok_a else 'NO'} (ratio "
        f"{loss['ldlq'] / loss['near']:.3f}; the quantize run's own "
        f"{served_rel:.6g})")
    reset_counts()
    had, _ = quantize_layer(W, H, dataclasses.replace(qcfg,
                                                      transform="hadamard"),
                            seed=lseed, collect_stats=False)
    x = torch.randn(8, W.shape[1], generator=g, device=DEV)
    with torch.no_grad():
        y = had(x)
        y_ref = x @ had.dequantize(plain=True).T  # no kernel
    rel = float(torch.linalg.norm(y - y_ref) / torch.linalg.norm(y_ref))
    had_launches = _counts()
    ok_c = rel <= HADAMARD_LINEAR_RTOL and had_launches["hadamard"] > 0
    log(f"[quantize] (c) block 0 mlp.wo with --transform hadamard: "
        f"hadamard launches {had_launches['hadamard']}, forward vs dense "
        f"dequantize() product relative error {rel:.2e} (tol "
        f"{HADAMARD_LINEAR_RTOL:g}) {'OK' if ok_c else 'FAIL'} "
        f"({time.perf_counter() - t0:.1f}s for (a) and (c))")
    del H, W, had
    if not ok_a:
        raise AssertionError("LDLQ's proxy loss is not below nearest's")
    if not ok_c:
        raise AssertionError("the hadamard linear failed its check")
    missing = [k for k in QUANT_KERNELS if launches[k] == 0]
    log(f"[quantize] (d) launched on the quantize path: "
        f"{ {k: launches[k] for k in QUANT_KERNELS} }, hadamard on the "
        f"hadamard linear: {had_launches['hadamard']}")
    if missing or had_launches["hadamard"] == 0:
        raise AssertionError(f"kernels never launched: {missing}")

    del qm, params
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    qm, meta = load_quantized(art, device=DEV, verify=True)
    torch.cuda.synchronize()
    log(f"[quantize] artifact {n_bytes / 1e9:.2f} GB saved in "
        f"{t_save:.1f}s, loaded back with SHA-256 verified in "
        f"{time.perf_counter() - t0:.1f}s; manifest quality section: "
        f"{meta['quality']['aggregate']['n_layers']} layers")
    prompt_len, gen = 128, 16
    arrive = (0, 0, 0, 0)
    prompts = make_calibration(cfg.vocab, n_segments=len(arrive),
                               seg_len=prompt_len, seed=seed + 3)
    _, reqs, rec = serve_requests(torch, qm, prompts, gen=gen,
                                  arrive=arrive, args=SERVE_ARGS)
    chk = check_logits(torch, qm, prompts, reqs, atol=QUANT_LOGIT_ATOL,
                       mean_atol=QUANT_LOGIT_MEAN_ATOL, tag="quantize-check")
    # the artifact stays (under WORK_DIR) for phase 10's corrupt_shard load
    # and quality-baseline round trip
    return {"launches": launches, "hadamard_launches": had_launches,
            "serve_launches": rec["launches"], "seconds": t_quant,
            "ppl": (ppl_fp, ppl_q), "check": chk, "tok_s": rec["tok_s"],
            "artifact": art}


def _serve_synthetic(torch, arch: str, *, layers: int, seed: int,
                     prompt_len: int, gen: int, arrive, profile: bool = False
                     ) -> dict:
    """Serve a seeded synthetic 2-bit ``arch`` (Kronecker transforms) at full
    width, depth ``layers``, with ``--paged --paged-prefill``, hold the
    engine's logits to the recompute oracle within the model's gate, and
    with ``profile`` time a prefill tick and decode ticks."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import make_calibration
    from repro_torch.serve.synthetic import synthetic_quantized_model

    cfg = get_config(arch)
    if layers != cfg.n_layers:
        log(f"[{arch}] DEPTH CUT: {layers} of {cfg.n_layers} layers (full "
            f"width kept)")
        cfg = dataclasses.replace(cfg, n_layers=layers)
    t0 = time.perf_counter()
    qm = synthetic_quantized_model(cfg, seed=seed, device=DEV)
    torch.cuda.synchronize()
    log(f"[{arch}] synthetic 2-bit {cfg.name}: {cfg.n_layers} layers, "
        f"d_model {cfg.d_model}, d_ff {cfg.d_ff} (mlp {cfg.mlp}), heads "
        f"{cfg.n_heads}/{cfg.n_kv_heads} (G = "
        f"{cfg.n_heads // cfg.n_kv_heads}), vocab {cfg.vocab}, {cfg.dtype}; "
        f"built on the card in {time.perf_counter() - t0:.1f}s")
    prompts = make_calibration(cfg.vocab, n_segments=len(arrive),
                               seg_len=prompt_len, seed=seed + 3)
    adapter, reqs, rec = serve_requests(torch, qm, prompts, gen=gen,
                                        arrive=arrive, args=SERVE_ARGS)
    atol, mean_atol = DENSE_LOGIT_GATES[arch]
    rec["check"] = check_logits(torch, qm, prompts, reqs, atol=atol,
                                mean_atol=mean_atol, tag=f"{arch}-check")
    if profile:
        profile_ticks(torch, adapter, SERVE_ARGS, prompts)
    del qm, adapter, reqs
    torch.cuda.empty_cache()
    return rec


def phase_dense_family(torch, *, seed: int) -> dict:
    """Phase 7: the rest of the dense family at full width.  (a) a synthetic
    2-bit starcoder2-15b (GeLU MLP, G = 12, d_ff 24576 = 128 x 192) served
    as in phase 4, with its tick profile; (b) starcoder2-15b quantized in
    process by the function ``launch/serve.py --quantize`` calls (LDLQ over
    24576 columns, kron_mul on its Hessian), then served; (c) synthetic
    llama2-70b (d_ff 28672 = 128 x 224) and qwen2-72b (d_ff 29568 =
    168 x 176, kron_mul's layout that reads A from global memory) and
    mistral-large-123b (d_model 12288 = 96 x 128, G = 12) served.  Every
    run is held to the recompute oracle.  Returns the launch counts of each
    path."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import make_calibration
    from repro_torch.kernels import reset_counts
    from repro_torch.launch.serve import quantize_in_process
    from repro_torch.models.transformer import init_decoder

    paths = {}
    # (a) the same request schedule as phase 4
    paths["starcoder2_serve"] = _serve_synthetic(
        torch, "starcoder2-15b", layers=SC_LAYERS, seed=seed,
        prompt_len=128, gen=32, arrive=(0, 0, 0, 0, 3, 5, 7, 9),
        profile=True)["launches"]

    # (b) in-process quantization, as launch/serve.py --quantize runs it
    full = get_config("starcoder2-15b")
    cfg = dataclasses.replace(full, n_layers=SC_QUANT_LAYERS)
    log(f"[starcoder2-15b quantize] DEPTH CUT: {SC_QUANT_LAYERS} of "
        f"{full.n_layers} blocks (full width: d_model {cfg.d_model}, d_ff "
        f"{cfg.d_ff})")
    g = torch.Generator(device=DEV)
    g.manual_seed(seed)
    params = init_decoder(cfg, g, device=DEV)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    qm = quantize_in_process(params, cfg, bits=2, seed=seed, verbose=True)
    torch.cuda.synchronize()
    t_quant = time.perf_counter() - t0
    launches = _counts()
    paths["starcoder2_quantize"] = launches
    log(f"[starcoder2-15b quantize] launch/serve.py quantize_in_process "
        f"(--quantize --bits 2: ldlq, kronecker, 8 x 64 calibration tokens)"
        f": {SC_QUANT_LAYERS} block(s) in {t_quant:.1f}s, peak "
        f"torch.cuda.max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; kernel "
        f"launches {launches}")
    for i, blk_stats in enumerate(qm.stats):
        for name, st in blk_stats.items():
            log(f"[starcoder2-15b quantize]   {i}/{name:8s} ({st['m']}x"
                f"{st['n']}): proxy_rel {st['proxy_rel']:.4f}, mu_w "
                f"{st['mu_w_pre']:.2f} -> {st['mu_w_post']:.2f}, wall_s "
                f"{st['wall_s']:.1f}")
    missing = [k for k in QUANT_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the in-process "
                             f"quantize path: {missing}")
    del params
    prompts = make_calibration(cfg.vocab, n_segments=4, seg_len=128,
                               seed=seed + 3)
    _, reqs, rec = serve_requests(torch, qm, prompts, gen=16,
                                  arrive=(0, 0, 0, 0), args=SERVE_ARGS)
    atol, mean_atol = DENSE_LOGIT_GATES["starcoder2-15b quantized"]
    check_logits(torch, qm, prompts, reqs, atol=atol, mean_atol=mean_atol,
                 tag="starcoder2-15b-quantize-check")
    paths["starcoder2_serve_quantized"] = rec["launches"]
    del qm, reqs
    torch.cuda.empty_cache()

    # (c) the two widest d_ff, and the widest d_model (12288 = 96 x 128)
    # with G = 12 through the engine
    for arch in ("llama2-70b", "qwen2-72b", "mistral-large-123b"):
        paths[arch.split("-")[0] + "_serve"] = _serve_synthetic(
            torch, arch, layers=BIG_LAYERS, seed=seed, prompt_len=128,
            gen=16, arrive=(0, 0, 0, 0))["launches"]
    log(f"[dense family] kernel launches per path: {paths}")
    return paths


def _profile(torch, run, n_ticks: int):
    """``torch.profiler`` around ``run()`` (n_ticks engine ticks): wall and
    device-busy time per tick and the CUDA kernel events, or None when the
    profiler recorded no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / n_ticks
    dev = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in dev) / 1e6 / n_ticks
    if not dev or busy == 0:
        return None
    return wall, busy, dev


# the prefix of quant_matmul's CUDA kernels' names (csrc/quant_matmul.cu)
QMM_PREFIX = "qmm_"
# PyTorch's index_select kernels (indexSelectSmallIndex/LargeIndex): the
# permutation gathers the Kronecker transforms no longer launch
INDEX_SELECT = "indexSelect"


def _report_tick(tag, prof, n_ticks, names) -> None:
    if prof is None:
        log(f"[profile] {tag}: device time not measured (the profiler "
            f"recorded no CUDA kernels)")
        return
    wall, busy, dev = prof
    n = sum(e.count for e in dev) / n_ticks
    log(f"[profile] {tag}: wall {wall * 1e3:.1f} ms, device busy "
        f"{busy * 1e3:.1f} ms (idle share {1 - busy / wall:.0%}), {n:.0f} "
        f"kernels per tick")
    for e in sorted(dev, key=lambda e: -e.self_device_time_total)[:6]:
        log(f"[profile]   {e.self_device_time_total / 1e3 / n_ticks:8.2f} ms "
            f"{e.count / n_ticks:6.0f}x  {e.key[:90]}")
    for name in names:
        # a family's kernels share a name prefix (qmm_rows16_kernel and
        # qmm_tiled_kernel are quant_matmul's)
        mine = [e for e in dev if name in e.key]
        label = {QMM_PREFIX: QMM_PREFIX + "*",
                 INDEX_SELECT: "index_select"}.get(name, name)
        log(f"[profile] {label} per tick: "
            f"{sum(e.self_device_time_total for e in mine) / 1e3 / n_ticks:.2f}"
            f" ms device time over "
            f"{sum(e.count for e in mine) / n_ticks:.0f} launches")


def profile_ticks(torch, adapter, args, prompts, ticks: int = 3,
                  dryrun_tick: bool = False) -> None:
    """Where a tick's time goes, from ``torch.profiler``: one prefill tick
    of a fresh engine (8 admissions x 64-token chunks, the token budget),
    then a few decode-only ticks of a second short workload (8 lanes, all
    prefilled first).  Reports device-busy time against wall time, the
    kernels launched per tick and the attention kernels' share; with
    ``dryrun_tick``, one more decode tick under the op analysis
    (:func:`_dryrun_tick`)."""
    from repro_torch.launch.serve import build_engine

    attn = ("paged_prefill_kernel", "paged_decode_kernel",
            "decode_merge_kernel")
    engine = build_engine(adapter, max_seq_len=prompts.shape[1] + 2,
                          args=args)
    for p in prompts:
        engine.submit(p, max_new=1)
    _report_tick(f"prefill tick ({len(prompts)} admissions x "
                 f"{args.prefill_chunk}-token chunks)",
                 _profile(torch, engine.tick, 1), 1,
                 attn[:1] + ("kron_mul_kernel", QMM_PREFIX, INDEX_SELECT))
    engine.run()

    engine = build_engine(adapter, max_seq_len=prompts.shape[1] + ticks + 3,
                          args=args)
    reqs = [engine.submit(p, max_new=ticks + 3) for p in prompts]
    while any(not r.out_tokens for r in reqs):
        engine.tick()

    def decode():
        for _ in range(ticks):
            engine.tick()

    prof = _profile(torch, decode, ticks)
    _report_tick(f"decode tick ({len(prompts)} lanes, ctx "
                 f"~{prompts.shape[1]})", prof,
                 ticks, attn[1:] + ("kron_mul_kernel", QMM_PREFIX,
                                    INDEX_SELECT))
    if dryrun_tick:  # phase 15 (c), on phase 4's engine
        _dryrun_tick(torch, engine, None if prof is None else prof[1])
    engine.run()


def _dryrun_tick(torch, engine, busy_s) -> None:
    """Phase 15 (c), on phase 4's engine: one more decode tick under the
    op analysis on the card.  Its counted quant_matmul, paged-decode and
    kron_mul calls must equal the ``COUNTS`` deltas of that tick; its
    FLOPs and bytes, and the bytes' time at the card's memory rate, are
    printed against the decode ticks' device busy time (no speed gate)."""
    from repro_torch.kernels import reset_counts
    from repro_torch.runtime.op_analysis import analyze_step
    from repro_torch.runtime.roofline import HW

    tag = "dryrun-c"
    _sync(torch)
    reset_counts()
    stats, _ = analyze_step(engine.tick, device=DEV)
    _sync(torch)
    counts = _counts()
    traced = {k: stats.kernel_launches.get(k, 0) for k in SERVE_KERNELS}
    want = {k: counts[k] for k in SERVE_KERNELS}
    hw = HW()
    busy = ("not measured" if busy_s is None
            else f"{busy_s * 1e3:.2f} ms")
    log(f"[{tag}] a phase-4 decode tick under the op analysis: "
        f"{stats.flops / 1e9:.2f} GFLOP, {stats.bytes_accessed / 1e9:.3f} GB "
        f"over {sum(v['count'] for v in stats.ops.values())} ops; compute "
        f"term {stats.flops / hw.peak_flops * 1e3:.4f} ms, memory term "
        f"{stats.bytes_accessed / hw.hbm_bw * 1e3:.3f} ms against the "
        f"decode ticks' device busy {busy} a tick; kernel calls counted "
        f"{traced}, COUNTS deltas {want}")
    wrong = [k for k in SERVE_KERNELS if traced[k] != want[k]]
    if wrong or not (traced["quant_matmul"] and traced["paged_decode"]
                     and traced["kron_mul"]):
        raise AssertionError(f"[{tag}] the op analysis counted other kernel "
                             f"calls than COUNTS: {wrong}")


# ---------------------------------------------------------------------------
# phase 8: the request lifecycle, the prefix cache and int8 KV
# ---------------------------------------------------------------------------

# (a) ten requests of prompt 128 + gen 32: eight share a 96-token prefix (6
# pages of 16) and end in 32 tokens of their own; the last two repeat
# request 0's whole prompt (a page-aligned full hit: copy-on-admit)
PREFIX_SHARED = 96
PREFIX_ARRIVE = (0, 2, 2, 2, 2, 3, 3, 3, 4, 4)
# (a)'s second run: a pool small enough that decode evicts and admission
# reclaims trie leaves
PREFIX_TIGHT_PAGES = 28
# (c): the pool, the queue bound and the tenants (rate per tick, burst,
# class); the clock reads the tick number
LIFECYCLE_PAGES = 40
LIFECYCLE_MAX_QUEUE = 4
LIFECYCLE_TENANTS = {"paid": (None, 4, 0), "free": (0.5, 2, 1)}
# (b): the int8 paged engine against the gather-dense int8 engine (the same
# pages dequantized, attention in plain PyTorch), max and mean |diff| over
# the positions both streams share: about twice the 0.0223 / 0.00307 read
# on a correct run (one H100, every other check passed)
INT8_LOGIT_ATOL, INT8_LOGIT_MEAN_ATOL = 0.045, 0.006


def _sync(torch) -> None:
    if DEV == "cuda":
        torch.cuda.synchronize()


def _args(**kw) -> argparse.Namespace:
    """Phase 4's engine flags with phase 8's and 9's knobs set."""
    base = dict(vars(SERVE_ARGS), prefix_cache=False, kv_int8=False,
                deadline_s=None, max_queue=None, speculative=0,
                draft="ngram", host_sample=False)
    base.update(kw)
    return argparse.Namespace(**base)


def drive_schedule(engine, schedule, *, events=None, on_submit=None) -> dict:
    """Drive ``engine`` one tick at a time on a clock that reads the tick
    number, so deadlines and rate limits take the same decisions in every
    run.  ``schedule`` is a list of (tick, submit kwargs), each submitted
    just before that tick with ``arrival`` = the tick unless the kwargs
    give one; ``events`` maps a tick to ``fn(engine, run)``, called before
    that tick (a cancel between ticks).  Returns the requests by schedule
    index, the rejections, the admission order (re-admissions after
    eviction included), the requests finished per tick and the most pages
    shared at once."""
    from repro_torch.serve.faults import AdmissionRejected

    clock = [0.0]
    engine.now = lambda: clock[0]
    run = {"reqs": {}, "rejected": {}, "admitted": [], "finished": [],
           "cancelled": [], "peak_shared": 0}
    index = {}
    plan = engine.scheduler.plan

    def plan_and_log(running, pool, now=0.0):
        before = {id(r) for r in running}
        out = plan(running, pool, now=now)
        run["admitted"] += [index[id(r)] for r in running
                            if id(r) not in before]
        return out

    engine.scheduler.plan = plan_and_log
    order = sorted(range(len(schedule)), key=lambda i: schedule[i][0])
    tick = 0
    while order or not engine.idle:
        clock[0] = float(tick)
        while order and schedule[order[0]][0] <= tick:
            i = order.pop(0)
            try:
                r = engine.submit(**{"arrival": float(tick),
                                     **schedule[i][1]})
            except AdmissionRejected as e:
                run["rejected"][i] = e.reason
                continue
            run["reqs"][i] = r
            index[id(r)] = i
            if on_submit is not None:
                on_submit(i, r)
        if events and tick in events:
            events[tick](engine, run)
        res = engine.tick()
        run["finished"].append([index[id(r)] for r in res.finished])
        run["peak_shared"] = max(run["peak_shared"], engine.pool.shared_pages)
        tick += 1
        if tick > 20_000:
            raise AssertionError("schedule did not drain")
    run["ticks"] = tick
    return run


class _ModelFreeDecoder:
    """The model's stand-in when a schedule is replayed on the CPU: a pool
    of one layer and one KV head of width 1 with the run's page geometry,
    and zero logits.  What the engine emits comes from the card's run
    (:func:`_replay_engine`)."""

    def __init__(self, torch):
        import types

        self.torch = torch
        self.cfg = types.SimpleNamespace(n_layers=1, n_kv_heads=1,
                                         head_dim=1, dtype="float32")

    def make_pool(self, **kw):
        from repro_torch.serve.kv_cache import PagedKVPool

        kw.pop("dtype")  # the replay reads no page
        return PagedKVPool(self.cfg, device="cpu", **kw)

    def prefill_paged(self, tokens, *_):
        return self.torch.zeros(*tokens.shape, 1)

    def decode_paged_sample(self, tokens, *_):
        B = tokens.shape[0]
        return (self.torch.zeros(B, 1, dtype=self.torch.int32),
                self.torch.zeros(B, 1, 1))


def _replay_engine(torch, args, max_seq_len: int, card_run: dict,
                   tenants=None):
    """The port's engine on the CPU with :class:`_ModelFreeDecoder`,
    emitting at every position the token the card emitted there: the same
    schedule then takes the same host decisions iff they depend on nothing
    but the schedule and the tokens.  Returns (engine, on_submit)."""
    from repro_torch.launch.serve import build_engine
    from repro_torch.serve.engine import Engine

    tokens = {i: list(r.out_tokens) for i, r in card_run["reqs"].items()}
    rid_index = {}

    class ReplayEngine(Engine):
        def _emit(self, req, token, logits, now):
            i = rid_index[req.rid]
            super()._emit(req, tokens[i][len(req.out_tokens)], None, now)

    decoder = _ModelFreeDecoder(torch)
    ecfg = build_engine(decoder, max_seq_len=max_seq_len, args=args,
                        tenants=tenants).ecfg
    return (ReplayEngine(decoder, ecfg),
            lambda i, r: rid_index.__setitem__(r.rid, i))


def _decisions(engine, run: dict) -> dict:
    """Every host decision of a run phase 8 holds the card to the CPU on."""
    s = engine.summary()
    return {
        **{k: s[k] for k in ("prefix_hit_tokens", "cached_pages",
                             "shared_pages", "cow_copies", "evictions",
                             "prefill_tokens", "decode_tokens", "cancelled",
                             "failed", "deadline_missed",
                             "admission_rejected", "steps")},
        "peak_shared_pages": run["peak_shared"],
        "outcomes": {i: (r.state.value, r.finish_reason, len(r.out_tokens),
                         r.n_evictions)
                     for i, r in sorted(run["reqs"].items())},
        "rejected": dict(sorted(run["rejected"].items())),
        "admitted": run["admitted"],
        "finished_per_tick": run["finished"],
    }


def _compare_greedy(torch, got_run: dict, want_run: dict) -> tuple:
    """Two greedy runs of one schedule (``record_logits``): the logits at
    every position both streams share, up to and including each stream's
    first parting, and each first parting with the ``want`` run's top-2
    margin there.  Returns (max |diff|, mean |diff|, positions, partings
    as (request, position, margin), the partings whose margin is not below
    twice the max |diff|)."""
    import numpy as np

    diffs, firsts = [], []
    for i, r in got_run["reqs"].items():
        o = want_run["reqs"][i]
        toks, otoks = r.out_tokens, o.out_tokens
        n = next((k for k, (a, b) in enumerate(zip(toks, otoks)) if a != b),
                 None)
        upto = len(toks) if n is None else n + 1
        got = torch.as_tensor(np.stack(r.step_logits[:upto]), device=DEV)
        want = torch.as_tensor(np.stack(o.step_logits[:upto]), device=DEV)
        diffs.append((got.float() - want.float()).abs())
        if n is not None:
            top2 = torch.topk(want[n].float(), 2).values
            firsts.append((i, n, float(top2[0] - top2[1])))
    max_d = max(float(d.max()) for d in diffs)
    mean_d = (sum(float(d.sum()) for d in diffs)
              / sum(d.numel() for d in diffs))
    unexplained = [f for f in firsts if f[2] >= 2 * max_d]
    return max_d, mean_d, sum(d.shape[0] for d in diffs), firsts, unexplained


def _leak_gate(tag: str, engine) -> None:
    pool = engine.pool
    leaked = pool.pages_in_use - pool.cached_pages
    if leaked or pool._slots or engine.live_requests():
        raise AssertionError(f"[{tag}] {leaked} leaked pages, "
                             f"{len(pool._slots)} live slots after drain")


def _serve_schedule(torch, tag: str, adapter, args, schedule, *,
                    max_seq_len: int, events=None, tenants=None,
                    replay: bool = True, required=SERVE_KERNELS,
                    faults=None) -> tuple:
    """One card run of ``schedule`` (launches counted from 0 around it,
    every kernel in ``required`` launched), its leak gate, and with
    ``replay`` the same schedule replayed on the CPU with equal host
    decisions.  ``faults`` is the engine's fault plan (phase 10).
    Returns (engine, run, launches); ``run["wall"]`` is the run's wall
    time."""
    from repro_torch.kernels import reset_counts
    from repro_torch.launch.serve import build_engine

    engine = build_engine(adapter, max_seq_len=max_seq_len, args=args,
                          record_logits=True, tenants=tenants, faults=faults)
    _sync(torch)
    reset_counts()
    t0 = time.perf_counter()
    run = drive_schedule(engine, schedule, events=events)
    _sync(torch)
    wall = run["wall"] = time.perf_counter() - t0
    launches = _counts()
    _leak_gate(tag, engine)
    got = _decisions(engine, run)
    total = sum(len(r.out_tokens) for r in run["reqs"].values())
    log(f"[{tag}] {len(schedule)} requests, {total} tokens in {wall:.2f}s "
        f"over {run['ticks']} ticks; prefix_hit_tokens "
        f"{got['prefix_hit_tokens']}, cached_pages {got['cached_pages']}, "
        f"shared_pages {got['shared_pages']} (peak "
        f"{got['peak_shared_pages']}), cow_copies {got['cow_copies']}, "
        f"evictions {got['evictions']}, prefill_tokens "
        f"{got['prefill_tokens']}; kernel launches {launches}")
    missing = [k for k in required if launches[k] == 0]
    if missing:
        raise AssertionError(f"[{tag}] kernels never launched: {missing}")
    if replay:
        cpu, on_submit = _replay_engine(torch, args, max_seq_len, run,
                                        tenants=tenants)
        cpu_run = drive_schedule(cpu, schedule, events=events,
                                 on_submit=on_submit)
        _leak_gate(f"{tag} cpu", cpu)
        want = _decisions(cpu, cpu_run)
        counters = ("prefix_hit_tokens", "cached_pages", "shared_pages",
                    "peak_shared_pages", "cow_copies", "evictions")
        log(f"[{tag}] the same schedule on the CPU (the card's tokens "
            f"replayed through the port's engine): "
            + ", ".join(f"{k} {want[k]}" for k in counters))
        diff = [k for k in want if want[k] != got[k]]
        if diff:
            raise AssertionError(f"[{tag}] host decisions differ from the "
                                 f"CPU's: {diff}")
    return engine, run, launches


def phase_lifecycle(torch, *, seed: int, layers: int, cfg=None,
                    profile: bool = True) -> dict:
    """Phase 8: ``qwen3-14b`` (phase 4's synthetic 2-bit model, full width,
    ``layers`` deep) through (a) the prefix cache, (b) int8 KV against the
    gather-dense int8 engine, (c) the request lifecycle.  Host decisions of
    (a) and (c) are held to the same schedule replayed on the CPU; every
    emitted position is held to the recompute oracle as in phase 5.
    Returns the kernel launches of each run."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import make_calibration
    from repro_torch.launch.serve import build_engine
    from repro_torch.serve.adapter import CachedDecoder
    from repro_torch.serve.scheduler import TenantPolicy
    from repro_torch.serve.synthetic import synthetic_quantized_model

    t_phase = time.perf_counter()
    if cfg is None:
        cfg = _depth_cut("lifecycle", get_config("qwen3-14b"), layers)
    qm = synthetic_quantized_model(cfg, seed=seed, device=DEV)
    adapter = CachedDecoder.from_quantized(qm)
    prompt_len, gen = 128, 32
    max_seq_len = prompt_len + gen
    paths = {}

    # ---- (a) the prefix cache ---------------------------------------------
    base = make_calibration(cfg.vocab, n_segments=8, seg_len=prompt_len,
                            seed=seed + 5)
    prompts = [np.concatenate([base[0, :PREFIX_SHARED],
                               base[i, PREFIX_SHARED:]]) for i in range(8)]
    prompts += [prompts[0], prompts[0]]
    schedule = [(t, dict(prompt=p, max_new=gen))
                for p, t in zip(prompts, PREFIX_ARRIVE)]
    runs = {}
    for name, kw in (("prefix", dict(prefix_cache=True)),
                     ("prefix tight", dict(prefix_cache=True,
                                           pages=PREFIX_TIGHT_PAGES)),
                     ("no prefix cache", {})):
        tag = f"lifecycle-a {name}"
        eng, run, launches = _serve_schedule(
            torch, tag, adapter, _args(**kw), schedule,
            max_seq_len=max_seq_len, replay=bool(kw))
        runs[name] = (eng, run, launches)
        paths[tag.replace(" ", "_")] = launches
    eng, run, _ = runs["prefix"]
    s, tight = eng.summary(), runs["prefix tight"][0].summary()
    nocache = runs["no prefix cache"]
    log(f"[lifecycle-a] paged prefill with the cache: "
        f"{runs['prefix'][2]['paged_prefill']} launches, "
        f"{s['prefill_tokens']} tokens; without: "
        f"{nocache[2]['paged_prefill']} launches, "
        f"{nocache[0].summary()['prefill_tokens']} tokens")
    if s["cow_copies"] < 1 or s["prefix_hit_tokens"] <= 0:
        raise AssertionError("[lifecycle-a] the prefix cache was not hit "
                             "(cow_copies < 1 or prefix_hit_tokens == 0)")
    if tight["evictions"] <= 0:
        raise AssertionError("[lifecycle-a] the tight pool never evicted")
    for name in ("prefix", "prefix tight"):
        r = runs[name][1]["reqs"]
        check_logits(torch, qm, [r[i].prompt for i in range(len(r))],
                     [r[i] for i in range(len(r))], atol=LOGIT_ATOL,
                     mean_atol=LOGIT_MEAN_ATOL,
                     tag=f"lifecycle-a {name} check")
    stream = list(run["reqs"][1].out_tokens)  # (c)'s stop token source
    del runs, nocache, eng, run

    # ---- (b) int8 KV ---------------------------------------------------------
    arrive = (0, 0, 0, 0, 3, 5, 7, 9)
    p4 = make_calibration(cfg.vocab, n_segments=len(arrive),
                          seg_len=prompt_len, seed=seed + 3)
    sched_b = [(t, dict(prompt=p, max_new=gen)) for p, t in zip(p4, arrive)]
    args8 = _args(kv_int8=True)
    eng8, run8, launches = _serve_schedule(
        torch, "lifecycle-b int8", adapter, args8, sched_b,
        max_seq_len=max_seq_len, replay=False)
    paths["lifecycle-b_int8"] = launches
    oracle = build_engine(adapter, max_seq_len=max_seq_len, args=args8,
                          record_logits=True, paged=False,
                          paged_prefill=False, prefix_cache=False,
                          robust=False)
    t0 = time.perf_counter()
    orun = drive_schedule(oracle, sched_b)
    _sync(torch)
    t_oracle = time.perf_counter() - t0
    max_d, mean_d, n_pos, firsts, unexplained = _compare_greedy(
        torch, run8, orun)
    log(f"[lifecycle-b] --kv-int8 --paged --paged-prefill against the "
        f"gather-dense int8 engine (run in {t_oracle:.1f}s): {n_pos} "
        f"positions, logit max |diff| {max_d:.4f} (tol {INT8_LOGIT_ATOL}), "
        f"mean |diff| {mean_d:.5f} (tol {INT8_LOGIT_MEAN_ATOL}); streams "
        f"that part: {len(firsts)} (request, position, oracle top-2 "
        f"margin: {firsts}; all below 2 x max |diff|: "
        f"{'yes' if not unexplained else 'NO'})")
    if max_d > INT8_LOGIT_ATOL or mean_d > INT8_LOGIT_MEAN_ATOL \
            or unexplained:
        raise AssertionError("[lifecycle-b] int8 paged engine disagrees "
                             "with the gather-dense int8 engine")
    check_logits(torch, qm, [r.prompt for r in run8["reqs"].values()],
                 list(run8["reqs"].values()), atol=None, mean_atol=None,
                 tag="lifecycle-b int8 vs fp recompute")
    pool = eng8.pool
    bf16 = 2 * pool.k.numel() * 2
    log(f"[lifecycle-b] KV pool bytes: int8 {pool.total_bytes()} (pages + "
        f"fp32 scales), bf16 {bf16} for the same {pool.n_pages} pages")
    del eng8, run8, oracle, orun
    if profile:
        profile_ticks(torch, adapter, args8, p4)

    # ---- (c) the request lifecycle -------------------------------------------
    k = next(k for k in range(3, len(stream)) if stream[k] not in stream[:k])
    stop = stream[k]
    P = prompts
    sched_c = [
        (0, dict(prompt=P[1], max_new=gen, tenant="paid",
                 stop_tokens=(stop,))),
        (0, dict(prompt=P[2], max_new=gen, tenant="free")),
        (0, dict(prompt=P[3], max_new=gen, tenant="free")),
        (0, dict(prompt=P[4], max_new=gen, tenant="free")),  # rate limited
        (1, dict(prompt=P[5], max_new=gen, tenant="paid", deadline_s=0.0)),
        (2, dict(prompt=P[6], max_new=gen, tenant="paid")),
        (2, dict(prompt=P[7], max_new=gen, tenant="free")),
        (2, dict(prompt=base[1], max_new=gen, tenant="paid")),
        (2, dict(prompt=base[2], max_new=gen, tenant="paid")),
        (2, dict(prompt=base[3], max_new=gen, tenant="paid")),
        (2, dict(prompt=base[4], max_new=gen, tenant="paid")),
    ]

    def cancel(state):
        def fn(engine, run):  # the first request of the schedule in state
            for i, r in sorted(run["reqs"].items()):
                if r.state.value == state:
                    run["cancelled"].append((i, state))
                    engine.cancel(r.rid)
                    return
            raise AssertionError(f"[lifecycle-c] no request {state} to "
                                 f"cancel")
        return fn

    events = {3: cancel("queued"), 12: cancel("decode")}
    tenants = {n: TenantPolicy(rate=r, burst=b, priority=p)
               for n, (r, b, p) in LIFECYCLE_TENANTS.items()}
    args_c = _args(pages=LIFECYCLE_PAGES, max_queue=LIFECYCLE_MAX_QUEUE)
    eng, run, launches = _serve_schedule(
        torch, "lifecycle-c", adapter, args_c, sched_c,
        max_seq_len=max_seq_len, events=events, tenants=tenants)
    paths["lifecycle-c"] = launches
    reqs = run["reqs"]
    out = {i: (r.state.value, r.finish_reason) for i, r in reqs.items()}
    log(f"[lifecycle-c] stop token {stop} (position {k} of (a)'s stream); "
        f"outcomes {out}; rejected {run['rejected']}; admission order "
        f"{run['admitted']}; cancelled {run['cancelled']}; evictions "
        f"{eng.summary()['evictions']}")
    stops = [r for r in reqs.values() if r.finish_reason == "stop"]
    reasons = sorted(set(run["rejected"].values()))
    if (not stops or any(r.out_tokens[-1] not in r.stop_tokens
                         for r in stops)
            or [s for _, s in run["cancelled"]] != ["queued", "decode"]
            or "deadline" not in {r.finish_reason for r in reqs.values()}
            or reasons != ["queue_full", "rate_limited"]
            or eng.summary()["evictions"] <= 0):
        raise AssertionError("[lifecycle-c] a lifecycle event did not "
                             "happen as scheduled")
    idx = sorted(reqs)
    check_logits(torch, qm, [reqs[i].prompt for i in idx],
                 [reqs[i] for i in idx], atol=LOGIT_ATOL,
                 mean_atol=LOGIT_MEAN_ATOL, tag="lifecycle-c check")
    del qm, adapter, eng, run
    if DEV == "cuda":
        torch.cuda.empty_cache()
    log(f"[lifecycle] phase 8 passed in {time.perf_counter() - t_phase:.1f}s")
    return paths


# ---------------------------------------------------------------------------
# phase 9: sampling and speculative decode
# ---------------------------------------------------------------------------

# draft depth of the speculative runs (``--speculative 4 --draft ngram``)
SPEC_K = 4
# (b): the sampled requests (request i draws from seed i)
SAMPLE_TEMP, SAMPLE_TOP_P = 0.8, 0.9


def _spec_prompts(vocab: int, seed: int, n: int = 8, length: int = 128):
    """Prompts of seeded repeated spans (code, JSON and templated text
    repeat themselves): prompt i repeats a span of 4 + 2 (i % 4) tokens;
    odd prompts have eight tokens replaced at seeded positions, so some
    drafts proposed from them are wrong."""
    import numpy as np

    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        span = rng.integers(0, vocab, 4 + 2 * (i % 4))
        p = np.resize(span, length).astype(np.int32)
        if i % 2:
            p[rng.choice(length, 8, replace=False)] = rng.integers(0, vocab, 8)
        out.append(p)
    return out


def _draw_explained(lg, temp: float, top_p: float, u: float, token: int, *,
                    delta: float, floor: float) -> tuple:
    """Whether ``token`` can be the inverse-CDF draw of ``u`` from logits
    ``lg`` (V,) at ``temp``/``top_p`` once every logit may move by up to
    ``delta`` and the CDF by up to ``floor`` of its mass, and the distance
    of ``u·S`` from the nearest bucket edge (S the nucleus mass, in units
    of the total).  Float64, on the host.

    A move of at most ``delta`` per logit keeps every probability, top-k
    mass and nucleus mass within ``r = exp(2·delta/temp)`` of these; the
    nucleus can take in the next token, or lose its last, only where that
    carries the token's start across ``top_p``.  So the drawn rank's bucket
    meets ``[u·S_lo/r² − floor, u·S_hi·r² + floor]``, and the token at a
    rank has a logit within ``2·delta`` of the logits this order puts at
    the ranks there."""
    import numpy as np

    lg = np.asarray(lg, np.float64)
    z = lg / temp
    p = np.exp(z - z.max())
    p /= p.sum()
    order = np.argsort(-p, kind="stable")
    ps = p[order]
    csum = np.cumsum(ps)
    n = max(1, int(np.sum(csum - ps < top_p)))
    x = u * csum[n - 1]
    dist = float(np.min(np.abs(np.concatenate([[0.0], csum[:n]]) - x)))
    r2 = np.exp(4.0 * delta / temp)
    grow = n < ps.size and (csum[n] - ps[n]) / r2 - floor < top_p
    shrink = n > 1 and csum[n - 2] * r2 + floor >= top_p
    s_hi = csum[n] if grow else csum[n - 1]
    s_lo = csum[n - 2] if shrink else csum[n - 1]
    lo, hi = u * s_lo / r2 - floor, u * s_hi * r2 + floor
    ranks = np.flatnonzero((csum - ps <= hi) & (csum >= lo))
    ranks = ranks[ranks < n + grow]
    if ranks.size == 0:
        return False, dist
    near = lg[order[ranks]]
    return (bool(near.min() - 2 * delta <= lg[token]
                 <= near.max() + 2 * delta), dist)


def _cdf_rounding(torch, logits, temp: float, top_p: float) -> float:
    """Max distance, in units of the nucleus mass, between the normalized
    CDF the draw compares ``u`` with (``cumsum(ps) / Σps`` from
    :func:`nucleus` in float32 on the logits' device) and the same CDF
    from a float64 softmax of the logits in the same order: the softmax,
    cumsum and sum rounding of this device, over rows of ``logits`` (n,
    V)."""
    from repro_torch.serve.adapter import nucleus

    n, dev = logits.shape[0], logits.device
    order, ps = nucleus(logits[:, None], torch.full((n,), temp, device=dev),
                        torch.full((n,), top_p, device=dev))
    c32 = (torch.cumsum(ps, dim=-1).double()
           / ps.sum(dim=-1, keepdim=True).double())
    p64 = torch.softmax(logits.double() / temp, dim=-1)[:, None]
    ps64 = torch.gather(p64, -1, order) * (ps > 0)
    c64 = torch.cumsum(ps64, dim=-1) / ps64.sum(dim=-1, keepdim=True)
    return float((c32 - c64).abs().max())


def _check_draws(torch, tag: str, run: dict, temp: float, top_p: float, *,
                 err=None) -> dict:
    """Every token the card drew in ``run`` against :func:`sample_tokens` on
    the CPU over the card's recorded logits, with the same seeds and
    emission indices.  A draw moves to another bucket than the exact
    (float64) draw's only within its device's CDF rounding of an edge
    (:func:`_cdf_rounding`), so a parting is admitted within ``floor`` =
    twice the sum of both devices' rounding (measured over these logits
    unless ``err`` gives it), ranks reordered by at most the float32
    rounding of z = logit / T (``delta``).  Returns the counts and the
    rounding."""
    import numpy as np

    from repro_torch.serve.adapter import sample_tokens, uniform

    measure = err is None
    err = dict(err or {"cuda": 0.0, "cpu": 0.0})
    n_draws, partings = 0, []
    t0 = time.perf_counter()
    for i, r in sorted(run["reqs"].items()):
        lg = np.stack(r.step_logits).astype(np.float32)  # (N, V)
        N = lg.shape[0]
        seed = r.sampling.seed
        cpu = torch.as_tensor(lg)
        got = sample_tokens(
            cpu[:, None], torch.full((N,), temp), torch.full((N,), top_p),
            torch.full((N,), seed, dtype=torch.int32),
            torch.arange(N, dtype=torch.int32))[:, 0].numpy()
        if measure:
            err["cpu"] = max(err["cpu"], _cdf_rounding(torch, cpu, temp,
                                                       top_p))
            err["cuda"] = max(err["cuda"], _cdf_rounding(
                torch, cpu.to(DEV), temp, top_p))
        n_draws += N
        for k in np.flatnonzero(got != np.asarray(r.out_tokens)):
            partings.append((i, int(k), lg[k], int(r.out_tokens[k]),
                             int(got[k]), seed))
    floor = 2 * (err["cuda"] + err["cpu"])
    shown, bad = [], []
    for i, k, lg, card, host, seed in partings:
        u = float(uniform(torch.tensor(seed), torch.tensor(k)))
        delta = (float(np.abs(lg).max()) + 4 * temp) * 2.0**-23
        ok, dist = _draw_explained(lg, temp, top_p, u, card, delta=delta,
                                   floor=floor)
        ok2, _ = _draw_explained(lg, temp, top_p, u, host, delta=delta,
                                 floor=floor)
        shown.append((i, k, card, host, f"{dist:.3g}"))
        if not (ok and ok2):
            bad.append((i, k))
    log(f"[{tag}] {n_draws} card draws against sample_tokens on the CPU "
        f"over the card's logits ({time.perf_counter() - t0:.1f}s): "
        f"{len(partings)} differ (request, index, card, cpu, edge "
        f"distance: {shown}); float32 CDF rounding card {err['cuda']:.3g}, "
        f"cpu {err['cpu']:.3g}, admitted within {floor:.3g} of an edge: "
        f"{'yes' if not bad else 'NO ' + str(bad)}")
    if bad:
        raise AssertionError(f"[{tag}] card draws disagree with the CPU's")
    return {"draws": n_draws, "partings": len(partings), "err": err}


def _compare_sampled(torch, tag: str, got_run: dict, want_run: dict,
                     temp: float, top_p: float, *, floor: float,
                     keys=None) -> list:
    """Two sampled runs of one schedule: equal up to each stream's first
    parting, which :func:`_draw_explained` must admit on the ``want`` run's
    logits with ``delta`` = the max |Δlogit| up to it.  ``keys`` maps
    ``got`` request keys to ``want`` keys (default: the same)."""
    import numpy as np

    from repro_torch.serve.adapter import uniform

    keys = keys or {i: i for i in got_run["reqs"]}
    out, bad, same = [], [], 0
    max_d = 0.0
    for gi, wi in keys.items():
        g, w = got_run["reqs"][gi], want_run["reqs"][wi]
        n = next((k for k, (a, b) in enumerate(zip(g.out_tokens,
                                                   w.out_tokens))
                  if a != b), None)
        upto = len(g.out_tokens) if n is None else n + 1
        d = float(np.abs(np.stack(g.step_logits[:upto])
                         - np.stack(w.step_logits[:upto])).max())
        max_d = max(max_d, d)
        same += upto - (n is not None)
        if n is None:
            continue
        u = float(uniform(torch.tensor(w.sampling.seed), torch.tensor(n)))
        ok, dist = _draw_explained(w.step_logits[n], temp, top_p, u,
                                   g.out_tokens[n], delta=d, floor=floor)
        out.append((wi, n, f"{dist:.3g}", f"{d:.3g}"))
        if not ok:
            bad.append((wi, n))
    log(f"[{tag}] {same} tokens equal before the first partings; partings "
        f"(request, position, edge distance, max |dlogit| before it): {out}; "
        f"max |dlogit| {max_d:.4f}; all admitted: "
        f"{'yes' if not bad else 'NO ' + str(bad)}")
    if bad:
        raise AssertionError(f"[{tag}] sampled streams part where no logit "
                             f"error explains it")
    return out


def _profile_verify_tick(torch, tag: str, adapter, args, prompts, *,
                         sampling=None) -> None:
    """``torch.profiler`` over one verify tick of 8 lanes at context ~128,
    after a few verify ticks (so the lanes carry drafts): device busy,
    idle share, kernels per tick, with the attention, kron_mul,
    quant_matmul, sort and scan (cumsum) kernels named."""
    from repro_torch.launch.serve import build_engine

    engine = build_engine(adapter, max_seq_len=prompts[0].shape[0] + 40,
                          args=args)
    reqs = [engine.submit(p, max_new=32, **({"sampling": sampling(i)}
                                              if sampling else {}))
            for i, p in enumerate(prompts)]
    while any(not r.out_tokens for r in reqs):
        engine.tick()
    for _ in range(3):
        engine.tick()
    before = engine.summary()["draft_tokens"]
    prof = _profile(torch, engine.tick, 1)
    drafts = engine.summary()["draft_tokens"] - before
    _report_tick(f"{tag} verify tick ({len(prompts)} lanes, K = "
                 f"{args.speculative}, {drafts} drafts, ctx ~"
                 f"{prompts[0].shape[0]})", prof, 1,
                 ("paged_prefill_kernel", "kron_mul_kernel", QMM_PREFIX,
                  "Sort", "sort", "Scan", "scan"))
    engine.run()


def _time_draw(torch, V: int, seed: int) -> None:
    """:func:`sample_tokens` at a verify tick's shape (8 lanes, K + 1
    positions, the vocabulary) over CUDA events, sampled and greedy."""
    from repro_torch.serve.adapter import sample_tokens

    timer = Timer(torch)
    g = torch.Generator(device=DEV)
    g.manual_seed(seed)
    lg = torch.randn(8, SPEC_K + 1, V, device=DEV, generator=g) * 2
    B = lg.shape[0]
    targs = (torch.full((B,), SAMPLE_TEMP, device=DEV),
             torch.full((B,), SAMPLE_TOP_P, device=DEV),
             torch.arange(B, dtype=torch.int32),
             torch.zeros(B, dtype=torch.int32))
    t_draw = timer(lambda: sample_tokens(lg, *targs))
    t_greedy = timer(lambda: sample_tokens(lg, *targs, greedy_only=True))
    log(f"[speculative-b] sample_tokens at the verify tick's shape (8, "
        f"{SPEC_K + 1}, {V}): {t_draw:.4f} ms sampled, {t_greedy:.4f} ms "
        f"greedy (argmax only), CUDA events, L2 flushed")


def phase_speculative(torch, *, seed: int, layers: int, cfg=None,
                      profile: bool = True) -> dict:
    """Phase 9: ``qwen3-14b`` (phase 4's synthetic 2-bit model, full width)
    with phase 4's flags, on tick-counted schedules of eight prompts of
    repeated spans: (a) greedy speculative (K = 4, n-gram drafts; the
    chunked-prefill kernel as verifier) against the same schedule with
    K = 0; (b) sampled (T 0.8, top-p 0.9, seeds 0..7): two runs, the card's
    draws against the CPU's on its logits, K = 4 against K = 0, one
    request alone against its batch; (c) int8 KV with K = 4 against the
    int8 engine with K = 0.  ``cfg`` replaces the model (a rehearsal on the
    CPU at a small one); ``profile`` times the verify ticks and the draw.
    Returns the kernel launches of each run."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.serve.adapter import CachedDecoder, sample_tokens
    from repro_torch.serve.scheduler import SamplingParams
    from repro_torch.serve.synthetic import synthetic_quantized_model

    t_phase = time.perf_counter()
    if cfg is None:
        cfg = _depth_cut("speculative", get_config("qwen3-14b"), layers)
    qm = synthetic_quantized_model(cfg, seed=seed, device=DEV)
    adapter = CachedDecoder.from_quantized(qm)
    prompt_len, gen = 128, 32
    max_seq_len = prompt_len + gen
    prompts = _spec_prompts(cfg.vocab, seed + 9)
    arrive = (0, 0, 0, 0, 3, 5, 7, 9)
    greedy = [(t, dict(prompt=p, max_new=gen))
              for p, t in zip(prompts, arrive)]
    spec = lambda **kw: _args(speculative=SPEC_K, draft="ngram", **kw)
    later = ("quant_matmul", "paged_prefill", "kron_mul")
    paths = {}

    # ---- (a) greedy speculative against K = 0 -------------------------------
    runs = {}
    for k in (SPEC_K, 0):
        tag = f"speculative-a K={k}"
        runs[k] = _serve_schedule(
            torch, tag, adapter, _args() if k == 0 else spec(), greedy,
            max_seq_len=max_seq_len, replay=False,
            required=SERVE_KERNELS if k == 0 else later)
        paths[f"speculative-a_k{k}"] = runs[k][2]
    (eng4, run4, l4), (eng0, run0, l0) = runs[SPEC_K], runs[0]
    s4, s0 = eng4.summary(), eng0.summary()
    L = cfg.n_layers
    rise = l4["paged_prefill"] - l0["paged_prefill"]
    per_verify = rise == s4["spec_ticks"] * L
    log(f"[speculative-a] K={SPEC_K}: spec_ticks {s4['spec_ticks']}, "
        f"spec_lanes {s4['spec_lanes']}, draft_tokens {s4['draft_tokens']}, "
        f"accepted_tokens {s4['accepted_tokens']}, rolled_back_tokens "
        f"{s4['rolled_back_tokens']}, acceptance_rate "
        f"{s4['acceptance_rate']:.3f}, accepted_per_tick "
        f"{s4['accepted_per_tick']:.2f}, tokens_per_lane_tick "
        f"{s4['tokens_per_lane_tick']:.3f}; steps {s4['steps']} against "
        f"{s0['steps']} at K=0; wall {run4['wall']:.2f}s against "
        f"{run0['wall']:.2f}s at K=0 (one run each, not a claim); "
        f"paged_prefill launches {l4['paged_prefill']} against "
        f"{l0['paged_prefill']} (rise {rise} = {s4['spec_ticks']} verify "
        f"ticks x {L} layers: {'yes' if per_verify else 'NO'}"
        f"), paged_decode {l4['paged_decode']} against {l0['paged_decode']}")
    if (s4["accepted_tokens"] <= 0 or s4["rolled_back_tokens"] <= 0
            or l4["paged_prefill"] != (s4["prefill_batches"]
                                       + s4["spec_ticks"]) * L
            or l0["paged_prefill"] != s0["prefill_batches"] * L
            or (s4["prefill_batches"] == s0["prefill_batches"]
                and not per_verify)):
        raise AssertionError("[speculative-a] drafts were not both accepted "
                             "and rolled back, or the verify ticks did not "
                             "run the prefill kernel once per layer")
    max_d, mean_d, n_pos, firsts, unexplained = _compare_greedy(
        torch, run4, run0)
    log(f"[speculative-a] K={SPEC_K} against K=0: {n_pos} positions, logit "
        f"max |diff| {max_d:.4f}, mean |diff| {mean_d:.5f}; streams that "
        f"part: {len(firsts)} (request, position, K=0 top-2 margin: "
        f"{firsts}; all below 2 x max |diff|: "
        f"{'yes' if not unexplained else 'NO'})")
    if unexplained:
        raise AssertionError("[speculative-a] speculative streams part from "
                             "one-token decode where no logit error "
                             "explains it")
    idx = sorted(run4["reqs"])
    check_logits(torch, qm, prompts, [run4["reqs"][i] for i in idx],
                 atol=LOGIT_ATOL, mean_atol=LOGIT_MEAN_ATOL,
                 tag="speculative-a check")
    del runs, eng4, eng0, run0
    if profile:
        _profile_verify_tick(torch, "speculative-a greedy", adapter, spec(),
                             prompts)

    # ---- (b) sampled -----------------------------------------------------
    sp = lambda i: SamplingParams(temperature=SAMPLE_TEMP,
                                  top_p=SAMPLE_TOP_P, seed=i)
    sampled = [(t, dict(prompt=p, max_new=gen, sampling=sp(i)))
               for i, (p, t) in enumerate(zip(prompts, arrive))]
    sruns = {}
    for name, args, sched in (
            ("K=0", _args(), sampled), ("K=0 again", _args(), sampled),
            (f"K={SPEC_K}", spec(), sampled),
            ("request 0 alone", _args(), sampled[:1])):
        tag = f"speculative-b {name}"
        sruns[name] = _serve_schedule(
            torch, tag, adapter, args, sched, max_seq_len=max_seq_len,
            replay=False,
            required=later if args.speculative else SERVE_KERNELS)
        paths["speculative-b_" + name.replace(" ", "_").replace("=", "")] = (
            sruns[name][2])
    base, again = sruns["K=0"][1], sruns["K=0 again"][1]
    same = all(base["reqs"][i].out_tokens == again["reqs"][i].out_tokens
               for i in base["reqs"])
    n_greedy = sum(base["reqs"][i].out_tokens == run4["reqs"][i].out_tokens
                   for i in base["reqs"])
    log(f"[speculative-b] T {SAMPLE_TEMP}, top-p {SAMPLE_TOP_P}, seeds 0..7:"
        f" two runs draw identical streams: {'yes' if same else 'NO'}; "
        f"streams equal to the greedy ones of (a): {n_greedy} of "
        f"{len(base['reqs'])}")
    if not same:
        raise AssertionError("[speculative-b] the same sampled schedule drew "
                             "different streams")
    err = _check_draws(torch, "speculative-b K=0 draws", base, SAMPLE_TEMP,
                       SAMPLE_TOP_P)["err"]
    kspec = sruns[f"K={SPEC_K}"]
    _check_draws(torch, f"speculative-b K={SPEC_K} draws", kspec[1],
                 SAMPLE_TEMP, SAMPLE_TOP_P, err=err)
    # two card runs: the card's own CDF rounding, twice
    floor = 4 * err["cuda"]
    _compare_sampled(torch, f"speculative-b K={SPEC_K} against K=0",
                     kspec[1], base, SAMPLE_TEMP, SAMPLE_TOP_P, floor=floor)
    _compare_sampled(torch, "speculative-b alone against the batch",
                     sruns["request 0 alone"][1], base, SAMPLE_TEMP,
                     SAMPLE_TOP_P, floor=floor, keys={0: 0})
    ks = kspec[0].summary()
    log(f"[speculative-b] K={SPEC_K} sampled: accepted_tokens "
        f"{ks['accepted_tokens']}, rolled_back_tokens "
        f"{ks['rolled_back_tokens']}, acceptance_rate "
        f"{ks['acceptance_rate']:.3f}, tokens_per_lane_tick "
        f"{ks['tokens_per_lane_tick']:.3f}; wall {kspec[1]['wall']:.2f}s "
        f"against {base['wall']:.2f}s at K=0")
    del sruns, base, again, kspec, run4
    if profile:
        _time_draw(torch, cfg.vocab, seed)
        _profile_verify_tick(torch, "speculative-b sampled", adapter, spec(),
                             prompts, sampling=sp)

    # ---- (c) int8 KV, K = 4 against K = 0 ----------------------------------
    iruns = {}
    for k in (SPEC_K, 0):
        args = spec(kv_int8=True) if k else _args(kv_int8=True)
        iruns[k] = _serve_schedule(
            torch, f"speculative-c int8 K={k}", adapter, args, greedy,
            max_seq_len=max_seq_len, replay=False,
            required=later if k else SERVE_KERNELS)
        paths[f"speculative-c_int8_k{k}"] = iruns[k][2]
    max_d, mean_d, n_pos, firsts, unexplained = _compare_greedy(
        torch, iruns[SPEC_K][1], iruns[0][1])
    s8 = iruns[SPEC_K][0].summary()
    log(f"[speculative-c] --kv-int8 K={SPEC_K} against --kv-int8 K=0: "
        f"{n_pos} positions, logit max |diff| {max_d:.4f} (tol "
        f"{INT8_LOGIT_ATOL}), mean |diff| {mean_d:.5f} (tol "
        f"{INT8_LOGIT_MEAN_ATOL}); streams that part: {len(firsts)} "
        f"(request, position, K=0 top-2 margin: {firsts}; all below 2 x "
        f"max |diff|: {'yes' if not unexplained else 'NO'}); accepted "
        f"{s8['accepted_tokens']}, rolled back {s8['rolled_back_tokens']}")
    if max_d > INT8_LOGIT_ATOL or mean_d > INT8_LOGIT_MEAN_ATOL \
            or unexplained:
        raise AssertionError("[speculative-c] int8 speculative decode "
                             "disagrees with int8 one-token decode")
    del qm, adapter, iruns
    if DEV == "cuda":
        torch.cuda.empty_cache()
    log(f"[speculative] phase 9 passed in "
        f"{time.perf_counter() - t_phase:.1f}s")
    return paths


# ---------------------------------------------------------------------------
# phase 10: observability, faults and quality
# ---------------------------------------------------------------------------

# (a): phase 4's requests by index, armed once request 5 is submitted (tick
# 5): request 1's next decode page claim fails, request 5's boundary logits
# turn NaN, the next dispatch carrying request 3 raises, one admit or extend
# reports no pages, and request 0 is cancelled at tick 6
OBSERVE_PLAN = ("alloc_fail@rid={1};nan_logits@rid={5};"
                "dispatch_error@rid={3};pool_exhausted;cancel@rid={0},tick=6")
OBSERVE_ARM_TICK = 5
OBSERVE_OUTCOMES = {0: "cancelled", 1: "alloc_fail", 3: "dispatch_error",
                    5: "nan_logits"}
# (a)'s verify run: request 1's logits turn NaN inside its verify tick 4
OBSERVE_VERIFY_PLAN = "nan_logits@rid={1},tick=4"
# phase 4's launches per layer of the served model (50 forwards of 7
# projections, 40 decode ticks, 10 prefill ticks, two Kronecker factors per
# projection): 14,000 / 1,600 / 400 / 28,000 at 40 layers
PHASE4_LAUNCHES_PER_LAYER = {"quant_matmul": 350, "paged_decode": 40,
                             "paged_prefill": 10, "kron_mul": 700}
# (c): the pinned canary set (the serve CLI's defaults) and its period in
# ticks (the clock reads the tick number): a probe at the start and every
# CANARY_EVERY ticks of phase 4's 50
CANARY_PROMPTS, CANARY_LEN, CANARY_EVERY = 2, 16, 16
# phase 10 (b)'s coverage gate: the step spans' phases over the summed host
# wall of the ticks
SPAN_COVERAGE_MIN = 0.9


def _run_ticked(engine, schedule) -> dict:
    """Submit ``schedule`` (tick, submit kwargs) with arrival = its tick and
    drive it through ``run_to_completion`` on a clock that reads the tick
    number (the steps counter), so the engine admits at phase 4's ticks and
    the canary period counts ticks.  Returns the requests by index."""
    steps = engine.metrics.counter("steps")
    engine.now = lambda: float(steps.value)
    reqs = {i: engine.submit(arrival=float(t), **kw)
            for i, (t, kw) in enumerate(schedule)}
    engine.run()
    return {"reqs": reqs}


def _survivor_partings(torch, tag: str, run: dict, base: dict, survivors,
                       check_max: float) -> float:
    """Survivors of a faulted run against the fault-free run: logits
    within phase 5's limit, streams equal but where the fault-free run's
    top-2 margin is below 2 x phase 5's max |diff| (or 2 x this pair's, if
    larger).  Returns this pair's max |diff|."""
    max_d, mean_d, n_pos, firsts, _ = _compare_greedy(
        torch, {"reqs": {i: run["reqs"][i] for i in survivors}}, base)
    bound = 2 * max(check_max, max_d)
    unexplained = [f for f in firsts if f[2] >= bound]
    log(f"[{tag}] survivors {list(survivors)} against the fault-free run: "
        f"{n_pos} positions, logit max |diff| {max_d:.4f} (tol "
        f"{LOGIT_ATOL}), mean {mean_d:.5f}; streams that part: "
        f"{len(firsts)} (request, position, margin: {firsts}; all below "
        f"{bound:.4f}: {'yes' if not unexplained else 'NO'})")
    if max_d > LOGIT_ATOL or unexplained:
        raise AssertionError(f"[{tag}] a fault reached a survivor")
    return max_d


def _arm(spec: str):
    """An event for ``drive_schedule`` that parses ``spec`` with the
    submitted requests' real rids (``{i}`` = request i's) into the
    engine's plan."""
    from repro_torch.serve.faults import parse_fault_plan

    def arm(engine, run):
        rids = [run["reqs"][i].rid for i in range(len(run["reqs"]))]
        engine.faults.rules += parse_fault_plan(spec.format(*rids)).rules
    return arm


def _fault_counts(engine) -> dict:
    return {k: v for k, v in sorted(engine.summary().items())
            if k.startswith("fault:")}


def _decode_dispatch_profile(torch, adapter, args, prompts) -> dict:
    """``torch.profiler`` over one decode tick of a traced engine, after a
    decode tick profiled as warm-up and discarded (the profiler's first
    step may drop kernel records): the quant_matmul kernels launched
    inside the ``dispatch:decode_paged*`` range (a launch belongs to the
    range when its CUDA runtime call does) against all of the tick's, and
    the launch counters' delta over that tick."""
    from torch.profiler import ProfilerActivity, profile, schedule

    from repro_torch.launch.serve import build_engine
    from repro_torch.serve.telemetry import Tracer

    engine = build_engine(adapter, max_seq_len=prompts.shape[1] + 5,
                          args=args)
    engine.attach_tracer(Tracer())
    reqs = [engine.submit(p, max_new=4) for p in prompts]
    while any(not r.out_tokens for r in reqs):
        engine.tick()
    path = WORK_DIR / "decode_tick_trace.json"
    _sync(torch)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: p.export_chrome_trace(str(path))
                 ) as prof:
        for _ in range(2):  # warm-up tick, then the recorded one
            before = _counts()
            engine.tick()
            _sync(torch)
            prof.step()
    counted = {k: v - before[k] for k, v in _counts().items()}
    engine.run()
    events = json.loads(path.read_text())["traceEvents"]
    path.unlink()
    ranges = [e for e in events if e.get("ph") == "X"
              and e.get("cat") == "user_annotation"
              and e.get("name", "").startswith("dispatch:decode_paged")]
    # kernel names are demangled signatures ("void qmm_rows16_kernel<...")
    qmm = [e for e in events if e.get("cat") == "kernel"
           and QMM_PREFIX in e.get("name", "")]
    inside = 0
    if len(ranges) == 1:
        t0, t1 = ranges[0]["ts"], ranges[0]["ts"] + ranges[0]["dur"]
        launched = {e["args"]["correlation"] for e in events
                    if e.get("cat") in ("cuda_runtime", "cuda_driver")
                    and "correlation" in e.get("args", {})
                    and t0 <= e["ts"] <= t1}
        inside = sum(e["args"].get("correlation") in launched for e in qmm)
    cats: dict = {}
    for e in events:
        cats[e.get("cat")] = cats.get(e.get("cat"), 0) + 1
    return {"ranges": [e["name"] for e in ranges], "qmm_inside": inside,
            "qmm_kernels": len(qmm), "counted": counted, "categories": cats}


def phase_observe(torch, *, seed: int, layers: int, check_max: float,
                  artifact, cfg=None, profile: bool = True) -> dict:
    """Phase 10: ``qwen3-14b`` (phase 4's synthetic 2-bit model, full width,
    ``layers`` deep) with phase 4's flags and schedule through (a) a fault
    plan of five kinds with the NaN/Inf screen, a NaN inside a K = 4 verify
    tick, and a corrupt shard of phase 6's ``artifact``; (b) a live sync
    tracer and the metrics registry; (c) canaries and shadow sampling, and
    the quality-baseline round trip on ``artifact``.  ``check_max`` is
    phase 5's max |diff|.  ``cfg`` replaces the model (a rehearsal on the
    CPU at a small one); ``profile`` runs the profiler gate.  Returns the
    kernel launches of each run."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import make_calibration
    from repro_torch.kernels import reset_counts
    from repro_torch.launch import quality_report
    from repro_torch.launch import serve as serve_cli
    from repro_torch.launch.serve import build_engine
    from repro_torch.serve.adapter import CachedDecoder
    from repro_torch.serve.artifacts import ArtifactCorruption, load_quantized
    from repro_torch.serve.faults import FaultPlan, parse_fault_plan
    from repro_torch.serve.quality import (
        _nll_from_logits,
        load_baseline,
        teacher_forced_logits,
        teacher_forced_nll,
    )
    from repro_torch.serve.synthetic import synthetic_quantized_model
    from repro_torch.serve.telemetry import (
        Tracer,
        phase_breakdown,
        validate_chrome_trace,
    )

    t_phase = time.perf_counter()
    if cfg is None:
        cfg = _depth_cut("observe", get_config("qwen3-14b"), layers)
    L = cfg.n_layers
    qm = synthetic_quantized_model(cfg, seed=seed, device=DEV)
    adapter = CachedDecoder.from_quantized(qm)
    prompt_len, gen = 128, 32
    max_seq_len = prompt_len + gen
    arrive = (0, 0, 0, 0, 3, 5, 7, 9)
    prompts = make_calibration(cfg.vocab, n_segments=len(arrive),
                               seg_len=prompt_len, seed=seed + 3)
    schedule = [(t, dict(prompt=p, max_new=gen))
                for p, t in zip(prompts, arrive)]
    paths = {}

    # ---- (a) faults ------------------------------------------------------
    screened = _args(screen_logits=True)
    base_eng, base, paths["observe-a_baseline"] = _serve_schedule(
        torch, "observe-a fault-free", adapter, screened, schedule,
        max_seq_len=max_seq_len, replay=False)
    plan = FaultPlan()
    eng, run, paths["observe-a_faults"] = _serve_schedule(
        torch, "observe-a faults", adapter, screened, schedule,
        max_seq_len=max_seq_len, replay=False, faults=plan,
        events={OBSERVE_ARM_TICK: _arm(OBSERVE_PLAN)})
    s = eng.summary()
    reasons = {i: r.finish_reason for i, r in sorted(run["reqs"].items())}
    fired = {f"fault:{e['kind']}": 1 for e in plan.log}
    counts = _fault_counts(eng)
    want = {i: OBSERVE_OUTCOMES.get(i, "length") for i in reasons}
    log(f"[observe-a] plan {OBSERVE_PLAN!r} armed at tick "
        f"{OBSERVE_ARM_TICK} with the real rids: fired "
        f"{[(e['tick'], e['kind']) for e in plan.log]}; finish reasons "
        f"{reasons}; {counts}; quarantined_lanes {s['quarantined_lanes']}, "
        f"failed {s['failed']}, cancelled {s['cancelled']}; pages_in_use "
        f"{eng.pool.pages_in_use} after the drain")
    if (reasons != want or counts != fired or len(plan.log) != 5
            or s["quarantined_lanes"] != 1 or eng.pool.pages_in_use):
        raise AssertionError("[observe-a] the fault plan's outcomes, "
                             "counters or pages are not as planned")
    survivors = [i for i in reasons if i not in OBSERVE_OUTCOMES]
    _survivor_partings(torch, "observe-a", run, base, survivors, check_max)
    check_logits(torch, qm, [prompts[i] for i in survivors],
                 [run["reqs"][i] for i in survivors], atol=LOGIT_ATOL,
                 mean_atol=LOGIT_MEAN_ATOL, tag="observe-a check")
    del base_eng, eng, run

    # NaN inside a K = 4 verify tick, on phase 9's prompts
    spec_prompts = _spec_prompts(cfg.vocab, seed + 9)
    greedy = [(t, dict(prompt=p, max_new=gen))
              for p, t in zip(spec_prompts, arrive)]
    spec = _args(speculative=SPEC_K, draft="ngram", screen_logits=True)
    later = ("quant_matmul", "paged_prefill", "kron_mul")
    _, vbase, paths["observe-a_verify"] = _serve_schedule(
        torch, f"observe-a K={SPEC_K}", adapter, spec, greedy,
        max_seq_len=max_seq_len, replay=False, required=later)
    vplan = FaultPlan()
    veng, vrun, paths["observe-a_verify_nan"] = _serve_schedule(
        torch, f"observe-a K={SPEC_K} nan", adapter, spec, greedy,
        max_seq_len=max_seq_len, replay=False, required=later, faults=vplan,
        events={0: _arm(OBSERVE_VERIFY_PLAN)})
    vs = veng.summary()
    log(f"[observe-a] K={SPEC_K} with {OBSERVE_VERIFY_PLAN!r}: fired "
        f"{[(e['tick'], e['kind'], e.get('lane')) for e in vplan.log]}, "
        f"request 1 {vrun['reqs'][1].finish_reason} after "
        f"{len(vrun['reqs'][1].out_tokens)} tokens, quarantined_lanes "
        f"{vs['quarantined_lanes']}, spec_ticks {vs['spec_ticks']}")
    if (vrun["reqs"][1].finish_reason != "nan_logits"
            or vs["quarantined_lanes"] != 1 or len(vplan.log) != 1
            or veng.pool.pages_in_use):
        raise AssertionError("[observe-a] the verify tick's NaN lane was "
                             "not quarantined")
    _survivor_partings(torch, f"observe-a K={SPEC_K}", vrun, vbase,
                       [i for i in vrun["reqs"] if i != 1], check_max)
    del veng, vrun, vbase

    try:
        load_quantized(artifact, device=DEV,
                       faults=parse_fault_plan("corrupt_shard@shard=0"))
    except ArtifactCorruption as e:
        log(f"[observe-a] phase 6's artifact with corrupt_shard@shard=0: "
            f"ArtifactCorruption ({e})")
    else:
        raise AssertionError("[observe-a] corrupt_shard@shard=0 loaded")

    # ---- (b) telemetry ---------------------------------------------------
    want_launches = {k: v * L for k, v in PHASE4_LAUNCHES_PER_LAYER.items()}
    walls = []
    traced = None
    for i, trace in enumerate((False, True, True, False)):
        tracer = Tracer(sync=True) if trace else None
        _, reqs, rec = serve_requests(torch, qm, prompts, gen=gen,
                                      arrive=arrive, args=SERVE_ARGS,
                                      tracer=tracer)
        tag = f"observe-b_{'traced' if trace else 'untraced'}_{i}"
        paths[tag] = rec["launches"]
        walls.append((trace, rec["tick_s"], rec["ticks"]))
        got = {k: rec["launches"][k] for k in want_launches}
        if got != want_launches:
            raise AssertionError(f"[{tag}] launches {got}, phase 4 "
                                 f"launches {want_launches}")
        if trace and traced is None:
            traced = (tracer, reqs, rec)
    tracer, reqs, rec = traced
    path = WORK_DIR / "observe_trace.json"
    tracer.export_chrome_trace(path)
    n_ev = validate_chrome_trace(json.loads(path.read_text()))
    path.unlink()
    pb = phase_breakdown(tracer.spans)
    covered = sum(p["time_s"] for p in pb["phases"].values())
    s = rec["summary"]
    ttft = [r.t_first - r.arrival for r in reqs]
    itl = [b - a for r in reqs for a, b in zip(r.token_times,
                                               r.token_times[1:])]
    pct = {f"{n}_p{q}": float(np.percentile(np.asarray(v), q))
           for n, v in (("ttft_s", ttft), ("itl_s", itl)) for q in (50, 99)}
    same_pct = all(s[k] == v for k, v in pct.items())
    log(f"[observe-b] traced run (sync tracer): {len(tracer)} spans, "
        f"{n_ev} trace events valid; {pb['root_count']} step roots over "
        f"{rec['ticks']} ticks; phases "
        f"{ {k: round(p['time_s'], 4) for k, p in pb['phases'].items()} } "
        f"cover {covered:.4f} of {rec['tick_s']:.4f} s of tick wall "
        f"({covered / rec['tick_s']:.1%}, gate {SPAN_COVERAGE_MIN:.0%}; "
        f"{pb['coverage']:.1%} of the step spans); engine percentiles "
        f"{ {k: round(s[k], 6) for k in pct} } equal those of token_times: "
        f"{'yes' if same_pct else 'NO'}")
    if (pb["root_count"] != rec["ticks"]
            or covered < SPAN_COVERAGE_MIN * rec["tick_s"] or not same_pct):
        raise AssertionError("[observe-b] the trace does not cover the "
                             "ticks, or the engine's percentiles differ")
    log("[observe-b] tick wall per run, alternating (a finding, not a "
        "claim): " + ", ".join(
            f"{'traced' if t else 'untraced'} {w / n * 1e3:.2f} ms x {n}"
            for t, w, n in walls))
    if profile:
        prof = _decode_dispatch_profile(torch, adapter, SERVE_ARGS, prompts)
        log(f"[observe-b] torch.profiler over one decode tick: ranges "
            f"{prof['ranges']}, quant_matmul kernels launched inside "
            f"{prof['qmm_inside']} of {prof['qmm_kernels']} in the tick "
            f"(counters: {prof['counted']['quant_matmul']}; 7 x {L} = "
            f"{7 * L}); trace events by category {prof['categories']}")
        if (len(prof["ranges"]) != 1 or prof["qmm_inside"] != 7 * L
                or prof["qmm_kernels"] != 7 * L
                or prof["counted"]["quant_matmul"] != 7 * L):
            raise AssertionError("[observe-b] the decode dispatch range "
                                 "does not hold the tick's quant_matmul "
                                 "launches")
    del traced, tracer, reqs

    # ---- (c) quality -----------------------------------------------------
    canary = make_calibration(cfg.vocab, n_segments=CANARY_PROMPTS,
                              seg_len=CANARY_LEN, seed=seed + 1234)
    qargs = _args(canary_every=CANARY_EVERY, shadow_rate=1.0, seed=seed)
    engine = build_engine(adapter, max_seq_len=max_seq_len, args=qargs)
    engine.attach_canary(canary)
    _sync(torch)
    reset_counts()
    t0 = time.perf_counter()
    qrun = _run_ticked(engine, schedule)
    _sync(torch)
    paths["observe-c_quality"] = _counts()
    qs = engine.summary()
    same = all(qrun["reqs"][i].out_tokens == base["reqs"][i].out_tokens
               for i in base["reqs"])
    before = _counts()
    offline = teacher_forced_nll(adapter, canary)
    probe = {k: v - before[k] for k, v in _counts().items()}
    log(f"[observe-c] canary_every {CANARY_EVERY} ticks, shadow_rate 1.0: "
        f"{qs['steps']} ticks in {time.perf_counter() - t0:.2f}s; streams "
        f"equal to (a)'s fault-free run: {'yes' if same else 'NO'}; "
        f"canary_runs {qs['canary_runs']}, canary_nll {qs['canary_nll']!r}, "
        f"offline teacher_forced_nll {offline!r} (equal: "
        f"{'yes' if offline == qs['canary_nll'] else 'NO'}); act_absmax "
        f"{qs['act_absmax']:.4g}, act_sat {qs['act_sat']:.3g}; one probe "
        f"launches quant_matmul {probe['quant_matmul']}, kron_mul "
        f"{probe['kron_mul']}; pages_in_use {engine.pool.pages_in_use}")
    if (not same or qs["canary_runs"] < 2 or offline != qs["canary_nll"]
            or probe["quant_matmul"] != 7 * L or engine.pool.pages_in_use):
        raise AssertionError("[observe-c] the canary touched traffic, or "
                             "its gauge differs from the offline NLL")
    got = torch.as_tensor(teacher_forced_logits(adapter, canary), device=DEV)
    with torch.no_grad():
        want = qm.logits(torch.as_tensor(canary, dtype=torch.int64,
                                         device=DEV), plain=True).float()
    dmax = float((got - want).abs().max())
    nll_plain = _nll_from_logits(want.cpu().numpy(), canary)
    log(f"[observe-c] canary probe against the recompute oracle "
        f"(logits(plain=True)): logit max |diff| {dmax:.4f} (tol "
        f"{LOGIT_ATOL}), NLL {offline:.6f} against {nll_plain:.6f}, |diff| "
        f"{abs(offline - nll_plain):.2e} (tol 2 x max |diff| = "
        f"{2 * dmax:.2e})")
    if dmax > LOGIT_ATOL or abs(offline - nll_plain) > 2 * dmax:
        raise AssertionError("[observe-c] the canary probe disagrees with "
                             "the recompute oracle")
    diffs = engine.metrics.histogram("shadow_max_abs_logit_diff").samples
    flips = unexplained = 0
    for r in qrun["reqs"].values():
        full = np.concatenate([r.prompt, np.asarray(r.out_tokens, np.int32)])
        rows = teacher_forced_logits(adapter, full[None])[0][
            len(r.prompt) - 1: len(r.prompt) - 1 + len(r.out_tokens)]
        served = np.stack(r.step_logits)
        d = float(np.abs(served - rows).max())
        top2 = np.sort(rows, axis=-1)[:, -2:]
        flip = np.argmax(served, -1) != np.argmax(rows, -1)
        flips += int(flip.sum())
        unexplained += int((flip & (top2[:, 1] - top2[:, 0] >= 2 * d)).sum())
    log(f"[observe-c] shadow: samples {qs['shadow_samples']}, tokens "
        f"{qs['shadow_tokens']}, max_abs_logit_diff per sample "
        f"{[round(x, 4) for x in diffs]} (tol {LOGIT_ATOL}), "
        f"shadow_token_flips {qs['shadow_token_flips']} (recounted "
        f"{flips}; at a margin >= 2 x max |diff|: {unexplained})")
    if (qs["shadow_samples"] != len(schedule) or max(diffs) > LOGIT_ATOL
            or flips != qs["shadow_token_flips"] or unexplained):
        raise AssertionError("[observe-c] shadow sampling disagrees")
    del engine, qrun

    base_json = WORK_DIR / "quality_baseline.json"
    rc = quality_report.main([str(artifact), "--write-baseline",
                              str(base_json)])
    obj = load_baseline(base_json)
    n = len(obj["proxy_loss"])
    obj["proxy_loss"] = {k: v / 2 for k, v in obj["proxy_loss"].items()}
    halved = WORK_DIR / "quality_baseline_halved.json"
    halved.write_text(json.dumps(obj))
    cli = ["--device", DEV, "--load-quantized", str(artifact), "--paged",
           "--paged-prefill", "--requests", "2", "--prompt-len", "16",
           "--gen", "4", "--quality-strict", "--quality-baseline"]
    rc_own = serve_cli.main([*cli, str(base_json)])
    try:
        serve_cli.main([*cli, str(halved)])
        refused = None
    except SystemExit as e:
        refused = str(e)
    log(f"[observe-c] quality_report --write-baseline: rc {rc}, {n} "
        f"layers; serve --quality-strict against it: rc {rc_own}; "
        f"against every proxy loss halved: {refused!r}")
    if rc != 0 or rc_own != 0 or not refused \
            or not refused.startswith(f"refusing to serve: {n} layer"):
        raise AssertionError("[observe-c] the quality baseline round "
                             "trip failed")
    del qm, adapter
    if DEV == "cuda":
        torch.cuda.empty_cache()
    log(f"[observe] phase 10 passed in {time.perf_counter() - t_phase:.1f}s")
    return paths


# ---------------------------------------------------------------------------
# phase 11: tensor-parallel serving
# ---------------------------------------------------------------------------

# phase 11's depths where not phase 4's: (b) K = 4 over int8 pages at
# mp = 2 (a two-rank tick takes ~7x a one-device tick), (c) mp = 4
# (qwen3-14b's 8 KV heads as 2 per rank)
TP_SPEC_LAYERS, TP4_LAYERS = 8, 2
# phase 11 (b)'s NaN: request 1's logits turn NaN inside its verify tick 4
TP_NAN_PLAN = "nan_logits@rid={1},tick=4"
# phase 11 (d): seconds a dead worker may take to turn /healthz non-200
TP_HEALTH_S = 1.0


def _tp_run(torch, tag: str, mesh, dist, args, schedule, *, max_seq_len: int,
            events=None, faults=None) -> tuple:
    """One tensor-parallel run of ``schedule`` with every rank's launch
    counts set to 0 before it and read after it; the pool split and the
    kernels of ``SERVE_KERNELS`` launched on every rank.  Returns (engine,
    run, launches per rank)."""
    from repro_torch.launch.serve import build_engine
    from repro_torch.serve.distributed import (
        rank_launch_counts,
        reset_rank_counts,
    )

    engine = build_engine(dist, max_seq_len=max_seq_len, args=args,
                          record_logits=True, faults=faults)
    pool = engine.pool
    _sync(torch)
    reset_rank_counts(mesh)
    t0 = time.perf_counter()
    run = drive_schedule(engine, schedule, events=events)
    _sync(torch)
    wall = run["wall"] = time.perf_counter() - t0
    per_rank = rank_launch_counts(mesh)
    _leak_gate(tag, engine)
    total = sum(len(r.out_tokens) for r in run["reqs"].values())
    split = pool.total_bytes() // pool.device_bytes()
    log(f"[{tag}] {len(schedule)} requests, {total} tokens in {wall:.2f}s "
        f"over {run['ticks']} ticks ({wall / run['ticks'] * 1e3:.1f} ms a "
        f"tick, {mesh.size} ranks on {mesh.backend}"
        f"{', sharing one card: no TP speed' if mesh.staged else ''}); KV pool "
        f"{pool.total_bytes()} B total, {pool.device_bytes()} B on each rank "
        f"(1/{split}); kernel launches by rank "
        + "; ".join(f"rank {r}: " + ", ".join(
            f"{k} {c[k]}" for k in SERVE_KERNELS)
            for r, c in enumerate(per_rank)))
    missing = [(r, k) for r, c in enumerate(per_rank) for k in SERVE_KERNELS
               if c[k] == 0 and not (k == "paged_decode" and args.speculative)]
    if missing:
        raise AssertionError(f"[{tag}] kernels never launched: {missing}")
    if any(c != per_rank[0] for c in per_rank):
        raise AssertionError(f"[{tag}] ranks launched different kernels")
    return engine, run, per_rank


def _tp_frontdoor(torch, mesh, dist, qm, prompts, base: dict, *,
                  check_max: float, gen: int, max_seq_len: int) -> list:
    """Phase 11 (d): ``FrontDoor`` over (a)'s mesh and adapter, phase 12
    (a)'s client traffic (phase 4's prompts, one buffered, a burst of four
    then one every ``FD_GAP_S``).  Streams equal (a)'s one-device run
    (``base``) but where its top-2 margin is below 2 x ``check_max``, that
    run's max |diff| against the oracle, phase 5's check,
    contiguous SSE indices, ``/healthz`` 200, no tick error, the serving
    kernels launched on every rank alike, a clean drain.  Then a second
    front door over the same adapter, idle, and rank 1 killed: ``/healthz``
    non-200 within ``TP_HEALTH_S``, the drain and the mesh's abort without
    a hang.  Ends the mesh.  Returns the launches by rank."""
    import threading

    from repro_torch.launch.serve import build_engine
    from repro_torch.serve.distributed import (
        rank_launch_counts,
        reset_rank_counts,
    )
    from repro_torch.serve.frontdoor import FrontDoor, leak_gate

    tag = "tp-d"
    n_req = len(prompts)
    engine = build_engine(dist, max_seq_len=max_seq_len, args=SERVE_ARGS,
                          record_logits=True)
    fd = FrontDoor(engine, port=0, drain_timeout_s=30.0, tick_stall_s=60.0)
    _sync(torch)
    reset_rank_counts(mesh)
    t0 = time.perf_counter()
    fd.start_in_thread()
    outs = [{} for _ in range(n_req)]
    threads = []
    for i in range(n_req):
        body = {"prompt": prompts[i].tolist(), "max_new": gen,
                "stream": i != FD_BUFFERED}
        th = threading.Thread(target=_http_stream,
                              args=(fd.port, body, outs[i]))
        th.start()
        threads.append(th)
        if i >= 3:
            time.sleep(FD_GAP_S)
    status, health = _get(fd.port, "/healthz")
    for th in threads:
        th.join(2 * CLIENT_TIMEOUT_S)
    wall = time.perf_counter() - t0
    failed = [(i, o["error"]) for i, o in enumerate(outs) if "error" in o]
    if failed:  # where every rank waits (a stalled client's timeout)
        log(f"[{tag}] clients failed: {failed}\n" + mesh.command_log())
    streams, rids = {}, {}
    for i, o in enumerate(outs):
        streams[i], rids[i] = _stream_tokens(tag, o)
    status_m, metricsz = _get(fd.port, "/metricsz")
    report = fd.drain_and_join(timeout=120)
    _sync(torch)
    per_rank = rank_launch_counts(mesh)
    s = engine.summary()
    by_rid = {r.rid: r for r in engine.finished}
    reqs = [by_rid[rids[i]] for i in range(n_req)]
    log(f"[{tag}] FrontDoor over the mp=2 mesh on 127.0.0.1:{fd.port}: "
        f"{n_req} requests ({n_req - 1} SSE, 1 buffered), a burst of 4 then "
        f"one every {FD_GAP_S * 1e3:.0f} ms: "
        f"{sum(map(len, streams.values()))} tokens in {wall:.2f}s over "
        f"{s['steps']} ticks; /healthz during the run {status} "
        f"{health['status']}; {_client_latency(outs)}; drain: "
        + " / ".join(report.lines()) + f"; tick_errors {s['tick_errors']} "
        f"(/metricsz {status_m} {metricsz.get('tick_errors')}); kernel "
        f"launches by rank " + "; ".join(
            f"rank {r}: " + ", ".join(f"{k} {c[k]}" for k in SERVE_KERNELS)
            for r, c in enumerate(per_rank)))
    if status != 200 or health["status"] != "ok":
        raise AssertionError(f"[{tag}] /healthz did not answer ok")
    if s["tick_errors"] or metricsz.get("tick_errors"):
        raise AssertionError(f"[{tag}] {s['tick_errors']} ticks raised")
    if not report.clean or report.exit_code != 0 \
            or leak_gate(engine.pool) != (0, 0):
        raise AssertionError(f"[{tag}] the drain's leak gate failed")
    missing = [(r, k) for r, c in enumerate(per_rank) for k in SERVE_KERNELS
               if c[k] == 0]
    if missing or any(c != per_rank[0] for c in per_rank):
        raise AssertionError(f"[{tag}] kernels not launched alike on every "
                             f"rank: missing {missing}")
    _splice_partings(torch, tag, streams, base, 2 * check_max)
    check_logits(torch, qm, prompts, reqs, atol=LOGIT_ATOL,
                 mean_atol=LOGIT_MEAN_ATOL, tag=f"{tag} check")
    del engine, fd, reqs, by_rid

    # a worker dies while the engine idles
    engine = build_engine(dist, max_seq_len=max_seq_len, args=SERVE_ARGS)
    fd = FrontDoor(engine, port=0, drain_timeout_s=30.0,
                   tick_stall_s=60.0).start_in_thread()
    before = _get(fd.port, "/healthz")
    worker = mesh.procs[0]
    t_kill = time.perf_counter()
    worker.kill()
    worker.wait()
    status, health = _get(fd.port, "/healthz")
    t_health = time.perf_counter() - t_kill
    report = fd.drain_and_join(timeout=60)
    mesh.close()
    t_end = time.perf_counter() - t_kill
    log(f"[{tag}] rank 1 (pid {worker.pid}) killed under an idle front "
        f"door: /healthz {before[0]} {before[1]['status']} before, "
        f"{status} {health['status']} ({health.get('mesh')!r}) "
        f"{t_health * 1e3:.1f} ms after the kill; drain and the mesh's "
        f"abort done {t_end:.2f}s after it ({report.lines()[0]}; mesh "
        f"{mesh.broken_reason()!r})")
    if before[0] != 200 or status == 200 or t_health > TP_HEALTH_S:
        raise AssertionError(f"[{tag}] /healthz did not turn non-200 "
                             f"within {TP_HEALTH_S}s of a dead rank")
    if not report.clean or mesh.broken_reason() is None:
        raise AssertionError(f"[{tag}] the idle drain or the abort failed")
    return per_rank


def phase_tp(torch, *, seed: int, layers: int, cfg=None) -> dict:
    """Phase 11: tensor-parallel serving (``serve/distributed.py``) with
    ranks sharing the card on gloo.  (a) mp = 2: phase 4's synthetic 2-bit
    model at ``layers`` layers (built by every rank from its seed), flags
    and schedule; streams equal a one-device run of the same model and
    schedule but where its top-2 margin is below 2 x that run's max |diff|
    against the recompute oracle, logits within phase 5's gate of the
    oracle, each rank holding half the pool and half the packed codes.  (b) mp = 2, K =
    4 speculative decode over int8 pages on phase 9's prompts at
    ``TP_SPEC_LAYERS`` layers against the same on one device
    (``INT8_LOGIT_*``), with request 1's logits NaN in a verify tick: that
    lane alone quarantined.  (c) mp = 4 at ``TP4_LAYERS`` layers: 2 KV
    heads a rank, phase 5's gate.  (d), after (b), on (a)'s mesh and
    adapter: the front door over the mesh (:func:`_tp_frontdoor`), held to
    (a)'s one-device run, which ends that mesh.  ``cfg`` replaces the
    model (a rehearsal on the CPU).  Returns every run's launches, by
    rank."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import make_calibration
    from repro_torch.serve.adapter import CachedDecoder
    from repro_torch.serve.distributed import (
        DistributedCachedDecoder,
        make_serving_mesh,
        rank_weight_bytes,
    )
    from repro_torch.serve.faults import FaultPlan
    from repro_torch.serve.synthetic import synthetic_quantized_model

    t_phase = time.perf_counter()
    if cfg is None:
        cfg = _depth_cut("tp", get_config("qwen3-14b"), layers)
    prompt_len, gen = 128, 32
    max_seq_len = prompt_len + gen
    arrive = (0, 0, 0, 0, 3, 5, 7, 9)
    prompts = make_calibration(cfg.vocab, n_segments=len(arrive),
                               seg_len=prompt_len, seed=seed + 3)
    schedule = [(t, dict(prompt=p, max_new=gen))
                for p, t in zip(prompts, arrive)]
    paths = {}

    def by_rank(tag, per_rank):
        for r, c in enumerate(per_rank):
            paths[f"{tag} rank{r}"] = c

    # ---- (a) mp = 2, phase 4 ----------------------------------------------
    t0 = time.perf_counter()
    mesh = make_serving_mesh(1, 2, device=DEV)
    log(f"[tp] {mesh.describe()}; started in "
        f"{time.perf_counter() - t0:.1f}s")
    try:
        t0 = time.perf_counter()
        dist = DistributedCachedDecoder.from_builder(
            synthetic_quantized_model, mesh=mesh, cfg=cfg, seed=seed)
        qm = synthetic_quantized_model(cfg, seed=seed, device=DEV)
        full = sum(blk[n].packed.numel() * 4 for blk in qm.blocks
                   for n in blk if hasattr(blk[n], "packed"))
        per_rank = rank_weight_bytes(dist)
        log(f"[tp-a] synthetic 2-bit {cfg.name} ({cfg.n_layers} layers) "
            f"built by every rank in {time.perf_counter() - t0:.1f}s; "
            f"packed codes {full} B whole, by rank {per_rank}")
        if any(b * 2 != full for b in per_rank):
            raise AssertionError("[tp-a] a rank does not hold half the codes")
        # the reference at the same depth: one device, the same schedule
        _, one, paths["tp-a one device"] = _serve_schedule(
            torch, f"tp-a one device {cfg.n_layers} layers",
            CachedDecoder.from_quantized(qm), SERVE_ARGS, schedule,
            max_seq_len=max_seq_len, replay=False, required=SERVE_KERNELS)
        base = one["reqs"]
        check_max = check_logits(
            torch, qm, prompts, [base[i] for i in range(len(prompts))],
            atol=LOGIT_ATOL, mean_atol=LOGIT_MEAN_ATOL,
            tag="tp-a one device check")["max_diff"]
        del one
        eng, run, launches = _tp_run(torch, "tp-a mp=2", mesh, dist,
                                     SERVE_ARGS, schedule,
                                     max_seq_len=max_seq_len)
        by_rank("tp-a mp=2", launches)
        pool = eng.pool
        if not dist._pool_sharded or pool.device_bytes() * 2 != \
                pool.total_bytes():
            raise AssertionError("[tp-a] the KV pool did not split in two")
        max_d, mean_d, n_pos, firsts, _ = _compare_greedy(torch, run, {
            "reqs": {i: base[i] for i in run["reqs"]}})
        bound = 2 * check_max
        unexplained = [f for f in firsts if f[2] >= bound]
        log(f"[tp-a] against the one-device run: {n_pos} positions, logit "
            f"max |diff| {max_d:.4f}, mean {mean_d:.5f}; streams that part: "
            f"{len(firsts)} (request, position, margin: {firsts}; all "
            f"below 2 x its max |diff| = {bound:.4f}: "
            f"{'yes' if not unexplained else 'NO'})")
        if unexplained:
            raise AssertionError("[tp-a] streams part from one device's")
        check_logits(torch, qm, prompts, [run["reqs"][i]
                                          for i in range(len(prompts))],
                     atol=LOGIT_ATOL, mean_atol=LOGIT_MEAN_ATOL,
                     tag="tp-a check")
        del eng, run
        dist_a, qm_a = dist, qm  # (d)'s, after (b)

        # ---- (b) mp = 2: K = 4 over int8 pages, a NaN lane ---------------
        cfg_b = dataclasses.replace(
            cfg, n_layers=min(TP_SPEC_LAYERS, cfg.n_layers))
        dist = DistributedCachedDecoder.from_builder(
            synthetic_quantized_model, mesh=mesh, cfg=cfg_b, seed=seed)
        qm = synthetic_quantized_model(cfg_b, seed=seed, device=DEV)
        spec_prompts = _spec_prompts(cfg.vocab, seed + 9)
        greedy = [(t, dict(prompt=p, max_new=gen))
                  for p, t in zip(spec_prompts, arrive)]
        spec = _args(speculative=SPEC_K, draft="ngram", kv_int8=True,
                     screen_logits=True)
        _, one, paths["tp-b one device"] = _serve_schedule(
            torch, f"tp-b one device K={SPEC_K} int8 {cfg_b.n_layers} "
            f"layers",
            CachedDecoder.from_quantized(qm), spec, greedy,
            max_seq_len=max_seq_len, replay=False,
            required=tuple(k for k in SERVE_KERNELS if k != "paged_decode"))
        plan = FaultPlan()
        eng, run, launches = _tp_run(
            torch, f"tp-b mp=2 K={SPEC_K} int8 nan {cfg_b.n_layers} layers",
            mesh, dist, spec,
            greedy, max_seq_len=max_seq_len, faults=plan,
            events={0: _arm(TP_NAN_PLAN)})
        by_rank(f"tp-b mp=2 K={SPEC_K} int8", launches)
        s = eng.summary()
        log(f"[tp-b] {TP_NAN_PLAN!r}: fired "
            f"{[(e['tick'], e['kind'], e.get('lane')) for e in plan.log]}, "
            f"request 1 {run['reqs'][1].finish_reason} after "
            f"{len(run['reqs'][1].out_tokens)} tokens, quarantined_lanes "
            f"{s['quarantined_lanes']}, accepted {s['accepted_tokens']} of "
            f"{s['draft_tokens']} drafts, spec_ticks {s['spec_ticks']}")
        if (run["reqs"][1].finish_reason != "nan_logits"
                or s["quarantined_lanes"] != 1 or len(plan.log) != 1
                or s["accepted_tokens"] == 0):
            raise AssertionError("[tp-b] the NaN lane was not quarantined "
                                 "alone")
        survivors = [i for i in run["reqs"] if i != 1]
        max_d, mean_d, n_pos, firsts, _ = _compare_greedy(
            torch, {"reqs": {i: run["reqs"][i] for i in survivors}}, one)
        bound = 2 * max(check_max, max_d)
        unexplained = [f for f in firsts if f[2] >= bound]
        log(f"[tp-b] survivors against one device: {n_pos} positions, "
            f"logit max |diff| {max_d:.4f} (tol {INT8_LOGIT_ATOL}), mean "
            f"{mean_d:.5f} (tol {INT8_LOGIT_MEAN_ATOL}); streams that part: "
            f"{len(firsts)} ({firsts}; all below {bound:.4f}: "
            f"{'yes' if not unexplained else 'NO'})")
        if (max_d > INT8_LOGIT_ATOL or mean_d > INT8_LOGIT_MEAN_ATOL
                or unexplained):
            raise AssertionError("[tp-b] int8 K=4 at mp=2 disagrees")
        del eng, run, one, dist, qm

        # ---- (d) the front door over (a)'s mesh and adapter ---------------
        t0 = time.perf_counter()
        by_rank("tp-d frontdoor mp=2", _tp_frontdoor(
            torch, mesh, dist_a, qm_a, prompts, base, check_max=check_max,
            gen=gen, max_seq_len=max_seq_len))
        log(f"[tp-d] passed in {time.perf_counter() - t0:.1f}s")
        del dist_a, qm_a
    finally:
        mesh.close()
    if DEV == "cuda":
        torch.cuda.empty_cache()

    # ---- (c) mp = 4: two KV heads a rank ---------------------------------
    cfg4 = dataclasses.replace(cfg, n_layers=min(TP4_LAYERS, cfg.n_layers))
    t0 = time.perf_counter()
    mesh = make_serving_mesh(1, 4, device=DEV)
    log(f"[tp] {mesh.describe()}; started in "
        f"{time.perf_counter() - t0:.1f}s")
    try:
        dist = DistributedCachedDecoder.from_builder(
            synthetic_quantized_model, mesh=mesh, cfg=cfg4, seed=seed)
        qm = synthetic_quantized_model(cfg4, seed=seed, device=DEV)
        eng, run, launches = _tp_run(torch, f"tp-c mp=4 {cfg4.n_layers} "
                                     f"layers", mesh, dist, SERVE_ARGS,
                                     schedule, max_seq_len=max_seq_len)
        by_rank("tp-c mp=4", launches)
        if not dist._pool_sharded or eng.adapter._attn_cfg.n_kv_heads != \
                cfg.n_kv_heads // 4:
            raise AssertionError("[tp-c] the pool did not split over 4")
        check_logits(torch, qm, prompts, [run["reqs"][i]
                                          for i in range(len(prompts))],
                     atol=LOGIT_ATOL, mean_atol=LOGIT_MEAN_ATOL,
                     tag="tp-c check")
        del eng, run, dist, qm
    finally:
        mesh.close()
    if DEV == "cuda":
        torch.cuda.empty_cache()
    log(f"[tp] phase 11 passed in {time.perf_counter() - t_phase:.1f}s")
    return paths


# ---------------------------------------------------------------------------
# phase 12: the HTTP/SSE front door and the replica fleet
# ---------------------------------------------------------------------------

# (a) the front door's traffic: phase 4's eight prompts, request FD_BUFFERED
# buffered and the rest SSE, a burst of four then one every FD_GAP_S
FD_BUFFERED = 5
FD_GAP_S = 0.1
# (b) the fleet: the sampled request (T 0.8, top-p 0.9) on prompt
# FLEET_SAMPLED_PROMPT with seed FLEET_SAMPLE_SEED; replica 1 is killed
# (SIGKILL) once every stream routed to it holds FLEET_KILL_AFTER tokens
FLEET_SAMPLED_PROMPT, FLEET_SAMPLE_SEED = 0, 11
FLEET_KILL_AFTER = 4
# extra replica flags (a CPU rehearsal slows its replicas' ticks with a
# replica_slow fault plan, so the kill lands mid-stream)
FLEET_EXTRA_ARGS: list = []
# how long a client waits on its socket, seconds
CLIENT_TIMEOUT_S = 60
# (c) the fleet over meshes: two `--mesh 1,2` replicas (four ranks sharing
# the card on gloo, ~1 s a 40-layer tick) of phase 4's model at full width,
# its depth cut to FLEET_TP_LAYERS for the script's time limit alone; the
# first FLEET_TP_GREEDY of phase 4's prompts greedy, and the sampled one
FLEET_TP_LAYERS = 8
FLEET_TP_GREEDY = 4
# seconds the killed mesh's processes may outlive its rank 0's SIGKILL
FLEET_REAP_S = 10.0


def _http_stream(port: int, body: dict, out: dict, *,
                 abort_after=None) -> None:
    """One client of ``POST /v1/generate`` (run on a thread): the status,
    and every SSE frame with the time it reached this socket (or the
    buffered payload); ``abort_after`` = n resets the connection (RST)
    after n token frames.  Fills ``out``."""
    import http.client
    import socket
    import struct

    out["t_send"] = time.perf_counter()
    c = http.client.HTTPConnection("127.0.0.1", port,
                                   timeout=CLIENT_TIMEOUT_S)
    try:
        c.request("POST", "/v1/generate", json.dumps(body),
                  {"Content-Type": "application/json"})
        r = c.getresponse()
        out["status"] = r.status
        if r.status != 200 or not body.get("stream", True):
            out["body"] = json.loads(r.read())
            out["t_done"] = time.perf_counter()
            return
        frames, event = [], None
        while True:
            line = r.fp.readline()
            if not line:
                break
            if line.startswith(b"event: "):
                event = line[7:].strip().decode()
            elif line.startswith(b"data: "):
                frames.append((time.perf_counter(), event,
                               json.loads(line[6:])))
                n_tok = sum(1 for f in frames if f[1] == "token")
                if abort_after is not None and n_tok >= abort_after:
                    sock = r.fp.raw._sock
                    sock.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                                    struct.pack("ii", 1, 0))
                    r.close()
                    sock.close()
                    break
                if event == "done":
                    break
        out["frames"] = frames
    except Exception as e:  # reported by the caller's gates
        out["error"] = repr(e)
    finally:
        c.close()


def _stream_tokens(tag: str, out: dict) -> tuple:
    """(tokens, rid) of one finished client: status 200, SSE frame indices
    contiguous from 0, one done frame carrying the same tokens."""
    if "error" in out or out.get("status") != 200:
        raise AssertionError(f"[{tag}] client failed: {out.get('status')} "
                             f"{out.get('error') or out.get('body')}")
    if "frames" not in out:
        return out["body"]["tokens"], out["body"]["rid"]
    toks = [d["token"] for _, ev, d in out["frames"] if ev == "token"]
    idx = [d["i"] for _, ev, d in out["frames"] if ev == "token"]
    done = [d for _, ev, d in out["frames"] if ev == "done"]
    if idx != list(range(len(toks))) or len(done) != 1 \
            or done[0]["tokens"] != toks:
        raise AssertionError(f"[{tag}] SSE frames not contiguous or not "
                             f"closed by one done frame: indices {idx}")
    return toks, done[0]["rid"]


def _client_latency(outs) -> str:
    """TTFT and ITL p50/p99 at the client socket, over the SSE clients."""
    import numpy as np

    ttft, itl = [], []
    for o in outs:
        ts = [t for t, ev, _ in o.get("frames", ()) if ev == "token"]
        if ts:
            ttft.append(ts[0] - o["t_send"])
            itl.extend(np.diff(ts))

    def pct(xs, q):
        return float(np.percentile(xs, q)) * 1e3 if len(xs) else 0.0

    return (f"ttft p50 {pct(ttft, 50):.1f} ms p99 {pct(ttft, 99):.1f} ms; "
            f"itl p50 {pct(itl, 50):.1f} ms p99 {pct(itl, 99):.1f} ms "
            f"(at the client socket, {len(ttft)} SSE streams)")


def _get(port: int, path: str) -> tuple:
    import http.client

    c = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    try:
        c.request("GET", path)
        r = c.getresponse()
        return r.status, json.loads(r.read())
    finally:
        c.close()


def _wait_for(pred, timeout: float, what: str) -> None:
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < timeout:
        if pred():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out after {timeout:.0f}s waiting for "
                         f"{what}")


def _splice_partings(torch, tag: str, streams: dict, base: dict,
                     bound: float) -> list:
    """Token streams that came over the wire (no logits) against a greedy
    run's requests: equal but where the run's top-2 margin at the first
    parting is below ``bound``."""
    firsts, bad = [], []
    for i, toks in streams.items():
        ref = base[i]
        n = next((k for k, (a, b) in enumerate(zip(toks, ref.out_tokens))
                  if a != b), None)
        if n is None:
            if len(toks) != len(ref.out_tokens):
                bad.append((i, "length"))
            continue
        top2 = torch.topk(torch.as_tensor(ref.step_logits[n]).float(),
                          2).values
        margin = float(top2[0] - top2[1])
        firsts.append((i, n, round(margin, 4)))
        if margin >= bound:
            bad.append((i, n))
    log(f"[{tag}] {len(streams)} streams against the in-process ones: "
        f"{len(firsts)} part (request, position, margin: {firsts}); all "
        f"below {bound:.4f}: {'yes' if not bad else 'NO ' + str(bad)}")
    if bad:
        raise AssertionError(f"[{tag}] a stream parts where no logit "
                             f"error explains it")
    return firsts


def _sampled_splice(torch, tag: str, toks, ref, *, delta: float,
                    floor: float) -> None:
    """A sampled stream that came over the wire against an uninterrupted
    sampled run of the same request on the card: equal up to the first
    parting, which :func:`_draw_explained` must admit on the run's logits
    with every logit moved by up to ``delta`` (the replica's logits do not
    cross the wire: twice the drift measured between two batchings of the
    same requests) and the CDF by ``floor`` (both draws' float32
    rounding, twice each)."""
    from repro_torch.serve.adapter import uniform

    sp = ref.sampling
    n = next((k for k, (a, b) in enumerate(zip(toks, ref.out_tokens))
              if a != b), None)
    if n is None:
        ok = len(toks) == len(ref.out_tokens)
        note = "equal"
    else:
        u = float(uniform(torch.tensor(sp.seed), torch.tensor(n)))
        ok, dist = _draw_explained(ref.step_logits[n], sp.temperature,
                                   sp.top_p, u, toks[n], delta=delta,
                                   floor=floor)
        note = f"part at {n} (edge distance {dist:.3g})"
    log(f"[{tag}] sampled stream (T {sp.temperature}, top-p {sp.top_p}, "
        f"seed {sp.seed}) against the uninterrupted run on the card: "
        f"{note}; admitted with |dlogit| <= {delta:.4f}, CDF floor "
        f"{floor:.3g}: {'yes' if ok else 'NO'}")
    if not ok:
        raise AssertionError(f"[{tag}] the sampled splice parts where no "
                             f"rounding explains it")


def _timed_factory(tail):
    """A ``ProcessReplicaFactory`` of ``tail`` that notes when it spawned
    each replica generation (``spawned``, for the start seconds) and
    echoes each replica line with the seconds since its spawn."""
    from repro_torch.serve.fleet import ProcessReplicaFactory, replica_command

    class TimedFactory(ProcessReplicaFactory):
        spawned: dict = {}  # (index, generation) -> perf_counter

        def spawn(self, handle) -> None:
            self.spawned[(handle.index, handle.generation + 1)] = \
                time.perf_counter()
            super().spawn(handle)

        def _pump(self, handle, pipe) -> None:
            t0 = self.spawned[(handle.index, handle.generation)]
            for line in iter(pipe.readline, b""):
                print(f"[replica {handle.index} "
                      f"+{time.perf_counter() - t0:.1f}s] "
                      f"{line.decode(errors='replace').rstrip()}",
                      flush=True)
            pipe.close()

    return TimedFactory(replica_command(tail))


def _mesh_procs(pid: int) -> list:
    """A mesh replica's processes as (pid, start time): rank 0 and every
    worker under it."""
    from repro_torch.serve.fleet.supervisor import _descendants, _stat

    st = _stat(pid)
    return ([] if st is None else [(pid, st[19])]) + _descendants(pid)


def _gpu_apps(torch) -> list:
    """``nvidia-smi``'s compute apps on the card as (pid, used memory)
    (none off the card).  In a container the pids may be the host's."""
    if DEV != "cuda":
        return []
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout
    return [(int(ln.split(",")[0]), ln.split(",")[1].strip())
            for ln in out.splitlines() if ln.strip()]


def _fleet_tp(torch, *, cfg, seed: int, prompts, args, check_max: float,
              prompt_len: int, gen: int) -> None:
    """Phase 12 (c): two replica processes of ``launch/serve.py --mesh
    1,2`` behind an in-process ``Supervisor`` and ``FleetRouter``, over
    phase 4's model at ``FLEET_TP_LAYERS`` layers saved as an artifact.
    ``FLEET_TP_GREEDY`` greedy requests and one sampled; replica 1's rank
    0 SIGKILLed once its streams hold ``FLEET_KILL_AFTER`` tokens: its
    mesh gone within ``FLEET_REAP_S`` (``/proc`` and ``nvidia-smi``),
    every stream whole, the splices held to an uninterrupted one-device
    run on the card (greedy under the margin rule, sampled as (b)),
    replica 1 back as generation 2 serving a later request.  While replica
    1 restarts, a worker of idle replica 0 SIGKILLed: the supervisor
    restarts replica 0 within ``fail_threshold`` probes, the backoff and
    one replica start.  A clean fleet drain, and no mesh process left."""
    import dataclasses
    import os
    import signal
    import threading

    import numpy as np

    from repro_torch.launch.serve import build_engine
    from repro_torch.serve.adapter import CachedDecoder
    from repro_torch.serve.artifacts import save_quantized
    from repro_torch.serve.fleet import (
        FleetRouter,
        Supervisor,
        prefix_key,
        rendezvous_rank,
    )
    from repro_torch.serve.fleet.supervisor import _running
    from repro_torch.serve.scheduler import SamplingParams
    from repro_torch.serve.synthetic import (
        QUIP_CONFIG,
        synthetic_quantized_model,
    )

    tag = "fleet-tp"
    t_c = time.perf_counter()
    cfg = _depth_cut(tag, cfg, min(FLEET_TP_LAYERS, cfg.n_layers))
    max_seq_len = prompt_len + gen
    greedy = list(range(FLEET_TP_GREEDY))
    qm = synthetic_quantized_model(cfg, seed=seed, device=DEV)

    # the uninterrupted runs on one device: the greedy requests batched
    # and one by one (their drift between batchings), the sampled alone
    def one_device(idx, sampling=None, serial=False):
        eng = build_engine(CachedDecoder.from_quantized(qm),
                           max_seq_len=max_seq_len, args=args,
                           record_logits=True)
        out = {}
        for i in idx:
            out[i] = eng.submit(prompts[i], max_new=gen, sampling=sampling)
            if serial:
                eng.run()
        eng.run()
        return out

    art = WORK_DIR / "fleet_tp_artifact"
    shutil.rmtree(art, ignore_errors=True)
    save_quantized(art, qm, QUIP_CONFIG, extra_meta={"seed": seed})
    affinity = [rendezvous_rank(prefix_key(prompts[i]), 2)[0] for i in greedy]
    if affinity[FLEET_SAMPLED_PROMPT] != 1:
        raise AssertionError(f"[{tag}] the sampled prompt's affinity is not "
                             f"replica 1")

    tail = ["--load-quantized", str(art), "--paged", "--paged-prefill",
            "--device", DEV, "--mesh", "1,2", "--slots", str(args.slots),
            "--page-size", str(args.page_size), "--token-budget",
            str(args.token_budget), "--prefill-chunk",
            str(args.prefill_chunk), "--prompt-len", str(prompt_len),
            "--gen", str(gen), "--drain-timeout-s", "30", "--tick-stall-s",
            "60", *FLEET_EXTRA_ARGS]
    factory = _timed_factory(tail)
    sup = Supervisor(factory, 2, probe_interval_s=0.5, start_timeout_s=600,
                     max_restarts=1, backoff_base_s=0.5,
                     replica_drain_timeout_s=90)
    router = FleetRouter(sup, port=0, drain_timeout_s=60,
                         stream_idle_timeout_s=120)
    h0, h1 = sup.handles
    starts, ready_at = {}, {}

    def ready(h, generation):
        if h.state == "healthy" and h.generation == generation:
            key = (h.index, generation)
            if key not in ready_at:
                ready_at[key] = time.perf_counter()
                starts[key] = ready_at[key] - factory.spawned[key]
            return True
        return False

    def gone(procs, apps_before=()):
        """``procs`` ended per /proc and per nvidia-smi: none of their pids
        listed and, given the list before (the container shows the host's
        pids), as many fewer apps listed."""
        apps = _gpu_apps(torch)
        return not any(map(_running, procs)) \
            and not {p for p, _ in procs} & {p for p, _ in apps} \
            and (not apps_before
                 or len(apps) <= len(apps_before) - len(procs))

    drained = False
    meshes = []
    start_errors = []

    def start():
        try:
            router.start_in_thread()
            for h in sup.handles:
                ready(h, 1)
        except BaseException as e:  # raised on the main thread below
            start_errors.append(e)

    try:
        # the replicas start while the one-device references run here
        starter = threading.Thread(target=start, name="fleet-start")
        starter.start()
        try:
            batched = one_device(greedy)
            drift = _compare_greedy(
                torch, {"reqs": one_device(greedy, serial=True)},
                {"reqs": batched})[0]
            sp = SamplingParams(temperature=SAMPLE_TEMP, top_p=SAMPLE_TOP_P,
                                seed=FLEET_SAMPLE_SEED)
            sampled_ref = one_device([FLEET_SAMPLED_PROMPT],
                                     sp)[FLEET_SAMPLED_PROMPT]
            cdf_err = _cdf_rounding(torch, torch.as_tensor(
                np.stack(sampled_ref.step_logits)).to(DEV), SAMPLE_TEMP,
                SAMPLE_TOP_P)
        finally:
            starter.join()
        del qm
        if DEV == "cuda":
            torch.cuda.empty_cache()
        if start_errors:
            raise start_errors[0]
        bound = 2 * max(check_max, drift)
        meshes = [_mesh_procs(h.pid) for h in sup.handles]
        apps = _gpu_apps(torch)  # this process and the four ranks
        log(f"[{tag}] 2 replicas of `python -m repro_torch.launch.serve "
            f"{' '.join(tail)}` ready, started in "
            f"{starts[(0, 1)]:.1f}s and {starts[(1, 1)]:.1f}s; processes "
            f"(rank 0 first) {[[p for p, _ in m] for m in meshes]}; "
            f"nvidia-smi compute apps {apps}; prompts' affinity {affinity}")
        if any(len(m) != 2 for m in meshes):
            raise AssertionError(f"[{tag}] a replica is not a mesh of two "
                                 f"ranks")
        bodies = {i: {"prompt": prompts[i].tolist(), "max_new": gen}
                  for i in greedy}
        bodies["sampled"] = {"prompt": prompts[FLEET_SAMPLED_PROMPT].tolist(),
                             "max_new": gen, "temperature": SAMPLE_TEMP,
                             "top_p": SAMPLE_TOP_P, "seed": FLEET_SAMPLE_SEED}
        outs = {k: {} for k in bodies}
        threads = [threading.Thread(target=_http_stream,
                                    args=(router.port, b, outs[k]))
                   for k, b in bodies.items()]
        for th in threads:
            th.start()
        n_on1 = affinity.count(1) + 1

        def midway():
            entries = [e for e in router.journal.live() if e.replica == 1]
            return h1.routed >= n_on1 and entries and all(
                len(e.tokens) >= FLEET_KILL_AFTER for e in entries)

        _wait_for(midway, 300, "every stream on replica 1 to be mid-way")
        held = sorted(len(e.tokens) for e in router.journal.live()
                      if e.replica == 1)
        t_kill = time.perf_counter()
        os.kill(h1.pid, signal.SIGKILL)
        _wait_for(lambda: gone(meshes[1], apps), FLEET_REAP_S,
                  "the killed mesh's processes to end")
        t_gone = time.perf_counter() - t_kill
        log(f"[{tag}] SIGKILL to replica 1's rank 0 (pid {h1.pid}) holding "
            f"{len(held)} streams at {held} tokens: its mesh "
            f"{[p for p, _ in meshes[1]]} gone from /proc and nvidia-smi "
            f"{t_gone:.2f}s later (nvidia-smi now lists {_gpu_apps(torch)}"
            f", {len(apps)} before)")
        for th in threads:
            th.join(2 * CLIENT_TIMEOUT_S)
        toks = {k: _stream_tokens(tag, o)[0] for k, o in outs.items()}
        _, fz = _get(router.port, "/fleetz")
        log(f"[{tag}] {len(bodies)} requests ({len(greedy)} greedy, 1 "
            f"sampled): failovers {fz['router']['failovers']}, routed per "
            f"replica {[r['routed'] for r in fz['replicas']]}; "
            f"{_client_latency(outs.values())}; drift between batchings on "
            f"one device {drift:.4f}")
        if fz["router"]["failovers"] < 1:
            raise AssertionError(f"[{tag}] no failover")
        _splice_partings(torch, f"{tag} greedy",
                         {i: toks[i] for i in greedy}, batched, bound)
        _sampled_splice(torch, f"{tag} sampled", toks["sampled"],
                        sampled_ref, delta=2 * drift, floor=4 * cdf_err)

        # replica 1 comes back while a worker of replica 0, idle now, dies:
        # /healthz 503 mesh_broken, fail_threshold probes, a restart; the
        # two restarts overlap
        old0 = meshes[0]
        t_kill0 = time.perf_counter()
        os.kill(old0[1][0], signal.SIGKILL)
        _wait_for(lambda: all([ready(h0, 2), ready(h1, 2)]), 600,
                  "replicas 0 and 1 to restart")
        t_back = ready_at[(0, 2)] - t_kill0
        t_restart = ready_at[(1, 2)] - t_kill
        meshes = [_mesh_procs(h.pid) for h in sup.handles]
        limit = (sup.fail_threshold * sup.probe_interval_s
                 + sup.backoff_base_s + 2 * sup.probe_interval_s
                 + max(starts.values()))
        log(f"[{tag}] replica 1 back as generation {h1.generation} "
            f"{t_restart:.1f}s after its kill (this start "
            f"{starts[(1, 2)]:.1f}s), processes {[p for p, _ in meshes[1]]}"
            f"; SIGKILL to replica 0's worker (pid {old0[1][0]}) while "
            f"idle: replica 0 back as generation {h0.generation} "
            f"{t_back:.1f}s later (this start {starts[(0, 2)]:.1f}s; limit "
            f"{sup.fail_threshold} probes x {sup.probe_interval_s}s + "
            f"backoff {sup.backoff_base_s}s + 2 probe periods + the slowest "
            f"start = {limit:.1f}s); its old mesh gone: {gone(old0)}")
        if t_back > limit or not gone(old0) or len(meshes[0]) != 2 \
                or len(meshes[1]) != 2:
            raise AssertionError(f"[{tag}] a replica was not restarted as a "
                                 f"new mesh in time")
        # the restarted replica 1 serves a later request
        later_i = next(i for i in greedy if affinity[i] == 1)
        served_before = h1.served
        later = {}
        _http_stream(router.port, bodies[later_i], later)
        _splice_partings(torch, f"{tag} restarted",
                         {later_i: _stream_tokens(tag, later)[0]}, batched,
                         bound)
        _wait_for(lambda: h1.served == served_before + 1, 30,
                  "the restarted replica to serve the later request")
        errs = {h.index: _get(h.port, "/metricsz")[1]["tick_errors"]
                for h in sup.handles}
        if any(errs.values()):
            raise AssertionError(f"[{tag}] a replica's ticks raised: {errs}")
        frep = router.drain_and_join(timeout=300)
        drained = True
    finally:
        if not drained:  # no more restarts; stop every replica started
            sup._draining = True
            for h in sup.handles:
                factory.kill(h)
    left = [p for m in meshes for p in m if _running(p)]
    log(f"[{tag}] fleet drain: " + " / ".join(frep.lines())
        + f"; mesh processes left {left}; replica starts (index, "
        f"generation): seconds {starts}; 12 (c) took "
        f"{time.perf_counter() - t_c:.1f}s")
    if not frep.clean or frep.failed or left \
            or [r["restarts"] for r in frep.replicas] != [1, 1] \
            or any(r["exit_code"] != 0 for r in frep.replicas):
        raise AssertionError(f"[{tag}] the fleet drain was not clean")
    shutil.rmtree(art, ignore_errors=True)


def phase_frontdoor(torch, *, seed: int, layers: int, cfg=None) -> dict:
    """Phase 12: (a) phase 4's model (rebuilt from its seed, full width,
    ``layers`` deep) behind ``FrontDoor`` in this process, phase 4's
    prompts sent by HTTP clients, the streams held to phase 4's schedule
    run on the same model in this process (``serve_requests``) and to the
    recompute oracle; (b) the same model as an
    artifact served by two replica processes of ``launch/serve.py`` behind
    an in-process ``Supervisor`` and ``FleetRouter``, replica 1 killed
    (SIGKILL) mid-stream and restarted; (c) the same over two
    ``--mesh 1,2`` replicas (:func:`_fleet_tp`).  ``check_max`` is the
    reference run's max |diff| against the oracle.  ``cfg`` replaces the
    model (a rehearsal on the CPU at a small one).  Returns (a)'s kernel
    launches."""
    import dataclasses
    import os
    import signal
    import threading

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import make_calibration
    from repro_torch.kernels import reset_counts
    from repro_torch.launch.serve import build_engine
    from repro_torch.serve.adapter import CachedDecoder
    from repro_torch.serve.artifacts import save_quantized
    from repro_torch.serve.fleet import (
        FleetRouter,
        ProcessReplicaFactory,
        Supervisor,
        prefix_key,
        rendezvous_rank,
        replica_command,
    )
    from repro_torch.serve.frontdoor import FrontDoor, leak_gate
    from repro_torch.serve.scheduler import SamplingParams
    from repro_torch.serve.synthetic import (
        QUIP_CONFIG,
        synthetic_quantized_model,
    )

    t_phase = time.perf_counter()
    if cfg is None:
        cfg = _depth_cut("frontdoor", get_config("qwen3-14b"), layers)
    args = _args()
    prompt_len, gen = 128, 32
    max_seq_len = prompt_len + gen
    n_req = 8
    prompts = make_calibration(cfg.vocab, n_segments=n_req,
                               seg_len=prompt_len, seed=seed + 3)
    qm = synthetic_quantized_model(cfg, seed=seed, device=DEV)
    # the reference at the same depth: phase 4's schedule on one device
    _, ref_reqs, served = serve_requests(
        torch, qm, prompts, gen=gen, arrive=(0, 0, 0, 0, 3, 5, 7, 9),
        args=SERVE_ARGS)
    check_max = check_logits(torch, qm, prompts, ref_reqs, atol=LOGIT_ATOL,
                             mean_atol=LOGIT_MEAN_ATOL,
                             tag="frontdoor reference check")["max_diff"]
    base = dict(enumerate(ref_reqs))
    bound = 2 * check_max

    # ---- (a) the front door in this process -----------------------------
    engine = build_engine(CachedDecoder.from_quantized(qm),
                          max_seq_len=max_seq_len, args=args,
                          record_logits=True)
    fd = FrontDoor(engine, port=0, drain_timeout_s=30.0, tick_stall_s=60.0)
    _sync(torch)
    reset_counts()
    t0 = time.perf_counter()
    fd.start_in_thread()
    outs = [{} for _ in range(n_req)]
    threads = []
    for i in range(n_req):
        body = {"prompt": prompts[i].tolist(), "max_new": gen,
                "stream": i != FD_BUFFERED}
        th = threading.Thread(target=_http_stream,
                              args=(fd.port, body, outs[i]))
        th.start()
        threads.append(th)
        if i >= 3:
            time.sleep(FD_GAP_S)
    status, health = _get(fd.port, "/healthz")
    for th in threads:
        th.join(2 * CLIENT_TIMEOUT_S)
    wall = time.perf_counter() - t0
    streams, rids = {}, {}
    for i, o in enumerate(outs):
        streams[i], rids[i] = _stream_tokens("frontdoor", o)
    log(f"[frontdoor] FrontDoor on 127.0.0.1:{fd.port}: {n_req} requests "
        f"({n_req - 1} SSE, 1 buffered), a burst of 4 then one every "
        f"{FD_GAP_S * 1e3:.0f} ms: {sum(map(len, streams.values()))} tokens "
        f"in {wall:.2f}s; /healthz during the run {status} "
        f"{health['status']}; {_client_latency(outs)}")
    if status != 200 or health["status"] != "ok":
        raise AssertionError("[frontdoor] /healthz did not answer ok")
    # an over-capacity body, then a client that vanishes mid-stream
    over, cut = {}, {}
    _http_stream(fd.port, {"prompt": prompts[0].tolist(),
                           "max_new": 10_000}, over)
    _http_stream(fd.port, {"prompt": prompts[1].tolist(), "max_new": gen},
                 cut, abort_after=3)
    m = engine.metrics
    _wait_for(lambda: m.counter("finish:cancelled").value >= 1, 60,
              "the disconnected request to end cancelled")
    status_m, metricsz = _get(fd.port, "/metricsz")
    report = fd.drain_and_join(timeout=120)
    launches = _counts()
    s = engine.summary()
    by_rid = {r.rid: r for r in engine.finished}
    reqs = [by_rid[rids[i]] for i in range(n_req)]
    cancelled = [r for r in engine.finished
                 if r.finish_reason == "cancelled"]
    n_cut = len([f for f in cut.get("frames", ()) if f[1] == "token"])
    log(f"[frontdoor] over-capacity body: {over.get('status')} "
        f"{over.get('body', {}).get('error')}; client reset after {n_cut} "
        f"tokens: {len(cancelled)} request ended cancelled after "
        f"{[len(r.out_tokens) for r in cancelled]} tokens, "
        f"client_disconnects {s['client_disconnects']}; /metricsz "
        f"{status_m} tick_errors {metricsz.get('tick_errors')}; drain: "
        + " / ".join(report.lines()) + f"; tick_errors {s['tick_errors']}; "
        f"kernel launches {launches}")
    if over.get("status") != 413 or \
            over["body"].get("error") != "over_capacity":
        raise AssertionError("[frontdoor] over-capacity body not refused "
                             "with 413")
    if len(cancelled) != 1 or s["client_disconnects"] < 1:
        raise AssertionError("[frontdoor] the disconnected client's "
                             "request did not end cancelled")
    if s["tick_errors"] or metricsz.get("tick_errors"):
        raise AssertionError(f"[frontdoor] {s['tick_errors']} ticks raised")
    if not report.clean or report.exit_code != 0 \
            or leak_gate(engine.pool) != (0, 0):
        raise AssertionError("[frontdoor] the drain's leak gate failed")
    missing = [k for k in SERVE_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"[frontdoor] kernels never launched behind "
                             f"the front door: {missing}")
    fd_reqs = dict(enumerate(reqs))
    # the logits' drift between two batchings of the same requests (phase
    # 4's tick schedule, this wall-clock one), and between that schedule
    # and each request alone, the pair (b)'s sampled gate compares (a
    # replica's batch against the request run alone; as (c) measures it):
    # the larger bounds (b)'s sampled gate
    drift = _survivor_partings(torch, "frontdoor", {"reqs": fd_reqs},
                               {"reqs": base}, range(n_req), check_max)
    serial = build_engine(CachedDecoder.from_quantized(qm),
                          max_seq_len=max_seq_len, args=args,
                          record_logits=True)
    alone = {}
    for i in range(n_req):
        alone[i] = serial.submit(prompts[i], max_new=gen)
        serial.run()
    drift_alone = _compare_greedy(torch, {"reqs": alone},
                                  {"reqs": base})[0]
    log(f"[frontdoor] logit drift between batchings: the front door's "
        f"against the schedule's {drift:.4f}, each request alone against "
        f"the schedule's {drift_alone:.4f}")
    drift = max(drift, drift_alone)
    del serial, alone
    check_logits(torch, qm, prompts, reqs, atol=LOGIT_ATOL,
                 mean_atol=LOGIT_MEAN_ATOL, tag="frontdoor check")

    # the uninterrupted sampled run (b)'s splice is held to, on the card
    sp = SamplingParams(temperature=SAMPLE_TEMP, top_p=SAMPLE_TOP_P,
                        seed=FLEET_SAMPLE_SEED)
    solo = build_engine(CachedDecoder.from_quantized(qm),
                        max_seq_len=max_seq_len, args=args,
                        record_logits=True)
    sampled_ref = solo.submit(prompts[FLEET_SAMPLED_PROMPT], max_new=gen,
                              sampling=sp)
    solo.run()
    lg = torch.as_tensor(np.stack(sampled_ref.step_logits)).to(DEV)
    cdf_err = _cdf_rounding(torch, lg, SAMPLE_TEMP, SAMPLE_TOP_P)
    art = WORK_DIR / "fleet_artifact"
    shutil.rmtree(art, ignore_errors=True)
    save_quantized(art, qm, QUIP_CONFIG, extra_meta={"seed": seed})
    del qm, engine, fd, solo, lg
    if DEV == "cuda":
        torch.cuda.empty_cache()
        peak = served["peak_bytes"]
        free, total = torch.cuda.mem_get_info()
        log(f"[fleet] two replicas of the engine need about 2 x "
            f"{peak / 2**30:.2f} GiB (the reference run's peak "
            f"torch.cuda.max_memory_allocated) beside their CUDA contexts; "
            f"the card has {free / 2**30:.2f} of {total / 2**30:.2f} GiB "
            f"free")
        if 2 * peak > free:
            raise AssertionError("[fleet] two replicas do not fit the card")
    t_a = time.perf_counter() - t_phase

    # ---- (b) two replica processes behind the router --------------------
    t_b = time.perf_counter()
    affinity = [rendezvous_rank(prefix_key(p), 2)[0] for p in prompts]
    if sorted(set(affinity)) != [0, 1] \
            or affinity[FLEET_SAMPLED_PROMPT] != 1:
        raise AssertionError(f"[fleet] the prompts' affinity {affinity} "
                             f"does not reach both replicas")
    tail = ["--load-quantized", str(art), "--paged", "--paged-prefill",
            "--device", DEV, "--slots", str(args.slots), "--page-size",
            str(args.page_size), "--token-budget", str(args.token_budget),
            "--prefill-chunk", str(args.prefill_chunk), "--prompt-len",
            str(prompt_len), "--gen", str(gen), "--drain-timeout-s", "30",
            "--tick-stall-s", "60", *FLEET_EXTRA_ARGS]
    factory = ProcessReplicaFactory(replica_command(tail))
    sup = Supervisor(factory, 2, probe_interval_s=0.5, start_timeout_s=600,
                     max_restarts=1, backoff_base_s=0.5,
                     replica_drain_timeout_s=90)
    router = FleetRouter(sup, port=0, drain_timeout_s=60,
                         stream_idle_timeout_s=120)
    drained = False
    try:
        router.start_in_thread()
        h0, h1 = sup.handles
        log(f"[fleet] 2 replicas of `python -m repro_torch.launch.serve "
            f"{' '.join(tail)}` ready in {time.perf_counter() - t_b:.1f}s "
            f"(pids {h0.pid}, {h1.pid}); router on 127.0.0.1:{router.port};"
            f" prompts' affinity {affinity}")
        bodies = [{"prompt": p.tolist(), "max_new": gen} for p in prompts]
        bodies.append({"prompt": prompts[FLEET_SAMPLED_PROMPT].tolist(),
                       "max_new": gen, "temperature": SAMPLE_TEMP,
                       "top_p": SAMPLE_TOP_P, "seed": FLEET_SAMPLE_SEED})
        fouts = [{} for _ in bodies]
        threads = []
        for i, body in enumerate(bodies):
            th = threading.Thread(target=_http_stream,
                                  args=(router.port, body, fouts[i]))
            th.start()
            threads.append(th)
            if i >= 3:
                time.sleep(FD_GAP_S)
        # every stream on replica 1 mid-way: read its /metricsz, kill -9
        n_on1 = sum(1 for a in affinity + [1] if a == 1)

        def midway():
            entries = [e for e in router.journal.live() if e.replica == 1]
            return h1.routed >= n_on1 and entries and all(
                len(e.tokens) >= FLEET_KILL_AFTER for e in entries)

        _wait_for(midway, 300, "every stream on replica 1 to be mid-way")
        _, m1 = _get(h1.port, "/metricsz")
        held = sorted(len(e.tokens) for e in router.journal.live()
                      if e.replica == 1)
        t_kill = time.perf_counter()
        os.kill(h1.pid, signal.SIGKILL)
        log(f"[fleet] SIGKILL to replica 1 (pid {h1.pid}) holding "
            f"{len(held)} streams at {held} tokens; its tick_errors "
            f"{m1['tick_errors']}, steps {m1['steps']}")
        for th in threads:
            th.join(2 * CLIENT_TIMEOUT_S)
        fstreams = {i: _stream_tokens("fleet", o)[0]
                    for i, o in enumerate(fouts)}
        _, fz = _get(router.port, "/fleetz")
        routed = [r["routed"] for r in fz["replicas"]]
        log(f"[fleet] {len(bodies)} requests ({n_req} greedy, 1 sampled) "
            f"through the router: failovers {fz['router']['failovers']}, "
            f"routed per replica {routed}, served "
            f"{[r['served'] for r in fz['replicas']]}; "
            f"{_client_latency(fouts)}")
        if min(routed) == 0 or fz["router"]["failovers"] < 1:
            raise AssertionError("[fleet] no failover, or a replica got no "
                                 "request")
        _splice_partings(torch, "fleet greedy",
                         {i: fstreams[i] for i in range(n_req)}, fd_reqs,
                         bound)
        _sampled_splice(torch, "fleet sampled", fstreams[n_req],
                        sampled_ref, delta=2 * drift, floor=4 * cdf_err)
        # the restarted replica serves a later request
        _wait_for(lambda: h1.state == "healthy" and h1.generation == 2, 600,
                  "replica 1 to restart")
        t_restart = time.perf_counter() - t_kill
        later_i = next(i for i in range(n_req) if affinity[i] == 1
                       and i != FLEET_SAMPLED_PROMPT)
        served_before = h1.served
        later = {}
        _http_stream(router.port, bodies[later_i], later)
        later_toks = _stream_tokens("fleet later", later)[0]
        # the router counts a stream served after relaying its done frame
        _wait_for(lambda: h1.served == served_before + 1, 30,
                  "the restarted replica to serve the later request")
        _splice_partings(torch, "fleet restarted", {later_i: later_toks},
                         fd_reqs, bound)
        errs = {h.index: _get(h.port, "/metricsz")[1]["tick_errors"]
                for h in sup.handles}
        log(f"[fleet] replica 1 back as generation {h1.generation} (pid "
            f"{h1.pid}) {t_restart:.1f}s after the kill, served request "
            f"{later_i}; tick_errors by replica {errs} (killed incarnation "
            f"{m1['tick_errors']})")
        if any(errs.values()) or m1["tick_errors"]:
            raise AssertionError("[fleet] a replica's ticks raised")
        frep = router.drain_and_join(timeout=300)
        drained = True
    finally:
        if not drained:  # no more restarts; stop every replica started
            sup._draining = True
            for h in sup.handles:
                factory.kill(h)
    if not frep.clean or frep.exit_code != 0 or frep.failed \
            or frep.replicas[1]["restarts"] != 1 \
            or any(r["exit_code"] != 0 for r in frep.replicas):
        raise AssertionError("[fleet] the fleet drain was not clean")
    shutil.rmtree(art, ignore_errors=True)
    t_b = time.perf_counter() - t_b

    # ---- (c) two mesh replicas behind the router ---------------------------
    t_c = time.perf_counter()
    _fleet_tp(torch, cfg=cfg, seed=seed, prompts=prompts, args=args,
              check_max=check_max, prompt_len=prompt_len, gen=gen)
    log(f"[frontdoor] phase 12 passed in "
        f"{time.perf_counter() - t_phase:.1f}s ((a) {t_a:.1f}s, (b) "
        f"{t_b:.1f}s, (c) {time.perf_counter() - t_c:.1f}s)")
    return {"frontdoor": launches}


# ---------------------------------------------------------------------------
# phase 13: the moe, rwkv and hybrid families through the Model facade
# ---------------------------------------------------------------------------

# (tag, arch, layers or None for the whole model, weight_bits): the runs of
# phase 13 at full width, one after another; depth is cut only where the
# model does not fit the card (llama4-scout 48 x 0.4 GB of bf16 experts,
# arctic 35 x 26.8 GB, llama-3.2-vision-90b 100 x 1.71 GB in bf16: whole
# only at 2 bits, 0.21 GB a layer)
FAMILY_RUNS = (
    ("llama4", "llama4-scout-17b-a16e", 4, 0),
    ("llama4 packed", "llama4-scout-17b-a16e", 4, 2),
    ("arctic", "arctic-480b", 1, 0),
    ("rwkv6", "rwkv6-1.6b", None, 0),
    ("zamba2 packed", "zamba2-7b", None, 2),
    ("whisper", "whisper-small", None, 0),
    ("whisper packed", "whisper-small", None, 2),
    ("vlm packed", "llama-3.2-vision-90b", None, 2),
    ("vlm", "llama-3.2-vision-90b", 10, 0),
)
FAMILY_PROMPTS, FAMILY_PROMPT_LEN, FAMILY_GEN = 8, 128, 32
# the stub frontends' embeddings beside the prompts, by family: whisper's
# 1,500 encoder positions of a 30-s window; the vlm's n_patches
FAMILY_EMBEDDED = {"encdec": "frames", "vlm": "patches"}
FAMILY_FRAMES = 1500
# the chunked scans against their per-step oracles: one full-width layer,
# T tokens
SCAN_T = 64
# the run whose layer-0 routed activations feed expert_hessians
EXPERT_H_RUN = "llama4"
# decode steps of the wrong runs that show each decode gate can fail
WRONG_STEPS = 4
# stated tolerances of phase 13's equivalence gates, by run, all in fp32
# at full width: about twice what correct runs read (one H100, every
# other check passing; PERF.md §6).  In bf16 the same runs read up to
# 250x more (zamba2's 81 layers) and MoE routing flips on near ties, so
# bf16 runs only the timed main path, held to its own teacher-forced
# argmax.  Each prefill (encdec, vlm), decode, packed and scan gate must
# also fail a wrong run (``_family_gates``); the wrong runs read 6.3-7.1
# max |diff| against logits of rms 1.0 (the encdec and vlm runs'
# 0.22-8.1), and 0.87-0.95 of a scan oracle's largest value
FAMILY_GATES = {
    # prefill logits vs forward logits at S - 1, max |diff| (the same
    # tokens and capacity; the forward's lm head is a larger GEMM); read
    # 5.2e-6, 5.5e-6, 5.8e-6, 6.0e-6 and 3.8e-6; whisper 3.1e-6 and
    # 3.6e-6, the vlm 6.4e-6 (packed) and 8.2e-6
    "prefill": {"llama4": 1.1e-5, "llama4 packed": 1.1e-5, "arctic": 1.2e-5,
                "rwkv6": 1.2e-5, "zamba2 packed": 8e-6, "whisper": 6.2e-6,
                "whisper packed": 7.2e-6, "vlm packed": 1.3e-5,
                "vlm": 1.6e-5},
    # teacher-forced decode logits vs forward logits, max and mean |diff|;
    # read 3.1e-5 / 4.4e-6, 1.17e-3 / 9.5e-5, 2.7e-5 / 3.0e-6, 1.3e-5 /
    # 9.7e-7 and 3.08e-3 / 2.8e-4; whisper 8.3e-6 / 9.0e-7 and 4.5e-5 /
    # 6.5e-6, the vlm 2.28e-2 / 2.0e-3 (100 packed layers: quant_matmul's
    # fp32-in-bf16-terms error, as in "packed") and 4.2e-5 / 4.6e-6
    "decode": {"llama4": (6.3e-5, 8.8e-6), "llama4 packed": (2.4e-3, 1.9e-4),
               "arctic": (5.4e-5, 6e-6), "rwkv6": (2.6e-5, 2e-6),
               "zamba2 packed": (6.2e-3, 5.6e-4), "whisper": (1.7e-5, 1.8e-6),
               "whisper packed": (9e-5, 1.3e-5),
               "vlm packed": (4.6e-2, 4.1e-3), "vlm": (8.5e-5, 9.2e-6)},
    # packed projections: quant_matmul's kernel vs its plain version,
    # forward logits max and mean |diff|; read 1.35e-3 / 1.19e-4 and
    # 1.05e-3 / 1.09e-4; whisper 9.8e-5 / 1.27e-5, the vlm over 100
    # layers 3.68e-2 / 3.8e-3
    "packed": {"llama4 packed": (2.7e-3, 2.4e-4),
               "zamba2 packed": (2.1e-3, 2.2e-4),
               "whisper packed": (2e-4, 2.5e-5),
               "vlm packed": (7.4e-2, 7.6e-3)},
    # chunked scan vs per-step oracle, max |diff| relative to the oracle's
    # largest |value|; read 2.26e-6 and 1.38e-6
    "scan": {"rwkv6": 4.5e-6, "zamba2 packed": 2.8e-6},
}
# expert_hessians vs a plain per-expert XᵀX: fp32, relative to max |H|;
# an expert routed fewer tokens than EXPERT_H_MIN_TOKENS takes the shared H
EXPERT_H_RTOL, EXPERT_H_MIN_TOKENS = 1e-5, 64


def _tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(_tree_bytes(v) for v in tree)
    return tree.numel() * tree.element_size()


def _family_projections(cfg, call: str = "prefill") -> int:
    """quant_matmul launches of one call (``"prefill"``, or ``"decode"``:
    one step) of a packed model: every attention and dense-MLP projection
    of every layer (or every shared-block invocation).  A cross attention
    projects its K/V once a prefill, from the encoder states or the
    patches, and only q and the output at decode; a forward call counts
    as a prefill."""
    attn = 4
    mlp = 3 if cfg.mlp == "swiglu" else 2
    cross = attn if call == "prefill" else 2
    if cfg.family == "hybrid":
        return (attn + mlp) * (cfg.n_layers // cfg.shared_attn_period)
    if cfg.family == "moe":
        return (attn + (mlp if cfg.dense_residual else 0)) * cfg.n_layers
    if cfg.family == "encdec":
        enc = (attn + mlp) * (cfg.n_enc_layers or cfg.n_layers)
        dec = (attn + cross + mlp) * (cfg.n_dec_layers or cfg.n_layers)
        return (enc if call == "prefill" else 0) + dec
    if cfg.family == "vlm":
        n_cross = cfg.n_layers // cfg.cross_every
        return ((attn + mlp) * (cfg.n_layers - n_cross)
                + (cross + mlp) * n_cross)
    return (attn + mlp) * cfg.n_layers


def _family_batch(torch, cfg, prompts, seed: int) -> dict:
    """The main path's batch: the prompts and, for the encdec and vlm
    families, their stub embeddings (B, FAMILY_FRAMES or n_patches,
    d_model) drawn from the seed on the card in fp32 and cast to the
    model's dtype (the bf16 and fp32 runs see the same draw)."""
    key = FAMILY_EMBEDDED.get(cfg.family)
    if key is None:
        return {"tokens": prompts}
    n = FAMILY_FRAMES if cfg.family == "encdec" else cfg.n_patches
    g = torch.Generator(device=DEV)
    g.manual_seed(seed + 7)
    x = torch.randn(prompts.shape[0], n, cfg.d_model, generator=g,
                    device=DEV)
    return {"tokens": prompts, key: x.to(getattr(torch, cfg.dtype))}


def _greedy_batch(torch, model, params, batch: dict, gen: int):
    """``greedy_generate``'s loop (``Model.prefill``, then ``decode_step``
    on each argmax) over a batch dict: ``greedy_generate`` takes the
    prompt tokens only, and the encdec and vlm families need their stub
    embeddings beside them."""
    S = batch["tokens"].shape[1]
    logits, cache = model.prefill(params, batch, max_len=S + gen)
    toks = [torch.argmax(logits, -1)[:, None]]
    for i in range(gen - 1):
        logits, cache = model.decode_step(params, toks[-1], cache, S + i)
        toks.append(torch.argmax(logits, -1)[:, None])
    return torch.cat(toks, dim=1)


def _generate(torch, model, params, batch: dict, gen: int):
    """The greedy main path: ``greedy_generate`` for the token-only
    families, :func:`_greedy_batch` for encdec and vlm."""
    from repro_torch.launch.serve import greedy_generate

    if model.cfg.family in FAMILY_EMBEDDED:
        return _greedy_batch(torch, model, params, batch, gen)
    return greedy_generate(model, params, batch["tokens"], gen)


def _with_tokens(batch: dict, tokens) -> dict:
    return {**batch, "tokens": tokens}


def _rolled(torch, batch: dict) -> dict:
    """``batch`` with its stub embeddings rolled by one row: each prompt
    beside another row's frames or patches."""
    return {k: v if k == "tokens" else torch.roll(v, 1, dims=0)
            for k, v in batch.items()}


def _set_vlm_gates(torch, params, seed: int) -> list:
    """Every vlm cross layer's ``xattn.gate`` and ``mlp_gate`` set to a
    seeded value of magnitude 0.3-0.9 and random sign (a fresh init's 0
    leaves the cross path inert).  Returns the values set."""
    g = torch.Generator(device="cpu")
    g.manual_seed(seed + 9)
    vals = []
    for lp in params["cross_layers"]:
        for leaf, name in ((lp["xattn"], "gate"), (lp, "mlp_gate")):
            v = (0.3 + 0.6 * torch.rand((), generator=g)) * (
                1.0 if torch.rand((), generator=g) < 0.5 else -1.0)
            leaf[name].fill_(float(v))
            vals.append(round(float(v), 3))
    return vals


class _RouteRecorder:
    """Records every ``moe_route`` call of the MoE layers (routed
    activations, choices, keep masks and capacity) while installed."""

    def __init__(self, L):
        self.L, self.calls, self._orig = L, [], None

    def __enter__(self):
        self._orig = self.L.moe_route

        def rec(p, xt, cfg):
            r = self._orig(p, xt, cfg)
            self.calls.append({"x": xt, **r})
            return r

        self.L.moe_route = rec
        return self

    def __exit__(self, *exc):
        self.L.moe_route = self._orig


def _must_fail(tag: str, what: str, reading: str, passes: bool) -> None:
    """A gate's wrong run: it must fail the gate, or the gate sees
    nothing."""
    log(f"[{tag}] wrong run ({what}): {reading}; fails the gate: "
        f"{'no' if passes else 'yes'} {'FAIL' if passes else 'OK'}")
    if passes:
        raise AssertionError(f"[{tag}] the gate passes a wrong run "
                             f"({what})")


def _wrong_decodes(torch, cfg, cache) -> list:
    """The decode gate's wrong runs, by family: cache faults the gate must
    see, as (what, cache, position shift)."""
    if cfg.family in FAMILY_EMBEDDED:
        rolled = [{k: torch.roll(v, 1, dims=0) for k, v in c.items()}
                  for c in cache["cross"]]
        return [("cross caches rolled by one row of the batch",
                 {"self": cache["self"], "cross": rolled}, 0),
                ("each step stored and read one position late", cache, 1)]
    if cfg.family == "rwkv":
        return [("layer states rotated by one layer",
                 cache[1:] + cache[:1], 0)]
    if cfg.family == "hybrid":
        kv, mamba = cache["kv"], cache["mamba"]
        return [("shared-block KV caches rotated by one invocation",
                 {"mamba": mamba, "kv": kv[1:] + kv[:1]}, 0),
                ("Mamba2 conv states zeroed after the prefill",
                 {"mamba": [{**m, "conv": torch.zeros_like(m["conv"])}
                            for m in mamba], "kv": kv}, 0)]
    return [("each step stored and read one position late", cache, 1)]


def _tail_dropped(tree):
    """``tree`` with every packed leaf's last row of words (the last 32 /
    bits inputs) read as codes 0: the packed gate's wrong run."""
    if isinstance(tree, dict):
        if "packed" in tree:
            w = tree["packed"].clone()
            w[-1] = 0
            return {**tree, "packed": w}
        return {k: _tail_dropped(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tail_dropped(v) for v in tree]
    return tree


def _scan_gate(torch, tag: str, scan, oracle, x, tol: float) -> float:
    """A chunked scan against its per-step oracle on x (B, SCAN_T, D); the
    wrong run restarts the scan every 16 tokens (no state carried)."""
    want = oracle(x).float()
    top = max(float(want.abs().max()), 1e-30)
    rel = float((scan(x).float() - want).abs().max()) / top
    bad = torch.cat([scan(x[:, i:i + 16]) for i in range(0, x.shape[1], 16)],
                    dim=1)
    rel_bad = float((bad.float() - want).abs().max()) / top
    ok = rel <= tol
    log(f"[{tag}] chunked vs per-step oracle, one full-width layer at T = "
        f"{SCAN_T} (fp32): max |diff| {rel:.4e} of the oracle's max |value| "
        f"(tol {tol}) {'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"[{tag}] chunked scan disagrees with its "
                             f"oracle")
    _must_fail(tag, "the scan restarted every 16 tokens", f"{rel_bad:.4e}",
               rel_bad <= tol)
    return rel


def _expert_hessian_gate(torch, tag: str, call: dict, n_experts: int):
    """expert_hessians on layer 0's routed activations: the counts are the
    routing's integer counts, each H a plain per-expert XᵀX, the starved
    experts the shared H."""
    from repro_torch.core.hessian import expert_hessians

    X, top_e = call["x"].float(), call["top_e"]
    t0 = time.perf_counter()
    Hs, counts = expert_hessians(X, top_e, n_experts,
                                 min_tokens=EXPERT_H_MIN_TOKENS)
    _sync(torch)
    t_h = time.perf_counter() - t0
    want_counts = torch.bincount(top_e.reshape(-1), minlength=n_experts)
    shared = torch.einsum("ti,tj->ij", X, X) / X.shape[0]
    worst, starved = 0.0, []
    for e in range(n_experts):
        if int(want_counts[e]) < EXPERT_H_MIN_TOKENS:
            starved.append(e)
            want = shared
        else:
            Xe = X[(top_e == e).any(-1)]
            want = torch.einsum("ti,tj->ij", Xe, Xe) / Xe.shape[0]
        worst = max(worst, float((Hs[e] - want).abs().max())
                    / float(want.abs().max()))
    ok = (torch.equal(counts.long(), want_counts) and bool(starved)
          and worst <= EXPERT_H_RTOL)
    log(f"[{tag}] expert_hessians on layer 0's routed activations "
        f"({X.shape[0]} tokens x {X.shape[1]}) in {t_h:.2f}s: counts "
        f"{want_counts.tolist()} equal the routing's; starved (< "
        f"{EXPERT_H_MIN_TOKENS} tokens) "
        f"{starved} carry the shared H; max |H - plain XᵀX| / max |H| "
        f"{worst:.3e} (tol {EXPERT_H_RTOL}) {'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"[{tag}] expert_hessians disagree")


def _init_family(torch, tag: str, cfg, seed: int):
    from repro_torch.models.lm import build_model

    model = build_model(cfg)
    g = torch.Generator(device=DEV)
    g.manual_seed(seed)
    t0 = time.perf_counter()
    params = model.init(g, device=DEV)
    gates = (f"; xattn.gate and mlp_gate by cross layer "
             f"{_set_vlm_gates(torch, params, seed)}"
             if cfg.family == "vlm" else "")
    _sync(torch)
    log(f"[{tag}] {cfg.name} ({cfg.family}): {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, vocab {cfg.vocab}, {cfg.dtype}"
        f"{f', {cfg.n_experts} experts top-{cfg.top_k}' if cfg.n_experts else ''}"
        f"{', dense residual' if cfg.dense_residual else ''}"
        f"{f', weight_bits {cfg.weight_bits}' if cfg.weight_bits else ''}; "
        f"params {_tree_bytes(params) / 1e9:.2f} GB on the card, drawn from "
        f"seed {seed} in {time.perf_counter() - t0:.1f}s{gates}")
    return model, params


def _family_main(torch, tag: str, cfg, prompts, *, seed: int) -> dict:
    """The main path in the model's own dtype: ``greedy_generate`` (or
    ``_greedy_batch`` beside stub embeddings; launches counted from 0
    around it), then the same prefill and decode steps teacher-forced on
    its stream, timed, whose argmax must be the stream.  Returns the
    launches."""
    from repro_torch.kernels import reset_counts
    from repro_torch.models import layers as L

    model, params = _init_family(torch, tag, cfg, seed)
    batch = _family_batch(torch, cfg, prompts, seed)
    B, S = prompts.shape
    gen = FAMILY_GEN
    _generate(torch, model, params, _with_tokens(batch, prompts[:, :8]),
              2)  # warm-up
    _sync(torch)
    reset_counts()
    t0 = time.perf_counter()
    with _RouteRecorder(L) as routes:
        stream = _generate(torch, model, params, batch, gen)
        _sync(torch)
    wall = time.perf_counter() - t0
    launches = _counts()
    loop = ("_greedy_batch" if cfg.family in FAMILY_EMBEDDED
            else "greedy_generate")
    log(f"[{tag}] {loop}: {B} x ({S} + {gen}) in {wall:.2f}s "
        f"({B * gen / wall:.1f} tok/s, no claim); kernel launches "
        f"{launches}")
    if cfg.n_experts:
        drops = [(i, int((~c["keep"]).sum()), c["keep"].numel())
                 for i, c in enumerate(routes.calls[:cfg.n_layers])]
        log(f"[{tag}] the real-capacity prefill (capacity_factor "
            f"{cfg.capacity_factor}, C = {routes.calls[0]['C']} of "
            f"{B * S} tokens) dropped (layer, pairs, of): {drops}")
    t0 = time.perf_counter()
    lg, cache = model.prefill(params, batch, max_len=S + gen)
    _sync(torch)
    t_pre = time.perf_counter() - t0
    dec = [lg]
    t0 = time.perf_counter()
    for j in range(gen - 1):
        lg, cache = model.decode_step(params, stream[:, j:j + 1], cache,
                                      S + j)
        dec.append(lg)
    _sync(torch)
    t_dec = (time.perf_counter() - t0) / (gen - 1)
    dec = torch.stack(dec, dim=1)
    ok = (tuple(stream.shape) == (B, gen)
          and bool(((stream >= 0) & (stream < cfg.vocab)).all())
          and bool(torch.isfinite(dec).all())
          and torch.equal(torch.argmax(dec, -1), stream))
    log(f"[{tag}] prefill {t_pre * 1e3:.1f} ms, decode {t_dec * 1e3:.1f} ms "
        f"a step; the stream ({B} x {gen} tokens in [0, {cfg.vocab})) is "
        f"the argmax of the same prefill and decode steps teacher-forced, "
        f"finite logits: {'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"[{tag}] the stream is not its own argmax")
    want = (_family_projections(cfg, "prefill")
            + (gen - 1) * _family_projections(cfg, "decode"))
    if cfg.weight_bits:
        log(f"[{tag}] quant_matmul launches {launches['quant_matmul']} = "
            f"{_family_projections(cfg, 'prefill')} a prefill + {gen - 1} x "
            f"{_family_projections(cfg, 'decode')} a decode step: "
            f"{'yes' if launches['quant_matmul'] == want else 'NO'}")
    if cfg.weight_bits and DEV == "cuda" and launches["quant_matmul"] != want:
        raise AssertionError(f"[{tag}] {launches['quant_matmul']} "
                             f"quant_matmul launches, not {want}")
    if tag == EXPERT_H_RUN:
        _expert_hessian_gate(torch, tag, routes.calls[0], cfg.n_experts)
    return launches


def _family_gates(torch, tag: str, cfg, prompts, *, seed: int) -> None:
    """The equivalence gates in fp32 at full width (``FAMILY_GATES``,
    by run): prefill against forward, teacher-forced decode against
    forward (MoE at ``capacity_factor`` = experts / top-k, where nothing
    drops) with the greedy stream equal to the forward argmax at every
    position but near ties, packed projections against their
    ``plain=True`` version, the chunked scans against their per-step
    oracles; each decode, packed and scan gate also against a wrong
    run."""
    import dataclasses

    from repro_torch.kernels import reset_counts
    from repro_torch.models import ssm
    from repro_torch.models.lm import build_model

    gates = {k: v[tag] for k, v in FAMILY_GATES.items() if tag in v}
    tag = f"{tag} fp32"
    cfg = dataclasses.replace(cfg, dtype="float32")
    model, params = _init_family(torch, tag, cfg, seed)
    batch = _family_batch(torch, cfg, prompts, seed)
    B, S = prompts.shape
    gen = FAMILY_GEN
    # ---- prefill vs forward at S - 1, same tokens and capacity ----
    pl, _ = model.prefill(params, batch, max_len=S + gen)
    h, _ = model.forward(params, batch)
    fl = model.logits(params, h[:, -1])
    d_pre = float((pl - fl).abs().max())
    ok = d_pre <= gates["prefill"]
    log(f"[{tag}] prefill vs forward logits at position {S - 1}: max |diff| "
        f"{d_pre:.4e} (tol {gates['prefill']}) {'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"[{tag}] prefill disagrees with forward")
    if cfg.family in FAMILY_EMBEDDED:
        bad, _ = model.prefill(params, _rolled(torch, batch), max_len=S + gen)
        d_bad = float((bad - fl).abs().max())
        _must_fail(tag, f"a prefill fed another row's "
                        f"{FAMILY_EMBEDDED[cfg.family]}",
                   f"max |diff| {d_bad:.4e}", d_bad <= gates["prefill"])
        del bad
    del pl, h, fl
    # ---- decode vs forward, teacher-forced, nothing dropped ----
    m_nd = model
    if cfg.n_experts:
        m_nd = build_model(dataclasses.replace(
            cfg, capacity_factor=cfg.n_experts / cfg.top_k))
    stream = _generate(torch, m_nd, params, batch, gen)
    h, _ = m_nd.forward(params, _with_tokens(
        batch, torch.cat([prompts, stream], 1)))
    full = m_nd.logits(params, h[:, S - 1:S - 1 + gen])
    del h
    lg, cache = m_nd.prefill(params, batch, max_len=S + gen)
    wrong = []
    for what, bad_cache, shift in _wrong_decodes(torch, cfg, cache):
        bad = []
        for j in range(WRONG_STEPS):
            lg_bad, bad_cache = m_nd.decode_step(
                params, stream[:, j:j + 1], bad_cache, S + j + shift)
            bad.append(lg_bad)
        wrong.append((what, torch.stack(bad, dim=1)))
        del bad_cache, bad
    dec = [lg]
    for j in range(gen - 1):
        lg, cache = m_nd.decode_step(params, stream[:, j:j + 1], cache, S + j)
        dec.append(lg)
    dec = torch.stack(dec, dim=1)
    diff = (dec - full).abs()
    d_max, d_mean = float(diff.max()), float(diff.mean())
    top2 = torch.topk(full, 2, dim=-1).values
    margin = top2[..., 0] - top2[..., 1]
    flips = stream != torch.argmax(full, -1)
    unexplained = int((flips & (margin >= 2 * d_max)).sum())
    tol, mtol = gates["decode"]
    ok = d_max <= tol and d_mean <= mtol and unexplained == 0 and bool(
        torch.isfinite(dec).all())
    log(f"[{tag}] decode vs teacher-forced forward"
        f"{f' at capacity_factor {m_nd.cfg.capacity_factor}' if cfg.n_experts else ''}"
        f", {B} x {gen} positions (forward logit rms "
        f"{float(full.pow(2).mean().sqrt()):.3f}): logit max |diff| "
        f"{d_max:.4e} (tol {tol}), mean {d_mean:.4e} (tol {mtol}); stream "
        f"tokens that differ from the forward argmax: {int(flips.sum())} of "
        f"{flips.numel()} (all at a top-2 margin < 2 x max |diff|: "
        f"{'yes' if unexplained == 0 else 'NO'}) {'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"[{tag}] decode disagrees with forward")
    for what, bad in wrong:
        bd = (bad - full[:, :WRONG_STEPS]).abs()
        _must_fail(tag, f"{what}, {WRONG_STEPS} steps",
                   f"max |diff| {float(bd.max()):.4e}, mean "
                   f"{float(bd.mean()):.4e}",
                   float(bd.max()) <= tol and float(bd.mean()) <= mtol)
    del full, dec, diff, cache, wrong, bd
    # ---- packed projections: the kernel against its plain version ----
    if cfg.weight_bits:
        per_call = _family_projections(cfg)
        reset_counts()
        got = model.logits(params, model.forward(params, batch)[0])
        n_fwd = _counts()["quant_matmul"]
        want = model.logits(params, model.forward(params, batch,
                                                  plain=True)[0])
        d = (got - want).abs()
        tol, mtol = gates["packed"]
        ok = (float(d.max()) <= tol and float(d.mean()) <= mtol
              and (DEV != "cuda" or n_fwd == per_call))
        log(f"[{tag}] packed projections through quant_matmul: forward "
            f"logits vs plain=True, {B} x {S} positions: max |diff| "
            f"{float(d.max()):.4e} (tol {tol}), mean {float(d.mean()):.4e} "
            f"(tol {mtol}); {n_fwd} launches a forward call = {per_call} "
            f"projections {'OK' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"[{tag}] packed projections disagree")
        del d, want
        bad_params = _tail_dropped(params)
        wrong = model.logits(bad_params, model.forward(
            bad_params, batch, plain=True)[0])
        d = (got - wrong).abs()
        _must_fail(tag, "the last packed word of K read as codes 0",
                   f"max |diff| {float(d.max()):.4e}, mean "
                   f"{float(d.mean()):.4e}",
                   float(d.max()) <= tol and float(d.mean()) <= mtol)
        del got, wrong, d, bad_params
    # ---- chunked scans against their per-step oracles ----
    if cfg.family in ("rwkv", "hybrid"):
        gx = torch.Generator(device=DEV)
        gx.manual_seed(seed + 5)
        x = 0.5 * torch.randn(2, SCAN_T, cfg.d_model, generator=gx,
                              device=DEV)
        if cfg.family == "rwkv":
            p0 = params["layers"][0]["time_mix"]
            _scan_gate(torch, f"{tag} rwkv6_time_mix",
                       lambda u: ssm.rwkv6_time_mix(p0, u, cfg),
                       lambda u: ssm.rwkv6_scan_ref(p0, u, cfg), x,
                       gates["scan"])
        else:
            p0 = params["mamba_layers"][0]["mamba"]
            _scan_gate(torch, f"{tag} mamba2_forward",
                       lambda u: ssm.mamba2_forward(p0, u, cfg),
                       lambda u: ssm.mamba2_scan_ref(p0, u, cfg), x,
                       gates["scan"])


def _family_run(torch, tag: str, cfg, *, seed: int) -> dict:
    """One family at full width: the main path in its own dtype
    (``_family_main``), then the equivalence gates in fp32
    (``_family_gates``), the card freed after each.  Returns the main
    path's launches."""
    from repro_torch.data.synthetic import make_calibration

    t_run = time.perf_counter()
    prompts = torch.as_tensor(make_calibration(
        cfg.vocab, n_segments=FAMILY_PROMPTS, seg_len=FAMILY_PROMPT_LEN,
        seed=seed + 3), device=DEV).long()
    peaks = []

    def peak():  # GB allocated at most since the last call; frees the card
        if DEV == "cuda":
            peaks.append(f"{torch.cuda.max_memory_allocated() / 1e9:.2f}")
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()

    peak()
    with torch.no_grad():
        launches = _family_main(torch, tag, cfg, prompts, seed=seed)
        peak()
        _family_gates(torch, tag, cfg, prompts, seed=seed)
        peak()
    log(f"[{tag}] run passed in {time.perf_counter() - t_run:.1f}s (peak "
        f"{' and '.join(peaks[1:]) or 'not measured'} GB allocated on the "
        f"card, {cfg.dtype} and fp32)")
    return launches


def phase_families(torch, *, seed: int, cfgs=None) -> dict:
    """Phase 13: the moe, rwkv, hybrid, encdec and vlm families at full
    width through ``build_model`` and ``greedy_generate`` (``_greedy_batch``
    beside stub embeddings; ``FAMILY_RUNS``), each with its gates.
    ``cfgs`` ({tag: cfg}) replaces the models (a rehearsal on the
    CPU at the smoke configs).  Returns each run's launches."""
    import dataclasses

    from repro_torch.configs import get_config

    t_phase = time.perf_counter()
    paths = {}
    for tag, arch, layers, bits in FAMILY_RUNS:
        if cfgs is not None:
            cfg = cfgs[tag]
        else:
            cfg = dataclasses.replace(get_config(arch), weight_bits=bits)
            if layers is not None and layers != cfg.n_layers:
                log(f"[{tag}] DEPTH CUT: {layers} of {cfg.n_layers} layers "
                    f"(full width kept)")
                cfg = dataclasses.replace(cfg, n_layers=layers)
        paths[f"families {tag}"] = _family_run(torch, tag, cfg, seed=seed)
    log(f"[families] phase 13 passed in "
        f"{time.perf_counter() - t_phase:.1f}s")
    return paths


# ---------------------------------------------------------------------------
# phase 14: training
# ---------------------------------------------------------------------------

# qwen3-14b at full width, depth cut to 2 of 40 layers for memory: 2.22 B
# parameters, 1.56 B of them in the embedding and the head (adamw's state
# of the whole model is about 300 GB)
TRAIN_ARCH, TRAIN_LAYERS = "qwen3-14b", 2
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 32, 64, 6
# (a): the step with remat "full" over two microbatches against remat
# "none" over one, fp32 (sgd at lr 1, so each leaf's update is its
# gradient): loss and grad_norm relative, and every leaf's update max
# |diff| beyond one ulp of its largest |param| (the rounding of storing
# p - g), relative to its largest |update|: about twice the worst reading
# on the H100 (7.8e-6, layers/attn/wo; grad_norm 9.1e-8, loss 0); the
# undivided wrong run reads 1.0
TRAIN_ACCUM_RTOL = 2e-5
# (c): the CLI's fault drill at the smoke config, in one fresh process
TRAIN_DRILL = ["--arch", "qwen3-14b", "--smoke", "--steps", "8",
               "--global-batch", "4", "--seq-len", "16", "--save-every", "3",
               "--log-every", "1"]
TRAIN_DRILL_CHILD = r"""
import contextlib, io, json, sys
from repro_torch.launch import train
runs = []
for argv in json.loads(sys.argv[1]):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = train.main(argv)
    runs.append({"rc": rc, "out": out.getvalue()})
print(json.dumps(runs))
"""


def _train_cfg(cfg=None):
    import dataclasses

    from repro_torch.configs import get_config

    if cfg is not None:
        return cfg
    cfg = get_config(TRAIN_ARCH)
    log(f"[train] DEPTH CUT: {TRAIN_LAYERS} of {cfg.n_layers} layers (full "
        f"width kept; memory)")
    return dataclasses.replace(cfg, n_layers=TRAIN_LAYERS)


def _train_init(torch, cfg, seed: int):
    from repro_torch.convert import stack_layers
    from repro_torch.models.lm import build_model

    model = build_model(cfg)
    g = torch.Generator(device=DEV)
    g.manual_seed(seed)
    return model, stack_layers(model.init(g, device=DEV))


def _rel(torch, a, b) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _train_accum(torch, cfg, seed: int) -> None:
    """(a): one fp32 sgd(1.0) step of remat "full" over two microbatches
    against remat "none" over one on the same batch, and the same step
    with the microbatch sum left undivided, which must fail the gate."""
    import dataclasses

    from repro_torch.data.synthetic import token_batches
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.lm import build_model
    from repro_torch.optim import Optimizer, sgd
    from repro_torch.tree import flatten_with_paths, tree_map

    tag = "train (a)"
    cfg = dataclasses.replace(cfg, dtype="float32")
    model0, p0 = _train_init(torch, dataclasses.replace(cfg, remat="none"),
                             seed)
    n_micro = max(1, TRAIN_BATCH // cfg.microbatch)
    batch = next(token_batches(cfg.vocab, TRAIN_BATCH, TRAIN_SEQ, seed=seed,
                               device=DEV))
    opt = sgd(1.0)

    def run(remat: str, nm: int, optimizer=opt):
        """-> (each leaf's update, metrics); p0 is kept."""
        model = build_model(dataclasses.replace(cfg, remat=remat))
        p = tree_map(lambda t: t.clone(), p0)
        t0 = time.perf_counter()
        p, _, m = make_train_step(model, optimizer, n_micro=nm)(p, {}, batch,
                                                                0)
        _sync(torch)
        wall = time.perf_counter() - t0
        tree_map(lambda a, b: a.sub_(b), p, p0)
        return p, {k: float(v) for k, v in m.items()}, wall

    ref, m_ref, w_ref = run("none", 1)
    ref_leaves = dict(flatten_with_paths(ref))
    # storing p - g rounds to the param's ulp: the two runs' updates may
    # differ by one ulp of the largest |param| whatever their gradients
    floor = {k: 2.0**-23 * float(p.abs().max())
             for k, p in flatten_with_paths(p0)}

    def gate(upd, m):
        errs = {}
        for k, u in flatten_with_paths(upd):
            r = ref_leaves[k]
            err = float((u - r).abs().max())
            errs[k] = max(0.0, err - floor[k]) / float(r.abs().max())
        worst = max(errs, key=errs.get)
        d = {k: abs(m[k] - m_ref[k]) / abs(m_ref[k])
             for k in ("loss", "grad_norm")}
        ok = max(errs[worst], *d.values()) <= TRAIN_ACCUM_RTOL
        return ok, (f"loss {m['loss']:.6f} vs {m_ref['loss']:.6f} (rel "
                    f"{d['loss']:.2e}), grad_norm {m['grad_norm']:.6f} vs "
                    f"{m_ref['grad_norm']:.6f} (rel {d['grad_norm']:.2e}), "
                    f"leaf updates' max |diff| beyond one param ulp, "
                    f"relative to the largest |update|: worst {worst} "
                    f"{errs[worst]:.2e} (all: " + ", ".join(
                        f"{k} {v:.1e}" for k, v in errs.items()) + ")")

    upd, m, wall = run("full", n_micro)
    ok, reading = gate(upd, m)
    del upd
    log(f"[{tag}] remat full x {n_micro} microbatches against remat none x "
        f"1, {TRAIN_BATCH} x {TRAIN_SEQ} tokens, fp32 sgd(1.0): {reading}; "
        f"gate rel <= {TRAIN_ACCUM_RTOL:g}: {'OK' if ok else 'FAIL'} (steps "
        f"{wall:.2f} s and {w_ref:.2f} s, host clock)")
    if not ok:
        raise AssertionError(f"[{tag}] accumulation and remat disagree")

    def undivided(grads, state, params, step):
        tree_map(lambda g: g.mul_(n_micro), grads)
        return opt.update(grads, state, params, step)

    upd, m, _ = run("full", n_micro, Optimizer(init=opt.init,
                                               update=undivided))
    ok, reading = gate(upd, m)
    _must_fail(tag, "the microbatch sum left undivided", reading, ok)
    del upd, ref, ref_leaves, p0


def _train_loop(torch, cfg, seed: int) -> dict:
    """(b): the CLI's optimizer and step in the model's dtype with remat
    "full", TRAIN_STEPS steps on the stream; launches counted from 0
    around the loop.  Returns the launches."""
    from repro_torch.data.synthetic import token_batches
    from repro_torch.kernels import reset_counts
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import Optimizer, adamw, cosine_schedule

    tag = "train (b)"
    if DEV == "cuda":
        torch.cuda.reset_peak_memory_stats()
    model, params = _train_init(torch, cfg, seed)
    opt = adamw(cosine_schedule(3e-4, TRAIN_STEPS,
                                max(TRAIN_STEPS // 20, 1)))
    state = opt.init(params)
    n_micro = max(1, TRAIN_BATCH // cfg.microbatch)
    opt_ms = []

    def timed(grads, st, p, step):
        ev = _events(torch)
        out = opt.update(grads, st, p, step)
        opt_ms.append(ev())
        return out

    step_fn = make_train_step(model, Optimizer(init=opt.init, update=timed),
                              n_micro=n_micro)
    stream = token_batches(cfg.vocab, TRAIN_BATCH, TRAIN_SEQ, seed=seed,
                           device=DEV)
    losses, gnorms, step_ms = [], [], []
    _sync(torch)
    reset_counts()
    for step in range(TRAIN_STEPS):
        batch = next(stream)
        ev = _events(torch)
        params, state, m = step_fn(params, state, batch, step)
        step_ms.append(ev())
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
    launches = _counts()
    peak = (torch.cuda.max_memory_allocated() / 1e9 if DEV == "cuda"
            else float("nan"))
    for s in range(TRAIN_STEPS):
        log(f"[{tag}] step {s} loss={losses[s]:.4f} gnorm={gnorms[s]:.4f} "
            f"step {step_ms[s]:.1f} ms, optimizer {opt_ms[s]:.1f} ms")
    steady = sorted(step_ms[1:])[len(step_ms[1:]) // 2]
    steady_opt = sorted(opt_ms[1:])[len(opt_ms[1:]) // 2]
    log(f"[{tag}] {cfg.name} {cfg.n_layers} layers {cfg.dtype}, remat "
        f"{cfg.remat}, adamw, {TRAIN_BATCH} x {TRAIN_SEQ} tokens in "
        f"{n_micro} microbatches: median step (1..{TRAIN_STEPS - 1}) "
        f"{steady:.1f} ms, optimizer {steady_opt:.1f} ms "
        f"({100 * steady_opt / steady:.1f} %), peak {peak:.2f} GB allocated; "
        f"kernel launches {launches}")
    finite = all(math.isfinite(x) for x in losses + gnorms)
    ok = finite and losses[-1] < losses[0]
    log(f"[{tag}] losses and grad norms finite: {finite}; step "
        f"{TRAIN_STEPS - 1}'s loss {losses[-1]:.4f} below step 0's "
        f"{losses[0]:.4f}: {'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"[{tag}] the loop did not train")
    return launches


def _events(torch):
    """Starts a timer; the returned callable gives the ms since (CUDA
    events on the card, the host clock elsewhere)."""
    if DEV != "cuda":
        t0 = time.perf_counter()
        return lambda: 1e3 * (time.perf_counter() - t0)
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()

    def stop():
        b.record()
        b.synchronize()
        return a.elapsed_time(b)

    return stop


def start_train_drill() -> dict:
    """(c), started: the train CLI's fault-and-resume drill in one fresh
    process, which runs on while the script goes on (it needs a few
    seconds of the card, the rest is the process's start): an
    uninterrupted run, the same with ``--fail-at 5`` in a fresh
    directory, then that run extended to 10 steps.  ``main`` starts it
    beside the kernels' build; :func:`phase_train` checks it."""
    import os

    dirs = (WORK_DIR / "train_a", WORK_DIR / "train_b")
    for d in dirs:
        shutil.rmtree(d, ignore_errors=True)
    WORK_DIR.mkdir(parents=True, exist_ok=True)
    a, b = (str(d) for d in dirs)
    base = TRAIN_DRILL + ["--device", DEV]
    extended = base + ["--ckpt-dir", b, "--fail-at", "5"]
    extended[extended.index("--steps") + 1] = "10"
    argvs = [base + ["--ckpt-dir", a],
             base + ["--ckpt-dir", b, "--fail-at", "5"], extended]
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")])}
    # its output goes to files: a full pipe would stall it until the check
    logs = (WORK_DIR / "train_drill.out", WORK_DIR / "train_drill.err")
    with open(logs[0], "w") as out, open(logs[1], "w") as err:
        proc = subprocess.Popen([sys.executable, "-c", TRAIN_DRILL_CHILD,
                                 json.dumps(argvs)], env=env, cwd=ROOT,
                                stdout=out, stderr=err)
    return {"proc": proc, "dirs": dirs, "logs": logs,
            "t0": time.perf_counter()}


def stop_train_drill(drill) -> None:
    """Ends a process started beside the build (phase 14's drill, phase
    15's dry run) if it still runs (an earlier phase failed)."""
    if drill and drill["proc"].poll() is None:
        drill["proc"].kill()
        drill["proc"].wait()


def _train_drill(torch, drill: dict) -> None:
    """(c), checked: waits for the drill's process and holds its runs to
    the gates."""
    from repro_torch.checkpoint.store import latest_step, load_arrays

    tag = "train (c)"
    a, b = drill["dirs"]
    try:
        drill["proc"].wait(timeout=600)
    finally:
        stop_train_drill(drill)
    wall = time.perf_counter() - drill["t0"]
    stdout, stderr = (p.read_text() for p in drill["logs"])
    if drill["proc"].returncode != 0:
        log(stdout[-4000:] + stderr[-4000:])
        raise AssertionError(f"[{tag}] the drill's process exited "
                             f"{drill['proc'].returncode}")
    runs = json.loads(stdout.strip().splitlines()[-1])
    for i, r in enumerate(runs):
        for line in r["out"].splitlines():
            log(f"[{tag}] run {i + 1}: {line}")
    out2 = runs[1]["out"]
    steps = (latest_step(a), latest_step(b))
    la, _, _, _ = load_arrays(a, step=8)
    lb, _, _, _ = load_arrays(b, step=8)
    same = list(la) == list(lb) and all(
        la[k].dtype == lb[k].dtype and la[k].tobytes() == lb[k].tobytes()
        for k in la)
    checks = {
        "every exit code 0": all(r["rc"] == 0 for r in runs),
        "run 2 trapped one failure": out2.count("FAILED (") == 1,
        "run 2 restored step 3": "restored to step 3, continuing" in out2,
        "runs 1 and 2 ended at step 8": steps[0] == 8 and "done at step 8"
        in out2,
        f"run 2's final checkpoint equals run 1's bit for bit ({len(la)} "
        f"leaves)": same,
        "run 3 resumed from step 8": "resumed from step 8" in runs[2]["out"],
        "latest step 10 after run 3": steps[1] == 10,
    }
    for what, ok in checks.items():
        log(f"[{tag}] {what}: {'OK' if ok else 'FAIL'}")
    log(f"[{tag}] three CLI runs in one process, {wall:.1f}s from its "
        f"start to its check")
    if not all(checks.values()):
        raise AssertionError(f"[{tag}] the fault drill failed")


def phase_train(torch, *, seed: int, cfg=None, drill=None) -> dict:
    """Phase 14: training (``launch/steps.py``, ``launch/train.py``) at
    full width: (a) accumulation and remat in fp32, (b) the train loop in
    bf16, (c) the CLI's fault-and-resume drill at the smoke config
    (``drill``, from :func:`start_train_drill`; started here if None).
    ``cfg`` replaces the model (a rehearsal on the CPU at a smoke
    config).  Returns the loop's launches."""
    t_phase = time.perf_counter()
    drill = drill or start_train_drill()
    cfg = _train_cfg(cfg)
    _train_accum(torch, cfg, seed)
    _release(torch, "train (a)")
    launches = _train_loop(torch, cfg, seed)
    _release(torch, "train (b)")
    _train_drill(torch, drill)
    log(f"[train] phase 14 passed in {time.perf_counter() - t_phase:.1f}s")
    return {"train": launches}


# ---------------------------------------------------------------------------
# phase 15: the dry run against the card
# ---------------------------------------------------------------------------

# (d): the full dry run of these cells (arch, shape, mesh shape or None for
# the default production mesh), in a process started beside the build
DRYRUN_CELLS = (("qwen3-14b", "train_4k", None),
                ("qwen3-14b", "train_4k", (1, 4)),
                ("qwen3-14b", "decode_32k", None),
                ("qwen3-14b", "decode_32k", (1, 4)))
DRYRUN_CHILD = r"""
import json, sys
from repro_torch.launch import dryrun
for arch, shape, mesh in json.loads(sys.argv[2]):
    argv = ["--arch", arch, "--shape", shape, "--out", sys.argv[1]]
    if mesh:
        argv += ["--mesh-shape", ",".join(map(str, mesh)),
                 "--tag", "x".join(map(str, mesh))]
    if dryrun.main(argv):
        sys.exit(1)
"""
# (b): a batch cache of this many lanes and positions, the model's dtype
DRYRUN_DECODE_B, DRYRUN_DECODE_LEN = 8, 2048
# argument bytes: the caching allocator rounds each block to 512 B, and a
# tensor over 1 MiB may hold the unsplit tail of its segment (< 1 MiB)
ALLOC_SLACK_SMALL, ALLOC_SLACK_LARGE = 511, 2**20 + 511
# the trace's peak live bytes against max_memory_allocated over one step,
# less what the first step left allocated for good (cuBLAS's workspaces):
# the allocator's rounding and kernels' own temporaries are not in the
# trace
DRYRUN_PEAK_RTOL, DRYRUN_PEAK_ATOL = 0.01, 16 * 2**20


def start_dryrun() -> dict:
    """(d), started: the dry run of ``DRYRUN_CELLS`` in one fresh process
    (CPU only: ``meta`` tensors, nothing on the card), beside the
    kernels' build; :func:`phase_dryrun` reads its records."""
    import os

    out = WORK_DIR / "dryrun"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True, exist_ok=True)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")])}
    logs = (WORK_DIR / "dryrun.out", WORK_DIR / "dryrun.err")
    with open(logs[0], "w") as o, open(logs[1], "w") as e:
        proc = subprocess.Popen(
            [sys.executable, "-c", DRYRUN_CHILD, str(out),
             json.dumps(DRYRUN_CELLS)], env=env, cwd=ROOT, stdout=o,
            stderr=e)
    return {"proc": proc, "out": out, "logs": logs,
            "t0": time.perf_counter()}


def _alloc_slack(tree) -> int:
    from repro_torch.runtime.op_analysis import _tensors

    return sum(ALLOC_SLACK_SMALL if t.numel() * t.element_size() <= 2**20
               else ALLOC_SLACK_LARGE for t in _tensors(tree))


def _tree_nbytes(tree) -> int:
    from repro_torch.runtime.op_analysis import _tensors

    return sum(t.numel() * t.element_size() for t in _tensors(tree))


def _dryrun_cell(torch, tag: str, rec: dict, args, step, wrong: int,
                 base: int) -> dict:
    """One cell of (a) / (b) on the card: ``args`` placed (their
    allocation from ``base`` against the dry run's argument bytes), one
    step traced under the op analysis (FLOPs and bytes against the
    ``meta`` trace's, exactly), then one step timed with its peak against
    the trace's; ``wrong`` bytes left out of the dry run (the optimizer
    state, the cache) must fail both gates."""
    from repro_torch.runtime.op_analysis import _tensors, analyze_step

    _sync(torch)
    alloc = torch.cuda.memory_allocated() - base
    want, slack = rec["arg_bytes"], _alloc_slack(args)
    gap = alloc - want
    ok = 0 <= gap <= slack
    log(f"[{tag}] arguments: the dry run's {want} B (exact per-device "
        f"{rec['per_device_bytes']['total']} B), allocated on the card "
        f"{alloc} B: +{gap} B over {len(_tensors(args))} tensors, "
        f"bound [0, {slack}] (512-B rounding, and the unsplit tail of a "
        f"segment under 1 MiB for a tensor over 1 MiB): "
        f"{'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"[{tag}] argument bytes disagree")
    gap_w = alloc - (want - wrong)
    _must_fail(tag, f"argument bytes without {wrong} B", f"+{gap_w} B",
               0 <= gap_w <= slack)

    card = analyze_step(step, *args)[0]  # drops the step's result
    _sync(torch)
    persistent = torch.cuda.memory_allocated() - base - alloc
    meta = rec["op_analysis"]
    same = card.flops == meta["flops"] and \
        card.bytes_accessed == meta["bytes"]
    log(f"[{tag}] op analysis on meta: {meta['flops']:.6e} FLOP, "
        f"{meta['bytes']:.6e} B over {meta['ops_traced']} ops; the same "
        f"step traced on the card: {card.flops:.6e} FLOP, "
        f"{card.bytes_accessed:.6e} B over "
        f"{sum(v['count'] for v in card.ops.values())} ops: "
        f"{'equal' if same else 'DIFFERENT'}")
    if not same:
        diff = {k: (rec["op_table"].get(k), card.ops.get(k))
                for k in set(rec["op_table"]) | set(card.ops)
                if rec["op_table"].get(k) != card.ops.get(k)}
        raise AssertionError(f"[{tag}] the meta and card traces differ: "
                             f"{diff}")
    torch.cuda.reset_peak_memory_stats()
    ev = _events(torch)
    step(*args)
    ms = ev()
    peak = torch.cuda.max_memory_allocated() - base - persistent
    want_peak = rec["peak_live_bytes"]
    tol = DRYRUN_PEAK_RTOL * peak + DRYRUN_PEAK_ATOL
    ok = abs(want_peak - peak) <= tol
    r = rec["roofline"]
    log(f"[{tag}] peak: the trace's {want_peak / 1e9:.4f} GB, "
        f"max_memory_allocated over one step {peak / 1e9:.4f} GB less "
        f"{persistent} B the first step left allocated "
        f"({(want_peak - peak) / peak:+.3%}, tol {DRYRUN_PEAK_RTOL:.0%} + "
        f"{DRYRUN_PEAK_ATOL >> 20} MiB): "
        f"{'OK' if ok else 'FAIL'}; step {ms:.1f} ms against the "
        f"roofline's compute term {r['compute_s'] * 1e3:.2f} ms and memory "
        f"term {r['memory_s'] * 1e3:.2f} ms (H100 datasheet; "
        f"{r['dominant']}-bound, mfu bound {r['mfu_bound']:.3f}, measured "
        f"{r['model_flops'] / (ms / 1e3) / r['hw']['peak_flops']:.3f})")
    if not ok:
        raise AssertionError(f"[{tag}] peak live bytes disagree")
    _must_fail(tag, f"peak without {wrong} B",
               f"{(want_peak - wrong - peak) / peak:+.2%}",
               abs(want_peak - wrong - peak) <= tol)
    return {"ms": ms, "peak": peak}


def phase_dryrun(torch, *, seed: int, dryrun: dict, cfg=None) -> dict:
    """Phase 15: the dry run (``launch/dryrun.py``) against the card.  (a)
    phase 14 (b)'s train cell (qwen3-14b at 2 layers, full width, 32 x 64
    tokens, bf16 adamw, remat full, mesh (1, 1)) and (b) a decode cell of
    the same model with a batch cache (``DRYRUN_DECODE_B`` x
    ``DRYRUN_DECODE_LEN``, bf16), each through :func:`_dryrun_cell`; (c)
    ran on phase 4's engine (:func:`_dryrun_tick`); (d) the records of
    ``DRYRUN_CELLS`` from the process :func:`start_dryrun` started, one
    line a cell, and the card's memory against the figure they were held
    to; (e) the op analysis's collectives under ``torch.distributed``'s
    ``fake`` backend on this torch.  Returns the kernel launches (none)."""
    import os

    from repro_torch.configs.base import ShapeSpec
    from repro_torch.kernels import reset_counts
    from repro_torch.launch import dryrun as dr
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import make_decode_step, make_train_step
    from repro_torch.optim import adamw, cosine_schedule
    from repro_torch.runtime.sharding import default_rules

    t_phase = time.perf_counter()
    cfg = _train_cfg(cfg)
    host = make_host_mesh()
    _sync(torch)
    reset_counts()

    # ---- (a) the train cell -------------------------------------------
    tag = "dryrun-a"
    shape = ShapeSpec("chip_train", TRAIN_SEQ, TRAIN_BATCH, "train")
    rec = dr.analyze_cell(cfg, shape, host, default_rules())
    base = torch.cuda.memory_allocated()
    model, params = _train_init(torch, cfg, seed)
    opt = adamw(cosine_schedule(3e-4, 10_000, 500))
    state = opt.init(params)
    g = torch.Generator(device=DEV)
    g.manual_seed(seed)
    toks = torch.randint(0, cfg.vocab, (TRAIN_BATCH, TRAIN_SEQ + 1),
                         generator=g, device=DEV, dtype=torch.int32)
    batch = {"tokens": toks[:, :-1].contiguous(),
             "targets": toks[:, 1:].contiguous()}
    del toks
    log(f"[{tag}] {cfg.name} {cfg.n_layers} layers {cfg.dtype}, remat "
        f"{cfg.remat}, adamw, {TRAIN_BATCH} x {TRAIN_SEQ} tokens, mesh "
        f"(1, 1); the dry run traced it on meta in {rec['trace_s']} s")
    _dryrun_cell(torch, tag, rec, (params, state, batch, 0),
                 make_train_step(model, opt), _tree_nbytes(state), base)
    del params, state, batch, model, opt
    _release(torch, "phase 15 (a)")

    # ---- (b) a decode cell with a batch cache ------------------------
    tag = "dryrun-b"
    B, S = DRYRUN_DECODE_B, DRYRUN_DECODE_LEN
    rec = dr.analyze_cell(cfg, ShapeSpec("chip_decode", S, B, "decode"),
                          host, default_rules())
    base = torch.cuda.memory_allocated()
    model, params = _train_init(torch, cfg, seed)
    cache = model.init_cache(B, S, device=DEV)
    tokens = torch.zeros((B, 1), dtype=torch.int32, device=DEV)
    log(f"[{tag}] {cfg.name} {cfg.n_layers} layers {cfg.dtype}, a batch "
        f"cache of {B} x {S} positions, one token at position {S - 1}")
    _dryrun_cell(torch, tag, rec, (params, tokens, cache, S - 1),
                 make_decode_step(model), _tree_nbytes(cache), base)
    del params, cache, tokens, model
    _release(torch, "phase 15 (b)")

    # ---- (d) the full dry run ----------------------------------------
    tag = "dryrun-d"
    proc = dryrun["proc"]
    early = proc.poll() is not None
    try:
        rc = proc.wait(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    err = dryrun["logs"][1].read_text()
    if rc != 0:
        raise AssertionError(f"[{tag}] the dry run exited {rc}: {err[-2000:]}")
    total = torch.cuda.get_device_properties(0).total_memory
    for arch, shape_name, mesh in DRYRUN_CELLS:
        suffix = "." + "x".join(map(str, mesh)) if mesh else ""
        rec = json.loads((dryrun["out"] / f"{arch}__{shape_name}__pod1"
                          f"{suffix}.json").read_text())
        d, r = rec["per_device_bytes"], rec["roofline"]
        coll = ("null (" + rec["collectives_note"].split(":")[0] + ")"
                if rec["collectives"] is None
                else f"{rec['collectives']['total_bytes']:.0f} B")
        log(f"[{tag}] {arch} x {shape_name} mesh {rec['mesh']} "
            f"({rec['chips']} chips): per device "
            + ", ".join(f"{k} {v / 1e9:.3f} GB" for k, v in d.items())
            + f"; peak {rec['per_device_peak_bytes'] / 1e9:.2f} GB, fits "
            f"{rec['fits']}; {rec['op_analysis']['flops_per_device']:.4e} "
            f"FLOP and {rec['op_analysis']['bytes_per_device']:.4e} B a "
            f"device; compute {r['compute_s']:.4f} s, memory "
            f"{r['memory_s']:.4f} s, collective {r['collective_s']}, "
            f"{r['dominant']}-bound, useful {r['useful_ratio']:.3f}, mfu "
            f"bound {r['mfu_bound']:.3f}; collectives {coll}; traced in "
            f"{rec['trace_s']} s")
        # counted on one chip, and for a train cell on a mesh (one rank's
        # trace); null with its reason for a decode cell on a mesh
        counted = rec["chips"] == 1 or rec["kind"] == "train"
        if rec["status"] != "ok" or counted != (
                rec["collectives"] is not None) or counted != (
                r["collective_s"] is not None):
            raise AssertionError(f"[{tag}] {arch} x {shape_name}: a bad "
                                 f"record")
    log(f"[{tag}] the dry run's {len(DRYRUN_CELLS)} cells ran beside "
        f"phases 1-14 (done before phase 15: {early}); the card's memory "
        f"(get_device_properties(0).total_memory) {total} B, the figure "
        f"the records' fits used {dr.DEVICE_MEMORY_BYTES} B")
    if total != dr.DEVICE_MEMORY_BYTES:
        raise AssertionError(f"[{tag}] the card's memory {total} B is not "
                             f"the dry run's {dr.DEVICE_MEMORY_BYTES} B")

    # ---- (e) collectives under the fake backend -----------------------
    _fake_collectives(torch)
    log(f"[dryrun] phase 15 passed in {time.perf_counter() - t_phase:.1f}s")
    return {"dryrun": _counts()}


def _fake_collectives(torch) -> None:
    """(e): an all-reduce, an all-gather and a reduce-scatter of one rank
    of four under ``torch.distributed``'s ``fake`` backend, counted by the
    op analysis with the per-device link-byte conventions."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.runtime.op_analysis import analyze_step

    tag = "dryrun-e"
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        x = torch.ones(1024, device=DEV)

        def f(x):
            dist.all_reduce(x)
            dist.all_gather_into_tensor(torch.empty(4096, device=DEV), x)
            dist.reduce_scatter_tensor(torch.empty(256, device=DEV), x)

        stats, _ = analyze_step(f, x, device=DEV)
    finally:
        dist.destroy_process_group()
    got = stats.collectives.bytes_by_kind
    want = {"all-reduce": 2 * 4096 * 0.75, "all-gather": 16384 * 0.75,
            "reduce-scatter": 4096 * 0.75}
    log(f"[{tag}] torch {torch.__version__}, backend 'fake', 1 rank of 4: "
        f"collective bytes {got} (want {want})")
    if got != want:
        raise AssertionError(f"[{tag}] collective bytes off the conventions")


# ---------------------------------------------------------------------------
# phase 16: training over a mesh of ranks sharing the card
# ---------------------------------------------------------------------------

# (a), (b): qwen3-14b at full width, cut to this depth for memory (a
# one-device fp32 step of 2 layers holds ~50 GB; each of two ranks half of
# the state, but the whole replicated activations and its own CUDA
# context), 8 x 64 tokens in 2 microbatches; every run of the phase takes
# the same tokens
MESH_RANKS, MESH_LAYERS = 2, 2
MESH_BATCH, MESH_SEQ, MESH_MICRO = 8, 64, 4
MESH_STEPS_FP32, MESH_STEPS_BF16 = 3, 4
# (d): llama4-scout-17b-a16e at full width (16 experts, 8 a rank), one
# layer for memory: 4.1e9 parameters, 16.6 GB in fp32; adamw's master and
# moments would add 49.8 GB on one device, so the gated run takes sgd
# (its update linear in the gradient), as does its bf16 timing
MESH_MOE_ARCH, MESH_MOE_LAYERS, MESH_MOE_OPT = "llama4-scout-17b-a16e", 1, \
    "sgd"
# (e): one fp32 sgd step against one device at full width, at the fewest
# layers that hold each block kind: (tag, arch, depth fields, dtype).  The
# vlm's 5 layers (4 self, 1 gated cross; 6.4e9 parameters) do not fit one
# device in fp32 with their gradients and fp32 sum (77 GB), so it runs in
# bf16, gated on loss and grad norm only; its gates take seeded non-zero
# values.  Then 3 adafactor steps of (a)'s model.
MESH_FAMILY_RUNS = (
    ("rwkv6", "rwkv6-1.6b", {"n_layers": 1}, "float32"),
    ("zamba2", "zamba2-7b", {"n_layers": 6}, "float32"),
    ("whisper", "whisper-small",
     {"n_layers": 1, "n_enc_layers": 1, "n_dec_layers": 1}, "float32"),
    ("vlm", "llama-3.2-vision-90b", {"n_layers": 5}, "bfloat16"),
)
MESH_ADAFACTOR_STEPS = 3
# the elements of each kept leaf the gates read (every element of a
# smaller leaf): the runs' states stay on their devices, only these move
MESH_SAMPLE = 1 << 16
# (a) gates: loss and grad norm as on the CPU (relative 1e-5).  adamw's
# first moment, linear in the gradients: max |dm| of each leaf's sample
# within MESH_M_RTOL of its max |m|.  Params: each leaf's distance from
# the one-device params within MESH_UPDATE_RTOL of how far that run moved
# it (L2 over the sample), no element off by more than MESH_OUTSIDE_MAX —
# not the CPU's elementwise tolerance, because the ranks' split products
# round otherwise than one device's and adamw's normalized update turns
# an ulp of a near-zero gradient into up to 2 lr a step (the most it
# moves an element, weight decay aside), where the elements outside that
# tolerance are counted and logged.  sgd's and adafactor's runs take the
# loss, grad norm and distance gates; sgd's also no element off by more
# than MESH_UPDATE_RTOL of the sample's largest move (its update is
# linear in the gradient) plus the two roundings of p - lr g, within an
# ulp of p: 2^-22 |p|
MESH_LOSS_RTOL = 1e-5
# about 3.5 times the worst reading on the H100 (8.7e-5, attn/wq), far
# below what a gradient off by a factor would read
MESH_M_RTOL = 3e-4
MESH_UPDATE_RTOL = 1e-2
MESH_LEAF_RTOL, MESH_LEAF_ATOL = 1e-5, 1e-6
MESH_OUTSIDE_MAX = 2 * 3e-4 * 1.1 * MESH_STEPS_FP32
MESH_SGD_ULP = 2.0 ** -22
# the bf16 vlm against one device in bf16, relative: each logit a bf16
# ulp (2^-8) apart at most, averaged over 512 tokens into the loss; the
# grad norm summed over 6.4e9 elements
MESH_BF16_LOSS_RTOL, MESH_BF16_GNORM_RTOL = 1e-3, 1e-2
# (c): the train CLI's fault drill on 2 ranks at the smoke config
MESH_DRILL = ["--arch", "qwen3-14b", "--smoke", "--steps", "6",
              "--global-batch", "4", "--seq-len", "16", "--save-every", "2",
              "--log-every", "1", "--devices", str(MESH_RANKS)]
MESH_CHILD = r"""
import json, sys
import chip_smoke
print(json.dumps(chip_smoke.train_mesh_child(json.loads(sys.argv[1]))))
"""


def start_mesh_drill() -> dict:
    """(c), started: the train CLI with ``--devices 2`` (two ranks sharing
    the card on gloo) at the smoke config in one fresh process beside the
    build: an uninterrupted run, then the same with ``--fail-at 3``."""
    import os

    dirs = (WORK_DIR / "mesh_a", WORK_DIR / "mesh_b")
    for d in dirs:
        shutil.rmtree(d, ignore_errors=True)
    WORK_DIR.mkdir(parents=True, exist_ok=True)
    base = MESH_DRILL + ["--device", DEV]
    argvs = [base + ["--ckpt-dir", str(dirs[0])],
             base + ["--ckpt-dir", str(dirs[1]), "--fail-at", "3"]]
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")])}
    logs = (WORK_DIR / "mesh_drill.out", WORK_DIR / "mesh_drill.err")
    with open(logs[0], "w") as out, open(logs[1], "w") as err:
        proc = subprocess.Popen([sys.executable, "-c", TRAIN_DRILL_CHILD,
                                 json.dumps(argvs)], env=env, cwd=ROOT,
                                stdout=out, stderr=err)
    return {"proc": proc, "dirs": dirs, "logs": logs,
            "t0": time.perf_counter()}


def mesh_runs(smoke: bool = False) -> list:
    """Phase 16's runs of the mesh, in order: (a) and (b) of qwen3-14b,
    (d) of llama4-scout, (e) of the other families and adafactor.  Each is
    a dict: ``tag``, ``cfg`` (a dict), ``optimizer``, ``steps``, ``gate``
    ("adamw", "sgd", "bf16", "adafactor"; "time": the mesh alone, timed),
    ``keep``, ``init_values``.  ``smoke``: every config's smoke form (a
    CPU rehearsal)."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config, get_smoke_config

    get = get_smoke_config if smoke else get_config

    def cut(tag, arch, fields, why="memory"):
        full = get(arch)
        if smoke:
            return full
        cfg = dataclasses.replace(full, **fields)
        log(f"[train-mesh {tag}] DEPTH CUT: {cfg.n_layers} of "
            f"{full.n_layers} layers ({why}); full width"
            + (f" ({', '.join(f'{k}={v}' for k, v in fields.items())})"
               if len(fields) > 1 else ""))
        return cfg

    def run(tag, cfg, optimizer, steps, gate, keep=("params",),
            init_values=None):
        cfg = dataclasses.replace(cfg, microbatch=MESH_MICRO)
        return {"tag": tag, "cfg": dataclasses.asdict(cfg),
                "optimizer": optimizer, "steps": steps, "gate": gate,
                "keep": list(keep), "init_values": init_values or {}}

    qwen = cut("(a)", TRAIN_ARCH, {"n_layers": MESH_LAYERS})
    f32 = dataclasses.replace(qwen, dtype="float32")
    scout = cut("(d)", MESH_MOE_ARCH, {"n_layers": MESH_MOE_LAYERS})
    runs = [run("(a)", f32, "adamw", MESH_STEPS_FP32, "adamw",
                keep=("params", "opt/m")),
            run("(b)", qwen, "adamw", MESH_STEPS_BF16, "time"),
            run("(d)", dataclasses.replace(scout, dtype="float32"),
                MESH_MOE_OPT, MESH_STEPS_FP32, "sgd"),
            run("(d) bf16", scout, MESH_MOE_OPT, MESH_STEPS_BF16, "time")]
    for tag, arch, fields, dtype in MESH_FAMILY_RUNS:
        cfg = dataclasses.replace(cut(f"(e) {tag}", arch, fields),
                                  dtype=dtype)
        gates = {}
        if cfg.family == "vlm":  # seeded non-zero gates: the cross path
            g = np.random.default_rng(9)
            gates = {k: float(g.uniform(0.3, 0.9) * g.choice([-1, 1]))
                     for k in ("cross_layers/mlp_gate",
                               "cross_layers/xattn/gate")}
        runs.append(run(f"(e) {tag}", cfg, "sgd", 1,
                        "bf16" if dtype == "bfloat16" else "sgd",
                        init_values=gates))
    runs.append(run("(e) adafactor", f32, "adafactor", MESH_ADAFACTOR_STEPS,
                    "adafactor", keep=("params",)))
    return runs


def _mesh_batches(torch, cfg, steps: int, seed: int):
    """The batches of a run whose family takes stub embeddings (frames,
    patches) beside the tokens: ``token_batches``' first ``steps`` and a
    seeded draw of the embeddings in the model's dtype, on the host; None
    for the token-only families (the run reads the stream itself)."""
    from repro_torch.data.synthetic import token_batches

    key = FAMILY_EMBEDDED.get(cfg.family)
    if key is None:
        return None
    n = FAMILY_FRAMES if cfg.family == "encdec" else cfg.n_patches
    g = torch.Generator().manual_seed(seed + 7)
    stream = token_batches(cfg.vocab, MESH_BATCH, MESH_SEQ, seed=seed,
                           device="cpu")
    out = []
    for _ in range(steps):
        b = next(stream)
        b[key] = torch.randn(MESH_BATCH, n, cfg.d_model, generator=g).to(
            getattr(torch, cfg.dtype))
        out.append(b)
    return out


def _mesh_job(torch, r: dict, seed: int, dev: str):
    from repro_torch.configs import ArchConfig
    from repro_torch.launch.train import Job, TrainOptions

    cfg = ArchConfig.from_dict(r["cfg"])
    opts = TrainOptions(steps=r["steps"], global_batch=MESH_BATCH,
                        seq_len=MESH_SEQ, seed=seed, device=dev,
                        log_every=1)
    timed = r["gate"] == "time"
    return Job(cfg, opts, keep=() if timed else tuple(r["keep"]),
               optimizer=r["optimizer"],
               batches=_mesh_batches(torch, cfg, r["steps"], seed),
               sample=0 if timed else MESH_SAMPLE,
               init_values=r["init_values"])


def _init_sample(torch, job) -> dict:
    """:func:`sample_leaves` of the run's fresh init (the params every run
    of it starts from), drawn again on the device."""
    from repro_torch.convert import stack_layers
    from repro_torch.launch.train import sample_leaves
    from repro_torch.models.lm import build_model

    g = torch.Generator(device=job.opts.device)
    g.manual_seed(job.opts.seed)
    params = stack_layers(build_model(job.cfg).init(
        g, device=job.opts.device))
    leaves = dict(_flat(params))
    for k, v in job.init_values.items():
        leaves[k].fill_(v)
    out = sample_leaves({"params": params}, job.sample)
    del params, leaves
    return out


def _leaf_stats(torch, got: dict, want: dict, init: dict) -> dict:
    """Per leaf, from the samples of the mesh run, the one-device run and
    the init: the differences the gates read."""
    out = {}
    for k, a in got.items():
        b = want[k]
        d = (a.double() - b.double()).abs()
        v = {"n": b.numel(), "max_abs": float(d.max()),
             "max_ref": float(b.abs().max()),
             "outside": int((d > MESH_LEAF_RTOL * b.double().abs()
                             + MESH_LEAF_ATOL).sum())}
        if k in init:
            moved = b.double() - init[k].double()
            v["dist"] = float(torch.linalg.vector_norm(a.double()
                                                       - b.double()))
            v["moved"] = float(torch.linalg.vector_norm(moved))
            v["max_moved"] = float(moved.abs().max())
            v["sgd_outside"] = int((d > MESH_UPDATE_RTOL * v["max_moved"]
                                    + MESH_SGD_ULP * b.double().abs()).sum())
        out[k] = v
    return out


def train_mesh_child(spec: dict) -> dict:
    """Phase 16's runs (``spec["runs"]``, :func:`mesh_runs`) in a fresh
    process (deterministic algorithms from its first CUDA call; this
    process is rank 0 and starts the other ranks): first each gated run
    on one device, keeping only :func:`sample_leaves` of its final state
    and of its init; then every run on the (1, ``mp``) mesh, all of them
    one after another in one start of the ranks, each gated run's final
    state sampled where it lies.  Launches are counted from 0 around the
    mesh runs."""
    import gc

    import torch

    from repro_torch.kernels import reset_counts
    from repro_torch.launch.train import train_jobs

    dev, seed, mp = spec["device"], spec["seed"], spec["mp"]
    out, wall = {}, {}
    for r in spec["runs"]:
        if r["gate"] == "time":
            continue
        job = _mesh_job(torch, r, seed, dev)
        t0 = time.perf_counter()
        ref = train_jobs([job])[0]
        init = _init_sample(torch, job)
        wall[f"{r['tag']} one device"] = time.perf_counter() - t0
        out[r["tag"]] = {"ref": ref["history"], "sample": ref["sample"],
                         "init": init}
        del ref, job
        gc.collect()
        if dev == "cuda":
            torch.cuda.empty_cache()
    reset_counts()
    t0 = time.perf_counter()
    jobs = [_mesh_job(torch, r, seed, dev) for r in spec["runs"]]
    mesh = train_jobs(jobs, dp=1, mp=mp)
    wall["mesh, every run"] = time.perf_counter() - t0
    launches = _counts()
    for r, got in zip(spec["runs"], mesh):
        rec = out.setdefault(r["tag"], {})
        rec.update(gate=r["gate"], mesh=got["history"],
                   ms_by_rank=got["ms_by_rank"])
        if "sample" in rec:
            rec["leaves"] = _leaf_stats(torch, got["sample"],
                                        rec.pop("sample"), rec.pop("init"))
            rec["block_sha"] = got["block_sha"]
    return {"runs": out, "launches": launches, "wall": wall}


def _flat(tree):
    from repro_torch.tree import flatten_with_paths

    return flatten_with_paths(tree)



def _mesh_drill(drill: dict) -> None:
    """(c), checked: both CLI runs exit 0, the second traps its failure at
    step 3 and restores step 2 on both ranks, and its final checkpoint
    equals the first's bit for bit."""
    from repro_torch.checkpoint.store import load_arrays

    tag = "train-mesh (c)"
    a, b = drill["dirs"]
    try:
        drill["proc"].wait(timeout=600)
    finally:
        stop_train_drill(drill)
    wall = time.perf_counter() - drill["t0"]
    stdout, stderr = (p.read_text() for p in drill["logs"])
    if drill["proc"].returncode != 0:
        log(stdout[-4000:] + stderr[-4000:])
        raise AssertionError(f"[{tag}] the drill's process exited "
                             f"{drill['proc'].returncode}")
    runs = json.loads(stdout.strip().splitlines()[-1])
    for i, r in enumerate(runs):
        for line in r["out"].splitlines():
            log(f"[{tag}] run {i + 1}: {line}")
    out2 = runs[1]["out"]
    la, _, _, _ = load_arrays(a, step=6)
    lb, _, _, _ = load_arrays(b, step=6)
    same = list(la) == list(lb) and all(
        la[k].dtype == lb[k].dtype and la[k].tobytes() == lb[k].tobytes()
        for k in la)
    checks = {
        "every exit code 0": all(r["rc"] == 0 for r in runs),
        "both runs on a mesh of 2 ranks": all(
            "mesh data=1 model=2" in r["out"] for r in runs),
        "run 2 trapped one failure": out2.count("FAILED (") == 1,
        "run 2 restored step 2": "restored to step 2, continuing" in out2,
        f"run 2's final checkpoint equals run 1's bit for bit ({len(la)} "
        f"leaves)": same,
    }
    for what, ok in checks.items():
        log(f"[{tag}] {what}: {'OK' if ok else 'FAIL'}")
    log(f"[{tag}] two CLI runs of 2 ranks in one process, {wall:.1f}s "
        f"from its start to its check")
    if not all(checks.values()):
        raise AssertionError(f"[{tag}] the mesh fault drill failed")


def run_mesh_child(runs: list, mp: int, seed: int, tag: str) -> dict:
    """:func:`train_mesh_child` of ``runs`` on (1, ``mp``) in a fresh
    process; logs its lines and returns its record."""
    import os

    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(ROOT / "src"), str(ROOT), os.environ.get("PYTHONPATH", "")])}
    logs = (WORK_DIR / f"{tag}.out", WORK_DIR / f"{tag}.err")
    WORK_DIR.mkdir(parents=True, exist_ok=True)
    with open(logs[0], "w") as o, open(logs[1], "w") as e:
        proc = subprocess.Popen(
            [sys.executable, "-c", MESH_CHILD,
             json.dumps({"runs": runs, "seed": seed, "device": DEV,
                         "mp": mp})], env=env, cwd=ROOT, stdout=o, stderr=e)
    try:
        rc = proc.wait(timeout=900)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    stdout, stderr = (p.read_text() for p in logs)
    if rc != 0:
        log(stdout[-4000:] + stderr[-4000:])
        raise AssertionError(f"[{tag}] the mesh process exited {rc}")
    lines = stdout.strip().splitlines()
    for line in lines[:-1]:
        log(f"[{tag}] {line}")
    return json.loads(lines[-1])


def _leaf_gate(gate: str, k: str, v: dict) -> tuple[bool, str]:
    """A leaf's gate of a run against one device, from its sample."""
    if k.startswith("opt/m/"):
        rel = v["max_abs"] / max(v["max_ref"], 1e-30)
        return rel <= MESH_M_RTOL, (f"max |dm| {v['max_abs']:.3e} = "
                                    f"{rel:.2e} of max |m| (gate "
                                    f"{MESH_M_RTOL:g})")
    rel = v["dist"] / max(v["moved"], 1e-30)
    ok = rel <= MESH_UPDATE_RTOL
    reading = (f"|p - p_ref| {v['dist']:.3e} = {rel:.2e} of the one-device "
               f"run's move {v['moved']:.3e} (gate {MESH_UPDATE_RTOL:g})")
    if gate == "adamw":
        ok &= v["max_abs"] <= MESH_OUTSIDE_MAX
        reading += (f", max |d| {v['max_abs']:.3e} (gate "
                    f"{MESH_OUTSIDE_MAX:.2e})")
    elif gate == "sgd":
        ok &= v["sgd_outside"] == 0
        reading += (f", max |d| {v['max_abs']:.3e}, {v['sgd_outside']} "
                    f"elements off by more than {MESH_UPDATE_RTOL:g} of the "
                    f"largest move {v['max_moved']:.3e} + 2^-22|p|")
    else:
        reading += f", max |d| {v['max_abs']:.3e}"
    return ok, reading


def _mesh_timed(tag: str, rec: dict, cfg, steps: int) -> None:
    for r, ms in enumerate(rec["ms_by_rank"]):
        line = (f"[{tag}] rank {r}: {cfg.dtype} step ms (CUDA events) "
                + ", ".join(f"{t:.1f}" for t in ms))
        if len(ms) > 1:  # the first step builds and warms up
            line += (f"; median of steps 1..{len(ms) - 1} "
                     f"{sorted(ms[1:])[len(ms[1:]) // 2]:.1f} ms")
        log(line)
    losses = [h["loss"] for h in rec["mesh"]]
    ok = all(math.isfinite(x) for x in losses) and len(losses) == steps
    log(f"[{tag}] {cfg.dtype} losses {[round(x, 4) for x in losses]} "
        f"finite: {'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"[{tag}] the {cfg.dtype} mesh run failed")


def mesh_gates(res: dict, runs: list, mp: int) -> None:
    """Phase 16's gates on a :func:`train_mesh_child` record of a (1,
    ``mp``) mesh: each gated run against its one-device run (loss and
    grad norm of every step, each leaf's sample, and the leaves with
    replicas bit-identical on every rank), each timed run's step time a
    rank."""
    from repro_torch.configs import ArchConfig

    failed = []
    for r in runs:
        tag, rec = f"train-mesh {r['tag']}", res["runs"][r["tag"]]
        cfg = ArchConfig.from_dict(r["cfg"])
        log(f"[{tag}] {cfg.name}, {cfg.n_layers} layers, {cfg.dtype}, "
            f"{r['optimizer']}, {r['steps']} step(s)"
            + (f", init {r['init_values']}" if r["init_values"] else ""))
        if cfg.n_experts:
            from repro_torch.runtime.train_mesh import ShardPlan, TrainMesh

            plan = ShardPlan(cfg, TrainMesh(dp=1, mp=mp))
            local = (cfg.n_experts // mp if plan.parallel("act_experts")
                     else cfg.n_experts)
            log(f"[{tag}] expert-parallel: "
                f"{plan.parallel('act_experts')}; {local} of "
                f"{cfg.n_experts} experts stored and computed a rank")
        if r["gate"] == "time":
            _mesh_timed(tag, rec, cfg, r["steps"])
            continue
        rtol = {"loss": MESH_LOSS_RTOL, "grad_norm": MESH_LOSS_RTOL}
        if r["gate"] == "bf16":
            rtol = {"loss": MESH_BF16_LOSS_RTOL,
                    "grad_norm": MESH_BF16_GNORM_RTOL}
        ok_loss = len(rec["mesh"]) == len(rec["ref"]) == r["steps"]
        for s, (a, b) in enumerate(zip(rec["ref"], rec["mesh"])):
            d = {k: abs(b[k] - a[k]) / abs(a[k]) for k in rtol}
            ok_loss &= all(d[k] <= rtol[k] for k in rtol)
            log(f"[{tag}] step {s}: loss {b['loss']:.7f} vs {a['loss']:.7f}"
                f" (rel {d['loss']:.2e}), grad_norm {b['grad_norm']:.6f} vs "
                f"{a['grad_norm']:.6f} (rel {d['grad_norm']:.2e})"
                + (f", aux {b['aux']:.6f} vs {a['aux']:.6f}, dropped "
                   f"{b['dropped']} vs {a['dropped']}" if "aux" in a else ""))
            if "dropped" in a:
                ok_loss &= a["dropped"] == b["dropped"]
        ok_leaves = True
        if r["gate"] != "bf16":
            for k, v in rec["leaves"].items():
                ok, reading = _leaf_gate(r["gate"], k, v)
                ok_leaves &= ok
                log(f"[{tag}] {k}: {reading}; {v['outside']} of {v['n']} "
                    f"sampled elements outside |d| <= {MESH_LEAF_RTOL:g}|ref|"
                    f" + {MESH_LEAF_ATOL:g}: {'OK' if ok else 'FAIL'}")
        sha = rec["block_sha"]
        ok_rep = all(len(set(h)) == 1 for h in sha.values())
        log(f"[{tag}] loss and grad_norm within "
            + ", ".join(f"{k} {v:g}" for k, v in rtol.items())
            + f": {'OK' if ok_loss else 'FAIL'}; every sampled leaf: "
            f"{'OK' if ok_leaves else 'FAIL'}; the {len(sha)} leaves with "
            f"replicas bit-identical on every rank: "
            f"{'OK' if ok_rep else 'FAIL'}")
        if not (ok_loss and ok_leaves and ok_rep):
            failed.append(r["tag"])
        _mesh_timed(tag, rec, cfg, r["steps"])
    log("[train-mesh] wall (host clock, process starts included): "
        + ", ".join(f"{k} {v:.1f} s" for k, v in res["wall"].items()))
    if failed:
        raise AssertionError(f"[train-mesh] the mesh step is not the "
                             f"one-device step: {', '.join(failed)}")


def phase_train_mesh(torch, *, seed: int, drill=None, runs=None) -> dict:
    """Phase 16: training over a (1, 2) mesh of ranks sharing the card on
    gloo (``launch/train.py``'s ``train_jobs``, the function under the
    CLI's ``--devices``; no kernel: fp weights): (a) qwen3-14b fp32
    against one device, (b) its bf16 step time per rank, (d)
    llama4-scout fp32 against one device and its bf16 step time, (e) the
    other families and adafactor against one device, all in one start of
    the ranks; (c) the CLI's fault drill (``drill``, from
    :func:`start_mesh_drill`; started here if None).  ``runs`` replaces
    :func:`mesh_runs` (a rehearsal on the CPU at the smoke configs).
    Returns the launches of the mesh runs."""
    t_phase = time.perf_counter()
    tag = "train-mesh"
    drill = drill or start_mesh_drill()
    runs = runs if runs is not None else mesh_runs()
    log(f"[{tag}] {len(runs)} runs, {MESH_BATCH} x {MESH_SEQ} tokens in "
        f"{MESH_BATCH // MESH_MICRO} microbatches, {MESH_RANKS} ranks on one "
        f"{DEV} device (gloo; collectives on CUDA tensors staged through "
        f"host memory), started once for every run")
    res = run_mesh_child(runs, MESH_RANKS, seed, tag)
    mesh_gates(res, runs, MESH_RANKS)
    log(f"[{tag}] kernel launches around the mesh runs (rank 0): "
        f"{res['launches']}")
    _mesh_drill(drill)
    log(f"[{tag}] phase 16 passed in {time.perf_counter() - t_phase:.1f}s")
    return {"train_mesh": res["launches"]}


REPLACES = {
    "quant_matmul": "src/repro/kernels/quant_matmul/kernel.py:60",
    "paged_decode": "src/repro/kernels/paged_attention/kernel.py:164",
    "paged_prefill": "src/repro/kernels/paged_attention/kernel.py:389",
    "ldlq": "src/repro/kernels/ldlq/kernel.py:53",
    "kron_mul": "src/repro/kernels/kron_mul/kernel.py:49",
    "hadamard": "src/repro/kernels/hadamard/kernel.py:55",
}
# kernel -> its source family in kernels/_build.SOURCES
FAMILY = {"paged_decode": "paged_attention",
          "paged_prefill": "paged_attention"}


def _release(torch, after: str) -> None:
    """Frees the card between phases: collects cyclic garbage (engines,
    tracers and threads' closures form cycles) and empties the caching
    allocator, and logs what the finished phases still hold."""
    import gc

    held = torch.cuda.memory_allocated()
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[memory] after {after}: {held / 1e9:.2f} GB allocated, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB after gc.collect")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--layers", type=int, default=40,
                    help="depth of the served synthetic qwen3-14b (width "
                         "is never cut)")
    ap.add_argument("--quant-layers", type=int, default=2,
                    help="depth of the quantized qwen3-14b (phase 6)")
    ap.add_argument("--calib-segments", type=int, default=128)
    ap.add_argument("--calib-len", type=int, default=2048)
    ap.add_argument("--calib-chunk", type=int, default=8)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        log("[device] torch.cuda.is_available() is False: this smoke run "
            "needs a CUDA card")
        return 2
    from repro_torch.kernels import _build  # fails outside a checkout

    t_start = time.perf_counter()
    dev = phase_device(torch)
    # phase 14 (c)'s process runs beside the build: it holds the card for
    # a few seconds, the rest of its ~20 s is its start
    drill = start_train_drill()
    atexit.register(stop_train_drill, drill)
    # phase 15 (d)'s dry run: CPU only, beside the build and the phases
    dry = start_dryrun()
    atexit.register(stop_train_drill, dry)
    # phase 16 (c)'s two CLI runs of 2 ranks, beside the build too
    mesh_drill = start_mesh_drill()
    atexit.register(stop_train_drill, mesh_drill)
    phase_build()
    reps = phase_kernels(torch)
    _release(torch, "phase 3")
    served = phase_serve(torch, seed=args.seed, layers=args.layers)
    _release(torch, "phase 4")
    quant = phase_quantize(torch, seed=args.seed, layers=args.quant_layers,
                           segments=args.calib_segments,
                           seg_len=args.calib_len, chunk=args.calib_chunk)
    _release(torch, "phase 6")
    dense = phase_dense_family(torch, seed=args.seed)
    _release(torch, "phase 7")
    lifecycle = phase_lifecycle(torch, seed=args.seed,
                                layers=min(args.layers, LIFECYCLE_LAYERS))
    _release(torch, "phase 8")
    speculative = phase_speculative(torch, seed=args.seed,
                                    layers=min(args.layers, SPEC_LAYERS))
    _release(torch, "phase 9")
    observe = phase_observe(torch, seed=args.seed,
                            layers=min(args.layers, OBSERVE_LAYERS),
                            check_max=served["check"]["max_diff"],
                            artifact=quant["artifact"])
    _release(torch, "phase 10")
    tp = phase_tp(torch, seed=args.seed, layers=min(args.layers, TP_LAYERS))
    _release(torch, "phase 11")
    frontdoor = phase_frontdoor(torch, seed=args.seed,
                                layers=min(args.layers, FRONTDOOR_LAYERS))
    _release(torch, "phase 12")
    families = phase_families(torch, seed=args.seed)
    _release(torch, "phase 13")
    train = phase_train(torch, seed=args.seed, drill=drill)
    _release(torch, "phase 14")
    dryrun = phase_dryrun(torch, seed=args.seed, dryrun=dry)
    _release(torch, "phase 15")
    train_mesh = phase_train_mesh(torch, seed=args.seed, drill=mesh_drill)
    _release(torch, "phase 16")
    # launches: each kernel on the path that runs it — the synthetic serve
    # for the serving kernels, the quantize run for ldlq and kron_mul, the
    # hadamard linear for hadamard; phases 7's to 10's paths beside them
    paths = {"serve": served["launches"], "quantize": quant["launches"],
             "hadamard_linear": quant["hadamard_launches"],
             "serve_quantized": quant["serve_launches"], **dense,
             **lifecycle, **speculative, **observe, **tp, **frontdoor,
             **families, **train, **dryrun, **train_mesh}
    main_path = {"ldlq": "quantize", "kron_mul": "quantize",
                 "hadamard": "hadamard_linear"}
    kernels = []
    for name, rep in reps.items():
        kernels.append({
            "name": name, "route": "cuda",
            "source": str(_build.SOURCES[FAMILY.get(name, name)]
                          .relative_to(ROOT)),
            "replaces": REPLACES[name],
            "launches": paths[main_path.get(name, "serve")][name],
            "max_abs_err": rep["max_abs_err"], "ms": rep["ms"],
            "plain_ms": rep["plain_ms"], "bound_ms": rep["bound_ms"],
            "bound_by": rep["bound_by"], "library_ms": rep["library_ms"],
            "case": rep["case"],
            **{k: rep[k] for k in ("codes_differ_frac", "fused_ms",
                                   "plain_fused_ms", "library_fp32_ms",
                                   "terms", "decode", "prefill",
                                   "dense_widths", "tp_rank", "families")
               if k in rep},
            "launches_by_path": {p: c[name] for p, c in paths.items()},
        })
    shutil.rmtree(WORK_DIR, ignore_errors=True)
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f}s")
    print(dev["smi"])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
