#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py            # one CUDA card; exits nonzero on any failure

Phases, each printing its own lines:

  1. device  — the card's name, its ``nvidia-smi`` name and power limit, and
     the torch / CUDA versions;
  2. build   — compile every CUDA kernel of the serving path from the
     sources in this checkout (``torch.utils.cpp_extension.load``, one
     compiler process per source, in parallel);
  3. kernels — each kernel's launch wrapper, and the public wrapper the
     serving path calls (``ops.py``: epilogue, self-token merge, layouts),
     against its plain PyTorch version at ``qwen3-14b`` shapes and at
     ragged ones, with the error beside its stated tolerance, the kernel's median time over CUDA events, the plain
     version's time, the time of one library call computing the same
     function (``torch.matmul`` on the dequantized bf16 weight, SDPA on
     gathered dense K/V — yardsticks only, never called by the port) and
     the least time the card could take (bytes over 3.35 TB/s or
     operations over the fp32 peak, whichever is larger);
  4. serve   — a seeded synthetic 2-bit ``qwen3-14b`` artifact at full width
     and depth, saved with the port's store and loaded back (SHA-256
     checked), served through the engine with ``--paged --paged-prefill``:
     8 requests of prompt 128 and gen 32 submitted at fixed engine ticks
     (four at once, then one every other tick), kernel launch counts read
     around the run;
  5. check   — every emitted position re-run teacher-forced through the
     recompute oracle (``QuantizedModel.logits`` on the plain paths, on
     the card) and compared with the engine's logits.

The next-to-last line is a JSON record of the kernels; the last line is
``{"ok": true, "device": {...}}``, printed only when every phase passed.
Nothing of JAX or of the ``repro`` package is imported.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import shutil
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_S = 3.35e12  # H100 SXM device memory rate
FP32_FLOP_S = 67e12  # H100 SXM fp32 outside the tensor cores
L2_BYTES = 50 * 2**20
WORK_DIR = ROOT / "build" / "chip_smoke"

# stated tolerances (see the checks below for what each bounds)
EPS32 = 2.0**-24  # fp32 unit roundoff
BF16_ULP = 2.0**-7  # one bf16 unit in the last place, relative to |value|
ATTN_ATOL = 1e-4  # attention outputs, fp32 both sides
# engine vs recompute oracle logits, bf16 over 40 layers: about twice the
# largest max |diff| (0.1191) and mean |diff| (0.0170) read on correct runs
LOGIT_ATOL = 0.25
LOGIT_MEAN_ATOL = 0.035

# quant_matmul (K, M, B, bits): the qwen3-14b projections at decode (B 1,
# 8) and prefill (64, 512) rows; 3 and 4 bits; and ragged shapes -- K
# ending in a partial packed word, M not a multiple of the 256-column tile,
# B not a multiple of the row block
QMM_CASES = (
    [(K, M, B, 2) for (K, M) in ((5120, 5120), (5120, 1024), (5120, 17408),
                                 (17408, 5120))
     for B in (1, 8, 64, 512)]
    + [(5120, 5120, 8, 3), (5120, 5120, 8, 4)]
    + [(5121, 1000, 5, bits) for bits in (2, 3, 4)]
    + [(17, 300, 3, 8)]
)

def log(msg: str) -> None:
    print(msg, flush=True)


class Timer:
    """Median time of a callable over CUDA events, with the L2 cache
    flushed before every repetition (the serving path finds weights and
    pages cold)."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(2 * L2_BYTES, dtype=torch.uint8,
                                 device="cuda")

    def __call__(self, fn, reps: int = 20, warmup: int = 3) -> float:
        torch = self.torch
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


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    tb, to = n_bytes / HBM_BYTES_S * 1e3, n_ops / FP32_FLOP_S * 1e3
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
    from repro_torch.kernels.quant_matmul import ops as qmm_ops
    from repro_torch.kernels.quant_matmul.kernel import quant_matmul_kernel
    from repro_torch.kernels.quant_matmul.ref import (
        grid_matmul_ref,
        quant_matmul_ref,
    )

    g = torch.Generator(device="cuda")
    g.manual_seed(11)
    rep = None
    worst = 0.0
    for K, M, B, bits in QMM_CASES:
        maxq = 2**bits - 1
        codes = torch.randint(0, maxq + 1, (M, K), generator=g,
                              device="cuda", dtype=torch.int32)
        packed = packing.pack(codes, bits)
        x = torch.randn(B, K, generator=g, device="cuda")
        # the kernel: fp32 sums in any order, |err| <= K eps sum_k |x_k q_k|
        bound = K * EPS32 * grid_matmul_ref(x.abs(), packed, bits, K)
        ok, err = True, 0.0
        for xin in (x, x.to(torch.bfloat16)):
            got = quant_matmul_kernel(xin, packed, bits=bits)
            d = (got - grid_matmul_ref(xin.float(), packed, bits, K)).abs()
            ok = ok and bool((d <= bound).all())
            err = max(err, float(d.max()))
        # the wrapper (kernel + affine epilogue) with fp32 activations, as
        # QuantizedLinear calls it, against the plain dequantize-then-matmul:
        # the kernel's sum scaled by 2s/maxq (2K eps), the row sum (K eps)
        # and the plain matmul (K eps), each times s sum|x|, plus 8 roundings
        s_ = torch.tensor(1.3 / K**0.5, device="cuda")
        dz = (qmm_ops.quant_matmul(x, packed, bits, K, s_, maxq)
              - quant_matmul_ref(x, packed, bits, K, s_, maxq)).abs()
        wbound = (4 * K + 8) * EPS32 * s_ * x.abs().sum(-1, keepdim=True)
        ok_w = bool((dz <= wbound).all())
        t_k = timer(lambda: quant_matmul_kernel(x, packed, bits=bits))
        t_p = timer(lambda: grid_matmul_ref(x, packed, bits, K))
        W = codes.to(torch.bfloat16)
        xb = x.to(torch.bfloat16)
        t_l = timer(lambda: torch.matmul(xb, W.T))
        Kp = packed.shape[0]
        n_bytes = B * K * 4 + Kp * M * 4 + B * M * 4
        bms, by = bound_ms(n_bytes, 2.0 * B * K * M)
        worst = max(worst, err)
        log(f"[kernel] quant_matmul K={K} M={M} B={B} bits={bits}: "
            f"max_abs_err={err:.3e} (bound max {float(bound.max()):.3e}, "
            f"fp32 and bf16 x) {'OK' if ok else 'FAIL'}; ops.quant_matmul "
            f"max_abs_err={float(dz.max()):.3e} (bound max "
            f"{float(wbound.max()):.3e}) {'OK' if ok_w else 'FAIL'}"
            f" | kernel {t_k:.4f} ms, plain {t_p:.4f} ms, "
            f"library(bf16 matmul) {t_l:.4f} ms, bound {bms:.4f} ms ({by})")
        if not (ok and ok_w):
            raise AssertionError(f"quant_matmul disagrees at K={K} M={M} "
                                 f"B={B} bits={bits}")
        if (K, M, B, bits) == (5120, 17408, 8, 2):
            rep = dict(case="K=5120 M=17408 B=8 bits=2 (decode mlp.wi)",
                       ms=t_k, plain_ms=t_p, library_ms=t_l, bound_ms=bms,
                       bound_by=by)
    rep["max_abs_err"] = worst
    return rep


def _pool(torch, g, *, kind, L=2, B=8, Pa=128, ps=16, KV=8, hd=128):
    P = B * Pa + 1
    shape = (L, P, ps, KV, hd)
    if kind == "int8":
        kp = torch.randint(-127, 128, shape, generator=g, device="cuda",
                           dtype=torch.int8)
        vp = torch.randint(-127, 128, shape, generator=g, device="cuda",
                           dtype=torch.int8)
        ks = torch.rand(shape[:-1], generator=g, device="cuda") * 0.02 + 1e-3
        vs = torch.rand(shape[:-1], generator=g, device="cuda") * 0.02 + 1e-3
    else:
        dt = torch.bfloat16 if kind == "bf16" else torch.float32
        kp = torch.randn(shape, generator=g, device="cuda").to(dt)
        vp = torch.randn(shape, generator=g, device="cuda").to(dt)
        ks = vs = None
    # every lane gets distinct physical pages (physical != logical order)
    perm = torch.randperm(P - 1, generator=g, device="cuda") + 1
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


def decode_cases(torch, timer) -> dict:
    import torch.nn.functional as F

    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.paged_attention.kernel import paged_attention_kernel
    from repro_torch.kernels.paged_attention.ref import (
        paged_attention_stats_ref,
        paged_gqa_decode_ref,
    )

    g = torch.Generator(device="cuda")
    g.manual_seed(12)
    B, KV, G, hd, ps, Pa, layer = 8, 8, 5, 128, 16, 128, 1
    ctx_list = [0, 1, 17, 100, 511, 1000, 1500, 2048]
    ctx = torch.tensor(ctx_list, dtype=torch.int32, device="cuda")
    rep, worst = None, 0.0
    for kind in ("bf16", "fp32", "int8"):
        kp, vp, ks, vs, bt = _pool(torch, g, kind=kind, B=B, Pa=Pa, ps=ps,
                                   KV=KV, hd=hd)
        q = torch.randn(B, KV, G, hd, generator=g, device="cuda")
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
        worst = max(worst, err)
        # the wrapper as the adapter calls it: (B, H, hd) queries and the
        # token's own K/V in the model dtype, the self token merged in
        dt = _model_dtype(torch, kind)
        qh = q.reshape(B, KV * G, hd).to(dt)
        k_new = torch.randn(B, KV, hd, generator=g, device="cuda").to(dt)
        v_new = torch.randn(B, KV, hd, generator=g, device="cuda").to(dt)
        w_err, w_ok = _within(
            torch, pa_ops.paged_gqa_decode(qh, k_new, v_new, kp, vp, bt, ctx,
                                           **kw),
            paged_gqa_decode_ref(qh, k_new, v_new, kp, vp, bt, ctx, **kw))
        t_k = timer(lambda: paged_attention_kernel(q, kp, vp, bt, ctx, **kw))
        t_p = timer(lambda: paged_attention_stats_ref(q, kp, vp, bt, ctx,
                                                      **kw))
        kd, vd = _dense_kv(torch, kp, vp, ks, vs, bt, layer)
        S = kd.shape[1]
        qs = q.reshape(B, KV * G, 1, hd).to(torch.bfloat16)
        kt, vt = kd.transpose(1, 2), vd.transpose(1, 2)  # (B, KV, S, hd)
        mask = (torch.arange(S, device="cuda")[None, :] < ctx[:, None])
        mask = mask[:, None, None, :]
        t_l = timer(lambda: F.scaled_dot_product_attention(
            qs, kt, vt, attn_mask=mask, enable_gqa=True))
        n_bytes = (q.numel() * 4 + _kv_bytes(ctx_list, KV, hd, kind)
                   + o.numel() * 4 + 2 * m.numel() * 4 + bt.numel() * 4)
        n_ops = 4.0 * sum(ctx_list) * KV * G * hd
        bms, by = bound_ms(n_bytes, n_ops)
        ok = err <= ATTN_ATOL and empty_ok and w_ok
        log(f"[kernel] paged_decode {kind} pages B={B} KV={KV} G={G} hd={hd} "
            f"ps={ps} ctx={ctx_list}: max_abs_err={err:.3e} (tol "
            f"{ATTN_ATOL}) empty-lane {'OK' if empty_ok else 'FAIL'}; "
            f"ops.paged_gqa_decode ({str(dt)[6:]} q/k/v) max_abs_err="
            f"{w_err:.3e} (tol {ATTN_ATOL}"
            f"{' + 1 bf16 ulp' if dt == torch.bfloat16 else ''}) "
            f"{'OK' if ok else 'FAIL'} | kernel {t_k:.4f} ms, plain "
            f"{t_p:.4f} ms, library(SDPA dense) {t_l:.4f} ms, bound "
            f"{bms:.4f} ms ({by})")
        if not ok:
            raise AssertionError(f"paged_decode ({kind}) disagrees")
        if kind == "bf16":
            rep = dict(case=f"bf16 pages B=8 ctx={ctx_list}", ms=t_k,
                       plain_ms=t_p, library_ms=t_l, bound_ms=bms,
                       bound_by=by)
    rep["max_abs_err"] = worst
    return rep


def prefill_cases(torch, timer) -> dict:
    import torch.nn.functional as F

    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.paged_attention.kernel import paged_prefill_kernel
    from repro_torch.kernels.paged_attention.ref import (
        paged_gqa_prefill_ref,
        paged_prefill_grouped_ref,
    )

    g = torch.Generator(device="cuda")
    g.manual_seed(13)
    B, KV, G, C, hd, ps, Pa, layer = 8, 8, 5, 64, 128, 16, 64, 0
    ctx_list = [0, 16, 64, 100, 128, 300, 777, 1024]
    ctx = torch.tensor(ctx_list, dtype=torch.int32, device="cuda")
    rep, worst = None, 0.0
    for kind in ("bf16", "fp32", "int8"):
        kp, vp, ks, vs, bt = _pool(torch, g, kind=kind, B=B, Pa=Pa, ps=ps,
                                   KV=KV, hd=hd)
        dt = _model_dtype(torch, kind)
        q = torch.randn(B, KV, G, C, hd, generator=g, device="cuda")
        kc = torch.randn(B, C, KV, hd, generator=g, device="cuda").to(dt)
        vc = torch.randn(B, C, KV, hd, generator=g, device="cuda").to(dt)
        for self_ in (False, True):
            kw = dict(layer=layer, k_scale=ks, v_scale=vs)
            if self_:
                kw["k_self"] = (kc.float() + 0.1 * torch.randn(
                    kc.shape, generator=g, device="cuda")).to(dt)
                kw["v_self"] = (vc.float() + 0.1 * torch.randn(
                    vc.shape, generator=g, device="cuda")).to(dt)
            got = paged_prefill_kernel(q, kc, vc, kp, vp, bt, ctx, **kw)
            want = paged_prefill_grouped_ref(q, kc, vc, kp, vp, bt, ctx, **kw)
            err = float((got - want).abs().max())
            worst = max(worst, err)
            # the wrapper as the adapter calls it: (B, C, H, hd) queries
            # in the model dtype
            qh = q.permute(0, 3, 1, 2, 4).reshape(B, C, KV * G, hd).to(dt)
            w_err, w_ok = _within(
                torch, pa_ops.paged_gqa_prefill(qh, kc, vc, kp, vp, bt, ctx,
                                                **kw),
                paged_gqa_prefill_ref(qh, kc, vc, kp, vp, bt, ctx, **kw))
            t_k = timer(lambda: paged_prefill_kernel(q, kc, vc, kp, vp, bt,
                                                     ctx, **kw))
            t_p = timer(lambda: paged_prefill_grouped_ref(q, kc, vc, kp, vp,
                                                          bt, ctx, **kw))
            kd, vd = _dense_kv(torch, kp, vp, ks, vs, bt, layer)
            S = kd.shape[1]
            kall = torch.cat([kd, kc.to(torch.bfloat16)], 1).transpose(1, 2)
            vall = torch.cat([vd, vc.to(torch.bfloat16)], 1).transpose(1, 2)
            qs = q.reshape(B, KV * G, C, hd).to(torch.bfloat16)
            m_ctx = (torch.arange(S, device="cuda")[None, :] < ctx[:, None])
            m_ctx = m_ctx[:, None, :].expand(B, C, S)
            causal = torch.tril(torch.ones(C, C, dtype=torch.bool,
                                           device="cuda"))
            mask = torch.cat([m_ctx, causal.expand(B, C, C)], -1)[:, None]
            t_l = timer(lambda: F.scaled_dot_product_attention(
                qs, kall, vall, attn_mask=mask, enable_gqa=True))
            n_chunk = kc.numel() * kc.element_size() * (4 if self_ else 2)
            n_bytes = (q.numel() * 4 + _kv_bytes(ctx_list, KV, hd, kind)
                       + n_chunk + got.numel() * 4 + bt.numel() * 4)
            n_ops = sum(4.0 * G * C * hd * KV * (c + (C + 1) / 2)
                        for c in ctx_list)
            bms, by = bound_ms(n_bytes, n_ops)
            ok = err <= ATTN_ATOL and w_ok
            case = kind + (" +self" if self_ else "")
            log(f"[kernel] paged_prefill {case} pages B={B} C={C} KV={KV} "
                f"G={G} hd={hd} ctx={ctx_list}: max_abs_err={err:.3e} (tol "
                f"{ATTN_ATOL}); ops.paged_gqa_prefill ({str(dt)[6:]} q/k/v) "
                f"max_abs_err={w_err:.3e} (tol {ATTN_ATOL}"
                f"{' + 1 bf16 ulp' if dt == torch.bfloat16 else ''}) "
                f"{'OK' if ok else 'FAIL'} | kernel {t_k:.4f} "
                f"ms, plain {t_p:.4f} ms, library(SDPA dense) {t_l:.4f} ms, "
                f"bound {bms:.4f} ms ({by})")
            if not ok:
                raise AssertionError(f"paged_prefill ({case}) disagrees")
            if kind == "bf16" and not self_:
                rep = dict(case=f"bf16 pages B=8 C=64 ctx={ctx_list}",
                           ms=t_k, plain_ms=t_p, library_ms=t_l,
                           bound_ms=bms, bound_by=by)
    rep["max_abs_err"] = worst
    return rep


def phase_kernels(torch) -> dict:
    timer = Timer(torch)
    reps = {
        "quant_matmul": qmm_cases(torch, timer),
        "paged_decode": decode_cases(torch, timer),
        "paged_prefill": prefill_cases(torch, timer),
    }
    del timer
    torch.cuda.empty_cache()
    return reps


# ---------------------------------------------------------------------------
# phase 4 + 5: serve the full model, then check it
# ---------------------------------------------------------------------------


def _counts():
    from repro_torch.kernels.paged_attention import kernel as pa
    from repro_torch.kernels.quant_matmul import kernel as qmm

    return {**qmm.COUNTS, **pa.COUNTS}


def _reset_counts():
    from repro_torch.kernels.paged_attention import kernel as pa
    from repro_torch.kernels.quant_matmul import kernel as qmm

    for d in (qmm.COUNTS, pa.COUNTS):
        for k in d:
            d[k] = 0


def phase_serve(torch, *, seed: int, layers: int) -> dict:
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import make_calibration
    from repro_torch.launch.serve import build_engine
    from repro_torch.serve.adapter import CachedDecoder
    from repro_torch.serve.artifacts import load_quantized, save_quantized
    from repro_torch.serve.synthetic import QUIP_CONFIG, synthetic_quantized_model

    cfg = get_config("qwen3-14b")
    if layers != cfg.n_layers:
        log(f"[serve] DEPTH CUT: {layers} of {cfg.n_layers} layers "
            f"(full width kept)")
        cfg = dataclasses.replace(cfg, n_layers=layers)
    t0 = time.perf_counter()
    qm = synthetic_quantized_model(cfg, seed=seed, device="cuda")
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
    qm, meta = load_quantized(art, device="cuda", verify=True)
    torch.cuda.synchronize()
    log(f"[serve] artifact {n_bytes / 1e9:.2f} GB saved in {t_save:.1f}s, "
        f"loaded back with SHA-256 verified in "
        f"{time.perf_counter() - t0:.1f}s ({path})")

    args = argparse.Namespace(slots=8, page_size=16, pages=None,
                              token_budget=512, prefill_chunk=64, paged=True,
                              paged_prefill=True)
    # request i is submitted just before engine tick arrive[i]: a burst of
    # four (one batched prefill), then one joining every other tick while
    # the others decode.  Arrivals count ticks, not wall-clock time, so
    # every run schedules the same ticks and launches the same kernels.
    prompt_len, gen = 128, 32
    arrive = (0, 0, 0, 0, 3, 5, 7, 9)
    n_req = len(arrive)
    prompts = make_calibration(cfg.vocab, n_segments=n_req,
                               seg_len=prompt_len, seed=seed + 3)
    adapter = CachedDecoder.from_quantized(qm)
    engine = build_engine(adapter, max_seq_len=prompt_len + gen, args=args,
                          record_logits=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    decode_ticks = []
    reqs = []
    engine.reset_clock()
    t0 = time.perf_counter()
    tick = 0
    while len(reqs) < n_req or not engine.idle:
        while len(reqs) < n_req and arrive[len(reqs)] <= tick:
            reqs.append(engine.submit(prompts[len(reqs)], max_new=gen,
                                      arrival=engine.now()))
        before = _counts()
        engine.tick()
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
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing}")

    # ---- phase 5: teacher-forced recompute oracle on the plain paths ----
    t0 = time.perf_counter()
    seqs = np.stack([np.concatenate([prompts[i], r.out_tokens[:-1]])
                     for i, r in enumerate(reqs)]).astype(np.int64)
    with torch.no_grad():
        want = qm.logits(torch.as_tensor(seqs, device="cuda"))
        want = want[:, prompt_len - 1:].float()  # (n_req, gen, V)
    got = torch.as_tensor(np.stack([np.stack(r.step_logits) for r in reqs]),
                          device="cuda").float()
    if got.shape != want.shape:
        raise AssertionError(f"logits {tuple(got.shape)} vs oracle "
                             f"{tuple(want.shape)}")
    finite = bool(torch.isfinite(got).all())
    diff = (got - want).abs()
    max_diff = float(diff.max())
    mean_diff = float(diff.mean())
    rms = float(want.pow(2).mean().sqrt())
    toks = torch.as_tensor(np.stack([r.out_tokens for r in reqs]),
                           device="cuda")
    # greedy: every emitted token is the argmax of the engine's own logits
    own = bool((toks == torch.argmax(got, -1)).all())
    # a token may differ from the oracle's argmax only where the logit
    # error explains it: oracle top-2 margin below twice the max |diff|
    top2 = torch.topk(want, 2, dim=-1).values
    margin = top2[..., 0] - top2[..., 1]
    flips = toks != torch.argmax(want, -1)
    n_flips = int(flips.sum())
    unexplained = int((flips & (margin >= 2 * max_diff)).sum())
    log(f"[check] {got.shape[0] * got.shape[1]} positions teacher-forced "
        f"through the recompute oracle in {time.perf_counter() - t0:.1f}s: "
        f"logit max |diff| {max_diff:.4f} (tol {LOGIT_ATOL}), mean |diff| "
        f"{mean_diff:.5f} (tol {LOGIT_MEAN_ATOL}), oracle logit rms "
        f"{rms:.3f}; tokens are "
        f"the argmax of the engine's logits: {'yes' if own else 'NO'}; "
        f"tokens that differ from the oracle argmax: {n_flips} (all at a "
        f"top-2 margin < 2 x max |diff|: "
        f"{'yes' if unexplained == 0 else 'NO'})")
    if (not finite or max_diff > LOGIT_ATOL or mean_diff > LOGIT_MEAN_ATOL
            or not own or unexplained):
        raise AssertionError("engine logits disagree with the oracle")
    profile_decode(torch, adapter, args, prompts)
    return {"launches": launches, "tok_s": total / wall}


def profile_decode(torch, adapter, args, prompts, ticks: int = 3) -> None:
    """Where a decode tick's time goes: ``torch.profiler`` over a few
    decode-only ticks of a second, short workload (8 lanes, all prefilled
    first).  Reports device-busy time against wall time and the kernels
    launched per tick."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.serve import build_engine

    engine = build_engine(adapter, max_seq_len=prompts.shape[1] + ticks + 2,
                          args=args)
    reqs = [engine.submit(p, max_new=ticks + 2) for p in prompts]
    while any(not r.out_tokens for r in reqs):
        engine.tick()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(ticks):
            engine.tick()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / ticks
    engine.run()
    dev = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in dev) / 1e6 / ticks
    n = sum(e.count for e in dev) / ticks
    if not dev or busy == 0:
        log("[profile] decode tick: device time not measured (the profiler "
            "recorded no CUDA kernels)")
        return
    log(f"[profile] decode tick (8 lanes, ctx ~{prompts.shape[1]}): wall "
        f"{wall * 1e3:.1f} ms, device busy {busy * 1e3:.1f} ms (idle share "
        f"{1 - busy / wall:.0%}), {n:.0f} kernels per tick")
    for e in sorted(dev, key=lambda e: -e.self_device_time_total)[:6]:
        log(f"[profile]   {e.self_device_time_total / 1e3 / ticks:8.2f} ms "
            f"{e.count / ticks:6.0f}x  {e.key[:90]}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--layers", type=int, default=40,
                    help="depth of the served qwen3-14b (width is never cut)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        log("[device] torch.cuda.is_available() is False: this smoke run "
            "needs a CUDA card")
        return 2
    from repro_torch.kernels import _build  # fails outside a checkout

    dev = phase_device(torch)
    phase_build()
    reps = phase_kernels(torch)
    served = phase_serve(torch, seed=args.seed, layers=args.layers)
    replaces = {
        "quant_matmul": "src/repro/kernels/quant_matmul/kernel.py:60",
        "paged_decode": "src/repro/kernels/paged_attention/kernel.py:164",
        "paged_prefill": "src/repro/kernels/paged_attention/kernel.py:389",
    }
    sources = {
        "quant_matmul": _build.SOURCES["quant_matmul"],
        "paged_decode": _build.SOURCES["paged_attention"],
        "paged_prefill": _build.SOURCES["paged_attention"],
    }
    kernels = []
    for name, rep in reps.items():
        kernels.append({
            "name": name, "route": "cuda",
            "source": str(sources[name].relative_to(ROOT)),
            "replaces": replaces[name],
            "launches": served["launches"][name],
            "max_abs_err": rep["max_abs_err"], "ms": rep["ms"],
            "plain_ms": rep["plain_ms"], "bound_ms": rep["bound_ms"],
            "bound_by": rep["bound_by"], "library_ms": rep["library_ms"],
            "case": rep["case"],
        })
    shutil.rmtree(WORK_DIR / "artifact", ignore_errors=True)
    print(dev["smi"])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
