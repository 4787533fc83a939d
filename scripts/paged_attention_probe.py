#!/usr/bin/env python3
"""Device time of the paged-attention kernels, kernel by kernel.

    python3 scripts/paged_attention_probe.py     # one CUDA card

At the phase-3 table cases of ``chip_smoke.py`` (bf16 pages, qwen3-14b
widths): decode at ctx 0..2048 and with a block table of 8192 keys (the
kernel entry and the adapter's fused entry); prefill at prior ctx 0..1024
with and without k_self/v_self, with every lane at 1024 and every lane at
0.  For each it prints the check against the plain version, the device
time of every CUDA kernel per call (``torch.profiler`` over 20 calls) and
the event time of 50 back-to-back calls (no L2 flush), which includes the
host's launch overhead where that is longer than the kernels; first, the
registers and spills of every paged-attention kernel instantiation.  Exits
nonzero without a card or when a check fails.
"""
from __future__ import annotations

import pathlib
import re
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def device_ms(torch, fn, n: int = 20) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / 1e3 / n
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA}


def back_to_back_ms(torch, fn, n: int = 50) -> float:
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def report(torch, tag: str, ok: bool, fn) -> bool:
    per = device_ms(torch, fn)
    kernels = ", ".join(
        f"{re.sub(r'^void \(anonymous namespace\)::', '', k)[:48]} {v:.4f} ms"
        for k, v in sorted(per.items(), key=lambda kv: -kv[1]))
    print(f"[probe] {tag}: check {'OK' if ok else 'FAIL'}; device {kernels}; "
          f"back-to-back {back_to_back_ms(torch, fn):.4f} ms per call",
          flush=True)
    return ok


def registers() -> None:
    """Registers and spills of every paged-attention kernel instantiation
    (``cuobjdump -res-usage`` of the built extension)."""
    import subprocess

    from torch.utils.cpp_extension import CUDA_HOME

    from repro_torch.kernels import _build

    res = subprocess.run(
        [str(pathlib.Path(CUDA_HOME or "/usr/local/cuda") / "bin" /
             "cuobjdump"), "-res-usage",
         str(_build.BUILD_DIR / f"{_build.NAME}.so")],
        capture_output=True, text=True).stdout
    name = None
    for line in res.splitlines():
        if "Function" in line:
            name = line.split("Function")[-1].strip(" :")
        elif name and re.search(r"paged_(prefill|decode)_kernel|merge", name):
            regs = re.search(r"REG:(\d+)", line)
            local = re.search(r"LOCAL:(\d+)", line)
            if regs:
                print(f"[probe] {name[:90]}: registers {regs.group(1)}, "
                      f"spills {local.group(1) if local else '?'} bytes")
            name = None


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("[probe] torch.cuda.is_available() is False: needs a CUDA card")
        return 2
    import chip_smoke as cs
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.paged_attention.kernel import (
        paged_attention_kernel,
        paged_prefill_kernel,
    )

    cs.phase_device(torch)
    cs.phase_build()
    registers()
    g = torch.Generator(device=cs.DEV)
    g.manual_seed(12)
    ok = True
    for ctx_list, Pa in (([0, 1, 17, 100, 511, 1000, 1500, 2048], 128),
                         ([0, 5, 64, 128, 129, 200, 255, 300], 512)):
        c = cs._decode_check(torch, g, "bf16", B=8, KV=8, G=5, hd=128, ps=16,
                             Pa=Pa, layer=1, ctx_list=ctx_list)
        q, kp, vp, bt, ctx, kw = (c[k] for k in ("q", "kp", "vp", "bt", "ctx",
                                                  "kw"))
        tag = f"decode Pa*ps={Pa * 16} ctx={ctx_list}"
        ok &= report(torch, tag, c["ok"], lambda: paged_attention_kernel(
            q, kp, vp, bt, ctx, **kw))
        ok &= report(torch, tag + " fused entry", c["ok"],
                     lambda: pa_ops.paged_gqa_decode(
                         c["qh"], c["k_new"], c["v_new"], kp, vp, bt, ctx,
                         **kw))
    for ctx_list, self_ in (([0, 16, 64, 100, 128, 300, 777, 1024], False),
                            ([0, 16, 64, 100, 128, 300, 777, 1024], True),
                            ([1024] * 8, False), ([0] * 8, False)):
        c = cs._prefill_check(torch, g, "bf16", self_, B=8, KV=8, G=5, C=64,
                              hd=128, ps=16, Pa=64, layer=0,
                              ctx_list=ctx_list)
        q, kc, vc, kp, vp, bt, ctx, kw = (
            c[k] for k in ("q", "kc", "vc", "kp", "vp", "bt", "ctx", "kw"))
        ok &= report(torch, f"prefill C=64 ctx={ctx_list}"
                     f"{' +self' if self_ else ''}", c["ok"],
                     lambda: paged_prefill_kernel(q, kc, vc, kp, vp, bt, ctx,
                                                  **kw))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
