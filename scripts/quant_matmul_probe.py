#!/usr/bin/env python3
"""Device time of the quant_matmul kernel at the qwen3-14b projections.

    python3 scripts/quant_matmul_probe.py     # one CUDA card

Builds the kernels, prints the registers and spills of every quant_matmul
kernel instantiation, runs ``chip_smoke.py``'s quant_matmul cases (both
gates, two launches bit-identical, event times with the L2 flushed) and its
paged-decode check at G = 12, then, at K x M = 5120 x 17408, 5120 x 5120,
5120 x 1024 and 17408 x 5120 (2-bit) with 1, 8, 64 and 512 rows, the
device time per call of the kernel entry (grid sum) and of the fused entry
``ops.quant_matmul`` (``torch.profiler`` over 20 calls), beside the bf16
``torch.matmul`` on the dequantized W.  Exits nonzero without a card or
when a check fails.
"""
from __future__ import annotations

import pathlib
import re
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

from scripts.paged_attention_probe import device_ms  # noqa: E402


def registers() -> None:
    """Registers and spills of every quant_matmul kernel instantiation
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
        elif name and "qmm_" in name:
            regs = re.search(r"REG:(\d+)", line)
            local = re.search(r"LOCAL:(\d+)", line)
            shared = re.search(r"SHARED:(\d+)", line)
            if regs:
                print(f"[probe] {name[:100]}: registers {regs.group(1)}, "
                      f"spills {local.group(1) if local else '?'} bytes, "
                      f"static shared {shared.group(1) if shared else '?'}")
            name = None


def short(kernel: str) -> str:
    """A kernel's profiler name without its return type and namespace."""
    return re.sub(r"^void (\(anonymous namespace\)::)?", "", kernel)[:40]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("[probe] torch.cuda.is_available() is False: needs a CUDA card")
        return 2
    import chip_smoke as cs
    from repro_torch.core import packing
    from repro_torch.kernels.quant_matmul import ops as qmm_ops
    from repro_torch.kernels.quant_matmul.kernel import quant_matmul_kernel

    cs.phase_device(torch)
    cs.phase_build()
    registers()
    timer = cs.Timer(torch)
    cs.qmm_cases(torch, timer)
    g = torch.Generator(device=cs.DEV)
    g.manual_seed(12)
    for kind in ("bf16", "int8"):
        c = cs._decode_check(torch, g, kind, B=8, KV=8, G=12, hd=128, ps=16,
                             Pa=128, layer=1,
                             ctx_list=[0, 1, 17, 100, 511, 1000, 1500, 2048])
        print(f"[probe] paged_decode {kind} G=12: max_abs_err "
              f"{c['err']:.3e}, fused {c['w_err']:.3e} "
              f"{'OK' if c['ok'] else 'FAIL'}", flush=True)
        if not c["ok"]:
            return 1
        del c
    for K, M in ((5120, 17408), (5120, 5120), (5120, 1024), (17408, 5120)):
        codes = torch.randint(0, 4, (M, K), generator=g, device=cs.DEV,
                              dtype=torch.int32)
        packed = packing.pack(codes, 2)
        W = codes.to(torch.bfloat16)
        s_ = torch.tensor(0.02, device=cs.DEV)
        for B in (1, 8, 64, 512):
            x = torch.randn(B, K, generator=g, device=cs.DEV)
            xb = x.to(torch.bfloat16)
            per = {
                "kernel": device_ms(torch, lambda: quant_matmul_kernel(
                    x, packed, bits=2)),
                "fused": device_ms(torch, lambda: qmm_ops.quant_matmul(
                    x, packed, 2, K, s_, 3)),
                "bf16 matmul": device_ms(torch, lambda: torch.matmul(
                    xb, W.T)),
            }
            line = "; ".join(
                f"{tag} " + ", ".join(f"{short(k)} {v:.4f} ms"
                                      for k, v in d.items())
                for tag, d in per.items())
            print(f"[probe] K={K} M={M} B={B}: {line}", flush=True)
        del W, codes, packed
    return 0


if __name__ == "__main__":
    sys.exit(main())
