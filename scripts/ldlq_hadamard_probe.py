#!/usr/bin/env python3
"""Device time of the ldlq and hadamard kernels at the qwen3-14b shapes.

    python3 scripts/ldlq_hadamard_probe.py     # one CUDA card

Builds ldlq.cu and hadamard.cu with their bindings alone, printing
ptxas's registers and spills for every kernel instantiation
(``-Xptxas -v``); runs ``chip_smoke.py``'s ldlq and hadamard cases (the
gates, bit-for-bit checks and event times with the L2 flushed); then
prints the device time per call (``torch.profiler`` over 20 calls) of

- the in-block LDLQ kernel, nb = 128, 2 bits, at M = 1024, 5120 and 17408
  rows, nearest and stochastic, with the host's time to enqueue one call;
- the Hadamard kernel at n = 1024 (N = 136 and 17408 x 17), 128, 2048
  and 16384, both directions;
- ``round_weights('ldlq')`` on the seven linears of one qwen3-14b block
  (the quantize run's "round" phase): wall time, and device time split
  into the in-block kernel, the cross-block matmuls and the rest.

Exits nonzero without a card or when a check fails.
"""
from __future__ import annotations

import collections
import pathlib
import re
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

from scripts.paged_attention_probe import device_ms  # noqa: E402
from scripts.quant_matmul_probe import short  # noqa: E402

NAME = "repro_torch_ldlq_hadamard_probe"
# qwen3-14b's seven linears of one block, (rows m, columns n) of W
BLOCK_LINEARS = {"attn.wq": (5120, 5120), "attn.wk": (1024, 5120),
                 "attn.wv": (1024, 5120), "attn.wo": (5120, 5120),
                 "mlp.wi": (17408, 5120), "mlp.wg": (17408, 5120),
                 "mlp.wo": (5120, 17408)}


def build() -> pathlib.Path:
    """Build ldlq.cu, hadamard.cu and their bindings alone, with ptxas's
    resource report, and point the kernel wrappers at them; returns the
    shared library."""
    import torch
    from torch.utils.cpp_extension import load

    from repro_torch.kernels import _build

    sources = []
    for name in ("ldlq", "hadamard"):
        cu = _build.SOURCES[name]
        sources += [str(cu), str(cu.with_name(f"{name}_binding.cpp"))]
    out = _build.BUILD_DIR.parent / "ldlq_hadamard_probe"
    out.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    load(name=NAME, sources=sources, extra_cflags=_build.CXX_FLAGS,
         extra_cuda_cflags=_build.CUDA_FLAGS + ["-Xptxas=-v"],
         build_directory=str(out), is_python_module=False, verbose=True)
    print(f"[probe] built ldlq.cu and hadamard.cu in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    _build.ops = lambda: torch.ops.repro_torch
    return out / f"{NAME}.so"


def sass_mix(so: pathlib.Path) -> None:
    """The SASS instruction mix of each ldlq kernel instantiation."""
    from torch.utils.cpp_extension import CUDA_HOME

    sass = subprocess.run(
        [str(pathlib.Path(CUDA_HOME or "/usr/local/cuda") / "bin" /
             "cuobjdump"), "-sass", str(so)],
        capture_output=True, text=True).stdout
    ops, name = collections.Counter(), None
    for line in sass.splitlines() + ["Function : end"]:
        if "Function :" in line:
            if name and ops:
                print(f"[probe] {name} SASS: {sum(ops.values())} "
                      "instructions; " + ", ".join(
                          f"{k} {v}" for k, v in ops.most_common(16)),
                      flush=True)
            name = (line.split("Function :")[-1].strip()
                    if "ldlq_rows_kernel" in line else None)
            ops = collections.Counter()
        elif name:
            m = re.match(r"\s*/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?"
                         r"([A-Z0-9_]+)", line)
            if m:
                ops[m.group(1)] += 1


def _line(per: dict) -> str:
    return ", ".join(f"{short(k)[:48]} {v:.4f} ms" for k, v in
                     sorted(per.items(), key=lambda kv: -kv[1]))


def host_ms(torch, fn, n: int = 200) -> float:
    """Host time to enqueue one call (no synchronization inside the run):
    the least event time a call can show while the card keeps up."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3 / n


def ldlq_blocks(torch, cs) -> None:
    from repro_torch.core.ldlq import ldl_decomposition
    from repro_torch.kernels.ldlq.kernel import ldlq_block_kernel

    g = torch.Generator(device=cs.DEV)
    g.manual_seed(18)
    nb, maxq = 128, 3
    Ub = ldl_decomposition(cs._spd_hessian(torch, g, nb))[0].contiguous()
    for M in (1024, 5120, 17408):
        W = torch.rand(M, nb, generator=g, device=cs.DEV) * maxq
        base = torch.randn(M, nb, generator=g, device=cs.DEV)
        noise = torch.rand(M, nb, generator=g, device=cs.DEV)
        per = []
        for name, nz in (("nearest", None), ("stochastic", noise)):
            def fn():
                return ldlq_block_kernel(W, base, Ub, maxq=maxq, noise=nz)
            per.append(f"{name}: {_line(device_ms(torch, fn))}, host "
                       f"{host_ms(torch, fn):.4f} ms per call")
        print(f"[probe] ldlq block M={M} nb={nb} 2-bit: " + "; ".join(per),
              flush=True)


def hadamard_rows(torch, cs) -> None:
    from repro_torch.kernels.hadamard.kernel import hadamard_kernel

    g = torch.Generator(device=cs.DEV)
    g.manual_seed(19)
    for n, N in ((1024, 8 * 17), (1024, 17408 * 17), (128, 4096),
                 (2048, 300), (16384, 64)):
        s = (torch.randint(0, 2, (n,), generator=g, device=cs.DEV) * 2
             - 1).float()
        x = torch.randn(N, n, generator=g, device=cs.DEV)
        per = [f"transpose={tr}: " + _line(device_ms(
                   torch, lambda: hadamard_kernel(x, s, transpose=tr)))
               for tr in (False, True)]
        print(f"[probe] hadamard n={n} N={N}: " + "; ".join(per), flush=True)
        del x


def ldlq_round_split(torch, cs) -> None:
    """round_weights('ldlq') on one block's linears, as phase 6 runs it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.methods import round_weights

    g = torch.Generator(device=cs.DEV)
    g.manual_seed(20)
    hess, total = {}, {"wall": 0.0, "kernel": 0.0, "matmul": 0.0,
                       "other": 0.0}
    for name, (m, n) in BLOCK_LINEARS.items():
        if n not in hess:
            hess[n] = cs._spd_hessian(torch, g, n)
        W = torch.rand(m, n, generator=g, device=cs.DEV) * 3
        round_weights("ldlq", W, hess[n], 3)  # warm-up
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            round_weights("ldlq", W, hess[n], 3)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        split = {"kernel": 0.0, "matmul": 0.0, "other": 0.0}
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA:
                continue
            ms = e.self_device_time_total / 1e3
            key = ("kernel" if "ldlq_" in e.key else
                   "matmul" if "gemm" in e.key.lower() else "other")
            split[key] += ms
        total["wall"] += wall
        for k, v in split.items():
            total[k] += v
        print(f"[probe] round_weights('ldlq') {name} ({m} x {n}): wall "
              f"{wall:.2f} ms; device: in-block kernel {split['kernel']:.2f}"
              f" ms, cross-block matmul {split['matmul']:.2f} ms, other "
              f"{split['other']:.2f} ms", flush=True)
        del W
    print(f"[probe] round_weights('ldlq') per qwen3-14b block (7 linears): "
          f"wall {total['wall']:.1f} ms; device: in-block kernel "
          f"{total['kernel']:.1f} ms, cross-block matmul "
          f"{total['matmul']:.1f} ms, other {total['other']:.1f} ms "
          f"(LDL factorization, copies); host and idle "
          f"{total['wall'] - total['kernel'] - total['matmul'] - total['other']:.1f}"
          f" ms", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("[probe] torch.cuda.is_available() is False: needs a CUDA card")
        return 2
    import chip_smoke as cs

    cs.phase_device(torch)
    sass_mix(build())
    timer = cs.Timer(torch)
    cs.ldlq_cases(torch, timer)
    cs.hadamard_cases(torch, timer)
    del timer
    ldlq_blocks(torch, cs)
    hadamard_rows(torch, cs)
    ldlq_round_split(torch, cs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
