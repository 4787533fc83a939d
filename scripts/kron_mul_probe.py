#!/usr/bin/env python3
"""Device time of the kron_mul kernel at the qwen3-14b transforms.

    python3 scripts/kron_mul_probe.py     # one CUDA card

Builds kron_mul.cu and its binding alone, prints the registers and stack
of every kron_mul kernel instantiation and the instruction mix of the
q = 136 whole-row one, runs ``chip_smoke.py``'s kron_mul
cases (the gate, both fused directions, two launches bit-identical, event
times with the L2 flushed), then, at n = 1024, 5120 and 17408 with 8, 512
and n rows, the device time per call (``torch.profiler`` over 20 calls) of
the kernel entry, the fused forward entry (permutation and D) and the
fused inverse entry (transposed factors, inverse permutation), beside the
plain composition the fused entries replace.  Exits nonzero without a card
or when a check fails.
"""
from __future__ import annotations

import collections
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

from scripts.paged_attention_probe import device_ms  # noqa: E402
from scripts.quant_matmul_probe import short  # noqa: E402


NAME = "repro_torch_kron_probe"


def build() -> pathlib.Path:
    """Build kron_mul.cu and its binding alone (seconds, where the whole
    extension takes minutes) and point the kernel wrappers at it; returns
    the shared library."""
    import time

    import torch
    from torch.utils.cpp_extension import load

    from repro_torch.kernels import _build

    cu = _build.SOURCES["kron_mul"]
    out = _build.BUILD_DIR.parent / "kron_probe"
    out.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    load(name=NAME, sources=[str(cu), str(cu.with_name(
             "kron_mul_binding.cpp"))],
         extra_cflags=_build.CXX_FLAGS, extra_cuda_cflags=_build.CUDA_FLAGS,
         build_directory=str(out), is_python_module=False, verbose=False)
    print(f"[probe] built kron_mul.cu in {time.perf_counter() - t0:.1f}s",
          flush=True)
    _build.ops = lambda: torch.ops.repro_torch
    return out / f"{NAME}.so"


def _cuobjdump(so: pathlib.Path, *args: str) -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    return subprocess.run(
        [str(pathlib.Path(CUDA_HOME or "/usr/local/cuda") / "bin" /
             "cuobjdump"), *args, str(so)],
        capture_output=True, text=True).stdout


def registers(so: pathlib.Path) -> None:
    """Registers and stack of every kron_mul kernel instantiation, and the
    instruction mix of kron_mul_kernel<2, 9> (whole rows of q = 136)."""
    name = None
    for line in _cuobjdump(so, "-res-usage").splitlines():
        if "Function" in line:
            name = line.split("Function")[-1].strip(" :")
        elif name and "kron_mul_kernel" in name:
            regs = re.search(r"REG:(\d+)", line)
            local = re.search(r"STACK:(\d+)", line)
            if regs:
                print(f"[probe] {name[:90]}: registers {regs.group(1)}, "
                      f"stack {local.group(1) if local else '?'} bytes",
                      flush=True)
            name = None
    ops = collections.Counter()
    inside = False
    for line in _cuobjdump(so, "-sass").splitlines():
        if "Function :" in line:
            inside = "kron_mul_kernelILi2ELi9E" in line
        elif inside:
            m = re.match(r"\s*/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+)",
                         line)
            if m:
                ops[m.group(1)] += 1
    print("[probe] kron_mul_kernel<2, 9> SASS mix: " + ", ".join(
        f"{k} {v}" for k, v in ops.most_common(18)), flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("[probe] torch.cuda.is_available() is False: needs a CUDA card")
        return 2
    import chip_smoke as cs
    from repro_torch.core.incoherence import kron_factors, random_orthogonal
    from repro_torch.kernels.kron_mul.kernel import kron_mul_kernel
    from repro_torch.kernels.kron_mul.ref import kron_mul_ref

    cs.phase_device(torch)
    registers(build())
    cs.kron_cases(torch, cs.Timer(torch))
    g = torch.Generator(device=cs.DEV)
    g.manual_seed(17)
    for n in (1024, 5120, 17408):
        p, q = kron_factors(n)
        A = random_orthogonal(p, g, device=cs.DEV)
        B = random_orthogonal(q, g, device=cs.DEV)
        perm = torch.randperm(n, generator=g, device=cs.DEV)
        inv = torch.argsort(perm)
        D = torch.rand(n, generator=g, device=cs.DEV) + 0.5
        fw = dict(perm=perm, inv_perm=inv, scale=D)
        iv = dict(perm=perm, inv_perm=inv, transpose=True)
        for N in (8, 512, n):
            x = torch.randn(N, n, generator=g, device=cs.DEV)
            per = {
                "kernel": device_ms(torch, lambda: kron_mul_kernel(x, A, B)),
                "forward": device_ms(
                    torch, lambda: kron_mul_kernel(x, A, B, **fw)),
                "inverse": device_ms(
                    torch, lambda: kron_mul_kernel(x, A, B, **iv)),
                "plain forward": device_ms(
                    torch, lambda: kron_mul_ref(x, A, B, **fw)),
                "plain inverse": device_ms(
                    torch, lambda: kron_mul_ref(x, A, B, **iv)),
            }
            line = "; ".join(
                f"{tag}: " + ", ".join(f"{short(k)[:70]} {v:.4f} ms"
                                       for k, v in d.items())
                + f" (sum {sum(d.values()):.4f})"
                for tag, d in per.items())
            print(f"[probe] n={n}={p}x{q} N={N}: {line}", flush=True)
            del x
    return 0


if __name__ == "__main__":
    sys.exit(main())
