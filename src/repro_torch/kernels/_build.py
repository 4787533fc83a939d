"""Build and load the port's hand-written CUDA kernels.

Every kernel directory holds ``csrc/<name>.cu`` (the kernels and their
launch functions, no PyTorch headers), ``csrc/<name>.h`` (the launch
interface) and ``csrc/<name>_binding.cpp`` (the PyTorch operators
``torch.ops.repro_torch.*``, typed by their schemas, on PyTorch's current
stream).  All of them compile into one extension with
``torch.utils.cpp_extension.load``; ninja runs the compilers in parallel,
one process per source.

The extension builds into ``build/torch_ext/`` at the repository root.  The
first call that needs a kernel builds it, and every process on a fresh
machine builds anew.  A failed build raises with the compiler's output —
there is no fallback.
"""
from __future__ import annotations

import functools
import pathlib
import time

__all__ = ["SOURCES", "BUILD_DIR", "NAME", "CUDA_FLAGS", "build", "ops"]

_KERNELS = pathlib.Path(__file__).resolve().parent
BUILD_DIR = _KERNELS.parents[2] / "build" / "torch_ext"
NAME = "repro_torch_kernels"

# kernel family -> its CUDA source (the binding sits beside it)
SOURCES = {
    "quant_matmul": _KERNELS / "quant_matmul" / "csrc" / "quant_matmul.cu",
    "paged_attention": (
        _KERNELS / "paged_attention" / "csrc" / "paged_attention.cu"
    ),
    "ldlq": _KERNELS / "ldlq" / "csrc" / "ldlq.cu",
    "kron_mul": _KERNELS / "kron_mul" / "csrc" / "kron_mul.cu",
    "hadamard": _KERNELS / "hadamard" / "csrc" / "hadamard.cu",
}

# (the C++ standard is PyTorch's own: cpp_extension adds it)
CUDA_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3"]
CXX_FLAGS = ["-O3"]


def _sources() -> list[str]:
    out = []
    for cu in SOURCES.values():
        out += [str(cu), str(cu.with_name(f"{cu.stem}_binding.cpp"))]
    return out


@functools.cache
def build() -> float:
    """Compile (if needed) and load the extension; returns the seconds it
    took.  Raises ``RuntimeError`` with the compiler's output on failure."""
    import torch
    from torch.utils.cpp_extension import load

    if not torch.cuda.is_available():
        raise RuntimeError("the CUDA kernels of repro_torch need a CUDA card")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    load(name=NAME, sources=_sources(), extra_cflags=CXX_FLAGS,
         extra_cuda_cflags=CUDA_FLAGS, build_directory=str(BUILD_DIR),
         is_python_module=False, verbose=False)
    return time.perf_counter() - t0


def ops():
    """``torch.ops.repro_torch`` with the kernels' operators registered,
    building the extension on first use."""
    import torch

    build()
    return torch.ops.repro_torch
