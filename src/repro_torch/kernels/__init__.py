"""Hand-written CUDA kernels for Hopper (sm_90a) and their plain versions.

Each kernel package follows the JAX package's three-file convention:
``kernel.py`` (launch wrapper of the CUDA source in ``csrc/``, with its
launch count), ``ops.py`` (the public wrapper: dispatch by device, padding
and epilogues) and ``ref.py`` (the plain PyTorch version).  A CUDA tensor
always goes to the kernel; only a CPU tensor takes the plain version.
"""

_FAMILIES = ("quant_matmul", "paged_attention", "ldlq", "kron_mul", "hadamard")


def _count_dicts():
    import importlib

    return [importlib.import_module(f"repro_torch.kernels.{f}.kernel").COUNTS
            for f in _FAMILIES]


def launch_counts() -> dict:
    """Launches of every CUDA kernel so far, by kernel name."""
    out = {}
    for d in _count_dicts():
        out.update(d)
    return out


def reset_counts() -> None:
    """Set every kernel's launch count to 0."""
    for d in _count_dicts():
        for k in d:
            d[k] = 0
