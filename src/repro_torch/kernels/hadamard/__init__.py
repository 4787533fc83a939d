from repro_torch.kernels.hadamard.kernel import hadamard_kernel
from repro_torch.kernels.hadamard.ops import hadamard_transform
from repro_torch.kernels.hadamard.ref import (
    fwht_ref,
    hadamard_dense_ref,
    hadamard_ref,
    sylvester,
)

__all__ = [
    "hadamard_transform",
    "hadamard_kernel",
    "hadamard_ref",
    "hadamard_dense_ref",
    "fwht_ref",
    "sylvester",
]
