from repro_torch.kernels.quant_matmul.kernel import quant_matmul_kernel
from repro_torch.kernels.quant_matmul.ops import quant_matmul
from repro_torch.kernels.quant_matmul.ref import grid_matmul_ref, quant_matmul_ref

__all__ = [
    "quant_matmul",
    "quant_matmul_kernel",
    "quant_matmul_ref",
    "grid_matmul_ref",
]
