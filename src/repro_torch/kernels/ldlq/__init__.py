from repro_torch.kernels.ldlq.kernel import ldlq_block_kernel
from repro_torch.kernels.ldlq.ops import ldlq
from repro_torch.kernels.ldlq.ref import ldlq_block_ref, ldlq_block_seq_ref

__all__ = [
    "ldlq",
    "ldlq_block_kernel",
    "ldlq_block_ref",
    "ldlq_block_seq_ref",
]
