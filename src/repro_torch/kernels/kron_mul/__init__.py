from repro_torch.kernels.kron_mul.kernel import kron_mul_kernel
from repro_torch.kernels.kron_mul.ops import kron_mul
from repro_torch.kernels.kron_mul.ref import kron_mul_dense_ref, kron_mul_ref

__all__ = ["kron_mul", "kron_mul_kernel", "kron_mul_ref", "kron_mul_dense_ref"]
