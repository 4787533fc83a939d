"""The CUDA Hadamard kernel's stage grouping, written out on the CPU.

``csrc/hadamard.cu`` keeps a row of n <= 2048 in one warp's registers:
lane l holds V values at ``V·(G·i + l) + v``, so the stages over the low
index bits run inside a lane's vector, the next ones as lane shuffles and
the rest across a lane's vectors (at n = 1024: bits 0–1, 2–6, 7–9); wider
rows run the shared-memory butterflies over the whole row.
``hadamard_kernel_order_ref`` writes that data movement out in plain
PyTorch.  It must give ``hadamard_ref``'s bits exactly (the kernel equals
``hadamard_ref`` bit for bit on the card, ``chip_smoke.py`` phase 3), and
agree with the JAX package's Pallas kernel in interpret mode, which sums
in another order (two dense products with Sylvester factors): atol 1e-5
on O(1) values, as ``tests/test_torch_incoherence.py`` states.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.hadamard import ops as ref_had
from repro_torch.kernels.hadamard.ref import (WARP_MAX_N, hadamard_ref,
                                              hadamard_kernel_order_ref,
                                              warp_layout)

ATOL = 1e-5


def _inputs(n: int, N: int):
    rng = np.random.default_rng(7 * n + N)
    x = rng.standard_normal((N, n)).astype(np.float32)
    s = np.where(rng.random(n) < 0.5, -1.0, 1.0).astype(np.float32)
    return x, s


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("n", [2, 128, 1024, 2048, 4096, 8192])
def test_kernel_order_is_plain_version_bit_for_bit(n, transpose):
    x, s = _inputs(n, 9)
    got = hadamard_kernel_order_ref(torch.from_numpy(x), torch.from_numpy(s),
                                    transpose=transpose)
    want = hadamard_ref(torch.from_numpy(x), torch.from_numpy(s),
                        transpose=transpose)
    assert torch.equal(got, want)
    # and with leading dims, as ops.hadamard_transform passes them
    lead = hadamard_kernel_order_ref(torch.from_numpy(x).reshape(3, 3, n),
                                     torch.from_numpy(s),
                                     transpose=transpose)
    assert torch.equal(lead.reshape(9, n), want)


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("n", [2, 128, 1024, 2048, 4096])
def test_kernel_order_matches_pallas_interpret(n, transpose):
    x, s = _inputs(n, 6)
    if transpose:  # S H x / sqrt(n): the Pallas kernel with unit signs
        want = np.asarray(ref_had.hadamard_transform(
            jnp.asarray(x), jnp.ones(n, jnp.float32), interpret=True)) * s
    else:
        want = np.asarray(ref_had.hadamard_transform(
            jnp.asarray(x), jnp.asarray(s), interpret=True))
    got = hadamard_kernel_order_ref(torch.from_numpy(x), torch.from_numpy(s),
                                    transpose=transpose)
    np.testing.assert_allclose(got.numpy(), want, rtol=0.0, atol=ATOL)


@pytest.mark.parametrize("n,layout", [
    (2, (1, 1, 2)), (4, (1, 1, 4)), (64, (1, 16, 4)), (128, (1, 32, 4)),
    (1024, (8, 32, 4)), (2048, (16, 32, 4)),
])
def test_warp_layout_bit_groups(n, layout):
    """(R, G, V): at n = 1024 bits 0–1 in a lane's vector (V = 4), 2–6
    across 32 lanes, 7–9 across 8 vectors; a row never spans warps."""
    R, G, V = warp_layout(n)
    assert (R, G, V) == layout
    assert R * G * V == n and G <= 32 and 32 % G == 0
    assert n <= WARP_MAX_N
