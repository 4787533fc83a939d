"""Port parity: repro_torch.core.packing vs repro.core.packing, bit-exact."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import packing as ref
from repro_torch.core import packing


@pytest.mark.parametrize("bits", [2, 3, 4, 8])
@pytest.mark.parametrize("m,n", [(5, 64), (7, 33), (3, 1), (16, 130)])
def test_pack_unpack_bit_exact(bits, m, n):
    """Same words as the reference (n not a multiple of vals included),
    top field of every word set so the unsigned shift is exercised."""
    rng = np.random.default_rng(bits * 1000 + m * 10 + n)
    Wq = rng.integers(0, 2**bits, size=(m, n), dtype=np.int32)
    Wq[:, : min(n, 32 // bits)] = 2**bits - 1  # word 0: every field set
    want = np.asarray(ref.pack(jnp.asarray(Wq), bits))
    got = packing.pack(torch.from_numpy(Wq), bits)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert tuple(got.shape) == packing.packed_shape(m, n, bits)
    assert packing.packed_shape(m, n, bits) == ref.packed_shape(m, n, bits)
    back = packing.unpack(got, bits, n)
    np.testing.assert_array_equal(back.numpy(), Wq)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(ref.unpack(jnp.asarray(want), bits, n)))


def test_unsupported_bits_raise():
    with pytest.raises(ValueError, match="bit width"):
        packing.vals_per_word(5)
