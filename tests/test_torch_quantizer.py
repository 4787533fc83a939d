"""Port parity: incoherence transforms and QuantizedLinear.

The reference's transform factors (``make_transform``, jax.random) are
carried into the port through ``repro_torch.convert`` as numpy arrays; the
port's ``apply_transform``, ``QuantizedLinear.dequantize()`` and
``QuantizedLinear(x)`` must then match the reference at fp32.

The reference objects are extracted as numpy trees by the helpers in
``torch_parity.py``.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import make_hessian, make_weights
from torch_parity import linear_numpy, transform_numpy

from repro.core import incoherence as ref_inc
from repro.core.quantizer import QuipConfig, quantize_layer
from repro_torch import convert
from repro_torch.core import incoherence as inc

RTOL = ATOL = 1e-5


@pytest.mark.parametrize("kind,n,permute", [
    ("kronecker", 96, True), ("kronecker", 96, False),
    ("kronecker", 13, True),  # prime: p = 1, no A factor
    ("hadamard", 48, True), ("hadamard", 64, False),
])
def test_apply_transform_matches_reference(kind, n, permute):
    t_ref = ref_inc.make_transform(kind, n, seed=5, permute=permute)
    t = convert.transform_from_numpy(transform_numpy(t_ref), device="cpu")
    for key in ("A", "B", "signs", "perm"):
        a, b = getattr(t_ref, key), getattr(t, key)
        assert (a is None) == (b is None), key
        if a is not None:
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    x = np.random.default_rng(n).standard_normal((3, 2, n)).astype(np.float32)
    for inverse in (False, True):
        want = np.asarray(ref_inc.apply_transform(t_ref, jnp.asarray(x),
                                                  inverse=inverse))
        got = inc.apply_transform(t, torch.from_numpy(x), inverse=inverse)
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    # orthogonal: T^T T x = x
    back = inc.apply_transform(t, inc.apply_transform(t, torch.from_numpy(x)),
                               inverse=True)
    np.testing.assert_allclose(back.numpy(), x, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("transform", ["kronecker", "hadamard", "none"])
@pytest.mark.parametrize("bits", [2, 3, 4])
def test_quantized_linear_matches_reference(transform, bits):
    W = make_weights(32, 64, seed=bits)
    H = make_hessian(64, seed=bits)
    qcfg = QuipConfig(bits=bits, method="ldlq", transform=transform,
                      incoherence=transform != "none")
    ql_ref, _ = quantize_layer(W, H, qcfg, seed=3, collect_stats=False)
    ql = convert.linear_from_numpy(linear_numpy(ql_ref), device="cpu")
    np.testing.assert_allclose(ql.dequantize().numpy(),
                               np.asarray(ql_ref.dequantize()),
                               rtol=RTOL, atol=ATOL)
    x = np.random.default_rng(bits).standard_normal((2, 5, 64)).astype(
        np.float32)
    for uk in (True, False):
        want = np.asarray(ql_ref(jnp.asarray(x), use_kernel=uk))
        got = ql(torch.from_numpy(x), use_kernel=uk)
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    # the plain path (the oracle's) is the same arithmetic on the CPU
    np.testing.assert_array_equal(ql.dequantize(plain=True).numpy(),
                                  ql.dequantize().numpy())
    np.testing.assert_array_equal(
        ql(torch.from_numpy(x), plain=True).numpy(),
        ql(torch.from_numpy(x), use_kernel=False).numpy())


def test_quantized_linear_rejects_mismatched_packing():
    W = make_weights(16, 32, seed=1)
    H = make_hessian(32, seed=1)
    ql_ref, _ = quantize_layer(W, H, QuipConfig(bits=2), seed=1,
                               collect_stats=False)
    d = linear_numpy(ql_ref)
    d["packed"] = d["packed"][:-1]
    with pytest.raises(ValueError, match="packed weight shape"):
        convert.linear_from_numpy(d, device="cpu")
