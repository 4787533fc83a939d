"""The CUDA quant_matmul kernel's precision scheme, checked on the CPU.

A plain-PyTorch emulation of the kernel's arithmetic — fp32 x split into
bf16 terms (``kernel.x_terms``: three below K = 1024, else two; one for
bf16 x), exact bf16 codes, fp32 sums, the row
sum and the affine epilogue ``(2s/maxq)·acc − s·Σx`` stored in x's
dtype — is held against the port's plain versions (``ref.py``) and the JAX
package's ``quant_matmul`` on the same numpy inputs, at the qwen3-14b
reduction width K = 5120 (narrowed in M) and at the ragged K = 17, 8-bit
case of ``chip_smoke.py``.

Tolerances: the two gates ``chip_smoke.py`` holds the CUDA kernel to on the
card — the grid sum within ``K·2⁻²⁴·Σ_k|x q|`` and the wrapper within
``(4K+8)·2⁻²⁴·s·Σ_k|x|``.
"""
from __future__ import annotations

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.quant_matmul import ops as ref_qmm
from repro_torch.core import packing
from repro_torch.kernels.quant_matmul import ops as qmm
from repro_torch.kernels.quant_matmul.kernel import (
    quant_matmul_fused,
    quant_matmul_kernel,
    x_terms,
)
from repro_torch.kernels.quant_matmul.ref import (
    grid_matmul_ref,
    quant_matmul_ref,
)

EPS32 = 2.0**-24


def _terms(x: torch.Tensor, n: int) -> list[torch.Tensor]:
    """x (fp32) as n bf16 values (kept fp32), each the rounding of what the
    ones before leave (the kernel's ``split_pair``)."""
    out, r = [], x.clone()
    for _ in range(n):
        h = r.to(torch.bfloat16).float()
        out.append(h)
        r = r - h
    return out


def _emulate(x, packed, bits, K, s, maxq, terms):
    """(grid sum, fused output) as the kernel computes them: one fp32
    product per bf16 term of x with the exact codes, summed in fp32."""
    codes = packing.unpack(packed, bits, K).float()  # (M, K), exact in bf16
    assert torch.equal(codes, codes.to(torch.bfloat16).float())
    acc = sum(t @ codes.T for t in _terms(x.float(), terms))
    rs = x.float().sum(-1, keepdim=True)
    sf = torch.as_tensor(s, dtype=torch.float32)
    z = acc * (2.0 * sf / maxq) - sf * rs
    return acc, z.to(x.dtype)


def _inputs(K, M, B, bits, seed):
    rng = np.random.default_rng(seed)
    maxq = 2**bits - 1
    codes = rng.integers(0, maxq + 1, size=(M, K), dtype=np.int32)
    packed = packing.pack(torch.from_numpy(codes), bits)
    x = torch.from_numpy(rng.standard_normal((B, K)).astype(np.float32))
    s = torch.tensor(1.3 / K**0.5, dtype=torch.float32)
    return x, packed, s, maxq


def _gates(x, packed, bits, K, s, maxq, acc, z):
    """(kernel gate holds, wrapper gate holds) for an emulated result."""
    bound = K * EPS32 * grid_matmul_ref(x.abs(), packed, bits, K)
    d = (acc - grid_matmul_ref(x, packed, bits, K)).abs()
    wbound = (4 * K + 8) * EPS32 * s * x.float().abs().sum(-1, keepdim=True)
    dz = (z.float() - quant_matmul_ref(x, packed, bits, K, s, maxq).float())
    return bool((d <= bound).all()), bool((dz.abs() <= wbound).all())


@pytest.mark.parametrize("K,M,B,bits", [(5120, 48, 8, 2), (5120, 48, 64, 2),
                                        (5121, 40, 5, 3), (17, 300, 3, 8),
                                        (17, 30, 20, 8)])
def test_kernel_split_scheme_meets_both_gates(K, M, B, bits):
    """The kernel's own term count (two from K = 1024, three below) at
    decode rows (B <= 16) and prefill rows, fp32 x."""
    x, packed, s, maxq = _inputs(K, M, B, bits, seed=K + B)
    terms = x_terms(K, x.dtype)
    assert terms == (3 if K < 1024 else 2)
    acc, z = _emulate(x, packed, bits, K, s, maxq, terms)
    assert _gates(x, packed, bits, K, s, maxq, acc, z) == (True, True)
    want_jax = np.asarray(ref_qmm.quant_matmul(
        jnp.asarray(x.numpy()), jnp.asarray(packed.numpy()), bits, K,
        jnp.float32(s.item()), maxq))
    wbound = (4 * K + 8) * EPS32 * float(s) * x.abs().sum(-1, keepdim=True)
    assert bool((torch.from_numpy(np.abs(z.numpy() - want_jax))
                 <= wbound).all())


@pytest.mark.parametrize("K", [5120, 17408])
def test_two_terms_meet_gate_at_main_path_widths(K):
    """Two bf16 terms (the kernel's rule from K = 1024) at both
    reduction widths of the main path, with 16x the gate's margin."""
    x, packed, s, maxq = _inputs(K, 24, 17, 2, seed=K)
    acc, z = _emulate(x, packed, 2, K, s, maxq, 2)
    assert _gates(x, packed, 2, K, s, maxq, acc, z) == (True, True)
    bound = K * EPS32 * grid_matmul_ref(x.abs(), packed, 2, K)
    err = (acc - grid_matmul_ref(x, packed, 2, K)).abs()
    assert bool((err * 16 <= bound).all())


def test_bf16_x_is_one_exact_term():
    x, packed, s, maxq = _inputs(5120, 32, 8, 2, seed=1)
    xb = x.to(torch.bfloat16)
    assert x_terms(5120, torch.bfloat16) == 1
    acc, z = _emulate(xb, packed, 2, 5120, s, maxq, 1)
    assert z.dtype == torch.bfloat16
    assert _gates(xb, packed, 2, 5120, s, maxq, acc, z)[0]


@pytest.mark.parametrize("case", ["K17_8bit_random", "K5120_same_sign"])
def test_one_term_misses_gate(case):
    """fp32 x rounded to one bf16 term misses the kernel's gate: at the
    ragged K = 17, 8-bit case of ``chip_smoke.py`` with random x, and at
    K = 5120 where every x rounds the same way (1 + 3·2^-10 times a
    positive scale: each term loses about 2^-8.4 of itself), while the
    kernel's own term count meets it.  (At K = 5120 with random x the
    rounding errors cancel and one term would pass: the gate is a worst
    case.)"""
    if case == "K17_8bit_random":
        K, B, bits = 17, 3, 8
        x, packed, s, maxq = _inputs(K, 300, B, bits, seed=4)
    else:
        K, B, bits = 5120, 8, 2
        _, packed, s, maxq = _inputs(K, 48, B, bits, seed=5)
        rng = np.random.default_rng(6)
        x = torch.from_numpy(
            ((1 + 3 * 2.0**-10) * 2.0 ** rng.integers(-4, 4, (B, K)))
            .astype(np.float32))
    acc, z = _emulate(x, packed, bits, K, s, maxq, 1)
    assert _gates(x, packed, bits, K, s, maxq, acc, z)[0] is False
    acc, z = _emulate(x, packed, bits, K, s, maxq, x_terms(K, x.dtype))
    assert _gates(x, packed, bits, K, s, maxq, acc, z) == (True, True)
    acc, z = _emulate(x, packed, bits, K, s, maxq, 2)
    assert _gates(x, packed, bits, K, s, maxq, acc, z)[0] is (K >= 1024)


def test_three_terms_are_exact():
    """hi + mid + lo reproduces every fp32 x over twelve decades; hi + mid
    leaves at most 2^-16 |x|."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.standard_normal(100_000)
                          * 10.0 ** rng.uniform(-6, 6, 100_000))
                         .astype(np.float32))
    t = _terms(x, 3)
    assert torch.equal(t[0] + t[1] + t[2], x)
    assert bool(((x - t[0] - t[1]).abs() <= 2.0**-16 * x.abs()).all())


def test_entries_keep_their_names_and_meanings():
    """``quant_matmul_kernel`` is still the integer-grid sum (no epilogue)
    and ``ops.quant_matmul`` keeps its name and signature, with the
    epilogue, on the CPU path."""
    x, packed, s, maxq = _inputs(160, 48, 5, 2, seed=3)
    np.testing.assert_array_equal(
        quant_matmul_kernel(x, packed, bits=2).numpy(),
        grid_matmul_ref(x, packed, 2, 160).numpy())
    assert list(inspect.signature(qmm.quant_matmul).parameters) == [
        "x", "packed", "bits", "n", "s", "maxq"]
    want = quant_matmul_ref(x, packed, 2, 160, s, maxq).numpy()
    np.testing.assert_array_equal(
        qmm.quant_matmul(x, packed, 2, 160, s, maxq).numpy(), want)
    np.testing.assert_array_equal(
        quant_matmul_fused(x, packed, 2, s, maxq).numpy(), want)
