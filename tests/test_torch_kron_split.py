"""The CUDA kron_mul kernel's precision scheme, checked on the CPU.

A plain-PyTorch emulation of the kernel's arithmetic — both products
``T = X·Bᵀ`` and ``Y = A·T`` as TF32 tensor-core steps of k = 8, each
operand split into ``big = rna(v)`` and ``small = rna(v − big)`` (TF32
rounding to nearest, ties away from zero, as ``cvt.rna.tf32.f32``), three
products ``small·big + big·small + big·big`` per step summed into one fp32
accumulator, T kept in fp32 between the products — is held against the
JAX package's ``kron_mul_ref`` and the port's plain version on the same
numpy inputs, at the three qwen3-14b factor shapes (32 × 32, 64 × 80,
128 × 136) and the widest of the other dense configs (128 × 224 and
168 × 176: d_ff 28672 and 29568), narrowed in N, with random and
all-positive x.  The kernel's rows past p (168 pads to 192) are zeros and
add nothing to any sum, so the emulation leaves them out.

Tolerance: the gate ``chip_smoke.py`` holds the CUDA kernel to on the
card, ``2(p+q+1)·2⁻²⁴·((|A| ⊗ |B|)|x|)`` per element.  The schemes that
were not chosen are recorded against the same gate: bf16 hi + lo splits
read about a quarter of it at 32 × 32, one TF32 product misses it.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.kron_mul import ref as jax_kron_ref
from repro_torch.kernels.kron_mul.ref import kron_mul_ref

EPS32 = 2.0**-24
# kron_factors(1024, 5120, 17408, 28672, 29568)
SHAPES = [(32, 32), (64, 80), (128, 136), (128, 224), (168, 176)]


def tf32_rna(v: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to TF32 (10 stored mantissa bits), to nearest with ties
    away from zero: half a TF32 ulp added to the magnitude bits, the 13 low
    bits cleared."""
    u = v.contiguous().view(torch.int32)
    return ((u + 0x1000) & ~0x1FFF).view(torch.float32)


def split_tf32(v):
    big = tf32_rna(v)
    return big, tf32_rna(v - big)


def split_bf16(v):
    hi = v.to(torch.bfloat16).float()
    return hi, (v - hi).to(torch.bfloat16).float()


def split_one_tf32(v):
    return tf32_rna(v), torch.zeros_like(v)


def _mma3(a, b, split):
    """a (..., M, K) @ b (..., K, N) as the kernel runs it: per k-step of
    8, the three split products in the kernel's order into one fp32
    accumulator."""
    ab, as_ = split(a)
    bb, bs = split(b)
    acc = None
    for k0 in range(0, a.shape[-1], 8):
        k = slice(k0, k0 + 8)
        for x, y in ((as_, bb), (ab, bs), (ab, bb)):
            t = x[..., :, k] @ y[..., k, :]
            acc = t if acc is None else acc + t
    return acc


def emulate(x, A, B, split=split_tf32):
    """(A ⊗ B) x per row of x (N, p q) with the kernel's arithmetic."""
    N, p, q = x.shape[0], A.shape[0], B.shape[0]
    T = _mma3(x.reshape(N, p, q), B.T.contiguous(), split)  # X B^T
    Y = _mma3(A.expand(N, p, p), T, split)  # A T
    return Y.reshape(N, p * q)


def _orth(n, rng):
    g = rng.standard_normal((n, n))
    qm, r = np.linalg.qr(g)
    return (qm * np.sign(np.diag(r))[None, :]).astype(np.float32)


def _inputs(p, q, N, positive, seed):
    rng = np.random.default_rng(seed)
    A, B = _orth(p, rng), _orth(q, rng)
    x = rng.standard_normal((N, p * q)).astype(np.float32)
    if positive:
        x = np.abs(x)
    return x, A, B


def _gate_ratio(got, x, A, B, want):
    """max |got − want| over the gate, elementwise."""
    p, q = A.shape[0], B.shape[0]
    bound = 2 * (p + q + 1) * EPS32 * kron_mul_ref(x.abs(), A.abs(), B.abs())
    return float(((got - want).abs() / bound).max())


@pytest.mark.parametrize("positive", [False, True],
                         ids=["random_x", "positive_x"])
@pytest.mark.parametrize("p,q", SHAPES)
def test_three_tf32_products_meet_gate_with_margin(p, q, positive):
    """3xTF32 stays under 1/50 of the gate against both plain versions."""
    x, A, B = _inputs(p, q, 8, positive, seed=p * q + positive)
    tx, tA, tB = map(torch.from_numpy, (x, A, B))
    got = emulate(tx, tA, tB)
    want_port = kron_mul_ref(tx, tA, tB)
    want_jax = torch.from_numpy(np.array(jax_kron_ref.kron_mul_ref(
        jnp.asarray(x), jnp.asarray(A), jnp.asarray(B))))
    assert _gate_ratio(got, tx, tA, tB, want_port) < 0.02
    assert _gate_ratio(got, tx, tA, tB, want_jax) < 0.02


@pytest.mark.parametrize("positive", [False, True],
                         ids=["random_x", "positive_x"])
def test_bf16_hi_lo_uses_a_quarter_of_the_gate(positive):
    """Why the kernel does not reuse the bf16 hi + lo splits of the
    attention and quant_matmul kernels: at 32 × 32 (the 1024-wide
    projections) they read 0.2–0.4 of the gate, 3xTF32 about 0.01."""
    x, A, B = _inputs(32, 32, 16, positive, seed=32 + positive)
    tx, tA, tB = map(torch.from_numpy, (x, A, B))
    want = kron_mul_ref(tx, tA, tB)
    bf16 = _gate_ratio(emulate(tx, tA, tB, split_bf16), tx, tA, tB, want)
    tf32 = _gate_ratio(emulate(tx, tA, tB), tx, tA, tB, want)
    assert 0.2 < bf16 < 0.4
    assert tf32 < bf16 / 10


def test_one_tf32_product_misses_gate():
    """One rounded TF32 product per multiply–add (what ``allow_tf32``
    gives) misses the gate at 32 × 32."""
    x, A, B = _inputs(32, 32, 8, False, seed=5)
    tx, tA, tB = map(torch.from_numpy, (x, A, B))
    want = kron_mul_ref(tx, tA, tB)
    assert _gate_ratio(emulate(tx, tA, tB, split_one_tf32), tx, tA, tB,
                       want) > 1.0


def test_tf32_split_keeps_22_bits():
    """rna rounds ties away from zero and keeps 10 stored bits; big + small
    is within 2^-22 of v over twelve decades."""
    one = torch.tensor([1.0 + 2.0**-11, -(1.0 + 2.0**-11),
                        1.0 + 2.0**-11 - 2.0**-23], dtype=torch.float32)
    assert tf32_rna(one).tolist() == [1.0 + 2.0**-10, -(1.0 + 2.0**-10), 1.0]
    rng = np.random.default_rng(0)
    v = torch.from_numpy((rng.standard_normal(100_000)
                          * 10.0 ** rng.uniform(-6, 6, 100_000))
                         .astype(np.float32))
    big, small = split_tf32(v)
    assert torch.equal(big, tf32_rna(big)) and torch.equal(small,
                                                           tf32_rna(small))
    assert bool(((v - big - small).abs() <= 2.0**-22 * v.abs()).all())
