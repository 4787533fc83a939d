"""The CUDA in-block LDLQ kernel's summation order, emulated on the CPU.

``ldlq_block_seq_ref`` is the function ``csrc/ldlq.cu`` computes, in its
order: each column's error is pushed into running sums as soon as it is
known, ``val_k = (W_k + base_k) + Σ_{j<k} E_j·U[j, k]`` summed in ascending
j, one fp32 FMA per term (the kernel equals it bit for bit on the card,
``chip_smoke.py`` phase 3).  The FMA is reproduced exactly by ``fma32``
(float64 rounded to odd), checked here against exact rational arithmetic,
where a plain float64 sum rounds twice.  The same numpy inputs go through
the emulation, through the JAX package's Pallas ``ldlq_block_kernel`` in
interpret mode and through the port's plain ``ldlq_block_ref``, which sum
``E·U[:, k]`` in another order.  The gate is ``chip_smoke.py``'s
``_ldlq_near_ties``, for one block: every code of every version is what
its own recurrence gives in float64, except within the fp32 summation
bound ``(nb + 4)·2⁻²⁴·(|W| + |base| + |E|·|U|)`` of a rounding boundary
(x.5, or the drawn uniform); and where two versions differ, the row's
first differing code is such a near-tie (after it, the rows' errors
differ and so do their later codes).
"""
from __future__ import annotations

from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import make_hessian

from repro.kernels.ldlq.kernel import ldlq_block_kernel as pallas_block
from repro_torch.core.ldlq import ldl_decomposition
from repro_torch.kernels.ldlq.ref import (fma32, ldlq_block_ref,
                                          ldlq_block_seq_ref)

EPS32 = 2.0**-24


def _inputs(M: int, nb: int, bits: int, stochastic: bool):
    """W on the grid's range, a cross-block feedback ``base``, the strictly
    upper LDL factor of an SPD proxy Hessian, and uniforms (numpy)."""
    maxq = 2**bits - 1
    rng = np.random.default_rng(1000 * M + 10 * nb + bits)
    W = (rng.random((M, nb)) * maxq).astype(np.float32)
    base = (0.5 * rng.standard_normal((M, nb))).astype(np.float32)
    H = torch.from_numpy(np.asarray(make_hessian(nb, seed=nb), np.float64))
    U = ldl_decomposition(H)[0].numpy().astype(np.float32)
    noise = rng.random((M, nb)).astype(np.float32) if stochastic else None
    return W, base, U, noise, maxq


def _recurrence(W, base, U, Q, maxq, noise):
    """(codes that differ from the float64 recurrence on Q's own errors,
    positions near a rounding boundary), both (M, nb) bool."""
    W, base, U, Q = (np.asarray(a, np.float64) for a in (W, base, U, Q))
    E = W - Q
    val = W + base + E @ U
    tol = (W.shape[1] + 4) * EPS32 * (np.abs(W) + np.abs(base)
                                      + np.abs(E) @ np.abs(U))
    lo = np.floor(val)
    if noise is None:
        want = np.clip(np.round(val), 0, maxq)
        near = np.abs((val - lo) - 0.5) <= tol
    else:
        u = np.asarray(noise, np.float64)
        want = np.clip(lo + (u < val - lo), 0, maxq)
        near = np.abs((val - lo) - u) <= tol
    return want != Q, near


def _check_explained(Q, E, W, base, U, maxq, noise):
    np.testing.assert_array_equal(E, W - Q)
    bad, near = _recurrence(W, base, U, Q, maxq, noise)
    assert not (bad & ~near).any(), "codes away from a tie"
    return near


def _check_differ_at_ties(Q, other, near):
    for r in np.flatnonzero((Q != other).any(axis=1)):
        k = int(np.argmax(Q[r] != other[r]))
        assert near[r, k], f"row {r} first differs at column {k}, no tie"


@pytest.mark.parametrize("stochastic", [False, True])
@pytest.mark.parametrize("bits", [2, 4])
@pytest.mark.parametrize("nb", [1, 37, 128])
@pytest.mark.parametrize("M", [64, 256])
def test_push_order_matches_pallas_and_plain_block(M, nb, bits, stochastic):
    W, base, U, noise, maxq = _inputs(M, nb, bits, stochastic)
    nz = None if noise is None else torch.from_numpy(noise)
    Q, E = (t.numpy() for t in ldlq_block_seq_ref(
        torch.from_numpy(W), torch.from_numpy(base), torch.from_numpy(U),
        maxq=maxq, noise=nz))
    near = _check_explained(Q, E, W, base, U, maxq, noise)
    Qp, Ep = (t.numpy() for t in ldlq_block_ref(
        torch.from_numpy(W), torch.from_numpy(base), torch.from_numpy(U),
        maxq=maxq, noise=nz))
    _check_explained(Qp, Ep, W, base, U, maxq, noise)
    _check_differ_at_ties(Q, Qp, near)
    if not stochastic:  # the Pallas kernel rounds to nearest only
        Qj, Ej = pallas_block(jnp.asarray(W), jnp.asarray(base),
                              jnp.asarray(U), nb=nb, bM=64, maxq=maxq,
                              interpret=True)
        Qj, Ej = np.asarray(Qj), np.asarray(Ej)
        _check_explained(Qj, Ej, W, base, U, maxq, None)
        _check_differ_at_ties(Q, Qj, near)


def test_push_order_row_strided_views():
    """Column slices of a wider W (as ``blocked_schedule`` passes them)
    give the same bits as contiguous copies."""
    W, base, U, noise, maxq = _inputs(64, 37, 2, True)
    wide = np.zeros((64, 80), np.float32)
    wide[:, 5:42] = W
    Wv = torch.from_numpy(wide)[:, 5:42]
    assert not Wv.is_contiguous()
    got = ldlq_block_seq_ref(Wv, torch.from_numpy(base), torch.from_numpy(U),
                             maxq=maxq, noise=torch.from_numpy(noise))
    want = ldlq_block_seq_ref(torch.from_numpy(W), torch.from_numpy(base),
                              torch.from_numpy(U), maxq=maxq,
                              noise=torch.from_numpy(noise))
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _round32(x: Fraction) -> np.float32:
    """x rounded to the nearest fp32, ties to even (exact)."""
    f = np.float32(float(x))
    near = [f, np.nextafter(f, np.float32(np.inf)),
            np.nextafter(f, np.float32(-np.inf))]
    return min(near, key=lambda c: (abs(Fraction(float(c)) - x),
                                    int(np.array(c).view(np.int32)) & 1))


def _fma_cases():
    """Random fp32 triples, and triples whose exact a·b + c lies just off
    an fp32 rounding midpoint by less than a float64 ulp, so that a plain
    float64 sum lands on the midpoint and rounds the wrong way."""
    rng = np.random.default_rng(18)
    a = rng.standard_normal(4000).astype(np.float32)
    b = rng.standard_normal(4000).astype(np.float32)
    c = (rng.standard_normal(4000) * 10.0 ** rng.integers(-8, 3, 4000)
         ).astype(np.float32)
    one = np.float32(1 + 2**-12)  # one·one = 1 + 2^-11 + 2^-24: a midpoint
    hard = [(one, one, np.float32(d)) for d in (2**-80, -2**-80, 2**-60,
                                                -2**-60, 0.0)]
    hard += [(-one, one, np.float32(d)) for d in (2**-80, -2**-80)]
    return (np.concatenate([a, [h[0] for h in hard]]).astype(np.float32),
            np.concatenate([b, [h[1] for h in hard]]).astype(np.float32),
            np.concatenate([c, [h[2] for h in hard]]).astype(np.float32))


def test_fma32_is_correctly_rounded():
    a, b, c = _fma_cases()
    got = fma32(torch.from_numpy(a), torch.from_numpy(b),
                torch.from_numpy(c)).numpy()
    want = np.array([_round32(Fraction(float(x)) * Fraction(float(y))
                              + Fraction(float(z)))
                     for x, y, z in zip(a, b, c)], np.float32)
    np.testing.assert_array_equal(got, want)
    # the plain float64 sum rounds twice and misses the constructed cases
    naive = (a.astype(np.float64) * b + c).astype(np.float32)
    assert (naive != want).any()


@pytest.mark.parametrize("maxq", [1, 3, 15, 255])
def test_kernel_rounding_matches_round_and_clamp(maxq):
    """``csrc/ldlq.cu`` rounds to nearest as ``(x + 1.5·2²³) − 1.5·2²³`` in
    fp32 and then clamps to [0, maxq]: for every x that equals
    ``clamp(round(x), 0, maxq)`` (half to even), the emulation's rounding —
    exactly so for |x| < 2²², and beyond it both sides clamp."""
    rng = np.random.default_rng(maxq)
    big = [s * 2.0**k + d for k in range(20, 41) for s in (1, -1)
           for d in (-0.5, 0.0, 0.5)]
    x = np.concatenate([
        np.arange(-40.0, maxq + 40.0, 0.25),  # ties at every .5
        rng.standard_normal(20000) * 100.0,
        np.nextafter(np.arange(-3.5, maxq + 3.5), np.inf),
        np.nextafter(np.arange(-3.5, maxq + 3.5), -np.inf),
        big, [0.0, -0.0, np.inf, -np.inf],
    ]).astype(np.float32)
    t = torch.from_numpy(x)
    magic = torch.tensor(12582912.0)
    got = torch.clamp((t + magic) - magic, 0, maxq)
    assert torch.equal(got, torch.clamp(torch.round(t), 0, maxq))
