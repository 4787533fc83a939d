"""Port parity: LDL decomposition, LDLQ, OPTQ, greedy and the rounding
methods, plus the in-block LDLQ kernel's plain version.

Same numpy inputs into the JAX package and the port.  In float64 (``with
jax.enable_x64(True)`` on the reference side) the codes must be equal bit
for bit.  In fp32 the two are the same algorithm in other summation orders,
so a value near a rounding boundary may round the other way and the
feedback carries the flip along its row: the fraction of differing codes is
bounded (2 %, as ``tests/test_ldlq.py::test_optq_equals_ldlq_fp32_tie_noise_bounded``
bounds the reference's own two paths).  The CUDA kernel is held against
the plain version on the card by ``chip_smoke.py``.
"""
from __future__ import annotations

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import make_hessian, make_weights

from repro.kernels.ldlq.kernel import ldlq_block_kernel as ref_block_kernel
from repro.kernels.ldlq.ops import ldlq_pallas
from repro_torch.core import greedy, ldlq, methods
from repro_torch.kernels.ldlq import ops as ldlq_ops
from repro_torch.kernels.ldlq.kernel import ldlq_block_kernel
from repro_torch.kernels.ldlq.ref import ldlq_block_ref

# repro.core re-exports functions under these module names
ref_greedy = importlib.import_module("repro.core.greedy")
ref_ldlq = importlib.import_module("repro.core.ldlq")
ref_methods = importlib.import_module("repro.core.methods")

TIE_FRAC = 0.02


def T(a):
    return torch.from_numpy(np.array(a))


def _grid_problem(m, n, bits, seed, dtype=np.float32):
    """W uniform on the grid's range, an SPD H, and its Udot (numpy)."""
    maxq = 2**bits - 1
    W = np.random.default_rng(seed).random((m, n)) * maxq
    H = np.asarray(make_hessian(n, seed=seed), np.float64)
    return W.astype(dtype), H.astype(dtype), maxq


def test_ldl_decomposition_matches_reference():
    """In float64 (this H's condition number is ~1e6, so fp32 Cholesky
    factors of two libraries differ in their third digit)."""
    H = np.asarray(make_hessian(96, seed=0), np.float64)
    with jax.enable_x64(True):
        Ur, Dr = ref_ldlq.ldl_decomposition(jnp.asarray(H))
        Ur, Dr = np.asarray(Ur), np.asarray(Dr)
    Udot, D = ldlq.ldl_decomposition(T(H))
    np.testing.assert_allclose(Udot.numpy(), Ur, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(D.numpy(), Dr, rtol=1e-9)
    I = torch.eye(96, dtype=torch.float64)
    rec = (Udot + I) @ torch.diag(D) @ (Udot + I).T
    np.testing.assert_allclose(rec.numpy(), H, rtol=1e-9, atol=1e-9)
    assert float(torch.max(torch.abs(torch.tril(Udot)))) == 0.0


@pytest.mark.parametrize("bits", [2, 3, 4])
def test_ldlq_bit_exact_float64(bits):
    """ldlq, ldlq_blocked and optq_reference equal the reference's bit for
    bit in float64, given the same Udot and H."""
    W, H, maxq = _grid_problem(100, 128, bits, seed=2, dtype=np.float64)
    with jax.enable_x64(True):
        Ur, _ = ref_ldlq.ldl_decomposition(jnp.asarray(H))
        Ud = np.asarray(Ur)
        want = np.asarray(ref_ldlq.ldlq(jnp.asarray(W), Ur, maxq))
        want_b = np.asarray(ref_ldlq.ldlq_blocked(jnp.asarray(W), Ur, maxq,
                                                  block=32))
        want_o = np.asarray(ref_ldlq.optq_reference(jnp.asarray(W),
                                                    jnp.asarray(H), maxq))
    assert want.dtype == np.float64
    np.testing.assert_array_equal(ldlq.ldlq(T(W), T(Ud), maxq).numpy(), want)
    np.testing.assert_array_equal(
        ldlq.ldlq_blocked(T(W), T(Ud), maxq, block=32).numpy(), want_b)
    np.testing.assert_array_equal(
        ldlq.optq_reference(T(W), T(H), maxq).numpy(), want_o)
    # Theorem 6 in the port: OPTQ == LDLQ exactly in float64
    np.testing.assert_array_equal(want_o, want)


def test_ldlq_fp32_tie_flips_bounded():
    W, H, maxq = _grid_problem(100, 100, 2, seed=3)
    Ur, _ = ref_ldlq.ldl_decomposition(jnp.asarray(H))
    want = np.asarray(ref_ldlq.ldlq(jnp.asarray(W), Ur, maxq))
    got = ldlq.ldlq(T(W), T(np.asarray(Ur)), maxq).numpy()
    assert np.mean(got != want) < TIE_FRAC


@pytest.mark.parametrize("m,n,block,bits", [(64, 256, 128, 2),
                                            (37, 128, 64, 4),
                                            (100, 96, 32, 3)])
def test_blocked_plain_versions_match_pallas_interpret(m, n, block, bits):
    """The shared blocked schedule over the kernel's plain step, and the
    core blocked LDLQ, against the JAX package's Pallas driver in interpret
    mode."""
    W, H, maxq = _grid_problem(m, n, bits, seed=m)
    Ur, _ = ref_ldlq.ldl_decomposition(jnp.asarray(H))
    want = np.asarray(ldlq_pallas(jnp.asarray(W), Ur, maxq, block=block,
                                  interpret=True))
    Ud = T(np.asarray(Ur))
    for got in (ldlq.blocked_schedule(T(W), Ud, maxq, block=block,
                                      step=ldlq_block_ref),
                ldlq_ops.ldlq(T(W), Ud, maxq, block=block)):
        assert np.mean(got.numpy() != want) < TIE_FRAC
    # on the CPU the ops wrapper is the core blocked LDLQ
    np.testing.assert_array_equal(
        ldlq_ops.ldlq(T(W), Ud, maxq, block=block).numpy(),
        ldlq.ldlq_blocked(T(W), Ud, maxq, block=block).numpy())


@pytest.mark.parametrize("M,nb", [(24, 128), (13, 40)])
def test_block_kernel_plain_version_matches_pallas_interpret(M, nb):
    rng = np.random.default_rng(M)
    Wb = (rng.random((M, nb)) * 3).astype(np.float32)
    base = (0.3 * rng.standard_normal((M, nb))).astype(np.float32)
    Ub = np.triu(0.2 * rng.standard_normal((nb, nb)), 1).astype(np.float32)
    bM = 8 if M % 8 == 0 else M
    Qr, Er = ref_block_kernel(jnp.asarray(Wb), jnp.asarray(base),
                              jnp.asarray(Ub), nb=nb, bM=bM, maxq=3,
                              interpret=True)
    for fn in (ldlq_block_ref, ldlq_block_kernel):
        Q, E = fn(T(Wb), T(base), T(Ub), maxq=3)
        np.testing.assert_array_equal(Q.numpy(), np.asarray(Qr))
        np.testing.assert_array_equal(E.numpy(), np.asarray(Er))
        np.testing.assert_array_equal(E.numpy(), Wb - Q.numpy())


def test_ldlq_wrappers_reject_bad_shapes():
    W = torch.zeros(8, 96)
    with pytest.raises(ValueError, match="multiple of the LDLQ block"):
        ldlq.ldlq_blocked(W, torch.zeros(96, 96), 3, block=64)
    with pytest.raises(ValueError, match="columns but U block"):
        ldlq_block_kernel(torch.zeros(4, 8), torch.zeros(4, 8),
                          torch.zeros(7, 7), maxq=3)
    with pytest.raises(ValueError, match="base"):
        ldlq_block_kernel(torch.zeros(4, 8), torch.zeros(4, 7),
                          torch.zeros(8, 8), maxq=3)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("method", ["near", "ldlq", "greedy", "ldlq_rg"])
def test_deterministic_methods_match_reference(method, dtype):
    """Exactly equal in float64; in fp32 each side factors H with its own
    library, so tie flips are bounded."""
    W = (np.asarray(make_weights(24, 64, seed=6)) * 30 + 1.5).astype(dtype)
    H = np.asarray(make_hessian(64, seed=6)).astype(dtype)
    kw = {"greedy_passes": 3} if method in ("greedy", "ldlq_rg") else {}
    with jax.enable_x64(dtype == np.float64):
        want = np.asarray(ref_methods.round_weights(
            method, jnp.asarray(W), jnp.asarray(H), 3,
            jax.random.PRNGKey(0), **kw))
    assert want.dtype == dtype
    got = methods.round_weights(method, T(W), T(H), 3, None, **kw).numpy()
    if dtype == np.float64:
        np.testing.assert_array_equal(got, want)
    else:
        assert np.mean(got != want) < TIE_FRAC


@pytest.mark.parametrize("n", [131, 7])
def test_ldlq_width_without_block_divisor(n):
    """A column count with no divisor in [8, 128] takes the sequential LDLQ
    on the CPU, as in the JAX package (equal bit for bit in float64); the
    card runs the blocked schedule at that small block instead, which gives
    the same codes."""
    assert methods.pick_block(n) < 8
    W = np.asarray(make_weights(12, n, seed=n), np.float64) * 30 + 1.5
    H = np.asarray(make_hessian(n, seed=n), np.float64)
    with jax.enable_x64(True):
        want = np.asarray(ref_methods.round_weights(
            "ldlq", jnp.asarray(W), jnp.asarray(H), 3, jax.random.PRNGKey(0)))
    got = methods.round_weights("ldlq", T(W), T(H), 3, None)
    np.testing.assert_array_equal(got.numpy(), want)
    Udot, _ = ldlq.ldl_decomposition(T(H))
    b = methods.pick_block(n)
    for step in (ldlq.ldlq_block_step, ldlq_block_ref):
        blocked = ldlq.blocked_schedule(T(W), Udot, 3, block=b, step=step)
        np.testing.assert_array_equal(blocked.numpy(), want)


def test_greedy_pass_matches_reference_float64():
    W = np.asarray(make_weights(16, 48, seed=7), np.float64) * 30 + 1.5
    H = np.asarray(make_hessian(48, seed=7), np.float64)
    with jax.enable_x64(True):
        init = np.asarray(ref_ldlq.quantize_nearest(jnp.asarray(W), 3))
        want = np.asarray(ref_greedy.greedy(jnp.asarray(W), jnp.asarray(H),
                                            3, passes=2,
                                            init=jnp.asarray(init)))
    got = greedy.greedy(T(W), T(H), 3, passes=2, init=T(init)).numpy()
    np.testing.assert_array_equal(got, want)


def test_pick_block_matches_reference():
    for n in (64, 96, 100, 128, 5120, 17408, 13):
        assert methods.pick_block(n) == ref_methods.pick_block(n)


def test_unknown_method_raises():
    with pytest.raises(KeyError, match="unknown rounding method"):
        methods.round_weights("nope", torch.zeros(2, 2), torch.eye(2), 3)
    with pytest.raises(ValueError, match="Generator"):
        methods.round_weights("stoch", torch.zeros(2, 2), torch.eye(2), 3)


def test_stochastic_rounding_unbiased():
    g = torch.Generator().manual_seed(11)
    z = torch.full((40000,), 0.3)
    q = ldlq.quantize_stoch(z, 7, g)
    assert set(q.unique().tolist()) <= {0.0, 1.0}
    assert abs(float(q.mean()) - 0.3) < 0.01


@pytest.mark.parametrize("method", ["stoch", "ldlq_stoch"])
def test_stochastic_methods_unbiased(method):
    """Each code is an unbiased rounding of the value its recurrence feeds
    it: r = val - q has mean ~0, |r| < 1, and rounds up or down (not to
    nearest) a good share of the time.  Also the same generator seed gives
    the same codes."""
    W = np.asarray(make_weights(48, 64, seed=8)) * 20 + 1.5
    H = np.asarray(make_hessian(64, seed=8))
    Wt, Ht = T(W), T(H)
    Udot = ldlq.ldl_decomposition(Ht)[0] if method == "ldlq_stoch" else \
        torch.zeros(64, 64)
    rs = []
    for seed in range(20):
        g = torch.Generator().manual_seed(seed)
        Q = methods.round_weights(method, Wt, Ht, 3, g)
        val = Wt + (Wt - Q) @ Udot
        inside = (val > 0) & (val < 3)  # the clamp makes no rounding
        rs.append((val - Q)[inside])
    r = torch.cat(rs)
    assert float(r.abs().max()) < 1.0
    assert abs(float(r.mean())) < 4 * float(r.std()) / len(r) ** 0.5 + 1e-3
    assert float((r.abs() > 0.5).float().mean()) > 0.1
    g1, g2 = (torch.Generator().manual_seed(5) for _ in range(2))
    assert torch.equal(methods.round_weights(method, Wt, Ht, 3, g1),
                       methods.round_weights(method, Wt, Ht, 3, g2))
