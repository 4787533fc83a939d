"""Port parity: incoherence preprocessing (Algorithm 1) and the Kronecker
and Hadamard kernels' plain versions.

The port draws its transforms from a ``torch.Generator`` (their bits
cannot match ``jax.random``), so the parity tests hand
``incoherence_preprocess`` the JAX package's own factors
(``torch_parity.reference_transforms``); the port's own construction is
checked for what it must be: orthogonal, seeded, shaped as the reference's.
The plain kron_mul and hadamard versions are held against the JAX
package's Pallas kernels in interpret mode.  Tolerance: fp32, atol 1e-5
on O(1) values (different summation orders only).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import make_hessian, make_weights
from torch_parity import reference_transforms

from repro.core import incoherence as ref_inc
from repro.kernels.hadamard import ops as ref_had
from repro.kernels.kron_mul import ops as ref_kron
from repro_torch.core import incoherence as inc
from repro_torch.kernels.hadamard import hadamard_kernel, hadamard_transform
from repro_torch.kernels.hadamard.ref import hadamard_dense_ref
from repro_torch.kernels.kron_mul import kron_mul, kron_mul_kernel
from repro_torch.kernels.kron_mul.ref import kron_mul_dense_ref

ATOL = 1e-5


def T(a):
    return torch.from_numpy(np.array(a))


def _close(got: torch.Tensor, want, atol=ATOL, rtol=0.0):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol,
                               atol=atol)


# ---------------------------------------------------------------------------
# kron_mul and hadamard plain versions vs the Pallas kernels (interpret)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("p,q,N", [(8, 16, 5), (32, 32, 3), (4, 34, 9)])
def test_kron_mul_matches_pallas_interpret(p, q, N):
    rng = np.random.default_rng(p * q)
    x = rng.standard_normal((N, p * q)).astype(np.float32)
    A = np.linalg.qr(rng.standard_normal((p, p)))[0].astype(np.float32)
    B = np.linalg.qr(rng.standard_normal((q, q)))[0].astype(np.float32)
    want = ref_kron.kron_mul(jnp.asarray(x), jnp.asarray(A), jnp.asarray(B),
                             interpret=True)
    _close(kron_mul_kernel(T(x), T(A), T(B)), want)
    _close(kron_mul(T(x).reshape(N, 1, p * q), T(A), T(B)).reshape(N, -1),
           want)
    _close(kron_mul_dense_ref(T(x), T(A), T(B)), want)


def test_kron_mul_p1_and_errors():
    x = torch.randn(3, 13)
    B = torch.linalg.qr(torch.randn(13, 13))[0]
    _close(kron_mul(x, None, B), kron_mul_dense_ref(x, None, B).numpy())
    with pytest.raises(ValueError, match="feature dim"):
        kron_mul_kernel(torch.zeros(2, 10), torch.eye(2), torch.eye(4))
    with pytest.raises(ValueError, match="square"):
        kron_mul_kernel(torch.zeros(2, 8), torch.zeros(2, 3), torch.eye(4))


@pytest.mark.parametrize("n,N", [(64, 7), (1024, 4), (256, 17)])
def test_hadamard_matches_pallas_interpret(n, N):
    rng = np.random.default_rng(n + N)
    x = rng.standard_normal((N, n)).astype(np.float32)
    s = np.where(rng.random(n) < 0.5, -1.0, 1.0).astype(np.float32)
    want = ref_had.hadamard_transform(jnp.asarray(x), jnp.asarray(s),
                                      interpret=True)
    _close(hadamard_kernel(T(x), T(s)), want)
    _close(hadamard_transform(T(x).reshape(N, 1, n), T(s)).reshape(N, n),
           want)
    _close(hadamard_dense_ref(T(x), T(s)), want)
    # the transpose S H x / sqrt(n) undoes H S x / sqrt(n)
    back = hadamard_transform(hadamard_transform(T(x), T(s)), T(s),
                              transpose=True)
    _close(back, x)


@pytest.mark.parametrize("n", [0, 1, 12, 100])
def test_hadamard_rejects_non_power_of_two(n):
    with pytest.raises(ValueError, match="power of two >= 2"):
        ref_had.hadamard_transform(jnp.zeros((2, n)), jnp.ones((n,)),
                                   interpret=True)
    with pytest.raises(ValueError, match="power of two >= 2"):
        hadamard_transform(torch.zeros(2, n), torch.ones(n))


# ---------------------------------------------------------------------------
# the port's own transforms
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind,n,permute", [
    ("kronecker", 96, True), ("kronecker", 13, False),
    ("hadamard", 48, True), ("hadamard", 64, False), ("none", 10, True),
])
def test_make_transform_construction(kind, n, permute):
    t = inc.seeded_transform(kind, n, 7, permute=permute, device="cpu")
    r = ref_inc.make_transform(kind, n, 7, permute=permute)
    for key in ("A", "B", "signs", "perm"):
        a, b = getattr(r, key), getattr(t, key)
        assert (a is None) == (b is None), key
        if a is not None:
            assert tuple(b.shape) == tuple(np.asarray(a).shape), key
    x = torch.randn(4, n)
    y = inc.apply_transform(t, x)
    _close(torch.linalg.norm(y, dim=-1), torch.linalg.norm(x, dim=-1).numpy(),
           atol=1e-4)
    _close(inc.apply_transform(t, y, inverse=True), x.numpy(), atol=1e-5)
    if t.signs is not None:
        assert set(t.signs.tolist()) <= {-1.0, 1.0}
    if t.perm is not None:
        assert sorted(t.perm.tolist()) == list(range(n))
    again = inc.seeded_transform(kind, n, 7, permute=permute,
                                 device="cpu")
    for key, val in t.tensors().items():
        assert torch.equal(val, again.tensors()[key])


def test_hadamard_transform_needs_even_dim():
    with pytest.raises(ValueError, match="even dim"):
        inc.seeded_transform("hadamard", 15, 0, device="cpu")
    with pytest.raises(ValueError, match="needs a torch.Generator"):
        inc.make_transform("kronecker", 8, None)


# ---------------------------------------------------------------------------
# Algorithm 1 with the reference's factors injected
# ---------------------------------------------------------------------------


def test_preprocess_pieces_match_reference():
    W = np.asarray(make_weights(32, 64, seed=1))
    H = np.asarray(make_hessian(64, seed=1))
    Wr, Hr, D = inc.diag_rescale(T(W), T(H))
    rW, rH, rD = ref_inc.diag_rescale(jnp.asarray(W), jnp.asarray(H))
    _close(D, rD, rtol=1e-6)
    _close(Wr, rW, rtol=1e-6)
    _close(Hr, rH, rtol=1e-5)
    s = inc.quant_range(T(W), 2.4)
    np.testing.assert_allclose(float(s), float(ref_inc.quant_range(
        jnp.asarray(W), 2.4)), rtol=1e-6)
    _close(inc.to_grid(T(W), s, 3),
           ref_inc.to_grid(jnp.asarray(W), jnp.float32(float(s)), 3),
           rtol=1e-6)
    np.testing.assert_allclose(float(inc.mu_weight(T(W))),
                               float(ref_inc.mu_weight(jnp.asarray(W))),
                               rtol=1e-5)
    np.testing.assert_allclose(float(inc.mu_hessian(T(H))),
                               float(ref_inc.mu_hessian(jnp.asarray(H))),
                               rtol=1e-3)


@pytest.mark.parametrize("kind", ["kronecker", "hadamard"])
@pytest.mark.parametrize("rescale,spectrum", [(True, True), (False, False)])
def test_incoherence_preprocess_matches_reference(kind, rescale, spectrum):
    W = np.asarray(make_weights(48, 96, seed=2))
    H = np.asarray(make_hessian(96, seed=2))
    kw = dict(bits=2, seed=5, kind=kind, rescale=rescale,
              spectrum_range=spectrum)
    rWg, rHt, rst = ref_inc.incoherence_preprocess(
        jnp.asarray(W), jnp.asarray(H), **kw)
    Wg, Ht, st = inc.incoherence_preprocess(
        T(W), T(H), transforms=reference_transforms, **kw)
    scale = float(np.max(np.abs(np.asarray(rHt))))
    _close(Wg, rWg, atol=1e-4)
    _close(Ht, rHt, atol=2e-6 * scale)
    np.testing.assert_allclose(float(st.s), float(rst.s), rtol=1e-5)
    assert (st.D is None) == (rst.D is None)
    if st.D is not None:
        _close(st.D, rst.D, rtol=1e-6)
    # Algorithm 2 reverts Algorithm 1 (up to the grid scale's rounding)
    back = inc.incoherence_postprocess(Wg, st)
    want = ref_inc.incoherence_postprocess(rWg, rst)
    _close(back, want, atol=1e-5)
    _close(back, W, atol=1e-5)
