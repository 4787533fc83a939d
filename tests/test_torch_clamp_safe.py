"""Algorithm 5 (clamp-safe rounding, Theorem 7) on the port.

The five property tests of ``tests/test_clamp_safe.py``, on the same
Hessians and the Fig. 4 counterexample, through ``repro_torch``; the
stochastic draws come from a ``torch.Generator``, so they are tested by
property, not against ``jax.random``.  The deterministic solve is also held
to the JAX package's: the same H, the port in float64 and in float32, the
JAX package in float32 (its solve casts H to float32), after 300 projected
gradient steps: max |ΔL| <= 2e-3 (|L| <= 1 on these Hessians; each step's
fp32 rounding is carried into the next) and the objectives tr(H LᵀL)
within 1e-4 relative.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import make_hessian

from repro.core.clamp_safe import solve_clamp_safe_L as jax_solve
from repro_torch.core.clamp_safe import clamp_safe_round, solve_clamp_safe_L
from repro_torch.core.ldlq import ldl_decomposition, ldlq
from repro_torch.core.proxy import proxy_loss

L_ATOL = 2e-3
OBJ_RTOL = 1e-4


def H_(n, **kw) -> torch.Tensor:
    return torch.from_numpy(np.array(make_hessian(n, **kw),
                                     dtype=np.float32))


def _counterexample(n=64, d=16, c=0.01):
    H = np.ones((n, n)) + np.eye(n)
    H[n - 1, n - 1] = 1.0
    H[0, 1:n - 1] += 2 * c
    H[1:n - 1, 0] += 2 * c
    H[0, n - 1] += c
    H[n - 1, 0] += c
    H[0, 0] += 4 * c + n * c**2
    W = 0.499 * np.ones((d, n)) + 0.002 * (np.arange(n) % 2)
    return (torch.from_numpy(W.astype(np.float32)),
            torch.from_numpy(H.astype(np.float32)))


def test_solution_is_feasible_unit_upper():
    H = H_(48, seed=1)
    c = 0.3
    L = solve_clamp_safe_L(H, c)
    n = H.shape[0]
    np.testing.assert_allclose(np.diag(L.numpy()), np.ones(n), atol=1e-5)
    assert float(torch.max(torch.abs(torch.tril(L, -1)))) < 1e-6
    col_sq = np.sum(L.numpy() ** 2, axis=0)
    assert col_sq.max() <= 1 + c + 1e-4


def test_large_c_recovers_ldl():
    """With the constraint slack, the optimum is the LDL factor."""
    H = H_(32, seed=2, damp=1e-1)
    L = solve_clamp_safe_L(H, c=1e6, iters=500)
    Udot, _ = ldl_decomposition(H)
    Lres = (L @ (torch.eye(32) + Udot)).numpy()
    np.testing.assert_allclose(Lres, np.eye(32), atol=5e-2)


def test_objective_no_worse_than_projected_start():
    H = H_(40, seed=3)
    L = solve_clamp_safe_L(H, 0.2, iters=400)
    obj = float(torch.trace(H @ L.T @ L))
    # identity L is always feasible: the solver must beat or match it
    assert obj <= float(torch.trace(H)) * 1.0001


def test_beats_clamped_ldlq_on_counterexample():
    """Fig. 4 / Thm 7: where clamping breaks LDLQ, Algorithm 5 survives."""
    W, H = _counterexample()
    maxq = 15
    Udot, _ = ldl_decomposition(H)
    l_ldlq = float(proxy_loss(ldlq(W, Udot, maxq), W, H))
    g = torch.Generator().manual_seed(0)
    l_safe = float(proxy_loss(clamp_safe_round(W, H, maxq, g, c=0.1), W, H))
    assert l_safe < l_ldlq * 0.25, (l_safe, l_ldlq)


def test_rounded_weights_stay_in_range():
    W, H = _counterexample()
    out = clamp_safe_round(W, H, 15, torch.Generator().manual_seed(1),
                           c=0.1).numpy()
    assert out.min() >= 0.0 and out.max() <= 15.0
    assert set(np.unique(out)) <= set(float(v) for v in range(16))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n,seed,c", [(48, 1, 0.3), (40, 3, 0.2)])
def test_solve_matches_jax(n, seed, c, dtype):
    H = np.asarray(make_hessian(n, seed=seed), dtype=np.float64)
    want = np.asarray(jax_solve(jnp.asarray(H, jnp.float32), c),
                      dtype=np.float64)
    got = solve_clamp_safe_L(torch.from_numpy(H).to(dtype), c)
    assert got.dtype == dtype
    got = got.double().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=L_ATOL)

    def obj(L):
        return float(np.trace(H @ L.T @ L))

    assert abs(obj(got) - obj(want)) <= OBJ_RTOL * obj(want)


def test_rounding_is_seeded_and_unbiased():
    """One generator seed, one result; the stochastic Q is unbiased, so the
    mean code over many draws tracks the fed-back target on a diagonal H
    (U = 0: no feedback, each code a plain stochastic rounding of W)."""
    W = torch.full((2000, 4), 2.3)
    H = torch.eye(4)
    a = clamp_safe_round(W, H, 3, torch.Generator().manual_seed(7))
    b = clamp_safe_round(W, H, 3, torch.Generator().manual_seed(7))
    assert torch.equal(a, b)
    assert set(a.unique().tolist()) == {2.0, 3.0}
    assert abs(float(a.mean()) - 2.3) < 0.03
