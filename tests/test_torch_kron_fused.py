"""The fused Kronecker entry: permutation, ``D`` rescale, transposed factors,
p = 1 and strided x, checked on the CPU.

``kron_mul(x, A, B, perm=, inv_perm=, scale=, transpose=)`` is one kernel
launch on the card; its plain version must run exactly the operations
``apply_transform`` and ``QuantizedLinear.forward`` ran before the fold
(divide, ``index_select``, ``A·X``, ``·Bᵀ``, ``index_select``), so every
CPU result is bit for bit what it was (``torch.equal``).  The kernel's
permutation scheme — the input written to its permuted place through
``inv_perm`` as it is read in order, the output gathered through
``inv_perm`` (whole rows) or scattered through ``perm`` (column slices) —
is emulated index for index.  Against the JAX package: fp32, atol 1e-5 on
O(1) values (summation orders only).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.kron_mul import ref as jax_kron_ref
from repro_torch.core import incoherence as inc
from repro_torch.kernels.kron_mul import kron_mul, kron_mul_kernel
from repro_torch.kernels.kron_mul.ref import kron_mul_ref

ATOL = 1e-5


def _old_kron(x, A, B):
    """The two-matmul plain version as it was before the fold."""
    p = 1 if A is None else A.shape[0]
    q = B.shape[0]
    lead = x.shape[:-1]
    xm = x.reshape(*lead, p, q)
    if A is not None:
        xm = torch.matmul(A, xm)
    xm = torch.matmul(xm, B.T)
    return xm.reshape(*lead, p * q)


def _old_forward(x, A, B, perm, scale):
    """QuantizedLinear.forward's ``h / D`` then apply_transform's gather."""
    if scale is not None:
        x = x / scale
    if perm is not None:
        x = torch.index_select(x, -1, perm)
    return _old_kron(x, A, B)


def _old_inverse(x, A, B, perm):
    y = _old_kron(x, None if A is None else A.T, B.T)
    if perm is not None:
        y = torch.index_select(y, -1, torch.argsort(perm))
    return y


def _inputs(p, q, N, seed):
    rng = np.random.default_rng(seed)
    n = p * q
    A = (None if p == 1 else
         np.linalg.qr(rng.standard_normal((p, p)))[0].astype(np.float32))
    B = np.linalg.qr(rng.standard_normal((q, q)))[0].astype(np.float32)
    x = rng.standard_normal((N, n)).astype(np.float32)
    perm = rng.permutation(n).astype(np.int64)
    scale = rng.uniform(0.5, 2.0, n).astype(np.float32)
    t = lambda a: None if a is None else torch.from_numpy(a)
    return x, A, B, perm, scale, t


SHAPES = [(1, 13), (4, 6), (8, 16), (3, 5)]


@pytest.mark.parametrize("mode", ["plain", "perm", "perm_scale", "scale",
                                  "inverse", "inverse_perm"])
@pytest.mark.parametrize("p,q", SHAPES)
def test_fused_ref_is_the_old_composition_bit_for_bit(p, q, mode):
    x, A, B, perm, scale, t = _inputs(p, q, 5, seed=p * q)
    tx, tA, tB = t(x), t(A), t(B)
    tp = t(perm) if "perm" in mode else None
    ts = t(scale) if "scale" in mode else None
    if mode.startswith("inverse"):
        want = _old_inverse(tx, tA, tB, tp)
        got = kron_mul_ref(tx, tA, tB, perm=tp, transpose=True)
        inv = None if tp is None else torch.argsort(tp)
        got_k = kron_mul_kernel(tx, tA, tB, perm=tp, inv_perm=inv,
                                transpose=True)
    else:
        want = _old_forward(tx, tA, tB, tp, ts)
        got = kron_mul_ref(tx, tA, tB, perm=tp, scale=ts)
        got_k = kron_mul_kernel(tx, tA, tB, perm=tp, scale=ts)
    assert torch.equal(got, want)
    assert torch.equal(got_k, want)  # a CPU tensor: the plain version
    # the public wrapper on a 3-D view
    got_o = kron_mul(tx.reshape(5, 1, p * q), tA, tB, perm=tp, scale=ts,
                     transpose=mode.startswith("inverse"))
    assert torch.equal(got_o.reshape(5, -1), want)


@pytest.mark.parametrize("p,q", [(8, 16), (32, 32)])
def test_fused_entry_matches_jax(p, q):
    """(A ⊗ B)(x/D)[perm] and P^T (Aᵀ ⊗ Bᵀ) x against the JAX package's
    kron_mul_ref with the gather, division and scatter done in numpy."""
    x, A, B, perm, scale, t = _inputs(p, q, 7, seed=p + q)
    fwd = np.asarray(jax_kron_ref.kron_mul_ref(
        jnp.asarray((x / scale)[:, perm]), jnp.asarray(A), jnp.asarray(B)))
    got = kron_mul(t(x), t(A), t(B), perm=t(perm), scale=t(scale))
    np.testing.assert_allclose(got.numpy(), fwd, rtol=0, atol=ATOL)
    inv = np.empty_like(np.asarray(jax_kron_ref.kron_mul_ref(
        jnp.asarray(x), jnp.asarray(A.T), jnp.asarray(B.T))))
    inv[:, perm] = np.asarray(jax_kron_ref.kron_mul_ref(
        jnp.asarray(x), jnp.asarray(A.T), jnp.asarray(B.T)))
    got = kron_mul(t(x), t(A), t(B), perm=t(perm), transpose=True)
    np.testing.assert_allclose(got.numpy(), inv, rtol=0, atol=ATOL)
    # the inverse undoes the forward (orthogonal factors)
    back = kron_mul(got, t(A), t(B), perm=t(perm))
    np.testing.assert_allclose(back.numpy(), x, rtol=0, atol=ATOL)


# kron_factors of the other dense widths: 6144, 12288, 24576, 28672, 29568
DENSE_SHAPES = [(64, 96), (96, 128), (128, 192), (128, 224), (168, 176)]


def _jax_entry(x, A, B, perm, scale, mode):
    """The entry ``mode`` computed with the JAX package's kron_mul_ref, the
    division, gather and scatter done in numpy."""
    if mode.startswith("inverse"):
        y = np.asarray(jax_kron_ref.kron_mul_ref(
            jnp.asarray(x), jnp.asarray(A.T), jnp.asarray(B.T)))
        if perm is None:
            return y
        out = np.empty_like(y)
        out[:, perm] = y
        return out
    if scale is not None:
        x = x / scale
    if perm is not None:
        x = x[:, perm]
    return np.asarray(jax_kron_ref.kron_mul_ref(
        jnp.asarray(x), jnp.asarray(A), jnp.asarray(B)))


@pytest.mark.parametrize("mode", ["plain", "perm", "perm_scale", "scale",
                                  "inverse", "inverse_perm"])
@pytest.mark.parametrize("p,q", DENSE_SHAPES)
def test_plain_entries_match_jax_at_dense_factors(p, q, mode):
    """Every entry of the plain version (the kernel wrapper on a CPU
    tensor, and the public wrapper) against the JAX package's kron_mul_ref
    at the factor pairs of llama2-70b, mistral-large-123b, qwen2-72b and
    starcoder2-15b: fp32, atol 1e-5 on O(1) values."""
    x, A, B, perm, scale, t = _inputs(p, q, 3, seed=p + 2 * q)
    perm = perm if "perm" in mode else None
    scale = scale if "scale" in mode else None
    kw = dict(perm=t(perm), scale=t(scale),
              transpose=mode.startswith("inverse"))
    want = _jax_entry(x, A, B, perm, scale, mode)
    for fn in (kron_mul_ref, kron_mul_kernel, kron_mul):
        got = fn(t(x), t(A), t(B), **kw)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def test_kernel_limits_match_its_header_and_are_named():
    """The wrapper's limits are the CUDA header's, every dense config's
    factors are inside them, and a factor above them raises the named
    ValueError before anything launches."""
    import pathlib
    import re

    from repro_torch.kernels.kron_mul import kernel as kron_kernel

    h = (pathlib.Path(kron_kernel.__file__).parent / "csrc" /
         "kron_mul.h").read_text()
    assert int(re.search(r"kKronMaxP = (\d+);", h).group(1)) == \
        kron_kernel.MAX_P
    assert int(re.search(r"kKronMaxQ = (\d+);", h).group(1)) == \
        kron_kernel.MAX_Q
    for p, q in DENSE_SHAPES + [(16, 32), (64, 128), (192, 256)]:
        kron_kernel.check_factors(p, q)
    for p, q in ((193, 8), (8, 257), (256, 256)):
        with pytest.raises(ValueError, match=f"kron_mul factors {p} x {q} "
                                             f"exceed the kernel's 192 x 256"):
            kron_kernel.check_factors(p, q)


def test_strided_x_equals_contiguous():
    """A row-strided x (the kernel reads it in place) and a transposed one
    (the binding copies it) give what their contiguous copies give."""
    x, A, B, perm, scale, t = _inputs(4, 6, 24, seed=9)
    wide = torch.from_numpy(np.concatenate([x, x[:, :5]], axis=1))
    rows = wide[:, :24]
    assert rows.stride() == (29, 1)
    want = kron_mul(rows.contiguous(), t(A), t(B), perm=t(perm))
    assert torch.equal(kron_mul(rows, t(A), t(B), perm=t(perm)), want)
    cols = torch.from_numpy(x).T  # (24, 24) with column stride 24
    assert cols.stride() == (1, 24)
    for tr in (False, True):
        assert torch.equal(
            kron_mul(cols, t(A), t(B), perm=t(perm), transpose=tr),
            kron_mul(cols.contiguous(), t(A), t(B), perm=t(perm),
                     transpose=tr))


@pytest.mark.parametrize("p,q", [(1, 13), (8, 16)])
def test_kernel_permutation_scheme(p, q):
    """The kernel's index scheme reproduces the plain version exactly.
    Load: X[inv_perm[j]] = x[j] / scale[j] for j in order.  Store of the
    transposed transform: y[j] = Y[inv_perm[j]] for j in order (whole
    rows), or y[perm[k]] = Y[k] for the slice's k (column slices)."""
    x, A, B, perm, scale, t = _inputs(p, q, 3, seed=p + 2 * q)
    tx, tA, tB, tp, ts = t(x), t(A), t(B), t(perm), t(scale)
    inv = torch.argsort(tp)
    X = torch.empty_like(tx)
    X[:, inv] = tx / ts  # scattered writes of in-order reads
    assert torch.equal(_old_kron(X, tA, tB),
                       kron_mul_ref(tx, tA, tB, perm=tp, scale=ts))
    Y = _old_kron(tx, None if tA is None else tA.T, tB.T)
    want = kron_mul_ref(tx, tA, tB, perm=tp, transpose=True)
    assert torch.equal(Y[:, inv], want)  # gathered, in-order stores
    scattered = torch.empty_like(Y)
    scattered[:, tp] = Y
    assert torch.equal(scattered, want)


def test_apply_transform_is_one_kron_mul_call(monkeypatch):
    """The Kronecker transform, with its permutation and the ``D``
    division, is one ``kron_mul`` call each way — no separate gather or
    division around it — and QuantizedLinear.forward passes ``D`` in."""
    calls = []
    real = inc.kron_mul

    def spy(x, A, B, **kw):
        calls.append(kw)
        return real(x, A, B, **kw)

    monkeypatch.setattr(inc, "kron_mul", spy)
    g = torch.Generator().manual_seed(0)
    tr = inc.make_transform("kronecker", 24, g)
    x = torch.randn(3, 24, generator=g)
    D = torch.rand(24, generator=g) + 0.5
    y = inc.apply_transform(tr, x, scale=D)
    assert torch.equal(y, _old_forward(x, tr.A, tr.B, tr.perm, D))
    z = inc.apply_transform(tr, y, inverse=True)
    assert torch.equal(z, _old_inverse(y, tr.A, tr.B, tr.perm))
    assert [c["transpose"] for c in calls] == [False, True]
    assert all(c["perm"] is tr.perm and c["inv_perm"] is tr.inv_perm
               for c in calls)
    assert calls[0]["scale"] is D and calls[1]["scale"] is None
    # the other kinds divide first, as before
    had = inc.make_transform("hadamard", 24, g)
    assert torch.equal(inc.apply_transform(had, x, scale=D),
                       inc.apply_transform(had, x / D))
    assert torch.equal(inc.apply_transform(inc.OrthogonalTransform(
        "none", 24), x, scale=D), x / D)


def test_scale_of_the_transposed_transform_is_refused():
    x, A, B, perm, scale, t = _inputs(4, 6, 2, seed=1)
    for fn in (kron_mul_ref, kron_mul_kernel, kron_mul):
        with pytest.raises(ValueError, match="forward transform"):
            fn(t(x), t(A), t(B), scale=t(scale), transpose=True)
    g = torch.Generator().manual_seed(0)
    with pytest.raises(ValueError, match="forward transform"):
        inc.apply_transform(inc.make_transform("kronecker", 24, g),
                            t(x), inverse=True, scale=t(scale))
