"""Port parity: the kernels' plain PyTorch versions (what the port runs on
the CPU) vs the JAX package's Pallas kernels in interpret mode, on the
same numpy inputs, plus the operand checks.  The CUDA kernels themselves
are held against these plain versions on the card by ``chip_smoke.py``.

Tolerance: atol 2e-5 at fp32 (different summation orders only).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention import kernel as ref_pa_kernel
from repro.kernels.paged_attention import ops as ref_pa
from repro.kernels.quant_matmul import kernel as ref_qmm_kernel
from repro.kernels.quant_matmul import ops as ref_qmm
from repro_torch.core import packing
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels.quant_matmul import ops as qmm
from repro_torch.kernels.quant_matmul.kernel import quant_matmul_kernel

ATOL = 2e-5
T = torch.from_numpy


def _close(got: torch.Tensor, want, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=atol)


# ---------------------------------------------------------------------------
# quant_matmul
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bits", [2, 3, 4])
@pytest.mark.parametrize("B,M,K", [(1, 48, 160), (5, 130, 96), (130, 40, 33)])
def test_quant_matmul_matches_interpret_kernel(bits, B, M, K):
    rng = np.random.default_rng(bits * 100 + B)
    maxq = 2**bits - 1
    codes = rng.integers(0, maxq + 1, size=(M, K), dtype=np.int32)
    packed = packing.pack(T(codes), bits)
    x = rng.standard_normal((B, K)).astype(np.float32)
    s = np.float32(0.05)
    want = ref_qmm.quant_matmul(jnp.asarray(x), jnp.asarray(packed.numpy()),
                                bits, K, jnp.float32(s), maxq, interpret=True)
    got = qmm.quant_matmul(T(x), packed, bits, K, torch.tensor(s), maxq)
    _close(got, want)


def test_quant_matmul_kernel_entry_grid_and_errors():
    """The launch wrapper's CPU path is the integer-grid matmul the Pallas
    kernel computes; its named-dimension error fires on the same shape."""
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 4, size=(128, 128), dtype=np.int32)
    packed = packing.pack(T(codes), 2)
    x = rng.standard_normal((8, 128)).astype(np.float32)
    want = ref_qmm_kernel.quant_matmul_kernel(
        jnp.asarray(x), jnp.asarray(packed.numpy()), bits=2, bB=8, bM=128,
        bK=128, interpret=True)
    _close(quant_matmul_kernel(T(x), packed, bits=2), want, atol=1e-4)
    with pytest.raises(ValueError, match="reduction dim") as port:
        quant_matmul_kernel(T(x), packed[:4], bits=2)
    with pytest.raises(ValueError, match="reduction dim") as ref:
        ref_qmm_kernel.quant_matmul_kernel(
            jnp.asarray(x), jnp.asarray(packed.numpy()[:4]), bits=2, bB=8,
            bM=128, bK=128, interpret=True)
    assert str(port.value) == str(ref.value)


# ---------------------------------------------------------------------------
# paged attention
# ---------------------------------------------------------------------------


def _setup(*, L=2, P=9, ps=4, KV=2, G=2, hd=16, B=3, Pa=3, int8=False,
           seed=0):
    rng = np.random.default_rng(seed)
    H = KV * G
    if int8:
        kp = rng.integers(-127, 128, (L, P, ps, KV, hd), dtype=np.int8)
        vp = rng.integers(-127, 128, (L, P, ps, KV, hd), dtype=np.int8)
        ks = (np.abs(rng.standard_normal((L, P, ps, KV))) * 0.02 + 1e-3)
        vs = (np.abs(rng.standard_normal((L, P, ps, KV))) * 0.02 + 1e-3)
        ks, vs = ks.astype(np.float32), vs.astype(np.float32)
    else:
        kp = rng.standard_normal((L, P, ps, KV, hd)).astype(np.float32)
        vp = rng.standard_normal((L, P, ps, KV, hd)).astype(np.float32)
        ks = vs = None
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    kn = (rng.standard_normal((B, KV, hd)) * 0.5).astype(np.float32)
    vn = (rng.standard_normal((B, KV, hd)) * 0.5).astype(np.float32)
    bt = np.stack([rng.permutation(np.arange(1, P))[:Pa]
                   for _ in range(B)]).astype(np.int32)
    return q, kn, vn, kp, vp, bt, ks, vs


def _j(*arrs):
    return [None if a is None else jnp.asarray(a) for a in arrs]


def _t(*arrs):
    return [None if a is None else T(np.ascontiguousarray(a)) for a in arrs]


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("G", [1, 2, 4, 12])
def test_paged_decode_matches_interpret_kernel(int8, G):
    """Ragged contexts with an empty lane, page-straddling lengths; G = 12
    is the group of mistral-large-123b and starcoder2-15b (more rows than
    one CUDA decode block holds)."""
    q, kn, vn, kp, vp, bt, ks, vs = _setup(G=G, int8=int8, seed=G)
    cl = np.array([0, 5, 12], np.int32)
    for layer in (0, 1):
        want = ref_pa.paged_gqa_decode(
            *_j(q, kn, vn, kp, vp, bt, cl), layer=layer,
            k_scale=_j(ks)[0], v_scale=_j(vs)[0], interpret=True)
        got = pa.paged_gqa_decode(
            *_t(q, kn, vn, kp, vp, bt, cl), layer=layer,
            k_scale=_t(ks)[0], v_scale=_t(vs)[0])
        _close(got, want)
        # the kernel's own (o, m, l), empty lane included
        B, H, hd = q.shape
        qg = q.reshape(B, 2, H // 2, hd)
        w = ref_pa_kernel.paged_attention_kernel(
            *_j(qg, kp, vp, bt, cl), layer=layer, k_scale=_j(ks)[0],
            v_scale=_j(vs)[0], interpret=True)
        g = pa.paged_attention_kernel(
            *_t(qg, kp, vp, bt, cl), layer=layer, k_scale=_t(ks)[0],
            v_scale=_t(vs)[0])
        for got_i, want_i in zip(g, w):
            _close(got_i, want_i)
        assert bool((g[1][0] == torch.finfo(torch.float32).min).all())
        assert bool((g[2][0] == 0).all() and (g[0][0] == 0).all())


def test_paged_decode_g12_bf16_pages_matches_interpret_kernel():
    """bf16 pages (the model's pool dtype) at G = 12, both entries."""
    q, kn, vn, kp, vp, bt, _, _ = _setup(G=12, seed=12)
    kp16, vp16 = (jnp.asarray(a, dtype=jnp.bfloat16) for a in (kp, vp))
    tk, tv = (T(a).to(torch.bfloat16) for a in (kp, vp))
    cl = np.array([0, 5, 12], np.int32)
    want = ref_pa.paged_gqa_decode(*_j(q, kn, vn), kp16, vp16, *_j(bt, cl),
                                   layer=1, interpret=True)
    got = pa.paged_gqa_decode(*_t(q, kn, vn), tk, tv, *_t(bt, cl), layer=1)
    _close(got, want)
    B, H, hd = q.shape
    qg = q.reshape(B, 2, H // 2, hd)
    w = ref_pa_kernel.paged_attention_kernel(jnp.asarray(qg), kp16, vp16,
                                             *_j(bt, cl), layer=1,
                                             interpret=True)
    g = pa.paged_attention_kernel(T(qg), tk, tv, *_t(bt, cl), layer=1)
    for got_i, want_i in zip(g, w):
        _close(got_i, want_i)


def _setup_prefill(*, C=4, int8=False, seed=0, G=2):
    q, _, _, kp, vp, bt, ks, vs = _setup(int8=int8, seed=seed, G=G)
    rng = np.random.default_rng(seed + 100)
    B, H, hd = q.shape
    KV = kp.shape[3]
    qc = rng.standard_normal((B, C, H, hd)).astype(np.float32)
    kc = rng.standard_normal((B, C, KV, hd)).astype(np.float32)
    vc = rng.standard_normal((B, C, KV, hd)).astype(np.float32)
    return qc, kc, vc, kp, vp, bt, ks, vs


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("C,self_", [(4, False), (6, False), (4, True)])
def test_paged_prefill_matches_interpret_kernel(int8, C, self_):
    q, kc, vc, kp, vp, bt, ks, vs = _setup_prefill(C=C, int8=int8, seed=C)
    cl = np.array([0, 3, 8], np.int32)
    kself = vself = None
    if self_:
        rng = np.random.default_rng(7)
        kself = (kc + 0.1 * rng.standard_normal(kc.shape)).astype(np.float32)
        vself = (vc + 0.1 * rng.standard_normal(vc.shape)).astype(np.float32)
    # a chunk with the diagonal override is the speculative verifier's call
    ref_op = ref_pa.paged_gqa_verify if self_ else ref_pa.paged_gqa_prefill
    op = pa.paged_gqa_verify if self_ else pa.paged_gqa_prefill
    want = ref_op(
        *_j(q, kc, vc, kp, vp, bt, cl), layer=1, k_scale=_j(ks)[0],
        v_scale=_j(vs)[0], k_self=_j(kself)[0], v_self=_j(vself)[0],
        interpret=True)
    got = op(
        *_t(q, kc, vc, kp, vp, bt, cl), layer=1, k_scale=_t(ks)[0],
        v_scale=_t(vs)[0], k_self=_t(kself)[0], v_self=_t(vself)[0])
    _close(got, want)
    # the kernel entry's grouped layout
    B, _, H, hd = q.shape
    KV = kc.shape[2]
    qg = q.reshape(B, C, KV, H // KV, hd).transpose(0, 2, 3, 1, 4)
    w = ref_pa_kernel.paged_prefill_kernel(
        *_j(qg, kc, vc, kp, vp, bt, cl), layer=1, k_scale=_j(ks)[0],
        v_scale=_j(vs)[0], k_self=_j(kself)[0], v_self=_j(vself)[0],
        interpret=True)
    g = pa.paged_prefill_kernel(
        *_t(qg, kc, vc, kp, vp, bt, cl), layer=1, k_scale=_t(ks)[0],
        v_scale=_t(vs)[0], k_self=_t(kself)[0], v_self=_t(vself)[0])
    _close(g, w)


def _same_error(port_call, ref_call):
    with pytest.raises(ValueError) as port:
        port_call()
    with pytest.raises(ValueError) as ref:
        ref_call()
    assert str(port.value) == str(ref.value)


def test_paged_kernel_operand_errors_match_reference():
    q, kn, vn, kp, vp, bt, *_ = _setup()
    cl = np.array([1, 1, 1], np.int32)
    qg = q.reshape(3, 2, 2, 16)
    qq, _, _, kq, vq, btq, _, _ = _setup(int8=True)
    cases = [
        (qg[:, :1], kp, vp, bt, cl, 0),  # KV mismatch
        (qg, kp, vp, bt, cl, 99),  # layer out of range
        (qg, kp, vp, bt[:2], cl, 0),  # block_tables batch
        (qg, kp, vp, bt, cl[:2], 0),  # ctx_len batch
        (qq.reshape(3, 2, 2, 16), kq, vq, btq, cl, 0),  # int8 sans scales
        (q, kp, vp, bt, cl, 0),  # ungrouped q
    ]
    for qx, k, v, b, c, layer in cases:
        _same_error(
            lambda: pa.paged_attention_kernel(*_t(qx, k, v, b, c),
                                              layer=layer),
            lambda: ref_pa_kernel.paged_attention_kernel(
                *_j(qx, k, v, b, c), layer=layer, interpret=True),
        )


def test_paged_prefill_operand_errors_match_reference():
    q, kc, vc, kp, vp, bt, *_ = _setup_prefill(C=4)
    cl = np.array([1, 1, 1], np.int32)
    B, C, H, hd = q.shape
    KV = kc.shape[2]
    qg = q.reshape(B, C, KV, H // KV, hd).transpose(0, 2, 3, 1, 4)
    qq, kcc, vcc, kq, vq, btq, _, _ = _setup_prefill(int8=True, C=4)
    qqg = qq.reshape(B, C, KV, H // KV, hd).transpose(0, 2, 3, 1, 4)
    cases = [
        (q, kc, vc, kp, vp, bt, 0, None),  # ungrouped q
        (qg, kc[:, :2], vc, kp, vp, bt, 0, None),  # chunk shape
        (qg, kc, vc, kp, vp, bt, 99, None),  # layer
        (qg, kc, vc, kp, vp, bt[:2], 0, None),  # block_tables
        (qqg, kcc, vcc, kq, vq, btq, 0, None),  # int8 sans scales
        (qg, kc, vc, kp, vp, bt, 0, kc),  # k_self without v_self
    ]
    for qx, k1, v1, k, v, b, layer, kself in cases:
        _same_error(
            lambda: pa.paged_prefill_kernel(
                *_t(qx, k1, v1, k, v, b, cl), layer=layer,
                k_self=_t(kself)[0]),
            lambda: ref_pa_kernel.paged_prefill_kernel(
                *_j(qx, k1, v1, k, v, b, cl), layer=layer,
                k_self=_j(kself)[0], interpret=True),
        )
