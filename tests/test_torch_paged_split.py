"""The CUDA paged-attention kernels' precision scheme, checked on the CPU.

``ref.py``'s emulation of the kernels' arithmetic — bf16 hi/lo operand
splits on the tensor cores for prefill, fixed 128-key context splits and
their merge with the token's own K/V folded in for decode — is held
against the JAX package's ``paged_gqa_prefill`` / ``paged_gqa_decode`` (its
CPU path) and the port's fp32 plain versions, on the same numpy inputs at
the chip cases' widths (hd 128, G 5), narrowed in batch and context.

Tolerance: ``ATTN_ATOL = 1e-4`` absolute, the gate ``chip_smoke.py`` holds
the kernels to on the card (fp32 on both sides).  A bf16 output adds one
bf16 unit in the last place of the value.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention import ops as ref_pa
from repro_torch.kernels.paged_attention import ref

ATTN_ATOL = 1e-4
KV, G, HD, PS = 2, 5, 128, 16


def _pool(rng, kind, *, L=2, B=3, Pa=13):
    P = B * Pa + 1
    shape = (L, P, PS, KV, HD)
    if kind == "int8":
        kp = rng.integers(-127, 128, shape, dtype=np.int8)
        vp = rng.integers(-127, 128, shape, dtype=np.int8)
        ks = (rng.random(shape[:-1]) * 0.02 + 1e-3).astype(np.float32)
        vs = (rng.random(shape[:-1]) * 0.02 + 1e-3).astype(np.float32)
    else:
        kp = rng.standard_normal(shape).astype(np.float32)
        vp = rng.standard_normal(shape).astype(np.float32)
        ks = vs = None
    bt = np.stack([rng.permutation(np.arange(1, P))[:Pa]
                   for _ in range(B)]).astype(np.int32)
    return kp, vp, ks, vs, bt


def _bf16(x: np.ndarray) -> np.ndarray:
    """x rounded to bf16 values, kept fp32 (exact in both frameworks)."""
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


def _torch(x, kind):
    if x is None:
        return None
    t = torch.from_numpy(np.ascontiguousarray(x))
    return t.to(torch.bfloat16) if kind == "bf16" and t.is_floating_point() \
        else t


def _jax(x, kind):
    if x is None:
        return None
    return jnp.asarray(x, dtype=jnp.bfloat16) if kind == "bf16" \
        else jnp.asarray(x)


def _prefill_inputs(kind, C, self_, seed):
    rng = np.random.default_rng(seed)
    kp, vp, ks, vs, bt = _pool(rng, kind)
    if kind == "bf16":
        kp, vp = _bf16(kp), _bf16(vp)
    B = bt.shape[0]
    q = rng.standard_normal((B, C, KV * G, HD)).astype(np.float32)
    kc = rng.standard_normal((B, C, KV, HD)).astype(np.float32)
    vc = rng.standard_normal((B, C, KV, HD)).astype(np.float32)
    kself = vself = None
    if self_:
        kself = (kc + 0.1 * rng.standard_normal(kc.shape)).astype(np.float32)
        vself = (vc + 0.1 * rng.standard_normal(vc.shape)).astype(np.float32)
    ctx = np.array([0, 37, 200], np.int32)  # ragged, an empty lane
    return q, kc, vc, kself, vself, kp, vp, ks, vs, bt, ctx


def _grouped(q):
    B, C, H, hd = q.shape
    return q.reshape(B, C, KV, H // KV, hd).permute(0, 2, 3, 1, 4)


def _ungrouped(o):
    B, KV_, G_, C, hd = o.shape
    return o.permute(0, 3, 1, 2, 4).reshape(B, C, KV_ * G_, hd)


@pytest.mark.parametrize("kind", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("C,self_", [(16, False), (17, True), (64, False),
                                     (64, True)])
def test_prefill_split_scheme_meets_gate(kind, C, self_):
    """Key tiles of 64 (32 for fp32 pages), 2 or 3 split products each,
    G*C rows not a multiple of the 64-row block at C = 17."""
    (q, kc, vc, kself, vself, kp, vp, ks, vs, bt,
     ctx) = _prefill_inputs(kind, C, self_, seed=C + 7 * self_)
    want_jax = np.asarray(ref_pa.paged_gqa_prefill(
        *(jnp.asarray(a) for a in (q, kc, vc)), _jax(kp, kind),
        _jax(vp, kind), jnp.asarray(bt), jnp.asarray(ctx), layer=1,
        k_scale=_jax(ks, kind), v_scale=_jax(vs, kind),
        k_self=_jax(kself, "fp32"), v_self=_jax(vself, "fp32")),
        dtype=np.float32)
    tq = torch.from_numpy(q)
    args = (torch.from_numpy(kc), torch.from_numpy(vc), _torch(kp, kind),
            _torch(vp, kind), torch.from_numpy(bt), torch.from_numpy(ctx))
    kw = dict(layer=1, k_scale=_torch(ks, kind), v_scale=_torch(vs, kind),
              k_self=_torch(kself, "fp32"), v_self=_torch(vself, "fp32"))
    want = ref.paged_gqa_prefill_ref(tq, *args, **kw)
    got = _ungrouped(ref.paged_prefill_emulated(_grouped(tq), *args, **kw))
    err = float((got - want).abs().max())
    err_jax = float(np.abs(got.numpy() - want_jax).max())
    assert err <= ATTN_ATOL, err
    assert err_jax <= ATTN_ATOL, err_jax


@pytest.mark.parametrize("kind", ["fp32", "bf16"])
def test_prefill_without_split_misses_gate(kind):
    """One bf16 term per operand (no lo part) misses the 1e-4 gate at fp32
    queries: the split is what the gate needs."""
    (q, kc, vc, _, _, kp, vp, ks, vs, bt,
     ctx) = _prefill_inputs(kind, 64, False, seed=3)
    tq = torch.from_numpy(q)
    args = (torch.from_numpy(kc), torch.from_numpy(vc), _torch(kp, kind),
            _torch(vp, kind), torch.from_numpy(bt), torch.from_numpy(ctx))
    want = ref.paged_gqa_prefill_ref(tq, *args, layer=0)
    plain = _ungrouped(ref.paged_prefill_emulated(_grouped(tq), *args,
                                                  layer=0, split=False))
    split = _ungrouped(ref.paged_prefill_emulated(_grouped(tq), *args,
                                                  layer=0))
    assert float((plain - want).abs().max()) > ATTN_ATOL
    assert float((split - want).abs().max()) <= ATTN_ATOL


@pytest.mark.parametrize("kind", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("ctx", [(0, 1, 130), (17, 300, 129)])
def test_decode_splits_and_self_merge_meet_gate(kind, ctx):
    """Fixed 128-key splits (a split boundary at 128 / 129 / 130, and the
    block table's 13 pages = 208 keys far beyond most contexts, an empty
    lane), merged, the token's own K/V folded in by the epilogue formula."""
    rng = np.random.default_rng(sum(ctx) + len(kind))
    kp, vp, ks, vs, bt = _pool(rng, kind, Pa=20)
    if kind == "bf16":
        kp, vp = _bf16(kp), _bf16(vp)
    B = bt.shape[0]
    q = rng.standard_normal((B, KV * G, HD)).astype(np.float32)
    kn = rng.standard_normal((B, KV, HD)).astype(np.float32)
    vn = rng.standard_normal((B, KV, HD)).astype(np.float32)
    cl = np.array(ctx, np.int32)
    want_jax = np.asarray(ref_pa.paged_gqa_decode(
        jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), _jax(kp, kind),
        _jax(vp, kind), jnp.asarray(bt), jnp.asarray(cl), layer=0,
        k_scale=_jax(ks, kind), v_scale=_jax(vs, kind)), dtype=np.float32)
    tq, tkn, tvn = (torch.from_numpy(a) for a in (q, kn, vn))
    pool = (_torch(kp, kind), _torch(vp, kind), torch.from_numpy(bt),
            torch.from_numpy(cl))
    kw = dict(layer=0, k_scale=_torch(ks, kind), v_scale=_torch(vs, kind))
    want = ref.paged_gqa_decode_ref(tq, tkn, tvn, *pool, **kw)
    qg = tq.reshape(B, KV, G, HD)
    o, m, l = ref.decode_splits_emulated(qg, *pool, **kw)
    # the state itself, against the plain version (empty lane exact)
    o_r, m_r, l_r = ref.paged_attention_stats_ref(qg, *pool, **kw)
    live = torch.from_numpy(cl) > 0
    assert bool((m[~live] == ref.NEG).all() and (l[~live] == 0).all()
                and (o[~live] == 0).all())
    assert float((o[live] / l[live] - o_r[live] / l_r[live]).abs().max()) \
        <= ATTN_ATOL
    assert float((m[live] - m_r[live]).abs().max()) <= ATTN_ATOL
    got = ref.fold_self_token(qg, o, m, l, tkn, tvn).reshape(B, KV * G, HD)
    assert float((got - want).abs().max()) <= ATTN_ATOL
    assert float(np.abs(got.numpy() - want_jax).max()) <= ATTN_ATOL


def test_split_bf16_bound():
    """|x - hi - lo| <= 2^-16 |x| over six decades, hi and lo bf16 values."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.standard_normal(100_000)
                          * 10.0 ** rng.uniform(-3, 3, 100_000))
                         .astype(np.float32))
    hi, lo = ref.split_bf16(x)
    assert torch.equal(hi, hi.to(torch.bfloat16).float())
    assert torch.equal(lo, lo.to(torch.bfloat16).float())
    assert bool(((x - hi - lo).abs() <= 2.0**-16 * x.abs()).all())
