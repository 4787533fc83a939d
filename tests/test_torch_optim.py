"""The port's optimizers, schedules and int8 error-feedback compression
(``repro_torch.optim``) against the JAX package's, over the JAX smoke
init tree converted into the stacked layout (``convert.stack_layers``),
plus the port's counterparts of the JAX package's substrate cases.

Tolerances (read on this CPU, about ten times below each):
* fp32 state and params: max |Δ| ≤ 1e-5 · max |leaf| (read ≤ 3.1e-7);
* bf16 params: within one bf16 ulp of the JAX package's, or within the
  fp32 bound above (a master within rounding of a bf16 boundary may round
  the other way, and ``p - lr·g`` near 0 cancels; read: 2-6 of ~500 k
  elements);
* ``grad_norm``: relative 1e-5 (read ≤ 1.6e-6 on bf16 grads);
* schedules: within 1 fp32 ulp;
* int8 payloads, scales and error buffers equal to the JAX functions'
  run op by op (under ``jit`` codes may differ by 1 at exact ties).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as RO
from repro.checkpoint.store import _flatten_with_paths as ref_flatten
from repro_torch import optim as PO
from repro_torch.convert import stack_layers
from repro_torch.tree import flatten_with_paths, unflatten
from torch_parity import family_models

STATE_RTOL = 1e-5
GN_RTOL = 1e-5
STEPS = 3

OPTS = {
    "adamw": (lambda m: m.adamw(m.cosine_schedule(1e-2, 10, 2))),
    "adafactor": (lambda m: m.adafactor(1e-2)),
    "sgd": (lambda m: m.sgd(0.1)),
    "sgd_momentum": (lambda m: m.sgd(0.1, 0.9)),
}


def _np32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _keys(tree, port: bool) -> list:
    if port:
        return [k for k, _ in flatten_with_paths(tree)]
    return [k for k, _ in ref_flatten(tree)[0]]


def _grads(rng, ref_params, port_params, dtype):
    """Seeded grads in the param dtype, the same values in both trees."""
    items = ref_flatten(ref_params)[0]
    gs = {k: rng.standard_normal(x.shape).astype(np.float32) * 0.1
          for k, x in items}
    jdt = jnp.dtype(dtype)
    ref = jax.tree_util.tree_unflatten(
        ref_flatten(ref_params)[1],
        [jnp.asarray(gs[k]).astype(jdt) for k, _ in items])
    port = unflatten(port_params, {
        k: torch.from_numpy(_np32(jnp.asarray(gs[k]).astype(jdt)).copy()).to(
            getattr(torch, dtype)) for k in gs})
    return ref, port


def assert_trees_close(port_tree, ref_tree, *, bf16_ulp: bool):
    want = dict(ref_flatten(ref_tree)[0])
    got = dict(flatten_with_paths(port_tree))
    assert list(got) == list(want)
    for k, w in want.items():
        g = got[k]
        assert tuple(g.shape) == tuple(w.shape), k
        assert str(g.dtype).split(".")[-1] == str(w.dtype), k
        a, b = _np32(g), _np32(w)
        atol = STATE_RTOL * (float(np.abs(b).max()) or 1.0)
        rtol = 2.0**-7 if bf16_ulp and g.dtype == torch.bfloat16 else 0.0
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(OPTS))
def test_optimizer_matches_jax_over_stacked_tree(name, dtype):
    ref_model, ref_params, _, port_params = family_models("qwen3-14b",
                                                          dtype=dtype)
    port_params = stack_layers(port_params)
    ro, po = OPTS[name](RO), OPTS[name](PO)
    ref_state, port_state = ro.init(ref_params), po.init(port_params)
    assert _keys(port_state, True) == _keys(ref_state, False)
    upd = jax.jit(ro.update)
    rng = np.random.default_rng(7)
    for step in range(STEPS):
        rg, pg = _grads(rng, ref_params, port_params, dtype)
        ref_params, ref_state, rm = upd(rg, ref_state, ref_params,
                                        jnp.int32(step))
        port_params, port_state, pm = po.update(pg, port_state, port_params,
                                                step)
        np.testing.assert_allclose(float(pm["grad_norm"]),
                                   float(rm["grad_norm"]), rtol=GN_RTOL)
    assert_trees_close({"params": port_params, "opt": port_state},
                       {"params": ref_params, "opt": ref_state},
                       bf16_ulp=True)


def test_adafactor_factors_stacked_norm_scales():
    """A stacked (L, d) norm scale is a >=2-D leaf: row and column
    moments, as the JAX package's adafactor gives it."""
    _, ref_params, _, port_params = family_models("qwen3-14b")
    state = PO.adafactor(1e-2).init(stack_layers(port_params))
    row, col = state["moments"]["layers"]["ln1"]["scale"]
    L, d = 2, 64
    assert tuple(row.shape) == (L,) and tuple(col.shape) == (d,)
    assert state["moments"]["final_norm"]["scale"][1] is None
    ref_state = RO.adafactor(1e-2).init(ref_params)
    assert ref_state["moments"]["layers"]["ln1"]["scale"][0].shape == (L,)


def test_update_writes_in_place_and_master_never_aliases():
    params = {"w": torch.ones(4)}
    opt = PO.adamw(1e-2)
    state = opt.init(params)
    assert state["master"]["w"].data_ptr() != params["w"].data_ptr()
    w = params["w"]
    p2, s2, _ = opt.update({"w": torch.full((4,), 0.5)}, state, params, 0)
    assert p2["w"] is w and s2 is state
    assert state["master"]["w"].data_ptr() != w.data_ptr()
    assert torch.equal(w, state["master"]["w"])


def _ulp_close(got, want):
    want = np.float32(want)
    assert abs(np.float32(got) - want) <= np.spacing(np.abs(want)), (got,
                                                                     want)


@pytest.mark.parametrize("args", [(3e-4, 1), (1.0, 10), (2.5e-3, 7)])
def test_linear_warmup_matches_jax(args):
    ref, port = RO.linear_warmup(*args), PO.linear_warmup(*args)
    for s in range(0, 15):
        got = port(s)
        assert got.dtype == torch.float32
        _ulp_close(float(got), float(ref(jnp.int32(s))))
        _ulp_close(float(port(torch.tensor(s, dtype=torch.int32))),
                   float(jax.jit(ref)(jnp.int32(s))))


@pytest.mark.parametrize("args", [(3e-4, 6, 1), (3e-4, 100, 5),
                                  (1.0, 50, 0, 0.0), (1e-2, 10, 2, 0.25)])
def test_cosine_schedule_matches_jax(args):
    ref, port = RO.cosine_schedule(*args), PO.cosine_schedule(*args)
    for s in list(range(0, 12)) + [49, 50, 99, 150]:
        got = port(s)
        assert got.dtype == torch.float32
        _ulp_close(float(got), float(ref(jnp.int32(s))))


def test_global_norm_and_clip_match_jax():
    _, ref_params, _, port_params = family_models("qwen3-14b")
    port_params = stack_layers(port_params)
    gn_ref = float(RO.optimizers.global_norm(ref_params))
    np.testing.assert_allclose(float(PO.global_norm(port_params)), gn_ref,
                               rtol=GN_RTOL)
    for max_norm in (1.0, 10 * gn_ref):
        rc, rgn = RO.optimizers.clip_by_global_norm(ref_params, max_norm)
        pc, pgn = PO.clip_by_global_norm(port_params, max_norm)
        np.testing.assert_allclose(float(pgn), float(rgn), rtol=GN_RTOL)
        assert_trees_close(pc, rc, bf16_ulp=False)
    assert float(PO.global_norm({"a": torch.tensor([3.0]),
                                 "b": (torch.tensor([4.0]), None)})) == 5.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ef_int8_matches_jax_payloads(dtype):
    """Against the JAX functions run op by op, as written.  Under ``jit``
    XLA turns ``max/127 + 1e-12`` into ``fma(max, 1/127, 1e-12)``, which
    can move the scale by an ulp and flip codes at exact ties (bf16 grads
    make ties: 17 of 16 k read); those codes then differ by 1 at most."""
    _, ref_params, _, port_params = family_models("qwen3-14b", dtype=dtype)
    port_params = stack_layers(port_params)
    ref_ef = RO.init_ef_state(ref_params)
    port_ef = PO.init_ef_state(port_params)
    jit_ef = ref_ef
    assert _keys(port_ef, True) == _keys(ref_ef, False)
    rng = np.random.default_rng(3)
    for _ in range(3):
        rg, pg = _grads(rng, ref_params, port_params, dtype)
        rq, rs, ref_ef = RO.ef_int8_compress(rg, ref_ef)
        jq, _, jit_ef = jax.jit(RO.ef_int8_compress)(rg, jit_ef)
        pq, ps, port_ef = PO.ef_int8_compress(pg, port_ef)
        rq_d, jq_d = dict(ref_flatten(rq)[0]), dict(ref_flatten(jq)[0])
        rs_d = dict(ref_flatten(rs)[0])
        re_d = dict(ref_flatten(ref_ef)[0])
        for k, q in flatten_with_paths(pq):
            assert q.dtype == torch.int8
            np.testing.assert_array_equal(q.numpy(), np.asarray(rq_d[k]),
                                          err_msg=k)
            assert np.abs(q.numpy().astype(int)
                          - np.asarray(jq_d[k]).astype(int)).max() <= 1, k
        for k, s in flatten_with_paths(ps):
            assert float(s) == float(rs_d[k]), k
        for k, e in flatten_with_paths(port_ef):
            np.testing.assert_array_equal(e.numpy(), np.asarray(re_d[k]),
                                          err_msg=k)
        pd = PO.ef_int8_decompress(pq, ps)
        rd = RO.ef_int8_decompress(rq, rs)
        assert_trees_close(pd, rd, bf16_ulp=False)


def test_ef_int8_one_scale_covers_all_layers_of_a_stacked_leaf():
    g = {"layers": {"w": torch.stack([torch.full((4,), 1.0),
                                      torch.full((4,), 127.0)])}}
    q, s, _ = PO.ef_int8_compress(g, PO.init_ef_state(g))
    assert s["layers"]["w"].shape == ()
    assert q["layers"]["w"][0].tolist() == [1] * 4
    assert q["layers"]["w"][1].tolist() == [127] * 4


# ---------------------------------------------------------------------------
# the JAX package's substrate cases (tests/test_substrate.py), on the port
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("make_opt", [
    lambda: PO.adamw(5e-2), lambda: PO.adafactor(5e-2),
    lambda: PO.sgd(1e-1, 0.9),
], ids=["adamw", "adafactor", "sgd_momentum"])
def test_optimizer_reduces_quadratic(make_opt):
    opt = make_opt()
    params = {"w": torch.tensor([2.0, -3.0, 1.5])}
    state = opt.init(params)
    l0 = float(torch.sum(params["w"] ** 2))
    for step in range(200):
        g = {"w": 2 * params["w"]}
        params, state, _ = opt.update(g, state, params, step)
    assert float(torch.sum(params["w"] ** 2)) < 0.2 * l0


def test_bf16_params_fp32_master():
    opt = PO.adamw(1e-2)
    params = {"w": torch.ones(4, dtype=torch.bfloat16)}
    state = opt.init(params)
    assert state["master"]["w"].dtype == torch.float32
    g = {"w": torch.full((4,), 0.5, dtype=torch.bfloat16)}
    p2, s2, m = opt.update(g, state, params, 0)
    assert p2["w"].dtype == torch.bfloat16
    assert float(m["grad_norm"]) > 0


def test_cosine_schedule_shape():
    f = PO.cosine_schedule(1.0, 100, warmup_steps=10, final_frac=0.1)
    assert float(f(0)) < 0.2
    assert abs(float(f(10)) - 1.0) < 0.05
    assert abs(float(f(99)) - 0.1) < 0.05


def test_ef_int8_error_feedback_converges():
    """Accumulated EF error stays bounded; mean compressed grad ~ true."""
    g = {"w": torch.linspace(-1, 1, 256)}
    ef = PO.init_ef_state(g)
    acc = torch.zeros_like(g["w"])
    for _ in range(50):
        q, s, ef = PO.ef_int8_compress(g, ef)
        acc = acc + PO.ef_int8_decompress(q, s)["w"]
    np.testing.assert_allclose((acc / 50).numpy(), g["w"].numpy(),
                               atol=1e-3)


def test_ef_int8_payload_is_int8():
    g = {"w": torch.randn(64, generator=torch.Generator().manual_seed(0))}
    q, s, ef = PO.ef_int8_compress(g, PO.init_ef_state(g))
    assert q["w"].dtype == torch.int8
