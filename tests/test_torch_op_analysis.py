"""The op analysis (``runtime/op_analysis.py``) against the JAX package's
``analyze_hlo`` and against the conventions it states: FLOPs of the smoke
dense train, prefill and decode steps equal the JAX package's on the
compiled smoke step (tolerance 0: both count 2·m·n·k a matmul, and eager
tracing unrolls the microbatch and remat loops that ``analyze_hlo``
weights by trip count), a ``meta`` trace counts what a CPU trace counts,
bytes, peak live bytes, the port's kernels' formulas and launches, the
collectives under the ``fake`` backend, and the per-op breakdown."""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke
from repro.launch.steps import make_decode_step as ref_decode_step
from repro.launch.steps import make_prefill_step as ref_prefill_step
from repro.launch.steps import make_train_step as ref_train_step
from repro.models import build_model as ref_build
from repro.optim import adamw as ref_adamw
from repro.optim import cosine_schedule as ref_cosine
from repro.runtime.hlo_analysis import analyze_hlo
from repro_torch.configs import get_smoke_config
from repro_torch.convert import stack_layers
from repro_torch.kernels.kron_mul.ref import kron_mul_ref
from repro_torch.kernels.paged_attention.ref import paged_gqa_decode_ref
from repro_torch.kernels.quant_matmul.ref import quant_matmul_ref
from repro_torch.launch.steps import (
    make_decode_step,
    make_prefill_step,
    make_train_step,
)
from repro_torch.models.lm import build_model
from repro_torch.optim import adamw, cosine_schedule
from repro_torch.runtime import op_breakdown
from repro_torch.runtime.op_analysis import analyze_step

B, S = 4, 32


def _cfgs(remat, microbatch, dtype):
    kw = dict(remat=remat, microbatch=microbatch, dtype=dtype)
    return (dataclasses.replace(ref_smoke("qwen3-14b"), **kw),
            dataclasses.replace(get_smoke_config("qwen3-14b"), **kw))


def _port_step(cfg, kind, device):
    model = build_model(cfg)
    params = stack_layers(model.abstract_params() if device == "meta" else
                          model.init(torch.Generator().manual_seed(0),
                                     device=device))
    tok = torch.zeros((B, S), dtype=torch.int32, device=device)
    if kind == "train":
        opt = adamw(cosine_schedule(3e-4, 10_000, 500))
        return make_train_step(model, opt), (
            params, opt.init(params), {"tokens": tok, "targets": tok}, 0)
    if kind == "prefill":
        return make_prefill_step(model), (params, {"tokens": tok})
    cache = (model.abstract_cache(B, S) if device == "meta" else
             model.init_cache(B, S, device=device))
    return make_decode_step(model), (params, tok[:, :1], cache, S - 1)


def _ref_flops(cfg, kind) -> float:
    model = ref_build(cfg)
    params = model.init(jax.random.PRNGKey(0))
    tok = jnp.zeros((B, S), jnp.int32)
    if kind == "train":
        opt = ref_adamw(ref_cosine(3e-4, 10_000, 500))
        lowered = jax.jit(ref_train_step(model, opt)).lower(
            params, opt.init(params), {"tokens": tok, "targets": tok},
            jnp.int32(0))
    elif kind == "prefill":
        lowered = jax.jit(ref_prefill_step(model)).lower(
            params, {"tokens": tok})
    else:
        lowered = jax.jit(ref_decode_step(model)).lower(
            params, tok[:, :1], model.init_cache(B, S), jnp.int32(S - 1))
    return analyze_hlo(lowered.compile().as_text(), 1).flops


@pytest.mark.parametrize("kind,remat,microbatch,dtype", [
    ("train", "none", 4, "float32"), ("train", "full", 2, "float32"),
    ("train", "dots", 2, "bfloat16"), ("prefill", "full", 16, "float32"),
    ("decode", "full", 16, "float32"), ("decode", "full", 16, "bfloat16"),
])
def test_flops_equal_analyze_hlo(kind, remat, microbatch, dtype):
    ref_cfg, cfg = _cfgs(remat, microbatch, dtype)
    fn, args = _port_step(cfg, kind, "meta")
    stats, _ = analyze_step(fn, *args)
    assert stats.device == "meta"
    assert stats.flops == _ref_flops(ref_cfg, kind) > 0


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_meta_trace_counts_what_a_cpu_trace_counts(kind):
    """The same matmuls and the same bytes of every op on the step's
    device; a CPU trace also counts the host-side scalar ops (the
    optimizer's step counter), which a ``meta`` or card trace does not."""
    _, cfg = _cfgs("full", 2, "bfloat16")
    meta, _ = analyze_step(*_flat(_port_step(cfg, kind, "meta")))
    cpu, _ = analyze_step(*_flat(_port_step(cfg, kind, "cpu")))
    assert meta.flops == cpu.flops
    assert meta.arg_bytes == cpu.arg_bytes
    assert meta.peak_live_bytes == cpu.peak_live_bytes
    for name, row in meta.ops.items():
        if row["flops"]:
            assert cpu.ops[name] == row, name
    assert meta.bytes_accessed <= cpu.bytes_accessed
    if kind != "train":  # no host scalars outside the optimizer
        assert meta.bytes_accessed == cpu.bytes_accessed


def _flat(step):
    fn, args = step
    return (fn, *args)


def test_bytes_are_operands_and_results_of_non_views():
    a = torch.ones(64, 32)
    b = torch.ones(32, 16)

    def f(a, b):
        c = a @ b            # mm: 64·32 + 32·16 + 64·16 floats
        v = c.view(16, 64).t()  # views: nothing
        return v.sum()       # sum: 64·16 in, 1 out

    stats, _ = analyze_step(f, a, b)
    assert stats.flops == 2 * 64 * 32 * 16
    assert stats.bytes_accessed == 4 * ((64 * 32 + 32 * 16 + 64 * 16)
                                        + (64 * 16 + 1))
    assert stats.ops["aten.view"]["bytes"] == 0
    assert stats.ops["aten.t"]["bytes"] == 0


def test_peak_live_bytes_track_lifetimes():
    x = torch.ones(1000)  # an argument: 4,000 B live throughout

    def f(x):
        a = x * 2              # 4,000 B made during the step
        b = a + 1              # 8,000
        del a                  # 4,000
        c = torch.cat([b, b])  # 12,000: the peak
        del b                  # 8,000
        return c[:10].clone()  # 8,040 (the slice is a view of c)

    stats, _ = analyze_step(f, x)
    assert stats.arg_bytes == 4000
    assert stats.peak_live_bytes == 4000 + 12000


# ---- the port's kernels: formulas and launches --------------------------------

# the operators the CUDA extension registers, here with the plain versions
# as CPU implementations (the extension is not built on the CPU), so that
# the recorder sees torch.ops.repro_torch.* calls as it does on the card
_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_LIB.define("quant_matmul(Tensor x, Tensor packed, int bits, Tensor? s, "
            "int maxq, Tensor counters) -> Tensor")
_LIB.define("kron_mul(Tensor x, Tensor? A, Tensor B, Tensor? perm, Tensor? "
            "inv_perm, Tensor? scale, bool transpose) -> Tensor")
_LIB.define("paged_decode_self(Tensor q, Tensor k_new, Tensor v_new, "
            "Tensor k_pages, Tensor v_pages, Tensor? k_scale, Tensor? "
            "v_scale, Tensor block_tables, Tensor ctx_len, int layer) -> "
            "Tensor")
_LIB.impl("quant_matmul", lambda x, packed, bits, s, maxq, counters:
          quant_matmul_ref(x, packed, bits, x.shape[1], s, maxq), "CPU")
_LIB.impl("kron_mul", lambda x, A, B_, perm, inv_perm, scale, transpose:
          kron_mul_ref(x, A, B_, perm=perm, inv_perm=inv_perm, scale=scale,
                       transpose=transpose), "CPU")
_LIB.impl("paged_decode_self", lambda q, kn, vn, kp, vp, ks, vs, bt, cl, l:
          paged_gqa_decode_ref(q, kn, vn, kp, vp, bt, cl, layer=l,
                               k_scale=ks, v_scale=vs), "CPU")


def test_kernel_formulas_and_launches():
    ops = torch.ops.repro_torch
    g = torch.Generator().manual_seed(0)
    x = torch.randn(8, 256, generator=g)
    packed = torch.randint(-2**31, 2**31 - 1, (16, 96), dtype=torch.int32,
                           generator=g)
    A, Bf = torch.randn(16, 16, generator=g), torch.randn(16, 16, generator=g)
    L, P, ps, KV, hd, H = 2, 6, 16, 2, 32, 8
    kp = torch.randn(L, P, ps, KV, hd, generator=g)
    ctx = torch.tensor([5, 0, 33], dtype=torch.int32)
    bt = torch.arange(3 * 2, dtype=torch.int32).reshape(3, 2)

    def f():
        ops.quant_matmul(x, packed, 2, torch.tensor(0.5), 3,
                         torch.zeros(1, dtype=torch.int32))
        ops.kron_mul(x, A, Bf, None, None, None, False)
        ops.kron_mul(x[:0], A, Bf, None, None, None, False)  # no launch
        ops.paged_decode_self(torch.randn(3, H, hd), torch.randn(3, KV, hd),
                              torch.randn(3, KV, hd), kp, kp, None, None,
                              bt, ctx, 1)

    stats, _ = analyze_step(f, device="cpu")
    assert stats.kernel_launches == {"quant_matmul": 1, "kron_mul": 1,
                                     "paged_decode": 1}
    qmm = 2 * 8 * 256 * 96 + 8 * 256 + 2 * 8 * 96
    kron = 2 * 8 * (16 + 16) * 16 * 16
    attn = 4 * H * hd * (5 + 0 + 33 + 3)
    assert stats.ops["repro_torch.quant_matmul"]["flops"] == qmm
    assert stats.ops["repro_torch.kron_mul"]["flops"] == kron
    assert stats.ops["repro_torch.paged_decode_self"]["flops"] == attn


def test_meta_paged_decode_counts_capacity():
    """On ``meta`` the context lengths are unknown: the tables' capacity
    (3 lanes x 2 pages x 16) counts, plus each lane's own token."""
    from repro_torch.runtime.op_analysis import KERNEL_FORMULAS, \
        _load_kernel_formulas

    _load_kernel_formulas()
    _, formula, launched = KERNEL_FORMULAS["repro_torch.paged_decode_self"]
    q = torch.empty(3, 8, 32, device="meta")
    kp = torch.empty(2, 6, 16, 2, 32, device="meta")
    bt = torch.empty(3, 2, dtype=torch.int32, device="meta")
    ctx = torch.empty(3, dtype=torch.int32, device="meta")
    assert launched(q)
    assert formula(q, None, None, kp, kp, None, None, bt, ctx, 0) == \
        4 * 8 * 32 * (3 * 2 * 16 + 3)


# ---- collectives ----------------------------------------------------------


@pytest.fixture
def fake_group():
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    yield dist
    dist.destroy_process_group()


def test_collective_bytes_follow_the_conventions(fake_group):
    dist = fake_group
    x = torch.ones(1000)

    def f(x):
        dist.all_reduce(x)
        dist.all_gather_into_tensor(torch.empty(4000), x)
        dist.reduce_scatter_tensor(torch.empty(250), x)
        fc.wait_tensor(fc.all_reduce(x, "sum", dist.group.WORLD))

    import torch.distributed._functional_collectives as fc

    stats, _ = analyze_step(f, x, device="cpu")
    g = (4 - 1) / 4
    assert stats.collectives.bytes_by_kind == {
        "all-reduce": 2 * 2 * 4000 * g, "all-gather": 16000 * g,
        "reduce-scatter": 4000 * g}
    assert stats.collectives.count_by_kind == {
        "all-reduce": 2, "all-gather": 1, "reduce-scatter": 1}
    assert stats.collectives.total_bytes == (16000 + 16000 + 4000) * g


def test_breakdown_reads_the_dry_run_record(capsys, tmp_path):
    import json

    from repro_torch.launch import dryrun

    rec = dryrun.lower_cell("qwen3-14b", "decode_32k", mesh_shape=(1, 1),
                            overrides={"n_layers": "1"}, verbose=False)
    path = tmp_path / "rec.json"
    path.write_text(json.dumps(rec))
    by_bytes, by_flops = op_breakdown.breakdown(rec)
    assert sum(by_flops.values()) == rec["op_analysis"]["flops"]
    assert sum(by_bytes.values()) == rec["op_analysis"]["bytes"]
    assert op_breakdown.main([str(path), "--top", "3"]) == 0
    out = capsys.readouterr().out
    assert "== bytes (per device)" in out and "aten.bmm" in out
