"""Tensor-parallel serving in the port (``repro_torch.serve.distributed``),
held against the JAX package on the CPU: the sharded 2-bit linears, their
layout, the sharded artifact load, 2-bit engine parity and the
indivisible-KV-head fallback.

The JAX package's own TP tests (``tests/test_distributed.py``) skip on a
one-device host, so each engine case holds the port's
``DistributedCachedDecoder`` on a mesh of gloo processes to the JAX
package's single-device engine AND the port's single-device engine
(``torch_parity.three_engines``).  The fp cases live in
``test_torch_distributed_engine.py``; ``test_torch_distributed_ref.py``
holds the port to the JAX ``DistributedCachedDecoder`` itself.  One
(1, 2) mesh serves the module; the (1, 4) case starts its own.
"""
from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch
from conftest import make_hessian, make_weights
from torch_parity import (
    linear_numpy,
    quantized_tree_numpy,
    smoke_prompts,
    three_engines,
)

from repro.configs import get_smoke_config as ref_smoke
from repro.core.quantizer import QuipConfig as RefQuipConfig
from repro.core.quantizer import quantize_layer as ref_quantize_layer
from repro.data import make_calibration as ref_calibration
from repro.models import build_model
from repro.serve import CachedDecoder as RefDecoder
from repro_torch import convert
from repro_torch.serve.adapter import CachedDecoder
from repro_torch.serve.distributed import (
    PACKED_AXES,
    DistributedCachedDecoder,
    apply_sharded_linear,
    make_serving_mesh,
    shard_quantized_model,
)

# one sharded linear against the unsharded one (fp32; read ~3e-7)
LINEAR_ATOL = 1e-5


@pytest.fixture(scope="module")
def mesh():
    m = make_serving_mesh(1, 2, device="cpu")
    yield m
    m.close()


@pytest.fixture(scope="module")
def quantized():
    """The reference smoke model quantized to 2 bits (the
    tests/test_distributed.py ``quantized_smoke`` recipe), and the port's
    conversion of it."""
    from repro.launch.quantize import quantize_dense_model

    cfg = ref_smoke("qwen3-14b")
    params = build_model(cfg).init(jax.random.PRNGKey(0))
    calib = ref_calibration(cfg.vocab, n_segments=4, seg_len=32, seed=7)
    qm = quantize_dense_model(params, cfg,
                              RefQuipConfig(bits=2, method="ldlq",
                                            use_kernel=False),
                              calib.tokens, seed=0, verbose=False)
    port = convert.quantized_model_from_numpy(
        dataclasses.asdict(cfg), quantized_tree_numpy(qm), device="cpu")
    return qm, port


def _adapters(quantized, mesh):
    qm, port = quantized
    return (RefDecoder.from_quantized(qm), CachedDecoder.from_quantized(port),
            DistributedCachedDecoder.from_quantized(port, mesh=mesh))


@pytest.mark.parametrize("bits", [2, 3])
@pytest.mark.parametrize("name", ["attn.wq", "attn.wo"])
def test_sharded_linear_outputs_match_unsharded(mesh, name, bits):
    """Column- and row-parallel placements reproduce the unsharded layer
    (and the JAX layer) up to matmul reassociation.  At 3 bits the 128
    input columns fill 13 packed rows, which 2 ranks cannot split: the
    row-parallel placement falls back to whole codes."""
    W, H = make_weights(64, 128, seed=3), make_hessian(128, seed=3)
    ref_layer, _ = ref_quantize_layer(
        W, H, RefQuipConfig(bits=bits, use_kernel=False), seed=1,
        collect_stats=False)
    layer = convert.linear_from_numpy(linear_numpy(ref_layer), device="cpu")
    x = np.array(make_weights(5, 128, seed=9))
    y_ref = np.asarray(ref_layer(x))
    y0 = layer(torch.as_tensor(x)).numpy()
    mode, y = apply_sharded_linear(mesh, layer, name, torch.as_tensor(x))
    assert mode == ("col" if name == "attn.wq" else
                    "row" if bits == 2 else None)
    np.testing.assert_allclose(y.numpy(), y0, rtol=0, atol=LINEAR_ATOL)
    np.testing.assert_allclose(y.numpy(), y_ref, rtol=0, atol=LINEAR_ATOL)


def test_shard_quantized_model_layout_and_originals(mesh, quantized):
    """Every packed tensor lands split per PACKED_AXES (half the words on
    this rank); the input model's tensors are untouched."""
    _, qm = quantized
    before = [{n: blk[n].packed.clone() for n in PACKED_AXES}
              for blk in qm.blocks]
    sq = shard_quantized_model(qm, mesh)
    for blk, blk0, saved in zip(sq.blocks, qm.blocks, before):
        for name, axes in PACKED_AXES.items():
            lin, full = blk[name], blk0[name].packed
            rows, m = full.shape
            if axes[1] is not None:
                assert lin.mode == "col"
                assert torch.equal(lin.packed, full[:, : m // 2])
            else:
                assert lin.mode == "row"
                assert torch.equal(lin.packed, full[: rows // 2])
                assert (lin.lo, lin.hi) == (0, blk0[name].n // 2)
            assert torch.equal(full, saved[name])


def test_sharded_artifact_load_roundtrip(mesh, quantized, tmp_path):
    """load(mesh=...) keeps packed codes on the host, slices them there,
    and every sharded projection matches the plainly loaded artifact."""
    from repro_torch.serve.artifacts import load_quantized, save_quantized

    save_quantized(tmp_path / "art", quantized[1],
                   {"bits": 2, "method": "ldlq"})
    dist, meta = DistributedCachedDecoder.load(tmp_path / "art", mesh=mesh)
    assert meta["quip_config"]["bits"] == 2
    plain, _ = load_quantized(tmp_path / "art", device="cpu")
    g = torch.Generator().manual_seed(13)
    for i, blk in enumerate(plain.blocks):
        for name in PACKED_AXES:
            lin = dist.blocks[i][name]
            assert lin.mode is not None
            assert lin.packed.numel() * 2 == blk[name].packed.numel()
            x = torch.randn(3, blk[name].n, generator=g)
            np.testing.assert_allclose(dist.project(i, name, x).numpy(),
                                       blk[name](x).numpy(), rtol=0,
                                       atol=LINEAR_ATOL)


def test_tp_engine_quantized_token_parity(mesh, quantized):
    """Sharded 2-bit packed codes over the sharded pool: the exact stream
    of both single-device engines."""
    eng, _ = three_engines(_adapters(quantized, mesh),
                           smoke_prompts(4, 12, 5), 5)
    assert eng.adapter._pool_sharded
    assert eng.pool.device_bytes() * 2 == eng.pool.total_bytes()


def test_indivisible_kv_heads_fall_back_replicated(quantized):
    """At mp = 4 the smoke config's 2 KV heads cannot split: the pool
    replicates and every rank attends every head, while attn.wk/wv's 32
    output columns still shard — same tokens as both single-device
    engines."""
    assert quantized[1].cfg.n_kv_heads % 4 != 0
    with make_serving_mesh(1, 4, device="cpu") as mesh4:
        eng, _ = three_engines(_adapters(quantized, mesh4),
                               smoke_prompts(2, 10, 6), 4)
        dist = eng.adapter
        assert not dist._pool_sharded
        assert eng.pool.device_bytes() == eng.pool.total_bytes()
        assert dist.blocks[0]["attn.wk"].mode == "col"
        assert dist.blocks[0]["attn.wk"].packed.shape[1] == 32 // 4
