"""Slice gate: the port's engine serves the reference's own smoke artifact
(2-bit LDLQ) and fp params with greedy token streams identical to the
reference engine, on the paged paths and under eviction, and the port's
serve CLI passes ``--check`` on a converted reference artifact."""
from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
from torch_parity import quantized_tree_numpy

from repro.configs import get_smoke_config as ref_smoke
from repro.core.quantizer import QuipConfig
from repro.data import make_calibration as ref_calibration
from repro.models import build_model
from repro.serve import CachedDecoder as RefDecoder
from repro.serve import Engine as RefEngine
from repro.serve import EngineConfig as RefEngineConfig
from repro_torch import convert
from repro_torch.configs import ArchConfig
from repro_torch.launch import serve as port_serve
from repro_torch.serve.adapter import CachedDecoder
from repro_torch.serve.engine import Engine, EngineConfig

RTOL = ATOL = 2e-3


@pytest.fixture(scope="module")
def reference():
    """The reference smoke model, fp params and its 2-bit quantization
    (the tests/test_serve.py ``quantized_smoke`` recipe)."""
    from repro.launch.quantize import quantize_dense_model

    cfg = ref_smoke("qwen3-14b")
    model = build_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    calib = ref_calibration(cfg.vocab, n_segments=4, seg_len=32, seed=7)
    qcfg = QuipConfig(bits=2, method="ldlq", use_kernel=False)
    qm = quantize_dense_model(params, cfg, qcfg, calib.tokens, seed=0,
                              verbose=False)
    return cfg, model, params, qm, qcfg


def _decoders(reference, weights: str):
    cfg, model, params, qm, _ = reference
    if weights == "fp":
        port_cfg = ArchConfig.from_dict(dataclasses.asdict(cfg))
        port = CachedDecoder.from_model(
            port_cfg,
            convert.fp_params_from_numpy(jax.tree.map(np.asarray, params),
                                         device="cpu"))
        return RefDecoder.from_model(model, params), port
    port_qm = convert.quantized_model_from_numpy(
        dataclasses.asdict(cfg), quantized_tree_numpy(qm), device="cpu")
    return RefDecoder.from_quantized(qm), CachedDecoder.from_quantized(port_qm)


# (engine knobs, prompt len, gen): the reference serving tests' default
# and the verify recipe's eviction config (pool too small for all lanes)
CONFIGS = {
    "paged": (dict(n_slots=4, page_size=4, token_budget=32, prefill_chunk=8,
                   paged_decode=True, paged_prefill=True), 12, 6),
    "evict": (dict(n_slots=4, page_size=4, n_pages=16, token_budget=64,
                   prefill_chunk=32, paged_decode=True, paged_prefill=True),
              16, 16),
    "dense": (dict(n_slots=4, page_size=4, token_budget=32, prefill_chunk=8),
              12, 6),
}


def _run(engine_cls, cfg_cls, adapter, prompts, gen, knobs):
    eng = engine_cls(adapter, cfg_cls(max_seq_len=prompts.shape[1] + gen,
                                      record_logits=True, **knobs))
    reqs = [eng.submit(np.asarray(p), max_new=gen) for p in prompts]
    eng.run()
    return eng, reqs


@pytest.mark.parametrize("config", ["paged", "evict", "dense"])
@pytest.mark.parametrize("weights", ["2bit", "fp"])
def test_engine_tokens_match_reference_engine(reference, weights, config):
    knobs, prompt_len, gen = CONFIGS[config]
    ref_adapter, port_adapter = _decoders(reference, weights)
    prompts = np.asarray(ref_calibration(256, n_segments=6,
                                         seg_len=prompt_len, seed=3).tokens)
    ref_eng, ref_reqs = _run(RefEngine, RefEngineConfig, ref_adapter,
                             prompts, gen, knobs)
    eng, reqs = _run(Engine, EngineConfig, port_adapter, prompts, gen, knobs)
    assert eng.stats["evictions"] == ref_eng.stats["evictions"]
    if config == "evict":
        assert eng.stats["evictions"] > 0
    for r, rr in zip(reqs, ref_reqs):
        assert r.state.value == rr.state.value
        assert r.out_tokens == rr.out_tokens
        np.testing.assert_allclose(np.stack(r.step_logits),
                                   np.stack(rr.step_logits), rtol=RTOL,
                                   atol=ATOL)
    assert eng.pool.pages_in_use == 0


@pytest.mark.parametrize("flags", [
    [],
    ["--slots", "4", "--page-size", "4", "--pages", "16", "--prompt-len",
     "16", "--gen", "16"],
])
def test_serve_cli_check_on_converted_reference_artifact(reference, tmp_path,
                                                         flags, capsys):
    from repro.serve.artifacts import load_quantized as ref_load
    from repro.serve.artifacts import save_quantized as ref_save

    cfg, _, _, qm, qcfg = reference
    ref_save(tmp_path / "ref_art", qm, qcfg)
    loaded, meta = ref_load(tmp_path / "ref_art")  # transforms from seeds
    convert.write_port_artifact(
        tmp_path / "port_art", meta["arch_config"],
        quantized_tree_numpy(loaded), meta["quip_config"])
    rc = port_serve.main([
        "--device", "cpu", "--smoke", "--load-quantized",
        str(tmp_path / "port_art"), "--paged", "--paged-prefill", "--check",
        "--requests", "4", *flags,
    ])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "token agreement 100.00%" in out


def test_cuda_device_without_a_card_raises():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        port_serve.main(["--smoke", "--device", "cuda"])


def _default_device_calls(tmp_path):
    """Each public constructor that places tensors, called with no device."""
    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.core.hessian import HessianAccumulator
    from repro_torch.core.incoherence import random_orthogonal, seeded_transform
    from repro_torch.models.lm import build_model
    from repro_torch.models.transformer import init_decoder
    from repro_torch.serve.artifacts import load_quantized
    from repro_torch.serve.kv_cache import PagedKVPool
    from repro_torch.serve.synthetic import synthetic_quantized_model

    cfg = get_smoke_config("qwen3-14b")
    t = {"kind": "none", "n": 4, "A": None, "B": None, "signs": None,
         "perm": None}
    return {
        "load_quantized": lambda: load_quantized(tmp_path),
        "PagedKVPool": lambda: PagedKVPool(cfg, n_pages=4, page_size=4,
                                           n_slots=1, max_pages_per_seq=2),
        "init_decoder": lambda: init_decoder(cfg, torch.Generator()),
        "synthetic_quantized_model":
            lambda: synthetic_quantized_model(cfg, seed=0),
        "transform_from_numpy": lambda: convert.transform_from_numpy(t),
        "fp_params_from_numpy": lambda: convert.fp_params_from_numpy({}),
        "seeded_transform": lambda: seeded_transform("kronecker", 8, 0),
        "HessianAccumulator.create": lambda: HessianAccumulator.create(8),
        "random_orthogonal": lambda: random_orthogonal(8, torch.Generator()),
        "build_model.init": lambda: build_model(
            get_smoke_config("arctic-480b")).init(torch.Generator()),
        "build_model.init_cache": lambda: build_model(
            get_smoke_config("zamba2-7b")).init_cache(1, 4),
    }


@pytest.mark.parametrize("entry", [
    "load_quantized", "PagedKVPool", "init_decoder",
    "synthetic_quantized_model", "transform_from_numpy",
    "fp_params_from_numpy", "seeded_transform", "HessianAccumulator.create",
    "random_orthogonal", "build_model.init", "build_model.init_cache",
])
def test_entry_points_default_to_cuda(entry, tmp_path):
    """With no device given, tensors go to the card: without one, the call
    raises before it touches any data instead of serving on the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        _default_device_calls(tmp_path)[entry]()
