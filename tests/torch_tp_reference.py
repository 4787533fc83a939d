"""The JAX package's ``DistributedCachedDecoder`` on a (1, 2) host mesh:
a script (not a test module) that ``test_torch_distributed_ref.py`` runs
in a subprocess, since the host's device count is fixed when JAX starts.

    XLA_FLAGS=--xla_force_host_platform_device_count=2 \\
        python tests/torch_tp_reference.py OUT.pkl

Writes a pickle: the smoke fp params and their 2-bit quantization as
numpy trees (what ``repro_torch.convert`` takes), and each case's token
streams from the JAX TP engine.  The mesh is built with ``Auto`` axis
types: ``jax.make_mesh`` (what ``serve.distributed.make_serving_mesh``
calls) defaults to ``Explicit`` axes from jax 0.8 on, which the JAX
package's TP path predates and fails under.
"""
from __future__ import annotations

import dataclasses
import pickle
import sys

import jax
import numpy as np
from jax.sharding import AxisType
from torch_parity import quantized_tree_numpy

from repro.configs import get_smoke_config
from repro.core.quantizer import QuipConfig
from repro.data import make_calibration
from repro.launch.quantize import quantize_dense_model
from repro.models import build_model
from repro.serve import DistributedCachedDecoder, Engine, EngineConfig

# case -> (weights, prompt seed, prompts, prompt length, gen): the first
# two parity tests of tests/test_distributed.py
CASES = {"fp": ("fp", 3, 3, 10, 6), "2bit": ("2bit", 5, 4, 12, 5)}


def _tokens(adapter, prompts, gen) -> list:
    eng = Engine(adapter, EngineConfig(
        max_seq_len=prompts.shape[1] + gen, n_slots=4, page_size=4,
        token_budget=32, prefill_chunk=8, paged_decode=True))
    reqs = [eng.submit(np.asarray(p), max_new=gen) for p in prompts]
    eng.run()
    return [list(map(int, r.out_tokens)) for r in reqs]


def main(out_path: str) -> None:
    assert jax.device_count() >= 2, "run with XLA_FLAGS (2 host devices)"
    mesh = jax.make_mesh((1, 2), ("data", "model"),
                         axis_types=(AxisType.Auto, AxisType.Auto))
    cfg = get_smoke_config("qwen3-14b")
    model = build_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    calib = make_calibration(cfg.vocab, n_segments=4, seg_len=32, seed=7)
    qm = quantize_dense_model(params, cfg,
                              QuipConfig(bits=2, method="ldlq",
                                         use_kernel=False),
                              calib.tokens, seed=0, verbose=False)
    out = {"arch_config": dataclasses.asdict(cfg),
           "params": jax.tree.map(np.asarray, params),
           "quantized": quantized_tree_numpy(qm), "tokens": {}}
    for case, (weights, seed, n, seg_len, gen) in CASES.items():
        prompts = np.asarray(make_calibration(cfg.vocab, n_segments=n,
                                              seg_len=seg_len,
                                              seed=seed).tokens)
        adapter = (DistributedCachedDecoder.from_model(model, params,
                                                       mesh=mesh)
                   if weights == "fp" else
                   DistributedCachedDecoder.from_quantized(qm, mesh=mesh))
        out["tokens"][case] = (prompts, gen, _tokens(adapter, prompts, gen))
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    main(sys.argv[1])
