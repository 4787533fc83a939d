"""The port's tensor-parallel engine held to the JAX package's
``DistributedCachedDecoder`` itself: the JAX one runs in a subprocess on a
host of two devices (``XLA_FLAGS=--xla_force_host_platform_device_count=2``,
``torch_tp_reference.py``), the port's on a (1, 2) mesh of gloo
processes, over the same fp params and the same 2-bit quantization;
greedy streams identical."""
from __future__ import annotations

import os
import pathlib
import pickle
import subprocess
import sys

import pytest
from torch_parity import run_tokens, tp_drive

from repro_torch import convert
from repro_torch.configs import ArchConfig
from repro_torch.serve.distributed import (
    DistributedCachedDecoder,
    make_serving_mesh,
)
from repro_torch.serve.engine import Engine, EngineConfig

TESTS = pathlib.Path(__file__).resolve().parent


@pytest.fixture(scope="module")
def jax_tp(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_tp") / "ref.pkl"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    env["PYTHONPATH"] = os.pathsep.join(
        [str(TESTS.parent / "src"), str(TESTS)]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    res = subprocess.run([sys.executable, str(TESTS / "torch_tp_reference.py"),
                          str(out)], env=env, capture_output=True, text=True,
                         timeout=600)
    assert res.returncode == 0, res.stdout + res.stderr
    with open(out, "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def mesh():
    m = make_serving_mesh(1, 2, device="cpu")
    yield m
    m.close()


@pytest.mark.parametrize("case", ["fp", "2bit"])
def test_tp_engine_matches_jax_distributed_decoder(jax_tp, mesh, case):
    prompts, gen, want = jax_tp["tokens"][case]
    if case == "fp":
        dist = DistributedCachedDecoder.from_model(
            ArchConfig.from_dict(jax_tp["arch_config"]),
            convert.fp_params_from_numpy(jax_tp["params"], device="cpu"),
            mesh=mesh)
    else:
        dist = DistributedCachedDecoder.from_quantized(
            convert.quantized_model_from_numpy(
                jax_tp["arch_config"], jax_tp["quantized"], device="cpu"),
            mesh=mesh)
    eng, run = tp_drive(dist, Engine, EngineConfig, prompts, gen)
    assert dist._pool_sharded
    assert run_tokens(run) == want
    assert all(len(t) == gen for t in want)
