"""The port imports neither JAX nor the reference package: a fresh process
imports every module of repro_torch and chip_smoke and checks
sys.modules."""
from __future__ import annotations

import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]

_PROBE = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                              "repro_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(len(names), leaked)
assert not leaked, leaked
assert len(names) >= 25, names
for name in ("repro_torch.serve.frontdoor.server",
             "repro_torch.serve.frontdoor.wire",
             "repro_torch.serve.fleet.router",
             "repro_torch.serve.fleet.supervisor",
             "repro_torch.models.lm", "repro_torch.models.ssm",
             "repro_torch.models.recurrent",
             "repro_torch.models.multimodal",
             "repro_torch.optim", "repro_torch.optim.optimizers",
             "repro_torch.optim.schedule", "repro_torch.optim.compression",
             "repro_torch.launch.steps", "repro_torch.launch.train",
             "repro_torch.tree", "repro_torch.runtime.elastic",
             "repro_torch.runtime.op_analysis",
             "repro_torch.runtime.op_breakdown",
             "repro_torch.runtime.roofline", "repro_torch.launch.dryrun",
             "repro_torch.launch.mesh", "repro_torch.launch.specs",
             "repro_torch.runtime.process_group",
             "repro_torch.runtime.collectives",
             "repro_torch.runtime.train_mesh"):
    assert name in names, name
"""


def test_port_imports_no_jax_and_no_reference():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"), str(ROOT)])
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.strip().endswith("[]")


def test_train_driver_imports_nothing_of_serving():
    """The training driver shares the process-group helpers with serving
    through ``runtime/process_group.py``: importing it loads no module of
    ``repro_torch.serve``."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    probe = ("import sys, repro_torch.launch.train; print(sorted(m for m in "
             "sys.modules if m.startswith('repro_torch.serve')))")
    out = subprocess.run([sys.executable, "-c", probe], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
