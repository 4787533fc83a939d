"""The port's roofline against the JAX package's: ``model_flops`` for
every arch and shape, every term of ``roofline_terms`` under the JAX
package's TPU constants, and the H100 defaults."""
from __future__ import annotations

import dataclasses

import pytest

from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_config as ref_config
from repro.runtime import roofline as ref_roofline
from repro_torch.configs import ARCHS, SHAPES, get_config
from repro_torch.runtime.roofline import HW, model_flops, roofline_terms

TPU = HW(name="tpu_v5e", peak_flops=197e12, hbm_bw=819e9, link_bw=50e9)


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_equal_jax(arch):
    for name, shape in SHAPES.items():
        assert model_flops(get_config(arch), shape) == \
            ref_roofline.model_flops(ref_config(arch), REF_SHAPES[name])


def test_hw_defaults_are_the_h100_datasheet():
    hw = HW()
    assert (hw.peak_flops, hw.hbm_bw, hw.link_bw) == (989.4e12, 3.35e12,
                                                      450e9)
    assert dataclasses.asdict(ref_roofline.HW()) == dataclasses.asdict(TPU)


@pytest.mark.parametrize("chips", [1, 4, 256])
@pytest.mark.parametrize("flops_are_global", [True, False])
@pytest.mark.parametrize("cell", [None, ("qwen3-14b", "train_4k"),
                                  ("arctic-480b", "decode_32k"),
                                  ("zamba2-7b", "prefill_32k")])
def test_roofline_terms_equal_jax(cell, flops_are_global, chips):
    """Every field of the JAX terms under its TPU constants; ``mfu_bound``
    against the formula with the terms' own ``hw`` (the JAX property reads
    the default ``HW()``, which is the same TPU here)."""
    kw = dict(hlo_flops=3.1e15, hlo_bytes=2.7e12, collective_bytes=4.4e11,
              chips=chips, flops_are_global=flops_are_global)
    cfg = shape = ref_cfg = ref_shape = None
    if cell:
        cfg, shape = get_config(cell[0]), SHAPES[cell[1]]
        ref_cfg, ref_shape = ref_config(cell[0]), REF_SHAPES[cell[1]]
    got = roofline_terms(cfg=cfg, shape=shape, hw=TPU, **kw).to_dict()
    want = ref_roofline.roofline_terms(cfg=ref_cfg, shape=ref_shape,
                                       **kw).to_dict()
    assert got.pop("hw") == dataclasses.asdict(TPU)
    mfu = got.pop("mfu_bound")
    want.pop("mfu_bound")
    assert got == want
    t = max(got["compute_s"], got["memory_s"], got["collective_s"])
    assert mfu == got["model_flops"] / (chips * TPU.peak_flops * t)


def test_mfu_reads_the_terms_hw():
    cfg, shape = get_config("qwen3-14b"), SHAPES["train_4k"]
    a = roofline_terms(hlo_flops=1e18, hlo_bytes=1e12, collective_bytes=0.0,
                       chips=1, cfg=cfg, shape=shape)
    b = roofline_terms(hlo_flops=1e18, hlo_bytes=1e12, collective_bytes=0.0,
                       chips=1, cfg=cfg, shape=shape, hw=TPU)
    assert a.dominant == b.dominant == "compute"
    assert a.mfu == b.mfu  # compute-bound: the peak cancels
    assert a.compute_s == 1e18 / 989.4e12


@pytest.mark.parametrize("flops,bytes_,dominant", [
    (1e15, 1e9, "compute"), (1e9, 1e13, "memory")])
def test_uncounted_collectives_stay_null(flops, bytes_, dominant):
    t = roofline_terms(hlo_flops=flops, hlo_bytes=bytes_,
                       collective_bytes=None, chips=256,
                       flops_are_global=False)
    d = t.to_dict()
    assert d["collective_s"] is None and d["collective_bytes"] is None
    assert d["dominant"] == dominant
    assert t.step_time_s == max(d["compute_s"], d["memory_s"])
