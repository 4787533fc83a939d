"""Three-term roofline model of one step from its op analysis.

    compute term    = op FLOPs / (chips · peak FLOP/s)
    memory term     = op bytes / (chips · memory rate)
    collective term = collective bytes / (chips · link rate)

The JAX package's ``runtime/roofline.py`` with H100 constants: :class:`HW`
defaults to the NVIDIA H100 SXM's datasheet figures (the card the port
runs on, ``NVIDIA H100 80GB HBM3, 700.00 W``): dense bf16 989.4 TFLOP/s,
HBM3 3.35 TB/s, NVLink 450 GB/s per direction per card.  They are the
datasheet's, not measured.  The FLOPs and bytes come from
:mod:`repro_torch.runtime.op_analysis`.

MODEL_FLOPS (useful work) is 6·N·D for training and 2·N·D for a
forward-only step (N = params, active params for MoE; D = tokens the
step processes), giving the MODEL_FLOPS / op-FLOPs "usefulness" ratio
that shows recompute and redundancy.

A term that was not counted is ``None`` (a multi-card cell's collectives
while the port's step is one process's program); ``dominant`` and the
step bound are taken over the terms that were counted.  ``mfu`` reads the
peak of the ``hw`` the terms were built with (the JAX property reads the
default ``HW()``'s whatever was passed).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.configs.base import ArchConfig, ShapeSpec

__all__ = ["HW", "RooflineTerms", "roofline_terms", "model_flops"]


@dataclasses.dataclass(frozen=True)
class HW:
    name: str = "h100_sxm"
    peak_flops: float = 989.4e12  # dense bf16 FLOP/s per card (datasheet)
    hbm_bw: float = 3.35e12  # HBM3 bytes/s per card (datasheet)
    link_bw: float = 450e9  # NVLink bytes/s per card, one direction


@dataclasses.dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: Optional[float]
    hlo_flops: float
    hlo_bytes: float
    collective_bytes: Optional[float]
    model_flops: float
    chips: int
    hw: HW = HW()

    def _counted(self) -> dict:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return {k: v for k, v in terms.items() if v is not None}

    @property
    def dominant(self) -> str:
        terms = self._counted()
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Lower bound assuming perfect overlap: max of the counted terms."""
        return max(self._counted().values())

    @property
    def hlo_flops_global(self) -> float:
        """``hlo_flops`` is per device; the program is symmetric."""
        return self.hlo_flops * self.chips

    @property
    def useful_ratio(self) -> float:
        """MODEL_FLOPS / global op FLOPs (recompute and redundancy)."""
        g = self.hlo_flops_global
        return self.model_flops / g if g else 0.0

    @property
    def mfu(self) -> float:
        """Model-FLOPs utilization at the roofline-bound step time."""
        t = self.step_time_s
        if not t:
            return 0.0
        return self.model_flops / (self.chips * self.hw.peak_flops * t)

    def to_dict(self) -> dict:
        return {
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "hlo_flops": self.hlo_flops,
            "hlo_bytes": self.hlo_bytes,
            "collective_bytes": self.collective_bytes,
            "hlo_flops_global": self.hlo_flops_global,
            "model_flops": self.model_flops,
            "useful_ratio": self.useful_ratio,
            "mfu_bound": self.mfu,
            "chips": self.chips,
            "hw": dataclasses.asdict(self.hw),
        }


def model_flops(cfg: ArchConfig, shape: ShapeSpec) -> float:
    """Useful FLOPs per step: 6·N_active·tokens (train), 2·N_active·tokens
    (forward-only prefill / decode)."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch  # decode: one token a sequence


def roofline_terms(
    *,
    hlo_flops: float,
    hlo_bytes: float,
    collective_bytes: Optional[float],
    chips: int,
    cfg: Optional[ArchConfig] = None,
    shape: Optional[ShapeSpec] = None,
    hw: HW = HW(),
    flops_are_global: bool = True,
) -> RooflineTerms:
    """``flops_are_global=False`` when the counts are one device's
    (the op analysis of one process's step is).  ``collective_bytes``
    ``None`` (not counted) gives ``collective_s`` ``None``."""
    div = chips if flops_are_global else 1
    mf = model_flops(cfg, shape) if (cfg and shape) else 0.0
    if collective_bytes is None:
        coll_s = None
    elif flops_are_global:
        coll_s = collective_bytes / div / hw.link_bw
    else:
        coll_s = collective_bytes / hw.link_bw
    return RooflineTerms(
        compute_s=hlo_flops / div / hw.peak_flops,
        memory_s=hlo_bytes / div / hw.hbm_bw,
        collective_s=coll_s,
        hlo_flops=hlo_flops,
        hlo_bytes=hlo_bytes,
        collective_bytes=collective_bytes,
        model_flops=mf,
        chips=chips,
        hw=hw,
    )
