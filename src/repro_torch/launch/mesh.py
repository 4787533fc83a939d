"""Production mesh construction.

Functions, not module constants, and neither touches a device: a mesh
here is an :class:`~repro_torch.runtime.sharding.AbstractMesh`, a
description the dry run resolves specs on.  Single pod: 16 × 16 = 256
chips.  Multi-pod: 2 pods × 256 = 512 chips with a leading 'pod' axis
extending data parallelism.
"""
from __future__ import annotations

from repro_torch.runtime.sharding import AbstractMesh

__all__ = ["make_production_mesh", "make_host_mesh"]


def make_production_mesh(*, multi_pod: bool = False, shape=None,
                         devices=None) -> AbstractMesh:
    """The default production grids; ``shape`` re-slices the same chips
    (e.g. (256, 1) = pure ZeRO for models whose sharded weights fit
    without tensor parallelism)."""
    if shape is None:
        shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {tuple(shape)} does not match the "
                         f"axes {axes}")
    return AbstractMesh(tuple(zip(axes, (int(s) for s in shape))),
                        None if devices is None else tuple(devices))


def make_host_mesh() -> AbstractMesh:
    """Degenerate 1 × 1 mesh for single-device runs."""
    return AbstractMesh((("data", 1), ("model", 1)))
