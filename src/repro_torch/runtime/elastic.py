"""Elastic re-mesh: the mesh and its rules after losing devices.

The JAX package's ``runtime/elastic.py``.  Checkpoints store logical
(unsharded) tensors (``checkpoint/store.py``), so a resume onto a degraded
device set is: pick the best mesh for the devices that remain, re-derive
the specs from the same logical-axis rules, and restore.  Losing a pod
degrades (pod 2, data 16, model 16) to (data 16, model 16); losing cards
within a pod degrades the data axis first (model-parallel groups stay
whole so per-device weight shards keep fitting in memory).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

from repro_torch.runtime.sharding import (
    AbstractMesh,
    ShardingContext,
    default_rules,
)

__all__ = ["best_mesh_shape", "remesh"]


def best_mesh_shape(
    n_devices: int, *, model_parallelism: int = 16, max_pod: int = 16 * 16
) -> tuple[tuple[int, ...], tuple[str, ...]]:
    """Largest usable (pod, data, model) grid for a degraded device count.

    Keeps the model axis whole; spends the loss on data parallelism; drops
    the pod axis when fewer than 2 full pods remain.  Remainder devices
    stay idle (hot spares)."""
    model = min(model_parallelism, max(n_devices, 1))
    groups = n_devices // model
    if groups == 0:
        model, groups = 1, n_devices
    data_per_pod = max(max_pod // model, 1)
    if groups >= 2 * data_per_pod:
        pods = groups // data_per_pod
        return (pods, data_per_pod, model), ("pod", "data", "model")
    return (groups, model), ("data", "model")


def remesh(
    n_devices: Optional[int] = None,
    *,
    model_parallelism: int = 16,
    devices: Optional[Sequence] = None,
) -> ShardingContext:
    """The sharding context for however many devices are still healthy:
    an :class:`AbstractMesh` over the first ``used`` devices (the cards
    ``torch.cuda.device_count()`` counts, unless ``devices`` is given) with
    :func:`default_rules`.  Builds no process group."""
    if devices is None:
        import torch

        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devices = list(devices)
    n = n_devices if n_devices is not None else len(devices)
    shape, axes = best_mesh_shape(n, model_parallelism=model_parallelism)
    used = math.prod(shape)
    if used > len(devices):
        raise ValueError(f"a {shape} mesh needs {used} devices, "
                         f"{len(devices)} given")
    mesh = AbstractMesh(tuple(zip(axes, shape)), tuple(devices[:used]))
    return ShardingContext(mesh=mesh,
                           rules=default_rules(multi_pod=len(shape) == 3))
