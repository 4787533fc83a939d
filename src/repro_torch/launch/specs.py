"""``meta``-tensor stand-ins for every model input (the dry run's inputs).

The JAX package's ``launch/specs.py`` with ``meta`` tensors in place of
``jax.ShapeDtypeStruct``: shapes and dtypes, no data, no device memory.
``input_specs`` covers the data inputs per shape kind; params, optimizer
state and cache come from ``Model.abstract_params`` /
:func:`abstract_opt_state` / ``Model.abstract_cache``.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.models.layers import _dtype

__all__ = ["input_specs", "abstract_opt_state"]


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ArchConfig, shape: ShapeSpec) -> dict:
    """Data inputs for the step function of this (arch, shape) cell."""
    B, S = shape.global_batch, shape.seq_len
    dt = _dtype(cfg)
    if shape.kind in ("train", "prefill"):
        batch = {"tokens": _meta((B, S), torch.int32)}
        if shape.kind == "train":
            batch["targets"] = _meta((B, S), torch.int32)
        if cfg.family == "encdec":
            batch["frames"] = _meta((B, S, cfg.d_model), dt)
        if cfg.family == "vlm":
            batch["patches"] = _meta((B, cfg.n_patches, cfg.d_model), dt)
        return {"batch": batch}
    # decode: one new token against a seq_len-deep cache / state
    return {"tokens": _meta((B, 1), torch.int32),
            "pos": _meta((), torch.int32)}


def abstract_opt_state(optimizer, abstract_params):
    """The optimizer's state over ``abstract_params`` on ``meta`` (its
    ``init`` run on meta tensors allocates nothing)."""
    return optimizer.init(abstract_params)
