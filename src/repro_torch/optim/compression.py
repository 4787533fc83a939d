"""int8 error-feedback gradient compression.

Each leaf is quantized to int8 with one absmax scale per leaf (a stacked
``(L, ...)`` leaf takes one scale for all its layers, as in the JAX
package), and the quantization residual is kept in an error-feedback
buffer that is added back the next step.  ``torch.round`` rounds half to
even, as ``jnp.round`` does, so the payloads equal the JAX package's.
"""
from __future__ import annotations

import torch

from repro_torch.tree import flatten_with_paths, tree_map, unflatten

__all__ = ["init_ef_state", "ef_int8_compress", "ef_int8_decompress"]


def init_ef_state(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def _compress_leaf(g: torch.Tensor, e: torch.Tensor):
    gf = g.to(torch.float32) + e
    scale = torch.max(torch.abs(gf)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    err = gf - q.to(torch.float32) * scale
    return q, scale, err


def ef_int8_compress(grads, ef_state):
    """-> (int8 tree, scale tree, new ef_state)."""
    errs = dict(flatten_with_paths(ef_state))
    out = {k: _compress_leaf(g, errs[k]) for k, g in flatten_with_paths(grads)}
    return tuple(unflatten(grads, {k: o[i] for k, o in out.items()})
                 for i in range(3))


def ef_int8_decompress(qs, scales):
    return tree_map(lambda q, s: q.to(torch.float32) * s, qs, scales)
