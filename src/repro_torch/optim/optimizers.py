"""Optimizers as (init, update) pairs over trees of tensors (optax-style).

Plain functions over nested dicts, not ``torch.optim``: the state's tree
is the checkpoint's tree, with the JAX package's keys.  Mixed precision:
params may be bf16; the optimizer keeps an fp32 master copy (never an
alias of an fp32 param) and fp32 moments, and re-casts the updated master
into the params ("params = cast(master)").  ``adafactor`` factors the
second moment of every leaf with ``ndim >= 2`` — over a layer-stacked
tree, the JAX package's leaves, so a stacked ``(L, d)`` norm scale gets
row and column moments as it does there.

``update(grads, state, params, step) -> (params, state, {"grad_norm"})``
writes the new values into ``params`` and ``state`` in place and returns
them: the counterpart of the JAX train step donating both, so a step at
full width holds one copy of the state, not two.  The caller must not
keep the old values.  ``step`` is an int or a 0-d tensor; ``t = step +
1`` and the lr are fp32, as in the JAX package.

Over a training mesh (a ``ShardPlan`` active through
``runtime/sharding.py``'s ``mesh_context``) the trees hold this rank's
blocks: adamw and sgd are elementwise and run on them as they are, and
:func:`global_norm` sums the squares of each block, counts a replicated
leaf once and adds over the mesh, so the norm and the clip scale are the
one-device ones.  adafactor's factored moments reduce over a leaf's last
two dims, which the mesh may shard: a mean over a sharded dim is the
local sum summed over that axis in rank order, divided by the full size
(:func:`_mean`); its row and column moments are stored as the plan's
``state_specs`` place them.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.runtime.sharding import current_mesh_context
from repro_torch.tree import tree_leaves, tree_map

__all__ = ["Optimizer", "adamw", "adafactor", "sgd", "global_norm",
           "clip_by_global_norm"]

_F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable  # params -> state
    update: Callable  # (grads, state, params, step) -> (params, state, metrics)
    name: str = ""


def global_norm(tree) -> torch.Tensor:
    """The L2 norm of every leaf; under a training mesh ``tree`` is the
    params' tree of this rank's blocks and the norm is the logical
    tree's."""
    ctx = current_mesh_context()
    if ctx is not None:
        return torch.sqrt(ctx.sum_squares(tree))
    return torch.sqrt(sum(torch.sum(torch.square(x.to(_F32)))
                          for x in tree_leaves(tree)))


def clip_by_global_norm(grads, max_norm: float):
    g32, gn = _clipped(grads, max_norm)
    return tree_map(g32, grads), gn


def _lr_fn(lr):
    return lr if callable(lr) else (lambda _: lr)


def _t(step) -> torch.Tensor:
    return torch.as_tensor(step).to(_F32) + 1.0


def _master(params):
    # a copy even for fp32 params: the master is updated in place
    return tree_map(lambda p: p.to(_F32, copy=True), params)


def _zeros(shape, p):
    return torch.zeros(shape, dtype=_F32, device=p.device)


def _clipped(grads, clip_norm):
    """(leaf -> its fp32 grad, global norm), the grad scaled by
    ``min(1, clip_norm / (norm + 1e-9))`` when ``clip_norm`` is set; the
    optimizers apply it one leaf at a time, so no fp32 copy of the whole
    tree is made."""
    gn = global_norm(grads)
    if clip_norm is None:
        return (lambda g: g.to(_F32)), gn
    scale = torch.clamp(clip_norm / (gn + 1e-9), max=1.0)
    return (lambda g: g.to(_F32) * scale), gn


def adamw(lr: Callable | float, *, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.1,
          clip_norm: Optional[float] = 1.0) -> Optimizer:
    lr_fn = _lr_fn(lr)

    def init(params):
        return {"master": _master(params),
                "m": tree_map(lambda p: _zeros(p.shape, p), params),
                "v": tree_map(lambda p: _zeros(p.shape, p), params)}

    @torch.no_grad()
    def update(grads, state, params, step):
        g32, gn = _clipped(grads, clip_norm)
        t = _t(step)
        lr_t = lr_fn(step)
        bc1 = 1.0 - b1**t
        bc2 = 1.0 - b2**t

        def upd(g, m, v, master, p):
            g = g32(g)
            m.copy_(b1 * m + (1 - b1) * g)
            v.copy_(b2 * v + (1 - b2) * g * g)
            mh = m / bc1
            vh = v / bc2
            master.copy_(master - lr_t * (
                mh / (torch.sqrt(vh) + eps) + weight_decay * master))
            p.copy_(master)

        tree_map(upd, grads, state["m"], state["v"], state["master"], params)
        return params, state, {"grad_norm": gn}

    return Optimizer(init=init, update=update, name="adamw")


def _mean(x: torch.Tensor, dim: int, axis, keepdim: bool = False):
    """The mean of ``x`` over ``dim`` (of the logical leaf): where the
    mesh axis ``axis`` shards that dim, the local sum summed over the axis
    in rank order and divided by the full size; else ``torch.mean``."""
    ctx = current_mesh_context()
    if ctx is None or axis is None:
        return torch.mean(x, dim=dim, keepdim=keepdim)
    if not isinstance(axis, str):
        raise ValueError(f"a dim sharded over several mesh axes {axis}")
    comm = ctx.axis_comm(axis)
    total = comm.all_reduce_sum([torch.sum(x, dim=dim, keepdim=keepdim)])[0]
    return total / (x.shape[dim] * comm.size)


def adafactor(lr: Callable | float, *, decay: float = 0.8, eps: float = 1e-30,
              clip_norm: Optional[float] = 1.0) -> Optimizer:
    """Factored second moment for >=2D leaves (memory ~ O(m+n) per
    matrix)."""
    lr_fn = _lr_fn(lr)

    def moment_shapes(p):
        if p.ndim >= 2:
            return (_zeros(p.shape[:-1], p),  # row
                    _zeros(p.shape[:-2] + p.shape[-1:], p))  # col
        return (_zeros(p.shape, p), None)

    def init(params):
        return {"master": _master(params),
                "moments": tree_map(moment_shapes, params)}

    @torch.no_grad()
    def update(grads, state, params, step):
        g32, gn = _clipped(grads, clip_norm)
        t = _t(step)
        beta = 1.0 - t ** (-decay)
        lr_t = lr_fn(step)
        # each leaf's spec on a mesh (which axes shard its last two dims)
        ctx = current_mesh_context()
        specs = ctx.specs if ctx is not None else tree_map(
            lambda p: (None,) * p.ndim, params)

        def upd(g, mom, master, p, spec):
            g = g32(g)
            row, col = mom
            g2 = g * g + eps
            if g.ndim >= 2:
                row.copy_(beta * row + (1 - beta) * _mean(g2, -1, spec[-1]))
                col.copy_(beta * col + (1 - beta) * _mean(g2, -2, spec[-2]))
                denom = torch.sqrt(
                    row[..., None] * col[..., None, :]
                    / (_mean(row, -1, spec[-2], keepdim=True)[..., None]
                       + eps))
                upd_val = g / (denom + 1e-9)
            else:
                row.copy_(beta * row + (1 - beta) * g2)
                upd_val = g / (torch.sqrt(row) + 1e-9)
            master.copy_(master - lr_t * upd_val)
            p.copy_(master)

        tree_map(upd, grads, state["moments"], state["master"], params,
                 specs)
        return params, state, {"grad_norm": gn}

    return Optimizer(init=init, update=update, name="adafactor")


def sgd(lr: Callable | float, momentum: float = 0.0) -> Optimizer:
    lr_fn = _lr_fn(lr)

    def init(params):
        if momentum:
            return {"mom": tree_map(lambda p: _zeros(p.shape, p), params)}
        return {}

    @torch.no_grad()
    def update(grads, state, params, step):
        lr_t = lr_fn(step)
        gn = global_norm(grads)
        if momentum:
            def upd(g, m, p):
                m.copy_(momentum * m + g.to(_F32))
                p.copy_(p.to(_F32) - lr_t * m)

            tree_map(upd, grads, state["mom"], params)
        else:
            tree_map(lambda g, p: p.copy_(p.to(_F32) - lr_t * g.to(_F32)),
                     grads, params)
        return params, state, {"grad_norm": gn}

    return Optimizer(init=init, update=update, name="sgd")
