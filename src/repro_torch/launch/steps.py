"""Step functions: gradient-accumulated train step, prefill, decode.

``make_train_step`` returns a ``(params, opt_state, batch, step) ->
(params, opt_state, metrics)`` function over the train state in the JAX
package's layout (``convert.stack_layers``: one tensor per leaf, layers
stacked along axis 0), so the optimizer and the checkpoint see the JAX
package's leaves:

  * the forward runs on per-layer views of the stacked leaves
    (``convert.layer_views``), so each layer's gradient lands in its slice
    of the stacked leaf;
  * microbatch gradients of ``ce + aux_coef·aux`` are taken one
    microbatch at a time in the param dtype, each cast to ``accum_dtype``
    before it is added (fp32 by default), and the sum divided by
    ``n_micro`` — the JAX package's ``lax.scan`` accumulation; bf16
    ``.grad`` buffers never accumulate across microbatches;
  * remat comes from the model config (``transformer.remat_wrap`` around
    each block);
  * the optimizer updates params and state in place (the JAX step donates
    both), and ``metrics`` holds the mean ``ce`` as ``loss`` beside the
    optimizer's ``grad_norm``; a MoE model's also its mean load-balancing
    ``aux`` and the ``dropped`` (token, choice) pairs of the step's
    forward (``layers.moe_drops``).

With ``mesh`` (a ``runtime/train_mesh.py`` ``TrainMesh`` of more than one
rank) the state is this rank's blocks under the plan's specs
(``ShardPlan``; every family, every optimizer) and the step is the
one-device step:

  * each data rank takes its rows of every microbatch, after
    ``split_microbatches``, so the data ranks' rows put together are the
    one-device microbatch;
  * the forward runs on the plan's compute layout under its
    ``mesh_context`` (``constrain`` places the collectives);
  * gradients of leaves not sharded over ``data`` are summed over it (a
    ``data``-sharded leaf's by the gather's backward) and every gradient
    is divided by ``n_micro · dp``; ``loss`` is the mean over data ranks;
  * the optimizer runs on the blocks, under the plan's context (the
    global norm is the logical tree's, adafactor's factored means the
    logical leaf's).

A batch that carries more than tokens (encdec's ``frames``, the vlm's
``patches``) is sliced like the tokens: every leaf's rows.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch

from repro_torch.convert import layer_views
from repro_torch.models.layers import moe_drops
from repro_torch.models.lm import Model, build_model
from repro_torch.optim.optimizers import Optimizer
from repro_torch.runtime.sharding import mesh_context
from repro_torch.tree import flatten_with_paths, tree_map, unflatten

__all__ = ["make_train_step", "make_prefill_step", "make_decode_step",
           "split_microbatches"]


def split_microbatches(batch: dict, n_micro: int) -> dict:
    """Reshape every leaf (Bg, ...) -> (n_micro, Bg/n_micro, ...)."""
    def f(x):
        B = x.shape[0]
        if B % n_micro:
            raise ValueError(f"global batch {B} does not split into "
                             f"{n_micro} microbatches")
        return x.reshape(n_micro, B // n_micro, *x.shape[1:])

    return tree_map(f, batch)


def make_train_step(model: Model, optimizer: Optimizer, *,
                    n_micro: Optional[int] = None,
                    accum_dtype=torch.float32, aux_coef: float = 0.01,
                    mesh=None):
    cfg = model.cfg
    plan = None
    if mesh is not None and mesh.size > 1:
        from repro_torch.runtime.train_mesh import ShardPlan

        plan = ShardPlan(cfg, mesh)
        model = build_model(plan.local_cfg)
    dp = plan.mesh.dp if plan else 1

    def train_step(params, opt_state, batch, step):
        Bg = batch["tokens"].shape[0]
        nm = n_micro or max(1, Bg // max(cfg.microbatch, 1))
        micro = split_microbatches(batch, nm)
        if plan:
            micro = plan.data_slice(micro)
        flat = flatten_with_paths(params)
        keys = [k for k, _ in flat]
        leaves = [p.detach().requires_grad_() for _, p in flat]
        tree = unflatten(params, dict(zip(keys, leaves)))
        g_sum = [torch.zeros(p.shape, dtype=accum_dtype, device=p.device)
                 for p in leaves]
        dev = batch["tokens"].device
        loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
        aux_sum = torch.zeros((), dtype=torch.float32, device=dev)
        dropped = torch.zeros((), dtype=torch.int64, device=dev)
        with mesh_context(plan) if plan else contextlib.nullcontext(), \
                moe_drops() as drops:
            views = None if plan else layer_views(tree)
            for i in range(nm):
                mb = tree_map(lambda x: x[i], micro)
                # on a mesh the gathers run per microbatch (their
                # backward returns each gradient to its block)
                v = layer_views(plan.compute(tree)) if plan else views
                loss, metrics = model.loss(v, mb, aux_coef=aux_coef)
                n_fwd = len(drops)  # the forward's, before any recompute
                grads = torch.autograd.grad(loss, leaves, allow_unused=True)
                with torch.no_grad():
                    for acc, g in zip(g_sum, grads):
                        if g is not None:
                            acc.add_(g.to(accum_dtype))
                    loss_sum += metrics["ce"].detach()
                    aux_sum += metrics["aux"].detach()
                    dropped += sum(drops[:n_fwd], torch.zeros_like(dropped))
                    drops.clear()
                del loss, metrics, grads, v
            del views, leaves, tree
            with torch.no_grad():
                if plan:
                    plan.reduce_grads(keys, g_sum)
                    loss_sum = plan.sum_over_data(loss_sum)
                    if cfg.n_experts:
                        aux_sum = plan.sum_over_data(aux_sum)
                        dropped = plan.sum_over_data(dropped)
                grads = unflatten(params, {k: g.div_(nm * dp)
                                           for k, g in zip(keys, g_sum)})
            params, opt_state, opt_metrics = optimizer.update(
                grads, opt_state, params, step)
        out = {"loss": loss_sum / (nm * dp), **opt_metrics}
        if cfg.n_experts:  # the mean aux and the step's dropped pairs
            out.update(aux=aux_sum / (nm * dp), dropped=dropped)
        return params, opt_state, out

    train_step.plan = plan  # the mesh's placement (None on one device)
    return train_step


def make_prefill_step(model: Model, kv_dtype=None):
    """``(params, batch) -> (last-token logits, cache)``, params in the
    train state's stacked layout."""
    @torch.no_grad()
    def prefill_step(params, batch):
        return model.prefill(layer_views(params), batch, kv_dtype=kv_dtype)

    return prefill_step


def make_decode_step(model: Model):
    """``(params, tokens, cache, pos) -> (logits, cache)``, params in the
    train state's stacked layout."""
    @torch.no_grad()
    def decode_step(params, tokens, cache, pos):
        return model.decode_step(layer_views(params), tokens, cache, pos)

    return decode_step
