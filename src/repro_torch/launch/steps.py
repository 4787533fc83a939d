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
    optimizer's ``grad_norm``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.convert import layer_views
from repro_torch.models.lm import Model
from repro_torch.optim.optimizers import Optimizer
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
                    accum_dtype=torch.float32, aux_coef: float = 0.01):
    cfg = model.cfg

    def train_step(params, opt_state, batch, step):
        Bg = batch["tokens"].shape[0]
        nm = n_micro or max(1, Bg // max(cfg.microbatch, 1))
        micro = split_microbatches(batch, nm)
        flat = flatten_with_paths(params)
        keys = [k for k, _ in flat]
        leaves = [p.detach().requires_grad_() for _, p in flat]
        views = layer_views(unflatten(params, dict(zip(keys, leaves))))
        g_sum = [torch.zeros(p.shape, dtype=accum_dtype, device=p.device)
                 for p in leaves]
        loss_sum = torch.zeros((), dtype=torch.float32,
                               device=batch["tokens"].device)
        for i in range(nm):
            mb = tree_map(lambda x: x[i], micro)
            loss, metrics = model.loss(views, mb, aux_coef=aux_coef)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            with torch.no_grad():
                for acc, g in zip(g_sum, grads):
                    if g is not None:
                        acc.add_(g.to(accum_dtype))
                loss_sum += metrics["ce"].detach()
            del loss, metrics, grads
        del views, leaves
        with torch.no_grad():
            grads = unflatten(params, {k: g.div_(nm)
                                       for k, g in zip(keys, g_sum)})
        params, opt_state, opt_metrics = optimizer.update(
            grads, opt_state, params, step)
        return params, opt_state, {"loss": loss_sum / nm, **opt_metrics}

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
