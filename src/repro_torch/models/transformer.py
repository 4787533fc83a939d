"""Decoder-only transformer stack (the dense and moe families).

The tree is ``{"embed": {"tok", "head"}, "layers": [per-layer dict],
"final_norm": {"scale"}}`` with (in, out) weights — the layout of the JAX
package's ``init_decoder`` after ``unstack_layers``: the port keeps layers
as a list and applies them in a Python loop where the JAX package stacks
them and scans.  A moe layer holds ``"moe"`` (router, experts, arctic's
dense residual) where a dense layer holds ``"mlp"``.  The scales are the
JAX package's, and so are the biases (``bq bk bv`` with ``qkv_bias``,
``bi bo`` with ``mlp_bias``): zeros.  The values come from a
``torch.Generator``, so they differ from ``jax.random``'s (tests convert
the JAX package's params instead).

Serving without the engine goes through a dense batch cache, one
``{"k", "v"}`` of (B, max_len, KV, hd) per layer (``"k_scale"`` and
``"v_scale"`` too when int8): :func:`decoder_prefill` builds it,
:func:`decoder_decode_step` extends it by one token.
``decoder_forward(plain=True)`` runs packed projections through
quant_matmul's plain version (the oracle's path).

While grad is enabled, each block of a forward runs under the config's
activation checkpointing (:func:`remat_wrap`, ``cfg.remat``); serving runs
under ``no_grad`` and never checkpoints.

Under a training mesh (``runtime/train_mesh.py``) attention is
head-parallel, the MLP (and arctic's dense residual) ``ff``-parallel, a
moe layer's experts expert-parallel (each rank its ``E/mp`` experts, the
router whole on every rank: ``layers.moe_apply``) and the embedding and
LM head vocab-parallel; the norms compute whole on every rank.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.models import layers as L

__all__ = [
    "remat_wrap",
    "init_decoder",
    "decoder_axes",
    "decoder_forward",
    "decoder_prefill",
    "decoder_decode_step",
    "init_decoder_cache",
    "decoder_cache_axes",
]


def _dots_saveable():
    save = {torch.ops.aten.mm.default, torch.ops.aten.addmm.default}

    def policy(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in save
                else CheckpointPolicy.PREFER_RECOMPUTE)

    return create_selective_checkpoint_contexts(policy)


def remat_wrap(fn, cfg: ArchConfig):
    """``fn`` under ``cfg.remat`` while grad is enabled: ``"full"`` keeps
    only the block's inputs and recomputes it in the backward, ``"dots"``
    also keeps the outputs of its matmuls without batch dims (``mm``,
    ``addmm``: the projections), the counterpart of
    ``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``.  With
    ``"none"``, or under ``no_grad``, ``fn`` runs as it is."""
    if cfg.remat == "none":
        return fn
    if cfg.remat not in ("full", "dots"):
        raise ValueError(f"remat must be 'none', 'full' or 'dots', got "
                         f"{cfg.remat!r}")
    extra = {"context_fn": _dots_saveable} if cfg.remat == "dots" else {}

    def wrapped(*args, **kwargs):
        if not torch.is_grad_enabled():
            return fn(*args, **kwargs)
        return checkpoint(fn, *args, use_reentrant=False, **extra, **kwargs)

    return wrapped


def init_decoder(cfg: ArchConfig, generator: torch.Generator, *,
                 device=DEFAULT_DEVICE) -> dict:
    device = resolve_device(device)
    d = cfg.d_model
    embed = L.init_embedding(generator, cfg, device=device)
    layers = []
    for _ in range(cfg.n_layers):
        lp = {"ln1": L.init_norm(cfg, d, device=device),
              "attn": L.init_attention(generator, cfg, device=device),
              "ln2": L.init_norm(cfg, d, device=device)}
        if cfg.n_experts:
            lp["moe"] = L.init_moe(generator, cfg, device=device)
        else:
            lp["mlp"] = L.init_mlp(generator, cfg, device=device)
        layers.append(lp)
    return {"embed": embed, "layers": layers,
            "final_norm": L.init_norm(cfg, d, device=device)}


def decoder_axes(cfg: ArchConfig) -> dict:
    """Logical axes of the :func:`init_decoder` tree: ``{"embed", "layers",
    "final_norm"}``, with ``"layers"`` one per-layer dict that holds for
    every layer (the port keeps layers unstacked).  Weights are (in, out)."""
    layer = {"ln1": L.norm_axes(), "attn": L.attention_axes(cfg),
             "ln2": L.norm_axes()}
    if cfg.n_experts:
        layer["moe"] = L.moe_axes(cfg)
    else:
        layer["mlp"] = L.mlp_axes(cfg)
    return {"embed": L.embedding_axes(cfg), "layers": layer,
            "final_norm": L.norm_axes()}


def _ffn(lp: dict, h: torch.Tensor, cfg: ArchConfig, plain: bool = False):
    if cfg.n_experts:
        return L.moe_apply(lp["moe"], h, cfg, plain=plain)
    return L.mlp_apply(lp["mlp"], h, cfg, plain=plain), None


def _block_apply(lp, x, cfg: ArchConfig, positions, *, plain: bool = False):
    """-> (x, aux or None, post-RoPE (k, v))."""
    h = L.norm_apply(lp["ln1"], x, cfg)
    a, kv = L.attention_full(lp["attn"], h, cfg, positions=positions,
                             return_kv=True, plain=plain)
    x = x + a
    f, aux = _ffn(lp, L.norm_apply(lp["ln2"], x, cfg), cfg, plain)
    return x + f, aux, kv


def _positions(tokens: torch.Tensor) -> torch.Tensor:
    return torch.arange(tokens.shape[1], dtype=torch.int32,
                        device=tokens.device)


def decoder_forward(params: dict, tokens: torch.Tensor, cfg: ArchConfig, *,
                    plain: bool = False):
    """tokens (B, S) -> (hidden (B, S, D), aux_loss / n_layers)."""
    x = L.embed(params["embed"], tokens)
    positions = _positions(tokens)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    block = remat_wrap(_block_apply, cfg)
    for lp in params["layers"]:
        x, a, _ = block(lp, x, cfg, positions, plain=plain)
        if a is not None:
            aux = aux + a
    x = L.norm_apply(params["final_norm"], x, cfg)
    return x, aux / cfg.n_layers


def init_decoder_cache(cfg: ArchConfig, batch: int, max_len: int,
                       kv_dtype=None, *, device=DEFAULT_DEVICE) -> list:
    """One zero :func:`~repro_torch.models.layers.init_kv_cache` per
    layer."""
    device = resolve_device(device)
    return [L.init_kv_cache(cfg, batch, max_len, kv_dtype, device=device)
            for _ in range(cfg.n_layers)]


def decoder_cache_axes(cfg: ArchConfig, int8: bool = False) -> dict:
    """The axes of one layer's cache (every layer has the same)."""
    return L.kv_cache_axes(int8)


def decoder_prefill(params: dict, tokens: torch.Tensor, cfg: ArchConfig,
                    kv_dtype=None, max_len=None):
    """Forward the full prompt, building the per-layer KV caches.

    ``max_len`` reserves cache room beyond the prompt (the decode budget).
    Returns (last-token logits (B, V), caches)."""
    B, S = tokens.shape
    x = L.embed(params["embed"], tokens)
    positions = _positions(tokens)
    caches = []
    for lp in params["layers"]:
        x, _, (k, v) = _block_apply(lp, x, cfg, positions)
        cache0 = L.init_kv_cache(cfg, B, max_len or S, kv_dtype,
                                 device=x.device)
        caches.append(L.cache_store(cache0, k, v, 0))
    x = L.norm_apply(params["final_norm"], x, cfg)
    return L.lm_logits(params["embed"], x[:, -1:, :])[:, 0], caches


def decoder_decode_step(params: dict, tokens: torch.Tensor, cfg: ArchConfig,
                        cache: list, pos: int):
    """One decode step: tokens (B, 1) at position ``pos``.  Returns
    (logits (B, V), new caches)."""
    x = L.embed(params["embed"], tokens)
    new = []
    for lp, cache_l in zip(params["layers"], cache):
        h = L.norm_apply(lp["ln1"], x, cfg)
        a, c = L.attention_decode(lp["attn"], h, cfg, cache_l, pos)
        new.append(c)
        x = x + a
        f, _ = _ffn(lp, L.norm_apply(lp["ln2"], x, cfg), cfg)
        x = x + f
    x = L.norm_apply(params["final_norm"], x, cfg)
    return L.lm_logits(params["embed"], x)[:, 0], new
