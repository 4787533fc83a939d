"""Seeded fp parameters of the dense decoder (the JAX package's layout).

The tree is ``{"embed": {"tok", "head"}, "layers": [per-layer dict],
"final_norm": {"scale"}}`` with (in, out) weights — the layout of the JAX
package's ``init_decoder`` after ``unstack_layers``.  The scales are the
JAX package's, and so are the biases (``bq bk bv`` with ``qkv_bias``,
``bi bo`` with ``mlp_bias``): zeros.  The values come from a
``torch.Generator``, so they differ from ``jax.random``'s (tests convert
the JAX package's params instead).
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DEFAULT_DEVICE, resolve_device

__all__ = ["init_decoder", "decoder_axes"]


def init_decoder(cfg: ArchConfig, generator: torch.Generator, *,
                 device=DEFAULT_DEVICE) -> dict:
    device = resolve_device(device)
    dt = getattr(torch, cfg.dtype)
    d, f = cfg.d_model, cfg.d_ff
    resid = 1.0 / math.sqrt(2 * max(cfg.n_layers, 1))

    def w(shape, std=None):
        std = shape[0] ** -0.5 if std is None else std
        return (torch.randn(shape, generator=generator, device=device)
                * std).to(dt)

    def ones(n):
        return {"scale": torch.ones(n, dtype=dt, device=device)}

    def zeros(n):
        return torch.zeros(n, dtype=dt, device=device)

    embed = {"tok": w((cfg.vocab, d), 0.02)}
    if not cfg.tie_embeddings:
        embed["head"] = w((d, cfg.vocab), d**-0.5)
    layers = []
    for _ in range(cfg.n_layers):
        attn = {
            "wq": w((d, cfg.q_dim)),
            "wk": w((d, cfg.kv_dim)),
            "wv": w((d, cfg.kv_dim)),
            "wo": w((cfg.q_dim, d), cfg.q_dim**-0.5 * resid),
        }
        if cfg.qkv_bias:
            attn.update(bq=zeros(cfg.q_dim), bk=zeros(cfg.kv_dim),
                        bv=zeros(cfg.kv_dim))
        if cfg.qk_norm:
            attn["q_norm"] = ones(cfg.head_dim)["scale"]
            attn["k_norm"] = ones(cfg.head_dim)["scale"]
        mlp = {"wi": w((d, f)), "wo": w((f, d), f**-0.5 * resid)}
        if cfg.mlp == "swiglu":
            mlp["wg"] = w((d, f))
        if cfg.mlp_bias:
            mlp.update(bi=zeros(f), bo=zeros(d))
        layers.append({"ln1": ones(d), "attn": attn, "ln2": ones(d),
                       "mlp": mlp})
    return {"embed": embed, "layers": layers, "final_norm": ones(d)}


def decoder_axes(cfg: ArchConfig) -> dict:
    """Logical axes of the :func:`init_decoder` tree: ``{"embed", "layers",
    "final_norm"}``, with ``"layers"`` one per-layer dict that holds for
    every layer (the port keeps layers unstacked).  Weights are (in, out)."""
    attn = {"wq": ("embed", "heads"), "wk": ("embed", "kv_heads"),
            "wv": ("embed", "kv_heads"), "wo": ("heads", "embed")}
    if cfg.qkv_bias:
        attn.update(bq=("heads",), bk=("kv_heads",), bv=("kv_heads",))
    if cfg.qk_norm:
        attn.update(q_norm=("norm",), k_norm=("norm",))
    mlp = {"wi": ("embed", "ff"), "wo": ("ff", "embed")}
    if cfg.mlp == "swiglu":
        mlp["wg"] = ("embed", "ff")
    if cfg.mlp_bias:
        mlp.update(bi=("ff",), bo=("norm",))
    embed = {"tok": ("vocab", "embed")}
    if not cfg.tie_embeddings:
        embed["head"] = ("embed", "vocab")
    norm = {"scale": ("norm",)}
    return {"embed": embed,
            "layers": {"ln1": norm, "attn": attn, "ln2": norm, "mlp": mlp},
            "final_norm": norm}
