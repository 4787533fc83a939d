"""The quantized dense decoder's full-sequence forward (recompute oracle).

:class:`QuantizedModel` is the serving adapter's input and the ``--check``
oracle: ``logits(tokens)`` recomputes the whole prefix through every block,
with each linear a callable — a :class:`QuantizedLinear` for an artifact, a
dense weight for fp params (:func:`fp_model`).  The quantization pipeline
itself (Hessians, LDLQ, the ``quantize`` CLI) is not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L

__all__ = ["QuantizedModel", "DENSE_LINEARS", "fp_model", "fp_blocks"]

# the per-block linears of the dense family, in the JAX package's order
DENSE_LINEARS = ("attn.wq", "attn.wk", "attn.wv", "attn.wo", "mlp.wi",
                 "mlp.wg", "mlp.wo")


@dataclasses.dataclass
class QuantizedModel:
    """Dense decoder whose block linears are callables (QuantizedLinear)."""

    cfg: object
    embed: dict
    final_norm: dict
    blocks: list  # per layer: dict name -> linear callable, plus norms

    def forward_hidden(self, tokens: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = L.embed(self.embed, tokens)
        positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                                 device=tokens.device)
        for blk in self.blocks:
            x = _quantized_block_forward(blk, x, cfg, positions)
        return L.norm_apply(self.final_norm, x, cfg)

    def logits(self, tokens: torch.Tensor) -> torch.Tensor:
        return L.lm_logits(self.embed, self.forward_hidden(tokens))


def _attn_forward_with_linears(blk, h, cfg, positions):
    """Causal full-sequence attention routed through the block's linears."""
    B, S, _ = h.shape
    q = blk["attn.wq"](h).reshape(B, S, cfg.n_heads, cfg.head_dim)
    k = blk["attn.wk"](h).reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    v = blk["attn.wv"](h).reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = L.rms_norm(q, blk["q_norm"], cfg.norm_eps)
        k = L.rms_norm(k, blk["k_norm"], cfg.norm_eps)
    q = L.rope(q, positions, cfg.rope_theta)
    k = L.rope(k, positions, cfg.rope_theta)
    s = L.gqa_scores(q, k, cfg)
    m = positions[:, None] >= positions[None, :]
    s = torch.where(m, s, torch.tensor(-1e30, dtype=s.dtype, device=s.device))
    o = L.gqa_out(torch.softmax(s, dim=-1), v, cfg)
    o = o.to(h.dtype).reshape(B, S, cfg.q_dim)
    return blk["attn.wo"](o)


def _quantized_block_forward(blk, x, cfg, positions):
    h = L.norm_apply(blk["ln1"], x, cfg)
    x = x + _attn_forward_with_linears(blk, h, cfg, positions)
    h = L.norm_apply(blk["ln2"], x, cfg)
    up = blk["mlp.wi"](h)
    if cfg.mlp == "swiglu":
        up = L.mlp_apply(up, blk["mlp.wg"](h))
    else:
        up = F.gelu(up, approximate="tanh")
    return x + blk["mlp.wo"](up)


def _dense(w: torch.Tensor) -> Callable:
    return lambda x: L.apply_w(w, x)


def fp_blocks(params: dict, cfg) -> list[dict]:
    """Per-layer blocks of dense-weight callables from an fp param tree
    (``{"embed", "layers": [per-layer dict], "final_norm"}``, the JAX
    package's ``unstack_layers`` layout)."""
    blocks = []
    for lp in params["layers"]:
        at, mp = lp["attn"], lp["mlp"]
        blk = {
            "ln1": lp["ln1"],
            "ln2": lp["ln2"],
            "attn.wq": _dense(at["wq"]),
            "attn.wk": _dense(at["wk"]),
            "attn.wv": _dense(at["wv"]),
            "attn.wo": _dense(at["wo"]),
            "mlp.wi": _dense(mp["wi"]),
            "mlp.wo": _dense(mp["wo"]),
        }
        if cfg.mlp == "swiglu":
            blk["mlp.wg"] = _dense(mp["wg"])
        if cfg.qk_norm:
            blk["q_norm"] = at["q_norm"]
            blk["k_norm"] = at["k_norm"]
        blocks.append(blk)
    return blocks


def fp_model(params: dict, cfg) -> QuantizedModel:
    """The recompute oracle over fp params (dense linears)."""
    return QuantizedModel(cfg=cfg, embed=params["embed"],
                          final_norm=params["final_norm"],
                          blocks=fp_blocks(params, cfg))
