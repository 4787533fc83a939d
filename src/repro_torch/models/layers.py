"""Primitive layers of the dense decoder's serving path.

Functional, on plain tensors, with the JAX package's layouts and masking
convention (masked scores are set to ``finfo(float32).min``), so the
tests compare like with like.  Attention scores and outputs accumulate in
fp32 whatever the storage dtype; probabilities are cast down to V's dtype
for the PV product, as the JAX package does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig

__all__ = [
    "NEG",
    "matmul",
    "apply_w",
    "rms_norm",
    "norm_apply",
    "rope",
    "gqa_scores",
    "gqa_out",
    "embed",
    "lm_logits",
    "mlp_act",
    "mlp_apply",
    "quantize_kv",
    "attend",
    "project_qkv",
    "attention_full",
]

NEG = torch.finfo(torch.float32).min


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in the promoted dtype of the two (JAX's promotion: an fp32
    activation against a bf16 weight computes in fp32)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


def apply_w(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y = x @ W for a dense (in, out) weight."""
    return matmul(x, w)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return ((xf * torch.rsqrt(var + eps)) * scale.to(torch.float32)).to(x.dtype)


def norm_apply(p: dict, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    return rms_norm(x, p["scale"], cfg.norm_eps)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate pairs (llama rotate-half convention).

    x: (..., S, H, hd); positions: (S,) or (B, S) int.
    """
    hd = x.shape[-1]
    half = hd // 2
    freqs = theta ** (
        -torch.arange(half, dtype=torch.float32, device=x.device) / half
    )
    ang = positions[..., None].to(torch.float32) * freqs  # (..., S, half)
    cos = torch.cos(ang)[..., None, :]  # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1 = x[..., :half].to(torch.float32)
    x2 = x[..., half:].to(torch.float32)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def gqa_scores(q: torch.Tensor, k: torch.Tensor,
               cfg: ArchConfig) -> torch.Tensor:
    """q: (B, Sq, H, hd), k: (B, Skv, KV, hd) -> (B, KV, G, Sq, Skv) fp32.

    Grouped einsum: the repeated-KV operand is never materialized."""
    B, Sq, H, hd = q.shape
    G = H // cfg.n_kv_heads
    qg = q.reshape(B, Sq, cfg.n_kv_heads, G, hd).to(torch.float32)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.to(torch.float32))
    return s * (hd**-0.5)


def gqa_out(probs: torch.Tensor, v: torch.Tensor,
            cfg: ArchConfig) -> torch.Tensor:
    """probs: (B, KV, G, Sq, Skv), v: (B, Skv, KV, hd) -> (B, Sq, H, hd) fp32.

    probs are rounded to v's storage dtype, then accumulated in fp32."""
    B, KV, G, Sq, Skv = probs.shape
    p = probs.to(v.dtype).to(torch.float32)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.to(torch.float32))
    return o.reshape(B, Sq, cfg.n_heads, cfg.head_dim)


def embed(p: dict, tokens: torch.Tensor) -> torch.Tensor:
    return p["tok"][tokens]


def lm_logits(p: dict, h: torch.Tensor) -> torch.Tensor:
    w = p["head"] if "head" in p else p["tok"].T
    return matmul(h, w)


def mlp_act(up: torch.Tensor, gate, cfg: ArchConfig) -> torch.Tensor:
    """The nonlinearity between the up (and gate) and down projections:
    swiglu's ``silu(up) · gate``, or GeLU in the tanh approximation (the
    default of ``jax.nn.gelu``), which takes no gate (``gate=None``)."""
    if cfg.mlp == "swiglu":
        return F.silu(up) * gate
    return F.gelu(up, approximate="tanh")


def mlp_apply(p: dict, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """The dense family's MLP from fp params (``wi wo``, ``wg`` for swiglu,
    ``bi``/``bo`` with ``mlp_bias``)."""
    h = apply_w(p["wi"], x)
    if cfg.mlp_bias:
        h = h + p["bi"]
    gate = apply_w(p["wg"], x) if cfg.mlp == "swiglu" else None
    out = apply_w(p["wo"], mlp_act(h, gate, cfg))
    if cfg.mlp_bias:
        out = out + p["bo"]
    return out


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-(token, head) symmetric int8 over the last axis of (..., hd)."""
    xf = x.to(torch.float32)
    scale = torch.amax(torch.abs(xf), dim=-1) / 127.0
    scale = torch.clamp(scale, min=1e-8)
    q = torch.round(xf / scale[..., None])
    return q.to(torch.int8), scale


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           positions: torch.Tensor, cfg: ArchConfig, *,
           causal: bool = True) -> torch.Tensor:
    """Softmax attention of post-RoPE q (B, S, H, hd) over k/v (B, S, KV,
    hd), chunked over query blocks of ``cfg.attn_q_chunk`` (rows of a
    softmax are independent, so chunking changes no value) -> (B, S, H, hd)
    fp32.  Causal masking is an additive -1e30 bias without the head
    dims."""
    S = q.shape[1]
    qc = min(cfg.attn_q_chunk, S)
    while S % qc:
        qc -= 1
    outs = []
    for i0 in range(0, S, qc):
        s = gqa_scores(q[:, i0:i0 + qc], k, cfg)  # (B, KV, G, qc, S)
        if causal:
            pq = positions[i0:i0 + qc]
            s = s + torch.where(pq[:, None] >= positions[None, :], 0.0,
                                -1e30).to(torch.float32)
        outs.append(gqa_out(torch.softmax(s, dim=-1), v, cfg))
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


def project_qkv(p: dict, x: torch.Tensor, cfg: ArchConfig,
                positions: torch.Tensor):
    """(q, k, v) of the dense family's attention from fp params: (B, S,
    heads, hd) each, biased (``qkv_bias``), qk-normed and RoPE'd."""
    B, S, _ = x.shape
    q, k, v = (apply_w(p[w], x) for w in ("wq", "wk", "wv"))
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, S, cfg.n_heads, cfg.head_dim)
    k = k.reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    v = v.reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    return rope(q, positions, cfg.rope_theta), rope(k, positions,
                                                    cfg.rope_theta), v


def attention_full(p: dict, x: torch.Tensor, cfg: ArchConfig, *,
                   positions: torch.Tensor, causal: bool = True,
                   return_kv: bool = False):
    """Full-sequence self-attention of the dense family from fp params
    (``wq wk wv wo`` as (in, out), ``bq bk bv`` with ``qkv_bias``,
    ``q_norm``/``k_norm`` with qk-norm).

    x: (B, S, D) -> (B, S, D), and the post-RoPE ``(k, v)`` (B, S, KV,
    hd) with ``return_kv``.
    """
    B, S, _ = x.shape
    q, k, v = project_qkv(p, x, cfg, positions)
    o = attend(q, k, v, positions, cfg, causal=causal)
    out = apply_w(p["wo"], o.to(x.dtype).reshape(B, S, cfg.q_dim))
    if return_kv:
        return out, (k, v)
    return out
