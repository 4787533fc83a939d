"""Primitive layers: norms, RoPE, attention (GQA, qk-norm, biases, cross
attention with its tanh gate, the dense KV cache), MLP (SwiGLU / GeLU), MoE
with scatter-based dispatch, and the projection weight leaf (dense, or
packed when ``cfg.weight_bits``).

Functional, on plain tensors, with the JAX package's layouts and masking
convention (masked scores are set to ``finfo(float32).min`` or biased by
-1e30), so the tests compare like with like.  Attention scores and outputs
accumulate in fp32 whatever the storage dtype; probabilities are cast down
to V's dtype for the PV product, as the JAX package does; with
``cfg.attn_bf16_probs`` the full-sequence attention keeps fp32 max and sum
statistics around bf16 exponentials and probabilities, as the JAX
package's branch does.

Layout changes are marked with ``runtime/sharding.py``'s ``constrain``
at the JAX package's points (and where an activation enters a
column-parallel product): a no-op without a mesh context; under a training
mesh the embedding and the logits are vocab-parallel, attention
head-parallel, the MLP ``ff``-parallel and the MoE expert-parallel where
the plan says so.

``init_*`` draw from an explicit ``torch.Generator`` on ``device`` (the
values differ from ``jax.random``'s; tests convert the JAX package's params
instead) and return the JAX package's tree with (in, out) weights.
"""
from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.core import packing
from repro_torch.kernels.quant_matmul.ops import quant_matmul
from repro_torch.kernels.quant_matmul.ref import quant_matmul_ref
from repro_torch.runtime import collectives
from repro_torch.runtime.sharding import constrain, current_mesh_context

__all__ = [
    "NEG",
    "matmul",
    "init_dense",
    "pack_w",
    "init_w",
    "w_axes",
    "apply_w",
    "rms_norm",
    "layer_norm",
    "norm_apply",
    "init_norm",
    "norm_axes",
    "rope",
    "gqa_scores",
    "gqa_out",
    "init_attention",
    "attention_axes",
    "init_mlp",
    "mlp_axes",
    "init_embedding",
    "embedding_axes",
    "embed",
    "lm_logits",
    "mlp_act",
    "mlp_apply",
    "quantize_kv",
    "dequantize_kv",
    "attend",
    "project_qkv",
    "attention_full",
    "init_kv_cache",
    "kv_cache_axes",
    "cache_store",
    "cache_read",
    "attention_decode",
    "init_moe",
    "moe_axes",
    "moe_capacity",
    "moe_route",
    "moe_apply",
    "moe_drops",
]

NEG = torch.finfo(torch.float32).min


def _dtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in the promoted dtype of the two (JAX's promotion: an fp32
    activation against a bf16 weight computes in fp32)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------


def init_dense(g: torch.Generator, shape, dtype, scale: Optional[float] = None,
               *, device) -> torch.Tensor:
    """N(0, std²) with std = ``scale`` or fan-in ``shape[-2]`` ** -0.5.  A
    stacked (E, in, out) weight is drawn one slice at a time, so no fp32
    temporary of the whole stack is made (arctic's experts are 26.8 GB a
    layer in bf16); on ``meta`` (shapes only) in one call."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = scale if scale is not None else fan_in**-0.5
    if len(shape) == 3 and torch.device(device).type != "meta":
        out = torch.empty(shape, dtype=dtype, device=device)
        for e in range(shape[0]):
            out[e] = torch.randn(shape[1:], generator=g, device=device) * std
        return out
    return (torch.randn(shape, generator=g, device=device) * std).to(dtype)


def pack_w(W: torch.Tensor, bits: int) -> dict:
    """The packed leaf of an fp32 (in, out) weight, as the JAX package's
    ``init_w`` makes it: one scale ``s = max|W| + 1e-8``, codes
    ``clip(round((Wᵀ/s + 1)·maxq/2), 0, maxq)`` packed along ``in``
    (``(in/vals, out)`` int32), so ``W ≈ (2q/maxq − 1)·s``."""
    vals = 32 // bits
    if W.shape[0] % vals:
        raise ValueError(f"packed weight {tuple(W.shape)}: in={W.shape[0]} "
                         f"is not a multiple of {vals} codes a word at "
                         f"{bits} bits")
    maxq = 2**bits - 1
    s = torch.max(torch.abs(W)) + 1e-8
    grid = torch.clamp(torch.round((W.T / s + 1.0) * (maxq / 2.0)), 0, maxq)
    return {"packed": packing.pack(grid.to(torch.int32), bits),
            "scale": s.to(torch.float32)}


def init_w(g: torch.Generator, cfg: ArchConfig, shape, dtype, scale=None, *,
           device):
    """A projection weight: dense (in, out), or the packed leaf
    ``{"packed", "scale"}`` (:func:`pack_w`) when ``cfg.weight_bits``."""
    W = init_dense(g, shape, torch.float32, scale, device=device)
    if not cfg.weight_bits:
        return W.to(dtype)
    return pack_w(W, cfg.weight_bits)


def w_axes(cfg: ArchConfig, axes: tuple):
    return {"packed": axes, "scale": ()} if cfg.weight_bits else axes


def apply_w(p, x: torch.Tensor, cfg: Optional[ArchConfig] = None, *,
            plain: bool = False) -> torch.Tensor:
    """y = x @ W for a dense (in, out) weight, or for a packed leaf through
    ``quant_matmul`` (``x @ ((2q/maxq − 1)·s)``, in x's dtype): the CUDA
    kernel with its dequant epilogue for a CUDA tensor, its plain version
    on the CPU or with ``plain=True`` (the oracle's path)."""
    if isinstance(p, dict):
        bits = cfg.weight_bits
        n = p["packed"].shape[0] * (32 // bits)
        fn = quant_matmul_ref if plain else quant_matmul
        return fn(x, p["packed"], bits, n, p["scale"], 2**bits - 1)
    return matmul(x, p)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return ((xf * torch.rsqrt(var + eps)) * scale.to(torch.float32)).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.to(torch.float32) + bias.to(torch.float32)).to(x.dtype)


def norm_apply(p: dict, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    if "bias" in p:
        return layer_norm(x, p["scale"], p["bias"], cfg.norm_eps)
    return rms_norm(x, p["scale"], cfg.norm_eps)


def init_norm(cfg: ArchConfig, dim: int, kind: str = "rms", *,
              device) -> dict:
    dt = _dtype(cfg)
    p = {"scale": torch.ones(dim, dtype=dt, device=device)}
    if kind == "ln":
        p["bias"] = torch.zeros(dim, dtype=dt, device=device)
    return p


def norm_axes(kind: str = "rms") -> dict:
    ax = {"scale": ("norm",)}
    if kind == "ln":
        ax["bias"] = ("norm",)
    return ax


# ---------------------------------------------------------------------------
# RoPE and grouped attention
# ---------------------------------------------------------------------------


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


# ---------------------------------------------------------------------------
# init of attention, MLP and embedding
# ---------------------------------------------------------------------------


def _resid(cfg: ArchConfig) -> float:
    return 1.0 / math.sqrt(2 * max(cfg.n_layers, 1))


def init_attention(g: torch.Generator, cfg: ArchConfig, *, device,
                   cross: bool = False) -> dict:
    """The attention's params; ``cross`` adds the 0-d ``gate`` (zeros) of a
    tanh-gated cross attention (llama-3.2-vision), whose output is
    ``tanh(gate)·out``."""
    dt = _dtype(cfg)
    d = cfg.d_model
    p = {
        "wq": init_w(g, cfg, (d, cfg.q_dim), dt, device=device),
        "wk": init_w(g, cfg, (d, cfg.kv_dim), dt, device=device),
        "wv": init_w(g, cfg, (d, cfg.kv_dim), dt, device=device),
        "wo": init_w(g, cfg, (cfg.q_dim, d), dt,
                     scale=cfg.q_dim**-0.5 * _resid(cfg), device=device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros(cfg.q_dim, dtype=dt, device=device)
        p["bk"] = torch.zeros(cfg.kv_dim, dtype=dt, device=device)
        p["bv"] = torch.zeros(cfg.kv_dim, dtype=dt, device=device)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones(cfg.head_dim, dtype=dt, device=device)
        p["k_norm"] = torch.ones(cfg.head_dim, dtype=dt, device=device)
    if cross:
        p["gate"] = torch.zeros((), dtype=dt, device=device)
    return p


def attention_axes(cfg: ArchConfig, cross: bool = False) -> dict:
    ax = {
        "wq": w_axes(cfg, ("embed", "heads")),
        "wk": w_axes(cfg, ("embed", "kv_heads")),
        "wv": w_axes(cfg, ("embed", "kv_heads")),
        "wo": w_axes(cfg, ("heads", "embed")),
    }
    if cfg.qkv_bias:
        ax.update(bq=("heads",), bk=("kv_heads",), bv=("kv_heads",))
    if cfg.qk_norm:
        ax.update(q_norm=("norm",), k_norm=("norm",))
    if cross:
        ax["gate"] = ()
    return ax


def init_mlp(g: torch.Generator, cfg: ArchConfig, *, device) -> dict:
    dt = _dtype(cfg)
    d, f = cfg.d_model, cfg.d_ff
    p = {
        "wi": init_w(g, cfg, (d, f), dt, device=device),
        "wo": init_w(g, cfg, (f, d), dt, scale=f**-0.5 * _resid(cfg),
                     device=device),
    }
    if cfg.mlp == "swiglu":
        p["wg"] = init_w(g, cfg, (d, f), dt, device=device)
    if cfg.mlp_bias:
        p["bi"] = torch.zeros(f, dtype=dt, device=device)
        p["bo"] = torch.zeros(d, dtype=dt, device=device)
    return p


def mlp_axes(cfg: ArchConfig) -> dict:
    ax = {"wi": w_axes(cfg, ("embed", "ff")),
          "wo": w_axes(cfg, ("ff", "embed"))}
    if cfg.mlp == "swiglu":
        ax["wg"] = w_axes(cfg, ("embed", "ff"))
    if cfg.mlp_bias:
        ax.update(bi=("ff",), bo=("norm",))
    return ax


def init_embedding(g: torch.Generator, cfg: ArchConfig, *, device) -> dict:
    dt = _dtype(cfg)
    p = {"tok": init_dense(g, (cfg.vocab, cfg.d_model), dt, 0.02,
                           device=device)}
    if not cfg.tie_embeddings:
        p["head"] = init_dense(g, (cfg.d_model, cfg.vocab), dt,
                               cfg.d_model**-0.5, device=device)
    return p


def embedding_axes(cfg: ArchConfig) -> dict:
    ax = {"tok": ("vocab", "embed")}
    if not cfg.tie_embeddings:
        ax["head"] = ("embed", "vocab")
    return ax


def embed(p: dict, tokens: torch.Tensor) -> torch.Tensor:
    """Rows of ``tok``; vocab-parallel under a mesh that splits the vocab
    (``tok`` is then this rank's rows: a token outside them gives zeros,
    and the ranks' rows are summed)."""
    tok = p["tok"]
    ctx = current_mesh_context()
    if ctx is None or not ctx.parallel("vocab"):
        return constrain(tok[tokens], ("batch", "seq", "act_embed"))
    local = tokens - ctx.model_rank * tok.shape[0]
    mine = (local >= 0) & (local < tok.shape[0])
    h = tok[torch.where(mine, local, 0)] * mine[..., None].to(tok.dtype)
    return constrain(h, ("batch", "seq", "act_embed"), summed="vocab")


def lm_logits(p: dict, h: torch.Tensor) -> torch.Tensor:
    """h @ head (or tokᵀ): under a mesh that splits the vocab, this rank's
    columns of the logits."""
    w = p["head"] if "head" in p else p["tok"].T
    h = constrain(h, ("batch", "seq", "act_embed"), feeds="vocab")
    return constrain(matmul(h, w), ("batch", "seq", "act_ff"))


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def mlp_act(up: torch.Tensor, gate, cfg: ArchConfig) -> torch.Tensor:
    """The nonlinearity between the up (and gate) and down projections:
    swiglu's ``silu(up) · gate``, or GeLU in the tanh approximation (the
    default of ``jax.nn.gelu``), which takes no gate (``gate=None``)."""
    if cfg.mlp == "swiglu":
        return F.silu(up) * gate
    return F.gelu(up, approximate="tanh")


def mlp_apply(p: dict, x: torch.Tensor, cfg: ArchConfig, *,
              plain: bool = False) -> torch.Tensor:
    """The MLP (``wi wo``, ``wg`` for swiglu, ``bi``/``bo`` with
    ``mlp_bias``), each weight dense or packed (:func:`apply_w`)."""
    x = constrain(x, ("batch", "seq", "act_embed"), feeds="act_ff")
    h = apply_w(p["wi"], x, cfg, plain=plain)
    if cfg.mlp_bias:
        h = h + p["bi"]
    gate = apply_w(p["wg"], x, cfg, plain=plain) if cfg.mlp == "swiglu" \
        else None
    h = constrain(mlp_act(h, gate, cfg), ("batch", "seq", "act_ff"))
    out = constrain(apply_w(p["wo"], h, cfg, plain=plain),
                    ("batch", "seq", "act_embed"), summed="act_ff")
    if cfg.mlp_bias:
        out = out + p["bo"]
    return out


# ---------------------------------------------------------------------------
# full-sequence attention
# ---------------------------------------------------------------------------


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-(token, head) symmetric int8 over the last axis of (..., hd)."""
    xf = x.to(torch.float32)
    scale = torch.amax(torch.abs(xf), dim=-1) / 127.0
    scale = torch.clamp(scale, min=1e-8)
    q = torch.round(xf / scale[..., None])
    return q.to(torch.int8), scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  dtype: torch.dtype) -> torch.Tensor:
    return (q.to(torch.float32) * scale[..., None]).to(dtype)


def _bf16_softmax(s: torch.Tensor) -> torch.Tensor:
    """Flash-style softmax: fp32 max and sum statistics, bf16 exponentials
    and probabilities (the JAX package's ``attn_bf16_probs`` branch)."""
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - m).to(torch.bfloat16)
    denom = torch.sum(p.to(torch.float32), dim=-1, keepdim=True)
    return p / denom.to(torch.bfloat16)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           positions: torch.Tensor, cfg: ArchConfig, *,
           causal: bool = True, bf16_probs: bool = False) -> torch.Tensor:
    """Softmax attention of post-RoPE q (B, Sq, H, hd) over k/v (B, Skv,
    KV, hd), chunked over query blocks of ``cfg.attn_q_chunk`` (rows of a
    softmax are independent, so chunking changes no value) -> (B, Sq, H,
    hd) fp32.  Causal masking (self-attention: Sq = Skv) is an additive
    -1e30 bias without the head dims.  ``bf16_probs`` takes
    :func:`_bf16_softmax`."""
    S = q.shape[1]
    qc = min(cfg.attn_q_chunk, S)
    while S % qc:
        qc -= 1
    outs = []
    for i0 in range(0, S, qc):
        s = gqa_scores(q[:, i0:i0 + qc], k, cfg)  # (B, KV, G, qc, Skv)
        if causal:
            pq = positions[i0:i0 + qc]
            s = s + torch.where(pq[:, None] >= positions[None, :], 0.0,
                                -1e30).to(torch.float32)
        probs = _bf16_softmax(s) if bf16_probs else torch.softmax(s, dim=-1)
        outs.append(gqa_out(probs, v, cfg))
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


def project_qkv(p: dict, x: torch.Tensor, cfg: ArchConfig,
                positions: torch.Tensor, *, x_kv: Optional[torch.Tensor] = None,
                plain: bool = False):
    """(q, k, v) of the attention: q (B, S, H, hd) from x, k/v (B, Skv, KV,
    hd) from ``x_kv`` (default: x), biased (``qkv_bias``), qk-normed, and
    RoPE'd at ``positions`` for self-attention only: a cross attention
    (``x_kv`` given) rotates neither side."""
    B, S, _ = x.shape
    cross = x_kv is not None
    x_kv = x if x_kv is None else x_kv
    q = apply_w(p["wq"], x, cfg, plain=plain)
    k, v = (apply_w(p[w], x_kv, cfg, plain=plain) for w in ("wk", "wv"))
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, S, cfg.n_heads, cfg.head_dim)
    k = k.reshape(B, x_kv.shape[1], cfg.n_kv_heads, cfg.head_dim)
    v = v.reshape(B, x_kv.shape[1], cfg.n_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if cross:
        return q, k, v
    return rope(q, positions, cfg.rope_theta), rope(k, positions,
                                                    cfg.rope_theta), v


def _gated(p: dict, out: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``tanh(gate)·out`` for a gated cross attention, else ``out``."""
    if "gate" not in p:
        return out
    return torch.tanh(p["gate"].to(torch.float32)).to(dtype) * out


def attention_full(p: dict, x: torch.Tensor, cfg: ArchConfig, *,
                   positions: torch.Tensor, causal: bool = True,
                   x_kv: Optional[torch.Tensor] = None,
                   return_kv: bool = False, plain: bool = False):
    """Full-sequence attention (``wq wk wv wo`` dense (in, out) or packed,
    ``bq bk bv`` with ``qkv_bias``, ``q_norm``/``k_norm`` with qk-norm).
    ``x_kv`` (B, Skv, D) switches to cross attention: K/V from ``x_kv``, no
    RoPE (so no key positions: the JAX package's ``positions_kv`` reaches
    only RoPE and the causal mask, which a cross attention has neither
    of); a ``gate`` in ``p`` scales the output by ``tanh(gate)``.

    x: (B, S, D) -> (B, S, D), and the (post-RoPE for self-attention)
    ``(k, v)`` (B, Skv, KV, hd) with ``return_kv``.
    """
    B, S, _ = x.shape
    x = constrain(x, ("batch", "seq", "act_embed"), feeds="act_heads")
    if x_kv is not None:
        x_kv = constrain(x_kv, ("batch", "seq", "act_embed"),
                         feeds="act_heads")
    q, k, v = project_qkv(p, x, cfg, positions, x_kv=x_kv, plain=plain)
    q = constrain(q, ("batch", "seq", "act_heads", None))
    k = constrain(k, ("batch", "seq", "act_heads", None))
    o = attend(q, k, v, positions, cfg, causal=causal,
               bf16_probs=cfg.attn_bf16_probs)
    out = apply_w(p["wo"], o.to(x.dtype).reshape(B, S, cfg.q_dim), cfg,
                  plain=plain)
    out = constrain(out, ("batch", "seq", "act_embed"), summed="act_heads")
    out = _gated(p, out, x.dtype)
    if return_kv:
        return out, (k, v)
    return out


# ---------------------------------------------------------------------------
# the dense KV cache (one layer: (B, max_len, KV, hd))
# ---------------------------------------------------------------------------


def init_kv_cache(cfg: ArchConfig, batch: int, max_len: int, dtype=None, *,
                  device) -> dict:
    dt = dtype or _dtype(cfg)
    shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    if dt == torch.int8:
        return {
            "k": torch.zeros(shape, dtype=torch.int8, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_scale": torch.zeros(shape[:-1], dtype=torch.float32,
                                   device=device),
            "v_scale": torch.zeros(shape[:-1], dtype=torch.float32,
                                   device=device),
        }
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def kv_cache_axes(int8: bool = False) -> dict:
    ax = {"k": ("batch", "seq_kv", None, None),
          "v": ("batch", "seq_kv", None, None)}
    if int8:
        ax["k_scale"] = ("batch", "seq_kv", None)
        ax["v_scale"] = ("batch", "seq_kv", None)
    return ax


def _put(buf: torch.Tensor, x: torch.Tensor, index: int) -> torch.Tensor:
    return torch.slice_scatter(buf, x.to(buf.dtype), dim=1, start=index,
                               end=index + x.shape[1])


def cache_store(cache: dict, k: torch.Tensor, v: torch.Tensor,
                index: int) -> dict:
    """A new cache with k/v (B, S_new, KV, hd) written at position
    ``index`` along seq (int8 caches store codes and per-(token, head)
    scales)."""
    if cache["k"].dtype == torch.int8:
        kq, ks = quantize_kv(k)
        vq, vs = quantize_kv(v)
        return {"k": _put(cache["k"], kq, index),
                "v": _put(cache["v"], vq, index),
                "k_scale": _put(cache["k_scale"], ks, index),
                "v_scale": _put(cache["v_scale"], vs, index)}
    return {"k": _put(cache["k"], k, index), "v": _put(cache["v"], v, index)}


def cache_read(cache: dict, dtype: torch.dtype):
    if cache["k"].dtype == torch.int8:
        return (dequantize_kv(cache["k"], cache["k_scale"], dtype),
                dequantize_kv(cache["v"], cache["v_scale"], dtype))
    return cache["k"].to(dtype), cache["v"].to(dtype)


def attention_decode(p: dict, x: torch.Tensor, cfg: ArchConfig, cache: dict,
                     pos: int, *, cross: bool = False):
    """One-token attention against a dense cache.

    x: (B, 1, D); ``pos``: the current position (the same for the batch).
    Self-attention stores the token's K/V at ``pos`` first and masks keys
    past ``pos``; ``cross`` reads the whole encoder / vision cache
    unmasked, stores nothing and rotates nothing.  Returns (out (B, 1, D),
    the new cache, or ``cache`` itself when ``cross``)."""
    B = x.shape[0]
    pos = int(pos)
    q = apply_w(p["wq"], x, cfg)
    if cfg.qkv_bias:
        q = q + p["bq"]
    q = q.reshape(B, 1, cfg.n_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
    if not cross:
        k_new = apply_w(p["wk"], x, cfg)
        v_new = apply_w(p["wv"], x, cfg)
        if cfg.qkv_bias:
            k_new, v_new = k_new + p["bk"], v_new + p["bv"]
        k_new = k_new.reshape(B, 1, cfg.n_kv_heads, cfg.head_dim)
        v_new = v_new.reshape(B, 1, cfg.n_kv_heads, cfg.head_dim)
        if cfg.qk_norm:
            k_new = rms_norm(k_new, p["k_norm"], cfg.norm_eps)
        at = torch.tensor([pos], dtype=torch.int32, device=x.device)
        q = rope(q, at, cfg.rope_theta)
        k_new = rope(k_new, at, cfg.rope_theta)
        cache = cache_store(cache, k_new, v_new, pos)
    k, v = cache_read(cache, x.dtype)
    S = k.shape[1]
    s = gqa_scores(q, k, cfg)  # (B, KV, G, 1, S)
    if not cross:
        s = s + torch.where(torch.arange(S, device=x.device) <= pos, 0.0,
                            -1e30).to(torch.float32)
    o = gqa_out(torch.softmax(s, dim=-1), v, cfg)
    o = o.reshape(B, 1, cfg.q_dim).to(x.dtype)
    return _gated(p, apply_w(p["wo"], o, cfg), x.dtype), cache


# ---------------------------------------------------------------------------
# MoE (scatter/gather dispatch into an (E, C, D) buffer)
# ---------------------------------------------------------------------------


def init_moe(g: torch.Generator, cfg: ArchConfig, *, device) -> dict:
    dt = _dtype(cfg)
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    p = {
        "router": init_dense(g, (d, E), torch.float32, device=device),
        "wi": init_dense(g, (E, d, f), dt, device=device),
        "wg": init_dense(g, (E, d, f), dt, device=device),
        "wo": init_dense(g, (E, f, d), dt, scale=f**-0.5 * _resid(cfg),
                         device=device),
    }
    if cfg.dense_residual:
        p["dense"] = init_mlp(g, cfg, device=device)
    return p


def moe_axes(cfg: ArchConfig) -> dict:
    ax = {
        "router": ("embed", None),
        "wi": ("experts", "expert_embed", "expert_ff"),
        "wg": ("experts", "expert_embed", "expert_ff"),
        "wo": ("experts", "expert_ff", "expert_embed"),
    }
    if cfg.dense_residual:
        ax["dense"] = mlp_axes(cfg)
    return ax


def moe_capacity(cfg: ArchConfig, tokens: int) -> int:
    c = math.ceil(tokens * cfg.top_k / cfg.n_experts * cfg.capacity_factor)
    return max(8, -(-c // 8) * 8)  # round up to a multiple of 8


# the active counters of moe_apply's dropped (token, choice) pairs
_DROPS: list = []


@contextlib.contextmanager
def moe_drops():
    """While active, each :func:`moe_apply` call appends the number of
    (token, choice) pairs its routing dropped (a 0-d tensor; on data ranks
    this rank's tokens') to the yielded list, in call order; a remat'd
    block's recompute in the backward appends again."""
    calls: list = []
    _DROPS.append(calls)
    try:
        yield calls
    finally:
        _DROPS.pop()


def _data_comm():
    """The data axis's communicator of the active training mesh, where it
    has more than one rank (else None)."""
    comm = getattr(current_mesh_context(), "data_comm", None)
    return comm if comm is not None and comm.size > 1 else None


def moe_route(p: dict, xt: torch.Tensor, cfg: ArchConfig) -> dict:
    """The routing of tokens xt (T, D): router ``probs`` (T, E) fp32, the
    renormalized ``top_p`` and ``top_e`` (T, k) — ties go to the lower
    expert, as ``jax.lax.top_k`` breaks them (a stable descending sort) —
    and each (token, choice)'s slot ``pos`` in its expert, ``keep`` (slot
    below the capacity ``C``), all flattened to (T·k,) in token-major
    order.

    On a training mesh with data ranks, ``xt`` is this rank's rows of the
    microbatch and the routing is the whole microbatch's: ``C`` comes from
    its ``tokens`` (every data rank's), and each slot is offset by the
    tokens the data ranks before this one sent to its expert (an exact
    all-gather of the per-expert counts)."""
    E, k = cfg.n_experts, cfg.top_k
    logits = xt.to(torch.float32) @ p["router"].to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[:, :k], top_e[:, :k]
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    e_flat = top_e.reshape(-1)
    onehot = F.one_hot(e_flat, E).to(torch.int32)  # (T*k, E)
    pos = torch.sum((torch.cumsum(onehot, dim=0) - onehot) * onehot, dim=-1)
    tokens = xt.shape[0]
    comm = _data_comm()
    if comm is not None:
        counts = comm.all_gather(onehot.sum(dim=0))
        before = torch.zeros_like(counts[0])
        for c in counts[:comm.rank]:
            before = before + c
        pos = pos + before[e_flat]
        tokens *= comm.size
    C = moe_capacity(cfg, tokens)
    return {"probs": probs, "top_p": top_p, "top_e": top_e, "e": e_flat,
            "pos": pos, "keep": pos < C, "C": C, "tokens": tokens}


def moe_apply(p: dict, x: torch.Tensor, cfg: ArchConfig, *,
              plain: bool = False):
    """x: (B, S, D) -> (y, aux_loss).

    Tokens past an expert's capacity are dropped: their scatter adds zero
    at slot C - 1 and their gather reads slot 0 with weight 0, as the JAX
    package's ``.at[].add`` / ``where(keep, pos, 0)`` do.  The expert
    products are plain batched matmuls over E; ``plain`` reaches only the
    dense residual's (possibly packed) weights.

    Expert parallelism (a training mesh whose plan computes
    ``act_experts`` in parallel): ``wi wg wo`` hold this rank's experts
    ``[r·El, (r+1)·El)``; every rank routes every token, fills and
    computes only its experts' rows of the buffer, and its part of ``y``
    (zero for the other experts' tokens) is summed over ``model``.  The
    load-balancing aux is split the same way: ``E·Σ frac_tokens·
    frac_probs`` over the rank's experts, summed.  On data ranks the
    routing is the whole microbatch's (:func:`moe_route`) and the two
    fractions are sums over every data rank's tokens."""
    B, S, D = x.shape
    T = B * S
    E, k = cfg.n_experts, cfg.top_k
    xt = constrain(x, ("batch", "seq", "act_embed"),
                   feeds="act_experts").reshape(T, D)
    r = moe_route(p, xt, cfg)
    e_flat, pos, keep, C = r["e"], r["pos"], r["keep"], r["C"]
    if _DROPS:
        _DROPS[-1].append(torch.sum(~keep))
    El, lo = p["wi"].shape[0], 0  # this rank's experts, the first
    if El < E:  # the others' tokens are no part of this rank's buffer
        lo = current_mesh_context().model_rank * El
        mine = (e_flat >= lo) & (e_flat < lo + El)
        keep = keep & mine
        e_flat = torch.where(mine, e_flat - lo, 0)

    x_rep = torch.repeat_interleave(xt, k, dim=0)  # (T*k, D)
    buf = torch.zeros((El, C, D), dtype=x.dtype, device=x.device)
    buf.index_put_((e_flat, torch.where(keep, pos, C - 1)),
                   x_rep * keep[:, None].to(x.dtype), accumulate=True)
    buf = constrain(buf, ("act_experts", None, None))
    h = matmul(buf, p["wi"])  # (El, C, F), batched over the experts
    h = F.silu(h) * matmul(buf, p["wg"])
    h = constrain(h, ("act_experts", None, None))
    y_e = matmul(h, p["wo"])  # (El, C, D)

    y_tok = y_e[e_flat, torch.where(keep, pos, 0)]  # (T*k, D)
    w = (keep[:, None] * r["top_p"].reshape(-1)[:, None]).to(x.dtype)
    y = torch.sum((y_tok * w).reshape(T, k, D), dim=1)
    y = constrain(y, ("batch", "act_embed"), summed="act_experts")
    if cfg.dense_residual and "dense" in p:
        y = y + mlp_apply(p["dense"], x, cfg, plain=plain).reshape(T, D)

    # load-balancing aux loss (Switch-style)
    top1 = F.one_hot(r["top_e"][:, 0], E).to(torch.float32)
    comm = _data_comm()
    if comm is None:
        frac_tokens = torch.mean(top1, dim=0)
        frac_probs = torch.mean(r["probs"], dim=0)
    else:  # the microbatch's means: sums over every data rank's tokens
        frac_tokens = comm.all_reduce_sum([top1.sum(dim=0)])[0] / r["tokens"]
        frac_probs = collectives.data_sum(r["probs"].sum(dim=0),
                                          comm) / r["tokens"]
    if El < E:
        frac_tokens, frac_probs = (f[lo:lo + El] for f in (frac_tokens,
                                                           frac_probs))
    aux = E * torch.sum(frac_tokens * frac_probs)
    aux = constrain(aux, (), summed="act_experts")
    return y.reshape(B, S, D), aux
