"""Unified cached prefill/decode forward over fp and QuIP-quantized models.

A :class:`CachedDecoder` holds per-layer *blocks*: norm params plus one
callable per linear projection, keyed like ``QuantizedModel.blocks``
("attn.wq", ..., "mlp.wo").  For fp params the callables are dense
matmuls, with the config's biases added (``launch.quantize.fp_blocks``);
for a ``QuantizedModel`` they ARE the :class:`QuantizedLinear` layers, so
every projection runs the packed ``D⁻¹ → V → quant_matmul → Uᵀ`` path
(without biases, as the JAX package's quantized blocks carry none).

Two decode paths share the block structure:

  * **gather-dense (reference oracle)** — :meth:`__call__`: the engine
    gathers every context page into a dense ``(L, B, S, KV, hd)`` window
    and the forward concatenates new K/V;
  * **paged** — :meth:`decode_paged`: every projection through the
    ``quant_matmul`` kernel, attention in place against the physical page
    pool (``kernels.paged_attention``, self-token folded in analytically),
    and an in-place scatter of the new K/V into the pool tensors.

Prefill has the same split: :meth:`prefill_paged` runs a whole padded
cross-request chunk batch ``(B, C)`` through the chunked-prefill kernel.
Selection is greedy only (an argmax on the device); sampling at
temperature > 0 and the speculative verifier are not ported yet.

Masking uses the same where-set convention as the recompute path
(``finfo(float32).min``), so cached logits match it up to matmul
reassociation.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.quantizer import QuantizedLinear
from repro_torch.kernels.paged_attention.ops import (
    paged_gqa_decode,
    paged_gqa_prefill,
)
from repro_torch.launch.quantize import fp_blocks
from repro_torch.models import layers as L
from repro_torch.serve.kv_cache import PagedKVPool

__all__ = ["CachedDecoder", "sample_tokens"]


def sample_tokens(logits: torch.Tensor) -> torch.Tensor:
    """Greedy selection over a step's logits (B, T, V) -> (B, T) int32 on
    the logits' device — the exact argmax (first index on ties)."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


@dataclasses.dataclass
class CachedDecoder:
    """KV-cached forward shared by the fp and quantized serving paths."""

    cfg: ArchConfig
    embed: dict
    final_norm: dict
    blocks: list

    def __post_init__(self):
        if self.cfg.family != "dense":
            raise ValueError(
                f"serving adapter supports the dense family, got "
                f"{self.cfg.family}"
            )

    @property
    def device(self) -> torch.device:
        return self.embed["tok"].device

    # ---- constructors ---------------------------------------------------

    @classmethod
    def from_model(cls, cfg: ArchConfig, params: dict) -> "CachedDecoder":
        """From an fp param tree (``models.transformer`` layout)."""
        return cls(cfg=cfg, embed=params["embed"],
                   final_norm=params["final_norm"],
                   blocks=fp_blocks(params, cfg))

    @classmethod
    def from_quantized(cls, qm) -> "CachedDecoder":
        return cls(cfg=qm.cfg, embed=qm.embed, final_norm=qm.final_norm,
                   blocks=qm.blocks)

    def make_pool(self, **kw) -> PagedKVPool:
        return PagedKVPool(self.cfg, device=self.device, **kw)

    def _place(self, *arrays):
        return [torch.as_tensor(np.asarray(a), dtype=torch.int32,
                                device=self.device) for a in arrays]

    # ---- gather-dense reference path ------------------------------------

    @torch.no_grad()
    def __call__(self, tokens, positions, ctx_k, ctx_v, ctx_len):
        """Cached forward (gather-dense reference).

        tokens    (B, T) int — new tokens (decode: T=1; prefill: B=1);
        positions (B, T) int — absolute position of each new token;
        ctx_k/v   (L, B, S, KV, hd) — gathered context pages (post-RoPE K);
        ctx_len   (B,) int — valid context tokens per lane.

        Returns (logits (B, T, V), k_new (L, B, T, KV, hd), v_new (same)).
        """
        tokens, positions, ctx_len = self._place(tokens, positions, ctx_len)
        cfg = self.cfg
        x = L.embed(self.embed, tokens)
        new_k, new_v = [], []
        for i, blk in enumerate(self.blocks):
            x, k, v = self._block(blk, x, positions, ctx_k[i], ctx_v[i],
                                  ctx_len)
            new_k.append(k)
            new_v.append(v)
        x = L.norm_apply(self.final_norm, x, cfg)
        logits = L.lm_logits(self.embed, x)
        return logits, torch.stack(new_k), torch.stack(new_v)

    def _block(self, blk, x, positions, ck, cv, ctx_len):
        cfg = self.cfg
        B, T, _ = x.shape
        S = ck.shape[1]
        h = L.norm_apply(blk["ln1"], x, cfg)
        q, k, v = self._qkv(blk, h, positions)
        k_all = torch.cat([ck.to(k.dtype), k], dim=1)
        v_all = torch.cat([cv.to(v.dtype), v], dim=1)
        s = L.gqa_scores(q, k_all, cfg)  # (B, KV, G, T, S+T)
        # context keys: valid below each lane's ctx_len; new keys: causal
        # within the chunk (their positions are >= every context position)
        dev = x.device
        mask_ctx = (torch.arange(S, device=dev)[None, None, :]
                    < ctx_len[:, None, None]).expand(B, T, S)
        mask_new = torch.tril(torch.ones(T, T, dtype=torch.bool, device=dev))
        mask = torch.cat([mask_ctx, mask_new.expand(B, T, T)], dim=-1)
        s = torch.where(mask[:, None, None], s, torch.full_like(s, L.NEG))
        o = L.gqa_out(torch.softmax(s, dim=-1), v_all, cfg)
        o = o.to(x.dtype).reshape(B, T, cfg.q_dim)
        x = x + blk["attn.wo"](o)
        return self._mlp(blk, x), k, v

    # ---- shared block pieces --------------------------------------------

    @staticmethod
    def _proj(blk, name, h, kernel: bool):
        """Apply one projection; with ``kernel`` a QuantizedLinear goes
        through the quant_matmul kernel dispatch."""
        f = blk[name]
        if kernel and isinstance(f, QuantizedLinear):
            return f(h, use_kernel=True)
        return f(h)

    def _qkv(self, blk, h, positions, *, kernel_proj: bool = False):
        """(q, k, v) each (B, T, heads, hd), qk-normed + RoPE'd."""
        cfg = self.cfg
        B, T, _ = h.shape
        proj = lambda n: self._proj(blk, n, h, kernel_proj)
        q = proj("attn.wq").reshape(B, T, cfg.n_heads, cfg.head_dim)
        k = proj("attn.wk").reshape(B, T, cfg.n_kv_heads, cfg.head_dim)
        v = proj("attn.wv").reshape(B, T, cfg.n_kv_heads, cfg.head_dim)
        if cfg.qk_norm:
            q = L.rms_norm(q, blk["q_norm"], cfg.norm_eps)
            k = L.rms_norm(k, blk["k_norm"], cfg.norm_eps)
        q = L.rope(q, positions, cfg.rope_theta)
        k = L.rope(k, positions, cfg.rope_theta)
        return q, k, v

    def _mlp(self, blk, x, *, kernel_proj: bool = False):
        cfg = self.cfg
        h = L.norm_apply(blk["ln2"], x, cfg)
        gate = (self._proj(blk, "mlp.wg", h, kernel_proj)
                if cfg.mlp == "swiglu" else None)
        up = L.mlp_act(self._proj(blk, "mlp.wi", h, kernel_proj), gate, cfg)
        return x + self._proj(blk, "mlp.wo", up, kernel_proj)

    # ---- paged decode ----------------------------------------------------

    @torch.no_grad()
    def decode_paged(self, tokens, positions, block_tables, ctx_len, pages,
                     offs, pool):
        """Fused decode step against ``pool`` (PagedKVPool), in place.

        tokens/positions (B, 1); block_tables (B, Pa) bucketed to the
        attended prefix; ctx_len (B,); pages/offs (B,) physical address of
        each lane's new token (scratch for pad lanes).  Writes the new K/V
        into ``pool`` and returns logits (B, 1, V); the caller owns the
        host-side length accounting (``pool.note_written``).
        """
        tokens, positions, bt, ctx_len = self._place(
            tokens, positions, block_tables, ctx_len)
        x = L.embed(self.embed, tokens)  # (B, 1, D)
        new_k, new_v = [], []
        for i, blk in enumerate(self.blocks):
            x, k, v = self._block_paged(blk, x, positions, i, pool, bt,
                                        ctx_len)
            new_k.append(k)
            new_v.append(v)
        x = L.norm_apply(self.final_norm, x, self.cfg)
        logits = L.lm_logits(self.embed, x)
        pool.scatter(pages, offs, torch.stack(new_k), torch.stack(new_v))
        return logits

    def decode_paged_sample(self, tokens, positions, block_tables, ctx_len,
                            pages, offs, pool):
        """:meth:`decode_paged` with greedy selection on the device.
        Returns ``(sel (B, 1) int32, logits (B, 1, V))``."""
        logits = self.decode_paged(tokens, positions, block_tables, ctx_len,
                                   pages, offs, pool)
        return sample_tokens(logits), logits

    def _block_paged(self, blk, x, positions, layer, pool, bt, ctx_len):
        cfg = self.cfg
        B = x.shape[0]
        h = L.norm_apply(blk["ln1"], x, cfg)
        q, k, v = self._qkv(blk, h, positions, kernel_proj=True)
        o = paged_gqa_decode(
            q[:, 0], k[:, 0], v[:, 0], pool.k, pool.v, bt, ctx_len,
            layer=layer, k_scale=pool.k_scale, v_scale=pool.v_scale,
        )
        o = o.to(x.dtype).reshape(B, 1, cfg.q_dim)
        x = x + self._proj(blk, "attn.wo", o, True)
        return self._mlp(blk, x, kernel_proj=True), k[:, 0], v[:, 0]

    # ---- paged batched prefill -------------------------------------------

    @torch.no_grad()
    def prefill_paged(self, tokens, positions, block_tables, ctx_len, pages,
                      offs, pool):
        """Fused cross-request prefill chunk batch against ``pool``.

        tokens/positions (B, C) — lane b carries one request's chunk
        (front-aligned, zero-padded tail); block_tables (B, Pa) bucketed to
        the longest prior context; ctx_len (B,) prior context per lane (the
        chunk start); pages/offs (B, C) physical address of every chunk
        token (scratch for padding).  Writes the chunk's K/V into ``pool``
        and returns logits (B, C, V); the caller owns the length
        accounting (``pool.note_span_written``).
        """
        tokens, positions, bt, ctx_len = self._place(
            tokens, positions, block_tables, ctx_len)
        cfg = self.cfg
        x = L.embed(self.embed, tokens)  # (B, C, D)
        new_k, new_v = [], []
        for i, blk in enumerate(self.blocks):
            B, C, _ = x.shape
            h = L.norm_apply(blk["ln1"], x, cfg)
            q, k, v = self._qkv(blk, h, positions, kernel_proj=True)
            o = paged_gqa_prefill(
                q, k, v, pool.k, pool.v, bt, ctx_len, layer=i,
                k_scale=pool.k_scale, v_scale=pool.v_scale,
            )
            o = o.to(x.dtype).reshape(B, C, cfg.q_dim)
            x = x + self._proj(blk, "attn.wo", o, True)
            x = self._mlp(blk, x, kernel_proj=True)
            new_k.append(k)
            new_v.append(v)
        x = L.norm_apply(self.final_norm, x, cfg)
        logits = L.lm_logits(self.embed, x)
        # (L, B, C, KV, hd) against (B, C) addresses
        pool.scatter(pages, offs, torch.stack(new_k), torch.stack(new_v))
        return logits
