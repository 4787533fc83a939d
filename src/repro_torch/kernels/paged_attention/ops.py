"""Public wrappers around the paged-attention kernels.

``paged_gqa_decode`` is what the serving adapter's paged decode calls once
per layer per step; ``paged_gqa_prefill`` is its chunked-prefill sibling
and ``paged_gqa_verify`` the same kernel as a speculative verifier.  A CUDA
tensor goes to the hand-written kernels, a CPU tensor to the plain
versions.  For decode the kernel accumulates only over context pages and
returns ``(o, m, l)``; the token's own (K, V), never read back from the
pool, is folded in analytically:

    m' = max(m, s_self);  o' = o·e^{m−m'} + v_self·e^{s_self−m'}
    l' = l·e^{m−m'} + e^{s_self−m'};      out = o' / l'

which equals the softmax over [context, self] up to fp reassociation.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.paged_attention.kernel import (
    paged_attention_kernel,
    paged_prefill_kernel,
)
from repro_torch.kernels.paged_attention.ref import (
    paged_gqa_decode_ref,
    paged_gqa_prefill_ref,
)


def _groups(H: int, KV: int) -> int:
    if H % KV:
        raise ValueError(f"n_heads {H} must be a multiple of n_kv_heads {KV}")
    return H // KV


def paged_gqa_decode(
    q: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,
    ctx_len: torch.Tensor,
    *,
    layer: int,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One-token GQA decode attention against the physical page pool.

    q (B, H, hd) post-RoPE queries; k_new/v_new (B, KV, hd) the token's own
    post-RoPE K/V (not yet scattered); k/v_pages the full (L, P, ps, KV, hd)
    pool (+ scales for int8 pages); block_tables (B, Pa); ctx_len (B,).
    -> (B, H, hd) q.dtype.
    """
    if not q.is_cuda:
        return paged_gqa_decode_ref(
            q, k_new, v_new, k_pages, v_pages, block_tables, ctx_len,
            layer=layer, k_scale=k_scale, v_scale=v_scale,
        )
    B, H, hd = q.shape
    KV = k_new.shape[1]
    qg = q.reshape(B, KV, _groups(H, KV), hd)
    o, m, l = paged_attention_kernel(
        qg, k_pages, v_pages, block_tables, ctx_len, layer=layer,
        k_scale=k_scale, v_scale=v_scale,
    )
    qf = qg.to(torch.float32)
    s_self = torch.einsum(
        "bkgd,bkd->bkg", qf, k_new.to(torch.float32)) * (hd**-0.5)
    m0, l0 = m[..., 0], l[..., 0]
    m_tot = torch.maximum(m0, s_self)
    a_ctx = torch.exp(m0 - m_tot)
    a_self = torch.exp(s_self - m_tot)
    num = o * a_ctx[..., None] + (
        v_new.to(torch.float32)[:, :, None, :] * a_self[..., None]
    )
    den = l0 * a_ctx + a_self
    out = num / den[..., None]
    return out.reshape(B, H, hd).to(q.dtype)


def paged_gqa_prefill(
    q: torch.Tensor,
    k_chunk: torch.Tensor,
    v_chunk: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,
    ctx_len: torch.Tensor,
    *,
    layer: int,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    k_self: Optional[torch.Tensor] = None,
    v_self: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Chunk-batch causal prefill attention against the physical page pool.

    q (B, C, H, hd) post-RoPE chunk queries (lane b's token t at absolute
    position ``ctx_len[b] + t``); k_chunk/v_chunk (B, C, KV, hd) the
    chunk's own K/V (not yet scattered); pool, block tables and ragged
    prior-context lengths as for decode; k/v_self optional (B, C, KV, hd)
    diagonal override.  -> (B, C, H, hd) q.dtype.
    """
    if not q.is_cuda:
        return paged_gqa_prefill_ref(
            q, k_chunk, v_chunk, k_pages, v_pages, block_tables, ctx_len,
            layer=layer, k_scale=k_scale, v_scale=v_scale,
            k_self=k_self, v_self=v_self,
        )
    B, C, H, hd = q.shape
    KV = k_chunk.shape[2]
    G = _groups(H, KV)
    qg = q.reshape(B, C, KV, G, hd).permute(0, 2, 3, 1, 4)
    o = paged_prefill_kernel(
        qg, k_chunk, v_chunk, k_pages, v_pages, block_tables, ctx_len,
        layer=layer, k_scale=k_scale, v_scale=v_scale,
        k_self=k_self, v_self=v_self,
    )  # (B, KV, G, C, hd) normalized fp32
    return o.permute(0, 3, 1, 2, 4).reshape(B, C, H, hd).to(q.dtype)


def paged_gqa_verify(q, k_chunk, v_chunk, k_pages, v_pages, block_tables,
                     ctx_len, *, layer, k_scale=None, v_scale=None,
                     k_self=None, v_self=None) -> torch.Tensor:
    """Speculative-verify attention: the chunked-prefill kernel reused over a
    ``[last_emitted, d_1 .. d_K]`` chunk per lane (width K + 1 >= 1)."""
    if q.shape[1] < 1:
        raise ValueError(
            f"verify chunk needs >= 1 token (the last emitted token), "
            f"got width {q.shape[1]}"
        )
    return paged_gqa_prefill(
        q, k_chunk, v_chunk, k_pages, v_pages, block_tables, ctx_len,
        layer=layer, k_scale=k_scale, v_scale=v_scale, k_self=k_self,
        v_self=v_self,
    )
