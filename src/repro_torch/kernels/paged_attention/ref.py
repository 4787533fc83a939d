"""Plain PyTorch versions of paged GQA attention (decode + chunked prefill).

Each gathers exactly the attended pages of one layer from the physical
pool (advanced indexing), concatenates the token's/chunk's own K/V and
runs a plain masked softmax — the math of the JAX package's oracles,
written independently of the kernels' tiling.  The tests hold them
against the JAX package; the CPU dispatch runs them; ``chip_smoke.py``
holds the CUDA kernels against them on the card.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG = torch.finfo(torch.float32).min


def gather_layer(pages, scale, layer, block_tables):
    """(L, P, ps, KV, hd)[layer, bt] -> (B, Pa*ps, KV, hd) fp32."""
    bt = block_tables.to(torch.int64)
    g = pages[layer][bt].to(torch.float32)  # (B, Pa, ps, KV, hd)
    if scale is not None:
        g = g * scale[layer][bt][..., None]
    return g.reshape(g.shape[0], -1, *pages.shape[-2:])


def _ctx_mask(ctx_len, S, device):
    return torch.arange(S, device=device)[None, :] < ctx_len.to(device)[:, None]


def paged_attention_stats_ref(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,
    ctx_len: torch.Tensor,
    *,
    layer: int,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
):
    """What the decode kernel returns: q (B, KV, G, hd) grouped queries ->
    unnormalized ``o`` (B, KV, G, hd) and the max/normalizer ``m``, ``l``
    (B, KV, G, 1) of the softmax over the lane's context positions
    ``< ctx_len`` — ``m = finfo.min, l = 0, o = 0`` for an empty lane."""
    hd = q.shape[-1]
    kc = gather_layer(k_pages, k_scale, layer, block_tables)
    vc = gather_layer(v_pages, v_scale, layer, block_tables)
    s = torch.einsum("bkgd,bskd->bkgs", q.to(torch.float32), kc) * (hd**-0.5)
    valid = _ctx_mask(ctx_len, kc.shape[1], q.device)[:, None, None]
    s = torch.where(valid, s, torch.full_like(s, NEG))
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), torch.zeros_like(s))
    l = torch.sum(p, dim=-1, keepdim=True)
    o = torch.einsum("bkgs,bskd->bkgd", p, vc)
    return o, m, l


def paged_gqa_decode_ref(
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
    """One-token GQA attention vs paged context + the token itself.

    q (B, H, hd); k_new/v_new (B, KV, hd) — the token's own (post-RoPE)
    K/V, not yet in the pool; k/v_pages (L, P, ps, KV, hd); block_tables
    (B, Pa); ctx_len (B,).  Returns (B, H, hd) in q.dtype.
    """
    B, H, hd = q.shape
    KV = k_new.shape[1]
    G = H // KV
    kc = gather_layer(k_pages, k_scale, layer, block_tables)
    vc = gather_layer(v_pages, v_scale, layer, block_tables)
    S = kc.shape[1]
    qg = q.reshape(B, KV, G, hd).to(torch.float32)
    s_ctx = torch.einsum("bkgd,bskd->bkgs", qg, kc) * (hd**-0.5)
    valid = _ctx_mask(ctx_len, S, q.device)
    s_ctx = torch.where(valid[:, None, None], s_ctx,
                        torch.full_like(s_ctx, NEG))
    s_self = torch.einsum(
        "bkgd,bkd->bkg", qg, k_new.to(torch.float32)) * (hd**-0.5)
    s = torch.cat([s_ctx, s_self[..., None]], dim=-1)
    probs = torch.softmax(s, dim=-1)
    v_all = torch.cat([vc, v_new.to(torch.float32)[:, None]], dim=1)
    o = torch.einsum("bkgs,bskd->bkgd", probs, v_all)
    return o.reshape(B, H, hd).to(q.dtype)


def paged_gqa_prefill_ref(
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
    """Chunked-prefill GQA attention vs paged prior context + the chunk.

    q (B, C, H, hd) post-RoPE chunk queries; k_chunk/v_chunk (B, C, KV, hd)
    the chunk's own K/V, not yet in the pool; chunk token t of lane b
    attends context positions ``< ctx_len[b]`` plus chunk positions
    ``<= t``.  ``k_self``/``v_self`` (B, C, KV, hd) override the diagonal of
    the intra-chunk block.  -> (B, C, H, hd) in q.dtype.
    """
    B, C, H, hd = q.shape
    KV = k_chunk.shape[2]
    G = H // KV
    kc = gather_layer(k_pages, k_scale, layer, block_tables)
    vc = gather_layer(v_pages, v_scale, layer, block_tables)
    S = kc.shape[1]
    qg = q.reshape(B, C, KV, G, hd).to(torch.float32)
    s_ctx = torch.einsum("bckgd,bskd->bkgcs", qg, kc) * (hd**-0.5)
    valid = _ctx_mask(ctx_len, S, q.device)
    s_ctx = torch.where(valid[:, None, None, None], s_ctx,
                        torch.full_like(s_ctx, NEG))
    s_new = torch.einsum(
        "bckgd,btkd->bkgct", qg, k_chunk.to(torch.float32)) * (hd**-0.5)
    eye = torch.eye(C, dtype=torch.bool, device=q.device)
    if k_self is not None:
        s_diag = torch.einsum(
            "bckgd,bckd->bkgc", qg, k_self.to(torch.float32)) * (hd**-0.5)
        s_new = torch.where(eye, s_diag[..., None], s_new)
    causal = torch.tril(torch.ones(C, C, dtype=torch.bool, device=q.device))
    s_new = torch.where(causal, s_new, torch.full_like(s_new, NEG))
    s = torch.cat([s_ctx, s_new], dim=-1)
    probs = torch.softmax(s, dim=-1)
    v_all = torch.cat([vc, v_chunk.to(torch.float32)], dim=1)
    o = torch.einsum("bkgcs,bskd->bkgcd", probs, v_all)
    if v_self is not None:
        dp = torch.where(eye, probs[..., S:], torch.zeros_like(probs[..., S:]))
        vd = v_self.to(torch.float32) - v_chunk.to(torch.float32)
        o = o + torch.einsum("bkgct,btkd->bkgcd", dp, vd)
    return o.permute(0, 3, 1, 2, 4).reshape(B, C, H, hd).to(q.dtype)


def paged_prefill_grouped_ref(q, k_chunk, v_chunk, k_pages, v_pages,
                              block_tables, ctx_len, *, layer, k_scale=None,
                              v_scale=None, k_self=None, v_self=None):
    """What the prefill kernel returns: q (B, KV, G, C, hd) grouped chunk
    queries -> normalized (B, KV, G, C, hd) fp32 (:func:`paged_gqa_prefill_ref`
    in the kernel's layout)."""
    B, KV, G, C, hd = q.shape
    qs = q.to(torch.float32).permute(0, 3, 1, 2, 4).reshape(B, C, KV * G, hd)
    o = paged_gqa_prefill_ref(
        qs, k_chunk, v_chunk, k_pages, v_pages, block_tables, ctx_len,
        layer=layer, k_scale=k_scale, v_scale=v_scale, k_self=k_self,
        v_self=v_self,
    )
    return o.reshape(B, C, KV, G, hd).permute(0, 2, 3, 1, 4)
