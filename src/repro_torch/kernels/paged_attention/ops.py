"""Public wrappers around the paged-attention kernels.

``paged_gqa_decode`` is what the serving adapter's paged decode calls once
per layer per step; ``paged_gqa_prefill`` is its chunked-prefill sibling
and ``paged_gqa_verify`` the same kernel as a speculative verifier.  A CUDA
tensor goes to the hand-written kernels, a CPU tensor to the plain
versions.  For decode the kernel accumulates only over context pages; the
token's own (K, V), never read back from the pool, is folded in
analytically by the kernel's merge epilogue:

    m' = max(m, s_self);  o' = o·e^{m−m'} + v_self·e^{s_self−m'}
    l' = l·e^{m−m'} + e^{s_self−m'};      out = o' / l'

which equals the softmax over [context, self] up to fp reassociation
(``ref.fold_self_token`` is the same formula in plain PyTorch).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.paged_attention.kernel import (
    paged_gqa_decode_kernel,
    paged_gqa_prefill_kernel,
)
from repro_torch.kernels.paged_attention.ref import (
    paged_gqa_decode_ref,
    paged_gqa_prefill_ref,
)
from repro_torch.runtime.op_analysis import register_kernel


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
    return paged_gqa_decode_kernel(
        q, k_new, v_new, k_pages, v_pages, block_tables, ctx_len,
        layer=layer, k_scale=k_scale, v_scale=v_scale,
    )


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
    return paged_gqa_prefill_kernel(
        q, k_chunk, v_chunk, k_pages, v_pages, block_tables, ctx_len,
        layer=layer, k_scale=k_scale, v_scale=v_scale,
        k_self=k_self, v_self=v_self,
    )


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


# the op analysis's FLOP formulas (``runtime/op_analysis.py``): q·kᵀ and
# p·v over every key a query attends, 4·hd a (query head, key) pair.  The
# keys are each lane's context (read on the card: the work this run's data
# needs; a ``meta`` trace counts the tables' capacity) plus, for decode,
# the token itself and, for prefill, the causal chunk.


def _ctx_keys(ctx_len, block_tables, k_pages) -> float:
    if ctx_len.device.type == "meta":
        return float(block_tables.shape[0] * block_tables.shape[1]
                     * k_pages.shape[2])
    return float(ctx_len.sum())


@register_kernel("paged_decode", "paged_decode",
                 launched=lambda q, *a: q.shape[0] > 0)
def _paged_decode_flops(q, k_pages, v_pages, k_scale, v_scale, block_tables,
                        ctx_len, layer) -> float:
    B, KV, G, hd = q.shape
    return 4.0 * KV * G * hd * _ctx_keys(ctx_len, block_tables, k_pages)


@register_kernel("paged_decode_self", "paged_decode",
                 launched=lambda q, *a: q.shape[0] > 0)
def _paged_decode_self_flops(q, k_new, v_new, k_pages, v_pages, k_scale,
                             v_scale, block_tables, ctx_len, layer) -> float:
    B, H, hd = q.shape
    keys = _ctx_keys(ctx_len, block_tables, k_pages) + B
    return 4.0 * H * hd * keys


def _prefill_keys(B, C, ctx_len, block_tables, k_pages) -> float:
    return (C * _ctx_keys(ctx_len, block_tables, k_pages)
            + B * C * (C + 1) / 2)


@register_kernel("paged_prefill", "paged_prefill",
                 launched=lambda q, *a: q.shape[0] > 0 and q.shape[3] > 0)
def _paged_prefill_flops(q, k_chunk, v_chunk, k_pages, v_pages, k_scale,
                         v_scale, k_self, v_self, block_tables, ctx_len,
                         layer) -> float:
    B, KV, G, C, hd = q.shape
    return 4.0 * KV * G * hd * _prefill_keys(B, C, ctx_len, block_tables,
                                             k_pages)


@register_kernel("paged_prefill_bchd", "paged_prefill",
                 launched=lambda q, *a: q.shape[0] > 0 and q.shape[1] > 0)
def _paged_prefill_bchd_flops(q, k_chunk, v_chunk, k_pages, v_pages,
                              k_scale, v_scale, k_self, v_self, block_tables,
                              ctx_len, layer) -> float:
    B, C, H, hd = q.shape
    return 4.0 * H * hd * _prefill_keys(B, C, ctx_len, block_tables, k_pages)
