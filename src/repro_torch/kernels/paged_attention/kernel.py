"""Launch wrappers of the hand-written CUDA paged-attention kernels.

* :func:`paged_attention_kernel` — decode: the online-softmax state
  ``(o, m, l)`` of one grouped query token per lane over its context pages
  (``repro/kernels/paged_attention/kernel.py:paged_attention_kernel``);
* :func:`paged_gqa_decode_kernel` — the same kernel in the adapter's
  ``(B, H, hd)`` layout, its merge epilogue folding the token's own K/V in
  and normalizing (what ``ops.paged_gqa_decode`` runs on the card);
* :func:`paged_prefill_kernel` — chunked prefill: the normalized output of
  a ``C``-token chunk per lane over its paged prior context plus the chunk
  itself, causally (``...:paged_prefill_kernel``);
* :func:`paged_gqa_prefill_kernel` — the same kernel reading and writing
  the adapter's ``(B, C, H, hd)`` layout in ``q.dtype``.

All validate their operands with the JAX package's checks and messages.
A CUDA tensor launches ``csrc/paged_attention.cu`` through the operators
``torch.ops.repro_torch.paged_decode`` / ``paged_decode_self`` /
``paged_prefill`` / ``paged_prefill_bchd`` (and raises if it cannot); a
CPU tensor runs the plain version from ``ref.py``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.paged_attention.ref import (
    paged_attention_stats_ref,
    paged_gqa_decode_ref,
    paged_gqa_prefill_ref,
    paged_prefill_grouped_ref,
)

__all__ = ["paged_attention_kernel", "paged_gqa_decode_kernel",
           "paged_prefill_kernel", "paged_gqa_prefill_kernel", "COUNTS"]

# launches of the CUDA kernels (chip_smoke.py reads and resets this)
COUNTS = {"paged_decode": 0, "paged_prefill": 0}

_MAX_G = 128  # largest decode group (csrc kMaxDecodeGroup)
_MAX_HD = 256  # largest head dim (csrc kMaxHeadDim)


def _check_operands(q, k_pages, v_pages, block_tables, ctx_len, layer,
                    k_scale, v_scale):
    if q.ndim != 4:
        raise ValueError(
            f"q must be (B, KV, G, hd) grouped queries, got shape "
            f"{tuple(q.shape)}"
        )
    B, KV, G, hd = q.shape
    if k_pages.ndim != 5 or v_pages.shape != k_pages.shape:
        raise ValueError(
            "k_pages/v_pages must both be (L, n_pages, page_size, KV, hd); "
            f"got k_pages {tuple(k_pages.shape)}, v_pages "
            f"{tuple(v_pages.shape)}"
        )
    L, P, ps, KVp, hdp = k_pages.shape
    if (KVp, hdp) != (KV, hd):
        raise ValueError(
            f"page pool carries (KV={KVp}, hd={hdp}) but queries expect "
            f"(KV={KV}, hd={hd})"
        )
    if not 0 <= layer < L:
        raise ValueError(f"layer {layer} out of range for {L}-layer pool")
    if block_tables.ndim != 2 or block_tables.shape[0] != B:
        raise ValueError(
            f"block_tables must be (B={B}, pages_attended), got "
            f"{tuple(block_tables.shape)}"
        )
    if tuple(ctx_len.shape) != (B,):
        raise ValueError(f"ctx_len must be (B={B},), got "
                         f"{tuple(ctx_len.shape)}")
    int8_pages = k_pages.dtype == torch.int8
    if int8_pages:
        if k_scale is None or v_scale is None:
            raise ValueError("int8 pages require k_scale and v_scale")
        if (tuple(k_scale.shape) != (L, P, ps, KV)
                or tuple(v_scale.shape) != (L, P, ps, KV)):
            raise ValueError(
                f"page scales must be (L, P, ps, KV)={(L, P, ps, KV)}, got "
                f"k_scale {tuple(k_scale.shape)}, v_scale "
                f"{tuple(v_scale.shape)}"
            )
    elif k_scale is not None or v_scale is not None:
        raise ValueError("page scales only apply to int8 pages")
    return int8_pages


def _check_prefill_operands(q, k_chunk, v_chunk, k_pages, v_pages,
                            block_tables, ctx_len, layer, k_scale, v_scale,
                            k_self=None, v_self=None):
    if q.ndim != 5:
        raise ValueError(
            f"q must be (B, KV, G, C, hd) grouped chunk queries, got shape "
            f"{tuple(q.shape)}"
        )
    B, KV, G, C, hd = q.shape
    if (tuple(k_chunk.shape) != (B, C, KV, hd)
            or v_chunk.shape != k_chunk.shape):
        raise ValueError(
            f"k_chunk/v_chunk must both be (B={B}, C={C}, KV={KV}, hd={hd}); "
            f"got k_chunk {tuple(k_chunk.shape)}, v_chunk "
            f"{tuple(v_chunk.shape)}"
        )
    if (k_self is None) != (v_self is None):
        raise ValueError("k_self and v_self must be given together")
    if k_self is not None and (
        k_self.shape != k_chunk.shape or v_self.shape != v_chunk.shape
    ):
        raise ValueError(
            f"k_self/v_self must match k_chunk {tuple(k_chunk.shape)}; got "
            f"k_self {tuple(k_self.shape)}, v_self {tuple(v_self.shape)}"
        )
    # pool/table/scale checks are shared with the decode entry
    return _check_operands(
        q[:, :, :, 0], k_pages, v_pages, block_tables, ctx_len, layer,
        k_scale, v_scale,
    )


def _groups(H: int, KV: int) -> int:
    if H % KV:
        raise ValueError(f"n_heads {H} must be a multiple of n_kv_heads {KV}")
    return H // KV


def _limits(G: int, hd: int, decode: bool) -> None:
    if hd > _MAX_HD:
        raise ValueError(f"head_dim {hd} exceeds the kernel's {_MAX_HD}")
    if decode and G > _MAX_G:
        raise ValueError(f"group size G={G} exceeds the decode kernel's "
                         f"limit of {_MAX_G}")


def paged_attention_kernel(
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
    """Online-softmax decode attention of layer ``layer`` against the pool.

    q (B, KV, G, hd) grouped post-RoPE queries; k/v_pages (L, P, ps, KV,
    hd) fp or int8 (+ (L, P, ps, KV) fp32 scales); block_tables (B, Pa);
    ctx_len (B,).  Returns ``(o, m, l)``: unnormalized accumulator (B, KV,
    G, hd) and running max / normalizer (B, KV, G, 1), all fp32.
    """
    _check_operands(q, k_pages, v_pages, block_tables, ctx_len, layer,
                    k_scale, v_scale)
    if not q.is_cuda:
        return paged_attention_stats_ref(
            q, k_pages, v_pages, block_tables, ctx_len, layer=layer,
            k_scale=k_scale, v_scale=v_scale,
        )
    _limits(q.shape[2], q.shape[3], decode=True)
    o, m, l = _build.ops().paged_decode(
        q, k_pages, v_pages, k_scale, v_scale, block_tables, ctx_len, layer)
    if q.shape[0]:
        COUNTS["paged_decode"] += 1
    return o, m, l


def paged_gqa_decode_kernel(
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
    """Decode attention in the adapter's layout, the token's own K/V folded
    in: q (B, H, hd); k_new/v_new (B, KV, hd) not yet in the pool; pool,
    tables and scales as for :func:`paged_attention_kernel`.  Returns the
    normalized (B, H, hd) in q.dtype (two launches on the card: the split
    kernel and its merge epilogue)."""
    B, H, hd = q.shape
    KV = k_new.shape[1]
    qg = q.reshape(B, KV, _groups(H, KV), hd)
    _check_operands(qg, k_pages, v_pages, block_tables, ctx_len, layer,
                    k_scale, v_scale)
    if tuple(k_new.shape) != (B, KV, hd) or v_new.shape != k_new.shape:
        raise ValueError(
            f"k_new/v_new must both be (B={B}, KV={KV}, hd={hd}); got k_new "
            f"{tuple(k_new.shape)}, v_new {tuple(v_new.shape)}"
        )
    if not q.is_cuda:
        return paged_gqa_decode_ref(
            q, k_new, v_new, k_pages, v_pages, block_tables, ctx_len,
            layer=layer, k_scale=k_scale, v_scale=v_scale,
        )
    _limits(qg.shape[2], hd, decode=True)
    out = _build.ops().paged_decode_self(
        q, k_new, v_new, k_pages, v_pages, k_scale, v_scale, block_tables,
        ctx_len, layer)
    if B:
        COUNTS["paged_decode"] += 1
    return out


def paged_prefill_kernel(
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
    """Causal chunked-prefill attention of layer ``layer`` against the pool.

    q (B, KV, G, C, hd) grouped post-RoPE chunk queries (lane b's token t
    at absolute position ``ctx_len[b] + t``); k/v_chunk (B, C, KV, hd) the
    chunk's own K/V, not yet in the pool; pool, tables and scales as for
    decode, ``ctx_len`` the prior-context lengths (0 allowed); k/v_self
    optional (B, C, KV, hd) diagonal override.  Returns the normalized
    output (B, KV, G, C, hd) fp32.
    """
    _check_prefill_operands(q, k_chunk, v_chunk, k_pages, v_pages,
                            block_tables, ctx_len, layer, k_scale, v_scale,
                            k_self, v_self)
    if not q.is_cuda:
        return paged_prefill_grouped_ref(
            q, k_chunk, v_chunk, k_pages, v_pages, block_tables, ctx_len,
            layer=layer, k_scale=k_scale, v_scale=v_scale, k_self=k_self,
            v_self=v_self,
        )
    _limits(q.shape[2], q.shape[4], decode=False)
    o = _build.ops().paged_prefill(
        q, k_chunk, v_chunk, k_pages, v_pages, k_scale, v_scale, k_self,
        v_self, block_tables, ctx_len, layer)
    if q.shape[0] and q.shape[3]:
        COUNTS["paged_prefill"] += 1
    return o


def paged_gqa_prefill_kernel(
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
    """:func:`paged_prefill_kernel` in the adapter's layout: q (B, C, H, hd)
    read in place, the normalized output written as (B, C, H, hd) in
    q.dtype (no permuted copies on either side)."""
    B, C, H, hd = q.shape
    KV = k_chunk.shape[2]
    qg = q.reshape(B, C, KV, _groups(H, KV), hd).permute(0, 2, 3, 1, 4)
    _check_prefill_operands(qg, k_chunk, v_chunk, k_pages, v_pages,
                            block_tables, ctx_len, layer, k_scale, v_scale,
                            k_self, v_self)
    if not q.is_cuda:
        return paged_gqa_prefill_ref(
            q, k_chunk, v_chunk, k_pages, v_pages, block_tables, ctx_len,
            layer=layer, k_scale=k_scale, v_scale=v_scale, k_self=k_self,
            v_self=v_self,
        )
    _limits(qg.shape[2], hd, decode=False)
    out = _build.ops().paged_prefill_bchd(
        q, k_chunk, v_chunk, k_pages, v_pages, k_scale, v_scale, k_self,
        v_self, block_tables, ctx_len, layer)
    if B and C:
        COUNTS["paged_prefill"] += 1
    return out
