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


# ---------------------------------------------------------------------------
# Emulation of the CUDA kernels' arithmetic (csrc/paged_attention.cu), for
# the CPU tests of its precision scheme; nothing on the main path calls it.
# ---------------------------------------------------------------------------

DECODE_SPLIT_KEYS = 128  # context keys per decode block (kDecodeSplitKeys)


def split_bf16(x: torch.Tensor):
    """fp32 ``x`` -> (hi, lo), both bf16 values held in fp32: hi = bf16(x),
    lo = bf16(x - hi), so |x - hi - lo| <= 2^-16 |x|."""
    x = x.to(torch.float32)
    hi = x.to(torch.bfloat16).to(torch.float32)
    return hi, (x - hi).to(torch.bfloat16).to(torch.float32)


def prefill_key_tile(page_dtype: torch.dtype, hd: int) -> int:
    """Keys per tile of the prefill kernel (``PrefillCfg::KT``): 64, or fewer
    where wide fp32 rows would not fit shared memory."""
    HD = 64 if hd <= 64 else (128 if hd <= 128 else 256)
    elt = max(torch.empty((), dtype=page_dtype).element_size(), 2)
    return 64 if HD * elt <= 256 else (32 if HD * elt <= 512 else 16)


def _gather_raw(pages, scale, layer, block_tables):
    """(L, P, ps, KV, hd)[layer, bt] -> raw values (B, S, KV, hd) fp32 and,
    for int8 pages, their scales (B, S, KV) — not yet multiplied."""
    bt = block_tables.to(torch.int64)
    g = pages[layer][bt].to(torch.float32)
    B = g.shape[0]
    g = g.reshape(B, -1, *pages.shape[-2:])
    sc = None if scale is None else scale[layer][bt].reshape(B, -1,
                                                             pages.shape[-2])
    return g, sc


def _tc_product(a_hi, a_lo, b_hi, b_lo):
    """The tensor-core products of split operands, summed in fp32:
    a_hi.b_hi + a_lo.b_hi (+ a_hi.b_lo when b is split too)."""
    out = a_hi @ b_hi + a_lo @ b_hi
    if b_lo is not None:
        out = out + a_hi @ b_lo
    return out


def paged_prefill_emulated(q, k_chunk, v_chunk, k_pages, v_pages,
                           block_tables, ctx_len, *, layer, k_scale=None,
                           v_scale=None, k_self=None, v_self=None,
                           split: bool = True):
    """The prefill kernel's arithmetic in plain PyTorch: q (B, KV, G, C, hd)
    -> normalized (B, KV, G, C, hd) fp32, as ``paged_prefill_kernel``.

    Key tiles of :func:`prefill_key_tile` keys with an fp32 online softmax;
    Q and P split into bf16 hi + lo (fp32 pages and the chunk's own K/V
    too), int8 values exact in bf16 with the K scale on the score column and
    the V scale on the probability; the diagonal override in fp32.
    ``split=False`` rounds every operand to one bf16 term instead (what the
    scheme avoids)."""
    B, KV, G, C, hd = q.shape
    R = G * C
    f32 = torch.float32

    def parts(x, exact=False):
        if exact:
            return x, None
        if not split:
            return x.to(torch.bfloat16).to(f32), None
        return split_bf16(x)

    qf = q.to(f32).reshape(B, KV, R, hd)
    q_hi, q_lo = parts(qf)
    if q_lo is None:
        q_lo = torch.zeros_like(q_hi)
    scale = hd**-0.5
    kc, ksc = _gather_raw(k_pages, k_scale, layer, block_tables)
    vc, vsc = _gather_raw(v_pages, v_scale, layer, block_tables)
    n_ctx = ctx_len.to(torch.int64).clamp(max=kc.shape[1])
    exact_pages = k_pages.dtype != torch.float32
    KT = prefill_key_tile(k_pages.dtype, hd)
    m = torch.full((B, KV, R), NEG, dtype=f32)
    l = torch.zeros((B, KV, R), dtype=f32)
    o = torch.zeros((B, KV, R, hd), dtype=f32)

    def step(k_t, v_t, ks_t, vs_t, valid, exact, diag=None):
        # k_t, v_t (B, KV, T, hd); ks_t, vs_t (B, KV, T) or None; valid
        # broadcastable to (B, KV, R, T); diag (mask, scores) or None
        nonlocal m, l, o
        k_hi, k_lo = parts(k_t, exact)
        v_hi, v_lo = parts(v_t, exact)
        s = _tc_product(q_hi, q_lo, k_hi.transpose(-1, -2),
                        None if k_lo is None else k_lo.transpose(-1, -2))
        s = s * scale
        if ks_t is not None:
            s = s * ks_t[:, :, None, :]
        if diag is not None:
            s = torch.where(diag[0], diag[1][..., None], s)
        s = torch.where(valid, s, torch.full_like(s, NEG))
        mx = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - mx)
        p = torch.where(valid, torch.exp(s - mx[..., None]),
                        torch.zeros_like(s))
        l = l * alpha + p.sum(-1)
        pv = p if vs_t is None else p * vs_t[:, :, None, :]
        p_hi, p_lo = parts(pv)
        if p_lo is None:
            p_lo = torch.zeros_like(p_hi)
        o = o * alpha[..., None] + _tc_product(p_hi, p_lo, v_hi, v_lo)
        m = mx
        return p

    for key0 in range(0, int(n_ctx.max()) if B else 0, KT):
        sl = slice(key0, key0 + KT)
        k_t = kc[:, sl].permute(0, 2, 1, 3)
        v_t = vc[:, sl].permute(0, 2, 1, 3)
        T = k_t.shape[2]
        ks_t = None if ksc is None else ksc[:, sl].permute(0, 2, 1)
        vs_t = None if vsc is None else vsc[:, sl].permute(0, 2, 1)
        valid = (key0 + torch.arange(T))[None, :] < n_ctx[:, None]
        step(k_t, v_t, ks_t, vs_t, valid[:, None, None, :], exact_pages)
    # the chunk itself: row r sees chunk keys <= c_r
    c_row = torch.arange(R) % C
    s_diag = None
    if k_self is not None:
        ks_rows = k_self.to(f32).permute(0, 2, 1, 3)[:, :, c_row]
        s_diag = (qf * ks_rows).sum(-1) * scale  # (B, KV, R)
    kch = k_chunk.to(f32).permute(0, 2, 1, 3)
    vch = v_chunk.to(f32).permute(0, 2, 1, 3)
    for key0 in range(0, C, KT):
        keys = key0 + torch.arange(min(KT, C - key0))
        valid = keys[None, :] <= c_row[:, None]  # (R, T)
        diag = None
        if s_diag is not None:
            diag = (keys[None, :] == c_row[:, None], s_diag)
        p = step(kch[:, :, keys], vch[:, :, keys], None, None, valid, False,
                 diag)
        if v_self is not None:
            own = keys[None, :] == c_row[:, None]
            pd = torch.where(own, p, torch.zeros_like(p)).sum(-1)
            dv = (v_self.to(f32) - v_chunk.to(f32)).permute(0, 2, 1, 3)
            in_tile = (c_row >= key0) & (c_row < key0 + KT)
            o = o + torch.where(in_tile[:, None], pd[..., None]
                                * dv[:, :, c_row], torch.zeros_like(o))
    return (o / l[..., None]).reshape(B, KV, G, C, hd)


def decode_splits_emulated(q, k_pages, v_pages, block_tables, ctx_len, *,
                           layer, k_scale=None, v_scale=None):
    """The decode kernel's split-K in plain PyTorch: the fp32 state of each
    fixed split of :data:`DECODE_SPLIT_KEYS` context keys, merged as the
    merge kernel does.  q (B, KV, G, hd) -> (o, m, l) as
    :func:`paged_attention_stats_ref`."""
    B, KV, G, hd = q.shape
    kc = gather_layer(k_pages, k_scale, layer, block_tables)
    vc = gather_layer(v_pages, v_scale, layer, block_tables)
    S = kc.shape[1]
    qf = q.to(torch.float32)
    m = torch.full((B, KV, G), NEG)
    l = torch.zeros((B, KV, G))
    o = torch.zeros((B, KV, G, hd))
    n_ctx = ctx_len.to(torch.int64).clamp(max=S)
    for k0 in range(0, S, DECODE_SPLIT_KEYS):
        sl = slice(k0, k0 + DECODE_SPLIT_KEYS)
        valid = (k0 + torch.arange(kc[:, sl].shape[1]))[None, :] \
            < n_ctx[:, None]
        live = (n_ctx > k0)[:, None, None]  # blocks past ctx do not run
        s = torch.einsum("bkgd,bskd->bkgs", qf, kc[:, sl]) * (hd**-0.5)
        s = torch.where(valid[:, None, None], s, torch.full_like(s, NEG))
        m_s = s.amax(-1)
        p = torch.where(valid[:, None, None], torch.exp(s - m_s[..., None]),
                        torch.zeros_like(s))
        l_s = p.sum(-1)
        o_s = torch.einsum("bkgs,bskd->bkgd", p, vc[:, sl])
        mx = torch.where(live, torch.maximum(m, m_s), m)
        w_old = torch.exp(m - mx)
        w_new = torch.where(live, torch.exp(m_s - mx), torch.zeros_like(m))
        l = l * w_old + l_s * w_new
        o = o * w_old[..., None] + o_s * w_new[..., None]
        m = mx
    return o, m[..., None], l[..., None]


def fold_self_token(q, o, m, l, k_new, v_new):
    """The decode merge epilogue: fold the token's own (k_new, v_new)
    (B, KV, hd) into the context state (o, m, l) of q (B, KV, G, hd) and
    normalize -> (B, KV, G, hd) fp32 (the formula of ``ops.py``)."""
    hd = q.shape[-1]
    s_self = torch.einsum("bkgd,bkd->bkg", q.to(torch.float32),
                          k_new.to(torch.float32)) * (hd**-0.5)
    m0, l0 = m[..., 0], l[..., 0]
    m_tot = torch.maximum(m0, s_self)
    a_ctx = torch.exp(m0 - m_tot)
    a_self = torch.exp(s_self - m_tot)
    num = o * a_ctx[..., None] + (
        v_new.to(torch.float32)[:, :, None, :] * a_self[..., None])
    return num / (l0 * a_ctx + a_self)[..., None]
