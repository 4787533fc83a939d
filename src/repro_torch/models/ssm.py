"""Attention-free sequence mixers: Mamba2 (SSD) and RWKV6 ("Finch").

Both are linear-attention-family recurrences

    h_t = diag(d_t) h_{t-1} + k_t^T v_t,      y_t = q_t h_t (+ bonus)

computed with the JAX package's *chunked* algorithm: intra-chunk terms are
attention-like matmuls with decay masks, and the inter-chunk state (fp32)
is carried from chunk to chunk.  The per-step recurrences are the decode
steps, and the ``*_scan_ref`` oracles (tests only) apply them token by
token.  Every product is a plain ``torch.matmul`` / ``einsum``, as in the
JAX package, where none of this reaches a Pallas kernel.

Under a training mesh (``runtime/sharding.py``'s ``constrain``, at the JAX
package's points): RWKV6's time mix is head-parallel — its input feeds the
rank's heads (``wr wk wv wg`` columns, ``decay_B``, ``w0``, ``ln_x`` and
``bonus`` cut to them by the plan; the token-shift mixes and ``decay_A``
whole), the group norm is per head and the row-parallel ``wo`` is summed;
its channel mix is ``ff``-parallel (``wk`` columns, ``wv`` rows, summed)
with the ``d_model``-wide ``wr`` gate whole; Mamba2 computes whole on
every rank (its ``in_proj`` output ``[z, xBC, dt]`` is fused).

Numerical safety: decay factors are applied as exp(Δlog) with Δlog ≤ 0
wherever possible.  RWKV6's per-channel decay needs the factored form
exp(+cum)·exp(−cum): log-decay is clamped to ≥ −4 (``_LOGW_MIN``) and the
chunk is 16 tokens, so the factored exponentials stay well inside fp32.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import (
    _dtype,
    _resid,
    init_dense,
    matmul,
    rms_norm,
)
from repro_torch.runtime.sharding import constrain

__all__ = [
    "init_mamba2", "mamba2_axes", "mamba2_forward", "xBC_tail_state",
    "init_mamba2_state", "mamba2_state_axes", "mamba2_decode_step",
    "mamba2_scan_ref", "init_rwkv6", "rwkv6_axes", "init_channel_mix",
    "channel_mix_axes", "rwkv6_time_mix", "rwkv6_time_mix_step",
    "channel_mix", "channel_mix_step", "rwkv6_scan_ref",
]


def _chunk(T: int, chunk: int) -> int:
    c = min(chunk, T)
    while T % c:
        c -= 1
    return c


# ===========================================================================
# Mamba2
# ===========================================================================


def init_mamba2(g: torch.Generator, cfg: ArchConfig, *, device) -> dict:
    dt = _dtype(cfg)
    d, di, N, H = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    conv_dim = di + 2 * N  # conv over [x, B, C]
    f32 = dict(dtype=torch.float32, device=device)
    return {
        # in_proj -> [z (di), x (di), B (N), C (N), dt (H)]
        "in_proj": init_dense(g, (d, 2 * di + 2 * N + H), dt, device=device),
        "conv_w": init_dense(g, (cfg.ssm_conv, conv_dim), dt, 0.2,
                             device=device),
        "conv_b": torch.zeros(conv_dim, dtype=dt, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, **f32)),
        "D": torch.ones(H, **f32),
        "dt_bias": torch.zeros(H, **f32),
        "norm": torch.ones(di, dtype=dt, device=device),  # gated RMSNorm
        "out_proj": init_dense(g, (di, d), dt, di**-0.5 * _resid(cfg),
                               device=device),
    }


def mamba2_axes(cfg: ArchConfig) -> dict:
    return {"in_proj": ("embed", "ff"), "conv_w": ("conv", None),
            "conv_b": (None,), "A_log": (None,), "D": (None,),
            "dt_bias": (None,), "norm": ("norm",), "out_proj": ("ff", "embed")}


def _mamba2_split(p: dict, cfg: ArchConfig, u: torch.Tensor):
    di, N = cfg.d_inner, cfg.ssm_state
    zxbcdt = matmul(u, p["in_proj"])
    return (zxbcdt[..., :di], zxbcdt[..., di:2 * di + 2 * N],
            zxbcdt[..., 2 * di + 2 * N:])


def _causal_conv(xBC: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv along seq.  xBC: (B, T, C); w: (K, C)."""
    K, T = w.shape[0], xBC.shape[1]
    pad = F.pad(xBC, (0, 0, K - 1, 0))
    out = sum(pad[:, i:i + T, :] * w[i][None, None, :] for i in range(K))
    return F.silu(out + b)


def mamba2_forward(p: dict, u: torch.Tensor, cfg: ArchConfig, *,
                   chunk: int = 128, return_state: bool = False):
    """Chunked SSD forward.  u: (B, T, D) -> (B, T, D) (and the decode
    state ``{"ssm", "conv"}`` with ``return_state``)."""
    B, T, _ = u.shape
    di, N, H, hd = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    z, xBC_pre, dtr = _mamba2_split(p, cfg, u)
    xBC = _causal_conv(xBC_pre, p["conv_w"], p["conv_b"])
    x = xBC[..., :di].reshape(B, T, H, hd)
    xf = x.to(torch.float32)
    Bm = xBC[..., di:di + N].to(torch.float32)  # (B, T, N), one group
    Cm = xBC[..., di + N:].to(torch.float32)

    dt = F.softplus(dtr.to(torch.float32) + p["dt_bias"])  # (B, T, H)
    log_a = dt * -torch.exp(p["A_log"])  # (B, T, H) <= 0

    c = _chunk(T, chunk)
    mask = torch.tril(torch.ones((c, c), dtype=torch.bool, device=u.device))
    h = torch.zeros((B, H, hd, N), dtype=torch.float32, device=u.device)
    ys = []
    for t0 in range(0, T, c):
        sl = slice(t0, t0 + c)
        xq, Bq, Cq, dtq = xf[:, sl], Bm[:, sl], Cm[:, sl], dt[:, sl]
        cumq = torch.cumsum(log_a[:, sl], dim=1)  # inclusive (B, c, H)
        # intra-chunk: M[t,s] = CB[t,s] * exp(cum_t - cum_s) * dt_s, t >= s
        CB = torch.einsum("btn,bsn->bts", Cq, Bq)
        dlt = cumq[:, :, None, :] - cumq[:, None, :, :]  # (B, c, c, H)
        dec = torch.exp(torch.where(mask[None, :, :, None], dlt, -math.inf))
        M = CB[..., None] * dec * dtq[:, None, :, :]
        y_intra = torch.einsum("btsh,bshd->bthd", M, xq)
        # inter-chunk: y_t += exp(cum_t) * C_t . h_prev
        y_inter = torch.einsum("btn,bhdn->bthd", Cq, h) \
            * torch.exp(cumq)[..., None]
        # h' = exp(cum_last) h + sum_s exp(cum_last - cum_s) dt_s x_s B_s^T
        cum_last = cumq[:, -1, :]  # (B, H)
        w = torch.exp(cum_last[:, None, :] - cumq) * dtq
        dh = torch.einsum("bsh,bshd,bsn->bhdn", w, xq, Bq)
        h = torch.exp(cum_last)[:, :, None, None] * h + dh
        ys.append((y_intra + y_inter).to(u.dtype))
    y = torch.cat(ys, dim=1) if len(ys) > 1 else ys[0]
    y = y + p["D"][None, None, :, None] * xf
    y = y.reshape(B, T, di).to(u.dtype)
    y = rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    out = constrain(matmul(y, p["out_proj"]), ("batch", "seq", "act_embed"))
    if return_state:
        K = cfg.ssm_conv  # the pre-conv rows xBC_tail_state would recompute
        return out, {"ssm": h,
                     "conv": xBC_pre[:, -(K - 1):, :].to(torch.float32)}
    return out


def xBC_tail_state(p: dict, cfg: ArchConfig, u: torch.Tensor) -> torch.Tensor:
    """Last (K-1) pre-conv xBC rows: the decode-time conv state."""
    _, xBC_pre, _ = _mamba2_split(p, cfg, u)
    return xBC_pre[:, -(cfg.ssm_conv - 1):, :].to(torch.float32)


def init_mamba2_state(cfg: ArchConfig, batch: int, *, device) -> dict:
    di, N, H, hd = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    return {
        "ssm": torch.zeros((batch, H, hd, N), dtype=torch.float32,
                           device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, di + 2 * N),
                            dtype=torch.float32, device=device),
    }


def mamba2_state_axes() -> dict:
    return {"ssm": ("batch", None, None, None), "conv": ("batch", None, None)}


def mamba2_decode_step(p: dict, u: torch.Tensor, cfg: ArchConfig,
                       state: dict):
    """u: (B, 1, D); the O(1) recurrence.  Returns (y (B, 1, D),
    new_state)."""
    B = u.shape[0]
    di, N, H, hd = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    z, xBC_pre, dtr = _mamba2_split(p, cfg, u)
    xBC_pre = xBC_pre[:, 0].to(torch.float32)  # (B, conv_dim)
    window = torch.cat([state["conv"], xBC_pre[:, None, :]], dim=1)
    xBC = F.silu(torch.einsum("bkc,kc->bc", window,
                              p["conv_w"].to(torch.float32))
                 + p["conv_b"].to(torch.float32))
    x = xBC[:, :di].reshape(B, H, hd)
    Bm, Cm = xBC[:, di:di + N], xBC[:, di + N:]
    dt = F.softplus(dtr[:, 0].to(torch.float32) + p["dt_bias"])  # (B, H)
    a = torch.exp(dt * -torch.exp(p["A_log"]))
    h = a[:, :, None, None] * state["ssm"] \
        + torch.einsum("bh,bhd,bn->bhdn", dt, x, Bm)
    y = torch.einsum("bn,bhdn->bhd", Cm, h) + p["D"][None, :, None] * x
    y = y.reshape(B, 1, di).to(u.dtype)
    y = rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    return matmul(y, p["out_proj"]), {"ssm": h, "conv": window[:, 1:, :]}


def mamba2_scan_ref(p: dict, u: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Naive per-step oracle (tests only)."""
    state = init_mamba2_state(cfg, u.shape[0], device=u.device)
    ys = []
    for t in range(u.shape[1]):
        y, state = mamba2_decode_step(p, u[:, t:t + 1], cfg, state)
        ys.append(y)
    return torch.cat(ys, dim=1)


# ===========================================================================
# RWKV6 ("Finch": data-dependent decay)
# ===========================================================================

_LOGW_MIN = -4.0  # per-step log-decay clamp (chunked-form fp32 safety)


def init_rwkv6(g: torch.Generator, cfg: ArchConfig, *, device) -> dict:
    dt = _dtype(cfg)
    d = cfg.d_model
    H = d // cfg.rwkv_head_size
    ml, dl = cfg.rwkv_mix_lora, cfg.rwkv_decay_lora

    def w(shape, std=None):
        return init_dense(g, shape, dt, std, device=device)

    return {
        # token-shift data-dependent mixing (5 targets: r, k, v, g, w)
        "mu_x": torch.full((d,), 0.5, dtype=dt, device=device),
        "mu": torch.full((5, d), 0.5, dtype=dt, device=device),
        "mix_w1": w((d, 5 * ml), 0.02),
        "mix_w2": w((5, ml, d), 0.02),
        "wr": w((d, d)),
        "wk": w((d, d)),
        "wv": w((d, d)),
        "wg": w((d, d)),
        "wo": w((d, d), d**-0.5 * _resid(cfg)),
        # data-dependent decay LoRA: logw = -exp(w0 + tanh(x A) B)
        "w0": torch.zeros(d, dtype=torch.float32, device=device),
        "decay_A": w((d, dl), 0.02),
        "decay_B": w((dl, d), 0.02),
        "bonus": torch.zeros((H, cfg.rwkv_head_size), dtype=torch.float32,
                             device=device),  # u
        "ln_x": torch.ones(d, dtype=dt, device=device),  # head group norm
    }


def rwkv6_axes() -> dict:
    return {"mu_x": (None,), "mu": (None, None), "mix_w1": ("embed", None),
            "mix_w2": (None, None, "embed"), "wr": ("embed", "heads"),
            "wk": ("embed", "heads"), "wv": ("embed", "heads"),
            "wg": ("embed", "heads"), "wo": ("heads", "embed"),
            "w0": (None,), "decay_A": ("embed", None),
            "decay_B": (None, "embed"), "bonus": (None, None),
            "ln_x": ("norm",)}


def init_channel_mix(g: torch.Generator, cfg: ArchConfig, *, device) -> dict:
    dt = _dtype(cfg)
    d, f = cfg.d_model, cfg.d_ff
    return {
        "mu_k": torch.full((d,), 0.5, dtype=dt, device=device),
        "mu_r": torch.full((d,), 0.5, dtype=dt, device=device),
        "wk": init_dense(g, (d, f), dt, device=device),
        "wv": init_dense(g, (f, d), dt, f**-0.5 * _resid(cfg),
                         device=device),
        "wr": init_dense(g, (d, d), dt, device=device),
    }


def channel_mix_axes() -> dict:
    return {"mu_k": (None,), "mu_r": (None,), "wk": ("embed", "ff"),
            "wv": ("ff", "embed"), "wr": ("embed", "heads")}


def _token_shift(x: torch.Tensor, prev: Optional[torch.Tensor]):
    """Previous-token features: (B, T, D) -> (B, T, D) shifted right."""
    if prev is None:
        prev = torch.zeros_like(x[:, :1])
    return torch.cat([prev.to(x.dtype), x[:, :-1]], dim=1)


def _rwkv_mix(p: dict, x: torch.Tensor, xprev: torch.Tensor):
    """Data-dependent lerp producing the 5 mixed inputs (r, k, v, g, w)."""
    dx = xprev - x
    xxx = x + dx * p["mu_x"]
    ml = p["mix_w2"].shape[1]
    lora = torch.tanh(matmul(xxx, p["mix_w1"]))  # (B, T, 5*ml)
    B_, T_, _ = lora.shape
    lora = lora.reshape(B_, T_, 5, ml)
    dt = torch.promote_types(lora.dtype, p["mix_w2"].dtype)
    adjust = torch.einsum("btfm,fmd->btfd", lora.to(dt),
                          p["mix_w2"].to(dt))  # (B, T, 5, D)
    mixed = x[:, :, None, :] + dx[:, :, None, :] * (p["mu"][None, None]
                                                    + adjust)
    return [mixed[:, :, i, :] for i in range(5)]


def _rwkv_logw(p: dict, xw: torch.Tensor) -> torch.Tensor:
    """Per-channel log decay in [-4, ~0)."""
    z = p["w0"] + matmul(torch.tanh(matmul(xw, p["decay_A"])),
                         p["decay_B"]).to(torch.float32)
    logw = -torch.exp(torch.clamp(z, -12.0, math.log(-_LOGW_MIN)))
    return torch.clamp(logw, min=_LOGW_MIN)


def _group_norm_gate(p: dict, y: torch.Tensor, g: torch.Tensor,
                     x: torch.Tensor) -> torch.Tensor:
    """Per-head RMS norm (eps 64e-5, unit scale) of y (B, T, H, hs) fp32,
    then ``ln_x`` and the gate, and ``wo`` (summed over the heads'
    ranks)."""
    B, T = x.shape[:2]
    y = rms_norm(y, torch.ones(y.shape[-1], device=y.device), 64e-5)
    y = (y.reshape(B, T, -1).to(x.dtype) * p["ln_x"]) * g
    return constrain(matmul(y, p["wo"]), ("batch", "seq", "act_embed"),
                     summed="act_heads")


def rwkv6_time_mix(p: dict, x: torch.Tensor, cfg: ArchConfig, *,
                   chunk: int = 16, shift_state=None, wkv_state=None,
                   return_state: bool = False):
    """RWKV6 time mixing, chunked.  x: (B, T, D) -> (B, T, D) (and the
    last token, the new shift state, and the wkv state (B, H, hs, hs) with
    ``return_state``)."""
    B, T, D = x.shape
    hs = cfg.rwkv_head_size
    x = constrain(x, ("batch", "seq", "act_embed"), feeds="act_heads")
    xr, xk, xv, xg, xw = _rwkv_mix(p, x, _token_shift(x, shift_state))
    f32 = torch.float32
    H = p["wr"].shape[-1] // hs  # this rank's heads under a mesh
    r = matmul(xr, p["wr"]).reshape(B, T, H, hs).to(f32)
    k = matmul(xk, p["wk"]).reshape(B, T, H, hs).to(f32)
    v = matmul(xv, p["wv"]).reshape(B, T, H, hs).to(f32)
    g = F.silu(matmul(xg, p["wg"]))
    logw = _rwkv_logw(p, xw).reshape(B, T, H, hs)
    u = p["bonus"]  # (H, hs)

    c = _chunk(T, chunk)
    # strict causal mask (s < t); the s == t term is the bonus
    mask = torch.tril(torch.ones((c, c), dtype=torch.bool, device=x.device),
                      diagonal=-1)
    S = (wkv_state.to(f32) if wkv_state is not None
         else torch.zeros((B, H, hs, hs), dtype=f32, device=x.device))
    ys = []
    for t0 in range(0, T, c):
        sl = slice(t0, t0 + c)
        rq, kq, vq, wq = r[:, sl], k[:, sl], v[:, sl], logw[:, sl]
        cumq = torch.cumsum(wq, dim=1)  # inclusive per-channel log decay
        # s < t: (r_t ⊙ e^{cum_{t-1}}) (k_s ⊙ e^{-cum_s}), with
        # cum_{t-1} = cum_t - w_t
        r_dec = rq * torch.exp(cumq - wq)
        k_dec = kq * torch.exp(-cumq)
        att = torch.einsum("bthn,bshn->bhts", r_dec, k_dec)
        att = torch.where(mask[None, None], att, 0.0)
        y_intra = torch.einsum("bhts,bshn->bthn", att, vq)
        # bonus (current token)
        rk = torch.einsum("bthn,bthn->bth", rq * u[None, None], kq)
        y_bonus = rk[..., None] * vq
        # inter-chunk: y_t += (r_t ⊙ e^{cum_{t-1}}) . S_prev
        y_inter = torch.einsum("bthn,bhnm->bthm", r_dec, S)
        # S' = diag(e^{cum_last}) S + Σ_s (k_s e^{cum_last - cum_s}) v_s
        cum_last = cumq[:, -1]  # (B, H, hs)
        k_up = kq * torch.exp(cum_last[:, None] - cumq)
        S = torch.exp(cum_last)[..., None] * S \
            + torch.einsum("bshn,bshm->bhnm", k_up, vq)
        ys.append(y_intra + y_bonus + y_inter)
    y = torch.cat(ys, dim=1) if len(ys) > 1 else ys[0]
    out = _group_norm_gate(p, y, g, x)
    if return_state:
        return out, x[:, -1:, :], S
    return out


def rwkv6_time_mix_step(p: dict, x: torch.Tensor, cfg: ArchConfig,
                        shift_state: torch.Tensor, wkv_state: torch.Tensor):
    """Single-token recurrence.  x: (B, 1, D).  Returns (out, new shift
    state, new wkv state)."""
    B, _, D = x.shape
    hs = cfg.rwkv_head_size
    H = D // hs
    xr, xk, xv, xg, xw = _rwkv_mix(p, x, shift_state.to(x.dtype))
    f32 = torch.float32
    r = matmul(xr, p["wr"]).reshape(B, H, hs).to(f32)
    k = matmul(xk, p["wk"]).reshape(B, H, hs).to(f32)
    v = matmul(xv, p["wv"]).reshape(B, H, hs).to(f32)
    g = F.silu(matmul(xg, p["wg"]))
    w = torch.exp(_rwkv_logw(p, xw).reshape(B, H, hs))
    u = p["bonus"]
    # y = r . (S + u ⊙ k^T v)
    kv = torch.einsum("bhn,bhm->bhnm", k, v)
    y = torch.einsum("bhn,bhnm->bhm", r, wkv_state + u[None, :, :, None] * kv)
    S_new = w[..., None] * wkv_state + kv
    return _group_norm_gate(p, y[:, None], g, x), x, S_new


def channel_mix(p: dict, x: torch.Tensor, shift_state=None,
                return_state: bool = False):
    xprev = _token_shift(x, shift_state)
    out = _channel_mix(p, x, xprev)
    if return_state:
        return out, x[:, -1:, :]
    return out


def _channel_mix(p: dict, x: torch.Tensor, xprev: torch.Tensor):
    xk = x + (xprev - x) * p["mu_k"]
    xr = x + (xprev - x) * p["mu_r"]
    xk = constrain(xk, ("batch", "seq", "act_embed"), feeds="act_ff")
    h = torch.square(F.relu(matmul(xk, p["wk"])))
    h = constrain(h, ("batch", "seq", "act_ff"))
    kv = constrain(matmul(h, p["wv"]), ("batch", "seq", "act_embed"),
                   summed="act_ff")
    return torch.sigmoid(matmul(xr, p["wr"])) * kv


def channel_mix_step(p: dict, x: torch.Tensor, shift_state: torch.Tensor):
    return _channel_mix(p, x, shift_state.to(x.dtype)), x


def rwkv6_scan_ref(p: dict, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Per-step oracle for the chunked time-mix (tests only)."""
    B, T, D = x.shape
    hs = cfg.rwkv_head_size
    shift = torch.zeros((B, 1, D), dtype=x.dtype, device=x.device)
    S = torch.zeros((B, D // hs, hs, hs), dtype=torch.float32,
                    device=x.device)
    ys = []
    for t in range(T):
        y, shift, S = rwkv6_time_mix_step(p, x[:, t:t + 1], cfg, shift, S)
        ys.append(y)
    return torch.cat(ys, dim=1)
