"""RWKV6 LM and the Zamba2-style hybrid (Mamba2 backbone + shared
attention block).

Both families are sub-quadratic: their decode state is O(1) in the context
length (the hybrid's shared block keeps a KV cache per invocation).

Hybrid layout: ``n_shared = n_layers // shared_attn_period`` invocations of
one SHARED transformer block (one weight copy, a distinct KV cache per
invocation), each after ``period - 1`` Mamba2 layers; the leftover Mamba2
layers form the tail.  zamba2-7b: 81 = 13·(5 mamba + 1 shared) + 3.

Layers are lists of per-layer dicts, as in ``models.transformer``; the
caches are ``[{"tm_shift", "wkv", "cm_shift"}]`` per RWKV layer, and
``{"mamba": [{"ssm", "conv"}] per Mamba2 layer, "kv": [{"k", "v"}] per
shared-block invocation}``.  ``hybrid_forward(plain=True)`` runs the
shared block's packed projections through quant_matmul's plain version;
RWKV has no packed weights.  While grad is enabled, each layer of a
forward (each Mamba2 layer and shared-block invocation of the hybrid)
runs under ``cfg.remat`` (``transformer.remat_wrap``).

Under a training mesh (``runtime/train_mesh.py``): the embedding and LM
head are vocab-parallel; RWKV6's time mix is head-parallel and its
channel mix ``ff``-parallel (``models/ssm.py`` says which leaves); the
hybrid's shared block is head- and ``ff``-parallel as a dense block is,
and its Mamba2 layers compute whole on every rank (``in_proj`` and
``out_proj`` gathered: the ``in_proj`` output ``[z, xBC, dt]`` is fused).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.models import layers as L
from repro_torch.models import ssm
from repro_torch.models.transformer import remat_wrap

__all__ = [
    "init_rwkv_lm", "rwkv_lm_axes", "rwkv_forward", "rwkv_prefill",
    "rwkv_decode_step", "init_rwkv_cache", "rwkv_cache_axes",
    "init_hybrid", "hybrid_axes", "hybrid_forward", "hybrid_prefill",
    "hybrid_decode_step", "init_hybrid_cache", "hybrid_cache_axes",
]


def _zero(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=x.device)


def _last_logits(params: dict, x: torch.Tensor, cfg: ArchConfig):
    x = L.norm_apply(params["final_norm"], x, cfg)
    return L.lm_logits(params["embed"], x[:, -1:, :])[:, 0]


# ===========================================================================
# RWKV6
# ===========================================================================


def init_rwkv_lm(cfg: ArchConfig, generator: torch.Generator, *,
                 device=DEFAULT_DEVICE) -> dict:
    device = resolve_device(device)
    d, g = cfg.d_model, generator
    layers = [{"ln1": L.init_norm(cfg, d, "ln", device=device),
               "time_mix": ssm.init_rwkv6(g, cfg, device=device),
               "ln2": L.init_norm(cfg, d, "ln", device=device),
               "channel_mix": ssm.init_channel_mix(g, cfg, device=device)}
              for _ in range(cfg.n_layers)]
    return {"embed": L.init_embedding(g, cfg, device=device),
            "ln0": L.init_norm(cfg, d, "ln", device=device),
            "layers": layers,
            "final_norm": L.init_norm(cfg, d, "ln", device=device)}


def rwkv_lm_axes(cfg: ArchConfig) -> dict:
    return {"embed": L.embedding_axes(cfg), "ln0": L.norm_axes("ln"),
            "layers": {"ln1": L.norm_axes("ln"), "time_mix": ssm.rwkv6_axes(),
                       "ln2": L.norm_axes("ln"),
                       "channel_mix": ssm.channel_mix_axes()},
            "final_norm": L.norm_axes("ln")}


def _rwkv_block(lp: dict, x, cfg: ArchConfig):
    x = x + ssm.rwkv6_time_mix(lp["time_mix"],
                               L.norm_apply(lp["ln1"], x, cfg), cfg)
    return x + ssm.channel_mix(lp["channel_mix"],
                               L.norm_apply(lp["ln2"], x, cfg))


def _rwkv_layers(params, tokens, cfg, mode: str, cache=None):
    """Run every RWKV layer over tokens.  ``mode``: "forward", "prefill"
    (also collect each layer's decode state) or "decode" (one token
    against ``cache``, returning the new states)."""
    x = L.embed(params["embed"], tokens)
    x = L.norm_apply(params["ln0"], x, cfg)
    if mode == "forward":
        block = remat_wrap(_rwkv_block, cfg)
        for lp in params["layers"]:
            x = block(lp, x, cfg)
        return x, []
    states = []
    for i, lp in enumerate(params["layers"]):
        h = L.norm_apply(lp["ln1"], x, cfg)
        if mode == "decode":
            st = cache[i]
            tm, tm_shift, wkv = ssm.rwkv6_time_mix_step(
                lp["time_mix"], h, cfg, st["tm_shift"], st["wkv"])
            x = x + tm
            h = L.norm_apply(lp["ln2"], x, cfg)
            cm, cm_shift = ssm.channel_mix_step(lp["channel_mix"], h,
                                                st["cm_shift"])
        else:
            tm, tm_shift, wkv = ssm.rwkv6_time_mix(lp["time_mix"], h, cfg,
                                                   return_state=True)
            x = x + tm
            h = L.norm_apply(lp["ln2"], x, cfg)
            cm, cm_shift = ssm.channel_mix(lp["channel_mix"], h,
                                           return_state=True)
        x = x + cm
        states.append({"tm_shift": tm_shift, "wkv": wkv,
                       "cm_shift": cm_shift})
    return x, states


def rwkv_forward(params: dict, tokens: torch.Tensor, cfg: ArchConfig, *,
                 plain: bool = False):
    """tokens (B, S) -> (hidden (B, S, D), aux 0)."""
    x, _ = _rwkv_layers(params, tokens, cfg, "forward")
    return L.norm_apply(params["final_norm"], x, cfg), _zero(x)


def init_rwkv_cache(cfg: ArchConfig, batch: int, max_len: int = 0,
                    kv_dtype=None, *, device=DEFAULT_DEVICE) -> list:
    """Recurrent state (the context length enters only through its
    contents)."""
    device = resolve_device(device)
    d, hs = cfg.d_model, cfg.rwkv_head_size
    dt = L._dtype(cfg)
    return [{"tm_shift": torch.zeros((batch, 1, d), dtype=dt, device=device),
             "wkv": torch.zeros((batch, d // hs, hs, hs), dtype=torch.float32,
                                device=device),
             "cm_shift": torch.zeros((batch, 1, d), dtype=dt, device=device)}
            for _ in range(cfg.n_layers)]


def rwkv_cache_axes(cfg: ArchConfig, int8: bool = False) -> dict:
    """The axes of one layer's state (every layer has the same)."""
    return {"tm_shift": ("batch", None, None),
            "wkv": ("batch", None, None, None),
            "cm_shift": ("batch", None, None)}


def rwkv_prefill(params: dict, tokens: torch.Tensor, cfg: ArchConfig,
                 kv_dtype=None, max_len=None):
    x, states = _rwkv_layers(params, tokens, cfg, "prefill")
    return _last_logits(params, x, cfg), states


def rwkv_decode_step(params: dict, tokens: torch.Tensor, cfg: ArchConfig,
                     cache: list, pos: int):
    x, states = _rwkv_layers(params, tokens, cfg, "decode", cache)
    x = L.norm_apply(params["final_norm"], x, cfg)
    return L.lm_logits(params["embed"], x)[:, 0], states


# ===========================================================================
# Hybrid (zamba2-style)
# ===========================================================================


def _hybrid_counts(cfg: ArchConfig):
    """(n_shared, Mamba2 layers per superblock, n_mamba, tail)."""
    per = cfg.shared_attn_period
    n_shared = cfg.n_layers // per
    n_mamba = cfg.n_layers - n_shared
    return n_shared, per - 1, n_mamba, n_mamba - n_shared * (per - 1)


def init_hybrid(cfg: ArchConfig, generator: torch.Generator, *,
                device=DEFAULT_DEVICE) -> dict:
    device = resolve_device(device)
    d, g = cfg.d_model, generator
    _, _, n_mamba, _ = _hybrid_counts(cfg)
    return {
        "embed": L.init_embedding(g, cfg, device=device),
        "mamba_layers": [{"norm": L.init_norm(cfg, d, device=device),
                          "mamba": ssm.init_mamba2(g, cfg, device=device)}
                         for _ in range(n_mamba)],
        "shared": {"ln1": L.init_norm(cfg, d, device=device),
                   "attn": L.init_attention(g, cfg, device=device),
                   "ln2": L.init_norm(cfg, d, device=device),
                   "mlp": L.init_mlp(g, cfg, device=device)},
        "final_norm": L.init_norm(cfg, d, device=device),
    }


def hybrid_axes(cfg: ArchConfig) -> dict:
    return {"embed": L.embedding_axes(cfg),
            "mamba_layers": {"norm": L.norm_axes(),
                             "mamba": ssm.mamba2_axes(cfg)},
            "shared": {"ln1": L.norm_axes(), "attn": L.attention_axes(cfg),
                       "ln2": L.norm_axes(), "mlp": L.mlp_axes(cfg)},
            "final_norm": L.norm_axes()}


def _order(cfg: ArchConfig):
    """The layer order: ("mamba", i) and ("shared", j) in the JAX
    package's superblock order, the tail last."""
    n_shared, per_m, n_mamba, _ = _hybrid_counts(cfg)
    out = []
    for j in range(n_shared):
        out += [("mamba", j * per_m + i) for i in range(per_m)]
        out.append(("shared", j))
    return out + [("mamba", i) for i in range(n_shared * per_m, n_mamba)]


def _shared_block(sp: dict, x, cfg: ArchConfig, positions, *,
                  plain: bool = False):
    """-> (x, post-RoPE (k, v))."""
    h = L.norm_apply(sp["ln1"], x, cfg)
    a, kv = L.attention_full(sp["attn"], h, cfg, positions=positions,
                             return_kv=True, plain=plain)
    x = x + a
    h = L.norm_apply(sp["ln2"], x, cfg)
    return x + L.mlp_apply(sp["mlp"], h, cfg, plain=plain), kv


def _mamba_block(lp: dict, x, cfg: ArchConfig):
    return x + ssm.mamba2_forward(lp["mamba"], L.norm_apply(lp["norm"], x,
                                                            cfg), cfg)


def _hybrid_full(params, tokens, cfg, *, plain: bool = False, kv_dtype=None,
                 max_len=None, states: bool = False):
    B, S = tokens.shape
    positions = torch.arange(S, dtype=torch.int32, device=tokens.device)
    x = L.embed(params["embed"], tokens)
    mamba_st = [None] * len(params["mamba_layers"])
    kv = []
    mamba_block = remat_wrap(_mamba_block, cfg)
    shared_block = remat_wrap(_shared_block, cfg)
    for kind, i in _order(cfg):
        if kind == "mamba":
            lp = params["mamba_layers"][i]
            if states:
                h = L.norm_apply(lp["norm"], x, cfg)
                y, mamba_st[i] = ssm.mamba2_forward(lp["mamba"], h, cfg,
                                                    return_state=True)
                x = x + y
            else:
                x = mamba_block(lp, x, cfg)
        else:
            x, (k, v) = shared_block(params["shared"], x, cfg, positions,
                                     plain=plain)
            if states:
                kv0 = L.init_kv_cache(cfg, B, max_len or S, kv_dtype,
                                      device=x.device)
                kv.append(L.cache_store(kv0, k, v, 0))
    return x, {"mamba": mamba_st, "kv": kv}


def hybrid_forward(params: dict, tokens: torch.Tensor, cfg: ArchConfig, *,
                   plain: bool = False):
    x, _ = _hybrid_full(params, tokens, cfg, plain=plain)
    return L.norm_apply(params["final_norm"], x, cfg), _zero(x)


def init_hybrid_cache(cfg: ArchConfig, batch: int, max_len: int,
                      kv_dtype=None, *, device=DEFAULT_DEVICE) -> dict:
    device = resolve_device(device)
    n_shared, _, n_mamba, _ = _hybrid_counts(cfg)
    return {"mamba": [ssm.init_mamba2_state(cfg, batch, device=device)
                      for _ in range(n_mamba)],
            "kv": [L.init_kv_cache(cfg, batch, max_len, kv_dtype,
                                   device=device)
                   for _ in range(n_shared)]}


def hybrid_cache_axes(cfg: ArchConfig, int8: bool = False) -> dict:
    """The axes of one Mamba2 layer's state and one invocation's cache."""
    return {"mamba": ssm.mamba2_state_axes(), "kv": L.kv_cache_axes(int8)}


def hybrid_prefill(params: dict, tokens: torch.Tensor, cfg: ArchConfig,
                   kv_dtype=None, max_len=None):
    x, cache = _hybrid_full(params, tokens, cfg, kv_dtype=kv_dtype,
                            max_len=max_len, states=True)
    return _last_logits(params, x, cfg), cache


def hybrid_decode_step(params: dict, tokens: torch.Tensor, cfg: ArchConfig,
                       cache: dict, pos: int):
    x = L.embed(params["embed"], tokens)
    mamba_st = list(cache["mamba"])
    kv = list(cache["kv"])
    sp = params["shared"]
    for kind, i in _order(cfg):
        if kind == "mamba":
            lp = params["mamba_layers"][i]
            h = L.norm_apply(lp["norm"], x, cfg)
            y, mamba_st[i] = ssm.mamba2_decode_step(lp["mamba"], h, cfg,
                                                    mamba_st[i])
            x = x + y
        else:
            h = L.norm_apply(sp["ln1"], x, cfg)
            a, kv[i] = L.attention_decode(sp["attn"], h, cfg, kv[i], pos)
            x = x + a
            h = L.norm_apply(sp["ln2"], x, cfg)
            x = x + L.mlp_apply(sp["mlp"], h, cfg)
    x = L.norm_apply(params["final_norm"], x, cfg)
    return L.lm_logits(params["embed"], x)[:, 0], {"mamba": mamba_st,
                                                   "kv": kv}
