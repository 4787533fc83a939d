"""Encoder-decoder (whisper-style) and VLM (llama-3.2-vision-style) stacks.

The modality frontends are stubs, as in the JAX package: the batch carries
precomputed frame embeddings ``"frames"`` (B, S_enc, d_model) for encdec
and patch embeddings ``"patches"`` (B, n_patches, d_model) for vlm beside
``"tokens"``; only the transformer backbone is real (and packable with
``cfg.weight_bits``).

Layers are lists of per-layer dicts, applied in Python loops where the JAX
package stacks and scans them (``models.transformer``'s layout):

* encdec ``{"embed", "enc_layers", "enc_norm", "dec_layers",
  "final_norm"}``: a bidirectional, RoPE'd, layer-normed encoder; decoder
  layers of causal self-attention, cross attention over the encoder states
  (``ln_x``, ``xattn``) and a GeLU MLP.
* vlm ``{"embed", "self_layers", "cross_layers", "final_norm"}``:
  ``n_layers // cross_every`` superblocks of ``cross_every - 1`` self
  layers and one gated cross layer (``xattn`` with its ``gate``, and
  ``mlp_gate``: ``x + tanh(mlp_gate)·mlp``), then the leftover self layers
  as a tail.

A fresh init sets every gate to 0, as the JAX package's does, so the vlm's
cross path adds nothing until the gates are set.

Caches are ``{"self": [one dense KV cache per self-attention layer],
"cross": [one per cross layer]}``; a prefill computes each cross layer's
K/V once, uses them for its attention and stores them, and decode reads
them without storing.  ``*_forward(plain=True)`` runs packed projections
through quant_matmul's plain version (the oracle's path).  While grad is
enabled, each encoder, decoder, self and cross layer of a forward runs
under ``cfg.remat`` (``transformer.remat_wrap``).

Under a training mesh (``runtime/train_mesh.py``) every self and cross
attention is head-parallel (the encoder states or the patches feed the
rank's K/V heads, so their gradient is summed over ``model``), every MLP
``ff``-parallel and the embedding vocab-parallel; the vlm's ``xattn.gate``
and ``mlp_gate`` scale an output after its sum, so they compute whole on
every rank, as do the norms.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.models import layers as L
from repro_torch.models.recurrent import _last_logits, _zero
from repro_torch.models.transformer import remat_wrap

__all__ = [
    "init_encdec", "encdec_axes", "encdec_forward", "encdec_prefill",
    "encdec_decode_step", "init_encdec_cache", "encdec_cache_axes",
    "init_vlm", "vlm_axes", "vlm_forward", "vlm_prefill",
    "vlm_decode_step", "init_vlm_cache", "vlm_cache_axes",
]


def _arange(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int32, device=device)


def _caches(cfg: ArchConfig, x: torch.Tensor, kv_dtype, max_len,
            cross_len: int) -> tuple:
    """What a prefill fills: ``{"self": [], "cross": []}`` and two makers
    of one layer's cache, a self cache of ``max_len`` in ``kv_dtype`` and
    a cross cache of ``cross_len`` in the model's dtype (never int8), each
    holding the given K/V from position 0."""
    B, S = x.shape[:2]

    def store(length, dtype):
        return lambda k, v: L.cache_store(
            L.init_kv_cache(cfg, B, length, dtype, device=x.device), k, v, 0)

    return ({"self": [], "cross": []}, store(max_len or S, kv_dtype),
            store(cross_len, None))


def _self_attn(lp: dict, x, cfg, positions, plain: bool):
    """Causal self-attention of a pre-normed block -> (x + attn, (k, v))."""
    h = L.norm_apply(lp["ln1"], x, cfg)
    a, kv = L.attention_full(lp["attn"], h, cfg, positions=positions,
                             causal=True, return_kv=True, plain=plain)
    return x + a, kv


# ===========================================================================
# Encoder-decoder (whisper backbone; conv audio frontend stubbed)
# ===========================================================================


def _n_enc_dec(cfg: ArchConfig) -> tuple[int, int]:
    return cfg.n_enc_layers or cfg.n_layers, cfg.n_dec_layers or cfg.n_layers


def init_encdec(cfg: ArchConfig, generator: torch.Generator, *,
                device=DEFAULT_DEVICE) -> dict:
    device = resolve_device(device)
    d, g = cfg.d_model, generator
    n_enc, n_dec = _n_enc_dec(cfg)

    def block():
        return {"ln1": L.init_norm(cfg, d, "ln", device=device),
                "attn": L.init_attention(g, cfg, device=device),
                "ln2": L.init_norm(cfg, d, "ln", device=device),
                "mlp": L.init_mlp(g, cfg, device=device)}

    enc = [block() for _ in range(n_enc)]
    dec = [{**block(), "ln_x": L.init_norm(cfg, d, "ln", device=device),
            "xattn": L.init_attention(g, cfg, device=device)}
           for _ in range(n_dec)]
    return {"embed": L.init_embedding(g, cfg, device=device),
            "enc_layers": enc,
            "enc_norm": L.init_norm(cfg, d, "ln", device=device),
            "dec_layers": dec,
            "final_norm": L.init_norm(cfg, d, "ln", device=device)}


def encdec_axes(cfg: ArchConfig) -> dict:
    """Logical axes, one per-layer dict for each (unstacked) layer list."""
    enc = {"ln1": L.norm_axes("ln"), "attn": L.attention_axes(cfg),
           "ln2": L.norm_axes("ln"), "mlp": L.mlp_axes(cfg)}
    dec = {**enc, "ln_x": L.norm_axes("ln"), "xattn": L.attention_axes(cfg)}
    return {"embed": L.embedding_axes(cfg), "enc_layers": enc,
            "enc_norm": L.norm_axes("ln"), "dec_layers": dec,
            "final_norm": L.norm_axes("ln")}


def _encode(params: dict, frames: torch.Tensor, cfg: ArchConfig, *,
            plain: bool = False) -> torch.Tensor:
    """frames (B, S_enc, D) stub embeddings -> encoder states: pre-norm
    blocks of bidirectional RoPE'd self-attention and MLP, then
    ``enc_norm``."""
    positions = _arange(frames.shape[1], frames.device)
    x = frames
    block = remat_wrap(_enc_block, cfg)
    for lp in params["enc_layers"]:
        x = block(lp, x, cfg, positions, plain)
    return L.norm_apply(params["enc_norm"], x, cfg)


def _enc_block(lp: dict, x, cfg, positions, plain: bool):
    h = L.norm_apply(lp["ln1"], x, cfg)
    x = x + L.attention_full(lp["attn"], h, cfg, positions=positions,
                             causal=False, plain=plain)
    h = L.norm_apply(lp["ln2"], x, cfg)
    return x + L.mlp_apply(lp["mlp"], h, cfg, plain=plain)


def _dec_block(lp: dict, x, enc, cfg, positions, *, plain: bool = False):
    """-> (x, self (k, v), cross (k, v))."""
    x, kv = _self_attn(lp, x, cfg, positions, plain)
    h = L.norm_apply(lp["ln_x"], x, cfg)
    xa, ckv = L.attention_full(lp["xattn"], h, cfg, positions=positions,
                               causal=False, x_kv=enc, return_kv=True,
                               plain=plain)
    x = x + xa
    h = L.norm_apply(lp["ln2"], x, cfg)
    return x + L.mlp_apply(lp["mlp"], h, cfg, plain=plain), kv, ckv


def _encdec_run(params, batch, cfg, *, plain=False, prefill=None):
    """Encode, then run the decoder over the whole token sequence.
    ``prefill`` = (kv_dtype, max_len) also builds the caches.  Returns
    (hidden before the final norm, caches or None)."""
    enc = _encode(params, batch["frames"], cfg, plain=plain)
    tokens = batch["tokens"]
    positions = _arange(tokens.shape[1], tokens.device)
    x = L.embed(params["embed"], tokens)
    caches = None
    if prefill is not None:
        caches, self_c, cross_c = _caches(cfg, x, *prefill, enc.shape[1])
    block = remat_wrap(_dec_block, cfg)
    for lp in params["dec_layers"]:
        x, kv, ckv = block(lp, x, enc, cfg, positions, plain=plain)
        if caches is not None:
            caches["self"].append(self_c(*kv))
            caches["cross"].append(cross_c(*ckv))
    return x, caches


def encdec_forward(params: dict, batch: dict, cfg: ArchConfig, *,
                   plain: bool = False):
    """batch ``{"frames": (B, S_enc, D), "tokens": (B, S)}`` -> (hidden
    (B, S, D), aux 0)."""
    x, _ = _encdec_run(params, batch, cfg, plain=plain)
    return L.norm_apply(params["final_norm"], x, cfg), _zero(x)


def encdec_prefill(params: dict, batch: dict, cfg: ArchConfig,
                   kv_dtype=None, max_len=None):
    """Encode and prefill the decoder prompt.  ``max_len`` reserves self
    cache room beyond the prompt.  Returns (last-token logits (B, V),
    caches)."""
    x, caches = _encdec_run(params, batch, cfg, prefill=(kv_dtype, max_len))
    return _last_logits(params, x, cfg), caches


def encdec_decode_step(params: dict, tokens: torch.Tensor, cfg: ArchConfig,
                       cache: dict, pos: int):
    """One decode step: tokens (B, 1) at position ``pos``.  Returns
    (logits (B, V), new caches; the cross caches are carried as they
    are)."""
    x = L.embed(params["embed"], tokens)
    new = []
    for lp, c_self, c_cross in zip(params["dec_layers"], cache["self"],
                                   cache["cross"]):
        h = L.norm_apply(lp["ln1"], x, cfg)
        a, c = L.attention_decode(lp["attn"], h, cfg, c_self, pos)
        new.append(c)
        x = x + a
        h = L.norm_apply(lp["ln_x"], x, cfg)
        xa, _ = L.attention_decode(lp["xattn"], h, cfg, c_cross, pos,
                                   cross=True)
        x = x + xa
        h = L.norm_apply(lp["ln2"], x, cfg)
        x = x + L.mlp_apply(lp["mlp"], h, cfg)
    x = L.norm_apply(params["final_norm"], x, cfg)
    return L.lm_logits(params["embed"], x)[:, 0], {"self": new,
                                                    "cross": cache["cross"]}


def init_encdec_cache(cfg: ArchConfig, batch: int, max_len: int,
                      kv_dtype=None, *, device=DEFAULT_DEVICE) -> dict:
    """Zero caches: per decoder layer one self cache of ``max_len`` (in
    ``kv_dtype``) and one cross cache of ``max_len`` (the JAX package's
    shapes; a prefill replaces the cross caches with the encoder's
    length)."""
    device = resolve_device(device)
    n_dec = _n_enc_dec(cfg)[1]
    return {"self": [L.init_kv_cache(cfg, batch, max_len, kv_dtype,
                                     device=device) for _ in range(n_dec)],
            "cross": [L.init_kv_cache(cfg, batch, max_len, device=device)
                      for _ in range(n_dec)]}


def encdec_cache_axes(cfg: ArchConfig, int8: bool = False) -> dict:
    """The axes of one layer's self and cross caches."""
    return {"self": L.kv_cache_axes(int8), "cross": L.kv_cache_axes(False)}


# ===========================================================================
# VLM (llama-3.2-vision backbone; patch frontend stubbed)
# ===========================================================================


def _vlm_counts(cfg: ArchConfig) -> tuple[int, int, int, int]:
    """(superblocks, self layers per superblock, self layers in all,
    leftover self layers of the tail)."""
    per = cfg.cross_every
    n_super = cfg.n_layers // per
    tail = cfg.n_layers - n_super * per
    return n_super, per - 1, n_super * (per - 1) + tail, tail


def init_vlm(cfg: ArchConfig, generator: torch.Generator, *,
             device=DEFAULT_DEVICE) -> dict:
    device = resolve_device(device)
    d, g = cfg.d_model, generator
    n_super, _, n_self, _ = _vlm_counts(cfg)
    self_layers = [{"ln1": L.init_norm(cfg, d, device=device),
                    "attn": L.init_attention(g, cfg, device=device),
                    "ln2": L.init_norm(cfg, d, device=device),
                    "mlp": L.init_mlp(g, cfg, device=device)}
                   for _ in range(n_self)]
    cross_layers = [{"ln1": L.init_norm(cfg, d, device=device),
                     "xattn": L.init_attention(g, cfg, device=device,
                                               cross=True),
                     "ln2": L.init_norm(cfg, d, device=device),
                     "mlp": L.init_mlp(g, cfg, device=device),
                     "mlp_gate": torch.zeros((), dtype=getattr(torch,
                                                               cfg.dtype),
                                             device=device)}
                    for _ in range(n_super)]
    return {"embed": L.init_embedding(g, cfg, device=device),
            "self_layers": self_layers, "cross_layers": cross_layers,
            "final_norm": L.init_norm(cfg, d, device=device)}


def vlm_axes(cfg: ArchConfig) -> dict:
    """Logical axes, one per-layer dict for each (unstacked) layer list."""
    return {"embed": L.embedding_axes(cfg),
            "self_layers": {"ln1": L.norm_axes(),
                            "attn": L.attention_axes(cfg),
                            "ln2": L.norm_axes(), "mlp": L.mlp_axes(cfg)},
            "cross_layers": {"ln1": L.norm_axes(),
                             "xattn": L.attention_axes(cfg, cross=True),
                             "ln2": L.norm_axes(), "mlp": L.mlp_axes(cfg),
                             "mlp_gate": ()},
            "final_norm": L.norm_axes()}


def _order(cfg: ArchConfig):
    """The layer order: ("self", i) and ("cross", j) index pairs, each
    superblock's self layers before its cross layer, then the tail."""
    n_super, per_self, n_self, _ = _vlm_counts(cfg)
    out = []
    for j in range(n_super):
        out += [("self", j * per_self + i) for i in range(per_self)]
        out.append(("cross", j))
    return out + [("self", i) for i in range(n_super * per_self, n_self)]


def _mlp_gated(lp: dict, x, cfg, plain: bool):
    h = L.norm_apply(lp["ln2"], x, cfg)
    f = L.mlp_apply(lp["mlp"], h, cfg, plain=plain)
    if "mlp_gate" in lp:
        f = torch.tanh(lp["mlp_gate"].to(torch.float32)).to(x.dtype) * f
    return x + f


def _vlm_run(params, batch, cfg, *, plain=False, prefill=None):
    """Every layer over the whole sequence.  ``prefill`` = (kv_dtype,
    max_len) also builds the caches.  Returns (hidden before the final
    norm, caches or None)."""
    tokens, patches = batch["tokens"], batch["patches"]
    positions = _arange(tokens.shape[1], tokens.device)
    x = L.embed(params["embed"], tokens)
    caches = None
    if prefill is not None:
        caches, self_c, cross_c = _caches(cfg, x, *prefill, cfg.n_patches)
    layer = remat_wrap(_vlm_layer, cfg)
    for kind, i in _order(cfg):
        x, kv = layer(kind, params[f"{kind}_layers"][i], x, patches, cfg,
                      positions, plain)
        if caches is not None:
            caches[kind].append((self_c if kind == "self" else cross_c)(*kv))
    return x, caches


def _vlm_layer(kind: str, lp: dict, x, patches, cfg, positions, plain: bool):
    """One self or gated cross layer -> (x, its (k, v))."""
    if kind == "self":
        x, kv = _self_attn(lp, x, cfg, positions, plain)
    else:
        h = L.norm_apply(lp["ln1"], x, cfg)
        a, kv = L.attention_full(lp["xattn"], h, cfg, positions=positions,
                                 causal=False, x_kv=patches, return_kv=True,
                                 plain=plain)
        x = x + a
    return _mlp_gated(lp, x, cfg, plain), kv


def vlm_forward(params: dict, batch: dict, cfg: ArchConfig, *,
                plain: bool = False):
    """batch ``{"tokens": (B, S), "patches": (B, P, D)}`` -> (hidden (B, S,
    D), aux 0)."""
    x, _ = _vlm_run(params, batch, cfg, plain=plain)
    return L.norm_apply(params["final_norm"], x, cfg), _zero(x)


def vlm_prefill(params: dict, batch: dict, cfg: ArchConfig, kv_dtype=None,
                max_len=None):
    """Prefill the prompt beside its patches.  ``max_len`` reserves self
    cache room beyond the prompt.  Returns (last-token logits (B, V),
    caches)."""
    x, caches = _vlm_run(params, batch, cfg, prefill=(kv_dtype, max_len))
    return _last_logits(params, x, cfg), caches


def vlm_decode_step(params: dict, tokens: torch.Tensor, cfg: ArchConfig,
                    cache: dict, pos: int):
    """One decode step: tokens (B, 1) at position ``pos``.  Returns
    (logits (B, V), new caches; the cross caches are carried as they
    are)."""
    x = L.embed(params["embed"], tokens)
    new = list(cache["self"])
    for kind, i in _order(cfg):
        if kind == "self":
            lp = params["self_layers"][i]
            h = L.norm_apply(lp["ln1"], x, cfg)
            a, new[i] = L.attention_decode(lp["attn"], h, cfg, new[i], pos)
        else:
            lp = params["cross_layers"][i]
            h = L.norm_apply(lp["ln1"], x, cfg)
            a, _ = L.attention_decode(lp["xattn"], h, cfg, cache["cross"][i],
                                      pos, cross=True)
        x = _mlp_gated(lp, x + a, cfg, False)
    x = L.norm_apply(params["final_norm"], x, cfg)
    return L.lm_logits(params["embed"], x)[:, 0], {"self": new,
                                                    "cross": cache["cross"]}


def init_vlm_cache(cfg: ArchConfig, batch: int, max_len: int, kv_dtype=None,
                   *, device=DEFAULT_DEVICE) -> dict:
    """Zero caches: one self cache of ``max_len`` (in ``kv_dtype``) per
    self layer, one cross cache of ``n_patches`` per cross layer."""
    device = resolve_device(device)
    n_super, _, n_self, _ = _vlm_counts(cfg)
    return {"self": [L.init_kv_cache(cfg, batch, max_len, kv_dtype,
                                     device=device) for _ in range(n_self)],
            "cross": [L.init_kv_cache(cfg, batch, cfg.n_patches,
                                      device=device)
                      for _ in range(n_super)]}


def vlm_cache_axes(cfg: ArchConfig, int8: bool = False) -> dict:
    """The axes of one layer's self and cross caches."""
    return {"self": L.kv_cache_axes(int8), "cross": L.kv_cache_axes(False)}
