"""Unified Model facade: one API over the port's model families.

    model = build_model(cfg)
    params = model.init(generator, device="cuda")   # seeded, on the card
    aparams = model.abstract_params()               # meta tensors (shapes)
    acache = model.abstract_cache(B, S)              # meta tensors (shapes)
    hidden, aux = model.forward(params, batch)
    logits, cache = model.prefill(params, batch, max_len=S + gen)
    logits, cache = model.decode_step(params, tokens, cache, pos)

``batch`` is a dict: ``{"tokens"}`` (and optional ``"targets"`` for
``loss``), plus the stub embeddings ``"frames"`` (encdec: whisper-small)
or ``"patches"`` (vlm: llama-3.2-vision-90b).  The token-only families
(dense, moe, rwkv, hybrid) take ``batch["tokens"]`` through the
``_tok_fwd`` / ``_tok_prefill`` adapters, as in the JAX package; encdec
and vlm take the whole dict.  ``forward(plain=True)`` runs packed ``weight_bits``
projections through quant_matmul's plain version instead of its CUDA
kernel (the oracle's path).  Training (``launch/steps.py``) calls
``loss`` under autograd on per-layer views of a layer-stacked train state
(``convert.layer_views``), with each block under ``cfg.remat``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DEFAULT_DEVICE
from repro_torch.models import layers as L
from repro_torch.models import multimodal as MM
from repro_torch.models import recurrent as R
from repro_torch.models import transformer as T
from repro_torch.runtime.collectives import max_over
from repro_torch.runtime.sharding import constrain, current_mesh_context

__all__ = ["Model", "build_model"]


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    _init: Callable
    _axes: Callable
    _forward: Callable
    _prefill: Callable
    _decode: Callable
    _init_cache: Callable
    _cache_axes: Callable

    # ---- params ----
    def init(self, generator: torch.Generator, *, device=DEFAULT_DEVICE):
        return self._init(self.cfg, generator, device=device)

    def abstract_params(self, generator: Optional[torch.Generator] = None):
        """The param tree on the ``meta`` device: shapes and dtypes, no
        data (PyTorch's counterpart of ``jax.eval_shape``)."""
        return self._init(self.cfg, generator or torch.Generator(),
                          device="meta")

    def param_axes(self):
        return self._axes(self.cfg)

    # ---- compute ----
    def forward(self, params, batch: dict, *, plain: bool = False):
        """-> (hidden (B, S, D), aux_loss)."""
        return self._forward(params, batch, self.cfg, plain=plain)

    def logits(self, params, hidden):
        return L.lm_logits(params["embed"], hidden)

    def loss(self, params, batch: dict, aux_coef: float = 0.01):
        """Mean next-token cross entropy (+ MoE aux), as the JAX package
        computes it (the last position has no target).  Under a mesh that
        splits the vocab the logits are this rank's columns, and the max,
        the sum of exponentials and the target's logit are taken over
        ``model``."""
        hidden, aux = self.forward(params, batch)
        targets = batch.get("targets")
        if targets is None:
            targets = torch.roll(batch["tokens"], -1, dims=-1)
        logits = self.logits(params, hidden).to(torch.float32)
        ctx = current_mesh_context()
        if ctx is not None and ctx.parallel("vocab"):
            nll = _vocab_parallel_nll(logits, targets, ctx)
        else:
            logp = F.log_softmax(logits, dim=-1)
            nll = -torch.gather(logp, -1, targets[..., None].long())[..., 0]
        # the last position has no target; the mask comes from an arange,
        # not an indexed store of a Python scalar, which dispatches other
        # ops on the CPU than on the card or ``meta`` (the op analysis
        # counts the same ops on each)
        S = nll.shape[-1]
        mask = (torch.arange(S, device=nll.device) < S - 1).to(
            nll.dtype).expand_as(nll)
        ce = torch.sum(nll * mask) / torch.sum(mask)
        return ce + aux_coef * aux, {"ce": ce, "aux": aux}

    def prefill(self, params, batch: dict, kv_dtype=None, max_len=None):
        return self._prefill(params, batch, self.cfg, kv_dtype, max_len)

    def decode_step(self, params, tokens, cache, pos: int):
        return self._decode(params, tokens, self.cfg, cache, pos)

    def init_cache(self, batch: int, max_len: int, kv_dtype=None, *,
                   device=DEFAULT_DEVICE):
        return self._init_cache(self.cfg, batch, max_len, kv_dtype,
                                device=device)

    def cache_axes(self, int8: bool = False):
        return self._cache_axes(self.cfg, int8)

    def abstract_cache(self, batch: int, max_len: int, kv_dtype=None):
        """The cache on the ``meta`` device: shapes and dtypes, no data
        (the counterpart of ``jax.eval_shape(init_cache)``), in the port's
        per-layer layout; ``convert.stack_cache`` gives the JAX one."""
        return self._init_cache(self.cfg, batch, max_len, kv_dtype,
                                device="meta")


def _vocab_parallel_nll(logits, targets, ctx):
    """-log softmax(logits)[target] from this rank's vocab columns:
    ``log Σ exp(x − m) − (x_t − m)`` with the max ``m``, the sum and the
    target's logit taken over ``model`` (the target lies in one rank's
    columns; the others add zero)."""
    rows = logits.shape[-1]
    z = logits - max_over(logits.amax(dim=-1), ctx.comm)[..., None]
    se = constrain(torch.exp(z).sum(dim=-1), ("batch", "seq"),
                   summed="vocab")
    local = targets.long() - ctx.model_rank * rows
    mine = (local >= 0) & (local < rows)
    zt = torch.gather(z, -1, torch.where(mine, local, 0)[..., None])[..., 0]
    zt = constrain(zt * mine.to(z.dtype), ("batch", "seq"), summed="vocab")
    return torch.log(se) - zt


# --- family adapters (batch dict vs tokens-only signatures) ---------------


def _tok_fwd(fn):
    def wrapped(params, batch, cfg, *, plain=False):
        return fn(params, batch["tokens"], cfg, plain=plain)

    return wrapped


def _tok_prefill(fn):
    def wrapped(params, batch, cfg, kv_dtype=None, max_len=None):
        return fn(params, batch["tokens"], cfg, kv_dtype, max_len)

    return wrapped


_DECODER = dict(
    init=T.init_decoder, axes=T.decoder_axes,
    forward=_tok_fwd(T.decoder_forward),
    prefill=_tok_prefill(T.decoder_prefill), decode=T.decoder_decode_step,
    init_cache=T.init_decoder_cache, cache_axes=T.decoder_cache_axes,
)

_FAMILIES: dict[str, dict[str, Any]] = {
    "dense": _DECODER,
    "moe": _DECODER,
    "rwkv": dict(
        init=R.init_rwkv_lm, axes=R.rwkv_lm_axes,
        forward=_tok_fwd(R.rwkv_forward),
        prefill=_tok_prefill(R.rwkv_prefill), decode=R.rwkv_decode_step,
        init_cache=R.init_rwkv_cache, cache_axes=R.rwkv_cache_axes,
    ),
    "hybrid": dict(
        init=R.init_hybrid, axes=R.hybrid_axes,
        forward=_tok_fwd(R.hybrid_forward),
        prefill=_tok_prefill(R.hybrid_prefill), decode=R.hybrid_decode_step,
        init_cache=R.init_hybrid_cache, cache_axes=R.hybrid_cache_axes,
    ),
    "encdec": dict(
        init=MM.init_encdec, axes=MM.encdec_axes, forward=MM.encdec_forward,
        prefill=MM.encdec_prefill, decode=MM.encdec_decode_step,
        init_cache=MM.init_encdec_cache, cache_axes=MM.encdec_cache_axes,
    ),
    "vlm": dict(
        init=MM.init_vlm, axes=MM.vlm_axes, forward=MM.vlm_forward,
        prefill=MM.vlm_prefill, decode=MM.vlm_decode_step,
        init_cache=MM.init_vlm_cache, cache_axes=MM.vlm_cache_axes,
    ),
}


def build_model(cfg: ArchConfig) -> Model:
    fam = _FAMILIES[cfg.family]
    return Model(cfg=cfg, _init=fam["init"], _axes=fam["axes"],
                 _forward=fam["forward"], _prefill=fam["prefill"],
                 _decode=fam["decode"], _init_cache=fam["init_cache"],
                 _cache_axes=fam["cache_axes"])
