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
:meth:`verify_paged` is the speculative verifier on the same trunk: a
``(B, K+1)`` chunk ``[last_emitted, d_1 .. d_K]`` per decode lane through
``paged_gqa_verify`` (the chunked-prefill kernel), a token selected at
every chunk position on the device, and the longest accepted draft prefix
counted.  Over int8 pools the chunk's own K/V is round-tripped through the
page quantizer for attention, with the fp values as the kernel's diagonal
override, so a verify tick reads what one-token decode would read.

Selection (:func:`sample_tokens`) is the exact argmax at temperature 0;
otherwise a draw that is a pure function of (request seed, emission
index): the JAX package's ``fold_in(PRNGKey(seed), index)`` uniform,
reproduced bit for bit by :func:`uniform` (threefry2x32 on 32-bit words),
then temperature, nucleus filter and inverse CDF.

Masking uses the same where-set convention as the recompute path
(``finfo(float32).min``), so cached logits match it up to matmul
reassociation.

Engine hooks, as in the JAX package: ``faults`` (serve/faults.py) raises
an armed ``dispatch_error`` at the entry of every dispatch, before any
pool buffer is written, and writes NaN into the lanes an armed
``nan_logits`` rule names, in place on the returned logits (in
:meth:`decode_paged_sample` before the draw; in :meth:`verify_paged`
after it, where the JAX package's fused dispatch drew from clean
logits); ``tracer`` records one ``dispatch:*`` span per dispatch.
:meth:`activation_probe` is the quality canaries' dense trunk.

Tensor parallelism (``serve/distributed.py``) overrides five hooks and
nothing else: :meth:`_project` (the collectives around sharded
projections), :meth:`_local_heads` / :meth:`_gather_heads` (attention over
a rank's KV heads), ``_attn_cfg`` (the head counts attention sees) and
the device step each dispatch makes (``_decode_trunk``,
``_prefill_step``, ``_dense_step``, ``_probe_step``: host arrays and the
pool in, device work and results out), which it replays on every rank.
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
    paged_gqa_verify,
)
from repro_torch.launch.quantize import fp_blocks
from repro_torch.models import layers as L
from repro_torch.serve.faults import NO_FAULTS, FaultPlan
from repro_torch.serve.kv_cache import PagedKVPool
from repro_torch.serve.quality import SAT_THRESHOLD
from repro_torch.serve.telemetry import NULL_TRACER, Tracer

__all__ = ["CachedDecoder", "sample_tokens", "uniform"]

_M32 = 0xFFFFFFFF
_THREEFRY_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 (20 rounds) on int64 tensors holding 32-bit words
    (torch has no uint32 arithmetic to rely on, on every device)."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _THREEFRY_ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = (((x1 << r) | (x1 >> (32 - r))) & _M32) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def uniform(seeds: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``jax.random.uniform(fold_in(PRNGKey(seed), index))`` bit for bit
    (threefry2x32, partitionable random bits), elementwise over
    broadcast ``seeds`` and ``index`` -> float32 in [0, 1).

    ``PRNGKey(s)`` is the key (0, s); ``fold_in(key, d)`` is
    ``threefry(key, (0, d))``; a scalar's 32 random bits are ``x0 ^ x1``
    of ``threefry(key, (0, 0))``, and ``u`` is the float with those bits'
    top 23 as mantissa, minus one.
    """
    seeds = seeds.to(torch.int64) & _M32
    index = index.to(torch.int64) & _M32
    zero = torch.zeros_like(seeds + index)
    k0, k1 = _threefry2x32(zero, seeds + zero, zero, index + zero)
    x0, x1 = _threefry2x32(k0, k1, zero, zero)
    bits = ((x0 ^ x1) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0


def nucleus(logits: torch.Tensor, temps: torch.Tensor,
            top_ps: torch.Tensor):
    """The draw's distribution over (B, T, V) logits, per lane's
    temperature and top-p: ``(order, ps)``, the tokens by descending
    probability (ties in index order, as ``jnp.argsort(-p)``) and their
    probabilities with the tail past the nucleus zeroed (the head always
    kept).  Temperature-0 lanes are scaled by 1."""
    t = torch.where(temps > 0, temps, torch.ones_like(temps))
    z = logits.to(torch.float32) / t[:, None, None]
    p = torch.softmax(z, dim=-1)
    ps, order = torch.sort(p, dim=-1, descending=True, stable=True)
    keep = (torch.cumsum(ps, dim=-1) - ps) < top_ps[:, None, None]
    keep[..., 0] = True
    return order, torch.where(keep, ps, torch.zeros_like(ps))


def sample_tokens(logits: torch.Tensor, temps, top_ps, seeds, draws,
                  greedy_only: bool = False) -> torch.Tensor:
    """Token selection over a step's logits (B, T, V) -> (B, T) int32 on
    the logits' device.

    temps/top_ps (B,) float32 tensors on the logits' device; seeds/draws
    (B,) int32 tensors, best on the host: chunk position t of lane b draws
    with the uniform of ``(seeds[b], draws[b] + t)``, so a stream is a
    pure function of (seed, emission index) whatever the batch, the
    schedule, eviction or speculative grouping.  The uniforms depend on
    nothing the device computes, so they are made on the host (one copy
    instead of some 300 tiny integer kernels).  The draw is the inverse
    CDF of the nucleus (:func:`nucleus`): ``searchsorted(cumsum(ps),
    u·Σps, right)``, clipped to V − 1.  ``temps == 0`` lanes take the
    exact argmax (first index on ties); ``greedy_only`` skips the draw
    when every lane is greedy.
    """
    greedy = torch.argmax(logits, dim=-1)
    if greedy_only:
        return greedy.to(torch.int32)
    T, V = logits.shape[1], logits.shape[2]
    order, ps = nucleus(logits, temps, top_ps)
    idx = draws.cpu()[:, None].to(torch.int64) + torch.arange(T)
    u = uniform(seeds.cpu()[:, None], idx).to(logits.device) * ps.sum(
        dim=-1)
    pick = torch.searchsorted(torch.cumsum(ps, dim=-1), u[..., None],
                              right=True).clamp_(0, V - 1)
    sampled = torch.gather(order, -1, pick)[..., 0]
    return torch.where(temps[:, None] > 0, sampled, greedy).to(torch.int32)


def _poison_lanes(logits: torch.Tensor, lanes: list) -> torch.Tensor:
    """Overwrite the given batch lanes of ``logits`` with NaN, in place:
    the nan_logits fault, what a rotted artifact or an unstable kernel
    would hand the sampler.  Fault path only."""
    if lanes:
        logits[torch.as_tensor(lanes, device=logits.device)] = float("nan")
    return logits


def _int8_roundtrip(x: torch.Tensor) -> torch.Tensor:
    """Quantize-dequantize through the int8 page quantizer: the value a
    later read of this token's K/V sees after the pool's scatter."""
    q, s = L.quantize_kv(x)
    return (q.to(torch.float32) * s[..., None]).to(x.dtype)


def _accept(sel: torch.Tensor, drafts: torch.Tensor,
            n_drafts: torch.Tensor) -> torch.Tensor:
    """Longest accepted draft prefix per lane: draft i is accepted while
    every draft before it was and the selection at its predicting position
    drew exactly it."""
    K = drafts.shape[1]
    ok = (drafts == sel[:, :K]) & (
        torch.arange(K, device=sel.device)[None] < n_drafts[:, None])
    return torch.cumprod(ok.to(torch.int32), dim=1).sum(dim=1).to(
        torch.int32)


@dataclasses.dataclass
class CachedDecoder:
    """KV-cached forward shared by the fp and quantized serving paths."""

    cfg: ArchConfig
    embed: dict
    final_norm: dict
    blocks: list
    # span sink for the dispatches; Engine.attach_tracer swaps in its live
    # tracer (the NULL_TRACER default costs one no-op call)
    tracer: Tracer = dataclasses.field(default=NULL_TRACER, repr=False)
    # fault-injection plan; the engine points this at its own plan and
    # keeps its dispatch context (tick, lane_rids)
    faults: FaultPlan = dataclasses.field(default=NO_FAULTS, repr=False)

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

    def trace_tags(self) -> dict:
        """Static tags merged into every span this adapter's tracer
        exports (Engine.attach_tracer reads them once)."""
        return {}

    def _place(self, *arrays):
        return [torch.as_tensor(np.asarray(a), dtype=torch.int32,
                                device=self.device) for a in arrays]

    def _place_sampling(self, sampling):
        """``(temps, top_ps, seeds, draws)`` host arrays as the arguments of
        :func:`sample_tokens` (temps and top-p on the device, seeds and
        draws on the host), and whether every lane is greedy."""
        temps, top_ps, seeds, draws = sampling
        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32),
                                        device=self.device)
        i32 = lambda a: torch.as_tensor(np.asarray(a, np.int32))
        greedy = bool((np.asarray(temps) == 0.0).all())
        return (f32(temps), f32(top_ps), i32(seeds), i32(draws)), greedy

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
        if self.faults.rules:
            self.faults.check_dispatch()
        logits, k_new, v_new = self._dense_step(tokens, positions, ctx_k,
                                                ctx_v, ctx_len)
        if self.faults.rules:
            _poison_lanes(logits, self.faults.nan_lanes())
        return logits, k_new, v_new

    @torch.no_grad()
    def _dense_step(self, tokens, positions, ctx_k, ctx_v, ctx_len):
        tokens, positions, ctx_len = self._place(tokens, positions, ctx_len)
        x = L.embed(self.embed, tokens)
        new_k, new_v = [], []
        for i, blk in enumerate(self.blocks):
            x, k, v = self._block(blk, x, positions, ctx_k[i], ctx_v[i],
                                  ctx_len)
            new_k.append(k)
            new_v.append(v)
        return self._logits(x), torch.stack(new_k), torch.stack(new_v)

    def _logits(self, x):
        """Final norm and LM head; ``None`` where no one reads the logits
        (a tensor-parallel worker rank)."""
        if not self._want_logits:
            return None
        return L.lm_logits(self.embed, L.norm_apply(self.final_norm, x,
                                                    self.cfg))

    def _block(self, blk, x, positions, ck, cv, ctx_len, *,
               kernel_proj: bool = False):
        cfg = self.cfg
        B, T, _ = x.shape
        S = ck.shape[1]
        h = L.norm_apply(blk["ln1"], x, cfg)
        q, k, v = self._local_heads(
            *self._qkv(blk, h, positions, kernel_proj=kernel_proj))
        k_all = torch.cat([ck.to(k.dtype), k], dim=1)
        v_all = torch.cat([cv.to(v.dtype), v], dim=1)
        s = L.gqa_scores(q, k_all, self._attn_cfg)  # (B, KV, G, T, S+T)
        # context keys: valid below each lane's ctx_len; new keys: causal
        # within the chunk (their positions are >= every context position)
        dev = x.device
        mask_ctx = (torch.arange(S, device=dev)[None, None, :]
                    < ctx_len[:, None, None]).expand(B, T, S)
        mask_new = torch.tril(torch.ones(T, T, dtype=torch.bool, device=dev))
        mask = torch.cat([mask_ctx, mask_new.expand(B, T, T)], dim=-1)
        s = torch.where(mask[:, None, None], s, torch.full_like(s, L.NEG))
        o = self._gather_heads(
            L.gqa_out(torch.softmax(s, dim=-1), v_all, self._attn_cfg))
        o = o.to(x.dtype).reshape(B, T, cfg.q_dim)
        x = x + self._project(blk, ("attn.wo",), o, kernel_proj)[0]
        return self._mlp(blk, x, kernel_proj=kernel_proj), k, v

    # ---- quality probe ---------------------------------------------------

    @torch.no_grad()
    def activation_probe(self, tokens):
        """Teacher-forced causal forward over full sequences with
        per-layer activation reductions (the quality canaries' probe).

        tokens (B, S) int.  Returns ``(logits (B, S, V) float32 numpy,
        {"absmax": (L+1,), "sat": (L+1,)})``: entry i is the hidden state
        entering block i, entry L the final pre-norm hidden state; ``sat``
        is the fraction of elements at or beyond
        :data:`repro_torch.serve.quality.SAT_THRESHOLD`.  The sequence is
        padded to the next power of two (causal attention: pad positions
        cannot reach real ones, and are masked out of the reductions).
        Runs the gather-dense trunk with an empty context, its projections
        through the quant_matmul dispatch as the paged paths run them: the
        KV pool is never touched, so an engine's traffic stays
        token-identical.
        """
        tokens = np.asarray(tokens, np.int32)
        if tokens.ndim != 2:
            raise ValueError(f"tokens must be (B, S), got {tokens.shape}")
        B, S = tokens.shape
        Sp = 1
        while Sp < S:
            Sp <<= 1
        padded = np.zeros((B, Sp), np.int32)
        padded[:, :S] = tokens
        positions = np.tile(np.arange(Sp, dtype=np.int32), (B, 1))
        with self.tracer.span("dispatch:activation_probe", lanes=B, tokens=S):
            logits, act = self._probe_step(padded, positions, S)
        return logits, act

    @torch.no_grad()
    def _probe_step(self, padded, positions, S: int):
        B, Sp = padded.shape
        acfg = self._attn_cfg
        toks, positions, ctx_len = self._place(padded, positions,
                                               np.zeros(B, np.int32))
        ctx = torch.zeros((B, 0, acfg.n_kv_heads, acfg.head_dim),
                          dtype=torch.float32, device=self.device)
        valid = (torch.arange(Sp, device=self.device) < S)[None, :, None]
        n_el = max(S * B, 1)
        absmax, sat = [], []

        def reduce(x):
            ax = x.float().abs() * valid
            absmax.append(ax.max())
            sat.append((ax >= SAT_THRESHOLD).sum() / (n_el * x.shape[-1]))

        x = L.embed(self.embed, toks)
        for blk in self.blocks:
            reduce(x)
            x, _, _ = self._block(blk, x, positions, ctx, ctx, ctx_len,
                                  kernel_proj=True)
        reduce(x)
        logits = self._logits(x)
        if logits is None:
            return None, None
        return logits[:, :S].float().cpu().numpy(), {
            "absmax": torch.stack(absmax).double().cpu().numpy(),
            "sat": torch.stack(sat).double().cpu().numpy(),
        }

    # ---- shared block pieces --------------------------------------------

    # head counts attention runs at (a tensor-parallel rank: its own)
    _attn_cfg = property(lambda self: self.cfg)
    # whether the trunks compute logits (a tensor-parallel worker: no)
    _want_logits = True

    @staticmethod
    def _proj(blk, name, h, kernel: bool):
        """Apply one projection; with ``kernel`` a QuantizedLinear goes
        through the quant_matmul kernel dispatch."""
        f = blk[name]
        if kernel and isinstance(f, QuantizedLinear):
            return f(h, use_kernel=True)
        return f(h)

    def _project(self, blk, names, h, kernel: bool) -> list:
        """The projections ``names`` of one input ``h``."""
        return [self._proj(blk, n, h, kernel) for n in names]

    @staticmethod
    def _local_heads(q, k, v):
        """The (q, k, v) heads this process attends (all of them)."""
        return q, k, v

    @staticmethod
    def _gather_heads(o):
        """Attention output (..., heads, hd) of every head from this
        process's share."""
        return o

    def _qkv(self, blk, h, positions, *, kernel_proj: bool = False):
        """(q, k, v) each (B, T, heads, hd), qk-normed + RoPE'd."""
        cfg = self.cfg
        B, T, _ = h.shape
        q, k, v = self._project(blk, ("attn.wq", "attn.wk", "attn.wv"), h,
                                kernel_proj)
        q = q.reshape(B, T, cfg.n_heads, cfg.head_dim)
        k = k.reshape(B, T, cfg.n_kv_heads, cfg.head_dim)
        v = v.reshape(B, T, cfg.n_kv_heads, cfg.head_dim)
        if cfg.qk_norm:
            q = L.rms_norm(q, blk["q_norm"], cfg.norm_eps)
            k = L.rms_norm(k, blk["k_norm"], cfg.norm_eps)
        q = L.rope(q, positions, cfg.rope_theta)
        k = L.rope(k, positions, cfg.rope_theta)
        return q, k, v

    def _mlp(self, blk, x, *, kernel_proj: bool = False):
        cfg = self.cfg
        h = L.norm_apply(blk["ln2"], x, cfg)
        if cfg.mlp == "swiglu":
            gate, wi = self._project(blk, ("mlp.wg", "mlp.wi"), h,
                                     kernel_proj)
        else:
            gate, wi = None, self._project(blk, ("mlp.wi",), h,
                                           kernel_proj)[0]
        up = L.mlp_act(wi, gate, cfg)
        return x + self._project(blk, ("mlp.wo",), up, kernel_proj)[0]

    # ---- paged decode ----------------------------------------------------

    def decode_paged(self, tokens, positions, block_tables, ctx_len, pages,
                     offs, pool):
        """Fused decode step against ``pool`` (PagedKVPool), in place.

        tokens/positions (B, 1); block_tables (B, Pa) bucketed to the
        attended prefix; ctx_len (B,); pages/offs (B,) physical address of
        each lane's new token (scratch for pad lanes).  Writes the new K/V
        into ``pool`` and returns logits (B, 1, V); the caller owns the
        host-side length accounting (``pool.note_written``).
        """
        if self.faults.rules:
            self.faults.check_dispatch()
        with self.tracer.span("dispatch:decode_paged", lanes=len(tokens)):
            logits = self._decode_trunk(tokens, positions, block_tables,
                                        ctx_len, pages, offs, pool)
        if self.faults.rules:
            _poison_lanes(logits, self.faults.nan_lanes())
        return logits

    def decode_paged_sample(self, tokens, positions, block_tables, ctx_len,
                            pages, offs, sampling, pool):
        """:meth:`decode_paged` with :func:`sample_tokens` on the device;
        ``sampling = (temps, top_ps, seeds, draws)`` per lane.  Returns
        ``(sel (B, 1) int32, logits (B, 1, V))``."""
        if self.faults.rules:
            self.faults.check_dispatch()
        with self.tracer.span("dispatch:decode_paged_sample",
                              lanes=len(tokens)):
            logits = self._decode_trunk(tokens, positions, block_tables,
                                        ctx_len, pages, offs, pool)
            if self.faults.rules:
                _poison_lanes(logits, self.faults.nan_lanes())
            args, greedy = self._place_sampling(sampling)
            sel = sample_tokens(logits, *args, greedy_only=greedy)
        return sel, logits

    @torch.no_grad()
    def _decode_trunk(self, tokens, positions, block_tables, ctx_len, pages,
                      offs, pool):
        tokens, positions, bt, ctx_len = self._place(
            tokens, positions, block_tables, ctx_len)
        x = L.embed(self.embed, tokens)  # (B, 1, D)
        new_k, new_v = [], []
        for i, blk in enumerate(self.blocks):
            x, k, v = self._block_paged(blk, x, positions, i, pool, bt,
                                        ctx_len)
            new_k.append(k)
            new_v.append(v)
        logits = self._logits(x)
        pool.scatter(pages, offs, torch.stack(new_k), torch.stack(new_v))
        return logits

    def _block_paged(self, blk, x, positions, layer, pool, bt, ctx_len):
        cfg = self.cfg
        B = x.shape[0]
        h = L.norm_apply(blk["ln1"], x, cfg)
        q, k, v = self._local_heads(
            *self._qkv(blk, h, positions, kernel_proj=True))
        o = paged_gqa_decode(
            q[:, 0], k[:, 0], v[:, 0], pool.k, pool.v, bt, ctx_len,
            layer=layer, k_scale=pool.k_scale, v_scale=pool.v_scale,
        )
        o = self._gather_heads(o).to(x.dtype).reshape(B, 1, cfg.q_dim)
        x = x + self._project(blk, ("attn.wo",), o, True)[0]
        return self._mlp(blk, x, kernel_proj=True), k[:, 0], v[:, 0]

    # ---- paged batched prefill and the speculative verifier -------------

    def _prefill_trunk(self, tokens, positions, bt, ctx_len, pool, *,
                       verify: bool):
        """Embed -> blocks (chunk attention over the pool) -> logits, and
        the chunk's K/V stacked (L, B, C, KV, hd) for the scatter.  With
        ``verify`` attention runs ``paged_gqa_verify``, and over int8 pools
        the chunk's own K/V is round-tripped through the page quantizer
        (what the pool returns for these tokens once scattered) while the
        fp values ride along as the diagonal override (what one-token
        decode folds in for its own position)."""
        cfg = self.cfg
        x = L.embed(self.embed, tokens)  # (B, C, D)
        rt = verify and pool.is_int8
        attend = paged_gqa_verify if verify else paged_gqa_prefill
        new_k, new_v = [], []
        for i, blk in enumerate(self.blocks):
            B, C, _ = x.shape
            h = L.norm_apply(blk["ln1"], x, cfg)
            q, k, v = self._local_heads(
                *self._qkv(blk, h, positions, kernel_proj=True))
            ka, va = (_int8_roundtrip(k), _int8_roundtrip(v)) if rt else (k, v)
            o = attend(
                q, ka, va, pool.k, pool.v, bt, ctx_len, layer=i,
                k_scale=pool.k_scale, v_scale=pool.v_scale,
                k_self=k if rt else None, v_self=v if rt else None,
            )
            o = self._gather_heads(o).to(x.dtype).reshape(B, C, cfg.q_dim)
            x = x + self._project(blk, ("attn.wo",), o, True)[0]
            x = self._mlp(blk, x, kernel_proj=True)
            new_k.append(k)
            new_v.append(v)
        return self._logits(x), torch.stack(new_k), torch.stack(new_v)

    @torch.no_grad()
    def _prefill_step(self, tokens, positions, block_tables, ctx_len, pages,
                      offs, pool, *, verify: bool):
        """Place the host arrays, run :meth:`_prefill_trunk` and scatter
        the chunk's K/V ((L, B, C, KV, hd) against (B, C) addresses)."""
        tokens, positions, bt, ctx_len = self._place(
            tokens, positions, block_tables, ctx_len)
        logits, kn, vn = self._prefill_trunk(tokens, positions, bt, ctx_len,
                                             pool, verify=verify)
        pool.scatter(pages, offs, kn, vn)
        return logits

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
        if self.faults.rules:
            self.faults.check_dispatch()
        with self.tracer.span("dispatch:prefill_paged", lanes=len(tokens),
                              chunk=len(tokens[0])):
            logits = self._prefill_step(tokens, positions, block_tables,
                                        ctx_len, pages, offs, pool,
                                        verify=False)
        if self.faults.rules:
            _poison_lanes(logits, self.faults.nan_lanes())
        return logits

    @torch.no_grad()
    def verify_paged(self, tokens, positions, block_tables, ctx_len, pages,
                     offs, drafts, n_drafts, sampling, pool):
        """One speculative verify tick against ``pool``, in place.

        tokens (B, K+1) — lane b carries ``[last_emitted, d_1 .. d_K]``
        (zero-padded past its draft count) at positions ``ctx_len[b] ..
        ctx_len[b] + K``; drafts (B, K) the proposed tokens; n_drafts (B,)
        valid drafts per lane; pages/offs (B, K+1) the address of every fed
        token's K/V (scratch for padding); ``sampling = (temps, top_ps,
        seeds, draws)`` per :func:`sample_tokens`.  Runs the prefill trunk
        through ``paged_gqa_verify``, selects a token at every chunk
        position, counts each lane's accepted draft prefix and scatters
        ALL fed tokens' K/V (the engine truncates the rejected tail).
        Returns ``(sel (B, K+1) int32, n_acc (B,) int32, logits (B, K+1,
        V))``: lane b emits ``sel[b, :n_acc[b] + 1]``.
        """
        if self.faults.rules:
            self.faults.check_dispatch()
        with self.tracer.span("dispatch:verify_paged", lanes=len(tokens),
                              width=len(tokens[0])):
            logits = self._prefill_step(tokens, positions, block_tables,
                                        ctx_len, pages, offs, pool,
                                        verify=True)
            drafts, n_drafts = self._place(drafts, n_drafts)
            args, greedy = self._place_sampling(sampling)
            sel = sample_tokens(logits, *args, greedy_only=greedy)
            n_acc = _accept(sel, drafts, n_drafts)
        if self.faults.rules:
            _poison_lanes(logits, self.faults.nan_lanes())
        return sel, n_acc, logits
