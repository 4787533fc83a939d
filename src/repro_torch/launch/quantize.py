"""QuIP post-training quantization driver (paper Sec. 6 "Setup").

Quantization proceeds one transformer block at a time, as the paper does:
(1) run calibration activations through the network quantized SO FAR to
the current block, (2) accumulate per-layer proxy Hessians H = E[x x^T] at
each linear's true input, (3) QuIP-quantize every linear in the block,
(4) the quantized block produces the inputs for the next.

Hessian accumulation streams: calibration segments pass through each block
``--calib-chunk`` segments at a time and feed ``HessianAccumulator.update``
per segment, so per-block activation memory is O(chunk · seg_len · d_ff).

:class:`QuantizedModel` is also the serving adapter's input and the
``--check`` oracle: ``logits(tokens)`` recomputes the whole prefix through
every block, with each linear a callable — a :class:`QuantizedLinear` for
an artifact, a dense weight for fp params (:func:`fp_model`).  With
``plain=True`` every linear runs as plain PyTorch (no CUDA kernel), so the
oracle checks the engine's kernels instead of sharing them.

    PYTHONPATH=src python -m repro_torch.launch.quantize --arch qwen3-14b \\
        --smoke --device cpu --bits 2 --method ldlq --out-dir /tmp/port_q

Runs on the GPU (``--device cuda``, the default) through the hand-written
LDLQ, Kronecker and Hadamard kernels, or on the CPU through their plain
versions.  Every fp32 product on the card runs in full fp32: the entry
point turns TF32 off (``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32``), since TF32 would move codes.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core.hessian import HessianAccumulator
from repro_torch.core.quantizer import QuipConfig, quantize_layer
from repro_torch.models import layers as L

__all__ = [
    "QuantizedModel",
    "DENSE_LINEARS",
    "PhaseClock",
    "block_hessians",
    "quantize_dense_model",
    "perplexity",
    "fp_model",
    "fp_blocks",
    "main",
]

# the per-block linears of the dense family, in the JAX package's order
# (the index is part of every linear's seed)
DENSE_LINEARS = ("attn.wq", "attn.wk", "attn.wv", "attn.wo", "mlp.wi",
                 "mlp.wg", "mlp.wo")


@dataclasses.dataclass
class QuantizedModel:
    """Dense decoder whose block linears are callables (QuantizedLinear).

    ``stats``: per block, the quality report of each quantized linear;
    ``profile``: per block, phase seconds and kernel launches (filled by
    ``quantize_dense_model(profile=True)``)."""

    cfg: object
    embed: dict
    final_norm: dict
    blocks: list  # per layer: dict name -> linear callable, plus norms
    stats: list = dataclasses.field(default_factory=list)
    profile: list = dataclasses.field(default_factory=list)

    def forward_hidden(self, tokens: torch.Tensor, *,
                       plain: bool = False) -> torch.Tensor:
        cfg = self.cfg
        x = L.embed(self.embed, tokens)
        positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                                 device=tokens.device)
        for blk in self.blocks:
            x = _quantized_block_forward(blk, x, cfg, positions, plain=plain)
        return L.norm_apply(self.final_norm, x, cfg)

    def logits(self, tokens: torch.Tensor, *,
               plain: bool = False) -> torch.Tensor:
        return L.lm_logits(self.embed,
                           self.forward_hidden(tokens, plain=plain))


def _linears(blk, plain: bool) -> Callable:
    """name, x -> the block's linear ``name`` applied to x."""
    if plain:
        return lambda name, x: blk[name](x, plain=True)
    return lambda name, x: blk[name](x)


def _attn_forward_with_linears(blk, h, cfg, positions, plain=False):
    """Causal full-sequence attention routed through the block's linears."""
    lin = _linears(blk, plain)
    B, S, _ = h.shape
    q = lin("attn.wq", h).reshape(B, S, cfg.n_heads, cfg.head_dim)
    k = lin("attn.wk", h).reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    v = lin("attn.wv", h).reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = L.rms_norm(q, blk["q_norm"], cfg.norm_eps)
        k = L.rms_norm(k, blk["k_norm"], cfg.norm_eps)
    q = L.rope(q, positions, cfg.rope_theta)
    k = L.rope(k, positions, cfg.rope_theta)
    o = L.attend(q, k, v, positions, cfg)
    o = o.to(h.dtype).reshape(B, S, cfg.q_dim)
    return lin("attn.wo", o)


def _quantized_block_forward(blk, x, cfg, positions, plain=False):
    lin = _linears(blk, plain)
    h = L.norm_apply(blk["ln1"], x, cfg)
    x = x + _attn_forward_with_linears(blk, h, cfg, positions, plain)
    h = L.norm_apply(blk["ln2"], x, cfg)
    gate = lin("mlp.wg", h) if cfg.mlp == "swiglu" else None
    return x + lin("mlp.wo", L.mlp_act(lin("mlp.wi", h), gate, cfg))


def _dense(w: torch.Tensor, b: Optional[torch.Tensor] = None) -> Callable:
    if b is None:
        return lambda x, plain=False: L.apply_w(w, x)  # plain PyTorch always
    return lambda x, plain=False: L.apply_w(w, x) + b


def fp_blocks(params: dict, cfg) -> list[dict]:
    """Per-layer blocks of dense-weight callables from an fp param tree
    (``{"embed", "layers": [per-layer dict], "final_norm"}``, the JAX
    package's ``unstack_layers`` layout).  Linear ``w<x>`` adds the bias
    ``b<x>`` where the tree has one — ``bq bk bv`` and ``bi bo``, as the JAX
    serving adapter adds them (``attn.wo`` and ``mlp.wg`` have none)."""
    blocks = []
    for lp in params["layers"]:
        blk = {"ln1": lp["ln1"], "ln2": lp["ln2"]}
        for name in _block_linears(cfg):
            grp, w = name.split(".")
            blk[name] = _dense(lp[grp][w], lp[grp].get("b" + w[1:]))
        if cfg.qk_norm:
            blk["q_norm"] = lp["attn"]["q_norm"]
            blk["k_norm"] = lp["attn"]["k_norm"]
        blocks.append(blk)
    return blocks


def fp_model(params: dict, cfg) -> QuantizedModel:
    """The recompute oracle over fp params (dense linears)."""
    return QuantizedModel(cfg=cfg, embed=params["embed"],
                          final_norm=params["final_norm"],
                          blocks=fp_blocks(params, cfg))


# ---------------------------------------------------------------------------
# Block-by-block quantization
# ---------------------------------------------------------------------------


def _block_taps(lp, x, cfg, positions):
    """Run one fp block, returning the activation at each linear's input.

    The biases are handled as the JAX package's ``_block_taps`` handles
    them: the attention output and the residual include ``bq bk bv``
    (through ``attention_full``), but the ``attn.wo`` tap recomputes q
    without ``bq`` (its keys and values keep theirs), and the MLP's taps and
    residual use neither ``bi`` nor ``bo``."""
    taps = {}
    h = L.norm_apply(lp["ln1"], x, cfg)
    taps["attn.wq"] = taps["attn.wk"] = taps["attn.wv"] = h
    a, (k, v) = L.attention_full(lp["attn"], h, cfg, positions=positions,
                                 causal=True, return_kv=True)
    # the wo input (pre-projection attention output), recomputed from q
    B, S, _ = h.shape
    q = L.apply_w(lp["attn"]["wq"], h).reshape(B, S, cfg.n_heads,
                                               cfg.head_dim)
    if cfg.qk_norm:
        q = L.rms_norm(q, lp["attn"]["q_norm"], cfg.norm_eps)
    q = L.rope(q, positions, cfg.rope_theta)
    o = L.attend(q, k, v, positions, cfg).to(h.dtype)
    taps["attn.wo"] = o.reshape(B, S, cfg.q_dim)
    x = x + a
    h2 = L.norm_apply(lp["ln2"], x, cfg)
    taps["mlp.wi"] = taps["mlp.wg"] = h2
    gate = (L.apply_w(lp["mlp"]["wg"], h2) if cfg.mlp == "swiglu"
            else None)
    up = L.mlp_act(L.apply_w(lp["mlp"]["wi"], h2), gate, cfg)
    taps["mlp.wo"] = up
    x = x + L.apply_w(lp["mlp"]["wo"], up)
    return x, taps


def _get_path(tree, path):
    for p in path.split("."):
        tree = tree[p]
    return tree


def _block_linears(cfg) -> tuple[str, ...]:
    return tuple(
        n for n in DENSE_LINEARS if n != "mlp.wg" or cfg.mlp == "swiglu"
    )


def block_hessians(lp, x: torch.Tensor, cfg, positions: torch.Tensor, *,
                   chunk: int = 0) -> dict[str, torch.Tensor]:
    """Per-linear proxy Hessians for one block, streaming over segments.

    ``x`` (B, S, d) is the calibration activation entering the block;
    activations at each linear's input are materialized only ``chunk``
    segments at a time (``chunk <= 0``: the whole batch at once).  Each
    segment is folded through ``HessianAccumulator.update`` individually.
    """
    B = x.shape[0]
    chunk = B if chunk <= 0 else min(chunk, B)
    accs: dict[str, HessianAccumulator] = {}
    for i0 in range(0, B, chunk):
        _, taps = _block_taps(lp, x[i0:i0 + chunk], cfg, positions)
        for name in _block_linears(cfg):
            X = taps[name].to(torch.float32)
            acc = accs.get(name) or HessianAccumulator.create(
                X.shape[-1], device=X.device)
            accs[name] = acc.update_segments(X)
    return {name: acc.finalize() for name, acc in accs.items()}


class PhaseClock:
    """Seconds per named phase.  On the card it synchronizes the device at
    every phase boundary, so a phase is charged its own device work (and
    the run is slower by that much: use it for profiling only)."""

    def __init__(self, device):
        self.sync = torch.device(device).type == "cuda"
        self.seconds: dict[str, float] = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        if self.sync:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.sync:
                torch.cuda.synchronize()
            self.seconds[name] = (self.seconds.get(name, 0.0)
                                  + time.perf_counter() - t0)


@torch.no_grad()
def quantize_dense_model(
    params: dict,
    cfg,
    qcfg: QuipConfig,
    calib_tokens,
    *,
    seed: int = 0,
    verbose: bool = True,
    calib_chunk: int = 8,
    transforms: Optional[Callable] = None,
    profile: bool = False,
) -> QuantizedModel:
    """Block-by-block QuIP over a dense decoder (params from
    ``models.transformer.init_decoder``, on the device to quantize on).

    ``calib_tokens`` (B, S) int; ``calib_chunk``: calibration segments
    materialized at once per block (<= 0 keeps the whole batch resident).
    Linear ``j`` of block ``i`` is quantized with seed
    ``seed·1000 + i·10 + j``.  ``transforms`` overrides the seeded
    incoherence transforms (see ``incoherence_preprocess``).  With
    ``profile`` each block's phase seconds and kernel launches go to
    ``QuantizedModel.profile``.
    """
    from repro_torch.kernels import launch_counts

    dev = params["embed"]["tok"].device
    tokens = (calib_tokens if isinstance(calib_tokens, torch.Tensor)
              else torch.from_numpy(np.array(calib_tokens)))
    tokens = tokens.to(device=dev, dtype=torch.int64)
    B, S = tokens.shape
    chunk = B if calib_chunk <= 0 else min(calib_chunk, B)
    positions = torch.arange(S, dtype=torch.int32, device=dev)
    x = L.embed(params["embed"], tokens)

    blocks, all_stats, prof = [], [], []
    n_layers = len(params["layers"])
    for i, lp in enumerate(params["layers"]):
        t0 = time.perf_counter()
        clock = PhaseClock(dev) if profile else None
        phase = clock or (lambda name: contextlib.nullcontext())
        before = launch_counts()
        # Hessians from the quantized-prefix activations, chunk by chunk
        with phase("hessians"):
            hessians = block_hessians(lp, x, cfg, positions, chunk=chunk)
        blk = {"ln1": lp["ln1"], "ln2": lp["ln2"]}
        if cfg.qk_norm:
            blk["q_norm"] = lp["attn"]["q_norm"]
            blk["k_norm"] = lp["attn"]["k_norm"]
        stats_blk = {}
        for name in _block_linears(cfg):
            W = _get_path(lp, name).T  # stored (in, out) -> (out, in)
            layer, st = quantize_layer(
                W, hessians.pop(name), qcfg,
                seed=seed * 1000 + i * 10 + DENSE_LINEARS.index(name),
                transforms=transforms, phases=clock,
            )
            blk[name] = layer
            stats_blk[name] = st
        # advance the calibration activations through the QUANTIZED block,
        # in the same segment chunks
        with phase("forward"):
            x = torch.cat([
                _quantized_block_forward(blk, x[i0:i0 + chunk], cfg,
                                         positions)
                for i0 in range(0, B, chunk)
            ])
        blocks.append(blk)
        all_stats.append(stats_blk)
        after = launch_counts()
        launches = {k: after[k] - before[k] for k in after}
        secs = time.perf_counter() - t0
        if profile:
            prof.append({"block": i, "seconds": secs,
                         "phases": dict(clock.seconds),
                         "launches": launches})
        if verbose:
            mean_proxy = float(np.mean(
                [s["proxy_loss"] for s in stats_blk.values()]))
            used = {k: v for k, v in launches.items() if v}
            print(f"[quantize] block {i}/{n_layers} proxy={mean_proxy:.4g} "
                  f"({secs:.1f}s) kernel launches {used}", flush=True)
    return QuantizedModel(cfg=cfg, embed=params["embed"],
                          final_norm=params["final_norm"], blocks=blocks,
                          stats=all_stats, profile=prof)


@torch.no_grad()
def perplexity(logits_fn, tokens, batch: int = 8) -> float:
    """Next-token perplexity of a logits(tokens) function."""
    tot, cnt = 0.0, 0
    for i in range(0, tokens.shape[0], batch):
        tb = tokens[i:i + batch]
        logits = logits_fn(tb[:, :-1]).to(torch.float32)
        logp = torch.log_softmax(logits, dim=-1)
        nll = -torch.gather(logp, -1, tb[:, 1:, None].to(torch.int64))[..., 0]
        tot += float(torch.sum(nll))
        cnt += nll.numel()
    return float(np.exp(tot / cnt))


def main(argv=None):
    from repro_torch.configs import ARCHS, get_config, get_smoke_config
    from repro_torch.data.synthetic import make_calibration
    from repro_torch.device import resolve_device
    from repro_torch.models.transformer import init_decoder

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-14b", choices=ARCHS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--bits", type=int, default=2)
    ap.add_argument("--method", default="ldlq")
    ap.add_argument("--no-incoherence", action="store_true")
    ap.add_argument("--transform", default="kronecker",
                    choices=["kronecker", "hadamard", "none"])
    ap.add_argument("--calib-segments", type=int, default=16)
    ap.add_argument("--calib-len", type=int, default=128)
    ap.add_argument("--calib-chunk", type=int, default=8,
                    help="calibration segments materialized at once per "
                         "block (streaming Hessians; 0 = whole batch)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--out-dir", default=None,
                    help="persist the quantized model as a serving artifact "
                         "(packed ints + scales + transform factors); serve "
                         "with repro_torch.launch.serve --load-quantized")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    # full fp32 products: TF32 would move the codes
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[quantize] device {device.type}; fp32 matmuls in full fp32 "
          f"(torch.backends.cuda.matmul.allow_tf32 = False, "
          f"torch.backends.cudnn.allow_tf32 = False)")
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(
        args.arch)
    if cfg.family != "dense":
        raise SystemExit("the quantize driver drives the dense family")
    g = torch.Generator(device=device)
    g.manual_seed(args.seed)
    params = init_decoder(cfg, g, device=device)
    calib = make_calibration(cfg.vocab, n_segments=args.calib_segments,
                             seg_len=args.calib_len, seed=args.seed + 7)
    qcfg = QuipConfig(
        bits=args.bits,
        method=args.method,
        incoherence=not args.no_incoherence,
        transform=args.transform,
        use_kernel=False,
    )
    qm = quantize_dense_model(params, cfg, qcfg, calib, seed=args.seed,
                              calib_chunk=args.calib_chunk)

    if args.out_dir:
        from repro_torch.serve.artifacts import save_quantized
        from repro_torch.serve.quality import build_quality_section

        # the quality section ships inside the manifest, next to the shard
        # digests: the audit describes exactly the weights it travels with
        quality = build_quality_section(qm.stats)
        path = save_quantized(
            args.out_dir, qm, qcfg,
            extra_meta={"stats": qm.stats, "smoke": args.smoke,
                        "seed": args.seed, "quality": quality},
        )
        agg = quality["aggregate"]
        print(f"[quantize] artifact saved to {path}")
        if agg:
            print(
                f"[quantize] quality: layers={agg['n_layers']} "
                f"total_proxy={agg['total_proxy_loss']:.4g} "
                f"max_proxy_rel={agg['max_proxy_rel']:.4g} "
                f"max_mu_w_post={agg['max_mu_w_post']:.3g} "
                f"max_h_cond={agg['max_h_cond']:.3g}"
            )

    eval_tokens = torch.as_tensor(make_calibration(
        cfg.vocab, n_segments=8, seg_len=args.calib_len, seed=args.seed + 99
    ), dtype=torch.int64, device=device)
    ppl_fp = perplexity(fp_model(params, cfg).logits, eval_tokens)
    ppl_q = perplexity(qm.logits, eval_tokens)
    rec = {
        "arch": cfg.name, "bits": args.bits, "method": qcfg.label(),
        "ppl_fp16": ppl_fp, "ppl_quant": ppl_q,
        "mean_proxy": float(np.mean([
            s["proxy_loss"] for blk in qm.stats for s in blk.values()
        ])),
    }
    print(json.dumps(rec, indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rec, f)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
