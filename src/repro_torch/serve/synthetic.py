"""A seeded synthetic QuIP artifact at any size, built on the device.

Where the JAX quantizer cannot run (no JAX on the GPU machine), serving is
exercised on a :class:`QuantizedModel` with the real structure and random
content, all drawn from one ``torch.Generator``:

  * uniform random b-bit codes, packed by :func:`repro_torch.core.packing.pack`;
  * Kronecker transforms with permutations on both sides — the JAX
    quantizer's default ``QuipConfig(transform="kronecker")`` structure;
  * a diagonal rescale ``D`` near 1;
  * ``s`` such that a unit-RMS input gives a unit-RMS output (about
    ``1.34 / sqrt(n)`` at 2 bits), so 40 residual layers stay finite in
    bf16;
  * fp embedding, LM head and norms in ``cfg.dtype``.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import incoherence as inc
from repro_torch.core import packing
from repro_torch.core.quantizer import QuantizedLinear
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.launch.quantize import QuantizedModel

__all__ = ["synthetic_quantized_model", "QUIP_CONFIG"]

QUIP_CONFIG = {"bits": 2, "method": "synthetic", "transform": "kronecker"}


def _transform(n: int, g: torch.Generator, device) -> inc.OrthogonalTransform:
    p, q = inc.kron_factors(n)
    A = inc.random_orthogonal(p, g, device=device) if p > 1 else None
    B = inc.random_orthogonal(q, g, device=device)
    perm = torch.randperm(n, generator=g, device=device)
    return inc.OrthogonalTransform("kronecker", n, A, B, None, perm)


def _linear(m: int, n: int, bits: int, g: torch.Generator,
            device) -> QuantizedLinear:
    maxq = 2**bits - 1
    codes = torch.randint(0, maxq + 1, (m, n), generator=g, device=device,
                          dtype=torch.int32)
    D = torch.exp(0.05 * torch.randn(n, generator=g, device=device))
    state = inc.PreprocessState(
        U=_transform(m, g, device), V=_transform(n, g, device), D=D,
        # E[(2q/maxq - 1)^2] over uniform codes is (maxq + 2) / (3 maxq)
        s=torch.tensor(math.sqrt(3.0 * maxq / ((maxq + 2) * n)),
                       device=device),
        maxq=maxq,
    )
    return QuantizedLinear(packing.pack(codes, bits), bits, m, n, state,
                           use_kernel=False)


def synthetic_quantized_model(cfg: ArchConfig, *, seed: int, bits: int = 2,
                              device=DEFAULT_DEVICE) -> QuantizedModel:
    device = resolve_device(device)
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    dt = getattr(torch, cfg.dtype)
    d, f = cfg.d_model, cfg.d_ff

    def randn(shape, std):
        return (torch.randn(shape, generator=g, device=device) * std).to(dt)

    def ones(n):
        return torch.ones(n, dtype=dt, device=device)

    shapes = {  # name -> (out m, in n)
        "attn.wq": (cfg.q_dim, d), "attn.wk": (cfg.kv_dim, d),
        "attn.wv": (cfg.kv_dim, d), "attn.wo": (d, cfg.q_dim),
        "mlp.wi": (f, d), "mlp.wg": (f, d), "mlp.wo": (d, f),
    }
    if cfg.mlp != "swiglu":  # GeLU: no gate
        del shapes["mlp.wg"]
    embed = {"tok": randn((cfg.vocab, d), 0.02)}
    if not cfg.tie_embeddings:
        embed["head"] = randn((d, cfg.vocab), d**-0.5)
    blocks = []
    for _ in range(cfg.n_layers):
        blk = {"ln1": {"scale": ones(d)}, "ln2": {"scale": ones(d)}}
        if cfg.qk_norm:
            blk["q_norm"] = ones(cfg.head_dim)
            blk["k_norm"] = ones(cfg.head_dim)
        for name, (m, n) in shapes.items():
            blk[name] = _linear(m, n, bits, g, device)
        blocks.append(blk)
    return QuantizedModel(cfg=cfg, embed=embed,
                          final_norm={"scale": ones(d)}, blocks=blocks)
