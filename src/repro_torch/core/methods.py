"""Rounding-method registry: the paper's Table-2 grid of quantizers.

Every method maps ``(W_grid, H, maxq, generator) -> What_grid`` on the
integer grid domain ``[0, maxq]``; incoherence processing composes
orthogonally (it happens before/after, in :mod:`repro_torch.core.quantizer`).

  near        nearest rounding, no feedback
  stoch       unbiased stochastic rounding, no feedback
  ldlq        LDLQ == OPTQ (Theorem 6); blocked schedule, whose in-block
              recurrence is the CUDA kernel for a CUDA tensor
  ldlq_stoch  LDLQ with stochastic rounding (same kernel, drawn uniforms)
  ldlq_rg     LDLQ with diag(H)-descending column reorder + greedy passes
  greedy      stand-alone greedy coordinate descent (Alg. 4)

The stochastic methods draw from a ``torch.Generator``: their bits cannot
match ``jax.random``'s, only their distribution can.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.core.greedy import greedy as _greedy_fn
from repro_torch.core.ldlq import (
    ldl_decomposition,
    ldlq as _ldlq_seq,
    quantize_nearest,
    quantize_stoch,
    uniform_noise,
)
from repro_torch.kernels.ldlq import ops as ldlq_ops

__all__ = ["round_weights", "METHODS", "pick_block"]


def pick_block(n: int, target: int = 128) -> int:
    """Largest divisor of n that is <= target (LDLQ panel width)."""
    for b in range(min(target, n), 0, -1):
        if n % b == 0:
            return b
    return 1


def _ldlq(W, H, maxq, generator, *, stochastic=False, block=128):
    Udot, _ = ldl_decomposition(H)
    b = pick_block(W.shape[1], block)
    noise = uniform_noise(W, generator) if stochastic else None
    if b < 8 and not W.is_cuda:
        # no divisor of n in [8, block]: the JAX package's sequential LDLQ
        # (the same function); on the card the kernel takes any block
        return _ldlq_seq(W, Udot, maxq, noise=noise)
    return ldlq_ops.ldlq(W, Udot, maxq, block=b, noise=noise)


def _ldlq_rg(W, H, maxq, generator, *, greedy_passes=10, block=128):
    d = torch.diagonal(H)
    perm = torch.argsort(-d, stable=True)
    inv = torch.argsort(perm, stable=True)
    Wp = W[:, perm]
    Hp = H[perm][:, perm]
    What = _ldlq(Wp, Hp, maxq, generator, block=block)
    if greedy_passes:
        What = _greedy_fn(Wp, Hp, maxq, passes=greedy_passes, init=What)
    return What[:, inv]


def _near(W, H, maxq, generator):  # noqa: ARG001
    return quantize_nearest(W, maxq)


def _stoch(W, H, maxq, generator):  # noqa: ARG001
    return quantize_stoch(W, maxq, generator)


def _greedy(W, H, maxq, generator, *, greedy_passes=10):  # noqa: ARG001
    return _greedy_fn(W, H, maxq, passes=greedy_passes)


METHODS: dict[str, Callable] = {
    "near": _near,
    "stoch": _stoch,
    "ldlq": _ldlq,
    "ldlq_stoch": lambda W, H, maxq, generator, **kw: _ldlq(
        W, H, maxq, generator, stochastic=True, **kw
    ),
    "ldlq_rg": _ldlq_rg,
    "greedy": _greedy,
}


def round_weights(
    method: str,
    W: torch.Tensor,
    H: torch.Tensor,
    maxq: int,
    generator: Optional[torch.Generator] = None,
    **kw,
) -> torch.Tensor:
    if method not in METHODS:
        raise KeyError(
            f"unknown rounding method {method!r}; have {list(METHODS)}")
    return METHODS[method](W, H, maxq, generator, **kw)
