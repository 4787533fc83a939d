"""LR schedules as ``step -> lr`` callables, computed in fp32 as the JAX
package computes them (``jnp.asarray(step, float32)``).  ``step`` is an
int or a 0-d tensor; the lr is a 0-d fp32 tensor on the step's device
(the CPU for an int).

The cosine is the C library's ``cosf``, the function XLA's CPU backend
calls for an fp32 cosine, computed on the host: ``torch.cos`` (SLEEF on
the CPU, the CUDA intrinsic on the card) is one ulp off it at some
arguments, which ``1 + cos`` near -1 turns into two ulp of the lr.
"""
from __future__ import annotations

import ctypes
import ctypes.util
import functools
import math

import torch

__all__ = ["linear_warmup", "cosine_schedule"]


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


@functools.lru_cache(maxsize=1)
def _libm_cosf():
    cosf = ctypes.CDLL(ctypes.util.find_library("m")).cosf
    cosf.restype, cosf.argtypes = ctypes.c_float, [ctypes.c_float]
    return cosf


def _cos(x: torch.Tensor) -> torch.Tensor:
    """fp32 cosine of a 0-d tensor by ``cosf``, on ``x``'s device."""
    return torch.tensor(_libm_cosf()(float(x)), dtype=torch.float32,
                        device=x.device)


def linear_warmup(peak_lr: float, warmup_steps: int):
    def f(step):
        s = _f32(step)
        return peak_lr * torch.clamp((s + 1) / max(warmup_steps, 1), max=1.0)

    return f


def cosine_schedule(peak_lr: float, total_steps: int, warmup_steps: int = 0,
                    final_frac: float = 0.1):
    def f(step):
        s = _f32(step)
        warm = torch.clamp((s + 1) / max(warmup_steps, 1), max=1.0)
        prog = torch.clamp(
            (s - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (
            1 + _cos(math.pi * prog))
        return peak_lr * warm * cos

    return f
