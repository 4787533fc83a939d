"""Architecture registry: ``--arch <id>`` resolution, with the JAX
package's ids in its order."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import SHAPES, ArchConfig, ShapeSpec, shapes_for

__all__ = ["ArchConfig", "ShapeSpec", "SHAPES", "shapes_for", "ARCHS",
           "ARCH_IDS", "get_config", "get_smoke_config"]

# arch id -> module name, in the JAX package's order
_MODULES = {
    "mistral-large-123b": "mistral_large_123b",
    "qwen3-14b": "qwen3_14b",
    "qwen2-72b": "qwen2_72b",
    "starcoder2-15b": "starcoder2_15b",
    "whisper-small": "whisper_small",
    "rwkv6-1.6b": "rwkv6_1p6b",
    "llama-3.2-vision-90b": "llama32_vision_90b",
    "arctic-480b": "arctic_480b",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "zamba2-7b": "zamba2_7b",
    # paper-fidelity anchor (not one of the assigned architectures)
    "llama2-70b": "llama2_70b",
}

ARCHS = tuple(_MODULES)
ARCH_IDS = [k for k in _MODULES if k != "llama2-70b"]


def _module(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; have {sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


def get_config(arch: str) -> ArchConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ArchConfig:
    return _module(arch).smoke()
