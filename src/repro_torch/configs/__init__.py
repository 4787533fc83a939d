"""Architecture registry: ``--arch <id>`` resolution (dense family only)."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ArchConfig

__all__ = ["ArchConfig", "ARCHS", "get_config", "get_smoke_config"]

# arch id -> module name (the JAX package's dense family)
_MODULES = {
    "qwen3-14b": "qwen3_14b",
    "llama2-70b": "llama2_70b",
    "mistral-large-123b": "mistral_large_123b",
    "qwen2-72b": "qwen2_72b",
    "starcoder2-15b": "starcoder2_15b",
}

ARCHS = tuple(_MODULES)


def _module(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; have {sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


def get_config(arch: str) -> ArchConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ArchConfig:
    return _module(arch).smoke()
