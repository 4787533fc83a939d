"""Architecture config schema (dense decoder subset).

The port serves the dense family only, so :class:`ArchConfig` keeps the
fields that family reads, the biases of qwen2-72b and starcoder2-15b
included.  ``from_dict`` accepts a full config dict as the JAX package
writes it into artifact manifests and drops the fields of the other
families.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

__all__ = ["ArchConfig"]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0  # 0 -> d_model // n_heads

    # attention options
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 1e6
    attn_q_chunk: int = 1024  # query-block size for full-sequence attention

    # mlp options
    mlp: Literal["swiglu", "gelu"] = "swiglu"
    mlp_bias: bool = False

    # misc
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @classmethod
    def from_dict(cls, d: dict) -> "ArchConfig":
        """Build from a manifest's ``arch_config``; fields this schema does
        not model (other families, training knobs) are dropped.  A field
        that would change what the dense path computes — bf16 attention
        probabilities, the JAX package's in-model packed weights
        (``weight_bits``) — raises at any value but its default."""
        names = {f.name for f in dataclasses.fields(cls)}
        for flag in ("attn_bf16_probs", "weight_bits"):
            if d.get(flag):
                raise ValueError(f"{flag}={d[flag]!r} is not supported by "
                                 f"the port")
        return cls(**{k: v for k, v in d.items() if k in names})
