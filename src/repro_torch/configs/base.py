"""Architecture config schema and the input-shape registry.

One :class:`ArchConfig` covers the dense, moe, rwkv, hybrid, encdec and vlm
families through family-specific optional fields, with the JAX package's
names and defaults, the training knobs ``microbatch`` and ``remat``
among them.  ``from_dict`` accepts a full config dict as the JAX package
writes it into artifact manifests and drops the fields this schema does
not model (``causal``).

Shapes: every LM cell is seq_len × global_batch; ``decode_*`` and
``long_*`` run one token against a seq_len-deep cache or state, not a
train step.  ``long_500k`` runs only for the sub-quadratic families (rwkv,
hybrid).  The registry and :func:`shapes_for` are the JAX package's.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

__all__ = ["ArchConfig", "ShapeSpec", "SHAPES", "shapes_for"]


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: Literal["dense", "moe", "rwkv", "hybrid", "encdec", "vlm"]
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

    # moe options
    n_experts: int = 0
    top_k: int = 0
    dense_residual: bool = False  # arctic: dense MLP in parallel with MoE
    capacity_factor: float = 1.25

    # ssm / hybrid options
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    shared_attn_period: int = 0  # hybrid: shared attn block every k layers

    # rwkv options
    rwkv_head_size: int = 64
    rwkv_decay_lora: int = 64
    rwkv_mix_lora: int = 32

    # encdec options (0 -> n_layers)
    n_enc_layers: int = 0
    n_dec_layers: int = 0

    # vlm options
    cross_every: int = 0  # every k-th layer is a gated cross-attn layer
    n_patches: int = 1024  # stub image-patch count (frontend stubbed)

    # misc
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    attn_bf16_probs: bool = False  # bf16 exp/probs, fp32 max and sum
    weight_bits: int = 0  # 0 = dense weights; 2/3/4 = packed projections

    # training knobs
    microbatch: int = 16  # global microbatch per grad-accum step
    # activation checkpointing of each block while grad is enabled:
    # "full" recomputes the block, "dots" keeps its matmul outputs
    remat: Literal["none", "full", "dots"] = "full"

    # which assigned shapes this arch skips (beyond the family default)
    shape_skips: tuple[str, ...] = ()

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks), the JAX
        package's formula."""
        d, f, v = self.d_model, self.d_ff, self.vocab
        attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        emb = v * d * (1 if self.tie_embeddings else 2)
        if self.family == "rwkv":
            return emb + self.n_layers * (4 * d * d + d * d // 2 + 2 * d * f)
        if self.family == "hybrid":
            di, s = self.d_inner, self.ssm_state
            mamba = d * (2 * di + 2 * s + self.ssm_heads) + di * d
            n_shared = max(1, self.n_layers // max(self.shared_attn_period, 1))
            return (emb + (self.n_layers - n_shared) * mamba
                    + attn + 3 * d * f)
        if self.family == "moe":
            ffn = self.n_experts * 3 * d * f + d * self.n_experts
            if self.dense_residual:
                ffn += 3 * d * f
            return emb + self.n_layers * (attn + ffn)
        blk = attn + (3 if self.mlp == "swiglu" else 2) * d * f
        n_blocks = self.n_layers
        if self.family == "encdec":
            n_blocks = self.n_enc_layers + self.n_dec_layers
            blk += attn  # decoder cross-attn, counted once per layer pair
        return emb + n_blocks * blk

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k of n_experts)."""
        if self.family != "moe" or not self.n_experts:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        ffn_total = self.n_layers * self.n_experts * 3 * d * f
        ffn_active = self.n_layers * self.top_k * 3 * d * f
        return self.param_count() - ffn_total + ffn_active

    @classmethod
    def from_dict(cls, d: dict) -> "ArchConfig":
        """Build from a manifest's ``arch_config``; fields this schema does
        not model are dropped.  A field that would change
        what the port computes raises at any value but its default
        instead: in-model packed weights (``weight_bits``) on the dense
        family, whose serving path (artifacts, adapter, engine) quantizes
        with QuIP's own linears and reads fp weights, and ``qk_norm`` on
        the encdec and vlm families, whose cached cross K/V would skip
        ``k_norm`` where the forward applies it (so prefill then decode
        would not equal the forward)."""
        names = {f.name for f in dataclasses.fields(cls)}
        refused = {}
        if d.get("family") == "dense":
            refused["weight_bits"] = "is not supported by the port"
        if d.get("family") in ("encdec", "vlm"):
            refused["qk_norm"] = (
                f"is not supported by the port on the {d['family']} "
                f"family: the cross K/V cache would skip k_norm, which "
                f"the forward applies")
        for flag, why in refused.items():
            if d.get(flag):
                raise ValueError(f"{flag}={d[flag]!r} {why}")
        kw = {k: v for k, v in d.items() if k in names}
        if "shape_skips" in kw:  # a json list in a manifest
            kw["shape_skips"] = tuple(kw["shape_skips"])
        return cls(**kw)


def shapes_for(cfg: ArchConfig) -> list[ShapeSpec]:
    """The assigned shapes this arch runs (sub-quadratic gating applied)."""
    out = []
    for s in SHAPES.values():
        if s.name in cfg.shape_skips:
            continue
        if s.name == "long_500k" and cfg.family not in ("rwkv", "hybrid"):
            continue  # needs sub-quadratic attention
        out.append(s)
    return out
