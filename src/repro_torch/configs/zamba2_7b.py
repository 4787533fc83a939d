"""zamba2-7b [hybrid] — Mamba2 backbone + shared attention block —
arXiv:2411.15242.

Layout: 81 layers = 13 superblocks of (5 Mamba2 + 1 shared attn+MLP
invocation) + 3 tail Mamba2 layers; the attention block is ONE weight copy
invoked 13 times with distinct KV caches (DESIGN.md §5).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,      # MHA in the shared block
    head_dim=112,       # 3584 / 32
    d_ff=14336,
    vocab=32000,
    ssm_state=64,
    ssm_conv=4,
    ssm_expand=2,
    ssm_head_dim=64,
    shared_attn_period=6,
    mlp="swiglu",
    rope_theta=1e4,
    microbatch=32,
)


def smoke() -> ArchConfig:
    return ArchConfig(
        name="zamba2-7b-smoke",
        family="hybrid",
        n_layers=7,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab=256,
        ssm_state=16,
        ssm_conv=4,
        ssm_expand=2,
        ssm_head_dim=32,
        shared_attn_period=3,
        mlp="swiglu",
        dtype="float32",
        microbatch=2,
        remat="none",
    )
