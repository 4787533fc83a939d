"""arctic-480b [moe] — 128 experts top-2 + dense residual MLP —
hf:Snowflake/snowflake-arctic-base."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=4864,
    vocab=32000,
    n_experts=128,
    top_k=2,
    dense_residual=True,
    mlp="swiglu",
    rope_theta=1e6,
)


def smoke() -> ArchConfig:
    return ArchConfig(
        name="arctic-480b-smoke",
        family="moe",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=64,
        vocab=256,
        n_experts=8,
        top_k=2,
        dense_residual=True,
        capacity_factor=4.0,  # no-drop headroom for smoke equivalence tests
        mlp="swiglu",
        dtype="float32",
        microbatch=2,
        remat="none",
    )
