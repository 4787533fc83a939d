"""qwen3-14b [dense] — qk_norm, GQA — hf:Qwen/Qwen3-8B family."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-14b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=17408,
    vocab=151936,
    qk_norm=True,
    mlp="swiglu",
    rope_theta=1e6,
)


def smoke() -> ArchConfig:
    return ArchConfig(
        name="qwen3-14b-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab=256,
        qk_norm=True,
        mlp="swiglu",
        dtype="float32",
        microbatch=2,
        remat="none",
    )
