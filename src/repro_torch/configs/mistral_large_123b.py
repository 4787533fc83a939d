"""mistral-large-123b [dense] — hf:mistralai/Mistral-Large-Instruct-2407."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mistral-large-123b",
    family="dense",
    n_layers=88,
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    d_ff=28672,
    vocab=32768,
    mlp="swiglu",
    rope_theta=1e6,
)


def smoke() -> ArchConfig:
    return ArchConfig(
        name="mistral-large-123b-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab=256,
        mlp="swiglu",
        dtype="float32",
        microbatch=2,
        remat="none",
    )
