"""qwen2-72b [dense] — GQA, QKV bias — arXiv:2407.10671."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-72b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=29568,
    vocab=152064,
    qkv_bias=True,
    mlp="swiglu",
    rope_theta=1e6,
)


def smoke() -> ArchConfig:
    return ArchConfig(
        name="qwen2-72b-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab=256,
        qkv_bias=True,
        mlp="swiglu",
        dtype="float32",
        microbatch=2,
        remat="none",
    )
