"""starcoder2-15b [dense] — GQA kv=4, RoPE, GeLU MLP w/ bias — arXiv:2402.19173."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-15b",
    family="dense",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=4,
    d_ff=24576,
    vocab=49152,
    mlp="gelu",
    mlp_bias=True,
    qkv_bias=True,
    rope_theta=1e5,
)


def smoke() -> ArchConfig:
    return ArchConfig(
        name="starcoder2-15b-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab=256,
        mlp="gelu",
        mlp_bias=True,
        qkv_bias=True,
        dtype="float32",
        microbatch=2,
        remat="none",
    )
