"""llama-3.2-vision-90b [vlm] — a gated cross-attention image layer every
5th layer; the patch frontend is a stub: callers pass patch embeddings
(B, n_patches, d_model) as ``batch["patches"]`` —
hf:meta-llama/Llama-3.2-11B-Vision family."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    n_layers=100,  # 80 self + 20 gated cross-attn
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab=128256,
    cross_every=5,
    n_patches=1024,
    mlp="swiglu",
    rope_theta=5e5,
)


def smoke() -> ArchConfig:
    return ArchConfig(
        name="llama-3.2-vision-90b-smoke",
        family="vlm",
        n_layers=4,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab=256,
        cross_every=2,
        n_patches=16,
        mlp="swiglu",
        dtype="float32",
        microbatch=2,
        remat="none",
    )
