"""whisper-small [audio enc-dec] — arXiv:2212.04356.

The conv audio frontend is a stub: callers pass precomputed frame
embeddings (B, S_enc, d_model) as ``batch["frames"]``.  RoPE replaces
Whisper's sinusoidal / learned positions, as in the JAX package.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-small",
    family="encdec",
    n_layers=12,
    n_enc_layers=12,
    n_dec_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab=51865,
    mlp="gelu",
    mlp_bias=True,
    rope_theta=1e4,
    microbatch=32,
)


def smoke() -> ArchConfig:
    return ArchConfig(
        name="whisper-small-smoke",
        family="encdec",
        n_layers=2,
        n_enc_layers=2,
        n_dec_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab=256,
        mlp="gelu",
        mlp_bias=True,
        dtype="float32",
        microbatch=2,
        remat="none",
    )
