"""llama2-70b [dense] — the paper's own Table-1 evaluation model
(Touvron et al. 2023); included as the paper-fidelity anchor."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama2-70b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab=32000,
    mlp="swiglu",
    rope_theta=1e4,
)


def smoke() -> ArchConfig:
    return ArchConfig(
        name="llama2-70b-smoke",
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
