"""llama4-scout-17b-a16e [moe] — 16 experts top-1 —
hf:meta-llama/Llama-4-Scout-17B-16E."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab=202048,
    n_experts=16,
    top_k=1,
    mlp="swiglu",
    rope_theta=5e5,
)


def smoke() -> ArchConfig:
    return ArchConfig(
        name="llama4-scout-17b-a16e-smoke",
        family="moe",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=64,
        vocab=256,
        n_experts=4,
        top_k=1,
        # high capacity so smoke-test decode==forward holds exactly (at the
        # production factor a busy expert may drop tokens in long batches —
        # inherent capacity-MoE semantics, not a bug)
        capacity_factor=4.0,
        mlp="swiglu",
        dtype="float32",
        microbatch=2,
        remat="none",
    )
