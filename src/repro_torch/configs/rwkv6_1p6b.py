"""rwkv6-1.6b [ssm] — "Finch", data-dependent decay — arXiv:2404.05892."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-1.6b",
    family="rwkv",
    n_layers=24,
    d_model=2048,
    n_heads=32,          # d_model / rwkv_head_size
    n_kv_heads=32,
    d_ff=7168,
    vocab=65536,
    rwkv_head_size=64,
    rwkv_decay_lora=64,
    rwkv_mix_lora=32,
    microbatch=32,
)


def smoke() -> ArchConfig:
    return ArchConfig(
        name="rwkv6-1.6b-smoke",
        family="rwkv",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab=256,
        rwkv_head_size=16,
        rwkv_decay_lora=8,
        rwkv_mix_lora=4,
        dtype="float32",
        microbatch=2,
        remat="none",
    )
