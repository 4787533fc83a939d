"""Optimizers, schedules and gradient compression over trees of tensors."""
from repro_torch.optim.compression import (
    ef_int8_compress,
    ef_int8_decompress,
    init_ef_state,
)
from repro_torch.optim.optimizers import (
    Optimizer,
    adafactor,
    adamw,
    clip_by_global_norm,
    global_norm,
    sgd,
)
from repro_torch.optim.schedule import cosine_schedule, linear_warmup

__all__ = [
    "Optimizer",
    "adamw",
    "adafactor",
    "sgd",
    "global_norm",
    "clip_by_global_norm",
    "cosine_schedule",
    "linear_warmup",
    "ef_int8_compress",
    "ef_int8_decompress",
    "init_ef_state",
]
