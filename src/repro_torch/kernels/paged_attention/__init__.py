from repro_torch.kernels.paged_attention.kernel import (
    paged_attention_kernel,
    paged_prefill_kernel,
)
from repro_torch.kernels.paged_attention.ops import (
    paged_gqa_decode,
    paged_gqa_prefill,
    paged_gqa_verify,
)
from repro_torch.kernels.paged_attention.ref import (
    paged_attention_stats_ref,
    paged_gqa_decode_ref,
    paged_gqa_prefill_ref,
    paged_prefill_grouped_ref,
)

__all__ = [
    "paged_attention_kernel",
    "paged_prefill_kernel",
    "paged_gqa_decode",
    "paged_gqa_prefill",
    "paged_gqa_verify",
    "paged_attention_stats_ref",
    "paged_gqa_decode_ref",
    "paged_gqa_prefill_ref",
    "paged_prefill_grouped_ref",
]
