from faabric_tpu_torch.ops._build import LAUNCHES, reset_launch_counts
from faabric_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_with_lse,
    merge_attention_blocks,
)
from faabric_tpu_torch.ops.ring_permute import ring_permute
from faabric_tpu_torch.ops.rms_norm import rms_norm

__all__ = [
    "LAUNCHES",
    "flash_attention",
    "flash_attention_with_lse",
    "merge_attention_blocks",
    "reset_launch_counts",
    "ring_permute",
    "rms_norm",
]
