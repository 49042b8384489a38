"""Fused train operations and the packed device TT algebra."""

from tensor_networks_tpu_torch.ops import packed
from tensor_networks_tpu_torch.ops.packed import PackedTT
from tensor_networks_tpu_torch.ops.fast import (
    tt_inner_fast,
    tt_inner_fn,
    stack_tt_cores,
    tt_round_fixed,
)

__all__ = [
    "packed",
    "PackedTT",
    "tt_inner_fast",
    "tt_inner_fn",
    "stack_tt_cores",
    "tt_round_fixed",
]
