"""TT algebra, the four rounding families, fused train operations and
the packed device TT algebra."""

from tensor_networks_tpu_torch.ops.tt import (
    tt_rank1,
    tt_separable,
    tt_right_orth,
    tt_sum,
    rand_tree,
)
from tensor_networks_tpu_torch.ops.rounding import tt_svd_round
from tensor_networks_tpu_torch.ops.gram import (
    tt_gramsvd_round,
    tt_sum_gramsvd_round,
)
from tensor_networks_tpu_torch.ops.randomized import (
    TTRandRound,
    tt_randomized_round,
    tt_sum_randomized_round,
    tt_rand_precond_svd_round,
)
from tensor_networks_tpu_torch.ops import packed
from tensor_networks_tpu_torch.ops.packed import PackedTT
from tensor_networks_tpu_torch.ops.fast import (
    tt_inner_fast,
    tt_inner_fn,
    stack_tt_cores,
    tt_round_fixed,
)

__all__ = [
    "tt_rank1",
    "tt_separable",
    "tt_right_orth",
    "tt_sum",
    "rand_tree",
    "tt_svd_round",
    "tt_gramsvd_round",
    "tt_sum_gramsvd_round",
    "TTRandRound",
    "tt_randomized_round",
    "tt_sum_randomized_round",
    "tt_rand_precond_svd_round",
    "packed",
    "PackedTT",
    "tt_inner_fast",
    "tt_inner_fn",
    "stack_tt_cores",
    "tt_round_fixed",
]
