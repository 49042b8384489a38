"""TT algebra, the four rounding families, TT-operators and GMRES,
fused train operations, the packed device TT algebra, the QTT
constructors, and the ALS linear solver and DMRG eigensolver."""

from tensor_networks_tpu_torch.ops.tt import (
    tt_rank1,
    tt_separable,
    tt_right_orth,
    tt_sum,
    rand_tree,
)
from tensor_networks_tpu_torch.ops.ttop import (
    ttop_rank1,
    ttop_rank2,
    ttop_sum,
    ttop_apply,
    ttop_sum_apply,
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
from tensor_networks_tpu_torch.ops.solvers import gmres
from tensor_networks_tpu_torch.ops import packed, qtt
from tensor_networks_tpu_torch.ops.packed import (
    PackedTT,
    PackedTTOp,
    gmres_packed,
    pack_ttop,
    rand_round,
    svd_round,
    ttop_add,
    ttop_apply_packed,
    ttop_compose,
    ttop_identity,
    ttop_round,
    ttop_scale,
    ttop_transpose,
)
from tensor_networks_tpu_torch.ops.qtt import (
    qtt_exponential,
    qtt_exponential_2d,
    qtt_exponential_nd,
    qtt_interleave_1d_op,
    qtt_polynomial,
    qtt_rank1_from_weights,
    qtt_screened_laplacian,
    qtt_screened_laplacian_2d,
    qtt_screened_laplacian_nd,
    qtt_shift,
    qtt_tridiagonal,
    qtt_trig,
)
from tensor_networks_tpu_torch.ops.als import als_solve, als_solve_adaptive
from tensor_networks_tpu_torch.ops.eigen import (
    als_eigsh,
    als_eigsh_adaptive,
    als_eigsh_k,
)
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
    "ttop_rank1",
    "ttop_rank2",
    "ttop_sum",
    "ttop_apply",
    "ttop_sum_apply",
    "tt_svd_round",
    "tt_gramsvd_round",
    "tt_sum_gramsvd_round",
    "TTRandRound",
    "tt_randomized_round",
    "tt_sum_randomized_round",
    "tt_rand_precond_svd_round",
    "gmres",
    "packed",
    "PackedTT",
    "PackedTTOp",
    "gmres_packed",
    "pack_ttop",
    "rand_round",
    "svd_round",
    "ttop_add",
    "ttop_apply_packed",
    "ttop_compose",
    "ttop_identity",
    "ttop_round",
    "ttop_scale",
    "ttop_transpose",
    "qtt",
    "qtt_exponential",
    "qtt_exponential_2d",
    "qtt_exponential_nd",
    "qtt_interleave_1d_op",
    "qtt_polynomial",
    "qtt_rank1_from_weights",
    "qtt_screened_laplacian",
    "qtt_screened_laplacian_2d",
    "qtt_screened_laplacian_nd",
    "qtt_shift",
    "qtt_tridiagonal",
    "qtt_trig",
    "als_solve",
    "als_solve_adaptive",
    "als_eigsh",
    "als_eigsh_adaptive",
    "als_eigsh_k",
    "tt_inner_fast",
    "tt_inner_fn",
    "stack_tt_cores",
    "tt_round_fixed",
]
