"""tensor_networks_tpu_torch -- the PyTorch + CUDA port of tensor_networks_tpu.

The same named-index tensor networks as the JAX package, written in
PyTorch for one NVIDIA H100: an edge-aware cached contraction planner,
the graph rewrites (svd, qr, merge, orthonormalize, round), the TT
constructors and the four TT rounding families, TT-operators and
TT-GMRES (graph and packed), uniform-train fast paths (zipper inner
product, fixed-rank rounding sweep), the packed device TT algebra, the
QTT constructors, the ALS linear solver and DMRG eigensolver
(:mod:`tensor_networks_tpu_torch.ops.als`, :mod:`~.ops.eigen`), the time
integrators (:mod:`~.ops.evolve`), tight-budget rounding in float64
(:mod:`~.ops.tight`), cross approximation
(:mod:`tensor_networks_tpu_torch.cross`), tensor completion
(:mod:`~.fit`), the serving export through ``torch.export``
(:mod:`~.export`) and profiling hooks (:mod:`~.profiling`), with the JAX package's Pallas
kernels replaced by hand-written CUDA kernels for Hopper
(:mod:`tensor_networks_tpu_torch.kernels`).

This package imports neither JAX nor ``tensor_networks_tpu`` and sets no
global torch state.  Constructors place their tensors on the card unless
the caller names another device (``device="cpu"``, as the CPU tests do;
see :func:`resolve_device`); functions of tensors follow their inputs.
Randomness comes from an explicit ``torch.Generator`` where one is given.
"""

from tensor_networks_tpu_torch.types import (
    Index,
    IndexName,
    IntOrStr,
    NodeName,
    SVDConfig,
    resolve_device,
)
from tensor_networks_tpu_torch.dimtree import DimTreeNode, NodeInfo
from tensor_networks_tpu_torch.kernels import TruncSVD, delta_svd
from tensor_networks_tpu_torch.tensor import Tensor
from tensor_networks_tpu_torch.network import EinsumArgs, TensorNetwork, vector
from tensor_networks_tpu_torch.ops import (
    tt_rank1,
    tt_separable,
    tt_right_orth,
    tt_sum,
    rand_tree,
    ttop_rank1,
    ttop_rank2,
    ttop_sum,
    ttop_apply,
    ttop_sum_apply,
    tt_svd_round,
    tt_gramsvd_round,
    tt_sum_gramsvd_round,
    TTRandRound,
    tt_randomized_round,
    tt_sum_randomized_round,
    tt_rand_precond_svd_round,
    gmres,
    packed,
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
    qtt,
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
    als_solve,
    als_solve_adaptive,
    als_eigsh,
    als_eigsh_adaptive,
    als_eigsh_k,
    evolve_theta,
    evolve_tdvp,
    evolve_tdvp2,
    tdvp_trajectory,
    tt_inner_fast,
    tt_inner_fn,
    stack_tt_cores,
    tt_round_fixed,
)
from tensor_networks_tpu_torch import cross
from tensor_networks_tpu_torch import fit
from tensor_networks_tpu_torch import export

__version__ = "0.1.0"

__all__ = [
    "Index",
    "IndexName",
    "IntOrStr",
    "NodeName",
    "SVDConfig",
    "resolve_device",
    "DimTreeNode",
    "NodeInfo",
    "TruncSVD",
    "delta_svd",
    "Tensor",
    "EinsumArgs",
    "TensorNetwork",
    "vector",
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
    "evolve_theta",
    "evolve_tdvp",
    "evolve_tdvp2",
    "tdvp_trajectory",
    "tt_inner_fast",
    "tt_inner_fn",
    "stack_tt_cores",
    "tt_round_fixed",
    "cross",
    "fit",
    "export",
]
