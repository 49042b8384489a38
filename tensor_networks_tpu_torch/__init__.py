"""tensor_networks_tpu_torch -- the PyTorch + CUDA port of tensor_networks_tpu.

The same named-index tensor networks as the JAX package, written in
PyTorch for one NVIDIA H100: an edge-aware cached contraction planner,
uniform-train fast paths (zipper inner product, fixed-rank rounding
sweep) and the packed device TT algebra, with the JAX package's Pallas
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
from tensor_networks_tpu_torch.network import EinsumArgs, TensorNetwork
from tensor_networks_tpu_torch.ops import (
    packed,
    PackedTT,
    tt_inner_fast,
    tt_inner_fn,
    stack_tt_cores,
    tt_round_fixed,
)

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
    "packed",
    "PackedTT",
    "tt_inner_fast",
    "tt_inner_fn",
    "stack_tt_cores",
    "tt_round_fixed",
]
