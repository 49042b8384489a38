"""Tensor-train constructors, orthogonalization, and exact sums.

Counterpart of ``tensor_networks_tpu/ops/tt.py``.  Parity reference:
``pytens/algs.py`` -- tt_rank1 :1592, tt_separable :1621, tt_right_orth
:1654, tt_sum :2535, rand_tree :2796.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from tensor_networks_tpu_torch.kernels import qr_reduced_padded
from tensor_networks_tpu_torch.network import TensorNetwork
from tensor_networks_tpu_torch.tensor import Tensor
from tensor_networks_tpu_torch.types import Index, NodeName, resolve_device


# -- constructors -------------------------------------------------------------


def tt_rank1(
    indices: List[Index], vals: List[np.ndarray], dtype=None, device=None
) -> TensorNetwork:
    """Rank-1 TT from one vector per dimension, on ``device`` (default:
    the card) as ``dtype`` (default: the vectors' own)."""
    device = resolve_device(device)
    vals = [torch.as_tensor(v, dtype=dtype, device=device) for v in vals]
    dim = len(indices)
    tt = TensorNetwork()
    bonds = [Index("r1", 1)]
    tt.add_node(0, Tensor(vals[0][:, None], [indices[0], bonds[0]]))
    for ii, index in enumerate(indices[1:-1]):
        bonds.append(Index(f"r{ii + 2}", 1))
        tt.add_node(
            ii + 1,
            Tensor(vals[ii + 1][None, :, None], [bonds[ii], index, bonds[ii + 1]]),
        )
        tt.add_edge(ii, ii + 1)
    tt.add_node(dim - 1, Tensor(vals[-1][None, :], [bonds[-1], indices[-1]]))
    tt.add_edge(dim - 2, dim - 1)
    return tt


def tt_separable(
    indices: List[Index],
    funcs: List[np.ndarray],
    dtype=torch.float64,
    device=None,
) -> TensorNetwork:
    """Rank-2 TT representing a sum of univariate functions, on
    ``device`` (default: the card) as ``dtype``."""
    device = resolve_device(device)
    dim = len(indices)
    tt = TensorNetwork()
    bonds: List[Index] = []
    for ii, index in enumerate(indices):
        bonds.append(Index(f"r_{ii + 1}", 2))
        f = np.asarray(funcs[ii])
        if ii == 0:
            val = np.ones((index.size, 2))
            val[:, 0] = f
            inds = [index, bonds[-1]]
        elif ii < dim - 1:
            val = np.zeros((2, index.size, 2))
            val[0, :, 0] = 1.0
            val[1, :, 0] = f
            val[1, :, 1] = 1.0
            inds = [bonds[-2], index, bonds[-1]]
        else:
            val = np.ones((2, index.size))
            val[1, :] = f
            inds = [bonds[-2], index]
        tt.add_node(
            ii, Tensor(torch.tensor(val, dtype=dtype, device=device), inds)
        )
        if ii > 0:
            tt.add_edge(ii - 1, ii)
    return tt


def rand_tree(
    indices: List[Index],
    ranks: List[int],
    rng: Optional[Union[np.random.Generator, np.random.RandomState]] = None,
    dtype=torch.float64,
    device=None,
) -> TensorNetwork:
    """A random tree tensor network over a uniformly sampled topology,
    with standard-normal values on ``device`` (default: the card).

    The topology and the values are drawn from ``rng``, or without one
    from NumPy's global stream, as the JAX package draws them: after the
    same ``np.random.seed`` both packages build the same tree.
    """
    rng = np.random if rng is None else rng
    device = resolve_device(device)
    ndims = len(indices)
    num_of_nodes = len(ranks) + 1
    assert ndims <= num_of_nodes

    ranks = list(ranks)
    rng.shuffle(ranks)
    nodes_with_free = rng.choice(num_of_nodes, len(indices), replace=False)

    parent: Dict[int, Tuple[NodeName, int]] = {}
    pool = list(range(num_of_nodes))
    while len(pool) > 1:
        node = rng.choice(pool, 1)[0]
        pool.remove(node)

        p = rng.choice(num_of_nodes, 1)[0]
        while p == node:
            p = rng.choice(num_of_nodes, 1)[0]
        ancestor = p
        while ancestor in parent:
            ancestor, _ = parent[ancestor]
            if ancestor == node:
                p = rng.choice(num_of_nodes, 1)[0]
                while p == node:
                    p = rng.choice(num_of_nodes, 1)[0]
                ancestor = p
        parent[node] = (p, len(pool) - 1)

    tree = TensorNetwork()
    for i in range(num_of_nodes):
        i_indices: List[Index] = []
        i_dims: List[int] = []
        if i in nodes_with_free:
            idx = list(nodes_with_free).index(i)
            i_indices.append(indices[idx])
            i_dims.append(indices[idx].size)
        if i in parent:
            _, ridx = parent[i]
            i_indices.append(Index(f"r_{ridx}", ranks[ridx]))
            i_dims.append(ranks[ridx])
        for p, ridx in parent.values():
            if p == i:
                i_indices.append(Index(f"r_{ridx}", ranks[ridx]))
                i_dims.append(ranks[ridx])
        value = torch.tensor(
            rng.standard_normal(i_dims), dtype=dtype, device=device
        )
        tree.add_node(i, Tensor(value, i_indices))
    for i, (p, _) in parent.items():
        tree.add_edge(i, p)
    return tree


# -- orthogonalization --------------------------------------------------------


def tt_right_orth(tn: TensorNetwork, node: int) -> TensorNetwork:
    """Right-orthogonalize core ``node`` of a TT, pushing its R factor into
    core ``node - 1``.  Zero-pads when the core is rank-deficient so bond
    dimensions never change.  Modifies the network in place."""
    val = tn.value(node)
    if val.ndim == 3:
        r, n, b = val.shape
        q, rr = qr_reduced_padded(val.reshape(r, n * b).T, r)
        tn.node_tensor(node).update_val_size(q.T.reshape(r, n, b))
    else:
        q, rr = qr_reduced_padded(val.T, val.shape[0])
        tn.node_tensor(node).update_val_size(q.T)

    prev = tn.value(node - 1)
    tn.node_tensor(node - 1).update_val_size(prev @ rr.T)
    return tn


# -- TT sums -------------------------------------------------------------------


def tt_sum(tt_in: List[TensorNetwork]) -> TensorNetwork:
    """Exact k-ary TT sum: first/last cores concatenate, middle cores are
    placed block-diagonally into a zero tensor."""
    tt_out = TensorNetwork()
    dim = tt_in[0].dim()
    for ii, node in enumerate(tt_in[0].network.nodes):
        inds = tt_in[0].node_tensor(node).indices
        core_values = [tt.value(node) for tt in tt_in]

        if ii == 0:
            new_value = torch.cat(core_values, dim=1)
            new_inds = [
                Index(inds[0].name, inds[0].size),
                Index("rank_0", new_value.shape[1]),
            ]
        elif ii == dim - 1:
            new_value = torch.cat(core_values, dim=0)
            new_inds = [
                Index(f"rank_{ii - 1}", new_value.shape[0]),
                Index(inds[1].name, inds[1].size),
            ]
        else:
            rank_left = sum(v.shape[0] for v in core_values)
            rank_right = sum(v.shape[2] for v in core_values)
            new_value = core_values[0].new_zeros(
                (rank_left, core_values[0].shape[1], rank_right)
            )
            off_l = off_r = 0
            for cv in core_values:
                new_value[
                    off_l : off_l + cv.shape[0], :, off_r : off_r + cv.shape[2]
                ] = cv
                off_l += cv.shape[0]
                off_r += cv.shape[2]
            new_inds = [
                Index(f"rank_{ii - 1}", rank_left),
                Index(inds[1].name, inds[1].size),
                Index(f"rank_{ii}", rank_right),
            ]

        tt_out.add_node(ii, Tensor(new_value, new_inds))
        if ii > 0:
            tt_out.add_edge(ii - 1, ii)
    return tt_out
