"""TT-operators (matrix trains): constructors and application.

Counterpart of ``tensor_networks_tpu/ops/ttop.py``.  A rank-k
TT-operator is the block-diagonal assembly of k rank-1 operator trains,
so there is exactly one constructor -- :func:`ttop_sum` -- with the rank-1
and rank-2 entry points as thin aliases.  Block embedding is a single
einsum against an identity (``M_s -> delta_st M_s``), not a fill loop.

Application contracts operator and vector cores position-wise (bond
ranks multiply); the lazy :func:`ttop_sum_apply` evaluates user
callables per core per summand and assembles the same block structure.

Capability parity: ``pytens/algs.py`` ttop_rank1/2/sum (:2383-2533),
ttop_apply (:2662), ttop_sum_apply (:2588).
"""

from __future__ import annotations

import copy
from typing import Callable, List, Sequence

import torch

from tensor_networks_tpu_torch.network import TensorNetwork
from tensor_networks_tpu_torch.tensor import Tensor
from tensor_networks_tpu_torch.types import Index, resolve_device


def _operator_train(
    stacks: List[torch.Tensor],
    indices_out: Sequence[Index],
    indices_in: Sequence[Index],
    prefix: str,
) -> TensorNetwork:
    """Assemble an operator train from per-position summand stacks.

    ``stacks[p]`` is (S, n_out, n_in) at position p; middle cores embed
    block-diagonally, first/last cores flatten the summand axis onto the
    adjacent bond.
    """
    d = len(stacks)
    n_sum = stacks[0].shape[0]
    eye = torch.eye(n_sum, dtype=stacks[0].dtype, device=stacks[0].device)
    bonds = [Index(f"{prefix}_r{p + 1}", n_sum) for p in range(d - 1)]

    net = TensorNetwork()
    for p, stack in enumerate(stacks):
        if p == 0:
            core = torch.movedim(stack, 0, -1).contiguous()  # (n_out, n_in, S)
            inds = [indices_out[0], indices_in[0], bonds[0]]
        elif p == d - 1:
            core = stack  # (S, n_out, n_in)
            inds = [bonds[p - 1], indices_out[p], indices_in[p]]
        else:
            # (S, n_out, n_in, S'): diagonal summand embedding
            core = torch.einsum("soi,st->soit", stack, eye)
            inds = [bonds[p - 1], indices_out[p], indices_in[p], bonds[p]]
        net.add_node(p, Tensor(core, inds))
        if p:
            net.add_edge(p - 1, p)
    return net


def ttop_sum(
    indices_in: Sequence[Index],
    indices_out: Sequence[Index],
    cores: List[List],
    rank_name_prefix: str,
    device=None,
) -> TensorNetwork:
    """Sum of k rank-1 TT-operators as one rank-k operator train, on
    ``device`` (default: the card), in the cores' dtype."""
    if len(indices_in) != len(indices_out):
        raise ValueError("operator needs matching input/output arity")
    device = resolve_device(device)
    d = len(indices_in)
    stacks = [
        torch.stack(
            [
                torch.as_tensor(summand[p], device=device)
                for summand in cores
            ]
        )
        for p in range(d)
    ]
    return _operator_train(stacks, indices_out, indices_in, rank_name_prefix)


def ttop_rank1(
    indices_in: Sequence[Index],
    indices_out: Sequence[Index],
    cores: List,
    rank_name_prefix: str,
    device=None,
) -> TensorNetwork:
    """Rank-1 TT-operator from one matrix per dimension."""
    return ttop_sum(indices_in, indices_out, [cores], rank_name_prefix, device)


def ttop_rank2(
    indices_in: Sequence[Index],
    indices_out: Sequence[Index],
    cores_r1: List,
    cores_r2: List,
    rank_name_prefix: str,
    device=None,
) -> TensorNetwork:
    """Sum of two rank-1 TT-operators."""
    return ttop_sum(
        indices_in, indices_out, [cores_r1, cores_r2], rank_name_prefix, device
    )


# -- application ---------------------------------------------------------------


def _apply_first(op_core, v_core):
    # (n_out, n_in, R) x (n_in, r) -> (n_out, r*R)
    out = torch.einsum("oik,il->olk", op_core, v_core)
    return out.reshape(out.shape[0], -1)


def _apply_mid(op_core, v_core):
    # (R, n_out, n_in, R') x (r, n_in, r') -> (r*R, n_out, r'*R')
    out = torch.einsum("aoib,mir->maorb", op_core, v_core)
    s = out.shape
    return out.reshape(s[0] * s[1], s[2], s[3] * s[4])


def _apply_last(op_core, v_core):
    # (R, n_out, n_in) x (r, n_in) -> (r*R, n_out)
    out = torch.einsum("aoi,mi->mao", op_core, v_core)
    s = out.shape
    return out.reshape(s[0] * s[1], s[2])


def ttop_apply(ttop: TensorNetwork, tt_in: TensorNetwork) -> TensorNetwork:
    """Apply a TT-operator to a TT; bond ranks multiply."""
    out = copy.deepcopy(tt_in)
    op_nodes = list(ttop.network.nodes)
    tt_nodes = list(out.network.nodes)
    d = len(tt_nodes)
    kernels = [_apply_first] + [_apply_mid] * (d - 2) + [_apply_last]
    for kernel, op_node, tt_node in zip(kernels, op_nodes, tt_nodes):
        out.node_tensor(tt_node).update_val_size(
            kernel(ttop.value(op_node), out.value(tt_node))
        )
    return out


def ttop_sum_apply(
    tt_in: TensorNetwork,
    indices_in: Sequence[Index],
    indices_out: Sequence[Index],
    cores: List[List[Callable]],
    rank_name_prefix: str,
) -> TensorNetwork:
    """Apply a lazily-defined sum of rank-1 operators (one callable per
    position per summand) without materializing the operator.

    Each summand's callables map the input cores to output cores of the
    same bond ranks; the results assemble block-diagonally, exactly as a
    TT sum of the individually applied trains, on the input's device.
    """
    if len(indices_in) != len(indices_out):
        raise ValueError("operator needs matching input/output arity")
    d = len(indices_in)
    node_order = list(tt_in.network.nodes)
    values = [tt_in.value(nm) for nm in node_order]
    dev = values[0].device

    # applied[p] has shape (S, <core shape with n_out at the mode axis>)
    applied = [
        torch.stack(
            [
                torch.as_tensor(summand[p](values[p]), device=dev)
                for summand in cores
            ]
        )
        for p in range(d)
    ]
    n_sum = applied[0].shape[0]
    eye = torch.eye(n_sum, dtype=applied[0].dtype, device=dev)

    out = TensorNetwork()
    bond_sizes = [
        n_sum * (values[p].shape[-1] if p < d - 1 else 1) for p in range(d)
    ]
    bonds = [
        Index(f"{rank_name_prefix}_r{p + 1}", bond_sizes[p])
        for p in range(d - 1)
    ]
    for p in range(d):
        stack = applied[p]
        if p == 0:
            # summand-major blocks along the bond: (n_out, S*r)
            core = torch.movedim(stack, 0, 1).reshape(stack.shape[1], -1)
            inds = [indices_out[0], bonds[0]]
        elif p == d - 1:
            core = stack.reshape(-1, stack.shape[-1])  # (S*r, n_out)
            inds = [bonds[p - 1], indices_out[p]]
        else:
            blocks = torch.einsum("sanb,st->santb", stack, eye)
            s = blocks.shape
            core = blocks.reshape(s[0] * s[1], s[2], s[3] * s[4])
            inds = [bonds[p - 1], indices_out[p], bonds[p]]
        out.add_node(p, Tensor(core, inds))
        if p:
            out.add_edge(p - 1, p)
    return out
