"""Gram-SVD TT rounding: single trains and implicit sums of trains.

Counterpart of ``tensor_networks_tpu/ops/gram.py``.  The Gram approach
(Al Daas/Ballard/Manning, IPDPS'22) never orthogonalizes: each bond is
truncated from the eigendecompositions of its two Gram matrices -- the
left one from the train head as rounded so far, the right one from a
precomputed chain of environment Grams.  GEMMs and ``eigh`` (cuSOLVER on
the card), no pivoting.  The per-bond rank decision reads the singular
values on the host once a bond.

The environment chain is a plain loop of torch ops: its steps depend on
each other, so batching gains nothing.  The implicit-sum variant works
on summand-stacked, zero-padded cores, so the block-structured Gram
update is one einsum rather than a loop over block pairs.  The
static-shape alternative is ``ops.fast.tt_round_fixed(method="gram")``.

Capability parity: ``pytens/algs.py`` Gram rounding (:1707-1840) and its
TT-sum form (:1907-2130).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from tensor_networks_tpu_torch.kernels import gram_eig_and_svd
from tensor_networks_tpu_torch.network import TensorNetwork
from tensor_networks_tpu_torch.tensor import Tensor
from tensor_networks_tpu_torch.types import Index


# -- environment Gram chains ---------------------------------------------------


def _env_step(env: torch.Tensor, core: torch.Tensor) -> torch.Tensor:
    """Pull the right-environment Gram through one middle core:
    env'[a, m] = sum_{n, b, c} core[a, n, b] env[b, c] core[m, n, c]."""
    tmp = torch.einsum("anb,bc->anc", core, env)
    return torch.einsum("anc,mnc->am", tmp, core)


def _bond_environments(cores: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Right-environment Gram for every bond k = 0..d-2.

    ``envs[k]`` is the Gram of the sub-train right of bond k.
    """
    last = cores[-1]
    out = [last @ last.T]
    for core in reversed(cores[1:-1]):
        out.append(_env_step(out[-1], core))
    return out[::-1]


def _norm_budget(head: torch.Tensor, env0: torch.Tensor, eps: float, d: int) -> float:
    """The per-bond budget eps * ||train|| / sqrt(d - 1) (one host read)."""
    norm_sq = torch.sum((head @ env0) * head)
    return eps * float(np.sqrt(norm_sq.item())) / np.sqrt(d - 1)


# -- single-train rounding ------------------------------------------------------


def tt_gramsvd_round(tn: TensorNetwork, eps: float) -> TensorNetwork:
    """Round a TT in place by per-bond Gram-SVD truncation.

    Works for any train length >= 2 and ragged ranks; node order follows
    the graph's insertion order.
    """
    names = list(tn.network.nodes)
    cores = [tn.value(nm) for nm in names]
    d = len(cores)
    envs = _bond_environments(cores)

    head = cores[0]
    budget = _norm_budget(head, envs[0], eps, d)

    for k in range(d - 1):
        bond = head.shape[-1]
        flat = head.reshape(-1, bond)
        shrink, expand = gram_eig_and_svd(flat.T @ flat, envs[k], budget)
        tn.node_tensor(names[k]).update_val_size(
            (flat @ shrink).reshape(*head.shape[:-1], -1)
        )
        nxt = cores[k + 1]
        head = (expand @ nxt.reshape(nxt.shape[0], -1)).reshape(
            -1, *nxt.shape[1:]
        )
        tn.node_tensor(names[k + 1]).update_val_size(head)
    return tn


# -- implicit-sum rounding --------------------------------------------------------


def _pad_to(core: torch.Tensor, shape) -> torch.Tensor:
    """Zero-pad every axis of ``core`` at its end to ``shape``."""
    grow = []
    for s, t in zip(reversed(core.shape), reversed(shape)):
        grow += [0, t - s]
    return F.pad(core, grow)


def _sum_env_step(env4: torch.Tensor, mids_k: torch.Tensor) -> torch.Tensor:
    """Block Gram update over summand-stacked cores: with
    ``mids_k[s] = summand s's core`` and ``env4[i, b, j, d]`` coupling
    summand i's bond b with summand j's bond d, produce the environment
    one bond to the left:
    env'[i, a, j, c] = sum_{n,b,d} M_i[a,n,b] env[i,b,j,d] M_j[c,n,d]."""
    tmp = torch.einsum("ianb,ibjd->ianjd", mids_k, env4)
    return torch.einsum("ianjd,jcnd->iajc", tmp, mids_k)


def tt_sum_gramsvd_round(
    factors_list: List[TensorNetwork], eps: float = 1e-14
) -> TensorNetwork:
    """Round a sum of TTs without materializing the block-diagonal cores.

    Summand cores are zero-padded to a common rank and stacked, so the
    block-structured Gram chain runs as stacked einsums; the result is a
    fresh train (summands untouched) on the summands' device.
    """
    n_sum = len(factors_list)
    node_lists = [list(f.network.nodes) for f in factors_list]
    d = len(node_lists[0])
    trains = [
        [f.value(nm) for nm in names]
        for f, names in zip(factors_list, node_lists)
    ]
    rank = max(
        max(max(c.shape[0] for c in train[1:]) for train in trains),
        max(max(c.shape[-1] for c in train[:-1]) for train in trains),
    )

    # stack padded summand cores: firsts (n, S*R), mids (S, R, n, R),
    # lasts (S, R, n)
    firsts = torch.cat(
        [_pad_to(t[0], (t[0].shape[0], rank)) for t in trains], dim=1
    )
    lasts = torch.stack(
        [_pad_to(t[-1], (rank, t[-1].shape[1])) for t in trains]
    )
    mids_stacked = [
        torch.stack(
            [_pad_to(t[k], (rank, t[k].shape[1], rank)) for t in trains]
        )
        for k in range(1, d - 1)
    ]

    # environment chain in block form, flattened to (S*R, S*R) per bond
    env4 = torch.einsum("ian,jbn->iajb", lasts, lasts)
    envs4 = [env4]
    for mids_k in reversed(mids_stacked):
        envs4.append(_sum_env_step(envs4[-1], mids_k))
    envs = [e.reshape(n_sum * rank, n_sum * rank) for e in envs4[::-1]]

    head = firsts  # (n, S*R)
    budget = _norm_budget(head, envs[0], eps, d)

    out_cores: List[torch.Tensor] = []
    for k in range(d - 1):
        bond = head.shape[-1]
        flat = head.reshape(-1, bond)
        shrink, expand = gram_eig_and_svd(flat.T @ flat, envs[k], budget)
        out_cores.append((flat @ shrink).reshape(*head.shape[:-1], -1))
        if k == d - 2:
            head = torch.einsum(
                "kia,ian->kn", expand.reshape(-1, n_sum, rank), lasts
            )
        else:
            nxt = torch.einsum(
                "kia,ianb->knib",
                expand.reshape(-1, n_sum, rank),
                mids_stacked[k],
            )
            head = nxt.reshape(nxt.shape[0], nxt.shape[1], -1)
    out_cores.append(head)

    # assemble a fresh train with the original free indices
    free0 = factors_list[0]
    free_set = set(free0.free_indices())
    result = TensorNetwork()
    mode_indices = [
        next(i for i in free0.node_tensor(nm).indices if i in free_set)
        for nm in node_lists[0]
    ]
    bonds = [
        Index(f"gr_{k}", int(out_cores[k].shape[-1]))
        for k in range(d - 1)
    ]
    for k, core in enumerate(out_cores):
        if k == 0:
            inds = [mode_indices[0], bonds[0]]
        elif k == d - 1:
            inds = [bonds[-1], mode_indices[-1]]
        else:
            inds = [bonds[k - 1], mode_indices[k], bonds[k]]
        result.add_node(k, Tensor(core, inds))
        if k:
            result.add_edge(k - 1, k)
    return result
