"""PackedTT: static-shape tensor trains as three stacked tensors.

Counterpart of the core half of ``tensor_networks_tpu/ops/packed.py``:
pack/unpack, ragged-chain packing, inner/norm/scale and batched
evaluation.  For CUDA tensors, :func:`inner` runs the H1 zipper kernel
and :func:`evaluate` the H2 evaluation kernel; CPU tensors take the
kernels' plain versions.

Parity anchors: ``pytens/algs.py`` tt_sum :2535.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from tensor_networks_tpu_torch.kernels.evaluate import tt_evaluate
from tensor_networks_tpu_torch.kernels.zipper import tt_inner, tt_inner_plain
from tensor_networks_tpu_torch.network import TensorNetwork
from tensor_networks_tpu_torch.ops.fast import stack_tt_cores
from tensor_networks_tpu_torch.tensor import Tensor
from tensor_networks_tpu_torch.types import Index, resolve_device


class PackedTT(NamedTuple):
    """A uniform TT as (first (n, r), mids (d-2, r, n, r), last (r, n))."""

    first: torch.Tensor
    mids: torch.Tensor
    last: torch.Tensor

    @property
    def d(self) -> int:
        return self.mids.shape[0] + 2

    @property
    def rank(self) -> int:
        return self.first.shape[1]

    @property
    def mode(self) -> int:
        return self.first.shape[0]


def pack(tn: TensorNetwork, dtype: Optional[torch.dtype] = None) -> PackedTT:
    """Pack a uniform TT network into stacked tensors."""
    first, mids, last = stack_tt_cores(tn)
    if mids is None:
        raise ValueError("PackedTT needs d >= 3")
    if dtype is not None:
        first, mids, last = (x.to(dtype) for x in (first, mids, last))
    return PackedTT(first.contiguous(), mids.contiguous(), last.contiguous())


def from_numpy(first, mids, last, device=None, dtype=None) -> PackedTT:
    """A PackedTT from NumPy arrays (e.g. the JAX package's packed cores,
    fetched with ``np.asarray``), placed on ``device`` (default: the
    card) as ``dtype``."""
    device = resolve_device(device)
    return PackedTT(
        *(
            torch.tensor(np.asarray(x), device=device, dtype=dtype)
            for x in (first, mids, last)
        )
    )


def unpack(p: PackedTT, index_names: Optional[List[str]] = None) -> TensorNetwork:
    """Materialize a PackedTT as a graph network.

    Mode sizes come from the packed tensors: a mixed-mode train packed by
    :func:`pack_ragged` unpacks with every mode at the padded maximum
    (the padded slices are zero).
    """
    d = p.d
    n = p.mode
    if index_names is None:
        index_names = [f"x{i}" for i in range(d)]
    indices = [Index(nm, n) for nm in index_names]
    tn = TensorNetwork()
    bonds = [
        Index(f"r{i + 1}", int(s))
        for i, s in enumerate([p.first.shape[1]] + [p.mids.shape[3]] * (d - 2))
    ]
    tn.add_node(0, Tensor(p.first, [indices[0], bonds[0]]))
    for i in range(d - 2):
        tn.add_node(
            i + 1, Tensor(p.mids[i], [bonds[i], indices[i + 1], bonds[i + 1]])
        )
        tn.add_edge(i, i + 1)
    tn.add_node(d - 1, Tensor(p.last, [bonds[-1], indices[-1]]))
    tn.add_edge(d - 2, d - 1)
    return tn


def pad_rank(a: PackedTT, rank: int) -> PackedTT:
    """Zero-pad every bond of the train to ``rank`` (numerically inert)."""
    grow = rank - a.rank
    if grow < 0:
        raise ValueError(f"cannot shrink rank {a.rank} to {rank}")
    if grow == 0:
        return a
    return PackedTT(
        F.pad(a.first, (0, grow)),
        F.pad(a.mids, (0, grow, 0, 0, 0, grow)),
        F.pad(a.last, (0, 0, 0, grow)),
    )


def _chain_order(tn: TensorNetwork) -> Optional[list]:
    """Node names of a path-topology network in chain order, else None."""
    nodes = list(tn.network.nodes)
    if len(nodes) < 3:
        return None
    nbrs = {n: list(tn.network.neighbors(n)) for n in nodes}
    ends = [n for n in nodes if len(nbrs[n]) == 1]
    if len(ends) != 2 or any(len(v) > 2 for v in nbrs.values()):
        return None
    order, prev = [ends[0]], None
    while True:
        step = [m for m in nbrs[order[-1]] if m != prev]
        if not step:
            break
        prev = order[-1]
        order.append(step[0])
    return order if len(order) == len(nodes) else None


def chain_cores(tn: TensorNetwork):
    """Canonical cores of a linear-chain network with ragged ranks.

    Returns ``(order, cores, free_indices, perms)`` -- node names in
    chain order, values permuted into (left bond, mode, right bond) /
    (mode, right) / (left, mode) layout from the index metadata, the
    per-node free index, and the axis permutation applied to each node
    (invert with ``np.argsort(perm)`` to write values back) -- or None
    when the network is not a chain of >= 3 cores with exactly one free
    index per core.
    """
    order = _chain_order(tn)
    if order is None:
        return None
    tensors = [tn.node_tensor(n) for n in order]
    bonds = []
    for a, b in zip(tensors, tensors[1:]):
        shared = [i for i in a.indices if i in b.indices]
        if len(shared) != 1:
            return None
        bonds.append(shared[0])

    cores, frees, perms = [], [], []
    for k, t in enumerate(tensors):
        near = {bonds[j] for j in (k - 1, k) if 0 <= j < len(bonds)}
        free = [i for i in t.indices if i not in near]
        if len(free) != 1 or len(t.indices) != len(near) + 1:
            return None
        frees.append(free[0])
        axes = (
            [t.indices.index(bonds[k - 1])] if k else []
        ) + [t.indices.index(free[0])] + (
            [t.indices.index(bonds[k])] if k < len(bonds) else []
        )
        cores.append(t.value.permute(axes))
        perms.append(tuple(axes))
    return order, cores, frees, perms


def pack_ragged(
    tn: TensorNetwork, dtype: Optional[torch.dtype] = None
) -> Optional[PackedTT]:
    """Pack a linear-chain TT with *ragged* bond ranks into a PackedTT.

    Every bond is zero-padded to the largest rank rounded up to a power
    of two (>= 32), the JAX package's bucket, so packed shapes match it;
    mixed mode sizes are zero-padded to the largest mode.  Both paddings
    are numerically inert for inner/norm and for evaluation (indices
    only address the true range; the network-level route clamps per
    dimension).  Axes are put in canonical (left bond, mode, right bond)
    order from the index metadata, so any core layout is accepted.

    Returns None when the network is not a chain of >= 3 cores with one
    free index per core.
    """
    extracted = chain_cores(tn)
    if extracted is None:
        return None
    _, cores, frees, _ = extracted
    nmax = max(f.size for f in frees)
    rmax = max(
        [c.shape[-1] for c in cores[:-1]]
        + [c.shape[0] for c in cores[1:]]
    )
    r = max(32, 1 << (rmax - 1).bit_length())
    first = F.pad(
        cores[0], (0, r - cores[0].shape[1], 0, nmax - cores[0].shape[0])
    )
    mids = torch.stack(
        [
            F.pad(
                c,
                (
                    0, r - c.shape[2],
                    0, nmax - c.shape[1],
                    0, r - c.shape[0],
                ),
            )
            for c in cores[1:-1]
        ]
    )
    last = F.pad(
        cores[-1], (0, nmax - cores[-1].shape[1], 0, r - cores[-1].shape[0])
    )
    if dtype is not None:
        first, mids, last = (x.to(dtype) for x in (first, mids, last))
    return PackedTT(first.contiguous(), mids.contiguous(), last.contiguous())


class _Inner(torch.autograd.Function):
    """Differentiable zipper: kernel forward, plain-zipper backward.

    The kernel has no backward; the cotangents come from autograd of the
    plain zipper in full precision regardless of the forward
    ``precision`` -- the JAX package's ``_inner_diff`` custom VJP.
    """

    @staticmethod
    def forward(ctx, precision, fa, ma, la, fb, mb, lb):
        ctx.save_for_backward(fa, ma, la, fb, mb, lb)
        return tt_inner(fa, ma, la, fb, mb, lb, precision=precision)

    @staticmethod
    def backward(ctx, g):
        saved = [x.detach().requires_grad_(True) for x in ctx.saved_tensors]
        with torch.enable_grad():
            out = tt_inner_plain(*saved)
        grads = torch.autograd.grad(out, saved, g, allow_unused=True)
        return (None,) + tuple(grads)


def inner(a: PackedTT, b: PackedTT, precision: str = "highest") -> torch.Tensor:
    """<a, b> via the fused zipper (the H1 kernel for CUDA tensors).

    ``precision`` takes the JAX API's values; all compute in full
    precision.  Differentiable: the backward pass is autograd of the
    plain zipper.
    """
    return _Inner.apply(
        precision, a.first, a.mids, a.last, b.first, b.mids, b.last
    )


def norm(a: PackedTT) -> torch.Tensor:
    return torch.sqrt(torch.abs(inner(a, a)))


def scale(a: PackedTT, factor) -> PackedTT:
    """Scale the represented tensor (folds into the first core)."""
    return PackedTT(a.first * factor, a.mids, a.last)


def evaluate(x: PackedTT, idx, precision: str = "bf16x3") -> torch.Tensor:
    """Evaluate the train at (B, d) integer multi-indices (the H2 kernel
    for CUDA tensors).  Out-of-range indices clamp into each mode's
    range, as the JAX package's ``packed.evaluate`` does."""
    return _eval_routed(x.first, x.mids, x.last, idx, precision)


def _eval_routed(first, mids, last, idx, precision: str) -> torch.Tensor:
    """Clamp at this public boundary, then route by device.

    The clamp gives every route the semantics of the JAX package's XLA
    gather (and of ``TensorNetwork.evaluate``); without it the kernel
    would read out of bounds.
    """
    idx = torch.as_tensor(idx, device=first.device)
    d_modes = idx.shape[1]
    mid_caps = [] if mids is None else [mids.shape[2]] * (d_modes - 2)
    caps = [first.shape[0]] + mid_caps + [last.shape[1]]
    ub = torch.tensor(caps, device=idx.device, dtype=idx.dtype) - 1
    idx = torch.minimum(idx.clamp(min=0), ub[None, :])
    return tt_evaluate(first, mids, last, idx, precision=precision)
