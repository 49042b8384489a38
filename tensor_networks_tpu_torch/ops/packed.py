"""PackedTT: static-shape tensor trains as three stacked tensors.

Counterpart of the core half of ``tensor_networks_tpu/ops/packed.py``:
pack/unpack, ragged-chain packing, inner/norm/norm_exact/scale, the
exact sum and Hadamard product, and batched evaluation (f64
evaluation, the differentiable form, ensembles).  For CUDA tensors,
:func:`inner` runs the H1 zipper kernel and every evaluation the H2
evaluation kernel; CPU tensors take the kernels' plain versions.  The
rest is torch ops (cuSOLVER QR in :func:`norm_exact`), where the JAX
package has XLA.

Parity anchors: ``pytens/algs.py`` tt_sum :2535.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from tensor_networks_tpu_torch.kernels.evaluate import (
    tt_evaluate,
    tt_evaluate_plain,
)
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


def pad(a: PackedTT) -> PackedTT:
    """The train itself, unchanged.

    The JAX package pads every bond to the TPU's 128-lane width here so
    that its Pallas zipper runs without a per-call padding pass.  The
    H100 kernels take any rank, so there is no lane width to pad to;
    the function stays for the API.  :func:`pad_rank` pads to a chosen
    rank.
    """
    return a


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

    Cores of mixed dtypes are promoted to one
    (``torch.promote_types``) unless ``dtype`` names it.  Returns None when the network is
    not a chain of >= 3 cores with one free index per core.
    """
    extracted = chain_cores(tn)
    if extracted is None:
        return None
    _, cores, frees, _ = extracted
    if dtype is None:
        dtype = cores[0].dtype
        for c in cores[1:]:
            dtype = torch.promote_types(dtype, c.dtype)
    cores = [c.to(dtype) for c in cores]
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


def norm_exact(a: PackedTT) -> torch.Tensor:
    """Train norm via a right-orthogonalising QR sweep.

    The zipper norm ``sqrt(<a, a>)`` loses half the mantissa to
    cancellation when ``a`` is a small difference of large trains (the
    cross's NORM check, a GMRES residual).  The QR sweep is backward
    stable: error ~ eps * component norms.  Each step is one
    ``torch.linalg.qr`` (cuSOLVER on the card).
    """
    r = a.last.shape[0]
    q, rmat = torch.linalg.qr(a.last.T)
    if q.shape[1] < r:  # fewer modes than the bond: R is (n, r)
        rmat = F.pad(rmat, (0, 0, 0, r - rmat.shape[0]))
    carry = rmat.T
    for core in reversed(a.mids):
        cur = torch.einsum("rnk,kc->rnc", core, carry)
        carry = torch.linalg.qr(cur.reshape(core.shape[0], -1).T)[1].T
    return torch.linalg.norm(a.first @ carry)


def scale(a: PackedTT, factor) -> PackedTT:
    """Scale the represented tensor (folds into the first core)."""
    return PackedTT(a.first * factor, a.mids, a.last)


def _add2(a: PackedTT, b: PackedTT) -> PackedTT:
    ra, rb = a.rank, b.rank
    d_mid, _, n, _ = a.mids.shape
    mids = a.mids.new_zeros((d_mid, ra + rb, n, ra + rb))
    mids[:, :ra, :, :ra] = a.mids
    mids[:, ra:, :, ra:] = b.mids
    return PackedTT(
        torch.cat([a.first, b.first], dim=1),
        mids,
        torch.cat([a.last, b.last], dim=0),
    )


def add(*terms: PackedTT) -> PackedTT:
    """Exact k-ary sum: bond ranks add (block-diagonal embedding)."""
    out = terms[0]
    for t in terms[1:]:
        out = _add2(out, t)
    return out


def hadamard(a: PackedTT, b: PackedTT) -> PackedTT:
    """Exact elementwise product: bond ranks multiply (per-core
    Kronecker factors)."""
    n = a.mode
    first = torch.einsum("na,nb->nab", a.first, b.first).reshape(n, -1)
    mids = torch.einsum("kanb,kcnd->kacnbd", a.mids, b.mids)
    k, ra, rb, _, sa, sb = mids.shape
    mids = mids.reshape(k, ra * rb, n, sa * sb)
    last = torch.einsum("an,bn->abn", a.last, b.last).reshape(-1, n)
    return PackedTT(first, mids, last)


def evaluate(x: PackedTT, idx, precision: str = "bf16x3") -> torch.Tensor:
    """Evaluate the train at (B, d) integer multi-indices (the H2 kernel
    for CUDA tensors).  Out-of-range indices clamp into each mode's
    range, as the JAX package's ``packed.evaluate`` does."""
    return _eval_routed(x.first, x.mids, x.last, idx, precision)


def evaluate_dw(x: PackedTT, idx) -> np.ndarray:
    """Evaluate the train at (B, d) multi-indices in float64; returns a
    NumPy float64 vector.

    The JAX package evaluates here in double-word arithmetic (Ozaki
    split products) because the TPU has no f64.  The H100 does: the
    cores are cast to float64 and take the usual route, which for CUDA
    cores is the H2 kernel's float64 instantiation.
    """
    first, mids, last = (t.to(torch.float64) for t in x)
    out = _eval_routed(first, mids, last, idx, "highest")
    return out.detach().cpu().numpy()


class _EvaluateFast(torch.autograd.Function):
    """Batched evaluation: routed forward (H2 on the card), backward by
    autograd of the plain evaluator -- the JAX package's custom VJP."""

    @staticmethod
    def forward(ctx, precision, first, mids, last, idx):
        ctx.save_for_backward(first, mids, last, idx)
        return _eval_routed(first, mids, last, idx, precision)

    @staticmethod
    def backward(ctx, g):
        first, mids, last, idx = ctx.saved_tensors
        cores = [
            None if x is None else x.detach().requires_grad_(True)
            for x in (first, mids, last)
        ]
        # the same clamp as the forward, so both see the same points
        idx = _clamp_idx(first, mids, last, idx)
        with torch.enable_grad():
            out = tt_evaluate_plain(*cores, idx)
        live = [x for x in cores if x is not None]
        grads = iter(torch.autograd.grad(out, live, g.to(first.dtype)))
        return (None,) + tuple(
            None if x is None else next(grads) for x in cores
        ) + (None,)


def tt_evaluate_fast(first, mids, last, idx, precision: str = "bf16x3"):
    """Differentiable batched evaluation with the fast forward pass.

    The forward runs the H2 kernel for CUDA cores (the plain version for
    CPU cores); the backward rematerialises through autograd of the
    plain evaluator, with the cotangent cast to the cores' dtype, and
    gives no gradient for ``idx``.
    """
    idx = torch.as_tensor(idx, device=first.device)
    return _EvaluateFast.apply(precision, first, mids, last, idx)


def evaluate_ensemble(
    trains: Sequence[PackedTT], idx, precision: str = "bf16x3"
) -> torch.Tensor:
    """Evaluate E same-shape trains in one call; returns (E, N).

    The ensemble axis is folded into the mode axis: the combined train
    has mode ``E * n``, where symbol ``e*n + j`` selects train ``e``'s
    mode-``j`` slice, so the whole ensemble is one batched evaluation
    (one H2 call for all ``E * N`` points on the card).

    ``idx`` is ``(N, d)`` (shared points) or ``(E, N, d)`` (per-train
    points).  Out-of-range indices clamp into their own train's range,
    as :func:`evaluate` does.  Forward only; for gradients map
    :func:`tt_evaluate_fast` over the ensemble.
    """
    trains = list(trains)
    if not trains:
        raise ValueError("evaluate_ensemble needs at least one train")
    d, n, r = trains[0].d, trains[0].mode, trains[0].rank
    shapes = [tuple(x.shape) for x in trains[0]]
    for t in trains[1:]:
        if [tuple(x.shape) for x in t] != shapes:
            raise ValueError(
                "ensemble trains must share shapes; got "
                f"{[tuple(x.shape) for x in t]} vs {shapes}"
            )
    e = len(trains)
    idx = torch.as_tensor(idx, device=trains[0].first.device)
    if idx.ndim == 2:
        idx = idx[None].expand((e,) + tuple(idx.shape))
    if idx.ndim != 3 or idx.shape[0] != e or idx.shape[2] != d:
        raise ValueError(
            f"idx must be (N, {d}) or ({e}, N, {d}); got {tuple(idx.shape)}"
        )
    npts = idx.shape[1]

    first = torch.stack([t.first for t in trains]).reshape(e * n, r)
    mids = torch.stack([t.mids for t in trains], dim=2).reshape(
        d - 2, r, e * n, r
    )
    last = torch.stack([t.last for t in trains], dim=1).reshape(r, e * n)
    # clamp BEFORE the per-train offset, so out-of-range points stay in
    # their own train's block of symbols
    offs = torch.arange(e, device=idx.device, dtype=idx.dtype) * n
    idx = idx.clamp(0, n - 1) + offs[:, None, None]
    out = _eval_routed(first, mids, last, idx.reshape(e * npts, d), precision)
    return out.reshape(e, npts)


def _clamp_idx(first, mids, last, idx) -> torch.Tensor:
    """``idx`` on the cores' device, each column clamped into its mode."""
    idx = torch.as_tensor(idx, device=first.device)
    d_modes = idx.shape[1]
    mid_caps = [] if mids is None else [mids.shape[2]] * (d_modes - 2)
    caps = [first.shape[0]] + mid_caps + [last.shape[1]]
    ub = torch.tensor(caps, device=idx.device, dtype=idx.dtype) - 1
    return torch.minimum(idx.clamp(min=0), ub[None, :])


def _eval_routed(first, mids, last, idx, precision: str) -> torch.Tensor:
    """Clamp at this public boundary, then route by device.

    The clamp gives every route the semantics of the JAX package's XLA
    gather (and of ``TensorNetwork.evaluate``); without it the kernel
    would read out of bounds.
    """
    idx = _clamp_idx(first, mids, last, idx)
    return tt_evaluate(first, mids, last, idx, precision=precision)
