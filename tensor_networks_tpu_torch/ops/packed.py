"""PackedTT: static-shape tensor trains as three stacked tensors.

Counterpart of ``tensor_networks_tpu/ops/packed.py``: pack/unpack,
ragged-chain packing, inner/norm/norm_exact/scale, the exact sum and
Hadamard product, batched evaluation (f64 evaluation, the
differentiable form, ensembles), the uniform TT-operator algebra
(:class:`PackedTTOp`: sum, identity, scale, transpose, compose, round,
apply), fixed-rank rounding (:func:`rand_round`, :func:`svd_round`) and
:func:`gmres_packed`.  For CUDA tensors, :func:`inner` runs the H1
zipper kernel and every evaluation the H2 evaluation kernel; CPU
tensors take the kernels' plain versions.  The rest is torch ops
(cuSOLVER QR and SVD in the rounds and :func:`norm_exact`), where the
JAX package has XLA.

Parity anchors: ``pytens/algs.py`` tt_sum :2535, ttop_apply :2662,
TTRandRound :2133, gmres :2700.
"""

from __future__ import annotations

import math
import time
import warnings
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from tensor_networks_tpu_torch.kernels.evaluate import (
    clamp_modes,
    tt_evaluate,
    tt_evaluate_plain,
)
from tensor_networks_tpu_torch.kernels.zipper import tt_inner, tt_inner_plain
from tensor_networks_tpu_torch.network import TensorNetwork
from tensor_networks_tpu_torch.ops.fast import (
    _trunc_count,
    _tt_round_sweep,
    stack_tt_cores,
    sweep_noise_floor,
)
from tensor_networks_tpu_torch.ops.randomized import _pow2_scaled
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


class PackedTTOp(NamedTuple):
    """A uniform TT-operator: (first (no, ni, R), mids (d-2, R, no, ni, R),
    last (R, no, ni))."""

    first: torch.Tensor
    mids: torch.Tensor
    last: torch.Tensor


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


def ttop_add(*ops: PackedTTOp) -> PackedTTOp:
    """Exact sum of uniform TT-operators: operator bond ranks add
    (block-diagonal embedding -- the operator analogue of :func:`add`;
    reference semantics ``pytens/algs.py:2479-2532`` ``ttop_sum`` built
    for the packed form).  All operands must share (d, n_out, n_in)."""
    # explicit promotion: a slice assignment would silently DOWNCAST a
    # wider operand's mids into the first operand's dtype
    dt = ops[0].mids.dtype
    for o in ops[1:]:
        dt = torch.promote_types(dt, o.mids.dtype)
    out = ops[0]
    for o in ops[1:]:
        ra = out.first.shape[-1]
        rb = o.first.shape[-1]
        if out.mids.shape[:1] + out.mids.shape[2:4] != (
            o.mids.shape[:1] + o.mids.shape[2:4]
        ):
            raise ValueError(
                f"operator shape mismatch: {tuple(out.mids.shape)} vs "
                f"{tuple(o.mids.shape)}"
            )
        first = torch.cat([out.first.to(dt), o.first.to(dt)], dim=-1)
        d_m, _, no, ni, _ = out.mids.shape
        mids = out.mids.new_zeros((d_m, ra + rb, no, ni, ra + rb), dtype=dt)
        mids[:, :ra, :, :, :ra] = out.mids
        mids[:, ra:, :, :, ra:] = o.mids
        last = torch.cat([out.last.to(dt), o.last.to(dt)], dim=0)
        out = PackedTTOp(first, mids, last)
    return out


def pack_ttop(
    op_net: TensorNetwork,
    indices_out: List[Index],
    indices_in: List[Index],
    dtype: Optional[torch.dtype] = None,
    device=None,
) -> PackedTTOp:
    """Pack a TT-operator network (as built by the ``ops.ttop``
    constructors) into the uniform packed layout, on ``device`` (default:
    the card).

    Position p is the node carrying ``indices_out[p]``; cores are
    permuted to the canonical (bond, out, in, bond) axis order by index
    identity, and ragged bond ranks are zero-padded to the maximum
    (inert for apply/compose/add).  Mode sizes must be uniform
    (the packed layout's contract).
    """
    d = len(indices_out)
    if len(indices_in) != d:
        raise ValueError("operator needs matching input/output arity")
    if d < 3:
        raise ValueError("packed operators need d >= 3")
    device = resolve_device(device)
    # node holding each output index
    pos_node = {}
    for node in op_net.network.nodes:
        t = op_net.node_tensor(node)
        for p, io in enumerate(indices_out):
            if io in t.indices:
                if p in pos_node:
                    raise ValueError(f"output index {io.name} on two nodes")
                pos_node[p] = node
    if len(pos_node) != d:
        raise ValueError("every output index must sit on exactly one node")
    vals, bonds_r = [], []
    for p in range(d):
        t = op_net.node_tensor(pos_node[p])
        phys = {indices_out[p], indices_in[p]}
        if indices_in[p] not in t.indices:
            raise ValueError(f"in/out index pair {p} split across nodes")
        side = [i for i in t.indices if i not in phys]
        if p == 0:
            if len(side) != 1:
                raise ValueError("first operator core must have 1 bond")
            order = [indices_out[p], indices_in[p], side[0]]
            bonds_r.append(side[0])
        else:
            left = bonds_r[-1]
            if left not in side:
                raise ValueError(f"nodes {p - 1} and {p} share no bond index")
            rest = [i for i in side if i != left]
            if p == d - 1:
                if rest:
                    raise ValueError("last operator core must have 1 bond")
                order = [left, indices_out[p], indices_in[p]]
            else:
                if len(rest) != 1:
                    raise ValueError(f"mid operator core {p} must have 2 bonds")
                order = [left, indices_out[p], indices_in[p], rest[0]]
                bonds_r.append(rest[0])
        perm = [t.indices.index(i) for i in order]
        vals.append(t.permute(perm).value)
    big = max(i.size for i in bonds_r)
    if dtype is None:
        dtype = vals[0].dtype
        for v in vals[1:]:
            dtype = torch.promote_types(dtype, v.dtype)

    def padded(v, pads):
        return F.pad(v.to(device=device, dtype=dtype), pads)

    first = padded(vals[0], (0, big - vals[0].shape[2]))
    mids = torch.stack(
        [
            padded(v, (0, big - v.shape[3], 0, 0, 0, 0, 0, big - v.shape[0]))
            for v in vals[1:-1]
        ]
    )
    last = padded(vals[-1], (0, 0, 0, 0, 0, big - vals[-1].shape[0]))
    return PackedTTOp(first.contiguous(), mids.contiguous(), last.contiguous())


def ttop_identity(
    d: int, n: int, dtype: torch.dtype = torch.float64, device=None
) -> PackedTTOp:
    """The rank-1 identity operator on d modes of size n, on ``device``
    (default: the card) -- the unit of :func:`ttop_compose` and the
    ``alpha I + ...`` building block of shifted systems.  The middle
    cores are materialized: no stride-0 view reaches a kernel or an
    in-place update."""
    if d < 3:
        raise ValueError("packed operators need d >= 3")
    eye = torch.eye(n, dtype=dtype, device=resolve_device(device))
    return PackedTTOp(
        eye[:, :, None].contiguous(),
        eye[None, None, :, :, None].expand(d - 2, 1, n, n, 1).contiguous(),
        eye[None].contiguous(),
    )


def ttop_scale(op: PackedTTOp, factor) -> PackedTTOp:
    """Scale the represented operator (folds into the first core)."""
    f = torch.as_tensor(factor, dtype=op.first.dtype, device=op.first.device)
    return PackedTTOp(op.first * f, op.mids, op.last)


def ttop_transpose(op: PackedTTOp) -> PackedTTOp:
    """The transposed operator (out/in physical axes swapped per core):
    ``ttop_apply_packed(ttop_transpose(A), x)`` applies ``A^T``."""
    return PackedTTOp(
        op.first.permute(1, 0, 2).contiguous(),
        op.mids.permute(0, 1, 3, 2, 4).contiguous(),
        op.last.permute(0, 2, 1).contiguous(),
    )


def ttop_compose(a: PackedTTOp, b: PackedTTOp) -> PackedTTOp:
    """The operator product ``A @ B`` (apply ``B`` first): per-core
    contraction over the shared physical index, bond ranks multiply.

    Follow with :func:`ttop_round` when composing chains -- the product
    rank ``R_A * R_B`` usually overshoots the exact rank.  Typical use:
    the SPD normal equations of a nonsymmetric system,
    ``ttop_compose(ttop_transpose(A), A)``.  No reference counterpart
    (``pytens`` applies operators to trains only,
    ``pytens/algs.py:2662``).
    """
    ra, rb = a.first.shape[-1], b.first.shape[-1]
    if (
        a.mids.shape[0] != b.mids.shape[0]
        or a.first.shape[1] != b.first.shape[0]
        or a.mids.shape[3] != b.mids.shape[2]
    ):
        raise ValueError(
            f"operator shape mismatch: {tuple(a.mids.shape)} vs "
            f"{tuple(b.mids.shape)}"
        )
    first = torch.einsum("imr,mjs->ijrs", a.first, b.first).reshape(
        a.first.shape[0], b.first.shape[1], ra * rb
    )
    dm = a.mids.shape[0]
    mids = torch.einsum("kaimt,kbmjs->kabijts", a.mids, b.mids).reshape(
        dm, ra * rb, a.mids.shape[2], b.mids.shape[3], ra * rb
    )
    last = torch.einsum("aim,bmj->abij", a.last, b.last).reshape(
        ra * rb, a.last.shape[1], b.last.shape[2]
    )
    return PackedTTOp(first.contiguous(), mids.contiguous(), last.contiguous())


def ttop_round(
    op: PackedTTOp, eps: float = 1e-12, reorth: bool = False
) -> PackedTTOp:
    """Compress a uniform TT-operator to its eps-accurate ranks.

    The (out, in) physical pair of every core is fused into one mode of
    size ``no * ni`` and the train runs through the fused Householder
    orthogonalize+truncate sweep (``ops.fast._tt_round_sweep``); the
    uniform packed layout is then sliced to the largest kept bond --
    smaller bonds keep zeroed (inert) directions.  Use after
    :func:`ttop_add` chains or operator-operator products whose
    block-diagonal ranks overshoot the exact ones.  ``eps`` is relative
    to the operator's Frobenius norm.  One host fetch (the kept ranks).
    No reference counterpart (``pytens`` rounds TT tensors only,
    ``pytens/algs.py:1841``).
    """
    dm = op.mids.shape[0]
    if dm < 1:
        raise ValueError("ttop_round needs d >= 3 cores")
    floor = sweep_noise_floor(op.first.dtype, dm + 2)
    if eps < floor:
        warnings.warn(
            f"ttop_round eps={eps:g} is below the {op.first.dtype} "
            f"sweep noise floor ({floor:.1e}): null directions may "
            "stay above budget and the operator may not compress; "
            "raise eps or round in float64",
            RuntimeWarning,
            stacklevel=2,
        )
    no, ni, big = op.first.shape
    f, m, l, ks = _tt_round_sweep(
        op.first.reshape(no * ni, big),
        op.mids.reshape(dm, big, no * ni, big),
        op.last.reshape(big, no * ni),
        eps,
        True,
        reorth,
    )
    r_new = int(ks.max())
    return PackedTTOp(
        f[:, :r_new].reshape(no, ni, r_new).contiguous(),
        m[:, :r_new, :, :r_new].reshape(dm, r_new, no, ni, r_new).contiguous(),
        l[:r_new, :].reshape(r_new, no, ni).contiguous(),
    )


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
    n = first.shape[0] if mids is None else mids.shape[2]
    return clamp_modes(idx, first.shape[0], n, last.shape[1])


def _eval_routed(first, mids, last, idx, precision: str) -> torch.Tensor:
    """Clamp at this public boundary, then route by device.

    The clamp gives every route the semantics of the JAX package's XLA
    gather (and of ``TensorNetwork.evaluate``); without it the kernel
    would read out of bounds.
    """
    idx = _clamp_idx(first, mids, last, idx)
    return tt_evaluate(first, mids, last, idx, precision=precision)


def ttop_apply_packed(op: PackedTTOp, x: PackedTT) -> PackedTT:
    """Apply a uniform TT-operator; bond ranks multiply (r * R).

    One batched einsum per core kind, the middle cores all at once over
    the stacked mids.  Every fused bond uses the same (x-rank major,
    op-rank minor) layout on both sides of each core -- mixing the
    orders corrupts any operator with R > 1.
    """
    # first: (no, ni, R) x (ni, r) -> (no, r*R)
    first = torch.einsum("oik,il->olk", op.first, x.first)
    first = first.reshape(first.shape[0], -1)
    # mids: (k, R, no, ni, R) x (k, r, ni, r) -> (k, r*R, no, r*R)
    mids = torch.einsum("kaoib,kmir->kmaorb", op.mids, x.mids)
    k, m, a, no, r2, b = mids.shape
    mids = mids.reshape(k, m * a, no, r2 * b)
    # last: (R, no, ni) x (r, ni) -> (r*R, no)
    last = torch.einsum("aoi,mi->mao", op.last, x.last)
    last = last.reshape(-1, last.shape[2])
    return PackedTT(first.contiguous(), mids.contiguous(), last.contiguous())


def rand_round(x: PackedTT, target: int, generator: torch.Generator) -> PackedTT:
    """Round to fixed target ranks with Gaussian TT sketching (static
    shapes; the cheapest rank-control primitive, no host sync).

    Draws the sketch -- first (n, t), mids (d-2, t, n, t), last (t, n),
    scaled by ``1/sqrt`` of each core's (n t) or (n t t) as the JAX
    package does -- from ``generator`` on the train's device (the JAX
    package takes a key), then runs :func:`rand_round_sketched`.
    """
    d_mid, _, n, _ = x.mids.shape
    opts = dict(generator=generator, dtype=x.first.dtype, device=x.first.device)
    s_first = torch.randn((n, target), **opts) / math.sqrt(n * target)
    s_mids = torch.randn((d_mid, target, n, target), **opts) / math.sqrt(
        n * target * target
    )
    s_last = torch.randn((target, n), **opts) / math.sqrt(n * target)
    return rand_round_sketched(x, s_first, s_mids, s_last)


def rand_round_sketched(
    x: PackedTT, s_first: torch.Tensor, s_mids: torch.Tensor, s_last: torch.Tensor
) -> PackedTT:
    """Randomize-then-orthogonalize rounding against a given sketch
    train (first (n, t), mids (d-2, t, n, t), last (t, n)); the target
    rank t is the sketch's.

    Right-to-left partial contractions W_k (r, t) of the train against
    the sketch, then a left-to-right sweep that orthogonalizes
    ``Z_k W_k`` and carries ``Q^T Z_k`` on.  Each W_k is scaled by a
    power of two: only its column space enters Q, so the scaling is
    exact, and unscaled it shrinks by about ``1/sqrt(n t)`` a core and
    underflows float32 on long trains (as ``ops/randomized.py``'s
    interfaces did).  A first core with fewer modes than t gives a
    (n, n) Q, zero-padded to t columns.
    """
    target = s_first.shape[1]
    w_last = _pow2_scaled(x.last @ s_last.T)  # (r, t)
    ws = [None] * x.mids.shape[0]
    w = w_last
    for k in range(x.mids.shape[0] - 1, -1, -1):
        xc, sc = x.mids[k], s_mids[k]  # (r, n, r), (t, n, t)
        tmp = (xc.reshape(-1, xc.shape[-1]) @ w).reshape(xc.shape[0], -1)
        w = _pow2_scaled(tmp @ sc.reshape(sc.shape[0], -1).T)  # (r, t)
        ws[k] = w
    # ws[k] pairs with the bond left of middle core k; the last bond
    # takes w_last

    z = x.first  # (n, r)
    q, _ = torch.linalg.qr(z @ ws[0])  # (n, t) -> (n, min(n, t))
    if q.shape[1] < target:  # n < target
        q = F.pad(q, (0, target - q.shape[1]))
    first_out = q
    m = q.T @ z  # (t, r)
    mids_out = []
    for xc, w in zip(x.mids, ws[1:] + [w_last]):
        z = torch.einsum("ta,anb->tnb", m, xc)  # (t, n, r)
        q, _ = torch.linalg.qr(z.reshape(-1, z.shape[-1]) @ w)  # (t n, t)
        mids_out.append(q.reshape(z.shape[0], z.shape[1], -1))
        m = q.T @ z.reshape(-1, z.shape[-1])  # (t, r)
    return PackedTT(
        first_out.contiguous(), torch.stack(mids_out), (m @ x.last).contiguous()
    )


def _svd_sweep(x: PackedTT, eps: float) -> List[torch.Tensor]:
    """Right-orthogonalize, then truncate left to right by SVD: the JAX
    package's ``_tt_round_sweep_fn(True)``, with every bond cut to the
    rank it holds instead of kept at the train's rank with zeroed
    directions.

    The backward QRs are reduced, so a bond carries at most
    ``min(n * r_right, r)`` directions; the forward SVDs keep the
    directions above the relative budget ``eps |x| / sqrt(d - 1)`` (the
    TT-SVD tail rule, at least one) and carry only those on.  The
    represented tensor and every bond's singular values are the masked
    sweep's; the SVDs are of the kept ranks, not of (r, r) -- a sum of
    k rank-r Krylov vectors is rank k r, and the masked sweep's cuSOLVER
    SVDs of that size took 5.2 s a round at rank 512 on an H100 (this
    sweep: 40 ms; ``chip_smoke.py`` phase 7).  One host read of the kept
    rank per bond (beside each SVD's own).  Returns the cores: first (n, k0),
    mids (k, n, k'), last (k, n).
    """
    d = x.d
    q, rmat = torch.linalg.qr(x.last.T)  # (nl, m), (m, r)
    right = [q.T]
    carry = rmat.T  # (r, m)
    for core in reversed(x.mids):
        cur = torch.einsum("rnk,kc->rnc", core, carry)  # (r, n, m)
        q, rmat = torch.linalg.qr(cur.reshape(core.shape[0], -1).T)
        right.append(q.T.reshape(-1, core.shape[1], carry.shape[1]))
        carry = rmat.T
    right.reverse()
    first_c = x.first @ carry
    budget = eps * torch.linalg.norm(first_c) / math.sqrt(d - 1.0)

    u, s, vt = torch.linalg.svd(first_c, full_matrices=False)
    k = int(_trunc_count(s, budget))
    out = [u[:, :k]]
    carry = s[:k, None] * vt[:k]
    for core in right[:-1]:
        cur = torch.einsum("ak,knc->anc", carry, core)  # (k, n, m)
        a, n, m = cur.shape
        q, rmat = torch.linalg.qr(cur.reshape(a * n, m))
        u, s, vt = torch.linalg.svd(rmat, full_matrices=False)
        k = int(_trunc_count(s, budget))
        out.append((q @ u[:, :k]).reshape(a, n, k))
        carry = s[:k, None] * vt[:k]
    out.append(carry @ right[-1])
    return out


def svd_round(x: PackedTT, target: int, eps: float = 1e-7) -> PackedTT:
    """Round to a fixed target rank through the exact SVD sweep.

    Runs the orthogonalize+truncate sweep (:func:`_svd_sweep`) and keeps
    the top ``target`` directions of every bond, zero-padding bonds that
    hold fewer -- a true best-rank-``target`` truncation, with noise at
    the dtype roundoff level instead of the sketch-conditioning level of
    :func:`rand_round`; use this when accuracy sets the floor (e.g. the
    GMRES Krylov recurrence in f32).
    """
    t = target
    first, *mids, last = _svd_sweep(x, eps)

    def grow(k):  # zero directions that bring a bond of k (<= t) up to t
        return t - min(k, t)

    return PackedTT(
        F.pad(first[:, :t], (0, grow(first.shape[1]))),
        torch.stack([
            F.pad(c[:t, :, :t], (0, grow(c.shape[2]), 0, 0, 0, grow(c.shape[0])))
            for c in mids
        ]),
        F.pad(last[:t], (0, 0, 0, grow(last.shape[0]))),
    )


class _Split:
    """Where a solve's time goes, by part: each :meth:`mark` charges the
    span since the previous mark to its part.  On the card the spans are
    between CUDA events on the current stream (the device's timeline,
    idle waits for the host included), read once after the solve's last
    host sync; on the CPU the host clock."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks = []
        self.mark(None)

    def mark(self, part: Optional[str]) -> None:
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
        else:
            e = time.perf_counter()
        self.marks.append((part, e))

    def seconds(self) -> dict:
        out = {}
        for (_, a), (part, b) in zip(self.marks, self.marks[1:]):
            dt = a.elapsed_time(b) / 1e3 if self.cuda else b - a
            out[part] = out.get(part, 0.0) + dt
        return out


def _gmres_at_rank(
    op: PackedTTOp,
    rhs: PackedTT,
    x0: PackedTT,
    eps: float,
    rank: int,
    maxiter: int,
    generator: torch.Generator,
    round_method: str,
    split: _Split,
) -> Tuple[PackedTT, float, int]:
    """One GMRES cycle with all Krylov vectors rounded to ``rank``;
    returns (x, the residual norm, iterations).

    Every iteration reuses the same shapes; the tiny Hessenberg
    least-squares solve stays in NumPy on the host.  ``split`` is
    charged by part: apply, round, coeffs (the CGS2 coefficient blocks:
    the H1 inner products and their one fetch), norm_exact, lstsq.
    """

    def rounded(t):
        out = svd_round(t, rank) if round_method == "svd" else rand_round(
            t, rank, generator
        )
        split.mark("round")
        return out

    def op_round(v):
        w = ttop_apply_packed(op, v)
        split.mark("apply")
        return rounded(w)

    r0 = rounded(add(rhs, scale(op_round(x0), -1.0)))
    beta = float(norm_exact(r0))
    split.mark("norm_exact")
    if beta == 0.0:
        return x0, 0.0, 0
    v = [scale(r0, 1.0 / beta)]

    h = np.zeros((1, 0))
    y: List[np.ndarray] = []
    iterations = 0
    for jj in range(maxiter):
        iterations += 1
        w = op_round(v[-1])

        h_new = np.zeros((jj + 2, jj + 1))
        h_new[: h.shape[0], : h.shape[1]] = h
        h = h_new

        # CGS2 ("twice is enough"): one block projection pass, round,
        # then a correction pass -- restores f32 basis orthogonality that
        # single-pass classical Gram-Schmidt loses
        for _ in range(2):
            # ONE host fetch for the whole coefficient block
            coeffs = torch.stack(
                [inner(w, v[ii]) for ii in range(jj + 1)]
            ).tolist()
            split.mark("coeffs")
            for ii, c in enumerate(coeffs):
                h[ii, jj] += c
            w = rounded(
                add(w, *[scale(v[ii], -c) for ii, c in enumerate(coeffs)])
            )

        h[jj + 1, jj] = float(norm_exact(w))
        split.mark("norm_exact")

        e = np.zeros(h.shape[0])
        e[0] = beta
        yy, resid, _, _ = np.linalg.lstsq(h, e, rcond=None)
        y.append(yy)
        split.mark("lstsq")
        done = resid.size > 0 and float(np.sqrt(resid[0])) < eps
        if done or h[jj + 1, jj] <= 1e-14 * beta:
            break
        v.append(scale(w, 1.0 / h[jj + 1, jj]))

    x = rounded(add(x0, *[scale(vv, float(c)) for vv, c in zip(v, y[-1])]))
    res = add(rhs, scale(ttop_apply_packed(op, x), -1.0))
    split.mark("apply")
    resid = float(norm_exact(res))
    split.mark("norm_exact")
    return x, resid, iterations


def gmres_packed(
    op: PackedTTOp,
    rhs: PackedTT,
    x0: PackedTT,
    eps: float = 1e-5,
    rank: Optional[int] = None,
    maxiter: int = 30,
    seed: int = 0,
    max_rank: Optional[int] = None,
    round_method: str = "svd",
) -> Tuple[PackedTT, float]:
    """TT-GMRES on packed trains; returns (x, the residual norm).

    Rank control rounds every Krylov vector to a fixed rank
    (``round_method="svd"``: :func:`svd_round`; anything else:
    :func:`rand_round`, drawing from a generator on ``x0``'s device
    seeded with ``seed``).  The rank ceiling is what limits the
    reachable residual: when a cycle stalls above ``eps``, the solver
    restarts warm from the current iterate with the rank doubled, up to
    ``max_rank`` (default ``8 x`` the starting rank).  Each iteration
    fetches one block of CGS2 coefficients per pass (H1 inner products
    on the card) and one ``norm_exact``.

    After each call, ``gmres_packed.last_stats`` holds ``cycles`` (one
    dict per cycle: rank, iterations, residual) and ``seconds`` by part
    (see :class:`_Split`).
    """
    generator = torch.Generator(device=x0.first.device).manual_seed(seed)
    rank = int(rank) if rank is not None else 2 * x0.rank
    ceiling = int(max_rank) if max_rank is not None else 8 * rank
    split = _Split(x0.first.device)
    cycles = []
    x = x0
    while True:
        x, resid, its = _gmres_at_rank(
            op, rhs, x, eps, rank, maxiter, generator, round_method, split
        )
        cycles.append({"rank": rank, "iterations": its, "resid": resid})
        if resid < eps or rank >= ceiling:
            gmres_packed.last_stats = {"cycles": cycles, "seconds": split.seconds()}
            return x, resid
        rank = min(2 * rank, ceiling)


gmres_packed.last_stats = {"cycles": [], "seconds": {}}
