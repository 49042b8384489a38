"""Fused fixed-shape TT operations for uniform trains.

Counterpart of ``tensor_networks_tpu/ops/fast.py`` (the subset the main
path needs).  When a train is *uniform* (all middle cores share
(r, n, r)) the hot operations run as single sweeps over stacked cores:

* :func:`tt_inner_fast` -- the O(d n r^3) inner-product zipper, through
  the H1 kernel for CUDA tensors (:mod:`..kernels.zipper`);
* :func:`tt_round_fixed` -- orthogonalization + truncation sweep with
  static shapes (truncated directions are zero-masked on the device; the
  kept ranks are fetched once at the end and the bonds compacted).
"""

from __future__ import annotations

import warnings
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from tensor_networks_tpu_torch.kernels.zipper import tt_inner, tt_inner_plain
from tensor_networks_tpu_torch.network import TensorNetwork


def stack_tt_cores(
    tn: TensorNetwork,
) -> Tuple[torch.Tensor, Optional[torch.Tensor], torch.Tensor]:
    """Extract (first, stacked middles, last) from a uniform TT.

    ``first`` is (n, r), ``mids`` is (d-2, r, n, r) or None when d == 2,
    ``last`` is (r, n).  Raises ValueError if the train is not uniform.
    """
    nodes = list(tn.network.nodes)
    # insertion order must BE chain order: consecutive cores share a
    # bond index.  A shuffled uniform train would pass the shape check
    # and stack silently wrong -- raise so callers take the
    # order-discovering padded path (:func:`_chain_padded`) instead.
    tensors = [tn.node_tensor(n) for n in nodes]
    for a, b in zip(tensors, tensors[1:]):
        if len(set(a.indices) & set(b.indices)) != 1:
            raise ValueError(
                "node insertion order is not chain order (consecutive "
                "cores share no unique bond)"
            )
    first = tn.value(nodes[0])
    last = tn.value(nodes[-1])
    mids = [tn.value(n) for n in nodes[1:-1]]
    if mids:
        shapes = {tuple(m.shape) for m in mids}
        if len(shapes) != 1:
            raise ValueError(f"non-uniform TT cores: {sorted(shapes)}")
        return first, torch.stack(mids), last
    return first, None, last


def _chain_padded(tn: TensorNetwork):
    """Canonicalize + zero-pad ANY linear chain for the fused sweeps.

    ``chain_cores`` handles arbitrary node layouts (axes are permuted
    into (left bond, mode, right bond) from the index metadata); ragged
    bond ranks pad to the largest rank, rounded up to a power of two
    (>= 8) as in the JAX package so kept ranks match it, and mixed mode
    sizes to the largest mode.  Zero padding is numerically inert.

    Returns ``(first, mids, last, emit)`` where ``emit`` carries what
    :func:`tt_round_fixed` needs to write results back into the
    original layout: ``(order, true core shapes, perms)``.  None when
    the network is not a chain of >= 3 single-free-index cores.
    """
    from tensor_networks_tpu_torch.ops.packed import chain_cores

    extracted = chain_cores(tn)
    if extracted is None:
        return None
    order, cores, frees, perms = extracted
    nmax = max(f.size for f in frees)
    rmax = max(
        [c.shape[-1] for c in cores[:-1]]
        + [c.shape[0] for c in cores[1:]]
    )
    rmax = max(8, 1 << (rmax - 1).bit_length())
    first = F.pad(
        cores[0],
        (0, rmax - cores[0].shape[1], 0, nmax - cores[0].shape[0]),
    )
    mids = torch.stack(
        [
            F.pad(
                c,
                (
                    0, rmax - c.shape[2],
                    0, nmax - c.shape[1],
                    0, rmax - c.shape[0],
                ),
            )
            for c in cores[1:-1]
        ]
    )
    last = F.pad(
        cores[-1],
        (0, nmax - cores[-1].shape[1], 0, rmax - cores[-1].shape[0]),
    )
    shapes = [tuple(c.shape) for c in cores]
    return first, mids, last, (order, shapes, perms)


def _bond_bounds(modes, bonds, r_pad: int) -> np.ndarray:
    """Static per-bond structural rank bounds of a (possibly padded) chain.

    ``bound_k = min(prod of true modes left of bond k, prod of true
    modes right of it, true bond dim)`` -- the rank the exact bond
    matricization cannot exceed (reference semantics
    ``pytens/utils.py:74-84``).  Products are capped at ``r_pad``.
    """
    nb = len(bonds)
    left = []
    p = 1
    for k in range(nb):
        p = min(p * int(modes[k]), r_pad)
        left.append(p)
    right = [0] * nb
    p = 1
    for k in range(nb - 1, -1, -1):
        p = min(p * int(modes[k + 1]), r_pad)
        right[k] = p
    return np.asarray(
        [
            min(left[k], right[k], int(bonds[k]), r_pad)
            for k in range(nb)
        ],
        np.int32,
    )


def tt_inner_fn(has_mids: bool, precision: str = "highest"):
    """The plain zipper as a function of the six packed cores (the JAX
    package's factory of the same name; here nothing is compiled).

    W_0 = A_0^T B_0;  W_k = sum_n A_k(n)^T W_{k-1} B_k(n);
    result = <W_{d-2}, A_last B_last^T>.  Every ``precision`` computes in
    full precision.
    """

    def inner(first_a, mids_a, last_a, first_b, mids_b, last_b):
        if not has_mids:
            mids_a = mids_b = None
        return tt_inner_plain(first_a, mids_a, last_a, first_b, mids_b, last_b)

    return inner


def tt_inner_fast(
    a: TensorNetwork, b: TensorNetwork, precision: str = "highest"
) -> torch.Tensor:
    """Inner product of two uniform TTs through the fused zipper.

    CUDA cores go through the H1 kernel, CPU cores through the plain
    zipper.  Non-uniform trains use the generic graph contraction.
    """
    try:
        fa, ma, la = stack_tt_cores(a)
        fb, mb, lb = stack_tt_cores(b)
    except ValueError:
        return a.inner(b)
    if (ma is None) != (mb is None):
        return a.inner(b)
    return tt_inner(
        *(x.contiguous() if x is not None else None
          for x in (fa, ma, la, fb, mb, lb)),
        precision=precision,
    )


#: how many times each rounding sweep ran (bench and tests read this)
ROUND_STATS = {"svd": 0}


def _trunc_count(s: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """Kept rank under the TT-SVD tail rule, computed on the device."""
    tail = torch.cumsum(torch.flip(s, [0]) ** 2, 0)
    drop = torch.sum(tail <= delta**2)
    return torch.clamp(s.shape[0] - drop, min=1)


def _qr(mat: torch.Tensor, reorth: bool):
    """Reduced QR; ``reorth`` runs it twice (QR-twice, the CGS2
    analogue) to restore null directions to the eps level."""
    q, rmat = torch.linalg.qr(mat)
    if reorth:
        q, r2 = torch.linalg.qr(q)
        rmat = r2 @ rmat
    return q, rmat


def _tt_round_sweep(first, mids, last, eps: float, relative: bool, reorth: bool):
    """Fused right-orthogonalization + forward truncation sweep (the JAX
    package's ``_tt_round_sweep_fn``).

    Static shapes throughout: instead of shrinking bonds, truncated
    directions are zeroed (same represented tensor as hard truncation);
    the kept ranks come back as one device tensor.
    """
    d = mids.shape[0] + 2
    r = last.shape[0]

    # ---- backward sweep: right-orthogonalize cores d-1 .. 1 ----------
    # rank-deficient bonds (n < r) are zero-padded so every step carries
    # a full (r, r) state; the zero directions are inert.
    ql, rl = _qr(last.T, reorth)
    if ql.shape[1] < r:
        ql = F.pad(ql, (0, r - ql.shape[1]))
        rl = F.pad(rl, (0, 0, 0, r - rl.shape[0]))
    last_q = ql.T  # (r, n), orthonormal (or zero) rows
    carry = rl.T
    mids_q = [None] * mids.shape[0]
    for k in range(mids.shape[0] - 1, -1, -1):
        rr, n, rc = mids[k].shape
        cur = torch.einsum("rnk,kc->rnc", mids[k], carry)
        q, rmat = _qr(cur.reshape(rr, n * rc).T, reorth)
        carry = rmat.T
        mids_q[k] = q.T.reshape(rr, n, rc)
    first_c = first @ carry  # (n, r)

    # ---- forward sweep: masked truncated SVD -------------------------
    norm = torch.linalg.norm(first_c)
    eps_t = torch.as_tensor(eps, dtype=first.dtype, device=first.device)
    budget = (eps_t * norm if relative else eps_t) / float(np.sqrt(d - 1.0))

    u, s, vt = torch.linalg.svd(first_c, full_matrices=False)
    if s.shape[0] < r:
        pad = r - s.shape[0]
        u = F.pad(u, (0, pad))
        s = F.pad(s, (0, pad))
        vt = F.pad(vt, (0, 0, 0, pad))
    ar = torch.arange(r, device=first.device)
    k0 = _trunc_count(s, budget)
    mask = (ar < k0).to(s.dtype)
    first_out = u * mask[None, :]
    carry_sv = (mask * s)[:, None] * vt

    mids_out, ranks = [], [k0]
    for core in mids_q:
        rr, n, rc = core.shape
        cur = torch.einsum("ak,knc->anc", carry_sv, core)
        # tall SVD via QR + small SVD: same factors, far cheaper than the
        # SVD of the (r*n, r) unfolding
        q, rmat = _qr(cur.reshape(rr * n, rc), reorth)
        u_s, s, vt = torch.linalg.svd(rmat, full_matrices=False)
        k = _trunc_count(s, budget)
        m = (ar[: s.shape[0]] < k).to(s.dtype)
        mids_out.append((q @ (u_s * m[None, :])).reshape(rr, n, -1))
        ranks.append(k)
        carry_sv = (m * s)[:, None] * vt
    last_out = carry_sv @ last_q
    return first_out, torch.stack(mids_out), last_out, torch.stack(ranks)


def sweep_noise_floor(dtype: torch.dtype, d: int) -> float:
    """Relative noise floor of a d-core chained-QR sweep.

    Null-direction singular values come out at roughly this fraction of
    the train norm (the JAX package's conservative estimate); truncation
    budgets below it may not engage.
    """
    return 10.0 * float(torch.finfo(dtype).eps) * float(np.sqrt(d))


def tt_round_fixed(
    tn: TensorNetwork,
    eps: float,
    relative: bool = True,
    method: str = "svd",
    reorth: bool = False,
) -> Tuple[TensorNetwork, List[int]]:
    """Round a TT chain with the fused static-shape sweep.

    ``method="svd"`` is the Householder-QR sweep (the JAX package's
    default); ``reorth`` orthogonalizes twice per bond for tight budgets
    near the dtype noise floor.  Returns the rounded network (bonds
    compacted to the discovered ranks) and the kept rank per bond.

    Any linear chain qualifies: ragged bond ranks, mixed mode sizes, and
    non-canonical core layouts are zero-padded into the uniform sweep
    (:func:`_chain_padded`) and sliced/un-permuted on emit; non-chain
    topologies raise.  The other JAX methods (``gram``, ``cholqr2``,
    ``twosided``, ``prefix``) are not ported yet.
    """
    if method != "svd":
        raise NotImplementedError(
            f"tt_round_fixed(method={method!r}) is not ported yet "
            "(ROADMAP, port queue: the other tt_round_fixed methods)"
        )
    emit = None
    try:
        first, mids, last = stack_tt_cores(tn)
    except ValueError:
        packed = _chain_padded(tn)
        if packed is None:
            raise
        first, mids, last, emit = packed
    if mids is None:
        raise ValueError("tt_round_fixed needs d >= 3")

    d = mids.shape[0] + 2
    floor = sweep_noise_floor(first.dtype, d) / (2.0 if reorth else 1.0)
    if relative and eps < floor:
        warnings.warn(
            f"requested relative eps={eps:.1e} is below the ~{floor:.1e} "
            f"noise floor of a {d}-core {first.dtype} svd rounding sweep; "
            "truncation may not engage.  Use float64 or reorth=True.",
            RuntimeWarning,
            stacklevel=2,
        )

    f, m, l, ks = _tt_round_sweep(first, mids, last, eps, relative, reorth)
    ROUND_STATS["svd"] += 1
    ranks = [int(x) for x in ks.tolist()]  # the sweep's one host fetch
    return emit_chain(tn, f, m, l, ranks, emit)


def emit_chain(tn, first_out, mids_out, last_out, ranks, emit=None):
    """Write swept cores back into a copy of ``tn``: slice the kept
    ranks (and, for padded entries, the true modes) and un-permute into
    each node's original axis layout."""
    out = tn.__deepcopy__({})
    if emit is not None:
        order, shapes, perms = emit

        def put(node, core, perm):
            inv = tuple(int(a) for a in np.argsort(perm))
            out.node_tensor(node).update_val_size(core.permute(inv))

        put(order[0], first_out[: shapes[0][0], : ranks[0]], perms[0])
        for k in range(1, len(order) - 1):
            put(
                order[k],
                mids_out[k - 1][
                    : ranks[k - 1], : shapes[k][1], : ranks[k]
                ],
                perms[k],
            )
        put(order[-1], last_out[: ranks[-1], : shapes[-1][1]], perms[-1])
        return out, ranks
    nodes = list(tn.network.nodes)
    out.node_tensor(nodes[0]).update_val_size(first_out[:, : ranks[0]])
    for i, node in enumerate(nodes[1:-1]):
        out.node_tensor(node).update_val_size(
            mids_out[i][: ranks[i], :, : ranks[i + 1]]
        )
    out.node_tensor(nodes[-1]).update_val_size(last_out[: ranks[-1], :])
    return out, ranks
