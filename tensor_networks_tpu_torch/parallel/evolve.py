"""Train-sharded time integration: the core-local operator algebra, one-
and two-site TDVP, and the theta method on the train-sharded ALS solver.

Counterpart of ``tensor_networks_tpu/parallel/evolve.py``.  The middle
cores of the state, the operator and every environment chain are split
along the train (block p on model rank p, :func:`place_tdvp_sharded`);
the boundary cores are whole on every rank.  A step runs the scan bodies
of the port's fused step (``ops/evolve._tdvp_fwd_body_of`` and the rest)
on each rank's block through :func:`sweeps._staged_sweep`: a rank
computes only its own stage and the carry -- an ``(r, s, r)`` env and an
``(r, r)`` bond factor, or the evolved working core of the two-site
sweep -- hops to its neighbour.  The boundary cores are evolved on every
rank from carries broadcast from the stage that produced them.  Per-rank
memory scales as ``1/P``; the wall is that of one sequential sweep.

Operators are passed whole (the same on every rank; they are small); a
state is passed whole or as this rank's block, as a solver returns it,
and every result holds this rank's block of the middle cores.  The
squaring count of the local exponentials comes from a distributed bound
on ``|A|_2`` that every rank reads alike.  :func:`evolve_theta_sharded`
keeps its right-hand side exact (the JAX module note at
``parallel/evolve.py:281-291``): its rank is the step operator's times
the state's, and it is not rounded back to the iterate's rank as the
single-device ``evolve_theta`` rounds it.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh

from tensor_networks_tpu_torch.ops.als import _columns
from tensor_networks_tpu_torch.ops.evolve import (
    _adv_left,
    _adv_right,
    _bond_evolve,
    _merge2,
    _ones3,
    _site_evolve,
    _split_left,
    _split_right,
    _split_theta,
    _squarings_for,
    _step_size,
    _tdvp2_bwd_body_of,
    _tdvp2_fwd_body_of,
    _tdvp_bwd_body_of,
    _tdvp_fwd_body_of,
    _tdvp_renv_body,
    _theta_evolve,
)
from tensor_networks_tpu_torch.ops.packed import PackedTT, PackedTTOp, pad_rank
from tensor_networks_tpu_torch.parallel import mesh as pm
from tensor_networks_tpu_torch.parallel.sweeps import (
    _agree,
    _block,
    _model,
    _norm_sharded,
    _place,
    _replicate_all,
    _replicate_from,
    _staged_sweep,
    tt_right_orth_sharded,
)

__all__ = [
    "add_sharded",
    "evolve_tdvp2_sharded",
    "evolve_tdvp_sharded",
    "evolve_theta_sharded",
    "place_tdvp_sharded",
    "tdvp_step_sharded",
    "ttop_apply_sharded",
]


# -- placement and the core-local algebra ----------------------------------------


def _block_train(mesh: DeviceMesh, t: PackedTT, count: int) -> PackedTT:
    """A train with this rank's block of its ``count`` middle cores (it
    holds all of them, or the block already), every core on the rank's
    device."""
    dev = pm.mesh_device(mesh)
    return PackedTT(t.first.to(dev), _block(mesh, t.mids, count), t.last.to(dev))


def _block_op(mesh: DeviceMesh, op: PackedTTOp) -> PackedTTOp:
    """A whole operator with this rank's block of its middle cores."""
    dev = pm.mesh_device(mesh)
    return PackedTTOp(op.first.to(dev), _block(mesh, op.mids, op.mids.shape[0]),
                      op.last.to(dev))


def place_tdvp_sharded(mesh: DeviceMesh, X, Am):
    """This rank's blocks of the state's and the operator's middle-core
    stacks (``tensor_networks_tpu/parallel/evolve.py:225``).  Takes the
    global stacks, the same on every rank."""
    return _place(mesh, X, Am)


def ttop_apply_sharded(mesh: DeviceMesh, op: PackedTTOp, x: PackedTT) -> PackedTT:
    """Apply a uniform TT-operator to a train-sharded train: one batched
    einsum over this rank's block, the fused bonds in
    ``ttop_apply_packed``'s (x-rank major, op-rank minor) layout
    (``tensor_networks_tpu/parallel/evolve.py:294``).  ``x`` is this
    rank's block; ``op`` whole or its block at the same positions."""
    dtp = x.first.dtype
    om = _block(mesh, op.mids, pm.axis_size(mesh, "model") * x.mids.shape[0]).to(dtp)
    first = torch.einsum("oik,il->olk", op.first.to(x.first.device, dtp), x.first)
    first = first.reshape(first.shape[0], -1)
    out = torch.einsum("kaoib,kmir->kmaorb", om, x.mids)
    k, r1, s1, no, r2, s2 = out.shape
    mids = out.reshape(k, r1 * s1, no, r2 * s2)
    last = torch.einsum("aoi,mi->mao", op.last.to(x.last.device, dtp), x.last)
    last = last.reshape(-1, last.shape[2])
    return PackedTT(first.contiguous(), mids.contiguous(), last.contiguous())


def add_sharded(mesh: DeviceMesh, a: PackedTT, b: PackedTT) -> PackedTT:
    """Exact direct sum (bond ranks add) of two trains' blocks at the same
    positions, by concatenation (``tensor_networks_tpu/parallel/evolve.py:319``):
    the values of ``packed.add``'s block-diagonal embedding."""
    dtp = a.first.dtype
    m, ra, n, _ = a.mids.shape
    if b.mids.shape[0] != m:
        raise ValueError(f"blocks of {m} and {b.mids.shape[0]} middle cores")
    rb = b.rank
    bm = b.mids.to(dtp)
    top = torch.cat([a.mids, a.mids.new_zeros((m, ra, n, rb))], dim=3)
    bot = torch.cat([bm.new_zeros((m, rb, n, ra)), bm], dim=3)
    return PackedTT(torch.cat([a.first, b.first.to(dtp)], dim=1),
                    torch.cat([top, bot], dim=1),
                    torch.cat([a.last, b.last.to(dtp)], dim=0))


def _rows_step(c, x):
    """One step of the induced-norm chain: the row vector times a core's
    matrix of entrywise maxima."""
    return (c[0] @ x[0],), None


def _op_norm_bound_sharded(mesh: DeviceMesh, first, mids, last) -> float:
    """``ops/evolve._op_norm_bound`` of an operator whose middle cores are
    this rank's block: the Frobenius norm by the distributed
    orthogonalization sweep, the induced norms by staged row-vector
    chains.  One host read; the same value on every rank."""
    parts = pm.axis_size(mesh, "model")
    with torch.no_grad():
        first, mids, last = (t.detach() for t in (first, mids, last))
        no, ni, R = first.shape
        fro = _norm_sharded(mesh, first.reshape(no * ni, R),
                            mids.reshape(mids.shape[0], R, no * ni, R),
                            last.reshape(R, no * ni))
        first, mids, last = first.abs(), mids.abs(), last.abs()

        def induced(axis):  # 1: row sums (|A|_inf), 0: column sums (|A|_1)
            [(_, (v,), _)] = _staged_sweep(mesh, [(False, (first.sum(axis).amax(0),),
                                                   (mids.sum(axis + 2).amax(2),), _rows_step)])
            return _replicate_from(v, mesh, parts - 1) @ last.sum(axis + 1).amax(1)

        return _agree(mesh, torch.minimum(fro, torch.sqrt(induced(1) * induced(0))))


def _canonical(mesh: DeviceMesh, first, X, last):
    """Right-canonicalize a train-sharded state, the R factors absorbed
    into the first core as ``ops/als._canonicalize`` absorbs them: the
    stacked layout ``(x0 (1, n, r), X, xl (r, n, 1))``."""
    carry, X, last_q = tt_right_orth_sharded(mesh, X, last)
    return torch.einsum("anb,cb->anc", first[None], carry.T), X, last_q[..., None]


# -- one-site TDVP ------------------------------------------------------------------


def _single(body):
    """A scan body whose carry is one tensor, on a one-tuple carry."""

    def wrapped(c, x):
        nc, y = body(c[0], x)
        return (nc,), y

    return wrapped


def _tdvp_step_blocks(mesh, x0, X, xl, a0, Am, al, h, dense_limit, kdim, squarings):
    """``ops/evolve._tdvp_step_impl`` on this rank's block: the same calls
    on the same operands, the mid-core scans staged over the ranks."""
    _, parts, _ = _model(mesh)
    one3 = _ones3(x0)
    lo, hi = -0.5 * h, 0.5 * h
    knobs = (dense_limit, kdim, squarings)

    [(_, front, rs)] = _staged_sweep(
        mesh, [(True, (_adv_right(one3, xl, al),), (X, Am), _single(_tdvp_renv_body))])
    (r_front,) = _replicate_all(front, mesh, 0)

    z = _site_evolve(one3, a0, r_front, x0, lo, *knobs)
    x0q, smat = _split_left(z)
    lenv = _adv_left(one3, x0q, a0)
    smat = _bond_evolve(lenv, r_front, smat, hi, *knobs)
    [(_, back, ys)] = _staged_sweep(
        mesh, [(False, (lenv, smat), (X, Am, rs), _tdvp_fwd_body_of(h, *knobs))])
    Q, ls = _columns(ys)
    l_back, smat = _replicate_all(back, mesh, parts - 1)

    zl = torch.einsum("ab,bnc->anc", smat, xl)
    zl = _site_evolve(l_back, al, one3, zl, lo, *knobs)
    zl = _site_evolve(l_back, al, one3, zl, lo, *knobs)
    xlq, smat = _split_right(zl)
    renv = _adv_right(one3, xlq, al)
    smat = _bond_evolve(l_back, renv, smat, hi, *knobs)
    [(_, front, V)] = _staged_sweep(
        mesh, [(True, (renv, smat), (Q, Am, ls), _tdvp_bwd_body_of(h, *knobs))])
    r_back, smat = _replicate_all(front, mesh, 0)

    z0 = torch.einsum("anb,bc->anc", x0q, smat)
    z0 = _site_evolve(one3, a0, r_back, z0, lo, *knobs)
    return z0, torch.stack(V), xlq


def tdvp_step_sharded(mesh: DeviceMesh, x0, X, xl, a0, Am, al, h,
                      dense_limit: int = 1024, kdim: int = 24, squarings: int = None):
    """One symmetric one-site TDVP step on the stacked layout
    (``tensor_networks_tpu/parallel/evolve.py:168``): ``x0 (1, n, r)``,
    this rank's ``X (m/P, r, n, r)`` and ``Am (m/P, s, n, n, s)``
    (:func:`place_tdvp_sharded`), ``xl (r, n, 1)``, right-canonical.
    ``squarings`` defaults to the count for this step from a distributed
    bound on the operator (one host read).  Returns ``(x0', X', xl',
    norm)``."""
    pm.require_group()
    if squarings is None:
        r, n = X.shape[1], X.shape[2]
        squarings = _squarings_for(_op_norm_bound_sharded(mesh, a0[0], Am, al[..., 0]),
                                   0.5 * float(h), r * n * r, dense_limit, kdim)
    z0, V, xlq = _tdvp_step_blocks(mesh, x0, X, xl, a0, Am, al, _step_size(h, x0),
                                   dense_limit, kdim, squarings)
    return z0, V, xlq, torch.linalg.norm(z0)


def _stacked_operands(mesh: DeviceMesh, A: PackedTTOp, u0: PackedTT):
    """The canonical stacked state and operator blocks of a trajectory,
    and the operator's block in its own dtype (for the norm bound)."""
    dtp = u0.first.dtype
    m = A.mids.shape[0]
    op = _block_op(mesh, A)
    u = _block_train(mesh, u0, m)
    x0, X, xl = _canonical(mesh, u.first.to(dtp), u.mids.to(dtp), u.last.to(dtp))
    return (x0, X, xl, op.first[None].to(dtp), op.mids.to(dtp),
            op.last[..., None].to(dtp)), op


def evolve_tdvp_sharded(
    mesh: DeviceMesh,
    A: PackedTTOp,
    u0: PackedTT,
    dt: float,
    steps: int,
    krylov: int = 24,
    dense_limit: int = 1024,
) -> Tuple[PackedTT, List[float]]:
    """Integrate ``du/dt = -A u`` by one-site TDVP with the state, the
    operator and the env chains sharded along the train
    (``tensor_networks_tpu/parallel/evolve.py:239``).  The integrator and
    contracts of ``ops.evolve.evolve_tdvp`` (symmetric ``A``,
    rank-preserving); the norms stay on the device and are read once.
    Needs ``d - 2`` divisible by the model axis.  Returns ``(u_final with
    this rank's block, norms)``."""
    pm.require_group()
    (x0, X, xl, a0, Am, al), op = _stacked_operands(mesh, A, u0)
    if steps <= 0:
        return PackedTT(x0[0], X, xl[..., 0]), []
    h = _step_size(dt, x0)
    squarings = _squarings_for(_op_norm_bound_sharded(mesh, *op), 0.5 * float(dt),
                               u0.rank * u0.mode * u0.rank, dense_limit, krylov)
    norms = []
    for _ in range(steps):
        x0, X, xl = _tdvp_step_blocks(mesh, x0, X, xl, a0, Am, al, h, dense_limit,
                                      krylov, squarings)
        norms.append(torch.linalg.norm(x0))
    return (PackedTT(x0[0].contiguous(), X.contiguous(), xl[..., 0].contiguous()),
            torch.stack(norms).cpu().tolist())


# -- two-site TDVP ------------------------------------------------------------------
# Mid pair j (cores j-1 and j of the stack, j = 1..m-1) runs on the rank
# that holds core j: its inputs are that rank's core j, the operator
# cores j-1 (a block of the operator stack shifted by one, placed like
# the state) and j, and the right env of core j; its outputs (the new
# core j-1, the left env, the new core j) stay there.  The evolved
# working core rides the carry across a block boundary; rank 0's block
# starts at pair 1, so no pair is computed that the fused step does not
# compute.


def _tdvp2_step_blocks(mesh, x0, X, xl, a0, Am, A1, al, Am0, AmL, h, eps, dense_limit,
                       kdim, rank, squarings):
    """``ops/evolve._tdvp2_step_impl`` on this rank's block.  Returns the
    new stacked state and the largest effective rank of the boundary
    splits (the same on every rank) and of this rank's pairs."""
    _, parts, me = _model(mesh)
    one3 = _ones3(x0)
    lo, hi = -0.5 * h, 0.5 * h
    knobs = (dense_limit, kdim, squarings)
    skip = 1 if me == 0 else 0  # rank 0's pairs start at 1

    [(_, _, rs)] = _staged_sweep(
        mesh, [(True, (_adv_right(one3, xl, al),), (X, Am), _single(_tdvp_renv_body))])
    X0, rs0 = _replicate_all((X[0], rs[0]), mesh, 0)

    theta = _theta_evolve(one3, a0, Am0, rs0, _merge2(x0, X0), lo, *knobs)
    u0q, s, v3, k0 = _split_theta(theta, rank, eps)
    lenv = _adv_left(one3, u0q, a0)
    sv = _site_evolve(lenv, Am0, rs0, s[:, None, None] * v3, hi, *knobs)

    [(_, back, fwd)] = _staged_sweep(mesh, [(
        False, (lenv, sv), (X[skip:], A1[skip:], Am[skip:], rs[skip:]),
        _tdvp2_fwd_body_of(h, eps, dense_limit, kdim, rank, squarings))])
    l_back, c = _replicate_all(back, mesh, parts - 1)

    theta = _theta_evolve(l_back, AmL, al, one3, _merge2(c, xl), lo, *knobs)
    ulq, s, vl, kl = _split_theta(theta, rank, eps)
    theta = _theta_evolve(l_back, AmL, al, one3, _merge2(ulq, s[:, None, None] * vl), lo,
                          *knobs)
    ub, s, xln, kl2 = _split_theta(theta, rank, eps)
    renv = _adv_right(one3, xln, al)
    us = _site_evolve(l_back, AmL, renv, ub * s[None, None, :], hi, *knobs)

    keffs = [k0, kl, kl2]
    Q, ls, kf = _columns(fwd) if fwd else ([], [], [])
    [(_, front, bwd)] = _staged_sweep(mesh, [(
        True, (renv, us), (Q, A1[skip:], Am[skip:], ls),
        _tdvp2_bwd_body_of(h, eps, dense_limit, kdim, rank, squarings))])
    V, kb = _columns(bwd) if bwd else ([], [])
    keffs += kf + kb
    r_back, c2 = _replicate_all(front, mesh, 0)

    theta = _theta_evolve(one3, a0, Am0, r_back, _merge2(u0q, c2), lo, *knobs)
    z0, s, v1, k0b = _split_theta(theta, rank, eps)
    keffs.append(k0b)
    if me == 0:
        V = [v1] + V
    return z0 * s[None, None, :], torch.stack(V), xln, torch.stack(keffs).max()


def evolve_tdvp2_sharded(
    mesh: DeviceMesh,
    A: PackedTTOp,
    u0: PackedTT,
    dt: float,
    steps: int,
    max_rank: int = None,
    eps: float = 0.0,
    krylov: int = 24,
    dense_limit: int = 4096,
) -> Tuple[PackedTT, List[float], List[int]]:
    """Two-site (rank-adaptive) TDVP with the train sharded along the
    model axis (``tensor_networks_tpu/parallel/evolve.py:672``): the
    integrator and contracts of ``ops.evolve.evolve_tdvp2`` (ranks breathe
    inside the static ``max_rank`` padding, ``eps`` zeroes split singular
    values), the mid pairs the fused step's own bodies staged over the
    ranks.  Needs ``d - 2`` divisible by the model axis and at least two
    middle cores.  Returns ``(u_final with this rank's block, norms, the
    largest effective bond rank of each step)``; the record is read
    once."""
    pm.require_group()
    if max_rank is None:
        max_rank = u0.rank
    if max_rank > u0.rank:
        u0 = pad_rank(u0, max_rank)
    elif max_rank < u0.rank:
        raise ValueError(
            f"max_rank {max_rank} below the initial rank {u0.rank}; round u0 first"
        )
    m = A.mids.shape[0]
    if m < 2:
        raise ValueError("the two-site sweep needs at least two middle cores")
    (x0, X, xl, a0, Am, al), op = _stacked_operands(mesh, A, u0)
    if steps <= 0:
        return PackedTT(x0[0], X, xl[..., 0]), [], []
    dtp = x0.dtype
    whole = A.mids.to(pm.mesh_device(mesh), dtp)
    A1 = _block(mesh, torch.cat([whole[:1], whole[:-1]]), m)
    Am0, AmL = whole[0], whole[-1]
    r, n = int(max_rank), u0.mode
    h = _step_size(dt, x0)
    ej = torch.full((), float(eps), dtype=dtp, device=x0.device)
    squarings = _squarings_for(_op_norm_bound_sharded(mesh, *op), 0.5 * float(dt),
                               r * n * n * r, dense_limit, krylov)
    norms, ranks = [], []
    for _ in range(steps):
        x0, X, xl, keff = _tdvp2_step_blocks(mesh, x0, X, xl, a0, Am, A1, al, Am0, AmL, h,
                                             ej, dense_limit, krylov, r, squarings)
        norms.append(torch.linalg.norm(x0))
        ranks.append(keff)
    # one all-reduce for the whole record: every rank's largest pair rank
    ranks = pm.all_reduce(torch.stack(ranks), mesh.get_group("model"),
                          op=torch.distributed.ReduceOp.MAX)
    rec = torch.stack([torch.stack(norms), ranks.to(dtp)]).cpu().tolist()
    return (PackedTT(x0[0].contiguous(), X.contiguous(), xl[..., 0].contiguous()),
            rec[0], [int(k) for k in rec[1]])


# -- the theta method -----------------------------------------------------------------


def evolve_theta_sharded(
    mesh: DeviceMesh,
    A: PackedTTOp,
    u0: PackedTT,
    dt: float,
    steps: int,
    theta: float = 1.0,
    mass: PackedTTOp = None,
    source=None,
    sweeps: int = 4,
    tol: float = 1e-10,
    op_eps: float = 1e-13,
    observables: Tuple[PackedTTOp, ...] = (),
    callback=None,
    **solve_kw,
):
    """Integrate ``M du/dt = -A u + f`` with the train sharded along the
    model axis (``tensor_networks_tpu/parallel/evolve.py:339``): every
    implicit step is one :func:`parallel.als.als_solve_sharded`, the
    right-hand side's operator apply and source sum are core-local, and
    the step tolerance uses the distributed backward-stable norm.  The
    step operators are assembled once on every rank (whole, from the
    same inputs).  Contracts of ``ops.evolve.evolve_theta`` (theta in
    (0, 1], constant or callable ``source``, ``observables`` recorded as
    ``<u, O u>`` after every step, extra keyword arguments reach the
    solver), except that the right-hand side stays exact.  Returns
    ``(u_final, residuals[, observable values])``."""
    from tensor_networks_tpu_torch.ops.packed import (
        add as packed_add,
        scale,
        ttop_add,
        ttop_identity,
        ttop_round,
        ttop_scale,
    )
    from tensor_networks_tpu_torch.parallel.als import als_solve_sharded
    from tensor_networks_tpu_torch.parallel.sweeps import tt_inner_train_sharded

    pm.require_group()
    if not 0.0 < theta <= 1.0:
        raise ValueError(
            f"theta must be in (0, 1] (theta=0 needs no solver), got {theta}"
        )
    m = A.mids.shape[0]
    d, n = m + 2, u0.mode
    dtp = u0.first.dtype
    M = mass if mass is not None else ttop_identity(d, n, dtp, device=A.first.device)
    lhs = ttop_round(ttop_add(M, ttop_scale(A, theta * dt)), op_eps)
    if theta < 1.0:
        rhs_op = ttop_round(ttop_add(M, ttop_scale(A, -(1.0 - theta) * dt)), op_eps)
    else:
        rhs_op = M
    identity_rhs = mass is None and theta == 1.0
    g_const = None
    if source is not None and not callable(source):
        g_const = _block_train(mesh, scale(source, dt), m)

    def _obs(u: PackedTT) -> Tuple[float, ...]:
        vals = []
        for o in observables:
            ou = ttop_apply_sharded(mesh, o, u)
            vals.append(float(tt_inner_train_sharded(mesh, u.first, u.mids, u.last,
                                                      ou.first, ou.mids, ou.last)))
        return tuple(vals)

    u = _block_train(mesh, u0, m)
    residuals: List[float] = []
    obs: List[Tuple[float, ...]] = []
    for step in range(steps):
        b = u if identity_rhs else ttop_apply_sharded(mesh, rhs_op, u)
        if source is not None:
            if g_const is not None:
                g = g_const
            else:
                g = scale(source((step + 1) * dt), theta * dt)
                if theta < 1.0:
                    g = packed_add(g, scale(source(step * dt), (1.0 - theta) * dt))
                g = _block_train(mesh, g, m)
            b = add_sharded(mesh, b, g)
        bn = float(_norm_sharded(mesh, b.first, b.mids, b.last))
        u, res, _ = als_solve_sharded(mesh, lhs, b, u, sweeps=sweeps, tol=tol * bn,
                                      **solve_kw)
        residuals.append(res)
        if observables:
            obs.append(_obs(u))
        if callback is not None:
            callback(step, u)
    if observables:
        return u, residuals, obs
    return u, residuals
