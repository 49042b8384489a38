"""Train-sharded ALS: linear solves whose trains and env chains are split
along the train.

Counterpart of ``tensor_networks_tpu/parallel/als.py``.  The iterate, the
operator, the right-hand side and their environment chains are split
along the mesh's ``model`` axis (block p on model rank p); the carries
of a sweep are an ``(r, s, r)`` operator env and an ``(r, rb)`` rhs env.
The mid cores run the scan bodies of the port's fused sweep
(``ops/als._als_fwd_body_of`` and the rest) through
:func:`sweeps._staged_sweep`, so each rank solves only its own block's
locals; the boundary cores are solved on every rank from envs broadcast
from the stage that produced them.  As in the fused loop, the right env
chains the backward half records are handed to the next sweep (each rank
keeps its own block's), a sweep reads the host once (its stop test), and
the record is fetched once at the end.  The true residual ``b - A x`` of
each sweep is assembled core-locally and its norm taken by the
distributed orthogonalization sweep (``norm_exact``'s contract, never the
cancelling zipper).  Every decision (the stop test, the adaptive
ladder's test) reads a value broadcast from model rank 0.

Operators are passed whole (the same on every rank); trains whole or as
this rank's block, as a solver returns them.  Results hold this rank's
block of the middle cores.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh

from tensor_networks_tpu_torch.ops.als import (
    _adv_left,
    _adv_left_b,
    _adv_right,
    _adv_right_b,
    _als_bwd_body_of,
    _als_fwd_body_of,
    _als_renv_body,
    _columns,
    _left_orth,
    _ones,
    _packed_of,
    _read_stop,
    _right_orth,
    _solve_core,
    _warm_gates,
)
from tensor_networks_tpu_torch.ops.packed import PackedTT, PackedTTOp, pad_rank, scale
from tensor_networks_tpu_torch.parallel import mesh as pm
from tensor_networks_tpu_torch.parallel.evolve import (
    _block_op,
    _block_train,
    _canonical,
    add_sharded,
    ttop_apply_sharded,
)
from tensor_networks_tpu_torch.parallel.sweeps import (
    _agree,
    _model,
    _norm_sharded,
    _own_slice,
    _place,
    _replicate_all,
    _staged_sweep,
    tt_gram_round_sharded,
)

__all__ = [
    "als_solve_adaptive_sharded",
    "als_solve_sharded",
    "als_sweep_sharded",
    "place_als_sharded",
]


def _als_sweep_blocks(mesh, x0c, X, xlc, a0, Am, al, b0, Bm, bl, lam,
                      warm_first, warm_mid, warm_last, dense_limit, cg_iters, spd,
                      renvs=None):
    """``ops/als._als_sweep_impl`` on this rank's block (``X``, ``Am``,
    ``Bm``, ``warm_mid`` and the chains in ``renvs``): the same calls on
    the same operands, the mid-core scans staged over the ranks."""
    _, parts, _ = _model(mesh)
    dt, dev = x0c.dtype, x0c.device
    one3, one2 = _ones(dt, dev, 1, 1, 1), _ones(dt, dev, 1, 1)

    def solve(L, R, Lb, Rb, ak, bk, vk, warm):
        return _solve_core(L, R, Lb, Rb, ak, bk, vk, lam, dense_limit, cg_iters, spd, warm)

    if renvs is None:
        [(_, front, ys)] = _staged_sweep(mesh, [(
            True, (_adv_right(one3, xlc, al), _adv_right_b(one2, xlc, bl)), (X, Am, Bm),
            _als_renv_body)])
        rs, rbs = _columns(ys)
        R, Rb = _replicate_all(front, mesh, 0)
    else:
        rs, rbs, R, Rb = renvs

    q0 = _left_orth(solve(one3, R, one2, Rb, a0, b0, x0c, warm_first))
    [(_, back, ys)] = _staged_sweep(mesh, [(
        False, (_adv_left(one3, q0, a0), _adv_left_b(one2, q0, b0)),
        (X, Am, Bm, rs, rbs, warm_mid), _als_fwd_body_of(lam, dense_limit, cg_iters, spd))])
    Q, ls, lbs = _columns(ys)
    L, Lb = _replicate_all(back, mesh, parts - 1)

    zl = solve(L, one3, Lb, one2, al, bl, xlc, warm_last)
    zl = solve(L, one3, Lb, one2, al, bl, zl, warm_last)
    vl = _right_orth(zl)
    [(_, front, ys)] = _staged_sweep(mesh, [(
        True, (_adv_right(one3, vl, al), _adv_right_b(one2, vl, bl)),
        (Q, Am, Bm, ls, lbs, warm_mid), _als_bwd_body_of(lam, dense_limit, cg_iters, spd))])
    V, rs, rbs = _columns(ys)
    R, Rb = _replicate_all(front, mesh, 0)

    z0 = solve(one3, R, one2, Rb, a0, b0, q0, warm_first)
    return z0, torch.stack(V), vl, (rs, rbs, R, Rb)


def als_sweep_sharded(
    mesh: DeviceMesh, x0, X, xl, a0, Am, al, b0, Bm, bl, lam,
    warm_f, warm_m, warm_l,
    dense_limit: int = 1024, cg_iters: int = 200, spd: bool = False,
):
    """One sharded ALS sweep on the stacked layout
    (``tensor_networks_tpu/parallel/als.py:231``): ``X``, ``Am``, ``Bm``
    and the warm-start gates ``warm_m`` are this rank's blocks
    (:func:`place_als_sharded`), the boundary cores whole.  Returns
    ``(x0', X', xl')`` right-canonical with the mass in core 0."""
    pm.require_group()
    z0, V, vl, _ = _als_sweep_blocks(
        mesh, x0, X, xl, a0, Am, al, b0, Bm, bl, lam, bool(warm_f),
        [bool(w) for w in warm_m], bool(warm_l), int(dense_limit), int(cg_iters), bool(spd))
    return z0, V, vl


def place_als_sharded(mesh: DeviceMesh, X, Am, Bm):
    """This rank's blocks of the iterate's, the operator's and the rhs's
    middle-core stacks (``tensor_networks_tpu/parallel/als.py:244``).
    Takes the global stacks, the same on every rank."""
    return _place(mesh, X, Am, Bm)


def _residual_train_sharded(mesh, op: PackedTTOp, rhs: PackedTT, x: PackedTT) -> PackedTT:
    """``rhs - op x`` on this rank's block: ``ops/als._residual_train``
    core by core (the apply and the direct sum touch no bond)."""
    return add_sharded(mesh, rhs, scale(ttop_apply_sharded(mesh, op, x), -1.0))


def _residual_sharded(mesh, op: PackedTTOp, rhs: PackedTT, x: PackedTT) -> torch.Tensor:
    """``|rhs - op x|`` through the distributed orthogonalization sweep
    (``tensor_networks_tpu/parallel/als.py:278``): the same 0-d tensor on
    every rank."""
    t = _residual_train_sharded(mesh, op, rhs, x)
    return _norm_sharded(mesh, t.first, t.mids, t.last)


def als_solve_sharded(
    mesh: DeviceMesh,
    op: PackedTTOp,
    rhs: PackedTT,
    x0: PackedTT,
    sweeps: int = 10,
    tol: float = 1e-8,
    lam: float = 0.0,
    dense_limit: int = 1024,
    cg_iters: int = 200,
    spd: bool = False,
) -> Tuple[PackedTT, float, List[float]]:
    """Solve ``op @ x = rhs`` by one-site ALS with the trains and the env
    chains sharded along the model axis
    (``tensor_networks_tpu/parallel/als.py:328``).  The contracts of
    ``ops.als.als_solve`` (minimum-norm dense or CG local solves,
    ``spd=True`` for SPD projections, CG warm starts gated on structural
    nonsingularity, the true residual after each sweep and the stop
    below ``tol``); per-rank memory scales as ``1/P``.  Needs ``d - 2``
    divisible by the model axis.  Returns ``(x with this rank's block,
    residual, history)``; the history is recorded on the device in the
    train's dtype and read once."""
    pm.require_group()
    dtp = x0.first.dtype
    m = op.mids.shape[0]
    d, n, r = m + 2, x0.mode, x0.rank
    opb, rhsb = _block_op(mesh, op), _block_train(mesh, rhs, m)
    x = _block_train(mesh, x0, m)
    x0c, X, xlc = _canonical(mesh, x.first.to(dtp), x.mids.to(dtp), x.last.to(dtp))
    a0, Am, al = opb.first[None].to(dtp), opb.mids.to(dtp), opb.last[..., None].to(dtp)
    b0, Bm, bl = rhsb.first[None].to(dtp), rhsb.mids.to(dtp), rhsb.last[..., None].to(dtp)
    warm = _warm_gates(d, n, r)
    warm_mid = warm[1:-1][_own_slice(mesh, m)]

    history: List[float] = []
    res = float("inf")
    if sweeps <= 0:
        return _packed_of(x0c, X, xlc), res, history
    # the JAX package's record length (its sweep cap bucketed to a power of two)
    cap = 1 << max(sweeps - 1, 1).bit_length()
    hist = torch.full((cap,), float("nan"), dtype=dtp, device=x0c.device)
    done, renvs = 0, None
    while done < sweeps:
        x0c, X, xlc, renvs = _als_sweep_blocks(
            mesh, x0c, X, xlc, a0, Am, al, b0, Bm, bl, lam, warm[0], warm_mid, warm[-1],
            dense_limit, cg_iters, spd, renvs)
        res_d = _residual_sharded(mesh, opb, rhsb, _packed_of(x0c, X, xlc)).to(dtp)
        hist[done] = res_d
        done += 1
        if _read_stop(res_d < tol):
            break
    rec = torch.cat([hist, hist.new_full((1,), done)]).cpu().numpy()
    history = [float(v) for v in rec[:int(rec[-1])]]
    if history:
        res = history[-1]
    return _packed_of(x0c, X, xlc), res, history


# -- rank-adaptive solves ----------------------------------------------------------


def _round_fixed_sharded(mesh: DeviceMesh, t: PackedTT, kick: int) -> PackedTT:
    """Rank-``kick`` truncation of a train-sharded train by the distributed
    Gram sweep (``tensor_networks_tpu/parallel/als.py:409``): zero budget
    and every bond's bound pinned to ``kick``, so each bond keeps its
    leading ``min(kick, structural)`` directions in the leading slots;
    a bond thinner than ``kick`` is zero-padded to it, as ``svd_round``
    pads."""
    d = pm.axis_size(mesh, "model") * t.mids.shape[0] + 2
    bounds = torch.full((d - 1,), kick, dtype=torch.int64, device=t.mids.device)
    f, m, l, _, _ = tt_gram_round_sharded(mesh, t.first, t.mids, t.last, 0.0, bounds=bounds)
    grow = max(kick - t.rank, 0)
    return PackedTT(F.pad(f[:, :kick], (0, grow)),
                    F.pad(m[:, :kick, :, :kick], (0, grow, 0, 0, 0, grow)),
                    F.pad(l[:kick], (0, 0, 0, grow)))


def _enrich_span_sharded(mesh: DeviceMesh, x: PackedTT, resid_train: PackedTT,
                         kick: int) -> PackedTT:
    """AMEn rank growth on this rank's block (``ops/als._enrich_span`` with
    the rounding distributed, ``tensor_networks_tpu/parallel/als.py:425``):
    the rank-``kick`` truncation of the residual train direct-summed with
    coefficient zero -- the represented iterate is unchanged, every bond
    frame gains the steepest-descent subspace."""
    z = _round_fixed_sharded(mesh, resid_train, kick)
    dt = x.first.dtype
    span = PackedTT(torch.zeros(z.first.shape, dtype=dt, device=z.first.device),
                    z.mids.to(dt), z.last.to(dt))
    return add_sharded(mesh, x, span)


def als_solve_adaptive_sharded(
    mesh: DeviceMesh,
    op: PackedTTOp,
    rhs: PackedTT,
    x0: PackedTT = None,
    eps: float = 1e-8,
    rank: int = None,
    max_rank: int = None,
    sweeps_per_rank: int = 4,
    enrich: bool = True,
    **kw,
) -> Tuple[PackedTT, float, List[float]]:
    """Rank-adaptive train-sharded ALS (``tensor_networks_tpu/parallel/als.py:448``):
    solve at the current rank with :func:`als_solve_sharded` and, while
    the exact relative residual stays above ``eps``, double the rank
    (warm restart) up to ``max_rank`` -- ``ops.als.als_solve_adaptive``'s
    schedule, the restarts' AMEn enrichment rounding the residual train
    with the distributed Gram sweep (``enrich=False``: inert zero
    padding).  The ladder's test reads values every rank holds alike.
    Returns ``(x with this rank's block, absolute residual, concatenated
    history)``."""
    pm.require_group()
    m = op.mids.shape[0]
    rhs = _block_train(mesh, rhs, m)

    def _grow(x: PackedTT, target: int) -> PackedTT:
        kick = target - x.rank
        if kick <= 0:
            return x
        if not enrich:
            return pad_rank(x, target)
        return _enrich_span_sharded(mesh, x, _residual_train_sharded(mesh, op, rhs, x), kick)

    x0 = rhs if x0 is None else _block_train(mesh, x0, m)
    rank = int(rank) if rank is not None else max(2 * x0.rank, 2)
    ceiling = int(max_rank) if max_rank is not None else 8 * rank
    b_norm = _agree(mesh, _norm_sharded(mesh, rhs.first, rhs.mids, rhs.last))
    x = _grow(x0, rank)
    hist_all: List[float] = []
    while True:
        x, res, hist = als_solve_sharded(mesh, op, rhs, x, sweeps=sweeps_per_rank,
                                         tol=eps * b_norm, **kw)
        hist_all += hist
        if res <= eps * b_norm or rank >= ceiling:
            return x, res, hist_all
        rank = min(2 * rank, ceiling)
        x = _grow(x, rank)

