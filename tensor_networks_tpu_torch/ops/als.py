"""ALS (one-site DMRG-style) linear solver for TT systems.

Counterpart of ``tensor_networks_tpu/ops/als.py``.  Solves ``A x = b``
with ``A`` a uniform TT-operator and ``b``, ``x`` uniform trains, by
sweeping over the cores of ``x`` and replacing each with the solution
of the small projected system

    (frame_k^T A frame_k) x_k = frame_k^T b,

where ``frame_k`` is the (orthonormalized) rest of the train.  Per
sweep this is d small solves plus O(d) environment GEMMs; for systems
whose Galerkin projection is well-posed (SPD, or diagonally dominant
like discretized elliptic operators) it converges in a handful of
sweeps at fixed rank.

The environments and local operators are ``torch.einsum`` (cuBLAS on
the card; the JAX package runs them as XLA einsums outside any Pallas
kernel).  The local systems are solved densely up to ``dense_limit``
unknowns -- a minimum-norm least-squares solve through one SVD, with
``jnp.linalg.lstsq``'s cut-off (:func:`_lstsq_min_norm`) -- and by
conjugate gradients above it, on the normal equations for general
``A`` or directly on the projected operator with ``spd=True``.  The
CG runs its full iteration budget with converged lanes frozen on the
device (:func:`_cg`), so no local solve reads the device.  Rank
adaptivity is by restart (:func:`als_solve_adaptive`), growing the
bonds with the rounded residual train (AMEn-style) or zero padding.
"""

from __future__ import annotations

import warnings
from typing import List, Tuple

import torch
import torch.nn.functional as F

from tensor_networks_tpu_torch.ops.packed import (
    PackedTT,
    PackedTTOp,
    add,
    norm_exact,
    pad_rank,
    scale,
    svd_round,
    ttop_apply_packed,
)

__all__ = ["als_solve", "als_solve_adaptive"]

_STALL_MSG = (
    "ALS sweep reduced the residual <2% (now {res:.2e}) with local "
    "systems of {size} unknowns above dense_limit={dense_limit} "
    "({path}); if it stays flat, raise dense_limit or cg_iters, or "
    "lower the rank{spd_hint}"
)


# -- environment advances ------------------------------------------------------
# Index conventions: ket core X (a, j, a2); the SAME core is the bra
# test frame with the output physical index (p, i, p2); operator core
# A (s, i, j, t); rhs core B (beta, i, beta2).  Left environment
# L (p, s, a); right environment R (q, t, c); rhs environments
# Lb (p, beta) / Rb (q, beta2).  The rhs-side functions take leading
# batch axes on their env and rhs-core arguments (the eigensolver's
# stacked deflation environments).


def _adv_left(L, xk, ak):
    t1 = torch.einsum("psa,ajb->psjb", L, xk)
    t2 = torch.einsum("psjb,sijt->pitb", t1, ak)
    return torch.einsum("pitb,piq->qtb", t2, xk)


def _adv_right(R, xk, ak):
    u1 = torch.einsum("ajc,qtc->ajqt", xk, R)
    u2 = torch.einsum("ajqt,sijt->asiq", u1, ak)
    return torch.einsum("asiq,piq->psa", u2, xk)


def _adv_left_b(Lb, xk, bk):
    t = torch.einsum("...pb,...bif->...pif", Lb, bk)
    return torch.einsum("...pif,piq->...qf", t, xk)


def _adv_right_b(Rb, xk, bk):
    t = torch.einsum("...bif,...qf->...biq", bk, Rb)
    return torch.einsum("...biq,piq->...pb", t, xk)


# -- the local system ----------------------------------------------------------


def _local_rhs(Lb, bk, Rb):
    return torch.einsum("...pb,...bif,...qf->...piq", Lb, bk, Rb)


def _local_dense(L, ak, R):
    h1 = torch.einsum("psa,sijt->paijt", L, ak)
    H = torch.einsum("paijt,qtc->piqajc", h1, R)
    m = H.shape[0] * H.shape[1] * H.shape[2]
    return H.reshape(m, m)


def _matvec(L, ak, R, v):
    v1 = torch.einsum("psa,ajc->psjc", L, v)
    v2 = torch.einsum("psjc,sijt->pitc", v1, ak)
    return torch.einsum("pitc,qtc->piq", v2, R)


def _matvec_t(L, ak, R, u):
    u1 = torch.einsum("psa,piq->saiq", L, u)
    u2 = torch.einsum("saiq,sijt->ajqt", u1, ak)
    return torch.einsum("ajqt,qtc->ajc", u2, R)


def _dot(a, b):
    return torch.dot(a.reshape(-1), b.reshape(-1))


def _cg(apply, b, x0, iters):
    """``jax.scipy.sparse.linalg.cg(apply, b, x0, maxiter=iters,
    tol=1e-12)``: stop once ``|r|^2 <= 1e-24 |b|^2``.

    The JAX loop exits per local; here every call runs ``iters`` steps
    and a converged solve is frozen on the device (``alpha = 0``, ``p``
    and ``gamma`` kept), so the result is the JAX iterate and no step
    reads the device.  The divisions are guarded on frozen steps only,
    where ``p^T A p`` can be 0 (the JAX loop never evaluates them).
    """
    atol2 = 1e-24 * _dot(b, b)
    x = x0
    r = b - apply(x0)
    p = r
    gamma = _dot(r, r)
    for _ in range(iters):
        live = gamma > atol2
        ap = apply(p)
        alpha = torch.where(live, gamma / torch.where(live, _dot(p, ap), 1.0), 0.0)
        x = x + alpha * p
        r = r - alpha * ap
        gamma_new = _dot(r, r)
        beta = gamma_new / torch.where(live, gamma, 1.0)
        p = torch.where(live, r + beta * p, p)
        gamma = torch.where(live, gamma_new, gamma)
    return x


def _local_cg(L, ak, R, rhs, v0, lam, iters, spd):
    """CG on the regularized projected system (H + lam I).

    ``spd=False`` (general ``A``): CG on the normal equations -- always
    applicable, but squares the local condition number.  ``spd=True``
    (symmetric positive definite ``A``; the Galerkin projection through
    orthonormal frames is then SPD too): plain CG on H directly -- the
    same iteration count buys twice the digits."""

    def hmat(v):
        return _matvec(L, ak, R, v) + lam * v

    if spd:
        return _cg(hmat, rhs, v0, iters)

    def hmat_t(u):
        return _matvec_t(L, ak, R, u) + lam * u

    return _cg(lambda v: hmat_t(hmat(v)), hmat_t(rhs), v0, iters)


def _lstsq_min_norm(a, b):
    """The minimum-norm least-squares solution of ``a x = b``, as
    ``jnp.linalg.lstsq`` computes it: one SVD, singular values below
    ``eps * max(a.shape) * s[0]`` dropped.

    Local systems of overparameterized bonds are singular, and
    ``torch.linalg.lstsq`` on CUDA tensors offers only ``gels``, which
    assumes full rank and returns garbage there; this is the same code
    on every device.
    """
    u, s, vt = torch.linalg.svd(a, full_matrices=False)
    keep = s >= torch.finfo(a.dtype).eps * max(a.shape) * s[0]
    s_inv = torch.where(keep, 1.0 / torch.where(keep, s, 1.0), 0.0)
    return vt.T @ (s_inv * (u.T @ b))


def _left_orth(core):
    r1, n, r2 = core.shape
    q, _ = torch.linalg.qr(core.reshape(r1 * n, r2))
    if q.shape[1] < r2:
        q = F.pad(q, (0, r2 - q.shape[1]))
    return q.reshape(r1, n, r2)


def _right_orth(core):
    r1, n, r2 = core.shape
    q, _ = torch.linalg.qr(core.reshape(r1, n * r2).T)
    if q.shape[1] < r1:
        q = F.pad(q, (0, r1 - q.shape[1]))
    return q.T.reshape(r1, n, r2)


def _solve_core(L, R, Lb, Rb, ak, bk, vk, lam, dense_limit, cg_iters,
                spd, warm):
    rhs = _local_rhs(Lb, bk, Rb)
    m = rhs.numel()
    if m <= dense_limit:
        H = _local_dense(L, ak, R)
        H = H + lam * torch.eye(m, dtype=H.dtype, device=H.device)
        # minimum-norm, not solve: frames of overparameterized bonds
        # (rank > rows of an end unfolding) have structurally zero
        # directions, making H singular -- the minimum-norm solution
        # zeroes them
        return _lstsq_min_norm(H, rhs.reshape(m)).reshape(rhs.shape)
    # warm-start ONLY structurally nonsingular locals.  On a singular
    # local (overparameterized bond: rank > the mode product on one
    # side), CG preserves the warm start's null(H) component -- the
    # represented tensor is unchanged (null(H) = null(frame)) but the
    # junk enters the bond basis at the orthogonalization step and the
    # sweep stalls orders of magnitude above the dense path (observed
    # in the JAX package: 1.4e-2 vs 1e-13 on a K=6 QTT system; every
    # LOCAL residual at 1e-15).  From x0 = 0 the Krylov space lives in
    # range(H), so CG returns the same minimum-norm solution the dense
    # path does.  ``warm`` is decided from shapes on the host.
    v0 = vk if warm else torch.zeros_like(vk)
    return _local_cg(L, ak, R, rhs, v0, lam, cg_iters, spd)


def _ones(dt, device, *shape):
    return torch.ones(shape, dtype=dt, device=device)


def _read_stop(flag) -> bool:
    """The one host read of a fused sweep: its stop test."""
    return bool(flag)


# -- fused sweep ----------------------------------------------------------------
# One sweep over stacked cores: boundary cores explicit, mid cores a
# Python loop, with the host loop's arithmetic call for call.  The JAX
# package's single-program sweep recomputes the right env chains at its
# top; here each sweep hands the chains its backward half recorded to
# the next (the same calls on the same cores: equal values, and the
# host loop's order).  On structurally full-rank trains the two paths
# agree to roundoff; on
# PADDED trains the cores are rank-deficient, the QR null-space gauge is
# arbitrary, and the paths converge equally well without being
# comparable core by core.


def _als_sweep_impl(x0c, X, xlc, a0, Am, al, b0, Bm, bl, lam,
                    warm_first, warm_mid, warm_last,
                    dense_limit, cg_iters, spd, renvs=None):
    """One full ALS sweep (left->right, right->left).

    ``x0c (1, n, r)``, ``X (m, r, n, r)``, ``xlc (r, n, 1)`` -- right-
    canonical with the mass in core 0 on entry and on exit.  ``warm_*``
    are the per-position CG warm-start gates (Python bools; ``warm_mid``
    a sequence of m).  ``renvs`` are the right env chains of these
    cores as the previous sweep returned them (None: computed here).
    Returns the new cores and their right env chains.
    """
    dt, dev = x0c.dtype, x0c.device
    one3, one2 = _ones(dt, dev, 1, 1, 1), _ones(dt, dev, 1, 1)
    m = X.shape[0]

    def solve(L, R, Lb, Rb, ak, bk, vk, warm):
        return _solve_core(L, R, Lb, Rb, ak, bk, vk, lam, dense_limit,
                           cg_iters, spd, warm)

    # right-env chains of the current cores, pre-absorb: entry j is
    # what mid j consumes (env of cores j+2..d-1); R, Rb the front's
    if renvs is None:
        rs_mid, rbs_mid = [None] * m, [None] * m
        R, Rb = _adv_right(one3, xlc, al), _adv_right_b(one2, xlc, bl)
        for j in range(m - 1, -1, -1):
            rs_mid[j], rbs_mid[j] = R, Rb
            R, Rb = _adv_right(R, X[j], Am[j]), _adv_right_b(Rb, X[j], Bm[j])
    else:
        rs_mid, rbs_mid, R, Rb = renvs

    # left -> right half
    q0 = _left_orth(solve(one3, R, one2, Rb, a0, b0, x0c, warm_first))
    L, Lb = _adv_left(one3, q0, a0), _adv_left_b(one2, q0, b0)
    Q, ls_mid, lbs_mid = [], [], []
    for j in range(m):
        qk = _left_orth(solve(L, rs_mid[j], Lb, rbs_mid[j], Am[j], Bm[j],
                              X[j], warm_mid[j]))
        Q.append(qk)
        ls_mid.append(L)
        lbs_mid.append(Lb)
        L, Lb = _adv_left(L, qk, Am[j]), _adv_left_b(Lb, qk, Bm[j])

    # last core: solved by the forward half (no orth), then again
    # first thing in the return half -- the host loop's exact order
    zl = solve(L, one3, Lb, one2, al, bl, xlc, warm_last)
    zl = solve(L, one3, Lb, one2, al, bl, zl, warm_last)
    vl = _right_orth(zl)
    R, Rb = _adv_right(one3, vl, al), _adv_right_b(one2, vl, bl)

    V = [None] * m
    for j in range(m - 1, -1, -1):
        rs_mid[j], rbs_mid[j] = R, Rb
        V[j] = _right_orth(solve(ls_mid[j], R, lbs_mid[j], Rb, Am[j], Bm[j],
                                 Q[j], warm_mid[j]))
        R, Rb = _adv_right(R, V[j], Am[j]), _adv_right_b(Rb, V[j], Bm[j])

    z0 = solve(one3, R, one2, Rb, a0, b0, q0, warm_first)
    return z0, torch.stack(V), vl, (rs_mid, rbs_mid, R, Rb)


def _als_loop_impl(x0c, X, xlc, a0, Am, al, b0, Bm, bl, op, rhs,
                   lam, warm_first, warm_mid, warm_last, sweeps, tol,
                   cap, dense_limit, cg_iters, spd):
    """The fused sweep loop: up to ``sweeps`` sweeps, the true residual
    (``norm_exact`` of the residual train, ``op``/``rhs`` the original
    operands) and the ``res < tol`` stop computed on the device, with
    one host read per sweep (the stop flag, :func:`_read_stop`).
    Returns the final cores plus the JAX package's ``(cap + 1,)``
    record, on the device in the train's dtype: per-sweep residuals
    (NaN past the executed count) with the executed sweep count in the
    tail."""
    dt = x0c.dtype
    hist = torch.full((cap,), float("nan"), dtype=dt, device=x0c.device)
    done, renvs = 0, None
    while done < sweeps:
        x0c, X, xlc, renvs = _als_sweep_impl(
            x0c, X, xlc, a0, Am, al, b0, Bm, bl, lam,
            warm_first, warm_mid, warm_last, dense_limit, cg_iters, spd, renvs,
        )
        x = _packed_of(x0c, X, xlc)
        res = norm_exact(_residual_train(op, rhs, x)).to(dt)
        hist[done] = res
        done += 1
        if _read_stop(res < tol):
            break
    return x0c, X, xlc, torch.cat([hist, hist.new_full((1,), done)])


def _residual_train(op: PackedTTOp, rhs: PackedTT, x: PackedTT) -> PackedTT:
    return add(rhs, scale(ttop_apply_packed(op, x), -1.0))


def _enrich_span(x: PackedTT, resid_train: PackedTT, kick: int) -> PackedTT:
    """AMEn rank growth: direct-sum the rank-``kick`` rounding of the
    residual train with coefficient zero -- the represented iterate is
    unchanged, but every bond frame gains the steepest-descent
    subspace the next sweep needs.  Shared by the adaptive linear
    solver and the adaptive eigensolver.  :func:`svd_round` pads every
    bond to exactly ``kick``, so the result has rank ``x.rank + kick``."""
    z = svd_round(resid_train, kick)
    dt = x.first.dtype
    span = PackedTT(
        torch.zeros(z.first.shape, dtype=dt, device=z.first.device),
        z.mids.to(dt),
        z.last.to(dt),
    )
    return add(x, span)


def _residual(op: PackedTTOp, rhs: PackedTT, x: PackedTT) -> float:
    return float(norm_exact(_residual_train(op, rhs, x)))


def _stall_warning(res, size, dense_limit, spd):
    warnings.warn(_STALL_MSG.format(
        res=res, size=size, dense_limit=dense_limit,
        path=("plain CG on the SPD projection" if spd
              else "CG on normal equations"),
        spd_hint=("" if spd else "; for SPD operators pass spd=True"),
    ), RuntimeWarning, stacklevel=3)


def _packed_of(first3, mids, last3) -> PackedTT:
    """The packed train of a sweep's cores (end bonds dropped), each
    contiguous: QR factors come back with column-major strides, and the
    kernels take contiguous cores only."""
    return PackedTT(first3[0].contiguous(), mids.contiguous(),
                    last3[..., 0].contiguous())


def _core_lists(t, dt):
    """A packed train's or operator's cores as a list with explicit
    size-1 end bonds, in ``dt``."""
    return [t.first[None].to(dt)] + list(t.mids.to(dt)) + [t.last[..., None].to(dt)]


def _canonicalize(xs):
    """Right-orthogonalize cores 1..d-1 in place, absorbing each R
    factor into the left neighbour (discarding it would change the
    represented tensor and destroy warm starts)."""
    for k in range(len(xs) - 1, 0, -1):
        r1, nn, r2 = xs[k].shape
        q, rmat = torch.linalg.qr(xs[k].reshape(r1, nn * r2).T)
        if q.shape[1] < r1:
            q = F.pad(q, (0, r1 - q.shape[1]))
            rmat = F.pad(rmat, (0, 0, 0, r1 - rmat.shape[0]))
        xs[k] = q.T.reshape(r1, nn, r2)
        xs[k - 1] = torch.einsum("anb,cb->anc", xs[k - 1], rmat)


def als_solve(
    op: PackedTTOp,
    rhs: PackedTT,
    x0: PackedTT,
    sweeps: int = 10,
    tol: float = 1e-8,
    lam: float = 0.0,
    dense_limit: int = 1024,
    cg_iters: int = 200,
    spd: bool = False,
    fused: bool = None,
) -> Tuple[PackedTT, float, List[float]]:
    """Solve ``op @ x = rhs`` by one-site ALS at the ranks of ``x0``.

    Returns ``(x, residual, history)`` where ``history`` is the true
    residual norm after each sweep (measured exactly via
    :func:`~tensor_networks_tpu_torch.ops.packed.norm_exact`) and the
    sweep loop stops once it drops below ``tol``.  On the fused path
    the history is recorded on the device in the TRAIN dtype -- for f32
    trains the returned ``history``/``residual`` carry ~1e-7 relative
    resolution (the host loop records full-precision values; use
    ``fused=False`` when comparing history against tolerances tighter
    than the train dtype's eps).

    The projected local systems are solved densely up to
    ``dense_limit`` unknowns (minimum-norm least squares), else by
    ``cg_iters`` CG steps -- on the normal equations for general ``A``,
    or directly on the projected operator when ``spd=True`` (``A``
    symmetric positive definite: twice the digits per iteration;
    elliptic operators like the screened Laplacian qualify).  ``lam``
    regularizes the local solves.  Grow ranks by restarting from
    ``packed.pad_rank(x, r2)``.

    ``fused`` (default on) sweeps over stacked cores and computes the
    residual and the ``res < tol`` stop on the device, reading the
    host once per sweep (the stop flag) and the history once at the
    end; ``fused=False`` keeps the host loop, which reads each sweep's
    residual as a float.  Both run the same arithmetic.
    """
    if fused is None:
        fused = True
    dt = x0.first.dtype
    dev = x0.first.device
    xs = _core_lists(x0, dt)
    bs = _core_lists(rhs, dt)
    as_ = _core_lists(op, dt)
    d = len(xs)
    _canonicalize(xs)

    # structural nonsingularity of each local system (CG warm-start
    # gate, see _solve_core): bond ranks within the mode products on
    # both sides of the core
    caps_l, cap = [], 1
    for k in range(d):
        caps_l.append(cap)
        cap = min(cap * xs[k].shape[1], 1 << 40)
    caps_r, cap = [0] * d, 1
    for k in range(d - 1, -1, -1):
        caps_r[k] = cap
        cap = min(cap * xs[k].shape[1], 1 << 40)
    warm_ok = [
        xs[k].shape[0] <= caps_l[k] and xs[k].shape[2] <= caps_r[k]
        for k in range(d)
    ]

    one3, one2 = _ones(dt, dev, 1, 1, 1), _ones(dt, dev, 1, 1)
    history: List[float] = []
    res = float("inf")
    warned_stall = False
    size = x0.rank * x0.mode * x0.rank
    # sweeps=0 returns the (canonicalized) start unchanged
    x = _packed_of(xs[0], torch.stack(xs[1:-1]), xs[-1])

    if fused:
        if sweeps <= 0:
            return x, res, history
        # the JAX package's record length (its sweep cap bucketed to a
        # power of two)
        cap = 1 << max(sweeps - 1, 1).bit_length()
        z0, Vm, vlq, rec = _als_loop_impl(
            xs[0], torch.stack(xs[1:-1]), xs[-1],
            as_[0], op.mids.to(dt), as_[-1],
            bs[0], rhs.mids.to(dt), bs[-1], op, rhs, lam,
            warm_ok[0], warm_ok[1:-1], warm_ok[-1], sweeps, tol,
            cap, dense_limit, cg_iters, spd,
        )
        rec = rec.cpu().numpy()  # one host fetch for the record
        n_done = int(rec[-1])
        history = [float(v) for v in rec[:n_done]]
        if history:
            res = history[-1]
        x = _packed_of(z0, Vm, vlq)
        # post-hoc stall warning -- the same between-sweep condition
        # the host loop checks (see the comment there)
        if size > dense_limit:
            for i in range(1, len(history)):
                if history[i] >= tol and history[i] > 0.98 * history[i - 1]:
                    _stall_warning(history[i], size, dense_limit, spd)
                    break
        return x, res, history

    # host-loop path: right-environment prefixes for the first
    # left-to-right pass; subsequent passes get them from the
    # preceding right-to-left pass (each half-sweep records the
    # prefixes the next consumes)
    rev_rs, rev_rbs = [one3], [one2]
    for k in range(d - 1, 0, -1):
        rev_rs.append(_adv_right(rev_rs[-1], xs[k], as_[k]))
        rev_rbs.append(_adv_right_b(rev_rbs[-1], xs[k], bs[k]))

    for _sweep in range(sweeps):
        rs = rev_rs[::-1]  # rs[k] = env right of core k
        rbs = rev_rbs[::-1]

        # left -> right, recording left prefixes for the return pass
        ls, lbs = [one3], [one2]
        for k in range(d):
            xs[k] = _solve_core(
                ls[-1], rs[k], lbs[-1], rbs[k], as_[k], bs[k], xs[k],
                lam, dense_limit, cg_iters, spd, warm_ok[k],
            )
            if k < d - 1:
                xs[k] = _left_orth(xs[k])
                ls.append(_adv_left(ls[-1], xs[k], as_[k]))
                lbs.append(_adv_left_b(lbs[-1], xs[k], bs[k]))

        # right -> left, recording right prefixes for the next sweep
        rev_rs, rev_rbs = [one3], [one2]
        for k in range(d - 1, -1, -1):
            xs[k] = _solve_core(
                ls[k], rev_rs[-1], lbs[k], rev_rbs[-1],
                as_[k], bs[k], xs[k],
                lam, dense_limit, cg_iters, spd, warm_ok[k],
            )
            if k > 0:
                xs[k] = _right_orth(xs[k])
                rev_rs.append(_adv_right(rev_rs[-1], xs[k], as_[k]))
                rev_rbs.append(_adv_right_b(rev_rbs[-1], xs[k], bs[k]))

        x = _packed_of(xs[0], torch.stack(xs[1:-1]), xs[-1])

        res = _residual(op, rhs, x)
        history.append(res)
        if res < tol:
            break
        if (
            not warned_stall
            and len(history) >= 2
            and history[-1] > 0.98 * history[-2]
            and size > dense_limit
        ):
            # a stalled sweep above tol on the CG path can be a
            # LOCAL-solve failure, not a rank limit: r*n*r past
            # dense_limit routes to CG, whose (on the normal equations,
            # squared) condition number can defeat cg_iters.  Warn once
            # but honor the requested sweeps -- slow legitimate
            # convergence must not be cut short.
            warned_stall = True
            _stall_warning(res, size, dense_limit, spd)

    return x, res, history


def als_solve_adaptive(
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
    """Rank-adaptive ALS: solve at the current rank and, while the
    exact relative residual stays above ``eps``, double the rank (warm
    restart) up to ``max_rank``.

    With ``enrich=True`` (default) the rank growth is AMEn-style: the
    new bond directions are the leading basis of the current residual
    train ``b - A x`` (rounded to the kick rank and direct-summed with
    coefficient zero -- the represented iterate is unchanged, but every
    bond's frame now spans the steepest-descent subspace the next sweep
    needs; Dolgov & Savostyanov's enrichment, done globally at
    restart).  ``enrich=False`` falls back to inert zero padding.
    Returns ``(x, absolute residual, concatenated per-sweep history)``;
    ``**kw`` goes to :func:`als_solve`.
    """

    def _grow(x: PackedTT, target: int) -> PackedTT:
        kick = target - x.rank
        if kick <= 0:
            return x
        if not enrich:
            return pad_rank(x, target)
        return _enrich_span(x, _residual_train(op, rhs, x), kick)

    if x0 is None:
        x0 = rhs
    rank = int(rank) if rank is not None else max(2 * x0.rank, 2)
    ceiling = int(max_rank) if max_rank is not None else 8 * rank
    b_norm = float(norm_exact(rhs))
    x = _grow(x0, rank)
    hist_all: List[float] = []
    while True:
        x, res, hist = als_solve(
            op, rhs, x, sweeps=sweeps_per_rank, tol=eps * b_norm, **kw
        )
        hist_all += hist
        if res <= eps * b_norm or rank >= ceiling:
            return x, res, hist_all
        rank = min(2 * rank, ceiling)
        x = _grow(x, rank)
