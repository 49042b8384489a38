"""Time integration for TT/QTT states.

Counterpart of ``tensor_networks_tpu/ops/evolve.py``.  Integrators for
``M du/dt = -A u`` in TT format:

* :func:`evolve_theta` -- the one-parameter theta family

      (M + theta dt A) u_{n+1} = (M - (1 - theta) dt A) u_n

  (``theta=1`` implicit Euler, ``theta=0.5`` Crank-Nicolson).  Both step
  operators are assembled once with the packed operator algebra and
  every step is one :func:`ops.als.als_solve` warm-started from the
  previous state.

* :func:`evolve_tdvp` -- one-site projector-splitting TDVP
  (Lubich-Oseledets): each core is evolved exactly under its projected
  effective operator and each bond factor backward.  Second order,
  rank-preserving, exact whenever the solution stays on the rank
  manifold.

* :func:`evolve_tdvp2` -- the two-site variant: each adjacent pair of
  cores is merged, evolved exactly and re-split by a truncated SVD at
  the static ``max_rank``, so bond ranks follow the dynamics.

* :func:`tdvp_trajectory` -- the fused one-site trajectory as a pure
  function of tensors, differentiable through ``torch.autograd``.

The local exponentials run dense below ``dense_limit`` unknowns and by
a ``kdim``-step Lanczos ``expm @ v`` above it (symmetric ``A`` assumed).
Both take the exponential of a small matrix with :func:`_expm`: Taylor
degree 18 with scaling and squaring, the scaling exponent computed on
the device and a fixed number of squarings, masked above it, bounded
once per trajectory from ``|dt|`` and a bound on ``|A|_2``
(:func:`_squarings`).  ``torch.linalg.matrix_exp``
reads its operand's norm on the host to choose its degree, one host
sync a call, which a fused step may not make.  The exponential is
evaluated in float64 whatever the operands' dtype (float32 squarings
alone lose ~1e-6 at scaled norms of 50).

"Fused" is the meaning of :mod:`ops.als`: a Python loop over the
stacked ``(d-2, r, n, r)`` cores with no host read inside a step --
the only syncs there are cuSOLVER's status checks (the two-site
split's SVD).  Norms, effective ranks and observables stay on the
device and are read once a trajectory (once a step when a callback
observes it).  The arithmetic is the host loop's call for call.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Callable, List, Optional, Tuple

import torch
import torch.nn.functional as F

from tensor_networks_tpu_torch.ops.als import (
    _adv_left,
    _adv_right,
    _canonicalize,
    _core_lists,
    _local_dense,
    _matvec,
    _packed_of,
    _scan,
    als_solve,
)
from tensor_networks_tpu_torch.ops.packed import (
    PackedTT,
    PackedTTOp,
    add,
    inner,
    norm_exact,
    pad_rank,
    scale,
    svd_round,
    ttop_add,
    ttop_apply_packed,
    ttop_identity,
    ttop_round,
    ttop_scale,
)

__all__ = [
    "evolve_theta",
    "evolve_tdvp",
    "evolve_tdvp2",
    "tdvp_trajectory",
]


def evolve_theta(
    A: PackedTTOp,
    u0: PackedTT,
    dt: float,
    steps: int,
    theta: float = 1.0,
    mass: PackedTTOp = None,
    source=None,
    rank: int = None,
    sweeps: int = 4,
    tol: float = 1e-10,
    op_eps: float = 1e-13,
    callback: Optional[Callable[[int, PackedTT], None]] = None,
    observables: Tuple[PackedTTOp, ...] = (),
    **solve_kw,
) -> Tuple[PackedTT, List[float]]:
    """Integrate ``M du/dt = -A u + f`` for ``steps`` steps of size ``dt``.

    Returns ``(u_final, residuals)`` with one ALS residual per step.
    ``source`` is the forcing ``f``: a :class:`PackedTT` for a constant
    source, or a callable ``t -> PackedTT`` evaluated at the theta
    quadrature points (``dt (theta f(t_{n+1}) + (1-theta) f(t_n))``
    joins the right-hand side each step).  ``rank`` bounds the solution
    rank (default: ``u0``'s rank); the right-hand side
    ``(M - (1-theta) dt A) u_n [+ source]`` is rounded back to it each
    step.  ``callback(n, u)`` observes the trajectory.  ``observables``:
    TT-operators whose raw expectations ``<u, O u>`` are recorded after
    every step (through the inner product kernel on the card); when
    given, the return gains a third element with the per-step value
    tuples.  Extra keyword arguments reach :func:`als_solve` (e.g.
    ``spd=True`` for symmetric ``A``/``M``).
    """
    if not 0.0 <= theta <= 1.0:
        raise ValueError(f"theta must be in [0, 1], got {theta}")
    if theta == 0.0:
        raise ValueError(
            "theta=0 (explicit Euler) needs no solver -- apply "
            "ttop_add(M_inv-weighted ...) directly; this integrator "
            "covers the implicit family theta in (0, 1]"
        )
    d, n = u0.d, u0.mode
    M = mass if mass is not None else ttop_identity(
        d, n, u0.first.dtype, device=u0.first.device)
    lhs = ttop_round(ttop_add(M, ttop_scale(A, theta * dt)), op_eps)
    if theta < 1.0:
        rhs_op = ttop_round(
            ttop_add(M, ttop_scale(A, -(1.0 - theta) * dt)), op_eps
        )
    else:
        rhs_op = M
    rank = int(rank) if rank is not None else u0.rank

    g_const = None
    if source is not None and not callable(source):
        # constant f: theta dt f + (1-theta) dt f = dt f
        g_const = scale(source, dt)

    # theta=1 with no mass makes the RHS operator the bare identity:
    # applying it (and re-rounding) would reproduce u at the cost of an
    # operator apply and a d-core sweep a step
    identity_rhs = mass is None and theta == 1.0

    u = svd_round(u0, rank) if u0.rank != rank else u0
    residuals: List[float] = []
    obs: List[Tuple[float, ...]] = []
    for step in range(steps):
        b = u if identity_rhs else ttop_apply_packed(rhs_op, u)
        if source is not None:
            if g_const is not None:
                g = g_const
            else:
                f1 = scale(source((step + 1) * dt), theta * dt)
                if theta < 1.0:
                    g = add(f1, scale(source(step * dt), (1.0 - theta) * dt))
                else:
                    g = f1
            b = add(b, g)
        if b is not u:
            b = svd_round(b, rank)
        u, res, _ = als_solve(
            lhs, b, u, sweeps=sweeps, tol=tol * float(norm_exact(b)), **solve_kw,
        )
        residuals.append(res)
        if observables:
            obs.append(_obs_host(observables, u))
        if callback is not None:
            callback(step, u)
    if observables:
        return u, residuals, obs
    return u, residuals


# -- local exponentials ------------------------------------------------------------
# Index conventions follow ops.als: ket core (a, j, b); operator core
# (s, i, j, t); left env L (p, s, a); right env R (q, t, c).  The bond
# (zero-site) effective operator between adjacent cores contracts the
# two environments over the shared operator bond.

#: the Taylor degree and the 1-norm the scaled operand is brought under:
#: the truncation error is below 1/19! (8e-18) there
_TAYLOR_DEGREE, _THETA = 18, 1.0


@lru_cache(maxsize=8)
def _taylor_blocks(device: torch.device) -> torch.Tensor:
    """The coefficients 1/k!, k = 0..18, as Paterson-Stockmeyer blocks
    ``(5, 4)``: row j weighs ``I, X, X^2, X^3`` in the j-th factor of
    ``X^4``.  Copied to the device once: the copy waits for it, so a step
    must not make it."""
    c = [1.0 / math.factorial(k) for k in range(_TAYLOR_DEGREE + 1)]
    c += [0.0] * (20 - len(c))
    return torch.tensor(c, dtype=torch.float64, device=device).reshape(5, 4)


def _expm(A: torch.Tensor, squarings: int) -> torch.Tensor:
    """``exp(A)`` of a square matrix with no host sync, in float64.

    The scaling exponent ``s = ceil(log2(|A|_1 / theta))`` is computed
    on the device and clamped to ``[0, squarings]``; the degree-18
    Taylor polynomial of ``A / 2^s`` (seven products) is then squared
    ``squarings`` times, each squaring past ``s`` masked out.  The
    caller guarantees ``s <= squarings`` (:func:`_squarings`).
    Differentiable: every step is a torch op.
    """
    X = A.to(torch.float64)
    dev, m = X.device, X.shape[0]
    s = torch.clamp(torch.ceil(torch.log2(X.abs().sum(0).amax() / _THETA)),
                    min=0, max=squarings)
    X = X * torch.exp2(-s)
    X2 = X @ X
    X4 = X2 @ X2
    powers = torch.stack([torch.eye(m, dtype=X.dtype, device=dev), X, X2, X2 @ X])
    blocks = torch.einsum("bk,kij->bij", _taylor_blocks(dev), powers)
    E = blocks[4]
    for j in (3, 2, 1, 0):
        E = torch.addmm(blocks[j], X4, E)
    live = s > torch.arange(squarings, dtype=X.dtype, device=dev)
    for i in range(squarings):
        E = torch.where(live[i], E @ E, E)
    return E.to(A.dtype)


def _op_norm_bound(A: PackedTTOp) -> float:
    """An upper bound on ``|A|_2``, read from the device once: the smaller
    of ``|A|_F`` and ``sqrt(|A|_1 |A|_inf)``.  Each induced norm is the
    largest row (column) sum of ``|A|``, a sum over bond paths of
    products of nonnegative core entries, so the product of the cores'
    entrywise maxima of their row (column) sums bounds it."""
    with torch.no_grad():
        first, mids, last = (t.detach() for t in A)
        no, ni, R = first.shape
        fro = norm_exact(PackedTT(first.reshape(no * ni, R),
                                  mids.reshape(mids.shape[0], R, no * ni, R),
                                  last.reshape(R, no * ni)))
        first, mids, last = first.abs(), mids.abs(), last.abs()

        def induced(axis):  # 1: row sums (|A|_inf), 0: column sums (|A|_1)
            v = first.sum(axis).amax(0)
            for m in mids.sum(axis + 2).amax(2):
                v = v @ m
            return v @ last.sum(axis + 1).amax(1)

        return float(torch.minimum(fro, torch.sqrt(induced(1) * induced(0))))


def _squarings(A: PackedTTOp, coef: float, local: int, dense_limit: int,
               kdim: int) -> int:
    """The squarings :func:`_expm` needs for every local exponential of
    one trajectory, from one host read (:func:`_op_norm_bound`)."""
    return _squarings_for(_op_norm_bound(A), coef, local, dense_limit, kdim)


def _squarings_for(norm_bound: float, coef: float, local: int, dense_limit: int,
                   kdim: int) -> int:
    """:func:`_squarings` from a bound on ``|A|_2``.

    A local operator is ``H = P^T A P`` with a frame of norm at most 1
    (orthonormal or zero-padded cores), so ``|coef H|_1 <= sqrt(m)
    |coef| |A|_2`` for ``m`` unknowns: up to ``local`` (the largest local
    block) below ``dense_limit``, else the ``kdim x kdim`` Lanczos
    tridiagonal.  One more squaring covers the frames' roundoff."""
    m = max(min(local, dense_limit), kdim)
    bound = abs(coef) * math.sqrt(m) * norm_bound
    if not bound > _THETA:  # also 0 and NaN: the clamp keeps s at 0
        return 1
    return math.ceil(math.log2(bound / _THETA)) + 1


def _bond_dense(L, R):
    K = torch.einsum("psa,qsc->pqac", L, R)
    m = K.shape[0] * K.shape[1]
    return K.reshape(m, m)


def _bond_mv(operands, v):
    L, R = operands
    t = torch.einsum("psa,ac->psc", L, v)
    return torch.einsum("psc,qsc->pq", t, R)


def _site_mv(operands, v):
    L, ak, R = operands
    return _matvec(L, ak, R, v)


def _expm_apply_dense(H, v, coef, squarings):
    E = _expm(coef * H, squarings)
    return (E @ v.reshape(-1)).reshape(v.shape)


def _lanczos_expm_apply(mv, operands, v, coef, kdim, squarings):
    """``expm(coef * H) @ v`` from a ``kdim``-step Lanczos space.

    ``H`` is the SYMMETRIC operator ``x -> mv(operands, x)``.  Every
    step of the budget runs; each is fully reorthogonalized against the
    ``(kdim, m)`` basis buffer (rows past the step are zero, so the
    projection is exact).  On breakdown (``beta`` at roundoff of
    ``max(|alpha|, 1)``, the JAX package's rule) the off-diagonal and
    the next basis vector are zeroed on the device, which makes the
    small exponential exact on the closed subspace.  The basis is
    written out of place, so the process differentiates.
    """
    dt = v.dtype
    shape, m = v.shape, v.numel()
    eps = torch.finfo(dt).eps
    v0 = v.reshape(-1)
    nrm = torch.linalg.norm(v0)
    q = v0 / torch.clamp(nrm, min=1e-300 if dt == torch.float64 else 1e-30)
    rows = torch.arange(kdim, device=v.device)[:, None]
    V = v0.new_zeros((kdim, m))
    q_prev, beta = torch.zeros_like(q), v0.new_zeros(())
    alphas, betas = [], []
    for j in range(kdim):
        V = torch.where(rows == j, q, V)
        w = mv(operands, q.reshape(shape)).reshape(-1)
        alpha = w @ q
        w = w - alpha * q - beta * q_prev
        w = w - V.T @ (V @ w)
        b = torch.linalg.norm(w)
        ok = b > 100.0 * eps * torch.clamp(torch.abs(alpha), min=1.0)
        q_prev, q = q, torch.where(ok, w / torch.clamp(b, min=eps * eps), 0.0)
        beta = torch.where(ok, b, 0.0)
        alphas.append(alpha)
        betas.append(beta)
    off = torch.stack(betas[:-1]) if kdim > 1 else v0.new_zeros((0,))
    T = torch.diag(torch.stack(alphas)) + torch.diag(off, 1) + torch.diag(off, -1)
    E = _expm(coef * T, squarings)
    return (nrm * (V.T @ E[:, 0])).reshape(shape)


def _site_evolve(L, ak, R, v, coef, dense_limit, kdim, squarings):
    if v.numel() <= dense_limit:
        return _expm_apply_dense(_local_dense(L, ak, R), v, coef, squarings)
    return _lanczos_expm_apply(_site_mv, (L, ak, R), v, coef, kdim, squarings)


def _bond_evolve(L, R, s, coef, dense_limit, kdim, squarings):
    if s.numel() <= dense_limit:
        return _expm_apply_dense(_bond_dense(L, R), s, coef, squarings)
    return _lanczos_expm_apply(_bond_mv, (L, R), s, coef, kdim, squarings)


# -- gauge splits and state plumbing -----------------------------------------------


def _split_left(core):
    """``core = Q S`` with Q left-orthogonal; zero-padded if deficient."""
    r1, n, r2 = core.shape
    q, smat = torch.linalg.qr(core.reshape(r1 * n, r2))
    if q.shape[1] < r2:
        smat = F.pad(smat, (0, 0, 0, r2 - q.shape[1]))
        q = F.pad(q, (0, r2 - q.shape[1]))
    return q.reshape(r1, n, r2), smat


def _split_right(core):
    """``core = S Q`` with Q right-orthogonal; zero-padded if deficient."""
    r1, n, r2 = core.shape
    q, rmat = torch.linalg.qr(core.reshape(r1, n * r2).T)
    if q.shape[1] < r1:
        rmat = F.pad(rmat, (0, 0, 0, r1 - q.shape[1]))
        q = F.pad(q, (0, r1 - q.shape[1]))
    return q.T.reshape(r1, n, r2), rmat.T


def _repack(xs: List[torch.Tensor]) -> PackedTT:
    if len(xs) > 2:
        mids = torch.stack(xs[1:-1])
    else:  # d=2: no mid cores -- (0, r, n, r) placeholder
        _, n, r = xs[0].shape
        mids = xs[0].new_zeros((0, r, n, r))
    return _packed_of(xs[0], mids, xs[-1])


def _right_envs(xs, as_, one3) -> List[torch.Tensor]:
    """Reversed right-environment prefixes: ``[I, env(d-1), ..., env(d-1..1)]``."""
    rev_rs = [one3]
    for k in range(len(xs) - 1, 0, -1):
        rev_rs.append(_adv_right(rev_rs[-1], xs[k], as_[k]))
    return rev_rs


def _sandwich_fused(x0, X, xl, o0, Om, ol):
    """``<x, O x>`` on the stacked layout -- one left-env pass over the
    train (the observable hook of the fused trajectories)."""
    env = _adv_left(_ones3(x0), x0, o0)
    for xk, ok in zip(X, Om):
        env = _adv_left(env, xk, ok)
    return _adv_left(env, xl, ol)[0, 0, 0]


def _obs_stacks(observables, dtp):
    """Per-observable stacked cores ``(o0, Om, ol)`` for the fused paths."""
    return tuple(
        (o.first[None].to(dtp), o.mids.to(dtp), o.last[..., None].to(dtp))
        for o in observables
    )


def _obs_host(observables, u: PackedTT) -> Tuple[float, ...]:
    """Host-path observable values ``<u, O u>`` through :func:`inner`
    (the H1 kernel for CUDA tensors); parity with the fused hook at
    roundoff."""
    dt = u.first.dtype
    return tuple(
        float(inner(u, ttop_apply_packed(PackedTTOp(*(t.to(dt) for t in o)), u)))
        for o in observables
    )


def _ones3(like):
    return torch.ones((1, 1, 1), dtype=like.dtype, device=like.device)


def _step_size(dt, like) -> torch.Tensor:
    """``dt`` as a 0-d tensor beside ``like``: a tensor keeps its graph;
    a number is written by a fill kernel (a copy from the host would
    wait for the device)."""
    if isinstance(dt, torch.Tensor):
        return dt.to(dtype=like.dtype, device=like.device)
    return torch.full((), float(dt), dtype=like.dtype, device=like.device)


def evolve_tdvp(
    A: PackedTTOp,
    u0: PackedTT,
    dt: float,
    steps: int,
    krylov: int = 24,
    dense_limit: int = 1024,
    callback: Optional[Callable[[int, PackedTT], None]] = None,
    fused: Optional[bool] = None,
    observables: Tuple[PackedTTOp, ...] = (),
) -> Tuple[PackedTT, List[float]]:
    """Integrate ``du/dt = -A u`` by one-site projector-splitting TDVP.

    ``A`` must be symmetric (the Lanczos local exponentials assume it;
    below ``dense_limit`` local unknowns the dense path tolerates any
    ``A``).  Every step is two half-sweeps of exact local exponentials
    -- no linear solves, no rank rounding: the bond ranks of ``u0`` are
    preserved, and the integrator is exact whenever the true solution
    stays on that rank manifold.  Returns ``(u_final, norms)`` with the
    state norm after each step (after the backward half-sweep all mass
    sits in the first core).

    ``krylov`` bounds the Lanczos space of the large local
    exponentials.  ``callback(n, u)`` observes the trajectory.

    ``fused`` (default on) runs each step over the stacked cores with no
    host read inside it; norms (and observables) are read once a
    trajectory, or once a step when a callback observes it.  The
    arithmetic is the host loop's (``fused=False``) call for call.

    ``observables``: TT-operators ``O`` whose raw expectations
    ``<u, O u>`` are recorded after every step -- on the device in the
    fused form (one extra env pass each per step), through the inner
    product kernel in the host loop.  When given, the return gains a
    third element: a list of per-step value tuples.
    """
    if fused is None:
        fused = True
    dtp = u0.first.dtype
    squarings = _squarings(A, 0.5 * float(dt), u0.rank * u0.mode * u0.rank,
                           dense_limit, krylov)
    if fused:
        x0, X, xl, a0, Am, al = _fused_operands(A, u0)
        h = _step_size(dt, x0)
        obs_stk = _obs_stacks(observables, dtp)
        if callback is None:
            x0, X, xl, norms_dev, obs_dev = _tdvp_traj_fused(
                x0, X, xl, a0, Am, al, h, obs_stk,
                steps, dense_limit, krylov, squarings,
            )
            rec = torch.cat([norms_dev[:, None], obs_dev], 1).cpu().tolist()
            u = _packed_of(x0, X, xl)
            norms = [row[0] for row in rec]
            if observables:
                return u, norms, [tuple(row[1:]) for row in rec]
            return u, norms
        norms = []
        obs: List[Tuple[float, ...]] = []
        for step in range(steps):
            x0, X, xl = _tdvp_step_impl(
                x0, X, xl, a0, Am, al, h, dense_limit, krylov, squarings
            )
            norms.append(float(torch.linalg.norm(x0)))
            if observables:
                obs.append(tuple(
                    float(_sandwich_fused(x0, X, xl, *stk)) for stk in obs_stk
                ))
            callback(step, _packed_of(x0, X, xl))
        u = _packed_of(x0, X, xl)
        return (u, norms, obs) if observables else (u, norms)
    xs = _core_lists(u0, dtp)
    as_ = _core_lists(A, dtp)
    d = len(xs)
    h = float(dt)
    knobs = (dense_limit, krylov, squarings)

    _canonicalize(xs)

    one3 = _ones3(xs[0])
    norms: List[float] = []
    obs: List[Tuple[float, ...]] = []
    # the backward half-sweep of each step leaves exactly the right-env
    # chain the next forward pass needs (cores k..d-1 are final and
    # right-canonical when env k is recorded), so it is built once here
    # and thereafter reused across steps
    rev_rs = _right_envs(xs, as_, one3)

    for step in range(steps):
        rs = rev_rs[::-1]

        # left -> right half step: site forward h/2, bond backward h/2
        ls = [one3]
        for k in range(d):
            xs[k] = _site_evolve(ls[-1], as_[k], rs[k], xs[k], -0.5 * h, *knobs)
            if k < d - 1:
                xs[k], smat = _split_left(xs[k])
                ls.append(_adv_left(ls[-1], xs[k], as_[k]))
                smat = _bond_evolve(ls[-1], rs[k], smat, +0.5 * h, *knobs)
                xs[k + 1] = torch.einsum("ab,bnc->anc", smat, xs[k + 1])

        # right -> left half step (mirror)
        rev_rs = [one3]
        for k in range(d - 1, -1, -1):
            xs[k] = _site_evolve(ls[k], as_[k], rev_rs[-1], xs[k], -0.5 * h, *knobs)
            if k > 0:
                xs[k], smat = _split_right(xs[k])
                rev_rs.append(_adv_right(rev_rs[-1], xs[k], as_[k]))
                smat = _bond_evolve(ls[k], rev_rs[-1], smat, +0.5 * h, *knobs)
                xs[k - 1] = torch.einsum("anb,bc->anc", xs[k - 1], smat)

        norms.append(float(torch.linalg.norm(xs[0])))
        if observables:
            obs.append(_obs_host(observables, _repack(xs)))
        if callback is not None:
            callback(step, _repack(xs))

    if observables:
        return _repack(xs), norms, obs
    return _repack(xs), norms


# -- fused one-site TDVP ------------------------------------------------------------
# Packed trains are uniform (mid cores (r, n, r), operator mids
# (s, n, n, s)), so the symmetric step runs over the stacks: boundary
# cores explicit, mid cores a loop over scan bodies.  The bodies are
# module-level builders, the JAX package's scan bodies, so a distributed
# step can run the same arithmetic.  Unlike the host loop, each step
# rebuilds its right-env chain at its top (the same calls on the same
# cores as the host loop's reuse).


def _tdvp_renv_body(R, inp):
    """Right-env body, emitting the PRE-absorb env at each core."""
    xk, ak = inp
    return _adv_right(R, xk, ak), R


def _tdvp_fwd_body_of(h, dense_limit, kdim, squarings):
    """Forward mid-core half-sweep body: absorb the bond factor, evolve
    the site forward, split left, evolve the new bond backward.  Emits
    (orthogonal core, PRE-update left env -- the backward sweep's ls[k])."""
    lo, hi = -0.5 * h, 0.5 * h

    def fwd_body(carry, inp):
        L, s = carry
        xk, ak, Rk = inp
        zk = torch.einsum("ab,bnc->anc", s, xk)
        zk = _site_evolve(L, ak, Rk, zk, lo, dense_limit, kdim, squarings)
        q, s2 = _split_left(zk)
        Ln = _adv_left(L, q, ak)
        s2 = _bond_evolve(Ln, Rk, s2, hi, dense_limit, kdim, squarings)
        return (Ln, s2), (q, L)

    return fwd_body


def _tdvp_bwd_body_of(h, dense_limit, kdim, squarings):
    """Backward mid-core half-sweep body (mirror of the forward one)."""
    lo, hi = -0.5 * h, 0.5 * h

    def bwd_body(carry, inp):
        R, s = carry
        qk, ak, Lk = inp
        zk = torch.einsum("anb,bc->anc", qk, s)
        zk = _site_evolve(Lk, ak, R, zk, lo, dense_limit, kdim, squarings)
        vk, s2 = _split_right(zk)
        Rn = _adv_right(R, vk, ak)
        s2 = _bond_evolve(Lk, Rn, s2, hi, dense_limit, kdim, squarings)
        return (Rn, s2), vk

    return bwd_body


def _tdvp_step_impl(x0, X, xl, a0, Am, al, h, dense_limit, kdim, squarings):
    """One symmetric one-site TDVP step; inputs right-canonical.

    ``x0 (1, n, r)``, ``X (m, r, n, r)``, ``xl (r, n, 1)``; operator
    cores ``a0 (1, n, n, s)``, ``Am (m, s, n, n, s)``, ``al (s, n, n, 1)``.
    Returns the same layout, right-canonical again.  No host read.
    """
    one3 = _ones3(x0)
    lo, hi = -0.5 * h, 0.5 * h
    knobs = (dense_limit, kdim, squarings)
    Xs, As = list(X), list(Am)

    # right-env chain (rs_mid[j] = env of cores j+2..d-1): the body emits
    # its carry BEFORE absorbing mid j
    r_front, rs_rev = _scan(_tdvp_renv_body, _adv_right(one3, xl, al),
                            (Xs[::-1], As[::-1]))
    rs_mid = rs_rev[::-1]

    # forward half-sweep: core 0 explicit, mids as one scan
    z = _site_evolve(one3, a0, r_front, x0, lo, *knobs)
    x0q, smat = _split_left(z)
    lenv = _adv_left(one3, x0q, a0)
    smat = _bond_evolve(lenv, r_front, smat, hi, *knobs)
    (l_back, smat), outs = _scan(_tdvp_fwd_body_of(h, *knobs), (lenv, smat),
                                 (Xs, As, rs_mid))
    Q = [o[0] for o in outs]
    ls_mid = [o[1] for o in outs]

    zl = torch.einsum("ab,bnc->anc", smat, xl)
    zl = _site_evolve(l_back, al, one3, zl, lo, *knobs)

    # backward half-sweep (mirror): last core explicit, mids reversed
    zl = _site_evolve(l_back, al, one3, zl, lo, *knobs)
    xlq, smat = _split_right(zl)
    renv = _adv_right(one3, xlq, al)
    smat = _bond_evolve(l_back, renv, smat, hi, *knobs)
    (r_back, smat), v_rev = _scan(_tdvp_bwd_body_of(h, *knobs), (renv, smat),
                                  (Q[::-1], As[::-1], ls_mid[::-1]))
    V = torch.stack(v_rev[::-1]) if v_rev else X

    z0 = torch.einsum("anb,bc->anc", x0q, smat)
    z0 = _site_evolve(one3, a0, r_back, z0, lo, *knobs)
    return z0, V, xlq


def _tdvp_traj_fused(x0, X, xl, a0, Am, al, h, obs_stk, steps, dense_limit,
                     kdim, squarings):
    """A whole TDVP trajectory on the device: the state, the norms
    ``(steps,)`` and the observables ``(steps, len(obs_stk))``.  Each
    observable contributes one ``<u, O u>`` env pass per step."""
    norms, obs = [], []
    for _ in range(steps):
        x0, X, xl = _tdvp_step_impl(x0, X, xl, a0, Am, al, h, dense_limit,
                                    kdim, squarings)
        norms.append(torch.linalg.norm(x0))
        obs.append(torch.stack([_sandwich_fused(x0, X, xl, *stk) for stk in obs_stk])
                   if obs_stk else x0.new_zeros((0,)))
    if not steps:
        return x0, X, xl, x0.new_zeros((0,)), x0.new_zeros((0, len(obs_stk)))
    return x0, X, xl, torch.stack(norms), torch.stack(obs)


def tdvp_trajectory(
    A: PackedTTOp,
    u0: PackedTT,
    dt,
    steps: int,
    observables: Tuple[PackedTTOp, ...] = (),
    krylov: int = 24,
    dense_limit: int = 1024,
) -> Tuple[PackedTT, torch.Tensor, torch.Tensor]:
    """The fused one-site TDVP trajectory as a PURE function of tensors.

    Same integrator as :func:`evolve_tdvp` (fused path), but nothing is
    fetched to the host inside the trajectory: returns ``(u_final,
    norms (steps,), obs (steps, n_obs))`` as tensors on the state's
    device, and the whole trajectory is DIFFERENTIABLE through
    ``torch.autograd``: gradients w.r.t. the operator cores, the initial
    state and ``dt`` (a tensor) flow through every step (QR, the local
    exponentials, the Lanczos path where it is reached).  The squaring
    count of the exponentials is set once from ``|dt|`` and a bound on
    ``|A|_2`` (one host read each, before the first step).

    Caveats: ``A`` symmetric (the TDVP regime); for reverse mode every
    bond rank must not exceed the mode product on either side -- the QR
    pullback needs tall factors, so OVERPARAMETERIZED (padded) trains
    have no gradient.
    """
    dtp = u0.first.dtype
    x0, X, xl, a0, Am, al = _fused_operands(A, u0)
    h = _step_size(dt, x0)
    squarings = _squarings(A, 0.5 * float(h.detach()), u0.rank * u0.mode * u0.rank,
                           dense_limit, krylov)
    x0, X, xl, norms, obs = _tdvp_traj_fused(
        x0, X, xl, a0, Am, al, h, _obs_stacks(observables, dtp),
        steps, dense_limit, krylov, squarings,
    )
    return _packed_of(x0, X, xl), norms, obs


def _fused_operands(A, u0):
    """Right-canonicalized stacked state + operator stacks for the fused path."""
    dtp = u0.first.dtype
    xs = _core_lists(u0, dtp)
    _canonicalize(xs)
    x0, xl = xs[0], xs[-1]
    X = torch.stack(xs[1:-1]) if len(xs) > 2 else u0.mids.to(dtp)
    a0 = A.first[None].to(dtp)
    Am = A.mids.to(dtp)
    al = A.last[..., None].to(dtp)
    return x0, X, xl, a0, Am, al


# -- two-site TDVP (rank-adaptive up to a static max_rank) -------------------------
# Two-site block theta (a, j, l, c); operator pair a1 (s, i, j, m),
# a2 (m, k, l, t); environments L (p, s, a) / R (q, t, c).


def _theta2_dense(L, a1, a2, R):
    h1 = torch.einsum("psa,sijm->paijm", L, a1)
    h2 = torch.einsum("paijm,mklt->paijklt", h1, a2)
    H = torch.einsum("paijklt,qtc->pikqajlc", h2, R)
    m = H.shape[0] * H.shape[1] * H.shape[2] * H.shape[3]
    return H.reshape(m, m)


def _theta2_mv(operands, v):
    L, a1, a2, R = operands
    v1 = torch.einsum("psa,ajlc->psjlc", L, v)
    v2 = torch.einsum("psjlc,sijm->pimlc", v1, a1)
    v3 = torch.einsum("pimlc,mklt->piktc", v2, a2)
    return torch.einsum("piktc,qtc->pikq", v3, R)


def _theta_evolve(L, a1, a2, R, theta, coef, dense_limit, kdim, squarings):
    if theta.numel() <= dense_limit:
        return _expm_apply_dense(_theta2_dense(L, a1, a2, R), theta, coef, squarings)
    return _lanczos_expm_apply(_theta2_mv, (L, a1, a2, R), theta, coef, kdim,
                               squarings)


def _split_theta(theta, rank, eps):
    """Truncated SVD of a two-site block at STATIC output rank.

    Keeps the top ``rank`` singular triplets (zero-padded when the block
    is thinner than ``rank``), zeroes singular values below
    ``eps * ||s||`` and reports the effective rank, computed on the
    device.  Returns ``(u3, s, v3, keff)`` with ``u3 (a, n1, rank)``
    column-orthonormal and ``v3 (rank, n2, c)`` row-orthonormal; the
    caller folds ``s`` into whichever side the sweep direction
    requires.  ``torch.linalg.svd`` reads cuSOLVER's status on the host.
    """
    a, n1, n2, c = theta.shape
    u, s, vt = torch.linalg.svd(theta.reshape(a * n1, n2 * c), full_matrices=False)
    keep = s > eps * torch.linalg.norm(s)
    keff = keep.sum()
    s = torch.where(keep, s, 0.0)
    k = s.shape[0]
    if k >= rank:
        u, s, vt = u[:, :rank], s[:rank], vt[:rank]
    else:
        u = F.pad(u, (0, rank - k))
        s = F.pad(s, (0, rank - k))
        vt = F.pad(vt, (0, 0, 0, rank - k))
    return (
        u.reshape(a, n1, rank),
        s,
        vt.reshape(rank, n2, c),
        torch.clamp(keff, max=rank),
    )


def _merge2(x1, x2):
    return torch.einsum("ajb,blc->ajlc", x1, x2)


def _tdvp2_fwd_body_of(h, eps, dense_limit, kdim, rank, squarings):
    """Forward mid-pair half-sweep body: merge the carried (evolved)
    core with the next one, evolve the pair, split at the static rank,
    back-evolve the new bond-carrying core.  The carry is ``(left env,
    evolved core)``.  Emits ``(q, PRE-update env, effective rank)``."""
    lo, hi = -0.5 * h, 0.5 * h

    def fwd_body(carry, inp):
        L, c = carry
        xk1, a1, a2, Rk = inp
        th = _merge2(c, xk1)
        th = _theta_evolve(L, a1, a2, Rk, th, lo, dense_limit, kdim, squarings)
        q, sk, vk, keff = _split_theta(th, rank, eps)
        Ln = _adv_left(L, q, a1)
        svk = sk[:, None, None] * vk
        svk = _site_evolve(Ln, a2, Rk, svk, hi, dense_limit, kdim, squarings)
        # emit the PRE-update env: the backward sweep needs ls[k]
        # (cores 0..k-1) at this pair
        return (Ln, svk), (q, L, keff)

    return fwd_body


def _tdvp2_bwd_body_of(h, eps, dense_limit, kdim, rank, squarings):
    """Backward mid-pair half-sweep body (mirror of the forward one)."""
    lo, hi = -0.5 * h, 0.5 * h

    def bwd_body(carry, inp):
        R, c2 = carry
        qk, a1, a2, Lk = inp
        th = _merge2(qk, c2)
        th = _theta_evolve(Lk, a1, a2, R, th, lo, dense_limit, kdim, squarings)
        uk, sk, vk, keff = _split_theta(th, rank, eps)
        Rn = _adv_right(R, vk, a2)
        usk = uk * sk[None, None, :]
        usk = _site_evolve(Lk, a1, Rn, usk, hi, dense_limit, kdim, squarings)
        return (Rn, usk), (vk, keff)

    return bwd_body


def _tdvp2_step_impl(x0, X, xl, a0, Am, al, h, eps, dense_limit, kdim, rank,
                     squarings):
    """One symmetric two-site TDVP step; inputs right-canonical, d >= 3.

    ``x0 (1, n, r)``, ``X (m, r, n, r)``, ``xl (r, n, 1)`` with
    ``r == rank``; operator cores ``a0 (1, n, n, s)``,
    ``Am (m, s, n, n, s)``, ``al (s, n, n, 1)``.  Same layout out,
    right-canonical again, plus the effective bond ranks of all
    ``2 (d-1)`` splits, on the device.  The arithmetic is the host
    loop's call for call.
    """
    one3 = _ones3(x0)
    lo, hi = -0.5 * h, 0.5 * h
    knobs = (dense_limit, kdim, squarings)
    Xs, As = list(X), list(Am)

    # right-env chain: rs_mid[j] = env right of core j+1 (cores j+2..d-1)
    _, rs_rev = _scan(_tdvp_renv_body, _adv_right(one3, xl, al), (Xs[::-1], As[::-1]))
    rs_mid = rs_rev[::-1]

    # forward half-sweep: pair (0,1) explicit, pairs (k,k+1) k=1..d-3
    # as one scan, pair (d-2,d-1) explicit
    theta = _merge2(x0, Xs[0])
    theta = _theta_evolve(one3, a0, As[0], rs_mid[0], theta, lo, *knobs)
    u0q, s, v3, k0 = _split_theta(theta, rank, eps)
    lenv = _adv_left(one3, u0q, a0)
    sv = s[:, None, None] * v3
    sv = _site_evolve(lenv, As[0], rs_mid[0], sv, hi, *knobs)

    (l_back, c), outs = _scan(
        _tdvp2_fwd_body_of(h, eps, dense_limit, kdim, rank, squarings),
        (lenv, sv), (Xs[1:], As[:-1], As[1:], rs_mid[1:]),
    )
    Q = [o[0] for o in outs]
    ls_mid = [o[1] for o in outs]
    kf_mid = [o[2] for o in outs]

    theta = _merge2(c, xl)
    theta = _theta_evolve(l_back, As[-1], al, one3, theta, lo, *knobs)
    ulq, s, vl, kl = _split_theta(theta, rank, eps)
    svl = s[:, None, None] * vl  # not back-evolved: the last pair ends
    # the forward half-sweep, and the backward one re-merges it first

    # backward half-sweep (mirror): pair (d-2,d-1) explicit first
    theta = _merge2(ulq, svl)
    theta = _theta_evolve(l_back, As[-1], al, one3, theta, lo, *knobs)
    ub, s, xln, kl2 = _split_theta(theta, rank, eps)
    renv = _adv_right(one3, xln, al)
    us = ub * s[None, None, :]
    us = _site_evolve(l_back, As[-1], renv, us, hi, *knobs)

    (r_back, c2), outs = _scan(
        _tdvp2_bwd_body_of(h, eps, dense_limit, kdim, rank, squarings),
        (renv, us), (Q[::-1], As[:-1][::-1], As[1:][::-1], ls_mid[::-1]),
    )
    v_rev = [o[0] for o in outs]
    kb_mid = [o[1] for o in outs]

    # final pair (0,1): no backward site evolve on the new first core
    theta = _merge2(u0q, c2)
    theta = _theta_evolve(one3, a0, As[0], r_back, theta, lo, *knobs)
    z0, s, v1, k0b = _split_theta(theta, rank, eps)
    z0 = z0 * s[None, None, :]

    Xn = torch.stack([v1] + v_rev[::-1])
    keffs = torch.stack([k0, kl, kl2, k0b] + kf_mid + kb_mid)
    return z0, Xn, xln, keffs


def _tdvp2_traj_fused(x0, X, xl, a0, Am, al, h, eps, obs_stk, steps,
                      dense_limit, kdim, rank, squarings):
    """A whole two-site trajectory on the device: the state and one
    record row a step (the norm, the largest effective rank, the
    observables)."""
    rows = []
    for _ in range(steps):
        x0, X, xl, keffs = _tdvp2_step_impl(
            x0, X, xl, a0, Am, al, h, eps, dense_limit, kdim, rank, squarings
        )
        rows.append(torch.stack(
            [torch.linalg.norm(x0), keffs.max().to(x0.dtype)]
            + [_sandwich_fused(x0, X, xl, *stk) for stk in obs_stk]
        ))
    rec = torch.stack(rows) if rows else x0.new_zeros((0, 2 + len(obs_stk)))
    return x0, X, xl, rec


def evolve_tdvp2(
    A: PackedTTOp,
    u0: PackedTT,
    dt: float,
    steps: int,
    max_rank: Optional[int] = None,
    eps: float = 0.0,
    krylov: int = 24,
    dense_limit: int = 4096,
    callback: Optional[Callable[[int, PackedTT], None]] = None,
    fused: Optional[bool] = None,
    observables: Tuple[PackedTTOp, ...] = (),
) -> Tuple[PackedTT, List[float], List[int]]:
    """Integrate ``du/dt = -A u`` by two-site projector-splitting TDVP.

    Like :func:`evolve_tdvp` but each substep evolves a MERGED pair of
    adjacent cores and re-splits it with a truncated SVD, so the bond
    ranks follow the dynamics instead of staying frozen at ``u0``'s.
    Every bond is padded to the static ``max_rank`` (default: ``u0``'s
    rank) up front, so growth never changes a shape; ``eps`` zeroes
    singular values below ``eps * ||s||`` at each split (``0.0`` keeps
    everything the static rank admits).

    ``A`` must be symmetric above ``dense_limit`` local unknowns (the
    Lanczos exponentials assume it).  Returns ``(u_final, norms,
    ranks)``: the state norm and the maximum effective bond rank seen
    in each step; the train's bonds stay at ``max_rank``.  Second order
    in ``dt``; at ``max_rank`` large enough to hold the exact solution
    and ``eps=0`` it inherits the one-site exactness property.

    ``fused`` (default on) runs each step over the stacked cores with no
    host read inside it but cuSOLVER's SVD status checks; the norms,
    ranks and observables are read once a trajectory (once a step with
    a callback).  The DEFAULT (``fused=None``) falls back to the host
    loop below 3 cores (no mid pairs); an explicit ``fused=True`` raises
    there, and ``fused=False`` keeps the host loop.

    ``observables``: TT-operators whose raw expectations ``<u, O u>``
    are recorded after every step (see :func:`evolve_tdvp`); when given,
    the return gains a FOURTH element: a list of per-step value tuples.
    """
    if max_rank is None:
        max_rank = u0.rank
    if max_rank > u0.rank:
        u0 = pad_rank(u0, max_rank)
    elif max_rank < u0.rank:
        raise ValueError(
            f"max_rank {max_rank} below the initial rank {u0.rank}; "
            "round u0 first"
        )
    dtp = u0.first.dtype
    if fused is None:
        fused = u0.d >= 3
    elif fused and u0.d < 3:
        raise ValueError(
            "fused two-site TDVP needs >= 3 cores; pass fused=False"
        )
    r = int(max_rank)
    n = u0.mode
    squarings = _squarings(A, 0.5 * float(dt), r * n * n * r, dense_limit, krylov)
    if fused:
        x0, X, xl, a0, Am, al = _fused_operands(A, u0)
        h = _step_size(dt, x0)
        ej = torch.full((), float(eps), dtype=dtp, device=x0.device)
        obs_stk = _obs_stacks(observables, dtp)
        if callback is None:
            x0, X, xl, rec = _tdvp2_traj_fused(
                x0, X, xl, a0, Am, al, h, ej, obs_stk, steps,
                dense_limit, krylov, r, squarings,
            )
            rec = rec.cpu().tolist()
            out = (
                _packed_of(x0, X, xl),
                [row[0] for row in rec],
                [int(row[1]) for row in rec],
            )
            if observables:
                return out + ([tuple(row[2:]) for row in rec],)
            return out
        norms2: List[float] = []
        ranks2: List[int] = []
        obs2: List[Tuple[float, ...]] = []
        for step in range(steps):
            x0, X, xl, keffs = _tdvp2_step_impl(
                x0, X, xl, a0, Am, al, h, ej, dense_limit, krylov, r, squarings
            )
            norms2.append(float(torch.linalg.norm(x0)))
            ranks2.append(int(keffs.max()))
            if observables:
                obs2.append(tuple(
                    float(_sandwich_fused(x0, X, xl, *stk)) for stk in obs_stk
                ))
            callback(step, _packed_of(x0, X, xl))
        u = _packed_of(x0, X, xl)
        if observables:
            return u, norms2, ranks2, obs2
        return u, norms2, ranks2
    xs = _core_lists(u0, dtp)
    as_ = _core_lists(A, dtp)
    d = len(xs)
    h = float(dt)
    knobs = (dense_limit, krylov, squarings)

    _canonicalize(xs)

    one3 = _ones3(xs[0])
    norms: List[float] = []
    ranks: List[int] = []
    obs: List[Tuple[float, ...]] = []
    # as in evolve_tdvp: the backward half-sweep records env k+1 after
    # core k+1's final split, so its chain is exactly the next step's
    rev_rs = _right_envs(xs, as_, one3)

    for step in range(steps):
        keffs = []
        rs = rev_rs[::-1]

        # left -> right: pair forward h/2, right core backward h/2
        ls = [one3]
        for k in range(d - 1):
            theta = _merge2(xs[k], xs[k + 1])
            theta = _theta_evolve(ls[-1], as_[k], as_[k + 1], rs[k + 1], theta,
                                  -0.5 * h, *knobs)
            u3, s, v3, keff = _split_theta(theta, r, eps)
            keffs.append(keff)
            xs[k] = u3
            ls.append(_adv_left(ls[-1], xs[k], as_[k]))
            sv = s[:, None, None] * v3
            if k < d - 2:
                sv = _site_evolve(ls[-1], as_[k + 1], rs[k + 1], sv, +0.5 * h, *knobs)
            xs[k + 1] = sv

        # right -> left (mirror): pair forward h/2, left core backward h/2
        rev_rs = [one3]
        for k in range(d - 2, -1, -1):
            theta = _merge2(xs[k], xs[k + 1])
            theta = _theta_evolve(ls[k], as_[k], as_[k + 1], rev_rs[-1], theta,
                                  -0.5 * h, *knobs)
            u3, s, v3, keff = _split_theta(theta, r, eps)
            keffs.append(keff)
            xs[k + 1] = v3
            rev_rs.append(_adv_right(rev_rs[-1], xs[k + 1], as_[k + 1]))
            us = u3 * s[None, None, :]
            if k > 0:
                us = _site_evolve(ls[k], as_[k], rev_rs[-1], us, +0.5 * h, *knobs)
            xs[k] = us

        norms.append(float(torch.linalg.norm(xs[0])))
        ranks.append(int(torch.stack(keffs).max()))
        if observables:
            obs.append(_obs_host(observables, _repack(xs)))
        if callback is not None:
            callback(step, _repack(xs))

    if observables:
        return _repack(xs), norms, ranks, obs
    return _repack(xs), norms, ranks
