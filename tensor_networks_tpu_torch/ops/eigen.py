"""One-site DMRG eigensolver for symmetric TT-operators.

Counterpart of ``tensor_networks_tpu/ops/eigen.py``.  Finds the
smallest eigenpair of a symmetric (typically SPD) uniform TT-operator
by sweeping over the cores of the iterate and replacing each with the
lowest eigenvector of the Galerkin-projected local operator
``H_k = frame_k^T A frame_k``; the Rayleigh quotient is monotonically
nonincreasing across local solves (textbook DMRG).  The environment
algebra is shared with the ALS linear solver
(:mod:`tensor_networks_tpu_torch.ops.als`).

Uniform packed trains overparameterize end bonds (rank above the mode
product on one side), and a rank-deficient core cannot be made
orthonormal -- zero-padded QR leaves the chained frame non-isometric,
so the honest local problem is the GENERALIZED one ``H v = lam B v``
with ``B`` the frame Gram.  The solver carries Gram environments
alongside the operator environments; ``B``'s Kronecker structure
``Lg (x) I (x) Rg`` makes the whitening two bond-sized ``eigh`` per
local solve, and whitened coordinates outside range(B) are shifted out
of the spectral window.  Large local problems (above ``dense_limit``
unknowns) take a matrix-free Lanczos process instead of the dense
``eigh``.  Each ``torch.linalg.eigh`` on the card checks its cuSOLVER
status on the host: three such reads per local solve, none other
inside a fused sweep.
"""

from __future__ import annotations

from functools import lru_cache
from typing import List, Tuple

import numpy as np
import torch

from tensor_networks_tpu_torch.ops.als import (
    _adv_left,
    _adv_left_b,
    _adv_right,
    _adv_right_b,
    _canonicalize,
    _core_lists,
    _enrich_span,
    _left_orth,
    _local_dense,
    _local_rhs,
    _matvec,
    _ones,
    _packed_of,
    _read_stop,
    _right_orth,
)
from tensor_networks_tpu_torch.ops.packed import (
    PackedTT,
    PackedTTOp,
    add,
    inner,
    norm_exact,
    pad_rank,
    scale,
    ttop_apply_packed,
)

__all__ = ["als_eigsh", "als_eigsh_adaptive", "als_eigsh_k"]


def _adv_left_g(Lg, xk):
    return torch.einsum("aA,ajb,AjB->bB", Lg, xk, xk)


def _adv_right_g(Rg, xk):
    return torch.einsum("bB,ajb,AjB->aA", Rg, xk, xk)


def _whitener(G):
    """(W, valid): eigenbasis whitener of a PSD metric (a bond Gram, or
    the projected mass operator) -- W maps whitened coordinates to the
    metric's coordinates, with rank-deficient directions zeroed.

    The rank cutoff scales with G's DTYPE: eigenvalue noise is ~eps
    relative, and a noise direction passing the gate gets amplified by
    1/sqrt(e) -- in the JAX package a hard-coded 1e-12 let f32 noise
    (~1e-7) through and the spurious directions captured the sweep (lam
    1.2999998 vs true 0.302336 on the K=6 regression config in f32).
    Entries below eps^2 of the largest are flushed to zero first: that
    moves no eigenvalue by more than ``eigh``'s own roundoff, and a
    zero-padded bond's Gram holds entries near float32's smallest normal
    number, on which torch's CPU LAPACK float32 ``eigh`` returned NaN
    eigenvalues with no error
    (``tests/test_torch_eigen.py::test_f32_metric_with_subnormal_entries``).
    """
    eps = torch.finfo(G.dtype).eps
    S = 0.5 * (G + G.T)
    S = torch.where(torch.abs(S) < eps * eps * torch.max(torch.abs(S)), 0.0, S)
    e, U = torch.linalg.eigh(S)
    valid = e > 100.0 * eps * torch.max(torch.abs(e))
    inv_sqrt = torch.where(valid, 1.0 / torch.sqrt(torch.where(valid, e, 1.0)), 0.0)
    return U * inv_sqrt[None, :], valid


def _local_ground_state(L, ak, R, Lg, Rg, pens, shift):
    """Smallest eigenpair of the projected local GENERALIZED problem
    ``H v = lam B v`` with ``B = Lg (x) I (x) Rg`` the frame Gram.

    The Kronecker structure of B makes the whitening two bond-sized
    eighs instead of one local-sized one; whitened coordinates outside
    range(B) are shifted out of the spectral window.  Deflated
    directions (``pens``: (k, m) local projections of already-computed
    eigenvectors) are pushed up by ``shift``.
    """
    h1 = torch.einsum("psa,sijt->paijt", L, ak)
    H6 = torch.einsum("paijt,qtc->piqajc", h1, R)
    wl, ml = _whitener(Lg)
    wr, mr = _whitener(Rg)
    Ht = torch.einsum("piqajc,pm,qn,ak,cl->minkjl", H6, wl, wr, wl, wr)
    p, n, q = H6.shape[:3]
    m = wl.shape[1] * n * wr.shape[1]
    Ht = Ht.reshape(m, m)
    Ht = 0.5 * (Ht + Ht.T)
    alive = (ml[:, None, None] & mr[None, None, :]).expand(
        wl.shape[1], n, wr.shape[1]
    ).reshape(m)
    big = 2.0 * torch.sum(torch.abs(Ht)) + shift
    Ht = Ht + torch.diag(torch.where(alive, 0.0, big).to(Ht.dtype))
    if pens.shape[0]:
        pw = torch.einsum(
            "zaic,am,cn->zmin", pens.reshape(pens.shape[0], p, n, q), wl, wr
        ).reshape(pens.shape[0], m)
        Ht = Ht + shift * (pw.T @ pw)
    w, y = torch.linalg.eigh(Ht)
    v = torch.einsum(
        "min,am,cn->aic", y[:, 0].reshape(wl.shape[1], n, wr.shape[1]), wl, wr
    )
    return w[0], v.reshape(-1)


@lru_cache(maxsize=32)
def _lanczos_seed_np(m: int):
    """Deterministic dense start vector for the matrix-free local
    solve (generic direction, nonzero overlap with the ground state
    a.s.); the JAX package's, so both start from the same vector."""
    rng = np.random.default_rng(13)
    v = rng.standard_normal(m)
    return v / np.linalg.norm(v)


@lru_cache(maxsize=32)
def _lanczos_seed(m: int, dtype: torch.dtype, device: torch.device):
    """:func:`_lanczos_seed_np` on ``device``, copied there once: the
    copy waits for the device, so a sweep must not make it."""
    return torch.tensor(_lanczos_seed_np(m), dtype=dtype, device=device)


def _local_ground_state_lanczos(L, ak, R, Lg, Rg, pens, shift, iters,
                                warm=None):
    """Matrix-free local ground state for LARGE local problems.

    Same generalized problem as :func:`_local_ground_state` (whitened
    frame-Gram metric, penalty deflation), but never materializes the
    ``(m, m)`` local matrix: ``iters`` Lanczos steps with full (CGS2)
    reorthogonalization run on the whitened operator apply (the
    ``als._matvec`` contractions), and one ``(iters, iters)`` eigh
    extracts the Ritz ground pair.  Dead whitened coordinates are
    masked out of the start vector and out of every apply, so the
    Krylov space never leaves the alive subspace.  Breakdown (happy or
    numerical) is masked on the device: steps past a vanishing beta
    are written out of the tridiagonal with a large diagonal so they
    cannot contaminate the minimum Ritz pair.
    """
    dt, dev = L.dtype, L.device
    tiny = torch.finfo(dt).tiny
    wl, ml = _whitener(Lg)
    wr, mr = _whitener(Rg)
    m1, m2 = wl.shape[1], wr.shape[1]
    n = ak.shape[2]
    alive = (ml[:, None, None] & mr[None, None, :]).expand(m1, n, m2).to(dt)
    mflat = m1 * n * m2
    npen = pens.shape[0]
    if npen:
        pw = torch.einsum(
            "zajc,am,cn->zmjn",
            pens.reshape(npen, wl.shape[0], n, wr.shape[0]), wl, wr,
        ).reshape(npen, mflat)

    def apply(vflat):
        v = vflat.reshape(m1, n, m2) * alive
        x = torch.einsum("mjn,am,cn->ajc", v, wl, wr)
        y = _matvec(L, ak, R, x)
        z = torch.einsum("piq,pm,qn->min", y, wl, wr)
        z = (z * alive).reshape(mflat)
        if npen:
            z = z + shift * (pw.T @ (pw @ vflat))
        return z

    K = int(iters)
    seed = _lanczos_seed(mflat, dt, dev) * alive.reshape(-1)
    if warm is not None:
        # Warm-start from the current core: as the sweep converges the
        # core approaches the local ground state, so each visit REFINES
        # instead of re-converging from a cold Krylov space (without
        # this the global Rayleigh error plateaus at the fixed-budget
        # Lanczos residual -- 1.2e-4 on the K=6 f64 regression config in
        # the JAX package, ~1e-10 warm).  Whitened coordinates of a raw
        # core x are W^+ x = W^T G x.  A small fixed perturbation
        # guarantees nonzero ground-state overlap.
        wlg = wl.T @ (0.5 * (Lg + Lg.T))
        grw = (0.5 * (Rg + Rg.T)) @ wr
        v0w = torch.einsum(
            "ma,ajc,cn->mjn", wlg, warm.reshape(wl.shape[0], n, wr.shape[0]), grw
        ).reshape(mflat) * alive.reshape(-1)
        v0 = v0w + 1e-4 * torch.linalg.norm(v0w) * seed
        v0 = torch.where(torch.linalg.norm(v0) > tiny, v0, seed)
    else:
        v0 = seed
    v0 = v0 / torch.clamp(torch.linalg.norm(v0), min=tiny)
    Vb = torch.zeros((K, mflat), dtype=dt, device=dev)
    Vb[0] = v0
    alphas = torch.zeros((K,), dtype=dt, device=dev)
    betas = torch.zeros((K,), dtype=dt, device=dev)
    valid = torch.arange(K, device=dev) == 0  # a Python True stored would copy and sync
    amax = torch.zeros((), dtype=dt, device=dev)
    gate = 50.0 * torch.finfo(dt).eps
    for j in range(K):
        vj = Vb[j]
        w = apply(vj)
        a_j = vj @ w
        amax = torch.maximum(amax, torch.abs(a_j))
        alphas[j] = a_j
        # full reorthogonalization, two CGS passes
        w = w - Vb.T @ (Vb @ w)
        w = w - Vb.T @ (Vb @ w)
        b_j = torch.linalg.norm(w)
        # breakdown gate at the ROUND-OFF scale, not sqrt(eps): with
        # full reorthogonalization, continuing past a small beta only
        # appends another orthonormal direction, while a sqrt(eps) gate
        # truncates the Krylov space as soon as the residual reaches
        # ~sqrt(eps)*|H| (a 5e-4 Rayleigh stall at f32 r=64 in the JAX
        # package).  50*eps*amax keeps true happy breakdown detected.
        ok = b_j > gate * amax
        betas[j] = torch.where(ok, b_j, 0.0)
        if j + 1 < K:
            Vb[j + 1] = torch.where(ok, w / torch.clamp(b_j, min=tiny), 0.0)
            valid[j + 1] = valid[j] & ok

    big = 10.0 * (amax + abs(shift) + 1.0)
    diag = torch.where(valid, alphas, big)
    off = betas[:-1] * valid[1:].to(dt)
    T = torch.diag(diag) + torch.diag(off, 1) + torch.diag(off, -1)
    wv, Y = torch.linalg.eigh(T)
    u = Vb.T @ Y[:, 0]
    vraw = torch.einsum("mjn,am,cn->ajc", u.reshape(m1, n, m2), wl, wr)
    return wv[0], vraw.reshape(-1)


def _adv_left_mb(L, xk, mk, vk):
    """Left env of the three-train sandwich x^T M v (bra ``xk``, ket
    ``vk``) -- the deflation projections in the mass metric.  Leading
    batch axes on ``L`` and ``vk`` (stacked deflation trains)."""
    t1 = torch.einsum("...psb,...bjc->...psjc", L, vk)
    t2 = torch.einsum("...psjc,sijt->...pitc", t1, mk)
    return torch.einsum("...pitc,piq->...qtc", t2, xk)


def _adv_right_mb(R, xk, mk, vk):
    u1 = torch.einsum("...bjc,...qtc->...bjqt", vk, R)
    u2 = torch.einsum("...bjqt,sijt->...bsiq", u1, mk)
    return torch.einsum("...bsiq,piq->...psb", u2, xk)


def _local_mb(L, mk, R, vk):
    t1 = torch.einsum("...psb,...bjc->...psjc", L, vk)
    t2 = torch.einsum("...psjc,sijt->...pitc", t1, mk)
    return torch.einsum("...pitc,...qtc->...piq", t2, R)


def _local_ground_state_mass(L, ak, R, Lm, mk, Rm, pens, shift):
    """Generalized local solve ``H v = lam B v`` with ``B`` the
    Galerkin projection of an SPD mass operator (full local whitening;
    no Kronecker shortcut since ``M`` couples the modes)."""
    H = _local_dense(L, ak, R)
    H = 0.5 * (H + H.T)
    W, alive = _whitener(_local_dense(Lm, mk, Rm))
    Ht = W.T @ H @ W
    Ht = 0.5 * (Ht + Ht.T)
    big = 2.0 * torch.sum(torch.abs(Ht)) + shift
    Ht = Ht + torch.diag(torch.where(alive, 0.0, big).to(Ht.dtype))
    if pens.shape[0]:
        pw = pens @ W
        Ht = Ht + shift * (pw.T @ pw)
    w, y = torch.linalg.eigh(Ht)
    return w[0], W @ y[:, 0]


def _carry_right(vec, q, nxt):
    """``nxt`` times the factor ``q^T vec`` that left-orthogonalizing
    ``vec`` into ``q`` leaves behind: the train is then the one the
    sweep holds, and the next Lanczos local starts from it."""
    return torch.einsum("bc,cks->bks", torch.einsum("ajb,ajc->bc", q, vec), nxt)


def _carry_left(prev, vec, q):
    """Mirror of :func:`_carry_right` for right-orthogonalization:
    ``prev`` times ``vec q^T``."""
    return torch.einsum("sia,ab->sib", prev, torch.einsum("ajc,bjc->ab", vec, q))


# -- fused sweep ----------------------------------------------------------------
# Same treatment as als._als_sweep_impl: boundary cores explicit, mid
# cores a Python loop over the stacks, the right env chains handed from
# one sweep's backward half to the next.  The carries add the metric env
# (frame Gram, or the Galerkin projection of the mass operator) and,
# when deflating, a J-stacked penalty env advanced by batched sandwich
# contractions (the deflation trains must share one rank -- als_eigsh
# falls back to the host loop otherwise).  On padded (rank-deficient)
# trains the local eigenbases match the host loop only up to whitener
# gauge; the contract is identical Rayleigh descent on full-rank trains
# and equal convergence otherwise.  Each orthogonalization's factor is
# carried into the next core (_carry_right, _carry_left) before that
# core's local solve, so a Lanczos local warm-starts from the iterate the
# sweep holds and its Ritz value cannot rise above the iterate's
# Rayleigh quotient.  The JAX package warm-starts from the core as it
# was before the factor moved: at K=14 rank 64 in f32 with 48 steps its
# energy after a sweep ended above the start's (ROADMAP.md section 3).


class _EigHelpers:
    """The metric/deflation plumbing of the eigensolver sweep.
    ``use_mass`` switches the local metric from the frame Gram to the
    Galerkin projection of the mass operator; ``use_pen`` carries
    J-stacked deflation environments.  ``mk``/``vk`` operands are
    ignored when the corresponding feature is off."""

    def __init__(self, use_mass: bool, use_pen: bool, dt, device, J: int = 0,
                 dense_limit: int = 1024, lanczos_iters: int = 64):
        self.use_mass = use_mass
        self.use_pen = use_pen
        self.dt = dt
        self.device = device
        self.J = J
        self.dense_limit = dense_limit
        self.lanczos_iters = lanczos_iters
        self.one3 = _ones(dt, device, 1, 1, 1)
        self.one2 = _ones(dt, device, 1, 1)

    def g_seed(self):
        return self.one3 if self.use_mass else self.one2

    def g_adv_l(self, Lg, xk, mk):
        if self.use_mass:
            return _adv_left(Lg, xk, mk)
        return _adv_left_g(Lg, xk)

    def g_adv_r(self, Rg, xk, mk):
        if self.use_mass:
            return _adv_right(Rg, xk, mk)
        return _adv_right_g(Rg, xk)

    def p_seed(self):
        if not self.use_pen:
            return None
        shape = (1, 1, 1) if self.use_mass else (1, 1)
        return _ones(self.dt, self.device, self.J, *shape)

    def p_adv_l(self, Lb, xk, mk, vk):
        if not self.use_pen:
            return None
        if self.use_mass:
            return _adv_left_mb(Lb, xk, mk, vk)
        return _adv_left_b(Lb, xk, vk)

    def p_adv_r(self, Rb, xk, mk, vk):
        if not self.use_pen:
            return None
        if self.use_mass:
            return _adv_right_mb(Rb, xk, mk, vk)
        return _adv_right_b(Rb, xk, vk)

    def pens_of(self, Lb, Rb, mk, vk, size):
        if not self.use_pen:
            return torch.zeros((0, size), dtype=self.dt, device=self.device)
        if self.use_mass:
            out = _local_mb(Lb, mk, Rb, vk)
        else:
            out = _local_rhs(Lb, vk, Rb)
        return out.reshape(out.shape[0], -1)

    def solve(self, L, R, Lg, Rg, ak, mk, pens, shift, warm=None):
        if self.use_mass:
            # the mass metric keeps the dense local path (its whitening
            # needs the full Galerkin-projected metric, not a Kronecker
            # bond pair)
            return _local_ground_state_mass(L, ak, R, Lg, mk, Rg, pens, shift)
        m = L.shape[2] * ak.shape[2] * R.shape[2]
        if m > self.dense_limit:
            return _local_ground_state_lanczos(
                L, ak, R, Lg, Rg, pens, shift, self.lanczos_iters, warm=warm,
            )
        return _local_ground_state(L, ak, R, Lg, Rg, pens, shift)


def _eig_sweep_impl(x0c, X, xlc, a0, Am, al, mstk, vstk, shift,
                    dense_limit: int = 1024, lanczos_iters: int = 64, renvs=None):
    """One full eigensolver sweep (left->right, right->left).

    ``mstk`` is ``(m0, Mm, ml)`` for the generalized problem or None
    (frame-Gram metric).  ``vstk`` is ``(V0 (J,1,n,rv), VM (mm,J,rv,n,rv),
    VL (J,rv,n,1))`` stacked deflation trains or None.  ``renvs`` are the
    right env chains of these cores as the previous sweep returned them
    (None: computed here).  Returns the updated cores, the Rayleigh
    values closing each half-sweep and the new cores' right env chains.
    """
    dt, dev = x0c.dtype, x0c.device
    one3 = _ones(dt, dev, 1, 1, 1)
    use_mass = mstk is not None
    use_pen = vstk is not None
    m0, Mm, ml = mstk if use_mass else (None, None, None)
    v0, VM, vl = vstk if use_pen else (None, None, None)
    h = _EigHelpers(use_mass, use_pen, dt, dev, v0.shape[0] if use_pen else 0,
                    dense_limit, lanczos_iters)
    m = X.shape[0]

    def mk(j):
        return Mm[j] if use_mass else None

    def vk(j):
        return VM[j] if use_pen else None

    # right-env chains of the current cores, pre-absorb
    if renvs is None:
        rs_mid, rgs_mid, rbs_mid = [None] * m, [None] * m, [None] * m
        R = _adv_right(one3, xlc, al)
        Rg = h.g_adv_r(h.g_seed(), xlc, ml)
        Rb = h.p_adv_r(h.p_seed(), xlc, ml, vl)
        for j in range(m - 1, -1, -1):
            rs_mid[j], rgs_mid[j], rbs_mid[j] = R, Rg, Rb
            R, Rg, Rb = (_adv_right(R, X[j], Am[j]), h.g_adv_r(Rg, X[j], mk(j)),
                         h.p_adv_r(Rb, X[j], mk(j), vk(j)))
    else:
        rs_mid, rgs_mid, rbs_mid, (R, Rg, Rb) = renvs

    # left -> right half
    pens = h.pens_of(h.p_seed(), Rb, m0, v0, x0c.numel())
    _, vec = h.solve(one3, R, h.g_seed(), Rg, a0, m0, pens, shift, warm=x0c)
    vec = vec.reshape(x0c.shape)
    q0 = _left_orth(vec)
    warm = _carry_right(vec, q0, X[0] if m else xlc)
    L = _adv_left(one3, q0, a0)
    Lg = h.g_adv_l(h.g_seed(), q0, m0)
    Lb = h.p_adv_l(h.p_seed(), q0, m0, v0)
    Q, ls_mid = [], []
    for j in range(m):
        pens = h.pens_of(Lb, rbs_mid[j], mk(j), vk(j), X[j].numel())
        _, vec = h.solve(L, rs_mid[j], Lg, rgs_mid[j], Am[j], mk(j), pens, shift,
                         warm=warm)
        vec = vec.reshape(X[j].shape)
        qk = _left_orth(vec)
        warm = _carry_right(vec, qk, X[j + 1] if j + 1 < m else xlc)
        Q.append(qk)
        ls_mid.append((L, Lg, Lb))
        L, Lg, Lb = (_adv_left(L, qk, Am[j]), h.g_adv_l(Lg, qk, mk(j)),
                     h.p_adv_l(Lb, qk, mk(j), vk(j)))

    pens = h.pens_of(Lb, h.p_seed(), ml, vl, xlc.numel())
    lam_f, vec = h.solve(L, one3, Lg, h.g_seed(), al, ml, pens, shift, warm=warm)

    # right -> left half.  The host loop re-solves the last core here,
    # but the eigen local solve does not depend on the current core
    # value on the dense path, so the re-solve is the forward one --
    # skipped
    vec = vec.reshape(xlc.shape)
    vlq = _right_orth(vec)
    warm = _carry_left(Q[-1] if m else q0, vec, vlq)
    R = _adv_right(one3, vlq, al)
    Rg = h.g_adv_r(h.g_seed(), vlq, ml)
    Rb = h.p_adv_r(h.p_seed(), vlq, ml, vl)
    V = [None] * m
    for j in range(m - 1, -1, -1):
        rs_mid[j], rgs_mid[j], rbs_mid[j] = R, Rg, Rb
        Lk, Lgk, Lbk = ls_mid[j]
        pens = h.pens_of(Lbk, Rb, mk(j), vk(j), Q[j].numel())
        _, vec = h.solve(Lk, R, Lgk, Rg, Am[j], mk(j), pens, shift, warm=warm)
        vec = vec.reshape(Q[j].shape)
        V[j] = _right_orth(vec)
        warm = _carry_left(Q[j - 1] if j else q0, vec, V[j])
        R, Rg, Rb = (_adv_right(R, V[j], Am[j]), h.g_adv_r(Rg, V[j], mk(j)),
                     h.p_adv_r(Rb, V[j], mk(j), vk(j)))

    pens = h.pens_of(h.p_seed(), Rb, m0, v0, q0.numel())
    lam_b, vec = h.solve(one3, R, h.g_seed(), Rg, a0, m0, pens, shift, warm=warm)
    return (vec.reshape(q0.shape), torch.stack(V), vlq, lam_f, lam_b,
            (rs_mid, rgs_mid, rbs_mid, (R, Rg, Rb)))


def _eig_loop_impl(x0c, X, xlc, a0, Am, al, mstk, vstk, shift,
                   sweeps, tol, cap, dense_limit: int = 1024,
                   lanczos_iters: int = 64):
    """The fused sweep loop: up to ``sweeps`` sweeps with the
    convergence test ``|lam_prev - lam_b| <= tol max(|lam_b|, tiny)``
    computed on the device and read once per sweep
    (:func:`als._read_stop`).  Returns the final cores plus the JAX
    package's ``(2 cap + 1,)`` record, on the device in the train's
    dtype: per-half-sweep Rayleigh values (NaN past the executed count)
    with the executed sweep count in the tail."""
    dt = x0c.dtype
    tiny = torch.finfo(dt).tiny
    hist = torch.full((2 * cap,), float("nan"), dtype=dt, device=x0c.device)
    lam_prev = torch.full((), float("inf"), dtype=dt, device=x0c.device)
    done, renvs = 0, None
    while done < sweeps:
        x0c, X, xlc, lam_f, lam_b, renvs = _eig_sweep_impl(
            x0c, X, xlc, a0, Am, al, mstk, vstk, shift,
            dense_limit, lanczos_iters, renvs,
        )
        hist[2 * done] = lam_f
        hist[2 * done + 1] = lam_b
        conv = torch.abs(lam_prev - lam_b) <= tol * torch.clamp(
            torch.abs(lam_b), min=tiny
        )
        lam_prev = lam_b
        done += 1
        if _read_stop(conv):
            break
    return x0c, X, xlc, torch.cat([hist, hist.new_full((1,), done)])


def _op_fro_norm(op: PackedTTOp) -> float:
    """Frobenius norm of the represented operator (an upper bound on
    |lam_max|) -- the fused-mode operator viewed as a train."""
    no, ni, R = op.first.shape
    dm = op.mids.shape[0]
    t = PackedTT(
        op.first.reshape(no * ni, R),
        op.mids.reshape(dm, R, no * ni, R),
        op.last.reshape(R, no * ni),
    )
    return float(norm_exact(t))


def _default_shift(op: PackedTTOp, x0: PackedTT, mass: PackedTTOp,
                   eigsh=None) -> float:
    """Default deflation penalty: an upper bound on the (generalized)
    spectral range -- 2 |A|_F, divided by a 2-sweep DMRG estimate of
    lam_min(M) when a mass matrix widens the range."""
    shift = 2.0 * _op_fro_norm(op)
    if mass is not None:
        solver = als_eigsh if eigsh is None else eigsh
        _, mu_min, _ = solver(mass, x0, sweeps=2)
        shift = shift / max(abs(mu_min), 1e-12)
    return shift


def als_eigsh(
    op: PackedTTOp,
    x0: PackedTT,
    sweeps: int = 10,
    tol: float = 1e-10,
    deflate: Tuple[PackedTT, ...] = (),
    shift: float = None,
    mass: PackedTTOp = None,
    fused: bool = None,
    dense_limit: int = 1024,
    lanczos_iters: int = 64,
) -> Tuple[PackedTT, float, List[float]]:
    """Smallest eigenpair of a symmetric TT-operator at the ranks of
    ``x0`` by one-site DMRG.

    Local problems up to ``dense_limit`` unknowns are solved by one
    dense whitened eigh; above it a matrix-free Lanczos with
    ``lanczos_iters`` steps runs rank-r GEMM applies instead
    (:func:`_local_ground_state_lanczos`).  The ``mass`` metric always
    uses the dense path.

    Returns ``(x, lam, history)`` -- the unit-norm eigenvector train,
    the Rayleigh quotient, and its value after each half-sweep; the
    sweep loop stops when the per-sweep improvement drops below
    ``tol * |lam|``.  Grow ranks with :func:`als_eigsh_adaptive`.  On
    the fused path the history is recorded on the device in the TRAIN
    dtype -- f32 trains return ``history``/``lam`` values at ~1e-7
    relative resolution (the host loop records full-precision floats;
    use ``fused=False`` for comparisons tighter than the train eps).

    ``deflate`` lists already-computed (unit-norm) eigenvector trains:
    each local solve adds the penalty ``shift * p p^T`` for their frame
    projections ``p``, pushing those directions above the window so the
    sweep converges to the NEXT eigenpair (penalty deflation;
    :func:`als_eigsh_k` drives this).  ``shift`` defaults to twice the
    operator Frobenius norm, an upper bound on the spectral range.

    ``mass``: an SPD TT-operator turns the problem into the GENERALIZED
    one ``A v = lam M v`` -- the local metric becomes the Galerkin
    projection of ``M``, deflation penalties use M-inner products, and
    the returned eigenvector is M-normalized (``<v, M v> = 1``).

    ``fused`` (default on) sweeps over stacked cores with the
    convergence test on the device, read once per sweep.  It needs the
    deflation trains to share one rank: the DEFAULT (``fused=None``)
    falls back to the host loop on mixed ranks, while an explicit
    ``fused=True`` raises.  ``fused=False`` keeps the host loop, which
    reads every half-sweep's Rayleigh value as a float.
    """
    dt = x0.first.dtype
    dev = x0.first.device
    xs = _core_lists(x0, dt)
    as_ = _core_lists(op, dt)
    d = len(xs)
    ms_ = None if mass is None else _core_lists(mass, dt)
    vs = [_core_lists(v, dt) for v in deflate]
    if deflate and shift is None:
        shift = _default_shift(op, x0, mass)
    shift = 0.0 if shift is None else float(shift)

    # canonicalize: all cores right-orthogonal (R factors absorbed left
    # so the represented train is unchanged)
    _canonicalize(xs)

    one3, one2 = _ones(dt, dev, 1, 1, 1), _ones(dt, dev, 1, 1)
    history: List[float] = []
    lam = float("inf")

    if fused is None:
        fused = not deflate or len({v.rank for v in deflate}) == 1
    if fused:
        mstk = None
        if mass is not None:
            mstk = (ms_[0], mass.mids.to(dt), ms_[-1])
        vstk = None
        if deflate:
            if len({v.rank for v in deflate}) != 1:
                raise ValueError(
                    "fused=True needs deflation trains of one shared "
                    "rank; pad them or pass fused=False"
                )
            vstk = (
                torch.stack([v[0] for v in vs]),
                torch.stack([torch.stack(v[1:-1]) for v in vs], dim=1),
                torch.stack([v[-1] for v in vs]),
            )
        if sweeps <= 0:
            return _packed_of(xs[0], torch.stack(xs[1:-1]), xs[-1]), lam, history
        # the JAX package's record length (its sweep cap bucketed to a
        # power of two)
        cap = 1 << max(sweeps - 1, 1).bit_length()
        z0, Vm, vlq, rec = _eig_loop_impl(
            xs[0], torch.stack(xs[1:-1]), xs[-1],
            as_[0], op.mids.to(dt), as_[-1], mstk, vstk, shift,
            sweeps, tol, cap, int(dense_limit), int(lanczos_iters),
        )
        rec = rec.cpu().numpy()  # one host fetch for the record
        n_done = int(rec[-1])
        history = [float(v) for v in rec[: 2 * n_done]]
        if history:
            lam = history[-1]
        return _packed_of(z0, Vm, vlq), lam, history

    use_mass = ms_ is not None

    def local_pens(lbs_k, rbs_k, k):
        if not vs:
            return torch.zeros((0, xs[k].numel()), dtype=dt, device=dev)
        if use_mass:
            return torch.stack([
                _local_mb(lbs_k[j], ms_[k], rbs_k[j], vs[j][k]).reshape(-1)
                for j in range(len(vs))
            ])
        return torch.stack([
            _local_rhs(lbs_k[j], vs[j][k], rbs_k[j]).reshape(-1)
            for j in range(len(vs))
        ])

    pen0 = one3 if use_mass else one2

    def pen_adv_l(env, k, j):
        if use_mass:
            return _adv_left_mb(env, xs[k], ms_[k], vs[j][k])
        return _adv_left_b(env, xs[k], vs[j][k])

    def pen_adv_r(env, k, j):
        if use_mass:
            return _adv_right_mb(env, xs[k], ms_[k], vs[j][k])
        return _adv_right_b(env, xs[k], vs[j][k])

    def solve_local(k, L, R, Lg_or_Lm, Rg_or_Rm, pens):
        if use_mass:
            return _local_ground_state_mass(
                L, as_[k], R, Lg_or_Lm, ms_[k], Rg_or_Rm, pens, shift
            )
        if xs[k].numel() > dense_limit:
            return _local_ground_state_lanczos(
                L, as_[k], R, Lg_or_Lm, Rg_or_Rm, pens, shift,
                int(lanczos_iters), warm=xs[k],
            )
        return _local_ground_state(L, as_[k], R, Lg_or_Lm, Rg_or_Rm, pens, shift)

    g0 = one3 if use_mass else one2  # metric env seed

    def metric_adv_l(env, k):
        if use_mass:
            return _adv_left(env, xs[k], ms_[k])
        return _adv_left_g(env, xs[k])

    def metric_adv_r(env, k):
        if use_mass:
            return _adv_right(env, xs[k], ms_[k])
        return _adv_right_g(env, xs[k])

    rev_rs, rev_rgs = [one3], [g0]
    rev_rbs = [[pen0] for _ in vs]
    for k in range(d - 1, 0, -1):
        rev_rs.append(_adv_right(rev_rs[-1], xs[k], as_[k]))
        rev_rgs.append(metric_adv_r(rev_rgs[-1], k))
        for j in range(len(vs)):
            rev_rbs[j].append(pen_adv_r(rev_rbs[j][-1], k, j))

    for _sweep in range(sweeps):
        rs, rgs = rev_rs[::-1], rev_rgs[::-1]
        rbs = [e[::-1] for e in rev_rbs]

        ls, lgs = [one3], [g0]
        lbs = [[pen0] for _ in vs]
        for k in range(d):
            pens = local_pens(
                [lbs[j][-1] for j in range(len(vs))],
                [rbs[j][k] for j in range(len(vs))],
                k,
            )
            lam_k, vec = solve_local(k, ls[-1], rs[k], lgs[-1], rgs[k], pens)
            xs[k] = vec = vec.reshape(xs[k].shape)
            if k < d - 1:
                xs[k] = _left_orth(vec)
                xs[k + 1] = _carry_right(vec, xs[k], xs[k + 1])
                ls.append(_adv_left(ls[-1], xs[k], as_[k]))
                lgs.append(metric_adv_l(lgs[-1], k))
                for j in range(len(vs)):
                    lbs[j].append(pen_adv_l(lbs[j][-1], k, j))
        history.append(float(lam_k))

        rev_rs, rev_rgs = [one3], [g0]
        rev_rbs = [[pen0] for _ in vs]
        for k in range(d - 1, -1, -1):
            pens = local_pens(
                [lbs[j][k] for j in range(len(vs))],
                [rev_rbs[j][-1] for j in range(len(vs))],
                k,
            )
            lam_k, vec = solve_local(k, ls[k], rev_rs[-1], lgs[k], rev_rgs[-1], pens)
            xs[k] = vec = vec.reshape(xs[k].shape)
            if k > 0:
                xs[k] = _right_orth(vec)
                xs[k - 1] = _carry_left(xs[k - 1], vec, xs[k])
                rev_rs.append(_adv_right(rev_rs[-1], xs[k], as_[k]))
                rev_rgs.append(metric_adv_r(rev_rgs[-1], k))
                for j in range(len(vs)):
                    rev_rbs[j].append(pen_adv_r(rev_rbs[j][-1], k, j))
        new_lam = float(lam_k)
        history.append(new_lam)
        if abs(lam - new_lam) <= tol * max(abs(new_lam), 1e-300):
            lam = new_lam
            break
        lam = new_lam

    # after the right-to-left pass core 0 is the open core and holds
    # the whole norm; the local eigenvector is unit in the (whitened)
    # metric, so x is unit-norm (M-normalized when mass is given)
    x = _packed_of(xs[0], torch.stack(xs[1:-1]), xs[-1])
    return x, lam, history


def als_eigsh_k(
    op: PackedTTOp,
    x0: PackedTT,
    k: int,
    sweeps: int = 10,
    shift: float = None,
    mass: PackedTTOp = None,
    slots: bool = True,
    **kw,
) -> Tuple[List[PackedTT], List[float]]:
    """The ``k`` lowest eigenpairs by sequential penalty deflation.

    Each eigenpair is computed by :func:`als_eigsh` with all previously
    found eigenvectors deflated; the reported eigenvalue is the clean
    Rayleigh quotient ``<v, A v> / <v, M v>`` (penalty leakage removed;
    :func:`packed.inner`, the zipper kernel on the card).  Returns
    ``(vectors, values)`` sorted ascending.

    ``slots`` (default on) fixes the deflation count at ``k - 1`` (+
    caller-supplied trains) from the FIRST eigenpair, filling unfound
    slots with zero trains at a shared rank: a zero train's penalty
    projections are exactly zero, so the result is unchanged while
    every eigenpair runs the fused sweep on one stack shape.
    ``slots=False`` grows the deflation stack per pair.
    """
    # compute the default penalty shift ONCE (it involves a QR-sweep
    # norm and, with a mass matrix, a cheap DMRG on M) instead of once
    # per excited state inside als_eigsh
    if k > 1 and shift is None:
        shift = _default_shift(op, x0, mass)

    # merge a caller-supplied deflate (find pairs ABOVE known
    # eigenvectors) with the ones found here
    base_deflate = tuple(kw.pop("deflate", ()))

    nslots = 0
    zero_slot = None
    if slots:
        rv = max([x0.rank] + [v.rank for v in base_deflate])
        base_deflate = tuple(
            pad_rank(v, rv) if v.rank < rv else v for v in base_deflate
        )
        if x0.rank < rv:
            x0 = pad_rank(x0, rv)
        nslots = len(base_deflate) + k - 1
        opts = dict(dtype=x0.first.dtype, device=x0.first.device)
        d, n = x0.d, x0.mode
        zero_slot = PackedTT(
            torch.zeros((n, rv), **opts),
            torch.zeros((d - 2, rv, n, rv), **opts),
            torch.zeros((rv, n), **opts),
        )
        if nslots and shift is None:
            # non-empty deflate makes als_eigsh derive a default shift
            # per call; pin it once here instead
            shift = _default_shift(op, x0, mass)

    found: List[PackedTT] = []
    vals: List[float] = []
    for _ in range(k):
        defl = base_deflate + tuple(found)
        if slots and len(defl) < nslots:
            defl = defl + (zero_slot,) * (nslots - len(defl))
        v, _, _ = als_eigsh(
            op, x0, sweeps=sweeps, deflate=defl, shift=shift, mass=mass, **kw,
        )
        denom = float(
            inner(v, ttop_apply_packed(mass, v)) if mass is not None else inner(v, v)
        )
        lam = float(inner(v, ttop_apply_packed(op, v))) / denom
        found.append(v)
        vals.append(lam)
    order = sorted(range(len(vals)), key=lambda i: vals[i])
    return [found[i] for i in order], [vals[i] for i in order]


def als_eigsh_adaptive(
    op: PackedTTOp,
    x0: PackedTT,
    eps: float = 1e-8,
    max_rank: int = None,
    sweeps_per_rank: int = 4,
    enrich: bool = True,
    mass: PackedTTOp = None,
    **kw,
) -> Tuple[PackedTT, float, List[float]]:
    """Rank-adaptive smallest eigenpair: run :func:`als_eigsh` at the
    current rank and, while the exact residual (``|A x - lam x|``, or
    ``|A x - lam M x|`` for a generalized problem) stays above
    ``eps * |lam|``, double the rank up to ``max_rank``.

    With ``enrich=True`` the new bond directions span the rounded
    eigen-residual train (coefficient zero -- the AMEn move of
    :func:`als.als_solve_adaptive` applied to the eigenproblem);
    otherwise inert zero padding.  Returns ``(x, lam, concatenated
    history)``.
    """
    rank = x0.rank
    ceiling = int(max_rank) if max_rank is not None else 8 * rank
    x = x0
    hist_all: List[float] = []
    while True:
        x, lam, hist = als_eigsh(op, x, sweeps=sweeps_per_rank, mass=mass, **kw)
        hist_all += hist
        lam_x = (
            scale(x, -lam)
            if mass is None
            else scale(ttop_apply_packed(mass, x), -lam)
        )
        resid_train = add(ttop_apply_packed(op, x), lam_x)
        resid = float(norm_exact(resid_train))
        if resid <= eps * max(abs(lam), 1e-300) or rank >= ceiling:
            return x, lam, hist_all
        new_rank = min(2 * rank, ceiling)
        kick = new_rank - x.rank
        if enrich and kick > 0:
            x = _enrich_span(x, resid_train, kick)
        else:
            x = pad_rank(x, new_rank)
        rank = new_rank
