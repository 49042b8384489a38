"""Fused fixed-shape TT operations for uniform trains.

Counterpart of ``tensor_networks_tpu/ops/fast.py`` (the parts the port
uses).  When a train is *uniform* (all middle cores share
(r, n, r)) the hot operations run as single sweeps over stacked cores:

* :func:`tt_inner_fast` -- the O(d n r^3) inner-product zipper, through
  the H1 kernel for CUDA tensors (:mod:`..kernels.zipper`);
* :func:`tt_round_fixed` -- orthogonalization + truncation sweep with
  static shapes (truncated directions are zero-masked on the device; the
  kept ranks are fetched once at the end and the bonds compacted).  Five
  sweeps, as in the JAX package: ``svd`` (Householder QR + SVD),
  ``gram`` (CholQR + Gram eigh), ``cholqr2`` (CholeskyQR2 + R-factor
  SVD), ``twosided`` (CholeskyQR2 chains + batched sign projectors) and
  ``prefix`` (GEMM-only Gram chains, every factorization batched over
  the bonds).  They are torch ops (cuBLAS and cuSOLVER on the card):
  none of them reaches a Pallas kernel in the JAX package.

The JAX sweeps' ``lax.scan``s are Python loops over the cores here, and
their device-side loops (``while_loop``, ``cond``) become host decisions
taken as rarely as the results allow: a Cholesky that fails is only
flagged on the device (one flag fetched with the kept ranks, the sweep
rerun with per-matrix shift escalation if any failed); the Newton-Schulz
sign iteration reads its error every few iterations; the basis recovery
of :func:`_proj_basis_cols` runs unconditionally under ``torch.where``.
"""

from __future__ import annotations

import os
import warnings
from functools import lru_cache
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


#: how many times each rounding sweep ran, and how many NaN breakdowns
#: fell back to the Householder sweep (bench and tests read this)
ROUND_STATS = {
    "svd": 0,
    "gram": 0,
    "cholqr2": 0,
    "twosided": 0,
    "prefix": 0,
    "fallback_nan": 0,
}
#: the methods whose sweeps take structural rank caps and can break down
GEMM_METHODS = ("gram", "cholqr2", "twosided", "prefix")
_TINY = 1e-30  # keeps traces and norms off zero, as in the JAX package


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


# ---- helpers of the GEMM-based sweeps --------------------------------------


def _eye(r: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(r, dtype=like.dtype, device=like.device)


def _trace(x: torch.Tensor) -> torch.Tensor:
    """Traces of a matrix or of a batch of them."""
    return torch.diagonal(x, dim1=-2, dim2=-1).sum(-1)


def _chol_adaptive(g, jit0, escalate: bool, fails: list):
    """Batched or single Cholesky of ``g + shift I`` (the JAX package's
    ``_chol_adaptive``); returns ``(L, shift used)``.

    On exactly rank-deficient trains Gram rounding noise can outweigh a
    trace-scaled shift and give a negative pivot.  With ``escalate`` the
    shift grows 32x per retry on exactly the matrices that failed, up to
    2**25 (one host read per retry, none when the first try holds).
    Without it nothing is read back: a failure is appended to ``fails``
    as a device flag, and the caller reruns the sweep with ``escalate``
    when a flag is set.  A matrix whose factorization failed gets a NaN
    factor, as ``jnp.linalg.cholesky`` gives (``cholesky_ex`` leaves a
    partial factor there).  Callers deflate ghosts with the returned
    shift.
    """
    eye = _eye(g.shape[-1], g)
    jit0 = torch.as_tensor(jit0, dtype=g.dtype, device=g.device)

    def chol(mult):
        l, info = torch.linalg.cholesky_ex(g + (jit0 * mult)[..., None, None] * eye)
        bad = (info != 0) | ~torch.isfinite(l).all(dim=-1).all(dim=-1)
        return l, bad

    mult = torch.ones_like(jit0)
    l, bad = chol(mult)
    if escalate:
        while bool((bad & (mult < 2.0**25)).any()):
            mult = torch.where(bad, mult * 32.0, mult)
            l2, bad2 = chol(mult)
            l = torch.where(bad[..., None, None], l2, l)
            bad = bad & bad2
    else:
        fails.append(bad.any())
    l = torch.where(bad[..., None, None], torch.full_like(l, float("nan")), l)
    return l, jit0 * mult


#: iterations of the Newton-Schulz sign iteration between two host reads
#: of its error
_SIGN_CHECK_EVERY = 8
#: the sign iteration's cap, as in the JAX package: thresholds below
#: ~1.5**-100 of the spectral radius do not resolve; the prefix sweep's
#: trust projector tolerates ~1e-2 leakage and stops at 40
_SIGN_ITERS = 100
_TRUST_SIGN_ITERS = 40


def _sign_newton_schulz(a0, alpha, max_iters: int):
    """Batched matrix sign of symmetric ``a0`` by Newton-Schulz (the JAX
    package's ``_sign_newton_schulz``): iterates until ``||x x - I||_max``
    falls under 50 machine eps or ``max_iters``.

    The error is read on the host every :data:`_SIGN_CHECK_EVERY`
    iterations, not every one: once converged an iteration is a fixed
    point up to roundoff, so the few extra ones change nothing but the
    last bits.
    """
    eye = _eye(a0.shape[-1], a0)
    tol = 50.0 * torch.finfo(a0.dtype).eps
    x = a0 / alpha[:, None, None]
    for i in range(max_iters):
        x2 = x @ x
        x3 = x @ x2
        check = (i + 1) % _SIGN_CHECK_EVERY == 0
        if check:
            err = torch.max(torch.abs(x2 - eye[None]))
        x = 1.5 * x - 0.5 * x3
        # NaN compares false, and ends the loop as in the JAX package
        if check and not float(err) > tol:
            break
    return x


@lru_cache(maxsize=16)
def _orth_probe_np(r: int) -> np.ndarray:
    """The fixed orthonormal probe of the truncation sweeps: the host QR
    of a Gaussian from ``default_rng(7)``, the same matrix as the JAX
    package's ``_orth_probe_np``.  For any orthogonal projector P the
    kept block of ``P @ probe`` has unit singular values, so one CholQR
    pass leaves an eps-level orthogonality defect."""
    rng = np.random.default_rng(7)
    q, _ = np.linalg.qr(rng.standard_normal((r, r)))
    return q


@lru_cache(maxsize=16)
def _power_probe_np(r: int) -> np.ndarray:
    """The unit start vector of the prefix sweep's power iterations.  The
    JAX package draws it from ``jax.random`` (key 3); this is another
    fixed vector, from ``default_rng(3)``: it only seeds three power
    steps that estimate a largest eigenvalue."""
    v = np.random.default_rng(3).standard_normal(r)
    return v / np.linalg.norm(v)


def _solve_right_lt(l, b):
    """X with X L^T = B for lower-triangular L (batched)."""
    return torch.linalg.solve_triangular(l.mT, b, upper=True, left=False)


def _proj_basis_cols(proj, masks, mach: float, escalate: bool, fails: list):
    """Orthonormal column bases of batched spectral projectors (the JAX
    package's ``_proj_basis_cols``): one batched CholQR pass on
    ``P @ probe``, the masks, then a two-step Newton-Schulz
    orthonormality polish ``Q <- Q (3I - Q^T Q)/2``.

    Entries whose first-pass defect exceeds 0.1 are re-CholQR'd before
    the polish.  The JAX package decides that with ``lax.cond``; here the
    recovery is computed for every entry and selected with
    ``torch.where``, so nothing is read back to the host.
    """
    r = proj.shape[-1]
    probe = torch.as_tensor(_orth_probe_np(r), dtype=proj.dtype, device=proj.device)
    c0 = torch.einsum("kab,bc->kac", proj, probe)
    g = torch.einsum("kab,kac->kbc", c0, c0)
    jit = (_trace(g) / r + _TINY) * (20.0 * mach)
    l, _ = _chol_adaptive(g, jit, escalate, fails)
    q = _solve_right_lt(l, c0) * masks[:, None, :]
    eye = _eye(r, proj)

    gq = torch.einsum("kab,kac->kbc", q, q)
    tgt = eye[None] * masks[:, None, :]  # diag(mask): kept columns -> 1
    defect = torch.amax(torch.abs(gq - tgt), dim=(-2, -1))
    bad = defect > 0.1
    jit2 = (_trace(gq) / r + _TINY) * (20.0 * mach)
    l2, _ = _chol_adaptive(gq, jit2, escalate, [])
    if not escalate:  # only the entries that take the recovery count
        fails.append((bad & ~torch.isfinite(l2).all(dim=-1).all(dim=-1)).any())
    q2 = _solve_right_lt(l2, q) * masks[:, None, :]
    q = torch.where(bad[:, None, None], q2, q)
    gq = torch.einsum("kab,kac->kbc", q, q)
    for step in range(2):
        q = torch.einsum("kab,kbc->kac", q, 1.5 * eye[None] - 0.5 * gq)
        if step == 0:
            gq = torch.einsum("kab,kac->kbc", q, q)
    return q


def _budget(first_c, eps: float, relative: bool, d: int) -> torch.Tensor:
    """The per-bond truncation budget of the sequential sweeps."""
    norm = torch.linalg.norm(first_c)
    eps_t = torch.as_tensor(eps, dtype=first_c.dtype, device=first_c.device)
    return (eps_t * norm if relative else eps_t) / float(np.sqrt(d - 1.0))


def _chol_rows(mat, mult: float, escalate: bool, fails: list):
    """Row-orthonormalize by CholQR: ``mat = L @ Q``; returns (L, Q, the
    shift).  ``mult`` scales the trace-relative shift in machine eps."""
    g = mat @ mat.T
    jitter = (torch.trace(g) / g.shape[0] + _TINY) * (mult * torch.finfo(mat.dtype).eps)
    l, jitter = _chol_adaptive(g, jitter, escalate, fails)
    q = torch.linalg.solve_triangular(l, mat, upper=False)
    return l, q, jitter


def _chol2_rows(mat, escalate: bool, fails: list):
    """Two CholQR passes; also returns the total shift mass the R
    factor's singular values were inflated by (rank-deficient rows come
    out at ~sqrt(shift): ghosts that truncation must not keep)."""
    l1, q1, j1 = _chol_rows(mat, 20.0, escalate, fails)
    l2, q2, j2 = _chol_rows(q1, 20.0, escalate, fails)
    scale1 = torch.trace(l1 @ l1.T) / l1.shape[0]
    return l1 @ l2, q2, j1 + j2 * scale1


def _back_chol2(mids, last, escalate: bool, fails: list):
    """Right-orthogonalize by CholeskyQR2 from the last core back:
    returns (carry L_1, the orthonormal middles, the orthonormal last)."""
    carry, last_q, _ = _chol2_rows(last, escalate, fails)
    mids_q = [None] * mids.shape[0]
    for k in range(mids.shape[0] - 1, -1, -1):
        rr, n, rc = mids[k].shape
        cur = torch.einsum("rnk,kc->rnc", mids[k], carry)
        carry, q, _ = _chol2_rows(cur.reshape(rr, n * rc), escalate, fails)
        mids_q[k] = q.reshape(rr, n, rc)
    return carry, mids_q, last_q


def _failed(fails: list, like: torch.Tensor) -> torch.Tensor:
    """Any Cholesky failure of a sweep, as one device flag."""
    if not fails:
        return torch.zeros((), dtype=torch.bool, device=like.device)
    return torch.stack(fails).any()


# ---- the GEMM-based sweeps --------------------------------------------------
#
# Each takes (first, mids, last, eps, relative, bounds, escalate) with
# ``bounds`` the (d-1,) structural rank caps (:func:`_bond_bounds`) on the
# cores' device, and returns (first_out, mids_out, last_out, kept ranks
# (d-1,), Cholesky failure flag), all on the device.


def _tt_round_gram_sweep(first, mids, last, eps, relative, bounds, escalate=False):
    """Gram/CholQR rounding sweep (the JAX package's
    ``_tt_round_gram_sweep_fn``): CholQR right-orthogonalization, then a
    forward truncation by ``eigh`` of each bond's r x r Gram matrix.

    Squares the condition number: singular values below sqrt(dtype eps)
    of the norm are unresolvable, so only for eps >> sqrt(eps_dtype)
    (f32: >= ~1e-3, f64: >= ~1e-7).  ``torch.linalg.eigh`` checks its
    result on the host, so each bond costs one device-to-host read.
    """
    d = mids.shape[0] + 2
    fails: list = []
    dt = first.dtype

    # ---- backward CholQR sweep ----------------------------------------
    carry, last_q, _ = _chol_rows(last, 10.0, escalate, fails)
    mids_q = [None] * mids.shape[0]
    for k in range(mids.shape[0] - 1, -1, -1):
        rr, n, rc = mids[k].shape
        cur = torch.einsum("rnk,kc->rnc", mids[k], carry)
        carry, q, _ = _chol_rows(cur.reshape(rr, n * rc), 10.0, escalate, fails)
        mids_q[k] = q.reshape(rr, n, rc)
    first_c = first @ carry

    # ---- forward Gram-eigh truncation sweep ---------------------------
    budget = _budget(first_c, eps, relative, d)

    def gram_trunc(cur, kmax):
        # kmax: the structural rank bound of the bond; eigenvalues past it
        # are Gram-squaring noise and never kept, whatever the budget
        # NaN (a failed Cholesky) reaches the outputs through ``cur``;
        # eigh itself would raise on it
        w, v = torch.linalg.eigh(torch.nan_to_num(cur.T @ cur))  # ascending
        w = torch.flip(w, [0])
        v = torch.flip(v, [1])
        s = torch.sqrt(torch.clamp(w, min=0.0))
        k = torch.minimum(_trunc_count(s, budget), kmax)
        m = (torch.arange(s.shape[0], device=s.device) < k).to(dt)
        inv_s = torch.where(s > 0, 1.0 / torch.where(s > 0, s, torch.ones_like(s)),
                            torch.zeros_like(s))
        u = cur @ (v * (m * inv_s)[None, :])
        return u, (m * s)[:, None] * v.T, k

    first_out, carry_sv, k = gram_trunc(
        first_c, torch.clamp(bounds[0], max=min(first.shape[0], first_c.shape[1]))
    )
    mids_out, ranks = [], [k]
    for i, core in enumerate(mids_q):
        rr, n, rc = core.shape
        cur = torch.einsum("ak,knc->anc", carry_sv, core)
        kmax = torch.minimum(torch.clamp(k * n, max=rc), bounds[i + 1])
        u, carry_sv, k = gram_trunc(cur.reshape(rr * n, rc), kmax)
        mids_out.append(u.reshape(rr, n, -1))
        ranks.append(k)
    last_out = carry_sv @ last_q
    return (first_out, torch.stack(mids_out), last_out, torch.stack(ranks),
            _failed(fails, first))


def _tt_round_cholqr2_sweep(first, mids, last, eps, relative, bounds, escalate=False):
    """Accurate all-GEMM rounding sweep (the JAX package's
    ``_tt_round_cholqr2_sweep_fn``): CholeskyQR2 right-orthogonalization
    and an exact SVD of each bond's small R factor.

    A trace-scaled shift keeps the Cholesky alive on rank-deficient
    bonds; it inflates null directions to ~sqrt(shift) ("ghosts"), which
    the truncation decision deflates (sqrt(s^2 - shift)) while the kept
    factors use the exact s.  Ghost floor ~sqrt(40 eps) relative.
    ``torch.linalg.svd`` checks its result on the host: one read per bond.
    """
    d = mids.shape[0] + 2
    fails: list = []
    carry, mids_q, last_q = _back_chol2(mids, last, escalate, fails)
    first_c = first @ carry
    budget = _budget(first_c, eps, relative, d)

    def trunc_cols(cur, bound):
        r_tot, qt, j_tot = _chol2_rows(cur.T, escalate, fails)  # cur = q r_tot^T
        # as in the gram sweep: NaN reaches the outputs through ``qt``
        u_s, s, vt = torch.linalg.svd(torch.nan_to_num(r_tot.T), full_matrices=False)
        s_true = torch.sqrt(torch.clamp(s * s - j_tot, min=0.0))
        k = torch.minimum(_trunc_count(s_true, budget), bound)
        m = (torch.arange(s.shape[0], device=s.device) < k).to(s.dtype)
        return qt.T @ (u_s * m[None, :]), (m * s)[:, None] * vt, k

    first_out, carry_sv, k = trunc_cols(first_c, bounds[0])
    mids_out, ranks = [], [k]
    for i, core in enumerate(mids_q):
        rr, n, rc = core.shape
        cur = torch.einsum("ak,knc->anc", carry_sv, core)
        left, carry_sv, k = trunc_cols(cur.reshape(rr * n, rc), bounds[i + 1])
        mids_out.append(left.reshape(rr, n, -1))
        ranks.append(k)
    last_out = carry_sv @ last_q
    return (first_out, torch.stack(mids_out), last_out, torch.stack(ranks),
            _failed(fails, first))


def _sign_projectors(a0, sign_iters: int):
    """0.5 (I + sign(a0)) for a batch of symmetric matrices, with the
    Gershgorin bound (>= |lambda|_max, so Newton-Schulz converges) as
    the spectral scaling."""
    alpha = torch.amax(torch.sum(torch.abs(a0), dim=2), dim=1) + _TINY
    sign = _sign_newton_schulz(a0, alpha, sign_iters)
    return 0.5 * (_eye(a0.shape[-1], a0)[None] + sign)


def _kept_ranks(proj, bounds):
    """Kept rank per bond: the projector's rounded trace in [1, r],
    capped by the structural bounds; and the column masks."""
    r = proj.shape[-1]
    tr = torch.round(_trace(proj)).to(torch.int64)
    ks = torch.minimum(torch.clamp(tr, 1, r), bounds)
    masks = (torch.arange(r, device=proj.device)[None, :] < ks[:, None]).to(proj.dtype)
    return ks, masks


def _tt_round_twosided_sweep(first, mids, last, eps, relative, bounds,
                             escalate=False):
    """Two-sided rounding with matmul-only spectral-projector truncation
    (the JAX package's ``_tt_round_twosided_sweep_fn``): CholeskyQR2
    right-orthogonalization, a forward CholeskyQR2 chain collecting every
    bond matrix L_k, truncation projectors of all bonds at once by a
    batched Newton-Schulz sign iteration, and the projection
    W_k = Q_{k-1}^T U_k Q_k.

    Drops directions with sigma^2 < budget^2 / r: the error contract
    holds, but it may keep a few more ranks than the SVD sweep on slowly
    decaying spectra.  No eigensolver: the host reads only the sign
    iteration's error, every few iterations.
    """
    d = mids.shape[0] + 2
    r = last.shape[0]
    dt = first.dtype
    fails: list = []
    carry, mids_q, last_q = _back_chol2(mids, last, escalate, fails)
    first_c = first @ carry  # (n, r) = U_1 L_1

    # ---- forward CholQR2 chain: the U_k and the bond matrices ---------
    lt1, u1t, j1 = _chol2_rows(first_c.T, escalate, fails)
    u_first = u1t.T
    l_bond = lt1.T
    l_list, j_list, u_mids = [l_bond], [j1], []
    for core in mids_q:
        rr, n, rc = core.shape
        cur = torch.einsum("ak,knc->anc", l_bond, core)
        lt, qt, j = _chol2_rows(cur.reshape(rr * n, rc).T, escalate, fails)
        l_bond = lt.T
        u_mids.append(qt.T.reshape(rr, n, rc))
        l_list.append(l_bond)
        j_list.append(j)
    l_end = l_bond
    l_all = torch.stack(l_list)  # (d-1, r, r): every bond, the last is l_end
    j_all = torch.stack(j_list)
    u_mids = torch.stack(u_mids)

    # ---- truncation projectors for all bonds at once -------------------
    gram = torch.einsum("kab,kcb->kac", l_all, l_all)  # column space of L_k
    # ||X||^2 = ||L_k||_F^2 at any bond; deflate the r shift masses
    norm2 = torch.clamp(torch.sum(l_all[-1] ** 2) - r * j_all[-1], min=0.0)
    eps_b = torch.as_tensor(eps, dtype=dt, device=first.device)
    budget2 = (eps_b**2 * norm2 if relative else eps_b**2) / (d - 1.0)
    tau2 = budget2 / r + j_all  # per direction, + the shift inflation
    eye = _eye(r, first)
    proj = _sign_projectors(gram - tau2[:, None, None] * eye[None], _SIGN_ITERS)
    ks, masks = _kept_ranks(proj, bounds)
    um = _proj_basis_cols(proj, masks, torch.finfo(dt).eps, escalate, fails)

    # ---- project: W_k = Q_{k-1}^T U_k Q_k -------------------------------
    first_out = u_first @ um[0]
    mids_out = torch.einsum("kam,kanb,kbp->kmnp", um[:-1], u_mids, um[1:])
    last_out = um[-1].T @ (l_end @ last_q)
    return first_out, mids_out, last_out, ks, _failed(fails, first)


def _power_lmax(mats, probe, steps: int = 3):
    """|lambda|_max estimate per matrix: ``steps`` batched power steps
    from ``probe``, then the Rayleigh quotient."""
    v = probe.expand(mats.shape[0], -1)
    for _ in range(steps):
        v = torch.einsum("kab,kb->ka", mats, v)
        v = v / (torch.linalg.norm(v, dim=1, keepdim=True) + _TINY)
    return torch.abs(torch.einsum("ka,kab,kb->k", v, mats, v)) + _TINY


def _tt_round_prefix_sweep(first, mids, last, eps, relative, bounds,
                           escalate=False, chain_precision: str = "high"):
    """Batched two-sided Gram rounding, the parallel-prefix mode (the JAX
    package's ``_tt_round_prefix_sweep_fn``).  The sequential chains
    carry only GEMMs; every factorization is batched over all bonds:

    1. left Grams H_k (forward) and right Grams G_k (backward) of every
       bond, both advanced by one pair of batched GEMMs per step, each
       step trace-rescaled (log-scales kept) so nothing over/underflows;
    2. one batched Cholesky whitening of all bonds, H = E^T E, G = F^T F;
    3. batched Newton-Schulz sign projectors onto the above-threshold
       left singular subspace of W_k = E_k F_k^T, bases by CholQR;
    4. oblique insertions a_k = E_k^{-1} Q_k, b_k^T = Q_k^T E_k, and the
       cores B_k = b_{k-1}^T A_k a_k in one batched einsum.

    Error rule: tau^2 = budget^2 / r per direction and bond, the
    twosided sweep's contract.  ``chain_precision``: ``"dw"`` carries
    the H/G chains in float64 (the JAX package's double-word carries;
    no double-word arithmetic here) and adds the spectral trust filters
    and noise clamp of that mode; ``"high"`` and ``"highest"`` both carry
    them in the cores' dtype in full precision (TF32 stays off) with the
    trace-product ghost deflation.  ``TNT_PREFIX_UNROLL`` of the JAX
    package has no meaning here: the chain is a Python loop, not a scan.
    """
    d = mids.shape[0] + 2
    r = last.shape[0]
    dt = first.dtype
    dev = first.device
    fails: list = []

    # ---- fused H/G chains: GEMM-only -----------------------------------
    h0 = first.T @ first
    s0 = torch.trace(h0) / r + _TINY
    g0 = last @ last.T
    t0 = torch.trace(g0) / r + _TINY
    # the H and G updates share one form, out[c, C] = sum M[a, b]
    # X[a, n, c] X[b, n, C], with X = core for H and the core reversed
    # end for end for G: one batched GEMM pair advances both chains
    cdt = torch.float64 if chain_precision == "dw" else dt
    xs = torch.stack([mids, torch.flip(mids, [0]).permute(0, 3, 2, 1)], dim=1).to(cdt)
    m = torch.stack([h0 / s0, g0 / t0]).to(cdt)
    m_seq, s_seq = [], []
    for x in xs:  # x (2, r, n, r)
        t = torch.einsum("yab,yanc->ybnc", m, x)
        m2 = torch.einsum("ybnc,ybnC->ycC", t, x)
        s = torch.einsum("yaa->y", m2) / r + _TINY
        m = m2 / s[:, None, None]
        m_seq.append(m)
        s_seq.append(s)
    m_seq = torch.stack(m_seq)
    ls_seq = torch.cumsum(torch.log(torch.stack(s_seq)), dim=0).to(dt)  # (d-2, 2)
    m_seq = m_seq.to(dt)
    # step i advances H over core i+1 (H at bond i+1) and G over core
    # d-2-i (G at bond d-3-i): G comes out in reverse bond order
    h_all = torch.cat([(h0 / s0)[None], m_seq[:, 0]])  # (nb, r, r)
    g_all = torch.cat([torch.flip(m_seq[:, 1], [0]), (g0 / t0)[None]])
    zero = torch.zeros(1, dtype=dt, device=dev)
    lh_all = torch.log(s0) + torch.cat([zero, ls_seq[:, 0]])
    lg_all = torch.log(t0) + torch.cat([torch.flip(ls_seq[:, 1], [0]), zero])

    norm2 = torch.einsum("kab,kba->k", h_all, g_all)  # ||X||^2, bond units
    eps_b = torch.as_tensor(eps, dtype=dt, device=dev)
    if relative:
        tau2 = eps_b**2 * norm2 / ((d - 1.0) * r)
    else:
        tau2 = eps_b**2 / ((d - 1.0) * r) * torch.exp(-(lh_all + lg_all))
    ks, a_ins, bt_ins = _prefix_bonds(h_all, g_all, tau2, bounds, chain_precision == "dw",
                                      _SIGN_ITERS, escalate, fails)
    first_out = first @ a_ins[0]
    mids_out = torch.einsum("kma,kanb,kbp->kmnp", bt_ins[:-1], mids, a_ins[1:])
    last_out = bt_ins[-1] @ last
    return first_out, mids_out, last_out, ks, _failed(fails, first)


def _prefix_bonds(h_all, g_all, tau2, bounds, dw: bool, sign_iters: int,
                  escalate: bool, fails: list):
    """The prefix sweep's decisions on a batch of bonds from their left
    and right Grams H and G (no communication: the train-sharded form runs
    it on each rank's own bonds).  ``tau2`` is the per-direction
    threshold before the ghost terms; ``sign_iters`` caps the sign
    iteration (the trust filters' at :data:`_TRUST_SIGN_ITERS`).  Returns
    the kept ranks and the oblique insertions ``a`` and ``b^T`` of every
    bond."""
    nb, r = h_all.shape[0], h_all.shape[-1]
    dt, dev = h_all.dtype, h_all.device
    mach = torch.finfo(dt).eps
    eye = _eye(r, h_all)

    # ---- batched whitening: one Cholesky over both chains --------------
    hg_all = torch.cat([h_all, g_all])  # (2 nb, r, r)
    jit_hg = (_trace(hg_all) / r + _TINY) * (20.0 * mach)
    l_hg, jit_hg = _chol_adaptive(hg_all, jit_hg, escalate, fails)
    jit_h, jit_g = jit_hg[:nb], jit_hg[nb:]
    e_all = l_hg[:nb].mT  # upper: H = E^T E
    f_all = l_hg[nb:].mT  # upper: G = F^T F

    def sym(x):
        return 0.5 * (x + x.mT)

    if not dw:
        # tau^2 inflated by the trace-product ghost bound
        ghost = jit_h * _trace(g_all) + jit_g * _trace(h_all)
        tau2 = tau2 + 2.0 * ghost
        w_all = torch.einsum("kab,kcb->kac", e_all, f_all)
    else:
        # spectral trust filters: the directions of H/G under the
        # shift / representation floor leave the decision operator
        # W = E (P_h P_g) F^T
        probe = torch.as_tensor(_power_probe_np(r), dtype=dt, device=dev)
        lmax = _power_lmax(hg_all, probe)
        theta = 2.0 * jit_hg + 2.0 * mach * lmax
        # explicit symmetrization: Newton-Schulz diverges for eigenvalues
        # pushed off the real axis by ulp-level asymmetry
        trust = _sign_projectors(sym(hg_all) - theta[:, None, None] * eye[None],
                                 min(sign_iters, _TRUST_SIGN_ITERS))
        ep = torch.einsum("kab,kbc->kac", e_all, trust[:nb])
        pf = torch.einsum("kab,kcb->kac", trust[nb:], f_all)
        w_all = torch.einsum("kab,kbc->kac", ep, pf)
    ww = sym(torch.einsum("kab,kcb->kac", w_all, w_all))
    if dw:
        # noise-floor clamp: ww carries ~eps lambda_max of eigenvalue noise
        tau2 = tau2 + 2.0 * mach * _power_lmax(ww, probe)

    # ---- batched sign projectors and bases -------------------------------
    proj = _sign_projectors(ww - tau2[:, None, None] * eye[None], sign_iters)
    ks, masks = _kept_ranks(proj, bounds)
    q_all = _proj_basis_cols(proj, masks, mach, escalate, fails)

    # ---- oblique insertions a = E^{-1} Q, b^T = Q^T E ---------------------
    a_ins = torch.linalg.solve_triangular(e_all, q_all, upper=True)  # E a = Q
    bt_ins = torch.einsum("kca,kcb->kab", q_all, e_all)
    return ks, a_ins, bt_ins


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
    """Round a TT chain with a fused static-shape sweep.

    ``method="svd"`` is the Householder-QR sweep (the default);
    ``"cholqr2"`` the all-GEMM accurate mode (CholeskyQR2 + exact
    R-factor SVDs); ``"twosided"`` removes the per-bond eigensolvers
    (CholeskyQR2 chains + batched matrix-sign projectors; may keep a few
    more ranks on slowly decaying spectra); ``"prefix"`` carries only
    GEMMs in its chains and batches every factorization over the bonds,
    at Gram accuracy (sqrt(mach eps) floor); ``"gram"`` is the
    loose-tolerance CholQR + Gram-eigh mode.  An unknown method string
    runs the ``svd`` sweep.  ``reorth`` orthogonalizes twice per bond in
    the ``svd`` sweep for tight budgets near the dtype noise floor.
    ``TNT_PREFIX_CHAIN_PREC`` ("high", "highest" or "dw") sets the prefix
    chains' precision.  Returns the rounded network (bonds compacted to
    the kept ranks) and the kept rank per bond.

    Any linear chain qualifies: ragged bond ranks, mixed mode sizes, and
    non-canonical core layouts are zero-padded into the uniform sweep
    (:func:`_chain_padded`) and sliced/un-permuted on emit; the GEMM
    methods cap each bond at the rank its exact matricization can hold
    (:func:`_bond_bounds`, from the true shapes).  Non-chain topologies
    raise.

    Resilience: when a Cholesky-based sweep breaks down (NaN on a heavily
    rank-deficient train) the call falls back to the Householder sweep
    with a warning and counts it in ``ROUND_STATS["fallback_nan"]``.
    """
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
    mach = float(torch.finfo(first.dtype).eps)
    prefix_chain = os.environ.get("TNT_PREFIX_CHAIN_PREC", "high")
    if method == "prefix" and prefix_chain == "dw":
        # compensated chains + trust filters resolve ~2 sqrt(mach eps)
        floor = 2.0 * float(np.sqrt(mach))
    elif method in ("gram", "prefix"):
        # Gram chains square the condition number: singular values below
        # ~sqrt(mach eps) of the norm are unresolvable regardless of d
        floor = 4.0 * float(np.sqrt(mach))
    else:
        floor = sweep_noise_floor(first.dtype, d) / (2.0 if reorth else 1.0)
    if relative and eps < floor:
        dtype_name = str(first.dtype).removeprefix("torch.")
        if method in ("gram", "prefix"):
            remedy = (
                "Use an accurate method (svd/cholqr2/twosided), or "
                "ops.tight.tt_round_tight for tight budgets on device."
            )
        else:
            remedy = (
                "Use float64, reorth=True for a ~2x-cost sweep with an "
                "eps-level floor, or ops.tight.tt_round_tight on device."
            )
        warnings.warn(
            f"requested relative eps={eps:.1e} is below the ~{floor:.1e} "
            f"noise floor of a {d}-core {dtype_name} {method} rounding "
            f"sweep; truncation may not engage. {remedy}",
            RuntimeWarning,
            stacklevel=2,
        )

    # looked up at call time, so tests can substitute a sweep
    sweeps = {
        "gram": _tt_round_gram_sweep,
        "cholqr2": _tt_round_cholqr2_sweep,
        "twosided": _tt_round_twosided_sweep,
        "prefix": lambda *a, **k: _tt_round_prefix_sweep(
            *a, chain_precision=prefix_chain, **k
        ),
    }
    if method not in sweeps:
        f, m, l, ks = _tt_round_sweep(first, mids, last, eps, relative, reorth)
        ROUND_STATS["svd"] += 1
        ranks = [int(x) for x in ks.tolist()]  # the sweep's one host fetch
        return emit_chain(tn, f, m, l, ranks, emit)

    # static structural rank caps from the TRUE shapes: on padded or
    # thin-ended chains the Gram / shift noise of these modes can inflate
    # spectra past the rank the exact matricization holds
    if emit is not None:
        true_shapes = emit[1]
        modes = (
            [true_shapes[0][0]]
            + [sh[1] for sh in true_shapes[1:-1]]
            + [true_shapes[-1][1]]
        )
        bond_dims = [true_shapes[0][1]] + [sh[2] for sh in true_shapes[1:-1]]
    else:
        modes = [first.shape[0]] + [mids.shape[2]] * (d - 2) + [last.shape[1]]
        bond_dims = [last.shape[0]] * (d - 1)
    bounds = torch.as_tensor(
        _bond_bounds(modes, bond_dims, int(last.shape[0])),
        dtype=torch.int64,
        device=first.device,
    )
    for escalate in (False, True):
        f, m, l, ks, failed = sweeps[method](
            first, mids, last, eps, relative, bounds, escalate=escalate
        )
        # breakdown detection covers EVERY core: a NaN confined to a
        # middle bond never reaches the last core's projection
        finite = torch.isfinite(torch.sum(f) + torch.sum(m) + torch.sum(l))
        # the kept ranks and both flags in one host fetch
        *ranks, failed, finite = torch.cat(
            [ks.to(torch.int64), failed.view(1).to(torch.int64),
             finite.view(1).to(torch.int64)]
        ).tolist()
        if not failed:  # a Cholesky failed: rerun with shift escalation
            break
    ROUND_STATS[method] += 1
    if not finite:
        ROUND_STATS["fallback_nan"] += 1
        warnings.warn(
            f"{method} rounding sweep broke down (NaN — Cholesky on a "
            "heavily rank-deficient train); falling back to the "
            "Householder sweep",
            RuntimeWarning,
            stacklevel=2,
        )
        f, m, l, ks = _tt_round_sweep(first, mids, last, eps, relative, reorth)
        ranks = ks.tolist()
    return emit_chain(tn, f, m, l, [int(x) for x in ranks], emit)


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
