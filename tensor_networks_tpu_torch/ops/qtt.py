"""Quantized-TT (QTT) constructors: grid operators and functions over
binary modes.

Counterpart of ``tensor_networks_tpu/ops/qtt.py``.  2^K-point grids
stored as K binary modes make billion-point PDE-style workloads
representable on one card; these constructors produce the packed forms
the solvers (:func:`ops.packed.gmres_packed`) consume directly, on
``device`` (default: the card).  Little-endian bit convention
throughout: core 0 is the least significant bit of the grid index.

The cores are built in NumPy and copied to the device whole: the
repeated middle cores are materialized, never a stride-0 broadcast
view, since the kernels and in-place updates need real strides.

No reference counterpart (``pytens`` has no QTT constructors; its
operator constructors are per-mode Kronecker products,
``pytens/algs.py:2383-2532``).  Dense oracles:
``tests/test_qtt_solve.py``.
"""

from __future__ import annotations

from math import comb as _comb

import numpy as np
import torch

from tensor_networks_tpu_torch.ops.packed import PackedTT, PackedTTOp, ttop_add
from tensor_networks_tpu_torch.types import resolve_device


def _on(device, dtype, *arrays):
    device = resolve_device(device)
    return [
        torch.tensor(np.ascontiguousarray(a), dtype=dtype, device=device)
        for a in arrays
    ]


def _repeat(core: np.ndarray, times: int) -> np.ndarray:
    """``times`` copies of ``core`` stacked on a new leading axis (a real
    array, not a broadcast view)."""
    return np.repeat(core[None], times, axis=0)


def qtt_shift(K: int, dtype=torch.float64, device=None) -> PackedTTOp:
    """Rank-2 QTT of the shift-by-one operator ``(S u)_i = u_{i+1}``
    (Dirichlet: the wraparound carry is dropped).

    A two-state carry automaton over the bits: state 0 = done (apply
    I), state 1 = a pending +1 (apply J = [[0,1],[0,0]] to finish or
    J^T to keep carrying).
    """
    if K < 2:
        raise ValueError("QTT operators need K >= 2 (K=2 has no middle"
                         " cores; the chain solvers need K >= 3)")
    eye = np.eye(2)
    J = np.array([[0.0, 1.0], [0.0, 0.0]])
    first = np.zeros((2, 2, 2))
    first[:, :, 0] = J
    first[:, :, 1] = J.T
    mid = np.zeros((2, 2, 2, 2))
    mid[0, :, :, 0] = eye
    mid[1, :, :, 0] = J
    mid[1, :, :, 1] = J.T
    last = np.zeros((2, 2, 2))
    last[0] = eye
    last[1] = J
    return PackedTTOp(*_on(device, dtype, first, _repeat(mid, K - 2), last))


def qtt_tridiagonal(
    K: int, main: float, upper: float, lower: float, dtype=torch.float64,
    device=None,
) -> PackedTTOp:
    """Rank-3 QTT of the Toeplitz tridiagonal
    ``main * I + upper * S + lower * S^T`` on 2^K points (Dirichlet
    ends; ``(S u)_i = u_{i+1}``).

    Three-state carry automaton: 0 = done, 1 = pending +1 (the
    ``upper * S`` term), 2 = pending -1 (the ``lower * S^T`` term);
    the coefficients enter once at the first core.  Covers stiffness
    (``2+delta, -1, -1``), FEM mass (``4/6, 1/6, 1/6``), and upwind
    advection (``1, -1, 0``) matrices exactly.
    """
    if K < 2:
        raise ValueError("QTT operators need K >= 2 (K=2 has no middle"
                         " cores; the chain solvers need K >= 3)")
    eye = np.eye(2)
    J = np.array([[0.0, 1.0], [0.0, 0.0]])
    Jt = J.T

    first = np.zeros((2, 2, 3))
    first[:, :, 0] = main * eye + upper * J + lower * Jt
    first[:, :, 1] = upper * Jt  # start the upper*S carry chain
    first[:, :, 2] = lower * J  # start the lower*S^T carry chain
    mid = np.zeros((3, 2, 2, 3))
    mid[0, :, :, 0] = eye
    mid[1, :, :, 0] = J  # +1 lands here
    mid[1, :, :, 1] = Jt  # +1 keeps carrying
    mid[2, :, :, 0] = Jt  # -1 lands here
    mid[2, :, :, 2] = J  # -1 keeps carrying
    last = np.zeros((3, 2, 2))
    last[0] = eye
    last[1] = J
    last[2] = Jt
    return PackedTTOp(*_on(device, dtype, first, _repeat(mid, K - 2), last))


def qtt_screened_laplacian(
    K: int, delta: float = 1.0, dtype=torch.float64, device=None
) -> PackedTTOp:
    """Rank-3 QTT of ``(2 + delta) I - S - S^T`` on 2^K points
    (Dirichlet ends) -- see :func:`qtt_tridiagonal`.

    With ``delta > 0`` the spectrum sits in ``[delta, 4 + delta]`` --
    condition independent of K, so solves stay meaningful at K = 30
    (2^30 unknowns).
    """
    return qtt_tridiagonal(K, 2.0 + delta, -1.0, -1.0, dtype, device)


def qtt_interleave_1d_op(op1d: PackedTTOp, K: int, phase: int,
                         dtype=torch.float64, naxes: int = 2,
                         device=None) -> PackedTTOp:
    """Extend a rank-R 1D QTT operator over ``naxes * K`` interleaved
    bits.

    The 1D cores sit at global positions with ``pos % naxes == phase``
    (axis 0 = x bits, 1 = y, ...); every other position carries a
    rank-diagonal identity core, so the automaton state rides across
    the foreign axes untouched.  Boundary embeddings keep the packed
    uniform-rank layout: the 1D first/last cores become mids entering/
    exiting at rank channel 0.
    """
    if not 0 <= phase < naxes:
        raise ValueError(f"phase {phase} outside [0, {naxes})")
    R = op1d.first.shape[-1]
    eyeRC = np.zeros((R, 2, 2, R))
    for a in range(R):
        eyeRC[a, :, :, a] = np.eye(2)
    first1, mids1, last1 = (
        x.detach().cpu().numpy() for x in (op1d.first, op1d.mids, op1d.last)
    )

    as_mid_first = np.zeros((R, 2, 2, R))
    as_mid_first[0] = first1  # enter at channel 0
    as_mid_last = np.zeros((R, 2, 2, R))
    as_mid_last[:, :, :, 0] = last1  # exit into channel 0
    own = [as_mid_first] + list(mids1) + [as_mid_last]

    cores = [
        own[pos // naxes] if pos % naxes == phase else eyeRC
        for pos in range(naxes * K)
    ]
    gfirst = cores[0][0]  # (2, 2, R)
    glast = cores[-1][:, :, :, 0]  # (R, 2, 2)
    gmids = np.stack(cores[1:-1])
    return PackedTTOp(*_on(device, dtype, gfirst, gmids, glast))


def qtt_screened_laplacian_2d(
    K: int, delta: float = 1.0, dtype=torch.float64, device=None
) -> PackedTTOp:
    """Rank-6 QTT of the 2D screened Laplacian on a 2^K x 2^K grid with
    interleaved bits (x at even positions): two interleaved 1D automata
    summed with :func:`ops.packed.ttop_add`."""
    return qtt_screened_laplacian_nd(K, 2, delta=delta, dtype=dtype,
                                     device=device)


def qtt_screened_laplacian_nd(
    K: int, naxes: int, delta: float = 1.0, dtype=torch.float64, device=None
) -> PackedTTOp:
    """Rank-``3 * naxes`` QTT of the n-dimensional screened Laplacian
    on a (2^K)^naxes grid with interleaved bits: ``naxes`` interleaved
    1D automata summed with :func:`ops.packed.ttop_add` (the shift at
    each axis sees a contiguous carry chain because interleaving is
    uniform).  ``delta`` applies once (axis 0); the other axes
    contribute plain ``2I - S - S^T``."""
    if K < 2:
        raise ValueError("the interleaved operator needs K >= 2")
    if naxes < 1:
        raise ValueError(f"naxes must be >= 1, got {naxes}")
    ops = [
        qtt_interleave_1d_op(
            qtt_screened_laplacian(
                K, delta=delta if a == 0 else 0.0, dtype=dtype, device="cpu"
            ),
            K,
            a,
            dtype,
            naxes=naxes,
            device=device,
        )
        for a in range(naxes)
    ]
    return ttop_add(*ops)


def qtt_rank1_from_weights(ws, dtype=torch.float64, device=None) -> PackedTT:
    """Rank-1 binary-mode train with per-position mode weights
    ``[1, ws[p]]`` -- separable functions factor over bits this way."""
    if len(ws) < 2:
        raise ValueError(
            f"need >= 2 positions (a PackedTT has >= 2 cores), got "
            f"{len(ws)}"
        )
    first = np.array([[1.0], [ws[0]]])  # (n, r)
    mids = np.array([[[[1.0], [w]]] for w in ws[1:-1]]).reshape(
        len(ws) - 2, 1, 2, 1
    )  # (d-2, 1, 2, 1)
    last = np.array([[1.0, ws[-1]]])  # (r, n)
    return PackedTT(*_on(device, dtype, first, mids, last))


def qtt_exponential(
    K: int, c: float = 3.0, dtype=torch.float64, device=None
) -> PackedTT:
    """Exact rank-1 QTT of ``f_i = exp(-c i / 2^K)`` (exponentials
    factor over bits: exp(a i) = prod_k exp(a b_k 2^k))."""
    ws = [float(np.exp(-c * (2.0**k) / 2.0**K)) for k in range(K)]
    return qtt_rank1_from_weights(ws, dtype, device)


def qtt_trig(
    K: int, freq: float, phase: float = 0.0, dtype=torch.float64, device=None
) -> PackedTT:
    """Exact rank-2 QTT of ``f_i = sin(freq * i / 2^K + phase)``.

    The classic angle-addition automaton: the bond carries the
    2-state ``[sin(theta), cos(theta)]`` of the partial bit sum and
    every core applies the rotation by its bit's angle --
    ``sin``/``cos``/any phase shift of a linear argument is exactly
    rank 2 in QTT (use ``phase=pi/2`` for cosine).
    """
    if K < 3:
        raise ValueError("packed trains need K >= 3")
    a = float(freq) / 2.0**K

    def rot(k):
        # (2 values, 2x2 rotation): G[alpha, v, beta]
        out = np.zeros((2, 2, 2))
        for v in (0, 1):
            phi = a * v * 2.0**k
            c, s = np.cos(phi), np.sin(phi)
            out[:, v, :] = [[c, -s], [s, c]]
        return out

    first = np.zeros((2, 2))
    for v in (0, 1):
        th = phase + a * v
        first[v] = [np.sin(th), np.cos(th)]
    mids = np.stack([rot(k) for k in range(1, K - 1)])
    last = np.zeros((2, 2))
    for v in (0, 1):
        phi = a * v * 2.0 ** (K - 1)
        last[:, v] = [np.cos(phi), np.sin(phi)]
    return PackedTT(*_on(device, dtype, first, mids, last))


def qtt_polynomial(K: int, coeffs, dtype=torch.float64, device=None) -> PackedTT:
    """Exact rank-(q+1) QTT of the degree-q polynomial
    ``f_i = sum_q coeffs[q] * (i / 2^K)^q``.

    The bond carries the monomial vector ``[1, X, ..., X^q]`` of the
    partial bit sum; each core is the binomial upper-triangular
    transition ``(X + u)^m = sum_j C(m,j) X^j u^(m-j)`` for its bit
    value's normalized weight ``u``.
    """
    if K < 3:
        raise ValueError("packed trains need K >= 3")
    coeffs = np.asarray(coeffs, dtype=np.float64)
    Q = len(coeffs) - 1
    if Q < 0:
        raise ValueError("need at least one coefficient")
    r = Q + 1
    comb = np.zeros((r, r))
    for m in range(r):
        for j in range(m + 1):
            comb[m, j] = float(_comb(m, j))

    def trans(k):
        # G[j, v, m] = C(m, j) * u^(m-j),  u = v * 2^k / 2^K
        out = np.zeros((r, 2, r))
        for v in (0, 1):
            u = v * 2.0**k / 2.0**K
            for m in range(r):
                for j in range(m + 1):
                    out[j, v, m] = comb[m, j] * u ** (m - j)
        return out

    first = np.zeros((2, r))
    for v in (0, 1):
        u = v / 2.0**K
        first[v] = [u**m for m in range(r)]
    mids = np.stack([trans(k) for k in range(1, K - 1)])
    last = np.zeros((r, 2))
    for v in (0, 1):
        u = v * 2.0 ** (K - 1) / 2.0**K
        for j in range(r):
            last[j, v] = sum(
                coeffs[m] * comb[m, j] * u ** (m - j)
                for m in range(j, r)
            )
    return PackedTT(*_on(device, dtype, first, mids, last))


def qtt_exponential_2d(
    K: int, cx: float = 3.0, cy: float = 2.0, dtype=torch.float64, device=None
) -> PackedTT:
    """Exact rank-1 QTT of ``exp(-cx x / 2^K) exp(-cy y / 2^K)`` over
    2K interleaved bits (x at even positions)."""
    return qtt_exponential_nd(K, (cx, cy), dtype, device)


def qtt_exponential_nd(K: int, cs, dtype=torch.float64, device=None) -> PackedTT:
    """Exact rank-1 QTT of ``prod_a exp(-cs[a] x_a / 2^K)`` over
    ``len(cs) * K`` interleaved bits (axis ``a`` at positions with
    ``pos % naxes == a``) -- the separable rhs matching the bit layout
    of :func:`qtt_screened_laplacian_nd`."""
    naxes = len(cs)
    ws = [
        float(np.exp(-cs[p % naxes] * (2.0 ** (p // naxes)) / 2.0**K))
        for p in range(naxes * K)
    ]
    return qtt_rank1_from_weights(ws, dtype, device)
