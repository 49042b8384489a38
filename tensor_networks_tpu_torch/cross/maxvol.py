"""Maxvol pivot selection: dominant-submatrix row search.

Given a tall matrix A (n x r), find r rows I such that the submatrix A[I]
is (quasi-)dominant, and return the interpolation coefficients
B = A @ A[I]^{-1} (so A == B @ A[I] up to the maxvol tolerance).

Two implementations with the same semantics:

* :func:`maxvol` -- host NumPy; LU-pivot initialization plus rank-1 swap
  updates.  Copied from ``tensor_networks_tpu/cross/maxvol.py``, with
  its tie window (:func:`_q`), so seeded runs of either package make
  the same host decisions.
* :func:`maxvol_device` -- torch ops on the tensor's own device (the
  card for a CUDA tensor): partial-pivoting LU rows, then argmax and
  rank-1 updates, with the stop test read every ``_CHECK_EVERY``
  iterations.

:func:`maxvol_auto` picks between them by size and by the device of the
caller's network.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

#: entries; from this size up, fibers of a network on the card go to
#: :func:`maxvol_device`.  Set from ``chip_smoke.py`` phase 5's timings
#: of :func:`maxvol_auto` on an H100, host copies included (PERF.md
#: section 6): on the cross's fiber family (32 r, r), the host branch
#: wins up to (1152, 36) = 41,472 entries and the card branch from
#: (1280, 40) = 51,200 up.
_DEVICE_SIZE_THRESHOLD = 48 * 1024

#: iterations between two reads of the device loop's stop flag; the
#: iterations after the stop are masked no-ops
_CHECK_EVERY = 8


def _q(mag: np.ndarray) -> np.ndarray:
    """Decision-hardened magnitudes: values within 1e-6 relative of
    each other TIE (argmax then picks the first index).

    Pivot selection is a chain of argmax decisions; a near-tie flipped
    by evaluation noise far below 1e-6 sends the whole cross down a
    different pivot trajectory.  The rank-1 update chain amplifies input
    noise, so the tie window sits far above it.  That granularity is
    quality-neutral -- maxvol runs at tol 1.05, and candidates within
    1e-6 of each other are volume-equivalent; only the DECISION is
    quantized, never the arithmetic.
    """
    m = np.max(mag) if mag.size else 0.0
    if m <= 0:
        return mag
    return np.round(mag * (1e6 / m))


def _lu_row_pivots(a: np.ndarray) -> np.ndarray:
    """Rows chosen by partially-pivoted Gaussian elimination: a cheap,
    well-conditioned starting set for the maxvol iteration."""
    a = np.array(a, dtype=np.float64)
    n, r = a.shape
    piv = np.arange(n)
    for k in range(r):
        i = k + int(np.argmax(_q(np.abs(a[k:, k]))))
        if i != k:
            a[[k, i]] = a[[i, k]]
            piv[[k, i]] = piv[[i, k]]
        if a[k, k] != 0.0:
            a[k + 1 :, k] /= a[k, k]
            a[k + 1 :, k + 1 :] -= np.outer(a[k + 1 :, k], a[k, k + 1 :])
    return piv[:r]


def maxvol(
    a, tol: float = 1.05, max_iters: int = 200
) -> Tuple[np.ndarray, np.ndarray]:
    """Host maxvol.  Returns (row indices I, coefficients B = A A[I]^-1)."""
    a = np.asarray(a, dtype=np.float64)
    n, r = a.shape
    if n <= r:
        return np.arange(n), np.eye(n)

    rows = _lu_row_pivots(a)
    b = np.linalg.solve(a[rows].T, a.T).T  # A @ inv(A[rows])
    for _ in range(max_iters):
        flat = int(np.argmax(_q(np.abs(b))))
        i, j = divmod(flat, r)
        if abs(b[i, j]) <= tol:
            break
        # replace pivot row j by row i; rank-1 update of B
        bj = b[:, j].copy()
        bi = b[i, :].copy()
        bi[j] -= 1.0
        b -= np.outer(bj, bi) / b[i, j]
        rows[j] = i
    return rows, b


def _lu_rows(a: torch.Tensor) -> torch.Tensor:
    """The r pivot rows of partially-pivoted Gaussian elimination on
    ``a`` (n x r), on ``a``'s device with no host read.

    The rows ``torch.linalg.lu_factor`` would pivot on (LAPACK's rule:
    the first row of largest magnitude), found by r elimination steps
    that leave the rows in place: a chosen row becomes zero in the
    columns after its step and is masked out of later choices.  (On the
    card, ``lu_factor`` of a tall matrix goes to MAGMA, which prints a
    warning on every call.)
    """
    n, r = a.shape
    work = a.clone()
    free = torch.ones(n, dtype=torch.bool, device=a.device)
    taken = torch.full((), -1.0, dtype=a.dtype, device=a.device)
    rows = []
    for k in range(r):
        i = torch.argmax(torch.where(free, work[:, k].abs(), taken))
        free.index_fill_(0, i.view(1), False)
        rows.append(i)
        pivot_row = work.index_select(0, i.view(1)).view(r)
        factor = work[:, k] / pivot_row[k]
        work[:, k + 1 :].addr_(factor, pivot_row[k + 1 :], alpha=-1)
    return torch.stack(rows)


def maxvol_device(
    a: torch.Tensor, tol: float = 1.05, max_iters: int = 200
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Maxvol on ``a``'s own device; returns (rows, B) as tensors there.

    The same algorithm as :func:`maxvol`, started from the rows of a
    partial-pivoting LU, as the JAX package's device maxvol is; like it,
    no tie window.  Each iteration is a few torch ops with no host read: the
    update is scaled by a stop flag on the device (0 once max|B| <= tol,
    which leaves B and the rows exactly as they are), and the host reads
    the flag every ``_CHECK_EVERY`` iterations.  So the result is the
    loop that stops at the first max|B| <= tol, or after ``max_iters``.
    """
    a = torch.as_tensor(a)
    n, r = a.shape
    if n <= r:
        return (
            torch.arange(n, device=a.device),
            torch.eye(n, dtype=a.dtype, device=a.device),
        )
    rows = _lu_rows(a)
    b = torch.linalg.solve(a[rows].T, a.T).T.contiguous()
    flat_b = b.view(-1)
    eye = torch.eye(r, dtype=a.dtype, device=a.device)
    done = 0
    while done < max_iters:
        steps = min(_CHECK_EVERY, max_iters - done)
        for _ in range(steps):
            flat = torch.argmax(flat_b.abs())
            i, j = flat // r, flat % r
            pivot = flat_b[flat]
            live = pivot.abs() > tol
            bj = b.index_select(1, j.view(1)).view(n)
            bi = b.index_select(0, i.view(1)).view(r) - eye[j]
            # a stopped loop subtracts exact zeros
            b.sub_(torch.outer(bj * (live / pivot), bi))
            rows.scatter_(0, j.view(1), torch.where(live, i, rows[j]).view(1))
        done += steps
        if not bool(live):
            break
    return rows, b


def maxvol_auto(
    a, tol: float = 1.05, max_iters: int = 200, device=None
) -> Tuple[np.ndarray, np.ndarray]:
    """Maxvol of a host matrix, on the host or on ``device``.

    ``device`` is where the caller's network lives.  Matrices of at
    least ``_DEVICE_SIZE_THRESHOLD`` entries run :func:`maxvol_device`
    there, smaller ones (and every matrix when no device is named) the
    host :func:`maxvol`.  The JAX package also kept float64 fibers on
    the host when its device had no x64 (a TPU); the H100 computes in
    float64, so that guard is gone.  Returns NumPy arrays.
    """
    a_np = np.asarray(a)
    if device is not None and a_np.size >= _DEVICE_SIZE_THRESHOLD:
        rows, b = maxvol_device(
            torch.as_tensor(a_np, device=device), tol, max_iters
        )
        return rows.cpu().numpy(), b.cpu().numpy()
    return maxvol(a_np, tol, max_iters)
