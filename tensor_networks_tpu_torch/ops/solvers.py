"""TT-GMRES: Krylov solve in tensor-train arithmetic.

Counterpart of ``tensor_networks_tpu/ops/solvers.py``.  Standard GMRES
with Givens-rotation residual tracking: the Hessenberg column is
rotated into upper-triangular form as it is produced, so the residual
norm is available every iteration without a least-squares solve, and
the final coefficients come from one back-substitution.  Every TT
operation (operator apply, basis combination) is followed by a rounding
step (:func:`tt_svd_round`) to keep bond ranks bounded -- the host
drives the loop; the TT arithmetic underneath runs on the networks'
device.

The packed variant with fixed-rank rounding is
:func:`tensor_networks_tpu_torch.ops.packed.gmres_packed`.

Capability parity: ``pytens/algs.py`` gmres (:2700-2793), tested to
residual < 1e-5 (``tests/main_test.py:446``).
"""

from __future__ import annotations

import copy
from typing import Callable, List, Tuple

import numpy as np

from tensor_networks_tpu_torch.network import TensorNetwork
from tensor_networks_tpu_torch.ops.rounding import tt_svd_round


def _back_substitute(
    columns: List[List[float]], rhs: List[float]
) -> np.ndarray:
    """Solve the upper-triangular system accumulated by the rotations;
    ``columns[j]`` holds R[0..j, j]."""
    m = len(columns)
    y = np.zeros(m)
    for j in range(m - 1, -1, -1):
        acc = rhs[j] - sum(columns[k][j] * y[k] for k in range(j + 1, m))
        y[j] = acc / columns[j][j]
    return y


def gmres(
    op: Callable[[TensorNetwork], TensorNetwork],
    rhs: TensorNetwork,
    x0: TensorNetwork,
    eps: float = 1e-5,
    round_eps: float = 1e-10,
    maxiter: int = 100,
) -> Tuple[TensorNetwork, float]:
    """Solve ``op(x) = rhs`` for a TT ``x`` starting from ``x0``.

    Returns ``(solution, final residual norm)``.  ``round_eps`` bounds
    the rank growth of every Krylov vector.
    """
    residual = tt_svd_round(rhs + op(x0).scale(-1.0), round_eps)
    beta = residual.norm()
    basis = [residual.scale(1.0 / beta)]

    giv_c: List[float] = []
    giv_s: List[float] = []
    r_columns: List[List[float]] = []
    g = [float(beta)]  # rotated right-hand side; g[-1] tracks ||residual||

    for j in range(maxiter):
        w = tt_svd_round(op(basis[-1]), round_eps)

        # modified Gram-Schmidt in TT arithmetic
        column = []
        for vec in basis:
            proj = float(w.inner(vec))
            column.append(proj)
            w = w + copy.deepcopy(vec).scale(-proj)
        w = tt_svd_round(w, round_eps)
        below = float(w.norm())

        # rotate the fresh column through the accumulated Givens pairs
        for i, (c, s) in enumerate(zip(giv_c, giv_s)):
            column[i], column[i + 1] = (
                c * column[i] + s * column[i + 1],
                -s * column[i] + c * column[i + 1],
            )
        # new rotation annihilating the subdiagonal entry
        denom = float(np.hypot(column[j], below))
        if denom == 0.0:
            break
        c, s = column[j] / denom, below / denom
        giv_c.append(c)
        giv_s.append(s)
        column[j] = denom
        r_columns.append(column)
        g.append(-s * g[j])
        g[j] = c * g[j]

        happy = below <= 1e-14 * abs(denom)  # exact breakdown
        if abs(g[j + 1]) < eps or happy:
            break
        basis.append(w.scale(1.0 / below))

    y = _back_substitute(r_columns, g)
    x = copy.deepcopy(x0)
    for vec, coeff in zip(basis, y):
        x = x + copy.deepcopy(vec).scale(float(coeff))
    x = tt_svd_round(x, round_eps)
    # round the residual before measuring: the raw difference train's
    # zipper norm loses half the mantissa to cancellation (the rounding
    # sweep re-orthogonalizes, so the norm is backward stable)
    final = tt_svd_round(rhs + op(x).scale(-1.0), round_eps)
    return x, final.norm()
