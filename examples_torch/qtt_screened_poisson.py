"""Screened-Poisson solves on a 2^K grid in QTT form, on the card: a
billion-unknown linear system through the packed ALS solver and TT-GMRES,
then the 2D and 3D operators.

The port of ``examples/qtt_screened_poisson.py``.  The 1D operator
``A = (2 + delta) I - S - S^T`` (S the shift by one, Dirichlet ends) is
an exact rank-3 QTT over K binary modes, a three-state carry automaton;
with ``delta > 0`` its spectrum lies in ``[delta, 4 + delta]``, so the
condition number does not grow with K and the solve is meaningful at
K = 30 (2^30 ~ 1.07e9 unknowns).  The right-hand side ``f_i = exp(-c i /
2^K)`` is an exact rank-1 QTT.  The 2D (K/2 bits an axis, a rank-6
operator) and 3D (16^3, rank 9) operators interleave the axes' bits.
All in float64.

    python3 examples_torch/qtt_screened_poisson.py [K] [chi] [--device cpu]
"""

from __future__ import annotations

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import sys

from examples_torch._common import clock, device_of, parser
from tensor_networks_tpu_torch.ops.als import als_solve, als_solve_adaptive
from tensor_networks_tpu_torch.ops.packed import gmres_packed, norm_exact, pad_rank
from tensor_networks_tpu_torch.ops.qtt import (
    qtt_exponential,
    qtt_exponential_2d,
    qtt_exponential_nd,
    qtt_screened_laplacian,
    qtt_screened_laplacian_2d,
    qtt_screened_laplacian_nd,
)


def solve_1d(K: int, chi: int, dev) -> dict:
    """The K-bit system by ALS (8 sweeps) and by TT-GMRES (Krylov rank
    chi): wall, relative residuals and both solutions."""
    op = qtt_screened_laplacian(K, delta=1.0, device=dev)
    rhs = qtt_exponential(K, c=3.0, device=dev)
    b_norm = float(norm_exact(rhs))
    out = {}

    t0 = clock(dev)
    x, resid, hist = als_solve(op, rhs, pad_rank(rhs, chi), sweeps=8, tol=1e-10)
    out["als_s"] = clock(dev) - t0
    out["als_rel"] = resid / b_norm
    out["als_sweeps"], out["x_als"] = len(hist), x
    print(f"[qtt-solve] ALS {len(hist)} sweeps in {out['als_s']:.1f}s: "
          f"rel residual {resid / b_norm:.2e} "
          f"(history {[f'{h / b_norm:.1e}' for h in hist]})", file=sys.stderr)
    assert resid / b_norm < 1e-6, "ALS did not converge"

    # the same system through the all-device Krylov solver
    t0 = clock(dev)
    xg, rg = gmres_packed(op, rhs, pad_rank(rhs, 4), eps=1e-8, rank=chi)
    out["gmres_s"] = clock(dev) - t0
    out["gmres_rel"], out["x_gmres"] = rg / b_norm, xg
    print(f"[qtt-solve] GMRES in {out['gmres_s']:.1f}s: rel residual {rg / b_norm:.2e}",
          file=sys.stderr)
    assert rg / b_norm < 1e-6, "GMRES did not converge"
    return out


def solve_2d(K2: int, chi: int, dev, sweeps: int = 8) -> dict:
    """A 2^K2 x 2^K2 grid: the rank-6 interleaved operator, solved at rank
    2 chi with dense locals up to 8192 unknowns."""
    op2 = qtt_screened_laplacian_2d(K2, delta=1.0, device=dev)
    rhs2 = qtt_exponential_2d(K2, device=dev)
    b2 = float(norm_exact(rhs2))
    t0 = clock(dev)
    x2, r2, h2 = als_solve(op2, rhs2, pad_rank(rhs2, 2 * chi), sweeps=sweeps, tol=1e-10,
                          dense_limit=8192)
    out = {"als2d_s": clock(dev) - t0, "als2d_rel": r2 / b2, "als2d_sweeps": len(h2),
           "x_2d": x2}
    print(f"[qtt-solve] 2D ({2**K2}x{2**K2}) ALS {len(h2)} sweeps in "
          f"{out['als2d_s']:.1f}s: rel residual {r2 / b2:.2e}", file=sys.stderr)
    assert r2 / b2 < 1e-6, "2D solve did not converge"
    return out


def solve_3d(K3: int, dev) -> dict:
    """A 16^3 grid (K3 = 4): the rank-9 operator, the adaptive (AMEn)
    solve from rank 8 up to 24 at eps 5e-4."""
    op3 = qtt_screened_laplacian_nd(K3, 3, delta=1.0, device=dev)
    rhs3 = qtt_exponential_nd(K3, (3.0, 2.0, 1.5), device=dev)
    b3 = float(norm_exact(rhs3))
    t0 = clock(dev)
    x3, r3, _ = als_solve_adaptive(op3, rhs3, eps=5e-4, rank=8, max_rank=24,
                                   dense_limit=8192)
    out = {"als3d_s": clock(dev) - t0, "als3d_rel": r3 / b3, "als3d_rank": x3.rank,
           "x_3d": x3}
    print(f"[qtt-solve] 3D ({2**K3}^3) adaptive ALS in {out['als3d_s']:.1f}s: "
          f"rel residual {r3 / b3:.2e} at rank {x3.rank}", file=sys.stderr)
    assert r3 / b3 < 1e-3, "3D solve did not converge"
    return out


def main(K: int = 30, chi: int = 12, device=None, K3: int = 4) -> dict:
    if K < 4:
        sys.exit("K must be >= 4 (the packed train needs middle cores and "
                 "the 2D section needs K//2 >= 2 bits per axis)")
    dev = device_of(device)
    print(f"[qtt-solve] screened Poisson, 2^{K} = {2**K:.3g} unknowns, "
          f"solution rank {chi}", file=sys.stderr)
    out = solve_1d(K, chi, dev)
    out.update(solve_2d(K // 2, chi, dev))
    out.update(solve_3d(K3, dev))
    print(f"[qtt-solve] OK als_rel={out['als_rel']:.2e} gmres_rel={out['gmres_rel']:.2e} "
          f"als2d_rel={out['als2d_rel']:.2e} als3d_rel={out['als3d_rel']:.2e}")
    return out


if __name__ == "__main__":
    p = parser(__doc__)
    p.add_argument("K", type=int, nargs="?", default=30)
    p.add_argument("chi", type=int, nargs="?", default=12)
    args = p.parse_args()
    main(args.K, args.chi, device=args.device)
