"""Ground and excited states of the screened Laplacian in QTT form, on the
card.

The port of ``examples/qtt_ground_state.py``.  The operator is the exact
interleaved-bit QTT of ``-Lap + delta`` (rank 3 in 1D, rank 9 on a
(2^K)^3 grid), and the DMRG eigensolver (``ops/eigen.py``) finds the
lowest eigenpairs by one-site Rayleigh sweeps.  The Kronecker-sum
spectrum is an analytic oracle at any size: the 1D free tridiagonal has
eigenvalues ``2 - 2 cos(k pi / (N+1))``, so the 3D ground energy is
``delta + 3 (2 - 2 cos(pi/(N+1)))`` and the first excited level is
three-fold degenerate.  Float64 throughout.

    python3 examples_torch/qtt_ground_state.py [--device cpu]
"""

from __future__ import annotations

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import sys

import numpy as np

from examples_torch._common import clock, device_of, parser
from tensor_networks_tpu_torch.ops import packed as pk
from tensor_networks_tpu_torch.ops.eigen import als_eigsh, als_eigsh_k
from tensor_networks_tpu_torch.ops.qtt import (
    qtt_exponential,
    qtt_exponential_nd,
    qtt_screened_laplacian,
    qtt_screened_laplacian_nd,
)


def ground_1d(K1: int, dev) -> dict:
    """The 1D operator at 2^K1 points: the ground energy against
    ``delta + 2 - 2 cos(pi/(N+1))``."""
    op1 = qtt_screened_laplacian(K1, delta=1.0, device=dev)
    x1 = pk.pad_rank(qtt_exponential(K1, c=3.0, device=dev), 8)
    t0 = clock(dev)
    _, lam1, _ = als_eigsh(op1, x1, sweeps=8)
    wall = clock(dev) - t0
    ref1 = 1.0 + 2 - 2 * np.cos(np.pi / (2.0**K1 + 1))
    print(f"[qtt-eigen] 1D 2^{K1}-point ground state in {wall:.1f}s: lam {lam1:.12f} "
          f"(analytic {ref1:.12f}, err {abs(lam1 - ref1):.1e})", file=sys.stderr)
    assert abs(lam1 - ref1) < 1e-9
    return {"ground1d_s": wall, "ground1d_err": abs(lam1 - ref1)}


def _grid_3d(K: int, delta: float, dev):
    N = 2**K
    op = qtt_screened_laplacian_nd(K, 3, delta=delta, device=dev)
    x0 = pk.pad_rank(qtt_exponential_nd(K, (1.0, 2.0, 3.0), device=dev), 8)
    lap1 = lambda k: 2.0 - 2.0 * np.cos(k * np.pi / (N + 1))  # noqa: E731
    return op, x0, delta + 3 * lap1(1), delta + 2 * lap1(1) + lap1(2)


def ground_3d(K: int, dev, delta: float = 1.0) -> dict:
    """The (2^K)^3 ground state against the analytic energy."""
    op, x0, ref0, _ = _grid_3d(K, delta, dev)
    t0 = clock(dev)
    _, lam, hist = als_eigsh(op, x0, sweeps=8)
    wall = clock(dev) - t0
    print(f"[qtt-eigen] 3D ({2**K}^3) ground state in {wall:.1f}s: lam {lam:.12f} "
          f"(analytic {ref0:.12f}, err {abs(lam - ref0):.1e}) after {len(hist)} "
          "half-sweeps", file=sys.stderr)
    assert abs(lam - ref0) < 1e-9, abs(lam - ref0)
    return {"ground3d_s": wall, "ground_err": abs(lam - ref0)}


def excited_3d(K: int, dev, delta: float = 1.0) -> dict:
    """The first excited level (three-fold degenerate) by deflating the
    ground state (``als_eigsh_k``, k=2)."""
    op, x0, _, ref1 = _grid_3d(K, delta, dev)
    t0 = clock(dev)
    vecs, vals = als_eigsh_k(op, x0, 2, sweeps=8)
    wall = clock(dev) - t0
    overlap = float(pk.inner(vecs[0], vecs[1]))
    print(f"[qtt-eigen] first excited in {wall:.1f}s: lam {vals[1]:.12f} "
          f"(analytic {ref1:.12f}, err {abs(vals[1] - ref1):.1e}); "
          f"<v0,v1> = {overlap:.1e}", file=sys.stderr)
    assert abs(vals[1] - ref1) < 1e-8, abs(vals[1] - ref1)
    return {"excited_s": wall, "excited_err": abs(vals[1] - ref1), "overlap": overlap}


def main(K1: int = 30, K: int = 5, device=None) -> dict:
    dev = device_of(device)
    out = ground_1d(K1, dev)
    out.update(ground_3d(K, dev))
    out.update(excited_3d(K, dev))
    print(f"[qtt-eigen] OK ground_err={out['ground_err']:.2e} "
          f"excited_err={out['excited_err']:.2e}")
    return out


if __name__ == "__main__":
    main(device=parser(__doc__).parse_args().device)
