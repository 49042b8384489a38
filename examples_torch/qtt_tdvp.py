"""Solve-free time integration on the card: projector-splitting TDVP on a
QTT grid.

The port of ``examples/qtt_tdvp.py``.  The heat equation ``du/dt = -A
u`` on a 2^K-point grid, ``A`` the exact QTT of the 1D stiffness
tridiagonal and a rank-1 exponential start.  Two-site TDVP
(``evolve_tdvp2``) evolves each pair exactly under its projected
operator -- no linear solves -- and grows the bond ranks up to a static
``max_rank``; the energy ``<u, A u>`` is recorded inside the fused
trajectory.

The oracle is spectral and exact at any grid size: the Dirichlet
Laplacian diagonalizes in the type-I sine basis, so ``u(T) =
DST^-1[exp(-T lam) DST[u0]]``.  Float64.  ``TNT_TDVP_K`` sets K
(default 12).

    python3 examples_torch/qtt_tdvp.py [--device cpu]
"""

from __future__ import annotations

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import os
import time

import numpy as np
from scipy.fft import dst, idst

from examples_torch._common import clock, dense_vector, device_of, parser
from tensor_networks_tpu_torch.ops.evolve import evolve_tdvp2
from tensor_networks_tpu_torch.ops.qtt import qtt_exponential, qtt_tridiagonal


def _lin_perm(K):
    """QTT (bit-major) position -> linear grid index."""
    n = 2**K
    lin = np.zeros(n, dtype=int)
    for pos in range(n):
        rem, bits = pos, []
        for _ in range(K):
            bits.append(rem % 2)
            rem //= 2
        bits = bits[::-1]
        lin[pos] = sum(b << k for k, b in enumerate(bits))
    return lin


def spectral_solution(K: int, u0, T: float) -> np.ndarray:
    """``u(T)`` of the discrete heat flow from the train ``u0``, on the
    linear grid, by the type-I sine transform."""
    n = 2**K
    ud0 = np.zeros(n)
    ud0[_lin_perm(K)] = dense_vector(u0)
    lam = 2.0 - 2.0 * np.cos(np.arange(1, n + 1) * np.pi / (n + 1))
    return idst(np.exp(-T * lam) * dst(ud0, type=1), type=1)


def main(K: int = None, T: float = 0.5, steps: int = 25, max_rank: int = 16,
         device=None) -> dict:
    dev = device_of(device)
    if K is None:
        K = int(os.environ.get("TNT_TDVP_K", "12"))
    n = 2**K
    dt = T / steps

    A = qtt_tridiagonal(K, 2.0, -1.0, -1.0, device=dev)
    u0 = qtt_exponential(K, c=4.0, device=dev)
    print(f"heat equation on 2^{K} = {n} points, rank-1 start, "
          f"dt={dt}, {steps} steps, max_rank={max_rank}")

    t0 = clock(dev)
    # the energy <u, A u> is recorded inside the fused trajectory
    u, norms, ranks, obs = evolve_tdvp2(
        A, u0, dt, steps, max_rank=max_rank, eps=1e-10, dense_limit=256,
        observables=(A,),
    )
    wall = clock(dev) - t0
    energies = [e[0] for e in obs]
    assert all(b < a for a, b in zip(energies, energies[1:])), (
        "heat-flow energy must decay monotonically"
    )

    t1 = time.perf_counter()
    ref = spectral_solution(K, u0, T)
    got = np.zeros(n)
    got[_lin_perm(K)] = dense_vector(u)
    rel = float(np.linalg.norm(got - ref) / np.linalg.norm(ref))
    oracle_s = time.perf_counter() - t1

    print(f"rank history (max effective per step): {ranks}")
    print(f"norm decay: {norms[0]:.6f} -> {norms[-1]:.6f}; "
          f"energy decay (in-program observable): "
          f"{energies[0]:.4f} -> {energies[-1]:.4f}")
    print(f"rel error vs spectral oracle: {rel:.3e}")
    print(f"wall: {wall:.1f}s ({wall / steps * 1e3:.0f} ms/step, no linear solves)")
    assert rel < 1e-6, rel
    print("OK")
    return {"K": K, "wall_s": wall, "ms_per_step": wall / steps * 1e3, "rel_err": rel,
            "energies": energies, "ranks": ranks, "oracle_s": oracle_s}


if __name__ == "__main__":
    main(device=parser(__doc__).parse_args().device)
