"""The heat equation on a 2^22-point grid, integrated in QTT form on the
card.

The port of ``examples/qtt_heat.py``.  ``du/dt = -A u`` with ``A`` the
4-million-point discrete Laplacian (an exact rank-3 QTT) and exponential
initial data (exact rank 1), stepped by Crank-Nicolson
(``ops/evolve.py``): each step is one warm-started ALS solve at rank 8.

No dense oracle exists at this size, so the run checks itself twice:
every step's ALS residual is small, and a Richardson study -- the
distance between the trajectories at dt and dt/2 must shrink about four
times a halving (Crank-Nicolson is second order) -- checks the
integrator, not only the solver.  Float64.

    python3 examples_torch/qtt_heat.py [--device cpu]
"""

from __future__ import annotations

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import sys

from examples_torch._common import clock, device_of, parser
from tensor_networks_tpu_torch.ops import packed as pk
from tensor_networks_tpu_torch.ops.evolve import evolve_theta
from tensor_networks_tpu_torch.ops.qtt import qtt_exponential, qtt_tridiagonal


def main(K: int = 22, step_counts=(8, 16, 32), T: float = 4.0, device=None) -> dict:
    dev = device_of(device)
    A = qtt_tridiagonal(K, 2.0, -1.0, -1.0, device=dev)  # unit-h discrete Laplacian
    u0 = pk.pad_rank(qtt_exponential(K, c=3.0, device=dev), 8)
    out = {"walls_s": {}, "max_resid": {}}

    finals = {}
    for steps in step_counts:
        t0 = clock(dev)
        u, res = evolve_theta(A, u0, T / steps, steps, theta=0.5, spd=True)
        wall = clock(dev) - t0
        finals[steps] = u
        out["walls_s"][steps], out["max_resid"][steps] = wall, max(res)
        print(f"[qtt-heat] N=2^{K}, {steps:3d} CN steps in {wall:5.1f}s: "
              f"max ALS resid {max(res):.1e}", file=sys.stderr)
        assert max(res) < 1e-8

    def dist(a, b):
        return float(pk.norm_exact(pk.add(a, pk.scale(b, -1.0))))

    s0, s1, s2 = step_counts
    d1 = dist(finals[s0], finals[s1])
    d2 = dist(finals[s1], finals[s2])
    ratio = d1 / d2
    print(f"[qtt-heat] Richardson: |u_{s0} - u_{s1}| = {d1:.3e}, |u_{s1} - u_{s2}| = "
          f"{d2:.3e}, ratio {ratio:.2f} (Crank-Nicolson => ~4)", file=sys.stderr)
    assert 3.0 < ratio < 5.0, ratio
    print(f"[qtt-heat] OK ratio={ratio:.2f} d2={d2:.2e}")
    out.update(ratio=ratio, d1=d1, d2=d2)
    return out


if __name__ == "__main__":
    main(device=parser(__doc__).parse_args().device)
