"""The CPU readings behind the bars of ``chip_smoke.py``'s phase 8.

    python3 solver_witness.py port   # the PyTorch port, on the CPU
    python3 solver_witness.py jax    # the JAX package's host loop, on the CPU

Each mode imports only its own package.  It prints, one line each:

- 8c (K=14, rank 64, f32, x0 = pad_rank(qtt_exponential(14, c=3), 64),
  48 Lanczos steps a local, every sweep run): the start's Rayleigh
  quotient and, after 5, 8 and 16 sweeps of ``als_eigsh``, lam against
  the exact delta + 2 - 2 cos(pi / (2^14 + 1)); the returned vector's
  own quotient, recomputed in f64, after 8 and 16; the port also prints
  its ALS residual after 8 sweeps of 48 CG steps.
- 8d (port only): ``als_eigsh_k`` k=3 on K=14 delta 0.3 rank 8 in f64,
  the relative eigenvalue errors and the pairwise overlaps.
- 8e: ``als_solve_adaptive`` at 3 and 5 bits per axis, rank 2 to 16,
  eps 1e-10, 2 sweeps a rank, enrichment on and off, in f64: the
  relative residual, the sweeps and the rank.

The port takes minutes, the JAX package's host loop about a quarter of
an hour (its 8c locals are compiled calls of one core each).
"""

from __future__ import annotations

import math
import os
import sys
import time

K, RANK, ITERS = 14, 64, 48
EXACT = 1.0 + 2 - 2 * math.cos(math.pi / (2**K + 1))


def _port():
    import torch

    import tensor_networks_tpu_torch as tnt
    from tensor_networks_tpu_torch import packed as pk

    cpu, f32 = "cpu", torch.float32
    op64 = tnt.qtt_screened_laplacian(K, delta=1.0, device=cpu)

    def rayleigh(x):
        x = pk.PackedTT(*(t.double() for t in x))
        return float(pk.inner(x, pk.ttop_apply_packed(op64, x)) / pk.inner(x, x))

    op = tnt.qtt_screened_laplacian(K, delta=1.0, dtype=f32, device=cpu)
    x0 = pk.pad_rank(tnt.qtt_exponential(K, c=3.0, dtype=f32, device=cpu), RANK)
    print(f"8c start: Rayleigh quotient - exact {rayleigh(x0) - EXACT:.4e}")
    for sweeps in (8, 16):
        t0 = time.perf_counter()
        x, lam, hist = tnt.als_eigsh(op, x0, sweeps=sweeps, tol=-1.0, lanczos_iters=ITERS)
        at = {s: f"{hist[2 * s - 1] - EXACT:.4e}" for s in (5, 8, 16) if 2 * s <= len(hist)}
        print(f"8c eigsh, {sweeps} sweeps: lam - exact by sweep {at}; returned vector's "
              f"Rayleigh quotient - exact {rayleigh(x) - EXACT:.4e} "
              f"({time.perf_counter() - t0:.1f} s)")
    x, res, _ = tnt.als_solve(op, x0, x0, sweeps=8, tol=-1.0, spd=True, cg_iters=ITERS)
    print(f"8c ALS, 8 sweeps: relative residual {res / float(pk.norm_exact(x0)):.4e}")

    opd = tnt.qtt_screened_laplacian(K, delta=0.3, device=cpu)
    vecs, vals = tnt.als_eigsh_k(opd, pk.pad_rank(tnt.qtt_exponential(K, c=2.0, device=cpu), 8), 3)
    exact = [0.3 + 2 - 2 * math.cos(j * math.pi / (2**K + 1)) for j in (1, 2, 3)]
    print("8d relative eigenvalue errors",
          [f"{abs(v - e) / e:.2e}" for v, e in zip(vals, exact)], "overlaps",
          [f"{abs(float(pk.inner(vecs[i], vecs[j]))):.2e}" for i, j in ((0, 1), (0, 2), (1, 2))])
    _adaptive(tnt.qtt_screened_laplacian_nd, tnt.qtt_exponential_nd, tnt.als_solve_adaptive,
              pk, dict(device=cpu))


def _jax():
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from tensor_networks_tpu.ops import packed as pk
    from tensor_networks_tpu.ops.als import als_solve_adaptive
    from tensor_networks_tpu.ops.eigen import als_eigsh
    from tensor_networks_tpu.ops.qtt import (
        qtt_exponential,
        qtt_exponential_nd,
        qtt_screened_laplacian,
        qtt_screened_laplacian_nd,
    )

    op64 = qtt_screened_laplacian(K, delta=1.0)

    def rayleigh(x):
        x = type(x)(*(t.astype(jnp.float64) for t in x))
        return float(pk.inner(x, pk.ttop_apply_packed(op64, x)) / pk.inner(x, x))

    op = type(op64)(*(t.astype(jnp.float32) for t in op64))
    x0 = pk.pad_rank(qtt_exponential(K, c=3.0), RANK)
    x0 = type(x0)(*(t.astype(jnp.float32) for t in x0))
    print(f"8c start: Rayleigh quotient - exact {rayleigh(x0) - EXACT:.4e}")
    for sweeps in (8, 16):
        t0 = time.perf_counter()
        x, lam, hist = als_eigsh(op, x0, sweeps=sweeps, tol=-1.0, lanczos_iters=ITERS,
                                 fused=False)
        at = {s: f"{hist[2 * s - 1] - EXACT:.4e}" for s in (5, 8, 16) if 2 * s <= len(hist)}
        print(f"8c eigsh host loop, {sweeps} sweeps: lam - exact by sweep {at}; returned "
              f"vector's Rayleigh quotient - exact {rayleigh(x) - EXACT:.4e} "
              f"({time.perf_counter() - t0:.1f} s)")
    _adaptive(qtt_screened_laplacian_nd, qtt_exponential_nd, als_solve_adaptive, pk,
              {}, fused=False)


def _adaptive(laplacian_nd, exponential_nd, solve, pk, where, **kw):
    for bits in (3, 5):
        op = laplacian_nd(bits, 3, delta=1.0, **where)
        rhs = exponential_nd(bits, (2.0, 3.0, 1.5), **where)
        norm = float(pk.norm_exact(rhs))
        for enrich in (True, False):
            x, res, hist = solve(op, rhs, eps=1e-10, rank=2, max_rank=16, sweeps_per_rank=2,
                                 enrich=enrich, **kw)
            print(f"8e {bits} bits, {'enriched' if enrich else 'padded'}: relative residual "
                  f"{res / norm:.6e}, {len(hist)} sweeps, rank {x.rank}")


if __name__ == "__main__":
    if sys.argv[1:] not in (["port"], ["jax"]):
        sys.exit(__doc__)
    (_port if sys.argv[1] == "port" else _jax)()
