"""The CPU readings behind the bars of ``chip_smoke.py``'s phases 8, 9 and 10b.

    python3 solver_witness.py port [solvers|evolve|fit]   # the PyTorch port, on the CPU
    python3 solver_witness.py jax [solvers|evolve]        # the JAX package, on the CPU

Each mode imports only its own package and prints phase 8's readings
(``solvers``), phase 9's (``evolve``) or both, one line each; ``port
fit`` prints phase 10b's (the port only, ~3 min).  Phase 8:

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

Phase 9 (the JAX package on its host loop where a leg compares the
two forms, as ``bench.py`` calls it for 9a):

- 9a (``bench.py``'s ``_leg_solver_cpu``): ``evolve_tdvp2`` on
  ``qtt_tridiagonal(12, 2, -1, -1)`` from ``qtt_exponential(12, c=3)``,
  f64, 10 steps to T=0.2, ``max_rank=12``, ``eps=1e-8``: the relative
  error against the spectral solution ``V exp(-Lambda T) V w0`` and the
  largest effective rank;
- 9b (``tools/tdvp_fused_probe.py``'s one-site step): K=22,
  ``pad_rank(qtt_exponential(22, 3), 8)``, f32, dt 1e-4, 3 steps fused
  and on the host loop: the largest relative difference of the norms;
- 9c (its two-site step at K=16, rank 8, eps 1e-6): the same, and the
  effective ranks of both forms;
- 9d: ``evolve_theta`` (theta 0.5) at K=12 from
  ``pad_rank(qtt_exponential(12, 3), 8)``, f64, dt 0.02, 10 steps, spd,
  observing ``A``: the final state's and the energies' relative errors
  against the discrete Crank-Nicolson solution in the eigenbasis;
- 9e (``tests/test_evolve.py:272``'s shape, K=6, r=2, f64):
  ``tdvp_trajectory``'s gradients of the final energy against central
  differences.

Phase 10b: ``fit_network_als`` on :func:`completion_problem` (20
sweeps, tol 1e-10, f64): the error of every sweep and the completion
error on the held-out points; then the same on an exact rank-4 random
target, which stalls likewise.

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


# -- phase 9 ---------------------------------------------------------------------


def heat_spectrum(K):
    """The tridiag(-1, 2, -1) matrix of 2^K points in its eigenbasis:
    ``(V, lams, w0)``, ``V`` the symmetric orthogonal sine transform and
    ``w0 = exp(-3 i / 2^K)`` (``bench.py``'s own formula)."""
    import numpy as np

    n = 2**K
    ii = np.arange(1, n + 1)
    V = np.sqrt(2.0 / (n + 1)) * np.sin(np.outer(ii, ii) * np.pi / (n + 1))
    return V, 2 - 2 * np.cos(ii * np.pi / (n + 1)), np.exp(-3.0 * np.arange(n) / n)


def grid_vector(first, mids, last):
    """A packed QTT train's values on the grid (core 0 the least
    significant bit), from NumPy cores."""
    import numpy as np

    v = first
    for m in mids:
        v = np.einsum("ar,rnb->anb", v, m).reshape(-1, m.shape[-1])
    v = (v @ last).reshape((2,) * (len(mids) + 2))
    return v.transpose(*reversed(range(v.ndim))).reshape(-1)


def cn_reference(K, dt, steps):
    """The discrete Crank-Nicolson trajectory of w0 in the eigenbasis:
    the final state and the energies <w_n, A w_n>, n = 1..steps."""
    V, lams, w0 = heat_spectrum(K)
    g = (1 - 0.5 * dt * lams) / (1 + 0.5 * dt * lams)
    c = V @ w0
    return V @ (g**steps * c), [float((lams * (g**n * c) ** 2).sum()) for n in range(1, steps + 1)]


def _evolve_readings(run, arrays):
    """Phase 9's readings; ``run(leg, **kw)`` calls one package's
    integrator, ``arrays`` turns its train into NumPy cores."""
    import numpy as np

    def rel(a, b):
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    V, lams, w0 = heat_spectrum(12)
    t0 = time.perf_counter()
    u, ranks = run("9a")
    ref = V @ (np.exp(-lams * 0.2) * (V @ w0))
    print(f"9a evolve_tdvp2 K=12 f64: relative error {rel(grid_vector(*arrays(u)), ref):.4e}, "
          f"max effective rank {max(ranks)} ({time.perf_counter() - t0:.1f} s)")
    for leg in ("9b", "9c"):
        t0 = time.perf_counter()
        (nf, rf), (nh, rh) = run(leg, fused=True), run(leg, fused=False)
        diff = max(abs(a - b) / abs(b) for a, b in zip(nf, nh))
        print(f"{leg} fused against host loop, f32, 3 steps: norms {nf}, largest relative "
              f"difference {diff:.4e}" + (f", ranks {rf} / {rh}" if rf else "")
              + f" ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    u, energies = run("9d")
    x_ref, e_ref = cn_reference(12, 0.02, 10)
    print(f"9d evolve_theta CN K=12 f64: final state relative error "
          f"{rel(grid_vector(*arrays(u)), x_ref):.4e}, energies largest relative error "
          f"{max(abs(a - b) / abs(b) for a, b in zip(energies, e_ref)):.4e} "
          f"({time.perf_counter() - t0:.1f} s)")
    grads, fds = run("9e")
    print("9e tdvp_trajectory gradient against central differences: relative errors "
          + ", ".join(f"{abs(g - f) / abs(f):.4e}" for g, f in zip(grads, fds)))


def _evolve_port():
    import numpy as np
    import torch

    import tensor_networks_tpu_torch as tnt
    from tensor_networks_tpu_torch import packed as pk

    cpu, f32 = "cpu", torch.float32

    def heat(K, dtype=torch.float64):
        return tnt.qtt_tridiagonal(K, 2.0, -1.0, -1.0, dtype=dtype, device=cpu)

    def start(K, dtype=torch.float64, rank=8):
        return pk.pad_rank(tnt.qtt_exponential(K, c=3.0, dtype=dtype, device=cpu), rank)

    def run(leg, fused=None):
        if leg == "9a":
            u, _, ranks = tnt.evolve_tdvp2(heat(12), start(12, rank=1), 0.02, 10, max_rank=12,
                                           eps=1e-8)
            return u, ranks
        if leg == "9b":
            _, norms = tnt.evolve_tdvp(heat(22, f32), start(22, f32), 1e-4, 3, fused=fused)
            return norms, None
        if leg == "9c":
            _, norms, ranks = tnt.evolve_tdvp2(heat(16, f32), start(16, f32), 1e-4, 3,
                                               max_rank=8, eps=1e-6, dense_limit=1024,
                                               fused=fused)
            return norms, ranks
        if leg == "9d":
            A = heat(12)
            u, _, obs = tnt.evolve_theta(A, start(12), 0.02, 10, theta=0.5, spd=True,
                                         observables=(A,))
            return u, [o[0] for o in obs]
        return _gradients_port(tnt, pk, torch, np)

    _evolve_readings(run, lambda u: [t.numpy() for t in u])


def _gradients_port(tnt, pk, torch, np):
    """9e: autograd of the final energy w.r.t. an operator coefficient
    and dt, and central differences (step 1e-6)."""
    K, r = 6, 2
    A = tnt.qtt_tridiagonal(K, 2.0, -1.0, -1.0, device="cpu")
    rng = np.random.default_rng(0)
    u0 = pk.from_numpy(rng.standard_normal((2, r)), rng.standard_normal((K - 2, r, 2, r)) / np.sqrt(r),
                       rng.standard_normal((r, 2)), device="cpu")

    def loss(c, dt):
        Ac = pk.PackedTTOp(A.first * c, A.mids, A.last)
        return tnt.tdvp_trajectory(Ac, u0, dt, 3, observables=(A,))[2][-1, 0]

    c, dt = (torch.tensor(v, dtype=torch.float64, requires_grad=True) for v in (1.0, 0.05))
    grads = [float(g) for g in torch.autograd.grad(loss(c, dt), (c, dt))]
    with torch.no_grad():
        fds = [float(loss(1.0 + 1e-6, 0.05) - loss(1.0 - 1e-6, 0.05)) / 2e-6,
               float(loss(1.0, 0.05 + 1e-6) - loss(1.0, 0.05 - 1e-6)) / 2e-6]
    return grads, fds


def _evolve_jax():
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import numpy as np

    from tensor_networks_tpu.ops import packed as pk
    from tensor_networks_tpu.ops.evolve import (
        evolve_tdvp,
        evolve_tdvp2,
        evolve_theta,
        tdvp_trajectory,
    )
    from tensor_networks_tpu.ops.qtt import qtt_exponential, qtt_tridiagonal

    def cast(t, dtype):
        return type(t)(*(x.astype(dtype) for x in t))

    def start(K, dtype=jnp.float64, rank=8):
        return cast(pk.pad_rank(qtt_exponential(K, c=3.0), rank), dtype)

    def run(leg, fused=None):
        if leg == "9a":
            u, _, ranks = evolve_tdvp2(qtt_tridiagonal(12, 2.0, -1.0, -1.0), start(12, rank=1),
                                       0.02, 10, max_rank=12, eps=1e-8)
            return u, ranks
        f32 = jnp.float32
        if leg == "9b":
            _, norms = evolve_tdvp(cast(qtt_tridiagonal(22, 2.0, -1.0, -1.0), f32),
                                   start(22, f32), 1e-4, 3, fused=fused)
            return norms, None
        if leg == "9c":
            _, norms, ranks = evolve_tdvp2(cast(qtt_tridiagonal(16, 2.0, -1.0, -1.0), f32),
                                           start(16, f32), 1e-4, 3, max_rank=8, eps=1e-6,
                                           dense_limit=1024, fused=fused)
            return norms, ranks
        if leg == "9d":
            A = qtt_tridiagonal(12, 2.0, -1.0, -1.0)
            u, _, obs = evolve_theta(A, start(12), 0.02, 10, theta=0.5, spd=True,
                                     observables=(A,), fused=False)
            return u, [o[0] for o in obs]
        K, r = 6, 2
        A = qtt_tridiagonal(K, 2.0, -1.0, -1.0)
        rng = np.random.default_rng(0)
        u0 = pk.PackedTT(jnp.asarray(rng.standard_normal((2, r))),
                         jnp.asarray(rng.standard_normal((K - 2, r, 2, r)) / np.sqrt(r)),
                         jnp.asarray(rng.standard_normal((r, 2))))

        def loss(c, dt):
            Ac = pk.PackedTTOp(A.first * c, A.mids, A.last)
            return tdvp_trajectory(Ac, u0, dt, 3, observables=(A,))[2][-1, 0]

        grads = [float(g) for g in jax.grad(loss, argnums=(0, 1))(1.0, 0.05)]
        fds = [float(loss(1.0 + 1e-6, 0.05) - loss(1.0 - 1e-6, 0.05)) / 2e-6,
               float(loss(1.0, 0.05 + 1e-6) - loss(1.0, 0.05 - 1e-6)) / 2e-6]
        return grads, fds

    _evolve_readings(run, lambda u: [np.asarray(t, dtype=np.float64) for t in u])


# -- phase 10 --------------------------------------------------------------------


#: phase 10b: d, n, model rank, observed and held-out points, sweeps, tol
FIT_D, FIT_N, FIT_RANK, FIT_OBS, FIT_HOLD, FIT_SWEEPS, FIT_TOL = (
    10, 32, 4, 2**20, 2**16, 20, 1e-10)


def completion_problem(tnt, device, exact_rank=False, seed=1234):
    """Phase 10b's completion problem on ``device``, all from NumPy seeds
    in float64: ``tests/test_fit.py::test_als_completes_sparse_smooth_train``'s
    additive target sum_i sin((i + 1) x_i) on a grid of 32 in [-1, 1] at
    d=10 (``exact_rank``: a random rank-4 train instead, cores after the
    first scaled by 1/2 so entries are O(1)); a rank-4 model from a
    second generator, scaled alike; 2^20 observed and 2^16 held-out
    points with the target's values.  Returns ``(indices, model, idx, y,
    hold, y_hold)``."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    inds = [tnt.Index(f"c{k}", FIT_N) for k in range(FIT_D)]

    def random_train(gen):
        t = tnt.TensorNetwork.rand_tt(inds, [FIT_RANK] * (FIT_D - 1), device=device)
        for k in range(FIT_D):
            v = gen.standard_normal(tuple(t.value(k).shape)) / (np.sqrt(FIT_RANK) if k else 1.0)
            t.node_tensor(k).update_val_size(torch.from_numpy(v).to(device))
        return t

    if exact_rank:
        target = random_train(rng)
    else:
        grid = np.linspace(-1.0, 1.0, FIT_N)
        target = tnt.tt_separable(inds, [np.sin((i + 1) * grid) for i in range(FIT_D)],
                                  device=device)
    model = random_train(np.random.default_rng(seed + 1))
    idx = rng.integers(0, FIT_N, (FIT_OBS, FIT_D))
    hold = rng.integers(0, FIT_N, (FIT_HOLD, FIT_D))
    return inds, model, idx, target.evaluate(inds, idx), hold, target.evaluate(inds, hold)


def _fit_port():
    import torch

    import tensor_networks_tpu_torch as tnt
    from tensor_networks_tpu_torch.fit import completion_error, fit_network_als

    torch.set_num_threads(4)
    for exact_rank in (False, True):
        inds, model, idx, y, hold, y_hold = completion_problem(tnt, "cpu", exact_rank)
        t0 = time.perf_counter()
        errs = fit_network_als(model, inds, idx, y, sweeps=FIT_SWEEPS, tol=FIT_TOL)
        print(f"10b {'exact rank-4' if exact_rank else 'additive'} target: errors by sweep "
              f"{[float(f'{e:.10e}') for e in errs]}; completion error "
              f"{completion_error(model, inds, hold, y_hold):.10e} "
              f"({time.perf_counter() - t0:.1f} s)")


if __name__ == "__main__":
    if sys.argv[1:2] not in (["port"], ["jax"]) or sys.argv[2:] not in (
            [], ["solvers"], ["evolve"], ["fit"]) or sys.argv[1:] == ["jax", "fit"]:
        sys.exit(__doc__)
    port = sys.argv[1] == "port"
    if sys.argv[2:] == ["fit"]:
        _fit_port()
    else:
        if sys.argv[2:] != ["evolve"]:
            (_port if port else _jax)()
        if sys.argv[2:] != ["solvers"]:
            (_evolve_port if port else _evolve_jax)()
