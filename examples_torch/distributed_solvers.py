"""The distributed solver family on the ranks of a process group, one card
each.

The port of ``examples/distributed_solvers.py``.  Every solver runs
train-sharded: the iterate, the operators and every environment chain
are split along the mesh's ``model`` axis (core block k on rank k), so
a rank holds about 1/P of the train, and the carries that pass between
neighbours are bond-sized.  The script walks the family on one
screened-Poisson / heat-equation setup (K binary modes, 2^K unknowns):

1. linear solve            -- ``als_solve_sharded``
2. adaptive linear solve   -- ``als_solve_adaptive_sharded`` (AMEn)
3. ground + excited states -- ``als_eigsh_k_sharded`` (k=3)
4. generalized eigenpair   -- ``als_eigsh_sharded(mass=...)`` (FEM pair)
5. time integration        -- ``evolve_theta_sharded`` (Crank-Nicolson
   with mass and source) and ``evolve_tdvp_sharded``

Every rank also runs the fused single-device solver at the same knobs,
and each result is held to it (1e-9 relative in float64) and, where one
exists, to the analytic oracle; the Crank-Nicolson steps are held to
the same steps taken densely (1e-10).  Float64.

Run on P cards with ``torchrun --standalone --nproc_per_node=P
examples_torch/distributed_solvers.py [K]``; a plain ``python3`` run is
a one-rank group, ``--device cpu`` a gloo group on the CPU.  K - 2 must
be a multiple of P.
"""

from __future__ import annotations

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import numpy as np
import torch
import torch.distributed as dist

from examples_torch._common import clock, dense_vector, device_of, join_group, parser, rank_device
import tensor_networks_tpu_torch as tnt
from tensor_networks_tpu_torch.ops import packed as pk
from tensor_networks_tpu_torch.ops.qtt import (
    qtt_exponential,
    qtt_screened_laplacian,
    qtt_tridiagonal,
)
from tensor_networks_tpu_torch.parallel import (
    als_eigsh_k_sharded,
    als_eigsh_sharded,
    als_solve_adaptive_sharded,
    als_solve_sharded,
    evolve_tdvp_sharded,
    evolve_theta_sharded,
    make_mesh,
)

#: sharded against fused, relative
TOL = 1e-9
#: Crank-Nicolson against the dense steps: the fused integrator rounds
#: each right-hand side to the state's rank, the sharded one does not,
#: so that leg is held to the dense recursion instead
DENSE_TOL = 1e-10


def _whole(mesh, x: pk.PackedTT) -> pk.PackedTT:
    """The train of which this rank holds the middle block."""
    group = mesh.get_group("model")
    parts = [torch.empty_like(x.mids) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.mids.contiguous(), group=group)
    return pk.PackedTT(x.first, torch.cat(parts), x.last)


def _rel_diff(x: pk.PackedTT, y: pk.PackedTT) -> float:
    return float(pk.norm_exact(pk.add(x, pk.scale(y, -1.0))) / pk.norm_exact(y))


def dense_operator(A) -> np.ndarray:
    """The matrix an operator train represents, ordered as
    :func:`dense_vector`."""
    m = A.first.cpu().numpy()
    for core in A.mids.cpu().numpy():
        m = np.einsum("oir,rpjs->opijs", m, core)
        m = m.reshape(m.shape[0] * m.shape[1], m.shape[2] * m.shape[3], m.shape[4])
    m = np.einsum("oir,rpj->opij", m, A.last.cpu().numpy())
    return m.reshape(m.shape[0] * m.shape[1], m.shape[2] * m.shape[3])


def _rel_seq(a, b) -> float:
    a, b = np.asarray(a, dtype=float), np.asarray(b, dtype=float)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _check(failed, name, value, bar):
    if not value <= bar:
        failed.append(f"{name} {value:.3e} > {bar:.0e}")


def main(K: int = 10, device=None) -> dict:
    dev = device_of(device)
    owned = join_group(dev)
    P = dist.get_world_size()
    assert (K - 2) % P == 0, f"K - 2 middle cores must split over {P} ranks"
    mesh = make_mesh((1, P), devices=None if dev.type == "cuda" else dev.type)
    dev = rank_device(dev)
    lead = dist.get_rank() == 0
    say = print if lead else (lambda *a, **k: None)
    say(f"mesh: {mesh}  |  2^{K} = {2**K} unknowns")
    out, failed = {"P": P, "K": K, "walls_s": {}}, []

    def timed(name, call):
        t0 = clock(dev)
        res = call()
        out["walls_s"][name] = clock(dev) - t0
        return res

    op = qtt_screened_laplacian(K, delta=1.0, device=dev)
    rhs = qtt_exponential(K, c=3.0, device=dev)
    bn = float(pk.norm_exact(rhs))

    # 1. linear solve at fixed rank
    x0 = pk.pad_rank(rhs, 6)
    x, res, _ = timed("1", lambda: als_solve_sharded(mesh, op, rhs, x0, sweeps=4, spd=True))
    xf, res_f, _ = tnt.als_solve(op, rhs, x0, sweeps=4, spd=True)
    out["1"] = {"rel_res": res / bn, "vs_fused": _rel_diff(_whole(mesh, x), xf)}
    _check(failed, "[1] state vs fused", out["1"]["vs_fused"], TOL)
    say(f"[1] als_solve_sharded      rel res {res / bn:.2e}  ({out['walls_s']['1']:.1f} s, "
        f"rank {x.rank}, mids on {P} ranks; fused rel res {res_f / bn:.2e}, "
        f"state within {out['1']['vs_fused']:.1e})")

    # 2. adaptive: grow ranks until 1e-10, AMEn kicks distributed
    xa, res_a, _ = timed("2", lambda: als_solve_adaptive_sharded(
        mesh, op, rhs, eps=1e-10, rank=2, max_rank=16, spd=True))
    xaf, res_af, _ = tnt.als_solve_adaptive(op, rhs, eps=1e-10, rank=2, max_rank=16, spd=True)
    out["2"] = {"rel_res": res_a / bn, "rank": xa.rank, "fused_rank": xaf.rank,
                "fused_rel_res": res_af / bn,
                "vs_fused": _rel_diff(_whole(mesh, xa), xaf)}
    _check(failed, "[2] state vs fused", out["2"]["vs_fused"], TOL)
    say(f"[2] adaptive (AMEn)        rel res {res_a / bn:.2e}  final rank {xa.rank}  "
        f"({out['walls_s']['2']:.1f} s; fused rank {xaf.rank}, rel res {res_af / bn:.2e}, "
        f"state within {out['2']['vs_fused']:.1e})")

    # 3. three lowest eigenpairs of the 1D screened Laplacian; the
    # analytic spectrum is delta + 4 sin^2(pi j / (2 (N+1)))
    delta = 0.5
    opg = qtt_screened_laplacian(K, delta=delta, device=dev)
    e0 = pk.pad_rank(qtt_exponential(K, c=2.0, device=dev), 6)
    _, vals = timed("3", lambda: als_eigsh_k_sharded(mesh, opg, e0, 3, sweeps=6))
    _, vals_f = tnt.als_eigsh_k(opg, e0, 3, sweeps=6)
    N = 2**K
    exact = [delta + 4.0 * np.sin(np.pi * j / (2 * (N + 1))) ** 2 for j in (1, 2, 3)]
    out["3"] = {"vals": list(map(float, vals)), "analytic_err": _rel_seq(vals, exact),
                "vs_fused": _rel_seq(vals, vals_f)}
    _check(failed, "[3] eigenvalues vs fused", out["3"]["vs_fused"], TOL)
    _check(failed, "[3] eigenvalues vs analytic", out["3"]["analytic_err"], TOL)
    say(f"[3] als_eigsh_k_sharded    lam {vals[0]:.6f} {vals[1]:.6f} {vals[2]:.6f}  vs "
        f"analytic err {max(abs(v - e) for v, e in zip(vals, exact)):.1e}  "
        f"({out['walls_s']['3']:.1f} s; vs fused {out['3']['vs_fused']:.1e})")

    # 4. generalized FEM pair: lam_min -> pi^2 as h -> 0
    h = 1.0 / (2**K + 1)
    A = qtt_tridiagonal(K, 2.0 / h, -1.0 / h, -1.0 / h, device=dev)
    M = qtt_tridiagonal(K, 4.0 * h / 6, h / 6, h / 6, device=dev)
    _, mu, _ = timed("4", lambda: als_eigsh_sharded(mesh, A, e0, sweeps=6, mass=M))
    _, mu_f, _ = tnt.als_eigsh(A, e0, sweeps=6, mass=M)
    out["4"] = {"mu": float(mu), "pi2_err": abs(mu - np.pi**2),
                "vs_fused": abs(mu - mu_f) / abs(mu_f)}
    _check(failed, "[4] eigenvalue vs fused", out["4"]["vs_fused"], TOL)
    say(f"[4] generalized (FEM)      lam {mu:.6f}  vs pi^2 err {abs(mu - np.pi**2):.1e}  "
        f"({out['walls_s']['4']:.1f} s; vs fused {out['4']['vs_fused']:.1e})")

    # 5. time integration: CN heat steps with the FEM pair + source, and
    # a TDVP flow under the identity (exact decay oracle)
    src = pk.pad_rank(qtt_exponential(K, c=-2.0, device=dev), 8)
    u0 = pk.pad_rank(qtt_exponential(K, c=1.0, device=dev), 8)
    theta_kw = dict(theta=0.5, mass=M, source=src, sweeps=6, spd=True)
    u_t, res_t = timed("5_theta", lambda: evolve_theta_sharded(mesh, A, u0, 1e-5, 3, **theta_kw))
    # the oracle: the same three steps as dense solves
    Ad, Md, ud, sd = dense_operator(A), dense_operator(M), dense_vector(u0), dense_vector(src)
    for _ in range(3):
        ud = np.linalg.solve(Md + 0.5e-5 * Ad, (Md - 0.5e-5 * Ad) @ ud + 1e-5 * sd)
    ident = pk.ttop_identity(K, 2, u0.first.dtype, device=dev)
    _, norms = timed("5_tdvp", lambda: evolve_tdvp_sharded(mesh, ident, u0, 0.05, 2))
    _, norms_f = tnt.evolve_tdvp(ident, u0, 0.05, 2)
    ratio = norms[1] / norms[0]
    out["5"] = {"max_step_resid": max(res_t), "theta_vs_dense": float(np.linalg.norm(dense_vector(_whole(mesh, u_t)) - ud)
                                         / np.linalg.norm(ud)),
                "tdvp_ratio": ratio, "tdvp_ratio_err": abs(ratio - np.exp(-0.05)),
                "tdvp_vs_fused": _rel_seq(norms, norms_f)}
    _check(failed, "[5] theta state vs dense", out["5"]["theta_vs_dense"], DENSE_TOL)
    _check(failed, "[5] tdvp norms vs fused", out["5"]["tdvp_vs_fused"], TOL)
    _check(failed, "[5] tdvp decay vs exp(-dt)", out["5"]["tdvp_ratio_err"], TOL)
    say(f"[5] evolve_theta_sharded   step residuals {max(res_t):.1e};  tdvp decay ratio "
        f"{ratio:.6f} (exact {np.exp(-0.05):.6f})  "
        f"({out['walls_s']['5_theta'] + out['walls_s']['5_tdvp']:.1f} s; vs fused "
        f"{out['5']['tdvp_vs_fused']:.1e}; theta vs the dense steps {out['5']['theta_vs_dense']:.1e})")

    if owned:
        dist.destroy_process_group()
    if failed:
        raise AssertionError("; ".join(failed))
    say("ALL OK")
    return out


if __name__ == "__main__":
    p = parser(__doc__)
    p.add_argument("K", type=int, nargs="?", default=10)
    args = p.parse_args()
    main(args.K, device=args.device)
