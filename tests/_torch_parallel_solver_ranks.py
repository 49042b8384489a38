"""The rank side of ``tests/test_torch_parallel_solvers.py``: one process of
a 4-rank gloo group on the CPU.

Imports torch, NumPy and the port only (a spawned rank must not load JAX).
:func:`run_rank` joins the group through a ``FileStore``, runs every
scenario on every rank in one order: each train-sharded solver on the
(1, 4) mesh, on rank 0 the same call on a (1, 1) mesh and the port's
fused single-device solver.  Rank 0 writes what the scenarios gathered
as NumPy arrays; a rank that fails writes its traceback beside them.
The systems are the JAX suite's (``tests/test_sweeps.py:266-410``): K=10,
so 8 middle cores, 2 a rank.  :func:`run_example_rank` is the rank side
of ``tests/test_torch_examples.py``: the two distributed example scripts
in a group of any size.
"""

import datetime
import os
import pickle
import traceback

import numpy as np
import torch
import torch.distributed as dist

import tensor_networks_tpu_torch as tnt
from tensor_networks_tpu_torch.ops import packed
from tensor_networks_tpu_torch.ops import als as als_ops
from tensor_networks_tpu_torch.ops import eigen as eig_ops
from tensor_networks_tpu_torch.ops import evolve as evo_ops
from tensor_networks_tpu_torch.parallel import (
    add_sharded,
    als_eigsh_adaptive_sharded,
    als_eigsh_k_sharded,
    als_eigsh_sharded,
    als_solve_adaptive_sharded,
    als_solve_sharded,
    als_sweep_sharded,
    evolve_tdvp2_sharded,
    evolve_tdvp_sharded,
    evolve_theta_sharded,
    make_mesh,
    place_als_sharded,
    place_eigsh_sharded,
    place_tdvp_sharded,
    tdvp_step_sharded,
    ttop_apply_sharded,
)
from tensor_networks_tpu_torch.parallel import als as pals
from tensor_networks_tpu_torch.parallel import eigen as peig
from tensor_networks_tpu_torch.parallel import evolve as pevo
from tensor_networks_tpu_torch.parallel import sweeps

WORLD = 4
K = 10
CPU = "cpu"


def _np(x):
    return np.asarray(x.detach().cpu())


def _gather(mesh, mids):
    """The global middle cores from each model rank's block."""
    group = mesh.get_group("model")
    parts = [torch.empty_like(mids) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, mids.contiguous(), group=group)
    return torch.cat(parts)


def _train(mesh, t):
    """A result train as NumPy cores, its blocks gathered over ``mesh``
    (None: a single-device result)."""
    if mesh is None:
        return tuple(_np(x) for x in t)
    return _np(t.first), _np(_gather(mesh, t.mids)), _np(t.last)


def _pack(mesh, obj):
    """A result with every train as NumPy cores."""
    if isinstance(obj, packed.PackedTT):
        return _train(mesh, obj)
    if isinstance(obj, (tuple, list)):
        return type(obj)(_pack(mesh, o) for o in obj)
    return obj


def _error(fn):
    try:
        fn()
    except (ValueError, RuntimeError) as e:
        return type(e).__name__, str(e)
    return None


def _three(m4, one, sharded, fused):
    """``sharded(mesh)`` on the (1, 4) mesh (every rank), on the (1, 1)
    mesh (rank 0) and the fused ``fused()`` (rank 1, meanwhile): the
    packed results this rank holds, and its raw ones."""
    raw = {"p4": sharded(m4)}
    if dist.get_rank() == 0:
        raw["p1"] = sharded(one)
    if dist.get_rank() == 1:
        raw["fused"] = fused()
    out = {"p4": _pack(m4, raw["p4"])}
    out.update({k: _pack(None, v) for k, v in raw.items() if k != "p4"})
    return out, raw


# ---- scenarios ----------------------------------------------------------------------


def scenario_algebra(m4, one):
    op = tnt.qtt_screened_laplacian(K, delta=1.0, device=CPU)
    u = packed.pad_rank(tnt.qtt_exponential(K, c=3.0, device=CPU), 6)
    v = tnt.qtt_exponential(K, c=-1.0, device=CPU)
    ub = pevo._block_train(m4, u, K - 2)
    vb = pevo._block_train(m4, v, K - 2)
    return {
        "apply": _train(m4, ttop_apply_sharded(m4, op, ub)),
        "apply_ref": _train(None, packed.ttop_apply_packed(op, u)),
        "add": _train(m4, add_sharded(m4, ub, vb)),
        "add_ref": _train(None, packed.add(u, v)),
        "u": _train(None, u), "v": _train(None, v), "op": _train(None, op),
    }


def _als_system():
    op = tnt.qtt_screened_laplacian(K, delta=1.0, device=CPU)
    rhs = tnt.qtt_exponential(K, c=3.0, device=CPU)
    return op, rhs, packed.pad_rank(rhs, 6)


def scenario_als(m4, one):
    op, rhs, x0 = _als_system()
    out = {}
    for name, kw in (("dense", dict(sweeps=2, tol=0.0, spd=True)),
                     ("cg", dict(sweeps=2, tol=0.0, spd=True, dense_limit=0, cg_iters=20))):
        out[name], _ = _three(m4, one, lambda m: als_solve_sharded(m, op, rhs, x0, **kw),
                              lambda: als_ops.als_solve(op, rhs, x0, **kw))
    # a warm restart from a sharded result (this rank's block)
    x4, _, _ = als_solve_sharded(m4, op, rhs, x0, sweeps=1, tol=0.0, spd=True)
    out["restart"] = _pack(m4, als_solve_sharded(m4, op, rhs, x4, sweeps=1, tol=0.0, spd=True))
    # one sweep on the stacked layout against the fused sweep
    xs = als_ops._core_lists(x0, x0.first.dtype)
    als_ops._canonicalize(xs)
    X = torch.stack(xs[1:-1])
    Xb, Amb, Bmb = place_als_sharded(m4, X, op.mids, rhs.mids)
    warm = als_ops._warm_gates(K, 2, 6)
    ends = (op.first[None], op.last[..., None], rhs.first[None], rhs.last[..., None])
    z0, V, vl = als_sweep_sharded(m4, xs[0], Xb, xs[-1], ends[0], Amb, ends[1], ends[2], Bmb,
                                  ends[3], 0.0, warm[0], warm[1:-1][sweeps._own_slice(m4, K - 2)],
                                  warm[-1], spd=True)
    out["sweep"] = (_np(z0), _np(_gather(m4, V)), _np(vl))
    if dist.get_rank() == 1:
        zf, Vf, vlf, _ = als_ops._als_sweep_impl(
            xs[0], X, xs[-1], ends[0], op.mids, ends[1], ends[2], rhs.mids, ends[3], 0.0,
            warm[0], warm[1:-1], warm[-1], 1024, 200, True)
        out["sweep_fused"] = (_np(zf), _np(Vf), _np(vlf))
    return out


def scenario_als_adaptive(m4, one):
    op, rhs, _ = _als_system()
    out = {}
    for enrich in (True, False):
        kw = dict(eps=1e-10, rank=2, max_rank=16, spd=True, enrich=enrich)
        out[enrich], _ = _three(m4, one, lambda m: als_solve_adaptive_sharded(m, op, rhs, **kw),
                                lambda: als_ops.als_solve_adaptive(op, rhs, **kw))
    return out


def _fem_pair():
    h = 1.0 / (2**K + 1)
    return (tnt.qtt_tridiagonal(K, 2.0 / h, -1.0 / h, -1.0 / h, device=CPU),
            tnt.qtt_tridiagonal(K, 4.0 * h / 6, h / 6, h / 6, device=CPU))


def scenario_eigsh(m4, one):
    op = tnt.qtt_screened_laplacian(K, delta=0.5, device=CPU)
    x0 = packed.pad_rank(tnt.qtt_exponential(K, c=2.0, device=CPU), 6)
    A, M = _fem_pair()
    out = {"op": _train(None, op)}
    out["ground"], raw = _three(m4, one, lambda m: als_eigsh_sharded(m, op, x0, sweeps=4),
                                lambda: eig_ops.als_eigsh(op, x0, sweeps=4))
    # deflated by the ground state each form found (the sharded ones by
    # their blocks)
    found = {id(m4): raw["p4"][0], id(one): raw.get("p1", (None,))[0]}
    out["deflate"], _ = _three(
        m4, one, lambda m: als_eigsh_sharded(m, op, x0, sweeps=5, deflate=(found[id(m)],)),
        lambda: eig_ops.als_eigsh(op, x0, sweeps=5, deflate=(raw["fused"][0],)))
    out["mass"], _ = _three(m4, one, lambda m: als_eigsh_sharded(m, A, x0, sweeps=4, mass=M),
                            lambda: eig_ops.als_eigsh(A, x0, sweeps=4, mass=M))
    kw = dict(sweeps=2, tol=-1.0, dense_limit=0, lanczos_iters=10)
    out["lanczos"], _ = _three(m4, one, lambda m: als_eigsh_sharded(m, op, x0, **kw),
                               lambda: eig_ops.als_eigsh(op, x0, **kw))
    return out


def scenario_eigsh_k(m4, one):
    op = tnt.qtt_screened_laplacian(K, delta=0.5, device=CPU)
    x0 = packed.pad_rank(tnt.qtt_exponential(K, c=2.0, device=CPU), 6)
    x1 = tnt.qtt_exponential(K, c=2.0, device=CPU)
    out = {}
    out["k"], _ = _three(m4, one, lambda m: als_eigsh_k_sharded(m, op, x0, 3, sweeps=6),
                         lambda: eig_ops.als_eigsh_k(op, x0, 3, sweeps=6))
    kw = dict(eps=1e-10, max_rank=8)
    out["adaptive"], _ = _three(m4, one, lambda m: als_eigsh_adaptive_sharded(m, op, x1, **kw),
                                lambda: eig_ops.als_eigsh_adaptive(op, x1, **kw))
    return out


def scenario_tdvp(m4, one):
    A = tnt.qtt_tridiagonal(K, 2.0, -1.0, -1.0, device=CPU)
    u0 = packed.pad_rank(tnt.qtt_exponential(K, c=3.0, device=CPU), 4)
    out = {}
    for name, kw in (("dense", {}), ("lanczos", dict(dense_limit=0, krylov=10))):
        out[name], _ = _three(m4, one, lambda m: evolve_tdvp_sharded(m, A, u0, 0.03, 3, **kw),
                              lambda: evo_ops.evolve_tdvp(A, u0, 0.03, 3, **kw))
    # one step on the stacked layout against the fused step
    x0, X, xl, a0, Am, al = evo_ops._fused_operands(A, u0)
    Xb, Amb = place_tdvp_sharded(m4, X, Am)
    z0, V, xlq, nrm = tdvp_step_sharded(m4, x0, Xb, xl, a0, Amb, al, 0.03)
    out["step"] = (_np(z0), _np(_gather(m4, V)), _np(xlq), float(nrm))
    out["bound_p4"] = pevo._op_norm_bound_sharded(m4, A.first, Amb, A.last)
    if dist.get_rank() == 1:
        sq = evo_ops._squarings(A, 0.015, 4 * 2 * 4, 1024, 24)
        zf, Vf, xlf = evo_ops._tdvp_step_impl(x0, X, xl, a0, Am, al,
                                              evo_ops._step_size(0.03, x0), 1024, 24, sq)
        out["step_fused"] = (_np(zf), _np(Vf), _np(xlf))
        out["bound"] = evo_ops._op_norm_bound(A)

    B = tnt.qtt_screened_laplacian(K, delta=1.0, device=CPU)
    for name, u_start, kw in (
            ("tdvp2", u0, dict(dt=0.01, steps=3, max_rank=6)),
            ("tdvp2_grow", tnt.qtt_exponential(K, c=3.0, device=CPU),
             dict(dt=0.05, steps=2, max_rank=8, eps=1e-10))):
        out[name], _ = _three(m4, one, lambda m: evolve_tdvp2_sharded(m, B, u_start, **kw),
                              lambda: evo_ops.evolve_tdvp2(B, u_start, **kw))
    return out


def scenario_theta(m4, one):
    op = tnt.qtt_screened_laplacian(K, delta=1.0, device=CPU)
    u0 = packed.pad_rank(tnt.qtt_exponential(K, c=3.0, device=CPU), 6)
    out = {}
    out["euler"], _ = _three(
        m4, one, lambda m: evolve_theta_sharded(m, op, u0, 0.01, 3, theta=1.0, spd=True),
        lambda: evo_ops.evolve_theta(op, u0, 0.01, 3, theta=1.0, spd=True))
    A, M = _fem_pair()
    u0b = packed.pad_rank(tnt.qtt_exponential(K, c=1.0, device=CPU), 8)
    src = packed.pad_rank(tnt.qtt_exponential(K, c=-2.0, device=CPU), 8)
    out["cn"] = {"p4": _pack(m4, evolve_theta_sharded(
        m4, A, u0b, 1e-5, 3, theta=0.5, mass=M, source=src, sweeps=6, spd=True,
        observables=(M,)))}
    out["cn"].update(A=_train(None, A), M=_train(None, M), u0=_train(None, u0b),
                     src=_train(None, src))
    return out


def scenario_capacity(m4, one):
    """The bytes of the trains, operator blocks and env chains a rank holds
    in one ALS sweep, one eigensolver sweep (mass and deflation on) and
    one TDVP step, at P=4 and at P=1 (the blocks and chains the sweeps
    stage)."""
    def nbytes(*ts):
        flat = [x for t in ts for x in (t if isinstance(t, list) else [t])]
        return sum(t.numel() * t.element_size() for t in flat)

    op, rhs, x0 = _als_system()
    dt = torch.float64

    def als_bytes(m):
        x = pevo._block_train(m, x0, K - 2)
        x0c, X, xlc = pevo._canonical(m, x.first, x.mids, x.last)
        opb, rb = pevo._block_op(m, op), pevo._block_train(m, rhs, K - 2)
        warm = als_ops._warm_gates(K, 2, 6)
        _, V, _, (rs, rbs, _, _) = pals._als_sweep_blocks(
            m, x0c, X, xlc, opb.first[None], opb.mids, opb.last[..., None], rb.first[None],
            rb.mids, rb.last[..., None], 0.0, warm[0], warm[1:-1][sweeps._own_slice(m, K - 2)],
            warm[-1], 1024, 200, True)
        return nbytes(V, opb.mids, rb.mids, rs, rbs)

    def eig_bytes(m):
        h = 1.0 / (2**K + 1)
        M = tnt.qtt_tridiagonal(K, 4.0 * h / 6, h / 6, h / 6, device=CPU)
        x = pevo._block_train(m, x0, K - 2)
        x0c, X, xlc = pevo._canonical(m, x.first, x.mids, x.last)
        opb, mb = pevo._block_op(m, op), pevo._block_op(m, M)
        vstk = (x0.first[None, None], x.mids[:, None], x0.last[None, ..., None])
        helpers = eig_ops._EigHelpers(True, True, dt, torch.device(CPU), 1)
        out = peig._eig_sweep_blocks(m, helpers, x0c, X, xlc, opb.first[None], opb.mids,
                                     opb.last[..., None],
                                     (mb.first[None], mb.mids, mb.last[..., None]),
                                     vstk, 10.0)
        chains = out[5][0]
        return nbytes(out[1], opb.mids, mb.mids, vstk[1], *chains)

    def tdvp_bytes(m):
        A = tnt.qtt_tridiagonal(K, 2.0, -1.0, -1.0, device=CPU)
        (x0c, X, xl, a0, Am, al), _ = pevo._stacked_operands(m, A, x0)
        z0, V, xlq = pevo._tdvp_step_blocks(m, x0c, X, xl, a0, Am, al,
                                            evo_ops._step_size(0.01, x0c), 1024, 24, 4)
        [(_, _, rs)] = sweeps._staged_sweep(m, [(True, (evo_ops._adv_right(
            evo_ops._ones3(z0), xlq, al),), (V, Am), pevo._single(evo_ops._tdvp_renv_body))])
        return nbytes(V, Am, rs)

    return {name: (fn(m4), fn(one) if dist.get_rank() == 0 else None)
            for name, fn in (("als", als_bytes), ("eigsh", eig_bytes), ("tdvp", tdvp_bytes))}


def scenario_errors(m4, one):
    op, rhs, x0 = _als_system()
    op9 = tnt.qtt_screened_laplacian(9, delta=1.0, device=CPU)
    rhs9 = tnt.qtt_exponential(9, c=3.0, device=CPU)
    return {
        "place_als": _error(lambda: place_als_sharded(m4, x0.mids[:6], op.mids[:6],
                                                      rhs.mids[:6])),
        "place_eigsh": _error(lambda: place_eigsh_sharded(m4, x0.mids[:6], op.mids[:6])),
        "place_tdvp": _error(lambda: place_tdvp_sharded(m4, x0.mids[:6], op.mids[:6])),
        "solve_k9": _error(lambda: als_solve_sharded(m4, op9, rhs9, rhs9, sweeps=1)),
        "eigsh_k9": _error(lambda: als_eigsh_sharded(m4, op9, rhs9, sweeps=1)),
        "tdvp_k9": _error(lambda: evolve_tdvp_sharded(m4, op9, rhs9, 0.01, 1)),
        "mixed_deflation": _error(lambda: als_eigsh_sharded(
            m4, op, x0, sweeps=1, deflate=(x0, rhs))),
    }


SCENARIOS = (
    ("algebra", scenario_algebra),
    ("als", scenario_als),
    ("als_adaptive", scenario_als_adaptive),
    ("eigsh", scenario_eigsh),
    ("eigsh_k", scenario_eigsh_k),
    ("tdvp", scenario_tdvp),
    ("theta", scenario_theta),
    ("capacity", scenario_capacity),
    ("errors", scenario_errors),
)


def _in_group(rank: int, world: int, store_path: str, out_dir: str, work) -> None:
    """Join a ``world``-rank gloo group through a ``FileStore``, run
    ``work()``, and on ranks 0 and 1 write what it returned as
    ``results_<rank>.pkl``; a rank that fails writes its traceback as
    ``error_<rank>.txt`` instead."""
    torch.set_num_threads(1)
    try:
        dist.init_process_group(
            "gloo", store=dist.FileStore(store_path, world), rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=60))
        results = work()
        if rank in (0, 1):
            with open(os.path.join(out_dir, f"results_{rank}.pkl"), "wb") as f:
                pickle.dump(results, f)
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(out_dir, f"error_{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise


def run_rank(rank: int, store_path: str, out_dir: str) -> None:
    """Run every scenario; ranks 0 (the P=4 and P=1 results) and 1 (the
    fused solvers') each write ``results_<rank>.pkl``."""
    def work():
        m4 = make_mesh((1, 4), devices="cpu")
        one = make_mesh((1, 1), devices="cpu")  # every rank builds it; rank 0 uses it
        return {name: fn(m4, one) for name, fn in SCENARIOS}

    _in_group(rank, WORLD, store_path, out_dir, work)


def run_example_rank(rank: int, world: int, store_path: str, out_dir: str) -> None:
    """The two distributed example scripts (``examples_torch/``) at small
    sizes on this rank of a ``world``-rank group: the solvers at K=6, the
    regression at d=4 for 10 steps.  Ranks 0 and 1 write what each
    ``main`` returned."""
    from examples_torch import distributed_solvers, tt_regression_multichip

    def work():
        return {"solvers": distributed_solvers.main(K=6, device=CPU),
                "regression": tt_regression_multichip.main(d=4, steps=10, device=CPU)}

    _in_group(rank, world, store_path, out_dir, work)
