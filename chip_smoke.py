#!/usr/bin/env python3
"""End-to-end check of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Builds the CUDA kernels from ``tensor_networks_tpu_torch/kernels/csrc``,
checks that the package's constructors default to the card, then runs
eight phases:

1. every kernel against its plain PyTorch version on the card, in float32
   and float64, at the main path's shapes and at odd ones, with a
   float64 plain result as the reference: the inner product on both of
   its routes (the fused steps up to rank 128, the chain above) and
   twice each for bit-identical outputs; the grouped evaluation kernel
   also at the index patterns that stress its grouping tables, and twice
   for bit-identical outputs; then what raised before: ranks 513 and
   1024, evaluation with end modes of their own, bf16 and f16 cores;
2. the main path at full size (d=50 cores, mode n=32, rank r=100, f32):
   build two trains, pack, inner product and norm, fixed-rank rounding
   of ``a + a``, evaluation at 8192 points -- with the kernels' launch
   counters reset just before and read just after (the three inner
   products must take the fused route);
3. timings at the main path's shapes (CUDA events): each kernel against
   its plain version and its bound (the larger of bytes over 3.35 TB/s
   and FP32 operations over 67 TFLOP/s, the H100's published peaks),
   the grouped evaluation against the per-point kernel it replaced
   at 8192, 1000 and 300 points; the inner product's fused route against
   the chain (turns F C C F), the device time of each by kernel
   (torch.profiler), the chain at ranks (256, 256) and (512, 300), and
   the kernels with bf16 and f16 cores;
4. every ``tt_round_fixed`` method on the main path's ``a + a``: kept
   ranks, error, wall time, device-busy time, kernel count and host
   syncs; ``torch.linalg.svd``'s drivers on the svd sweep's R factors;
   each method at d=12 in f64 for correctness;
5. cross approximation on the card: the JAX package's ``cross_device``
   leg (a d=8, n=32, rank-24 f32 target sampled in float64 through the
   evaluation kernel, kickrank 4, VALID_ERROR, max_iters 8, eps 1e-8),
   with the launch counters reset just before and read just after, its
   wall time split into fibers, target evaluation, pivots, check and
   the rest, its error against the plain f64 evaluation on the CPU, the
   f64 kernel held to that plain version on the target and on the
   cross's largest fiber batch, and the same cross on the CPU; the leg
   again at target rank 48 (kickrank 8), whose fibers cross the maxvol
   gate and must take ``maxvol_device``; the ``cross_host`` leg (Ackley
   d=8, VALID_ERROR and NORM), HT and Tucker; the kernels at the
   slice's new call shapes against their plain versions
   (``evaluate_ensemble``, ``tt_evaluate_fast`` and its gradient,
   ``evaluate_dw``, ``maxvol_device`` against the host loop); timings of
   the f64 evaluation (checked to 1e-12), the ensemble, and
   ``maxvol_auto``'s host and card branches on each side of its gate;
6. the four TT rounding families and the graph route at full width, with
   the launch counters reset just before and read just after:
   ``tt_svd_round``, ``TensorNetwork.round`` (orthonormalize, then per
   bond svd, merge and qr), ``tt_gramsvd_round``, ``tt_sum_gramsvd_round``,
   ``tt_randomized_round``, ``tt_sum_randomized_round`` and
   ``tt_rand_precond_svd_round`` on the main path's ``a + a`` (and
   ``[a, a, a]``), in f32 at eps 1e-3 and in f64 at 1e-10: kept ranks,
   the error at the 8192 points through the evaluation kernel against
   the plain f64 evaluation on the CPU, the error norm through the inner
   product kernel, wall, device-busy time, kernels and host syncs; the
   Gram families again above their floor; a summed HT (16 modes of 32,
   rank 32, f64) rounded from its root, its structure hash checked; and
   the inner product kernel's f64 instantiation timed at the main shape
   and at the error norms' (200, 100);
7. TT-GMRES on the card, each solve with the launch counters reset just
   before and read just after: ``gmres_packed`` on ``bench.py``'s
   screened-Poisson QTT systems (delta 1, rhs exp(-3 i / 2^K), x0 the
   rhs padded to rank 4): leg A at K=22 (4,194,304 unknowns), Krylov
   rank 8, in f64 and f32 with ``"svd"`` rounding and f64 with
   ``"rand"``; leg B at K=14, rank 64 = max_rank, f32 and f64.  Each
   solve's wall, cycles, iterations, device-busy time, kernels and host
   syncs (a second, profiled run), H1 launches by dtype, its per-part
   split, the residual as reported and recomputed on the CPU in f64, and
   the solution at 8192 grid points through H2 against the tridiagonal
   system solved in f64 on the host (``scipy.linalg.solve_banded``); H1
   and H2 at the solve's shapes against their plain versions, timed in
   turns.  Leg C: the graph ``gmres`` on a Kronecker-sum shifted
   Laplacian (d=8 modes of 32, delta 8), residual reported and
   recomputed;
8. the ALS linear solver and the DMRG eigensolver on the card at
   ``bench.py``'s solver configurations, TF32 off: (a) ``als_solve`` on
   phase 7's K=22 system from ``pad_rank(rhs, 8)`` (spd, dense locals,
   singular at the end bonds) in f64 and f32, fused and host loop, its
   solution at 8192 grid points through H2 against the banded solve;
   (b) ``bench.py``'s ``_leg_solver_cpu`` on the card in f64: the
   2^30-unknown solve and the 32^3 DMRG ground state against the
   analytic eigenvalue; (c) ``tools/solver_r64_probe.py``'s K=14,
   rank-64 f32 fused ALS and eigsh (CG and Lanczos locals of 8192
   unknowns), the per-sweep time the slope between 5 and 8 sweeps, with
   GFLOP/s; (d) ``als_eigsh_k`` (k=3, slots) at K=14 in f64 against the
   analytic eigenvalues, the overlaps through H1; (e)
   ``als_solve_adaptive`` with and without enrichment on the 3-axis
   interleaved system at 3 bits per axis (the reference suite's claims)
   and at 5.  Each solve's wall, sweeps, ms a sweep (CUDA events),
   device-busy share and kernels (torch.profiler, a second run) and host
   syncs by kind (the stop test, the record fetch, cuSOLVER's status
   checks), its residual reported and recomputed on the CPU in f64 or its
   eigenvalue error; H1 and H2 at the legs' shapes against their plain
   versions; ``torch.linalg.lstsq`` refused for the whole phase (the
   dense local solve must not reach its full-rank ``gels``).

Then a JSON line with phase 4's numbers, one with phase 5's, one with
phase 6's, one with phase 7's, one with phase 8's, one with per-kernel
results,
the card's name and power limit from ``nvidia-smi``, and, last, the
result line
``{"ok": true, "device": {...}}``.  Any failure raises and exits
nonzero without that line; without a CUDA device the script exits 2.
Imports nothing of JAX.
"""

from __future__ import annotations

import copy
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

SEED = 1234
D, N, R, B = 50, 32, 100, 8192
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published
FP32_FLOP_PER_S = 67e12  # H100 SXM, outside the tensor cores, published


def _rand(g, *shape, scale=1.0, dtype=torch.float32):
    return torch.randn(shape, generator=g, device=g.device, dtype=torch.float64).mul_(scale).to(dtype)


def _train(g, d, n, r, mid_scale, end_scale=1.0, dtype=torch.float32):
    """Packed cores (first, mids, last) of a random train."""
    return (
        _rand(g, n, r, scale=end_scale, dtype=dtype),
        _rand(g, d - 2, r, n, r, scale=mid_scale, dtype=dtype),
        _rand(g, r, n, scale=end_scale, dtype=dtype),
    )


def _f64(*xs):
    return [None if x is None else x.double() for x in xs]


def _time_ms(fn, reps=20, warmup=3):
    """Mean ms per call over ``reps`` calls (CUDA events, after warm-up);
    every output is summed into an accumulator that is checked finite."""
    acc = None
    for _ in range(warmup):
        out = fn()
        acc = out.sum() if acc is None else acc + out.sum()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        acc = acc + fn().sum()
    stop.record()
    torch.cuda.synchronize()
    if not torch.isfinite(acc):
        raise AssertionError("timed outputs are not finite")
    return start.elapsed_time(stop) / reps


def phase_kernels_vs_plain(zp, ev, dev):
    """H1 (both routes) and H2 against their plain versions, f32 and f64."""
    g = torch.Generator(device=dev).manual_seed(SEED)
    worst = {"inner": 0.0, "evaluate": 0.0}
    checks = 0
    tol = {torch.float32: 1e-4, torch.float64: 1e-10}
    edge = zp.FUSED_MAX_RANK
    # (d, n, r_a, r_b): the main path, odd sizes, mixed ranks, d = 2 and 3,
    # n = 1 and 300, the two sides of the fused route's rank limit, the
    # rank-256 and rank-512 envelope
    for d, n, ra, rb in [(D, N, R, R), (7, 5, 37, 37), (7, 5, 64, 96),
                         (3, 6, 9, 4), (2, 6, 20, 12), (6, 1, R, R),
                         (4, 300, 48, 40), (5, N, R, 64), (5, 8, edge, edge),
                         (5, 8, edge + 1, edge), (10, 8, 256, 256),
                         (4, 4, 512, 300)]:
        a64 = _train(g, max(d, 3), n, ra, 1 / math.sqrt(n * ra), dtype=torch.float64)
        b64 = _train(g, max(d, 3), n, rb, 1 / math.sqrt(n * rb), dtype=torch.float64)
        if d == 2:
            a64, b64 = (a64[0], None, a64[2]), (b64[0], None, b64[2])
        na = math.sqrt(zp.tt_inner_plain(*a64, *a64).item())
        nb = math.sqrt(zp.tt_inner_plain(*b64, *b64).item())
        fused = zp.takes_fused_route(ra, rb)
        # <a, b> of independent trains is near 0 at large d; <a, a> is not
        for x64, y64, scale in ((a64, b64, na * nb), (a64, a64, na * na)):
            ref = zp.tt_inner_plain(*x64, *y64).item()
            for dt in (torch.float32, torch.float64):
                args = [None if x is None else x.to(dt).contiguous()
                        for x in x64 + y64]
                before = zp.tt_inner_cuda.fused
                routed = zp.tt_inner_cuda(*args)
                if zp.tt_inner_cuda.fused != before + fused:
                    raise AssertionError(f"inner ra={ra} rb={rb}: wrong route")
                chain = zp.tt_inner_chain_cuda(*args)
                for name, val, again in (
                        ("routed", routed, zp.tt_inner_cuda),
                        ("chain", chain, zp.tt_inner_chain_cuda),
                        ("plain", zp.tt_inner_plain(*args), None)):
                    if again is not None and not torch.equal(val, again(*args)):
                        raise AssertionError(
                            f"inner {name} d={d} n={n} ra={ra} rb={rb} {dt}: "
                            "two calls differ")
                    err = abs(val.item() - ref) / scale
                    if not err <= tol[dt]:
                        raise AssertionError(
                            f"inner {name} d={d} n={n} ra={ra} rb={rb} {dt}: "
                            f"|got-ref|/(|a||b|) = {err:.3e} > {tol[dt]}")
                    worst["inner"] = max(worst["inner"], err / tol[dt])
                    checks += 1

    # (d, n, r, B, pattern): point values O(1) with mids scaled 1/sqrt(r).
    # Beside the main path's shape: one group of 8192 points (many tiles
    # of one slice), every point of a step in its own mode, one point,
    # batches that are no multiple of the tile, a mode without a point,
    # d = 2 and d = 3, the scalar-load path (r = 37), the rank envelope,
    # two modes, and more modes than points in most groups.
    tile = ev.TILE_P
    cases = [(D, N, R, B, "random"), (D, N, R, B, "one-mode"),
             (D, N, R, 1000, "random"), (D, N, R, 300, "random"),
             (9, N, R, 20, "distinct"), (D, N, R, 1, "random"),
             (7, 5, 37, 1000, "random"), (7, 5, 37, tile + 1, "skip-mode"),
             (2, 6, 40, 500, "random"), (3, 6, 40, 500, "random"),
             (10, 8, 256, 1000, "random"), (4, 4, 512, 300, "random"),
             (8, 2, 64, 777, "random"), (6, 300, 48, 2000, "random")]
    for d, n, r, bsz, pattern in cases:
        first, mids, last = _train(g, max(d, 3), n, r, 1 / math.sqrt(r),
                                   dtype=torch.float64)
        cores64 = (first, mids if d > 2 else None, last)
        idx = _points(g, pattern, bsz, d, n)
        ref = ev.tt_evaluate_plain(*cores64, idx)
        scale = ref.abs().max().item()
        if d > 2:  # the tile-list kernel against its torch version, exactly
            vals = torch.sort(idx[:, 1:-1].t().contiguous(), dim=1, stable=True)[0]
            slots = ev.max_tiles_per_step(bsz, n)
            if not torch.equal(ev.group_tiles_cuda(vals, n, tile, slots),
                               ev.group_tiles_plain(vals, n, tile, slots)):
                raise AssertionError(
                    f"tile list d={d} n={n} B={bsz} {pattern}: kernel != plain")
            checks += 1
        for dt in (torch.float32, torch.float64):
            cores = [None if x is None else x.to(dt).contiguous() for x in cores64]
            got = ev.tt_evaluate_cuda(*cores, idx)
            if not torch.equal(got, ev.tt_evaluate_cuda(*cores, idx)):
                raise AssertionError(
                    f"evaluate d={d} n={n} r={r} B={bsz} {pattern} {dt}: "
                    "two calls differ")
            for name, val in (("kernel", got),
                              ("per-point", ev.tt_evaluate_per_point_cuda(*cores, idx)),
                              ("plain", ev.tt_evaluate_plain(*cores, idx))):
                err = (val.double() - ref).abs().max().item() / scale
                if not err <= tol[dt]:
                    raise AssertionError(
                        f"evaluate {name} d={d} n={n} r={r} B={bsz} "
                        f"{pattern} {dt}: max err / max|ref| = {err:.3e}")
                worst["evaluate"] = max(worst["evaluate"], err / tol[dt])
                checks += 1
    if ev.tt_evaluate_cuda(*cores, idx[:0]).shape != (0,):
        raise AssertionError("evaluate at B=0 must return an empty vector")
    torch.cuda.synchronize()
    print(f"phase 1 kernels vs plain: ok, {checks} checks, worst err/tol "
          f"inner {worst['inner']:.3g} evaluate {worst['evaluate']:.3g}")
    phase_fault_cases(zp, ev, dev)


#: tolerances of the 2-byte types, of |a||b| or max|ref|: the kernels sum
#: in f32 and round the result to the cores' type (8 and 11 mantissa bits)
HALF_TOL = {torch.bfloat16: 8e-3, torch.float16: 1e-3}


def _check_inner(zp, route, args, ref, scale, tol, what):
    """One inner product through ``route`` against ``ref``, twice for the
    same bits; returns err/tol."""
    got = route(*args)
    if got.dtype != args[0].dtype or not torch.equal(got, route(*args)):
        raise AssertionError(f"{what}: wrong dtype, or two calls differ")
    err = abs(got.double().item() - ref) / scale
    if not err <= tol:
        raise AssertionError(f"{what}: |got-ref|/(|a||b|) = {err:.3e} > {tol}")
    return err / tol


def _check_eval(ev, cores, idx, ref, tol, what):
    """One grouped evaluation against ``ref``, twice for the same bits;
    returns err/tol."""
    got = ev.tt_evaluate_cuda(*cores, idx)
    if got.dtype != cores[0].dtype or not torch.equal(got, ev.tt_evaluate_cuda(*cores, idx)):
        raise AssertionError(f"{what}: wrong dtype, or two calls differ")
    err = (got.double() - ref).abs().max().item() / ref.abs().max().item()
    if not err <= tol:
        raise AssertionError(f"{what}: max err / max|ref| = {err:.3e} > {tol}")
    return err / tol


def phase_fault_cases(zp, ev, dev):
    """What raised on the card before: ranks above 512 (the chain and
    H2), H2 with end modes of their own, and bf16 / f16 cores through
    both H1 routes and H2.  Each against an f64 plain result on the same
    cores, each twice for bit-identical output."""
    g = torch.Generator(device=dev).manual_seed(SEED + 7)
    tol = {torch.float32: 1e-4, torch.float64: 1e-10, **HALF_TOL}
    worst, checks = {}, 0

    def note(key, ratio):
        nonlocal checks
        worst[key] = max(worst.get(key, 0.0), ratio)
        checks += 1

    # ranks 513 and 1024 at d=6, n=8: the chain and H2
    for r in (513, 1024):
        a64 = _train(g, 6, 8, r, 1 / math.sqrt(8 * r), dtype=torch.float64)
        b64 = _train(g, 6, 8, r, 1 / math.sqrt(8 * r), dtype=torch.float64)
        e64 = _train(g, 6, 8, r, 1 / math.sqrt(r), dtype=torch.float64)
        idx = _points(g, "random", 1000, 6, 8)
        na = math.sqrt(zp.tt_inner_plain(*a64, *a64).item())
        nb = math.sqrt(zp.tt_inner_plain(*b64, *b64).item())
        ref = zp.tt_inner_plain(*a64, *b64).item()
        eref = ev.tt_evaluate_plain(*e64, idx)
        for dt in (torch.float32, torch.float64):
            args = [x.to(dt) for x in a64 + b64]
            for route in (zp.tt_inner_cuda, zp.tt_inner_chain_cuda):
                note(f"rank {r}", _check_inner(zp, route, args, ref, na * nb, tol[dt],
                                               f"inner r={r} {dt}"))
            note(f"rank {r}", _check_eval(ev, [x.to(dt) for x in e64], idx, eref,
                                          tol[dt], f"evaluate r={r} {dt}"))
        del a64, b64, e64
    # end modes of their own: (n0, n, nl)
    for n0, n, nl in ((3, 8, 5), (32, 8, 1)):
        first = _rand(g, n0, 40, dtype=torch.float64)
        mids = _rand(g, 4, 40, n, 40, scale=1 / math.sqrt(40), dtype=torch.float64)
        last = _rand(g, 40, nl, dtype=torch.float64)
        idx = torch.stack([torch.randint(0, m, (1000,), generator=g, device=dev,
                                         dtype=torch.int32)
                           for m in [n0] + [n] * 4 + [nl]], dim=1).contiguous()
        eref = ev.tt_evaluate_plain(first, mids, last, idx)
        for dt in (torch.float32, torch.float64):
            note("end modes", _check_eval(ev, [x.to(dt) for x in (first, mids, last)],
                                          idx, eref, tol[dt],
                                          f"evaluate (n0, n, nl)=({n0}, {n}, {nl}) {dt}"))
    # bf16 and f16 cores at d=6, n=32: r=37 (rows not 4-byte aligned), 100,
    # and 129 (the router's chain); trains scaled to O(1)
    for r in (37, 100, 129):
        # |a| ~ 1: with mids scaled 1/sqrt(n r), |a|^2 ~ n^2 r |ends|^2
        ends = (N * N * r) ** -0.25
        a64 = _train(g, 6, N, r, 1 / math.sqrt(N * r), ends, dtype=torch.float64)
        b64 = _train(g, 6, N, r, 1 / math.sqrt(N * r), ends, dtype=torch.float64)
        e64 = _train(g, 6, N, r, 1 / math.sqrt(r), dtype=torch.float64)
        idx = _points(g, "random", 1000, 6, N)
        for dt in (torch.bfloat16, torch.float16):
            a, b, e = ([x.to(dt) for x in t] for t in (a64, b64, e64))
            # the reference takes the cores as rounded to dt
            a_r, b_r, e_r = (_f64(*t) for t in (a, b, e))
            na = math.sqrt(zp.tt_inner_plain(*a_r, *a_r).item())
            nb = math.sqrt(zp.tt_inner_plain(*b_r, *b_r).item())
            for x, y, scale in ((a, b, na * nb), (a, a, na * na)):
                ref = zp.tt_inner_plain(*_f64(*x), *_f64(*y)).item()
                fused = zp.tt_inner_cuda.fused
                for route in (zp.tt_inner_cuda, zp.tt_inner_chain_cuda):
                    note(f"{dt}", _check_inner(zp, route, x + y, ref, scale, tol[dt],
                                               f"inner r={r} {dt} {route.__name__}"))
                if zp.tt_inner_cuda.fused - fused != 2 * zp.takes_fused_route(r, r):
                    raise AssertionError(f"inner r={r} {dt}: wrong route")
            eref = ev.tt_evaluate_plain(*e_r, idx)
            note(f"{dt}", _check_eval(ev, e, idx, eref, tol[dt], f"evaluate r={r} {dt}"))
    torch.cuda.synchronize()
    print(f"phase 1 fault cases: ok, {checks} checks (each twice, bit-identical), "
          "worst err/tol " + ", ".join(f"{k} {v:.3g}" for k, v in worst.items()))


def _points(g, pattern, bsz, d, n):
    """(bsz, d) int32 evaluation points on the generator's device."""
    dev = g.device
    if pattern == "one-mode":
        # one group of bsz points at every step; the end indices vary, so
        # the values do and max|ref| is no single ill-conditioned product
        idx = torch.randint(0, n, (bsz, d), generator=g, device=dev, dtype=torch.int32)
        idx[:, 1:-1] = min(3, n - 1)
        return idx
    if pattern == "distinct":  # bsz <= n: every group holds one point
        rows = torch.arange(bsz, device=dev)[:, None]
        steps = torch.arange(d, device=dev)[None, :]
        return ((rows + steps) % n).to(torch.int32)
    idx = torch.randint(0, n, (bsz, d), generator=g, device=dev, dtype=torch.int32)
    if pattern == "skip-mode":  # mode 1 holds no point at any step
        idx = torch.where(idx == 1, torch.zeros_like(idx), idx)
    return idx


def phase_default_device():
    """Constructors called without a device put their tensors on the card."""
    import tensor_networks_tpu_torch as tnt

    inds = [tnt.Index(f"x{k}", 3) for k in range(4)]
    net = tnt.TensorNetwork.rand_tt(inds, [2, 2, 2])
    meta, arrays = net.to_separated_dict()
    made = {
        "rand_tt": [net.value(k) for k in range(4)],
        "from_dict": [tnt.TensorNetwork.from_dict(net.to_dict()).value(0)],
        "from_separated_dict": [
            tnt.TensorNetwork.from_separated_dict(meta, arrays).value(0)],
        "Tensor.from_dict": [tnt.Tensor.from_dict(net.node_tensor(1).to_dict()).value],
        "packed.from_numpy": list(tnt.packed.from_numpy(
            np.zeros((3, 2)), np.zeros((2, 2, 3, 2)), np.zeros((2, 3)))),
    }
    for name, tensors in made.items():
        if not all(t.is_cuda for t in tensors):
            raise AssertionError(f"{name} without a device did not use the card")
    if tnt.TensorNetwork.rand_tt(inds, [2, 2, 2], device="cpu").value(0).is_cuda:
        raise AssertionError("rand_tt(device='cpu') must stay on the CPU")
    print(f"default device: ok, {len(made)} constructors on "
          f"{made['rand_tt'][0].device}")


def phase_main_path(zp, ev, dev):
    """The port's main path at d=50, n=32, r=100 in f32 on one card."""
    from tensor_networks_tpu_torch import Index, TensorNetwork, packed
    from tensor_networks_tpu_torch import tt_inner_fast, tt_round_fixed

    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    inds = [Index(f"x{k}", N) for k in range(D)]
    # Middle cores scaled by 1/sqrt(n r) keep the zipper carry O(1) per
    # step.  The end cores set the norm: a train with 32**50 ~ 1e75
    # entries has typical entries ~ norm * 2.5e-38, so a norm of O(1)
    # would put the point values at the bottom of f32's normal range
    # (1.2e-38).  A norm of ~1e12 keeps point values (~1e-26) and
    # squared norms (~1e24) both far inside f32's range.
    end = (1e24 / (N * N * R)) ** 0.25
    trains = []
    for _ in range(2):
        # no device named: the cores land on the card
        tn = TensorNetwork.rand_tt(inds, [R] * (D - 1), dtype=torch.float32,
                                   generator=g)
        if not all(tn.value(k).is_cuda for k in range(D)):
            raise AssertionError("rand_tt without a device did not use the card")
        for k in range(D):
            t = tn.node_tensor(k)
            s = end if k in (0, D - 1) else 1 / math.sqrt(N * R)
            t.update_val_size(t.value * s)
        trains.append(tn)
    a, b = trains
    idx = torch.randint(0, N, (B, D), generator=g, device=dev)
    idx_np = idx.cpu().numpy()

    torch.cuda.synchronize()
    zp.tt_inner_cuda.launches = 0
    zp.tt_inner_cuda.fused = 0
    zp.tt_inner_chain_cuda.launches = 0
    ev.tt_evaluate_cuda.launches = 0
    ev.group_tiles_cuda.launches = 0
    t0 = time.perf_counter()
    pa, pb = packed.pack(a), packed.pack(b)
    ip = packed.inner(pa, pb)
    nrm = packed.norm(pa)
    fast = tt_inner_fast(a, b)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    rounded, ranks = tt_round_fixed(a + a, 1e-3)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    ev_packed = packed.evaluate(pa, idx)
    ev_net = a.evaluate(inds, idx_np)
    ev_round = rounded.evaluate(inds, idx_np)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    launches = {"zipper": zp.tt_inner_cuda.launches,
                "evaluate": ev.tt_evaluate_cuda.launches,
                "tiles": ev.group_tiles_cuda.launches}

    fused = zp.tt_inner_cuda.fused
    launches_chain = zp.tt_inner_chain_cuda.launches
    if launches != {"zipper": 3, "evaluate": 3, "tiles": 3}:
        raise AssertionError(
            "the main path makes 3 inner products and 3 evaluations, each "
            f"with one tile list: {launches}")
    if fused != 3 or launches_chain != 0:
        raise AssertionError(f"{3 - fused} of the 3 inner products missed the fused route")
    device_launches = zp.tt_inner_cuda.last_device_launches
    if device_launches > 2 + 2 * (D - 2):
        raise AssertionError(f"an inner product made {device_launches} launches")
    # f64 plain references on the same cores
    fa, ma, la = _f64(*stack(pa))
    fb, mb, lb = _f64(*stack(pb))
    ref_ab = zp.tt_inner_plain(fa, ma, la, fb, mb, lb).item()
    na = math.sqrt(zp.tt_inner_plain(fa, ma, la, fa, ma, la).item())
    nb = math.sqrt(zp.tt_inner_plain(fb, mb, lb, fb, mb, lb).item())
    for name, val, want, tol in (("inner", ip.item(), ref_ab, 1e-4 * na * nb),
                                 ("tt_inner_fast", fast.item(), ref_ab, 1e-4 * na * nb),
                                 ("norm", nrm.item(), na, 1e-4 * na)):
        if not (math.isfinite(val) and abs(val - want) <= tol):
            raise AssertionError(f"{name}: got {val!r}, want {want!r} +- {tol:.3e}")
    want_ranks = [N] + [R] * (D - 3) + [N]
    if ranks != want_ranks:
        raise AssertionError(f"tt_round_fixed kept ranks {ranks}, want {want_ranks}")
    ev_ref = ev.tt_evaluate_plain(fa, ma, la, idx).cpu().numpy()
    scale = np.abs(ev_ref).max()
    # The same rounding in f64 shows the sweep exact up to roundoff.  The
    # f32 sweep's own roundoff at these points measured ~6e-4 of max|2a|
    # on an H100 (about 8000 f32 eps, as the f64 sweep's ~9e-13 is about
    # 8000 f64 eps), whatever the budget, so the f32 rounding is held to
    # its contract, eps = 1e-3, not to 1e-4.
    a64 = a.__deepcopy__({})
    for k in range(D):
        a64.node_tensor(k).update_val_size(a64.value(k).double())
    rounded64, ranks64 = tt_round_fixed(a64 + a64, 1e-3)
    ev_round64 = rounded64.evaluate(inds, idx_np)
    errs = {
        "packed.evaluate": (np.abs(ev_packed.double().cpu().numpy() - ev_ref).max() / scale, 1e-4),
        "TensorNetwork.evaluate": (np.abs(ev_net - ev_ref).max() / scale, 1e-4),
        "rounded - 2a": (np.abs(ev_round - 2 * ev_ref).max() / (2 * scale), 1e-3),
        "rounded - 2a (f64 sweep)": (np.abs(ev_round64 - 2 * ev_ref).max() / (2 * scale), 1e-10),
    }
    if ranks64 != want_ranks:
        raise AssertionError(f"f64 tt_round_fixed kept ranks {ranks64}, want {want_ranks}")
    for name, (err, tol) in errs.items():
        if not err <= tol:
            raise AssertionError(f"{name}: max err / max|ref| = {err:.3e} > {tol}")
    for arr in (ev_packed.cpu().numpy(), ev_net, ev_round):
        if arr.shape != (B,) or not np.all(np.isfinite(arr)):
            raise AssertionError("evaluation output is not a finite (B,) vector")
    print(
        f"phase 2 main path d={D} n={N} r={R} B={B} f32: ok, launches {launches}, "
        f"inner products on the fused route {fused} of 3, {device_launches} "
        "device launches each, "
        f"<a,b>={ip.item():.6e} |a|={nrm.item():.6e} ranks {ranks[0]},"
        f"{ranks[1]}x{len(ranks) - 2},{ranks[-1]} eval rel err "
        + ", ".join(f"{k} {v[0]:.2e}" for k, v in errs.items())
        + f"; wall s: pack+inner+norm+fast {t1 - t0:.4f}, round(a+a) {t2 - t1:.4f}, "
        f"3 evaluates {t3 - t2:.4f}"
    )
    return dict(launches, chain=launches_chain), pa, idx, (a, inds, idx_np, ev_ref)


def stack(p):
    return p.first, p.mids, p.last


def _bound(flops, nbytes):
    """(ms, "bytes" | "operations"): the least time the card could take."""
    t_ops, t_bytes = flops / FP32_FLOP_PER_S, nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def _inner_bound(a, b):
    """The zipper's bound: W0 = fa^T fb, two GEMMs per core pair, the
    epilogue <W, la lb^T>; every core read once, one scalar written."""
    n0, ra = a[0].shape
    rb = b[0].shape[1]
    d_mid, _, n, _ = a[1].shape
    nl = a[2].shape[1]
    flops = 2 * n0 * ra * rb + d_mid * (2 * rb * n * ra * ra + 2 * ra * rb * rb * n)
    flops += 2 * ra * rb * nl + 2 * ra * rb
    nbytes = sum(x.numel() * x.element_size() for x in a + b) + a[0].element_size()
    return _bound(flops, nbytes)


def _evaluate_bound(cores, idx):
    """The evaluation's bound for these points: B (d-2) r^2 FMAs and the
    final dots; only the slices and end-core rows some point selects are
    read (once), plus the indices; B values written."""
    first, mids, last = cores
    bsz, d = idx.shape
    r = first.shape[1]
    flops = 2 * bsz * (d - 2) * r * r + 2 * bsz * r
    used = [len(torch.unique(idx[:, k])) for k in range(d)]
    item = first.element_size()
    nbytes = item * r * (used[0] + used[-1] + r * sum(used[1:-1]))
    nbytes += idx.numel() * idx.element_size() + bsz * item
    return _bound(flops, nbytes)


def phase_timings(zp, ev, pa, pb_like, idx, launches):
    """Kernel vs plain at the main path's shapes, turns P K K P; the
    grouped evaluation vs the per-point kernel at three batch sizes."""
    a = list(stack(pa))
    b = list(stack(pb_like))
    idx32 = idx.to(torch.int32).contiguous()
    tables = ev.build_group_tables(idx32, a[0].shape[0])
    inner_k = lambda: zp.tt_inner_cuda(*a, *b)  # noqa: E731
    inner_p = lambda: zp.tt_inner_plain(*a, *b)  # noqa: E731
    eval_k = lambda: ev.tt_evaluate_cuda(*a, idx32)  # noqa: E731
    eval_p = lambda: ev.tt_evaluate_plain(*a, idx32)  # noqa: E731
    n = a[0].shape[0]
    vals = torch.sort(idx32[:, 1:-1].t().contiguous(), dim=1, stable=True)[0]
    slots = ev.max_tiles_per_step(idx32.shape[0], n)
    tiles_k = lambda: ev.group_tiles_cuda(vals, n, ev.TILE_P, slots)  # noqa: E731
    tiles_p = lambda: ev.group_tiles_plain(vals, n, ev.TILE_P, slots)  # noqa: E731
    # the tile list does no arithmetic to speak of: sorted rows in, tiles out
    tile_bytes = vals.numel() * 4 + vals.shape[0] * slots * 16
    bounds = {"inner": _inner_bound(a, b), "evaluate": _evaluate_bound(a, idx32),
              "tiles": _bound(0, tile_bytes)}
    res = {}
    for name, k, p in (("inner", inner_k, inner_p), ("evaluate", eval_k, eval_p),
                       ("tiles", tiles_k, tiles_p)):
        tp1, tk1, tk2, tp2 = _time_ms(p), _time_ms(k), _time_ms(k), _time_ms(p)
        err = (k().double() - p().double()).abs().max().item()
        res[name] = {"ms": (tk1 + tk2) / 2, "plain_ms": (tp1 + tp2) / 2,
                     "runs_ms": [tp1, tk1, tk2, tp2], "max_abs_err": err,
                     "bound_ms": bounds[name][0], "bound_by": bounds[name][1]}
    print("phase 3 timings (ms, order plain kernel kernel plain): "
          + "; ".join(f"{k} kernel {v['ms']:.4f} plain {v['plain_ms']:.4f} runs "
                      + ",".join(f"{x:.4f}" for x in v["runs_ms"])
                      for k, v in res.items()))
    for name, key in (("inner", "zipper"), ("evaluate", "evaluate"),
                      ("tiles", "tiles")):
        v = res[name]
        print(f"  {name}: kernel {v['ms']:.4f} ms, plain {v['plain_ms']:.4f} ms, "
              f"bound {v['bound_ms']:.4f} ms by {v['bound_by']} "
              f"({100 * v['bound_ms'] / v['ms']:.1f}% of it reached), "
              f"{launches[key]} launches on the main path, library call: none "
              + ("(no single PyTorch call computes a d-step chain)"
                 if name != "tiles" else "(the plain version is ~25 PyTorch calls)"))
    # the evaluation's parts, and the per-point kernel it replaced (one
    # warp per point, each reading its own slice), turns G O O G
    t_tables = _time_ms(lambda: ev.build_group_tables(idx32, n).tiles)
    t_steps = _time_ms(lambda: ev.tt_evaluate_cuda(*a, idx32, tables))
    print(f"  evaluate parts: grouping tables {t_tables:.4f} ms, kernels with "
          f"tables given {t_steps:.4f} ms "
          f"({100 * res['evaluate']['bound_ms'] / t_steps:.1f}% of the bound)")
    parts, span = _device_us_by_kernel(eval_k)
    busy = sum(us for us, _ in parts.values())
    print("  evaluate, each kernel's share of a call (torch.profiler trace): "
          + ", ".join(f"{k} {us:.1f} us over {c:g} launches" for k, (us, c) in parts.items())
          + f"; busy {busy / 1e3:.4f} ms of a {span / 1e3:.4f} ms span (5 calls, the "
          "gaps between calls included)")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        eval_k()
    print(f"  evaluate: the host enqueues one call in "
          f"{(time.perf_counter() - t0) / 20 * 1e3:.4f} ms")
    torch.cuda.synchronize()
    for bsz in (B, 1000, 300):
        sub = idx32[:bsz].contiguous()
        grouped = lambda: ev.tt_evaluate_cuda(*a, sub)  # noqa: E731
        old = lambda: ev.tt_evaluate_per_point_cuda(*a, sub)  # noqa: E731
        runs = [_time_ms(grouped), _time_ms(old), _time_ms(old), _time_ms(grouped)]
        print(f"  evaluate B={bsz}: grouped {(runs[0] + runs[3]) / 2:.4f} ms, "
              f"per-point {(runs[1] + runs[2]) / 2:.4f} ms, runs "
              + ",".join(f"{x:.4f}" for x in runs))
        if bsz == B:
            res["evaluate"]["per_point_ms"] = (runs[1] + runs[2]) / 2
    return res


def _device_us_by_kernel(fn, calls=5):
    """Each kernel's share of one call of ``fn`` on the device, from a
    torch.profiler trace: {kernel: (us per call, launches per call)} and
    the call's device span in us.  A kernel's share is the time from the
    later of its start and the previous kernel's end to its own end, so
    a programmatic dependent launch, which starts early and waits, is
    charged only for what it adds to the chain, and the gaps where no
    kernel runs are left out (span minus the sum of shares is idle)."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    kernels = sorted((e["ts"], e["ts"] + e["dur"], e["name"])
                     for e in trace["traceEvents"]
                     if e.get("cat") == "kernel" and e.get("ph") == "X")
    keys = ("zip_step", "zip_reduce", "zip_last", "gemm_tn", "reduce_splits",
            "zipper_epilogue", "grouped_step", "grouped_finish", "group_tiles")
    out, prev_end = {}, None
    for start, end, name in kernels:
        key = next((k for k in keys if k in name), name[:40])
        share = end - max(start, prev_end) if prev_end is not None else end - start
        us, count = out.get(key, (0.0, 0.0))
        out[key] = (us + max(share, 0.0) / calls, count + 1 / calls)
        prev_end = end if prev_end is None else max(prev_end, end)
    span = (kernels[-1][1] - kernels[0][0]) / calls if kernels else 0.0
    return out, span


def phase_zipper_routes(zp, a, b, res):
    """H1 at the main shape: the fused route against the chain, turns
    F C C F; the device time of each by kernel (torch.profiler); the host
    time to enqueue one call; then the chain at ranks above the fused
    route's limit (d=50, n=32), where the router sends it."""
    fused = lambda: zp.tt_inner_cuda(*a, *b)  # noqa: E731
    chain = lambda: zp.tt_inner_chain_cuda(*a, *b)  # noqa: E731
    runs = [_time_ms(fused), _time_ms(chain), _time_ms(chain), _time_ms(fused)]
    fused_launches = zp.tt_inner_cuda.last_device_launches
    chain_launches = zp.tt_inner_chain_cuda.last_device_launches
    bound = res["inner"]["bound_ms"]
    ms_f, ms_c = (runs[0] + runs[3]) / 2, (runs[1] + runs[2]) / 2
    print(f"  inner fused vs chain (F C C F): fused {ms_f:.4f} ms, "
          f"{fused_launches} device launches, {100 * bound / ms_f:.1f}% of the "
          f"bound; chain {ms_c:.4f} ms, {chain_launches} device launches, "
          f"{100 * bound / ms_c:.1f}%; runs " + ",".join(f"{x:.4f}" for x in runs))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        fused()
    host_ms = (time.perf_counter() - t0) / 20 * 1e3
    torch.cuda.synchronize()
    for name, fn in (("fused", fused), ("chain", chain)):
        parts, span = _device_us_by_kernel(fn)
        busy = sum(us for us, _ in parts.values())
        print(f"  inner {name}, each kernel's share of a call (torch.profiler "
              "trace, to its end from the previous kernel's end): "
              + ", ".join(f"{k} {us:.1f} us over {c:g} launches"
                          for k, (us, c) in parts.items())
              + f"; busy {busy / 1e3:.4f} ms of a {span / 1e3:.4f} ms span "
              "(5 calls, the gaps between calls included)")
    print(f"  inner fused: the host enqueues one call in {host_ms:.4f} ms")
    g = torch.Generator(device=a[0].device).manual_seed(SEED + 3)
    big = {}
    for ra, rb in ((256, 256), (512, 300)):
        x = list(_train(g, D, N, ra, 1 / math.sqrt(N * ra)))
        y = list(_train(g, D, N, rb, 1 / math.sqrt(N * rb)))
        if zp.takes_fused_route(ra, rb):
            raise AssertionError(f"ranks ({ra}, {rb}) must take the chain")
        k = lambda: zp.tt_inner_cuda(*x, *y)  # noqa: E731
        p = lambda: zp.tt_inner_plain(*x, *y)  # noqa: E731
        t = [_time_ms(p, 5, 1), _time_ms(k, 5, 1), _time_ms(k, 5, 1), _time_ms(p, 5, 1)]
        bnd = _inner_bound(x, y)[0]
        big[(ra, rb)] = (t[1] + t[2]) / 2
        print(f"  inner chain at (r_a, r_b) = ({ra}, {rb}), d={D} n={N}: "
              f"{big[(ra, rb)]:.4f} ms ({zp.tt_inner_cuda.last_device_launches} "
              f"device launches), plain {(t[0] + t[3]) / 2:.4f} ms, bound "
              f"{bnd:.4f} ms ({100 * bnd / big[(ra, rb)]:.1f}%)")
        del x, y
    err = (chain().double() - zp.tt_inner_plain(*a, *b).double()).abs().item()
    return {"ms": ms_c, "plain_ms": res["inner"]["plain_ms"], "max_abs_err": err,
            "bound_ms": bound, "bound_by": res["inner"]["bound_by"]}


def phase_half_timings(zp, ev, dev):
    """H1 (fused and chain) and H2 at the main shape with bf16 and f16
    cores, trains scaled to O(1) (the main path's trains, with |a| ~ 1e12
    and point values ~ 1e-26, do not fit f16): kernel against the plain
    version on the same cores (turns P K K P), the bound with 2 bytes per
    element.  Each row is held to HALF_TOL against the f64 plain result
    on the same cores, twice for the same bits: the inner rows on <a, a>
    (of |a|^2; <a, b> of two independent trains is ~1e-38 and would
    check nothing), the evaluation of max|ref|.  The times are of <a, b>."""
    g = torch.Generator(device=dev).manual_seed(SEED + 8)
    ends = (N * N * R) ** -0.25  # |a| ~ 1
    a64 = _train(g, D, N, R, 1 / math.sqrt(N * R), ends, dtype=torch.float64)
    b64 = _train(g, D, N, R, 1 / math.sqrt(N * R), ends, dtype=torch.float64)
    e64 = _train(g, D, N, R, 1 / math.sqrt(R), dtype=torch.float64)
    idx = _points(g, "random", B, D, N)
    out = {}
    for dt, key in ((torch.bfloat16, "bf16"), (torch.float16, "f16")):
        a, b, e = ([x.to(dt) for x in t] for t in (a64, b64, e64))
        tol = HALF_TOL[dt]
        aa = zp.tt_inner_plain(*_f64(*a), *_f64(*a)).item()
        eref = ev.tt_evaluate_plain(*_f64(*e), idx)
        emax = eref.abs().max().item()
        rows = {}
        for name, k, p, check, bound in (
                ("inner", lambda: zp.tt_inner_cuda(*a, *b),
                 lambda: zp.tt_inner_plain(*a, *b),
                 lambda: _check_inner(zp, zp.tt_inner_cuda, a + a, aa, aa, tol,
                                      f"inner {key} main shape") * tol * aa,
                 _inner_bound(a, b)),
                ("chain", lambda: zp.tt_inner_chain_cuda(*a, *b),
                 lambda: zp.tt_inner_plain(*a, *b),
                 lambda: _check_inner(zp, zp.tt_inner_chain_cuda, a + a, aa, aa, tol,
                                      f"chain {key} main shape") * tol * aa,
                 _inner_bound(a, b)),
                ("evaluate", lambda: ev.tt_evaluate_cuda(*e, idx),
                 lambda: ev.tt_evaluate_plain(*e, idx),
                 lambda: _check_eval(ev, e, idx, eref, tol,
                                     f"evaluate {key} main shape") * tol * emax,
                 _evaluate_bound(e, idx))):
            runs = [_time_ms(p), _time_ms(k), _time_ms(k), _time_ms(p)]
            err = check()
            scale = aa if name != "evaluate" else emax
            rows[name] = {"ms": (runs[1] + runs[2]) / 2,
                          "plain_ms": (runs[0] + runs[3]) / 2,
                          "max_abs_err": err, "rel_err": err / scale,
                          "bound_ms": bound[0], "bound_by": bound[1]}
        rows["inner"]["device_launches"] = zp.tt_inner_cuda.last_device_launches
        out[key] = rows
        print(f"  {key} at d={D} n={N} r={R} (trains O(1), B={B}): "
              + "; ".join(f"{n} kernel {v['ms']:.4f} ms, plain {v['plain_ms']:.4f} ms, "
                          f"bound {v['bound_ms']:.4f} ms by {v['bound_by']}, "
                          f"max abs err {v['max_abs_err']:.3e} "
                          f"({v['rel_err']:.2e} of {'|a|^2' if n != 'evaluate' else 'max|ref|'}"
                          f", tolerance {tol:g})"
                          for n, v in rows.items()))
    return out


ROUND_METHODS = ("svd", "gram", "cholqr2", "twosided", "prefix")


def _device_profile(fn):
    """One call of ``fn`` under torch.profiler (CUDA activity): fn's
    result, the device-busy ms (the union of its kernels' and copies'
    intervals), the kernel count, and the three kernels with the most
    device time [(name, ms, launches)].  Read from the raw events: a
    TT-GMRES solve launches 1e4-1e5 kernels, too many to write and parse
    a chrome trace."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    spans = sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                   for e in prof.profiler.kineto_results.events()
                   if e.device_type() == torch.autograd.DeviceType.CUDA)
    busy, end = 0, None
    per_kernel = {}
    for s0, s1, name in spans:
        if end is None or s0 >= end:
            busy, end = busy + s1 - s0, s1
        elif s1 > end:
            busy, end = busy + s1 - end, s1
        if not name.startswith(("Memcpy", "Memset")):
            ns, count = per_kernel.get(name, (0, 0))
            per_kernel[name] = (ns + s1 - s0, count + 1)
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:3]
    kernels = sum(c for _, c in per_kernel.values())
    return out, busy / 1e6, kernels, [(name[:60], ns / 1e6, c) for name, (ns, c) in top]


def _host_syncs(fn):
    """How many times one call of ``fn`` makes the host wait for the card
    (``torch.cuda.set_sync_debug_mode``); returns (syncs, fn's result)."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in rec), out


def _svd_drivers(a, dev):
    """torch.linalg.svd with each cuSOLVER driver on the svd sweep's
    R factors: (100, 100) from a middle core of ``a``, (200, 200) from one
    of ``a + a`` (rank 100, as the sweep's factors of a doubled train)."""
    core = a.value(D // 2)
    mats = {100: torch.linalg.qr(core.reshape(R * N, R))[1]}
    core2 = torch.cat([core, core], dim=2)
    mats[200] = torch.linalg.qr(torch.cat([core2, core2], dim=0).reshape(2 * R * N, 2 * R))[1]
    out = {}
    for size, m in mats.items():
        ref = torch.linalg.svdvals(m.double())
        for driver in (None, "gesvd", "gesvdj", "gesvda"):
            fn = lambda: torch.linalg.svd(m, full_matrices=False, driver=driver)  # noqa: E731
            fn()
            torch.cuda.synchronize()
            runs = []
            for _ in range(7):
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                runs.append((time.perf_counter() - t0) * 1e3)
            err = (fn()[1].double() - ref).abs().max().item() / ref[0].item()
            out[f"{size} {driver or 'default'}"] = (float(np.median(runs)), err)
    print("  svd drivers on the sweep's R factors (f32, median of 7 calls, ms; "
          "max |s - s_f64| / s_max): "
          + "; ".join(f"({k.split()[0]}, {k.split()[0]}) {k.split()[1]} {ms:.4f} ({err:.1e})"
                      for k, (ms, err) in out.items()))
    return out


def _d12_train(tensor_network, inds, dev):
    """A d=12, n=32, r=100 f64 train and B points, from
    ``default_rng(SEED + 9)``: the cores in order (the middle ones scaled
    by 1/sqrt(n r)), then the (B, d) points."""
    d = len(inds)
    rng = np.random.default_rng(SEED + 9)
    t = tensor_network.rand_tt(inds, [R] * (d - 1), dtype=torch.float64, device=dev)
    for k in range(d):
        v = rng.standard_normal(tuple(t.value(k).shape))
        if 0 < k < d - 1:
            v /= math.sqrt(N * R)
        t.node_tensor(k).update_val_size(torch.from_numpy(v).to(dev))
    return t, rng.integers(0, N, (B, d))


def phase_rounding(a, inds, idx_np, ev_ref, dev):
    """Every tt_round_fixed method at full width: ``a + a`` of the main
    path's train (d=50, n=32, r=100, f32) at eps = 1e-3.  Each must keep
    the structural ranks [32, 100 x 47, 32] and hold the rounded train to
    2a at the main path's 8192 points within 5e-3 max|ref| (an f64 plain
    evaluation of a).  Reports the wall time (median of 5 calls after 2
    warm-ups, synchronised), one call's device-busy time, kernel count and
    largest kernels (torch.profiler), and the host syncs of one call.
    Then, at d=12 in f64 and eps = 1e-9, each method for correctness
    only: the structural ranks and 1e-8 of max|2a| at the points; gram,
    whose f64 floor (~6e-8) lies above 1e-9, keeps ghost ranks there as
    the JAX package's does, so it is held to ranks within the doubled
    train's and checked again at eps = 1e-6 for the structural ranks.
    Floor warnings (the Gram methods' at eps = 1e-3 in f32) are printed,
    not fatal."""
    import warnings

    from tensor_networks_tpu_torch import TensorNetwork, packed, tt_round_fixed
    from tensor_networks_tpu_torch.kernels import evaluate as ev
    from tensor_networks_tpu_torch.ops import fast

    s = a + a
    want = [N] + [R] * (D - 3) + [N]
    scale = 2 * np.abs(ev_ref).max()
    rows = {}
    print(f"phase 4 rounding a + a, d={D} n={N} r={R} f32, eps 1e-3, "
          f"{len(idx_np)} points:")
    for method in ROUND_METHODS:
        call = lambda: tt_round_fixed(s, 1e-3, method=method)  # noqa: E731
        fallbacks = fast.ROUND_STATS["fallback_nan"]
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            for _ in range(2):
                rounded, ranks = call()
        fallbacks = fast.ROUND_STATS["fallback_nan"] - fallbacks
        for w in {str(w.message) for w in rec}:
            print(f"  {method} warns: {w}")
        if ranks != want:
            raise AssertionError(f"{method} kept ranks {ranks}, want {want}")
        err = np.abs(rounded.evaluate(inds, idx_np) - 2 * ev_ref).max() / scale
        if not err <= 5e-3:
            raise AssertionError(f"{method}: max err / max|2a| = {err:.3e} > 5e-3")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            runs = []
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                call()
                torch.cuda.synchronize()
                runs.append(time.perf_counter() - t0)
            _, busy, kernels, top = _device_profile(call)
            syncs, _ = _host_syncs(call)
        rows[method] = {"wall_ms": 1e3 * float(np.median(runs)), "busy_ms": busy,
                        "kernels": kernels, "syncs": syncs, "err": float(err),
                        "fallbacks": fallbacks, "top": top}
        print(f"  {method}: ranks ok, err {err:.3e} of max|2a|, wall "
              f"{rows[method]['wall_ms']:.3f} ms (median of 5; runs "
              + ",".join(f"{1e3 * x:.3f}" for x in runs)
              + f"), device busy {busy:.3f} ms over {kernels} kernels, "
              f"{syncs} host syncs, {fallbacks} of 2 warm-ups fell back to svd; largest: "
              + "; ".join(f"{n} {ms:.3f} ms x{c}" for n, ms, c in top))
    rows["svd_drivers"] = _svd_drivers(a, dev)

    # d=12, f64: correctness only, on a train made with NumPy so that the
    # CPU tests can round the same one through the JAX package
    # (tests/test_torch_round.py::test_gram_keeps_ghost_ranks_below_its_floor_as_jax_does)
    from tensor_networks_tpu_torch import Index

    d12 = 12
    inds12 = [Index(f"y{k}", N) for k in range(d12)]
    t12, pts = _d12_train(TensorNetwork, inds12, dev)
    ref12 = 2 * ev.tt_evaluate_plain(*stack(packed.pack(t12)),
                                     torch.from_numpy(pts).to(dev)).cpu().numpy()
    want12 = [N] + [R] * (d12 - 3) + [N]
    errs = {}
    for method, eps in [(m, 1e-9) for m in ROUND_METHODS] + [("gram", 1e-6)]:
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            rounded, ranks = tt_round_fixed(t12 + t12, eps, method=method)
        for w in {str(w.message) for w in rec}:
            print(f"  {method} warns (d=12 f64, eps {eps:g}): {w}")
        if method == "gram" and eps < 6e-8:
            # below gram's f64 floor (4 sqrt(mach eps) ~ 6e-8, its warning)
            # the Gram eigenvalues' roundoff keeps ghost directions, in
            # the JAX package too: ranks between the structural ones and
            # the doubled train's, the error as small
            ok = (ranks[0] == ranks[-1] == N
                  and all(R <= k <= 2 * R for k in ranks[1:-1]))
            print(f"  gram at eps {eps:g}, below its floor, kept ranks {ranks}")
        else:
            ok = ranks == want12
        if not ok:
            raise AssertionError(f"{method} d=12 f64 eps {eps:g} kept ranks {ranks}")
        err = np.abs(rounded.evaluate(inds12, pts) - ref12).max() / np.abs(ref12).max()
        errs[f"{method} {eps:g}"] = err
        if not err <= 1e-8:
            raise AssertionError(f"{method} d=12 f64 eps {eps:g}: max err / max|2a| = {err:.3e}")
    print(f"  d={d12} f64 a + a: ranks ok for every method (structural, but gram "
          "at 1e-9), max err / max|2a| " + ", ".join(f"{m} {e:.2e}" for m, e in errs.items()))
    print(json.dumps({"rounding": rows}))
    return rows


# -- phase 5: cross approximation on the card -------------------------------

CROSS_D, CROSS_N, CROSS_R = 8, 32, 24  # the JAX package's cross_device leg
FP64_TC_FLOP_PER_S = 67e12  # H100 SXM, FP64 tensor cores, published
FP64_FMA_FLOP_PER_S = 34e12  # H100 SXM, FP64 outside the tensor cores


def _ackley(cross_mod):
    """The Ackley function of ``tests/test_cross.py`` as a CachedFunc."""

    class Ackley(cross_mod.CachedFunc):
        def _run(self, args):
            y1 = -20 * np.exp(-0.2 * np.sqrt(np.sum(args**2, axis=1) / args.shape[1]))
            y2 = -np.exp(np.sum(np.cos(2 * np.pi * args), axis=1) / args.shape[1])
            return y1 + y2 + 20 + np.exp(1.0)

    return Ackley


def _split_cross(engine, func, net, eps, sync):
    """Run ``engine.cross(net, eps=eps)`` with its parts timed on the
    host's clock: the fiber requests (point assembly, the target's
    CachedFunc bookkeeping and its evaluation), within them and in the
    validation reference the target's evaluation alone, the pivot
    choice, the convergence check, and the rest (copies of the
    iterate, core installs, rank growth).  Returns (result, wall s,
    {part: s}, [target batch sizes], the largest target batch)."""
    parts = {"fibers": 0.0, "target evaluation": 0.0, "pivots": 0.0, "check": 0.0}
    batches, largest = [], [np.empty((0, 0))]

    def keep(args):
        batches.append(len(args[0]))
        if len(args[0]) > len(largest[0]):
            largest[0] = np.asarray(args[0])

    def timed(key, fn, note=None):
        def wrapper(*args):
            t0 = time.perf_counter()
            out = fn(*args)
            parts[key] += time.perf_counter() - t0
            if note is not None:
                note(args)
            return out
        return wrapper

    engine._eval_fibers = timed("fibers", engine._eval_fibers)
    engine._pick = timed("pivots", engine._pick)
    engine._error = timed("check", engine._error)
    func._run = timed("target evaluation", func._run, keep)
    sync()
    t0 = time.perf_counter()
    res = engine.cross(net, eps=eps)
    sync()
    wall = time.perf_counter() - t0
    parts["rest"] = wall - parts["fibers"] - parts["pivots"] - parts["check"]
    return res, wall, parts, batches, largest[0]


def _rel_err(got, ref):
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


def _reset_evaluate_counts(ev):
    ev.tt_evaluate_cuda.launches = 0
    ev.tt_evaluate_cuda.launches_by_dtype = dict.fromkeys(
        ev.tt_evaluate_cuda.launches_by_dtype, 0)
    ev.group_tiles_cuda.launches = 0


def _cross_target(rank, seed, dev):
    """The ``cross_device`` target: a d=8, n=32 TT of ``rank``, f32 cores
    scaled by 1/sqrt(rank), on ``dev``; with its copy on the CPU."""
    from tensor_networks_tpu_torch import Index, TensorNetwork

    g = torch.Generator(device=dev).manual_seed(seed)
    t_inds = [Index(f"t{k}", CROSS_N) for k in range(CROSS_D)]
    target = TensorNetwork.rand_tt(t_inds, [rank] * (CROSS_D - 1),
                                   dtype=torch.float32, device=dev, generator=g)
    for k in range(CROSS_D):
        t = target.node_tensor(k)
        t.update_val_size(t.value / math.sqrt(rank))
    target_cpu = TensorNetwork.from_separated_dict(*target.to_separated_dict(),
                                                   device="cpu")
    return target, target_cpu, t_inds


def _check_f64_evaluation(target, target_cpu, t_inds, pts, what):
    """H2's float64 instantiation (the chain on the card, ``precision="dw"``)
    against the plain float64 evaluation of the same cores on the CPU,
    to 1e-12 of max|ref|; returns that ratio."""
    got = target.evaluate(t_inds, pts, precision="dw")
    ref = target_cpu.evaluate(t_inds, pts, precision="dw")
    err = float(np.abs(got - ref).max() / np.abs(ref).max())
    if not err <= 1e-12:
        raise AssertionError(f"H2 f64 at {what}: {err:.3e} of max|ref| > 1e-12")
    return err


def _cross_device_leg(ev, target, t_inds, device, grid, real, kickrank=4, max_iters=8):
    """The JAX package's ``cross_device`` leg on ``device``: a
    FuncTensorNetwork target sampled in float64 (``precision="dw"``),
    kickrank 4, VALID_ERROR on 2000 points, max_iters 8, eps 1e-8, the
    pivot generator seeded by ``np.random.seed(SEED)``.  The error is
    measured against ``real``, the target's values at ``grid`` from the
    plain float64 evaluation on the CPU.  The launch counts are read
    just after the cross; the largest target batch is kept."""
    from tensor_networks_tpu_torch import TensorNetwork, cross

    func = cross.FuncTensorNetwork(t_inds, target, precision="dw")
    gen = torch.Generator(device=device).manual_seed(SEED + 12)
    net = TensorNetwork.rand_tt(t_inds, [1] * (CROSS_D - 1), device=device,
                                generator=gen)
    np.random.seed(SEED)
    engine = cross.CrossApproximation(func, cross.CrossConfig(
        kickrank=kickrank, convergence=cross.ConvergenceCheck.VALID_ERROR,
        validation_size=2000, max_iters=max_iters))
    on_card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    res, wall, parts, batches, largest = _split_cross(engine, func, net, 1e-8, sync)
    launches = {"evaluate": ev.tt_evaluate_cuda.launches,
                "by_dtype": {k: v for k, v in ev.tt_evaluate_cuda.launches_by_dtype.items() if v},
                "tiles": ev.group_tiles_cuda.launches}
    err_dw = _rel_err(res.net.evaluate(t_inds, grid, precision="dw"), real)
    return {"wall_s": wall, "evals": func.num_calls(), "ranks": res.net.ranks(),
            "err_dw": err_dw, "parts": parts, "batches": batches,
            "largest_batch": largest.astype(int), "net": res.net,
            "sweeps": len(res.ranks_and_errors), "launches": launches}


def phase_cross(ev, dev):
    """Cross approximation on the card, with counts reset just before
    the ``cross_device`` run and read just after; the same cross on the
    CPU; the leg above the maxvol gate (target rank 48), with its own
    counts; then the JAX package's ``cross_host`` leg (VALID_ERROR and
    NORM), HT and Tucker."""
    import copy
    import importlib

    from tensor_networks_tpu_torch import Index, TensorNetwork, cross

    mv = importlib.import_module("tensor_networks_tpu_torch.cross.maxvol")
    target, target_cpu, t_inds = _cross_target(CROSS_R, SEED + 11, dev)
    grid = np.random.default_rng(11).integers(0, CROSS_N, (4096, CROSS_D))
    # the reference: the plain f64 evaluation on the CPU, not H2
    real = target_cpu.evaluate(t_inds, grid, precision="dw")
    f64_errs = {"target": _check_f64_evaluation(target, target_cpu, t_inds, grid,
                                                "the target, 4096 points")}

    torch.cuda.synchronize()
    _reset_evaluate_counts(ev)
    card = _cross_device_leg(ev, target, t_inds, dev, grid, real)
    launches = card["launches"]  # read just after the cross
    if launches["by_dtype"].get("f64", 0) == 0 or launches["tiles"] == 0:
        raise AssertionError(f"the cross's fibers missed H2's f64 kernel: {launches}")
    # H2 f64 on the cross's own largest fiber batch
    f64_errs["largest fiber batch"] = _check_f64_evaluation(
        target, target_cpu, t_inds, card["largest_batch"], "the largest fiber batch")
    # the model evaluated by a plain f32 evaluate (H2's f32 instantiation)
    net32 = copy.deepcopy(card["net"])
    for n in net32.network.nodes:
        net32.node_tensor(n).update_val_size(net32.value(n).float())
    err32 = _rel_err(net32.evaluate(t_inds, grid), real)
    # the same cross on the CPU, the target copied there
    host = _cross_device_leg(ev, target_cpu, t_inds, "cpu", grid, real)
    for name, leg in (("card", card), ("cpu", host)):
        if not leg["err_dw"] <= 1e-6:
            raise AssertionError(f"cross_device on the {name}: error {leg['err_dw']:.3e} > 1e-6")
    fiber_b = max(card["batches"])
    print(f"phase 5 cross_device d={CROSS_D} n={CROSS_N} target rank {CROSS_R} f32 "
          f"(dw fibers, kickrank 4, VALID_ERROR 2000, max_iters 8, eps 1e-8): ok; card: "
          f"wall {card['wall_s']:.4f} s, {card['sweeps']} sweeps, {card['evals']} unique "
          f"evaluations, ranks {card['ranks']}, error at 4096 points {card['err_dw']:.3e} "
          f"(f64) {err32:.3e} (f32 evaluate of the model), against the plain f64 "
          f"evaluation on the CPU; H2 launches {launches}; H2 f64 against that plain "
          "version (max err / max|ref|): " + ", ".join(f"{k} {v:.3e}" for k, v in f64_errs.items())
          + "; wall split s: " + ", ".join(f"{k} {v:.4f}" for k, v in card["parts"].items())
          + f"; largest target batch {fiber_b}; cpu: wall {host['wall_s']:.4f} s, "
          f"{host['evals']} unique evaluations, ranks {host['ranks']}, error "
          f"{host['err_dw']:.3e}, split s: "
          + ", ".join(f"{k} {v:.4f}" for k, v in host["parts"].items()))
    out = {"cross_device": {
        "wall_s": card["wall_s"], "evals": card["evals"], "sweeps": card["sweeps"],
        "ranks": card["ranks"], "err_f64": card["err_dw"], "err_f32_eval": err32,
        "launches": launches, "split_s": card["parts"], "fiber_batch": fiber_b,
        "h2_f64_vs_plain": f64_errs,
        "cpu": {"wall_s": host["wall_s"], "evals": host["evals"],
                "err_f64": host["err_dw"], "ranks": host["ranks"]}}}

    # above the maxvol gate: target rank 48, so the fibers (32 r, r)
    # reach 76,832 entries and take maxvol_device on the card
    target48, target48_cpu, _ = _cross_target(48, SEED + 17, dev)
    real48 = target48_cpu.evaluate(t_inds, grid, precision="dw")
    sizes, real_device = [], mv.maxvol_device

    def counted(a, *args):
        sizes.append(a.numel())
        return real_device(a, *args)

    mv.maxvol_device = counted
    try:
        torch.cuda.synchronize()
        _reset_evaluate_counts(ev)
        big = _cross_device_leg(ev, target48, t_inds, dev, grid, real48,
                                kickrank=8, max_iters=10)
    finally:
        mv.maxvol_device = real_device
    if (not big["err_dw"] <= 1e-6 or not sizes
            or big["launches"]["by_dtype"].get("f64", 0) == 0):
        raise AssertionError(f"cross_device above the gate: error {big['err_dw']:.3e}, "
                             f"{len(sizes)} maxvol_device calls, launches {big['launches']}")
    gate_err = _check_f64_evaluation(target48, target48_cpu, t_inds, big["largest_batch"],
                                     "the rank-48 cross's largest fiber batch")
    out["cross_device_gate"] = {
        "wall_s": big["wall_s"], "evals": big["evals"], "sweeps": big["sweeps"],
        "ranks": big["ranks"], "err_f64": big["err_dw"], "launches": big["launches"],
        "split_s": big["parts"], "maxvol_device_calls": len(sizes),
        "maxvol_device_entries": [min(sizes), max(sizes)], "h2_f64_vs_plain": gate_err}
    print(f"  cross_device above the maxvol gate ({mv._DEVICE_SIZE_THRESHOLD} entries): "
          f"target rank 48, kickrank 8, max_iters 10: ok, wall {big['wall_s']:.4f} s, "
          f"{big['sweeps']} sweeps, {big['evals']} unique evaluations, ranks {big['ranks']}, "
          f"error {big['err_dw']:.3e}; {len(sizes)} fibers through maxvol_device "
          f"({min(sizes)}-{max(sizes)} entries); H2 launches {big['launches']}; H2 f64 on the "
          f"largest fiber batch {gate_err:.3e} of max|ref|; split s: "
          + ", ".join(f"{k} {v:.4f}" for k, v in big["parts"].items()))

    # cross_host: Ackley d=8 on linspace(-2, 2, 16), the network on the card
    Ackley = _ackley(cross)
    c_inds = [Index(f"c{k}", 16, tuple(np.linspace(-2.0, 2.0, 16))) for k in range(8)]
    grid = np.random.default_rng(5).integers(0, 16, (4096, 8))
    for check, extra in (("VALID_ERROR", {"validation_size": 2000}),
                         ("NORM", {"max_iters": 30})):
        np.random.seed(7)
        func = Ackley(c_inds)
        net = TensorNetwork.rand_tt(c_inds, [1] * 7)
        engine = cross.CrossApproximation(func, cross.CrossConfig(
            kickrank=2, convergence=getattr(cross.ConvergenceCheck, check), **extra))
        res, wall, parts, _, _ = _split_cross(engine, func, net, 1e-4,
                                              torch.cuda.synchronize)
        err = _rel_err(res.net.evaluate(func.indices, grid), func(grid))
        if not err <= 1e-4 or not all(res.net.value(k).is_cuda for k in range(8)):
            raise AssertionError(f"cross_host {check}: error {err:.3e} > 1e-4, or off the card")
        out[f"cross_host_{check.lower()}"] = {
            "wall_s": wall, "evals": func.num_calls(), "ranks": res.net.ranks(),
            "err": err, "split_s": parts}
        print(f"  cross_host d=8 n=16 Ackley, kickrank 2, {check}, eps 1e-4: ok, wall "
              f"{wall:.4f} s, {func.num_calls()} unique evaluations, ranks "
              f"{res.net.ranks()}, error at 4096 points {err:.3e}; split s: "
              + ", ".join(f"{k} {v:.4f}" for k, v in parts.items()))

    # HT and Tucker through the runners, on the card by default
    inds4 = [Index(c, s, tuple(np.linspace(-32.768, 32.768, s)))
             for c, s in (("i", 8), ("j", 10), ("k", 12), ("l", 20))]
    grid4 = np.stack(np.meshgrid(*[range(i.size) for i in inds4]), -1).reshape(-1, 4)
    for runner in (cross.HTCrossRunner(), cross.TuckerCrossRunner()):
        np.random.seed(4)
        func = Ackley(inds4)
        t0 = time.perf_counter()
        net = runner.run(func, eps=1e-4)
        wall = time.perf_counter() - t0
        err = _rel_err(net.evaluate(func.indices, grid4), func(grid4))
        if not err <= 1e-4 or not all(net.value(n).is_cuda for n in net.network.nodes):
            raise AssertionError(f"{runner.ansatz} cross: error {err:.3e} > 1e-4, or off the card")
        out[f"cross_{runner.ansatz}"] = {"wall_s": wall, "evals": func.num_calls(), "err": err}
        print(f"  {runner.ansatz} cross of Ackley on (8, 10, 12, 20), eps 1e-4: ok, wall "
              f"{wall:.4f} s, {func.num_calls()} unique evaluations, error on the full "
              f"grid {err:.3e}")
    return out, launches, target


def _ensemble_trains(g, e, dtype):
    return [_train(g, CROSS_D, CROSS_N, 32, 1 / math.sqrt(32), dtype=dtype) for _ in range(e)]


def phase_cross_kernels(ev, dev, pa, idx):
    """The kernels on the slice's new call shapes against their plain
    versions, each twice for the same bits: evaluate_ensemble (64 trains
    at d=8, n=32, r=32, 64 points each; f32 and f64), tt_evaluate_fast
    (forward, and its gradient against autograd of the plain evaluator),
    evaluate_dw at the main shape, and maxvol_device against the host
    loop."""
    import importlib

    from tensor_networks_tpu_torch import packed

    mv = importlib.import_module("tensor_networks_tpu_torch.cross.maxvol")
    g = torch.Generator(device=dev).manual_seed(SEED + 13)
    tol = {torch.float32: 1e-4, torch.float64: 1e-10}
    worst, checks = {}, 0

    def note(key, err, limit, what):
        nonlocal checks
        if not err <= limit:
            raise AssertionError(f"{what}: relative error {err:.3e} > {limit}")
        worst[key] = max(worst.get(key, 0.0), err / limit)
        checks += 1

    def same_bits(fn, what):
        a, b = fn(), fn()
        if not all(torch.equal(x, y) for x, y in zip(a, b)):
            raise AssertionError(f"{what}: two calls differ")
        return a

    pts = torch.randint(0, CROSS_N, (64, 64, CROSS_D), generator=g, device=dev)
    for dt in (torch.float32, torch.float64):
        trains = [packed.PackedTT(*t) for t in _ensemble_trains(g, 64, dt)]
        (got,) = same_bits(lambda: (packed.evaluate_ensemble(trains, pts),),
                           f"evaluate_ensemble {dt}")
        ref = torch.stack([ev.tt_evaluate_plain(*_f64(*t), pts[e])
                           for e, t in enumerate(trains)])
        note("ensemble", ((got.double() - ref).abs().max() / ref.abs().max()).item(),
             tol[dt], f"evaluate_ensemble {dt}")
        cores = [x.requires_grad_(True) for x in _f64(*trains[0])]
        ref_fwd = ev.tt_evaluate_plain(*cores, pts[0])
        ref_grads = torch.autograd.grad(ref_fwd.sum(), cores)
        base = [x.detach().to(dt) for x in cores]

        def fast():
            c = [x.clone().requires_grad_(True) for x in base]
            out = packed.tt_evaluate_fast(*c, pts[0])
            return (out.detach(),) + torch.autograd.grad(out.sum(), c)

        fwd, *grads = same_bits(fast, f"tt_evaluate_fast {dt}")
        note("tt_evaluate_fast", ((fwd.double() - ref_fwd).abs().max()
                                  / ref_fwd.abs().max()).item(), tol[dt],
             f"tt_evaluate_fast forward {dt}")
        for x, y in zip(grads, ref_grads):
            note("tt_evaluate_fast", ((x.double() - y).abs().max() / y.abs().max()).item(),
                 tol[dt], f"tt_evaluate_fast gradient {dt}")
    (got,) = same_bits(lambda: (torch.from_numpy(packed.evaluate_dw(pa, idx)),),
                       "evaluate_dw")
    ref = ev.tt_evaluate_plain(*_f64(*stack(pa)), idx).cpu()
    note("evaluate_dw", ((got - ref).abs().max() / ref.abs().max()).item(), 1e-12,
         "evaluate_dw at the main shape")
    rng = np.random.default_rng(SEED + 14)
    mats = {}
    for n, r in ((768, 24), (3200, 100), (12800, 200)):
        a = np.linalg.qr(rng.standard_normal((n, r)))[0]
        mats[(n, r)] = a
        rows_h, _ = mv.maxvol(a)
        rows, b = same_bits(lambda: mv.maxvol_device(torch.from_numpy(a).to(dev)),
                            f"maxvol_device ({n}, {r})")
        rows, b = rows.cpu().numpy(), b.cpu().numpy()
        if not np.abs(b).max() <= 1.05 + 1e-8 or len(set(rows)) != r:
            raise AssertionError(f"maxvol_device ({n}, {r}): max|B| {np.abs(b).max():.4f}")
        note("maxvol", np.abs(b @ a[rows] - a).max(), 1e-10,
             f"maxvol_device ({n}, {r}) interpolation")
        ld_d = np.linalg.slogdet(a[rows])[1]
        ld_h = np.linalg.slogdet(a[rows_h])[1]
        note("maxvol det", abs(math.expm1(ld_d - ld_h)), 0.01,
             f"maxvol_device ({n}, {r}) |det| against the host's")
        print(f"  maxvol ({n}, {r}): device rows {'equal' if np.array_equal(np.sort(rows), np.sort(rows_h)) else 'differ from'} the host's, "
              f"log|det| device {ld_d:.6f} host {ld_h:.6f}, max|B| {np.abs(b).max():.4f}")
    torch.cuda.synchronize()
    print(f"phase 5 kernels on the cross's shapes: ok, {checks} checks (each twice, "
          "bit-identical), worst err/tol " + ", ".join(f"{k} {v:.3g}" for k, v in worst.items()))
    return mats


def _host_ms(fn, reps):
    """Median ms of ``reps`` synchronised calls on the host's clock."""
    runs = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        runs.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(runs)), runs


def phase_cross_timings(ev, dev, pa, idx, target, fiber_b, mats):
    """H2 in float64 at the main shape and at the cross's fiber shape,
    evaluate_ensemble against 64 separate calls, and host maxvol against
    maxvol_device.  Bounds: float64 operations over the FP64 tensor-core
    peak (67 TFLOP/s), with the FMA rate (34 TFLOP/s) printed beside."""
    import importlib

    from tensor_networks_tpu_torch import packed

    mv = importlib.import_module("tensor_networks_tpu_torch.cross.maxvol")
    g = torch.Generator(device=dev).manual_seed(SEED + 15)
    rows = {}
    idx32 = idx.to(torch.int32).contiguous()
    p64 = packed.pack_ragged(target, torch.float64)
    fidx = torch.randint(0, CROSS_N, (fiber_b, CROSS_D), generator=g, device=dev,
                         dtype=torch.int32)
    for key, cores, pts in (("f64", _f64(*stack(pa)), idx32),
                            ("f64_cross", list(stack(p64)), fidx)):
        k = lambda: ev.tt_evaluate_cuda(*cores, pts)  # noqa: E731
        p = lambda: ev.tt_evaluate_plain(*cores, pts)  # noqa: E731
        runs = [_time_ms(p), _time_ms(k), _time_ms(k), _time_ms(p)]
        ref = p()
        err = (k() - ref).abs().max().item()
        bound, by = _evaluate_bound(cores, pts)
        fma_ms = bound * FP32_FLOP_PER_S / FP64_FMA_FLOP_PER_S if by == "operations" else bound
        rows[key] = {"ms": (runs[1] + runs[2]) / 2, "plain_ms": (runs[0] + runs[3]) / 2,
                     "max_abs_err": err, "rel_err": err / ref.abs().max().item(),
                     "bound_ms": bound, "bound_by": by}
        if not rows[key]["rel_err"] <= 1e-12:
            raise AssertionError(f"H2 f64 {key}: {rows[key]['rel_err']:.3e} of max|ref| "
                                 "> 1e-12 against the plain version")
        b, d = pts.shape
        print(f"  H2 f64 d={d} n={cores[0].shape[0]} r={cores[0].shape[1]} B={b}: kernel "
              f"{rows[key]['ms']:.4f} ms, plain {rows[key]['plain_ms']:.4f} ms, bound "
              f"{bound:.4f} ms by {by} at 67 TFLOP/s ({100 * bound / rows[key]['ms']:.1f}% "
              f"of it reached; {fma_ms:.4f} ms at the 34 TFLOP/s FMA rate), max rel err "
              f"{rows[key]['rel_err']:.2e}; runs " + ",".join(f"{x:.4f}" for x in runs))
    pts = torch.randint(0, CROSS_N, (64, 64, CROSS_D), generator=g, device=dev)
    for dt, key in ((torch.float32, "f32"), (torch.float64, "f64")):
        trains = [packed.PackedTT(*t) for t in _ensemble_trains(g, 64, dt)]
        e = len(trains)
        one = lambda: packed.evaluate_ensemble(trains, pts)  # noqa: E731
        many = lambda: torch.stack([packed.evaluate(t, pts[i])  # noqa: E731
                                    for i, t in enumerate(trains)])
        folded = (torch.stack([t.first for t in trains]).reshape(e * CROSS_N, 32),
                  torch.stack([t.mids for t in trains], dim=2).reshape(CROSS_D - 2, 32, e * CROSS_N, 32),
                  torch.stack([t.last for t in trains], dim=1).reshape(32, e * CROSS_N))
        fidx = (pts + torch.arange(e, device=dev)[:, None, None] * CROSS_N).reshape(-1, CROSS_D)
        plain = lambda: ev.tt_evaluate_plain(*folded, fidx)  # noqa: E731
        runs = [_time_ms(plain), _time_ms(one), _time_ms(many), _time_ms(many),
                _time_ms(one), _time_ms(plain)]
        bound, by = _evaluate_bound(list(folded), fidx)
        err = (one().double() - many().double()).abs().max().item()
        rows[f"ensemble_{key}"] = {"ms": (runs[1] + runs[4]) / 2,
                                   "separate_ms": (runs[2] + runs[3]) / 2,
                                   "plain_ms": (runs[0] + runs[5]) / 2, "max_abs_err": err,
                                   "bound_ms": bound, "bound_by": by}
        r_ = rows[f"ensemble_{key}"]
        print(f"  evaluate_ensemble {key}, 64 trains d={CROSS_D} n={CROSS_N} r=32, 64 points "
              f"each: one call {r_['ms']:.4f} ms, 64 packed.evaluate calls "
              f"{r_['separate_ms']:.4f} ms, plain (folded) {r_['plain_ms']:.4f} ms, bound "
              f"{bound:.4f} ms by {by} ({100 * bound / r_['ms']:.1f}%); runs "
              + ",".join(f"{x:.4f}" for x in runs))
    # maxvol_auto itself, from a host array, on each side of the gate:
    # its host branch and its card branch (copies included) at the
    # checked sizes and at the cross's fiber family (32 r, r)
    rng = np.random.default_rng(SEED + 16)
    sizes = dict(mats)
    for r in (28, 32, 36, 40, 45, 49, 64):
        sizes[(32 * r, r)] = np.linalg.qr(rng.standard_normal((32 * r, r)))[0]
    gate = mv._DEVICE_SIZE_THRESHOLD

    def auto_ms(a, threshold):
        mv._DEVICE_SIZE_THRESHOLD = threshold
        try:
            return _host_ms(lambda: mv.maxvol_auto(a, device=dev), 1)[0]
        finally:
            mv._DEVICE_SIZE_THRESHOLD = gate

    mv_rows = {}
    for (n, r), a in sorted(sizes.items(), key=lambda kv: kv[1].size):
        auto_ms(a, 0)
        # turns host, card, card, host; medians
        runs = {"host": [], "card": []}
        for _ in range(4 if n * r < 1e6 else 1):
            for branch in ("host", "card", "card", "host"):
                runs[branch].append(auto_ms(a, a.size + 1 if branch == "host" else 0))
        host_ms, card_ms = (float(np.median(runs[k])) for k in ("host", "card"))
        a_dev = torch.from_numpy(a).to(dev)
        dev_ms, _ = _host_ms(lambda: mv.maxvol_device(a_dev), 5)
        mv_rows[f"{n}x{r}"] = {"entries": a.size, "host_ms": host_ms, "card_ms": card_ms,
                               "device_ms": dev_ms}
        print(f"  maxvol_auto ({n}, {r}) = {a.size} entries, f64 host array: host branch "
              f"{host_ms:.3f} ms, card branch {card_ms:.3f} ms with its copies, medians "
              f"of {len(runs['host'])} in turns (maxvol_device on a card tensor "
              f"{dev_ms:.3f} ms)")
    # the smallest size from which the card branch wins at every larger size
    wins = [v["entries"] for v in mv_rows.values() if v["card_ms"] < v["host_ms"]]
    by_run = next((v["entries"] for v in mv_rows.values()
                   if all(w["card_ms"] < w["host_ms"] for w in mv_rows.values()
                          if w["entries"] >= v["entries"])), None)
    print(f"  maxvol gate: {gate} entries in the code; by this run's timings "
          f"{by_run} (the card branch wins at {len(wins)} of {len(mv_rows)} sizes)")
    rows["maxvol"] = {"gate": gate, "gate_by_run": by_run, "sizes": mv_rows}
    return rows


# -- phase 6: the TT rounding families and the graph route on the card -------

#: the Gram families' relative floor, 4 sqrt(mach eps) (their warning in
#: tt_round_fixed): 1.4e-3 in f32, 6e-8 in f64, above phase 6's eps
GRAM_FLOOR = {torch.float32: 4 * math.sqrt(torch.finfo(torch.float32).eps),
              torch.float64: 4 * math.sqrt(torch.finfo(torch.float64).eps)}
#: an eps above that floor at which the Gram families are held to the
#: structural ranks
GRAM_EPS = {torch.float32: 1e-2, torch.float64: 1e-6}


def _chain_ranks(net):
    from tensor_networks_tpu_torch.ops.packed import chain_cores

    got = chain_cores(net)
    if got is None:
        raise AssertionError("the rounded network is not a chain with one mode per core")
    return [c.shape[-1] for c in got[1][:-1]]


def _split_merged_core(net, inds):
    """The graph route's orthonormalize hands the last core up whole (its
    one free leg, n, is no larger than its bond), so the rounded train
    ends in a core with two modes.  Split it back with the network's own
    exact QR so the train is a chain again (the new bond is n)."""
    free = set(net.free_indices())
    two = [nd for nd in net.network.nodes
           if sum(ix in free for ix in net.node_tensor(nd).indices) == 2]
    if len(two) != 1:
        raise AssertionError(f"expected one core with two modes, found {two}")
    t = net.node_tensor(two[0])
    later = max((ix for ix in t.indices if ix in free), key=inds.index)
    net.qr(two[0], [i for i, ix in enumerate(t.indices) if ix != later])
    return net


def _pack_chain(net, r):
    """The chain's cores zero-padded to the uniform rank ``r`` (inert for
    inner products): the error norms then run at the (2r, r) shapes."""
    from tensor_networks_tpu_torch.ops.packed import PackedTT, chain_cores

    _, cores, _, _ = chain_cores(net)
    first = F.pad(cores[0], (0, r - cores[0].shape[1]))
    mids = torch.stack([F.pad(c, (0, r - c.shape[2], 0, 0, 0, r - c.shape[0]))
                        for c in cores[1:-1]])
    last = F.pad(cores[-1], (0, 0, 0, r - cores[-1].shape[0]))
    return PackedTT(first.contiguous(), mids.contiguous(), last.contiguous())


def _double(packed, p):
    return packed.PackedTT(*(c.double() for c in p))


def _err_norm(packed, px, py, nx2):
    """|x - y| / |x| = sqrt(|x|^2 - 2<x, y> + |y|^2) / |x| through H1."""
    xy = packed.inner(px, py).item()
    yy = packed.inner(py, py).item()
    return math.sqrt(max(nx2 - 2 * xy + yy, 0.0) / nx2)


def _cost(call, reps=5):
    """Wall ms (median of ``reps`` synchronised calls; the caller warmed
    up), one call's device-busy ms, kernels and largest kernels
    (torch.profiler), and one call's host syncs."""
    runs = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        runs.append(1e3 * (time.perf_counter() - t0))
    _, busy, kernels, top = _device_profile(call)
    syncs, _ = _host_syncs(call)
    return {"wall_ms": float(np.median(runs)), "runs_ms": runs, "busy_ms": busy,
            "kernels": kernels, "syncs": syncs, "top": top}


def _round_leg(tnt, packed, a, inds, idx_np, ref_cpu, dtype, eps):
    """The seven calls on ``a + a`` (and ``[a, a, a]``) in ``dtype``."""
    import warnings

    a = a.__deepcopy__({})
    for k in range(D):
        a.node_tensor(k).update_val_size(a.value(k).to(dtype))
    x = a + a
    x3 = tnt.tt_sum([a, a, a])
    parts = [a, a, a]
    want = [N] + [R] * (D - 3) + [N]
    bound = [N] + [R + 10] * (D - 3) + [N]
    x_ranks = _chain_ranks(x)
    refs = {False: (x, _pack_chain(x, 2 * R), 2 * ref_cpu),
            True: (x3, _pack_chain(x3, 3 * R), 3 * ref_cpu)}
    norms2 = {}
    for is_sum, (_, px, _) in refs.items():
        p64 = _double(packed, px)
        norms2[is_sum] = {dtype: packed.inner(px, px).item(),
                          torch.float64: packed.inner(p64, p64).item()}
    delta = eps * math.sqrt(norms2[False][dtype])

    def graph_round():
        y = copy.deepcopy(x)
        y.round(0, delta)
        return y

    families = (  # (name, one call, whether it rounds the three-term sum)
        ("tt_svd_round", lambda: tnt.tt_svd_round(copy.deepcopy(x), eps), False),
        ("TensorNetwork.round", graph_round, False),
        ("tt_gramsvd_round", lambda: tnt.tt_gramsvd_round(copy.deepcopy(x), eps), False),
        ("tt_sum_gramsvd_round", lambda: tnt.tt_sum_gramsvd_round(parts, eps), True),
        ("tt_randomized_round", lambda: tnt.tt_randomized_round(x, want), False),
        ("tt_sum_randomized_round", lambda: tnt.tt_sum_randomized_round(parts, want), True),
        ("tt_rand_precond_svd_round",
         lambda: tnt.tt_rand_precond_svd_round(x, eps, bound), False),
    )
    # sqrt(|x|^2 - 2<x, y> + |y|^2) cancels: a relative error below
    # ~sqrt(4 d u) of |x| is lost in the inner products' roundoff
    floor = {dt: math.sqrt(4 * D * torch.finfo(dt).eps) for dt in (dtype, torch.float64)}
    bar = 5e-3 if dtype == torch.float32 else 1e-10
    rows = {}
    for name, call, is_sum in families:
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            y = call()
            call()
        for w in {str(w.message) for w in rec}:
            print(f"  {name} {dtype} warns: {w}")
            if "noise floor" in w:
                raise AssertionError(f"{name} at eps {eps:g} in {dtype} is below its "
                                     f"noise floor: {w}")
        if name == "TensorNetwork.round":
            merged = len(y.network.nodes)
            _split_merged_core(y, inds)
            if merged != D - 1:
                raise AssertionError(f"the graph route left {merged} cores, want {D - 1}")
        ranks = _chain_ranks(y)
        if "gram" in name:
            # below the Gram families' floor: ghost directions on the end
            # bonds, up to the sum's ranks (checked at the structural
            # ranks above the floor below)
            ok = all(w <= r <= xr for w, r, xr in zip(want, ranks, x_ranks))
        else:
            ok = ranks == want
        if not ok:
            raise AssertionError(f"{name} {dtype} kept ranks {ranks}, want {want}")
        _, px, ref = refs[is_sum]
        got = y.evaluate(inds, idx_np)
        err = float(np.abs(got - ref).max() / np.abs(ref).max())
        if got.shape != ref.shape or not np.all(np.isfinite(got)) or not err <= bar:
            raise AssertionError(f"{name} {dtype}: max err / max|ref| = {err:.3e} > {bar}")
        py = _pack_chain(y, max(ranks))
        en = _err_norm(packed, px, py, norms2[is_sum][dtype])
        en64 = (_err_norm(packed, _double(packed, px), _double(packed, py),
                          norms2[is_sum][torch.float64])
                if dtype != torch.float64 else en)
        # the error contract |x - y| <= eps |x|, or the pointwise bar where
        # the dtype's own roundoff sets the error, above the norms' floor
        for got_n, dt in ((en, dtype), (en64, torch.float64)):
            if not got_n <= max(eps, bar) + floor[dt]:
                raise AssertionError(f"{name} {dtype}: H1 error norm {got_n:.3e} in {dt} "
                                     f"above {max(eps, bar):g} + {floor[dt]:.1e}")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            cost = _cost(call)
        rows[name] = {"ranks": f"{ranks[0]},{ranks[1]}x{len(ranks) - 2},{ranks[-1]}"
                      if len(set(ranks[1:-1])) == 1 else ranks,
                      "err": err, "err_norm": en, "err_norm_f64": en64, **cost}
        print(f"  {name} {str(dtype)[6:]}: ranks {rows[name]['ranks']}, max err "
              f"{err:.3e} of max|ref|, H1 error norm {en:.3e} ({en64:.3e} in f64), wall "
              f"{cost['wall_ms']:.3f} ms (median of 5; runs "
              + ",".join(f"{t:.3f}" for t in cost["runs_ms"])
              + f"), device busy {cost['busy_ms']:.3f} ms over {cost['kernels']} kernels, "
              f"{cost['syncs']} host syncs; largest: "
              + "; ".join(f"{n} {ms:.3f} ms x{c}" for n, ms, c in cost["top"]))
    # the Gram families above their floor: the structural ranks
    geps = GRAM_EPS[dtype]
    for name, y in (("tt_gramsvd_round", tnt.tt_gramsvd_round(copy.deepcopy(x), geps)),
                    ("tt_sum_gramsvd_round", tnt.tt_sum_gramsvd_round(parts, geps))):
        ranks = _chain_ranks(y)
        ref = refs["sum" in name][2]
        err = float(np.abs(y.evaluate(inds, idx_np) - ref).max() / np.abs(ref).max())
        if ranks != want or not err <= bar:
            raise AssertionError(f"{name} {dtype} at eps {geps:g}: ranks {ranks}, "
                                 f"err {err:.3e}")
        rows[name]["above_floor"] = {"eps": geps, "err": err}
        print(f"  {name} {str(dtype)[6:]} at eps {geps:g} (above its floor "
              f"{GRAM_FLOOR[dtype]:.1e}): structural ranks, max err {err:.3e}")
    return rows


def _ht_leg(tnt, dev):
    """rand_ht over 16 indices of size 32 at rank 32 in f64, plus itself,
    rounded by TensorNetwork.round from its root at eps 1e-10."""
    g = torch.Generator(device=dev).manual_seed(SEED + 21)
    inds = [tnt.Index(f"h{k}", 32) for k in range(16)]
    ht = tnt.TensorNetwork.rand_ht(inds, 32, dtype=torch.float64, device=dev, generator=g)
    s = ht + ht
    if s.canonical_structure() != ht.canonical_structure():
        raise AssertionError("ht + ht changed the tree's structure")
    # orthonormalize hands each leaf (one free leg of 32, no larger than its
    # bond of 64) up to its parent whole: the rounded tree is the sum with
    # every leaf merged into its parent
    folded = copy.deepcopy(s)
    for leaf in [n for n in folded.network.nodes if len(folded.network.neighbors(n)) == 1]:
        folded.merge(folded.network.neighbors(leaf)[0], leaf, compute_data=False)
    delta = 1e-10 * s.norm()

    def call():
        y = copy.deepcopy(s)
        y.round("G0", delta)
        return y

    y = call()
    if y.canonical_structure() != folded.canonical_structure():
        raise AssertionError("round changed the HT's structure beyond folding its leaves")
    pts = np.random.default_rng(SEED + 22).integers(0, 32, (B, 16))
    ht_cpu = tnt.TensorNetwork.from_separated_dict(*ht.to_separated_dict(), device="cpu")
    ref = 2 * ht_cpu.evaluate(inds, pts)
    got = y.evaluate(inds, pts)
    err = float(np.abs(got - ref).max() / np.abs(ref).max())
    # the budget is norm-wise, 1e-10 |s|, and this tree has real directions
    # that small (uniform positive cores): pointwise, a few times that
    if not (np.all(np.isfinite(got)) and err <= 1e-9):
        raise AssertionError(f"HT round: max err / max|ref| = {err:.3e} > 1e-9")
    call()
    row = {"nodes": [len(s.network.nodes), len(y.network.nodes)],
           "ranks": sorted(set(y.ranks())), "err": err, **_cost(call, 3)}
    print(f"  HT d=16 n=32 r=32 f64, ht + ht rounded from its root at 1e-10: "
          f"{row['nodes'][0]} nodes to {row['nodes'][1]} (leaves folded; structure "
          f"hash as predicted), ranks {row['ranks']}, max err {err:.3e} of max|ref| "
          f"(general evaluator, against the plain f64 evaluation on the CPU), wall "
          f"{row['wall_ms']:.3f} ms (median of 3), device busy {row['busy_ms']:.3f} ms "
          f"over {row['kernels']} kernels, {row['syncs']} host syncs; largest: "
          + "; ".join(f"{n} {ms:.3f} ms x{c}" for n, ms, c in row["top"]))
    return row


def phase_rounding_families(zp, ev, a, inds, idx_np, dev):
    """The four TT rounding families and the graph route at full width:
    ``a + a`` of the main path's train (d=50, n=32, r=100) and the
    three-term sum, in f32 at eps 1e-3 and in f64 at 1e-10 (the f64 leg
    on the same cores, upcast), then the HT leg.  Each call's kept ranks,
    pointwise error through H2 at the main path's 8192 points against the
    plain f64 evaluation of a on the CPU, error norm through H1, wall,
    device-busy time, kernels and host syncs.  The kernels' launch counts
    are reset just before and read just after."""
    import tensor_networks_tpu_torch as tnt
    from tensor_networks_tpu_torch import packed

    cpu = [c.double().cpu() for c in stack(packed.pack(a))]
    ref_cpu = ev.tt_evaluate_plain(*cpu, torch.from_numpy(idx_np)).numpy()
    print(f"phase 6 rounding families, a + a and a + a + a, d={D} n={N} r={R}, "
          f"{len(idx_np)} points:")
    torch.cuda.synchronize()
    zp.tt_inner_cuda.launches = 0
    zp.tt_inner_chain_cuda.launches = 0
    _reset_evaluate_counts(ev)
    out = {}
    for dtype, eps in ((torch.float32, 1e-3), (torch.float64, 1e-10)):
        out[str(dtype)[6:]] = _round_leg(tnt, packed, a, inds, idx_np, ref_cpu, dtype, eps)
    out["ht"] = _ht_leg(tnt, dev)
    torch.cuda.synchronize()
    launches = {"zipper": zp.tt_inner_cuda.launches,
                "chain": zp.tt_inner_chain_cuda.launches,
                "evaluate": ev.tt_evaluate_cuda.launches,
                "tiles": ev.group_tiles_cuda.launches}
    if not all(launches.values()):
        raise AssertionError(f"phase 6 missed a kernel: launches {launches}")
    print(f"  phase 6 launches: {launches}")
    line = {"launches": launches, "ht": {k: out["ht"][k] for k in ("nodes", "err", "wall_ms",
                                                                    "busy_ms", "syncs")}}
    for key in ("float32", "float64"):
        line[key] = {name: [_sig(r["wall_ms"]), _sig(r["busy_ms"]), r["kernels"], r["syncs"],
                            _sig(r["err"]), _sig(r["err_norm"])]
                     for name, r in out[key].items()}
    line["columns"] = ["wall_ms", "busy_ms", "kernels", "syncs", "err", "err_norm"]
    print(json.dumps({"rounding_families": _sig(line)}, separators=(",", ":")))
    return out, launches


def phase_inner_f64_timings(zp, pa, pb, dev):
    """H1's float64 instantiation at the main shape (the fused route) and
    at phase 6's (200, 100) error-norm shape (the chain), turns plain,
    kernel, kernel, plain.  Bounds: float64 operations over the FP64
    tensor-core peak (67 TFLOP/s), the FMA rate (34 TFLOP/s) beside."""
    g = torch.Generator(device=dev).manual_seed(SEED + 23)
    rows = {}
    shapes = (("f64", _f64(*stack(pa)), _f64(*stack(pb))),
              ("f64_err_norm", list(_train(g, D, N, 2 * R, 1 / math.sqrt(N * 2 * R),
                                           dtype=torch.float64)),
               list(_train(g, D, N, R, 1 / math.sqrt(N * R), dtype=torch.float64))))
    for key, a, b in shapes:
        k = lambda: zp.tt_inner_cuda(*a, *b)  # noqa: E731
        p = lambda: zp.tt_inner_plain(*a, *b)  # noqa: E731
        runs = [_time_ms(p), _time_ms(k), _time_ms(k), _time_ms(p)]
        ref = p().item()
        err = abs(k().item() - ref)
        bound, by = _inner_bound(a, b)
        fma_ms = bound * FP32_FLOP_PER_S / FP64_FMA_FLOP_PER_S if by == "operations" else bound
        rel = err / math.sqrt(abs(zp.tt_inner_plain(*a, *a).item() * zp.tt_inner_plain(*b, *b).item()))
        if not rel <= 1e-12:
            raise AssertionError(f"H1 f64 {key}: {rel:.3e} of |a||b| against the plain version")
        route = "fused" if zp.takes_fused_route(a[0].shape[1], b[0].shape[1]) else "chain"
        rows[key] = {"ms": (runs[1] + runs[2]) / 2, "plain_ms": (runs[0] + runs[3]) / 2,
                     "max_abs_err": err, "rel_err": rel, "bound_ms": bound, "bound_by": by,
                     "fma_bound_ms": fma_ms, "route": route}
        print(f"  H1 f64 d={D} n={N} (r_a, r_b) = ({a[0].shape[1]}, {b[0].shape[1]}), "
              f"{route} route: kernel {rows[key]['ms']:.4f} ms, plain "
              f"{rows[key]['plain_ms']:.4f} ms, bound {bound:.4f} ms by {by} at 67 TFLOP/s "
              f"({100 * bound / rows[key]['ms']:.1f}% of it reached; {fma_ms:.4f} ms at the "
              f"34 TFLOP/s FMA rate), err {rel:.2e} of |a||b|; runs "
              + ",".join(f"{x:.4f}" for x in runs))
    return rows


# -- phase 7: TT-GMRES on the card ------------------------------------------

#: bench.py's solver legs: the screened-Poisson QTT system (2 + delta) I
#: - S - S^T with rhs exp(-c i / 2^K) (tools/solver_r64_probe.py:259-261)
QTT_DELTA, QTT_C = 1.0, 3.0
#: leg C: delta I plus one tridiag(-1, 2, -1) term per mode on d modes of
#: n; delta = 8 puts the spectrum in [8.07, 39.9], a ratio under 5
GRAPH_D, GRAPH_N, GRAPH_DELTA = 8, 32, 8.0
#: (leg, K, Krylov rank, max_rank, runs): bench.py:1128 _leg_solver_tpu's
#: K=22 rank-8 system and :1154 _leg_solver_r64's K=14 rank-64 one; each
#: run is (name, dtype, rounding, eps / |rhs|, residual bar, error bar)
GMRES_LEGS = (
    ("A", 22, 8, None, (("f64_svd", torch.float64, "svd", 1e-9, 1e-8, 1e-7),
                        ("f32_svd", torch.float32, "svd", 1e-5, 1e-5, 5e-4),
                        ("f64_rand", torch.float64, "rand", 1e-9, 1e-5, None))),
    ("B", 14, 64, 64, (("f32_svd", torch.float32, "svd", 1e-5, 1e-5, 5e-4),
                       ("f64_svd", torch.float64, "svd", 1e-9, 1e-8, 1e-7))),
)


def _banded_solution(K, delta, c):
    """The independent reference: tridiag(-1, 2 + delta, -1) u = exp(-c i
    / 2^K) with Dirichlet ends, solved in f64 on the host by LAPACK's
    banded solver."""
    from scipy.linalg import solve_banded

    n = 2**K
    ab = np.zeros((3, n))
    ab[0, 1:] = -1.0
    ab[1] = 2.0 + delta
    ab[2, :-1] = -1.0
    return solve_banded((1, 1), ab, np.exp(-c * np.arange(n) / n))


def _reset_counts(zp, ev):
    torch.cuda.synchronize()
    zp.tt_inner_cuda.launches = 0
    zp.tt_inner_chain_cuda.launches = 0
    zp.tt_inner_cuda.launches_by_dtype = dict.fromkeys(zp.DTYPE_SUFFIX.values(), 0)
    _reset_evaluate_counts(ev)


def _counts(zp, ev):
    torch.cuda.synchronize()
    by = {k: v for k, v in zp.tt_inner_cuda.launches_by_dtype.items() if v}
    return {"zipper": zp.tt_inner_cuda.launches, "zipper_by_dtype": by,
            "chain": zp.tt_inner_chain_cuda.launches,
            "evaluate": ev.tt_evaluate_cuda.launches, "tiles": ev.group_tiles_cuda.launches}


def _h1_h2_at(zp, ev, x, y, idx):
    """H1 on (x, y) and H2 on x at idx -- the shapes a solve gives them --
    against their plain versions (f64 plain for H1), each timed in turns
    P K K P, with its bound."""
    a, b = list(stack(x)), list(stack(y))
    a64, b64 = _f64(*a), _f64(*b)
    scale = math.sqrt(abs(zp.tt_inner_plain(*a64, *a64).item() * zp.tt_inner_plain(*b64, *b64).item()))
    ref = zp.tt_inner_plain(*a64, *b64).item()
    got = zp.tt_inner_cuda(*a, *b).item()
    idx32 = idx.to(torch.int32).contiguous()
    ev_k, ev_p = ev.tt_evaluate_cuda(*a, idx32), ev.tt_evaluate_plain(*a, idx32)
    tol = 1e-4 if a[0].dtype == torch.float32 else 1e-12
    h1_err = abs(got - ref) / scale
    h2_err = (ev_k.double() - ev_p.double()).abs().max().item() / ev_p.abs().max().item()
    if not (h1_err <= tol and h2_err <= tol):
        raise AssertionError(f"H1 {h1_err:.3e} / H2 {h2_err:.3e} of scale against the plain "
                             f"versions at {tuple(a[1].shape)}, tol {tol}")
    rows = {}
    for name, k, p, bound, err in (
            ("h1", lambda: zp.tt_inner_cuda(*a, *b), lambda: zp.tt_inner_plain(*a, *b),
             _inner_bound(a, b), abs(got - ref)),
            ("h2", lambda: ev.tt_evaluate_cuda(*a, idx32), lambda: ev.tt_evaluate_plain(*a, idx32),
             _evaluate_bound(a, idx32), (ev_k.double() - ev_p.double()).abs().max().item())):
        runs = [_time_ms(p), _time_ms(k), _time_ms(k), _time_ms(p)]
        rows[name] = {"ms": (runs[1] + runs[2]) / 2, "plain_ms": (runs[0] + runs[3]) / 2,
                      "runs_ms": runs, "bound_ms": bound[0], "bound_by": bound[1],
                      "max_abs_err": err}
    rows["h1"]["rel_err"], rows["h2"]["rel_err"] = h1_err, h2_err
    return rows


def _qtt_solve(tnt, zp, ev, K, rank, dtype, method, eps_rel, u_ref, pts, max_rank=None):
    """One gmres_packed solve of the K-bit system from x0 = pad_rank(rhs,
    4): wall (host clock, synchronised) with the launch counters reset
    before and read after (H1's), then the same solve under
    torch.profiler and the sync counter; the residual recomputed on the
    CPU in f64; the solution at the grid points ``pts`` through H2
    against the banded reference, H2's counters reset before and read
    after."""
    from tensor_networks_tpu_torch import packed

    op = tnt.qtt_screened_laplacian(K, delta=QTT_DELTA, dtype=dtype)
    rhs = tnt.qtt_exponential(K, c=QTT_C, dtype=dtype)
    x0 = packed.pad_rank(rhs, 4)
    rhs_norm = float(packed.norm_exact(rhs))

    def call():
        return packed.gmres_packed(op, rhs, x0, eps=eps_rel * rhs_norm, rank=rank,
                                   max_rank=max_rank, round_method=method)

    _reset_counts(zp, ev)
    t0 = time.perf_counter()
    x, resid = call()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _counts(zp, ev)
    stats = packed.gmres_packed.last_stats
    iters = sum(c["iterations"] for c in stats["cycles"])
    if counts["zipper"] == 0:
        raise AssertionError(f"the K={K} {dtype} {method} solve launched no H1")
    t0 = time.perf_counter()
    (syncs, _), busy, kernels, _ = _device_profile(lambda: _host_syncs(call))
    profiled = time.perf_counter() - t0

    # the residual again, independently: x on the CPU in f64, the plain
    # apply, norm_exact's QR sweep
    op64 = tnt.qtt_screened_laplacian(K, delta=QTT_DELTA, device="cpu")
    rhs64 = tnt.qtt_exponential(K, c=QTT_C, device="cpu")
    x64 = packed.PackedTT(*(t.detach().double().cpu() for t in x))
    res = packed.add(rhs64, packed.scale(packed.ttop_apply_packed(op64, x64), -1.0))
    recomputed = float(packed.norm_exact(res))
    rhs64_norm = float(packed.norm_exact(rhs64))

    bits = torch.from_numpy((pts[:, None] >> np.arange(K)[None, :]) & 1).to(x.first.device)
    _reset_evaluate_counts(ev)
    got = packed.evaluate(x, bits).double().cpu().numpy()
    torch.cuda.synchronize()
    counts.update(evaluate=ev.tt_evaluate_cuda.launches, tiles=ev.group_tiles_cuda.launches)
    err = float(np.abs(got - u_ref[pts]).max() / np.abs(u_ref).max())
    if counts["evaluate"] != 1 or counts["tiles"] != 1 or got.shape != pts.shape \
            or not np.all(np.isfinite(got)):
        raise AssertionError(f"the solution's evaluation: launches {counts}, shape {got.shape}")
    kernels_at = _h1_h2_at(zp, ev, x, packed.pad_rank(rhs, x.rank), bits)
    return {"wall_s": wall, "profiled_s": profiled, "cycles": [[c["rank"], c["iterations"]]
                                                                for c in stats["cycles"]],
            "rank": x.rank, "iterations": iters, "busy_ms": busy, "kernels": kernels,
            "syncs": syncs, "syncs_per_iteration": syncs / max(iters, 1),
            "launches": counts,
            "resid": resid / rhs_norm, "recomputed": recomputed / rhs64_norm,
            "recomputed_abs": recomputed, "resid_abs": resid, "rhs_norm": rhs64_norm,
            "err": err, "split_ms_per_iteration": {k: 1e3 * v / max(iters, 1)
                                                   for k, v in stats["seconds"].items()},
            "kernels_at": kernels_at}


def _check_solve(name, row, rel_bar, err_bar):
    bars = [("relative residual", row["resid"], rel_bar),
            ("recomputed residual", row["recomputed_abs"],
             3 * row["resid_abs"] + 1e-12 * row["rhs_norm"])]
    if err_bar is not None:
        bars.append(("error against the banded solve", row["err"], err_bar))
    for what, got, bar in bars:
        if not got <= bar:
            raise AssertionError(f"phase 7 {name}: {what} {got:.3e} above {bar:.3e}")


def _print_solve(name, row):
    split = ", ".join(f"{k} {v:.3f}" for k, v in row["split_ms_per_iteration"].items())
    h1, h2 = row["kernels_at"]["h1"], row["kernels_at"]["h2"]
    print(f"  {name}: wall {row['wall_s']:.3f} s ({row['profiled_s']:.3f} s profiled), cycles "
          f"(rank, iterations) {row['cycles']}, final rank {row['rank']}, {row['iterations']} "
          f"iterations; device busy {row['busy_ms']:.1f} ms over {row['kernels']} kernels, "
          f"{row['syncs']} host syncs ({row['syncs_per_iteration']:.1f} an iteration); "
          f"launches {row['launches']}; residual / |rhs| {row['resid']:.3e} reported, "
          f"{row['recomputed']:.3e} recomputed on the CPU in f64; max err / max|u_ref| "
          f"{row['err']:.3e} at {B} grid points (H2); ms an iteration: {split}; H1 at "
          f"(n=2, r={row['rank']}): kernel {h1['ms']:.4f} ms, plain {h1['plain_ms']:.4f}, "
          f"bound {h1['bound_ms']:.5f} by {h1['bound_by']}, err {h1['rel_err']:.1e} of |a||b|; "
          f"H2 at B={B}: kernel {h2['ms']:.4f} ms, plain {h2['plain_ms']:.4f}, bound "
          f"{h2['bound_ms']:.5f} by {h2['bound_by']}, err {h2['rel_err']:.1e} of max|ref|")


def _svd_round_departure(dev):
    """``svd_round`` against the JAX package's form of it -- the masked
    sweep at the input's rank, sliced to the target -- on a CGS2-sized
    input: the sum of 8 rank-64 f64 trains at K=14 (rank 512), rounded
    to 64.  Both results held together; each timed (host clock,
    synchronised, median of 3 after one warm-up)."""
    from tensor_networks_tpu_torch import packed
    from tensor_networks_tpu_torch.ops.fast import _tt_round_sweep

    g = torch.Generator(device=dev).manual_seed(SEED + 32)
    r = 64
    x = packed.add(*(packed.PackedTT(*_train(g, 14, 2, r, 1 / math.sqrt(2 * r),
                                             dtype=torch.float64)) for _ in range(8)))

    def masked():
        f, m, l, _ = _tt_round_sweep(*x, 1e-7, True, False)
        return packed.PackedTT(f[:, :r].contiguous(), m[:, :r, :, :r].contiguous(),
                               l[:r].contiguous())

    out = {}
    for name, fn in (("svd_round", lambda: packed.svd_round(x, r)), ("masked", masked)):
        y = fn()
        runs = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            runs.append(1e3 * (time.perf_counter() - t0))
        out[name] = (y, float(np.median(runs)))
    (a, ms_a), (b, ms_b) = out["svd_round"], out["masked"]
    diff = float(packed.norm_exact(packed.add(a, packed.scale(b, -1.0))))
    rel = diff / float(packed.norm_exact(b))
    if not rel <= 1e-10:
        raise AssertionError(f"svd_round and the masked sweep differ by {rel:.3e}")
    print(f"  svd_round on a sum of 8 rank-64 trains (K=14, rank 512, f64) to rank 64: "
          f"{ms_a:.2f} ms, the masked sweep at rank 512 {ms_b:.2f} ms (medians of 3); "
          f"results within {rel:.1e} of each other")
    return {"ms": ms_a, "masked_ms": ms_b, "rel_diff": rel}


def _graph_leg(tnt):
    """Leg C: ops.solvers.gmres on the Kronecker-sum shifted Laplacian
    (ttop_sum of delta I and one tridiag(-1, 2, -1) term per mode, d=8
    modes of n=32, 32^8 ~ 1.1e12 unknowns), rank-1 seeded rhs and x0,
    round_eps 1e-10, the default maxiter."""
    from tensor_networks_tpu_torch import packed

    rng = np.random.default_rng(SEED + 31)
    ins = [tnt.Index(f"g{k}", GRAPH_N) for k in range(GRAPH_D)]
    outs = [tnt.Index(f"h{k}", GRAPH_N) for k in range(GRAPH_D)]
    eye = np.eye(GRAPH_N)
    tri = 2.0 * eye - np.eye(GRAPH_N, k=1) - np.eye(GRAPH_N, k=-1)
    summands = [[GRAPH_DELTA * eye] + [eye] * (GRAPH_D - 1)] + [
        [tri if j == k else eye for j in range(GRAPH_D)] for k in range(GRAPH_D)]
    vecs = [[rng.standard_normal(GRAPH_N) for _ in range(GRAPH_D)] for _ in range(2)]
    op = tnt.ttop_sum(ins, outs, summands, "L")
    rhs, x0 = (tnt.tt_rank1(ins, v) for v in vecs)
    rhs_norm = rhs.norm()
    eps = 1e-6 * rhs_norm
    applies = [0]

    def apply(t):
        applies[0] += 1
        return tnt.ttop_apply(op, t)

    def call():
        return tnt.gmres(apply, rhs, x0, eps, 1e-10)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x, resid = call()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    iters = applies[0] - 2
    # again, counting host syncs: the contraction plans are cached now
    t0 = time.perf_counter()
    syncs, _ = _host_syncs(call)
    warm = time.perf_counter() - t0
    op_cpu = tnt.ttop_sum(ins, outs, summands, "L", device="cpu")
    x_cpu = tnt.TensorNetwork.from_separated_dict(*x.to_separated_dict(), device="cpu")
    rhs_cpu = tnt.tt_rank1(ins, vecs[0], device="cpu")
    diff = rhs_cpu + tnt.ttop_apply(op_cpu, x_cpu).scale(-1.0)
    recomputed = float(packed.norm_exact(packed.pack_ragged(diff)))
    row = {"wall_s": wall, "warm_s": warm, "iterations": iters, "ranks": x.ranks(), "syncs": syncs,
           "resid": resid / rhs_norm, "recomputed": recomputed / rhs_norm, "delta": GRAPH_DELTA}
    if not (row["resid"] < 1e-5 and recomputed <= 3 * resid + 1e-12 * rhs_norm):
        raise AssertionError(f"phase 7 graph route: residual {row['resid']:.3e} reported, "
                             f"{row['recomputed']:.3e} recomputed")
    print(f"  C graph gmres, d={GRAPH_D} n={GRAPH_N} ({GRAPH_N}^{GRAPH_D} unknowns), delta {GRAPH_DELTA}, op "
          f"rank {GRAPH_D + 1}, eps 1e-6 |rhs|: wall {wall:.3f} s ({warm:.3f} s again, plans "
          f"cached, counting syncs), {iters} iterations, ranks "
          f"{row['ranks']}, {syncs} host syncs; residual / |rhs| {row['resid']:.3e} reported, "
          f"{row['recomputed']:.3e} recomputed on the CPU in f64")
    return row


def phase_gmres(zp, ev):
    """TT-GMRES on the card: bench.py's solver_tpu system (leg A: K=22,
    rank 8; f64 and f32 svd, f64 rand), its solver_r64 shape (leg B:
    K=14, rank 64 = max_rank, f32 and f64), and the graph route (leg C).
    Each leg's launch counters are reset before and read after."""
    import tensor_networks_tpu_torch as tnt

    pts_rng = np.random.default_rng(SEED + 30)
    out, launches = {}, {}
    print("phase 7 TT-GMRES on the card (screened-Poisson QTT, delta 1, rhs exp(-3 i / 2^K)):")
    for leg, K, rank, max_rank, runs in GMRES_LEGS:
        u_ref = _banded_solution(K, QTT_DELTA, QTT_C)
        pts = pts_rng.integers(0, 2**K, B)
        for name, dtype, method, eps_rel, rel_bar, err_bar in runs:
            key = f"{leg}_{name}"
            row = _qtt_solve(tnt, zp, ev, K, rank, dtype, method, eps_rel, u_ref, pts,
                             max_rank)
            _print_solve(f"{leg} K={K} rank {rank} {name}", row)
            _check_solve(key, row, rel_bar, err_bar)
            out[key] = row
            launches[key] = row["launches"]
    svd_vs_masked = _svd_round_departure(torch.device("cuda:0"))
    _reset_counts(zp, ev)
    out["C"] = _graph_leg(tnt)
    launches["C"] = _counts(zp, ev)
    print(f"  phase 7 launches by solve: {launches}")
    line = {k: [_sig(r["wall_s"]), r["iterations"], r["rank"], _sig(r["busy_ms"]), r["kernels"],
                r["syncs"], _sig(r["resid"]), _sig(r["recomputed"]), _sig(r["err"])]
            for k, r in out.items() if k != "C"}
    line["columns"] = ["wall_s", "iterations", "rank", "busy_ms", "kernels", "syncs",
                       "resid", "recomputed", "err"]
    line["C"] = {k: _sig(v) for k, v in out["C"].items()}
    line["B_split_ms"] = {k: _sig(out[k]["split_ms_per_iteration"])
                          for k in ("B_f32_svd", "B_f64_svd")}
    line["svd_round_vs_masked"] = _sig(svd_vs_masked)
    print(json.dumps({"gmres": line}, separators=(",", ":")))
    return out, launches


# -- phase 8: the ALS linear solver and the DMRG eigensolver on the card -------

#: 8a: the K=22 system of phase 7, x0 = pad_rank(rhs, 8), spd; each run
#: is (name, dtype, relative residual bar, error bar), phase 7's bars
ALS22_RUNS = (("f64", torch.float64, 1e-10, 1e-7), ("f32", torch.float32, 1e-5, 5e-4))
#: 8c: tools/solver_r64_probe.py's configuration; the per-sweep time is
#: the slope between the two sweep budgets, as the probe takes it
R64_K, R64_RANK, R64_ITERS, R64_BUDGETS = 14, 64, 48, (5, 8)
#: 8c's bars: the ALS relative residual (set by the 48-step CG budget:
#: 3.76e-4 on the CPU, ``solver_witness.py port``; 3.41e-4 to 3.50e-4 on
#: the card), and the eigenvalue's error against the exact
#: delta + 2 - 2 cos(pi / (2^14 + 1)), held on the reported lam and on
#: the Rayleigh quotient of the returned vector recomputed on the CPU in
#: f64, each also below the start's own quotient (3.68e-4 above the
#: exact value).  The port on the CPU ends 8 sweeps at 9.2e-7 (lam) and
#: 3.0e-7 (recomputed); the JAX package's host loop, whose Lanczos
#: locals start from the core before the gauge moved, at 1.30e-3 after
#: 8 sweeps and 7.09e-4 after 16 (``solver_witness.py jax``).  8d's
#: relative bar on each of the three lowest eigenvalues and on the
#: pairwise overlaps (K=14, delta 0.3, f64; the CPU gives 2.4e-15 and
#: 1.1e-16)
R64_ALS_BAR, R64_EIG_BAR, EIGK_BAR = 1e-3, 1e-5, 1e-11
#: 8e: (bits per axis, relative residual bars of the enriched and the
#: padded run).  At 5 bits rank 16 does not reach 1e-10 in either
#: package: the JAX package's host loop ends enriched at 4.3115e-3 and
#: padded at 4.4436e-3, the port on the CPU at 4.3115e-3 and 4.31e-3 to
#: 4.49e-3 (``solver_witness.py``), the port on the card at 4.3115e-3
#: and 5.204e-3 (the padded bonds take their new directions from QR's
#: null-space completion, which follows the summation order); the bars
#: sit just above the largest reading
ADAPTIVE_RUNS = ((3, {"enrich": 1e-10, "pad": 1e-10}),
                 (5, {"enrich": 4.36e-3, "pad": 5.3e-3}))
#: the host syncs that are cuSOLVER's status checks
#: (:data:`tensor_networks_tpu_torch.syncs.SYNC_KINDS`)
CUSOLVER_INFO = ("svd info", "eigh info")


def _solver_run(call, zp, ev):
    """One call: wall on the host clock (synchronised), its CUDA-event ms
    and H1/H2 launches (counters reset just before, read just after);
    then the same call under torch.profiler and the sync counter."""
    _reset_counts(zp, ev)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    out = call()
    stop.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _counts(zp, ev)
    from tensor_networks_tpu_torch.syncs import host_syncs

    (syncs, _), busy, kernels, top = _device_profile(lambda: host_syncs(call))
    return out, {"wall_s": wall, "event_ms": start.elapsed_time(stop), "busy_ms": busy,
                 "busy_share": busy / (1e3 * wall), "kernels": kernels, "syncs": syncs,
                 "top": top, "launches": launches}


def _check_syncs(name, row, fused):
    """A fused loop reads the card once a sweep (its stop test) and once
    at the end (its record); any other sync is a cuSOLVER status check."""
    syncs = row["syncs"]
    if fused:
        bad = {k: v for k, v in syncs.items()
               if k not in CUSOLVER_INFO + ("stop test", "record fetch")}
        if bad or syncs.get("stop test") != row["sweeps"] or syncs.get("record fetch") != 1:
            raise AssertionError(f"phase 8 {name}: syncs {syncs} over {row['sweeps']} sweeps")
    row["syncs_per_sweep"] = {k: v / max(row["sweeps"], 1) for k, v in syncs.items()}


def _recomputed_residual(tnt, op_cpu, rhs_cpu, x):
    """|rhs - op x| with x copied to the CPU in f64: the plain apply and
    norm_exact's QR sweep."""
    from tensor_networks_tpu_torch import packed

    x64 = packed.PackedTT(*(t.detach().double().cpu() for t in x))
    res = packed.add(rhs_cpu, packed.scale(packed.ttop_apply_packed(op_cpu, x64), -1.0))
    return float(packed.norm_exact(res))


def _recomputed_rayleigh(tnt, op_cpu, x):
    """<x, op x> / <x, x> with x copied to the CPU in f64."""
    from tensor_networks_tpu_torch import packed

    x64 = packed.PackedTT(*(t.detach().double().cpu() for t in x))
    return float(packed.inner(x64, packed.ttop_apply_packed(op_cpu, x64))
                 / packed.inner(x64, x64))


def _grid_error(zp, ev, x, u_ref, pts, K):
    """The solution at the grid points through H2 (counters reset before
    and read after) against the reference, relative to max|u_ref|."""
    from tensor_networks_tpu_torch import packed

    bits = torch.from_numpy((pts[:, None] >> np.arange(K)[None, :]) & 1).to(x.first.device)
    _reset_counts(zp, ev)
    got = packed.evaluate(x, bits).double().cpu().numpy()
    counts = _counts(zp, ev)
    if counts["evaluate"] != 1 or got.shape != pts.shape or not np.all(np.isfinite(got)):
        raise AssertionError(f"the solution's evaluation: launches {counts}, shape {got.shape}")
    return float(np.abs(got - u_ref[pts]).max() / np.abs(u_ref).max()), bits, counts


def _als22_leg(tnt, zp, ev, pts):
    """8a: als_solve on phase 7's K=22 system (4,194,304 unknowns) from
    pad_rank(rhs, 8), spd, dense locals (the end bonds' locals are
    singular), f64 and f32, the fused loop and the host loop."""
    from tensor_networks_tpu_torch import packed

    K = 22
    u_ref = _banded_solution(K, QTT_DELTA, QTT_C)
    op64 = tnt.qtt_screened_laplacian(K, delta=QTT_DELTA, device="cpu")
    rhs64 = tnt.qtt_exponential(K, c=QTT_C, device="cpu")
    rhs_norm = float(packed.norm_exact(rhs64))
    rows, kernels_at = {}, {}
    for name, dtype, rel_bar, err_bar in ALS22_RUNS:
        op = tnt.qtt_screened_laplacian(K, delta=QTT_DELTA, dtype=dtype)
        rhs = tnt.qtt_exponential(K, c=QTT_C, dtype=dtype)
        for fused in (True, False):
            key = f"{name}_{'fused' if fused else 'host'}"

            def call():
                return tnt.als_solve(op, rhs, packed.pad_rank(rhs, 8), sweeps=8,
                                     tol=0.1 * rel_bar * rhs_norm, spd=True, fused=fused)

            call()  # first calls at these shapes, untimed: fused and host alike
            (x, res, hist), row = _solver_run(call, zp, ev)
            row["sweeps"] = len(hist)
            row["ms_per_sweep"] = row["event_ms"] / len(hist)
            row["resid"] = res / rhs_norm
            row["recomputed"] = _recomputed_residual(tnt, op64, rhs64, x) / rhs_norm
            row["err"], bits, row["launches_grid"] = _grid_error(zp, ev, x, u_ref, pts, K)
            _check_syncs(f"8a {key}", row, fused)
            for what, got, bar in (("relative residual", row["resid"], rel_bar),
                                   ("recomputed residual", row["recomputed"],
                                    3 * row["resid"] + 1e-12),
                                   ("error against the banded solve", row["err"], err_bar)):
                if not got <= bar:
                    raise AssertionError(f"phase 8 8a {key}: {what} {got:.3e} above {bar:.3e}")
            rows[key] = row
            if fused:
                kernels_at[f"8a_{name}"] = _h1_h2_at(zp, ev, x, packed.pad_rank(rhs, 8), bits)
    for name, _, _, _ in ALS22_RUNS:
        rows[f"{name}_fused_over_host"] = (rows[f"{name}_fused"]["ms_per_sweep"]
                                           / rows[f"{name}_host"]["ms_per_sweep"])
    return rows, kernels_at


def _solver_cpu_leg(tnt, zp, ev):
    """8b: bench.py:1321-1350 _leg_solver_cpu on the card in f64: the
    2^30-unknown ALS solve (2 sweeps, tol 1e-12) and the 32^3 DMRG
    ground state (8 sweeps)."""
    from tensor_networks_tpu_torch import packed

    rows = {}
    op = tnt.qtt_screened_laplacian(30, delta=1.0)
    rhs = tnt.qtt_exponential(30, c=3.0)
    (x, res, hist), row = _solver_run(
        lambda: tnt.als_solve(op, rhs, packed.pad_rank(rhs, 8), sweeps=2, tol=1e-12), zp, ev)
    rhs64 = tnt.qtt_exponential(30, c=3.0, device="cpu")
    rhs_norm = float(packed.norm_exact(rhs64))
    row.update(sweeps=len(hist), resid=res / rhs_norm,
               recomputed=_recomputed_residual(
                   tnt, tnt.qtt_screened_laplacian(30, delta=1.0, device="cpu"), rhs64, x)
               / rhs_norm)
    row["ms_per_sweep"] = row["event_ms"] / len(hist)
    _check_syncs("8b als", row, True)
    if not (row["resid"] < 1e-12 and row["recomputed"] <= 3 * row["resid"] + 1e-14):
        raise AssertionError(f"phase 8 8b 2^30 ALS: residual {row['resid']:.3e} reported, "
                             f"{row['recomputed']:.3e} recomputed")
    rows["als_2pow30"] = row

    op3 = tnt.qtt_screened_laplacian_nd(5, 3, delta=1.0)
    x0 = packed.pad_rank(tnt.qtt_exponential_nd(5, (1.0, 2.0, 3.0)), 8)
    (x3, lam, hist), row = _solver_run(lambda: tnt.als_eigsh(op3, x0, sweeps=8), zp, ev)
    exact = 1.0 + 3 * (2 - 2 * math.cos(math.pi / 33))
    row.update(sweeps=len(hist) // 2, lam=lam, err=abs(lam - exact),
               norm=float(packed.norm_exact(x3)))
    row["ms_per_sweep"] = row["event_ms"] / row["sweeps"]
    _check_syncs("8b eigsh", row, True)
    if not (row["err"] < 1e-10 and abs(row["norm"] - 1) < 1e-10):
        raise AssertionError(f"phase 8 8b 32^3 eigsh: |lam - exact| {row['err']:.3e}, "
                             f"|x| {row['norm']:.12f}")
    rows["eigsh_32cubed"] = row
    return rows


def _als_sweep_flops(d, r, n, s, cg_iters):
    """FLOPs of one ALS sweep (fwd+bwd) with CG locals, as
    tools/solver_r64_probe.py counts them: per local solve ``cg_iters``
    matvecs at ~4 s n r^3, ~2 env advances and one QR per core."""
    matvec = 4.0 * s * n * r**3
    return 2 * d * (cg_iters * matvec + 2.0 * matvec + 2.0 * n * r**3)


def _eig_sweep_flops(d, r, n, s, iters):
    """FLOPs of one eigsh sweep with Lanczos locals (the probe's count):
    per local ``iters`` whitened applies and CGS2 reorthogonalization,
    plus env advances."""
    m = r * n * r
    applyf = 4.0 * s * n * r**3 + 8.0 * n * r**3
    return 2 * d * (iters * (applyf + 4.0 * iters * m) + 8.0 * s * n * r**3)


def _r64_leg(tnt, zp, ev):
    """8c: tools/solver_r64_probe.py on the card: K=14, rank 64, f32, CG
    and Lanczos locals of 8192 unknowns, fused ALS and fused eigsh at 5
    and 8 sweeps (tol -1: every sweep runs): the per-sweep time is the
    slope between them (host clock), the errors the 8-sweep solve's
    (eigsh: the reported lam and the returned vector's Rayleigh quotient
    recomputed on the CPU, both below the start's quotient); busy
    share, kernels and syncs come from a 2-sweep solve."""
    from tensor_networks_tpu_torch import packed

    f32 = torch.float32
    op = tnt.qtt_screened_laplacian(R64_K, delta=1.0, dtype=f32)
    rhs = packed.pad_rank(tnt.qtt_exponential(R64_K, c=3.0, dtype=f32), R64_RANK)
    s_op = op.mids.shape[1]
    calls = {
        "als": lambda sw: tnt.als_solve(op, rhs, rhs, sweeps=sw, tol=-1.0, spd=True,
                                        cg_iters=R64_ITERS),
        "eigsh": lambda sw: tnt.als_eigsh(op, rhs, sweeps=sw, tol=-1.0,
                                          lanczos_iters=R64_ITERS),
    }
    flops = {"als": _als_sweep_flops(R64_K, R64_RANK, 2, s_op, R64_ITERS),
             "eigsh": _eig_sweep_flops(R64_K, R64_RANK, 2, s_op, R64_ITERS)}
    lo, hi = R64_BUDGETS
    rows = {}
    for name, fn in calls.items():
        walls = {}
        for sw in (lo, hi):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(sw)
            torch.cuda.synchronize()
            walls[sw] = time.perf_counter() - t0
        per = (walls[hi] - walls[lo]) / (hi - lo)
        _, row = _solver_run(lambda: fn(2), zp, ev)
        row.update(sweeps=2, walls_s=walls, ms_per_sweep=1e3 * per,
                   gflops=flops[name] / per / 1e9, event_ms_per_sweep=row["event_ms"] / 2)
        _check_syncs(f"8c {name}", row, True)
        rows[name] = (row, out)
    als_row, (x, res, _) = rows["als"]
    rhs_cpu = packed.PackedTT(*(t.double().cpu() for t in rhs))
    rhs_norm = float(packed.norm_exact(rhs_cpu))
    als_row["resid"] = res / rhs_norm
    als_row["recomputed"] = _recomputed_residual(
        tnt, tnt.qtt_screened_laplacian(R64_K, delta=1.0, device="cpu"), rhs_cpu, x) / rhs_norm
    eig_row, (x, lam, _) = rows["eigsh"]
    op_cpu = tnt.qtt_screened_laplacian(R64_K, delta=1.0, device="cpu")
    exact = 1.0 + 2 - 2 * math.cos(math.pi / (2**R64_K + 1))
    eig_row["lam"] = lam
    eig_row["err"] = abs(lam - exact)
    eig_row["start_err"] = _recomputed_rayleigh(tnt, op_cpu, rhs) - exact
    eig_row["recomputed"] = _recomputed_rayleigh(tnt, op_cpu, x) - exact
    for what, got, bar in (("ALS relative residual", als_row["resid"], R64_ALS_BAR),
                           ("ALS recomputed residual", als_row["recomputed"],
                            3 * als_row["resid"] + 1e-7),
                           ("eigsh |lam - exact|", eig_row["err"],
                            min(R64_EIG_BAR, eig_row["start_err"])),
                           ("eigsh recomputed Rayleigh quotient - exact",
                            abs(eig_row["recomputed"]), min(R64_EIG_BAR, eig_row["start_err"]))):
        if not got <= bar:
            raise AssertionError(f"phase 8 8c: {what} {got:.3e} above {bar:.3e}")
    return {"als": als_row, "eigsh": eig_row}


def _eigsh_k_leg(tnt, zp, ev, pts):
    """8d: als_eigsh_k(k=3, slots) on qtt_screened_laplacian(14, delta=0.3)
    from pad_rank(qtt_exponential(14, c=2), 8), f64: the eigenvalues
    against delta + 2 - 2 cos(j pi / (2^14 + 1)), j = 1..3, and the
    pairwise |<v_i, v_j>| through H1 (counters reset before the solve
    and read after it)."""
    from tensor_networks_tpu_torch import packed

    K, delta = 14, 0.3
    op = tnt.qtt_screened_laplacian(K, delta=delta)
    x0 = packed.pad_rank(tnt.qtt_exponential(K, c=2.0), 8)
    (vecs, vals), row = _solver_run(lambda: tnt.als_eigsh_k(op, x0, 3), zp, ev)
    if row["launches"]["zipper"] == 0:  # the clean Rayleigh quotients' H1 calls
        raise AssertionError(f"phase 8 8d launched no H1: {row['launches']}")
    exact = [delta + 2 - 2 * math.cos(j * math.pi / (2**K + 1)) for j in (1, 2, 3)]
    row["vals"] = vals
    row["rel_err"] = [abs(v - e) / e for v, e in zip(vals, exact)]
    _reset_counts(zp, ev)
    row["overlaps"] = [abs(float(packed.inner(vecs[i], vecs[j])))
                       for i in range(3) for j in range(i + 1, 3)]
    row["launches_overlaps"] = _counts(zp, ev)
    row["sweeps"] = row["syncs"].get("stop test", 0)  # over the three solves
    row["ms_per_sweep"] = row["event_ms"] / max(row["sweeps"], 1)
    row["syncs_per_sweep"] = {k: v / max(row["sweeps"], 1) for k, v in row["syncs"].items()}
    if row["launches_overlaps"]["zipper"] != 3:
        raise AssertionError(f"phase 8 8d overlaps: launches {row['launches_overlaps']}")
    if not (max(row["rel_err"]) <= EIGK_BAR and max(row["overlaps"]) <= EIGK_BAR):
        raise AssertionError(f"phase 8 8d: eigenvalue errors {row['rel_err']}, "
                             f"overlaps {row['overlaps']}, bar {EIGK_BAR:g}")
    bits = torch.from_numpy((pts[:, None] >> np.arange(K)[None, :]) & 1).to(vecs[0].first.device)
    return row, _h1_h2_at(zp, ev, vecs[0], vecs[1], bits)


def _adaptive_leg(tnt, zp, ev):
    """8e: als_solve_adaptive on qtt_screened_laplacian_nd(bits, 3,
    delta=1), rhs qtt_exponential_nd(bits, (2, 3, 1.5)), eps 1e-10, rank
    2 to 16, 2 sweeps a rank, enrichment on and off, f64: at 3 bits per
    axis (``tests/test_als_solver.py:218``: both reach 1e-10, enrichment
    in no more sweeps) and at 5, where rank 16 does not reach 1e-10 in
    either package and each run is held just above the readings of
    both (:data:`ADAPTIVE_RUNS`)."""
    from tensor_networks_tpu_torch import packed

    rows = {}
    for bits, bars in ADAPTIVE_RUNS:
        op = tnt.qtt_screened_laplacian_nd(bits, 3, delta=1.0)
        rhs = tnt.qtt_exponential_nd(bits, (2.0, 3.0, 1.5))
        op_cpu = tnt.qtt_screened_laplacian_nd(bits, 3, delta=1.0, device="cpu")
        rhs_cpu = tnt.qtt_exponential_nd(bits, (2.0, 3.0, 1.5), device="cpu")
        rhs_norm = float(packed.norm_exact(rhs_cpu))
        for enrich in (True, False):
            key = f"{bits}bit_{'enrich' if enrich else 'pad'}"
            (x, res, hist), row = _solver_run(lambda: tnt.als_solve_adaptive(
                op, rhs, eps=1e-10, rank=2, max_rank=16, sweeps_per_rank=2, enrich=enrich),
                zp, ev)
            row.update(sweeps=len(hist), rank=x.rank, resid=res / rhs_norm,
                       recomputed=_recomputed_residual(tnt, op_cpu, rhs_cpu, x) / rhs_norm)
            row["ms_per_sweep"] = row["event_ms"] / len(hist)
            row["syncs_per_sweep"] = {k: v / len(hist) for k, v in row["syncs"].items()}
            bar = bars["enrich" if enrich else "pad"]
            if not (row["resid"] <= bar and row["recomputed"] <= 3 * row["resid"] + 1e-14):
                raise AssertionError(f"phase 8 8e {key}: residual {row['resid']:.3e} reported, "
                                     f"{row['recomputed']:.3e} recomputed, bar {bar:.3e}")
            rows[key] = row
        if rows[f"{bits}bit_enrich"]["sweeps"] > rows[f"{bits}bit_pad"]["sweeps"]:
            raise AssertionError(f"phase 8 8e at {bits} bits: enrichment took more sweeps "
                                 f"than padding")
    return rows


def _print_solver_row(name, row):
    syncs = ", ".join(f"{k} {v:.2f}" for k, v in row.get("syncs_per_sweep", {}).items())
    extra = {k: row[k] for k in ("resid", "recomputed", "err", "start_err", "lam", "rel_err",
                                 "overlaps",
                                 "gflops", "rank", "launches") if k in row}
    print(f"  {name}: wall {row['wall_s']:.3f} s, {row.get('sweeps')} sweeps, "
          f"{row.get('ms_per_sweep', float('nan')):.2f} ms a sweep (CUDA events, "
          f"{row['event_ms']:.1f} ms a call); device busy {row['busy_ms']:.1f} ms "
          f"({100 * row['busy_share']:.0f}% of the wall) over {row['kernels']} kernels; "
          f"host syncs {row['syncs']} ({syncs} a sweep); top kernels "
          f"{[(n, round(ms, 2), c) for n, ms, c in row['top']]}; {extra}")


def phase_solvers(zp, ev):
    """The ALS linear solver and the DMRG eigensolver on the card at
    bench.py's solver configurations (8a-8e), each leg to its bars."""
    import tensor_networks_tpu_torch as tnt

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("phase 8 runs with TF32 off")
    pts_rng = np.random.default_rng(SEED + 40)
    print("phase 8 ALS and DMRG on the card:")
    t0 = time.perf_counter()
    # the dense local solve is a minimum-norm SVD solve: gels (all that
    # torch.linalg.lstsq has on CUDA) assumes full rank, and the end
    # bonds' locals are singular; refused for the whole phase
    real_lstsq = torch.linalg.lstsq

    def refuse_lstsq(*args, **kw):
        raise AssertionError("phase 8: torch.linalg.lstsq called")

    torch.linalg.lstsq = refuse_lstsq
    try:
        # first calls set up cuSOLVER and cuBLAS: one small solve of each
        # kind and dtype before the timed legs
        for dtype in (torch.float64, torch.float32):
            op = tnt.qtt_screened_laplacian(6, delta=1.0, dtype=dtype)
            x0 = tnt.packed.pad_rank(tnt.qtt_exponential(6, c=3.0, dtype=dtype), 8)
            tnt.als_solve(op, x0, x0, sweeps=1)
            tnt.als_solve(op, x0, x0, sweeps=1, dense_limit=0, cg_iters=2, spd=True)
            tnt.als_eigsh(op, x0, sweeps=1)
            tnt.als_eigsh(op, x0, sweeps=1, dense_limit=0, lanczos_iters=2)
        torch.cuda.synchronize()
        print(f"  warm-up (K=6 solves of each kind): {time.perf_counter() - t0:.2f} s")
        out, kernels_at = {}, {}
        out["8a"], kernels_at = _als22_leg(tnt, zp, ev, pts_rng.integers(0, 2**22, B))
        for k, r in out["8a"].items():
            if isinstance(r, dict):
                _print_solver_row(f"8a K=22 rank 8 {k}", r)
        print(f"  8a ms a sweep, fused over host: f64 {out['8a']['f64_fused_over_host']:.3f}, "
              f"f32 {out['8a']['f32_fused_over_host']:.3f}")
        out["8b"] = _solver_cpu_leg(tnt, zp, ev)
        for k, r in out["8b"].items():
            _print_solver_row(f"8b {k}", r)
        out["8c"] = _r64_leg(tnt, zp, ev)
        for k, r in out["8c"].items():
            _print_solver_row(f"8c K=14 rank 64 f32 {k} (slope of {R64_BUDGETS})", r)
        out["8d"], kernels_at["8d"] = _eigsh_k_leg(tnt, zp, ev, pts_rng.integers(0, 2**14, B))
        _print_solver_row("8d als_eigsh_k k=3 K=14 rank 8 f64", out["8d"])
        out["8e"] = _adaptive_leg(tnt, zp, ev)
        for k, r in out["8e"].items():
            _print_solver_row(f"8e als_solve_adaptive {k}", r)
    finally:
        torch.linalg.lstsq = real_lstsq
    print("  torch.linalg.lstsq refused throughout phase 8: never called")
    for k, r in kernels_at.items():
        h1, h2 = r["h1"], r["h2"]
        print(f"  {k}: H1 kernel {h1['ms']:.4f} ms, plain {h1['plain_ms']:.4f}, bound "
              f"{h1['bound_ms']:.6f} by {h1['bound_by']}, err {h1['rel_err']:.1e}; H2 kernel "
              f"{h2['ms']:.4f} ms, plain {h2['plain_ms']:.4f}, bound {h2['bound_ms']:.6f} by "
              f"{h2['bound_by']}, err {h2['rel_err']:.1e}")
    wall = time.perf_counter() - t0
    print(f"  phase 8 wall {wall:.1f} s")
    keep = ("wall_s", "sweeps", "ms_per_sweep", "busy_share", "kernels", "syncs", "resid",
            "recomputed", "err", "start_err", "lam", "rel_err", "overlaps", "gflops", "rank")
    line = {leg: {k: ({f: _sig(v) for f, v in r.items() if f in keep}
                      if isinstance(r, dict) else _sig(r)) for k, r in rows.items()}
            for leg, rows in out.items() if leg != "8d"}
    line["8d"] = {f: _sig(v) for f, v in out["8d"].items() if f in keep}
    line["wall_s"] = _sig(wall)
    print(json.dumps({"solvers": line}, separators=(",", ":")))
    # every solve's launches (H1 takes 8d's clean Rayleigh quotients), and
    # H2's in the check of 8a's solutions
    launches = {f"{leg}_{k}": r["launches"] for leg in ("8a", "8b", "8c", "8e")
                for k, r in out[leg].items() if isinstance(r, dict)}
    launches["8d"] = out["8d"]["launches"]
    launches.update({f"8a_{k}_check": r["launches_grid"] for k, r in out["8a"].items()
                     if isinstance(r, dict)})
    return out, kernels_at, launches


def _sig(x):
    """``x`` with every float cut to 4 significant digits (the kernels
    line must stay near 2 KB; the phase lines print the full values)."""
    if isinstance(x, float):
        return float(f"{x:.4g}")
    if isinstance(x, dict):
        return {k: _sig(v) for k, v in x.items()}
    return x


def _kernel_numbers(t):
    """The measured part of a kernel's entry; no single PyTorch call
    computes a chain of d-2 dependent steps or the tile list, so
    library_ms is null.  Rows for other dtypes and shapes (phases 3 and
    5) and evaluate_ensemble's one call (phase 5) keep their times,
    bound and error."""
    out = {"max_abs_err": t["max_abs_err"], "ms": t["ms"],
           "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
           "bound_by": t["bound_by"], "library_ms": None}
    for group, keep in (("by_dtype", ("ms", "plain_ms", "bound_ms", "max_abs_err")),
                        ("ensemble", ("ms", "plain_ms", "separate_ms", "bound_ms")),
                        ("gmres", ("ms", "plain_ms", "bound_ms", "max_abs_err")),
                        ("solvers", ("ms", "plain_ms", "bound_ms", "max_abs_err"))):
        if group in t:
            out[group] = {k: {f: v[f] for f in keep} for k, v in t[group].items()}
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import tensor_networks_tpu_torch as tnt
    from tensor_networks_tpu_torch.kernels import _build
    from tensor_networks_tpu_torch.kernels import evaluate as ev
    from tensor_networks_tpu_torch.kernels import zipper as zp

    dev = torch.device("cuda:0")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    _build.cuda_library()
    parts = _build.BUILD_SECONDS.get("libtnt_kernels.so", {})
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc, {_build.NVCC_FLAGS[1]}; "
          "one nvcc per source, started together, then the link: "
          + (", ".join(f"{k} {v:.2f} s" for k, v in parts.items()) or "built before")
          + ")")
    print(f"card: {card}")

    phase_default_device()
    phase_kernels_vs_plain(zp, ev, dev)
    launches, pa, idx, main_train = phase_main_path(zp, ev, dev)
    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    pb = tnt.packed.PackedTT(*_train(g, D, N, R, 1 / math.sqrt(N * R)))
    times = phase_timings(zp, ev, pa, pb, idx, launches)
    times["chain"] = phase_zipper_routes(zp, list(stack(pa)), list(stack(pb)),
                                         times)
    half = phase_half_timings(zp, ev, dev)
    for name in ("inner", "chain", "evaluate"):
        times[name]["by_dtype"] = {k: v[name] for k, v in half.items()}
    phase_rounding(*main_train, dev)
    cross_out, cross_launches, target = phase_cross(ev, dev)
    mats = phase_cross_kernels(ev, dev, pa, idx)
    fiber_b = min(cross_out["cross_device"]["fiber_batch"], 65536)
    cross_times = phase_cross_timings(ev, dev, pa, idx, target,
                                      1 << (fiber_b - 1).bit_length(), mats)
    print(json.dumps({"cross": cross_out, "cross_timings": cross_times}))
    for key in ("f64", "f64_cross"):
        times["evaluate"]["by_dtype"][key] = cross_times[key]
    times["evaluate"]["ensemble"] = {k: cross_times[f"ensemble_{k}"] for k in ("f32", "f64")}
    _, round_launches = phase_rounding_families(zp, ev, *main_train[:3], dev)
    inner64 = phase_inner_f64_timings(zp, pa, pb, dev)
    times["inner"]["by_dtype"]["f64"] = inner64["f64"]
    times["chain"]["by_dtype"]["f64_err_norm"] = inner64["f64_err_norm"]
    gmres_out, gmres_launches = phase_gmres(zp, ev)
    for name, key in (("inner", "h1"), ("evaluate", "h2")):
        times[name]["gmres"] = {k: r["kernels_at"][key] for k, r in gmres_out.items()
                                if k != "C"}
    _, solver_kernels, solver_launches = phase_solvers(zp, ev)
    for name, key in (("inner", "h1"), ("evaluate", "h2")):
        times[name]["solvers"] = {k: r[key] for k, r in solver_kernels.items()}

    kernels = [
        {"name": "tt_inner_cuda", "route": "cuda",
         "source": "tensor_networks_tpu_torch/kernels/csrc/zipper.cu",
         "replaces": "tensor_networks_tpu/kernels/pallas_ops.py:502 tt_inner_pallas, "
                     ":229 tt_inner_pallas_fused",
         "launches": launches["zipper"], **_kernel_numbers(times["inner"]),
         "launches_rounding": round_launches["zipper"],
         "launches_gmres": {k: v["zipper"] for k, v in gmres_launches.items()},
         "launches_solvers": {k: v["zipper"] for k, v in solver_launches.items()}},
        {"name": "tt_inner_chain_cuda", "route": "cuda",
         "source": "tensor_networks_tpu_torch/kernels/csrc/zipper.cu",
         "replaces": "tensor_networks_tpu/kernels/pallas_ops.py:502 tt_inner_pallas, "
                     ":229 tt_inner_pallas_fused, above rank 128",
         "launches": launches["chain"], **_kernel_numbers(times["chain"]),
         "launches_rounding": round_launches["chain"],
         "launches_gmres": {k: v["chain"] for k, v in gmres_launches.items()},
         "launches_solvers": {k: v["chain"] for k, v in solver_launches.items()}},
        {"name": "tt_evaluate_cuda", "route": "cuda",
         "source": "tensor_networks_tpu_torch/kernels/csrc/evaluate.cu",
         "replaces": "tensor_networks_tpu/kernels/pallas_ops.py:424 tt_evaluate_pallas, "
                     "tensor_networks_tpu/kernels/ragged_eval.py:107 tt_evaluate_ragged",
         "launches": launches["evaluate"], **_kernel_numbers(times["evaluate"]),
         "launches_cross": cross_launches["by_dtype"],
         "launches_rounding": round_launches["evaluate"],
         "launches_gmres": {k: v["evaluate"] for k, v in gmres_launches.items()},
         "launches_solvers": {k: v["evaluate"] for k, v in solver_launches.items()}},
        {"name": "group_tiles_cuda", "route": "cuda",
         "source": "tensor_networks_tpu_torch/kernels/csrc/evaluate.cu",
         "replaces": "tensor_networks_tpu/kernels/ragged_eval.py:65 (group counts, XLA)",
         "launches": launches["tiles"], **_kernel_numbers(times["tiles"]),
         "launches_cross": cross_launches["tiles"],
         "launches_rounding": round_launches["tiles"],
         "launches_gmres": {k: v["tiles"] for k, v in gmres_launches.items()},
         "launches_solvers": {k: v["tiles"] for k, v in solver_launches.items()}},
    ]
    print(json.dumps({"kernels": [_sig(k) for k in kernels]}, separators=(",", ":")))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
