#!/usr/bin/env python3
"""End-to-end check of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Builds the CUDA kernels from ``tensor_networks_tpu_torch/kernels/csrc``,
checks that the package's constructors default to the card, then runs
four phases:

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
   each method at d=12 in f64 for correctness.

Then a JSON line with phase 4's numbers, one with per-kernel results,
the card's name and power limit from ``nvidia-smi``, and, last, the
result line
``{"ok": true, "device": {...}}``.  Any failure raises and exits
nonzero without that line; without a CUDA device the script exits 2.
Imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

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
    """One call of ``fn`` under torch.profiler: the device-busy ms (the
    union of its kernels' and copies' intervals), the kernel count, and
    the three kernels with the most device time [(name, ms, launches)]."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    spans = sorted((e["ts"], e["ts"] + e["dur"], e["name"], e.get("cat"))
                   for e in events if e.get("ph") == "X"
                   and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    busy, end = 0.0, None
    for s0, s1, _, _ in spans:
        if end is None or s0 >= end:
            busy += s1 - s0
            end = s1
        elif s1 > end:
            busy += s1 - end
            end = s1
    per_kernel = {}
    for s0, s1, name, cat in spans:
        if cat == "kernel":
            us, count = per_kernel.get(name, (0.0, 0))
            per_kernel[name] = (us + s1 - s0, count + 1)
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:3]
    kernels = sum(c for _, c in per_kernel.values())
    return busy / 1e3, kernels, [(name[:60], us / 1e3, c) for name, (us, c) in top]


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
            busy, kernels, top = _device_profile(call)
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


def _kernel_numbers(t):
    """The measured part of a kernel's entry; no single PyTorch call
    computes a chain of d-2 dependent steps or the tile list, so
    library_ms is null."""
    out = {"max_abs_err": t["max_abs_err"], "ms": t["ms"],
           "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
           "bound_by": t["bound_by"], "library_ms": None}
    if "by_dtype" in t:  # the same kernel with 2-byte cores (phase 3)
        out["by_dtype"] = t["by_dtype"]
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

    kernels = [
        {"name": "tt_inner_cuda", "route": "cuda",
         "source": "tensor_networks_tpu_torch/kernels/csrc/zipper.cu",
         "replaces": "tensor_networks_tpu/kernels/pallas_ops.py:502 (tt_inner_pallas), "
                     "tensor_networks_tpu/kernels/pallas_ops.py:229 (tt_inner_pallas_fused)",
         "launches": launches["zipper"], **_kernel_numbers(times["inner"])},
        {"name": "tt_inner_chain_cuda", "route": "cuda",
         "source": "tensor_networks_tpu_torch/kernels/csrc/zipper.cu",
         "replaces": "tensor_networks_tpu/kernels/pallas_ops.py:502 (tt_inner_pallas), "
                     "tensor_networks_tpu/kernels/pallas_ops.py:229 (tt_inner_pallas_fused), "
                     "above rank 128",
         "launches": launches["chain"], **_kernel_numbers(times["chain"])},
        {"name": "tt_evaluate_cuda", "route": "cuda",
         "source": "tensor_networks_tpu_torch/kernels/csrc/evaluate.cu",
         "replaces": "tensor_networks_tpu/kernels/pallas_ops.py:424 (tt_evaluate_pallas), "
                     "tensor_networks_tpu/kernels/ragged_eval.py:107 (tt_evaluate_ragged)",
         "launches": launches["evaluate"], **_kernel_numbers(times["evaluate"])},
        {"name": "group_tiles_cuda", "route": "cuda",
         "source": "tensor_networks_tpu_torch/kernels/csrc/evaluate.cu",
         "replaces": "tensor_networks_tpu/kernels/ragged_eval.py:65 (the group counts "
                     "of tt_evaluate_ragged, XLA ops there)",
         "launches": launches["tiles"], **_kernel_numbers(times["tiles"])},
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
