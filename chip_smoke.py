#!/usr/bin/env python3
"""End-to-end check of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Builds the CUDA kernels from ``tensor_networks_tpu_torch/kernels/csrc``,
checks that the package's constructors default to the card, then runs
three phases:

1. every kernel against its plain PyTorch version on the card, in float32
   and float64, at the main path's shapes and at odd ones, with a
   float64 plain result as the reference: the inner product on both of
   its routes (the fused steps up to rank 128, the chain above) and
   twice each for bit-identical outputs; the grouped evaluation kernel
   also at the index patterns that stress its grouping tables, and twice
   for bit-identical outputs;
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
   (torch.profiler), and the chain at ranks (256, 256) and (512, 300).

Then a JSON line with per-kernel results, the card's name and power
limit from ``nvidia-smi``, and, last, the result line
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
    return dict(launches, chain=launches_chain), pa, idx


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
            "zipper_epilogue")
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


def _kernel_numbers(t):
    """The measured part of a kernel's entry; no single PyTorch call
    computes a chain of d-2 dependent steps or the tile list, so
    library_ms is null."""
    return {"max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None}


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
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc, {_build.NVCC_FLAGS[1]})")
    print(f"card: {card}")

    phase_default_device()
    phase_kernels_vs_plain(zp, ev, dev)
    launches, pa, idx = phase_main_path(zp, ev, dev)
    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    pb = tnt.packed.PackedTT(*_train(g, D, N, R, 1 / math.sqrt(N * R)))
    times = phase_timings(zp, ev, pa, pb, idx, launches)
    times["chain"] = phase_zipper_routes(zp, list(stack(pa)), list(stack(pb)),
                                         times)

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
