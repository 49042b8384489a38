#!/usr/bin/env python3
"""End-to-end check of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Builds the CUDA kernels from ``tensor_networks_tpu_torch/kernels/csrc``,
then runs three phases, one output line each:

1. every kernel against its plain PyTorch version on the card, in float32
   and float64, at the main path's shapes and at odd ones, with a
   float64 plain result as the reference;
2. the main path at full size (d=50 cores, mode n=32, rank r=100, f32):
   build two trains, pack, inner product and norm, fixed-rank rounding
   of ``a + a``, evaluation at 8192 points -- with the kernels' launch
   counters reset just before and read just after;
3. kernel and plain timings at the main path's shapes (CUDA events).

Then a JSON line with per-kernel results, the card's name and power
limit from ``nvidia-smi``, and, last, the result line
``{"ok": true, "device": {...}}``.  Any failure raises and exits
nonzero without that line; without a CUDA device the script exits 2.
Imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 1234
D, N, R, B = 50, 32, 100, 8192


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
    """H1 and H2 against their plain versions, f32 and f64."""
    g = torch.Generator(device=dev).manual_seed(SEED)
    worst = {"inner": 0.0, "evaluate": 0.0}
    checks = 0
    tol = {torch.float32: 1e-4, torch.float64: 1e-10}
    # (d, n, r_a, r_b): the main path, odd sizes, mixed ranks, d = 3, the
    # rank-256 and rank-512 envelope
    for d, n, ra, rb in [(D, N, R, R), (7, 5, 37, 37), (7, 5, 64, 96),
                         (3, 6, 9, 4), (10, 8, 256, 256), (4, 4, 512, 300)]:
        a64 = _train(g, d, n, ra, 1 / math.sqrt(n * ra), dtype=torch.float64)
        b64 = _train(g, d, n, rb, 1 / math.sqrt(n * rb), dtype=torch.float64)
        na = math.sqrt(zp.tt_inner_plain(*a64, *a64).item())
        nb = math.sqrt(zp.tt_inner_plain(*b64, *b64).item())
        # <a, b> of independent trains is near 0 at large d; <a, a> is not
        for x64, y64, scale in ((a64, b64, na * nb), (a64, a64, na * na)):
            ref = zp.tt_inner_plain(*x64, *y64).item()
            for dt in (torch.float32, torch.float64):
                args = [x.to(dt).contiguous() for x in x64 + y64]
                for name, val in (("kernel", zp.tt_inner_cuda(*args)),
                                  ("plain", zp.tt_inner_plain(*args))):
                    err = abs(val.item() - ref) / scale
                    if not err <= tol[dt]:
                        raise AssertionError(
                            f"inner {name} d={d} n={n} ra={ra} rb={rb} {dt}: "
                            f"|got-ref|/(|a||b|) = {err:.3e} > {tol[dt]}")
                    worst["inner"] = max(worst["inner"], err / tol[dt])
                    checks += 1

    # (d, n, r, B, pattern): point values O(1) with mids scaled 1/sqrt(r)
    for d, n, r, bsz, pattern in [(D, N, R, B, "random"), (D, N, R, 1000, "random"),
                                  (D, N, R, 1000, "one-mode"), (7, 5, 37, 1000, "random"),
                                  (10, 8, 256, 1000, "random"), (4, 4, 512, 300, "random")]:
        cores64 = _train(g, d, n, r, 1 / math.sqrt(r), dtype=torch.float64)
        if pattern == "one-mode":
            idx = torch.full((bsz, d), 3, device=dev, dtype=torch.int32)
        else:
            idx = torch.randint(0, n, (bsz, d), generator=g, device=dev,
                                dtype=torch.int32)
        ref = ev.tt_evaluate_plain(*cores64, idx)
        scale = ref.abs().max().item()
        for dt in (torch.float32, torch.float64):
            cores = [x.to(dt).contiguous() for x in cores64]
            for name, val in (("kernel", ev.tt_evaluate_cuda(*cores, idx)),
                              ("plain", ev.tt_evaluate_plain(*cores, idx))):
                err = (val.double() - ref).abs().max().item() / scale
                if not err <= tol[dt]:
                    raise AssertionError(
                        f"evaluate {name} d={d} n={n} r={r} B={bsz} "
                        f"{pattern} {dt}: max err / max|ref| = {err:.3e}")
                worst["evaluate"] = max(worst["evaluate"], err / tol[dt])
                checks += 1
    torch.cuda.synchronize()
    print(f"phase 1 kernels vs plain: ok, {checks} checks, worst err/tol "
          f"inner {worst['inner']:.3g} evaluate {worst['evaluate']:.3g}")


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
        tn = TensorNetwork.rand_tt(inds, [R] * (D - 1), dtype=torch.float32,
                                   device=dev, generator=g)
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
    ev.tt_evaluate_cuda.launches = 0
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
                "evaluate": ev.tt_evaluate_cuda.launches}

    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel was not launched on the main path: {launches}")
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
        f"<a,b>={ip.item():.6e} |a|={nrm.item():.6e} ranks {ranks[0]},"
        f"{ranks[1]}x{len(ranks) - 2},{ranks[-1]} eval rel err "
        + ", ".join(f"{k} {v[0]:.2e}" for k, v in errs.items())
        + f"; wall s: pack+inner+norm+fast {t1 - t0:.4f}, round(a+a) {t2 - t1:.4f}, "
        f"3 evaluates {t3 - t2:.4f}"
    )
    return launches, pa, idx


def stack(p):
    return p.first, p.mids, p.last


def phase_timings(zp, ev, pa, pb_like, idx):
    """Kernel vs plain at the main path's shapes, turns P K K P."""
    a = list(stack(pa))
    b = list(stack(pb_like))
    idx32 = idx.to(torch.int32).contiguous()
    inner_k = lambda: zp.tt_inner_cuda(*a, *b)  # noqa: E731
    inner_p = lambda: zp.tt_inner_plain(*a, *b)  # noqa: E731
    eval_k = lambda: ev.tt_evaluate_cuda(*a, idx32)  # noqa: E731
    eval_p = lambda: ev.tt_evaluate_plain(*a, idx32)  # noqa: E731
    res = {}
    for name, k, p in (("inner", inner_k, inner_p), ("evaluate", eval_k, eval_p)):
        tp1, tk1, tk2, tp2 = _time_ms(p), _time_ms(k), _time_ms(k), _time_ms(p)
        err = (k().double() - p().double()).abs().max().item()
        res[name] = {"ms": (tk1 + tk2) / 2, "plain_ms": (tp1 + tp2) / 2,
                     "runs_ms": [tp1, tk1, tk2, tp2], "max_abs_err": err}
    print("phase 3 timings (ms, order plain kernel kernel plain): "
          + "; ".join(f"{k} kernel {v['ms']:.4f} plain {v['plain_ms']:.4f} runs "
                      + ",".join(f"{x:.4f}" for x in v["runs_ms"])
                      for k, v in res.items()))
    return res


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

    phase_kernels_vs_plain(zp, ev, dev)
    launches, pa, idx = phase_main_path(zp, ev, dev)
    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    pb = tnt.packed.PackedTT(*_train(g, D, N, R, 1 / math.sqrt(N * R)))
    times = phase_timings(zp, ev, pa, pb, idx)

    kernels = [
        {"name": "tt_inner_cuda", "route": "cuda",
         "source": "tensor_networks_tpu_torch/kernels/csrc/zipper.cu",
         "replaces": "tensor_networks_tpu/kernels/pallas_ops.py:502 (tt_inner_pallas), "
                     "tensor_networks_tpu/kernels/pallas_ops.py:229 (tt_inner_pallas_fused)",
         "launches": launches["zipper"], "max_abs_err": times["inner"]["max_abs_err"],
         "ms": times["inner"]["ms"], "plain_ms": times["inner"]["plain_ms"]},
        {"name": "tt_evaluate_cuda", "route": "cuda",
         "source": "tensor_networks_tpu_torch/kernels/csrc/evaluate.cu",
         "replaces": "tensor_networks_tpu/kernels/pallas_ops.py:424 (tt_evaluate_pallas), "
                     "tensor_networks_tpu/kernels/ragged_eval.py:107 (tt_evaluate_ragged)",
         "launches": launches["evaluate"], "max_abs_err": times["evaluate"]["max_abs_err"],
         "ms": times["evaluate"]["ms"], "plain_ms": times["evaluate"]["plain_ms"]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
