#!/usr/bin/env python3
"""The train-sharded solvers across the cards of one host, against the
fused single-device solvers.

    python3 tools/parallel_solvers_probe.py [--ranks 4] [--device cpu]

Starts ``--ranks`` processes, one a card (``--device cpu``: gloo ranks on
the CPU), in a group at ``tcp://localhost`` and builds a (1, P) mesh.
Every rank runs each train-sharded solver on ``tests/test_sweeps.py``'s
K=10 systems (8 middle cores) and, for the hops' cost, 8a's K=22 ALS
(20 middle cores), in f64; every rank also runs the fused solver at the
same knobs.  Rank 0 gathers the blocks and holds each result to the
fused one: the represented tensors (``norm_exact`` of the difference)
and the records, relative to at least 1e-2 (residuals at roundoff).  It
times both forms, each after an untimed first call (CUDA events on the
card, the host clock on the CPU), and counts the layer's hops,
broadcasts and all-reduces a call.  Prints one JSON line; exits 1 if a
result is further than 1e-10 from the fused one.
"""

from __future__ import annotations

import argparse
import datetime
import json
import multiprocessing
import os
import socket
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

TOL = 1e-10


def _cases(tnt, par, packed, dev):
    """name -> (the sharded call on a mesh, the fused call)."""
    K = 10
    op = tnt.qtt_screened_laplacian(K, delta=1.0, device=dev)
    rhs = tnt.qtt_exponential(K, c=3.0, device=dev)
    x0 = packed.pad_rank(rhs, 6)
    lap = tnt.qtt_screened_laplacian(K, delta=0.5, device=dev)
    e0 = packed.pad_rank(tnt.qtt_exponential(K, c=2.0, device=dev), 6)
    h = 1.0 / (2**K + 1)
    A = tnt.qtt_tridiagonal(K, 2.0 / h, -1.0 / h, -1.0 / h, device=dev)
    M = tnt.qtt_tridiagonal(K, 4.0 * h / 6, h / 6, h / 6, device=dev)
    T = tnt.qtt_tridiagonal(K, 2.0, -1.0, -1.0, device=dev)
    u4 = packed.pad_rank(rhs, 4)
    op22 = tnt.qtt_screened_laplacian(22, delta=1.0, device=dev)
    rhs22 = tnt.qtt_exponential(22, c=3.0, device=dev)
    lz = dict(sweeps=3, tol=-1.0, dense_limit=0, lanczos_iters=12)
    return {
        "als": (lambda m: par.als_solve_sharded(m, op, rhs, x0, sweeps=2, tol=0.0, spd=True),
                lambda: tnt.als_solve(op, rhs, x0, sweeps=2, tol=0.0, spd=True)),
        "als_adaptive": (
            lambda m: par.als_solve_adaptive_sharded(m, op, rhs, eps=1e-10, rank=2, max_rank=16,
                                                     spd=True, enrich=False),
            lambda: tnt.als_solve_adaptive(op, rhs, eps=1e-10, rank=2, max_rank=16, spd=True,
                                           enrich=False)),
        "eigsh": (lambda m: par.als_eigsh_sharded(m, lap, e0, sweeps=4),
                  lambda: tnt.als_eigsh(lap, e0, sweeps=4)),
        "eigsh_mass": (lambda m: par.als_eigsh_sharded(m, A, e0, sweeps=4, mass=M),
                       lambda: tnt.als_eigsh(A, e0, sweeps=4, mass=M)),
        "eigsh_lanczos": (lambda m: par.als_eigsh_sharded(m, lap, e0, **lz),
                          lambda: tnt.als_eigsh(lap, e0, **lz)),
        "eigsh_k": (lambda m: par.als_eigsh_k_sharded(m, lap, e0, 3, sweeps=6),
                    lambda: tnt.als_eigsh_k(lap, e0, 3, sweeps=6)),
        "tdvp": (lambda m: par.evolve_tdvp_sharded(m, T, u4, 0.03, 3),
                 lambda: tnt.evolve_tdvp(T, u4, 0.03, 3)),
        "tdvp2": (lambda m: par.evolve_tdvp2_sharded(m, op, rhs, 0.05, 3, max_rank=8, eps=1e-10),
                  lambda: tnt.evolve_tdvp2(op, rhs, 0.05, 3, max_rank=8, eps=1e-10)),
        "theta": (lambda m: par.evolve_theta_sharded(m, op, x0, 0.01, 3, theta=1.0, spd=True),
                  lambda: tnt.evolve_theta(op, x0, 0.01, 3, theta=1.0, spd=True)),
        "als_k22": (
            lambda m: par.als_solve_sharded(m, op22, rhs22, packed.pad_rank(rhs22, 8), sweeps=3,
                                            tol=0.0, spd=True),
            lambda: tnt.als_solve(op22, rhs22, packed.pad_rank(rhs22, 8), sweeps=3, tol=0.0,
                                  spd=True)),
    }


def _whole(mesh, t, packed):
    """A result train with its blocks gathered over the model group."""
    group = mesh.get_group("model")
    parts = [torch.empty_like(t.mids) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.mids.contiguous(), group=group)
    return packed.PackedTT(t.first, torch.cat(parts), t.last)


def _timed(call, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = call()
        stop.record()
        torch.cuda.synchronize()
        return out, start.elapsed_time(stop)
    t0 = time.perf_counter()
    out = call()
    return out, 1e3 * (time.perf_counter() - t0)


def _rank(rank: int, world: int, port: int, device: str, out_path: str) -> None:
    torch.set_num_threads(1)
    import tensor_networks_tpu_torch as tnt
    from tensor_networks_tpu_torch import parallel as par
    from tensor_networks_tpu_torch.ops import packed
    from tensor_networks_tpu_torch.parallel import mesh as pm

    backend = "nccl" if device == "cuda" else "gloo"
    kw = {"device_id": torch.device("cuda", rank)} if device == "cuda" else {}
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=300), **kw)
    dev = torch.device("cuda", rank) if device == "cuda" else torch.device("cpu")
    if device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    mesh = par.make_mesh((1, world), devices=None if device == "cuda" else "cpu")
    rows, worst = {}, 0.0
    for name, (sharded, fused) in _cases(tnt, par, packed, dev).items():
        sharded(mesh)  # the first calls of each shape, untimed
        fused()
        for c in (pm.all_reduce, pm.broadcast, pm.hop):
            c.calls = 0
        got, ms = _timed(lambda: sharded(mesh), dev)
        counts = {"all_reduce": pm.all_reduce.calls, "broadcast": pm.broadcast.calls,
                  "hop": pm.hop.calls}
        ref, fms = _timed(fused, dev)
        x, xf = got[0], ref[0]
        if name == "eigsh_k":
            x, xf = x[0], xf[0]
        x = _whole(mesh, x, packed)
        x64, xf64 = (packed.PackedTT(*(t.double() for t in z)) for z in (x, xf))
        state = float(packed.norm_exact(packed.add(x64, packed.scale(xf64, -1.0)))
                      / packed.norm_exact(xf64))
        # records: relative, each value's scale at least 1e-2 (a residual
        # at roundoff, ~1e-14 of an O(1) right-hand side, is held to 1e-12)
        rec = max([float(np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
                                / np.maximum(np.abs(np.asarray(b, np.float64)), 1e-2)))
                   for a, b in zip(got[1:], ref[1:]) if np.size(b)] or [0.0])
        worst = max(worst, state, rec)
        rows[name] = {"state": state, "records": rec, "ms": ms, "fused_ms": fms, **counts}
    if rank == 0:
        name = torch.cuda.get_device_name(rank) if device == "cuda" else "cpu"
        with open(out_path, "w") as f:
            json.dump({"device": name, "ranks": world, "worst": worst, "cases": rows}, f)
    dist.destroy_process_group()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args()
    if args.device == "cuda" and torch.cuda.device_count() < args.ranks:
        print(f"needs {args.ranks} CUDA cards, found {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    out_path = os.path.join(os.environ.get("TMPDIR", "/tmp"), f"solvers_probe_{port}.json")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank, args=(r, args.ranks, port, args.device, out_path))
             for r in range(args.ranks)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(900)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    codes = [p.exitcode for p in procs]
    if codes != [0] * args.ranks:
        print(f"ranks exited {codes}", file=sys.stderr)
        return 1
    with open(out_path) as f:
        result = json.load(f)
    os.remove(out_path)
    print(json.dumps(result, separators=(",", ":")))
    return 0 if result["worst"] <= TOL else 1


if __name__ == "__main__":
    sys.exit(main())
