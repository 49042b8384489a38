#!/usr/bin/env python3
"""Where the sharded training step's time goes on one card.

    python3 tools/parallel_probe.py

Needs one CUDA card.  In a one-rank NCCL group on a (1, 1) mesh, at
``chip_smoke.py`` phase 12a's shape (d=50, n=32, r=100, f32, batches of
8192 points): the ms of each of 8 steps (CUDA events) of SGD and Adam,
with the plain forward and with H2's, the caching allocator's retries
and device allocations over them; the same steps with the layer's
all-reduces replaced by a copy (what the collectives cost on one rank);
and the host and device time of one NCCL all-reduce at the step's two
sizes.  Prints one JSON line.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

D, N, R, B, STEPS = 50, 32, 100, 8192, 8


def _steps(par, training, mesh, opt, fast):
    """ms of each step from the same start, and the allocator's counters."""
    init = par.init_tt_params(D, N, R, torch.float32, seed=1234, device="cuda")
    rng = np.random.default_rng(1354)
    if opt == "sgd":
        step, place_params, place_batch = par.make_train_step(mesh, fast_eval=fast)
    else:
        step, init_state, place_params, place_batch = training.make_adam_train_step(
            mesh, lr=1e-3, fast_eval=fast)
    batch = place_batch(rng.integers(0, N, (B, D)), rng.standard_normal(B).astype(np.float32))
    params = place_params(init)
    state = init_state(params) if opt == "adam" else None
    ms = []
    torch.cuda.synchronize()
    before = torch.cuda.memory_stats()
    for _ in range(STEPS):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        if state is None:
            params, loss = step(params, *batch, 0.1)
        else:
            params, state, loss = step(params, state, *batch)
        stop.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(stop))
    after = torch.cuda.memory_stats()
    return {"ms": [round(x, 3) for x in ms],
            "alloc_retries": after["num_alloc_retries"] - before["num_alloc_retries"],
            "device_allocs": after["num_device_alloc"] - before["num_device_alloc"]}


def _all_reduce_times(group, shape):
    x = torch.ones(shape, device="cuda")
    dist.all_reduce(x, group=group)
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(200):
        dist.all_reduce(x, group=group)
    stop.record()
    host = (time.perf_counter() - t0) / 200 * 1e3
    torch.cuda.synchronize()
    return {"host_ms": host, "event_ms": start.elapsed_time(stop) / 200}


def main() -> int:
    if not torch.cuda.is_available():
        print("parallel_probe: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    from tensor_networks_tpu_torch import parallel as par
    from tensor_networks_tpu_torch.parallel import mesh as pm
    from tensor_networks_tpu_torch.parallel import training

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1,
                            device_id=torch.device("cuda:0"))
    mesh = par.make_mesh((1, 1))
    out = {"card": card}
    for opt in ("sgd", "adam"):
        for fast in (False, True):
            out[f"{opt}_{'fast' if fast else 'plain'}"] = _steps(par, training, mesh, opt, fast)
    real = pm.all_reduce
    pm.all_reduce = lambda x, group, op=None: x.clone(memory_format=torch.contiguous_format)
    for opt in ("sgd", "adam"):
        out[f"{opt}_plain_no_collectives"] = _steps(par, training, mesh, opt, False)
    pm.all_reduce = real
    group = mesh.get_group("model")
    out["all_reduce"] = {f"{s[0]}x{s[1]}": _all_reduce_times(group, s) for s in ((R, R), (B, R))}
    dist.destroy_process_group()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
