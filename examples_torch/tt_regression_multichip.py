"""Sharded TT regression (tensor completion): the multi-card training demo.

The port of ``examples/tt_regression_multichip.py``.  Fits a tensor
train to sampled entries of a hidden low-rank target by Adam, with the
sample batch split over the mesh's ``data`` axis (DP) and every core's
mode dimension split over ``model`` (TP); the gradients and the model
sums are ``torch.distributed`` collectives.

On cards the mesh is model = max(1, P // 2), data = P // model; on the
CPU (gloo) every rank is on the model axis (data = 1), as in the JAX
script.

Run on P cards with ``torchrun --standalone --nproc_per_node=P
examples_torch/tt_regression_multichip.py``; a plain ``python3`` run is
a one-rank group, ``--device cpu`` a gloo group on the CPU.
"""

from __future__ import annotations

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import sys

import numpy as np
import torch
import torch.distributed as dist

from examples_torch._common import clock, device_of, join_group, parser, tt_network
from tensor_networks_tpu_torch import Index
from tensor_networks_tpu_torch.parallel import init_tt_params, make_mesh
from tensor_networks_tpu_torch.parallel.mesh import mesh_device
from tensor_networks_tpu_torch.parallel.training import make_adam_train_step


def main(d: int = 6, n: int = 16, r: int = 4, steps: int = 100, device=None) -> dict:
    dev = device_of(device)
    owned = join_group(dev)
    n_dev = dist.get_world_size()
    if dev.type == "cpu":
        data, model = 1, n_dev
    else:
        model = max(1, n_dev // 2) if n_dev > 1 else 1
        data = n_dev // model
    mesh = make_mesh((data, model), ("data", "model"),
                     devices=None if dev.type == "cuda" else dev.type)
    dev = mesh_device(mesh)
    lead = dist.get_rank() == 0
    say = (lambda *a: print(*a, file=sys.stderr)) if lead else (lambda *a: None)
    say(f"[train] mesh data={data} x model={model} ({dev.type})")

    # hidden target: a rank-3 train (the JAX script's legacy draws)
    legacy = np.random.RandomState(0)
    indices = [Index(f"x{i}", n) for i in range(d)]
    shapes = [(n, 3)] + [(3, n, 3)] * (d - 2) + [(3, n)]
    target = tt_network(indices, [legacy.randn(*s).astype(np.float32) for s in shapes], dev)
    target.scale(float(n) ** (-d / 2))  # O(1) entries

    batch = 1024
    idx = legacy.randint(0, n, size=(batch, d))
    y = np.asarray(target.evaluate(target.free_indices(), idx)).astype(np.float32)
    y = y / np.sqrt(np.mean(y**2))  # unit-RMS targets

    params = init_tt_params(d, n, r, dtype=torch.float32, seed=1, device=dev)
    step, init_state, place_params, place_batch = make_adam_train_step(mesh, lr=2e-2)
    params = place_params(params)
    opt_state = init_state(params)
    idx_dev, y_dev = place_batch(idx, y)

    losses = []
    t0 = clock(dev)
    for it in range(steps):
        params, opt_state, loss = step(params, opt_state, idx_dev, y_dev)
        if it % 50 == 0 or it == steps - 1:
            losses.append(float(loss))
            say(f"[train] step {it:4d}  mse {losses[-1]:.3e}")
    wall = clock(dev) - t0

    final = float(loss)
    rel = np.sqrt(final) / np.sqrt(np.mean(y**2))
    say(f"[train] final relative fit error: {rel:.3e} ({wall / steps * 1e3:.2f} ms a step)")
    if owned:
        dist.destroy_process_group()
    return {"mesh": (data, model), "final_mse": final, "first_mse": losses[0],
            "rel_err": float(rel), "ms_per_step": wall / steps * 1e3}


if __name__ == "__main__":
    main(device=parser(__doc__).parse_args().device)
