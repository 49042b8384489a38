"""What the example scripts and ``tools/scaling_probe_torch.py`` share: the
device of a run, a wall clock that waits for the card, a slope timer,
trains from NumPy or torch cores and their dense vectors, the process
group of the distributed scripts, and the ``--device`` flag."""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def device_of(device=None) -> torch.device:
    """The device a run uses: the card unless ``device`` names another.
    Raises when the card is asked for and there is none; nothing falls
    back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run on the CPU")
    return dev


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def clock(dev: torch.device) -> float:
    """``time.perf_counter()`` once the card has finished its work."""
    sync(dev)
    return time.perf_counter()


def _chained_ms(fn, k: int, dev: torch.device) -> float:
    """ms of ``k`` chained ``fn()`` calls (CUDA events on the card, the host
    clock elsewhere); every output is added into an accumulator that is
    read and checked finite, so no call's work can be skipped."""
    acc = torch.zeros((), dtype=torch.float64, device=dev)
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(k):
            acc = acc + fn().sum()
        stop.record()
        torch.cuda.synchronize(dev)
        ms = start.elapsed_time(stop)
    else:
        t0 = time.perf_counter()
        for _ in range(k):
            acc = acc + fn().sum()
        ms = (time.perf_counter() - t0) * 1e3
    if not torch.isfinite(acc):
        raise AssertionError("timed outputs are not finite")
    return ms


def slope_ms(fn, ks, dev: torch.device, reps: int = 1):
    """ms of one ``fn()`` call and the best runs behind it: the best of
    ``reps`` runs of ``k`` chained calls for each ``k`` in ``ks`` (after
    one untimed run each), the difference over the difference in ``k``,
    so the fixed costs of a timed run cancel."""
    for k in ks:
        _chained_ms(fn, k, dev)
    best = [min(_chained_ms(fn, k, dev) for _ in range(reps)) for k in ks]
    return max((best[1] - best[0]) / (ks[1] - ks[0]), 1e-6), best


def parser(doc: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=doc.strip().splitlines()[0])
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' to run without one)")
    return p


def tt_network(indices, cores, device):
    """A tensor train of the NumPy arrays or tensors ``cores`` (first
    ``(n, r)``, middles ``(r, n, r)``, last ``(r, n)``) on ``device``, with
    the node and bond names of ``TensorNetwork.rand_tt``."""
    from tensor_networks_tpu_torch import Index, Tensor, TensorNetwork

    d = len(indices)
    bonds = [Index(f"r{k + 1}", cores[k].shape[-1]) for k in range(d - 1)]
    net = TensorNetwork()
    for k, core in enumerate(cores):
        legs = ([indices[0], bonds[0]] if k == 0 else
                [bonds[-1], indices[-1]] if k == d - 1 else
                [bonds[k - 1], indices[k], bonds[k]])
        net.add_node(k, Tensor(torch.as_tensor(core, device=device), legs))
        if k:
            net.add_edge(k - 1, k)
    return net



def dense_vector(x) -> np.ndarray:
    """The vector a packed train represents (cores in order, the first
    slowest)."""
    v = x.first.cpu().numpy()
    for core in x.mids.cpu().numpy():
        v = np.einsum("xr,rns->xns", v, core).reshape(-1, core.shape[-1])
    return (v @ x.last.cpu().numpy()).reshape(-1)


def join_group(dev: torch.device) -> bool:
    """Join the default process group unless this process holds one:
    under ``torchrun`` the job's group (``env://``), else a one-rank
    group.  NCCL on the card, gloo on the CPU.  True when this call
    made the group (the caller then destroys it)."""
    import os

    import torch.distributed as dist

    if dist.is_initialized():
        return False
    backend = "nccl" if dev.type == "cuda" else "gloo"
    extra = {}
    if dev.type == "cuda":
        extra["device_id"] = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    if "RANK" in os.environ:
        dist.init_process_group(backend, **extra)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1, **extra)
    return True


def rank_device(dev: torch.device) -> torch.device:
    """This rank's device: its own card (``LOCAL_RANK``) or the CPU."""
    import os

    if dev.type == "cuda":
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return dev
