"""Training-state checkpoints: an ``.npz`` of the arrays and a ``.json``
of the state's structure.

Counterpart of ``tensor_networks_tpu/parallel/checkpoint.py`` (its npz
fallback; orbax is JAX's).  As orbax saves global arrays, the params and
the moments of an :class:`~.training.AdamState` are gathered from the
model ranks' mode slices before they are written, so a checkpoint written
on one mesh restores on another.  One rank writes; every rank can read.
"""

from __future__ import annotations

import json
import os
from typing import Any, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from tensor_networks_tpu_torch.parallel import mesh as pm
from tensor_networks_tpu_torch.parallel.sharded import (
    TTCores,
    gather_tt,
    shard_tt_params,
)
from tensor_networks_tpu_torch.parallel.training import AdamState, TTParams
from tensor_networks_tpu_torch.types import resolve_device

#: the named tuples a checkpoint can hold, by the name its json records
_TUPLES = {"TTCores": TTCores, "AdamState": AdamState}


def _encode(x, leaves: list):
    """The json structure of ``x`` (a dict of :class:`TTCores`,
    :class:`AdamState`, tensors, arrays and ints); its arrays appended to
    ``leaves``."""
    if x is None:
        return None
    if type(x).__name__ in _TUPLES:
        return {"tuple": type(x).__name__,
                "fields": [_encode(v, leaves) for v in x]}
    if isinstance(x, dict):
        return {"dict": {k: _encode(v, leaves) for k, v in x.items()}}
    leaves.append(np.asarray(x.detach().cpu() if torch.is_tensor(x) else x))
    return {"leaf": len(leaves) - 1}


def _decode(spec, data, device):
    if spec is None:
        return None
    if "tuple" in spec:
        return _TUPLES[spec["tuple"]](*(_decode(v, data, device) for v in spec["fields"]))
    if "dict" in spec:
        return {k: _decode(v, data, device) for k, v in spec["dict"].items()}
    return torch.from_numpy(data[f"leaf_{spec['leaf']}"]).to(device)


def _map_cores(fn, x):
    """``x`` with every :class:`TTCores` in it replaced by ``fn(cores)``."""
    if isinstance(x, TTCores):
        return fn(x)
    if isinstance(x, AdamState):
        return AdamState(*(_map_cores(fn, v) for v in x))
    if isinstance(x, dict):
        return {k: _map_cores(fn, v) for k, v in x.items()}
    return x


def save_train_state(
    path: str,
    params: TTParams,
    opt_state: Any = None,
    step: int = 0,
    mesh: Optional[DeviceMesh] = None,
) -> str:
    """Checkpoint params (+ optional optimizer state) to ``path.npz`` and
    ``path.treedef.json`` (``tensor_networks_tpu/parallel/checkpoint.py:27``).
    With ``mesh`` the cores are this rank's mode slices: every rank of the
    mesh calls this (the gather is a collective), the rank at coordinate 0
    writes, and all wait for the write; without it, global rank 0 writes
    whole cores."""
    state = {"params": params, "step": step}
    if opt_state is not None:
        state["opt_state"] = opt_state
    if mesh is not None:
        state = _map_cores(lambda c: gather_tt(mesh, c), state)
        writer = not any(mesh.get_coordinate())
    else:
        writer = not dist.is_initialized() or dist.get_rank() == 0
    if writer:
        leaves: list = []
        spec = _encode(state, leaves)
        os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
        np.savez(path + ".npz", **{f"leaf_{i}": x for i, x in enumerate(leaves)})
        with open(path + ".treedef.json", "w", encoding="utf-8") as f:
            json.dump({"treedef": spec, "n": len(leaves)}, f)
    if mesh is not None:
        # a barrier on each axis in turn holds every rank of the mesh
        # until the writer, at coordinate 0, has passed the first
        for name in mesh.mesh_dim_names:
            dist.barrier(group=mesh.get_group(name))
    return path


def load_train_state(
    path: str,
    template: Optional[Any] = None,
    mesh: Optional[DeviceMesh] = None,
    device=None,
) -> Tuple[TTParams, Any, int]:
    """Restore ``(params, opt_state, step)``
    (``tensor_networks_tpu/parallel/checkpoint.py:56``).  The structure is
    read from the json; a ``template`` state, when given, must have the
    same keys.  With ``mesh`` the cores come back as this rank's mode
    slices on its device, else whole on ``device`` (the card unless it
    names another)."""
    with open(path + ".treedef.json", encoding="utf-8") as f:
        spec = json.load(f)["treedef"]
    if template is not None:
        want = {k for k, v in template.items() if v is not None} | {"step"}
        if want != set(spec["dict"]):
            raise ValueError(
                f"checkpoint holds {sorted(spec['dict'])}, the template "
                f"{sorted(want)}"
            )
    dev = pm.mesh_device(mesh) if mesh is not None else resolve_device(device)
    with np.load(path + ".npz") as data:
        state = _decode(spec, data, dev)
    if mesh is not None:
        state = _map_cores(lambda c: shard_tt_params(mesh, c), state)
    return state["params"], state.get("opt_state"), int(state["step"])
