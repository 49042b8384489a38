"""Device meshes over the ranks of a ``torch.distributed`` job.

Counterpart of ``tensor_networks_tpu/parallel/mesh.py``.  The JAX
package holds every device in one process; here each rank is one
process on one device (SPMD, as ``torchrun --nproc-per-node`` starts
it), and a mesh is a :class:`~torch.distributed.device_mesh.DeviceMesh`
over the ranks of the default group, with the JAX axis names:
``("data", "model")``, or ``("slice", "data", "model")`` for the
hybrid mesh.  The caller initializes the default group
(``torch.distributed.init_process_group``); nothing here creates one.

The collectives of the layer go through the helpers below: ``all_reduce``
stands for ``lax.psum``, a ``batch_isend_irecv`` hop for ``lax.ppermute``,
``broadcast`` for the replicate-from-one-device psum; each counts its
calls (``all_reduce.calls``, ``hop.calls``, ``broadcast.calls``), which
the card's smoke test reads.
Peers and sources are global ranks (``dist.get_global_rank``): on a 2-D
mesh the model group's rank 1 is not global rank 1.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

def _device_type(devices) -> str:
    """``None`` means the card; anything else names a device type."""
    if devices is None:
        return "cuda"
    return torch.device(devices).type


def require_group() -> None:
    """Raise unless this process holds the default process group: the
    layer runs on its ranks and never falls back to one device."""
    if not dist.is_initialized():
        raise RuntimeError(
            "a mesh spans the ranks of the default process group: call "
            "torch.distributed.init_process_group first"
        )


def _grid(shape: Sequence[int], what: str) -> torch.Tensor:
    require_group()
    n = int(np.prod(shape))
    world = dist.get_world_size()
    if n > world:
        raise ValueError(
            f"{what} {tuple(shape)} needs {n} devices, have {world}"
        )
    return torch.arange(n).reshape(tuple(shape))


def _build(device_type: str, grid: torch.Tensor, names) -> DeviceMesh:
    if device_type == "cuda":
        torch.cuda.set_device(_local_cuda_index())
    mesh = DeviceMesh(device_type, grid, mesh_dim_names=tuple(names))
    # the first collective on each group involves all of its ranks, so a
    # later batched hop between two of them is allowed (NCCL's rule)
    if mesh.get_coordinate() is not None:
        one = torch.ones(1, device=mesh_device(mesh))
        for name in mesh.mesh_dim_names:
            dist.all_reduce(one, group=mesh.get_group(name))
    return mesh


def make_mesh(
    shape: Sequence[int],
    axis_names: Sequence[str] = ("data", "model"),
    devices=None,
) -> DeviceMesh:
    """A mesh of the given logical shape over ranks ``0 .. prod(shape)-1``
    (``tensor_networks_tpu/parallel/mesh.py:19``).  ``devices`` is the
    device type: ``None`` means the card (``cuda:<local rank>``), ``"cpu"``
    a gloo group's CPU ranks.  Every rank of the job calls it."""
    grid = _grid(shape, "mesh shape")
    return _build(_device_type(devices), grid, axis_names)


def default_mesh(
    n_devices: Optional[int] = None,
    model_parallel: Optional[int] = None,
    devices=None,
) -> DeviceMesh:
    """A ("data", "model") mesh over n ranks, all on the model axis by
    default (``tensor_networks_tpu/parallel/mesh.py:37``)."""
    if n_devices is None:
        n_devices = dist.get_world_size() if dist.is_initialized() else 1
    if model_parallel is None:
        model_parallel = n_devices
    if n_devices % model_parallel != 0:
        raise ValueError(
            f"model_parallel ({model_parallel}) must divide the device "
            f"count ({n_devices})"
        )
    return make_mesh(
        (n_devices // model_parallel, model_parallel), ("data", "model"),
        devices,
    )


def make_hybrid_mesh(
    n_slices: int,
    per_slice_shape: Sequence[int],
    axis_names: Sequence[str] = ("slice", "data", "model"),
    devices=None,
) -> DeviceMesh:
    """A multi-slice mesh: contiguous blocks of ranks per slice, the outer
    axis across slices (``tensor_networks_tpu/parallel/mesh.py:59``; its
    single-slice reshape, ``:93-107``).  Shard the batch over
    ``("slice", "data")`` and keep mode shardings on the inner axes."""
    shape = (n_slices, *per_slice_shape)
    if len(shape) != len(tuple(axis_names)):
        raise ValueError(
            f"{len(shape)} mesh dims need {len(shape)} axis names, "
            f"got {tuple(axis_names)}"
        )
    grid = _grid(shape, "hybrid mesh")
    return _build(_device_type(devices), grid, axis_names)


# ---- this rank's place on a mesh -------------------------------------------


def _local_cuda_index() -> int:
    """The card of this rank: ``LOCAL_RANK`` as torchrun sets it, else the
    global rank modulo the cards of the host."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return dist.get_rank() % torch.cuda.device_count()


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank's shards live on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", _local_cuda_index())
    return torch.device(mesh.device_type)


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_index(mesh: DeviceMesh, axis: str) -> int:
    """This rank's coordinate along ``axis`` (``lax.axis_index``)."""
    return mesh.get_local_rank(axis)


def axes_group(mesh: DeviceMesh, axes: Tuple[str, ...]):
    """The process group spanning ``axes`` at this rank's coordinates on
    the other axes, its ranks in row-major order over ``axes`` (the order
    of ``PartitionSpec(axes)``).  One axis is the mesh's own group; for
    several, every rank builds every such group with ``dist.new_group``
    in the same order (a collective call)."""
    axes = tuple(axes)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    names = mesh.mesh_dim_names
    dims = [names.index(a) for a in axes]
    rest = [i for i in range(len(names)) if i not in dims]
    ranks = mesh.mesh.permute(*rest, *dims).reshape(
        -1, int(np.prod([mesh.size(i) for i in dims]))
    )
    me = dist.get_rank()
    mine = None
    for row in ranks.tolist():
        group = dist.new_group(row)
        if me in row:
            mine = group
    return mine


def peer(group, index: int) -> int:
    """The global rank of ``group``'s member ``index``."""
    return dist.get_global_rank(group, index)


# ---- counted collectives ---------------------------------------------------


def all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``lax.psum`` over ``group`` into a new (contiguous) tensor."""
    out = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=op, group=group)
    all_reduce.calls += 1
    return out


all_reduce.calls = 0


def all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The members' blocks of ``x`` concatenated along ``dim``."""
    parts = [torch.empty_like(x, memory_format=torch.contiguous_format)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def broadcast(x: torch.Tensor, group, src: int) -> torch.Tensor:
    """Every member gets member ``src``'s ``x`` (``_replicate_from``)."""
    out = x.clone(memory_format=torch.contiguous_format)
    dist.broadcast(out, src=peer(group, src), group=group)
    broadcast.calls += 1
    # in this rank's own layout of x: an einsum's bits can follow its
    # operands' strides, and a replicated carry must be the stage's own
    return out if x.is_contiguous() else torch.empty_like(x).copy_(out)


broadcast.calls = 0


def hop(group, sends, recvs) -> None:
    """One batched neighbour exchange: ``sends`` and ``recvs`` are lists of
    (tensor, member index); the received tensors are filled in place.
    ``hop.calls`` counts the exchanges that moved a tensor on this rank."""
    ops = [dist.P2POp(dist.isend, t.contiguous(), peer(group, i), group)
           for t, i in sends]
    ops += [dist.P2POp(dist.irecv, t, peer(group, i), group) for t, i in recvs]
    if not ops:
        return
    hop.calls += 1
    for req in dist.batch_isend_irecv(ops):
        req.wait()


hop.calls = 0
