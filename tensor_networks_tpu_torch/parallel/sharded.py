"""Mode-sharded TT kernels: the inner product and the batched evaluation.

Counterpart of ``tensor_networks_tpu/parallel/sharded.py``.  There the
shardings are annotations and XLA places the collectives; here each rank
holds its slice of every core's mode dimension (``shard_tt_params``) and
the sums over the ``model`` axis are written out:

* :func:`tt_inner_mode_sharded` zips its mode slice of every core and
  all-reduces the (r_a, r_b) carry after each one;
* :func:`tt_evaluate_batched` with a ``mesh`` selects, at each core, the
  points whose index lies in this rank's slice (zero for the rest) and
  all-reduces the (B, r) carry over the model group.  Its sums are
  Megatron's operator pair, so gradients come out right: the carry's
  sum has an identity backward, and each core's input copy sums its
  gradient over the group.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch.distributed.device_mesh import DeviceMesh

from tensor_networks_tpu_torch.kernels.evaluate import clamp_modes, tt_evaluate_plain
from tensor_networks_tpu_torch.parallel import mesh as pm


class TTCores(NamedTuple):
    """A uniform TT as stacked tensors (``tensor_networks_tpu/parallel/sharded.py:25``)."""

    first: torch.Tensor  # (n, r)
    mids: torch.Tensor  # (d-2, r, n, r)
    last: torch.Tensor  # (r, n)


#: the mode axis of each field of :class:`TTCores`
MODE_DIMS = TTCores(first=0, mids=2, last=1)


def _mode_slice(x, dim: int, parts: int, index: int, device) -> torch.Tensor:
    """Block ``index`` of ``parts`` along ``dim`` of a global array, on
    ``device``; the mode size must divide evenly."""
    x = torch.as_tensor(x)
    size = x.shape[dim]
    if size % parts != 0:
        raise ValueError(
            f"mode sharding needs the mode size ({size}) divisible by the "
            f"model axis ({parts})"
        )
    step = size // parts
    return x.narrow(dim, index * step, step).to(device).contiguous()


def shard_tt_params(mesh: DeviceMesh, cores: TTCores) -> TTCores:
    """This rank's mode slice of every core, bonds whole
    (``tensor_networks_tpu/parallel/sharded.py:32``).  Takes the global
    cores (NumPy or tensors, the same on every rank)."""
    parts, me = pm.axis_size(mesh, "model"), pm.axis_index(mesh, "model")
    dev = pm.mesh_device(mesh)
    return TTCores(*(
        _mode_slice(x, dim, parts, me, dev) for x, dim in zip(cores, MODE_DIMS)
    ))


def tt_inner_mode_sharded(mesh: DeviceMesh, a: TTCores, b: TTCores) -> torch.Tensor:
    """TT inner product with the mode dimension sharded over ``model``
    (``tensor_networks_tpu/parallel/sharded.py:46``): one all-reduce of
    the (r_a, r_b) carry after each core.  Returns the same 0-d tensor on
    every rank."""
    group = mesh.get_group("model")
    w = pm.all_reduce(a.first.T @ b.first, group)
    for ca, cb in zip(a.mids, b.mids):
        ra, nl, ra2 = ca.shape
        rb, _, rb2 = cb.shape
        t = (w.T @ ca.reshape(ra, nl * ra2)).reshape(rb * nl, ra2)
        w = pm.all_reduce(t.T @ cb.reshape(rb * nl, rb2), group)
    return torch.sum(w * pm.all_reduce(a.last @ b.last.T, group))


class _SumOverGroup(torch.autograd.Function):
    """Forward: the sum over the group; backward: the identity (every
    member already holds the whole gradient of a replicated result)."""

    @staticmethod
    def forward(ctx, x, group):
        return pm.all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyToGroup(torch.autograd.Function):
    """Forward: the identity on a replicated input; backward: the sum of
    the members' partial gradients."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        return pm.all_reduce(g, ctx.group), None


def _owned(cols: torch.Tensor, size: int, index: int):
    """Local columns of the points in member ``index``'s slice of a mode
    of ``size`` per member, clamped into it, and the mask of those
    points."""
    local = cols - index * size
    mine = (local >= 0) & (local < size)
    return local.clamp(0, size - 1), mine


def tt_evaluate_batched(
    first: torch.Tensor,
    mids: torch.Tensor,
    last: torch.Tensor,
    idx,
    mesh: Optional[DeviceMesh] = None,
) -> torch.Tensor:
    """Values of a uniform TT at a (B, d) batch of multi-indices
    (``tensor_networks_tpu/parallel/sharded.py:84``).

    Without ``mesh`` the cores are whole and this is the plain evaluator
    (``kernels/evaluate.py::tt_evaluate_plain``): for modes up to 64 each
    step is one (B, r) x (r, n r) matmul and a row select, above that a
    gather.  With ``mesh`` the cores are this rank's mode slices
    (:func:`shard_tt_params`) and ``idx`` holds global indices; the
    result, the same on every model rank, is summed over the model
    group at every core.  Out-of-range indices clamp into their mode.
    """
    dev = first.device
    idx = torch.as_tensor(idx, device=dev)
    parts = 1 if mesh is None else pm.axis_size(mesh, "model")
    n0, nl = first.shape[0] * parts, last.shape[1] * parts
    n = mids.shape[2] * parts if mids.shape[0] else n0
    cols = clamp_modes(idx.long(), n0, n, nl)
    if mesh is None:
        return tt_evaluate_plain(first, mids, last, cols)

    group = mesh.get_group("model")
    me = pm.axis_index(mesh, "model")
    matmul_form = n0 <= 64
    rows = torch.arange(cols.shape[0], device=dev)
    local, mine = _owned(cols[:, 0], first.shape[0], me)
    v = _SumOverGroup.apply(first[local] * mine[:, None], group)
    for k, core in enumerate(mids):
        local, mine = _owned(cols[:, k + 1], core.shape[1], me)
        v_in = _CopyToGroup.apply(v, group)
        r, n_loc, r2 = core.shape
        if matmul_form:
            u = (v_in @ core.reshape(r, n_loc * r2)).reshape(-1, n_loc, r2)
            u = u[rows, local]
        else:
            u = torch.einsum("br,rbs->bs", v_in, core[:, local, :])
        v = _SumOverGroup.apply(u * mine[:, None], group)
    local, mine = _owned(cols[:, -1], last.shape[1], me)
    part = torch.sum(_CopyToGroup.apply(v, group) * last[:, local].T, dim=-1)
    return _SumOverGroup.apply(part * mine, group)


def gather_tt(mesh: DeviceMesh, cores: TTCores) -> TTCores:
    """The global cores from every model rank's mode slices (the inverse
    of :func:`shard_tt_params`; a collective over the model group)."""
    group = mesh.get_group("model")
    return TTCores(*(
        pm.all_gather(x, group, dim) for x, dim in zip(cores, MODE_DIMS)
    ))
