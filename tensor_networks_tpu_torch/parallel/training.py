"""A sharded TT-regression training step (tensor completion by SGD or Adam).

Counterpart of ``tensor_networks_tpu/parallel/training.py``: fit the
cores of a tensor train to observed entries over a ("data", "model")
mesh,

* DP: each rank takes its rows of the batch (``place_batch``), the mean
  over its rows is its loss, and the gradients and the loss are averaged
  over the batch axes' group in one all-reduce a step;
* TP: each rank holds a mode slice of every core (``place_params``) and
  the evaluation sums over the model group
  (:func:`~.sharded.tt_evaluate_batched`).

The JAX step is one jitted program; here it is autograd plus one
collective a step, and nothing in it reads the card but the caller's
read of the loss.  ``fast_eval=True`` runs the forward through
``ops/packed.tt_evaluate_fast``, the H2 kernel on the card.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from tensor_networks_tpu_torch.parallel import mesh as pm
from tensor_networks_tpu_torch.parallel.sharded import (
    TTCores,
    shard_tt_params,
    tt_evaluate_batched,
)
from tensor_networks_tpu_torch.types import resolve_device

TTParams = TTCores
#: ``optax.adam``'s defaults
B1, B2, EPS = 0.9, 0.999, 1e-8


class AdamState(NamedTuple):
    """Adam's state: the step count and both moments, shaped as the
    params (``optax.adam``'s ``ScaleByAdamState``)."""

    count: torch.Tensor  # 0-d int32
    mu: TTParams
    nu: TTParams


def init_tt_params(
    d: int, n: int, r: int, dtype=torch.float32, seed: int = 0, device=None
) -> TTParams:
    """Gaussian TT cores scaled for O(1) entry variance, drawn from
    ``numpy.random.default_rng(seed)``: the JAX package's cores bit for
    bit (``tensor_networks_tpu/parallel/training.py:33``).  On the card
    unless ``device`` names another."""
    rng = np.random.default_rng(seed)
    scale = 1.0 / np.sqrt(r)
    dev = resolve_device(device)
    return TTParams(
        first=torch.as_tensor(rng.standard_normal((n, r)) * scale, dtype=dtype, device=dev),
        mids=torch.as_tensor(
            rng.standard_normal((d - 2, r, n, r)) * scale, dtype=dtype, device=dev
        ),
        last=torch.as_tensor(rng.standard_normal((r, n)) * scale, dtype=dtype, device=dev),
    )


def _make_loss_fn(mesh: DeviceMesh, fast_eval: bool):
    """The local loss: the mean squared error over this rank's rows
    (``tensor_networks_tpu/parallel/training.py:47``)."""
    if fast_eval:
        from tensor_networks_tpu_torch.ops.packed import tt_evaluate_fast

        def loss_fn(params: TTParams, idx, y):
            preds = tt_evaluate_fast(params.first, params.mids, params.last, idx)
            return torch.mean((preds - y.to(preds.dtype)) ** 2)

        return loss_fn

    def loss_fn(params: TTParams, idx, y):
        preds = tt_evaluate_batched(params.first, params.mids, params.last, idx, mesh)
        return torch.mean((preds - y.to(preds.dtype)) ** 2)

    return loss_fn


def _value_and_grad(loss_fn, group, params: TTParams, idx, y):
    """The global mean loss and its gradients: the local loss's autograd,
    then one all-reduce of the gradients and the loss together, averaged
    over the batch group."""
    leaves = [p.detach().requires_grad_(True) for p in params]
    loss = loss_fn(TTParams(*leaves), idx, y)
    grads = torch.autograd.grad(loss, leaves)
    flat = torch.cat([g.reshape(-1) for g in grads] + [loss.detach().reshape(1)])
    flat = pm.all_reduce(flat, group) / torch.distributed.get_world_size(group)
    parts = torch.split(flat, [g.numel() for g in grads] + [1])
    return parts[-1][0], TTParams(*(p.view_as(g) for p, g in zip(parts, grads)))


def _setup(mesh: DeviceMesh, fast_eval: bool, batch_axes: Tuple[str, ...]):
    """The local loss, the batch axes' group, ``place_params`` and
    ``place_batch`` of a step."""
    if fast_eval and mesh.size() > 1:
        raise ValueError(
            "fast_eval uses the evaluation kernel, which does not "
            "partition over a multi-device mesh; use the default evaluation"
        )
    group = pm.axes_group(mesh, batch_axes)
    dev = pm.mesh_device(mesh)

    def place_params(params: TTParams) -> TTParams:
        return shard_tt_params(mesh, params)

    def place_batch(idx, y):
        idx, y = torch.as_tensor(idx), torch.as_tensor(y)
        parts = torch.distributed.get_world_size(group)
        me = torch.distributed.get_rank(group)
        if idx.shape[0] % parts != 0:
            raise ValueError(
                f"the batch ({idx.shape[0]}) must divide over the batch axes "
                f"{tuple(batch_axes)} ({parts} ranks)"
            )
        step = idx.shape[0] // parts
        rows = slice(me * step, (me + 1) * step)
        return idx[rows].to(dev).contiguous(), y[rows].to(dev).contiguous()

    return _make_loss_fn(mesh, fast_eval), group, place_params, place_batch


def make_train_step(
    mesh: DeviceMesh,
    optimizer: str = "sgd",
    fast_eval: bool = False,
    batch_axes: Tuple[str, ...] = ("data",),
):
    """The mesh-sharded SGD step ``step(params, idx, y, lr) -> (params,
    loss)`` with ``place_params`` and ``place_batch``
    (``tensor_networks_tpu/parallel/training.py:68``).  Every rank calls
    it, and the step, with its own shards.  ``optimizer`` is "sgd" (use
    :func:`make_adam_train_step` for Adam).  ``batch_axes`` names the
    mesh axes the batch divides over, e.g. ``("slice", "data")`` on a
    :func:`~.mesh.make_hybrid_mesh`.  ``fast_eval=True`` takes the H2
    kernel's forward, on a one-rank mesh only."""
    if optimizer != "sgd":
        raise ValueError(
            f"make_train_step is SGD (got {optimizer!r}); use "
            "make_adam_train_step for Adam"
        )
    loss_fn, group, place_params, place_batch = _setup(mesh, fast_eval, batch_axes)

    def step(params: TTParams, idx, y, lr) -> Tuple[TTParams, torch.Tensor]:
        loss, grads = _value_and_grad(loss_fn, group, params, idx, y)
        new = TTParams(*(p.detach() - lr * g for p, g in zip(params, grads)))
        return new, loss

    return step, place_params, place_batch


def make_adam_train_step(
    mesh: DeviceMesh,
    lr: float = 1e-2,
    fast_eval: bool = False,
    batch_axes: Tuple[str, ...] = ("data",),
):
    """Adam variant (``tensor_networks_tpu/parallel/training.py:130``):
    ``(step, init_state, place_params, place_batch)`` with ``step(params,
    opt_state, idx, y) -> (params, opt_state, loss)``; ``optax.adam``'s
    update (b1 0.9, b2 0.999, eps 1e-8 outside the square root,
    bias-corrected moments)."""
    loss_fn, group, place_params, place_batch = _setup(mesh, fast_eval, batch_axes)

    def init_state(params: TTParams) -> AdamState:
        count = torch.zeros((), dtype=torch.int32, device=params.first.device)
        return AdamState(count, *(TTParams(*map(torch.zeros_like, params)) for _ in "mv"))

    def step(params: TTParams, opt_state: AdamState, idx, y):
        loss, grads = _value_and_grad(loss_fn, group, params, idx, y)
        count = opt_state.count + 1
        mu = TTParams(*(B1 * m + (1 - B1) * g for m, g in zip(opt_state.mu, grads)))
        nu = TTParams(*(B2 * v + (1 - B2) * g * g for v, g in zip(opt_state.nu, grads)))
        t = count.to(params.first.dtype)
        c1, c2 = 1 - B1**t, 1 - B2**t
        new = TTParams(*(
            p.detach() - lr * (m / c1) / (torch.sqrt(v / c2) + EPS)
            for p, m, v in zip(params, mu, nu)
        ))
        return new, AdamState(count, mu, nu), loss

    return step, init_state, place_params, place_batch
