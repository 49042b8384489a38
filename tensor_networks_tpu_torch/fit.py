"""Fitting tensor networks to point data (tensor completion).

Counterpart of ``tensor_networks_tpu/fit.py``: treat every node value as
a parameter and descend on a regression loss over observed entries
(:func:`fit_network`, any topology), or complete a chain by alternating
least squares (:func:`fit_network_als`).  ``optax`` becomes
``torch.optim`` (Adam and SGD take the same update formulas and
defaults), the jitted step becomes autograd through
:meth:`TensorNetwork.evaluator`, and the per-mode normal equations of an
ALS core are assembled as batched GEMMs over observations grouped by
mode (:class:`_ModeGroups`), not with the JAX package's one-hot einsum,
which torch would materialize as an (N, n, r^2) intermediate.  Everything
runs where the network's values live; the host reads one loss a step
(gradient) or one error a sweep (ALS).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from tensor_networks_tpu_torch.network import TensorNetwork, _next_pow2
from tensor_networks_tpu_torch.types import Index


def fit_network(
    net: TensorNetwork,
    indices: Sequence[Index],
    idx: np.ndarray,
    y: np.ndarray,
    steps: int = 500,
    lr: float = 1e-2,
    optimizer: str = "adam",
    batch_size: Optional[int] = None,
    seed: int = 0,
    callback: Optional[Callable[[int, float], None]] = None,
) -> List[float]:
    """Fit ``net``'s node values to observations ``y`` at multi-indices
    ``idx`` by minimizing mean squared error.  Works for any topology.

    ``idx`` is ``(N, len(indices))`` integers; ``batch_size`` enables
    minibatch SGD over the observations, picked on the host by
    ``np.random.default_rng(seed)`` as in the JAX package (default: full
    batch, padded to the next power of two with weights ``batch / N`` on
    the real rows).  The target is fit in normalized scale (y / std(y))
    and the scale folds back into the first node at the end; the fitted
    values are written back into ``net`` in place.  Returns the loss
    trajectory (normalized scale), one host read a step.

    Model node values should be O(1)-scaled for deep networks (e.g. each
    random core divided by sqrt(rank)).  For chains prefer
    :func:`fit_network_als`, which converges much faster.
    """
    idx = np.asarray(idx, dtype=int)
    y = np.asarray(y)
    y_scale = float(np.std(y)) or 1.0
    y = y / y_scale
    n_obs = idx.shape[0]
    if idx.shape[1] != len(list(indices)):
        raise ValueError(
            f"idx has {idx.shape[1]} columns for {len(list(indices))} indices"
        )

    full_batch = batch_size is None
    batch = _next_pow2(n_obs) if full_batch else int(batch_size)
    run, values = net.evaluator(indices, batch)
    params = [v.detach().clone().requires_grad_(True) for v in values]
    dtype, device = params[0].dtype, params[0].device

    if full_batch:
        pad = batch - n_obs
        cols = torch.as_tensor(
            np.concatenate([idx, np.repeat(idx[-1:], pad, axis=0)]), device=device
        )
        w = torch.as_tensor(
            np.concatenate([np.ones(n_obs), np.zeros(pad)]), dtype=dtype, device=device
        ) * (batch / n_obs)
        targets = torch.as_tensor(
            np.concatenate([y, np.zeros(pad)]), dtype=dtype, device=device
        )
    else:
        idx_all = torch.as_tensor(idx, device=device)
        y_all = torch.as_tensor(y, dtype=dtype, device=device)
        w = torch.ones((batch,), dtype=dtype, device=device)

    opt = {"adam": torch.optim.Adam, "sgd": torch.optim.SGD}[optimizer](params, lr=lr)
    rng = np.random.default_rng(seed)
    losses: List[float] = []
    for it in range(steps):
        if not full_batch:
            pick = torch.as_tensor(rng.integers(0, n_obs, size=batch), device=device)
            cols, targets = idx_all[pick], y_all[pick]
        opt.zero_grad(set_to_none=True)
        loss = torch.mean(w * (run(params, cols) - targets) ** 2)
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))  # the step's one host read
        if callback is not None:
            callback(it, losses[-1])

    with torch.no_grad():
        params[0] = params[0] * y_scale
    for node, val in zip(net.network.nodes, params):
        net.node_tensor(node).update_val_size(val.detach())
    return losses


class _ModeGroups:
    """The observations of one ALS core grouped by their mode value.

    Observations with mode value m touch only slice m of the core, so
    the core's least squares splits into one normal equation per mode.
    Each observation gets a slot in an (n, width, .) layout, width the
    largest group (a stable sort on the device); a mode's Gram and
    right-hand side are then one batched GEMM over its slots, the
    padding rows being zero.
    """

    def __init__(self, cols: torch.Tensor, counts: torch.Tensor, width: int):
        order = torch.argsort(cols, stable=True)
        starts = torch.cumsum(counts, 0) - counts
        ranked = cols[order]
        pos = torch.arange(cols.shape[0], device=cols.device) - starts[ranked]
        self.slot = torch.empty_like(order)
        self.slot[order] = ranked * width + pos
        self.n, self.width = counts.shape[0], width

    @classmethod
    def of_cores(cls, cols: Sequence[torch.Tensor], sizes: Sequence[int]):
        """The groups of every core, with one host read: the largest
        group of each (counted by ``index_add_``: ``bincount`` reads the
        card to size its output)."""
        counts = [torch.zeros(n, dtype=c.dtype, device=c.device)
                  .index_add_(0, c, torch.ones_like(c)) for c, n in zip(cols, sizes)]
        widths = torch.stack([k.max() for k in counts]).tolist()
        return [cls(c, k, int(w)) for c, k, w in zip(cols, counts, widths)]

    def normal_equations(self, lr: torch.Tensor, y: torch.Tensor):
        """``(gram (n, p, p), rhs (n, p))`` of the rows ``lr`` (N, p)
        against ``y`` (N,): [lr y]^T [lr y] over each mode's slots."""
        p = lr.shape[1]
        rows = torch.cat([lr, y[:, None]], dim=1)
        slots = rows.new_zeros((self.n * self.width, p + 1))
        slots.index_copy_(0, self.slot, rows)
        slots = slots.view(self.n, self.width, p + 1)
        g = slots.transpose(1, 2) @ slots
        return g[:, :p, :p], g[:, :p, p]


def _advance_interface(L, core, cols):
    """L'(N, r2) = L(N, r1) @ core[:, cols[n], :] per observation."""
    return torch.einsum("na,nab->nb", L, core.permute(1, 0, 2)[cols])


def _advance_interface_right(R, core, cols):
    """R'(N, r1) = core[:, cols[n], :] @ R(N, r2) per observation."""
    return torch.einsum("nab,nb->na", core.permute(1, 0, 2)[cols], R)


def _solve_core(L, R, groups: _ModeGroups, y, lam):
    """One ALS core update: the per-mode decoupled least squares, solved
    batched (no status read).  Returns the core in (r1, n, r2) layout."""
    r1, r2 = L.shape[1], R.shape[1]
    lr = (L[:, :, None] * R[:, None, :]).reshape(L.shape[0], r1 * r2)
    gram, rhs = groups.normal_equations(lr, y)
    gram = gram + lam * torch.eye(r1 * r2, dtype=lr.dtype, device=lr.device)
    sol = torch.linalg.solve_ex(gram, rhs[..., None])[0][..., 0]
    return sol.reshape(groups.n, r1, r2).permute(1, 0, 2)


def _left_orth(core):
    """Orthonormal columns in the (r1*n, r2) unfolding (the R factor is
    dropped: the next core is solved again at once); a rank-deficient
    unfolding keeps its shape through zero columns."""
    r1, n, r2 = core.shape
    q = torch.linalg.qr(core.reshape(r1 * n, r2))[0]
    return F.pad(q, (0, r2 - q.shape[1])).reshape(r1, n, r2)


def _right_orth(core):
    r1, n, r2 = core.shape
    q = torch.linalg.qr(core.reshape(r1, n * r2).T)[0]
    return F.pad(q, (0, r1 - q.shape[1])).T.reshape(r1, n, r2)


def fit_network_als(
    net: TensorNetwork,
    indices: Sequence[Index],
    idx: np.ndarray,
    y: np.ndarray,
    sweeps: int = 10,
    lam: float = 1e-8,
    tol: float = 0.0,
) -> List[float]:
    """Alternating-least-squares tensor completion on a TT chain.

    Each core update is globally optimal given the others (per-mode
    decoupled normal equations, batched solves, QR frames for
    conditioning), so convergence is fast where the observations pin
    the model (roughly >= 0.5% of entries for d=8; spiky targets need
    far more).  ``net`` must be a chain (any core layout, ragged ranks
    fine), else ``ValueError``; the fitted values are written back in
    place.  Returns the relative training error of every sweep (one host
    read a sweep), stopping early once one is below ``tol``.
    """
    from tensor_networks_tpu_torch.ops.packed import chain_cores

    extracted = chain_cores(net)
    if extracted is None:
        raise ValueError("fit_network_als needs a chain topology (TT)")
    order, cores, frees, perms = extracted

    idx = np.asarray(idx, dtype=int)
    y_raw = np.asarray(y)
    y_scale = float(np.std(y_raw)) or 1.0
    dtype, device = cores[0].dtype, cores[0].device
    y_d = torch.as_tensor(y_raw / y_scale, dtype=dtype, device=device)
    n_obs = idx.shape[0]

    # observation columns in chain order (one upload), grouped by mode once
    col_of = {ind: c for c, ind in enumerate(indices)}
    cols = torch.as_tensor(idx[:, [col_of[f] for f in frees]], device=device)
    cols = cols.T.contiguous().unbind(0)
    groups = _ModeGroups.of_cores(cols, [f.size for f in frees])

    # work in uniform 3D layout: (1, n, r) ... (r, n, 1)
    cores = [cores[0][None]] + list(cores[1:-1]) + [cores[-1][..., None]]
    d = len(cores)
    ones = torch.ones((n_obs, 1), dtype=dtype, device=device)

    errors: List[float] = []
    for _sweep in range(sweeps):
        # left->right: orthogonal right frames make every normal
        # equation well-conditioned
        rights = [ones]
        for k in range(d - 1, 0, -1):
            rights.append(_advance_interface_right(rights[-1], cores[k], cols[k]))
        rights.reverse()  # rights[k] = interface right of core k

        left = ones
        for k in range(d):
            core = _solve_core(left, rights[k], groups[k], y_d, lam)
            if k < d - 1:
                core = _left_orth(core)
            cores[k] = core
            left = _advance_interface(left, core, cols[k])

        # right->left, mirrored
        lefts = [ones]
        for k in range(d - 1):
            lefts.append(_advance_interface(lefts[-1], cores[k], cols[k]))
        right = ones
        for k in range(d - 1, -1, -1):
            core = _solve_core(lefts[k], right, groups[k], y_d, lam)
            if k > 0:
                core = _right_orth(core)
            cores[k] = core
            right = _advance_interface_right(right, core, cols[k])

        preds = right[:, 0]
        err = float(torch.linalg.norm(preds - y_d) / torch.linalg.norm(y_d))
        errors.append(err)
        if tol and err < tol:
            break

    out = [cores[0][0] * y_scale] + cores[1:-1] + [cores[-1][..., 0]]
    for node, val, perm in zip(order, out, perms):
        net.node_tensor(node).update_val_size(val.permute(*np.argsort(perm).tolist()))
    return errors


def completion_error(
    net: TensorNetwork,
    indices: Sequence[Index],
    idx: np.ndarray,
    y: np.ndarray,
) -> float:
    """Relative l2 error of the fitted network on held-out entries
    (through :meth:`TensorNetwork.evaluate`: the evaluation kernel for a
    chain on the card)."""
    preds = net.evaluate(list(indices), np.asarray(idx))
    y = np.asarray(y)
    return float(np.linalg.norm(preds - y) / np.linalg.norm(y))
