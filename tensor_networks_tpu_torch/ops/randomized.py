"""Randomized TT rounding by Gaussian train sketching (arXiv:2110.04393).

Counterpart of ``tensor_networks_tpu/ops/randomized.py``.  GEMMs and thin
QRs with *fixed* target ranks: contract the train against a random rank-t
sketch train from the right, producing per-bond *interface matrices*;
then sweep left-to-right, using each interface to pick an orthonormal
bond basis (randomize-then-orthogonalize).  The implicit-sum variant runs
the same sweep over summand-stacked padded cores, so a k-term sum rounds
without ever materializing its block-diagonal cores.

The sketch comes from a ``torch.Generator`` seeded with ``seed`` on the
train's device, so it is not the JAX package's (JAX's PRNG stream is its
own); the same seed gives the same sketch on one device.

Capability parity: ``pytens/algs.py`` TTRandRound family (:2133-2380).
"""

from __future__ import annotations

import copy
import math
from typing import List, Sequence, Union

import torch

from tensor_networks_tpu_torch.kernels import qr_reduced
from tensor_networks_tpu_torch.network import TensorNetwork
from tensor_networks_tpu_torch.ops.gram import _pad_to


def _train_values(tn: TensorNetwork) -> List[torch.Tensor]:
    return [tn.value(nm) for nm in tn.network.nodes]


def _gaussian_train(
    modes: Sequence[int],
    ranks: Sequence[int],
    dtype: torch.dtype,
    seed: int,
    device=None,
) -> List[torch.Tensor]:
    """A random TT with standard-normal cores, each divided by the square
    root of its size, drawn on ``device`` from a generator seeded with
    ``seed``."""
    d = len(modes)
    shapes = (
        [(modes[0], ranks[0])]
        + [(ranks[k - 1], modes[k], ranks[k]) for k in range(1, d - 1)]
        + [(ranks[-1], modes[-1])]
    )
    gen = torch.Generator(device=device).manual_seed(seed)
    return [
        torch.randn(shape, generator=gen, dtype=dtype, device=device)
        / math.sqrt(float(math.prod(shape)))
        for shape in shapes
    ]


def _pow2_scaled(m: torch.Tensor) -> torch.Tensor:
    """``m`` times the power of two that brings its largest entry into
    [0.5, 1): exact in floating point, and computed on ``m``'s device."""
    _, exp = torch.frexp(m.abs().max())
    return torch.ldexp(m, -exp)


def _interfaces(
    cores: Sequence[torch.Tensor], sketch: Sequence[torch.Tensor]
) -> List[torch.Tensor]:
    """Interface matrices: ``ifc[k]`` contracts cores k+1.. against
    sketch cores k+1.. over all their modes, one (r_k, t_k) matrix per
    bond k = 0..d-2 (with the cores' leading summand axis, if any).

    Each interface is scaled by a power of two (exact): only its column
    space is used, and unscaled it shrinks by ~1/sqrt(n t) a core for a
    train whose cores keep its contractions O(1), so float32 underflowed
    by d=50 (56.6^-48 at n=32, t=100).  The summands of a sum share one
    scale per bond.
    """
    out = [_pow2_scaled(cores[-1] @ sketch[-1].T)]
    for core, sk in zip(cores[-2:0:-1], sketch[-2:0:-1]):
        *lead, r0, n, r1 = core.shape
        t0 = sk.shape[0]
        folded = (core.reshape(*lead, r0 * n, r1) @ out[-1]).reshape(*lead, r0, -1)
        out.append(_pow2_scaled(folded @ sk.reshape(t0, -1).T))
    return out[::-1]


def tt_randomized_round(
    y: TensorNetwork, target_ranks: Sequence[int], seed: int = 0
) -> TensorNetwork:
    """Round a single TT to fixed target ranks (randomize-then-orth);
    returns a new network, ``y`` is untouched."""
    cores = _train_values(y)
    d = len(cores)
    modes = [cores[0].shape[0]] + [c.shape[1] for c in cores[1:]]
    sketch = _gaussian_train(
        modes, target_ranks, cores[0].dtype, seed, cores[0].device
    )
    ifc = _interfaces(cores, sketch)

    result = copy.deepcopy(y)
    names = list(result.network.nodes)
    head = cores[0]
    for k in range(d - 1):
        flat = head.reshape(-1, head.shape[-1])
        basis, _ = qr_reduced(flat @ ifc[k])
        result.node_tensor(names[k]).update_val_size(
            basis.reshape(*head.shape[:-1], -1)
        )
        nxt = cores[k + 1]
        head = ((basis.T @ flat) @ nxt.reshape(nxt.shape[0], -1)).reshape(
            -1, *nxt.shape[1:]
        )
    result.node_tensor(names[-1]).update_val_size(head)
    return result


def tt_sum_randomized_round(
    y: List[TensorNetwork], target_ranks: Sequence[int], seed: int = 0
) -> TensorNetwork:
    """Round an implicit sum of TTs to fixed target ranks.

    Summand cores are zero-padded to a common rank and stacked; the sweep
    then runs on (S, R, n, R) arrays with einsum contractions, summing the
    summand axis only at the final core.
    """
    trains = [_train_values(t) for t in y]
    n_sum = len(trains)
    d = len(trains[0])
    modes = [trains[0][0].shape[0]] + [c.shape[1] for c in trains[0][1:]]
    dtype = trains[0][0].dtype

    rank = max(
        max(max(c.shape[0] for c in t[1:]) for t in trains),
        max(max(c.shape[-1] for c in t[:-1]) for t in trains),
    )

    firsts = torch.stack([_pad_to(t[0], (modes[0], rank)) for t in trains])
    lasts = torch.stack([_pad_to(t[-1], (rank, modes[-1])) for t in trains])
    mids = [
        torch.stack([_pad_to(t[k], (rank, modes[k], rank)) for t in trains])
        for k in range(1, d - 1)
    ]

    sketch = _gaussian_train(modes, target_ranks, dtype, seed, firsts.device)
    # the summands' interfaces at once: (S, R, t) per bond
    ifc = _interfaces([firsts] + mids + [lasts], sketch)

    result = copy.deepcopy(y[0])
    names = list(result.network.nodes)
    head = torch.movedim(firsts, 0, 1).reshape(modes[0], -1)  # (n, S*R)
    for k in range(d - 1):
        flat = head.reshape(-1, n_sum, rank)
        probe = torch.einsum("mia,iat->mt", flat, ifc[k])
        basis, _ = qr_reduced(probe)
        result.node_tensor(names[k]).update_val_size(
            basis.reshape(*head.shape[:-1], -1)
        )
        coeff = torch.einsum("mk,mia->kia", basis, flat)  # (t, S, R)
        if k == d - 2:
            head = torch.einsum("kia,ian->kn", coeff, lasts)
        else:
            nxt = torch.einsum("kia,ianb->knib", coeff, mids[k])
            head = nxt.reshape(nxt.shape[0], nxt.shape[1], -1)
    result.node_tensor(names[-1]).update_val_size(head)
    return result


def tt_rand_precond_svd_round(
    tn: Union[TensorNetwork, List[TensorNetwork]],
    eps: float,
    rank_bound: Sequence[int],
    seed: int = 0,
) -> TensorNetwork:
    """Randomized preconditioning to ``rank_bound`` followed by an exact
    delta-SVD re-round to tolerance ``eps`` -- the hybrid that combines
    the sketch's speed with the SVD sweep's optimal ranks."""
    from tensor_networks_tpu_torch.ops.rounding import tt_svd_round

    if isinstance(tn, list):
        coarse = tt_sum_randomized_round(tn, rank_bound, seed)
    else:
        coarse = tt_randomized_round(tn, rank_bound, seed)
    return tt_svd_round(coarse, eps)


class TTRandRound:
    """Object-style facade over the functional API (kept for parity with
    the reference's class interface)."""

    def __init__(
        self,
        y: Union[TensorNetwork, List[TensorNetwork]],
        target_ranks: Sequence[int],
        seed: int = 0,
    ):
        if isinstance(y, list):
            if not all(isinstance(t, TensorNetwork) for t in y):
                raise ValueError("expected a list of TensorNetworks")
            self.d = y[0].network.number_of_nodes()
            self.ns = len(y)
        elif isinstance(y, TensorNetwork):
            self.d = y.network.number_of_nodes()
            self.ns = 1
        else:
            raise ValueError(
                f"Invalid type for y ({type(y)}): expected a TensorNetwork "
                "or a list of TensorNetworks"
            )
        self.y = y
        self.target_ranks = list(target_ranks)
        self.seed = seed

    def rand_then_orth(self) -> TensorNetwork:
        if isinstance(self.y, list):
            raise ValueError("rand_then_orth expects a single TT")
        return tt_randomized_round(self.y, self.target_ranks, self.seed)

    def rto_rounding_ttsum(self) -> TensorNetwork:
        if not isinstance(self.y, list):
            raise ValueError("rto_rounding_ttsum expects a list of TTs")
        return tt_sum_randomized_round(
            self.y, self.target_ranks, self.seed
        )

    def round(self) -> TensorNetwork:
        if isinstance(self.y, list):
            return self.rto_rounding_ttsum()
        return self.rand_then_orth()
