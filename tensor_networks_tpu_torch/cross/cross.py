"""Rank-adaptive cross approximation over arbitrary dimension trees.

One engine subsumes TT-cross, HT-cross, and Tucker-cross: the ansatz is
whatever tree the starting network has.  Each iteration sweeps the tree
twice — root->leaves refining down-pivots, leaves->root refining
up-pivots and writing interpolation cores — then kicks and re-clamps all
bond ranks until the iterate (or a validation set) stops moving.

The sweeps are *level-synchronous*: nodes at the same tree depth have no
data dependencies within a half-sweep, so each level's fiber matrices
are assembled into ONE batched target-function call.  For
network-valued targets that is one batched evaluation per level (one
H2 kernel call for a chain on the card) instead of one per node; user
functions see O(depth) calls per sweep instead of O(nodes).

Pivot selection is pluggable (maxvol / DEIM); both run on NumPy fibers
on the host, and large maxvol problems of a network on the card run
there (:func:`~tensor_networks_tpu_torch.cross.maxvol.maxvol_auto`).
The engine is the JAX package's ``tensor_networks_tpu/cross/cross.py``,
with the same host decisions, so a seeded run of either package on the
same host target picks the same pivots.

Capability parity: ``pytens/cross/cross.py`` (engine :167-433).
"""

from __future__ import annotations

import copy
import logging
from dataclasses import dataclass, field
from enum import Enum, auto
from typing import (
    Callable,
    Dict,
    List,
    Optional,
    Sequence,
    Tuple,
)

import numpy as np
import torch

from tensor_networks_tpu_torch import network as ptn
from tensor_networks_tpu_torch.cross.funcs import TensorFunc
from tensor_networks_tpu_torch.cross.maxvol import maxvol_auto
from tensor_networks_tpu_torch.dimtree import DimTreeNode
from tensor_networks_tpu_torch.types import NodeName

logger = logging.getLogger(__name__)


class CrossAlgo(Enum):
    """Which pivot-selection rule drives the sweeps."""

    MAXVOL = auto()
    DEIM = auto()


class ConvergenceCheck(Enum):
    """What decides that the sweeps have converged."""

    NORM = auto()
    VALID_ERROR = auto()


@dataclass
class CrossConfig:
    """Knobs for a cross-approximation run (schema kept compatible with
    the reference's config)."""

    cross_algo: CrossAlgo = CrossAlgo.MAXVOL  # pivot-selection rule
    kickrank: int = 2  # rank increment between sweeps
    max_rank: Optional[int] = None  # hard rank cap
    max_iters: Optional[int] = None  # sweep budget
    validation_size: int = 1000  # points for VALID_ERROR checking
    convergence: ConvergenceCheck = ConvergenceCheck.NORM


@dataclass
class CrossResult:
    """A fitted network, its pivot tree, and the (rank, error)
    trajectory across sweeps."""

    net: "ptn.TensorNetwork"
    dim_tree: DimTreeNode
    ranks_and_errors: Sequence[Tuple[int, float]] = field(
        default_factory=list
    )


# --------------------------- pivot selection ---------------------------


def _pivots_maxvol(
    fiber: np.ndarray, device: Optional[torch.device] = None
) -> Tuple[np.ndarray, np.ndarray]:
    """Orthogonalize the fiber matrix, then take maxvol rows (large
    ones on ``device``, the network's).

    Returns (row indices, interpolation coefficients B with
    fiber ~= B @ fiber[rows])."""
    basis = np.linalg.qr(np.asarray(fiber))[0]
    return maxvol_auto(basis, device=device)


def _pivots_deim(
    fiber: np.ndarray, device: Optional[torch.device] = None
) -> Tuple[np.ndarray, np.ndarray]:
    """Discrete Empirical Interpolation rows of the left singular basis
    (on the host, wherever the network lives)."""
    u = np.linalg.svd(np.asarray(fiber), full_matrices=False)[0]
    r = u.shape[1]
    rows = np.empty(r, dtype=int)
    rows[0] = np.argmax(np.abs(u[:, 0]))
    for j in range(1, r):
        lead = u[rows[:j], :j]
        rhs = u[rows[:j], j]
        try:
            alpha = np.linalg.lstsq(lead, rhs, rcond=None)[0]
        except np.linalg.LinAlgError:
            alpha = np.linalg.pinv(lead) @ rhs
        residual = u[:, j] - u[:, :j] @ alpha
        rows[j] = np.argmax(np.abs(residual))
    coeffs = u @ np.linalg.pinv(u[rows])
    return rows, coeffs


_PIVOT_RULES: Dict[CrossAlgo, Callable] = {
    CrossAlgo.MAXVOL: _pivots_maxvol,
    CrossAlgo.DEIM: _pivots_deim,
}


def _cartesian_product_arrays(*arrays: np.ndarray) -> np.ndarray:
    """Row-wise cartesian product: (n_i, d_i) inputs ->
    (prod n_i, sum d_i)."""
    if not arrays:
        return np.array([[]])
    counts = [a.shape[0] for a in arrays]
    widths = [a.shape[1] for a in arrays]
    total = int(np.prod(counts))
    pieces = []
    for pos, arr in enumerate(arrays):
        view = [1] * len(arrays) + [widths[pos]]
        view[pos] = counts[pos]
        pieces.append(
            np.broadcast_to(arr.reshape(view), counts + [widths[pos]])
        )
    return np.concatenate(pieces, axis=-1).reshape(total, sum(widths))


def _norm_diff_packed(net, previous) -> Optional[float]:
    """NORM convergence metric for chain iterates.

    Chains pack both iterates into rank-bucketed PackedTTs and measure
    the block-diagonal difference train with ``packed.norm_exact``, the
    backward-stable QR-sweep norm (the zipper norm loses half the
    mantissa to cancellation precisely when the iterates agree, i.e. at
    convergence).  The installed interpolation cores are float64 while
    a start network may be float32, so both packs are promoted to one
    dtype first.  Returns None when either iterate is not a chain
    (HT/Tucker take the graph path).
    """
    from tensor_networks_tpu_torch.ops import packed

    a = packed.pack_ragged(net)
    b = packed.pack_ragged(previous)
    if (
        a is None
        or b is None
        or a.d != b.d
        or a.mode != b.mode
    ):
        return None
    dtype = torch.promote_types(a.first.dtype, b.first.dtype)
    rank = max(a.rank, b.rank)
    a = packed.pad_rank(packed.PackedTT(*(x.to(dtype) for x in a)), rank)
    b = packed.pad_rank(packed.PackedTT(*(x.to(dtype) for x in b)), rank)
    diff = packed.add(a, packed.scale(b, -1.0))
    return float(packed.norm_exact(diff) / packed.norm_exact(a))


# ----------------------------- the engine ------------------------------


#: one fiber-matrix request: (row indices+pivots, column indices+pivots)
_FiberJob = Tuple[
    Tuple[Sequence, np.ndarray], Tuple[Sequence, np.ndarray]
]


class CrossApproximation:
    """Level-synchronous dimension-tree cross approximation."""

    def __init__(
        self,
        tensor_func: TensorFunc,
        config: CrossConfig = CrossConfig(),
        rng: Optional[np.random.Generator] = None,
    ):
        self._config = config
        self._tensor_func = tensor_func
        # Private pivot rng.  Without an explicit ``rng`` it is seeded
        # from the global stream ONCE at construction, as in the JAX
        # package, so one ``np.random.seed`` gives either package the
        # same pivot draws; library code that consumes global draws in
        # the loop cannot shift the trajectory.
        if rng is None:
            rng = np.random.default_rng(np.random.randint(2**31))
        self._rng = rng
        # where the network lives; large maxvol problems run there
        self._device: Optional[torch.device] = None

    # -- batched fiber evaluation ------------------------------------------

    def _eval_fibers(self, jobs: List[_FiberJob]) -> List[np.ndarray]:
        """Evaluate every requested fiber matrix with ONE target call.

        Each job's points are the cartesian product of its column and row
        pivot sets, permuted into the function's index order; the results
        are split back and shaped (n_cols, n_rows).
        """
        func_order = self._tensor_func.indices
        batches: List[np.ndarray] = []
        shapes: List[Tuple[int, int]] = []
        for (row_idx, row_vals), (col_idx, col_vals) in jobs:
            pts = _cartesian_product_arrays(col_vals, row_vals).astype(
                int, copy=False
            )
            layout = list(col_idx) + list(row_idx)
            take = [layout.index(ind) for ind in func_order]
            batches.append(pts[:, take])
            shapes.append((len(col_vals), len(row_vals)))

        values = np.asarray(
            self._tensor_func(np.concatenate(batches, axis=0))
        ).reshape(-1)
        fibers = []
        at = 0
        for rows, cols in shapes:
            fibers.append(
                values[at : at + rows * cols].reshape(rows, cols)
            )
            at += rows * cols
        return fibers

    def _pick(self, fiber: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        rule = _PIVOT_RULES.get(self._config.cross_algo)
        if rule is None:
            raise ValueError(f"unsupported algo {self._config.cross_algo}")
        return rule(fiber, self._device)

    # -- per-node candidate assembly ------------------------------------------

    @staticmethod
    def _down_candidates(node: DimTreeNode) -> np.ndarray:
        """Candidate down-pivots: parent frees x parent's down pivots x
        sibling up pivots."""
        parent = node.up_info.nodes[0]
        parts = [
            np.arange(ind.size)[:, None]
            for ind in node.down_info.indices
            if ind in parent.free_indices
        ]
        if parent.up_info.nodes:
            parts.append(parent.down_info.vals)
        parts.extend(
            sib.up_info.vals
            for sib in parent.down_info.nodes
            if sib.node != node.node
        )
        return _cartesian_product_arrays(*parts)

    @staticmethod
    def _up_candidates(
        node: DimTreeNode,
    ) -> Tuple[np.ndarray, List[int]]:
        """Candidate up-pivots (own frees x children's up pivots) plus
        the core's axis sizes in candidate layout order."""
        parts, sizes = [], []
        for ind in node.up_info.indices:
            if ind in node.free_indices:
                parts.append(np.arange(ind.size)[:, None])
                sizes.append(ind.size)
        for child in sorted(node.down_info.nodes):
            parts.append(child.up_info.vals)
            sizes.append(len(child.up_info.vals))
        return _cartesian_product_arrays(*parts), sizes

    # -- level-synchronous half-sweeps -----------------------------------------

    @staticmethod
    def _levels(tree: DimTreeNode) -> List[List[DimTreeNode]]:
        """Tree nodes grouped by depth (root level first)."""
        levels: List[List[DimTreeNode]] = [[tree]]
        while levels[-1]:
            levels.append(
                [
                    child
                    for node in levels[-1]
                    for child in node.down_info.nodes
                ]
            )
        return levels[:-1]

    def _sweep_down(self, levels: List[List[DimTreeNode]]) -> None:
        """Root->leaves: per level, refine every node's down pivots
        against its parent/siblings with one batched evaluation."""
        for level in levels[1:]:
            candidates = [self._down_candidates(n) for n in level]
            fibers = self._eval_fibers(
                [
                    (
                        (n.up_info.indices, n.up_info.vals),
                        (n.down_info.indices, cand),
                    )
                    for n, cand in zip(level, candidates)
                ]
            )
            for node, cand, fiber in zip(level, candidates, fibers):
                rows, _ = self._pick(fiber)
                node.down_info.vals = cand[rows, :]
                node.down_info.rank = len(rows)

    def _sweep_up(self, net, levels: List[List[DimTreeNode]]) -> None:
        """Leaves->root: per level, refine up pivots and install the
        interpolation cores."""
        for level in reversed(levels[1:]):
            packed = [self._up_candidates(n) for n in level]
            fibers = self._eval_fibers(
                [
                    (
                        (n.down_info.indices, n.down_info.vals),
                        (n.up_info.indices, cand),
                    )
                    for n, (cand, _) in zip(level, packed)
                ]
            )
            for node, (cand, sizes), fiber in zip(level, packed, fibers):
                rows, coeffs = self._pick(fiber)
                node.up_info.vals = cand[rows, :]
                node.up_info.rank = len(rows)
                core = coeffs.reshape(*sizes, -1).transpose(
                    np.argsort(node.perm)
                )
                net.node_tensor(node.node).update_val_size(core)

    def _install_root(self, net, tree: DimTreeNode) -> None:
        """The root core holds raw fiber values over its own frees and
        the children's pivot sets."""
        children = sorted(tree.down_info.nodes)
        f_sizes = [ind.size for ind in tree.free_indices]
        f_grid = _cartesian_product_arrays(
            *[np.arange(s)[:, None] for s in f_sizes]
        )
        col_idx = [i for c in children for i in c.up_info.indices]
        col_vals = _cartesian_product_arrays(
            *[c.up_info.vals for c in children]
        )
        [fiber] = self._eval_fibers(
            [((tree.free_indices, f_grid), (col_idx, col_vals))]
        )
        c_sizes = [len(c.up_info.vals) for c in children]
        core = fiber.T.reshape(*f_sizes, *c_sizes).transpose(
            np.argsort(tree.perm)
        )
        net.node_tensor(tree.node).update_val_size(core)

    # -- rank schedule -----------------------------------------------------------

    def _grow_ranks(
        self, tree: DimTreeNode, known: Optional[np.ndarray]
    ) -> None:
        """Kick every rank, clamp to capacity fixpoint, seed new pivots."""
        kick = self._config.kickrank
        tree.increment_ranks(kick, self._config.max_rank)
        prev = None
        while tree.ranks() != prev:
            prev = tree.ranks()
            tree.bound_ranks()

        if known is None:
            fresh = np.concatenate(
                [
                    self._rng.integers(0, ind.size, [kick, 1])
                    for ind in tree.indices
                ],
                axis=-1,
            )
        else:
            fresh = known[self._rng.integers(0, len(known), [kick])]
        tree.add_values(fresh)

    # -- convergence --------------------------------------------------------------

    def _error(
        self,
        net,
        previous,
        validation: Optional[np.ndarray],
        reference: Optional[np.ndarray],
    ) -> float:
        check = self._config.convergence
        if check == ConvergenceCheck.NORM:
            fast = _norm_diff_packed(net, previous)
            if fast is not None:
                return fast
            return float((net - previous).norm() / net.norm())
        if check == ConvergenceCheck.VALID_ERROR:
            estimate = np.asarray(
                net.evaluate(self._tensor_func.indices, validation)
            ).reshape(-1)
            return float(
                np.linalg.norm(reference - estimate)
                / np.linalg.norm(reference)
            )
        raise RuntimeError("unknown termination criteria")

    # -- driver ---------------------------------------------------------------------

    def cross(
        self,
        net,
        root: Optional[NodeName] = None,
        validation: Optional[np.ndarray] = None,
        eps: float = 0.1,
        initialization: Optional[np.ndarray] = None,
        known: Optional[np.ndarray] = None,
    ) -> CrossResult:
        """Fit ``net``'s structure to the target function.

        ``initialization`` seeds the starting pivots; ``known`` restricts
        fresh pivots to rows of a known-support set.
        """
        if root is None:
            root = list(net.network.nodes)[0]
        tree = net.dimension_tree(root)
        self._device = net.value(root).device

        seeds = initialization
        if seeds is None:
            seeds = np.asarray(
                [[self._rng.integers(0, i.size) for i in tree.indices]]
            )
        tree.increment_ranks(len(seeds), self._config.max_rank)
        tree.add_values(np.asarray(seeds))

        reference = None
        if self._config.convergence == ConvergenceCheck.VALID_ERROR:
            if validation is None:
                validation = np.stack(
                    [
                        self._rng.integers(
                            0, i.size, size=self._config.validation_size
                        )
                        for i in self._tensor_func.indices
                    ],
                    axis=-1,
                )
            reference = np.asarray(self._tensor_func(validation))

        levels = self._levels(tree)
        trajectory: Dict[int, float] = {}
        sweep_no = 0
        while True:
            previous = copy.deepcopy(net)
            self._sweep_down(levels)
            self._sweep_up(net, levels)
            self._install_root(net, tree)

            err = self._error(net, previous, validation, reference)
            # Deliberate deviation from the reference (as in the JAX
            # package): reference cross.py:417 keys ranks_and_errors
            # by len(tree.up_info.vals) — but the ROOT's up vals are
            # never written (init empty at algs.py:1072-1074; the root
            # is excluded from _leaves_to_root at cross.py:327), so the
            # reference always records a single entry keyed 0.  Keying
            # by the max bond rank keeps the whole rank/error
            # trajectory instead.
            trajectory[max(tree.ranks(), default=0)] = float(err)
            logger.debug("sweep %s: error %s", sweep_no, err)

            budget = self._config.max_iters
            if err <= eps or (budget is not None and sweep_no >= budget):
                break
            sweep_no += 1
            self._grow_ranks(tree, known)

        return CrossResult(
            net=net,
            dim_tree=tree,
            ranks_and_errors=sorted(trajectory.items()),
        )
