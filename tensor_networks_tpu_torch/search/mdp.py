"""The search MDP: states, legal-move enumeration, and successor
generation.

A state is a network plus the unspent part of the global error budget.
Applying a split costs one device SVD; the many rank variants a split can
commit to are *views* of that single decomposition (tail blocks of the
spectrum), selected host-side by :func:`rank_variants` — a pure function
over the spectrum, unit-testable without any graph in sight.

Enumeration order and budget accounting are pinned by the count-exact
search tests (dfs=8 / bfs=7 / partition=7 on the 3x4x5 fixture), matching
the reference engine's observable behavior (``pytens/search/state.py``).

Counterpart of ``tensor_networks_tpu/search/mdp.py``.  Every child's
factors are slices of its parent split's factors on the same device; the
spectrum is read to the host once an action (or handed over by the
batched scorer, which reads each shape group's spectra once).
"""

from __future__ import annotations

import copy
import itertools
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from tensor_networks_tpu_torch.network import TensorNetwork
from tensor_networks_tpu_torch.search.actions import Action, ISplit, Merge, OSplit
from tensor_networks_tpu_torch.search.configuration import SearchConfig
from tensor_networks_tpu_torch.types import Index


def half_bipartitions(items: Sequence, total: int) -> Iterator[tuple]:
    """Smaller halves of all bipartitions of ``items``; when the sizes tie
    (even total, half-sized subset) only the lexicographically first half
    of the combinations survives, so each bipartition appears once."""
    for k in range(1, total // 2 + 1):
        combos = list(itertools.combinations(items, k))
        if total % 2 == 0 and k == total // 2:
            combos = combos[: len(combos) // 2]
        yield from combos


def rank_variants(
    spectrum: np.ndarray,
    budget_sq: float,
    width: int,
    target_size: Optional[int],
) -> Tuple[Optional[List[int]], float]:
    """Choose candidate kept-ranks for one split.

    Returns ``(ranks, spent)``: the ranks to branch on and the squared
    error charged to every branch.  ``ranks is None`` means no truncation
    fits the budget at all (the caller keeps the split at full rank);
    ``ranks == []`` means the budget allowed truncation but the
    ``target_size`` window excluded every candidate (no successors).
    """
    tail = np.cumsum(spectrum[::-1] ** 2)
    n_fit = int(np.searchsorted(tail, budget_sq, side="right"))
    if n_fit == 0:
        return None, 0.0

    fits = tail[:n_fit]
    if target_size is not None:
        keep = max(len(spectrum) - target_size + width // 2, 0)
        fits = fits[:keep]

    n_var = 1 if width == 0 else min(width, len(fits))
    spent = float(fits[-1]) if len(fits) else 0.0
    ranks = [
        max(len(spectrum) - len(fits) + n_var - v - 1, 1)
        for v in range(len(fits[-n_var:]) if n_var else 0)
    ]
    return ranks, spent


class SearchState:
    """A network, its remaining budget, and the program that built it."""

    def __init__(
        self,
        net: TensorNetwork,
        delta: float,
        threshold: float = 0.1,
        max_ops: int = 5,
    ):
        self.network = net
        self.curr_delta = delta
        self.threshold = threshold
        self.max_ops = max_ops
        self.past_actions: List[Action] = []
        self.links: List[str] = []
        self.is_noop = False

    # -- enumeration --------------------------------------------------------

    def get_legal_actions(self, index_actions: bool = False) -> List[Action]:
        """Positional splits on every node, or (with ``index_actions``)
        free-index splits filtered against the history."""
        if index_actions:
            return self.get_legal_index_actions()
        out: List[Action] = []
        for node in self.network.network.nodes:
            n_axes = len(self.network.node_tensor(node).indices)
            out.extend(
                ISplit(node, combo)
                for combo in half_bipartitions(range(n_axes), n_axes)
            )
        return out

    @staticmethod
    def all_index_combs(free_indices: Sequence[Index]):
        """Free-index bipartitions (smaller half, each appearing once)."""
        ordered = sorted(free_indices)
        return half_bipartitions(ordered, len(ordered))

    def get_legal_index_actions(self) -> List[Action]:
        """OSplits that extend the history canonically: strictly after the
        previous action in the action order, and non-conflicting."""
        history = self.past_actions
        candidates = (
            OSplit(comb)
            for comb in SearchState.all_index_combs(
                self.network.free_indices()
            )
        )
        if not history:
            return list(candidates)
        last = history[-1]
        return [
            ac
            for ac in candidates
            if last < ac and ac.is_valid(history)
        ]

    # -- successor generation -------------------------------------------------

    def take_action(
        self, action: Action, config: SearchConfig, svd=None, network=None
    ) -> Iterator["SearchState"]:
        """Successor states of applying ``action`` to this state.

        ``svd`` injects a precomputed decomposition (the batched scorer
        contract: (U, s, V) on the device plus the host copy of s);
        ``network`` optionally supplies the base network the
        decomposition was computed ON — the scorer's orthonormalized
        copy for multi-node states, where injecting factors into the
        un-orthonormalized graph would change the represented tensor.
        """
        if isinstance(action, Merge):
            child = self._child(copy.deepcopy(self.network), self.curr_delta)
            action.execute(child.network)
            child.past_actions = self.past_actions + [action]
            yield child
            return
        if not isinstance(action, (ISplit, OSplit)):
            raise TypeError(f"cannot apply {type(action).__name__}")

        if not action.is_valid(self.past_actions):
            return
        if action.delta is not None:
            self.curr_delta = action.delta

        base = self.network if network is None else network
        work = copy.deepcopy(base)
        try:
            names, cap = action.execute(work, svd)
        except (torch.linalg.LinAlgError, ValueError):
            return
        # the scorer hands over its host copy of s as a fourth entry
        spectrum = svd[3] if svd is not None and len(svd) > 3 else None
        for child in self._commit_split(
            work, names, cap, config, action.target_size, spectrum
        ):
            child.past_actions = self.past_actions + [action]
            yield child

    def _commit_split(
        self,
        net: TensorNetwork,
        names,
        cap: int,
        config: SearchConfig,
        target_size: Optional[int],
        spectrum: Optional[np.ndarray] = None,
    ) -> Iterator["SearchState"]:
        """Instantiate one successor per candidate rank of the new bond.

        ``spectrum`` is the host copy of the new bond's singular values
        where the caller has one; otherwise it is read here, once."""
        u, s, v = names
        if spectrum is None:
            spectrum = net.value(s).diagonal().cpu().numpy()
        budget_sq = self.curr_delta**2
        ranks, spent = rank_variants(
            spectrum,
            budget_sq,
            config.rank_search.error_split_stepsize,
            target_size,
        )

        if ranks is None:
            # nothing truncatable: keep the split at full rank
            if config.heuristics.prune_full_rank and cap == len(spectrum):
                return
            kept = copy.deepcopy(net)
            kept.merge(v, s)
            child = self._child(kept, self.curr_delta)
            child.links.append(kept.get_contraction_index(u, v)[0].name)
            yield child
            return

        # the candidates are slices of the split's factors, on their device
        u_val, s_val, v_val = net.value(u), net.value(s), net.value(v)
        left = float(np.sqrt(budget_sq - spent))
        for rank in ranks:
            cand = copy.deepcopy(net)
            cand.node_tensor(u).update_val_size(u_val[..., :rank])
            cand.node_tensor(s).update_val_size(s_val[:rank, :rank])
            cand.node_tensor(v).update_val_size(v_val[:rank, ...])
            cand.merge(v, s)
            child = self._child(cand, left)
            child.links.append(cand.get_contraction_index(u, v)[0].name)
            yield child

    def _child(self, net: TensorNetwork, delta: float) -> "SearchState":
        return SearchState(
            net, delta, threshold=self.threshold, max_ops=self.max_ops
        )

    # -- predicates -----------------------------------------------------------

    def is_terminal(self) -> bool:
        """No-op states and node-budget exhaustion end a trajectory."""
        return self.is_noop or (
            len(self.network.network.nodes) >= self.max_ops
        )

    def optimize(self) -> None:
        """Re-truncate in place within the remaining budget: orthonormalize
        at the node holding the first free index, then round."""
        anchor = self.network.free_indices()[0]
        root = self.network.node_by_free_index(anchor.name)
        root = self.network.orthonormalize(root)
        _, self.curr_delta = self.network.round(root, self.curr_delta)

    def get_result(self, total_cost: float) -> float:
        """1.0 iff compressed below ``threshold`` x the dense cost."""
        if self.is_noop:
            return 0.0
        return float(
            self.network.cost() <= self.threshold * total_cost
        )

    def __lt__(self, other: "SearchState") -> bool:
        # more budget headroom per unit cost explores first
        return (self.curr_delta**2 / self.network.cost()) < (
            other.curr_delta**2 / other.network.cost()
        )
