"""Exact rank assignment by branch-and-bound (replaces the reference's
Gurobi ILP, ``pytens/search/constraint.py``).

Counterpart of ``tensor_networks_tpu/search/constraint.py``, copied: it
is pure Python on the host.

The problem is tiny — at most ``max_ops`` edges, each with a handful of
binned rank candidates — so an exact host-side search with error-budget
and cost-bound pruning solves it in microseconds, with no closed-source
solver dependency.  Semantics match the ILP: one candidate per edge,
sum of truncation errors <= delta^2, minimize the sum of core sizes,
subject to cost <= upper.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

BAD_SCORE = 9999999999999


class RankAssignmentSolver:
    """Exact minimizer over per-edge candidate ranks.

    Each variable edge has candidate sizes with associated squared-error
    contributions; each network node costs (product of its fixed index
    sizes) x (product of its variable edges' chosen sizes).
    """

    def __init__(self) -> None:
        self.edges: List[str] = []
        self.candidates: Dict[str, List[int]] = {}
        self.errors: Dict[str, List[float]] = {}
        self.node_terms: List[Tuple[float, List[str]]] = []

    def add_edge(
        self, name: str, sizes: Sequence[int], errs: Sequence[float]
    ) -> None:
        self.edges.append(name)
        self.candidates[name] = list(sizes)
        self.errors[name] = list(errs)

    def add_node_term(self, fixed_cost: float, edge_names: List[str]) -> None:
        self.node_terms.append((fixed_cost, edge_names))

    def solve(
        self, delta: float, upper: float
    ) -> Tuple[Optional[Dict[str, int]], float]:
        """Returns (assignment name->size, cost) or (None, BAD_SCORE)."""
        budget = delta**2
        order = self.edges

        # per-edge minimum possible size (for the cost lower bound) and
        # minimum possible error (for the budget lower bound)
        min_size = {e: min(self.candidates[e]) for e in order}
        min_err = {e: min(self.errors[e]) for e in order}

        def cost_of(assign: Dict[str, int]) -> float:
            total = 0.0
            for fixed, enames in self.node_terms:
                term = fixed
                for e in enames:
                    term *= assign[e]
                total += term
            return total

        def lower_bound(assign: Dict[str, int]) -> float:
            total = 0.0
            for fixed, enames in self.node_terms:
                term = fixed
                for e in enames:
                    term *= assign.get(e, min_size[e])
                total += term
            return total

        best_cost = float(upper)
        best_assign: Optional[Dict[str, int]] = None

        def rec(i: int, assign: Dict[str, int], err: float) -> None:
            nonlocal best_cost, best_assign
            if err > budget:
                return
            if lower_bound(assign) > best_cost:
                return
            if i == len(order):
                c = cost_of(assign)
                if c <= best_cost:
                    best_cost = c
                    best_assign = dict(assign)
                return
            e = order[i]
            remaining_min = sum(min_err[o] for o in order[i + 1 :])
            # try larger sizes first (smaller error) so feasible solutions
            # appear early and tighten the bound
            for sz, er in zip(self.candidates[e], self.errors[e]):
                if err + er + remaining_min > budget:
                    continue
                assign[e] = sz
                rec(i + 1, assign, err + er)
                del assign[e]

        rec(0, {}, 0.0)
        if best_assign is None:
            return None, BAD_SCORE
        return best_assign, best_cost
