"""Exhaustive structure-search drivers.

Two enumeration disciplines over the same MDP (:mod:`.mdp`):

* :func:`run_bfs` — level-order worklist; counts every candidate state it
  generates.
* :func:`run_dfs` — recursive deepening with last-level rank narrowing
  (only the tightest truncation is explored at the final depth); counts
  every state it expands.

Both deduplicate (optionally) on the network's canonical topology hash and
track the cheapest network seen.  Counting/dedup/ordering semantics are
observable — the test suite pins exact visited-state counts — and match
the reference engine (``pytens/search/exhaustive.py``).

Counterpart of ``tensor_networks_tpu/search/drivers.py``, the logic
copied; the search runs on the device of the network it is given.
"""

from __future__ import annotations

import copy
import dataclasses
import time
from typing import List, Optional, Set, Tuple

from tensor_networks_tpu_torch.network import TensorNetwork
from tensor_networks_tpu_torch.search.batched import scored_splits
from tensor_networks_tpu_torch.search.configuration import SearchConfig
from tensor_networks_tpu_torch.search.mdp import SearchState
from tensor_networks_tpu_torch.search.trace import SearchTrace
from tensor_networks_tpu_torch.tensor import Tensor


def _narrowed(config: SearchConfig, width: int) -> SearchConfig:
    """A config whose truncation branching factor is ``width``."""
    if config.rank_search.error_split_stepsize == width:
        return config
    return dataclasses.replace(
        config,
        rank_search=dataclasses.replace(
            config.rank_search, error_split_stepsize=width
        ),
    )


def run_bfs(
    net: TensorNetwork, config: SearchConfig
) -> Tuple[dict, Optional[TensorNetwork], Tensor]:
    """Level-order exhaustive enumeration.

    Returns ``(stats, best_network, target_tensor)``; ``best_network`` is
    None when the timeout expired before any candidate was scored.
    """
    target = net.contract()
    trace = SearchTrace(target, config.engine.verbose)
    budget = config.engine.eps * net.norm()
    use_osplit = config.synthesizer.action_type == "osplit"
    dedup = config.heuristics.prune_duplicates

    frontier: List[SearchState] = [
        SearchState(copy.deepcopy(net), budget)
    ]
    seen: Set[int] = {net.canonical_structure()}
    best: Optional[TensorNetwork] = None
    count = 0
    start = time.time()

    while frontier:
        state = frontier.pop(0)
        if (
            config.engine.timeout is not None
            and time.time() - start >= config.engine.timeout
        ):
            break
        actions = state.get_legal_actions(use_osplit)
        # single-node states: every action's SVD in shape-grouped
        # batched device/host calls; multi-node states: one shared
        # environment orthonormalization per target node (no-op {}
        # when ineligible; absent actions take the per-action path)
        scored = scored_splits(state, actions)
        for action in actions:
            sv, base = scored.get(action, (None, None))
            for child in state.take_action(
                action, config=config, svd=sv, network=base
            ):
                if config.heuristics.prune_full_rank and child.is_noop:
                    continue
                count += 1
                if best is None or best.cost() > child.network.cost():
                    best = child.network
                dup = False
                if dedup:
                    key = child.network.canonical_structure(
                        consider_ranks=config.heuristics.prune_by_ranks
                    )
                    dup = key in seen
                    seen.add(key)
                if not dup and (
                    len(child.past_actions) < config.engine.max_ops
                ):
                    frontier.append(child)
                trace.record(child, best if best is not None else net)

    trace.stats["time"] = trace.elapsed()
    trace.stats["count"] = count
    return trace.stats, best, target


def run_dfs(
    net: TensorNetwork, config: SearchConfig
) -> Tuple[dict, TensorNetwork, Tensor]:
    """Depth-first exhaustive enumeration with last-level narrowing."""
    target = net.contract()
    trace = SearchTrace(target, config.engine.verbose)
    budget = config.engine.eps * net.norm()
    use_osplit = config.synthesizer.action_type == "osplit"
    width = config.rank_search.error_split_stepsize
    best = net
    seen: Set[int] = set()
    start = time.time()

    def expand(state: SearchState) -> None:
        nonlocal best
        trace.stats["count"] += 1
        depth = len(state.past_actions)
        if depth >= config.engine.max_ops:
            return
        if (
            config.engine.timeout is not None
            and time.time() - start > config.engine.timeout
        ):
            return
        last_level = depth + 1 >= config.engine.max_ops

        actions = state.get_legal_actions(use_osplit)
        # Last level: the reference-pinned semantics stop the whole
        # expansion after the first KEPT child (exhaustive.py:192-194),
        # so typically only the first action's SVD is consumed (more
        # when earlier actions yield only noop-pruned children or a
        # failed SVD — the per-action fallback covers those) —
        # batch-precomputing all of them is mostly waste.  BFS
        # consumes every action, so run_bfs always precomputes.
        scored = {} if last_level else scored_splits(state, actions)
        for action in actions:
            level_config = _narrowed(config, 1 if last_level else width)
            sv, base = scored.get(action, (None, None))
            for child in state.take_action(
                action, config=level_config, svd=sv, network=base
            ):
                if config.heuristics.prune_full_rank and child.is_noop:
                    continue
                if child.network.cost() < best.cost():
                    best = child.network
                trace.record(child, best)

                if config.heuristics.prune_duplicates:
                    key = child.network.canonical_structure(
                        consider_ranks=config.heuristics.prune_by_ranks
                    )
                    if key in seen:
                        # a repeated topology ends this whole expansion
                        return
                    seen.add(key)
                if last_level:
                    return
                expand(child)

    expand(SearchState(net, budget))
    trace.stats["time"] = trace.elapsed()
    return trace.stats, best, target
