"""Program synthesis: output-directed splits + exact rank assignment.

The flagship search pipeline, staged as explicit functions:

1. :class:`~.spectra.SplitSpectra` — per-bipartition singular spectra of
   the dense target, binned into rank candidates (device-batched SVDs).
2. :func:`explore_programs` — enumerate symbolic split programs (graph
   surgery only, no data) level by level up to ``max_ops``, scoring each
   with the exact :class:`~.constraint.RankAssignmentSolver` in ``topk``
   mode.
3. Replay — re-execute the best programs with real data around the solved
   ranks and round every node.

When a wall-clock budget is set, stage 2 runs in a *killable* child
process (spawn, host-only work): a hung solver or a pathological
enumeration is terminated at the deadline and the parent continues with
whatever the replay stage can do — matching the reference's watchdog
semantics (``pytens/search/partition.py`` runs fill_holes in a killable
``multiprocessing.Process``) without ever forking a live JAX backend.

Counterpart of ``tensor_networks_tpu/search/synthesis.py``.  The
watchdog child never touches the card: it is sent CPU copies
(:func:`watchdog_payload`) and starts with ``CUDA_VISIBLE_DEVICES``
empty, and it reports what it saw of the card
(``explore_with_watchdog.last_child``).
"""

from __future__ import annotations

import copy
import multiprocessing as mp
import os
import pickle
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from tensor_networks_tpu_torch.network import TensorNetwork
from tensor_networks_tpu_torch.search.actions import Action, OSplit
from tensor_networks_tpu_torch.search.configuration import SearchConfig
from tensor_networks_tpu_torch.search.constraint import (
    BAD_SCORE,
    RankAssignmentSolver,
)
from tensor_networks_tpu_torch.search.mdp import SearchState
from tensor_networks_tpu_torch.search.spectra import SplitSpectra
from tensor_networks_tpu_torch.search.trace import remove_temp_dir
from tensor_networks_tpu_torch.types import SVDConfig

Program = Tuple[Action, ...]


# -- symbolic execution --------------------------------------------------------


def symbolic_child(state: SearchState, action: Action) -> SearchState:
    """Apply a split as pure graph surgery (no numerical data)."""
    split = (
        action.to_isplit(state.network)
        if isinstance(action, OSplit)
        else action
    )
    net = copy.deepcopy(state.network)
    (u, s, v), _ = net.svd(
        split.node, split.left_indices, SVDConfig(compute_data=False)
    )
    net.merge(v, s, compute_data=False)

    child = SearchState(net, state.curr_delta)
    child.past_actions = state.past_actions + [action]
    child.links = state.links + [net.get_contraction_index(u, v)[0].name]
    return child


def osplit_view(state: SearchState, step: int) -> OSplit:
    """The free-index form of the ``step``-th split in a program: cut the
    bond it created and name the side with fewer free indices."""
    bond = state.links[step]
    net = state.network
    ends = [
        n
        for n in net.network.nodes
        if any(i.name == bond for i in net.node_tensor(n).indices)
    ]
    if len(ends) != 2:
        raise ValueError(f"bond {bond} does not have two endpoints: {ends}")

    all_free = net.free_indices()
    owner = {}
    for n in net.network.nodes:
        for i in net.node_tensor(n).indices:
            if i in all_free:
                owner.setdefault(i, n)

    sides = []
    for keep, drop in (ends, ends[::-1]):
        comp = net.network.reachable_from(keep, blocked={drop})
        sides.append([i for i in all_free if owner[i] in comp])
    return OSplit(min(sides, key=lambda fr: (len(fr), sorted(fr))))


# -- scoring --------------------------------------------------------------------


def assign_ranks(
    state: SearchState,
    spectra: SplitSpectra,
    delta: float,
    upper: float,
) -> Tuple[Dict[int, int], float]:
    """Optimal bond ranks for one symbolic program.

    Builds the assignment problem directly from the program's links and
    the binned spectra — no graph mutation — and returns
    ``(step -> solved size, total cost)`` or ``({}, BAD_SCORE)``.
    """
    solver = RankAssignmentSolver()
    free = state.network.free_indices()

    for step, action in enumerate(state.past_actions):
        split = (
            action
            if isinstance(action, OSplit)
            else osplit_view(state, step)
        )
        errs, sizes = spectra.candidates(split)
        solver.add_edge(state.links[step], sizes, errs)

    for n in state.network.network.nodes:
        fixed = 1.0
        bonds = []
        for ind in state.network.node_tensor(n).indices:
            if ind in free:
                fixed *= ind.size
            else:
                bonds.append(ind.name)
        solver.add_node_term(fixed, bonds)

    assignment, cost = solver.solve(delta, upper)
    if assignment is None:
        return {}, BAD_SCORE
    return (
        {k: assignment[link] for k, link in enumerate(state.links)},
        cost,
    )


# -- enumeration ------------------------------------------------------------------


class ExploreResult:
    """What the (possibly child-process) enumeration stage produces."""

    def __init__(self) -> None:
        self.costs: Dict[Program, float] = {}
        self.ranks: Dict[Program, Dict[int, int]] = {}
        self.order: List[Program] = []
        self.count = 0


def explore_programs(
    net: TensorNetwork,
    delta: float,
    spectra: SplitSpectra,
    config: SearchConfig,
    deadline: Optional[float] = None,
    score: bool = True,
) -> ExploreResult:
    """Enumerate symbolic split programs level by level.

    With ``score``, each program is rank-solved as it appears, with the
    running k-th-best cost as the solver's pruning bound.
    """
    result = ExploreResult()
    init = SearchState(net, delta)
    use_osplit = config.synthesizer.action_type == "osplit"
    bound: List[float] = [net.cost()]

    frontier = [init]
    for _ in range(config.engine.max_ops):
        nxt: List[SearchState] = []
        for state in frontier:
            if deadline is not None and time.time() > deadline:
                break
            for action in state.get_legal_actions(use_osplit):
                child = symbolic_child(state, action)
                result.count += 1
                program = tuple(child.past_actions)
                result.order.append(program)
                if score:
                    ranks, cost = assign_ranks(
                        child, spectra, delta, bound[-1]
                    )
                    result.costs[program] = cost
                    result.ranks[program] = ranks
                    if cost != BAD_SCORE:
                        bound = sorted(bound + [cost])[
                            : config.rank_search.k
                        ]
                nxt.append(child)
        frontier = nxt
    return result


# -- killable watchdog -------------------------------------------------------------


def watchdog_payload(
    net: TensorNetwork,
    delta: float,
    spectra: SplitSpectra,
    config: SearchConfig,
    score: bool,
) -> bytes:
    """The watchdog child's pickled arguments, every tensor a CPU copy:
    a CUDA tensor would be unpickled onto the card in the child."""
    host = copy.deepcopy(net)
    for n in host.network.nodes:
        host.node_tensor(n).update_val_size(host.value(n).cpu())
    return pickle.dumps((host, delta, spectra, config, score))


def _explore_worker(conn, payload: bytes) -> None:
    """Child-process entry (started with the card hidden): run the
    enumeration, ship the result back with what the child saw of the
    card."""
    if os.environ.get("TNT_FAULT_HANG_EXPLORE"):
        # fault injection for watchdog tests: simulate a hung solver
        time.sleep(600)
    net, delta, spectra, config, score = pickle.loads(payload)
    result = explore_programs(
        net, delta, spectra, config, deadline=None, score=score
    )
    seen = {
        "CUDA_VISIBLE_DEVICES": os.environ.get("CUDA_VISIBLE_DEVICES"),
        "cuda_initialized": torch.cuda.is_initialized(),
    }
    conn.send(
        (result.costs, result.ranks, result.order, result.count, seen)
    )
    conn.close()


def explore_with_watchdog(
    net: TensorNetwork,
    delta: float,
    spectra: SplitSpectra,
    config: SearchConfig,
    timeout: float,
    score: bool = True,
) -> ExploreResult:
    """Run :func:`explore_programs` in a child that is killed at the
    deadline; returns whatever completed (empty on kill).  What the
    child reported of the card is kept in
    ``explore_with_watchdog.last_child`` (None when nothing came back)."""
    result = ExploreResult()
    explore_with_watchdog.last_child = None
    if timeout <= 0:
        return result

    ctx = mp.get_context("spawn")
    parent_conn, child_conn = ctx.Pipe(duplex=False)
    payload = watchdog_payload(net, delta, spectra, config, score)
    proc = ctx.Process(
        target=_explore_worker, args=(child_conn, payload), daemon=True
    )
    # the child inherits the environment as it is at start: no device
    saved = os.environ.get("CUDA_VISIBLE_DEVICES")
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    try:
        proc.start()
    finally:
        if saved is None:
            del os.environ["CUDA_VISIBLE_DEVICES"]
        else:
            os.environ["CUDA_VISIBLE_DEVICES"] = saved
    child_conn.close()

    if parent_conn.poll(timeout):
        costs, ranks, order, count, seen = parent_conn.recv()
        result.costs, result.ranks = costs, ranks
        result.order, result.count = order, count
        explore_with_watchdog.last_child = seen
    proc.terminate()
    proc.join()
    parent_conn.close()
    return result


explore_with_watchdog.last_child = None


# -- the pipeline -------------------------------------------------------------------


class PartitionSearch:
    """Output-directed split synthesis with exact rank assignment."""

    def __init__(self, config: SearchConfig):
        self.config = config
        self.stats: Dict = {
            "unique": {},
            "compression": [],
            "count": 0,
            "tic": 0.0,
            "best_network": None,
        }
        self.spectra = SplitSpectra(config)
        self.delta = 0.0

    # -- replay stage -------------------------------------------------------

    def _replay(
        self,
        state: SearchState,
        actions: Sequence[Action],
        use_spill: bool = False,
    ) -> None:
        """Execute a program with real data; at the leaf, round every
        node and keep the cheapest network."""
        if not actions:
            for n in state.network.network.nodes:
                candidate = copy.deepcopy(state.network)
                candidate.round(n, state.curr_delta)
                if (
                    candidate.cost()
                    < self.stats["best_network"].cost()
                ):
                    self.stats["best_network"] = candidate
            return

        head, tail = actions[0], actions[1:]
        svd = None
        if use_spill and isinstance(head, OSplit):
            path = self.spectra.svd_file(head)
            if path is not None:
                data = np.load(path)
                svd = (data["u"], data["s"], data["v"])

        for child in state.take_action(head, config=self.config, svd=svd):
            self.stats["compression"].append(
                (time.time() - self.stats["tic"], child.network.cost())
            )
            key = child.network.canonical_structure()
            self.stats["unique"][key] = (
                self.stats["unique"].get(key, 0) + 1
            )
            self._replay(child, tail)

    def _replay_topk(
        self, init: SearchState, explored: ExploreResult
    ) -> None:
        """Instantiate the k cheapest feasible programs."""
        scored = sorted(
            (cost, program)
            for program, cost in explored.costs.items()
            if cost != BAD_SCORE
        )
        for _, program in scored[: self.config.rank_search.k]:
            solved = explored.ranks[program]
            for step, action in enumerate(program):
                action.target_size = solved[step]
            self.stats["best_acs"] = program
            self._replay(init, list(program), use_spill=False)

    def _replay_all(
        self, init: SearchState, explored: ExploreResult
    ) -> None:
        """fit_mode == "all": replay every program, splitting the budget
        evenly across its steps and seeding the first split from the
        spilled factors."""
        for program in explored.order:
            per_step = self.delta / np.sqrt(len(program))
            for action in program:
                action.delta = per_step
            self._replay(init, list(program), use_spill=True)

    # -- result assembly ------------------------------------------------------

    def _finish(self, net: TensorNetwork, target_value: torch.Tensor) -> Dict:
        free = net.free_indices()
        best = self.stats["best_network"]
        self.stats["cr_core"] = (
            float(np.prod([i.size for i in free])) / best.cost()
        )
        self.stats["cr_start"] = net.cost() / best.cost()

        dense = best.contract()
        perm = [dense.indices.index(i) for i in free]
        value = dense.permute(perm).value
        self.stats["reconstruction_error"] = float(
            torch.linalg.vector_norm(value - target_value)
            / torch.linalg.vector_norm(target_value)
        )
        return self.stats

    # -- entry points ------------------------------------------------------------

    def search(self, net: TensorNetwork) -> Dict:
        """Full pipeline from a (usually single-node) network."""
        if self.config.synthesizer.replay_from is not None:
            return self._search_from_log(net)

        start = time.time()
        self.stats["best_network"] = net
        self.delta = net.norm() * self.config.engine.eps
        target = net.contract()

        spill_uv = self.config.rank_search.fit_mode == "all"
        self.spectra.build(target, spill_uv=spill_uv)
        preprocess_end = time.time()

        self.stats["tic"] = time.time()
        init = SearchState(net, self.delta)
        timeout = self.config.engine.timeout
        try:
            if timeout is not None:
                explored = explore_with_watchdog(
                    net,
                    self.delta,
                    self.spectra,
                    self.config,
                    timeout,
                    score=not spill_uv,
                )
            else:
                explored = explore_programs(
                    net,
                    self.delta,
                    self.spectra,
                    self.config,
                    score=not spill_uv,
                )
            self.stats["count"] = explored.count

            if spill_uv:
                self._replay_all(init, explored)
            else:
                self._replay_topk(init, explored)
        finally:
            if self.config.output.remove_temp_after_run:
                remove_temp_dir(
                    self.config.output.output_dir,
                    self.spectra.temp_files,
                )

        self.stats["time"] = time.time() - start
        self.stats["preprocess"] = preprocess_end - start
        return self._finish(net, target.value)

    def _search_from_log(self, net: TensorNetwork) -> Dict:
        """Resume-by-log: rank-solve and replay a pickled program."""
        start = time.time()
        self.stats["tic"] = start
        with open(self.config.synthesizer.replay_from, "rb") as f:
            program = list(pickle.load(f))

        self.stats["best_network"] = net
        self.delta = net.norm() * self.config.engine.eps
        target = net.contract()
        self.spectra.build(
            target, combs=[ac.indices for ac in program]
        )
        preprocess_end = time.time()

        try:
            init = SearchState(net, self.delta)
            state = init
            for action in program:
                action.target_size = None
                state = symbolic_child(state, action)
            solved, cost = assign_ranks(
                state, self.spectra, self.delta, net.cost()
            )
            if cost != BAD_SCORE:
                for step, action in enumerate(program):
                    action.target_size = solved[step]
                self.stats["best_acs"] = tuple(program)
                self._replay(init, program, use_spill=False)
        finally:
            if self.config.output.remove_temp_after_run:
                remove_temp_dir(
                    self.config.output.output_dir,
                    self.spectra.temp_files,
                )

        self.stats["time"] = time.time() - start
        self.stats["preprocess"] = preprocess_end - start
        return self._finish(net, target.value)
