"""The port's structure search (``tensor_networks_tpu_torch.search``)
against the JAX package's, on the CPU in float64.

The JAX package runs only in the module-scoped ``jax_ref`` fixture: dfs,
bfs and partition search on the reference suite's 3x4x5 target at eps
0.5, and its batched scorer forced on.  The port matches it there:
counts equal, best-network cost and free indices equal,
``reconstruction_error`` within 1e-10 relative, the scorer's singular
values within 1e-10 of the top one.  Everything else is held to the
JAX suite's exact counts (``tests/test_search.py``,
``test_batched_search.py``, ``test_timeouts.py``) and to dense oracles:
the batched scorer against the per-action path, its factors against
each matricization, the rank solver against brute force.
"""

import dataclasses
import itertools
import json
import math
import os
import pickle
import time

import numpy as np
import pytest
import torch

import tensor_networks_tpu as jtn
from tensor_networks_tpu.search import SearchConfig as JSearchConfig
from tensor_networks_tpu.search import SearchEngine as JSearchEngine
from tensor_networks_tpu.search import batched as jbatched
from tensor_networks_tpu.search.mdp import SearchState as JSearchState
from tensor_networks_tpu_torch import Index, Tensor, TensorNetwork
from tensor_networks_tpu_torch.search import (
    ISplit,
    OSplit,
    SearchConfig,
    SearchEngine,
    SearchState,
)
from tensor_networks_tpu_torch.search import batched, spectra, synthesis
from tensor_networks_tpu_torch.search.constraint import (
    BAD_SCORE,
    RankAssignmentSolver,
)

# The suite runs in several worker processes on the CPU: torch's own
# thread pool would spin on the cores the other workers need.
torch.set_num_threads(1)

RTOL = 1e-10
SHAPE3 = (3, 4, 5)


def _data(shape, seed):
    np.random.seed(seed)
    return np.random.randn(*shape)


def _net(shape=SHAPE3, seed=1, names=None):
    names = names or [f"i{k}" for k in range(len(shape))]
    net = TensorNetwork()
    net.add_node(
        "G",
        Tensor(
            torch.from_numpy(_data(shape, seed)),
            [Index(nm, s) for nm, s in zip(names, shape)],
        ),
    )
    return net


def _jnet(shape=SHAPE3, seed=1, names=None):
    names = names or [f"i{k}" for k in range(len(shape))]
    net = jtn.TensorNetwork()
    net.add_node(
        "G",
        jtn.Tensor(
            _data(shape, seed), [jtn.Index(nm, s) for nm, s in zip(names, shape)]
        ),
    )
    return net


def _config(cls=SearchConfig, eps=0.5, **sections):
    config = cls()
    config.engine.eps = eps
    for key, value in sections.items():
        section, field = key.split("__")
        setattr(getattr(config, section), field, value)
    return config


def _run(kind, net, monkeypatch=None, force=None, engine=SearchEngine, **cfg):
    if monkeypatch is not None:
        if force is None:
            monkeypatch.delenv("TNT_SEARCH_DEVICE", raising=False)
        else:
            monkeypatch.setenv("TNT_SEARCH_DEVICE", force)
    cls = SearchConfig if engine is SearchEngine else JSearchConfig
    return getattr(engine(config=_config(cls, **cfg)), kind)(net)


def _summary(stats):
    best = stats["best_network"]
    return {
        "count": stats["count"],
        "cost": best.cost(),
        "free": [(i.name, i.size) for i in best.free_indices()],
        "error": stats["reconstruction_error"],
    }


def _mat(data, axes):
    rest = [k for k in range(data.ndim) if k not in axes]
    rows = math.prod(data.shape[a] for a in axes)
    return np.transpose(data, list(axes) + rest).reshape(rows, -1)


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX package's runs, once each: dfs, bfs and partition search
    at 3x4x5 (eps 0.5), and its batched scorer forced on (4x3x6)."""
    saved = os.environ.get("TNT_SEARCH_DEVICE")
    try:
        os.environ.pop("TNT_SEARCH_DEVICE", None)
        out = {
            kind: _summary(_run(kind, _jnet(), engine=JSearchEngine))
            for kind in ("dfs", "bfs", "partition_search")
        }
        os.environ["TNT_SEARCH_DEVICE"] = "1"
        jnet = _jnet((4, 3, 6), 7)
        state = JSearchState(jnet, 0.5)
        svds = jbatched.batched_split_svds(jnet, state.get_legal_actions(True))
        out["svals"] = {str(a): np.asarray(s) for a, (_, s, _) in svds.items()}
    finally:
        if saved is None:
            os.environ.pop("TNT_SEARCH_DEVICE", None)
        else:
            os.environ["TNT_SEARCH_DEVICE"] = saved
    return out


# -- configuration -------------------------------------------------------------

CONFIG_JSON = [
    {},
    {"synthesizer": {"action_type": "isplit"}, "rank_search": {"fit_mode": "all", "k": 3}},
    {"engine": {"eps": 0.25, "max_ops": 3, "timeout": 10.0, "verbose": True},
     "heuristics": {"prune_full_rank": True, "prune_duplicates": True,
                    "prune_by_ranks": False},
     "output": {"output_dir": "/tmp/x", "remove_temp_after_run": False},
     "preprocess": {"force_recompute": True},
     "synthesizer": {"bin_size": 0.2, "replay_from": "p.pkl"}},
    {"engine": {"epsilon": 0.1}},
    {"rank_search": {"fit_mode": "some"}},
    {"synthesizer": {"action_type": "merge"}},
    {"engine": 3},
    {"extra": {}},
]


@pytest.mark.parametrize("data", CONFIG_JSON)
def test_config_json_round_trip(data):
    """A JSON file the JAX loader accepts loads the same in the port, and
    one it refuses is refused with the same error."""
    text = json.dumps(data)
    outcome = []
    for cls in (JSearchConfig, SearchConfig):
        try:
            outcome.append(dataclasses.asdict(cls.load(text)))
        except (TypeError, ValueError) as exc:
            outcome.append((type(exc), str(exc)))
    assert outcome[0] == outcome[1]


def test_config_load_file(tmp_path):
    path = tmp_path / "search.json"
    path.write_text(json.dumps({"rank_search": {"fit_mode": "all", "k": 3}}))
    config = SearchConfig.load_file(str(path))
    assert config.rank_search.fit_mode == "all" and config.rank_search.k == 3


# -- actions and states --------------------------------------------------------


def test_action_order_and_equality():
    assert ISplit("n1", [0, 1]) != ISplit("n1", [0])
    assert ISplit("n1", [0, 1]) != ISplit("n2", [0, 1])
    i0, i1, i2 = Index("I0", 1), Index("I1", 2), Index("I2", 2)
    assert OSplit([i0, i1]) != OSplit([i0])
    assert OSplit([i0, i1]) == OSplit([i1, i0])
    assert OSplit([i0]) < OSplit([i0, i1]) < OSplit([i2, i0])


@pytest.mark.parametrize("kind", ["isplit", "osplit"])
def test_split_execution(kind):
    names = "ijkl"
    net = _net((3, 4, 5, 6), 0, names)
    first, second = (
        (ISplit("G", [0, 1]), ISplit("G", [0]))
        if kind == "isplit"
        else (OSplit([Index("i", 3), Index("k", 5)]), OSplit([Index("i", 3)]))
    )
    (u, s, v), _ = first.execute(net)
    shapes = [tuple(net.value(n).shape) for n in (u, s, v)]
    assert shapes == ([(3, 4, 12), (12, 12), (12, 5, 6)] if kind == "isplit"
                      else [(3, 5, 15), (15, 15), (15, 4, 6)])
    net.merge(v, s)
    (u, s, v), _ = second.execute(net)
    assert [tuple(net.value(n).shape) for n in (u, s)] == [(3, 3), (3, 3)]


def test_legal_actions():
    net = _net(names="ijk")
    init = SearchState(net, net.norm() * 0.1)
    assert init.get_legal_actions() == [ISplit("G", [k]) for k in range(3)]
    i, j, k = Index("i", 3), Index("j", 4), Index("k", 5)
    assert init.get_legal_actions(True) == [OSplit([i]), OSplit([j]), OSplit([k])]
    for child in init.take_action(ISplit("G", [0]), config=SearchConfig()):
        assert child.get_legal_actions() == [
            ISplit("n0", [0]), ISplit("n0", [1]), ISplit("n0", [2]), ISplit("G", [0])]
    for child in init.take_action(OSplit([i]), config=SearchConfig()):
        assert child.get_legal_actions(True) == [OSplit([j]), OSplit([k])]


# -- the reference counts ---------------------------------------------------------


def _check_best(stats, net, eps=0.5):
    free = net.free_indices()
    best = stats["best_network"]
    perm = [best.free_indices().index(i) for i in free]
    got = best.contract().permute(perm).value
    target = net.contract().value
    assert float(torch.linalg.vector_norm(target - got)) <= eps * net.norm()
    assert best.cost() <= net.cost()


@pytest.mark.parametrize(
    "kind,fit_mode,count",
    [("dfs", "topk", 8), ("bfs", "topk", 7), ("partition_search", "topk", 7),
     ("partition_search", "all", 7)],
)
def test_search_counts_match_the_reference(kind, fit_mode, count, jax_ref, monkeypatch, tmp_path):
    monkeypatch.delenv("TNT_SEARCH_DEVICE", raising=False)
    net = _net()
    stats = _run(kind, net, eps=0.5, engine__verbose=True,
                 rank_search__fit_mode=fit_mode, output__output_dir=str(tmp_path / "out"))
    assert stats["count"] == count
    _check_best(stats, net)
    if fit_mode == "topk":
        got, ref = _summary(stats), jax_ref[kind]
        assert (got["count"], got["cost"], got["free"]) == (ref["count"], ref["cost"], ref["free"])
        assert abs(got["error"] - ref["error"]) <= RTOL * ref["error"]
    else:
        assert not (tmp_path / "out").exists()  # the spilled factors were removed


def test_verbose_trace_keeps_the_stat_names(monkeypatch):
    monkeypatch.delenv("TNT_SEARCH_DEVICE", raising=False)
    stats = _run("bfs", _net(), engine__verbose=True)
    assert len(stats["costs"]) == len(stats["errors"]) == len(stats["ops"]) == 7
    assert sum(stats["unique"].values()) == 7
    assert all(0.0 <= e <= 0.5 for _, e in stats["errors"])


# -- the batched scorer -------------------------------------------------------------


@pytest.mark.parametrize(
    "kind,shape,seed,eps,max_ops,count",
    [("bfs", SHAPE3, 1, 0.5, 5, 7), ("dfs", SHAPE3, 1, 0.5, 5, 8),
     ("bfs", (3, 4, 5, 6), 3, 0.5, 5, 63),
     # depth 3 expands multi-node states: one shared orthonormalization
     # per node, then exact-shape batches of that node's matricizations
     ("bfs", (3, 4, 5, 6), 13, 0.4, 3, 47), ("dfs", (3, 4, 5, 6), 13, 0.4, 3, 26),
     # distinct mode sizes: 15 bipartitions in 15 exact shapes
     ("bfs", (2, 3, 5, 7, 11), 11, 0.5, 1, 15)],
)
def test_batched_counts_match_per_action_path(kind, shape, seed, eps, max_ops, count, monkeypatch):
    per_action = _run(kind, _net(shape, seed), monkeypatch, "0", eps=eps, engine__max_ops=max_ops)
    batched.scored_splits.per_action = 0
    scored = _run(kind, _net(shape, seed), monkeypatch, "1", eps=eps, engine__max_ops=max_ops)
    assert per_action["count"] == scored["count"] == count
    assert per_action["best_network"].cost() == scored["best_network"].cost()
    assert batched.scored_splits.per_action == 0


@pytest.mark.parametrize("shape,seed,groups", [((4, 3, 6), 7, 3), ((2, 3, 5, 7, 11), 11, 15),
                                               ((3, 3, 3, 3), 2, 2)])
@pytest.mark.parametrize("budget", [None, 10.0])
def test_batched_factors_reconstruct(shape, seed, groups, budget, monkeypatch):
    """Each exact-shape group is one batched call (SVD, or Gram + eigh
    under a comfortable budget); the factors reconstruct every
    matricization and the spectra are LAPACK's."""
    monkeypatch.setenv("TNT_SEARCH_DEVICE", "1")
    calls = []
    real = batched._group_factors
    monkeypatch.setattr(batched, "_group_factors",
                        lambda stack, gram: calls.append((stack.shape, gram)) or real(stack, gram))
    net = _net(shape, seed)
    actions = SearchState(net, 0.5).get_legal_actions(True)
    svds = batched.batched_split_svds(net, actions, budget=budget)
    assert len(svds) == len(actions)
    assert len(calls) == groups and all(gram == (budget is not None) for _, gram in calls)
    data = _data(shape, seed)
    free = net.free_indices()
    for action, (u, s, v, s_host) in svds.items():
        mat = _mat(data, [free.index(i) for i in action.indices])
        got = ((u * s) @ v).numpy()
        assert np.abs(got - mat).max() <= 1e-10 * np.abs(mat).max()
        ref = np.linalg.svd(mat, compute_uv=False)
        assert np.abs(s_host - ref[: len(s_host)]).max() <= RTOL * ref[0]
        assert np.array_equal(s.numpy(), s_host)


def test_batched_spectra_match_the_jax_scorer(jax_ref, monkeypatch):
    monkeypatch.setenv("TNT_SEARCH_DEVICE", "1")
    net = _net((4, 3, 6), 7)
    svds = batched.batched_split_svds(net, SearchState(net, 0.5).get_legal_actions(True))
    assert sorted(map(str, svds)) == sorted(jax_ref["svals"])
    for action, (_, _, _, s_host) in svds.items():
        ref = jax_ref["svals"][str(action)]
        assert s_host.shape == ref.shape
        assert np.abs(s_host - ref).max() <= RTOL * ref[0]


def test_eligibility_gates(monkeypatch):
    net = _net()
    monkeypatch.delenv("TNT_SEARCH_DEVICE", raising=False)
    assert not batched.device_scoring_eligible(net)  # a CPU state: off
    state = SearchState(net, 0.5)
    assert batched.scored_splits(state, state.get_legal_actions()) == {}
    monkeypatch.setenv("TNT_SEARCH_DEVICE", "0")
    assert not batched.device_scoring_eligible(net)
    monkeypatch.setenv("TNT_SEARCH_DEVICE", "1")
    assert batched.device_scoring_eligible(net)
    net.svd("G", [0])  # multi-node states never take the single-node path
    assert not batched.device_scoring_eligible(net)
    state = SearchState(net, 0.5)
    assert batched.maybe_batched_svds(state, state.get_legal_actions()) == {}
    assert batched.scored_splits(state, state.get_legal_actions())


def test_unresolvable_osplit_takes_the_per_action_path(monkeypatch):
    """An OSplit with no separating node is counted and left out; the
    others are scored on the shared orthonormalized base."""
    monkeypatch.setenv("TNT_SEARCH_DEVICE", "1")
    net = _net((3, 4, 5, 6), 5)
    net.svd("G", [0, 1])
    net.merge("n0", "n1")  # two nodes: (i0, i1) and (i2, i3)
    state = SearchState(net, 1.0)
    i = net.free_indices()
    actions = [OSplit([i[0], i[2]]), OSplit([i[0]]), OSplit([i[1]]), OSplit([i[2]])]
    batched.scored_splits.per_action = 0
    scored = batched.scored_splits(state, actions)
    assert batched.scored_splits.per_action == 1
    assert set(scored) == set(actions[1:])
    assert list(state.take_action(actions[0], SearchConfig())) == []


def test_scored_children_stay_on_the_root_device(monkeypatch):
    """A child's factors are slices of the scorer's factors: no copy, no
    host round trip (the card test checks the device)."""
    monkeypatch.setenv("TNT_SEARCH_DEVICE", "1")
    net = _net((4, 3, 6), 9)
    state = SearchState(net, 0.5)
    actions = state.get_legal_actions(True)
    svds = batched.maybe_batched_svds(state, actions)
    u = svds[actions[0]][0]
    children = list(state.take_action(actions[0], SearchConfig(), svd=svds[actions[0]]))
    assert children
    for child in children:
        for node in child.network.network.nodes:
            assert child.network.value(node).device == net.value("G").device
        u_node = child.network.node_by_free_index(actions[0].indices[0].name)
        assert (child.network.value(u_node).untyped_storage().data_ptr()
                == u.untyped_storage().data_ptr())


def _same_candidates(a, b, rtol):
    assert a[1] == b[1]
    assert np.allclose(a[0], b[0], rtol=rtol, atol=0.0)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_spectra_group_by_exact_shape(dtype, monkeypatch):
    """SplitSpectra makes one batched call per exact oriented shape (the
    float32 spectra through a float64 Gram), and matches LAPACK in
    float64 and the one-by-one path."""
    calls = []
    real = spectra.group_svals
    monkeypatch.setattr(spectra, "group_svals",
                        lambda stack: calls.append(tuple(stack.shape)) or real(stack))
    shape = (2, 3, 4, 5, 6)
    data = _data(shape, 4)
    net = _net(shape, 4)
    net.node_tensor("G").update_val_size(net.value("G").to(dtype))
    target = net.contract()
    config = _config(eps=0.3)
    grouped = spectra.SplitSpectra(config).build(target)
    combs = list(SearchState.all_index_combs(target.indices))
    oriented = set()
    for comb in combs:
        rows = math.prod(i.size for i in comb)
        oriented.add(tuple(sorted((rows, 720 // rows))))
    assert sorted(c[1:] for c in calls) == sorted(oriented)
    assert sum(c[0] for c in calls) == len(combs) == 15
    one_by_one = spectra.SplitSpectra(config).build(target, combs=combs)
    tol = RTOL if dtype == torch.float64 else 1e-5
    for comb in combs:
        _same_candidates(grouped.candidates(OSplit(comb)), one_by_one.candidates(OSplit(comb)), tol)
    s = np.linalg.svd(_mat(data.astype(np.float32 if dtype == torch.float32 else np.float64)
                           .astype(np.float64), [0, 2]), compute_uv=False)
    ref = spectra.bin_spectrum(s, grouped.delta, config.synthesizer.bin_size)
    _same_candidates(grouped.candidates(OSplit([target.indices[0], target.indices[2]])), ref, 1e-10)


# -- the exact rank solver (test_rank_solver.py) ----------------------------------


def _brute_force(edges, cands, errs, terms, delta, upper):
    best = None
    for combo in itertools.product(*[range(len(cands[e])) for e in edges]):
        if sum(errs[e][i] for e, i in zip(edges, combo)) > delta**2:
            continue
        assign = {e: cands[e][i] for e, i in zip(edges, combo)}
        cost = sum(f * np.prod([assign[e] for e in att]) for f, att in terms)
        if cost <= upper and (best is None or cost < best):
            best = cost
    return best


def test_rank_solver_matches_brute_force():
    rng = np.random.default_rng(3)
    for _ in range(60):
        edges = [f"e{i}" for i in range(int(rng.integers(1, 5)))]
        cands, errs = {}, {}
        for e in edges:
            sizes = sorted({int(s) for s in rng.integers(1, 30, size=int(rng.integers(2, 6)))},
                           reverse=True)
            cands[e], errs[e] = sizes, sorted(rng.uniform(0, 1, size=len(sizes)))
        terms = [(float(rng.integers(1, 10)), [e for e in edges if rng.random() < 0.7] or [edges[0]])
                 for _ in range(int(rng.integers(1, 4)))]
        delta = float(np.sqrt(rng.uniform(0.1, 2.0)))
        upper = float(rng.integers(50, 20000))
        solver = RankAssignmentSolver()
        for e in edges:
            solver.add_edge(e, cands[e], errs[e])
        for fixed, attached in terms:
            solver.add_node_term(fixed, attached)
        assign, cost = solver.solve(delta, upper)
        expected = _brute_force(edges, cands, errs, terms, delta, upper)
        if expected is None:
            assert assign is None and cost == BAD_SCORE
            continue
        assert np.isclose(cost, expected)
        assert np.isclose(sum(f * np.prod([assign[e] for e in att]) for f, att in terms), cost)
        assert sum(errs[e][cands[e].index(assign[e])] for e in edges) <= delta**2 + 1e-12


# -- pruning heuristics (test_search_heuristics.py) ------------------------------


def test_bfs_prune_duplicates_reduces_work(monkeypatch):
    monkeypatch.delenv("TNT_SEARCH_DEVICE", raising=False)
    every = _run("bfs", _net())
    pruned = _run("bfs", _net(), heuristics__prune_duplicates=True,
                  heuristics__prune_by_ranks=False)
    assert pruned["count"] <= every["count"]
    assert pruned["best_network"].cost() <= _net().cost()


def test_dfs_prune_full_rank(monkeypatch):
    monkeypatch.delenv("TNT_SEARCH_DEVICE", raising=False)
    stats = _run("dfs", _net(), eps=1e-12, heuristics__prune_full_rank=True)
    assert stats["best_network"].cost() <= _net().cost()


def test_bfs_isplit_mode(monkeypatch):
    monkeypatch.delenv("TNT_SEARCH_DEVICE", raising=False)
    stats = _run("bfs", _net(), synthesizer__action_type="isplit", engine__max_ops=2)
    assert stats["count"] > 0
    assert stats["best_network"].cost() <= _net().cost()


# -- timeouts and the watchdog (test_timeouts.py) --------------------------------


def test_bfs_timeout_cuts_search_short():
    start = time.time()
    stats = _run("bfs", _net((4, 5, 6, 3), 12), engine__timeout=0.0)
    assert time.time() - start < 30
    assert stats["count"] <= 60


def test_partition_timeout_still_returns_stats():
    stats = _run("partition_search", _net(seed=12), engine__max_ops=3, engine__timeout=0.0)
    assert stats["best_network"] is not None
    assert "reconstruction_error" in stats


def test_watchdog_kills_hung_enumeration(monkeypatch):
    monkeypatch.setenv("TNT_FAULT_HANG_EXPLORE", "1")
    start = time.time()
    stats = _run("partition_search", _net(seed=12), engine__timeout=2.0)
    assert time.time() - start < 30
    assert stats["count"] == 0
    assert stats["best_network"] is not None
    assert "reconstruction_error" in stats
    assert synthesis.explore_with_watchdog.last_child is None


def test_watchdog_returns_full_results_when_fast():
    net = _net(names="ijk")
    stats = _run("partition_search", net, engine__timeout=120.0)
    assert stats["count"] == 7
    assert stats["best_network"].cost() <= net.cost()
    assert stats["reconstruction_error"] <= 0.5 * 1.01
    assert synthesis.explore_with_watchdog.last_child == {
        "CUDA_VISIBLE_DEVICES": "", "cuda_initialized": False}


def _tensors(obj, seen=None):
    """Every torch tensor reachable from ``obj``."""
    seen = set() if seen is None else seen
    if id(obj) in seen:
        return
    seen.add(id(obj))
    if isinstance(obj, torch.Tensor):
        yield obj
        return
    if isinstance(obj, dict):
        children = list(obj.keys()) + list(obj.values())
    elif isinstance(obj, (list, tuple, set)):
        children = list(obj)
    elif hasattr(obj, "__dict__"):
        children = list(vars(obj).values())
    else:
        return
    for child in children:
        yield from _tensors(child, seen)


def test_watchdog_payload_holds_only_cpu_tensors():
    net = _net()
    target = net.contract()
    config = _config()
    sp = spectra.SplitSpectra(config).build(target)
    payload = pickle.loads(synthesis.watchdog_payload(net, 0.5, sp, config, True))
    found = list(_tensors(payload))
    assert len(found) == 1 and all(t.device.type == "cpu" for t in found)
    assert torch.equal(payload[0].value("G"), net.value("G"))
