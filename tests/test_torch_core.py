"""Parity of the port's graph core with the JAX package, in float64.

Index, Graph, dimension trees, the contraction planner, Tensor and
TensorNetwork get identical inputs in both packages (networks move
across through the separated-dict format) and must agree to 1e-12
relative: both sides run the same algorithms in f64, so only summation
order differs.  The port's constructors default to the card, so every
constructor call here names ``device="cpu"``.
"""

import copy

import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import opt_einsum as oe
import pytest
import torch

import tensor_networks_tpu as jtn
from tensor_networks_tpu import native as jnative
from tensor_networks_tpu import planner as jplanner
import tensor_networks_tpu_torch as ttn
from tensor_networks_tpu_torch import native as tnative
from tensor_networks_tpu_torch import planner as tplanner
from tensor_networks_tpu_torch.graph import Graph as TGraph
from tensor_networks_tpu.graph import Graph as JGraph

# The suite runs in several worker processes on the CPU: torch's own
# thread pool would spin on the cores the other workers need.
torch.set_num_threads(1)

RTOL = 1e-12


def _close(got, ref, rtol=RTOL):
    got = np.asarray(got.detach().numpy() if isinstance(got, torch.Tensor) else got)
    ref = np.asarray(ref)
    scale = max(np.abs(ref).max(), 1e-300)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= rtol * scale


def _keys(indices):
    """(name, size) pairs: Index equality is per package's class."""
    return [(i.name, i.size) for i in indices]


def _to_port(jnet):
    return ttn.TensorNetwork.from_separated_dict(
        *jnet.to_separated_dict(), device="cpu"
    )


def _jax_tt(seed, d=5, n=4, r=3):
    np.random.seed(seed)
    inds = [jtn.Index(f"x{k}", n) for k in range(d)]
    return jtn.TensorNetwork.rand_tt(inds, [r] * (d - 1)), inds


def _jax_tucker(seed):
    np.random.seed(seed)
    inds = [jtn.Index(f"y{k}", 3 + k) for k in range(4)]
    return jtn.TensorNetwork.rand_tucker(inds, 2), inds


def test_index_matches_jax():
    for name, size in (("a", 3), (7, 5)):
        j, t = jtn.Index(name, size), ttn.Index(name, size)
        assert j.to_dict() == t.to_dict()
        assert hash(j) == hash(t)
        assert t.with_new_size(9) == ttn.Index(name, 9)
        assert ttn.Index.from_dict(j.to_dict()) == t
    assert ttn.Index("a", 3) < ttn.Index("b", 1)
    assert ttn.Index("a", 3, (0.1, 0.2)) == ttn.Index("a", 3)


def test_graph_matches_jax():
    edges = [(0, 1), (1, 2), (1, 3), (3, 4), ("s", 4)]
    graphs = []
    for cls in (JGraph, TGraph):
        g = cls()
        for u, v in edges:
            g.add_edge(u, v)
        graphs.append(g)
    jg, tg = graphs
    assert tg.edges() == jg.edges()
    assert [tg.neighbors(n) for n in tg] == [jg.neighbors(n) for n in jg]
    assert tg.tree_hash() == jg.tree_hash()
    assert tg.connected_components() == jg.connected_components()
    assert tg.reachable_from(1, blocked=[3]) == jg.reachable_from(1, blocked=[3])


@pytest.mark.parametrize("kind", ["tt", "tucker"])
def test_dimension_tree_matches_jax(kind):
    jnet, _ = _jax_tt(1) if kind == "tt" else _jax_tucker(2)
    tnet = _to_port(jnet)
    root = list(jnet.network.nodes)[1]
    jt, tt_ = jnet.dimension_tree(root), tnet.dimension_tree(root)
    jnodes, tnodes = jt.preorder(), tt_.preorder()
    assert [n.node for n in tnodes] == [n.node for n in jnodes]
    for a, b in zip(tnodes, jnodes):
        assert _keys(a.indices) == _keys(b.indices)
        assert _keys(a.free_indices) == _keys(b.free_indices)
        assert a.perm == b.perm
        assert _keys(a.down_info.indices) == _keys(b.down_info.indices)
        assert _keys(a.up_info.indices) == _keys(b.up_info.indices)


def _operands(rng, spec, dims):
    arrays = [rng.standard_normal([dims[c] for c in s]) for s in spec]
    return arrays, [list(s) for s in spec]


@pytest.mark.parametrize(
    "spec,out",
    [
        (["ab", "bc", "cd", "de"], "ae"),  # chain, native DP
        (["ab", "bc", "ca"], ""),  # cycle to a scalar
        (["abc", "cd", "db", "e"], "ea"),  # outer product with one operand
        (["ab"], "ba"),  # single-operand permutation
        (["aab", "bc"], "c"),  # repeated index (trace)
    ],
)
def test_planner_matches_jax(spec, out):
    rng = np.random.default_rng(len(spec))
    dims = dict(zip("abcde", (2, 3, 4, 3, 2)))
    arrays, idx = _operands(rng, spec, dims)
    ref = jplanner.contract_values(idx, [jnp.asarray(a) for a in arrays], list(out))
    got = tplanner.contract_values(
        idx, [torch.from_numpy(a) for a in arrays], list(out)
    )
    _close(got, ref)


def _path_flops(expression, shapes, path):
    """Multiply-add count of a frozen pairwise path (opt_einsum's count,
    the one the subset DP minimizes)."""
    _, info = oe.contract_path(
        expression, *shapes, shapes=True, optimize=[tuple(p) for p in path]
    )
    return info.opt_cost


def test_planner_native_path_and_cache():
    """Up to 18 operands the port takes the native subset DP, which is
    exact; the plan is cached per signature.

    Where the JAX package's native optimizer loaded too, both frozen
    paths are identical.  It may not have: that package compiles its
    library in place, next to the source, so under parallel test workers
    one process can load a half-written file, give up and plan with
    opt_einsum for the rest of its life.  Then the port's path is held
    to the DP's guarantee instead: no more flops than the JAX plan's.
    """
    assert tnative.native_available()
    jnet, _ = _jax_tt(3, d=4)
    tnet = _to_port(jnet)
    pair = tnet.attach(tnet)
    eargs = pair.einsum_args()
    ids = tplanner.intern_ids(eargs.node_indices + [eargs.output_indices])
    shapes = [tuple(pair.value(n).shape) for n in eargs.node_order]
    tplanner.clear_cache()
    plan = tplanner.get_contraction(ids[:-1], ids[-1], shapes, torch.float64)
    jplan = jplanner.get_contraction(ids[:-1], ids[-1], shapes, np.float64)
    assert plan.path is not None and len(plan.path) == len(shapes) - 1
    if jnative.native_available():
        assert plan.path == [tuple(p) for p in jplan.path]
    assert _path_flops(jplan.expression, shapes, plan.path) <= _path_flops(
        jplan.expression, shapes, jplan.path
    )
    assert tplanner.get_contraction(ids[:-1], ids[-1], shapes, torch.float64) is plan
    assert tplanner.cache_size() == 1


def test_planner_greedy_above_native_range():
    """A d=12 train's norm network has 24 operands: the port's greedy
    pass must still find a zipper-like order (tiny intermediates)."""
    jnet, _ = _jax_tt(4, d=12, n=3, r=4)
    tnet = _to_port(jnet)
    _close(tnet.inner(tnet), jnet.inner(jnet))
    pair = tnet.attach(tnet)
    eargs = pair.einsum_args()
    ids = tplanner.intern_ids(eargs.node_indices + [eargs.output_indices])
    shapes = [tuple(pair.value(n).shape) for n in eargs.node_order]
    plan = tplanner.get_contraction(ids[:-1], ids[-1], shapes, torch.float64)
    assert max(len(kept) for *_, kept in plan._steps) <= 3


def test_tensor_ops_match_jax():
    rng = np.random.default_rng(5)
    i, j, k, l = (jtn.Index(c, s) for c, s in zip("ijkl", (3, 4, 5, 2)))
    a, b = rng.standard_normal((3, 4, 5)), rng.standard_normal((5, 2, 4))
    ja, jb = jtn.Tensor(jnp.asarray(a), [i, j, k]), jtn.Tensor(jnp.asarray(b), [k, l, j])
    ta = ttn.Tensor(torch.from_numpy(a), [ttn.Index(x.name, x.size) for x in ja.indices])
    tb = ttn.Tensor(torch.from_numpy(b), [ttn.Index(x.name, x.size) for x in jb.indices])

    jc, tc = ja.contract(jb), ta.contract(tb)
    assert [x.name for x in tc.indices] == [x.name for x in jc.indices]
    _close(tc.value, jc.value)

    c = rng.standard_normal((3, 4, 5))
    jm = ja.mult(jtn.Tensor(jnp.asarray(c), [i, j, k]), [j])
    tm = ta.mult(ttn.Tensor(torch.from_numpy(c), ta.indices), [ttn.Index("j", 4)])
    assert [(x.name, x.size) for x in tm.indices] == [(x.name, x.size) for x in jm.indices]
    _close(tm.value, jm.value)

    jd = ja.block_diagonal(jtn.Tensor(jnp.asarray(c), [i, j, k]), [j])
    td = ta.block_diagonal(ttn.Tensor(torch.from_numpy(c), ta.indices), [ttn.Index("j", 4)])
    assert td.value.shape == jd.value.shape
    _close(td.value, jd.value)

    # factors differ by signs between libraries: compare what they represent
    [u, s, v], budget = ta.svd([0, 2], delta=1e-10)
    [ju, js, jv], jbudget = ja.svd([0, 2], delta=1e-10)
    _close(u.contract(s).contract(v).permute([0, 1, 2]).value,
           ju.contract(js).contract(jv).value)
    assert np.isclose(budget, jbudget, rtol=1e-6)
    q, r = ta.qr([1])
    jq, jr = ja.qr([1])
    _close(q.contract(r).value, jq.contract(jr).value)


@pytest.mark.parametrize("kind", ["tt", "tucker"])
def test_network_ops_match_jax(kind):
    jnet, inds = _jax_tt(6) if kind == "tt" else _jax_tucker(7)
    jother, _ = _jax_tt(8) if kind == "tt" else _jax_tucker(9)
    tnet, tother = _to_port(jnet), _to_port(jother)

    _close(tnet.contract().value, jnet.contract().value)
    _close(tnet.inner(tother), jnet.inner(jother))
    assert np.isclose(tnet.norm(), jnet.norm(), rtol=RTOL)
    _close((tnet + tother).contract().value, (jnet + jother).contract().value)
    _close((tnet - tother).contract().value, (jnet - jother).contract().value)
    _close((tnet * tother).contract().value, (jnet * jother).contract().value)
    joined = tnet.attach(tother)
    assert list(joined.network.nodes) == list(jnet.attach(jother).network.nodes)
    assert sorted(tnet.ranks()) == sorted(jnet.ranks())
    assert _keys(tnet.free_indices()) == _keys(jnet.free_indices())
    assert tnet.shape() == jnet.shape()

    rng = np.random.default_rng(10)
    pts = np.stack([rng.integers(0, i.size, 50) for i in inds], axis=1)
    pts[1, -1] = 99  # above range: both packages clamp (XLA gather)
    ref = jnet.evaluate(inds, pts)
    tinds = [ttn.Index(i.name, i.size) for i in inds]
    got = tnet.evaluate(tinds, pts)
    assert got.dtype == np.float64 and got.shape == (50,)
    _close(got, ref)
    # negative entries clamp to 0 on every port route, as the JAX chain
    # route does (network.py:929-940); JAX's general CPU gather wraps them
    neg = pts.copy()
    neg[0, 0] = -2
    zero = pts.copy()
    zero[0, 0] = 0
    assert np.array_equal(tnet.evaluate(tinds, neg), tnet.evaluate(tinds, zero))

    scaled = copy.deepcopy(tnet).scale(2.5)
    _close(scaled.contract().value, 2.5 * jnet.contract().value)


def test_separated_dict_round_trip_is_exact():
    jnet, _ = _jax_tt(11)
    meta, arrays = jnet.to_separated_dict()
    tnet = ttn.TensorNetwork.from_separated_dict(meta, arrays, device="cpu")
    assert "tensor_indices" in meta["nodes"][0]  # caller's dict untouched
    for n in jnet.network.nodes:
        assert np.array_equal(tnet.value(n).numpy(), np.asarray(jnet.value(n)))
        assert _keys(tnet.node_tensor(n).indices) == _keys(jnet.node_tensor(n).indices)
    assert tnet.network.edges() == jnet.network.edges()

    back = jtn.TensorNetwork.from_separated_dict(*tnet.to_separated_dict())
    for n in jnet.network.nodes:
        assert np.array_equal(np.asarray(back.value(n)), np.asarray(jnet.value(n)))

    f32 = ttn.TensorNetwork.from_separated_dict(
        meta, arrays, device="cpu", dtype=torch.float32
    )
    assert all(f32.value(n).dtype == torch.float32 for n in jnet.network.nodes)


def test_rand_tt_uses_the_generator():
    inds = [ttn.Index(f"x{k}", 3) for k in range(4)]
    nets = [
        ttn.TensorNetwork.rand_tt(
            inds,
            [2, 2, 2],
            device="cpu",
            generator=torch.Generator().manual_seed(5),
        )
        for _ in range(2)
    ]
    assert nets[0].value(1).dtype == torch.float64
    assert all(torch.equal(nets[0].value(k), nets[1].value(k)) for k in range(4))


def test_resolve_device_defaults_to_the_card():
    assert ttn.resolve_device(None) == torch.device("cuda")
    assert ttn.resolve_device() == torch.device("cuda")
    assert ttn.resolve_device("cpu") == torch.device("cpu")
    assert ttn.resolve_device(torch.device("cpu")) == torch.device("cpu")
    assert ttn.resolve_device("cuda:1") == torch.device("cuda", 1)


def _constructors_without_a_device():
    inds = [ttn.Index(f"x{k}", 3) for k in range(4)]
    net = ttn.TensorNetwork.rand_tt(inds, [2, 2, 2], device="cpu")
    meta, arrays = net.to_separated_dict()
    packed = [np.zeros((3, 2)), np.zeros((2, 2, 3, 2)), np.zeros((2, 3))]
    return {
        "rand_tt": lambda: ttn.TensorNetwork.rand_tt(inds, [2, 2, 2]),
        "from_dict": lambda: ttn.TensorNetwork.from_dict(net.to_dict()),
        "from_separated_dict": lambda: ttn.TensorNetwork.from_separated_dict(
            meta, arrays
        ),
        "Tensor.from_dict": lambda: ttn.Tensor.from_dict(
            net.node_tensor(0).to_dict()
        ),
        "packed.from_numpy": lambda: ttn.packed.from_numpy(*packed),
    }


@pytest.mark.parametrize(
    "name",
    ["rand_tt", "from_dict", "from_separated_dict", "Tensor.from_dict",
     "packed.from_numpy"],
)
def test_constructors_without_a_device_need_the_card(name):
    """With no device named a constructor allocates on the card; on a
    machine without one torch's own error comes up (no quiet CPU run)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default succeeds here")
    build = _constructors_without_a_device()[name]
    with pytest.raises((RuntimeError, AssertionError)):
        build()


def test_constructors_honour_a_named_device():
    inds = [ttn.Index(f"x{k}", 3) for k in range(4)]
    net = ttn.TensorNetwork.rand_tt(inds, [2, 2, 2], device="cpu")
    assert all(net.value(k).device.type == "cpu" for k in range(4))
    again = ttn.TensorNetwork.from_dict(net.to_dict(), device="cpu")
    assert all(torch.equal(again.value(k), net.value(k)) for k in range(4))
    one = ttn.Tensor.from_dict(net.node_tensor(1).to_dict(), device="cpu")
    assert one.value.device.type == "cpu"
    pk = ttn.packed.from_numpy(
        np.zeros((3, 2)), np.zeros((2, 2, 3, 2)), np.zeros((2, 3)),
        device="cpu",
    )
    assert all(x.device.type == "cpu" for x in pk)


def test_port_imports_neither_jax_nor_the_jax_package():
    """A fresh interpreter that imports the port, its cross package, the
    time integrators, the multi-device layer and every module of it has
    loaded no ``jax`` and no ``tensor_networks_tpu``."""
    code = (
        "import sys, pkgutil, importlib\n"
        "import tensor_networks_tpu_torch as t\n"
        "import tensor_networks_tpu_torch.cross\n"
        "from tensor_networks_tpu_torch.parallel import (checkpoint, mesh, sharded,\n"
        "                                                sweeps, training)\n"
        "from tensor_networks_tpu_torch import (evolve_tdvp, evolve_tdvp2, evolve_theta,\n"
        "                                       tdvp_trajectory)\n"
        "for m in pkgutil.walk_packages(t.__path__, t.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'tensor_networks_tpu' or m.startswith('tensor_networks_tpu.')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True)
