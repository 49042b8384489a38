"""The port's graph rewrites against the JAX package's, in float64.

``svd`` (with and without ``compute_data``), ``qr``, ``merge``,
``orthonormalize``, ``round`` and ``compress`` run on a TT and on a
``rand_tree`` built from one seeded ``np.random`` state in each package.
After every rewrite both networks must hold the same node names in the
same order, the same index names and sizes on every node, the same
edges, the same ``canonical_structure`` hashes (with and without ranks;
Python's ``hash``, so compared within this process), node values within
1e-13 relative up to the sign of each SVD or QR factor column (a
freedom of the factorization: the LAPACK builds under the two packages
may pick either) and the represented tensor within 1e-13.  Also: slicing (``__getitem__``), ``integrate``,
``vector``, ``.npz`` checkpoints written by each package and loaded by
the other, ``__str__`` and ``draw``.
"""

import os
import sys

import numpy as np
import pytest
import torch

import tensor_networks_tpu as jtn
from tensor_networks_tpu.types import SVDConfig as JSVDConfig
import tensor_networks_tpu_torch as ttn
from tensor_networks_tpu_torch.types import SVDConfig as TSVDConfig

# The suite runs in several worker processes on the CPU: torch's own
# thread pool would spin on the cores the other workers need.
torch.set_num_threads(1)

RTOL = 1e-13


def _np(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _assert_same(jnet, tnet):
    """Names, indices, edges, structure hashes and values (up to factor
    signs) agree."""
    jnodes = list(jnet.network.nodes(data=True))
    tnodes = list(tnet.network.nodes(data=True))
    assert [n for n, _ in tnodes] == [n for n, _ in jnodes]
    assert tnet.network.edges() == jnet.network.edges()
    for (name, jd), (_, td) in zip(jnodes, tnodes):
        jt, tt = jd["tensor"], td["tensor"]
        assert [(i.name, i.size) for i in tt.indices] == [
            (i.name, i.size) for i in jt.indices
        ], name
        jv, tv = _np(jt.value), _np(tt.value)
        assert tv.shape == jv.shape, name
        if jv.size:
            err = np.abs(np.abs(tv) - np.abs(jv)).max()
            assert err <= RTOL * np.abs(jv).max(), name
    for ranks in (False, True):
        assert tnet.canonical_structure(ranks) == jnet.canonical_structure(ranks)


def _dense(net, order):
    """The represented tensor with its free axes in the order of the index
    names ``order``.  A JAX network is contracted by the port (on its own
    values): each JAX contraction of a new structure compiles a program."""
    if isinstance(net, jtn.TensorNetwork):
        net = ttn.TensorNetwork.from_separated_dict(
            *net.to_separated_dict(), device="cpu"
        )
    val = _np(net.contract().value)
    names = [i.name for i in net.free_indices()]
    return np.transpose(val, [names.index(n) for n in order])


def _norm(net):
    return float(np.linalg.norm(_dense(net, [i.name for i in net.free_indices()])))


def _pair(kind):
    """The same network in both packages: a TT (d=4, n=3, r=2) or a
    rand_tree over (4, 5, 3) with bonds (2, 3, 2), each package drawing
    its tree from the same seeded global NumPy stream."""
    sizes = [("x", 4), ("y", 5), ("z", 3)]
    if kind == "tt":
        np.random.seed(7)
        inds = [jtn.Index(f"x{k}", 3) for k in range(4)]
        jnet = jtn.TensorNetwork.rand_tt(inds, [2, 2, 2])
        tnet = ttn.TensorNetwork.from_separated_dict(
            *jnet.to_separated_dict(), device="cpu"
        )
        return jnet, tnet
    np.random.seed(3)
    jnet = jtn.rand_tree([jtn.Index(n, s) for n, s in sizes], [2, 3, 2])
    np.random.seed(3)
    tnet = ttn.rand_tree(
        [ttn.Index(n, s) for n, s in sizes], [2, 3, 2], device="cpu"
    )
    return jnet, tnet


def _largest(net):
    """The node with the most axes (the first such), and its axis count."""
    node = max(net.network.nodes, key=lambda n: len(net.node_tensor(n).indices))
    return node, len(net.node_tensor(node).indices)


def _svd(net, cfg):
    node, _ = _largest(net)
    return net.svd(node, [0], cfg(delta=1e-12))


def _svd_symbolic(net, cfg):
    node, _ = _largest(net)
    return net.svd(node, [0], cfg(compute_data=False))


def _qr(net, cfg):
    node, _ = _largest(net)
    return net.qr(node, [0])


def _merge(net, cfg):
    return net.merge(*net.network.edges()[1])


def _merge_symbolic(net, cfg):
    return net.merge(*net.network.edges()[1], compute_data=False)


def _orthonormalize(net, cfg):
    return net.orthonormalize(list(net.network.nodes)[1])


def _round(net, cfg):
    # a budget that truncates, so the kept ranks are the rank decisions;
    # the same float in both packages (the norm through the port's values)
    return net.round(list(net.network.nodes)[0], 0.05 * _norm(net))


def _compress(net, cfg):
    # an untruncated SVD leaves an S node that is a reshape of its bond
    _svd(net, cfg)
    before = len(net.network.nodes)
    net.compress()
    return before, len(net.network.nodes)


REWRITES = {
    "svd": _svd,
    "svd_symbolic": _svd_symbolic,
    "qr": _qr,
    "merge": _merge,
    "merge_symbolic": _merge_symbolic,
    "orthonormalize": _orthonormalize,
    "round": _round,
    "compress": _compress,
}


@pytest.mark.parametrize("rewrite", sorted(REWRITES))
@pytest.mark.parametrize("kind", ["tt", "tree"])
def test_rewrite_matches_jax(kind, rewrite):
    jnet, tnet = _pair(kind)
    _assert_same(jnet, tnet)
    order = [i.name for i in jnet.free_indices()]
    dense = _dense(jnet, order)
    ranks = tnet.ranks()
    jout = REWRITES[rewrite](jnet, JSVDConfig)
    tout = REWRITES[rewrite](tnet, TSVDConfig)
    assert tout == jout
    _assert_same(jnet, tnet)
    # the next names either package would draw
    assert tnet.fresh_node() == jnet.fresh_node()
    assert tnet.fresh_index() == jnet.fresh_index()
    if rewrite.endswith("symbolic"):
        return
    got = _dense(tnet, order)
    assert np.abs(got - _dense(jnet, order)).max() <= RTOL * np.abs(dense).max()
    if rewrite == "round":
        assert np.linalg.norm(got - dense) <= 0.05 * np.linalg.norm(dense) * (1 + 1e-7)
        # on the tree the budget truncates a bond (3 to 2)
        assert sum(tnet.ranks()) < sum(ranks) or kind == "tt"
    else:
        assert np.abs(got - dense).max() <= 1e-12 * np.abs(dense).max()
    if rewrite == "compress":
        assert tout[1] < tout[0]


def test_getitem_integrate_and_vector_match_jax():
    jnet, tnet = _pair("tt")
    for sel in ((0, 2, 1, 2), (slice(1, 3), 2, slice(None), 0)):
        got, want = tnet[sel], jnet[sel]
        assert [(i.name, i.size) for i in got.indices] == [
            (i.name, i.size) for i in want.indices
        ]
        np.testing.assert_allclose(_np(got.value), _np(want.value), rtol=1e-13)
    free = jnet.free_indices()
    tfree = tnet.free_indices()
    w = np.linspace(0.5, 1.5, 3)
    for jw, tw in (([w, 2.0], [w, 2.0]), ([1.0], [1.0])):
        want = jnet.integrate(free[: len(jw)], jw).contract()
        got = tnet.integrate(tfree[: len(tw)], tw).contract()
        assert [i.name for i in got.indices] == [i.name for i in want.indices]
        np.testing.assert_allclose(_np(got.value), _np(want.value), rtol=1e-13)
    vec = ttn.vector("v", ttn.Index("i", 3), np.arange(3.0), device="cpu")
    assert list(vec.network.nodes) == ["v"]
    assert vec.value("v").dtype == torch.float64
    assert torch.equal(vec.value("v"), torch.arange(3.0, dtype=torch.float64))
    kept = torch.ones(2)
    assert ttn.vector(0, ttn.Index("j", 2), kept).value(0) is kept


def test_npz_loads_in_both_packages(tmp_path):
    # the TT after a split: integer and string node names (a rand_tree's
    # NumPy-integer edge ends are not JSON, in either package)
    jnet, tnet = _pair("tt")
    _svd(jnet, JSVDConfig)
    _svd(tnet, TSVDConfig)
    order = [i.name for i in jnet.free_indices()]
    jnet.save_npz(os.fspath(tmp_path / "from_jax"))
    tnet.save_npz(os.fspath(tmp_path / "from_torch"))
    t_back = ttn.TensorNetwork.load_npz(os.fspath(tmp_path / "from_jax"), device="cpu")
    j_back = jtn.TensorNetwork.load_npz(os.fspath(tmp_path / "from_torch"))
    _assert_same(jnet, t_back)
    _assert_same(j_back, tnet)
    want = _dense(tnet, order)
    assert np.abs(_dense(t_back, order) - want).max() <= 1e-14 * np.abs(want).max()


class _Axes:
    """Records the drawing calls ``draw`` makes on a matplotlib axes."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def record(*args, **kwargs):
            self.calls.append((name, args, sorted(kwargs.items())))

        return record


def test_str_and_draw_match_jax(monkeypatch):
    """``__str__`` word for word; ``draw`` makes the JAX package's drawing
    calls, in order, on a recording axes (no matplotlib needed)."""
    import types

    from tensor_networks_tpu import viz as jviz

    jnet, tnet = _pair("tree")
    assert str(tnet) == str(jnet)
    pyplot = types.ModuleType("matplotlib.pyplot")
    stub = types.ModuleType("matplotlib")
    stub.pyplot = pyplot
    monkeypatch.setitem(sys.modules, "matplotlib", stub)
    monkeypatch.setitem(sys.modules, "matplotlib.pyplot", pyplot)
    jax_ax, port_ax = _Axes(), _Axes()
    jviz.draw_network(jnet, ax=jax_ax)
    tnet.draw(ax=port_ax)
    assert port_ax.calls == jax_ax.calls
    plotted = [c for c in port_ax.calls if c[0] == "plot"]
    assert len(plotted) == len(tnet.network.edges()) + len(tnet.free_indices())


def test_update_val_size_installs_numpy_on_the_values_device():
    t = ttn.Tensor(torch.zeros(2, 3, dtype=torch.float32), [ttn.Index("a", 2), ttn.Index("b", 3)])
    for keep_host in (False, True):
        t.update_val_size(np.ones((4, 3)), keep_host=keep_host)
        assert isinstance(t.value, torch.Tensor) and t.value.device.type == "cpu"
        assert [i.size for i in t.indices] == [4, 3]
    t.relabel_indices({"a": (1, 2)})
    assert t.indices[0] == ttn.Index("a", (1, 2))
