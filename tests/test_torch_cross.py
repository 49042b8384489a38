"""Parity of the port's cross approximation with the JAX package, on the
CPU in float64.

With a host target the fibers and every pivot decision are NumPy in both
packages, so one ``np.random.seed`` before each engine is built (its
private pivot generator takes one global draw) gives the same pivot
sets and the same cores; ``eps=0`` with ``max_iters=3`` lets the budget
stop both after four sweeps.  A network-valued target is held to the
final error instead (both under 1e-10), and the port's HT and Tucker
crosses to the reference suite's 1e-4 bar (``tests/test_cross.py``).
The port's constructors default to the card, so every network here
names ``device="cpu"``.
"""

import importlib
from typing import List

import numpy as np
import pytest
import torch

import tensor_networks_tpu as jtn
from tensor_networks_tpu import cross as jcross
import tensor_networks_tpu_torch as ttn
from tensor_networks_tpu_torch import cross as tcross

# The suite runs in several worker processes on the CPU: torch's own
# thread pool would spin on the cores the other workers need.
torch.set_num_threads(1)

# the packages export a function of the module's name: take the modules
jmaxvol = importlib.import_module("tensor_networks_tpu.cross.maxvol")
tmaxvol = importlib.import_module("tensor_networks_tpu_torch.cross.maxvol")

SIZES_4D = [("i", 8), ("j", 10), ("k", 12), ("l", 20)]  # test_cross.INDICES_4D


def _function_classes(base):
    """Ackley (``tests/test_cross.py``) and sin(sum x)
    (``tests/test_cross_accuracy.py``) on either package's CachedFunc."""

    class Ackley(base):
        def __init__(self, indices: List):
            super().__init__([
                ind.with_new_rng(np.linspace(-32.768, 32.768, ind.size))
                for ind in indices
            ])

        def _run(self, args):
            y1 = -20 * np.exp(-0.2 * np.sqrt(np.sum(args**2, axis=1) / args.shape[1]))
            y2 = -np.exp(np.sum(np.cos(2 * np.pi * args), axis=1) / args.shape[1])
            return y1 + y2 + 20 + np.exp(1.0)

    class RankTwo(base):
        def __init__(self, indices: List):
            super().__init__([
                ind.with_new_rng(np.linspace(0.0, np.pi / 2, ind.size))
                for ind in indices
            ])

        def _run(self, args):
            return np.sin(np.sum(args, axis=1))

    return {"ackley": (Ackley, SIZES_4D),
            "rank_two": (RankTwo, [(c, 12) for c in "ijkl"])}


def _run_cross(pkg, cross_mod, which, algo, convergence):
    cls, sizes = _function_classes(cross_mod.CachedFunc)[which]
    func = cls([pkg.Index(name, size) for name, size in sizes])
    kw = {} if pkg is jtn else {"device": "cpu"}
    net = pkg.TensorNetwork.rand_tt(func.indices, [1] * (len(sizes) - 1), **kw)
    np.random.seed(5)
    config = cross_mod.CrossConfig(
        kickrank=2, max_iters=3, validation_size=200,
        cross_algo=getattr(cross_mod.CrossAlgo, algo),
        convergence=getattr(cross_mod.ConvergenceCheck, convergence),
    )
    return cross_mod.CrossApproximation(func, config).cross(net, eps=0.0), func


@pytest.mark.parametrize("which,algo,convergence", [
    ("ackley", "MAXVOL", "VALID_ERROR"),
    ("ackley", "DEIM", "VALID_ERROR"),
    ("rank_two", "MAXVOL", "VALID_ERROR"),
    ("rank_two", "DEIM", "VALID_ERROR"),
])
def test_tt_cross_picks_the_pivots_of_jax(which, algo, convergence):
    """Identical pivot sets at every tree node, cores within 1e-12, the
    same unique-evaluation count and the same error trajectory."""
    jres, jfunc = _run_cross(jtn, jcross, which, algo, convergence)
    tres, tfunc = _run_cross(ttn, tcross, which, algo, convergence)
    jnodes, tnodes = jres.dim_tree.preorder(), tres.dim_tree.preorder()
    assert [n.node for n in jnodes] == [n.node for n in tnodes]
    for a, b in zip(jnodes, tnodes):
        assert np.array_equal(a.up_info.vals, b.up_info.vals)
        assert np.array_equal(a.down_info.vals, b.down_info.vals)
    for node in jres.net.network.nodes:
        ref = np.asarray(jres.net.value(node))
        got = tres.net.value(node)
        assert got.dtype == torch.float64 and got.device.type == "cpu"
        assert np.abs(got.numpy() - ref).max() <= 1e-12 * np.abs(ref).max()
    assert tfunc.num_calls() == jfunc.num_calls()
    assert tfunc.calls.shape == jfunc.calls.shape
    assert [r for r, _ in jres.ranks_and_errors] == [r for r, _ in tres.ranks_and_errors]
    # past the first sweep (which compares with the random start network)
    # the errors are functions of the shared cores, down to roundoff
    for (_, e1), (_, e2) in list(zip(jres.ranks_and_errors, tres.ranks_and_errors))[1:]:
        assert abs(e1 - e2) <= 1e-8 * e1 + 1e-14


def test_explicit_rng_reproduces_the_global_seed_run():
    """``CrossApproximation(rng=...)``: a generator seeded with the draw
    the engine would take from ``np.random.seed(5)`` gives that run's
    pivots and cores, takes no global draw, and two runs with equal
    generators agree."""
    cls, sizes = _function_classes(tcross.CachedFunc)["rank_two"]

    def run(rng=None):
        func = cls([ttn.Index(name, size) for name, size in sizes])
        net = ttn.TensorNetwork.rand_tt(func.indices, [1] * 3, device="cpu")
        if rng is None:
            np.random.seed(5)
        config = tcross.CrossConfig(kickrank=2, max_iters=3, validation_size=200)
        state = np.random.get_state()[1].copy()
        res = tcross.CrossApproximation(func, config, rng=rng).cross(net, eps=0.0)
        assert rng is None or np.array_equal(np.random.get_state()[1], state)
        return res

    np.random.seed(5)
    seed = np.random.randint(2**31)
    np.random.seed(123)
    runs = [run(), run(np.random.default_rng(seed)), run(np.random.default_rng(seed))]
    for res in runs[1:]:
        for a, b in zip(runs[0].dim_tree.preorder(), res.dim_tree.preorder()):
            assert np.array_equal(a.up_info.vals, b.up_info.vals)
            assert np.array_equal(a.down_info.vals, b.down_info.vals)
        for node in runs[0].net.network.nodes:
            assert torch.equal(res.net.value(node), runs[0].net.value(node))


def test_norm_check_promotes_and_matches_the_graph_norm():
    """The NORM metric of a chain (packed QR-sweep norm of the
    difference) on an f64 iterate against an f32 one, as the first sweep
    compares them: both packs promoted to f64, and the value equal to
    |net - previous| / |net| through the graph path within 1e-10; None
    for a network that is not a chain."""
    from tensor_networks_tpu_torch.cross.cross import _norm_diff_packed

    g = torch.Generator().manual_seed(2)
    inds = [ttn.Index(f"x{k}", 5) for k in range(5)]
    net = ttn.TensorNetwork.rand_tt(inds, [3, 4, 4, 3], device="cpu", generator=g)
    prev = ttn.TensorNetwork.rand_tt(inds, [2, 2, 2, 2], dtype=torch.float32,
                                     device="cpu", generator=g)
    got = _norm_diff_packed(net, prev)
    prev64 = ttn.TensorNetwork.from_dict(prev.to_dict(), device="cpu",
                                         dtype=torch.float64)
    ref = (net - prev64).norm() / net.norm()
    assert abs(got - ref) <= 1e-10 * ref
    tucker = ttn.TensorNetwork.rand_tucker(inds, 2, device="cpu", generator=g)
    assert _norm_diff_packed(tucker, tucker) is None


def test_network_target_reaches_1e10_in_both():
    """A float64 TT target through FuncTensorNetwork: the port samples
    with ``precision="dw"`` (float64), the JAX package with its default
    (float64 with x64 on, as the tests run it); both end under 1e-10 on
    the full grid."""
    d, n, r = 5, 6, 3
    np.random.seed(0)
    jinds = [jtn.Index(f"t{k}", n) for k in range(d)]
    jtarget = jtn.TensorNetwork.rand_tt(jinds, [r] * (d - 1))
    ttarget = ttn.TensorNetwork.from_separated_dict(
        *jtarget.to_separated_dict(), device="cpu")
    tinds = [ttn.Index(f"t{k}", n) for k in range(d)]
    grid = np.stack(np.meshgrid(*[range(n)] * d), -1).reshape(-1, d)
    errs = {}
    for name, pkg, cmod, target, inds, prec in (
            ("jax", jtn, jcross, jtarget, jinds, None),
            ("port", ttn, tcross, ttarget, tinds, "dw")):
        func = cmod.FuncTensorNetwork(inds, target, precision=prec)
        kw = {} if pkg is jtn else {"device": "cpu"}
        net = pkg.TensorNetwork.rand_tt(inds, [1] * (d - 1), **kw)
        np.random.seed(1)
        config = cmod.CrossConfig(kickrank=2, validation_size=200,
                                  convergence=cmod.ConvergenceCheck.VALID_ERROR)
        res = cmod.CrossApproximation(func, config).cross(net, eps=1e-12)
        got, ref = res.net.evaluate(inds, grid), target.evaluate(inds, grid)
        errs[name] = np.linalg.norm(got - ref) / np.linalg.norm(ref)
        assert func.cost() == target.cost() == n * r * 2 + (d - 2) * r * n * r
    assert errs["jax"] <= 1e-10 and errs["port"] <= 1e-10, errs


@pytest.mark.parametrize("shape", [(200, 8), (96, 24)])
def test_maxvol_matches_jax(shape):
    """Host maxvol: the same rows and coefficients as the JAX package's.
    maxvol_device on the CPU: the JAX device maxvol's rows (both start
    from LAPACK's partial-pivoting LU), dominant and interpolating."""
    rng = np.random.default_rng(sum(shape))
    a = np.linalg.qr(rng.standard_normal(shape))[0]
    rows_j, b_j = jmaxvol.maxvol(a)
    rows_t, b_t = tmaxvol.maxvol(a)
    assert np.array_equal(rows_t, rows_j)
    assert np.abs(b_t - b_j).max() <= 1e-12
    rows_jd, _ = jmaxvol.maxvol_device(a)
    rows_td, b_td = tmaxvol.maxvol_device(torch.from_numpy(a))
    assert rows_td.device.type == "cpu" and b_td.dtype == torch.float64
    rows_td, b_td = rows_td.numpy(), b_td.numpy()
    assert np.array_equal(rows_td, np.asarray(rows_jd))
    assert np.abs(b_td).max() <= 1.05 + 1e-8
    assert np.abs(b_td @ a[rows_td] - a).max() <= 1e-10
    # the device loop stops at the first max|B| <= tol, as the host's
    # does: the rows agree with the host loop's wherever the start does
    assert abs(abs(np.linalg.det(a[rows_td])) - abs(np.linalg.det(a[rows_t]))) \
        <= 0.01 * abs(np.linalg.det(a[rows_t]))


def test_maxvol_auto_routes_by_size_and_device(monkeypatch):
    """Below the gate, or with no device, the host loop; from the gate
    up, the device loop on the named device (here the CPU)."""
    a = np.linalg.qr(np.random.default_rng(3).standard_normal((96, 8)))[0]
    calls = []
    real = tmaxvol.maxvol_device
    monkeypatch.setattr(tmaxvol, "maxvol_device",
                        lambda *args: calls.append(1) or real(*args))
    host = tmaxvol.maxvol_auto(a, device="cpu")
    assert not calls and np.array_equal(host[0], tmaxvol.maxvol(a)[0])
    monkeypatch.setattr(tmaxvol, "_DEVICE_SIZE_THRESHOLD", a.size)
    tmaxvol.maxvol_auto(a)  # no device: the host loop
    assert not calls
    rows, b = tmaxvol.maxvol_auto(a, device="cpu")
    assert calls and isinstance(rows, np.ndarray) and isinstance(b, np.ndarray)
    assert np.abs(b @ a[rows] - a).max() <= 1e-10


@pytest.mark.parametrize("runner", ["HTCrossRunner", "TuckerCrossRunner"])
def test_port_runners_reach_the_reference_bar(runner):
    """The HT and Tucker runners on Ackley over INDICES_4D reach
    test_cross.py's 1e-4 on the full grid (port only; the TT runner
    runs on the card in tests/test_torch_cuda.py)."""
    cls, sizes = _function_classes(tcross.CachedFunc)["ackley"]
    func = cls([ttn.Index(name, size) for name, size in sizes])
    np.random.seed(4)
    net = getattr(tcross, runner)(device="cpu").run(func, eps=1e-4)
    assert all(net.value(n).device.type == "cpu" for n in net.network.nodes)
    grid = np.stack(np.meshgrid(*[range(s) for _, s in sizes]), -1).reshape(-1, 4)
    real, approx = func(grid), net.evaluate(func.indices, grid)
    assert np.linalg.norm(real - approx) / np.linalg.norm(real) <= 1e-4


def test_rand_ht_and_tucker_match_jax_structure():
    """Node names, index names and shapes as in the JAX package; values
    uniform on [0, 1), in the requested dtype, on the named device."""
    inds = [(c, 3 + k) for k, c in enumerate("abcde")]
    g = torch.Generator().manual_seed(0)
    for name, args in (("rand_ht", (2,)), ("rand_tucker", (3,))):
        j = getattr(jtn.TensorNetwork, name)([jtn.Index(*i) for i in inds], *args)
        t = getattr(ttn.TensorNetwork, name)(
            [ttn.Index(*i) for i in inds], *args, dtype=torch.float32,
            device="cpu", generator=g)
        assert list(j.network.nodes) == list(t.network.nodes)
        assert sorted(map(tuple, j.network.edges())) == sorted(map(tuple, t.network.edges()))
        for node in j.network.nodes:
            ji, ti = j.node_tensor(node).indices, t.node_tensor(node).indices
            assert [(i.name, i.size) for i in ji] == [(i.name, i.size) for i in ti]
            v = t.value(node)
            assert v.dtype == torch.float32 and v.device.type == "cpu"
            assert 0 <= v.min() and v.max() < 1
        assert t.cost() == j.cost()
        # values carried across: the port's network is the JAX package's
        moved = ttn.TensorNetwork.from_separated_dict(*j.to_separated_dict(), device="cpu")
        grid = np.stack([np.arange(6) % s for _, s in inds], -1)
        assert np.allclose(moved.evaluate(moved.free_indices(), grid),
                           j.evaluate(j.free_indices(), grid), rtol=1e-12)
    small = ttn.TensorNetwork.rand_tt([ttn.Index("x", 2)] * 3, [1, 1], device="cpu")
    assert small < t and not t < small


def test_runner_builds_on_the_card_by_default():
    """A runner without a device builds its network on the card: on a
    machine without one the first allocation raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default succeeds here")
    cls, sizes = _function_classes(tcross.CachedFunc)["ackley"]
    func = cls([ttn.Index(name, size) for name, size in sizes])
    with pytest.raises((RuntimeError, AssertionError)):
        tcross.TTCrossRunner().run(func, eps=1e-4)
