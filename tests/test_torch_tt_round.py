"""The port's TT constructors and four rounding families against the JAX
package's, in float64.

``tt_rank1``, ``tt_separable``, ``tt_right_orth`` and ``tt_sum``, then
``tt_svd_round``, ``tt_gramsvd_round``, ``tt_sum_gramsvd_round``,
``tt_randomized_round``, ``tt_sum_randomized_round`` and
``tt_rand_precond_svd_round`` at the JAX reference tests' sizes and
tolerances (``tests/test_core.py``: 1e-13, 1e-10 for the preconditioned
family).  The trains are made by the JAX package from a seed and carried
over through the separated-dict format.  Each case holds the port to the
JAX package's kept ranks and index names, its represented tensor to the
JAX result, and both to the dense input.  The randomized families take
one NumPy-made sketch in both packages: each such test replaces both
modules' ``_gaussian_train`` (JAX's PRNG stream is its own).  Last, the
slice as a whole: the seven calls that ``chip_smoke.py`` phase 6 makes at
d=50, on the JAX package's ``a + a`` at d=6.
"""

import copy
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensor_networks_tpu as jtn
from tensor_networks_tpu.ops import randomized as jrand
import tensor_networks_tpu_torch as ttn
from tensor_networks_tpu_torch.ops import randomized as trand

# The suite runs in several worker processes on the CPU: torch's own
# thread pool would spin on the cores the other workers need.
torch.set_num_threads(1)


def _np(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _to_port(jnet):
    return ttn.TensorNetwork.from_separated_dict(
        *jnet.to_separated_dict(), device="cpu"
    )


def _to_jax(tnet):
    """The port's network in the JAX package (no JAX op runs: the JAX
    package's own sums would compile a program per core shape)."""
    return jtn.TensorNetwork.from_separated_dict(*tnet.to_separated_dict())


def _dense(net, order):
    """The represented tensor with its free axes in the order of the index
    names ``order``; a JAX network is contracted by the port on its own
    values (a JAX contraction compiles a program per structure)."""
    if isinstance(net, jtn.TensorNetwork):
        net = _to_port(net)
    val = _np(net.contract().value)
    names = [i.name for i in net.free_indices()]
    return np.transpose(val, [names.index(n) for n in order])


def _close(got, want, rtol):
    assert np.abs(got - want).max() <= rtol * np.abs(want).max()


def _indices(net):
    return [
        (n, [(i.name, i.size) for i in net.node_tensor(n).indices])
        for n in net.network.nodes
    ]


def _trains(seed=4):
    """test_core's fixture: modes (5, 10, 20), ranks [2, 2] and [3, 4]."""
    np.random.seed(seed)
    inds = [jtn.Index("t", 5), jtn.Index("u", 10), jtn.Index("v", 20)]
    return (
        jtn.TensorNetwork.rand_tt(inds, [2, 2]),
        jtn.TensorNetwork.rand_tt(inds, [3, 4]),
        inds,
    )


def _numpy_sketch(modes, ranks, seed):
    rng = np.random.default_rng(1000 + seed)
    d = len(modes)
    shapes = (
        [(modes[0], ranks[0])]
        + [(ranks[k - 1], modes[k], ranks[k]) for k in range(1, d - 1)]
        + [(ranks[-1], modes[-1])]
    )
    return [rng.standard_normal(s) / np.sqrt(np.prod(s)) for s in shapes]


@pytest.fixture
def shared_sketch(monkeypatch):
    """Both packages' randomized rounding draw one NumPy-made sketch."""
    monkeypatch.setattr(
        jrand,
        "_gaussian_train",
        lambda modes, ranks, dtype, seed: [
            jnp.asarray(c, dtype) for c in _numpy_sketch(modes, ranks, seed)
        ],
    )
    monkeypatch.setattr(
        trand,
        "_gaussian_train",
        lambda modes, ranks, dtype, seed, device=None: [
            torch.tensor(c, dtype=dtype, device=device)
            for c in _numpy_sketch(modes, ranks, seed)
        ],
    )


# -- constructors, orthogonalization, sums ------------------------------------


def test_rank1_and_separable_match_jax():
    inds = [jtn.Index(f"x{k}", 3 + k) for k in range(4)]
    tinds = [ttn.Index(i.name, i.size) for i in inds]
    rng = np.random.default_rng(0)
    vals = [rng.standard_normal(i.size) for i in inds]
    for jmake, tmake in (
        (jtn.ops.tt_rank1, ttn.tt_rank1),
        (jtn.ops.tt_separable, ttn.tt_separable),
    ):
        jnet = jmake(inds, vals)
        tnet = tmake(tinds, vals, device="cpu")
        assert _indices(tnet) == _indices(jnet)
        assert tnet.network.edges() == jnet.network.edges()
        for n in jnet.network.nodes:
            assert np.array_equal(_np(tnet.value(n)), _np(jnet.value(n)))
    grid = np.meshgrid(*vals, indexing="ij")
    order = [i.name for i in inds]
    _close(_dense(ttn.tt_separable(tinds, vals, device="cpu"), order), sum(grid), 1e-13)
    f32 = ttn.tt_rank1(tinds, vals, dtype=torch.float32, device="cpu")
    assert all(f32.value(n).dtype == torch.float32 for n in f32.network.nodes)


def test_right_orth_and_sum_match_jax():
    jtt, jtt2, inds = _trains()
    order = [i.name for i in inds]
    tt = _to_port(jtt)
    dense = _dense(jtt, order)
    for node in (2, 1):
        jtn.tt_right_orth(jtt, node)
        ttn.tt_right_orth(tt, node)
        # each core's values up to the sign of each QR row
        for n in (node - 1, node):
            got, want = _np(tt.value(n)), _np(jtt.value(n))
            _close(np.abs(got), np.abs(want), 1e-13)
        core = _np(tt.value(node)).reshape(2, -1)
        assert np.abs(core @ core.T - np.eye(2)).max() <= 1e-14
        _close(_dense(tt, order), dense, 1e-13)
    np.random.seed(5)
    parts = [jtt, jtt2] + [
        jtn.TensorNetwork.rand_tt(inds, r) for r in ([8, 12], [3, 4])
    ]
    jsum = jtn.tt_sum(parts)
    tsum = ttn.tt_sum([_to_port(p) for p in parts])
    assert _indices(tsum) == _indices(jsum)
    assert tsum.ranks() == [2 + 3 + 8 + 3, 2 + 4 + 12 + 4]
    for n in jsum.network.nodes:
        assert np.array_equal(_np(tsum.value(n)), _np(jsum.value(n)))


# -- the four rounding families -----------------------------------------------

# family: (call on a package's top level, single train or list of three
# copies, JAX reference test tolerance, ranks the family must keep)
FAMILIES = {
    "svd": (lambda m, x: m.tt_svd_round(x, 1e-5), False, 1e-13, [2, 2]),
    "gramsvd": (lambda m, x: m.tt_gramsvd_round(x, 1e-5), False, 1e-13, [2, 2]),
    "sum_gramsvd": (
        lambda m, xs: m.tt_sum_gramsvd_round(xs, 1e-5), True, 1e-13, [2, 2]),
    "randomized": (
        lambda m, x: m.tt_randomized_round(x, [2, 2]), False, 1e-13, [2, 2]),
    "sum_randomized": (
        lambda m, xs: m.tt_sum_randomized_round(xs, [2, 2]), True, 1e-13, [2, 2]),
    "rand_precond_svd": (
        lambda m, x: m.tt_rand_precond_svd_round(x, 1e-10, [4, 4]),
        False, 1e-10, [2, 2]),
}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_family_matches_jax(family, shared_sketch):
    call, is_sum, tol, want_ranks = FAMILIES[family]
    jtt, _, inds = _trains()
    order = [i.name for i in inds]
    if is_sum:
        jin = [copy.deepcopy(jtt) for _ in range(3)]
        tin = [_to_port(jtt) for _ in range(3)]
        dense = 3 * _dense(jtt, order)
    else:
        tin = _to_port(jtt) + _to_port(jtt)
        jin = _to_jax(tin)
        dense = _dense(tin, order)
    jout = call(jtn, jin)
    tout = call(ttn, tin)
    assert tout.ranks() == jout.ranks() == want_ranks
    assert _indices(tout) == _indices(jout)
    got = _dense(tout, order)
    _close(got, _dense(jout, order), tol)
    _close(got, dense, tol)


def test_svd_round_warns_below_its_floor_as_jax_does():
    jtt, _, _ = _trains()
    msgs = []
    tt = _to_port(jtt)
    for m, x in ((jtn, _to_jax(tt + tt)), (ttn, tt + tt)):
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            m.tt_svd_round(x, 1e-16)
        msgs.append([str(w.message) for w in rec if w.category is RuntimeWarning])
    assert msgs[0] == msgs[1] and len(msgs[1]) == 1
    assert "float64 rounding sweep" in msgs[1][0]


def test_rand_round_facade(shared_sketch):
    jtt, _, inds = _trains()
    order = [i.name for i in inds]
    tt = _to_port(jtt)
    single = ttn.TTRandRound(tt + tt, [2, 2])
    both = ttn.TTRandRound([tt, tt], [2, 2], seed=3)
    assert (single.d, single.ns, both.d, both.ns) == (3, 1, 3, 2)
    _close(_dense(single.round(), order), 2 * _dense(tt, order), 1e-13)
    _close(_dense(both.round(), order), 2 * _dense(tt, order), 1e-13)
    with pytest.raises(ValueError):
        single.rto_rounding_ttsum()
    with pytest.raises(ValueError):
        both.rand_then_orth()
    with pytest.raises(ValueError):
        ttn.TTRandRound("not a train", [2, 2])


def test_randomized_sketch_is_seeded_and_normalised():
    a = trand._gaussian_train([3, 4, 5], [2, 2], torch.float64, 7, "cpu")
    b = trand._gaussian_train([3, 4, 5], [2, 2], torch.float64, 7, "cpu")
    assert [tuple(c.shape) for c in a] == [(3, 2), (2, 4, 2), (2, 5)]
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    big = trand._gaussian_train([400, 400], [50], torch.float64, 1, "cpu")[0]
    # unit-variance entries over sqrt(size): the core's norm is ~1
    assert abs(torch.linalg.norm(big).item() - 1.0) < 0.01


# -- the slice as a whole ---------------------------------------------------------


def test_phase6_calls_match_jax_on_a_doubled_train(shared_sketch):
    """chip_smoke.py phase 6's seven calls on the JAX package's a + a
    (d=6, n=4, r=5; the first and last bonds are structurally 4), at
    eps 1e-10.  The graph route's orthonormalize hands the last core up
    whole (one free leg no larger than its bond), in both packages, so
    its train has one core and one bond fewer.  The Gram families run at
    1e-6: below their f64 floor (~6e-8) the end bonds keep ghost
    directions whose count follows each eigensolver's roundoff, so the
    two packages need not agree there (phase 6 also runs them above
    their floor for the structural ranks)."""
    np.random.seed(8)
    inds = [jtn.Index(f"x{k}", 4) for k in range(6)]
    a = jtn.TensorNetwork.rand_tt(inds, [5] * 5)
    x = _to_jax(_to_port(a) + _to_port(a))
    order = [i.name for i in inds]
    dense = _dense(a, order)
    eps, eps_gram = 1e-10, 1e-6
    keep = [4, 5, 5, 5, 4]
    bound = [4, 6, 6, 6, 4]
    delta = eps * _to_port(x).norm()

    def graph_round(m, net):
        net.round(0, delta)
        return net

    calls = {
        "tt_svd_round": (lambda m, net: m.tt_svd_round(net, eps), x, 2),
        "TensorNetwork.round": (graph_round, x, 2),
        "tt_gramsvd_round": (
            lambda m, net: m.tt_gramsvd_round(net, eps_gram), x, 2),
        "tt_sum_gramsvd_round": (
            lambda m, nets: m.tt_sum_gramsvd_round(nets, eps_gram), [a] * 3, 3),
        "tt_randomized_round": (
            lambda m, net: m.tt_randomized_round(net, keep), x, 2),
        "tt_sum_randomized_round": (
            lambda m, nets: m.tt_sum_randomized_round(nets, keep), [a] * 3, 3),
        "tt_rand_precond_svd_round": (
            lambda m, net: m.tt_rand_precond_svd_round(net, eps, bound), x, 2),
    }
    for name, (call, arg, times) in calls.items():
        if isinstance(arg, list):
            jin = [copy.deepcopy(t) for t in arg]
            tin = [_to_port(t) for t in arg]
        else:
            jin, tin = copy.deepcopy(arg), _to_port(arg)
        jout, tout = call(jtn, jin), call(ttn, tin)
        want = keep[:-1] if name == "TensorNetwork.round" else keep
        assert tout.ranks() == jout.ranks() == want, name
        assert _indices(tout) == _indices(jout), name
        got = _dense(tout, order)
        _close(got, _dense(jout, order), 1e-12)
        _close(got, times * dense, eps_gram if "gram" in name else 1e-12)


def test_graph_round_of_a_summed_ht_matches_jax():
    """TensorNetwork.round from the root of ht + ht (4 modes of 3, rank 2):
    both packages fold every leaf into its parent (a leaf's one free leg,
    3, is no larger than its bond, 4) and keep the same ranks; the rounded
    tree's structure hash is the sum's with each leaf merged symbolically."""
    np.random.seed(9)
    ht = _to_port(
        jtn.TensorNetwork.rand_ht([jtn.Index(f"x{k}", 3) for k in range(4)], 2)
    )
    tsum = ht + ht
    jsum = _to_jax(tsum)
    order = [i.name for i in tsum.free_indices()]
    folded = _to_port(jsum)
    for leaf in [n for n in folded.network.nodes if len(folded.network.neighbors(n)) == 1]:
        folded.merge(folded.network.neighbors(leaf)[0], leaf, compute_data=False)
    delta = 1e-10 * tsum.norm()
    assert tsum.round("G0", delta) == jsum.round("G0", delta)
    assert _indices(tsum) == _indices(jsum)
    assert tsum.ranks() == jsum.ranks()
    assert len(tsum.network.nodes) == 3
    assert tsum.canonical_structure() == jsum.canonical_structure()
    assert tsum.canonical_structure() == folded.canonical_structure()
    _close(_dense(tsum, order), _dense(jsum, order), 1e-13)
    _close(_dense(tsum, order), 2 * _dense(ht, order), 1e-12)


def test_randomized_round_of_a_long_f32_train_keeps_its_interfaces_in_range():
    """d=70, n=4, target rank 4, f32 (the port alone): unscaled, the
    interfaces shrink by ~1/sqrt(n t) = 1/4 a core and underflow float32
    (4^-68 ~ 1e-41); scaled by powers of two they keep the doubled train
    to float32 roundoff."""
    d, n, r = 70, 4, 4
    g = torch.Generator().manual_seed(3)
    inds = [ttn.Index(f"x{k}", n) for k in range(d)]
    a = ttn.TensorNetwork.rand_tt(inds, [r] * (d - 1), dtype=torch.float32,
                                  device="cpu", generator=g)
    for k in range(1, d - 1):
        t = a.node_tensor(k)
        t.update_val_size(t.value / np.sqrt(n * r))
    pts = np.random.default_rng(0).integers(0, n, (64, d))
    a64 = copy.deepcopy(a)
    for k in range(d):
        a64.node_tensor(k).update_val_size(a64.value(k).double())
    ref = 2 * a64.evaluate(inds, pts)
    for y in (ttn.tt_randomized_round(a + a, [r] * (d - 1)),
              ttn.tt_sum_randomized_round([a, a], [r] * (d - 1))):
        got = y.evaluate(inds, pts)
        assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()


def test_gram_factorizations_of_f32_grams_run_in_f64():
    """Narrower Grams are factorized in float64 and the results cast back."""
    from tensor_networks_tpu_torch.kernels import linalg

    g = torch.Generator().manual_seed(2)
    hl = torch.randn(20, 6, generator=g, dtype=torch.float64)
    hr = torch.randn(20, 6, generator=g, dtype=torch.float64)
    gl, gr = (hl.T @ hl).float(), (hr.T @ hr).float()
    got = linalg._gram_weighted_cross(gl, gr)
    want = linalg._gram_weighted_cross(gl.double(), gr.double())
    assert all(x.dtype == torch.float32 for x in got)
    assert all(torch.equal(x, y.float()) for x, y in zip(got, want))
