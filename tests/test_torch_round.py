"""The port's GEMM-based rounding sweeps against the JAX package's.

``tt_round_fixed(method=m)`` for ``m`` in gram, cholqr2, twosided and
prefix: both packages round the same trains (NumPy cores from a seed, at
the JAX reference tests' shapes, f64; the JAX network moves across
through the separated-dict format) on the CPU.  Each case holds the port
to the JAX package's kept ranks, to its represented tensor within 1e-10
relative (both run the same algorithm; summation order and the
Newton-Schulz stopping point differ), and to the dense input within the
reference test's own bound.  Also: the padded entry, the f32 flat
spectrum, the NaN breakdown fallback, ``ROUND_STATS``, the prefix
chain precision switch (against ``highest`` and against the JAX
package's ``dw``), and gram's ghost ranks below its floor on the card
smoke's d=12 train.
"""

import functools
import warnings

import numpy as np
import pytest
import torch

import tensor_networks_tpu as jtn
from tensor_networks_tpu.ops import fast as jfast
from tensor_networks_tpu.ops import tt_sum
import tensor_networks_tpu_torch as ttn
from tensor_networks_tpu_torch.ops import fast as tfast

# The suite runs in several worker processes on the CPU: torch's own
# thread pool would spin on the cores the other workers need.
torch.set_num_threads(1)

METHODS = ("gram", "cholqr2", "twosided", "prefix")


def _to_torch(jt, dtype=None):
    return ttn.TensorNetwork.from_separated_dict(
        *jt.to_separated_dict(), device="cpu", dtype=dtype
    )


def _dense(tn, order):
    """Dense value of ``tn`` (either package) with its free axes in the
    order of the index names ``order``."""
    val = tn.contract().value
    val = val.numpy() if isinstance(val, torch.Tensor) else np.asarray(val)
    names = [i.name for i in tn.free_indices()]
    return np.transpose(val, [names.index(n) for n in order]).astype(np.float64)


def _rel(got, ref):
    return np.linalg.norm(got - ref) / np.linalg.norm(ref)


def _train(d, n, r, seed, prefix="x"):
    np.random.seed(seed)
    inds = [jtn.Index(f"{prefix}{i}", n) for i in range(d)]
    return jtn.TensorNetwork.rand_tt(inds, [r] * (d - 1)), inds


# Every train below is (or pads to) d=7 cores, modes of 5, rank 8, so that
# each package builds each sweep once for the whole file.


def _doubled():
    a, _ = _train(7, 5, 4, 0)
    return a + a, 1e-8, 1e-12


def _contract():
    a, inds = _train(7, 5, 4, 2)
    b = jtn.TensorNetwork.rand_tt(inds, [4] * 6)
    for node in list(b.network.nodes):
        t = b.node_tensor(node)
        t.update_val_size(np.asarray(t.value) * 1e-6)
    return a + b, 1e-3, 1e-3


def _structure():
    a, inds = _train(7, 5, 4, 5)
    return a + jtn.TensorNetwork.rand_tt(inds, [4] * 6), 1e-10, 1e-10


CASES = {"doubled": _doubled, "contract": _contract, "structure": _structure}


@functools.lru_cache(maxsize=None)
def _case(case):
    """``CASES[case]()``, its free index order and dense value, built once
    for the module (the JAX sums and contractions are the costly part);
    every test rounds a deep copy or a port copy of the train."""
    jt, eps, bound = CASES[case]()
    order = [i.name for i in jt.free_indices()]
    return jt, eps, bound, order, _dense(jt, order)


def _round_both(jt, eps, method):
    """Round ``jt`` in both packages; returns (JAX, port) results, each
    (network, ranks, RuntimeWarning messages)."""
    out = []
    for fn, tn in ((jfast.tt_round_fixed, jt),
                   (tfast.tt_round_fixed, _to_torch(jt))):
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            res, ranks = fn(tn.__deepcopy__({}), eps, method=method)
        msgs = [str(w.message) for w in rec if w.category is RuntimeWarning]
        out.append((res, ranks, msgs))
    return out


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("method", METHODS)
def test_method_matches_jax(method, case):
    """Doubled train at 1e-8 (exact rank recovery), the error contract
    (a + 1e-6 b at 1e-3) and a full-rank sum a + b kept whole at 1e-10;
    Below the Gram methods' f64 floor (~6e-8) both
    packages warn."""
    jt, eps, bound, order, dense = _case(case)
    (jr, jranks, jmsgs), (tr, tranks, tmsgs) = _round_both(jt, eps, method)
    assert tranks == jranks
    # the structure case keeps every rank up to its structural bound
    assert tranks == ([5, 8, 8, 8, 8, 5] if case == "structure" else [4] * 6)
    got = _dense(tr, order)
    assert _rel(got, _dense(jr, order)) <= 1e-10
    assert _rel(got, dense) <= bound
    # the same floor warnings, word for word
    assert tmsgs == jmsgs
    assert bool(tmsgs) == (method in ("gram", "prefix") and eps < 6e-8)


def test_ragged_mixed_chain_matches_jax():
    """Ragged ranks and mixed modes go through the padded entry: the
    doubled chain compacts back exactly, as in the JAX package."""
    np.random.seed(31)
    inds = [jtn.Index(f"w{k}", s) for k, s in enumerate([3, 5, 4, 5, 2, 5, 4])]
    a = jtn.TensorNetwork.rand_tt(inds, [2, 4, 3, 4, 2, 3])
    order = [i.name for i in inds]
    dense = 2.0 * _dense(a, order)
    for method in METHODS:
        (jr, jranks, _), (tr, tranks, _) = _round_both(a + a, 1e-10, method)
        assert tranks == jranks == [2, 4, 3, 4, 2, 3], method
        got = _dense(tr, order)
        assert _rel(got, _dense(jr, order)) <= 1e-10, method
        assert np.allclose(got, dense, atol=1e-8), method


def test_padded_structural_clamp_matches_jax():
    """A thin first mode on the padded path: every GEMM method keeps at
    most the structural bound of each bond, with the JAX package's ranks."""
    np.random.seed(37)
    inds = [jtn.Index(f"g{k}", s) for k, s in enumerate([2, 5, 4, 5, 3, 5, 4])]
    a = jtn.TensorNetwork.rand_tt(inds, [2, 5, 4, 5, 3, 4])
    order = [i.name for i in inds]
    dense = _dense(a, order)
    for method in METHODS:
        (jr, jranks, _), (tr, tranks, _) = _round_both(a, 1e-12, method)
        assert tranks == jranks, method
        assert tranks[0] <= 2 and tranks[1] <= 5 and tranks[2] <= 4, method
        got = _dense(tr, order)
        assert _rel(got, _dense(jr, order)) <= 1e-10, method
        assert _rel(got, dense) < 1e-6, method


def test_bond_bounds_of_the_padded_chain():
    assert tfast._bond_bounds([2, 7, 6, 7], [2, 6, 5], 8).tolist() == [2, 6, 5]
    assert tfast._bond_bounds([5] * 4, [9] * 3, 16).tolist() == [5, 9, 5]
    assert tfast._bond_bounds([2] * 6, [32] * 5, 32).tolist() == [2, 4, 8, 4, 2]


def test_cholqr2_f32_flat_spectrum_truncates():
    """Eight unit rank-1 terms plus one at 1e-8, in f32: cholqr2 drops
    the small one at eps=1e-4 (the JAX package's own test), with JAX's
    ranks and, through the inner product, JAX's train."""
    s = _flat_spectrum_f32()
    jr, jranks = jfast.tt_round_fixed(s.__deepcopy__({}), 1e-4, method="cholqr2")
    ts = _to_torch(s, torch.float32)
    tr, tranks = tfast.tt_round_fixed(ts, 1e-4, method="cholqr2")
    assert max(tranks) == 8
    assert tranks == jranks
    assert tr.value(list(tr.network.nodes)[1]).dtype == torch.float32
    assert _sq_dist(jr, tr) <= 1e-9


def _flat_spectrum_f32():
    """Eight unit rank-1 terms plus one at 1e-8 over 30 modes of 8, f32."""
    rng = np.random.default_rng(0)
    ins = [jtn.Index(f"q{i}", 8) for i in range(30)]

    def unit_rank1():
        vecs = [rng.standard_normal(i.size) for i in ins]
        return jtn.tt_rank1(ins, [v / np.linalg.norm(v) for v in vecs])

    tiny = unit_rank1()
    tiny.scale(1e-8)
    s = tt_sum([unit_rank1() for _ in range(8)] + [tiny])
    for node in list(s.network.nodes):
        s.node_tensor(node).update_val_size(
            np.asarray(s.value(node), np.float32)
        )
    return s


def _sq_dist(jr, tr):
    """|x - y|^2 / |x|^2 of the JAX result x and the port's y, in f64
    through the inner product (the dense tensor may be out of reach)."""
    jp = _to_torch(jr, torch.float64)
    tp = ttn.TensorNetwork.from_separated_dict(
        *tr.to_separated_dict(), device="cpu", dtype=torch.float64
    )
    xx = float(ttn.tt_inner_fast(jp, jp))
    yy = float(ttn.tt_inner_fast(tp, tp))
    xy = float(ttn.tt_inner_fast(jp, tp))
    return (xx + yy - 2 * xy) / xx


def test_nan_breakdown_falls_back_to_the_householder_sweep(monkeypatch):
    """A NaN in any core of a GEMM sweep's result (here a middle core,
    which the last core's projection never sees) reroutes the call to
    the svd sweep with the JAX package's warning and counter."""
    jt = _case("doubled")[0]
    order = [i.name for i in jt.free_indices()]
    real = tfast._tt_round_twosided_sweep

    def poisoned(*args, **kw):
        f, m, l, ks, failed = real(*args, **kw)
        m = m.clone()
        m[1] = float("nan")
        return f, m, l, ks, failed

    monkeypatch.setattr(tfast, "_tt_round_twosided_sweep", poisoned)
    before = dict(tfast.ROUND_STATS)
    with pytest.warns(RuntimeWarning, match="broke down"):
        tr, tranks = tfast.tt_round_fixed(_to_torch(jt), 1e-8, method="twosided")
    assert tfast.ROUND_STATS["fallback_nan"] == before["fallback_nan"] + 1
    assert tfast.ROUND_STATS["twosided"] == before["twosided"] + 1
    assert tfast.ROUND_STATS["svd"] == before["svd"]
    sr, sranks = tfast.tt_round_fixed(_to_torch(jt), 1e-8, method="svd")
    assert tranks == sranks == [4] * 6
    assert _rel(_dense(tr, order), _dense(sr, order)) == 0.0


@pytest.mark.parametrize("method", METHODS)
def test_sweep_returns_nan_on_a_breakdown(method):
    """A NaN inside a sweep (what a failed Cholesky leaves) comes out in
    the cores, as from the JAX sweeps, and raises nowhere on the way
    (``eigh`` and ``svd`` would raise on it)."""
    jt = _case("doubled")[0]
    first, mids, last = tfast.stack_tt_cores(_to_torch(jt))
    mids = mids.clone()
    mids[2, 0, 0, 0] = float("nan")
    sweep = {"gram": tfast._tt_round_gram_sweep,
             "cholqr2": tfast._tt_round_cholqr2_sweep,
             "twosided": tfast._tt_round_twosided_sweep,
             "prefix": tfast._tt_round_prefix_sweep}[method]
    bounds = torch.full((6,), 8, dtype=torch.int64)
    f, m, l, ks, _ = sweep(first, mids, last, 1e-8, True, bounds)
    assert not bool(torch.isfinite(f.sum() + m.sum() + l.sum()))
    assert ks.shape == (6,)


def test_round_stats_count_each_method_and_unknown_runs_svd():
    jt = _case("doubled")[0]
    tn = _to_torch(jt)
    for method in METHODS + ("no-such-method",):
        before = dict(tfast.ROUND_STATS)
        _, ranks = tfast.tt_round_fixed(tn.__deepcopy__({}), 1e-8, method=method)
        key = method if method in METHODS else "svd"
        after = dict(before, **{key: before[key] + 1})
        assert tfast.ROUND_STATS == after, method
        assert ranks == [4] * 6


def test_prefix_chain_precision_dw_matches_highest(monkeypatch):
    """f64 carries (``TNT_PREFIX_CHAIN_PREC=dw``, with its trust filters)
    give the same ranks and values within 1e-10 as ``highest``; ``dw``
    has its own, lower floor in the warning."""
    jt, eps = _case("doubled")[:2]
    order = [i.name for i in jt.free_indices()]
    out = {}
    for prec in ("highest", "dw"):
        monkeypatch.setenv("TNT_PREFIX_CHAIN_PREC", prec)
        tr, ranks = tfast.tt_round_fixed(_to_torch(jt), eps, method="prefix")
        out[prec] = (_dense(tr, order), ranks)
    assert out["dw"][1] == out["highest"][1] == [4] * 6
    assert _rel(out["dw"][0], out["highest"][0]) <= 1e-10
    with pytest.warns(RuntimeWarning, match=r"~3\.0e-08 noise floor"):
        tfast.tt_round_fixed(_to_torch(jt), 1e-10, method="prefix")


@pytest.mark.parametrize("train", ["doubled_f64", "flat_spectrum_f32"])
def test_prefix_chain_precision_dw_matches_jax(monkeypatch, train):
    """``TNT_PREFIX_CHAIN_PREC=dw`` in both packages (each reads it at
    call time): the port's f64 carries and trust filters against the JAX
    package's double-word carries, whose power-iteration start vector is
    another (``jax.random``) draw.  Same ranks and warnings; the f64
    doubled train within 1e-10 relative, the f32 flat spectrum (where the
    carries leave the cores' dtype, and the result comes back in f32)
    within f32 roundoff through the inner product."""
    monkeypatch.setenv("TNT_PREFIX_CHAIN_PREC", "dw")
    if train == "doubled_f64":
        jt, eps, bound = _case("doubled")[:3]
    else:
        jt, eps, bound = _flat_spectrum_f32(), 1e-3, None
    (jr, jranks, jmsgs), (tr, tranks, tmsgs) = _round_both(jt, eps, "prefix")
    assert tranks == jranks
    assert tmsgs == jmsgs
    if bound is None:
        assert tranks == [8] * 29
        assert tr.value(1).dtype == torch.float32
        assert _sq_dist(jr, tr) <= 1e-9
    else:
        assert tranks == [4] * 6
        order, dense = _case("doubled")[3:]
        got = _dense(tr, order)
        assert _rel(got, _dense(jr, order)) <= 1e-10
        assert _rel(got, dense) <= bound


def _chip_smoke_d12_train():
    """The d=12 train of ``chip_smoke.py``'s phase 4 (its ``_d12_train``):
    n=32, r=100, f64 cores drawn in order from ``default_rng(1234 + 9)``,
    the middle ones scaled by 1/sqrt(n r), then 8192 points."""
    d, n, r = 12, 32, 100
    rng = np.random.default_rng(1234 + 9)
    inds = [jtn.Index(f"y{k}", n) for k in range(d)]
    a = jtn.TensorNetwork.rand_tt(inds, [r] * (d - 1))
    for k in range(d):
        v = rng.standard_normal(np.shape(a.value(k)))
        if 0 < k < d - 1:
            v /= np.sqrt(n * r)
        a.node_tensor(k).update_val_size(v)
    return a, [ttn.Index(i.name, i.size) for i in inds], rng.integers(0, n, (8192, d))


def test_gram_keeps_ghost_ranks_below_its_floor_as_jax_does():
    """The card's d=12 f64 train, doubled, at eps 1e-9, below gram's f64
    floor (~6e-8): the Gram eigenvalues' roundoff keeps ghost directions
    on every middle bond in both packages (how many is roundoff, and
    differs between them); both warn alike, and both stay within 1e-10
    of each other and 1e-8 of 2a at the first 500 of the card's points."""
    a, inds, pts = _chip_smoke_d12_train()
    pts = pts[:500]
    (jr, jranks, jmsgs), (tr, tranks, tmsgs) = _round_both(a + a, 1e-9, "gram")
    assert tmsgs == jmsgs and len(tmsgs) == 1
    for ranks in (jranks, tranks):
        assert ranks[0] == ranks[-1] == 32
        assert all(100 < k <= 200 for k in ranks[1:-1]), ranks
    ref = 2 * _to_torch(a).evaluate(inds, pts)
    got = tr.evaluate(inds, pts)
    scale = np.abs(ref).max()
    assert np.abs(got - _to_torch(jr).evaluate(inds, pts)).max() <= 1e-10 * scale
    assert np.abs(got - ref).max() <= 1e-8 * scale


def test_triangular_solves_match_numpy():
    """The two solve forms the sweeps use: L X = B (the JAX package's
    ``solve_triangular(l, b, lower=True)``) and X L^T = B (its
    ``triangular_solve(l, b, left_side=False, transpose_a=True)``), and
    the upper E X = B of the prefix insertions."""
    rng = np.random.default_rng(5)
    l = np.tril(rng.standard_normal((3, 4, 4))) + 4 * np.eye(4)
    b = rng.standard_normal((3, 4, 4))
    lt, bt = torch.from_numpy(l), torch.from_numpy(b)
    x1 = torch.linalg.solve_triangular(lt, bt, upper=False).numpy()
    x2 = tfast._solve_right_lt(lt, bt).numpy()
    x3 = torch.linalg.solve_triangular(lt.mT, bt, upper=True).numpy()
    for k in range(3):
        assert np.allclose(x1[k], np.linalg.solve(l[k], b[k]), atol=1e-13)
        assert np.allclose(x2[k] @ l[k].T, b[k], atol=1e-13)
        assert np.allclose(x3[k], np.linalg.solve(l[k].T, b[k]), atol=1e-13)


def test_orth_probe_is_the_jax_packages():
    for r in (3, 8):
        assert np.array_equal(tfast._orth_probe_np(r), jfast._orth_probe_np(r))
