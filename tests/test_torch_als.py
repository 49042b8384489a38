"""The port's ALS linear solver against the JAX package's, on the CPU in
float64.

The same NumPy inputs go to both packages (packed trains through
``packed.from_numpy``, the QTT systems from each package's own constructor,
which agree exactly).  The JAX side runs its host loop (``fused=False``)
only: its fused loop compiles one whole program per shape.  Systems:

- a d=4, n=6 SPD-dominant operator ``I + sym (x) sym (x) sym (x) sym``
  with a full-rank rank-4 start (``tests/test_als_solver.py``'s
  ``_setup``, its cores drawn from a seed): the port's fused and host
  loops hold the JAX host loop's history to 1e-9 and its represented
  vector to 1e-10, on the dense and the CG local paths;
  the start with zero sweeps is the JAX package's canonicalized start
  (1e-12);
- the K=6 screened-Poisson QTT system from ``pad_rank(rhs, 6)``, whose
  end-bond locals are singular: the dense minimum-norm path, CG on the
  SPD projection and CG on the normal equations each reach a relative
  residual below 1e-10 and the dense solve to 1e-9, and the two CG
  forms land on one fixed point (1e-9);
- a nonsymmetric tridiagonal QTT operator (a general ``A``): residual
  below 1e-10 of |rhs|, the dense solve to 1e-9;
- ``als_solve_adaptive`` on the 3-axis interleaved system of
  ``tests/test_als_solver.py:218``: both growth rules reach 1e-10,
  enrichment in no more sweeps; ``_enrich_span`` returns rank
  ``r + kick`` with the represented vector unchanged (1e-13).

Beyond the first system, each JAX shape family costs seconds of
compiles, so the other systems are held to dense oracles (the JAX
package's own tests hold it to the same ones).

CG budgets are 40-60 steps: the port runs every step (converged locals
frozen on the device), so a budget the locals do not need costs CPU
time here and changes nothing.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensor_networks_tpu.ops import als as jals
from tensor_networks_tpu.ops import packed as jpk
from tensor_networks_tpu_torch.ops import als as tals
from tensor_networks_tpu_torch.ops import packed as tpk
from tensor_networks_tpu_torch.ops import qtt as tqtt

# The suite runs in several worker processes on the CPU: torch's own
# thread pool would spin on the cores the other workers need.
torch.set_num_threads(1)

K = 6


def _np(v):
    return v.detach().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _dense_train(x):
    """The represented vector of a packed train, core 0 slowest."""
    first, mids, last = (_np(t) for t in x)
    v = first
    for m in mids:
        v = np.einsum("ar,rnb->anb", v, m).reshape(-1, m.shape[-1])
    return (v @ last).reshape(-1)


def _dense_op(op):
    first, mids, last = (_np(t) for t in op)
    m = first
    for c in mids:
        m = np.einsum("oir,rpjs->opijs", m, c)
        s = m.shape
        m = m.reshape(s[0] * s[1], s[2] * s[3], s[4])
    m = np.einsum("oir,rpj->opij", m, last)
    s = m.shape
    return m.reshape(s[0] * s[1], s[2] * s[3])


def _both(cores, op=False):
    """(JAX, port) packed forms of the same NumPy cores."""
    j = tuple(jnp.asarray(c) for c in cores)
    t = tpk.from_numpy(*cores, device="cpu")
    if op:
        return jpk.PackedTTOp(*j), tpk.PackedTTOp(*t)
    return jpk.PackedTT(*j), t


@functools.lru_cache(maxsize=None)
def _random_system(seed=3, d=4, n=6, rank=4):
    """``I + sym_1 (x) ... (x) sym_d`` (rank-2 operator), a rank-3 rhs and
    a rank-``rank`` start, all drawn from ``seed``; built once for the
    module (no solve modifies its operands)."""
    rng = np.random.default_rng(seed)
    mats = []
    for _ in range(d):
        g = rng.standard_normal((n, n))
        mats.append(0.3 * (g + g.T) / (2 * np.sqrt(n)))
    eye = np.eye(n)
    first = np.stack([eye, mats[0]], axis=-1)
    mids = np.zeros((d - 2, 2, n, n, 2))
    mids[:, 0, :, :, 0] = eye
    for k in range(d - 2):
        mids[k, 1, :, :, 1] = mats[k + 1]
    last = np.stack([eye, mats[-1]], axis=0)

    def train(r):
        return (rng.standard_normal((n, r)), rng.standard_normal((d - 2, r, n, r)) / r,
                rng.standard_normal((r, n)))

    return _both((first, mids, last), op=True), _both(train(3)), _both(train(rank))


def _rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize("local", ["dense", "cg"])
def test_fused_and_host_loops_match_the_jax_host_loop(local):
    """On a structurally full-rank train the two paths are the JAX host
    loop's arithmetic: histories to 1e-9, vectors to 1e-10."""
    kw = {} if local == "dense" else dict(dense_limit=0, spd=True, cg_iters=40)
    (jop, top), (jrhs, trhs), (jx0, tx0) = _random_system()
    jx, jres, jh = jals.als_solve(jop, jrhs, jx0, sweeps=4, tol=0.0, fused=False, **kw)
    ref = _dense_train(jx)
    for fused in (True, False):
        x, res, h = tals.als_solve(top, trhs, tx0, sweeps=4, tol=0.0, fused=fused, **kw)
        assert len(h) == 4
        np.testing.assert_allclose(h, jh, rtol=1e-9)
        assert res == h[-1]
        assert _rel(_dense_train(x), ref) <= 1e-10


def _qtt_system():
    return (tqtt.qtt_screened_laplacian(K, delta=1.0, device="cpu"),
            tqtt.qtt_exponential(K, c=3.0, device="cpu"))


SINGULAR = {
    "dense": {},
    "cg_spd": dict(dense_limit=0, cg_iters=60, spd=True),
    "cg_normal": dict(dense_limit=0, cg_iters=60, spd=False),
}


@pytest.fixture(scope="module")
def singular_solves():
    """``tests/test_als_solver.py:167``'s system from ``pad_rank(rhs,
    6)``: rank 6 overparameterizes the end bonds, so their local
    systems are singular.  Each local path's solve, the dense solution
    and |rhs|."""
    top, trhs = _qtt_system()
    b = float(tpk.norm_exact(trhs))
    out = {p: tals.als_solve(top, trhs, tpk.pad_rank(trhs, 6), sweeps=6, tol=1e-11 * b, **kw)
           for p, kw in SINGULAR.items()}
    u_ref = np.linalg.solve(_dense_op(top), _dense_train(trhs))
    return out, u_ref, b


@pytest.mark.parametrize("path", list(SINGULAR))
def test_singular_locals_reach_the_minimum_norm_solution(singular_solves, path):
    """The dense path's minimum-norm solve and CG from zero on the
    singular locals: relative residual below 1e-10, the dense solution
    to 1e-9."""
    out, u_ref, b = singular_solves
    x, res, hist = out[path]
    assert res / b < 1e-10 and res == hist[-1]
    assert _rel(_dense_train(x), u_ref) <= 1e-9


def test_spd_and_normal_equation_cg_reach_one_fixed_point(singular_solves):
    out, _, b = singular_solves
    diff = tpk.add(out["cg_spd"][0], tpk.scale(out["cg_normal"][0], -1.0))
    assert float(tpk.norm_exact(diff)) / b < 1e-9


def test_converged_start_stays_converged():
    """Canonicalization absorbs the R factors: one more sweep from a
    converged iterate stays converged."""
    top, trhs = _qtt_system()
    b = float(tpk.norm_exact(trhs))
    x, res, _ = tals.als_solve(top, trhs, tpk.pad_rank(trhs, 6), sweeps=4, tol=1e-13)
    assert res / b < 1e-12
    _, again, _ = tals.als_solve(top, trhs, x, sweeps=1, tol=0.0)
    assert again <= max(2.0 * res, 1e-12 * b)


def test_general_operator():
    """A nonsymmetric, diagonally dominant tridiagonal QTT operator:
    the dense locals (the default) and CG on the normal equations from
    a rank-6 start, each to 1e-10 of |rhs| and to the dense solve."""
    top = tqtt.qtt_tridiagonal(K, 3.0, -1.5, -0.5, device="cpu")
    _, trhs = _qtt_system()
    a = _dense_op(top)
    assert np.abs(a - a.T).max() > 0.5
    u_ref = np.linalg.solve(a, _dense_train(trhs))
    b = float(tpk.norm_exact(trhs))
    for kw in ({}, SINGULAR["cg_normal"]):
        x, res, _ = tals.als_solve(top, trhs, tpk.pad_rank(trhs, 6), sweeps=6,
                                   tol=1e-11 * b, **kw)
        assert res / b < 1e-10
        assert _rel(_dense_train(x), u_ref) <= 1e-9


@functools.lru_cache(maxsize=None)
def _jax_canonicalized_start():
    """The JAX package's zero-sweep solve of ``_random_system()``: the
    reference of both cases below, computed once."""
    (jop, _), (jrhs, _), (jx0, _) = _random_system()
    return jals.als_solve(jop, jrhs, jx0, sweeps=0, fused=False)[0]


@pytest.mark.parametrize("fused", [True, False])
def test_zero_sweeps_return_the_canonicalized_start(fused):
    """Cores 1..d-1 right-orthogonal, the represented vector unchanged,
    the JAX package's cores (full rank: the QR gauge is fixed)."""
    (_, top), (_, trhs), (_, tx0) = _random_system()
    jx = _jax_canonicalized_start()
    x, res, hist = tals.als_solve(top, trhs, tx0, sweeps=0, fused=fused)
    assert res == float("inf") and hist == []
    for got, ref in zip(x, jx):
        np.testing.assert_allclose(_np(got), np.asarray(ref), atol=1e-12)
    assert _rel(_dense_train(x), _dense_train(tx0)) <= 1e-13
    for core in x.mids:
        rows = _np(core).reshape(core.shape[0], -1)
        np.testing.assert_allclose(rows @ rows.T, np.eye(core.shape[0]), atol=1e-13)


def test_fused_record_keeps_the_jax_layout(monkeypatch):
    """The fused loop's record: cap + 1 entries in the train's dtype,
    one per executed sweep, NaN past them, the count in the tail."""
    seen = []
    loop = tals._als_loop_impl

    def spy(*args, **kw):
        out = loop(*args, **kw)
        seen.append(out[-1])
        return out

    monkeypatch.setattr(tals, "_als_loop_impl", spy)
    top, trhs = _qtt_system()
    _, res, hist = tals.als_solve(top, trhs, tpk.pad_rank(trhs, 6), sweeps=5, tol=1e-12)
    rec = seen[0]
    assert rec.dtype == torch.float64 and rec.shape == (9,)  # cap 8
    n = int(rec[-1])
    assert n == len(hist) < 5 and hist[-1] == res < 1e-12
    assert torch.isfinite(rec[:n]).all() and torch.isnan(rec[n:-1]).all()


def test_adaptive_enrichment_and_padding():
    """``tests/test_als_solver.py:218``: both rank-growth rules reach
    1e-10 and the dense solution; enrichment takes no more sweeps than
    padding."""
    op = tqtt.qtt_screened_laplacian_nd(3, 3, delta=1.0, device="cpu")
    rhs = tqtt.qtt_exponential_nd(3, (2.0, 3.0, 1.5), device="cpu")
    b = float(tpk.norm_exact(rhs))
    u_ref = np.linalg.solve(_dense_op(op), _dense_train(rhs))
    runs = {}
    for enrich in (False, True):
        x, res, hist = tals.als_solve_adaptive(op, rhs, eps=1e-10, rank=2, max_rank=16,
                                               sweeps_per_rank=2, enrich=enrich)
        assert res / b < 1e-10
        assert _rel(_dense_train(x), u_ref) <= 1e-9
        runs[enrich] = hist
    assert len(runs[True]) <= len(runs[False])


def test_enrich_span_adds_exactly_the_kick():
    """``svd_round`` pads every bond to the kick, so the enriched train
    has rank r + kick and represents the same vector."""
    top, trhs = _qtt_system()
    x = tpk.pad_rank(trhs, 2)
    resid = tals._residual_train(top, trhs, x)
    y = tals._enrich_span(x, resid, 3)
    assert y.rank == 5 and y.mids.shape == (K - 2, 5, 2, 5)
    assert _rel(_dense_train(y), _dense_train(x)) <= 1e-13
