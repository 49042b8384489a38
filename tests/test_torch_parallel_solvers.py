"""The port's train-sharded solvers (``tensor_networks_tpu_torch.parallel``:
``als``, ``eigen``, ``evolve``) against the JAX package's, the port's fused
single-device solvers and dense oracles, on the CPU in float64.

One module fixture starts a 4-rank gloo group (spawned processes that
import torch and the port only, ``tests/_torch_parallel_solver_ranks.py``):
every sharded entry point runs on the (1, 4) mesh, on rank 0 again on a
(1, 1) mesh, and on rank 1 the fused solver at the same knobs.  The
parent kills the ranks after 120 s, so a hang fails this file and does
not stall the run.  While they run, the parent computes three JAX
sharded references on the conftest's CPU mesh at the JAX suite's shapes
(``tests/test_sweeps.py:266-410``: K=10, 8 middle cores, 2 a rank).

Tolerances:

- against the JAX sharded solvers, the JAX suite's own where the two
  packages' single-device solvers agree that closely: ALS solution 1e-9
  (its history only to residual bars, as ``tests/test_torch_als.py``
  holds this padded start: the first sweep follows the QR null-space
  completion of each package's LAPACK); eigensolver history 1e-12 and,
  as ``tests/test_torch_eigen.py`` holds the port's single-device
  vector to the JAX one, the vector to 1e-8 up to sign; TDVP norms and
  state 1e-10;
- P=4 and P=1 against the fused solver: 1e-12 relative in the histories
  and the represented tensors (the staged sweep runs the fused sweep's
  calls on the same operands, so they agree bit for bit here), the
  same ranks for two-site TDVP;
- the adaptive ladders with enrichment round their kick basis by the
  distributed Gram sweep, the fused ladders by ``svd_round``: the same
  ranks, the ALS residuals at the bar and its solutions within 1e-12,
  the eigenvalues within 1e-12 and the vectors 1e-10; P=4 and P=1 to
  1e-12;
- dense oracles at K=10: the operator apply and the direct sum 1e-12,
  the generalized FEM pair's ground value pi^2 to 1e-4, the three
  lowest eigenvalues to 1e-10, Crank-Nicolson against the dense
  implicit recursion 1e-12.
"""

import inspect
import multiprocessing
import os
import pickle
import sys
import time

import numpy as np
import pytest
import torch

import tensor_networks_tpu.parallel as jpar
import tensor_networks_tpu_torch as tnt
import tensor_networks_tpu_torch.parallel as tpar
from tensor_networks_tpu.ops import packed as jpk
from tensor_networks_tpu.ops import qtt as jqtt
from tensor_networks_tpu_torch.ops import als as als_ops
from tensor_networks_tpu_torch.ops import eigen as eig_ops
from tensor_networks_tpu_torch.ops import packed

sys.path.insert(0, os.path.dirname(__file__))
import _torch_parallel_solver_ranks as ranks_side  # noqa: E402

# The suite runs in several worker processes on the CPU: torch's own
# thread pool would spin on the cores the other workers need.
torch.set_num_threads(1)

DEADLINE_S = 120
K = ranks_side.K
F64 = 1e-12


def _dense(t):
    first, mids, last = (np.asarray(x) for x in t)
    v = first
    for core in mids:
        v = np.einsum("ar,rnb->anb", v, core).reshape(-1, core.shape[-1])
    return (v @ last).reshape(-1)


def _dense_op(t):
    first, mids, last = (np.asarray(x) for x in t)
    v = first.reshape(-1, first.shape[-1])  # (o i, s)
    n = first.shape[0]
    size = n
    for core in list(mids) + [last[..., None]]:
        s1, no, ni, s2 = core.shape
        v = np.einsum("xs,soit->xoit", v.reshape(-1, s1), core)
        v = v.reshape(size, size, no, ni, s2).transpose(0, 2, 1, 3, 4)
        size *= no
        v = v.reshape(size * size, s2)
    return v.reshape(size, size)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _merge(a, b):
    """Rank 0's results with the keys only rank 1 holds (the fused runs)."""
    if isinstance(a, dict) and isinstance(b, dict):
        out = dict(b)
        out.update({k: _merge(v, b[k]) if k in b else v for k, v in a.items()})
        return out
    return a


def _jax_refs():
    """The JAX package's sharded solvers on the (1, 4) CPU mesh."""
    m14 = jpar.make_mesh((1, 4), ("data", "model"))
    out = {}
    op = jqtt.qtt_screened_laplacian(K, delta=1.0)
    rhs = jqtt.qtt_exponential(K, c=3.0)
    x, _, hist = jpar.als_solve_sharded(m14, op, rhs, jpk.pad_rank(rhs, 6), sweeps=2, tol=0.0,
                                        spd=True)
    out["als"] = (tuple(np.asarray(t) for t in x), hist)
    op = jqtt.qtt_screened_laplacian(K, delta=0.5)
    x, _, hist = jpar.als_eigsh_sharded(m14, op, jpk.pad_rank(jqtt.qtt_exponential(K, c=2.0), 6),
                                        sweeps=4)
    out["eigsh"] = (tuple(np.asarray(t) for t in x), hist)
    A = jqtt.qtt_tridiagonal(K, 2.0, -1.0, -1.0)
    u, norms = jpar.evolve_tdvp_sharded(m14, A, jpk.pad_rank(jqtt.qtt_exponential(K, c=3.0), 4),
                                        0.03, 3)
    out["tdvp"] = (tuple(np.asarray(t) for t in u), norms)
    return out


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """(the port's results from the 4-rank group, the JAX references)."""
    if torch.distributed.is_initialized():
        pytest.fail("this process must not hold a default process group")
    out_dir = tmp_path_factory.mktemp("gloo_solvers")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=ranks_side.run_rank,
                         args=(rank, str(out_dir / "store"), str(out_dir)))
             for rank in range(ranks_side.WORLD)]
    deadline = time.monotonic() + DEADLINE_S
    for p in procs:
        p.start()
    try:
        refs = _jax_refs()
        while any(p.is_alive() for p in procs) and time.monotonic() < deadline:
            if any(p.exitcode not in (None, 0) for p in procs):
                break  # one rank failed: the others would wait for it
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(10)
    errors = sorted(out_dir.glob("error_*.txt"))
    codes = [p.exitcode for p in procs]
    if errors or codes != [0] * len(procs):
        detail = "\n".join(e.read_text() for e in errors)
        pytest.fail(f"gloo ranks exited {codes} (deadline {DEADLINE_S} s)\n{detail}")
    parts = []
    for rank in (0, 1):
        with open(out_dir / f"results_{rank}.pkl", "rb") as f:
            parts.append(pickle.load(f))
    return _merge(*parts), refs


# ---- against the JAX package's sharded solvers --------------------------------------


def test_als_matches_jax(both):
    """The start is padded (rank 6 holding rank 1): the two packages'
    LAPACK builds complete the QR null spaces differently, so the first
    sweep's residual differs (``tests/test_torch_als.py`` holds this
    system to residual bars and the dense solve for the same reason).
    Held: the same sweeps, both deep-converged, the solution to 1e-9."""
    port, refs = both
    x_ref, hist_ref = refs["als"]
    x, res, hist = port["als"]["dense"]["p4"]
    rhs_norm = np.linalg.norm(_dense(_rhs_cores()))
    assert len(hist) == len(hist_ref) == 2
    assert res == hist[-1] < 1e-11 * rhs_norm and hist_ref[-1] < 1e-11 * rhs_norm
    assert _rel(_dense(x), _dense(x_ref)) < 1e-9


def _rhs_cores():
    return tuple(t.numpy() for t in tnt.qtt_exponential(K, c=3.0, device="cpu"))


def test_eigsh_matches_jax(both):
    """``tests/test_torch_eigen.py``'s tolerances: the eigenvalue to 1e-12
    of |lam|, the Rayleigh history to 1e-8, the vector to 1e-8 up to
    sign.  On this padded start the port's single-device solver itself
    leaves the JAX one's second half-sweep value 1.4e-12 (relative)
    away, above the JAX suite's 1e-12 between its own two forms."""
    port, refs = both
    x_ref, hist_ref = refs["eigsh"]
    x, lam, hist = port["eigsh"]["ground"]["p4"]
    assert abs(lam - hist_ref[-1]) <= 1e-12 * abs(lam)
    np.testing.assert_allclose(hist, hist_ref, rtol=1e-8)
    got, ref = _dense(x), _dense(x_ref)
    assert min(_rel(got, ref), _rel(-got, ref)) < 1e-8


def test_tdvp_matches_jax(both):
    port, refs = both
    u_ref, norms_ref = refs["tdvp"]
    u, norms = port["tdvp"]["dense"]["p4"]
    np.testing.assert_allclose(norms, norms_ref, rtol=1e-10)
    assert _rel(_dense(u), _dense(u_ref)) < 1e-10


# ---- against the port's fused solvers ----------------------------------------------

FUSED_CASES = [
    ("als", "dense"), ("als", "cg"), ("als_adaptive", False),
    ("eigsh", "ground"), ("eigsh", "deflate"), ("eigsh", "mass"), ("eigsh", "lanczos"),
    ("tdvp", "dense"), ("tdvp", "lanczos"), ("tdvp", "tdvp2"), ("tdvp", "tdvp2_grow"),
    ("theta", "euler"),
]


def _split(result):
    """(the train, every record that follows it) of a solver's result."""
    return result[0], [np.asarray(r, np.float64) for r in result[1:]]


@pytest.mark.parametrize("scenario,case", FUSED_CASES)
@pytest.mark.parametrize("parts", ["p4", "p1"])
def test_sharded_matches_fused(both, scenario, case, parts):
    """The represented tensor and every record (residual or eigenvalue,
    history or norms, two-site ranks) of the P=4 and the P=1 run against
    the fused solver's."""
    res = both[0][scenario][case]
    x, recs = _split(res[parts])
    xf, recs_f = _split(res["fused"])
    assert _rel(_dense(x), _dense(xf)) <= F64
    for got, ref in zip(recs, recs_f):
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=F64, atol=0)


def test_eigsh_k_matches_fused_and_the_dense_spectrum(both):
    res = both[0]["eigsh_k"]["k"]
    vals_ref = np.linalg.eigvalsh(_dense_op(tuple(both[0]["eigsh"]["op"])))[:3]
    for parts in ("p4", "p1"):
        vecs, vals = res[parts]
        np.testing.assert_allclose(vals, res["fused"][1], rtol=F64)
        np.testing.assert_allclose(vals, vals_ref, rtol=1e-10)
        assert vals[0] < vals[1] < vals[2]
        for v, vf in zip(vecs, res["fused"][0]):
            assert _rel(_dense(v), _dense(vf)) <= F64


def test_als_adaptive_with_enrichment(both):
    """The distributed Gram kick basis spans what ``svd_round``'s does:
    the same rank ladder and solution; P=4 and P=1 alike."""
    res = both[0]["als_adaptive"][True]
    rhs_norm = np.linalg.norm(_dense(_rhs_cores()))
    (x4, r4, h4), (x1, r1, h1), (xf, rf, hf) = res["p4"], res["p1"], res["fused"]
    assert r4 <= 1e-10 * rhs_norm and rf <= 1e-10 * rhs_norm
    assert x4[0].shape == xf[0].shape and 2 < x4[0].shape[1] <= 16
    assert h4[0] > 1e-10 * rhs_norm and len(h4) == len(hf)
    assert _rel(_dense(x4), _dense(xf)) <= 1e-12
    assert _rel(_dense(x4), _dense(x1)) <= F64 and np.allclose(h4, h1, rtol=F64, atol=0)


@pytest.mark.parametrize("enrich", [True, False])
def test_als_adaptive_against_the_dense_solve(both, enrich):
    op = both[0]["algebra"]["op"]
    sol = np.linalg.solve(_dense_op(op), _dense(_rhs_cores()))
    x, _, _ = both[0]["als_adaptive"][enrich]["p4"]
    assert _rel(_dense(x), sol) < 1e-10


def test_eigsh_adaptive_grows_the_rank(both):
    """The enrichment's kick basis is the distributed Gram sweep's (the
    fused ladder's is ``svd_round``'s): the same rank and eigenvalue
    (1e-12, the JAX suite's bar between its two ladders), the vector to
    1e-10; P=4 and P=1 alike."""
    res = both[0]["eigsh_k"]["adaptive"]
    (x4, l4, h4), (x1, l1, h1), (xf, lf, _) = res["p4"], res["p1"], res["fused"]
    assert x4[0].shape[1] == xf[0].shape[1] > 1
    assert abs(l4 - lf) <= F64 * abs(lf)
    got, ref = _dense(x4), _dense(xf)
    assert min(_rel(got, ref), _rel(-got, ref)) < 1e-10
    assert _rel(got, _dense(x1)) <= F64 and np.allclose(h4, h1, rtol=F64, atol=0)


def test_generalized_fem_pair_reaches_pi_squared(both):
    lam = both[0]["eigsh"]["mass"]["p4"][1]
    np.testing.assert_allclose(lam, np.pi**2, rtol=1e-4)


def test_deflated_pair_lies_above_the_ground_state(both):
    e = both[0]["eigsh"]
    assert e["deflate"]["p4"][1] > e["ground"]["p4"][1]


def test_lanczos_locals_against_the_dense_ground_state(both):
    lam = both[0]["eigsh"]["lanczos"]["p4"][1]
    exact = np.linalg.eigvalsh(_dense_op(tuple(both[0]["eigsh"]["op"])))[0]
    assert abs(lam - exact) <= 1e-6 * exact


def test_warm_restart_from_a_sharded_result(both):
    """One sweep, then one more from the returned blocks: the two-sweep
    solve's tensor."""
    x, _, hist = both[0]["als"]["restart"]
    assert len(hist) == 1
    assert _rel(_dense(x), _dense(both[0]["als"]["dense"]["fused"][0])) < 1e-10


def test_sweep_on_the_stacked_layout_matches_the_fused_sweep(both):
    for got, ref in zip(both[0]["als"]["sweep"], both[0]["als"]["sweep_fused"]):
        assert np.array_equal(got, ref)


def test_tdvp_step_on_the_stacked_layout_matches_the_fused_step(both):
    t = both[0]["tdvp"]
    for got, ref in zip(t["step"][:3], t["step_fused"]):
        assert np.array_equal(got, ref)
    assert t["step"][3] == np.linalg.norm(t["step_fused"][0])
    assert t["bound_p4"] == t["bound"]


def test_crank_nicolson_against_the_dense_recursion(both):
    cn = both[0]["theta"]["cn"]
    u, res, obs = cn["p4"]
    Ad, Md = _dense_op(cn["A"]), _dense_op(cn["M"])
    ud, sd = _dense(cn["u0"]), _dense(cn["src"])
    dt, theta = 1e-5, 0.5
    for _ in range(3):
        ud = np.linalg.solve(Md + theta * dt * Ad,
                             (Md - (1 - theta) * dt * Ad) @ ud + dt * sd)
    assert _rel(_dense(u), ud) < 1e-12
    assert len(obs) == 3 and len(obs[0]) == 1
    got = _dense(u)
    np.testing.assert_allclose(obs[-1][0], got @ Md @ got, rtol=1e-10)


def test_apply_and_direct_sum_against_dense(both):
    a = both[0]["algebra"]
    assert all(np.array_equal(g, r) for g, r in zip(a["apply"], a["apply_ref"]))
    assert all(np.array_equal(g, r) for g, r in zip(a["add"], a["add_ref"]))
    u, v = _dense(a["u"]), _dense(a["v"])
    assert _rel(_dense(a["apply"]), _dense_op(a["op"]) @ u) <= F64
    assert _rel(_dense(a["add"]), u + v) <= F64


@pytest.mark.parametrize("solver", ["als", "eigsh", "tdvp"])
def test_a_rank_holds_under_half_of_one_device_bytes(both, solver):
    """The trains, operator blocks and env chains one sweep or step holds
    on a rank (``tests/test_capacity.py:126-127``'s bar)."""
    four, single = both[0]["capacity"][solver]
    assert 0 < four < single / 2


@pytest.mark.parametrize("call", ["place_als", "place_eigsh", "place_tdvp", "solve_k9",
                                  "eigsh_k9", "tdvp_k9"])
def test_indivisible_trains_are_refused(both, call):
    err = both[0]["errors"][call]
    assert err[0] == "ValueError" and "divisible by the model axis (4)" in err[1]


def test_mixed_deflation_ranks_are_refused(both):
    err = both[0]["errors"]["mixed_deflation"]
    assert err[0] == "ValueError" and "one shared rank" in err[1]


# ---- one process ----------------------------------------------------------------------


def test_exports_and_argument_order_match_jax():
    """Every public name of the JAX package's ``parallel`` and
    ``als_sweep_sharded``; the solvers take the JAX arguments in the JAX
    order (the port's own keywords follow them)."""
    from tensor_networks_tpu.parallel import als as jals

    assert set(jpar.__all__) <= set(tpar.__all__)
    names = [n for n in jpar.__all__
             if getattr(jpar, n).__module__.rsplit(".", 1)[1] in ("als", "eigen", "evolve")]
    assert len(names) == 14
    for name in names + ["als_sweep_sharded"]:
        ref = getattr(jpar, name, None) or getattr(jals, name)
        got = list(inspect.signature(getattr(tpar, name)).parameters)
        want = list(inspect.signature(ref).parameters)
        assert got[:len(want)] == want, name


@pytest.mark.parametrize("name", ["als_solve_sharded", "als_eigsh_sharded",
                                  "evolve_tdvp_sharded", "evolve_tdvp2_sharded",
                                  "evolve_theta_sharded", "als_solve_adaptive_sharded"])
def test_solvers_raise_without_a_process_group(name):
    """A mesh outlives its group: the solvers raise, and none falls back to
    the single-device solver."""
    torch.distributed.init_process_group(
        "gloo", store=torch.distributed.HashStore(), rank=0, world_size=1)
    try:
        mesh = tpar.make_mesh((1, 1), devices="cpu")
    finally:
        torch.distributed.destroy_process_group()
    op = tnt.qtt_screened_laplacian(5, delta=1.0, device="cpu")
    x = tnt.qtt_exponential(5, c=1.0, device="cpu")
    args = {"als_solve_sharded": (op, x, x), "als_eigsh_sharded": (op, x),
            "evolve_tdvp_sharded": (op, x, 0.01, 1), "evolve_tdvp2_sharded": (op, x, 0.01, 1),
            "evolve_theta_sharded": (op, x, 0.01, 1), "als_solve_adaptive_sharded": (op, x)}
    with pytest.raises(RuntimeError, match="init_process_group"):
        getattr(tpar, name)(mesh, *args[name])
    assert not torch.distributed.is_initialized()


# ---- the fused sweeps against their explicit loops ---------------------------------------


def _als_sweep_loop(x0c, X, xlc, a0, Am, al, b0, Bm, bl, lam, wf, wm, wl, dl, cg, spd):
    """The ALS sweep as the explicit loop it was before its scan bodies."""
    o = als_ops
    one3, one2 = o._ones(x0c.dtype, x0c.device, 1, 1, 1), o._ones(x0c.dtype, x0c.device, 1, 1)
    m = X.shape[0]

    def solve(L, R, Lb, Rb, ak, bk, vk, warm):
        return o._solve_core(L, R, Lb, Rb, ak, bk, vk, lam, dl, cg, spd, warm)

    rs, rbs = [None] * m, [None] * m
    R, Rb = o._adv_right(one3, xlc, al), o._adv_right_b(one2, xlc, bl)
    for j in range(m - 1, -1, -1):
        rs[j], rbs[j] = R, Rb
        R, Rb = o._adv_right(R, X[j], Am[j]), o._adv_right_b(Rb, X[j], Bm[j])
    q0 = o._left_orth(solve(one3, R, one2, Rb, a0, b0, x0c, wf))
    L, Lb = o._adv_left(one3, q0, a0), o._adv_left_b(one2, q0, b0)
    Q, ls, lbs = [], [], []
    for j in range(m):
        qk = o._left_orth(solve(L, rs[j], Lb, rbs[j], Am[j], Bm[j], X[j], wm[j]))
        Q.append(qk)
        ls.append(L)
        lbs.append(Lb)
        L, Lb = o._adv_left(L, qk, Am[j]), o._adv_left_b(Lb, qk, Bm[j])
    zl = solve(L, one3, Lb, one2, al, bl, xlc, wl)
    zl = solve(L, one3, Lb, one2, al, bl, zl, wl)
    vl = o._right_orth(zl)
    R, Rb = o._adv_right(one3, vl, al), o._adv_right_b(one2, vl, bl)
    V = [None] * m
    for j in range(m - 1, -1, -1):
        V[j] = o._right_orth(solve(ls[j], R, lbs[j], Rb, Am[j], Bm[j], Q[j], wm[j]))
        R, Rb = o._adv_right(R, V[j], Am[j]), o._adv_right_b(Rb, V[j], Bm[j])
    return solve(one3, R, one2, Rb, a0, b0, q0, wf), torch.stack(V), vl


def _eig_sweep_loop(x0c, X, xlc, a0, Am, al, mstk, vstk, shift, dl, iters):
    """The eigensolver sweep as the explicit loop it was before its scan
    bodies (the warm start carried into the next core as it went)."""
    e = eig_ops
    one3 = als_ops._ones(x0c.dtype, x0c.device, 1, 1, 1)
    use_mass, use_pen = mstk is not None, vstk is not None
    m0, Mm, ml = mstk if use_mass else (None, None, None)
    v0, VM, vl = vstk if use_pen else (None, None, None)
    h = e._EigHelpers(use_mass, use_pen, x0c.dtype, x0c.device,
                      v0.shape[0] if use_pen else 0, dl, iters)
    m = X.shape[0]

    def mk(j):
        return Mm[j] if use_mass else None

    def vk(j):
        return VM[j] if use_pen else None

    rs, rgs, rbs = [None] * m, [None] * m, [None] * m
    R = e._adv_right(one3, xlc, al)
    Rg = h.g_adv_r(h.g_seed(), xlc, ml)
    Rb = h.p_adv_r(h.p_seed(), xlc, ml, vl)
    for j in range(m - 1, -1, -1):
        rs[j], rgs[j], rbs[j] = R, Rg, Rb
        R, Rg, Rb = (e._adv_right(R, X[j], Am[j]), h.g_adv_r(Rg, X[j], mk(j)),
                     h.p_adv_r(Rb, X[j], mk(j), vk(j)))
    pens = h.pens_of(h.p_seed(), Rb, m0, v0, x0c.numel())
    _, vec = h.solve(one3, R, h.g_seed(), Rg, a0, m0, pens, shift, warm=x0c)
    vec = vec.reshape(x0c.shape)
    q0 = als_ops._left_orth(vec)
    warm = e._into_right(e._fac_right(vec, q0), X[0])
    L, Lg, Lb = (e._adv_left(one3, q0, a0), h.g_adv_l(h.g_seed(), q0, m0),
                 h.p_adv_l(h.p_seed(), q0, m0, v0))
    Q, ls = [], []
    for j in range(m):
        pens = h.pens_of(Lb, rbs[j], mk(j), vk(j), X[j].numel())
        _, vec = h.solve(L, rs[j], Lg, rgs[j], Am[j], mk(j), pens, shift, warm=warm)
        vec = vec.reshape(X[j].shape)
        qk = als_ops._left_orth(vec)
        warm = e._into_right(e._fac_right(vec, qk), X[j + 1] if j + 1 < m else xlc)
        Q.append(qk)
        ls.append((L, Lg, Lb))
        L, Lg, Lb = (e._adv_left(L, qk, Am[j]), h.g_adv_l(Lg, qk, mk(j)),
                     h.p_adv_l(Lb, qk, mk(j), vk(j)))
    pens = h.pens_of(Lb, h.p_seed(), ml, vl, xlc.numel())
    lam_f, vec = h.solve(L, one3, Lg, h.g_seed(), al, ml, pens, shift, warm=warm)
    vec = vec.reshape(xlc.shape)
    vlq = als_ops._right_orth(vec)
    warm = e._into_left(Q[-1], e._fac_left(vec, vlq))
    R, Rg, Rb = (e._adv_right(one3, vlq, al), h.g_adv_r(h.g_seed(), vlq, ml),
                 h.p_adv_r(h.p_seed(), vlq, ml, vl))
    V = [None] * m
    for j in range(m - 1, -1, -1):
        Lk, Lgk, Lbk = ls[j]
        pens = h.pens_of(Lbk, Rb, mk(j), vk(j), Q[j].numel())
        _, vec = h.solve(Lk, R, Lgk, Rg, Am[j], mk(j), pens, shift, warm=warm)
        vec = vec.reshape(Q[j].shape)
        V[j] = als_ops._right_orth(vec)
        warm = e._into_left(Q[j - 1] if j else q0, e._fac_left(vec, V[j]))
        R, Rg, Rb = (e._adv_right(R, V[j], Am[j]), h.g_adv_r(Rg, V[j], mk(j)),
                     h.p_adv_r(Rb, V[j], mk(j), vk(j)))
    pens = h.pens_of(h.p_seed(), Rb, m0, v0, q0.numel())
    lam_b, vec = h.solve(one3, R, h.g_seed(), Rg, a0, m0, pens, shift, warm=warm)
    return vec.reshape(q0.shape), torch.stack(V), vlq, lam_f, lam_b


def _stacked(t, dtype):
    xs = als_ops._core_lists(t, dtype)
    return xs[0], torch.stack(xs[1:-1]), xs[-1]


def _canonical(x0, dtype):
    xs = als_ops._core_lists(x0, dtype)
    als_ops._canonicalize(xs)
    return xs[0], torch.stack(xs[1:-1]), xs[-1]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("locals_", ["dense", "cg"])
def test_als_sweep_is_its_explicit_loop(dtype, locals_):
    """The scan-body sweep gives the explicit loop's bits."""
    op = tnt.qtt_screened_laplacian(6, delta=1.0, dtype=dtype, device="cpu")
    rhs = packed.pad_rank(tnt.qtt_exponential(6, c=3.0, dtype=dtype, device="cpu"), 2)
    x0 = packed.pad_rank(tnt.qtt_exponential(6, c=1.0, dtype=dtype, device="cpu"), 4)
    x = _canonical(x0, dtype)
    a, b = _stacked(op, dtype), _stacked(rhs, dtype)
    knobs = (1024, 200, True) if locals_ == "dense" else (0, 12, True)
    warm = (True, [True, False, True, True], False)
    for _ in range(2):
        got = als_ops._als_sweep_impl(*x, *a, *b, 0.0, *warm, *knobs)[:3]
        ref = _als_sweep_loop(*x, *a, *b, 0.0, *warm, *knobs)
        assert all(torch.equal(g, r) for g, r in zip(got, ref))
        x = got


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("case", ["dense", "lanczos", "mass_deflated"])
def test_eigsh_sweep_is_its_explicit_loop(dtype, case):
    op = tnt.qtt_screened_laplacian(6, delta=0.5, dtype=dtype, device="cpu")
    x = _canonical(packed.pad_rank(tnt.qtt_exponential(6, c=2.0, dtype=dtype, device="cpu"), 4),
                   dtype)
    a = _stacked(op, dtype)
    mstk = vstk = None
    dl, iters = (0, 6) if case == "lanczos" else (1024, 64)
    if case == "mass_deflated":
        mstk = _stacked(tnt.qtt_tridiagonal(6, 0.7, 0.1, 0.1, dtype=dtype, device="cpu"), dtype)
        v = _stacked(tnt.qtt_exponential(6, c=-1.0, dtype=dtype, device="cpu"), dtype)
        vstk = (v[0][None], v[1][:, None], v[2][None])
    got = eig_ops._eig_sweep_impl(*x, *a, mstk, vstk, 3.0, dl, iters)
    ref = _eig_sweep_loop(*x, *a, mstk, vstk, 3.0, dl, iters)
    assert all(torch.equal(g, r) for g, r in zip(got[:5], ref))
