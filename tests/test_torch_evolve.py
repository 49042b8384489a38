"""The port's time integrators (``ops/evolve.py``) on the CPU in float64,
held to the claims of ``tests/test_evolve.py``.

- Dense and analytic oracles: the theta trajectories (implicit Euler and
  Crank-Nicolson, with FEM mass, constant and time-dependent sources)
  against dense theta steps (1e-6); one-site TDVP at full rank against
  ``expm(-T A) u0`` (1e-12), its Lanczos path against the dense path
  (1e-12), rank-limited accuracy (2e-4) with the rank kept, the skew
  flow's norm (1e-12); the fused form against the host loop on both
  local paths (1e-12), the callback path, the observables; two-site
  TDVP growing onto the exact manifold (1e-11), beating frozen-rank
  TDVP, reporting its ``eps`` ranks; every refusal.
- The JAX package's host loop, called once per integrator at the K=5
  shapes of its own tests: the port's represented vector to 1e-10, its
  norms and energies to 1e-12, its ranks exactly.  Each JAX shape
  family costs seconds of compiles, so the other claims rest on the
  oracles above (the JAX package's own tests hold it to the same ones).
- ``tdvp_trajectory``'s autograd gradients (operator coefficient and
  ``dt``) against central differences (1e-6), its forward values against
  ``evolve_tdvp`` (1e-12).
- The sync-free local exponential against ``scipy.linalg.expm`` and
  ``torch.linalg.matrix_exp`` (both in float64 on the same input) at
  scaled 1-norms from 1e-6 to 50: 1e-13 relative in float64, 1e-6 in
  float32 (``matrix_exp`` in float32 itself is ~4e-6 off at 50).
"""

import numpy as np
import pytest
import scipy.linalg as sla
import torch

from tensor_networks_tpu.ops import evolve as jev
from tensor_networks_tpu.ops import packed as jpk
from tensor_networks_tpu.ops import qtt as jqtt
from tensor_networks_tpu_torch.ops import evolve as tev
from tensor_networks_tpu_torch.ops import packed as tpk
from tensor_networks_tpu_torch.ops import qtt as tqtt

# The suite runs in several worker processes on the CPU: torch's own
# thread pool would spin on the cores the other workers need.
torch.set_num_threads(1)

CPU = "cpu"


def _np(v):
    return v.detach().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _dense_of(p):
    """The represented vector of a packed train on the grid: core 0 is
    the least significant bit (the QTT convention)."""
    first, mids, last = (_np(t) for t in p)
    v = first
    for m in mids:
        v = np.einsum("ar,rnb->anb", v, m).reshape(-1, m.shape[-1])
    v = (v @ last).reshape((2,) * (len(mids) + 2))
    return v.transpose(*reversed(range(v.ndim))).reshape(-1)


def _heat(K, main=2.0, upper=-1.0, lower=-1.0):
    n = 2**K
    return main * np.eye(n) + upper * np.eye(n, k=1) + lower * np.eye(n, k=-1)


def _rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _op(K, main=2.0, upper=-1.0, lower=-1.0):
    return tqtt.qtt_tridiagonal(K, main, upper, lower, device=CPU)


def _exp(K, c=3.0):
    return tqtt.qtt_exponential(K, c=c, device=CPU)


def _theta_dense(Ad, Md, u, f, dt, steps, theta, forcing=lambda s: 1.0):
    L, R = Md + theta * dt * Ad, Md - (1 - theta) * dt * Ad
    for s in range(steps):
        u = np.linalg.solve(L, R @ u + forcing(s) * f)
    return u


@pytest.mark.parametrize("theta", [1.0, 0.5])
def test_theta_matches_dense_trajectory(theta):
    """Implicit Euler and Crank-Nicolson on the 1D heat equation: the
    dense 20-step trajectory (per-step ALS warm starts at fixed rank)."""
    K = 6
    u0 = tpk.pad_rank(_exp(K), 8)
    u, res = tev.evolve_theta(_op(K), u0, 0.1, 20, theta=theta, spd=True)
    assert len(res) == 20 and res[-1] < 1e-10
    ref = _theta_dense(_heat(K), np.eye(2**K), _dense_of(u0), 0.0, 0.1, 20, theta)
    assert _rel(_dense_of(u), ref) < 1e-6


def test_theta_with_fem_mass():
    """(M + theta dt A) with the FEM mass matrix against the dense
    generalized trajectory."""
    K = 5
    h = 1.0 / (2**K + 1)
    A = _op(K, 2.0 / h, -1.0 / h, -1.0 / h)
    M = _op(K, 4.0 * h / 6, h / 6, h / 6)
    u0 = tpk.pad_rank(_exp(K, 2.0), 8)
    u, res = tev.evolve_theta(A, u0, 1e-4, 10, theta=0.5, mass=M, spd=True)
    assert res[-1] < 1e-10
    ref = _theta_dense(_heat(K, 2.0 / h, -1.0 / h, -1.0 / h),
                       _heat(K, 4.0 * h / 6, h / 6, h / 6), _dense_of(u0), 0.0, 1e-4, 10, 0.5)
    assert _rel(_dense_of(u), ref) < 1e-6


@pytest.mark.parametrize("theta", [1.0, 0.5])
def test_theta_with_constant_source(theta):
    """du/dt = -A u + f with a constant train f."""
    K = 5
    u0 = tpk.pad_rank(_exp(K), 8)
    f = _exp(K, -2.0)
    u, res = tev.evolve_theta(_op(K), u0, 0.05, 12, theta=theta, source=f, spd=True)
    assert res[-1] < 1e-9
    ref = _theta_dense(_heat(K), np.eye(2**K), _dense_of(u0), 0.05 * _dense_of(f),
                       0.05, 12, theta)
    assert _rel(_dense_of(u), ref) < 1e-6


def test_theta_with_time_dependent_source():
    """A callable source f(t) = cos(t) f0 is taken at the theta
    quadrature points (Crank-Nicolson)."""
    K, dt = 5, 0.05
    u0 = tpk.pad_rank(_exp(K), 8)
    f0 = _exp(K, -2.0)
    u, res = tev.evolve_theta(_op(K), u0, dt, 10, theta=0.5,
                              source=lambda t: tpk.scale(f0, np.cos(t)), spd=True)
    assert res[-1] < 1e-9
    ref = _theta_dense(_heat(K), np.eye(2**K), _dense_of(u0), dt * _dense_of(f0), dt, 10, 0.5,
                       lambda s: 0.5 * (np.cos((s + 1) * dt) + np.cos(s * dt)))
    assert _rel(_dense_of(u), ref) < 1e-6


def test_tdvp_full_rank_is_exact():
    """At full bond rank the projector is the identity: TDVP reproduces
    expm(-T A) u0 to roundoff, and the norm history is the true norm."""
    K = 4
    u0 = tpk.pad_rank(_exp(K), 4)
    u, norms = tev.evolve_tdvp(_op(K), u0, 0.05, 10)
    ref = sla.expm(-0.5 * _heat(K)) @ _dense_of(u0)
    assert _rel(_dense_of(u), ref) < 1e-12
    assert abs(norms[-1] - np.linalg.norm(ref)) < 1e-12


def test_tdvp_lanczos_path_matches_dense_path():
    """dense_limit=0 sends every local exponential through Lanczos."""
    K = 4
    u0 = tpk.pad_rank(_exp(K), 4)
    u_d, _ = tev.evolve_tdvp(_op(K), u0, 0.05, 6)
    u_l, _ = tev.evolve_tdvp(_op(K), u0, 0.05, 6, dense_limit=0, krylov=20)
    assert _rel(_dense_of(u_l), _dense_of(u_d)) < 1e-12


def test_tdvp_rank_limited_accuracy_and_rank_preservation():
    """Rank-4 TDVP on a 2^7 heat equation stays at the truncation level
    of the manifold and never grows the rank."""
    K = 7
    u0 = tpk.svd_round(tpk.pad_rank(_exp(K), 4), 4)
    u, _ = tev.evolve_tdvp(_op(K), u0, 0.02, 25)
    assert u.rank == 4
    ref = sla.expm(-0.5 * _heat(K)) @ _dense_of(u0)
    assert _rel(_dense_of(u), ref) < 2e-4


def test_tdvp_skew_flow_preserves_norm():
    """A skew-symmetric generator (central advection) keeps the norm on
    the dense-exponential path."""
    K = 4
    u0 = tpk.pad_rank(_exp(K), 4)
    n0 = float(tpk.norm_exact(u0))
    _, norms = tev.evolve_tdvp(_op(K, 0.0, -1.0, 1.0), u0, 0.05, 12)
    assert abs(norms[-1] - n0) / n0 < 1e-12


@pytest.mark.parametrize("local", ["dense", "lanczos"])
def test_tdvp_fused_matches_host_loop(local):
    """The fused step is the host loop's arithmetic, reorganized."""
    K = 5
    kw = {} if local == "dense" else {"dense_limit": 0, "krylov": 20}
    u0 = tpk.svd_round(tpk.pad_rank(_exp(K), 4), 4)
    u_f, n_f = tev.evolve_tdvp(_op(K), u0, 0.04, 5, fused=True, **kw)
    u_h, n_h = tev.evolve_tdvp(_op(K), u0, 0.04, 5, fused=False, **kw)
    assert _rel(_dense_of(u_f), _dense_of(u_h)) < 1e-12
    np.testing.assert_allclose(n_f, n_h, rtol=1e-12)


def test_tdvp_fused_callback_path():
    """With a callback the fused path reads each step; the observed
    trajectory equals the unobserved one."""
    K = 4
    u0 = tpk.pad_rank(_exp(K), 4)
    seen = []
    _, n_cb = tev.evolve_tdvp(_op(K), u0, 0.05, 4,
                              callback=lambda s, u: seen.append(_dense_of(u)))
    u_sc, n_sc = tev.evolve_tdvp(_op(K), u0, 0.05, 4)
    assert len(seen) == 4
    np.testing.assert_allclose(n_cb, n_sc, rtol=1e-12)
    np.testing.assert_allclose(seen[-1], _dense_of(u_sc), rtol=0, atol=1e-12)


def test_tdvp_trajectory_is_differentiable():
    """Autograd through the whole trajectory: the final energy's
    gradients w.r.t. an operator coefficient and the step size against
    central differences (a full-rank train: the QR pullback needs tall
    factors); the forward values against evolve_tdvp."""
    K, r = 6, 2
    A = _op(K)
    rng = np.random.default_rng(0)
    u0 = tpk.from_numpy(rng.standard_normal((2, r)),
                        rng.standard_normal((K - 2, r, 2, r)) / np.sqrt(r),
                        rng.standard_normal((r, 2)), device=CPU)

    def loss(c, dtv):
        Ac = tpk.PackedTTOp(A.first * c, A.mids, A.last)
        return tev.tdvp_trajectory(Ac, u0, dtv, 3, observables=(A,))[2][-1, 0]

    c = torch.tensor(1.0, dtype=torch.float64, requires_grad=True)
    dtv = torch.tensor(0.05, dtype=torch.float64, requires_grad=True)
    gc, gdt = torch.autograd.grad(loss(c, dtv), (c, dtv))
    eps = 1e-6
    with torch.no_grad():
        fd_c = (loss(1.0 + eps, 0.05) - loss(1.0 - eps, 0.05)) / (2 * eps)
        fd_dt = (loss(1.0, 0.05 + eps) - loss(1.0, 0.05 - eps)) / (2 * eps)
    assert abs(float(gc) - float(fd_c)) / abs(float(fd_c)) < 1e-6
    assert abs(float(gdt) - float(fd_dt)) / abs(float(fd_dt)) < 1e-6
    u_r, n_r, o_r = tev.tdvp_trajectory(A, u0, 0.05, 3, observables=(A,))
    u_p, n_p, o_p = tev.evolve_tdvp(A, u0, 0.05, 3, observables=(A,))
    assert n_r.shape == (3,) and o_r.shape == (3, 1)
    np.testing.assert_allclose(_np(n_r), n_p, rtol=1e-12)
    np.testing.assert_allclose(_np(o_r)[:, 0], [t[0] for t in o_p], rtol=1e-12)
    np.testing.assert_allclose(_dense_of(u_r), _dense_of(u_p), rtol=0, atol=1e-12)


@pytest.fixture(scope="module")
def tdvp2_from_rank1():
    """Two-site TDVP at K=6 from the rank-1 exponential, max_rank 8, 8
    steps of 0.05, and the exact flow: shared by the two tests below."""
    K = 6
    u0 = _exp(K)
    u, norms, ranks = tev.evolve_tdvp2(_op(K), u0, 0.05, 8, max_rank=8)
    return u0, u, norms, ranks, sla.expm(-0.4 * _heat(K)) @ _dense_of(u0)


def test_tdvp2_grows_rank_to_exactness(tdvp2_from_rank1):
    """From a RANK-1 start with max_rank the full bond dimension, two-site
    TDVP grows onto the exact manifold."""
    _, u, norms, ranks, ref = tdvp2_from_rank1
    assert _rel(_dense_of(u), ref) < 1e-11
    assert abs(norms[-1] - np.linalg.norm(ref)) < 1e-11
    assert u.rank == 8 and 1 < ranks[-1] and max(ranks) <= 8


def test_tdvp2_beats_rank_frozen_tdvp1(tdvp2_from_rank1):
    """From the same rank-1 start the adaptive integrator is orders of
    magnitude closer to the flow than the rank-frozen one."""
    u0, u2, _, _, ref = tdvp2_from_rank1
    u1, _ = tev.evolve_tdvp(_op(6), u0, 0.05, 8)
    err1, err2 = _rel(_dense_of(u1), ref), _rel(_dense_of(u2), ref)
    assert err2 < 1e-11 and err1 > 1e3 * err2


def test_tdvp2_eps_truncation_and_rank_reporting():
    """A spectral threshold keeps the effective ranks below the padded
    max at truncation-level accuracy; the Lanczos path agrees with the
    dense path up to the SVD directions of the tiny kept values.  K=6 and
    max_rank 8 (the JAX test's K=7 and 10 cost 4x the dense locals'
    products on the CPU)."""
    K = 6
    u0 = _exp(K)
    seen = []  # the state after 3 steps, the dense path's
    u, _, ranks = tev.evolve_tdvp2(_op(K), u0, 0.02, 10, max_rank=8, eps=1e-6,
                                   callback=lambda s, x: seen.append(_dense_of(x)))
    ref = sla.expm(-0.2 * _heat(K)) @ _dense_of(u0)
    assert _rel(_dense_of(u), ref) < 1e-4
    assert all(r <= 8 for r in ranks) and min(ranks) < 8
    u_l, _, _ = tev.evolve_tdvp2(_op(K), u0, 0.02, 3, max_rank=8, eps=1e-6,
                                 dense_limit=0, krylov=24)
    assert _rel(_dense_of(u_l), seen[2]) < 1e-6


def test_observables_on_fused_and_host_paths():
    """<u, O u> recorded on the device in the fused trajectories matches
    the host path's (through the inner product); the identity observable
    gives the norm squared; the heat energy decays."""
    K = 5
    A = _op(K)
    u0 = tpk.pad_rank(_exp(K), 4)
    eye = tpk.ttop_identity(K, 2, torch.float64, device=CPU)
    _, n_f, e_f = tev.evolve_tdvp(A, u0, 0.04, 5, observables=(A, eye))
    _, _, e_h = tev.evolve_tdvp(A, u0, 0.04, 5, fused=False, observables=(A, eye))
    np.testing.assert_allclose(e_f, e_h, rtol=1e-10)
    np.testing.assert_allclose([e[1] for e in e_f], [n**2 for n in n_f], rtol=1e-12)
    energies = [e[0] for e in e_f]
    assert all(b < a for a, b in zip(energies, energies[1:]))
    _, _, _, e2 = tev.evolve_tdvp2(A, u0, 0.04, 4, max_rank=6, observables=(A,))
    _, _, _, e2h = tev.evolve_tdvp2(A, u0, 0.04, 4, max_rank=6, fused=False, observables=(A,))
    np.testing.assert_allclose(e2, e2h, rtol=1e-10)
    u3, _, e3 = tev.evolve_theta(A, u0, 0.05, 3, observables=(A,), spd=True)
    assert len(e3) == 3 and all(len(t) == 1 for t in e3)
    assert abs(e3[-1][0] - float(tpk.inner(u3, tpk.ttop_apply_packed(A, u3)))) < 1e-12


@pytest.mark.parametrize("kw", [{}, {"dense_limit": 0, "krylov": 24}, {"eps": 1e-6}],
                         ids=["dense", "lanczos", "eps"])
def test_tdvp2_fused_matches_host_loop(kw):
    """Trajectories, norms and effective ranks agree, with rank growth
    from a rank-1 start."""
    K = 5
    u0 = _exp(K)
    u_f, n_f, r_f = tev.evolve_tdvp2(_op(K), u0, 0.04, 4, max_rank=8, fused=True, **kw)
    u_h, n_h, r_h = tev.evolve_tdvp2(_op(K), u0, 0.04, 4, max_rank=8, fused=False, **kw)
    assert _rel(_dense_of(u_f), _dense_of(u_h)) < 1e-10
    np.testing.assert_allclose(n_f, n_h, rtol=1e-10)
    assert r_f == r_h


def test_tdvp2_fused_callback_path():
    """d=3 (no mid pairs) with a callback: the observed trajectory equals
    the unobserved one."""
    K = 3
    u0 = _exp(K)
    seen = []
    _, n_cb, r_cb = tev.evolve_tdvp2(_op(K), u0, 0.05, 4, max_rank=4,
                                     callback=lambda s, u: seen.append(_dense_of(u)))
    u_sc, n_sc, r_sc = tev.evolve_tdvp2(_op(K), u0, 0.05, 4, max_rank=4)
    assert len(seen) == 4 and r_cb == r_sc
    np.testing.assert_allclose(n_cb, n_sc, rtol=1e-12)
    np.testing.assert_allclose(seen[-1], _dense_of(u_sc), rtol=0, atol=1e-12)


def test_tdvp2_fused_rejects_two_cores():
    """d=2: explicit fused=True raises, the default keeps the host loop."""
    u0 = _exp(2, 1.0)
    with pytest.raises(ValueError):
        tev.evolve_tdvp2(_op(2), u0, 0.1, 1, max_rank=4, fused=True)
    u, _, _ = tev.evolve_tdvp2(_op(2), u0, 0.1, 1, max_rank=4)
    assert np.isfinite(_dense_of(u)).all()


def test_tdvp2_rejects_shrinking_max_rank():
    with pytest.raises(ValueError):
        tev.evolve_tdvp2(_op(4), tpk.pad_rank(_exp(4), 6), 0.1, 1, max_rank=4)


@pytest.mark.parametrize("theta", [0.0, 1.5])
def test_theta_rejects_explicit_and_out_of_range(theta):
    with pytest.raises(ValueError):
        tev.evolve_theta(_op(4), _exp(4), 0.1, 1, theta=theta)


def test_exports_and_signatures_match_the_jax_package():
    """The four integrators are exported from ``ops`` and the package, as
    in the JAX package, with its parameters and defaults."""
    import inspect

    import tensor_networks_tpu as jtn
    import tensor_networks_tpu.ops as jops
    import tensor_networks_tpu_torch as ttn
    import tensor_networks_tpu_torch.ops as tops

    names = {"evolve_theta", "evolve_tdvp", "evolve_tdvp2", "tdvp_trajectory"}
    for jmod, tmod in ((jops, tops), (jtn, ttn)):
        assert names <= set(jmod.__all__) and names <= set(tmod.__all__)
    for name in names:
        jsig = inspect.signature(getattr(jev, name)).parameters
        tsig = inspect.signature(getattr(tev, name)).parameters
        assert [(p.name, p.kind, p.default) for p in jsig.values()] == \
            [(p.name, p.kind, p.default) for p in tsig.values()], name


# -- against the JAX package's host loop ---------------------------------------------


def _jax_system(K, start):
    u0 = jqtt.qtt_exponential(K, c=3.0)
    return jqtt.qtt_tridiagonal(K, 2.0, -1.0, -1.0), start(u0)


def _port_train(ju):
    return tpk.from_numpy(*(np.asarray(x) for x in ju), device=CPU)


@pytest.mark.parametrize("integrator", ["tdvp", "tdvp2", "theta"])
def test_matches_the_jax_host_loop(integrator):
    """One JAX host-loop call per integrator at K=5, rank 4 (one shape
    family for the three), the same start on both sides: vectors to
    1e-10, norms and energies to 1e-12, ranks exactly.  The tdvp2 run
    grows from rank 1 with eps truncation."""
    K = 5
    A = _op(K)
    if integrator == "theta":
        jA, ju0 = _jax_system(K, lambda u: jpk.pad_rank(u, 4))
        ju, jres, jobs = jev.evolve_theta(jA, ju0, 0.05, 3, theta=0.5, spd=True, fused=False,
                                          observables=(jA,))
        u, res, obs = tev.evolve_theta(A, _port_train(ju0), 0.05, 3, theta=0.5, spd=True,
                                       observables=(A,))
        assert len(res) == len(jres) == 3 and max(res) < 1e-9
    elif integrator == "tdvp":
        jA, ju0 = _jax_system(K, lambda u: jpk.svd_round(jpk.pad_rank(u, 4), 4))
        ju, jobs_n, jobs = jev.evolve_tdvp(jA, ju0, 0.04, 5, fused=False, observables=(jA,))
        for fused in (True, False):
            u, norms, obs = tev.evolve_tdvp(A, _port_train(ju0), 0.04, 5, fused=fused,
                                            observables=(A,))
            np.testing.assert_allclose(norms, jobs_n, rtol=1e-12)
    else:
        jA, ju0 = _jax_system(K, lambda u: u)
        ju, jn, jr, jobs = jev.evolve_tdvp2(jA, ju0, 0.04, 4, max_rank=4, eps=1e-6,
                                            fused=False, observables=(jA,))
        for fused in (True, False):
            u, norms, ranks, obs = tev.evolve_tdvp2(A, _port_train(ju0), 0.04, 4, max_rank=4,
                                                    eps=1e-6, fused=fused, observables=(A,))
            np.testing.assert_allclose(norms, jn, rtol=1e-12)
            assert ranks == jr
    np.testing.assert_allclose(obs, jobs, rtol=1e-12)
    assert _rel(_dense_of(u), _dense_of(ju)) <= 1e-10


# -- the local exponential -------------------------------------------------------------


def _matrices(kind, m, rng):
    g = rng.standard_normal((m, m))
    return {"symmetric": g + g.T, "negative definite": -(g @ g.T),
            "skew": g - g.T, "general": g}[kind]


@pytest.mark.parametrize("dtype, bar", [(torch.float64, 1e-13), (torch.float32, 1e-6)],
                         ids=["f64", "f32"])
def test_sync_free_exponential_matches_scipy(dtype, bar):
    """``_expm`` against scipy's and torch's exponentials of the same
    (rounded) input in float64, at scaled 1-norms from 1e-6 to 50 (the
    locals' |coef| |H|_1 range), with the squarings ``_squarings`` would
    allow for that norm."""
    rng = np.random.default_rng(7)
    for kind in ("symmetric", "negative definite", "skew", "general"):
        for norm in (1e-6, 1e-3, 0.1, 1.0, 3.0, 10.0, 50.0):
            a = _matrices(kind, 48, rng)
            a = torch.tensor(a * norm / np.abs(a).sum(0).max(), dtype=dtype)
            a64 = a.double()
            squarings = max(0, int(np.ceil(np.log2(norm)))) + 1
            got = tev._expm(a, squarings).double().numpy()
            assert tev._expm(a, squarings).dtype == dtype
            for ref in (sla.expm(a64.numpy()), torch.linalg.matrix_exp(a64).numpy()):
                assert _rel(got, ref) <= bar, (kind, norm, _rel(got, ref))


@pytest.mark.parametrize("which", ["heat", "skew", "random"])
def test_operator_norm_bound_holds(which):
    """``_op_norm_bound`` lies between the dense operator's 2-norm and its
    Frobenius norm, for the QTT heat and advection operators and a
    random rank-3 operator with signed entries."""
    K = 5
    if which == "random":
        rng = np.random.default_rng(4)
        A = tpk.PackedTTOp(*(torch.tensor(rng.standard_normal(s)) for s in
                             ((2, 2, 3), (K - 2, 3, 2, 2, 3), (3, 2, 2))))
    else:
        A = _op(K) if which == "heat" else _op(K, 0.0, -1.0, 1.0)
    dense = _dense_op(A)
    bound = tev._op_norm_bound(A)
    assert np.linalg.norm(dense, 2) <= bound * (1 + 1e-12)
    assert bound <= np.linalg.norm(dense) * (1 + 1e-12)


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


def test_squarings_cover_the_locals():
    """The squaring count set from |dt| and the bound on |A|_2 covers the scaling
    exponent every local of a trajectory asks for: more squarings leave
    the result unchanged."""
    K = 6
    A, u0 = _op(K), tpk.pad_rank(_exp(K), 4)
    base = tev._squarings(A, 0.5 * 0.3, 4 * 2 * 4, 1024, 24)
    assert base >= 1
    seen = []
    real = tev._expm

    def spy(a, squarings):
        seen.append(float(a.abs().sum(0).amax()))
        return real(a, squarings)

    tev._expm = spy
    try:
        tev.evolve_tdvp(A, u0, 0.3, 2)
    finally:
        tev._expm = real
    assert seen and max(np.ceil(np.log2(max(seen) / tev._THETA)), 0) <= base
