"""The port's DMRG eigensolver against the JAX package's and against
dense oracles, on the CPU in float64 (one case in float32).

The JAX side runs its host loop only, on one shape family (K=6, rank
6), plus one direct call of each dense local solver: its fused loop
compiles one whole program per shape, and its Lanczos recompiles its
``fori_loop`` on every call (seconds each).  Tolerances:

- the same start through both packages: ``lam`` to 1e-12 of |lam|, the
  vector to 1e-8 up to sign; the port's fused and host loops give the
  same Rayleigh history (1e-8);
- the local solvers on one random symmetric local problem (whitener
  cut, penalties): eigenvalue to 1e-10, vector to 1e-8 up to sign
  (dense, and mass metric, against the JAX functions; Lanczos past
  breakdown against the JAX dense solve);
- ground states against dense minima: 1e-12 (K=8, delta 0.5; the
  3-axis Kronecker sum); the three lowest by deflation to 1e-11, pairwise
  inner products (the zipper) below 1e-10; Lanczos locals to 1e-6 fused
  and host, and 1e-8 with a budget above every local dimension
  (breakdown); six-step Lanczos locals descend monotonically (1e-12)
  from the start's Rayleigh quotient; the generalized FEM pair to 1e-9, M-normalized and
  M-orthogonal; f32 with the dtype-scaled whitener cut to 1e-5 of the
  exact 0.302336;
- deflation through the fused loop equals the host loop (1e-10); mixed
  deflation ranks fall back to the host loop by default and raise with
  ``fused=True``;
- a float32 Gram with subnormal entries whitens to W^T G W = I (1e-5).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg as sla
import torch

from tensor_networks_tpu.ops import eigen as jeig
from tensor_networks_tpu.ops import packed as jpk
from tensor_networks_tpu.ops import qtt as jqtt
from tensor_networks_tpu_torch.ops import eigen as teig
from tensor_networks_tpu_torch.ops import packed as tpk
from tensor_networks_tpu_torch.ops import qtt as tqtt

# The suite runs in several worker processes on the CPU: torch's own
# thread pool would spin on the cores the other workers need.
torch.set_num_threads(1)


def _np(v):
    return v.detach().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _dense_train(x):
    first, mids, last = (_np(t) for t in x)
    v = first
    for m in mids:
        v = np.einsum("ar,rnb->anb", v, m).reshape(-1, m.shape[-1])
    return (v @ last).reshape(-1)


def _tridiag(n, diag, off):
    return diag * np.eye(n) + off * (np.eye(n, k=1) + np.eye(n, k=-1))


def _trid_eigs(K, delta):
    return np.linalg.eigvalsh(_tridiag(2**K, 2.0 + delta, -1.0))


def _cpu(make, *args, **kw):
    return make(*args, device="cpu", **kw)


def _monotone(hist, slack):
    return all(hist[i + 1] <= hist[i] + slack for i in range(len(hist) - 1))


def test_same_start_through_both_packages():
    """K=6, delta 0.3, rank 6 (end bonds overparameterized, so the
    frame-Gram whitening is live): the JAX host loop against the port's
    fused and host loops."""
    K, delta = 6, 0.3
    jx, jlam, jh = jeig.als_eigsh(jqtt.qtt_screened_laplacian(K, delta=delta),
                                  jpk.pad_rank(jqtt.qtt_exponential(K, c=2.0), 6),
                                  sweeps=12, fused=False)
    op = _cpu(tqtt.qtt_screened_laplacian, K, delta=delta)
    x0 = tpk.pad_rank(_cpu(tqtt.qtt_exponential, K, c=2.0), 6)
    ref = _dense_train(jx)
    hists = []
    for fused in (True, False):
        x, lam, hist = teig.als_eigsh(op, x0, sweeps=12, fused=fused)
        assert abs(lam - jlam) <= 1e-12 * abs(jlam)
        assert abs(lam - _trid_eigs(K, delta)[0]) < 1e-12
        u = _dense_train(x)
        assert min(np.linalg.norm(u - ref), np.linalg.norm(u + ref)) <= 1e-8
        assert _monotone(hist, 1e-12)
        hists.append(hist)
    np.testing.assert_allclose(hists[0], hists[1], rtol=1e-8)
    np.testing.assert_allclose(hists[1], jh, rtol=1e-8)


def _local_problem(seed=11, p=4, n=2, q=5, s=3):
    """A random symmetric local problem: L, R symmetric in their frame
    axes, ak symmetric in its physical axes, PSD Grams with one dead
    direction each (the whitener's cut), two penalty rows."""
    rng = np.random.default_rng(seed)

    def sym_env(r):
        g = rng.standard_normal((r, s, r))
        return g + g.transpose(2, 1, 0)

    def gram(r):
        m = rng.standard_normal((r, r - 1))
        return m @ m.T

    ak = rng.standard_normal((s, n, n, s))
    ak = ak + ak.transpose(0, 2, 1, 3)
    pens = rng.standard_normal((2, p * n * q))
    return sym_env(p), ak, sym_env(q), gram(p), gram(q), pens


def _up_to_sign(u, ref, tol):
    u, ref = np.asarray(u), np.asarray(ref)
    assert min(np.linalg.norm(u - ref), np.linalg.norm(u + ref)) <= tol * np.linalg.norm(ref)


@pytest.mark.parametrize("solver", ["dense", "lanczos", "mass"])
def test_local_solvers_match_jax(solver):
    L, ak, R, Lg, Rg, pens = _local_problem()
    shift = 7.0
    j = [jnp.asarray(a) for a in (L, ak, R, Lg, Rg, pens)]
    t = [torch.tensor(a) for a in (L, ak, R, Lg, Rg, pens)]
    if solver == "dense":
        jl, jv = jeig._local_ground_state(*j, jnp.asarray(shift))
        tl, tv = teig._local_ground_state(*t, shift)
    elif solver == "lanczos":
        # against the JAX dense solve: the two packages' whitened bases
        # differ in eigenvector signs, so their Krylov sequences from
        # the shared seed differ until they span the alive space (3 * 2
        # * 4 = 24 directions); 30 steps go past breakdown
        jl, jv = jeig._local_ground_state(*j, jnp.asarray(shift))
        tl, tv = teig._local_ground_state_lanczos(*t, shift, 30)
    else:
        # a PSD mass Lg (x) (I + 1/2) (x) Rg, one dead direction per Gram
        mk = np.eye(2)[None, :, :, None] + 0.5
        mass = [Lg[:, None, :], mk, Rg[:, None, :]]
        jl, jv = jeig._local_ground_state_mass(j[0], j[1], j[2],
                                               *(jnp.asarray(a) for a in mass),
                                               j[5], jnp.asarray(shift))
        tl, tv = teig._local_ground_state_mass(t[0], t[1], t[2],
                                               *(torch.tensor(a) for a in mass),
                                               t[5], shift)
    assert abs(float(tl) - float(jl)) <= 1e-10 * max(abs(float(jl)), 1.0)
    _up_to_sign(_np(tv), np.asarray(jv), 1e-8)


def test_ground_state_k8_matches_dense():
    """``tests/test_eigen.py:26``: unit-norm eigenvector, monotone
    Rayleigh descent, the dense minimum to 1e-12."""
    K, delta = 8, 0.5
    x, lam, hist = teig.als_eigsh(_cpu(tqtt.qtt_screened_laplacian, K, delta=delta),
                                  tpk.pad_rank(_cpu(tqtt.qtt_exponential, K), 4), sweeps=8)
    assert abs(lam - _trid_eigs(K, delta)[0]) < 1e-12
    assert abs(float(tpk.norm_exact(x)) - 1.0) < 1e-12
    assert _monotone(hist, 1e-12)


def test_kronecker_sum_oracle():
    """3-axis interleaved Laplacian: the ground energy is the sum of the
    per-axis minima."""
    op = _cpu(tqtt.qtt_screened_laplacian_nd, 2, 3, delta=1.0)
    x0 = tpk.pad_rank(_cpu(tqtt.qtt_exponential_nd, 2, (1.0, 2.0, 3.0)), 8)
    _, lam, _ = teig.als_eigsh(op, x0, sweeps=10)
    ref = _trid_eigs(2, 1.0)[0] + 2 * _trid_eigs(2, 0.0)[0]
    assert abs(lam - ref) < 1e-12


def test_three_lowest_by_deflation():
    K, delta = 6, 0.3
    op = _cpu(tqtt.qtt_screened_laplacian, K, delta=delta)
    x0 = tpk.pad_rank(_cpu(tqtt.qtt_exponential, K, c=2.0), 6)
    vecs, vals = teig.als_eigsh_k(op, x0, 3, sweeps=12)
    for v, r in zip(vals, _trid_eigs(K, delta)[:3]):
        assert abs(v - r) < 1e-11, (v, r)
    for i in range(3):
        for j in range(i + 1, 3):
            assert abs(float(tpk.inner(vecs[i], vecs[j]))) < 1e-10


@pytest.mark.parametrize("fused", [True, False])
def test_lanczos_locals_match_dense(fused):
    """Every local through the matrix-free Lanczos (``dense_limit=0``,
    48 steps; the middle locals have 8 * 2 * 8 = 128 unknowns), K=5
    delta 1 rank 8: the dense minimum to 1e-6
    (``tests/test_eigen.py:285`` runs K=6)."""
    K = 5
    x, lam, _ = teig.als_eigsh(_cpu(tqtt.qtt_screened_laplacian, K, delta=1.0),
                               tpk.pad_rank(_cpu(tqtt.qtt_exponential, K, c=3.0), 8),
                               sweeps=4, dense_limit=0, lanczos_iters=48, fused=fused)
    assert abs(lam - _trid_eigs(K, 1.0)[0]) < 1e-6
    assert abs(float(tpk.norm_exact(x)) - 1.0) < 1e-8


@pytest.mark.parametrize("fused", [True, False])
def test_short_lanczos_descends_from_the_start(fused):
    """Six Lanczos steps a local (K=8, rank 8, ``dense_limit=0``): each
    local starts from the train the sweep holds, its orthogonalization
    factor carried into it, so the Rayleigh history is monotone (1e-12)
    and ends below the start's Rayleigh quotient, and the returned
    vector's own quotient is the reported ``lam`` (1e-10).  Warm-started
    from the core before the factor moved, as the JAX package's host
    loop is, the history rises and falls between half-sweeps and ends
    above the start's quotient."""
    K = 8
    op = _cpu(tqtt.qtt_screened_laplacian, K, delta=1.0)
    x0 = tpk.pad_rank(_cpu(tqtt.qtt_exponential, K, c=3.0), 8)

    def rayleigh(x):
        return float(tpk.inner(x, tpk.ttop_apply_packed(op, x)) / tpk.inner(x, x))

    x, lam, hist = teig.als_eigsh(op, x0, sweeps=4, tol=-1.0, dense_limit=0,
                                  lanczos_iters=6, fused=fused)
    assert _monotone(hist, 1e-12)
    assert lam < rayleigh(x0) - 1e-2
    assert abs(rayleigh(x) - lam) < 1e-10


def test_lanczos_breakdown_is_masked():
    """48 Lanczos steps on locals of at most 4 * 2 * 4 = 32 unknowns: the
    steps past breakdown must not reach the minimum Ritz pair."""
    K = 4
    _, lam, _ = teig.als_eigsh(_cpu(tqtt.qtt_screened_laplacian, K, delta=0.5),
                               tpk.pad_rank(_cpu(tqtt.qtt_exponential, K), 4),
                               sweeps=6, dense_limit=0, lanczos_iters=48)
    assert abs(lam - _trid_eigs(K, 0.5)[0]) < 1e-8


def test_generalized_fem_pair():
    """``tests/test_eigen.py:189``: the FEM stiffness/mass pair against
    scipy's dense generalized eigh."""
    K = 6
    n = 2**K
    h = 1.0 / (n + 1)
    A = _cpu(tqtt.qtt_tridiagonal, K, 2.0 / h, -1.0 / h, -1.0 / h)
    M = _cpu(tqtt.qtt_tridiagonal, K, 4.0 * h / 6, h / 6, h / 6)
    refs = sla.eigh(_tridiag(n, 2 / h, -1 / h), _tridiag(n, 4 * h / 6, h / 6),
                    eigvals_only=True)[:3]
    x0 = tpk.pad_rank(_cpu(tqtt.qtt_exponential, K, c=1.0), 6)
    x, lam, hist = teig.als_eigsh(A, x0, sweeps=10, mass=M)
    assert abs(lam - refs[0]) < 1e-9
    assert abs(float(tpk.inner(x, tpk.ttop_apply_packed(M, x))) - 1.0) < 1e-9
    assert _monotone(hist, 1e-9)
    vecs, vals = teig.als_eigsh_k(A, x0, 3, sweeps=10, mass=M)
    for v, r in zip(vals, refs):
        assert abs(v - r) < 1e-9, (v, r)
    for i in range(3):
        for j in range(i + 1, 3):
            assert abs(float(tpk.inner(vecs[i], tpk.ttop_apply_packed(M, vecs[j])))) < 1e-9


def test_f32_whitener_cutoff():
    """``tests/test_eigen.py:231``: in f32 a fixed 1e-12 Gram cut let
    noise through (lam 1.2999998 against 0.302336)."""
    K, delta = 6, 0.3
    op = _cpu(tqtt.qtt_screened_laplacian, K, delta=delta, dtype=torch.float32)
    x0 = tpk.pad_rank(_cpu(tqtt.qtt_exponential, K, dtype=torch.float32), 6)
    _, lam, hist = teig.als_eigsh(op, x0, sweeps=12)
    assert abs(lam - _trid_eigs(K, delta)[0]) < 1e-5, lam
    assert _monotone(hist, 1e-4)


def test_deflation_fused_matches_host_and_mixed_ranks():
    K, delta = 6, 0.3
    op = _cpu(tqtt.qtt_screened_laplacian, K, delta=delta)
    x0 = tpk.pad_rank(_cpu(tqtt.qtt_exponential, K, c=2.0), 6)
    v1, _, _ = teig.als_eigsh(op, x0, sweeps=10)
    out = {f: teig.als_eigsh(op, x0, sweeps=10, deflate=(v1,), fused=f) for f in (True, False)}
    (x2, l2, _), (_, l2h, _) = out[True], out[False]
    assert abs(l2 - l2h) < 1e-10 * abs(l2h)
    assert abs(l2 - _trid_eigs(K, delta)[1]) < 1e-10
    assert abs(float(tpk.inner(x2, v1))) < 1e-9
    mixed = (v1, tpk.pad_rank(v1, 8))
    _, l3, _ = teig.als_eigsh(op, x0, sweeps=10, deflate=mixed)  # host loop
    assert abs(l3 - _trid_eigs(K, delta)[1]) < 1e-9
    with pytest.raises(ValueError, match="one shared rank"):
        teig.als_eigsh(op, x0, sweeps=1, deflate=mixed, fused=True)


#: A float32 bond Gram from a sweep of the port (K=8, rank 16, f32, 4
#: threads): four unit eigenvalues, the rest below 2e-16, 128 entries
#: subnormal in float32; little-endian float32 bytes, base64.
SUBNORMAL_GRAM = (
    "/f9/P05HuLK1N4yyNqhXM5SJLacy6NmnZZuxHD1YYZqS+UWQza1kDhsnTYX9jpEE+QEAgAAA"
    "AIABAAAAAAAAAE5HuLIBAIA/uUYgM7rIIrNdBlonGgZIqP7bLBwm9r8a5IqaDkAFPw6KsTyG"
    "nGwDhOcAAAAAAACAAAAAAAAAAAC1N4yyuUYgMwEAgD+yipizb1eXM1Ro17PgoTQo+nmTJTTm"
    "C5zTPhMZj5z2kVyRrg4wg4wEQ12FASbnGwAAAAAANqhXM7rIIrOyipiz/P9/P8CsmzP4gk20"
    "ptK3KH8DoCfJk/2cMBWeGnTpx5H7YvIQvUOEhYFOCQEDJAYAAAAAAJSJLaddBlonb1eXM8Cs"
    "mzPqIjgoC6W8qC8tJR0ggs0b5I1DkRwG1g7qrYWGuNgZBd4BAIAEAAAAAAAAAAAAAAAy6Nmn"
    "GgZIqFRo17P4gk20C6W8qCNLUikikbmdaFWEnO3+6BE2poaPnB4EB2Isx4W2BQAABwAAgAAA"
    "AAAAAAAAZZuxHP7bLBzgoTQoptK3KC8tJR0ikbmd3dsjEktN7BDkwk6GIQPwA9IcAICPBQAA"
    "AAAAAAAAAAAAAAAAAAAAAD1YYZom9r8a+nmTJX8DoCcggs0baFWEnEtN7BCtssgPlgQhhR7y"
    "xgIvBACAMAEAAAAAAAAAAAAAAAAAAAAAAACS+UWQ5IqaDjTmC5zJk/2c5I1Dke3+6BHkwk6G"
    "lgQhhXMIAABRAACAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAza1kDkAFPw7TPhMZMBWeGhwG"
    "1g42poaPIQPwAx7yxgJRAACABAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAABsnTYWKsTyG"
    "j5z2kXTpx5HqrYWGnB4EB9IcAIAvBACAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAA"
    "AAD9jpEEnGwDhFyRrg77YvIQuNgZBWIsx4WPBQAAMAEAAAAAAAAAAAAAAAAAAAAAAAAAAAAA"
    "AAAAAAAAAAAAAAAA+QEAgOcAAAAwg4wEvUOEhd4BAIC2BQAAAAAAAAAAAAAAAAAAAAAAAAAA"
    "AAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAIAAAACAQ12FAYFOCQEEAAAABwAAgAAAAAAAAAAA"
    "AAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAABAAAAAAAAACbnGwADJAYAAAAAAAAA"
    "AAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAA"
    "AAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAA=="
)


def test_f32_metric_with_subnormal_entries():
    """On this Gram torch's CPU LAPACK float32 ``eigh`` returned two NaN
    eigenvalues with no error; the local solve's vector came out NaN and
    the next solve failed on it.
    The whitener flushes its sub-roundoff entries: W is finite, keeps
    the four unit directions (cut 100 eps_f32) and whitens them (W^T G W
    = I to 1e-5)."""
    import base64

    g = np.frombuffer(base64.b64decode("".join(SUBNORMAL_GRAM)), dtype="<f4").reshape(16, 16)
    gram = torch.tensor(g)
    w, valid = teig._whitener(gram)
    assert w.dtype == torch.float32 and torch.isfinite(w).all()
    assert int(valid.sum()) == 4
    wv = w[:, valid].double()
    np.testing.assert_allclose((wv.T @ gram.double() @ wv).numpy(), np.eye(4), atol=1e-5)
