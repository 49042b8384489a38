"""The port's two TT-GMRES solvers against the JAX package's, on the CPU
in float64.

``gmres_packed`` on the K=6 screened-Poisson QTT system of
``tests/test_qtt_solve.py:208`` (operator rank 3, rank-1 exponential
rhs, x0 = pad_rank(rhs, 4), Krylov rank 8): one short cycle in both
packages, held together (iterate to 1e-8 of its norm, residual to 1e-8
of rhs); then the port's full solve held to the reference bar (relative
residual < 1e-8) and to ``np.linalg.solve`` on the densified system
(1e-7).  The ``"rand"`` rounding draws from its own generator, so it is
held to the bar and the dense solve only.  The graph ``gmres`` on the
system of ``tests/test_core.py:321``: two iterations in both packages
held together, then the port's full solve to the reference bar
(residual < 1e-5) and to the dense solution.  The JAX runs are short:
each new rank is a JAX compile.
"""

import numpy as np
import torch

import tensor_networks_tpu as jtn
from tensor_networks_tpu.ops import packed as jpk
from tensor_networks_tpu.ops import qtt as jqtt
import tensor_networks_tpu_torch as ttn
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


def _qtt_system():
    op = tqtt.qtt_screened_laplacian(K, delta=1.0, device="cpu")
    rhs = tqtt.qtt_exponential(K, c=3.0, device="cpu")
    u_ref = np.linalg.solve(_dense_op(op), _dense_train(rhs))
    return op, rhs, u_ref


def test_gmres_packed_svd_matches_jax_and_dense():
    op, rhs, u_ref = _qtt_system()
    jop, jrhs = jqtt.qtt_screened_laplacian(K, delta=1.0), jqtt.qtt_exponential(K, c=3.0)
    short = dict(eps=1e-9, rank=8, maxiter=2, max_rank=8)
    jx, jres = jpk.gmres_packed(jop, jrhs, jpk.pad_rank(jrhs, 4), **short)
    tx, tres = tpk.gmres_packed(op, rhs, tpk.pad_rank(rhs, 4), **short)
    rhs_norm = float(tpk.norm_exact(rhs))
    ju, tu = _dense_train(jx), _dense_train(tx)
    assert np.linalg.norm(tu - ju) <= 1e-8 * np.linalg.norm(ju)
    assert abs(tres - float(jres)) <= 1e-8 * rhs_norm
    assert tpk.gmres_packed.last_stats["cycles"] == [
        {"rank": 8, "iterations": 2, "resid": tres}]

    x, resid = tpk.gmres_packed(op, rhs, tpk.pad_rank(rhs, 4), eps=1e-9, rank=8)
    assert resid / rhs_norm < 1e-8
    u = _dense_train(x)
    assert np.linalg.norm(u - u_ref) / np.linalg.norm(u_ref) < 1e-7
    parts = tpk.gmres_packed.last_stats["seconds"]
    assert set(parts) == {"apply", "round", "coeffs", "norm_exact", "lstsq"}


def test_gmres_packed_rand_meets_bar():
    """Randomized rounding (target 8 > n = 2: the first core's Q is
    zero-padded, the last bond's sketch is rank-deficient) reaches the
    same bars."""
    op, rhs, u_ref = _qtt_system()
    x, resid = tpk.gmres_packed(op, rhs, tpk.pad_rank(rhs, 4), eps=1e-9, rank=8,
                                round_method="rand", seed=3)
    rhs_norm = float(tpk.norm_exact(rhs))
    assert resid / rhs_norm < 1e-8
    assert all(torch.isfinite(t).all() for t in x)
    u = _dense_train(x)
    assert np.linalg.norm(u - u_ref) / np.linalg.norm(u_ref) < 1e-7


def _graph_system():
    """``tests/test_core.py:321``'s system, from a seed: a random 10 x 10
    matrix on the first mode, identities on modes of 5 and 3; rhs and x0
    random trains of ranks [3, 2]."""
    np.random.seed(5)
    pkgs = []
    for pkg in (jtn, ttn):
        pkgs.append([pkg.Index(nm, sz) for nm, sz in (("x", 10), ("y", 5), ("z", 3))]
                    + [pkg.Index(nm, sz) for nm, sz in (("xp", 10), ("yp", 5), ("zp", 3))])
    mat = np.random.randn(10, 10)
    ji, jo = pkgs[0][:3], pkgs[0][3:]
    jop = jtn.ttop_rank1(ji, jo, [mat, np.eye(5), np.eye(3)], "A")
    rhs = jtn.TensorNetwork.rand_tt(ji, [3, 2])
    x0 = jtn.TensorNetwork.rand_tt(ji, [3, 2])
    ti, to = pkgs[1][:3], pkgs[1][3:]
    top = ttn.ttop_rank1(ti, to, [mat, np.eye(5), np.eye(3)], "A", device="cpu")

    def port(net):
        return ttn.TensorNetwork.from_separated_dict(*net.to_separated_dict(),
                                                     device="cpu")

    return mat, (jop, rhs, x0), (top, port(rhs), port(x0))


def _dense(net):
    return _np(net.contract().value)


def test_graph_gmres_matches_jax_and_dense():
    mat, (jop, jrhs, jx0), (top, rhs, x0) = _graph_system()
    jx, jres = jtn.gmres(lambda t: jtn.ttop_apply(jop, t), jrhs, jx0, 1e-5, 1e-10,
                         maxiter=2)
    tx, tres = ttn.gmres(lambda t: ttn.ttop_apply(top, t), rhs, x0, 1e-5, 1e-10,
                         maxiter=2)
    ju = _dense(ttn.TensorNetwork.from_separated_dict(*jx.to_separated_dict(),
                                                      device="cpu"))
    tu = _dense(tx)
    assert np.abs(tu - ju).max() <= 1e-10 * np.abs(ju).max()
    assert abs(tres - jres) <= 1e-10 * abs(jres)

    x, resid = ttn.gmres(lambda t: ttn.ttop_apply(top, t), rhs, x0, 1e-5, 1e-10,
                         maxiter=30)
    assert resid < 1e-5
    want = np.einsum("ij,jkl->ikl", np.linalg.inv(mat), _dense(rhs))
    assert np.abs(_dense(x) - want).max() <= 1e-5 * np.abs(want).max()
