"""The port's TT-operator algebra, fixed-rank rounding and QTT constructors
against the JAX package's, on the CPU in float64.

The same NumPy inputs, made from a seed, go to both packages:
``ops/ttop.py`` (``ttop_sum``/``rank1``/``rank2``, ``ttop_apply``,
``ttop_sum_apply``) and the packed operator algebra of ``ops/packed.py``
(``pack_ttop``, ``ttop_add`` with mixed ranks and dtypes,
``ttop_identity``, ``ttop_scale``, ``ttop_transpose``, ``ttop_compose``,
``ttop_round``, ``ttop_apply_packed``) are held to 1e-12 of their scale;
``svd_round`` to the JAX result and to the dense input; ``rand_round``'s
inner function is fed the JAX package's own sketch draws and must give
its result; the QTT constructors must give the JAX package's cores exactly
and match the dense oracles of ``tests/test_qtt_solve.py``.  One shape
per JAX function keeps the JAX compiles few.
"""

import math

import jax
import jax.numpy as jnp
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

D, N = 4, 3  # the packed operator shape: d=4 cores, modes of 3


def _np(v):
    return v.detach().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _close(got, ref, rtol=1e-12):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    assert np.abs(got - ref).max() <= rtol * max(np.abs(ref).max(), 1e-300)


def _ops_np(seed, summands=2, n=N, d=D):
    rng = np.random.default_rng(seed)
    return [[rng.standard_normal((n, n)) / math.sqrt(n) for _ in range(d)]
            for _ in range(summands)]


def _indices(pkg, d=D, n=N):
    return ([pkg.Index(f"x{k}", n) for k in range(d)],
            [pkg.Index(f"y{k}", n) for k in range(d)])


def _train_np(seed, r, n=N, d=D):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, r)), rng.standard_normal((d - 2, r, n, r)),
            rng.standard_normal((r, n)))


def _both_train(seed, r, n=N, d=D):
    c = _train_np(seed, r, n, d)
    return jpk.PackedTT(*map(jnp.asarray, c)), tpk.from_numpy(*c, device="cpu")


def _both_op(op_np_cores, dtype=np.float64):
    c = [np.asarray(x, dtype) for x in op_np_cores]
    return (jpk.PackedTTOp(*map(jnp.asarray, c)),
            tpk.PackedTTOp(*(torch.from_numpy(x) for x in c)))


def _dense_train(x):
    """The represented vector of a packed train, core 0 slowest."""
    first, mids, last = (_np(t) for t in x)
    v = first
    for m in mids:
        v = np.einsum("ar,rnb->anb", v, m).reshape(-1, m.shape[-1])
    return (v @ last).reshape(-1)


def _dense_op(op):
    """The represented matrix of a packed operator, core 0 slowest."""
    first, mids, last = (_np(t) for t in op)
    m = first  # (O, I, R)
    for c in mids:
        m = np.einsum("oir,rpjs->opijs", m, c)
        s = m.shape
        m = m.reshape(s[0] * s[1], s[2] * s[3], s[4])
    m = np.einsum("oir,rpj->opij", m, last)
    s = m.shape
    return m.reshape(s[0] * s[1], s[2] * s[3])


def test_graph_operators_match_jax():
    """ttop_sum (and its rank-1/rank-2 aliases), ttop_apply and the lazy
    ttop_sum_apply: the same cores and the same applied trains."""
    ji, jo = _indices(jtn)
    ti, to = _indices(ttn)
    mats = _ops_np(1)
    jop = jtn.ttop_sum(ji, jo, mats, "A")
    top = ttn.ttop_sum(ti, to, mats, "A", device="cpu")
    for node in range(D):
        assert top.node_tensor(node).indices == [
            ttn.Index(i.name, i.size) for i in jop.node_tensor(node).indices]
        _close(top.value(node), jop.value(node))
    for jf, tf, args in ((jtn.ttop_rank1, ttn.ttop_rank1, [mats[0]]),
                         (jtn.ttop_rank2, ttn.ttop_rank2, mats)):
        jn, tn = jf(ji, jo, *args, "B"), tf(ti, to, *args, "B", device="cpu")
        for node in range(D):
            _close(tn.value(node), jn.value(node))

    c = _train_np(2, 2)
    cores = [c[0]] + list(c[1]) + [c[2]]
    jx = jtn.TensorNetwork()
    tx = ttn.TensorNetwork()
    bonds = [(f"r{k}", 2) for k in range(D - 1)]
    for k, v in enumerate(cores):
        legs = ([bonds[k - 1]] if k else []) + [(f"x{k}", N)] + (
            [bonds[k]] if k < D - 1 else [])
        jx.add_node(k, jtn.Tensor(jnp.asarray(v), [jtn.Index(*a) for a in legs]))
        tx.add_node(k, ttn.Tensor(torch.from_numpy(v), [ttn.Index(*a) for a in legs]))
        if k:
            jx.add_edge(k - 1, k)
            tx.add_edge(k - 1, k)
    japp, tapp = jtn.ttop_apply(jop, jx), ttn.ttop_apply(top, tx)
    for node in range(D):
        _close(tapp.value(node), japp.value(node))

    def lazy(m):
        first = lambda v, a=m[0]: np.asarray(a) @ np.asarray(v)  # noqa: E731
        mid = lambda v, a=m[1]: np.einsum("jk,mkp->mjp", a, np.asarray(v))  # noqa: E731
        mid2 = lambda v, a=m[2]: np.einsum("jk,mkp->mjp", a, np.asarray(v))  # noqa: E731
        last = lambda v, a=m[3]: np.einsum("ij,mj->mi", a, np.asarray(v))  # noqa: E731
        return [first, mid, mid2, last]

    jl = jtn.ttop_sum_apply(jx, ji, jo, [lazy(m) for m in mats], "L")
    tl = ttn.ttop_sum_apply(tx, ti, to, [lazy(m) for m in mats], "L")
    for node in range(D):
        _close(tl.value(node), jl.value(node))
    # the lazy and the materialized sums represent the same train
    _close(tl.contract().value, tapp.contract().value)


def test_packed_operator_algebra_matches_jax():
    """pack_ttop, ttop_add (mixed ranks and dtypes), ttop_identity,
    ttop_scale, ttop_transpose, ttop_compose, ttop_round (kept ranks
    equal) and ttop_apply_packed against the JAX package."""
    ji, jo = _indices(jtn)
    ti, to = _indices(ttn)
    mats = _ops_np(3)
    ja = jpk.pack_ttop(jtn.ttop_sum(ji, jo, mats, "A"), jo, ji)
    ta = tpk.pack_ttop(ttn.ttop_sum(ti, to, mats, "A", device="cpu"), to, ti,
                       device="cpu")
    for x, y in zip(ta, ja):
        assert x.is_contiguous()
        _close(x, y)
    assert ta.mids.shape == (D - 2, 2, N, N, 2)

    # a rank-1 float32 operand: the sum is promoted to float64
    jb, tb = _both_op([_ops_np(4, 1)[0][0][:, :, None],
                       np.stack([m[None, :, :, None] for m in _ops_np(5, 1)[0][1:3]]),
                       _ops_np(6, 1)[0][3][None]], np.float32)
    js, ts = jpk.ttop_add(ja, jb, ja), tpk.ttop_add(ta, tb, ta)
    assert ts.mids.dtype == torch.float64 and ts.mids.shape[1] == 5
    for x, y in zip(ts, js):
        _close(x, y)

    jid, tid = jpk.ttop_identity(D, N), tpk.ttop_identity(D, N, device="cpu")
    assert all(x.is_contiguous() and 0 not in x.stride() for x in tid)
    for x, y in zip(tid, jid):
        _close(x, y)
    for x, y in zip(tpk.ttop_scale(ts, -2.5), jpk.ttop_scale(js, -2.5)):
        _close(x, y)
    for x, y in zip(tpk.ttop_transpose(ts), jpk.ttop_transpose(js)):
        _close(x, y)
    jc = jpk.ttop_compose(jpk.ttop_transpose(ja), jpk.ttop_add(ja, jid))
    tc = tpk.ttop_compose(tpk.ttop_transpose(ta), tpk.ttop_add(ta, tid))
    for x, y in zip(tc, jc):
        _close(x, y)
    _close(_dense_op(tc), _dense_op(ta).T @ (_dense_op(ta) + np.eye(N**D)))

    jr, tr = jpk.ttop_round(js, eps=1e-10), tpk.ttop_round(ts, eps=1e-10)
    assert tr.first.shape == jr.first.shape  # the same kept rank
    _close(_dense_op(tr), _dense_op(jr))
    _close(_dense_op(tr), _dense_op(ts), 1e-9)

    jx, tx = _both_train(8, 3)
    jy, ty = jpk.ttop_apply_packed(js, jx), tpk.ttop_apply_packed(ts, tx)
    assert ty.rank == 15
    for x, y in zip(ty, jy):
        _close(x, y)
    _close(_dense_train(ty), _dense_op(ts) @ _dense_train(tx))


def test_svd_round_matches_jax_and_dense():
    """svd_round of a rank-6 train to target 8 (zero directions padded
    on) and to target 4 (truncating): the represented tensor as the JAX
    package's, and the first to the dense input."""
    (ja, ta), (jb, tb) = _both_train(9, 3), _both_train(10, 3)
    js, ts = jpk.add(ja, jb), tpk.add(ta, tb)
    for target in (8, 4):
        jr, tr = jpk.svd_round(js, target), tpk.svd_round(ts, target)
        assert tr.rank == target and all(x.is_contiguous() for x in tr)
        _close(_dense_train(tr), _dense_train(jr))
    _close(_dense_train(tpk.svd_round(ts, 8)), _dense_train(ts))


def _jax_sketch(x, target, key):
    """The three sketch tensors of the JAX package's rand_round
    (``packed.py:856-866``), drawn from ``key`` as it draws them."""
    d_mid, _, n, _ = x.mids.shape
    keys = jax.random.split(key, 3)
    dt = x.first.dtype
    return (
        jax.random.normal(keys[0], (n, target), dt) / jnp.sqrt(jnp.asarray(n * target, dt)),
        jax.random.normal(keys[1], (d_mid, target, n, target), dt)
        / jnp.sqrt(jnp.asarray(n * target * target, dt)),
        jax.random.normal(keys[2], (target, n), dt) / jnp.sqrt(jnp.asarray(n * target, dt)),
    )


def test_rand_round_matches_jax_draws():
    """rand_round_sketched, fed the JAX package's own draws, gives
    rand_round(x, t, key) to 1e-12; the public function recovers an
    exactly low-rank train (``tests/test_packed.py:87``).  The target is
    the mode size: with t > n the last bond's interface has rank n, and
    the QR's trailing columns are whatever each LAPACK build makes of a
    rank-deficient matrix (the GMRES tests run t > n on both packages)."""
    (ja, ta), (jb, tb) = _both_train(11, 3), _both_train(12, 2)
    js, ts = jpk.add(ja, jb), tpk.add(ta, tb)
    key = jax.random.PRNGKey(7)
    jr = jpk.rand_round(js, N, key)
    sketch = [torch.from_numpy(np.array(s)) for s in _jax_sketch(js, N, key)]
    tr = tpk.rand_round_sketched(ts, *sketch)
    for x, y in zip(tr, jr):
        _close(x, y)

    doubled = tpk.add(ta, ta)  # rank 6, exact rank 3
    out = tpk.rand_round(doubled, 3, torch.Generator().manual_seed(0))
    assert out.rank == 3
    _close(_dense_train(out), 2 * _dense_train(ta), 1e-10)


def test_rand_round_long_float32_train():
    """A d=120 float32 train of exact rank 2 rounded to target 8: the
    sketch interfaces shrink by ~1/sqrt(n t) a core (8^-118, far below
    float32's range) and would underflow to zero without the power-of-two
    rescaling; rescaled, the round keeps the train."""
    rng = np.random.default_rng(13)
    d, n, r = 120, 2, 2
    cores = [rng.standard_normal((n, r))] + [
        rng.standard_normal((r, n, r)) / math.sqrt(n * r) for _ in range(d - 2)
    ] + [rng.standard_normal((r, n))]
    x = tpk.PackedTT(*(torch.tensor(np.asarray(c), dtype=torch.float32) for c in
                       (cores[0], np.stack(cores[1:-1]), cores[-1])))
    y = tpk.rand_round(x, 8, torch.Generator().manual_seed(1))
    x64 = tpk.PackedTT(*(t.double() for t in x))
    y64 = tpk.PackedTT(*(t.double() for t in y))
    err = float(tpk.norm_exact(tpk.add(x64, tpk.scale(y64, -1.0))))
    assert all(torch.isfinite(t).all() for t in y)
    assert err <= 1e-4 * float(tpk.norm_exact(x64))


def _lin(K):
    """Position in the densified layout (core 0 slowest) -> grid index
    (little-endian bits), as ``tests/test_qtt_solve.py::_perm_to_linear``."""
    pos = np.arange(2**K)
    bits = [(pos >> (K - 1 - k)) & 1 for k in range(K)]  # bits[k]: core k's
    return sum(b << k for k, b in enumerate(bits))


def test_qtt_constructors_match_jax_and_dense():
    """Every QTT constructor gives the JAX package's cores exactly, contiguous;
    the screened Laplacian, the shift, the tridiagonal and the 2D operator
    densify to their matrices, the functions to their values."""
    K = 4
    n = 2**K
    calls = [
        ("qtt_shift", (K,)),
        ("qtt_tridiagonal", (K, 0.5, -1.5, 2.0)),
        ("qtt_screened_laplacian", (K, 0.7)),
        ("qtt_screened_laplacian_2d", (3, 0.9)),
        ("qtt_screened_laplacian_nd", (2, 3, 0.4)),
        ("qtt_exponential", (K, 3.0)),
        ("qtt_trig", (K, 5.0, 0.3)),
        ("qtt_polynomial", (K, [0.5, -1.0, 2.0])),
        ("qtt_exponential_2d", (3, 1.5, 2.5)),
        ("qtt_exponential_nd", (2, (1.0, 2.0, 3.0))),
        ("qtt_rank1_from_weights", ([0.5, 2.0, -1.0],)),
    ]
    built = {}
    for name, args in calls:
        got = getattr(tqtt, name)(*args, device="cpu")
        ref = getattr(jqtt, name)(*args)
        for x, y in zip(got, ref):
            assert x.dtype == torch.float64 and x.is_contiguous()
            np.testing.assert_array_equal(_np(x), np.asarray(y))
        built[name] = got
    got = tqtt.qtt_interleave_1d_op(built["qtt_shift"], K, 1, naxes=3, device="cpu")
    ref = jqtt.qtt_interleave_1d_op(jqtt.qtt_shift(K), K, 1, naxes=3)
    for x, y in zip(got, ref):
        np.testing.assert_array_equal(_np(x), np.asarray(y))
    f32 = tqtt.qtt_screened_laplacian(K, 1.0, dtype=torch.float32, device="cpu")
    assert all(x.dtype == torch.float32 for x in f32)

    lin = _lin(K)

    def on_grid(mat):
        out = np.zeros_like(mat)
        out[np.ix_(lin, lin)] = mat
        return out

    shift = np.diag(np.ones(n - 1), 1)
    _close(on_grid(_dense_op(built["qtt_shift"])), shift)
    _close(on_grid(_dense_op(built["qtt_tridiagonal"])),
           0.5 * np.eye(n) - 1.5 * shift + 2.0 * shift.T)
    _close(on_grid(_dense_op(built["qtt_screened_laplacian"])),
           2.7 * np.eye(n) - shift - shift.T)
    # the 2D operator: x bits at even positions, y bits at odd ones
    K2, n2 = 3, 8
    pos = np.arange(4**K2)
    bit = [(pos >> (2 * K2 - 1 - p)) & 1 for p in range(2 * K2)]
    gx = sum(bit[2 * k] << k for k in range(K2))
    gy = sum(bit[2 * k + 1] << k for k in range(K2))
    s2 = np.diag(np.ones(n2 - 1), 1)
    a1 = 2.0 * np.eye(n2) - s2 - s2.T
    want = np.kron(a1 + 0.9 * np.eye(n2), np.eye(n2)) + np.kron(np.eye(n2), a1)
    grid = gx * n2 + gy
    _close(_dense_op(built["qtt_screened_laplacian_2d"]), want[np.ix_(grid, grid)])

    t = np.arange(n) / n
    for name, values in (
        ("qtt_exponential", np.exp(-3.0 * t)),
        ("qtt_trig", np.sin(5.0 * t + 0.3)),
        ("qtt_polynomial", 0.5 - t + 2.0 * t**2),
    ):
        vec = np.zeros(n)
        vec[lin] = _dense_train(built[name])
        _close(vec, values, 1e-14)
