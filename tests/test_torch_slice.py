"""The port's main path against the JAX package's, end to end, in f64.

Both packages build the same trains (d=6, n=5, r=4; the JAX network
moves across through the separated-dict format), then pack, take inner
products and norms, round ``a + a`` with the fixed-rank sweep, evaluate,
and differentiate the packed inner product.  Tolerances: 1e-12 relative
for values (f64, same algorithms, summation order differs), 1e-10 for
gradients.  Rounded trains are compared as represented tensors: SVD
signs differ between the two libraries.
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensor_networks_tpu as jtn
from tensor_networks_tpu.ops import fast as jfast
from tensor_networks_tpu.ops import packed as jpk
import tensor_networks_tpu_torch as ttn
from tensor_networks_tpu_torch.ops import fast as tfast
from tensor_networks_tpu_torch.ops import packed as tpk

D, N, R = 6, 5, 4


def _rel(got, ref):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    return np.abs(got - ref).max() / np.abs(ref).max()


@pytest.fixture(scope="module")
def nets():
    np.random.seed(2024)
    inds = [jtn.Index(f"x{k}", N) for k in range(D)]
    ja = jtn.TensorNetwork.rand_tt(inds, [R] * (D - 1))
    jb = jtn.TensorNetwork.rand_tt(inds, [R] * (D - 1))
    ta, tb = (
        ttn.TensorNetwork.from_separated_dict(
            *x.to_separated_dict(), device="cpu"
        )
        for x in (ja, jb)
    )
    tinds = [ttn.Index(i.name, i.size) for i in inds]
    return ja, jb, ta, tb, inds, tinds


def test_pack_inner_norm(nets):
    ja, jb, ta, tb, _, _ = nets
    jpa, jpb = jpk.pack(ja), jpk.pack(jb)
    tpa, tpb = tpk.pack(ta), tpk.pack(tb)
    for x, y in zip(tpa, jpa):
        assert np.array_equal(x.numpy(), np.asarray(y))
    assert _rel(tpk.inner(tpa, tpb), jpk.inner(jpa, jpb)) <= 1e-12
    assert _rel(tpk.norm(tpa), jpk.norm(jpa)) <= 1e-12
    assert _rel(ttn.tt_inner_fast(ta, tb), jfast.tt_inner_fast(ja, jb)) <= 1e-12
    assert _rel(ta.inner(tb), ja.inner(jb)) <= 1e-12
    assert _rel(tpk.scale(tpa, -1.5).first, jpk.scale(jpa, -1.5).first) == 0

    # from_numpy takes the JAX package's packed arrays as they are
    tfa = tpk.from_numpy(
        *(np.asarray(x) for x in jpa), device="cpu", dtype=torch.float64
    )
    assert _rel(tpk.inner(tfa, tpb), jpk.inner(jpa, jpb)) <= 1e-12
    # unpack and pad_rank keep the represented tensor
    assert _rel(tpk.unpack(tpa).contract().value, ta.contract().value) == 0
    assert _rel(tpk.inner(tpk.pad_rank(tpa, 7), tpb), jpk.inner(jpa, jpb)) <= 1e-12


def test_round_fixed_matches_jax(nets):
    ja, _, ta, _, _, _ = nets
    jr, jranks = jfast.tt_round_fixed(ja + ja, 1e-8)
    tr, tranks = ttn.tt_round_fixed(ta + ta, 1e-8)
    assert tranks == jranks == [R] * (D - 1)
    assert _rel(tr.contract().value, jr.contract().value) <= 1e-12
    assert _rel(tr.contract().value, 2 * ja.contract().value) <= 1e-12
    assert tfast.ROUND_STATS["svd"] >= 1


def test_round_fixed_truncates_ragged_chains_like_jax(nets):
    """Truncation at a real budget keeps JAX's ranks, and the ragged
    chain it leaves goes through the padded entry (``_chain_padded``)."""
    ja, jb, ta, tb, _, _ = nets
    jr, jranks = jfast.tt_round_fixed(ja + jb, 0.3)
    tr, tranks = ttn.tt_round_fixed(ta + tb, 0.3)
    assert tranks == jranks
    assert _rel(tr.contract().value, jr.contract().value) <= 1e-12
    jp, jpr = jfast.tt_round_fixed(jr, 1e-10)  # ragged ranks now
    tp, tpr = ttn.tt_round_fixed(tr, 1e-10)
    assert tpr == jpr
    assert _rel(tp.contract().value, jp.contract().value) <= 1e-12
    jg, jgr = jfast.tt_round_fixed(ja, 1e-3, method="gram")
    tg, tgr = ttn.tt_round_fixed(ta, 1e-3, method="gram")
    assert tgr == jgr
    assert _rel(tg.contract().value, jg.contract().value) <= 1e-10


def test_evaluate_matches_jax(nets):
    ja, _, ta, _, inds, tinds = nets
    rng = np.random.default_rng(3)
    pts = rng.integers(0, N, (300, D))
    ref = ja.evaluate(inds, pts)
    assert _rel(ta.evaluate(tinds, pts), ref) <= 1e-12
    assert _rel(tpk.evaluate(tpk.pack(ta), torch.from_numpy(pts)), ref) <= 1e-12
    # CPU cores take the general evaluator; CUDA cores would take the
    # chain route, whose packing must match the JAX package's
    assert ta._ragged_evaluator(tinds) is None
    pk = tpk.pack_ragged(ta)
    assert pk.rank == 32  # the JAX package's rank bucket
    jpkr = jpk.pack_ragged(ja)
    assert _rel(tpk.evaluate(pk, torch.from_numpy(pts)),
                jpk.evaluate(jpkr, jnp.asarray(pts))) <= 1e-12


def test_inner_gradient_matches_jax(nets):
    ja, jb, ta, tb, _, _ = nets
    jpa, jpb = jpk.pack(ja), jpk.pack(jb)

    def f(*cores):
        return jpk.inner(jpk.PackedTT(*cores[:3]), jpk.PackedTT(*cores[3:]))

    jgrads = jax.grad(f, argnums=tuple(range(6)))(*jpa, *jpb)
    cores = [x.clone().requires_grad_(True) for x in (*tpk.pack(ta), *tpk.pack(tb))]
    out = tpk.inner(tpk.PackedTT(*cores[:3]), tpk.PackedTT(*cores[3:]))
    out.backward()
    for c, jg in zip(cores, jgrads):
        assert _rel(c.grad, jg) <= 1e-10


def test_import_pulls_in_no_jax():
    code = (
        "import sys, tensor_networks_tpu_torch; "
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'tensor_networks_tpu' or m.startswith('tensor_networks_tpu.')]; "
        "assert not bad, bad"
    )
    root = Path(__file__).resolve().parent.parent
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
