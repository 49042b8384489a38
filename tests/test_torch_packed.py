"""Parity of the port's packed TT algebra with the JAX package's
``ops/packed.py``, on the CPU in float64 (CPU tensors take the kernels'
plain versions).

The same NumPy cores go to both packages, and the results must agree to
1e-12 of their scale (gradients 1e-10): both sides do the same
arithmetic in f64, in another summation order.  One train shape (d=4,
n=3, r=4: fewer modes than the bond, so ``norm_exact`` takes its
padding branch) keeps the JAX compiles few.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensor_networks_tpu.ops import packed as jpk
from tensor_networks_tpu_torch.ops import packed as tpk

# The suite runs in several worker processes on the CPU: torch's own
# thread pool would spin on the cores the other workers need.
torch.set_num_threads(1)

D, N, R = 4, 3, 4

# jitted once per shape: op-by-op dispatch would compile every primitive
_jeval = jax.jit(lambda x, idx: jpk.evaluate(x, idx))
_jensemble = jax.jit(lambda trains, idx: jpk.evaluate_ensemble(trains, idx))


def _cores(seed, r=R):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((N, r)), rng.standard_normal((D - 2, r, N, r)),
            rng.standard_normal((r, N)))


def _both(seed, r=R):
    c = _cores(seed, r)
    return jpk.PackedTT(*map(jnp.asarray, c)), tpk.from_numpy(*c, device="cpu")


def _close(got, ref, rtol=1e-12):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= rtol * max(np.abs(ref).max(), 1e-300)


def _points(seed, b, low=0, high=N):
    return np.random.default_rng(seed).integers(low, high, (b, D))


@pytest.mark.parametrize("op", ["add", "hadamard"])
def test_sum_and_hadamard_match_jax(op):
    """The exact sum of three trains (ranks add) and the Hadamard product
    (ranks multiply): the same cores and the same values."""
    (ja, ta), (jb, tb), (jc, tc) = _both(1), _both(2, r=2), _both(3)
    if op == "add":
        j, t = jpk.add(ja, jb, jc), tpk.add(ta, tb, tc)
        assert t.rank == 2 * R + 2
    else:
        j, t = jpk.hadamard(ja, jb), tpk.hadamard(ta, tb)
        assert t.rank == 2 * R
    for x, y in zip(t, j):
        _close(x, y)
    pts = _points(4, 16)
    _close(tpk.evaluate(t, torch.from_numpy(pts)), _jeval(j, jnp.asarray(pts)))


def test_norm_exact_and_pad_match_jax():
    """The QR-sweep norm against the JAX package's, of a train and of a
    near-cancelling difference a - (1 - 1e-9) a, whose norm is 1e-9 |a|:
    the sweep is backward stable, so both packages hold it to roundoff
    of the components, 1e-12 |a| (the zipper norm would lose half the
    digits); pad returns the train itself."""
    ja, ta = _both(5)
    jd = jpk.add(ja, jpk.scale(ja, -(1 - 1e-9)))
    td = tpk.add(ta, tpk.scale(ta, -(1 - 1e-9)))
    norm_a = float(tpk.norm(ta))
    for got in (float(tpk.norm_exact(td)), float(jpk.norm_exact(jd))):
        assert abs(got - 1e-9 * norm_a) <= 1e-12 * norm_a
    _close(tpk.norm_exact(ta), norm_a)
    assert tpk.pad(ta) is ta


@pytest.mark.parametrize("shared", [True, False])
def test_evaluate_ensemble_matches_jax(shared):
    """Three trains folded into one call, at shared (N, d) or per-train
    (E, N, d) points with out-of-range entries, which clamp inside their
    own train; each row equals that train's own evaluation."""
    pairs = [_both(10 + e) for e in range(3)]
    shape = (20, D) if shared else (3, 20, D)
    pts = np.random.default_rng(6).integers(-2, N + 2, shape)
    got = tpk.evaluate_ensemble([t for _, t in pairs], torch.from_numpy(pts))
    ref = _jensemble([j for j, _ in pairs], jnp.asarray(pts))
    assert got.shape == (3, 20)
    _close(got, ref)
    for e, (_, t) in enumerate(pairs):
        _close(got[e], tpk.evaluate(t, torch.from_numpy(pts if shared else pts[e])))


def test_evaluate_dw_matches_jax_f64():
    """f64 evaluation (float64 cores and float32 cores cast to float64)
    against the JAX package's double-word evaluation with x64 on: a
    NumPy float64 vector, to 1e-12."""
    ja, ta = _both(7)
    pts = _points(8, 64)
    got = tpk.evaluate_dw(ta, torch.from_numpy(pts))
    assert isinstance(got, np.ndarray) and got.dtype == np.float64
    _close(got, jpk.evaluate_dw(ja, pts))
    # float32 cores are evaluated in float64 as they are: the reference
    # takes their exact float64 values
    t32 = tpk.PackedTT(*(x.float() for x in ta))
    ref32 = jpk.evaluate_dw(jpk.PackedTT(*(jnp.asarray(x.double().numpy()) for x in t32)), pts)
    _close(tpk.evaluate_dw(t32, torch.from_numpy(pts)), ref32)


def test_tt_evaluate_fast_gradient_matches_jax():
    """Forward values and the gradient of a weighted sum in every core,
    against ``jax.grad`` of the JAX package's function (1e-10); no
    gradient for the indices."""
    c = _cores(9)
    pts = _points(10, 32)
    w = np.random.default_rng(11).standard_normal(32)

    def forward_and_vjp(f, m, l):
        out, vjp = jax.vjp(
            lambda *x: jpk.tt_evaluate_fast(*x, jnp.asarray(pts)), f, m, l)
        return out, vjp(jnp.asarray(w))

    # one compile for the forward values and the gradient
    jout, jgrads = jax.jit(forward_and_vjp)(*map(jnp.asarray, c))
    cores = [torch.tensor(x, requires_grad=True) for x in c]
    idx = torch.from_numpy(pts)
    out = tpk.tt_evaluate_fast(*cores, idx)
    _close(out, jout)
    (out * torch.from_numpy(w)).sum().backward()
    for t, j in zip(cores, jgrads):
        _close(t.grad, j, rtol=1e-10)
    assert idx.grad is None
