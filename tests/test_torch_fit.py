"""The port's fitting (``fit.py``) on the CPU in float64, held to the JAX
package and to the claims of ``tests/test_fit.py``.

- The JAX package is called once per entry point, on the same networks
  (built by its constructors from the same NumPy seeds as its tests and
  carried over with ``from_separated_dict``) and the same observations:
  ``fit_network``, 10 Adam steps at ``test_fit.py``'s d=5 shape, whose
  loss trajectory the port's matches within 1e-8 relative;
  ``fit_network_als``, 3 sweeps at uniform rank 2 (d=5, n=5), per-sweep
  errors within 1e-6 relative or 1e-12 absolute and evaluations at
  held-out points within 1e-8 of max|y| (evaluations, not cores: the two
  LAPACK builds may flip QR signs).
- ``test_fit.py``'s claims on the port alone, at its data and bars:
  completion of a low-rank TT, trees and Tucker, the minibatch path, ALS
  on a sparse smooth train and on ragged ranks with a permuted core, and
  the refusal of a non-chain.
- The mode-grouped normal equations against the one-hot einsum the JAX
  package assembles them with (1e-12).
"""

import numpy as np
import pytest
import torch

import tensor_networks_tpu as jtn
from tensor_networks_tpu import fit as jfit
from tensor_networks_tpu.ops import tt_separable as jax_tt_separable
from tensor_networks_tpu_torch import TensorNetwork
from tensor_networks_tpu_torch.fit import (
    _ModeGroups,
    completion_error,
    fit_network,
    fit_network_als,
)

# The suite runs in several worker processes on the CPU: torch's own
# thread pool would spin on the cores the other workers need.
torch.set_num_threads(1)


def _to_port(jnet):
    return TensorNetwork.from_separated_dict(*jnet.to_separated_dict(), device="cpu")


def _port_indices(net, jindices):
    return [next(i for i in net.free_indices() if i.name == j.name) for j in jindices]


def _observations(truth, indices, n):
    idx = np.stack([np.random.randint(0, i.size, size=n) for i in indices], axis=-1)
    return idx, truth.evaluate(indices, idx)


def _low_rank_problem():
    """``test_fit.py::test_fit_completes_low_rank_tt``'s data: both
    packages' model, the observations and a held-out set."""
    np.random.seed(11)
    jind = [jtn.Index(f"x{i}", 6) for i in range(5)]
    truth = _to_port(jtn.TensorNetwork.rand_tt(jind, [2, 3, 3, 2]))
    indices = _port_indices(truth, jind)
    idx, y = _observations(truth, indices, 4000)
    jmodel = jtn.TensorNetwork.rand_tt(jind, [2, 3, 3, 2])
    for node in jmodel.network.nodes:  # O(1)-scaled init
        t = jmodel.node_tensor(node)
        t.update_val_size(np.asarray(t.value) / np.sqrt(3))
    hold = _observations(truth, indices, 1000)
    return jmodel, jind, indices, idx, y, hold


def test_fit_loss_trajectory_matches_jax():
    jmodel, jind, indices, idx, y, _ = _low_rank_problem()
    model = _to_port(jmodel)
    losses = fit_network(model, indices, idx, y, steps=10, lr=5e-2)
    jlosses = jfit.fit_network(jmodel, jind, idx, y, steps=10, lr=5e-2)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-8, atol=0)
    pts = _observations(model, indices, 64)[0]
    np.testing.assert_allclose(
        model.evaluate(indices, pts), np.asarray(jmodel.evaluate(jind, pts)),
        rtol=0, atol=1e-8 * np.abs(y).max())


def test_fit_completes_low_rank_tt():
    jmodel, _, indices, idx, y, (hold_idx, hold_y) = _low_rank_problem()
    model = _to_port(jmodel)
    losses = fit_network(model, indices, idx, y, steps=600, lr=5e-2)
    assert losses[-1] < 1e-4 * losses[0]
    assert completion_error(model, indices, hold_idx, hold_y) < 0.05


@pytest.mark.parametrize("kind", ["ht", "tucker"])
def test_fit_works_on_trees_and_tucker(kind):
    np.random.seed(11)
    jind = [jtn.Index(f"t{i}", 4) for i in range(4)]
    truth = _to_port(jtn.TensorNetwork.rand_ht(jind, 2))
    indices = _port_indices(truth, jind)
    idx, y = _observations(truth, indices, 256)  # full grid size
    builder = {"ht": lambda: jtn.TensorNetwork.rand_ht(jind, 2),
               "tucker": lambda: jtn.TensorNetwork.rand_tucker(jind)}[kind]
    model = _to_port(builder())
    losses = fit_network(model, indices, idx, y, steps=300, lr=5e-2)
    assert losses[-1] < 0.05 * losses[0]


def test_fit_minibatch_path():
    np.random.seed(11)
    jind = [jtn.Index(f"m{i}", 5) for i in range(4)]
    truth = _to_port(jtn.TensorNetwork.rand_tt(jind, [2, 2, 2]))
    indices = _port_indices(truth, jind)
    idx, y = _observations(truth, indices, 2000)
    model = _to_port(jtn.TensorNetwork.rand_tt(jind, [2, 2, 2]))
    losses = fit_network(model, indices, idx, y, steps=300, lr=5e-2, batch_size=256)
    assert np.mean(losses[-20:]) < 0.1 * np.mean(losses[:20])


def test_fit_sgd_takes_plain_gradient_steps():
    """``optimizer="sgd"``: the first step moves each value by -lr times
    its gradient, taken here by autograd on the same loss."""
    _, _, indices, idx, y, _ = _low_rank_problem()
    np.random.seed(3)
    jind = [jtn.Index(i.name, i.size) for i in indices]
    model = _to_port(jtn.TensorNetwork.rand_tt(jind, [2, 3, 3, 2]))
    before = [model.value(n).clone() for n in model.network.nodes]
    run, _ = model.evaluator(indices, 4096)
    vals = [v.clone().requires_grad_(True) for v in before]
    ys = y / np.std(y)
    cols = torch.as_tensor(np.concatenate([idx, np.repeat(idx[-1:], 96, 0)]))
    w = torch.as_tensor(np.r_[np.ones(4000), np.zeros(96)] * (4096 / 4000))
    loss = torch.mean(w * (run(vals, cols) - torch.as_tensor(np.r_[ys, np.zeros(96)])) ** 2)
    grads = torch.autograd.grad(loss, vals)
    losses = fit_network(model, indices, idx, y, steps=1, lr=1e-2, optimizer="sgd")
    assert losses[0] == pytest.approx(float(loss.detach()), rel=1e-14)
    scale = [np.std(y)] + [1.0] * (len(before) - 1)
    for n, b, g, s in zip(model.network.nodes, before, grads, scale):
        torch.testing.assert_close(model.value(n), (b - 1e-2 * g) * s, rtol=1e-12, atol=1e-14)


def _als_problem(seed=6, d=5, n=5, ranks=(2, 2, 2, 2), n_obs=3000):
    np.random.seed(seed)
    jind = [jtn.Index(f"b{i}", n) for i in range(d)]
    truth = _to_port(jtn.TensorNetwork.rand_tt(jind, list(ranks)))
    indices = _port_indices(truth, jind)
    idx, y = _observations(truth, indices, n_obs)
    jmodel = jtn.TensorNetwork.rand_tt(jind, list(ranks))
    return jmodel, jind, indices, idx, y, _observations(truth, indices, 500)


def test_als_matches_jax():
    jmodel, jind, indices, idx, y, (hold, _) = _als_problem()
    model = _to_port(jmodel)
    errs = fit_network_als(model, indices, idx, y, sweeps=3)
    jerrs = jfit.fit_network_als(jmodel, jind, idx, y, sweeps=3)
    assert len(errs) == len(jerrs) == 3
    for e, je in zip(errs, jerrs):
        assert abs(e - je) <= max(1e-6 * abs(je), 1e-12), (errs, jerrs)
    np.testing.assert_allclose(
        model.evaluate(indices, hold), np.asarray(jmodel.evaluate(jind, hold)),
        rtol=0, atol=1e-8 * np.abs(y).max())


def test_mode_groups_give_the_one_hot_normal_equations():
    rng = np.random.default_rng(0)
    n, p, big = 7, 6, 500
    cols = torch.as_tensor(rng.integers(0, n - 1, big))  # mode n-1 unobserved
    lr = torch.as_tensor(rng.standard_normal((big, p)))
    y = torch.as_tensor(rng.standard_normal(big))
    (groups,) = _ModeGroups.of_cores([cols], [n])
    gram, rhs = groups.normal_equations(lr, y)
    onehot = torch.nn.functional.one_hot(cols, n).double()
    torch.testing.assert_close(gram, torch.einsum("nm,ni,nj->mij", onehot, lr, lr),
                               rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(rhs, torch.einsum("nm,ni,n->mi", onehot, lr, y),
                               rtol=1e-12, atol=1e-12)


def test_als_completes_sparse_smooth_train():
    """ALS on a d=6 smooth rank-2 target at ~2% density converges to near
    machine precision and stops early at tol."""
    d, n = 6, 8
    grid = np.linspace(-1.0, 1.0, n)
    jind = [jtn.Index(f"a{i}", n, tuple(grid)) for i in range(d)]
    truth = _to_port(jax_tt_separable(jind, [np.sin((i + 1) * grid) for i in range(d)]))
    indices = _port_indices(truth, jind)
    np.random.seed(5)
    idx = np.stack([np.random.randint(0, n, 20000) for _ in indices], -1)
    y = truth.evaluate(indices, idx)
    model = _to_port(jtn.TensorNetwork.rand_tt(jind, [2] * (d - 1)))
    errs = fit_network_als(model, indices, idx, y, sweeps=40, tol=1e-6)
    assert errs[-1] < 1e-6
    assert len(errs) < 40  # tol early-stop fired
    hold = np.stack([np.random.randint(0, n, 2000) for _ in indices], -1)
    assert completion_error(model, indices, hold, truth.evaluate(indices, hold)) < 1e-5


def test_als_ragged_ranks_and_layouts():
    """Ragged bond ranks and a permuted core layout round-trip through the
    canonical extraction and the write-back."""
    jmodel, _, indices, idx, y, _ = _als_problem(ranks=(2, 3, 3, 2))
    model = _to_port(jmodel)
    t = model.node_tensor(2)
    perm = [2, 0, 1]
    val = t.value.permute(*perm)
    t.indices[:] = [t.indices[p] for p in perm]
    t.update_val_size(val)
    errs = fit_network_als(model, indices, idx, y, sweeps=30, tol=1e-8)
    assert errs[-1] < 1e-6
    got = model.evaluate(indices, idx)
    assert np.linalg.norm(got - y) / np.linalg.norm(y) < 1e-6


def test_als_rejects_non_chain():
    jind = [jtn.Index(f"c{i}", 4) for i in range(4)]
    np.random.seed(0)
    tuck = _to_port(jtn.TensorNetwork.rand_tucker(jind))
    with pytest.raises(ValueError):
        fit_network_als(tuck, _port_indices(tuck, jind), np.zeros((4, 4), int), np.zeros(4))
