"""The port's tight-budget rounding (``ops/tight.py``) on the CPU, held to
the claims of ``tests/test_tight_eps.py``.

- The JAX package's ``tt_round_tight`` is called once (its compensated
  float32 sweeps compile for ~25 s): on the graded d=6 float32 train at
  eps 1e-6, batched.  The port keeps the same ranks, and its error is at
  most 2 eps and at most 4 x max(the JAX error, eps / 10).
- Dense and exact oracles for the rest, errors from ``norm_exact`` of
  the float64 difference train: the graded ranks 1/2/3/4 at eps
  1e-1/1e-3/1e-5/3e-7 within 2 eps (both sweeps); a rank-deficient last
  core (bond 6 against mode 4) within 2e-5; batched against sequential;
  d=3; ragged ranks with mixed modes recovered exactly within 2e-5 of
  the dense tensor; a singular value at 1e-10 of the norm, below a
  float64 Gram's ~1.5e-8 floor, kept or dropped by the budget; the
  refusals.
"""

import numpy as np
import pytest
import torch

import tensor_networks_tpu as jtn
from tensor_networks_tpu.ops.tight import tt_round_tight as jax_tight
from tensor_networks_tpu_torch import Index, TensorNetwork, tt_rank1, tt_sum
from tensor_networks_tpu_torch.ops import packed as tpk
from tensor_networks_tpu_torch.ops.tight import tt_round_tight

# The suite runs in several worker processes on the CPU: torch's own
# thread pool would spin on the cores the other workers need.
torch.set_num_threads(1)


def _graded(d=10, n=6, scales=(1.0, 1e-2, 1e-4, 1e-6), dtype=torch.float32):
    """``tests/test_tight_eps.py::_graded_train`` from the same draws: a
    sum of unit rank-1 trains at the given scales."""
    rng = np.random.default_rng(7)
    ins = [Index(f"x{i}", n) for i in range(d)]
    terms = []
    for sc in scales:
        vecs = [rng.standard_normal(i.size) for i in ins]
        t = tt_rank1(ins, [v / np.linalg.norm(v) for v in vecs], device="cpu")
        terms.append(t.scale(sc))
    return _cast(tt_sum(terms), dtype)


def _cast(tn, dtype):
    out = tn.__deepcopy__({})
    for node in out.network.nodes:
        out.node_tensor(node).update_val_size(out.value(node).to(dtype))
    return out


def _rel(out, ref):
    """|out - ref| / |ref| in float64, by the QR-sweep norm."""
    ref64 = _cast(ref, torch.float64)
    diff = _cast(out, torch.float64) - ref64
    num = tpk.norm_exact(tpk.pack_ragged(diff))
    return float(num / tpk.norm_exact(tpk.pack_ragged(ref64)))


@pytest.fixture(scope="module")
def graded6():
    """The d=6 graded train and the JAX package's batched result on it."""
    s = _graded(d=6)
    js = jtn.TensorNetwork.from_separated_dict(*s.to_separated_dict())
    jout, jranks = jax_tight(js, 1e-6)
    back = TensorNetwork.from_separated_dict(*jout.to_separated_dict(), device="cpu")
    return s, back, jranks


def test_tight_matches_jax_on_the_graded_train(graded6):
    s, jout, jranks = graded6
    out, ranks = tt_round_tight(s.__deepcopy__({}), 1e-6)
    assert ranks == list(jranks)
    assert all(out.value(n).dtype == torch.float32 for n in out.network.nodes)
    rel, jrel = _rel(out, s), _rel(jout, s)
    assert rel <= 2e-6, rel
    assert rel <= 4.0 * max(jrel, 1e-7), (rel, jrel)


@pytest.mark.parametrize("sweep", ["batched", "sequential"])
@pytest.mark.parametrize("eps,want", [(1e-1, 1), (1e-3, 2), (1e-5, 3), (3e-7, 4)])
def test_tight_tracks_eps_below_the_f32_floor(eps, want, sweep):
    s = _graded()
    out, ranks = tt_round_tight(s.__deepcopy__({}), eps, sweep=sweep)
    assert max(ranks) == want, ranks
    assert _rel(out, s) <= 2.0 * eps


def test_tight_rank_deficient_last_core():
    """Bond rank 6 against mode size 4: no ghost directions, no NaN."""
    rng = np.random.default_rng(3)
    ins = [Index(f"x{i}", 4) for i in range(8)]
    terms = [tt_rank1(ins, [rng.standard_normal(4) for _ in ins], device="cpu")
             for _ in range(6)]
    s = _cast(tt_sum(terms), torch.float32)
    out, ranks = tt_round_tight(s.__deepcopy__({}), 1e-5)
    assert all(torch.isfinite(out.value(n)).all() for n in out.network.nodes)
    assert max(ranks) <= 6
    assert _rel(out, s) <= 2e-5


@pytest.mark.parametrize("eps", [1e-3, 1e-6])
def test_tight_batched_matches_sequential(eps):
    s = _graded()
    out_b, ranks_b = tt_round_tight(s.__deepcopy__({}), eps, sweep="batched")
    out_s, ranks_s = tt_round_tight(s.__deepcopy__({}), eps, sweep="sequential")
    assert ranks_b == ranks_s
    rel_b, rel_s = _rel(out_b, s), _rel(out_s, s)
    assert rel_b <= 2.0 * eps
    assert rel_b <= 4.0 * max(rel_s, eps / 10)


def test_tight_minimum_train():
    s = _graded(d=3, scales=(1.0, 1e-3))
    out, ranks = tt_round_tight(s.__deepcopy__({}), 1e-2)
    assert len(ranks) == 2 and max(ranks) == 1
    assert _rel(out, s) <= 2e-2


@pytest.mark.parametrize("sweep", ["batched", "sequential"])
def test_tight_ragged_mixed_chain(sweep):
    """Ragged ranks and mixed modes go through the chain padding: exact
    rank recovery on a doubled float32 train."""
    g = torch.Generator().manual_seed(33)
    ins = [Index(f"u{k}", s) for k, s in enumerate([3, 5, 4, 6])]
    a = TensorNetwork.rand_tt(ins, [2, 4, 3], dtype=torch.float32, device="cpu",
                              generator=g)
    dense = 2.0 * a.contract().value.double()
    out, ranks = tt_round_tight(a + a, 1e-5, sweep=sweep)
    assert ranks == [2, 4, 3]
    got = out.contract().value.double()
    assert float(torch.linalg.norm(got - dense) / torch.linalg.norm(dense)) < 2e-5


@pytest.mark.parametrize("sweep", ["batched", "sequential"])
def test_tight_resolves_below_the_gram_floor(sweep):
    """A term at 1e-10 of the norm, in float64: the R-factor spectra see
    it (a float64 Gram resolves only ~1.5e-8), so eps 1e-11 keeps it and
    1e-9 drops it, each within 2 eps."""
    s = _graded(d=8, scales=(1.0, 1e-4, 1e-10), dtype=torch.float64)
    for eps, want in ((1e-11, 3), (1e-9, 2)):
        out, ranks = tt_round_tight(s.__deepcopy__({}), eps, sweep=sweep)
        assert max(ranks) == want, (eps, ranks)
        assert _rel(out, s) <= 2.0 * eps


def test_tight_refusals():
    s = _graded(d=6)
    with pytest.raises(ValueError):
        tt_round_tight(s, 1e-3, sweep="nope")
    with pytest.raises(ValueError):
        tt_round_tight(_graded(d=2, scales=(1.0,)), 1e-3)
