"""The grouped evaluation (H2's design) on the CPU: its grouping tables
and the plain walk over them, against the port's plain evaluator and the
JAX package's evaluators.

``tt_evaluate_grouped_plain`` runs the same tables the CUDA kernel gets
(sort permutation, tile list), so these tests hold the tables; the
kernel itself runs only on a card (tests/test_torch_cuda.py and
chip_smoke.py).  Inputs come from a seed through NumPy and go to both
packages.  Tolerances, relative to max|ref|: 1e-12 in float64 and 1e-5
in float32 -- the same r-term sums in another order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from tensor_networks_tpu.kernels.ragged_eval import tt_evaluate_ragged
from tensor_networks_tpu.parallel.sharded import tt_evaluate_batched
from tensor_networks_tpu_torch.kernels import evaluate as tev


def _train(rng, d, n, r, dtype):
    first = rng.standard_normal((n, r))
    mids = rng.standard_normal((max(d - 2, 1), r, n, r)) / np.sqrt(r)
    last = rng.standard_normal((r, n))
    cores = [x.astype(dtype) for x in (first, mids, last)]
    if d == 2:
        cores[1] = None
    return cores


def _points(rng, pattern, b, d, n):
    if pattern == "one-mode":  # one group of b points at every step
        idx = rng.integers(0, n, (b, d))
        idx[:, 1:-1] = n - 1
        return idx
    if pattern == "distinct":  # b <= n: every group holds one point
        return (np.arange(b)[:, None] + np.arange(d)[None, :]) % n
    idx = rng.integers(0, n, (b, d))
    if pattern == "skip-mode":  # mode 1 holds no point at any step
        idx[idx == 1] = 0
    return idx


def _torch(cores):
    return [None if x is None else torch.from_numpy(x) for x in cores]


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / np.abs(ref).max()


# (pattern, B, d, n, r, tile_p): many tiles of one slice; one point per
# group; one point; a batch that is no multiple of the tile; a mode with
# no point; d = 3; two modes; more modes than points
CASES = [
    ("random", 48, 6, 5, 8, 4),
    ("one-mode", 48, 6, 5, 8, 4),
    ("skip-mode", 48, 6, 5, 8, 4),
    ("random", 48, 6, 5, 8, tev.TILE_P),
    ("distinct", 4, 5, 5, 8, 4),
    ("random", 1, 4, 3, 4, tev.TILE_P),
    ("random", 37, 3, 2, 3, 8),
    ("random", 3, 4, 5, 6, 2),
]


@pytest.mark.parametrize("pattern,b,d,n,r,tile_p", CASES)
def test_grouped_plain_matches_plain_and_batched_f64(pattern, b, d, n, r, tile_p):
    rng = np.random.default_rng(b * 100 + d)
    cores = _train(rng, d, n, r, np.float64)
    idx = _points(rng, pattern, b, d, n)
    got = tev.tt_evaluate_grouped_plain(*_torch(cores), torch.from_numpy(idx), tile_p)
    assert got.dtype == torch.float64 and got.shape == (b,)
    plain = tev.tt_evaluate_plain(*_torch(cores), torch.from_numpy(idx))
    assert _rel(got, plain) <= 1e-12
    ref = tt_evaluate_batched(*(jnp.asarray(x) for x in cores), jnp.asarray(idx))
    assert _rel(got, ref) <= 1e-12


@pytest.mark.parametrize("pattern,b,d,n,r,tile_p", CASES)
def test_grouped_plain_matches_ragged_f32(pattern, b, d, n, r, tile_p):
    rng = np.random.default_rng(b * 10 + n)
    cores = _train(rng, d, n, r, np.float32)
    idx = _points(rng, pattern, b, d, n)
    got = tev.tt_evaluate_grouped_plain(*_torch(cores), torch.from_numpy(idx), tile_p)
    assert got.dtype == torch.float32
    ref = tt_evaluate_ragged(
        *(jnp.asarray(x) for x in cores), jnp.asarray(idx, jnp.int32),
        precision="highest",
    )
    assert _rel(got, ref) <= 1e-5
    plain = tev.tt_evaluate_plain(*_torch(cores), torch.from_numpy(idx))
    assert _rel(got, plain) <= 1e-5


def test_grouped_plain_d2_has_no_tables():
    rng = np.random.default_rng(2)
    cores = _train(rng, 2, 4, 5, np.float64)
    idx = torch.from_numpy(rng.integers(0, 4, (20, 2)))
    got = tev.tt_evaluate_grouped_plain(*_torch(cores), idx)
    assert _rel(got, tev.tt_evaluate_plain(*_torch(cores), idx)) <= 1e-12


def _check_tables(idx, n, tile_p):
    """Every point in exactly one tile per step, in its own mode's tile;
    the table has the length the launch uses."""
    b, d = idx.shape
    tables = tev.build_group_tables(torch.from_numpy(idx), n, tile_p)
    slots = tev.max_tiles_per_step(b, n, tile_p)
    assert tables.tile_p == tile_p
    assert tables.perm.shape == (d - 2, b) and tables.perm.dtype == torch.int32
    assert tables.tiles.shape == (d - 2, slots, 4)
    assert tables.tiles.dtype == torch.int32 and tables.tiles.is_contiguous()
    perm, tiles = tables.perm.numpy(), tables.tiles.numpy()
    clamped = np.clip(idx, 0, n - 1)
    for k in range(d - 2):
        assert sorted(perm[k]) == list(range(b))
        seen = np.zeros(b, int)
        live = 0
        for step, mode, start, count in tiles[k]:
            if count == 0:  # a slot past the step's last tile
                assert (step, mode, start) == (0, 0, 0)
                continue
            live += 1
            assert step == k and 0 < count <= tile_p
            assert 0 <= mode < n and 0 <= start and start + count <= b
            rows = perm[k, start : start + count]
            assert np.all(clamped[rows, k + 1] == mode)
            seen[rows] += 1
        assert np.all(seen == 1)
        # no group is cut into more tiles than it needs
        sizes = np.bincount(clamped[:, k + 1], minlength=n)
        assert live == sum(-(-s // tile_p) for s in sizes) <= slots


@pytest.mark.parametrize("pattern,b,d,n,r,tile_p", [c for c in CASES if c[2] > 2])
def test_tile_list_covers_every_point_once(pattern, b, d, n, r, tile_p):
    rng = np.random.default_rng(b + d + n)
    _check_tables(_points(rng, pattern, b, d, n), n, tile_p)


def test_tables_clamp_out_of_range_modes():
    idx = np.array([[0, 7, -3, 1], [1, 2, 2, 0], [2, -1, 9, 2]])
    _check_tables(idx, 3, 2)


def test_sort_is_stable_and_wide_modes_sort():
    """Points of one mode keep their order (a stable sort); a mode size
    of tens of thousands leaves most groups empty."""
    idx = np.array([[0, 1, 0], [0, 0, 0], [0, 1, 0], [0, 0, 0], [0, 1, 0]])
    tables = tev.build_group_tables(torch.from_numpy(idx), 2, 4)
    assert tables.perm[0].tolist() == [1, 3, 0, 2, 4]
    big = np.array([[0, 40000, 0], [0, 3, 0], [0, 40000, 0]])
    _check_tables(big, 2**15 + 10000, 32)


@settings(max_examples=40, deadline=None)
@given(
    b=st.integers(1, 64),
    d=st.integers(3, 6),
    n=st.integers(1, 5),
    r=st.integers(1, 8),
    tile_p=st.sampled_from([1, 2, 4, 32]),
    seed=st.integers(0, 2**16),
)
def test_grouped_plain_hypothesis(b, d, n, r, tile_p, seed):
    rng = np.random.default_rng(seed)
    cores = _train(rng, d, n, r, np.float64)
    idx = rng.integers(0, n, (b, d))
    _check_tables(idx, n, tile_p)
    got = tev.tt_evaluate_grouped_plain(*_torch(cores), torch.from_numpy(idx), tile_p)
    plain = tev.tt_evaluate_plain(*_torch(cores), torch.from_numpy(idx))
    assert np.abs(got.numpy() - plain.numpy()).max() <= 1e-12 * max(
        np.abs(plain.numpy()).max(), 1e-300
    )
