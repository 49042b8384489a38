"""Parity of the port's kernel modules with the JAX package's kernels.

The plain PyTorch versions of H1 (zipper) and H2 (evaluate) get the same
NumPy inputs as the JAX functions they stand in for: the XLA scan forms
in float64 (rtol 1e-12, roundoff of a few dozen FMAs), and the TPU
kernels -- Pallas in interpret mode on the CPU, the ragged evaluator
through XLA:CPU -- in float32 (1e-5, f32 accumulation-order noise).  The
CUDA kernels themselves run only on a card (tests/test_torch_cuda.py and
chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensor_networks_tpu.kernels.pallas_ops import (
    pad_train,
    tt_evaluate_pallas,
    tt_inner_pallas,
    tt_inner_pallas_fused,
)
from tensor_networks_tpu.kernels.ragged_eval import tt_evaluate_ragged
from tensor_networks_tpu.ops import packed as jpk
from tensor_networks_tpu.ops.fast import tt_inner_fn
from tensor_networks_tpu.parallel.sharded import tt_evaluate_batched
from tensor_networks_tpu_torch.kernels import evaluate as tev
from tensor_networks_tpu_torch.kernels import zipper as tzp
from tensor_networks_tpu_torch.ops import packed as tpk

# The suite runs in several worker processes on the CPU: torch's own
# thread pool would spin on the cores the other workers need.
torch.set_num_threads(1)


def _train(rng, d, n, r, dtype):
    """(first, mids, last) as NumPy arrays; mids scaled to keep values O(1)."""
    first = rng.standard_normal((n, r))
    mids = rng.standard_normal((d - 2, r, n, r)) / np.sqrt(r)
    last = rng.standard_normal((r, n))
    return [x.astype(dtype) for x in (first, mids, last)]


def _both(arrays):
    return [jnp.asarray(x) for x in arrays], [torch.from_numpy(x) for x in arrays]


# (d, n, r_a, r_b): mixed ranks, and the shortest train with middle cores
ZIP_CASES = [(5, 4, 3, 5), (3, 6, 4, 4)]


@pytest.mark.parametrize("d,n,ra,rb", ZIP_CASES + [(6, 3, 7, 2)])
def test_zipper_plain_matches_scan_f64(d, n, ra, rb):
    rng = np.random.default_rng(d * 100 + ra)
    (ja, ta), (jb, tb) = _both(_train(rng, d, n, ra, np.float64)), _both(
        _train(rng, d, n, rb, np.float64)
    )
    ref = float(tt_inner_fn(True)(*ja, *jb))
    got = tzp.tt_inner_plain(*ta, *tb)
    assert got.dtype == torch.float64
    assert np.isclose(got.item(), ref, rtol=1e-12, atol=0)


def test_zipper_plain_d2_matches_scan():
    rng = np.random.default_rng(3)
    fa, fb = rng.standard_normal((4, 3)), rng.standard_normal((4, 2))
    la, lb = rng.standard_normal((3, 5)), rng.standard_normal((2, 5))
    ref = float(
        tt_inner_fn(False)(*map(jnp.asarray, (fa, jnp.zeros(0), la, fb,
                                              jnp.zeros(0), lb)))
    )
    got = tzp.tt_inner_plain(
        *map(torch.from_numpy, (fa,)), None, torch.from_numpy(la),
        torch.from_numpy(fb), None, torch.from_numpy(lb),
    )
    assert np.isclose(got.item(), ref, rtol=1e-12, atol=0)


@pytest.mark.parametrize("kernel", ["K1", "K2"])
@pytest.mark.parametrize("d,n,ra,rb", ZIP_CASES)
def test_zipper_plain_matches_pallas_f32(kernel, d, n, ra, rb):
    rng = np.random.default_rng(d * 10 + rb)
    a, b = _train(rng, d, n, ra, np.float32), _train(rng, d, n, rb, np.float32)
    (ja, ta), (jb, tb) = _both(a), _both(b)
    if kernel == "K1":
        ref = float(tt_inner_pallas(*ja, *jb))
    else:
        ref = float(tt_inner_pallas_fused(*pad_train(*ja), *pad_train(*jb)))
    got = tzp.tt_inner_plain(*ta, *tb)
    assert got.dtype == torch.float32
    assert np.isclose(got.item(), ref, rtol=1e-5, atol=0)


def _points(rng, pattern, b, d, n):
    if pattern == "random":
        return rng.integers(0, n, (b, d))
    if pattern == "one-mode":  # every point in one mode group at every step
        return np.full((b, d), n - 2)
    # empty mode groups: only the two extreme modes are ever used
    return rng.choice([0, n - 1], size=(b, d))


PATTERNS = ["random", "one-mode", "empty-groups"]


@pytest.mark.parametrize("pattern", PATTERNS)
def test_evaluate_plain_matches_batched_f64(pattern):
    rng = np.random.default_rng(11)
    d, n, r = 7, 6, 5
    (jc, tc) = _both(_train(rng, d, n, r, np.float64))
    idx = _points(rng, pattern, 300, d, n)
    ref = np.asarray(tt_evaluate_batched(*jc, jnp.asarray(idx)))
    got = tev.tt_evaluate_plain(*tc, torch.from_numpy(idx)).numpy()
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=0)


@pytest.mark.parametrize("kernel", ["K3", "K4"])
@pytest.mark.parametrize("pattern", PATTERNS)
def test_evaluate_plain_matches_tpu_kernels_f32(kernel, pattern):
    rng = np.random.default_rng(12)
    d, n, r = 8, 7, 6
    (jc, tc) = _both(_train(rng, d, n, r, np.float32))
    idx = _points(rng, pattern, 257, d, n)
    jidx = jnp.asarray(idx, jnp.int32)
    if kernel == "K3":
        ref = np.asarray(tt_evaluate_pallas(*jc, jidx, precision="highest"))
    else:
        ref = np.asarray(tt_evaluate_ragged(*jc, jidx, precision="highest"))
    got = tev.tt_evaluate_plain(*tc, torch.from_numpy(idx)).numpy()
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


def test_packed_evaluate_clamps_like_jax():
    """Out-of-range indices clamp exactly as the JAX packed.evaluate
    clamps them (above range, == n, negative, in first/middle/last)."""
    rng = np.random.default_rng(13)
    d, n, r = 6, 5, 4
    (jc, tc) = _both(_train(rng, d, n, r, np.float64))
    idx = rng.integers(0, n, (64, d))
    idx[3, 0] = 99
    idx[7, 2] = n
    idx[11, -1] = -3
    idx[12, 3] = -1
    ref = np.asarray(jpk.evaluate(jpk.PackedTT(*jc), jnp.asarray(idx)))
    got = tpk.evaluate(tpk.PackedTT(*tc), torch.from_numpy(idx)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=0)


def test_cpu_tensors_take_the_plain_versions():
    """CPU tensors route to the plain versions and launch nothing; the
    CUDA wrappers refuse CPU tensors instead of falling back."""
    rng = np.random.default_rng(14)
    _, (f, m, l) = _both(_train(rng, 4, 3, 2, np.float64))
    idx = torch.zeros((5, 4), dtype=torch.int32)
    before = (tzp.tt_inner_cuda.launches, tev.tt_evaluate_cuda.launches)
    assert torch.isclose(
        tzp.tt_inner(f, m, l, f, m, l), tzp.tt_inner_plain(f, m, l, f, m, l)
    )
    assert torch.equal(
        tev.tt_evaluate(f, m, l, idx), tev.tt_evaluate_plain(f, m, l, idx)
    )
    assert (tzp.tt_inner_cuda.launches, tev.tt_evaluate_cuda.launches) == before
    with pytest.raises(ValueError, match="CUDA"):
        tzp.tt_inner_cuda(f, m, l, f, m, l)
    with pytest.raises(ValueError, match="CUDA"):
        tev.tt_evaluate_cuda(f, m, l, idx)
    with pytest.raises(ValueError, match="precision"):
        tzp.tt_inner(f, m, l, f, m, l, precision="bf16")


# ---- H1's routing rule and the fused step's band plan (pure Python) ----


@pytest.mark.parametrize(
    "ra,rb,fused",
    [(1, 1, True), (100, 100, True), (100, 64, True), (128, 128, True),
     (129, 128, False), (128, 129, False), (256, 256, False), (512, 300, False)],
)
def test_zipper_route_by_rank(ra, rb, fused):
    assert tzp.FUSED_MAX_RANK >= 128
    assert tzp.takes_fused_route(ra, rb) is fused


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize(
    "ra,rb,n,sms",
    [(100, 100, 32, 132), (1, 1, 1, 132), (37, 37, 5, 132), (100, 64, 32, 132),
     (64, 100, 2, 132), (128, 128, 32, 132), (128, 128, 300, 132),
     (100, 100, 1, 132), (5, 128, 3, 8), (126, 3, 7, 114)],
)
def test_band_plan_covers_every_row_once(dtype, ra, rb, n, sms):
    plan = tzp.band_plan(ra, rb, n, dtype, sms)
    bands = tzp.band_rows(ra, plan.nbands)
    rows = [r for start, stop in bands for r in range(start, stop)]
    assert rows == list(range(ra))  # every a2 row in exactly one band, in order
    assert all(stop > start for start, stop in bands)  # no band is empty
    assert all(start % 4 == 0 for start, _ in bands)
    assert plan.tmax % 4 == 0 and plan.tmax >= max(b - a for a, b in bands)
    cols = 16 // torch.empty((), dtype=dtype).element_size()
    assert plan.threads % 32 == 0 and plan.threads <= 256
    assert plan.threads >= -(-rb // cols) * plan.tmax // 4
    assert plan.smem <= 232448


def test_band_plan_at_the_main_shape():
    """d=50, n=32, r=100 on 132 SMs: 4 bands of 28/24 rows, 128 blocks
    (8 bands would also fill the card, at twice the reads of W and B_i)."""
    plan = tzp.band_plan(100, 100, 32, torch.float32, 132)
    assert (plan.nbands, plan.tmax, plan.threads) == (4, 28, 192)
    assert tzp.band_rows(100, 4) == [(0, 28), (28, 52), (52, 76), (76, 100)]
    assert tzp.band_plan(100, 100, 32, torch.float64, 132).nbands == 8


def test_zipper_device_launches():
    assert tzp.device_launches(48, True) == 98  # 1 + 2 (d-2) + 1 at d=50
    # the chain at d=50: prologue, 48 x (two tile_gemm + the split-K
    # zip_reduce), zip_last on several blocks and zip_sum, at each shape
    # the chain is timed at
    for ra, rb, dtype in ((256, 256, torch.float32), (512, 300, torch.float32),
                          (200, 100, torch.float64)):
        splits = tzp.chain_plan(ra, rb, 32, dtype, 132).splits
        assert tzp.device_launches(48, False, splits) == 147
    assert tzp.device_launches(48, False, splits=1) == 99
    assert tzp.device_launches(0, True) == 2
    assert tzp.device_launches(0, False) == 3


@pytest.mark.parametrize("r", [3, tzp.FUSED_MAX_RANK + 1])
def test_cpu_inner_takes_the_plain_zipper_on_either_side_of_the_route(r):
    rng = np.random.default_rng(15)
    _, (f, m, l) = _both(_train(rng, 3, 2, r, np.float64))
    counts = (tzp.tt_inner_cuda.launches, tzp.tt_inner_cuda.fused,
              tzp.tt_inner_chain_cuda.launches)
    assert torch.equal(tzp.tt_inner(f, m, l, f, m, l), tzp.tt_inner_plain(f, m, l, f, m, l))
    assert torch.equal(tpk.inner(tpk.PackedTT(f, m, l), tpk.PackedTT(f, m, l)),
                       tzp.tt_inner_plain(f, m, l, f, m, l))
    assert (tzp.tt_inner_cuda.launches, tzp.tt_inner_cuda.fused,
            tzp.tt_inner_chain_cuda.launches) == counts
    with pytest.raises(ValueError, match="CUDA"):
        tzp.tt_inner_chain_cuda(f, m, l, f, m, l)


CHAIN_DTYPES = [torch.float32, torch.float64, torch.bfloat16, torch.float16]


@pytest.mark.parametrize("dtype", CHAIN_DTYPES)
@pytest.mark.parametrize(
    "ra,rb",
    [(129, 131), (131, 129), (256, 300), (300, 256), (200, 129), (129, 1024),
     (513, 1024), (1024, 513)],
)
def test_chain_plan_fits_and_splits_k_once(dtype, ra, rb):
    """Every plan fits one block, takes the DMMA tile exactly in f64, and
    its splits cover K = r_b n once, in order, none empty, each of whole
    K-slabs and at least 12 of them where K allows."""
    for n in (1, 2, 32):
        plan = tzp.chain_plan(ra, rb, n, dtype, 132)
        assert plan.smem <= 232448 and plan.threads <= 1024
        assert (plan.tile == tzp._DMMA_TILE) == (dtype == torch.float64)
        assert plan.tile in tzp.CHAIN_TILES
        k = rb * n
        ranges = tzp.split_ranges(k, plan.kchunk)
        assert len(ranges) == plan.splits >= 1
        assert ranges[0][0] == 0 and ranges[-1][1] == k
        assert all(stop > start for start, stop in ranges)
        assert all(b[0] == a[1] for a, b in zip(ranges, ranges[1:]))
        assert plan.kchunk % 16 == 0
        assert plan.splits == 1 or plan.kchunk >= 12 * 16


def test_chain_plan_at_the_timed_shapes():
    """d=50, n=32 on 132 SMs, one float block an SM. (256, 256): 2 x 64
    tiles of 128 x 128 for t = W^T A_k, 4 tiles x 32 splits of 16 K-slabs
    for W' = t^T B_k. (512, 300): 12 tiles x 11 splits of 55 slabs.
    (200, 100) f64: 64 x 64 DMMA tiles, two blocks an SM, 8 tiles x 16
    splits of 13 slabs."""
    assert tzp.chain_plan(256, 256, 32, torch.float32, 132) == (0, 32, 256, 256, 118784)
    assert tzp.chain_plan(512, 300, 32, torch.float32, 132) == (0, 11, 880, 256, 118784)
    assert tzp.chain_plan(200, 100, 32, torch.float64, 132) == (1, 16, 208, 128, 69632)
