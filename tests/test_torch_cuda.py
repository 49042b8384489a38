"""The port's CUDA kernels on a card: against their plain versions, the
routing through them, and the wrappers' refusals.

Every test needs a CUDA device (marker ``cuda``) and skips without one.
This file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances: 1e-4 (f32) / 1e-10 (f64) of the problem's scale, as in
``chip_smoke.py``; sums run in another order than cuBLAS's.
"""

import math

import numpy as np
import pytest
import torch

from tensor_networks_tpu_torch import Index, TensorNetwork
from tensor_networks_tpu_torch.kernels import evaluate as tev
from tensor_networks_tpu_torch.kernels import zipper as tzp
from tensor_networks_tpu_torch.ops import packed as tpk

pytestmark = pytest.mark.cuda
TOL = {torch.float32: 1e-4, torch.float64: 1e-10}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda:0")


def _train(g, d, n, r, dtype, dev, n0=None, nl=None):
    first = torch.randn((n0 or n, r), generator=g, dtype=torch.float64)
    mids = torch.randn((d - 2, r, n, r), generator=g, dtype=torch.float64)
    last = torch.randn((r, nl or n), generator=g, dtype=torch.float64)
    mids /= math.sqrt(n * r)
    return [x.to(dev, dtype) for x in (first, mids, last)]


def _f64(cores):
    return [None if x is None else x.double() for x in cores]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize(
    "d,n,ra,rb", [(2, 4, 3, 5), (3, 1, 1, 1), (5, 3, 65, 7), (4, 2, 130, 129)]
)
def test_zipper_kernel_matches_plain(dev, dtype, d, n, ra, rb):
    g = torch.Generator().manual_seed(d + ra)
    a = _train(g, d, n, ra, dtype, dev, n0=n + 1, nl=n + 2)
    b = _train(g, d, n, rb, dtype, dev, n0=n + 1, nl=n + 2)
    if d == 2:
        a[1] = b[1] = None
    a64, b64 = _f64(a), _f64(b)
    na = math.sqrt(tzp.tt_inner_plain(*a64, *a64).item())
    nb = math.sqrt(tzp.tt_inner_plain(*b64, *b64).item())
    for x, y, x64, y64, scale in ((a, b, a64, b64, na * nb), (a, a, a64, a64, na * na)):
        ref = tzp.tt_inner_plain(*x64, *y64).item()
        got = tzp.tt_inner_cuda(*x, *y)
        assert got.dtype == dtype and got.shape == ()
        assert abs(got.item() - ref) <= TOL[dtype] * scale


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("d,n,r,b", [(2, 3, 4, 1), (5, 4, 129, 33), (6, 7, 300, 70)])
def test_evaluate_kernel_matches_plain(dev, dtype, d, n, r, b):
    g = torch.Generator().manual_seed(d * r)
    first, mids, last = _train(g, d, n, r, dtype, dev)
    mids = mids * math.sqrt(n)  # point values O(1)
    if d == 2:
        mids = None
    idx = torch.randint(0, n, (b, d), generator=g, dtype=torch.int32).to(dev)
    ref = tev.tt_evaluate_plain(*_f64([first, mids, last]), idx)
    got = tev.tt_evaluate_cuda(first, mids, last, idx)
    assert got.dtype == dtype and got.shape == (b,)
    assert (got.double() - ref).abs().max() <= TOL[dtype] * ref.abs().max()


def test_main_path_routes_through_the_kernels(dev):
    g = torch.Generator(device=dev).manual_seed(0)
    inds = [Index(f"x{k}", 4) for k in range(6)]
    a = TensorNetwork.rand_tt(inds, [5] * 5, device=dev, generator=g)
    pa = tpk.pack(a)
    before = (tzp.tt_inner_cuda.launches, tev.tt_evaluate_cuda.launches)
    cores = [x.clone().requires_grad_(True) for x in pa]
    out = tpk.inner(tpk.PackedTT(*cores), pa)
    out.backward()
    pts = np.random.default_rng(1).integers(0, 4, (50, 6))
    pts[0, 0] = 9  # clamps to 3
    got = a.evaluate(inds, pts)
    assert tzp.tt_inner_cuda.launches == before[0] + 1
    assert tev.tt_evaluate_cuda.launches == before[1] + 1

    dense = a.contract().value.cpu().numpy()
    ref = dense[tuple(np.clip(pts, 0, 3).T)]
    assert np.abs(got - ref).max() <= 1e-10 * np.abs(ref).max()
    assert math.isclose(out.item(), float((dense * dense).sum()), rel_tol=1e-10)
    # the backward is autograd of the plain zipper on the same cores
    plain = [x.clone().requires_grad_(True) for x in pa]
    tzp.tt_inner_plain(*plain, *pa).backward()
    for c, p in zip(cores, plain):
        assert torch.allclose(c.grad, p.grad, rtol=1e-12, atol=0)


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    g = torch.Generator().manual_seed(3)
    f, m, l = _train(g, 4, 3, 5, torch.float32, dev)
    idx = torch.zeros((4, 4), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        tzp.tt_inner_cuda(f, m.transpose(1, 3), l, f, m, l)
    with pytest.raises(ValueError, match="dtype"):
        tzp.tt_inner_cuda(f.half(), m.half(), l.half(), f.half(), m.half(), l.half())
    with pytest.raises(ValueError, match="device and dtype"):
        tzp.tt_inner_cuda(f, m, l, f.cpu(), m, l)
    big = torch.zeros((3, 513), device=dev)
    with pytest.raises(ValueError, match="512"):
        tzp.tt_inner_cuda(big, None, big.T.contiguous(), big, None, big.T.contiguous())
    with pytest.raises(ValueError, match="int32"):
        tev.tt_evaluate_cuda(f, m, l, idx.long())
    with pytest.raises(ValueError, match="shape"):
        tev.tt_evaluate_cuda(f, m, l, idx[:, :3].contiguous())
