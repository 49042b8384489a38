"""The port's CUDA kernels on a card: against their plain versions, the
routing through them, and the wrappers' refusals.

Every test needs a CUDA device (marker ``cuda``) and skips without one.
This file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances: 1e-4 (f32) / 1e-10 (f64) of the problem's scale, as in
``chip_smoke.py``; sums run in another order than cuBLAS's.  Cores
stored in bfloat16 or float16 are summed in float32 and the result is
rounded to the cores' dtype, so they are held to 8e-3 (bf16, 8 bits of
mantissa) and 1e-3 (f16, 11 bits) of the scale, against the f64 plain
result on the same (rounded) cores.
"""

import math

import numpy as np
import pytest
import torch

from tensor_networks_tpu_torch import Index, Tensor, TensorNetwork, tt_inner_fast
from tensor_networks_tpu_torch.kernels import evaluate as tev
from tensor_networks_tpu_torch.kernels import zipper as tzp
from tensor_networks_tpu_torch.ops import packed as tpk

pytestmark = pytest.mark.cuda
TOL = {torch.float32: 1e-4, torch.float64: 1e-10, torch.bfloat16: 8e-3,
       torch.float16: 1e-3}


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


# (d, n, r_a, r_b): d = 2 and 3, n = 1 and 300, mixed ranks, the odd
# rank (scalar copies), and the two sides of the fused route's rank limit
ZIP_CASES = [
    (2, 4, 3, 5), (3, 1, 1, 1), (5, 3, 65, 7), (4, 2, 130, 129),
    (3, 6, 9, 4), (4, 1, 100, 100), (4, 300, 24, 20), (5, 32, 100, 64),
    (5, 5, 37, 37), (4, 4, tzp.FUSED_MAX_RANK, tzp.FUSED_MAX_RANK),
    (4, 4, tzp.FUSED_MAX_RANK + 1, tzp.FUSED_MAX_RANK),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("d,n,ra,rb", ZIP_CASES)
def test_zipper_kernel_matches_plain(dev, dtype, d, n, ra, rb):
    """Both routes against the f64 plain zipper; two calls of each give
    the same bits; the router takes the fused route up to the limit."""
    g = torch.Generator().manual_seed(d + n + ra + rb)
    a = _train(g, d, n, ra, dtype, dev, n0=n + 1, nl=n + 2)
    b = _train(g, d, n, rb, dtype, dev, n0=n + 1, nl=n + 2)
    if d == 2:
        a[1] = b[1] = None
    a64, b64 = _f64(a), _f64(b)
    na = math.sqrt(tzp.tt_inner_plain(*a64, *a64).item())
    nb = math.sqrt(tzp.tt_inner_plain(*b64, *b64).item())
    fused = tzp.takes_fused_route(ra, rb)
    for x, y, x64, y64, scale in ((a, b, a64, b64, na * nb), (a, a, a64, a64, na * na)):
        ref = tzp.tt_inner_plain(*x64, *y64).item()
        before = tzp.tt_inner_cuda.fused
        tzp.tt_inner_cuda(*x, *y)
        assert tzp.tt_inner_cuda.fused == before + fused
        if fused:
            assert tzp.tt_inner_cuda.last_device_launches == 2 + 2 * (d - 2)
        for route in (tzp.tt_inner_cuda, tzp.tt_inner_chain_cuda):
            got = route(*x, *y)
            assert got.dtype == dtype and got.shape == ()
            assert abs(got.item() - ref) <= TOL[dtype] * scale
            assert torch.equal(got, route(*x, *y))


def _view_at_offset(x, offset):
    """x copied into a buffer ``offset`` values in: a contiguous view
    whose rows are not 16-byte aligned (the chain's narrow copies)."""
    if x is None:
        return None
    buf = torch.empty(x.numel() + offset, dtype=x.dtype, device=x.device)
    view = buf[offset:].view(x.shape)
    view.copy_(x)
    return view


# above the fused route: odd ranks (129, 131: no 16-byte rows), the timed
# (256, 300), and past the old 512 limit; r_a != r_b, each way round
CHAIN_RANKS = [(129, 131), (131, 129), (256, 300), (300, 256), (513, 1024), (1024, 513)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("d,n", [(2, 1), (3, 2), (6, 32)])
@pytest.mark.parametrize("ra,rb", CHAIN_RANKS)
def test_chain_matches_plain_above_the_fused_route(dev, dtype, d, n, ra, rb):
    """The chain's tile GEMM against the f64 plain zipper on the same
    (rounded) cores, at aligned cores and at views 4 bytes in (8 for
    f64), each twice for the same bits; the router sends these ranks to
    the chain.  Trains scaled to |a| ~ 1 so f16 holds them."""
    g = torch.Generator().manual_seed(ra + 7 * rb + 31 * n + d)
    cores = []
    for r in (ra, rb):
        ends = (n * n * r) ** -0.25
        first, mids, last = _train(g, max(d, 3), n, r, torch.float64, dev,
                                   n0=n + 1, nl=n + 2)
        cores.append([first * ends, mids if d > 2 else None, last * ends])
    offset = max(1, 4 // torch.empty((), dtype=dtype).element_size())
    for shift in (0, offset):
        a, b = ([_view_at_offset(None if x is None else x.to(dtype), shift) for x in c]
                for c in cores)
        a64, b64 = _f64(a), _f64(b)
        na = math.sqrt(tzp.tt_inner_plain(*a64, *a64).item())
        nb = math.sqrt(tzp.tt_inner_plain(*b64, *b64).item())
        for x, y, x64, y64, scale in ((a, b, a64, b64, na * nb), (a, a, a64, a64, na * na)):
            ref = tzp.tt_inner_plain(*x64, *y64).item()
            chain, fused = tzp.tt_inner_chain_cuda.launches, tzp.tt_inner_cuda.fused
            got = tzp.tt_inner_cuda(*x, *y)
            assert (tzp.tt_inner_chain_cuda.launches, tzp.tt_inner_cuda.fused) == (chain + 1, fused)
            assert got.dtype == dtype and got.shape == ()
            assert abs(got.double().item() - ref) <= TOL[dtype] * scale
            assert torch.equal(got, tzp.tt_inner_chain_cuda(*x, *y))


def test_inner_entry_points_take_the_fused_route(dev):
    g = torch.Generator(device=dev).manual_seed(4)
    inds = [Index(f"x{k}", 4) for k in range(6)]
    a = TensorNetwork.rand_tt(inds, [5] * 5, generator=g)
    b = TensorNetwork.rand_tt(inds, [7] * 5, generator=g)
    pa, pb = tpk.pack(a), tpk.pack(b)
    before = (tzp.tt_inner_cuda.launches, tzp.tt_inner_cuda.fused,
              tzp.tt_inner_chain_cuda.launches)
    ip = tpk.inner(pa, pb)
    nrm = tpk.norm(pa)
    fast = tt_inner_fast(a, b)
    assert (tzp.tt_inner_cuda.launches, tzp.tt_inner_cuda.fused,
            tzp.tt_inner_chain_cuda.launches) == (
        before[0] + 3, before[1] + 3, before[2])
    assert tzp.tt_inner_cuda.last_device_launches == 2 + 2 * 4
    ref = tzp.tt_inner_plain(*pa, *pb).item()
    assert math.isclose(ip.item(), ref, rel_tol=1e-10)
    assert math.isclose(fast.item(), ref, rel_tol=1e-10)
    assert math.isclose(nrm.item() ** 2, tzp.tt_inner_plain(*pa, *pa).item(),
                        rel_tol=1e-10)


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


def _group_points(pattern, b, d, n, g):
    """Index patterns that stress the grouping tables."""
    if pattern == "one-mode":  # one group, many tiles of one slice
        idx = torch.randint(0, n, (b, d), generator=g, dtype=torch.int32)
        idx[:, 1:-1] = n - 1
        return idx
    if pattern == "distinct":  # b <= n: every group holds one point
        rows, steps = torch.arange(b)[:, None], torch.arange(d)[None, :]
        return ((rows + steps) % n).to(torch.int32)
    idx = torch.randint(0, n, (b, d), generator=g, dtype=torch.int32)
    if pattern == "skip-mode":  # mode 1 holds no point
        idx = torch.where(idx == 1, torch.zeros_like(idx), idx)
    return idx


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize(
    "d,n,r,b,pattern",
    [
        (6, 32, 100, 8192, "one-mode"),
        (7, 32, 100, 20, "distinct"),
        (5, 4, 100, 1, "random"),
        (5, 5, 37, tev.TILE_P + 1, "skip-mode"),
        (2, 6, 40, 500, "random"),
        (3, 6, 40, 500, "random"),
        (4, 4, 512, 300, "random"),
        (8, 2, 64, 777, "random"),
        (6, 300, 48, 2000, "random"),
    ],
)
def test_grouped_evaluate_cases(dev, dtype, d, n, r, b, pattern):
    """The grouped kernel at the shapes and index patterns that stress
    its tables and tiles; two calls give the same bits (no atomics)."""
    g = torch.Generator().manual_seed(d * r + b)
    first, mids, last = _train(g, max(d, 3), n, r, dtype, dev)
    mids = mids * math.sqrt(n) if d > 2 else None  # point values O(1)
    idx = _group_points(pattern, b, d, n, g).to(dev)
    ref = tev.tt_evaluate_plain(*_f64([first, mids, last]), idx)
    got = tev.tt_evaluate_cuda(first, mids, last, idx)
    assert got.dtype == dtype and got.shape == (b,)
    assert (got.double() - ref).abs().max() <= TOL[dtype] * ref.abs().max()
    assert torch.equal(got, tev.tt_evaluate_cuda(first, mids, last, idx))
    old = tev.tt_evaluate_per_point_cuda(first, mids, last, idx)
    assert (old.double() - ref).abs().max() <= TOL[dtype] * ref.abs().max()
    if d > 2:  # tables built once serve any train at the same points
        tables = tev.build_group_tables(idx, n)
        assert tables.perm.is_cuda and tables.tiles.is_cuda
        # the tile-list kernel against its torch version, exactly
        vals = torch.sort(idx[:, 1:-1].t().contiguous(), dim=1, stable=True)[0]
        slots = tev.max_tiles_per_step(b, n)
        assert torch.equal(
            tables.tiles, tev.group_tiles_plain(vals, n, tev.TILE_P, slots)
        )
        assert torch.equal(got, tev.tt_evaluate_cuda(first, mids, last, idx, tables))
    assert tev.tt_evaluate_cuda(first, mids, last, idx[:0]).shape == (0,)


def test_constructors_default_to_the_card(dev):
    inds = [Index(f"x{k}", 3) for k in range(4)]
    net = TensorNetwork.rand_tt(inds, [2, 2, 2])
    assert all(net.value(k).device == dev for k in range(4))
    meta, arrays = net.to_separated_dict()
    assert TensorNetwork.from_dict(net.to_dict()).value(0).device == dev
    assert TensorNetwork.from_separated_dict(meta, arrays).value(0).device == dev
    assert Tensor.from_dict(net.node_tensor(1).to_dict()).value.device == dev
    pk = tpk.from_numpy(np.zeros((3, 2)), np.zeros((2, 2, 3, 2)), np.zeros((2, 3)))
    assert all(x.device == dev for x in pk)
    on_cpu = TensorNetwork.rand_tt(inds, [2, 2, 2], device="cpu")
    assert on_cpu.value(0).device.type == "cpu"
    with pytest.raises(RuntimeError):  # a generator on another device
        TensorNetwork.rand_tt(inds, [2, 2, 2], generator=torch.Generator())


def test_main_path_routes_through_the_kernels(dev):
    g = torch.Generator(device=dev).manual_seed(0)
    inds = [Index(f"x{k}", 4) for k in range(6)]
    a = TensorNetwork.rand_tt(inds, [5] * 5, generator=g)
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
        tzp.tt_inner_cuda(f.int(), m.int(), l.int(), f.int(), m.int(), l.int())
    with pytest.raises(ValueError, match="dtype"):
        tev.tt_evaluate_cuda(f.int(), m.int(), l.int(), idx)
    with pytest.raises(ValueError, match="device and dtype"):
        tzp.tt_inner_cuda(f, m, l, f.cpu(), m, l)
    with pytest.raises(ValueError, match="shape"):  # la (r_a, nl) of another r
        tzp.tt_inner_cuda(f, m, l[:4].contiguous(), f, m, l)
    with pytest.raises(ValueError, match="one mode size"):  # the yardstick
        tev.tt_evaluate_per_point_cuda(f[:2].contiguous(), m, l, idx)
    with pytest.raises(ValueError, match="int32"):
        tev.tt_evaluate_cuda(f, m, l, idx.long())
    with pytest.raises(ValueError, match="shape"):
        tev.tt_evaluate_cuda(f, m, l, idx[:, :3].contiguous())
    other = tev.build_group_tables(idx[:3].contiguous(), 3)
    with pytest.raises(ValueError, match="grouping tables"):
        tev.tt_evaluate_cuda(f, m, l, idx, other)


def _net(g, inds, r, dtype, mid_scale, end_scale=1.0):
    """A random train on the card, its cores scaled, stored as dtype."""
    net = TensorNetwork.rand_tt(inds, [r] * (len(inds) - 1), generator=g)
    for k in range(len(inds)):
        t = net.node_tensor(k)
        s = mid_scale if 0 < k < len(inds) - 1 else end_scale
        t.update_val_size((t.value * s).to(dtype))
    return net


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("r", [513, 1024])
def test_ranks_above_512_through_the_entry_points(dev, dtype, r):
    """Ranks past the old 512 limit: the inner product takes the chain,
    evaluation the grouped kernel, through every entry point."""
    g = torch.Generator(device=dev).manual_seed(r)
    inds = [Index(f"x{k}", 8) for k in range(6)]
    a = _net(g, inds, r, dtype, 1 / math.sqrt(8 * r))
    b = _net(g, inds, r, dtype, 1 / math.sqrt(8 * r))
    pa, pb = tpk.pack(a), tpk.pack(b)
    a64, b64 = _f64(list(pa)), _f64(list(pb))
    na = math.sqrt(tzp.tt_inner_plain(*a64, *a64).item())
    nb = math.sqrt(tzp.tt_inner_plain(*b64, *b64).item())
    ref = tzp.tt_inner_plain(*a64, *b64).item()
    chain = tzp.tt_inner_chain_cuda.launches
    for got in (tpk.inner(pa, pb), tt_inner_fast(a, b)):
        assert got.dtype == dtype
        assert abs(got.item() - ref) <= TOL[dtype] * na * nb
    assert tzp.tt_inner_chain_cuda.launches == chain + 2
    assert abs(tpk.norm(pa).item() - na) <= TOL[dtype] * na
    assert torch.equal(tpk.inner(pa, pb), tpk.inner(pa, pb))

    # evaluation: mids scaled to keep point values O(1)
    e = _net(g, inds, r, dtype, 1 / math.sqrt(r))
    pe = tpk.pack(e)
    pts = torch.randint(0, 8, (300, 6), generator=g, device=dev)
    want = tev.tt_evaluate_plain(*_f64(list(pe)), pts)
    scale = want.abs().max().item()
    before = tev.tt_evaluate_cuda.launches
    got = tpk.evaluate(pe, pts)
    assert got.dtype == dtype
    assert (got.double() - want).abs().max().item() <= TOL[dtype] * scale
    assert torch.equal(got, tpk.evaluate(pe, pts))
    assert tev.tt_evaluate_cuda.launches == before + 2
    # the network's chain route packs rank r into the next power of two
    vals = e.evaluate(inds, pts.cpu().numpy())
    assert tev.tt_evaluate_cuda.launches > before + 2
    assert np.abs(vals - want.cpu().numpy()).max() <= TOL[dtype] * scale


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n0,n,nl", [(3, 8, 5), (32, 8, 1)])
def test_evaluate_takes_unequal_end_modes(dev, dtype, n0, n, nl):
    g = torch.Generator().manual_seed(n0 + nl)
    first, mids, last = _train(g, 6, n, 40, dtype, dev, n0=n0, nl=nl)
    mids = mids * math.sqrt(n)  # point values O(1)
    pk = tpk.PackedTT(first, mids, last)
    pts = torch.stack(
        [torch.randint(0, m, (500,), generator=g) for m in [n0] + [n] * 4 + [nl]],
        dim=1,
    ).to(dev)
    want = tev.tt_evaluate_plain(*_f64([first, mids, last]), pts)
    before = tev.tt_evaluate_cuda.launches
    got = tpk.evaluate(pk, pts)
    assert tev.tt_evaluate_cuda.launches == before + 1
    assert (got.double() - want).abs().max() <= TOL[dtype] * want.abs().max()
    assert torch.equal(got, tpk.evaluate(pk, pts))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("r", [37, 100, 129])
def test_half_trains_through_the_entry_points(dev, dtype, r):
    """bf16 and f16 cores run through the kernels' own 2-byte
    instantiations (r = 37: rows not 4-byte aligned; r = 129: the
    chain) and come back in their dtype."""
    g = torch.Generator(device=dev).manual_seed(r)
    inds = [Index(f"x{k}", 32) for k in range(6)]
    # |a| ~ 1: with mids scaled 1/sqrt(n r), |a|^2 ~ n^2 r |ends|^2, and
    # f16 holds nothing above 65504
    ends = (32 * 32 * r) ** -0.25
    a = _net(g, inds, r, dtype, 1 / math.sqrt(32 * r), ends)
    b = _net(g, inds, r, dtype, 1 / math.sqrt(32 * r), ends)
    pa, pb = tpk.pack(a), tpk.pack(b)
    assert pa.first.dtype == dtype
    a64, b64 = _f64(list(pa)), _f64(list(pb))
    na = math.sqrt(tzp.tt_inner_plain(*a64, *a64).item())
    nb = math.sqrt(tzp.tt_inner_plain(*b64, *b64).item())
    fused = tzp.tt_inner_cuda.fused
    for x, y, x64, y64, scale in ((pa, pb, a64, b64, na * nb), (pa, pa, a64, a64, na * na)):
        ref = tzp.tt_inner_plain(*x64, *y64).item()
        got = tpk.inner(x, y)
        assert got.dtype == dtype
        assert abs(got.item() - ref) <= TOL[dtype] * scale
        assert torch.equal(got, tpk.inner(x, y))
        chain = tzp.tt_inner_chain_cuda(*x, *y)
        assert chain.dtype == dtype
        assert abs(chain.item() - ref) <= TOL[dtype] * scale
    assert tzp.tt_inner_cuda.fused == fused + (4 if r <= tzp.FUSED_MAX_RANK else 0)
    assert abs(tpk.norm(pa).item() - na) <= TOL[dtype] * na
    fast = tt_inner_fast(a, b)
    assert fast.dtype == dtype
    assert abs(fast.item() - tzp.tt_inner_plain(*a64, *b64).item()) <= TOL[dtype] * na * nb

    e = _net(g, inds, r, dtype, 1 / math.sqrt(r))
    pe = tpk.pack(e)
    pts = torch.randint(0, 32, (1000, 6), generator=g, device=dev)
    want = tev.tt_evaluate_plain(*_f64(list(pe)), pts)
    scale = want.abs().max().item()
    got = tpk.evaluate(pe, pts)
    assert got.dtype == dtype
    assert (got.double() - want).abs().max().item() <= TOL[dtype] * scale
    assert torch.equal(got, tpk.evaluate(pe, pts))
    vals = e.evaluate(inds, pts.cpu().numpy())
    assert np.abs(vals - want.cpu().numpy()).max() <= TOL[dtype] * scale


def _on(net, device):
    return TensorNetwork.from_separated_dict(*net.to_separated_dict(), device=device)


@pytest.mark.parametrize("method", ["svd", "gram", "cholqr2", "twosided", "prefix"])
def test_round_methods_on_the_card_match_the_cpu(dev, method):
    """Every ``tt_round_fixed`` sweep on CUDA cores, in f64: the port's
    CPU result's ranks, and its represented tensor within 1e-10, on a
    doubled train (1e-8) and on a + 1e-6 b (1e-3)."""
    from tensor_networks_tpu_torch.ops import fast as tfast

    g = torch.Generator().manual_seed(7)
    inds = [Index(f"x{k}", 5) for k in range(7)]
    a = TensorNetwork.rand_tt(inds, [4] * 6, device="cpu", generator=g)
    b = TensorNetwork.rand_tt(inds, [4] * 6, device="cpu", generator=g)
    b.scale(1e-6)
    for net, eps, want in ((a + a, 1e-8, [4] * 6), (a + b, 1e-3, [4] * 6)):
        cpu, cpu_ranks = tfast.tt_round_fixed(net, eps, method=method)
        card, card_ranks = tfast.tt_round_fixed(_on(net, dev), eps, method=method)
        assert card_ranks == cpu_ranks == want
        x = card.contract().value.cpu()
        y = cpu.contract().value
        assert x.dtype == torch.float64
        assert ((x - y).norm() / y.norm()).item() <= 1e-10


def test_evaluate_dw_launches_the_f64_kernel_and_packs_once(dev, monkeypatch):
    """``precision="dw"`` on an f32 chain on the card: H2's float64
    instantiation, values within 1e-12 of an f64 plain evaluation of the
    same cores, one f64 pack for repeated calls; the default precision
    takes the f32 instantiation."""
    g = torch.Generator(device=dev).manual_seed(5)
    inds = [Index(f"x{k}", 6) for k in range(5)]
    a = TensorNetwork.rand_tt(inds, [7] * 4, dtype=torch.float32, generator=g)
    pts = np.random.default_rng(2).integers(0, 6, (300, 5))
    packs = []
    real_pack = tpk.pack_ragged
    monkeypatch.setattr(tpk, "pack_ragged",
                        lambda *args: packs.append(args) or real_pack(*args))
    by_dtype = dict(tev.tt_evaluate_cuda.launches_by_dtype)
    got = [a.evaluate(inds, pts, precision="dw") for _ in range(3)]
    assert tev.tt_evaluate_cuda.launches_by_dtype["f64"] == by_dtype["f64"] + 3
    assert len(packs) == 1 and packs[0][1] == torch.float64
    a.evaluate(inds, pts)
    assert tev.tt_evaluate_cuda.launches_by_dtype["f32"] == by_dtype["f32"] + 1
    ref = tev.tt_evaluate_plain(*_f64(tpk.pack(a)), torch.from_numpy(pts).to(dev))
    ref = ref.cpu().numpy()
    for x in got:
        assert np.abs(x - ref).max() <= 1e-12 * np.abs(ref).max()


def test_packed_additions_on_the_card_match_the_cpu(dev):
    """evaluate_ensemble (one H2 call for the ensemble), tt_evaluate_fast
    (forward and gradient), evaluate_dw, add and norm_exact on CUDA
    cores against the same calls on CPU cores, f64, 1e-10."""
    g = torch.Generator().manual_seed(11)
    cpu = [tpk.PackedTT(*_train(g, 5, 4, 6, torch.float64, "cpu")) for _ in range(3)]
    card = [tpk.PackedTT(*(x.to(dev) for x in t)) for t in cpu]
    pts = torch.randint(-1, 5, (3, 40, 5), generator=g)

    def close(x, y, tol=1e-10):
        x, y = torch.as_tensor(x).cpu(), torch.as_tensor(y).cpu()
        assert (x - y).abs().max() <= tol * y.abs().max()

    before = tev.tt_evaluate_cuda.launches
    close(tpk.evaluate_ensemble(card, pts.to(dev)), tpk.evaluate_ensemble(cpu, pts))
    assert tev.tt_evaluate_cuda.launches == before + 1
    close(tpk.evaluate_dw(card[0], pts[0]), tpk.evaluate_dw(cpu[0], pts[0]))
    close(tpk.norm_exact(tpk.add(*card)), tpk.norm_exact(tpk.add(*cpu)))
    grads = []
    for t in (card[0], cpu[0]):
        cores = [x.clone().requires_grad_(True) for x in t]
        tpk.tt_evaluate_fast(*cores, pts[0].to(t.first.device)).sum().backward()
        grads.append([c.grad for c in cores])
    for x, y in zip(*grads):
        close(x, y)


def test_maxvol_device_on_the_card(dev):
    """maxvol_device on a CUDA tensor stays on the card and gives a
    dominant (max|B| <= 1.05), interpolating submatrix whose volume is
    within 1% of the host loop's."""
    import importlib

    mv = importlib.import_module("tensor_networks_tpu_torch.cross.maxvol")
    a = np.linalg.qr(np.random.default_rng(4).standard_normal((768, 24)))[0]
    rows, b = mv.maxvol_device(torch.from_numpy(a).to(dev))
    assert rows.is_cuda and b.is_cuda
    rows, b = rows.cpu().numpy(), b.cpu().numpy()
    assert np.abs(b).max() <= 1.05 + 1e-8
    assert np.abs(b @ a[rows] - a).max() <= 1e-10
    host = abs(np.linalg.det(a[mv.maxvol(a)[0]]))
    assert abs(abs(np.linalg.det(a[rows])) - host) <= 0.01 * host


def test_cross_on_the_card(dev):
    """TT cross (NORM check through the packed QR-sweep norm on the
    card) and Tucker cross of Ackley built by the runners' default
    device, to the reference suite's 1e-4 on the full grid."""
    from tensor_networks_tpu_torch import cross

    class Ackley(cross.CachedFunc):
        def _run(self, args):
            y1 = -20 * np.exp(-0.2 * np.sqrt(np.sum(args**2, axis=1) / args.shape[1]))
            y2 = -np.exp(np.sum(np.cos(2 * np.pi * args), axis=1) / args.shape[1])
            return y1 + y2 + 20 + np.exp(1.0)

    inds = [Index(c, s, tuple(np.linspace(-32.768, 32.768, s)))
            for c, s in (("i", 8), ("j", 10), ("k", 12), ("l", 20))]
    grid = np.stack(np.meshgrid(*[range(i.size) for i in inds]), -1).reshape(-1, 4)
    for runner in (cross.TTCrossRunner(), cross.TuckerCrossRunner()):
        np.random.seed(4)
        func = Ackley(inds)
        net = runner.run(func, eps=1e-4)
        assert all(net.value(n).is_cuda for n in net.network.nodes)
        real, approx = func(grid), net.evaluate(func.indices, grid)
        assert np.linalg.norm(real - approx) / np.linalg.norm(real) <= 1e-4


# the QTT shapes of TT-GMRES: n=2, d=14 and 22, the Krylov ranks
QTT_ZIP_CASES = [(d, r) for d in (14, 22) for r in (4, 8, 64)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("d,r", QTT_ZIP_CASES)
def test_zipper_kernel_at_qtt_shapes(dev, dtype, d, r):
    """H1 at n=2 (its grid runs 2 blocks per band) against the f64 plain
    zipper, on the fused route; two calls give the same bits."""
    g = torch.Generator().manual_seed(d * 100 + r)
    a = _train(g, d, 2, r, dtype, dev)
    b = _train(g, d, 2, r, dtype, dev)
    a64, b64 = _f64(a), _f64(b)
    scale = math.sqrt(tzp.tt_inner_plain(*a64, *a64).item()
                      * tzp.tt_inner_plain(*b64, *b64).item())
    ref = tzp.tt_inner_plain(*a64, *b64).item()
    before = tzp.tt_inner_cuda.fused
    got = tzp.tt_inner_cuda(*a, *b)
    assert tzp.tt_inner_cuda.fused == before + 1
    assert torch.equal(got, tzp.tt_inner_cuda(*a, *b))
    assert abs(got.item() - ref) <= TOL[dtype] * scale


def test_gmres_packed_on_the_card_matches_the_cpu(dev):
    """gmres_packed on the K=10 screened-Poisson QTT system, f64, on the
    card and on the CPU: both under the residual bar (1e-8 of |rhs|),
    the iterates within 1e-7 of each other."""
    from tensor_networks_tpu_torch.ops import qtt

    out = {}
    for where in (dev, "cpu"):
        op = qtt.qtt_screened_laplacian(10, delta=1.0, device=where)
        rhs = qtt.qtt_exponential(10, c=3.0, device=where)
        x, resid = tpk.gmres_packed(op, rhs, tpk.pad_rank(rhs, 4), eps=1e-9, rank=8)
        rhs_norm = float(tpk.norm_exact(rhs))
        assert resid / rhs_norm < 1e-8
        assert x.first.device.type == torch.device(where).type
        out[str(where)] = (tpk.PackedTT(*(t.cpu() for t in x)), rhs_norm)
    (xc, norm_c), (xg, _) = out["cpu"], out[str(dev)]
    diff = tpk.add(xc, tpk.scale(xg, -1.0))
    assert float(tpk.norm_exact(diff)) <= 1e-7 * float(tpk.norm_exact(xc))


def test_operator_constructors_on_the_card(dev):
    """ttop_identity and the QTT constructors default to the card and give
    contiguous cores with no stride-0 axis."""
    from tensor_networks_tpu_torch.ops import qtt

    built = [tpk.ttop_identity(6, 2), qtt.qtt_screened_laplacian(8),
             qtt.qtt_shift(8), qtt.qtt_screened_laplacian_2d(4),
             qtt.qtt_exponential(8), qtt.qtt_trig(8, 3.0),
             qtt.qtt_polynomial(8, [1.0, 2.0])]
    for cores in built:
        for x in cores:
            assert x.device == dev and x.is_contiguous() and 0 not in x.stride()


def test_min_norm_local_solve_on_a_singular_matrix(dev):
    """The dense ALS local solve on a singular system (rank 5 of 8, f64)
    gives the minimum-norm least-squares solution on the card, as on the
    CPU and as the pseudo-inverse does."""
    from tensor_networks_tpu_torch.ops import als

    rng = np.random.default_rng(5)
    u = rng.standard_normal((8, 5))
    a = u @ rng.standard_normal((5, 8))
    b = rng.standard_normal(8)
    want = np.linalg.pinv(a) @ b
    for where in (dev, "cpu"):
        got = als._lstsq_min_norm(torch.tensor(a, device=where),
                                  torch.tensor(b, device=where)).cpu().numpy()
        assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


def test_als_on_singular_locals_never_calls_gels(dev, monkeypatch):
    """``tests/test_als_solver.py:167``'s system (K=6, rank 6: the end
    bonds' locals are singular) on the card: the dense path and CG from
    zero (1000 steps, SPD and normal equations) each reach 1e-10 of
    |rhs|, with ``torch.linalg.lstsq`` never called."""
    from tensor_networks_tpu_torch.ops import als, qtt

    def refuse(*args, **kw):
        raise AssertionError("torch.linalg.lstsq called")

    monkeypatch.setattr(torch.linalg, "lstsq", refuse)
    op = qtt.qtt_screened_laplacian(6, delta=1.0)
    rhs = qtt.qtt_exponential(6, c=3.0)
    b = float(tpk.norm_exact(rhs))
    for kw in ({}, dict(dense_limit=0, cg_iters=1000, spd=True),
               dict(dense_limit=0, cg_iters=1000, spd=False)):
        x, res, _ = als.als_solve(op, rhs, tpk.pad_rank(rhs, 6), sweeps=6, tol=1e-11 * b, **kw)
        assert x.first.is_cuda and res / b < 1e-10, (kw, res / b)


def _packed_on(x, where):
    return type(x)(*(t.to(where) for t in x))


def test_fused_solvers_on_the_card_match_the_cpu(dev):
    """Fused ``als_solve`` (dense locals) and ``als_eigsh`` at K=6 in f64
    on the card against the port on the CPU: represented vectors to
    1e-10 (the eigenvector up to sign), eigenvalues to 1e-10."""
    from tensor_networks_tpu_torch.ops import als, eigen, qtt

    out = {}
    for where in (dev, "cpu"):
        op = qtt.qtt_screened_laplacian(6, delta=1.0, device=where)
        rhs = qtt.qtt_exponential(6, c=3.0, device=where)
        x, res, _ = als.als_solve(op, rhs, tpk.pad_rank(rhs, 6), sweeps=4, tol=0.0)
        v, lam, _ = eigen.als_eigsh(op, tpk.pad_rank(rhs, 6), sweeps=6)
        out[str(where)] = (_packed_on(x, "cpu"), _packed_on(v, "cpu"), lam)
    (xc, vc, lc), (xg, vg, lg) = out["cpu"], out[str(dev)]
    for a, b, sign_free in ((xg, xc, False), (vg, vc, True)):
        ref = float(tpk.norm_exact(b))
        diff = float(tpk.norm_exact(tpk.add(a, tpk.scale(b, -1.0))))
        if sign_free:
            diff = min(diff, float(tpk.norm_exact(tpk.add(a, b))))
        assert diff <= 1e-10 * ref
    assert abs(lg - lc) <= 1e-10 * abs(lc)


def test_fused_sweeps_read_the_card_once_each(dev):
    """A fused solve reads the card once a sweep (its stop test) and once
    for its record; the rest are cuSOLVER's status checks: the same
    number for every local solve (2d per ALS sweep, 2d - 1 per eigsh
    sweep; eigsh's are three eighs each)."""
    from tensor_networks_tpu_torch.ops import als, eigen, qtt
    from tensor_networks_tpu_torch.syncs import host_syncs

    d = 6
    op = qtt.qtt_screened_laplacian(d, delta=1.0)
    rhs = qtt.qtt_exponential(d, c=3.0)
    x0 = tpk.pad_rank(rhs, 6)
    runs = {"als": lambda: als.als_solve(op, rhs, x0, sweeps=3, tol=0.0),
            "eigsh": lambda: eigen.als_eigsh(op, x0, sweeps=3, tol=-1.0),
            "lanczos": lambda: eigen.als_eigsh(op, x0, sweeps=3, tol=-1.0, dense_limit=0,
                                               lanczos_iters=8)}
    for name, call in runs.items():
        call()  # warm: the Lanczos seeds and cuSOLVER handles
        kinds, _ = host_syncs(call)
        info = kinds.pop("svd info" if name == "als" else "eigh info", 0)
        assert kinds == {"stop test": 3, "record fetch": 1}, (name, kinds)
        locals_ = 3 * (2 * d if name == "als" else 2 * d - 1)
        assert info > 0 and info % locals_ == 0, (name, info)
        if name != "als":
            assert info == 3 * locals_


def test_evolve_exponential_on_the_card(dev):
    """The time integrators' local exponential on the card, f32 and f64,
    at scaled 1-norms 1e-3 to 30, against ``torch.linalg.matrix_exp`` in
    f64 (1e-6 / 1e-13), with no host sync (``matrix_exp`` reads its
    operand's norm on the host to pick its degree)."""
    from tensor_networks_tpu_torch.ops import evolve
    from tensor_networks_tpu_torch.syncs import host_syncs

    g = torch.Generator(device=dev).manual_seed(5)
    for dtype, bar in ((torch.float32, 1e-6), (torch.float64, 1e-13)):
        for norm in (1e-3, 1.0, 30.0):
            a = torch.randn(128, 128, generator=g, device=dev, dtype=torch.float64)
            a = a + a.T
            a = (a * (norm / a.abs().sum(0).amax())).to(dtype)
            sq = max(0, math.ceil(math.log2(norm))) + 1
            evolve._expm(a, sq)  # the Taylor coefficients reach the card once
            syncs, got = host_syncs(lambda: evolve._expm(a, sq))
            ref = torch.linalg.matrix_exp(a.double())
            assert not syncs, syncs
            assert got.dtype == dtype
            assert ((got.double() - ref).norm() / ref.norm()).item() <= bar, (dtype, norm)


def test_fused_tdvp_steps_read_the_card_only_for_cusolver(dev):
    """A fused one-site step (dense and Lanczos locals) makes no host
    sync; a fused two-site step only cuSOLVER's SVD status reads, the
    same number for each of its 2 (d - 1) splits; a whole fused
    trajectory adds one read of the operator-norm bound (the squaring
    count) and one of its record."""
    from tensor_networks_tpu_torch.ops import evolve, qtt
    from tensor_networks_tpu_torch.syncs import host_syncs

    d = 6
    A = qtt.qtt_tridiagonal(d, 2.0, -1.0, -1.0)
    u0 = tpk.pad_rank(qtt.qtt_exponential(d, c=3.0), 4)
    x0, X, xl, a0, Am, al = evolve._fused_operands(A, u0)
    h = torch.full((), 0.01, dtype=torch.float64, device=dev)
    ej = torch.full((), 1e-8, dtype=torch.float64, device=dev)
    calls = {
        "one-site": lambda: evolve._tdvp_step_impl(x0, X, xl, a0, Am, al, h, 1024, 24, 2),
        "lanczos": lambda: evolve._tdvp_step_impl(x0, X, xl, a0, Am, al, h, 0, 8, 2),
        "two-site": lambda: evolve._tdvp2_step_impl(x0, X, xl, a0, Am, al, h, ej, 4096, 24,
                                                    4, 2),
    }
    for name, call in calls.items():
        call()  # warm: cuSOLVER handles, the Taylor coefficients
        kinds, _ = host_syncs(call)
        info = kinds.pop("svd info", 0)
        assert kinds == {}, (name, kinds)
        if name == "two-site":
            assert info > 0 and info % (2 * (d - 1)) == 0, info
        else:
            assert info == 0, (name, info)
    kinds, _ = host_syncs(lambda: evolve.evolve_tdvp(A, u0, 0.01, 3))
    assert kinds == {"record fetch": 1, "host float": 1}, kinds


def test_fused_tdvp_on_the_card_matches_host_loop_and_cpu(dev):
    """One- and two-site TDVP at K=6 in f64 on the card: the fused form
    against the host loop (vectors, norms 1e-12; ranks equal) and
    against the port on the CPU (1e-10; the effective ranks at eps 0 count
    roundoff-level singular values, so only the two card forms share
    them)."""
    from tensor_networks_tpu_torch.ops import evolve, qtt

    def runs(where):
        A = qtt.qtt_tridiagonal(6, 2.0, -1.0, -1.0, device=where)
        u0 = qtt.qtt_exponential(6, c=3.0, device=where)
        out = {}
        for fused in (True, False):
            u1, n1 = evolve.evolve_tdvp(A, tpk.pad_rank(u0, 4), 0.05, 4, fused=fused)
            u2, n2, r2 = evolve.evolve_tdvp2(A, u0, 0.05, 4, max_rank=8, fused=fused)
            out[fused] = ((_packed_on(u1, "cpu"), n1, None), (_packed_on(u2, "cpu"), n2, r2))
        return out

    def close(a, b, bar):
        ref = float(tpk.norm_exact(b))
        return float(tpk.norm_exact(tpk.add(a, tpk.scale(b, -1.0)))) <= bar * ref

    card, cpu = runs(dev), runs("cpu")
    for k in range(2):
        (uf, nf, rf), (uh, nh, rh), (uc, nc, _) = card[True][k], card[False][k], cpu[True][k]
        assert close(uf, uh, 1e-12) and close(uf, uc, 1e-10)
        np.testing.assert_allclose(nf, nh, rtol=1e-12)
        np.testing.assert_allclose(nf, nc, rtol=1e-10)
        assert rf == rh


def _graded_train(d, where, dtype=torch.float32, scales=(1.0, 1e-2, 1e-4, 1e-6)):
    """``tests/test_tight_eps.py``'s graded train (sums of unit rank-1
    trains at the given scales) built by the port from its draws."""
    from tensor_networks_tpu_torch import tt_rank1, tt_sum

    rng = np.random.default_rng(7)
    ins = [Index(f"x{i}", 6) for i in range(d)]
    terms = []
    for sc in scales:
        vecs = [rng.standard_normal(6) for _ in ins]
        terms.append(tt_rank1(ins, [sc * v / np.linalg.norm(v) for v in vecs],
                              dtype=dtype, device=where))
    return tt_sum(terms)


def test_tight_rounding_on_the_card_matches_the_cpu(dev):
    """``tt_round_tight`` on the card, both sweeps: the CPU's ranks and an
    error within 2 eps (the QR-sweep norm of the f64 difference); the
    batched sweep's host syncs are the same at d=6 and d=10."""
    from tensor_networks_tpu_torch.ops.tight import tt_round_tight
    from tensor_networks_tpu_torch.syncs import host_syncs

    def rel(out, ref):
        got = tpk.pack_ragged(out, torch.float64)
        want = tpk.pack_ragged(ref, torch.float64)
        return float(tpk.norm_exact(tpk.add(got, tpk.scale(want, -1.0))) / tpk.norm_exact(want))

    s, s_cpu = _graded_train(10, dev), _graded_train(10, "cpu")
    for sweep in ("batched", "sequential"):
        for eps in (1e-5, 3e-7):
            out, ranks = tt_round_tight(s.__deepcopy__({}), eps, sweep=sweep)
            _, ranks_cpu = tt_round_tight(s_cpu.__deepcopy__({}), eps, sweep=sweep)
            assert ranks == ranks_cpu, (sweep, eps, ranks, ranks_cpu)
            assert out.value(0).device == s.value(0).device
            assert out.value(0).dtype == torch.float32
            assert rel(out, s) <= 2 * eps, (sweep, eps)
    counts = []
    for d in (6, 10):
        t = _graded_train(d, dev)
        tt_round_tight(t.__deepcopy__({}), 1e-5)  # warm: cuSOLVER handles
        counts.append(host_syncs(lambda: tt_round_tight(t.__deepcopy__({}), 1e-5))[0])
    assert counts[0] == counts[1], counts


def test_exported_artifact_serves_across_devices(dev, tmp_path):
    """An artifact traced on the CPU serves on the card and one traced
    on the card serves on the CPU, with the same values (1e-12, f64)."""
    from tensor_networks_tpu_torch.export import export_evaluator, load

    inds = [Index(f"x{i}", 7) for i in range(6)]
    g = torch.Generator().manual_seed(23)
    net = TensorNetwork.rand_tt(inds, [3, 4, 5, 4, 3], device="cpu", generator=g)
    net_card = net.__deepcopy__({})
    for n in net_card.network.nodes:
        net_card.node_tensor(n).update_val_size(net.value(n).to(dev))
    pts = np.random.default_rng(0).integers(0, 7, (257, 6))
    ref = net.evaluate(inds, pts)
    for source, target in ((net, dev), (net_card, "cpu")):
        path = export_evaluator(source, inds).save(str(tmp_path / f"from_{source.value(0).device.type}"))
        got = load(path, device=target)(pts)
        assert np.abs(got - ref).max() <= 1e-12 * np.abs(ref).max()


def test_als_completion_on_the_card_matches_the_cpu(dev):
    """``fit_network_als`` at d=6, n=8, rank 3, f64: the card's first two
    sweep errors equal the CPU's within 1e-6 relative or 1e-12 absolute."""
    from tensor_networks_tpu_torch.fit import fit_network_als

    rng = np.random.default_rng(5)
    inds = [Index(f"a{i}", 8) for i in range(6)]
    truth = TensorNetwork.rand_tt(inds, [3] * 5, device="cpu",
                                  generator=torch.Generator().manual_seed(1))
    idx = rng.integers(0, 8, (20000, 6))
    y = truth.evaluate(inds, idx)
    errs = {}
    for where in ("cpu", dev):
        model = TensorNetwork.rand_tt(inds, [3] * 5, device="cpu",
                                      generator=torch.Generator().manual_seed(2))
        for n in model.network.nodes:
            model.node_tensor(n).update_val_size(model.value(n).to(where))
        errs[str(where)] = fit_network_als(model, inds, idx, y, sweeps=2)
    for a, b in zip(errs[str(dev)], errs["cpu"]):
        assert abs(a - b) <= max(1e-6 * abs(b), 1e-12), errs


def _search_net(shape, seed, where):
    rng = np.random.default_rng(seed)
    net = TensorNetwork()
    net.add_node("G", Tensor(torch.from_numpy(rng.standard_normal(shape)).to(where),
                             [Index(f"s{k}", n) for k, n in enumerate(shape)]))
    return net


def _search_config(eps, **engine):
    from tensor_networks_tpu_torch.search import SearchConfig

    config = SearchConfig()
    config.engine.eps = eps
    for key, value in engine.items():
        setattr(config.engine, key, value)
    return config


def test_batched_search_scoring_on_the_card(dev, monkeypatch):
    """Batched scoring is on by default for a state on the card: bfs
    (depth 3, multi-node states included) and dfs give the per-action
    path's counts and best cost, with no action left to it; every
    child's factors stay on the card."""
    from tensor_networks_tpu_torch.search import SearchEngine, SearchState, batched

    for kind in ("bfs", "dfs"):
        runs = {}
        for force in ("0", None):
            if force is None:
                monkeypatch.delenv("TNT_SEARCH_DEVICE", raising=False)
            else:
                monkeypatch.setenv("TNT_SEARCH_DEVICE", force)
            batched.scored_splits.per_action = 0
            stats = getattr(SearchEngine(_search_config(0.4, max_ops=3)), kind)(
                _search_net((3, 4, 5, 6), 13, dev))
            runs[force] = (stats["count"], stats["best_network"].cost(),
                           batched.scored_splits.per_action)
            assert stats["best_network"].value(next(iter(stats["best_network"].network.nodes))).is_cuda
        assert runs["0"][:2] == runs[None][:2], (kind, runs)
        assert runs[None][2] == 0
    monkeypatch.delenv("TNT_SEARCH_DEVICE", raising=False)
    net = _search_net((4, 6, 5, 3), 2, dev)
    state = SearchState(net, 0.5 * net.norm())
    actions = state.get_legal_actions(True)
    scored = batched.scored_splits(state, actions)
    assert set(scored) == set(actions)
    for action in actions:
        for child in state.take_action(action, _search_config(0.5), svd=scored[action][0]):
            assert all(child.network.value(n).is_cuda for n in child.network.network.nodes)


def test_watchdog_on_a_card_network(dev):
    """Partition search through the watchdog child on a network on the
    card returns the in-process result; the child was sent CPU copies
    and opened no CUDA context."""
    import pickle

    from tensor_networks_tpu_torch.search import SearchEngine, spectra, synthesis

    inline = SearchEngine(_search_config(0.5)).partition_search(_search_net((3, 4, 5), 1, dev))
    child = SearchEngine(_search_config(0.5, timeout=120.0)).partition_search(
        _search_net((3, 4, 5), 1, dev))
    assert child["count"] == inline["count"] == 7
    assert child["best_network"].cost() == inline["best_network"].cost()
    assert abs(child["reconstruction_error"] - inline["reconstruction_error"]) <= 1e-12
    assert synthesis.explore_with_watchdog.last_child == {
        "CUDA_VISIBLE_DEVICES": "", "cuda_initialized": False}
    net = _search_net((3, 4, 5), 1, dev)
    sp = spectra.SplitSpectra(_search_config(0.5)).build(net.contract())
    host, *_ = pickle.loads(synthesis.watchdog_payload(net, 0.5, sp, _search_config(0.5), True))
    assert all(host.value(n).device.type == "cpu" for n in host.network.nodes)


@pytest.fixture
def one_rank_nccl(dev):
    """A one-rank NCCL group on the card for the test, destroyed after."""
    import torch.distributed as dist

    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1,
                            device_id=dev)
    yield
    dist.destroy_process_group()


def test_parallel_step_fast_against_plain_on_one_rank(dev, one_rank_nccl):
    """The sharded SGD step on a (1, 1) NCCL mesh: the H2 forward
    (``fast_eval``) against the plain one, 1e-4 relative; H2 launched by
    the fast step only."""
    from tensor_networks_tpu_torch.parallel import init_tt_params, make_mesh, make_train_step

    mesh = make_mesh((1, 1))
    rng = np.random.default_rng(4)
    idx, y = rng.integers(0, 16, (1024, 8)), rng.standard_normal(1024).astype(np.float32)
    out = {}
    for fast in (False, True):
        step, place_params, place_batch = make_train_step(mesh, fast_eval=fast)
        params = place_params(init_tt_params(8, 16, 32, seed=2, device=dev))
        tev.tt_evaluate_cuda.launches = 0
        new, loss = step(params, *place_batch(idx, y), 1e-2)
        out[fast] = (float(loss), new, tev.tt_evaluate_cuda.launches)
    assert out[False][2] == 0 and out[True][2] == 1
    assert abs(out[True][0] - out[False][0]) <= 1e-4 * abs(out[False][0])
    for a, b in zip(out[True][1], out[False][1]):
        assert ((a - b).abs().max() / b.abs().max()).item() <= 1e-4


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_mode_sharded_inner_against_h1_on_one_rank(dev, one_rank_nccl, dtype):
    from tensor_networks_tpu_torch.parallel import make_mesh, shard_tt_params, tt_inner_mode_sharded
    from tensor_networks_tpu_torch.parallel.sharded import TTCores

    mesh = make_mesh((1, 1))
    g = torch.Generator().manual_seed(12)
    a = _train(g, 12, 32, 48, dtype, dev)
    b = _train(g, 12, 32, 48, dtype, dev)
    got = tt_inner_mode_sharded(mesh, shard_tt_params(mesh, TTCores(*a)),
                                shard_tt_params(mesh, TTCores(*b))).item()
    ref = tzp.tt_inner_cuda(*a, *b).item()
    scale = math.sqrt(tzp.tt_inner_plain(*_f64(a), *_f64(a)).item()
                      * tzp.tt_inner_plain(*_f64(b), *_f64(b)).item())
    assert abs(got - ref) <= (1e-5 if dtype == torch.float32 else 1e-12) * scale


def test_sharded_rounding_against_the_single_device_sweeps(dev, one_rank_nccl):
    """Train-sharded Gram and prefix rounding on one rank of a (1, 1) mesh
    keep the ranks of ``tt_round_fixed(method="gram" / "prefix")`` on a
    doubled f64 train, and its values at 4096 points (H2) to 1e-10 of
    their largest."""
    from tensor_networks_tpu_torch.ops.fast import tt_round_fixed
    from tensor_networks_tpu_torch.parallel import (
        make_mesh,
        place_train_sharded,
        tt_gram_round_sharded,
        tt_prefix_round_sharded,
    )

    mesh = make_mesh((1, 1))
    g = torch.Generator().manual_seed(21)
    f, m, l = _train(g, 12, 8, 6, torch.float64, dev)
    mids = torch.zeros(10, 12, 8, 12, dtype=torch.float64, device=dev)
    mids[:, :6, :, :6] = m
    mids[:, 6:, :, 6:] = m
    first, last = torch.cat([f, f], 1), torch.cat([l, l], 0)
    net = tpk.unpack(tpk.PackedTT(first, mids, last))
    idx = torch.randint(0, 8, (4096, 12), generator=g).to(dev)
    ref = tpk.evaluate(tpk.PackedTT(first, mids, last), idx)
    for method, fn in (("gram", tt_gram_round_sharded), ("prefix", tt_prefix_round_sharded)):
        m_sh, l_sh = place_train_sharded(mesh, mids, last)
        fo, mo, lo, k0, ks = fn(mesh, first, m_sh, l_sh, 1e-6)
        assert [int(k0)] + ks.tolist() == tt_round_fixed(net, 1e-6, method=method)[1] == [6] * 11
        got = tpk.evaluate(tpk.PackedTT(fo, mo, lo), idx)
        assert ((got - ref).abs().max() / ref.abs().max()).item() <= 1e-10, method


def _dense_on_host(t):
    first, mids, last = (x.double().cpu().numpy() for x in t)
    v = first
    for core in mids:
        v = np.einsum("ar,rnb->anb", v, core).reshape(-1, core.shape[-1])
    return (v @ last).reshape(-1)


def _solver_pair(name, dev):
    """(the train-sharded call on a mesh, the fused call) at K=8 in f64 on
    the card."""
    import tensor_networks_tpu_torch as tnt
    from tensor_networks_tpu_torch import parallel as par

    K = 8
    op = tnt.qtt_screened_laplacian(K, delta=1.0, device=dev)
    rhs = tnt.qtt_exponential(K, c=3.0, device=dev)
    x0 = tpk.pad_rank(rhs, 6)
    A = tnt.qtt_tridiagonal(K, 2.0, -1.0, -1.0, device=dev)
    kw_l = dict(sweeps=2, tol=-1.0, dense_limit=0, lanczos_iters=12)
    return {
        "als": (lambda m: par.als_solve_sharded(m, op, rhs, x0, sweeps=2, tol=0.0, spd=True),
                lambda: tnt.als_solve(op, rhs, x0, sweeps=2, tol=0.0, spd=True)),
        "als_adaptive": (
            lambda m: par.als_solve_adaptive_sharded(m, op, rhs, eps=1e-10, rank=2, max_rank=8,
                                                     spd=True, enrich=False),
            lambda: tnt.als_solve_adaptive(op, rhs, eps=1e-10, rank=2, max_rank=8, spd=True,
                                           enrich=False)),
        "eigsh": (lambda m: par.als_eigsh_sharded(m, op, x0, sweeps=3),
                  lambda: tnt.als_eigsh(op, x0, sweeps=3)),
        "eigsh_lanczos": (lambda m: par.als_eigsh_sharded(m, op, x0, **kw_l),
                          lambda: tnt.als_eigsh(op, x0, **kw_l)),
        "eigsh_k": (lambda m: par.als_eigsh_k_sharded(m, op, x0, 2, sweeps=3),
                    lambda: tnt.als_eigsh_k(op, x0, 2, sweeps=3)),
        "tdvp": (lambda m: par.evolve_tdvp_sharded(m, A, tpk.pad_rank(rhs, 4), 0.03, 2),
                 lambda: tnt.evolve_tdvp(A, tpk.pad_rank(rhs, 4), 0.03, 2)),
        "tdvp2": (lambda m: par.evolve_tdvp2_sharded(m, op, rhs, 0.05, 2, max_rank=6, eps=1e-10),
                  lambda: tnt.evolve_tdvp2(op, rhs, 0.05, 2, max_rank=6, eps=1e-10)),
        "theta": (lambda m: par.evolve_theta_sharded(m, op, x0, 0.01, 2, theta=1.0, spd=True),
                  lambda: tnt.evolve_theta(op, x0, 0.01, 2, theta=1.0, spd=True)),
    }[name]


@pytest.mark.parametrize("name", ["als", "als_adaptive", "eigsh", "eigsh_lanczos", "eigsh_k",
                                  "tdvp", "tdvp2", "theta"])
def test_sharded_solvers_against_the_fused_ones_on_one_rank(dev, one_rank_nccl, name):
    """Each train-sharded solver on a (1, 1) NCCL mesh against the fused
    single-device solver at the same knobs, both on the card in f64: the
    represented tensors and every record to 1e-10 relative (residuals at
    roundoff, ~1e-14, to 1e-13 absolute: cuBLAS may round the two
    forms' einsums differently), the same two-site ranks; the results
    stay on the card."""
    from tensor_networks_tpu_torch.parallel import make_mesh

    sharded, fused = _solver_pair(name, dev)
    got, ref = sharded(make_mesh((1, 1))), fused()
    if name == "eigsh_k":
        got, ref = (got[0][0],) + tuple(got[1:]), (ref[0][0],) + tuple(ref[1:])
    assert got[0].mids.device == dev
    a, b = _dense_on_host(got[0]), _dense_on_host(ref[0])
    assert np.linalg.norm(a - b) <= 1e-10 * np.linalg.norm(b), name
    for x, y in zip(got[1:], ref[1:]):
        np.testing.assert_allclose(np.asarray(x, np.float64), np.asarray(y, np.float64),
                                   rtol=1e-10, atol=1e-13)
