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
