"""H1: the TT inner-product zipper -- CUDA kernels, plain version, router.

Replaces the JAX package's Pallas zippers
``tensor_networks_tpu/kernels/pallas_ops.py::tt_inner_pallas`` (K1, :502)
and ``::tt_inner_pallas_fused`` (K2, :229); the kernel source is
``csrc/zipper.cu``.  One C call runs the whole inner product, so one
wrapper call is one inner product, as K2 was one dispatch.  Every launch
after a call's first is a programmatic dependent launch.  Two routes,
chosen by rank before any launch (:func:`takes_fused_route`):

* the fused route, max(r_a, r_b) <= :data:`FUSED_MAX_RANK`: per middle
  core pair one ``zip_step`` (a block per mode and band of rows computes
  A_i^T W B_i with both products in shared memory) and one ``zip_reduce``
  (the sum over modes in a fixed order); 1 + 2 (d-2) + 1 launches.
  :func:`band_plan` cuts the rows into bands;
* the chain (:func:`tt_inner_chain_cuda`), above that rank: per core pair
  t = W^T A_k and W' = t^T B_k through one pipelined tile GEMM
  (``tile_gemm``: a 4-stage ``cp.async`` ring of 16-deep K-slabs; f32 and
  the 2-byte cores on FP32 FMA in 128 x 128 tiles, 8 x 8 outputs a
  thread, one block an SM; f64 on the FP64 tensor cores, ``mma.sync``
  m16n8k4, in 64 x 64 tiles), the second product split along K and its
  slabs summed by ``zip_reduce``, then ``zip_last`` on several blocks and
  ``zip_sum``; 1 + 3 (d-2) + 2 launches, 147 at d=50.
  :func:`chain_plan` picks the tile and the split.

What bounds it on the H100: at d=50, n=32, r=100 one inner product is
~6.1 GFLOP over ~123 MB of cores, so it is FP32-FMA-bound: ~90 us at
67 TFLOP/s against ~37 us at 3.35 TB/s.  f32 stays on FMA (one TF32
pass does not keep its accuracy); f64 runs on DMMA.

Cores may be float32, float64, bfloat16 or float16, at any rank.  The
kernels keep the carry W and every product of 2-byte cores in float32
and return the result in the cores' dtype, as the JAX package does; the
wrappers allocate the float32 scratch.

Routing: :func:`tt_inner` sends CUDA tensors to the kernels (which raise
on what they cannot take) and CPU tensors to :func:`tt_inner_plain`.
There is no fallback from a kernel to the plain version, nor from the
fused route to the chain.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional

import torch

from tensor_networks_tpu_torch.kernels import _build

PRECISIONS = ("highest", "bf16x3", "default")
#: the suffix of each core dtype's C entry points
DTYPE_SUFFIX = {
    torch.float32: "f32",
    torch.float64: "f64",
    torch.bfloat16: "bf16",
    torch.float16: "f16",
}
#: ranks up to this take the fused route; its shared memory (A slice, U,
#: two rings) fits one block at this rank in float64 too
FUSED_MAX_RANK = 128
#: the chain GEMM's tiles by code, (BM, BN), as csrc/zipper.cu has them:
#: 0 computes in float on the FMA pipes (256 threads, 8 x 8 outputs each,
#: one block an SM), 1 in double on the FP64 tensor cores (4 warps of
#: 32 x 32, two blocks an SM)
CHAIN_TILES = {0: (128, 128), 1: (64, 64)}
_DMMA_TILE = 1
_CHAIN_BK = 16  # depth of a K-slab
_CHAIN_NSTAGE = 4  # K-slabs in a ring
_CHAIN_MIN_SLABS = 12  # K-slabs a split keeps at least, where K allows
#: a float tile's block asks for more than half an SM's shared memory
_EXCLUSIVE_SMEM = 116 * 1024
# the fused step's geometry, as csrc/zipper.cu has it
_STEP_TM = 4  # band rows per thread; bands start at multiples of it
_STEP_NJ = 1  # 16-byte column packs per thread
_STEP_MAX_THREADS = 256
_STEP_NSTAGE = 4  # K-slabs in flight per ring
_STEP_BK = 16  # depth of a K-slab
_SMEM_BYTES = 232448  # shared memory one block may take on the H100


def tt_inner_plain(fa, ma, la, fb, mb, lb) -> torch.Tensor:
    """The plain PyTorch zipper (the JAX package's ``tt_inner_fn``).

    W_0 = A_0^T B_0;  W_k = sum_n A_k(n)^T W_{k-1} B_k(n);
    result = <W_{d-2}, A_last B_last^T>.  ``ma``/``mb`` are
    (d-2, r, n, r) stacks or None when d == 2.
    """
    w = fa.T @ fb  # (r_a, r_b)
    if ma is not None:
        for a, b in zip(ma, mb):
            ra, n, ra2 = a.shape
            rb, _, rb2 = b.shape
            # t[(b1 n), a2] = sum_a1 w[a1, b1] a[a1, n, a2]
            t = (w.T @ a.reshape(ra, n * ra2)).reshape(rb * n, ra2)
            # w2[a2, b2] = sum_{b1, n} t[(b1 n), a2] b[(b1 n), b2]
            w = t.T @ b.reshape(rb * n, rb2)
    return torch.sum(w * (la @ lb.T))


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype the kernels compute in for cores of ``dtype``: float32
    for the 2-byte types, the dtype itself otherwise."""
    return torch.float32 if dtype in (torch.bfloat16, torch.float16) else dtype


def _check_dtype(dtype: torch.dtype) -> str:
    if dtype not in DTYPE_SUFFIX:
        raise ValueError(
            "dtype must be float32, float64, bfloat16 or float16, "
            f"got {dtype}"
        )
    return DTYPE_SUFFIX[dtype]


def _check_precision(precision: str) -> None:
    if precision not in PRECISIONS:
        raise ValueError(
            f"precision must be one of {PRECISIONS}, got {precision!r}"
        )


def takes_fused_route(ra: int, rb: int) -> bool:
    """The routing rule: the fused steps up to :data:`FUSED_MAX_RANK`,
    the chain above it.  Decided by shape alone, before any launch."""
    return max(ra, rb) <= FUSED_MAX_RANK


def band_rows(ra: int, nbands: int) -> list:
    """The (start, stop) rows of each band: whole units of ``_STEP_TM``
    rows, spread as evenly as possible; the last unit may be partial.
    ``zip_step`` computes the same from its block index."""
    units = math.ceil(ra / _STEP_TM)
    base, extra = divmod(units, nbands)
    bands = []
    for b in range(nbands):
        u0 = b * base + min(b, extra)
        u1 = u0 + base + (b < extra)
        bands.append((u0 * _STEP_TM, min(ra, u1 * _STEP_TM)))
    return bands


class BandPlan(NamedTuple):
    nbands: int  # bands of a2 rows; the step's grid is (n, nbands)
    tmax: int  # rows of the largest band, rounded up to _STEP_TM
    threads: int  # threads of a step block
    smem: int  # dynamic shared memory of a step block, bytes


def band_plan(ra: int, rb: int, n: int, dtype: torch.dtype, sms: int) -> BandPlan:
    """How ``zip_step`` cuts the a2 rows into bands for n modes on
    ``sms`` SMs.

    A block's threads cover its band (``_STEP_TM`` rows each) by r_b
    columns (one 16-byte pack each), at most ``_STEP_MAX_THREADS``; that
    sets the fewest bands.  Among the band counts from there to one unit
    per band, take the fewest whose n * nbands blocks fill their last
    wave of ``sms`` within 5% of the best count's fill (each band reads
    all of W and B_i).  Whole units per band, so no band is empty.  At
    the main shape that is 4 bands, one block per SM; 8 bands (two
    blocks per SM) measured slower on the H100 (``PERF.md``).
    ``dtype`` is the one the step computes and stages in
    (:func:`acc_dtype`): 2-byte cores take float32's bands.
    """
    item = torch.empty((), dtype=dtype).element_size()
    cols = _STEP_NJ * (16 // item)
    txc = math.ceil(rb / cols)
    units = math.ceil(ra / _STEP_TM)
    cap_units = _STEP_MAX_THREADS // txc
    plans = []
    for nbands in range(math.ceil(units / cap_units), units + 1):
        tmax = math.ceil(units / nbands) * _STEP_TM
        smem = ((ra + rb) * tmax + 2 * _STEP_NSTAGE * _STEP_BK * txc * cols) * item
        if smem <= _SMEM_BYTES:
            blocks = n * nbands
            fill = blocks / (math.ceil(blocks / sms) * sms)
            threads = 32 * math.ceil(txc * (tmax // _STEP_TM) / 32)
            plans.append((fill, BandPlan(nbands, tmax, threads, smem)))
    if not plans:
        raise ValueError(f"no band plan fits ranks ({ra}, {rb}) in shared memory")
    best = max(fill for fill, _ in plans)
    return next(plan for fill, plan in plans if fill >= 0.95 * best)


class ChainPlan(NamedTuple):
    tile: int  # CHAIN_TILES code of both products of a step
    splits: int  # K-ranges of the second product, W' = t^T B_k (K = r_b n)
    kchunk: int  # rows of each K-range, a whole number of K-slabs
    threads: int  # threads of a block
    smem: int  # dynamic shared memory a block asks for, bytes


def chain_plan(ra: int, rb: int, n: int, dtype: torch.dtype, sms: int) -> ChainPlan:
    """The chain's tile and K-split for cores of ``dtype`` on ``sms`` SMs.

    f64 takes the DMMA tile (64 x 64, two blocks an SM); float32 and the
    2-byte cores (float32 arithmetic, raw 2-byte ring) the 128 x 128 FMA
    tile, one block an SM: its block asks for ``_EXCLUSIVE_SMEM`` (16-byte
    rows) or fills the SM's registers.  The first product, t = W^T A_k,
    is not split.  The second, W' = t^T B_k (K = r_b n), is split into as
    many K-ranges as its output tiles leave room for in one wave of
    resident blocks, each keeping at least ``_CHAIN_MIN_SLABS`` K-slabs
    where K allows; every range but the last has ``kchunk`` rows
    (:func:`split_ranges`).  Measured on the H100 (``PERF.md``): smaller
    float tiles, two float blocks an SM, and a second wave of a few
    blocks were each slower.
    """
    item = torch.empty((), dtype=dtype).element_size()
    tile = _DMMA_TILE if dtype == torch.float64 else 0
    bm, bn = CHAIN_TILES[tile]
    if tile == _DMMA_TILE:
        per_sm, threads = 2, 128
        smem = _CHAIN_NSTAGE * _CHAIN_BK * ((bm + 4) + (bn + 4)) * 8
    else:
        per_sm, threads = 1, bm * bn // 64
        smem = max(_CHAIN_NSTAGE * _CHAIN_BK * (bm * 4 + bn * item), _EXCLUSIVE_SMEM)
    k = rb * n
    slabs = math.ceil(k / _CHAIN_BK)
    fit = sms * per_sm // (math.ceil(ra / bm) * math.ceil(rb / bn))
    splits = max(1, min(fit, slabs // _CHAIN_MIN_SLABS))
    kchunk = math.ceil(slabs / splits) * _CHAIN_BK
    return ChainPlan(tile, math.ceil(k / kchunk), kchunk, threads, smem)


def split_ranges(k: int, kchunk: int) -> list:
    """The (start, stop) rows of K that each split of the second product
    sums, as ``tile_gemm`` computes them from its z index."""
    return [(z * kchunk, min(k, (z + 1) * kchunk)) for z in range(math.ceil(k / kchunk))]


def device_launches(d_mid: int, fused: bool, splits: int = 1) -> int:
    """Kernel launches of one inner product: the fused route makes
    1 + 2 (d-2) + 1; the chain 1 + (2 or 3) (d-2) + 2, with a
    ``zip_reduce`` of the split-K slabs in each step when its second
    product is split (``chain_plan(...).splits`` > 1) and ``zip_sum``
    after its multi-block ``zip_last``."""
    if fused:
        return 2 + 2 * d_mid
    return 3 + d_mid * (3 if splits > 1 else 2)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check_cores(fa, ma, la, fb, mb, lb, who: str):
    """Validate the two trains; returns (n0, n, nl, ra, rb, d_mid)."""
    tensors = [fa, la, fb, lb] + [m for m in (ma, mb) if m is not None]
    dev = fa.device
    dtype = fa.dtype
    if dev.type != "cuda":
        raise ValueError(f"{who} needs CUDA tensors, got {dev}")
    for x in tensors:
        if x.device != dev or x.dtype != dtype:
            raise ValueError("all cores must share one CUDA device and dtype")
        if not x.is_contiguous():
            raise ValueError("cores must be contiguous")
    _check_dtype(dtype)
    if (ma is None) != (mb is None):
        raise ValueError("both trains need middle cores, or neither")
    n0, ra = fa.shape
    rb = fb.shape[1]
    nl = la.shape[1]
    if ma is None:
        d_mid, n = 0, n0
    else:
        d_mid, _, n, _ = ma.shape
    if (
        fb.shape != (n0, rb)
        or la.shape != (ra, nl)
        or lb.shape != (rb, nl)
        or (ma is not None and ma.shape != (d_mid, ra, n, ra))
        or (mb is not None and mb.shape != (d_mid, rb, n, rb))
    ):
        raise ValueError(
            "shape mismatch: need fa (n0, ra), ma (d-2, ra, n, ra), "
            "la (ra, nl) and the same for b with rb"
        )
    return n0, n, nl, ra, rb, d_mid


def _ptr(x: Optional[torch.Tensor]):
    return x.data_ptr() if x is not None else None


def _chain(fa, ma, la, fb, mb, lb, n0, n, nl, ra, rb, d_mid):
    """The chain: returns (the 0-d result, its device launches)."""
    dev, dtype = fa.device, fa.dtype
    acc = acc_dtype(dtype)
    lib = _build.cuda_library()
    plan = chain_plan(ra, rb, n, dtype, _sm_count(dev.index)) if d_mid else None
    splits = plan.splits if plan else 1
    with torch.cuda.device(dev):
        w = torch.empty(ra * rb, device=dev, dtype=acc)
        # t also takes zip_last's block sums (at most ra)
        t = torch.empty(max(rb * n * ra, ra), device=dev, dtype=acc)
        part = torch.empty(splits * ra * rb if splits > 1 else 1, device=dev, dtype=acc)
        out = torch.empty((), device=dev, dtype=dtype)
        fn = getattr(lib, f"tnt_zipper_{DTYPE_SUFFIX[dtype]}")
        rc = fn(
            _ptr(fa), _ptr(ma), _ptr(la), _ptr(fb), _ptr(mb), _ptr(lb),
            w.data_ptr(), t.data_ptr(), part.data_ptr(), out.data_ptr(),
            n0, n, nl, ra, rb, d_mid,
            plan.tile if plan else 0, splits, plan.kchunk if plan else 0,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(lib, rc, "tt_inner_chain_cuda")
    tt_inner_chain_cuda.launches += 1
    return out, device_launches(d_mid, False, splits)


def _fused(fa, ma, la, fb, mb, lb, n0, n, nl, ra, rb, d_mid):
    """The fused route: returns (the 0-d result, its device launches)."""
    dev, dtype = fa.device, fa.dtype
    acc = acc_dtype(dtype)
    lib = _build.cuda_library()
    plan = band_plan(ra, rb, n, acc, _sm_count(dev.index)) if d_mid else None
    with torch.cuda.device(dev):
        w = torch.empty(ra * rb, device=dev, dtype=acc)
        part = torch.empty(n * ra * rb if d_mid else 1, device=dev, dtype=acc)
        out = torch.empty((), device=dev, dtype=dtype)
        fn = getattr(lib, f"tnt_zipper_fused_{DTYPE_SUFFIX[dtype]}")
        rc = fn(
            _ptr(fa), _ptr(ma), _ptr(la), _ptr(fb), _ptr(mb), _ptr(lb),
            w.data_ptr(), part.data_ptr(), out.data_ptr(),
            n0, n, nl, ra, rb, d_mid,
            plan.nbands if plan else 0, plan.tmax if plan else 0,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(lib, rc, "tt_inner_cuda")
    tt_inner_cuda.fused += 1
    return out, device_launches(d_mid, True)


def tt_inner_cuda(
    fa: torch.Tensor,
    ma: Optional[torch.Tensor],
    la: torch.Tensor,
    fb: torch.Tensor,
    mb: Optional[torch.Tensor],
    lb: torch.Tensor,
) -> torch.Tensor:
    """<a, b> through the H1 kernels; returns a 0-d tensor.

    Takes contiguous float32, float64, bfloat16 or float16 CUDA tensors
    of one dtype on one device: fa (n0, r_a), ma (d-2, r_a, n, r_a) or
    None, la (r_a, nl), and the same for b with its own rank r_b; any
    ranks.  Returns the result in the cores' dtype (2-byte cores are
    summed in float32).  Raises on anything else.
    Ranks up to :data:`FUSED_MAX_RANK` take the fused route, larger ones
    the chain.  Counts one call in ``tt_inner_cuda.launches``, the fused
    ones also in ``tt_inner_cuda.fused`` (the chain's in
    ``tt_inner_chain_cuda.launches``), every call by the cores' dtype
    in ``tt_inner_cuda.launches_by_dtype`` (keys "f32", "f64", "bf16",
    "f16"), and keeps the device launches of the last call in
    ``tt_inner_cuda.last_device_launches``.
    """
    dims = _check_cores(fa, ma, la, fb, mb, lb, "tt_inner_cuda")
    route = _fused if takes_fused_route(dims[3], dims[4]) else _chain
    out, launches = route(fa, ma, la, fb, mb, lb, *dims)
    tt_inner_cuda.launches += 1
    tt_inner_cuda.launches_by_dtype[DTYPE_SUFFIX[fa.dtype]] += 1
    tt_inner_cuda.last_device_launches = launches
    return out


tt_inner_cuda.launches = 0
tt_inner_cuda.launches_by_dtype = dict.fromkeys(DTYPE_SUFFIX.values(), 0)
tt_inner_cuda.fused = 0
tt_inner_cuda.last_device_launches = 0


def tt_inner_chain_cuda(fa, ma, la, fb, mb, lb) -> torch.Tensor:
    """<a, b> through the chain at any rank: the route that
    :func:`tt_inner_cuda` takes above :data:`FUSED_MAX_RANK`, callable
    at every rank as the fused route's yardstick.  Same contract as
    :func:`tt_inner_cuda`; counts its calls in ``.launches`` and keeps the
    device launches of the last one in ``.last_device_launches``."""
    dims = _check_cores(fa, ma, la, fb, mb, lb, "tt_inner_chain_cuda")
    out, launches = _chain(fa, ma, la, fb, mb, lb, *dims)
    tt_inner_chain_cuda.last_device_launches = launches
    return out


tt_inner_chain_cuda.launches = 0
tt_inner_chain_cuda.last_device_launches = 0


def tt_inner(fa, ma, la, fb, mb, lb, precision: str = "highest"):
    """<a, b> of two packed trains: the H1 kernel for CUDA tensors, the
    plain zipper for CPU tensors.

    ``precision`` takes the JAX API's values ("highest", "bf16x3",
    "default"); every mode computes in full-precision FMA here (float32
    for 2-byte cores), which meets each mode's accuracy contract
    (bf16x3 ~1e-6 relative, default bf16-level).
    """
    _check_precision(precision)
    if fa.is_cuda:
        return tt_inner_cuda(fa, ma, la, fb, mb, lb)
    return tt_inner_plain(fa, ma, la, fb, mb, lb)
