"""H1: the TT inner-product zipper -- CUDA kernels, plain version, router.

Replaces the JAX package's Pallas zippers
``tensor_networks_tpu/kernels/pallas_ops.py::tt_inner_pallas`` (K1, :502)
and ``::tt_inner_pallas_fused`` (K2, :229); the kernel source is
``csrc/zipper.cu``.  One C call runs the whole inner product, so one
wrapper call is one inner product, as K2 was one dispatch.  Two routes,
chosen by rank before any launch (:func:`takes_fused_route`):

* the fused route, max(r_a, r_b) <= :data:`FUSED_MAX_RANK`: per middle
  core pair one ``zip_step`` (a block per mode and band of rows computes
  A_i^T W B_i with both products in shared memory) and one ``zip_reduce``
  (the sum over modes in a fixed order), chained by programmatic
  dependent launch; 1 + 2 (d-2) + 1 launches.  :func:`band_plan` cuts the
  rows into bands;
* the chain (:func:`tt_inner_chain_cuda`), above that rank: a prologue
  GEMM, two GEMM launches per core pair (the second split along K and
  reduced), one epilogue; ~3 (d-2) + 2 launches.

What bounds it on the H100: at d=50, n=32, r=100 one inner product is
~6.1 GFLOP over ~123 MB of cores, so it is FP32-FMA-bound: ~90 us at
67 TFLOP/s against ~37 us at 3.35 TB/s.  Both routes use plain FMA, no
tensor cores.

Cores may be float32, float64, bfloat16 or float16, at any rank.  The
kernels convert 2-byte cores to float32 as they load them, keep the
carry W and every product in float32, and return the result in the
cores' dtype, as the JAX package does; the wrappers allocate the
float32 scratch.

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
_SPLIT_TILE = 64  # the chain's GEMM output tile edge
_SPLIT_BK = 16  # the chain's GEMM K step
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


def _splits(sms: int, ra: int, rb: int, k: int) -> int:
    """K-splits for the chain step's second GEMM: enough partial tiles for
    two blocks per SM, at most one split per K step."""
    tiles = math.ceil(ra / _SPLIT_TILE) * math.ceil(rb / _SPLIT_TILE)
    return max(1, min(math.ceil(2 * sms / tiles), math.ceil(k / _SPLIT_BK)))


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


def device_launches(d_mid: int, fused: bool, splits: int = 1) -> int:
    """Kernel launches of one inner product: the fused route makes
    1 + 2 (d-2) + 1; the chain 1 + (2 or 3) (d-2) + 1, with a reduce of
    the split-K partials in each step when its second GEMM is split."""
    if fused:
        return 2 + 2 * d_mid
    return 2 + d_mid * (3 if splits > 1 else 2)


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
    splits = _splits(_sm_count(dev.index), ra, rb, rb * n) if d_mid else 1
    with torch.cuda.device(dev):
        w = torch.empty(ra * rb, device=dev, dtype=acc)
        t = torch.empty(max(rb * n * ra, 1), device=dev, dtype=acc)
        part = torch.empty(splits * ra * rb, device=dev, dtype=acc)
        out = torch.empty((), device=dev, dtype=dtype)
        fn = getattr(lib, f"tnt_zipper_{DTYPE_SUFFIX[dtype]}")
        rc = fn(
            _ptr(fa), _ptr(ma), _ptr(la), _ptr(fb), _ptr(mb), _ptr(lb),
            w.data_ptr(), t.data_ptr(), part.data_ptr(), out.data_ptr(),
            n0, n, nl, ra, rb, d_mid, splits,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(lib, rc, "tt_inner_chain_cuda")
    tt_inner_chain_cuda.launches += 1
    # the kernel's gemm() rounds the split count to whole K steps
    k = rb * n
    kchunk = math.ceil(math.ceil(k / splits) / _SPLIT_BK) * _SPLIT_BK
    return out, device_launches(d_mid, False, math.ceil(k / kchunk) if d_mid else 1)


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
    ``tt_inner_chain_cuda.launches``), and keeps the device launches of
    the last call in ``tt_inner_cuda.last_device_launches``.
    """
    dims = _check_cores(fa, ma, la, fb, mb, lb, "tt_inner_cuda")
    route = _fused if takes_fused_route(dims[3], dims[4]) else _chain
    out, launches = route(fa, ma, la, fb, mb, lb, *dims)
    tt_inner_cuda.launches += 1
    tt_inner_cuda.last_device_launches = launches
    return out


tt_inner_cuda.launches = 0
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
