"""H2: batched TT evaluation -- CUDA kernel, plain versions, router.

Replaces ``tensor_networks_tpu/kernels/pallas_ops.py::tt_evaluate_pallas``
(K3, :424) and ``tensor_networks_tpu/kernels/ragged_eval.py::
tt_evaluate_ragged`` (K4, :107); the kernel source is ``csrc/evaluate.cu``.

The kernel is grouped by mode, K4's idea.  At step k the points that
share mode i multiply their stacked carries, a (g, r) matrix, by the one
slice ``mids[k][:, i, :]``.  :func:`build_group_tables` sorts each middle
index column (``torch.sort`` on the indices' device, no host read) and
cuts the groups into tiles of at most ``TILE_P`` points; the kernel gives each
tile a block, which gathers its carries through the sort permutation and
writes them back to the same rows, so carries stay in point order.  One
C call runs the d-2 steps (one launch each, stream order between them)
and the final dot with the last core.

What bounds it on the H100: at d=50, n=32, r=100, B=8192 one call is
7.86 GFLOP of FP32 FMA, 117 us at 67 TFLOP/s, over 61 MB of cores, 18 us
at 3.35 TB/s: operation-bound.  A slice is read once per tile (~0.5 GB a
call through L2) instead of once per point (~15.7 GB).  The tile list
is a small kernel of its own on the card: written as torch ops it is
~25 dispatches, which cost the host more than the evaluation costs the
card.  A caller with several trains at the same points builds the
tables once and passes them in.

The kernel takes any rank, end cores with their own mode sizes (first
(n0, r), last (r, nl)), and float32, float64, bfloat16 or float16
cores: 2-byte cores are converted to float32 as they are loaded, the
carries are float32 (allocated by the wrapper), and the values come
back in the cores' dtype.

Routing: :func:`tt_evaluate` sends CUDA tensors to the kernel (which
raises on what it cannot take) and CPU tensors to
:func:`tt_evaluate_plain`.  There is no fallback from the kernel.
:func:`tt_evaluate_grouped_plain` walks the same grouping tables in
torch; the CPU tests hold the tables with it, and nothing on the CUDA
path calls it.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from tensor_networks_tpu_torch.kernels import _build
from tensor_networks_tpu_torch.kernels.zipper import (
    DTYPE_SUFFIX,
    _check_dtype,
    _check_precision,
    acc_dtype,
)

TILE_P = 32  # points per tile; the kernel is instantiated for this size


def tt_evaluate_plain(first, mids, last, idx) -> torch.Tensor:
    """Evaluate a uniform TT at (B, d) integer multi-indices (the plain
    version; the JAX package's ``parallel/sharded.py::tt_evaluate_batched``).

    For modest mode sizes each step is one (B, r) x (r, n*r) matmul
    followed by a row select; large-mode trains use the gather form.
    ``mids`` may be None (d == 2).  Indices must be in range.
    """
    idx = idx.long()
    v = first[idx[:, 0], :]  # (B, r)
    if mids is not None and mids.shape[0] > 0:
        matmul_form = first.shape[0] <= 64
        rows = torch.arange(idx.shape[0], device=idx.device)
        for k, core in enumerate(mids):
            cols = idx[:, k + 1]
            r, n, r2 = core.shape
            if matmul_form:
                u = (v @ core.reshape(r, n * r2)).reshape(-1, n, r2)
                v = u[rows, cols]
            else:
                sel = core[:, cols, :]  # (r, B, r2)
                v = torch.einsum("br,rbs->bs", v, sel)
    sel_last = last[:, idx[:, -1]]  # (r, B)
    return torch.sum(v * sel_last.T, dim=-1)


class GroupTables(NamedTuple):
    """The points of every step, grouped by mode and cut into tiles.

    ``perm`` (d-2, B) int32: row k lists the points in the order of
    their mode at step k (a stable sort of index column k + 1).
    ``tiles`` (d-2, max_tiles, 4) int32: per step, the tiles as
    (step, mode, first row of ``perm[step]``, row count); slots past a
    step's last tile hold zeros.  ``tile_p`` is the tile size the
    tables were cut for.
    """

    perm: torch.Tensor
    tiles: torch.Tensor
    tile_p: int


def max_tiles_per_step(b: int, n: int, tile_p: int = TILE_P) -> int:
    """Upper bound on a step's tile count: every group ends in at most
    one partly filled tile, and the full tiles hold at most B points."""
    return -(-b // tile_p) + n


def group_tiles_plain(
    vals: torch.Tensor, n: int, tile_p: int, max_tiles: int
) -> torch.Tensor:
    """The tile list of sorted mode rows ``vals`` (d-2, B), in torch ops;
    (d-2, max_tiles, 4) int32.  The plain version of the tile-list
    kernel: CPU tensors take it, and the card checks the kernel
    against it."""
    d_mid = vals.shape[0]
    dev = vals.device
    # edges[k, m] = first sorted position of mode m; edges[k, n] = B
    marks = torch.arange(n + 1, device=dev, dtype=vals.dtype).repeat(d_mid, 1)
    edges = torch.searchsorted(vals, marks)
    starts, ends = edges[:, :-1], edges[:, 1:]
    per_mode = (ends - starts + (tile_p - 1)) // tile_p
    last_slot = torch.cumsum(per_mode, dim=1)  # one past each mode's tiles
    slots = torch.arange(max_tiles, device=dev).repeat(d_mid, 1)
    mode = torch.searchsorted(last_slot, slots, right=True)
    used = mode < n
    mode = mode.clamp(max=n - 1)
    first_slot = torch.gather(last_slot - per_mode, 1, mode)
    start = torch.gather(starts, 1, mode) + (slots - first_slot) * tile_p
    count = (torch.gather(ends, 1, mode) - start).clamp(max=tile_p)
    step = torch.arange(d_mid, device=dev)[:, None].expand(d_mid, max_tiles)
    tiles = torch.stack([step, mode, start, count], dim=-1)
    return (tiles * used[..., None]).to(torch.int32)


def group_tiles_cuda(
    vals: torch.Tensor, n: int, tile_p: int, max_tiles: int
) -> torch.Tensor:
    """The same tile list through the tile-list kernel: one launch where
    the torch ops are ~25, which cost the host more than the evaluation
    costs the card.  Takes contiguous int32 CUDA rows; counts its
    launches in ``group_tiles_cuda.launches``."""
    if (
        not vals.is_cuda
        or vals.dtype != torch.int32
        or vals.ndim != 2
        or not vals.is_contiguous()
    ):
        raise ValueError(
            "group_tiles_cuda needs a contiguous (d-2, B) int32 CUDA tensor"
        )
    d_mid, b = vals.shape
    lib = _build.cuda_library()
    with torch.cuda.device(vals.device):
        tiles = torch.empty(
            (d_mid, max_tiles, 4), device=vals.device, dtype=torch.int32
        )
        rc = lib.tnt_group_tiles(
            vals.data_ptr(),
            tiles.data_ptr(),
            b,
            d_mid,
            n,
            max_tiles,
            tile_p,
            torch.cuda.current_stream(vals.device).cuda_stream,
        )
    _build.check(lib, rc, "group_tiles_cuda")
    group_tiles_cuda.launches += 1
    return tiles


group_tiles_cuda.launches = 0


def build_group_tables(
    idx: torch.Tensor, n: int, tile_p: int = TILE_P
) -> GroupTables:
    """Grouping tables of a (B >= 1, d >= 3) index matrix whose middle
    columns address modes of size ``n`` (out-of-range entries clamp).

    A stable ``torch.sort`` of every middle column, then the tile list:
    the tile-list kernel for CUDA indices, torch ops for CPU indices.
    Runs on ``idx``'s device and reads nothing back to the host: the
    tile table has the fixed length :func:`max_tiles_per_step`.
    """
    b, d = idx.shape
    max_tiles = max_tiles_per_step(b, n, tile_p)
    cols = idx[:, 1 : d - 1].t().clamp(0, n - 1)
    if idx.is_cuda:
        cols = cols.to(torch.int32)
    # sorted outputs keep their input's layout: make the rows contiguous
    vals, perm = torch.sort(cols.contiguous(), dim=1, stable=True)
    if idx.is_cuda:
        tiles = group_tiles_cuda(vals, n, tile_p, max_tiles)
    else:
        tiles = group_tiles_plain(vals, n, tile_p, max_tiles)
    return GroupTables(perm.to(torch.int32), tiles, tile_p)


def tt_evaluate_grouped_plain(
    first, mids, last, idx, tile_p: int = TILE_P
) -> torch.Tensor:
    """The kernel's algorithm in torch: per step and tile, gather the
    tile's carries through the permutation, multiply by the tile's one
    slice, write back to the same rows.  For the tests of the grouping
    tables; the CUDA path never calls it.  Indices must be in range."""
    idx = idx.long()
    v = first[idx[:, 0], :]
    if mids is not None and mids.shape[0] > 0:
        tables = build_group_tables(idx, mids.shape[2], tile_p)
        for k, core in enumerate(mids):
            nxt = torch.empty_like(v)
            for _, mode, start, count in tables.tiles[k].tolist():
                if count > 0:
                    rows = tables.perm[k, start : start + count].long()
                    nxt[rows] = v[rows] @ core[:, mode, :]
            v = nxt
    return torch.sum(v * last[:, idx[:, -1]].T, dim=-1)


def _check_eval_args(first, mids, last, idx):
    """Raise on what the kernels do not take; returns
    (B, d, n0, n, nl, r), with n = n0 when there are no middle cores."""
    dev = first.device
    dtype = first.dtype
    if dev.type != "cuda":
        raise ValueError(f"tt_evaluate_cuda needs CUDA tensors, got {dev}")
    cores = [first, last] + ([mids] if mids is not None else [])
    for x in cores:
        if x.device != dev or x.dtype != dtype:
            raise ValueError("all cores must share one CUDA device and dtype")
    for x in cores + [idx]:
        if not x.is_contiguous():
            raise ValueError("cores and indices must be contiguous")
    _check_dtype(dtype)
    if idx.device != dev or idx.dtype != torch.int32 or idx.ndim != 2:
        raise ValueError("idx must be a (B, d) int32 tensor on the cores' device")
    n0, r = first.shape
    nl = last.shape[1] if last.ndim == 2 else -1
    d_mid = 0 if mids is None else mids.shape[0]
    n = n0 if mids is None or mids.ndim != 4 else mids.shape[2]
    b, d = idx.shape
    if (
        last.shape != (r, nl)
        or (mids is not None and mids.shape != (d_mid, r, n, r))
        or d != d_mid + 2
    ):
        raise ValueError(
            "shape mismatch: need first (n0, r), mids (d-2, r, n, r), "
            "last (r, nl) and idx (B, d)"
        )
    return b, d, n0, n, nl, r


def tt_evaluate_cuda(
    first: torch.Tensor,
    mids: Optional[torch.Tensor],
    last: torch.Tensor,
    idx: torch.Tensor,
    tables: Optional[GroupTables] = None,
) -> torch.Tensor:
    """Values of the train at ``idx`` through the H2 kernel; (B,).

    Takes contiguous CUDA cores of one dtype (float32, float64, bfloat16
    or float16) on one device -- first (n0, r), mids (d-2, r, n, r) or
    None, last (r, nl), any r -- and a contiguous int32 (B, d) index
    matrix on the same device whose columns lie in [0, n0), [0, n) and
    [0, nl) (the kernel also clamps, as a memory guard).  Returns the
    values in the cores' dtype.
    ``tables`` are :func:`build_group_tables` of this ``idx`` (built
    here when not given; a caller that evaluates several trains at the
    same points builds them once).  Raises on anything else.  Counts one
    launch per call in ``tt_evaluate_cuda.launches``.
    """
    b, d, n0, n, nl, r = _check_eval_args(first, mids, last, idx)
    dev, dtype = first.device, first.dtype
    out = torch.empty(b, device=dev, dtype=dtype)
    if b == 0:
        return out
    if d > 2:
        if tables is None:
            tables = build_group_tables(idx, n)
        max_tiles = max_tiles_per_step(b, n, tables.tile_p)
        if (
            tables.perm.shape != (d - 2, b)
            or tables.tiles.shape != (d - 2, max_tiles, 4)
            or tables.perm.device != dev
            or tables.tiles.device != dev
            or tables.perm.dtype != torch.int32
            or tables.tiles.dtype != torch.int32
            or not tables.perm.is_contiguous()
            or not tables.tiles.is_contiguous()
        ):
            raise ValueError("grouping tables do not belong to these indices")
        perm_ptr, tiles_ptr = tables.perm.data_ptr(), tables.tiles.data_ptr()
        tile_p = tables.tile_p
    else:
        perm_ptr = tiles_ptr = None
        max_tiles, tile_p = 0, TILE_P

    lib = _build.cuda_library()
    fn = getattr(lib, f"tnt_evaluate_grouped_{DTYPE_SUFFIX[dtype]}")
    with torch.cuda.device(dev):
        # the carries of even and odd steps, in point order
        carry = torch.empty((2, b, r), device=dev, dtype=acc_dtype(dtype))
        rc = fn(
            first.data_ptr(),
            mids.data_ptr() if mids is not None else None,
            last.data_ptr(),
            idx.data_ptr(),
            perm_ptr,
            tiles_ptr,
            carry[0].data_ptr(),
            carry[1].data_ptr(),
            out.data_ptr(),
            b,
            d,
            n0,
            n,
            nl,
            r,
            max_tiles,
            tile_p,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(lib, rc, "tt_evaluate_cuda")
    tt_evaluate_cuda.launches += 1
    return out


tt_evaluate_cuda.launches = 0


def tt_evaluate_per_point_cuda(first, mids, last, idx) -> torch.Tensor:
    """The same values through the per-point kernel the grouped design
    replaced (one warp per point, each reading its own slice); takes
    what :func:`tt_evaluate_cuda` takes.  It is the yardstick that
    ``chip_smoke.py`` and the card tests time and check the grouped
    kernel against; :func:`tt_evaluate` never routes to it.  Unlike the
    grouped kernel it needs float32 or float64 cores, one mode size
    n0 = n = nl and r <= 512 (its registers per lane)."""
    b, d, n0, n, nl, r = _check_eval_args(first, mids, last, idx)
    dev, dtype = first.device, first.dtype
    if dtype not in (torch.float32, torch.float64) or not n0 == n == nl:
        raise ValueError(
            "the per-point kernel needs float32 or float64 cores of one "
            "mode size"
        )
    out = torch.empty(b, device=dev, dtype=dtype)
    if b == 0:
        return out
    lib = _build.cuda_library()
    fn = lib.tnt_evaluate_f32 if dtype == torch.float32 else lib.tnt_evaluate_f64
    with torch.cuda.device(dev):
        rc = fn(
            first.data_ptr(),
            mids.data_ptr() if mids is not None else None,
            last.data_ptr(),
            idx.data_ptr(),
            out.data_ptr(),
            b,
            d,
            n,
            r,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(lib, rc, "tt_evaluate_per_point_cuda")
    tt_evaluate_per_point_cuda.launches += 1
    return out


tt_evaluate_per_point_cuda.launches = 0


def tt_evaluate(first, mids, last, idx, precision: str = "highest"):
    """Values of a uniform TT at in-range (B, d) indices: the H2 kernel
    for CUDA tensors, the plain version for CPU tensors.

    ``precision`` takes the JAX API's values ("highest", "bf16x3",
    "default"); every mode computes in full-precision FMA here (float32
    for 2-byte cores), which meets each mode's accuracy contract.
    """
    _check_precision(precision)
    if first.is_cuda:
        return tt_evaluate_cuda(
            first, mids, last, idx.to(torch.int32).contiguous()
        )
    return tt_evaluate_plain(first, mids, last, idx)
