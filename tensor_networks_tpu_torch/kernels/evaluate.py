"""H2: batched TT evaluation -- CUDA kernel, plain version, router.

Replaces ``tensor_networks_tpu/kernels/pallas_ops.py::tt_evaluate_pallas``
(K3, :424) and ``tensor_networks_tpu/kernels/ragged_eval.py::
tt_evaluate_ragged`` (K4, :107); the kernel source is ``csrc/evaluate.cu``.
Each point gathers exactly its own (r, r) core slice per step (one warp
per point, the block's carries in shared memory), so there is no one-hot
select, no identity padding and no bf16 hi/lo split: those worked around
Mosaic's missing row gather.

What bounds it on the H100: every point streams r*r values per step; at
d=50, n=32, r=100, B=8192 that is ~15.7 GB through L2 for ~7.9 GFLOP, so
it is L2-bandwidth-bound (the ~61 MB of cores mostly stay in the 50 MB
L2).  Grouping points by mode so each slice is read once per group (K4's
idea) is later work.

Routing: :func:`tt_evaluate` sends CUDA tensors to the kernel (which
raises on what it cannot take) and CPU tensors to
:func:`tt_evaluate_plain`.  There is no fallback from the kernel.
"""

from __future__ import annotations

from typing import Optional

import torch

from tensor_networks_tpu_torch.kernels import _build
from tensor_networks_tpu_torch.kernels.zipper import MAX_RANK, _check_precision


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


def tt_evaluate_cuda(
    first: torch.Tensor,
    mids: Optional[torch.Tensor],
    last: torch.Tensor,
    idx: torch.Tensor,
) -> torch.Tensor:
    """Values of the train at ``idx`` through the H2 kernel; (B,).

    Takes contiguous float32 or float64 CUDA cores on one device --
    first (n, r), mids (d-2, r, n, r) or None, last (r, n), r <= 512 --
    and a contiguous int32 (B, d) index matrix on the same device whose
    entries lie in [0, n) (the kernel also clamps, as a memory guard).
    Raises on anything else.  Counts one launch per call in
    ``tt_evaluate_cuda.launches``.
    """
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
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"dtype must be float32 or float64, got {dtype}")
    if idx.device != dev or idx.dtype != torch.int32 or idx.ndim != 2:
        raise ValueError("idx must be a (B, d) int32 tensor on the cores' device")
    n, r = first.shape
    d_mid = 0 if mids is None else mids.shape[0]
    b, d = idx.shape
    if (
        last.shape != (r, n)
        or (mids is not None and mids.shape != (d_mid, r, n, r))
        or d != d_mid + 2
    ):
        raise ValueError(
            "shape mismatch: need first (n, r), mids (d-2, r, n, r), "
            "last (r, n) and idx (B, d)"
        )
    if r > MAX_RANK:
        raise ValueError(f"ranks above {MAX_RANK} are not supported")
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
    _build.check(lib, rc, "tt_evaluate_cuda")
    tt_evaluate_cuda.launches += 1
    return out


tt_evaluate_cuda.launches = 0


def tt_evaluate(first, mids, last, idx, precision: str = "highest"):
    """Values of a uniform TT at in-range (B, d) indices: the H2 kernel
    for CUDA tensors, the plain version for CPU tensors.

    ``precision`` takes the JAX API's values ("highest", "bf16x3",
    "default"); every mode computes in full-precision FMA here, which
    meets each mode's accuracy contract.
    """
    _check_precision(precision)
    if first.is_cuda:
        return tt_evaluate_cuda(
            first, mids, last, idx.to(torch.int32).contiguous()
        )
    return tt_evaluate_plain(first, mids, last, idx)
