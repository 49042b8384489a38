"""H1: the TT inner-product zipper -- CUDA kernel, plain version, router.

Replaces the JAX package's Pallas zippers
``tensor_networks_tpu/kernels/pallas_ops.py::tt_inner_pallas`` (K1, :502)
and ``::tt_inner_pallas_fused`` (K2, :229); the kernel source is
``csrc/zipper.cu``.  One C call runs the whole inner product (prologue
GEMM, two GEMM launches per middle core pair with stream order as the
step boundary, one epilogue), so one wrapper call is one inner product,
as K2 was one dispatch.

What bounds it on the H100: at d=50, n=32, r=100 one inner product is
~6.1 GFLOP over ~123 MB of cores, so it is FP32-FMA-bound: ~90 us at
67 TFLOP/s against ~37 us at 3.35 TB/s.  This first version uses plain
FMA tiles, no tensor cores; making it fast is later work.

Routing: :func:`tt_inner` sends CUDA tensors to the kernel (which raises
on what it cannot take) and CPU tensors to :func:`tt_inner_plain`.  There
is no fallback from the kernel to the plain version.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from tensor_networks_tpu_torch.kernels import _build

PRECISIONS = ("highest", "bf16x3", "default")
MAX_RANK = 512
_SPLIT_TILE = 64  # the kernel's GEMM output tile edge
_SPLIT_BK = 16  # the kernel's GEMM K step


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


def _check_precision(precision: str) -> None:
    if precision not in PRECISIONS:
        raise ValueError(
            f"precision must be one of {PRECISIONS}, got {precision!r}"
        )


def _splits(device: torch.device, ra: int, rb: int, k: int) -> int:
    """K-splits for the step's second GEMM: enough partial tiles for two
    blocks per SM, at most one split per K step."""
    tiles = math.ceil(ra / _SPLIT_TILE) * math.ceil(rb / _SPLIT_TILE)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(math.ceil(2 * sms / tiles), math.ceil(k / _SPLIT_BK)))


def tt_inner_cuda(
    fa: torch.Tensor,
    ma: Optional[torch.Tensor],
    la: torch.Tensor,
    fb: torch.Tensor,
    mb: Optional[torch.Tensor],
    lb: torch.Tensor,
) -> torch.Tensor:
    """<a, b> through the H1 kernel; returns a 0-d tensor.

    Takes contiguous float32 or float64 CUDA tensors on one device:
    fa (n0, r_a), ma (d-2, r_a, n, r_a) or None, la (r_a, nl), and the
    same for b with its own rank r_b <= 512.  Raises on anything else.
    Counts one launch per call in ``tt_inner_cuda.launches``.
    """
    tensors = [fa, la, fb, lb] + [m for m in (ma, mb) if m is not None]
    dev = fa.device
    dtype = fa.dtype
    if dev.type != "cuda":
        raise ValueError(f"tt_inner_cuda needs CUDA tensors, got {dev}")
    for x in tensors:
        if x.device != dev or x.dtype != dtype:
            raise ValueError("all cores must share one CUDA device and dtype")
        if not x.is_contiguous():
            raise ValueError("cores must be contiguous")
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"dtype must be float32 or float64, got {dtype}")
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
    if max(ra, rb) > MAX_RANK:
        raise ValueError(f"ranks above {MAX_RANK} are not supported")

    lib = _build.cuda_library()
    splits = _splits(dev, ra, rb, rb * n) if d_mid else 1
    with torch.cuda.device(dev):
        w = torch.empty(ra * rb, device=dev, dtype=dtype)
        t = torch.empty(max(rb * n * ra, 1), device=dev, dtype=dtype)
        part = torch.empty(splits * ra * rb, device=dev, dtype=dtype)
        out = torch.empty((), device=dev, dtype=dtype)
        fn = lib.tnt_zipper_f32 if dtype == torch.float32 else lib.tnt_zipper_f64
        rc = fn(
            fa.data_ptr(),
            ma.data_ptr() if ma is not None else None,
            la.data_ptr(),
            fb.data_ptr(),
            mb.data_ptr() if mb is not None else None,
            lb.data_ptr(),
            w.data_ptr(),
            t.data_ptr(),
            part.data_ptr(),
            out.data_ptr(),
            n0,
            n,
            nl,
            ra,
            rb,
            d_mid,
            splits,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(lib, rc, "tt_inner_cuda")
    tt_inner_cuda.launches += 1
    return out


tt_inner_cuda.launches = 0


def tt_inner(fa, ma, la, fb, mb, lb, precision: str = "highest"):
    """<a, b> of two packed trains: the H1 kernel for CUDA tensors, the
    plain zipper for CPU tensors.

    ``precision`` takes the JAX API's values ("highest", "bf16x3",
    "default"); every mode computes in full-precision FMA here, which
    meets each mode's accuracy contract (bf16x3 ~1e-6 relative, default
    bf16-level).
    """
    _check_precision(precision)
    if fa.is_cuda:
        return tt_inner_cuda(fa, ma, la, fb, mb, lb)
    return tt_inner_plain(fa, ma, la, fb, mb, lb)
