"""The least time the card could take for a kernel's work: the larger of
the bytes it must move (each input read once, each output written once)
over the memory rate, and its operations over the peak rate for their
type.  Published H100 SXM rates; the measurement scripts set each
kernel's time beside these bounds."""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published
FP32_FLOP_PER_S = 67e12  # H100 SXM, outside the tensor cores, published


def bound(flops, nbytes):
    """(ms, "bytes" | "operations"): the least time the card could take."""
    t_ops, t_bytes = flops / FP32_FLOP_PER_S, nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def inner_bound(a, b):
    """The zipper's bound for packed cores ``a`` and ``b`` (first, mids,
    last): W0 = fa^T fb, two GEMMs per core pair, the epilogue
    <W, la lb^T>; every core read once, one scalar written."""
    n0, ra = a[0].shape
    rb = b[0].shape[1]
    d_mid, _, n, _ = a[1].shape
    nl = a[2].shape[1]
    flops = 2 * n0 * ra * rb + d_mid * (2 * rb * n * ra * ra + 2 * ra * rb * rb * n)
    flops += 2 * ra * rb * nl + 2 * ra * rb
    nbytes = sum(x.numel() * x.element_size() for x in list(a) + list(b)) + a[0].element_size()
    return bound(flops, nbytes)
