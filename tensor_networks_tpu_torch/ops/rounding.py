"""TT rounding -- the exact delta-SVD sweep.

Counterpart of ``tensor_networks_tpu/ops/rounding.py``.  The four
rounding families live in three modules:

* here: :func:`tt_svd_round` -- right-orthogonalize then forward
  delta-SVD truncation, threading the unspent error budget between bonds
  (TTSVD, Oseledets 2011).  The reference-accuracy path.
* :mod:`tensor_networks_tpu_torch.ops.gram` -- Gram-SVD rounding for
  single trains and implicit sums (eigh + GEMMs).
* :mod:`tensor_networks_tpu_torch.ops.randomized` -- sketch-based
  rounding to fixed target ranks, and the sketch-then-SVD hybrid.

The static-shape form of this sweep is ``ops.fast.tt_round_fixed``.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from tensor_networks_tpu_torch.kernels import delta_svd
from tensor_networks_tpu_torch.network import TensorNetwork
from tensor_networks_tpu_torch.ops.fast import sweep_noise_floor
from tensor_networks_tpu_torch.ops.tt import tt_right_orth


def tt_svd_round(tn: TensorNetwork, eps: float) -> TensorNetwork:
    """Round a TT in place: backward QR sweep then forward truncation.

    The first bond consumes a norm-relative budget ``eps/sqrt(dim-1)``;
    whatever error a truncation does not spend carries to the next bond
    (the ``remaining_delta`` bookkeeping in :func:`delta_svd`).  Each bond
    reads its singular values on the host once (the rank decision).
    """
    dim = tn.dim()
    sample = tn.value(list(tn.network.nodes)[0])
    floor = sweep_noise_floor(sample.dtype, dim)
    if eps < floor:
        dtype_name = str(sample.dtype).removeprefix("torch.")
        warnings.warn(
            f"requested relative eps={eps:.1e} is below the ~{floor:.1e} "
            f"noise floor of a {dim}-core {dtype_name} rounding sweep; "
            "truncation may not engage on device. Use float64 inputs or "
            "ops.fast.tt_round_fixed(..., reorth=True).",
            RuntimeWarning,
            stacklevel=2,
        )
    out = tt_right_orth(tn, dim - 1)
    for jj in range(dim - 2, 0, -1):
        out = tt_right_orth(out, jj)

    nodes = list(out.network.nodes)
    first = nodes[0]
    value = out.value(first)
    trunc = delta_svd(value, eps / np.sqrt(dim - 1), with_normalizing=True)
    delta = trunc.delta
    assert delta is not None

    v = trunc.s[:, None] * trunc.v
    out.node_tensor(first).update_val_size(trunc.u)
    out.node_tensor(first + 1).update_val_size(
        torch.tensordot(v, out.value(first + 1), dims=1)
    )

    for node in nodes[1:-1]:
        value = out.value(node)
        r1, n, r2 = value.shape
        trunc = delta_svd(value.reshape(r1 * n, r2), delta)
        v = trunc.s[:, None] * trunc.v
        rank = trunc.u.shape[1]
        out.node_tensor(node).update_val_size(trunc.u.reshape(r1, n, rank))
        out.node_tensor(node + 1).update_val_size(
            torch.tensordot(v, out.value(node + 1), dims=1)
        )
    return out
