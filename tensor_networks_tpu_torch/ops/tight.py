"""Tight-truncation-budget TT rounding in float64.

Counterpart of ``tensor_networks_tpu/ops/tight.py``: ``tt_svd_round``'s
semantics with ``delta_svd``'s remaining-budget rule, at budgets far
below the float32 sweeps' noise floor.  The JAX package rebuilds ~76-bit
arithmetic out of float32 GEMMs (double- and triple-word words, Ozaki
splits, whitening passes and Newton-Schulz polish) because the TPU has
no float64.  The H100 has it, so none of that is carried over: every
core is cast to float64, rounded, and cast back to the input's dtype.

* **Backward sweep.**  Right-orthogonalization of cores d-1 .. 1 with
  Householder QR (cuSOLVER on the card), as in ``ops/fast.py``.
* **Spectra without squaring.**  A Gram matrix in float64 resolves
  singular values only down to ~1.5e-8 of the largest (the square root
  of float64's epsilon).  Here each bond's spectrum is taken from the R
  factor of a left-orthogonalizing QR sweep: if the bond's left
  unfolding is ``Q R`` and ``R = U S V^T``, its singular values are
  ``S``, to float64's own resolution.
* **The rank rule on the host** (:func:`_host_truncate`, the JAX
  package's own): the remaining squared budget is split equally over
  the bonds not yet processed, and a bond never keeps more than its
  structural rank.

Two forward sweeps, as in the JAX package:

- ``sweep="batched"`` (default), the projector form: one QR sweep of the
  *untruncated* right-orthogonal train gives every bond's R factor; one
  batched SVD of the (d-1, r, r) stack, one fetch of its singular
  values, the rule on every bond, one upload of the kept ranks, and
  every output core from one batched product.  Output core k is
  ``(U_{k-1}^T (x) I) Q_k U_k``, cut to the kept columns: no division by
  a singular value.  Truncation reads the untruncated spectra, so the
  dropped mass may be counted twice across bonds: never above the
  budget, at times a rank more.  The host syncs are a fixed few a call,
  whatever d.
- ``sweep="sequential"``: the exact truncate-then-carry recursion: per
  bond one QR, one SVD, one fetch of its singular values.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from tensor_networks_tpu_torch.network import TensorNetwork
from tensor_networks_tpu_torch.ops.fast import (
    _chain_padded,
    _qr,
    emit_chain,
    stack_tt_cores,
)


def _host_truncate(sigma, budget2_remaining, bonds_left, max_rank):
    """float64 rank rule on one bond's singular values (descending).

    Equal split of the remaining squared budget across unprocessed
    bonds (the reference's remaining-delta bookkeeping): the bond may
    drop tail mass up to ``remaining / bonds_left``; what it does not
    use stays in the pool.  ``max_rank`` is the structural rank of the
    bond matricization: directions past it are roundoff and are never
    kept.  Returns (kept rank, dropped squared mass).
    """
    lam = np.asarray(sigma, np.float64)[::-1] ** 2  # ascending
    allow2 = budget2_remaining / max(bonds_left, 1)
    tail = np.cumsum(lam)
    drop = int(np.searchsorted(tail, allow2, side="right"))
    k = min(max(lam.shape[0] - drop, 1), max_rank)
    drop = lam.shape[0] - k
    dropped = float(tail[drop - 1]) if drop > 0 else 0.0
    return k, dropped


def _qr_padded(mat: torch.Tensor, width: int):
    """Reduced QR with Q zero-padded to ``width`` columns and R to
    ``width`` rows, so a rank-deficient unfolding keeps its shape (the
    zero directions are inert)."""
    q, rmat = _qr(mat, False)
    if q.shape[1] < width:
        q = F.pad(q, (0, width - q.shape[1]))
        rmat = F.pad(rmat, (0, 0, 0, width - rmat.shape[0]))
    return q, rmat


def _backward(first, mids, last):
    """Right-orthogonalize cores d-1 .. 1: ``(first_c, mids_q, last_q)``
    with orthonormal (or zero) rows in every unfolding of ``mids_q`` and
    ``last_q``; ``first_c`` (n, r) carries the train's content."""
    r = last.shape[0]
    ql, rl = _qr_padded(last.T, r)
    carry = rl.T
    mids_q = torch.empty_like(mids)
    for k in range(mids.shape[0] - 1, -1, -1):
        rr, n, rc = mids[k].shape
        cur = (mids[k].reshape(rr * n, rc) @ carry).reshape(rr, n * rc)
        q, rmat = _qr_padded(cur.T, rr)
        carry = rmat.T
        mids_q[k] = q.T.reshape(rr, n, rc)
    return first @ carry, mids_q, ql.T


def tt_round_tight(
    tn: TensorNetwork,
    eps: float,
    relative: bool = True,
    sweep: str = "batched",
) -> Tuple[TensorNetwork, List[int]]:
    """Round a TT chain at tight budgets (down to ~1e-15 relative).

    Matches ``tt_svd_round`` with ``delta_svd``'s remaining-budget rule:
    the error is at most ``eps`` times the norm (``relative``) or
    ``eps``.  Ragged ranks, mixed mode sizes and any core layout go
    through :func:`~.fast._chain_padded`.  Returns the rounded network,
    its cores in the input's dtype, and the kept rank per bond.  See the
    module docstring for the two ``sweep`` forms.
    """
    if sweep not in ("batched", "sequential"):
        raise ValueError(f"unknown sweep {sweep!r}")
    emit = None
    try:
        first, mids, last = stack_tt_cores(tn)
    except ValueError:
        packed = _chain_padded(tn)
        if packed is None:
            raise
        first, mids, last, emit = packed
    if mids is None:
        raise ValueError("tt_round_tight needs d >= 3")
    dt = first.dtype
    first_c, mids_q, q_last = _backward(
        *(x.to(torch.float64) for x in (first, mids, last))
    )
    forward = _forward_batched if sweep == "batched" else _forward_sequential
    cores, ranks = forward(first_c, mids_q, q_last, eps, relative,
                           min(first.shape[0], first.shape[1]))
    first_out, mids_out, last_out = (
        [c.to(dt) for c in x] if isinstance(x, list) else x.to(dt)
        for x in cores
    )
    return emit_chain(tn, first_out, mids_out, last_out, ranks, emit)


def _budget2(norm2: float, eps: float, relative: bool) -> float:
    return (eps**2) * norm2 if relative else float(eps) ** 2


def _forward_batched(first_c, mids_q, q_last, eps, relative, bound0):
    """The projector form: every bond's R factor from one QR sweep of
    the untruncated train, one batched SVD and one fetch, every rank
    rule on the host, one upload, every core from one batched product."""
    r = q_last.shape[0]
    nb, n = mids_q.shape[0] + 1, mids_q.shape[2]
    q0, carry = _qr_padded(first_c, r)
    qs, rs = [], [carry]
    for core in mids_q:
        rr, nn, rc = core.shape
        cur = (carry @ core.reshape(rr, nn * rc)).reshape(rr * nn, rc)
        q, carry = _qr_padded(cur, rc)
        qs.append(q)
        rs.append(carry)
    u, s, vh = torch.linalg.svd(torch.stack(rs))
    s_host = s.cpu().numpy()  # the one fetch: every bond's spectrum

    remaining = _budget2(float(np.sum(s_host[0] ** 2)), eps, relative)
    ranks: List[int] = []
    for k in range(nb):
        bound = bound0 if k == 0 else min(ranks[-1] * n, r)
        kept, used = _host_truncate(s_host[k], remaining, nb - k, bound)
        remaining -= used
        ranks.append(kept)

    kept_t = torch.as_tensor(ranks).to(first_c.device)  # the one upload
    cols = torch.arange(r, device=first_c.device)
    u = u * (cols[None, None, :] < kept_t[:, None, None]).to(u.dtype)
    first_out = q0 @ u[0]
    # core k = (U_{k-1}^T (x) I) Q_k U_k on every middle bond at once
    right = torch.stack(qs) @ u[1:]  # (d-2, r n, r)
    mids_out = (
        u[:-1].transpose(1, 2) @ right.reshape(nb - 1, r, n * r)
    ).reshape(nb - 1, r, n, r)
    carry = (s[-1] * (cols < kept_t[-1]).to(s.dtype))[:, None] * vh[-1]
    return (first_out, mids_out, carry @ q_last), ranks


def _forward_sequential(first_c, mids_q, q_last, eps, relative, bound0):
    """The exact recursion: per bond QR of the truncated carry times the
    next core, SVD of its R factor, one fetch, the rule, the core
    ``Q U`` cut to the kept rank and the carry ``S V^T``."""
    nb = mids_q.shape[0] + 1

    def split(cur, remaining, bonds_left, bound):
        q, rmat = _qr(cur, False)
        u, s, vh = torch.linalg.svd(rmat, full_matrices=False)
        s_host = s.cpu().numpy()  # one fetch a bond
        if remaining is None:
            remaining = _budget2(float(np.sum(s_host**2)), eps, relative)
        kept, used = _host_truncate(s_host, remaining, bonds_left, bound)
        return q @ u[:, :kept], s[:kept, None] * vh[:kept], kept, remaining - used

    first_out, carry, kept, remaining = split(first_c, None, nb, bound0)
    ranks = [kept]
    mids_out = []
    for i, core in enumerate(mids_q):
        rr, n, rc = core.shape
        cur = (carry @ core.reshape(rr, n * rc)).reshape(kept * n, rc)
        out, carry, nxt, remaining = split(
            cur, remaining, nb - 1 - i, min(kept * n, rc)
        )
        mids_out.append(out.reshape(kept, n, nxt))
        kept = nxt
        ranks.append(kept)
    return (first_out, mids_out, carry @ q_last), ranks
