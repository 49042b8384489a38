"""Train-sharded TT sweeps: core blocks on the model ranks, carries hopped
between neighbours.

Counterpart of ``tensor_networks_tpu/parallel/sweeps.py``.  The middle
cores are split along the train (block p on model rank p, the pipeline
placement of :func:`place_train_sharded`); the first and last cores are
whole on every rank.  A sweep passes its (r x r) carry from one block to
the next: :func:`_staged_sweep` is the schedule, and the one place it
lives.  The JAX package writes it as a ``shard_map`` program in which
every device runs every stage under ``lax.cond`` and the inactive ones
compute zeros; here a rank computes only its own stage and the carry
moves by a ``batch_isend_irecv`` hop.  The win is memory (d r n r / P a
rank) with P - 1 hops of an (r x r) matrix; the wall is that of one
sequential sweep.
"""

from __future__ import annotations

import math
import os
import warnings

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh

from tensor_networks_tpu_torch.ops.als import _scan
from tensor_networks_tpu_torch.ops.fast import (
    _TINY,
    _bond_bounds,
    _failed,
    _prefix_bonds,
    _trunc_count,
)
from tensor_networks_tpu_torch.parallel import mesh as pm


def _model(mesh: DeviceMesh):
    """The model group, its size and this rank's place in it."""
    return (mesh.get_group("model"), pm.axis_size(mesh, "model"),
            pm.axis_index(mesh, "model"))


def _replicate_from(x: torch.Tensor, mesh: DeviceMesh, src: int) -> torch.Tensor:
    """Model rank ``src``'s ``x`` on every model rank
    (``tensor_networks_tpu/parallel/sweeps.py:30``)."""
    return pm.broadcast(x, mesh.get_group("model"), src)


def _replicate_all(xs, mesh: DeviceMesh, src: int):
    """:func:`_replicate_from` of each tensor of a tuple."""
    return tuple(_replicate_from(x, mesh, src) for x in xs)


def _agree(mesh: DeviceMesh, value) -> float:
    """Model rank 0's value (a 0-d tensor or a host number) as a host
    float on every model rank: a decision every rank must take alike (a
    shift, a squaring count, a ladder's test) comes from one source."""
    if not isinstance(value, torch.Tensor):
        value = torch.tensor(float(value), dtype=torch.float64, device=pm.mesh_device(mesh))
    return float(_replicate_from(value.reshape(()), mesh, 0))


def _memory_order(t: torch.Tensor):
    """The dims of ``t`` from the largest stride down: ``t.permute`` of
    them is contiguous for a dense tensor."""
    return sorted(range(t.dim()), key=lambda i: (-t.stride(i), i))


def _inverse(order):
    inv = [0] * len(order)
    for k, i in enumerate(order):
        inv[i] = k
    return inv


def _carry_orders(mesh: DeviceMesh, key, carry, out, stage: int):
    """The memory order of each tensor of a chain's hopped carry, the
    sending stage's.  A hop sends each tensor in its memory order and
    the receiver rebuilds the sender's strides: an einsum's bits can
    follow its operands' layout (the frame-Gram env is a transposed
    one), and a staged sweep must hand the next stage exactly what the
    fused loop hands its next core.  A chain's layout depends only on
    its body and shapes, so it is broadcast once a mesh (one host read)
    and kept on the mesh."""
    known = mesh.__dict__.setdefault("_tnt_carry_orders", {})
    if key not in known:
        flat = ([i for c in out for i in _memory_order(c)] if out is not None
                else [0] * sum(c.dim() for c in carry))
        flat = _replicate_from(torch.tensor(flat, dtype=torch.int64,
                                            device=pm.mesh_device(mesh)), mesh, stage).tolist()
        orders, k = [], 0
        for c in carry:
            orders.append(flat[k:k + c.dim()])
            k += c.dim()
        known[key] = orders
    return known[key]


def _staged_sweep(mesh: DeviceMesh, chains):
    """The staged pipeline of the train-sharded sweeps
    (``tensor_networks_tpu/parallel/sweeps.py:37``).

    Each chain is ``(reverse, carry, blocks, scan_fn)``: its stages are
    the model ranks, left to right (right to left with ``reverse``); the
    first stage starts from ``carry`` (a tuple of tensors), each runs
    ``ops.als._scan`` of ``scan_fn`` over its local ``blocks`` and hands
    the carry to the next, in the sender's layout (:func:`_carry_orders`).
    Several chains advance together, one stage each per step, with one
    batched hop a step.  A rank computes only its own stages.  Returns,
    per chain, ``(carry in, carry out, ys)`` of this rank's stage, the ys
    a list in block order: on the last stage, carry out is the sweep's
    result."""
    group, parts, me = _model(mesh)
    carries = [tuple(c[1]) for c in chains]
    outs = [None] * len(chains)
    for t in range(parts):
        sends, recvs, pending = [], [], []
        for i, (reverse, _, blocks, scan_fn) in enumerate(chains):
            stage, shift = (parts - 1 - t, -1) if reverse else (t, 1)
            out = None
            if me == stage:
                out, ys = _scan(scan_fn, carries[i], blocks, reverse)
                outs[i] = (carries[i], out, ys)
            if t == parts - 1:
                continue
            key = (scan_fn.__qualname__, reverse,
                   tuple((tuple(c.shape), c.dtype) for c in carries[i]))
            orders = _carry_orders(mesh, key, carries[i], out, stage)
            if me == stage:
                sends += [(c.permute(o), stage + shift) for c, o in zip(out, orders)]
            elif me == stage + shift:
                bufs = [c.new_empty([c.shape[j] for j in o])
                        for c, o in zip(carries[i], orders)]
                recvs += [(b, stage) for b in bufs]
                pending.append((i, bufs, orders))
        pm.hop(group, sends, recvs)
        for i, bufs, orders in pending:
            carries[i] = tuple(b.permute(_inverse(o)) for b, o in zip(bufs, orders))
    return outs


def _local_right_orth_step(c, x):
    """One core of the right-orthogonalization: QR of the core times the
    carry entering from the right (``sweeps.py:80``'s scan step)."""
    (core,) = x
    rr, n, rc = core.shape
    cur = torch.einsum("rnk,kc->rnc", core, c[0])
    q, rmat = torch.linalg.qr(cur.reshape(rr, n * rc).T)
    return (rmat.T,), q.T.reshape(rr, n, rc)


def tt_right_orth_sharded(mesh: DeviceMesh, mids: torch.Tensor, last: torch.Tensor):
    """Right-orthogonalize a uniform TT whose middle cores are sharded
    along the train (``tensor_networks_tpu/parallel/sweeps.py:94``).

    ``mids`` is this rank's block of middle cores, ``last`` (r, n) is
    whole.  Returns (the carry for the first core, the same on every
    rank; the orthogonalized block; the orthogonalized last core)."""
    r = last.shape[0]
    ql, rl = torch.linalg.qr(last.T)
    if ql.shape[1] < r:  # rank-deficient end bond: zero-padded
        ql = F.pad(ql, (0, r - ql.shape[1]))
        rl = F.pad(rl, (0, 0, 0, r - rl.shape[0]))
    [(_, (carry,), out)] = _staged_sweep(
        mesh, [(True, (rl.T,), (mids,), _local_right_orth_step)]
    )
    return _replicate_from(carry, mesh, 0), torch.stack(out), ql.T.contiguous()


def _own_slice(mesh: DeviceMesh, count: int) -> slice:
    """This model rank's block of ``count`` middle cores."""
    parts, me = pm.axis_size(mesh, "model"), pm.axis_index(mesh, "model")
    if count % parts != 0:
        raise ValueError(
            f"train sharding needs the middle-core count ({count}) "
            f"divisible by the model axis ({parts}); pad the train or "
            "choose a different mesh"
        )
    blk = count // parts
    return slice(me * blk, (me + 1) * blk)


def _block(mesh: DeviceMesh, mids, count: int) -> torch.Tensor:
    """This rank's block of stacked middle cores, on its device: ``mids``
    holds all ``count`` of them (the same on every rank; sliced here, as
    the JAX package's ``device_put`` shards a global array) or is
    already this rank's block (a solver's result)."""
    mids = torch.as_tensor(mids)
    if mids.shape[0] == count:
        mids = mids[_own_slice(mesh, count)]
    elif mids.shape[0] * pm.axis_size(mesh, "model") != count:
        raise ValueError(
            f"{mids.shape[0]} middle cores are neither the train's {count} "
            "nor this rank's block of them"
        )
    return mids.to(pm.mesh_device(mesh)).contiguous()


def _norm_sharded(mesh: DeviceMesh, first, mids, last) -> torch.Tensor:
    """Backward-stable norm of a train-sharded train
    (``tensor_networks_tpu/parallel/als.py:262``): the distributed
    right-orthogonalization, then the norm of the folded first core --
    ``packed.norm_exact``'s contract, never the cancelling zipper.  The
    same 0-d tensor on every rank (model rank 0's)."""
    carry, _, _ = tt_right_orth_sharded(mesh, mids, last)
    return _replicate_from(torch.linalg.norm(first @ carry), mesh, 0)


def _place(mesh: DeviceMesh, *stacks):
    """This rank's block of each global middle-core stack (NumPy or
    tensors of one length, the same on every rank), on its device; None
    stays None."""
    own = _own_slice(mesh, torch.as_tensor(stacks[0]).shape[0])
    dev = pm.mesh_device(mesh)
    return tuple(None if t is None else torch.as_tensor(t)[own].to(dev).contiguous()
                 for t in stacks)


def place_train_sharded(mesh: DeviceMesh, mids, last):
    """This rank's block of the middle cores and the whole last core, on
    its device (``tensor_networks_tpu/parallel/sweeps.py:162``).  Takes the
    global cores (NumPy or tensors, the same on every rank)."""
    (mids,) = _place(mesh, mids)
    return mids, torch.as_tensor(last).to(pm.mesh_device(mesh))


def _zip_step(w, x):
    """One core pair of the zipper (``sweeps.py:197``'s scan step)."""
    ca, cb = x
    ra, n, ra2 = ca.shape
    rb, _, rb2 = cb.shape
    t = (w[0].T @ ca.reshape(ra, n * ra2)).reshape(rb * n, ra2)
    return (t.T @ cb.reshape(rb * n, rb2),), None


def tt_inner_train_sharded(mesh: DeviceMesh, first_a, mids_a, last_a,
                           first_b, mids_b, last_b) -> torch.Tensor:
    """Inner product of two train-sharded TTs: each rank zips its block,
    the (r_a x r_b) carry hops to the next
    (``tensor_networks_tpu/parallel/sweeps.py:178``).  The same 0-d tensor
    on every rank."""
    _, parts, _ = _model(mesh)
    [(_, (w,), _)] = _staged_sweep(
        mesh, [(False, (first_a.T @ first_b,), (mids_a, mids_b), _zip_step)]
    )
    w = _replicate_from(w, mesh, parts - 1)
    return torch.sum(w * (last_a @ last_b.T))


# ---------------------- distributed Gram rounding ----------------------


def _gram_truncate(gl, gr, budget, kmax):
    """Masked static-shape bond truncation from the left and right Grams
    (``tensor_networks_tpu/parallel/sweeps.py:265``): (curr (r, r) to fold
    into the left core, nxt (r, r) into the right one, kept rank).  The
    eigendecompositions and the SVD run in float64 whatever the Grams'
    dtype (the port's Gram families do; the JAX package factorizes
    float32 Grams in float32).  ``kmax`` caps the kept rank at the bond's
    structural bound: Gram-squaring noise past it is never kept."""
    dt = gl.dtype
    eigl, vl = torch.linalg.eigh(gl.double())
    eigr, vr = torch.linalg.eigh(gr.double())

    def roots(eig):
        half = torch.sqrt(torch.abs(eig))
        half = torch.where(half <= torch.max(half) * 1e-8, 0.0, half)
        inv = torch.where(half == 0.0, 0.0, 1.0 / torch.where(half == 0.0, 1.0, half))
        return half, inv

    l12, lm12 = roots(eigl)
    r12, rm12 = roots(eigr)
    cross = (l12[:, None] * vl.T) @ (vr * r12[None, :])
    u, s, vt = torch.linalg.svd(cross, full_matrices=False)
    k = torch.minimum(_trunc_count(s, budget.double()), kmax)
    m = (torch.arange(s.shape[0], device=s.device) < k).to(s.dtype)
    curr = vl @ (lm12[:, None] * (u * m[None, :]))
    nxt = ((m * s)[:, None] * vt * rm12[None, :]) @ vr.T
    return curr.to(dt), nxt.to(dt), k


def _train_shard_meta(mesh: DeviceMesh, first, mids, last, bounds):
    """``(stages, global d, per-bond bounds on the cores' device)`` of a
    train-sharded sweep (``tensor_networks_tpu/parallel/sweeps.py:291``);
    ``mids`` is this rank's block, the bounds default to the structural
    ones of the global train (``ops/fast._bond_bounds``)."""
    parts = pm.axis_size(mesh, "model")
    if mids.shape[0] == 0:
        raise ValueError("each model rank needs at least one middle core")
    r = last.shape[0]
    d = parts * mids.shape[0] + 2
    if bounds is None:
        modes = [first.shape[0]] + [mids.shape[2]] * (d - 2) + [last.shape[1]]
        bounds = _bond_bounds(modes, [r] * (d - 1), r)
    bounds = torch.as_tensor(bounds, dtype=torch.int64, device=mids.device)
    return parts, d, bounds


def _gram_step(g, x):
    """The Gram of everything right of a core, from the one right of it
    (``sweeps.py:360``'s scan step)."""
    (core,) = x
    s = core.shape
    tmp = (core.reshape(-1, s[-1]) @ g[0]).reshape(-1, s[-2] * s[-1])
    g_new = tmp @ core.reshape(-1, s[-2] * s[-1]).T
    return (g_new,), g_new


def tt_gram_round_sharded(mesh: DeviceMesh, first, mids, last, eps: float, bounds=None):
    """Distributed TT rounding (Gram-SVD, IPDPS'22) of a train-sharded TT
    at relative ``eps`` (``tensor_networks_tpu/parallel/sweeps.py:314``).

    No orthogonalization: a backward sweep of right Grams (GEMMs only),
    then a forward truncation sweep from each bond's two Grams, each
    staged over the model ranks.  Truncated directions are zero-masked.
    Returns (first, this rank's block, last, the first bond's kept rank,
    this block's kept ranks); first, last and the first rank are the
    same on every rank.  Resolution floor: singular values below
    sqrt(dtype eps) of the norm."""
    parts, d, bounds = _train_shard_meta(mesh, first, mids, last, bounds)
    _, _, me = _model(mesh)
    blk = mids.shape[0]
    r = last.shape[0]

    # ---- stage A (right to left): the right Grams ----------------------
    [(g_in, (g_out,), grams)] = _staged_sweep(
        mesh, [(True, (last @ last.T,), (mids,), _gram_step)]
    )
    # the forward step at local core j needs the Gram right of it: the
    # backward scan's output at j + 1, the stage's entry carry at the end
    gr_local = grams[1:] + [g_in[0]]
    g_bond0 = _replicate_from(g_out, mesh, 0)
    norm = torch.sqrt(torch.abs(torch.sum((first @ g_bond0) * first)))
    budget = eps * norm / math.sqrt(d - 1.0)

    # ---- stage B (left to right): the truncation sweep -----------------
    kmax0 = torch.clamp(bounds[0], max=min(first.shape[0], r))
    curr0, nxt0, k0 = _gram_truncate(first.T @ first, g_bond0, budget, kmax0)

    def fwd_step(carry, x):
        carry_nxt, kprev = carry
        core, gr, bound = x
        rr, n, rc = core.shape
        mat = torch.einsum("ak,knc->anc", carry_nxt, core).reshape(-1, rc)
        kmax = torch.minimum(torch.clamp(kprev * n, max=rc), bound)
        curr, nxt, k = _gram_truncate(mat.T @ mat, gr, budget, kmax)
        return (nxt, k), ((mat @ curr).reshape(rr, n, rc), k)

    own = bounds[1 + me * blk:1 + (me + 1) * blk]
    [(_, (nxt_last, _), ys)] = _staged_sweep(
        mesh, [(False, (nxt0, k0), (mids, gr_local, own), fwd_step)]
    )
    mids_out, ranks = (torch.stack(c) for c in zip(*ys))
    nxt_last = _replicate_from(nxt_last, mesh, parts - 1)
    return first @ curr0, mids_out, nxt_last @ last, k0, ranks


def tt_prefix_round_sharded(
    mesh: DeviceMesh,
    first,
    mids,
    last,
    eps: float,
    sign_iters: int = 100,
    bounds=None,
    chain_precision: str | None = None,
):
    """Distributed parallel-prefix rounding at relative ``eps``: the
    GEMM-only Gram-chain mode of ``ops/fast.tt_round_fixed(method="prefix")``
    on a train-sharded TT (``tensor_networks_tpu/parallel/sweeps.py:503``).

    * The left (H) and right (G) Gram chains advance in one staged loop:
      at step t rank t advances H over its block while rank P-1-t
      advances G, so both finish in P stages.
    * Everything after the chains (the whitening Cholesky, the sign
      projectors, the bases, the insertions) is batched over each rank's
      L+1 bonds with no communication (``ops/fast._prefix_bonds``).
    * Each boundary bond has a single source: the rank owning it as its
      right boundary ships ``b^T`` (one more (r x r) hop) to its right
      neighbour, so the inserted ``a b^T`` comes from one projector.

    ``chain_precision`` (default: ``TNT_PREFIX_CHAIN_PREC``, then
    "highest"): "dw" carries the chains in float64 and adds the trust
    filters; "high" and "highest" carry them in the cores' dtype.  A
    Cholesky breakdown (a non-finite result on any rank) falls back to
    :func:`tt_gram_round_sharded` with a ``RuntimeWarning`` and a
    ``ROUND_STATS["fallback_nan"]`` count.  Returns what
    :func:`tt_gram_round_sharded` returns."""
    from tensor_networks_tpu_torch.ops.fast import ROUND_STATS

    if chain_precision is None:
        chain_precision = os.environ.get("TNT_PREFIX_CHAIN_PREC", "highest")
    _, _, bounds = _train_shard_meta(mesh, first, mids, last, bounds)
    out = _prefix_sharded(mesh, first, mids, last, bounds, eps, sign_iters,
                          chain_precision)
    group = mesh.get_group("model")
    f, m, l = out[:3]
    bad = (~torch.isfinite(torch.sum(f) + torch.sum(m) + torch.sum(l))).to(torch.int32)
    if bool(pm.all_reduce(bad, group, op=dist.ReduceOp.MAX)):
        ROUND_STATS["fallback_nan"] += 1
        warnings.warn(
            "distributed prefix rounding broke down (NaN — Cholesky on "
            "a heavily rank-deficient train); falling back to the "
            "eigh-based distributed gram sweep",
            RuntimeWarning,
            stacklevel=2,
        )
        return tt_gram_round_sharded(mesh, first, mids, last, eps, bounds)
    return out


def _chain_step(m, x):
    """One step of a normalized Gram chain: out[c, C] = sum M[a, b]
    X[a, n, c] X[b, n, C] over its trace / r (``sweeps.py:650``'s
    ``h_step``; ``g_step`` is the same on the core reversed)."""
    (core,) = x
    t = torch.einsum("ab,anc->bnc", m[0], core)
    m2 = torch.einsum("bnc,bnC->cC", t, core)
    m2 = m2 / (torch.trace(m2) / m2.shape[0] + _TINY)
    return (m2,), m2


def _prefix_sharded(mesh, first, mids, last, bounds, eps, sign_iters, chain_precision):
    """The raw result of :func:`tt_prefix_round_sharded`, before its
    breakdown check (``tensor_networks_tpu/parallel/sweeps.py:579``)."""
    group, parts, me = _model(mesh)
    dt = first.dtype
    r = last.shape[0]
    blk = mids.shape[0]
    d = parts * blk + 2
    dw = chain_precision == "dw"
    cdt = torch.float64 if dw else dt

    def start(x):
        return (x / (torch.trace(x) / r + _TINY)).to(cdt)

    # ---- both chains in one staged loop: H forward, G backward over the
    # cores reversed end for end (the same step form) ---------------------
    xs = mids.to(cdt)
    h_chain, g_chain = _staged_sweep(mesh, [
        (False, (start(first.T @ first),), (xs,), _chain_step),
        (True, (start(last @ last.T),), (xs.permute(0, 3, 2, 1),), _chain_step),
    ])
    (h_in,), _, hs = h_chain
    (g_in,), _, gs = g_chain
    # this rank's bonds base .. base + L: H at the block's entry, then
    # after each core; G after each core, then at the block's exit
    h_b = torch.stack([h_in] + hs).to(dt)
    g_b = torch.stack(gs + [g_in]).to(dt)

    norm2 = torch.einsum("kab,kba->k", h_b, g_b)
    eps_b = torch.as_tensor(eps, dtype=dt, device=first.device)
    tau2 = eps_b**2 * norm2 / ((d - 1.0) * r)
    own = bounds[me * blk:me * blk + blk + 1]
    for escalate in (False, True):
        fails: list = []
        ks, a_ins, bt_ins = _prefix_bonds(h_b, g_b, tau2, own, dw, sign_iters,
                                          escalate, fails)
        if escalate or not bool(_failed(fails, h_b)):
            break

    # ---- the boundary bond's b^T from the left neighbour ----------------
    bt0 = bt_ins[0] if me == 0 else torch.empty_like(bt_ins[0])
    pm.hop(group,
           [(bt_ins[blk], me + 1)] if me < parts - 1 else [],
           [(bt0, me - 1)] if me > 0 else [])
    bt_use = torch.cat([bt0[None], bt_ins[1:blk]])
    mids_out = torch.einsum("kma,kanb,kbp->kmnp", bt_use, mids, a_ins[1:]).contiguous()
    first_out = _replicate_from(first @ a_ins[0], mesh, 0)
    last_out = _replicate_from(bt_ins[blk] @ last, mesh, parts - 1)
    k0 = _replicate_from(ks[0], mesh, 0)
    return first_out, mids_out, last_out, k0, ks[1:]
