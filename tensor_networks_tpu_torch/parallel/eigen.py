"""Train-sharded DMRG eigensolver: ground and excited states whose trains
and env chains are split along the train.

Counterpart of ``tensor_networks_tpu/parallel/eigen.py``.  The iterate,
the operator, the optional mass operator, the deflation trains and every
env chain (operator, metric, penalty) are split along the mesh's
``model`` axis.  The mid cores run the scan bodies of the port's fused
sweep (``ops/eigen._eig_fwd_body_of`` and the rest) through
:func:`sweeps._staged_sweep`; the boundary cores are solved on every
rank, and the Rayleigh values are read where the fused sweep reads them.
A carry holds what is there: the penalty env only when deflating.

The Lanczos locals warm-start from the iterate the sweep holds, as the
port's fused sweep does (``ops/eigen.py``'s fused-sweep note): the
``(r x r)`` factor an orthogonalization leaves behind rides the carry
and the rank that owns the next core applies it, so the einsums are the
single-device ones.  The JAX package warm-starts from the core as it was
before the factor moved; its Lanczos iterates are not this solver's.

Operators are passed whole (the same on every rank); trains whole or as
this rank's block.  Results hold this rank's block of the middle cores.
Every decision (the stop test, the default shift, the adaptive ladder's
test) reads a value broadcast from model rank 0.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh

from tensor_networks_tpu_torch.ops.als import (
    _columns,
    _left_orth,
    _ones,
    _packed_of,
    _read_stop,
    _right_orth,
)
from tensor_networks_tpu_torch.ops.eigen import (
    _adv_left,
    _adv_right,
    _default_shift,
    _eig_bwd_body_of,
    _eig_fwd_body_of,
    _eig_renv_body_of,
    _EigHelpers,
    _fac_left,
    _fac_right,
    _into_left,
    _into_right,
)
from tensor_networks_tpu_torch.ops.packed import PackedTT, PackedTTOp, pad_rank, scale
from tensor_networks_tpu_torch.parallel import mesh as pm
from tensor_networks_tpu_torch.parallel.als import _enrich_span_sharded
from tensor_networks_tpu_torch.parallel.evolve import (
    _block_op,
    _block_train,
    _canonical,
    add_sharded,
    ttop_apply_sharded,
)
from tensor_networks_tpu_torch.parallel.sweeps import (
    _agree,
    _model,
    _norm_sharded,
    _place,
    _replicate_all,
    _replicate_from,
    _staged_sweep,
    tt_inner_train_sharded,
)

__all__ = [
    "als_eigsh_adaptive_sharded",
    "als_eigsh_k_sharded",
    "als_eigsh_sharded",
    "place_eigsh_sharded",
]


def _eig_sweep_blocks(mesh, h: _EigHelpers, x0c, X, xlc, a0, Am, al, mstk, vstk, shift,
                      renvs=None):
    """``ops/eigen._eig_sweep_impl`` on this rank's block: the same calls on
    the same operands, the mid-core scans staged over the ranks."""
    _, parts, _ = _model(mesh)
    one3 = _ones(x0c.dtype, x0c.device, 1, 1, 1)
    m0, Mm, ml = mstk if h.use_mass else (None, None, None)
    v0, VM, vl = vstk if h.use_pen else (None, None, None)
    cores = h.cores(Am, Mm, VM)

    if renvs is None:
        [(_, front, ys)] = _staged_sweep(mesh, [(
            True, h.envs(_adv_right(one3, xlc, al), h.g_adv_r(h.g_seed(), xlc, ml),
                         h.p_adv_r(h.p_seed(), xlc, ml, vl)),
            (X,) + cores, _eig_renv_body_of(h))])
        chains = _columns(ys)
        front = _replicate_all(front, mesh, 0)
    else:
        chains, front = renvs

    R, Rg, Rb = h.unenvs(front)
    pens = h.pens_of(h.p_seed(), Rb, m0, v0, x0c.numel())
    _, vec = h.solve(one3, R, h.g_seed(), Rg, a0, m0, pens, shift, warm=x0c)
    vec = vec.reshape(x0c.shape)
    q0 = _left_orth(vec)
    carry = (_fac_right(vec, q0),) + h.envs(
        _adv_left(one3, q0, a0), h.g_adv_l(h.g_seed(), q0, m0),
        h.p_adv_l(h.p_seed(), q0, m0, v0))
    [(_, back, ys)] = _staged_sweep(mesh, [(
        False, carry, (X,) + cores + tuple(chains), _eig_fwd_body_of(h, shift))])
    Q, *lchains = _columns(ys)
    back = _replicate_all(back, mesh, parts - 1)

    L, Lg, Lb = h.unenvs(back[1:])
    pens = h.pens_of(Lb, h.p_seed(), ml, vl, xlc.numel())
    lam_f, vec = h.solve(L, one3, Lg, h.g_seed(), al, ml, pens, shift,
                         warm=_into_right(back[0], xlc))
    vec = vec.reshape(xlc.shape)
    vlq = _right_orth(vec)
    carry = (_fac_left(vec, vlq),) + h.envs(
        _adv_right(one3, vlq, al), h.g_adv_r(h.g_seed(), vlq, ml),
        h.p_adv_r(h.p_seed(), vlq, ml, vl))
    [(_, front, ys)] = _staged_sweep(mesh, [(
        True, carry, (Q,) + cores + tuple(lchains), _eig_bwd_body_of(h, shift))])
    V, *chains = _columns(ys)
    front = _replicate_all(front, mesh, 0)

    R, Rg, Rb = h.unenvs(front[1:])
    pens = h.pens_of(h.p_seed(), Rb, m0, v0, q0.numel())
    lam_b, vec = h.solve(one3, R, h.g_seed(), Rg, a0, m0, pens, shift,
                         warm=_into_left(q0, front[0]))
    return (vec.reshape(q0.shape), torch.stack(V), vlq, lam_f, lam_b,
            (tuple(chains), front[1:]))


def place_eigsh_sharded(mesh: DeviceMesh, X, Am, Mm=None, VM=None):
    """This rank's blocks of the iterate's, the operator's, the mass
    operator's and the stacked deflation trains' middle-core stacks
    (``tensor_networks_tpu/parallel/eigen.py:222``); absent ones stay
    None.  Takes the global stacks, the same on every rank."""
    return _place(mesh, X, Am, Mm, VM)


def als_eigsh_sharded(
    mesh: DeviceMesh,
    op: PackedTTOp,
    x0: PackedTT,
    sweeps: int = 10,
    tol: float = 1e-10,
    deflate: Tuple[PackedTT, ...] = (),
    shift: float = None,
    mass: PackedTTOp = None,
    dense_limit: int = 1024,
    lanczos_iters: int = 64,
) -> Tuple[PackedTT, float, List[float]]:
    """Smallest eigenpair of a symmetric TT-operator by one-site DMRG with
    the trains and every env chain sharded along the model axis
    (``tensor_networks_tpu/parallel/eigen.py:239``).  The contracts of
    ``ops.eigen.als_eigsh``'s fused path (generalized local solves under
    ``mass``, penalty deflation by ``deflate``/``shift``, Lanczos locals
    above ``dense_limit``, the stop when a sweep's Rayleigh improvement
    drops below ``tol * |lam|``).  Needs ``d - 2`` divisible by the model
    axis and deflation trains of one shared rank.  Returns ``(x with this
    rank's block, lam, history)``; the history is read once."""
    pm.require_group()
    dt = x0.first.dtype
    use_mass, use_pen = mass is not None, bool(deflate)
    if use_pen and len({v.rank for v in deflate}) != 1:
        raise ValueError(
            "als_eigsh_sharded needs deflation trains of one shared rank; pad "
            "them with ops.packed.pad_rank"
        )
    if use_pen and shift is None:
        shift = _agree(mesh, _default_shift(
            op, x0, mass,
            eigsh=lambda mm, x, sweeps: als_eigsh_sharded(mesh, mm, x, sweeps=sweeps)))
    shift = 0.0 if shift is None else float(shift)

    m = op.mids.shape[0]
    dev = pm.mesh_device(mesh)
    opb = _block_op(mesh, op)
    x = _block_train(mesh, x0, m)
    x0c, X, xlc = _canonical(mesh, x.first.to(dt), x.mids.to(dt), x.last.to(dt))
    a0, Am, al = opb.first[None].to(dt), opb.mids.to(dt), opb.last[..., None].to(dt)
    mstk = vstk = None
    if use_mass:
        mb = _block_op(mesh, mass)
        mstk = (mb.first[None].to(dt), mb.mids.to(dt), mb.last[..., None].to(dt))
    if use_pen:
        vs = [_block_train(mesh, v, m) for v in deflate]
        vstk = (torch.stack([v.first[None].to(dt) for v in vs]),
                torch.stack([v.mids.to(dt) for v in vs], dim=1),
                torch.stack([v.last[..., None].to(dt) for v in vs]))
    h = _EigHelpers(use_mass, use_pen, dt, dev, len(deflate), int(dense_limit),
                    int(lanczos_iters))

    history: List[float] = []
    lam = float("inf")
    if sweeps <= 0:
        return _packed_of(x0c, X, xlc), lam, history
    # the JAX package's record length (its sweep cap bucketed to a power of two)
    cap = 1 << max(sweeps - 1, 1).bit_length()
    tiny = torch.finfo(dt).tiny
    hist = torch.full((2 * cap,), float("nan"), dtype=dt, device=dev)
    lam_prev = torch.full((), float("inf"), dtype=dt, device=dev)
    done, renvs = 0, None
    while done < sweeps:
        x0c, X, xlc, lam_f, lam_b, renvs = _eig_sweep_blocks(
            mesh, h, x0c, X, xlc, a0, Am, al, mstk, vstk, shift, renvs)
        lam_f, lam_b = _replicate_from(torch.stack([lam_f, lam_b]), mesh, 0)
        hist[2 * done] = lam_f
        hist[2 * done + 1] = lam_b
        conv = torch.abs(lam_prev - lam_b) <= tol * torch.clamp(torch.abs(lam_b), min=tiny)
        lam_prev = lam_b
        done += 1
        if _read_stop(conv):
            break
    rec = torch.cat([hist, hist.new_full((1,), done)]).cpu().numpy()
    history = [float(v) for v in rec[:2 * int(rec[-1])]]
    if history:
        lam = history[-1]
    return _packed_of(x0c, X, xlc), lam, history


def _inner_sharded(mesh: DeviceMesh, a: PackedTT, b: PackedTT) -> float:
    """The zipper inner product of two trains' blocks
    (``tensor_networks_tpu/parallel/eigen.py:329``): for expectations, not
    for near-cancelling differences (those take :func:`sweeps._norm_sharded`)."""
    return float(tt_inner_train_sharded(mesh, a.first, a.mids, a.last,
                                        b.first, b.mids, b.last))


def als_eigsh_k_sharded(
    mesh: DeviceMesh,
    op: PackedTTOp,
    x0: PackedTT,
    k: int,
    sweeps: int = 10,
    shift: float = None,
    mass: PackedTTOp = None,
    **kw,
) -> Tuple[List[PackedTT], List[float]]:
    """The ``k`` lowest eigenpairs with the trains sharded
    (``tensor_networks_tpu/parallel/eigen.py:340``): each an
    :func:`als_eigsh_sharded` run with every pair found before deflated,
    the deflation stack filled with zero trains at the rank of the first
    pair so that every solve has the same shapes (``ops.eigen.als_eigsh_k``'s
    slots), the clean Rayleigh quotients ``<v, A v> / <v, M v>`` taken
    distributed.  Returns ``(vectors with this rank's blocks, values)``
    sorted ascending."""
    pm.require_group()
    if k > 1 and shift is None:
        shift = _agree(mesh, _default_shift(
            op, x0, mass,
            eigsh=lambda mm, x, sweeps: als_eigsh_sharded(mesh, mm, x, sweeps=sweeps)))
    m = op.mids.shape[0]
    base = tuple(_block_train(mesh, v, m) for v in kw.pop("deflate", ()))
    x0 = _block_train(mesh, x0, m)
    rv = max([x0.rank] + [v.rank for v in base])
    base = tuple(pad_rank(v, rv) if v.rank < rv else v for v in base)
    if x0.rank < rv:
        x0 = pad_rank(x0, rv)
    nslots = len(base) + k - 1
    opts = dict(dtype=x0.first.dtype, device=x0.first.device)
    n = x0.mode
    zero_slot = PackedTT(torch.zeros((n, rv), **opts),
                         torch.zeros((x0.mids.shape[0], rv, n, rv), **opts),
                         torch.zeros((rv, n), **opts))
    found: List[PackedTT] = []
    vals: List[float] = []
    for _ in range(k):
        defl = base + tuple(found)
        if len(defl) < nslots:
            defl = defl + (zero_slot,) * (nslots - len(defl))
        v, _, _ = als_eigsh_sharded(mesh, op, x0, sweeps=sweeps, deflate=defl, shift=shift,
                                    mass=mass, **kw)
        mv = ttop_apply_sharded(mesh, mass, v) if mass is not None else v
        lam = _inner_sharded(mesh, v, ttop_apply_sharded(mesh, op, v)) / _inner_sharded(
            mesh, v, mv)
        found.append(v)
        vals.append(lam)
    order = sorted(range(len(vals)), key=lambda i: vals[i])
    return [found[i] for i in order], [vals[i] for i in order]


def als_eigsh_adaptive_sharded(
    mesh: DeviceMesh,
    op: PackedTTOp,
    x0: PackedTT,
    eps: float = 1e-8,
    max_rank: int = None,
    sweeps_per_rank: int = 4,
    enrich: bool = True,
    mass: PackedTTOp = None,
    **kw,
) -> Tuple[PackedTT, float, List[float]]:
    """Rank-adaptive train-sharded smallest eigenpair
    (``tensor_networks_tpu/parallel/eigen.py:409``): ``ops.eigen.als_eigsh_adaptive``'s
    geometric ladder with the eigen-residual train ``A x - lam (M) x``
    assembled core-locally, its norm by the distributed orthogonalization
    sweep and the AMEn kick basis by the distributed Gram truncation.
    Returns ``(x with this rank's block, lam, history)``."""
    pm.require_group()
    m = op.mids.shape[0]
    rank = x0.rank
    ceiling = int(max_rank) if max_rank is not None else 8 * rank
    x = _block_train(mesh, x0, m)
    hist_all: List[float] = []
    while True:
        x, lam, hist = als_eigsh_sharded(mesh, op, x, sweeps=sweeps_per_rank, mass=mass, **kw)
        hist_all += hist
        lam_x = scale(x if mass is None else ttop_apply_sharded(mesh, mass, x), -lam)
        resid_train = add_sharded(mesh, ttop_apply_sharded(mesh, op, x), lam_x)
        resid = _agree(mesh, _norm_sharded(mesh, resid_train.first, resid_train.mids,
                                           resid_train.last))
        if resid <= eps * max(abs(lam), 1e-300) or rank >= ceiling:
            return x, lam, hist_all
        new_rank = min(2 * rank, ceiling)
        kick = new_rank - x.rank
        if enrich and kick > 0:
            x = _enrich_span_sharded(mesh, x, resid_train, kick)
        else:
            x = pad_rank(x, new_rank)
        rank = new_rank
