"""The rank side of ``tests/test_torch_parallel.py``: one process of a
4-rank gloo group on the CPU.

Imports torch, NumPy and the port only (a spawned rank must not load JAX).
:func:`run_rank` joins the group through a ``FileStore``, loads the
inputs the test's parent wrote, runs every multi-rank scenario in one
order on every rank, and rank 0 writes what the scenarios gathered as
NumPy arrays.  A rank that fails writes its traceback beside them.
"""

import datetime
import os
import pickle
import traceback
import warnings

import numpy as np
import torch
import torch.distributed as dist

from tensor_networks_tpu_torch.ops.fast import ROUND_STATS
from tensor_networks_tpu_torch.parallel import (
    default_mesh,
    make_hybrid_mesh,
    make_mesh,
    make_train_step,
    place_train_sharded,
    shard_tt_params,
    tt_evaluate_batched,
    tt_gram_round_sharded,
    tt_inner_mode_sharded,
    tt_inner_train_sharded,
    tt_prefix_round_sharded,
    tt_right_orth_sharded,
)
from tensor_networks_tpu_torch.parallel import sweeps
from tensor_networks_tpu_torch.parallel.checkpoint import (
    load_train_state,
    save_train_state,
)
from tensor_networks_tpu_torch.parallel.sharded import TTCores, gather_tt
from tensor_networks_tpu_torch.parallel.training import (
    TTParams,
    make_adam_train_step,
)

WORLD = 4


def _np(x):
    return np.asarray(x.detach().cpu())


def _np_cores(cores):
    return tuple(_np(x) for x in cores)


def _gather_train(mesh, mids):
    """The global middle cores from each model rank's block."""
    parts = [torch.empty_like(mids) for _ in range(mesh.size(1))]
    dist.all_gather(parts, mids.contiguous(), group=mesh.get_group("model"))
    return _np(torch.cat(parts))


def _error(fn):
    """The type and message ``fn`` raises, or None."""
    try:
        fn()
    except (ValueError, RuntimeError) as e:
        return type(e).__name__, str(e)
    return None


def scenario_mesh(inp, out_dir):
    m = make_mesh((2, 2), devices="cpu")
    h = make_hybrid_mesh(2, (2, 1), devices="cpu")
    flat = default_mesh(devices="cpu")
    return {
        "mesh": (tuple(m.mesh.shape), m.mesh_dim_names, list(m.get_coordinate())),
        "hybrid": (tuple(h.mesh.shape), h.mesh_dim_names),
        "default": (tuple(flat.mesh.shape), flat.mesh_dim_names),
        "too_many": _error(lambda: make_mesh((2, 4), devices="cpu")),
        "hybrid_names": _error(
            lambda: make_hybrid_mesh(2, (2, 1), ("data", "model"), devices="cpu")
        ),
    }


def scenario_inner_mode(inp, out_dir):
    mesh = make_mesh((1, 4), devices="cpu")
    a = shard_tt_params(mesh, TTCores(*inp["inner_a"]))
    b = shard_tt_params(mesh, TTCores(*inp["inner_b"]))
    return float(tt_inner_mode_sharded(mesh, a, b))


def scenario_evaluate(inp, out_dir):
    mesh = make_mesh((1, 4), devices="cpu")
    out = {}
    for key, (cores, idx) in inp["evaluate"].items():
        local = shard_tt_params(mesh, TTCores(*cores))
        out[key] = _np(tt_evaluate_batched(*local, torch.from_numpy(idx), mesh))
    return out


def _steps(mesh, inp, adam, batch_axes=("data",), fast_eval=False):
    """Two steps from the shared params; the global params and losses."""
    idx, y = inp["step_batch"]
    if adam:
        step, init_state, place_params, place_batch = make_adam_train_step(
            mesh, lr=inp["adam_lr"], batch_axes=batch_axes, fast_eval=fast_eval)
    else:
        step, place_params, place_batch = make_train_step(
            mesh, batch_axes=batch_axes, fast_eval=fast_eval)
    params = place_params(TTParams(*inp["step_params"]))
    state = init_state(params) if adam else None
    batch = place_batch(idx, y)
    losses = []
    for _ in range(2):
        if adam:
            params, state, loss = step(params, state, *batch)
        else:
            params, loss = step(params, *batch, inp["sgd_lr"])
        losses.append(float(loss))
    return params, state, losses


def scenario_training(inp, out_dir):
    out = {}
    mesh = make_mesh((2, 2), devices="cpu")
    params, _, out["sgd_losses"] = _steps(mesh, inp, adam=False)
    out["sgd_params"] = _np_cores(gather_tt(mesh, params))
    adam_params, state, out["adam_losses"] = _steps(mesh, inp, adam=True)
    out["adam_params"] = _np_cores(gather_tt(mesh, adam_params))

    # checkpoints: written on (2, 2), read back there and on (1, 1)
    path = os.path.join(out_dir, "ckpt")
    save_train_state(path, adam_params, opt_state=state, step=2, mesh=mesh)
    back, back_state, back_step = load_train_state(path, mesh=mesh)
    out["ckpt_same_mesh"] = (
        back_step == 2
        and all(torch.equal(x, y) for x, y in zip(back, adam_params))
        and torch.equal(back_state.count, state.count)
        and all(torch.equal(x, y) for x, y in zip(back_state.mu, state.mu))
        and all(torch.equal(x, y) for x, y in zip(back_state.nu, state.nu))
    )
    out["ckpt_moments"] = _np_cores(gather_tt(mesh, state.nu))

    one = make_mesh((1, 1), devices="cpu")  # every rank builds it; rank 0 uses it
    if dist.get_rank() == 0:
        p1, _, out["sgd_losses_1x1"] = _steps(one, inp, adam=False)
        out["sgd_params_1x1"] = _np_cores(p1)
        _, _, out["sgd_losses_1x1_fast"] = _steps(one, inp, adam=False, fast_eval=True)
        restored, restored_state, _ = load_train_state(path, mesh=one)
        out["ckpt_on_1x1"] = (_np_cores(restored), _np_cores(restored_state.nu),
                              int(restored_state.count))
    out["fast_on_2x2"] = _error(lambda: make_train_step(mesh, fast_eval=True))

    hybrid = make_hybrid_mesh(2, (2, 1), devices="cpu")
    hyb_inp = dict(inp, step_params=inp["hybrid_params"], step_batch=inp["hybrid_batch"])
    ph, _, out["hybrid_losses"] = _steps(hybrid, hyb_inp, adam=False,
                                         batch_axes=("slice", "data"))
    flat = make_mesh((4, 1), devices="cpu")
    pf, _, out["flat_losses"] = _steps(flat, hyb_inp, adam=False)
    out["hybrid_params"] = _np_cores(ph)
    out["flat_params"] = _np_cores(pf)
    return out


def scenario_sweeps(inp, out_dir):
    mesh = make_mesh((1, 4), devices="cpu")
    out = {}
    first, mids, last = inp["orth"]
    m_sh, l_sh = place_train_sharded(mesh, mids, last)
    carry, mq, lq = tt_right_orth_sharded(mesh, m_sh, l_sh)
    out["orth"] = (_np(carry), _gather_train(mesh, mq), _np(lq))

    (fa, ma, la), (fb, mb, lb) = inp["inner_train"]
    ma, la = place_train_sharded(mesh, ma, la)
    mb, lb = place_train_sharded(mesh, mb, lb)
    out["inner_train"] = float(tt_inner_train_sharded(
        mesh, torch.from_numpy(fa), ma, la, torch.from_numpy(fb), mb, lb))

    for name, fn in (("gram", tt_gram_round_sharded), ("prefix", tt_prefix_round_sharded)):
        for key, eps in (("doubled", inp["round_eps"]), ("random", 1e-2)):
            first, mids, last = inp[key]
            m_sh, l_sh = place_train_sharded(mesh, mids, last)
            f, m, l, k0, ks = fn(mesh, torch.from_numpy(first), m_sh, l_sh, eps)
            out[f"{name}_{key}"] = (_np(f), _gather_train(mesh, m), _np(l),
                                    [int(k0)] + _gather_train(mesh, ks).tolist())

    # a poisoned prefix result on rank 0's second core falls back to gram
    first, mids, last = inp["doubled"]
    m_sh, l_sh = place_train_sharded(mesh, mids, last)
    real = sweeps._prefix_sharded

    def poisoned(*args):
        f, m, l, k0, ks = real(*args)
        if dist.get_rank() == 0:
            m = m.clone()
            m[1] = float("nan")
        return f, m, l, k0, ks

    before = ROUND_STATS["fallback_nan"]
    sweeps._prefix_sharded = poisoned
    try:
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            f, m, l, k0, ks = tt_prefix_round_sharded(
                mesh, torch.from_numpy(first), m_sh, l_sh, inp["round_eps"])
    finally:
        sweeps._prefix_sharded = real
    out["fallback"] = (
        [str(w.message) for w in rec if issubclass(w.category, RuntimeWarning)],
        ROUND_STATS["fallback_nan"] - before,
        [int(k0)] + _gather_train(mesh, ks).tolist(),
        _np(f), _gather_train(mesh, m), _np(l),
    )
    out["indivisible"] = _error(lambda: place_train_sharded(mesh, mids[:6], last))
    return out


SCENARIOS = (
    ("mesh", scenario_mesh),
    ("inner_mode", scenario_inner_mode),
    ("evaluate", scenario_evaluate),
    ("training", scenario_training),
    ("sweeps", scenario_sweeps),
)


def run_rank(rank: int, store_path: str, inputs_path: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    try:
        dist.init_process_group(
            "gloo", store=dist.FileStore(store_path, WORLD), rank=rank,
            world_size=WORLD, timeout=datetime.timedelta(seconds=60))
        with open(inputs_path, "rb") as f:
            inp = pickle.load(f)
        results = {name: fn(inp, out_dir) for name, fn in SCENARIOS}
        if rank == 0:
            with open(os.path.join(out_dir, "results.pkl"), "wb") as f:
                pickle.dump(results, f)
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(out_dir, f"error_{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise
