"""The port's multi-device layer (``tensor_networks_tpu_torch.parallel``)
against the JAX package's on the CPU.

One module fixture starts one 4-rank gloo group (spawned processes that
import torch and the port only, ``tests/_torch_parallel_ranks.py``),
which runs every multi-rank scenario and hands rank 0's gathered results
back as NumPy arrays; the parent kills the ranks after 120 s, so a
deadlock fails this file and does not hang the run.  While they run, the
parent computes the JAX package's results on the conftest's CPU mesh at
the JAX suite's shapes (``tests/test_parallel.py``, ``test_sweeps.py``):
d=6, n=16, r=5 for the mode-sharded inner product; d=8, n=16, r=8 in
float32 for the training step; d=10, n=4, r=6 in float64 for the
sweeps.  Tolerances: 1e-12 relative in float64, 1e-5 in float32.
"""

import multiprocessing
import os
import pickle
import sys
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensor_networks_tpu.parallel as jpar
from tensor_networks_tpu.parallel import sweeps as jsweeps
from tensor_networks_tpu.parallel.training import (
    make_adam_train_step as jmake_adam_train_step,
)
from tensor_networks_tpu_torch.ops import packed
from tensor_networks_tpu_torch.ops.fast import tt_round_fixed
from tensor_networks_tpu_torch.parallel import (
    init_tt_params,
    make_mesh,
    tt_evaluate_batched,
)
from tensor_networks_tpu_torch.parallel.checkpoint import (
    load_train_state,
    save_train_state,
)
from tensor_networks_tpu_torch.parallel.training import TTParams, make_adam_train_step

sys.path.insert(0, os.path.dirname(__file__))
import _torch_parallel_ranks as ranks_side  # noqa: E402

# The suite runs in several worker processes on the CPU: torch's own
# thread pool would spin on the cores the other workers need.
torch.set_num_threads(1)

DEADLINE_S = 120
F64, F32 = 1e-12, 1e-5
SWEEP = dict(d=10, n=4, r=6)


def _train(rng, d, n, r, dtype=np.float64):
    return (rng.standard_normal((n, r)).astype(dtype),
            (rng.standard_normal((d - 2, r, n, r)) / np.sqrt(n * r)).astype(dtype),
            rng.standard_normal((r, n)).astype(dtype))


def _doubled(train):
    """The cores of train + train (block-diagonal middles)."""
    f, m, l = train
    r = f.shape[1]
    mids = np.zeros((m.shape[0], 2 * r, m.shape[2], 2 * r))
    mids[:, :r, :, :r] = m
    mids[:, r:, :, r:] = m
    return np.concatenate([f, f], 1), mids, np.concatenate([l, l], 0)


def _dense(first, mids, last):
    x = first
    for core in mids:
        x = np.tensordot(x, core, axes=([-1], [0]))
    return np.tensordot(x, last, axes=([-1], [0]))


def _inputs():
    rng = np.random.default_rng(2024)
    d, n, r = SWEEP["d"], SWEEP["n"], SWEEP["r"]
    step_params = tuple(np.asarray(x) for x in jpar.init_tt_params(8, 16, 8, jnp.float32, seed=3))
    hyb_rng = np.random.default_rng(0)
    return {
        "inner_a": _train(rng, 6, 16, 5),
        "inner_b": _train(rng, 6, 16, 5),
        "evaluate": {
            key: (_train(rng, 5, n_mode, 4), rng.integers(0, n_mode, (64, 5)))
            for key, n_mode in (("n8", 8), ("n80", 80))
        },
        "step_params": step_params,
        "step_batch": (rng.integers(0, 16, (128, 8)),
                       rng.standard_normal(128).astype(np.float32)),
        "sgd_lr": 0.05,
        "adam_lr": 1e-2,
        "hybrid_params": tuple(
            np.asarray(x) for x in jpar.init_tt_params(5, 4, 3, jnp.float32, seed=0)),
        "hybrid_batch": (hyb_rng.integers(0, 4, size=(16, 5)),
                         hyb_rng.standard_normal(16).astype(np.float32)),
        "orth": _train(rng, d, n, r),
        "inner_train": (_train(rng, d, n, r), _train(rng, d, n, r)),
        "doubled": _doubled(_train(rng, d, n, r // 2)),
        "random": _train(rng, d, n, r),
        "round_eps": 1e-6,
    }


def _jax_refs(inp):
    """The JAX package's results on the same inputs (CPU mesh)."""
    out = {}
    m14 = jpar.make_mesh((1, 4), ("data", "model"))
    a = jpar.shard_tt_params(m14, jpar.sharded.TTCores(*map(jnp.asarray, inp["inner_a"])))
    b = jpar.shard_tt_params(m14, jpar.sharded.TTCores(*map(jnp.asarray, inp["inner_b"])))
    out["inner_mode"] = float(jpar.tt_inner_mode_sharded(m14, a, b))
    out["evaluate"] = {
        key: np.asarray(jpar.tt_evaluate_batched(*map(jnp.asarray, cores), jnp.asarray(idx)))
        for key, (cores, idx) in inp["evaluate"].items()
    }

    m22 = jpar.make_mesh((2, 2), ("data", "model"))
    step, place_params, place_batch = jpar.make_train_step(m22)
    params = place_params(jpar.TTParams(*map(jnp.asarray, inp["step_params"])))
    batch = place_batch(*inp["step_batch"])
    losses = []
    for _ in range(2):
        params, loss = step(params, *batch, inp["sgd_lr"])
        losses.append(float(loss))
    out["sgd"] = (losses, tuple(np.asarray(x) for x in params))

    step, init_state, place_params, place_batch = jmake_adam_train_step(m22, lr=inp["adam_lr"])
    params = place_params(jpar.TTParams(*map(jnp.asarray, inp["step_params"])))
    state = init_state(params)
    losses = []
    for _ in range(2):
        params, state, loss = step(params, state, *batch)
        losses.append(float(loss))
    out["adam"] = (losses, tuple(np.asarray(x) for x in params))

    (fa, ma, la), (fb, mb, lb) = inp["inner_train"]
    ma, la_j = jsweeps.place_train_sharded(m14, jnp.asarray(ma), jnp.asarray(la))
    mb, lb_j = jsweeps.place_train_sharded(m14, jnp.asarray(mb), jnp.asarray(lb))
    out["inner_train"] = float(jsweeps.tt_inner_train_sharded(
        m14, jnp.asarray(fa), ma, la_j, jnp.asarray(fb), mb, lb_j))

    first, mids, last = inp["doubled"]
    m_sh, l_sh = jsweeps.place_train_sharded(m14, jnp.asarray(mids), jnp.asarray(last))
    for name, fn in (("gram", jsweeps.tt_gram_round_sharded),
                     ("prefix", jsweeps.tt_prefix_round_sharded)):
        f, m, l, k0, ks = fn(m14, jnp.asarray(first), m_sh, l_sh, inp["round_eps"])
        out[name] = [int(k0)] + [int(x) for x in np.asarray(ks)]
    return out


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """(the port's gathered results from the 4-rank group, the JAX
    package's results, the inputs)."""
    if torch.distributed.is_initialized():
        pytest.fail("this process must not hold a default process group")
    out_dir = tmp_path_factory.mktemp("gloo")
    inp = _inputs()
    inputs_path = out_dir / "inputs.pkl"
    with open(inputs_path, "wb") as f:
        pickle.dump(inp, f)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=ranks_side.run_rank,
                         args=(rank, str(out_dir / "store"), str(inputs_path), str(out_dir)))
             for rank in range(ranks_side.WORLD)]
    deadline = time.monotonic() + DEADLINE_S
    for p in procs:
        p.start()
    try:
        refs = _jax_refs(inp)
        while any(p.is_alive() for p in procs) and time.monotonic() < deadline:
            if any(p.exitcode not in (None, 0) for p in procs):
                break  # one rank failed: the others would wait for it
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(10)
    errors = sorted(out_dir.glob("error_*.txt"))
    codes = [p.exitcode for p in procs]
    if errors or codes != [0] * len(procs):
        detail = "\n".join(e.read_text() for e in errors)
        pytest.fail(f"gloo ranks exited {codes} (deadline {DEADLINE_S} s)\n{detail}")
    with open(out_dir / "results.pkl", "rb") as f:
        return pickle.load(f), refs, inp


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


# ---- meshes -----------------------------------------------------------------


def test_mesh_shapes_and_axis_names(both):
    res = both[0]["mesh"]
    assert res["mesh"] == ((2, 2), ("data", "model"), [0, 0])
    assert res["hybrid"] == ((2, 2, 1), ("slice", "data", "model"))
    assert res["default"] == ((1, 4), ("data", "model"))


def test_mesh_refuses_what_the_jax_mesh_refuses(both):
    res = both[0]["mesh"]
    assert res["too_many"] == ("ValueError", "mesh shape (2, 4) needs 8 devices, have 4")
    assert res["hybrid_names"][0] == "ValueError"
    assert "3 mesh dims need 3 axis names" in res["hybrid_names"][1]


def test_mesh_needs_a_process_group():
    """No default group: the mesh raises and creates none."""
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_mesh((1, 1), devices="cpu")
    assert not torch.distributed.is_initialized()


# ---- mode-sharded kernels -----------------------------------------------------


def test_mode_sharded_inner_matches_jax(both):
    port, refs, inp = both
    assert abs(port["inner_mode"] - refs["inner_mode"]) <= F64 * abs(refs["inner_mode"])
    dense_a, dense_b = _dense(*inp["inner_a"]), _dense(*inp["inner_b"])
    assert np.isclose(port["inner_mode"], np.sum(dense_a * dense_b), rtol=1e-10)


@pytest.mark.parametrize("key", ["n8", "n80"])
def test_evaluate_batched_matches_jax(both, key):
    """One process: the matmul-select form (n <= 64) and the gather form."""
    _, refs, inp = both
    cores, idx = inp["evaluate"][key]
    got = tt_evaluate_batched(*map(torch.from_numpy, cores), torch.from_numpy(idx))
    assert _rel(got.numpy(), refs["evaluate"][key]) <= F64


@pytest.mark.parametrize("key", ["n8", "n80"])
def test_evaluate_mode_sharded_over_four_ranks(both, key):
    port, refs, _ = both
    assert _rel(port["evaluate"][key], refs["evaluate"][key]) <= F64


def test_evaluate_clamps_out_of_range_indices():
    rng = np.random.default_rng(5)
    cores = [torch.from_numpy(x) for x in _train(rng, 4, 6, 3)]
    idx = torch.tensor([[-3, 7, 2, 9], [0, 5, 5, 5]])
    got = tt_evaluate_batched(*cores, idx)
    ref = tt_evaluate_batched(*cores, idx.clamp(0, 5))
    assert torch.equal(got, ref)


# ---- the training step ----------------------------------------------------------


def test_sgd_step_on_2x2_matches_jax(both):
    """The params within 1e-5, and their change over the two steps within
    1e-3 (a small part of the params: its float32 roundoff is larger
    relative to it), so that a gradient summed once too often over the
    model group, off by a factor, fails."""
    port, refs, inp = both
    losses, params = refs["sgd"]
    assert _rel(port["training"]["sgd_losses"], losses) <= F32
    for got, ref, start in zip(port["training"]["sgd_params"], params, inp["step_params"]):
        assert _rel(got, ref) <= F32
        assert _rel(got - start, ref - start) <= 1e-3


def test_sgd_step_on_2x2_matches_one_rank(both):
    t = both[0]["training"]
    assert _rel(t["sgd_losses"], t["sgd_losses_1x1"]) <= F32
    for got, ref in zip(t["sgd_params"], t["sgd_params_1x1"]):
        assert _rel(got, ref) <= F32


def test_fast_eval_step_matches_the_plain_one_on_one_rank(both):
    t = both[0]["training"]
    assert _rel(t["sgd_losses_1x1_fast"], t["sgd_losses_1x1"]) <= F32


def test_fast_eval_refuses_a_multi_rank_mesh(both):
    err = both[0]["training"]["fast_on_2x2"]
    assert err[0] == "ValueError" and "does not partition" in err[1]


def test_adam_steps_on_2x2_match_jax(both):
    port, refs, _ = both
    losses, params = refs["adam"]
    assert _rel(port["training"]["adam_losses"], losses) <= F32
    for got, ref in zip(port["training"]["adam_params"], params):
        assert _rel(got, ref) <= F32


def test_hybrid_batch_axes_match_the_flat_mesh(both):
    """DP over ("slice", "data") of make_hybrid_mesh(2, (2, 1)) gives the
    (4, 1) mesh's losses and params (``test_train_step_hybrid_batch_axes``)."""
    t = both[0]["training"]
    assert np.allclose(t["hybrid_losses"], t["flat_losses"], rtol=1e-6)
    for a, b in zip(t["hybrid_params"], t["flat_params"]):
        assert np.allclose(a, b, atol=1e-6)


def test_init_tt_params_are_the_jax_cores():
    for dtype, jdtype in ((torch.float32, jnp.float32), (torch.float64, jnp.float64)):
        got = init_tt_params(5, 4, 3, dtype=dtype, seed=7, device="cpu")
        ref = jpar.init_tt_params(5, 4, 3, dtype=jdtype, seed=7)
        for x, y in zip(got, ref):
            assert x.dtype == dtype and np.array_equal(x.numpy(), np.asarray(y))


def test_jax_params_carry_across():
    ref = jpar.init_tt_params(6, 8, 4, dtype=jnp.float32, seed=1)
    got = TTParams(*(torch.from_numpy(np.array(x)) for x in ref))
    assert all(np.array_equal(x.numpy(), np.asarray(y)) for x, y in zip(got, ref))
    idx = np.random.default_rng(1).integers(0, 8, (32, 6))
    assert _rel(tt_evaluate_batched(*got, torch.from_numpy(idx)).numpy(),
                np.asarray(jpar.tt_evaluate_batched(*ref, jnp.asarray(idx)))) <= F32


# ---- checkpoints --------------------------------------------------------------------


def test_checkpoint_params_roundtrip(tmp_path):
    params = init_tt_params(5, 4, 3, dtype=torch.float32, seed=0, device="cpu")
    path = str(tmp_path / "ckpt")
    save_train_state(path, params, step=7)
    template = {"params": init_tt_params(5, 4, 3, seed=1, device="cpu"), "step": 0}
    restored, opt_state, step = load_train_state(path, template, device="cpu")
    assert step == 7 and opt_state is None
    assert all(torch.equal(a, b) for a, b in zip(restored, params))
    with pytest.raises(ValueError, match="template"):
        load_train_state(path, dict(template, opt_state=object()), device="cpu")


def test_checkpoint_params_and_adam_state_roundtrip(tmp_path):
    torch.distributed.init_process_group(
        "gloo", store=torch.distributed.HashStore(), rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), devices="cpu")
        step, init_state, place_params, place_batch = make_adam_train_step(mesh)
        params = place_params(init_tt_params(4, 3, 2, seed=2, device="cpu"))
        rng = np.random.default_rng(2)
        params, state, _ = step(params, init_state(params),
                                *place_batch(rng.integers(0, 3, (8, 4)), rng.standard_normal(8)))
        path = str(tmp_path / "ckpt")
        save_train_state(path, params, opt_state=state, step=3, mesh=mesh)
        restored, restored_state, n = load_train_state(path, mesh=mesh)
    finally:
        torch.distributed.destroy_process_group()
    assert n == 3 and int(restored_state.count) == 1
    assert all(torch.equal(a, b) for a, b in zip(restored, params))
    for moment in ("mu", "nu"):
        assert all(torch.equal(a, b) for a, b in
                   zip(getattr(restored_state, moment), getattr(state, moment)))


def test_checkpoint_on_2x2_restores_on_each_rank_and_on_1x1(both):
    t = both[0]["training"]
    assert t["ckpt_same_mesh"]
    params, nu, count = t["ckpt_on_1x1"]
    assert count == 2
    assert all(np.array_equal(a, b) for a, b in zip(params, t["adam_params"]))
    assert all(np.array_equal(a, b) for a, b in zip(nu, t["ckpt_moments"]))


# ---- train-sharded sweeps ----------------------------------------------------------


def test_right_orth_sharded_is_orthonormal_and_exact(both):
    port, _, inp = both
    carry, mq, lq = port["sweeps"]["orth"]
    first, mids, last = inp["orth"]
    r, n = SWEEP["r"], SWEEP["n"]
    for core in mq:
        mat = core.reshape(r, -1)
        assert np.abs(mat @ mat.T - np.eye(r)).max() <= F64
    gram = lq @ lq.T
    k = min(r, n)  # rows past the mode count are zero padding
    assert np.abs(gram[:k, :k] - np.eye(k)).max() <= F64
    assert np.abs(gram[k:]).max() <= F64
    dense = _dense(first, mids, last)
    assert _rel(_dense(first @ carry, mq, lq), dense) <= F64


def test_inner_train_sharded_matches_jax(both):
    port, refs, inp = both
    assert abs(port["sweeps"]["inner_train"] - refs["inner_train"]) <= F64 * abs(refs["inner_train"])
    (fa, ma, la), (fb, mb, lb) = inp["inner_train"]
    assert np.isclose(port["sweeps"]["inner_train"],
                      np.sum(_dense(fa, ma, la) * _dense(fb, mb, lb)), rtol=1e-10)


def _single_process_ranks(cores, eps, method):
    net = packed.unpack(packed.from_numpy(*cores, device="cpu"))
    return tt_round_fixed(net, eps, method=method)[1]


@pytest.mark.parametrize("method", ["gram", "prefix"])
def test_sharded_rounding_ranks_and_values(both, method):
    """base + base (rank 6, true rank 3) at eps 1e-6: the ranks of the JAX
    package's sharded form and of the port's single-process sweep; the
    masked result rebuilds the tensor."""
    port, refs, inp = both
    f, m, l, ranks = port["sweeps"][f"{method}_doubled"]
    d = SWEEP["d"]
    assert ranks == refs[method] == [3] * (d - 1)
    assert ranks == _single_process_ranks(inp["doubled"], inp["round_eps"], method)
    assert _rel(_dense(f, m, l), _dense(*inp["doubled"])) <= 1e-10


@pytest.mark.parametrize("method", ["gram", "prefix"])
def test_sharded_rounding_error_contract(both, method):
    """A full-rank random train at eps 1e-2 (``test_distributed_prefix_error_contract``):
    the error within eps, no rank above the input's."""
    port, _, inp = both
    f, m, l, ranks = port["sweeps"][f"{method}_random"]
    dense = _dense(*inp["random"])
    err = np.linalg.norm(_dense(f, m, l) - dense) / np.linalg.norm(dense)
    assert err < 1e-2 and max(ranks) <= SWEEP["r"]


def test_prefix_nan_fallback(both):
    """A non-finite prefix result on one rank sends every rank to the
    sharded Gram form, with the warning and one ROUND_STATS count."""
    port, _, inp = both
    messages, count, ranks, f, m, l = port["sweeps"]["fallback"]
    assert len(messages) == 1 and "broke down" in messages[0]
    assert count == 1
    assert ranks == [3] * (SWEEP["d"] - 1)
    assert _rel(_dense(f, m, l), _dense(*inp["doubled"])) <= 1e-10


def test_place_train_sharded_needs_divisible_blocks(both):
    err = both[0]["sweeps"]["indivisible"]
    assert err[0] == "ValueError" and "divisible by the model axis (4)" in err[1]
