"""The port's serving export (``export.py``) and profiling hooks
(``profiling.py``) on the CPU, held to the JAX package and to the claims
of ``tests/test_export.py``.

- The JAX package's ``export_evaluator`` is called once, on the same
  network (built by its ``rand_tt`` from the seed of its tests and
  carried over): both artifacts give the same values at batches 5 and
  257 (1e-12), and the JAX artifact, saved, is refused by the port's
  ``load``.
- ``test_export.py``'s cases on the port: any batch against
  ``TensorNetwork.evaluate`` (1e-12), a tree, the save/load round trip
  (exact) with and without the extension, ``bucket_batches`` persisted,
  duplicate and missing indices refused, the weight hot-swap and its
  shape check, clamping, bad points, bucketing (exact), the dtype cast
  (1e-5).  Besides: one trace serves batches 1, 17 and 257 with no guard
  on the batch, and a process that imports only torch and numpy serves
  a saved artifact.
- ``profiling``: ``Timer`` sums and counts, ``trace`` writes a trace
  holding an ``annotate`` region.
"""

import copy
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

import tensor_networks_tpu as jtn
from tensor_networks_tpu import export as jexport
from tensor_networks_tpu_torch import Index, TensorNetwork
from tensor_networks_tpu_torch import profiling
from tensor_networks_tpu_torch.export import ExportedEvaluator, export_evaluator, load

# The suite runs in several worker processes on the CPU: torch's own
# thread pool would spin on the cores the other workers need.
torch.set_num_threads(1)


def _points(indices, n, seed=0):
    rng = np.random.default_rng(seed + n)
    return np.stack([rng.integers(0, i.size, size=n) for i in indices], axis=-1)


def _to_port(jnet):
    return TensorNetwork.from_separated_dict(*jnet.to_separated_dict(), device="cpu")


@pytest.fixture(scope="module")
def tt_net():
    """``test_export.py``'s network: both packages' copies, the port's
    indices and its exported evaluator (traced once for the module)."""
    np.random.seed(23)
    jind = [jtn.Index(f"x{i}", 7) for i in range(6)]
    jnet = jtn.TensorNetwork.rand_tt(jind, [3, 4, 5, 4, 3])
    net = _to_port(jnet)
    indices = [Index(i.name, i.size) for i in jind]
    return net, indices, export_evaluator(net, indices), jnet, jind


def _fresh(ev):
    """A second evaluator on the same program, to mutate."""
    return ExportedEvaluator(ev._program, ev._values, ev.index_names,
                             ev.index_sizes, platforms=ev.platforms)


def test_export_matches_jax_and_refuses_its_artifact(tt_net, tmp_path):
    net, indices, ev, jnet, jind = tt_net
    jev = jexport.export_evaluator(jnet, jind)
    for n in (5, 257):
        pts = _points(indices, n)
        np.testing.assert_allclose(ev(pts), jev(pts), rtol=1e-12, atol=1e-12)
    path = jev.save(str(tmp_path / "jax_model.npz"))
    with pytest.raises(ValueError):
        load(path, device="cpu")


def test_export_matches_evaluate_any_batch(tt_net):
    net, indices, ev, *_ = tt_net
    for n in (1, 5, 64, 257):
        pts = _points(indices, n)
        got = ev(pts)
        assert got.shape == (n,)
        np.testing.assert_allclose(got, net.evaluate(indices, pts), rtol=1e-12, atol=1e-12)


def test_one_trace_serves_every_batch(tt_net, monkeypatch):
    """The batch is a symbol from 1 up with no other guard, and serving
    batches 1, 17 and 257 traces nothing again."""
    net, indices, ev, *_ = tt_net
    (rng,) = ev._program.range_constraints.values()
    assert rng.lower == 1 and rng.upper > 2**62  # int_oo: no upper guard
    traced = []
    monkeypatch.setattr(torch.export, "export", lambda *a, **k: traced.append(a))
    exact = _fresh(ev)
    exact.bucket_batches = False
    for n in (1, 17, 257):
        pts = _points(indices, n)
        np.testing.assert_allclose(exact(pts), net.evaluate(indices, pts),
                                   rtol=1e-12, atol=1e-12)
    assert traced == []


def test_export_tree_topology():
    np.random.seed(23)
    jind = [jtn.Index(f"y{i}", 5) for i in range(4)]
    net = _to_port(jtn.TensorNetwork.rand_ht(jind, rank=3))
    free = net.free_indices()
    ev = export_evaluator(net)  # defaults to the free indices' order
    assert ev.index_names == [i.name for i in free]
    pts = _points(free, 40)
    np.testing.assert_allclose(ev(pts), net.evaluate(free, pts), rtol=1e-12, atol=1e-12)


def test_save_load_roundtrip(tt_net, tmp_path):
    _, indices, ev, *_ = tt_net
    path = str(tmp_path / "model.npz")
    assert ev.save(path) == path
    back = load(path, device="cpu")
    assert back.index_names == [i.name for i in indices]
    assert back.index_sizes == [i.size for i in indices]
    assert back.platforms == ["cpu", "cuda"]
    pts = _points(indices, 33)
    np.testing.assert_allclose(back(pts), ev(pts), rtol=0, atol=0)


def test_save_load_extensionless_path(tt_net, tmp_path):
    """np.savez appends .npz to a bare path; save and load agree on it."""
    _, indices, ev, *_ = tt_net
    bare = str(tmp_path / "model")
    written = ev.save(bare)
    assert written == bare + ".npz"
    pts = _points(indices, 9)
    for p in (bare, written):
        np.testing.assert_allclose(load(p, device="cpu")(pts), ev(pts), rtol=0, atol=0)


def test_bucket_batches_persisted(tt_net, tmp_path):
    ev = _fresh(tt_net[2])
    ev.bucket_batches = False
    assert load(ev.save(str(tmp_path / "exact.npz")), device="cpu").bucket_batches is False
    ev.bucket_batches = True
    assert load(ev.save(str(tmp_path / "bucketed.npz")), device="cpu").bucket_batches is True


def test_duplicate_and_missing_indices_rejected(tt_net):
    net, indices, *_ = tt_net
    with pytest.raises(ValueError):
        export_evaluator(net, [indices[0]] + indices[:-1])
    with pytest.raises(ValueError):
        export_evaluator(net, indices[:-1])


def test_update_values_hot_swap(tt_net):
    net, indices, ev, *_ = tt_net
    ev = _fresh(ev)
    pts = _points(indices, 16)
    base = ev(pts)
    scaled = copy.deepcopy(net)
    t = scaled.node_tensor(next(iter(scaled.network.nodes)))
    t.update_val_size(t.value * 2.0)
    ev.update_values(scaled)
    np.testing.assert_allclose(ev(pts), 2.0 * base, rtol=1e-12)
    with pytest.raises(ValueError):
        ev.update_values([np.zeros((2, 2))] * len(list(net.network.nodes)))
    with pytest.raises(ValueError):
        ev.update_values([np.zeros((2, 2))])


def test_out_of_range_clamps(tt_net):
    _, indices, ev, *_ = tt_net
    pts = _points(indices, 8)
    pts[0, 0] = indices[0].size + 50  # clamps to size - 1
    pts[1, 1] = -3  # clamps to 0
    clamped = pts.copy()
    clamped[0, 0], clamped[1, 1] = indices[0].size - 1, 0
    np.testing.assert_allclose(ev(pts), ev(clamped), rtol=0, atol=0)


def test_rejects_bad_inputs(tt_net):
    _, indices, ev, *_ = tt_net
    with pytest.raises(ValueError):
        ev(_points(indices, 4)[:, :-1])  # wrong column count
    with pytest.raises(ValueError):
        ev(np.zeros(6, int))  # not a batch
    empty = ev(np.empty((0, len(indices))))
    assert empty.shape == (0,) and empty.dtype == np.float64
    cuda_only = ExportedEvaluator(ev._program, ev._values, ev.index_names,
                                 ev.index_sizes, platforms=("cuda",))
    with pytest.raises(ValueError):
        cuda_only(_points(indices, 4))


def test_batch_bucketing(tt_net):
    """Padding to powers of two leaves every result unchanged."""
    _, indices, ev, *_ = tt_net
    ev = _fresh(ev)
    assert ev.bucket_batches
    for n in (1, 2, 3, 64, 65, 100):
        pts = _points(indices, n)
        got = ev(pts)
        assert got.shape == (n,)
        ev.bucket_batches = False
        exact = ev(pts)
        ev.bucket_batches = True
        np.testing.assert_allclose(got, exact, rtol=0, atol=0)


def test_dtype_cast(tt_net):
    net, indices, *_ = tt_net
    ev = export_evaluator(net, indices, dtype=torch.float32)
    pts = _points(indices, 32)
    got = ev(pts)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, net.evaluate(indices, pts), rtol=1e-5, atol=1e-5)
    assert "cuda" in ev.platforms and "cpu" in ev.platforms


SERVE_WITHOUT_THE_PORT = """
import io, json, sys
import numpy as np
import torch
data = np.load(sys.argv[1])
meta = json.loads(data["manifest"].tobytes().decode())
program = torch.export.load(io.BytesIO(data["artifact"].tobytes())).module()
values = [torch.as_tensor(data[f"value_{i}"]) for i in range(meta["n_values"])]
pts = torch.as_tensor(np.load(sys.argv[2]))
out = program(pts, values)
assert not any(m.startswith("tensor_networks_tpu") for m in sys.modules)
np.save(sys.argv[3], out.numpy())
"""


def test_served_by_torch_and_numpy_alone(tt_net, tmp_path):
    _, indices, ev, *_ = tt_net
    path = ev.save(str(tmp_path / "model.npz"))
    pts = _points(indices, 37)
    np.save(tmp_path / "pts.npy", pts)
    subprocess.run([sys.executable, "-c", SERVE_WITHOUT_THE_PORT, path,
                    str(tmp_path / "pts.npy"), str(tmp_path / "out.npy")],
                   check=True, cwd=tmp_path, timeout=120)
    np.testing.assert_allclose(np.load(tmp_path / "out.npy"), ev(pts), rtol=0, atol=0)


def test_profiling_timer_and_trace(tmp_path):
    timer = profiling.Timer()
    for _ in range(3):
        with timer.section("work"):
            sum(range(1000))
    assert timer.counts["work"] == 3 and timer.totals["work"] > 0
    assert "work" in timer.summary() and "(3 calls)" in timer.summary()
    assert profiling.global_timer() is profiling.global_timer()
    with profiling.trace(str(tmp_path / "trace")) as path:
        with profiling.annotate("tnt_region"):
            torch.ones(8).sum()
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "tnt_region" for e in events)
