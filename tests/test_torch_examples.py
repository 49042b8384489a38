"""The port's example scripts (``examples_torch/``) and its scaling probe
(``tools/scaling_probe_torch.py``) on the CPU.

- No script imports JAX or the JAX package (an AST scan).
- ``qtt_stretch``'s steps at d=10, chi=4 in float32 against the JAX
  package on the same NumPy-made cores: the fused and graph inner
  products (1e-5 relative), the 1,000-point evaluation (1e-5 of
  max|ref|), the ranks of the rounded ``a + a`` (equal).
- ``qtt_fit_coefficient`` at K=5, rank 2, 4 steps: one Newton step's
  gradient and curvature (autograd and double backward) against central
  differences of the port's loss and gradient (1e-6 relative), and the
  forward energies against the JAX ``tdvp_trajectory`` at the same
  coefficient (1e-12 relative).  The JAX side runs forward only: its
  grad-of-grad of that loss compiles for tens of seconds.
- Every other script's ``main`` at a small size against the oracle of
  its JAX counterpart: dense solves, analytic eigenvalues, the
  ``scipy.fft`` spectral solution, the Richardson ratio, the network's
  own evaluation.  The modules beneath are held to the JAX package by
  their own ``test_torch_*`` files.
- The two distributed scripts in one spawn of 2 gloo ranks
  (``tests/_torch_parallel_solver_ranks.py::run_example_rank``), the
  regression's losses against a one-rank run in this process.
"""

import ast
import multiprocessing
import os
import pickle
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, os.path.dirname(__file__))

import _torch_parallel_solver_ranks as ranks_side  # noqa: E402
from examples_torch._common import dense_vector  # noqa: E402
from examples_torch.distributed_solvers import dense_operator  # noqa: E402
from examples_torch import (  # noqa: E402
    export_serving,
    inner_product_scaling,
    qtt_fit_coefficient,
    qtt_ground_state,
    qtt_heat,
    qtt_screened_poisson,
    qtt_stretch,
    qtt_tdvp,
    tt_regression_multichip,
)

# The suite runs in several worker processes on the CPU: torch's own
# thread pool would spin on the cores the other workers need.
torch.set_num_threads(1)

CPU = "cpu"
WORLD = 2
DEADLINE_S = 120
SCRIPTS = sorted((ROOT / "examples_torch").glob("*.py")) + [
    ROOT / "tools" / "scaling_probe_torch.py"]


# ---- imports ------------------------------------------------------------------------


def _imported(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module)
    return names


def test_every_example_has_a_port():
    jax_side = {p.name for p in (ROOT / "examples").glob("*.py")} - {"tpu_smoke.py"}
    assert jax_side <= {p.name for p in SCRIPTS}


@pytest.mark.parametrize("path", SCRIPTS, ids=lambda p: p.name)
def test_scripts_import_neither_jax_nor_the_jax_package(path):
    bad = [n for n in _imported(path)
           if n.split(".")[0] in ("jax", "jaxlib", "tensor_networks_tpu")]
    assert not bad, bad


@pytest.mark.parametrize("name", ["qtt_stretch", "qtt_heat", "distributed_solvers"])
def test_a_script_raises_without_a_card(name):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    mod = __import__(f"examples_torch.{name}", fromlist=["main"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main()


# ---- qtt_stretch against the JAX package --------------------------------------------


@pytest.fixture(scope="module")
def stretch():
    """(the port's main at d=10, chi=4; the JAX package's same steps on the
    same cores and points)."""
    import tensor_networks_tpu as jtn

    d, chi = 10, 4
    port = qtt_stretch.main(d, chi, device=CPU)
    rng = np.random.RandomState(0)
    inds = [jtn.Index(f"q{i}", 2) for i in range(d)]
    nets = []
    for _ in range(2):
        net = jtn.TensorNetwork.rand_tt(inds, [chi] * (d - 1))
        for k, core in enumerate(qtt_stretch.tt_cores(inds, chi, rng)):
            net.node_tensor(k).value = core
        nets.append(net)
    a, b = nets
    ref = {"inner_fused": float(jtn.tt_inner_fast(a, b)), "inner_graph": float(a.inner(b)),
           "values": np.asarray(a.evaluate(a.free_indices(), port["points"])),
           "ranks": jtn.tt_svd_round(a + a, 1e-3).ranks()}
    return port, ref


@pytest.mark.parametrize("key", ["inner_fused", "inner_graph"])
def test_stretch_inner_products_match_jax(stretch, key):
    port, ref = stretch
    assert abs(port[key] - ref[key]) <= 1e-5 * abs(ref[key])


def test_stretch_evaluation_and_rounding_match_jax(stretch):
    port, ref = stretch
    assert np.abs(port["values"] - ref["values"]).max() <= 1e-5 * np.abs(ref["values"]).max()
    assert port["ranks"] == ref["ranks"]


# ---- the Newton solve through double backward ---------------------------------------


FIT = dict(K=5, rank=2, steps=4, dt=0.05, c_true=1.3)


def test_newton_step_against_central_differences():
    dev = torch.device(CPU)
    loss, _ = qtt_fit_coefficient.fit_problem(**FIT, device=CPU)
    part = qtt_fit_coefficient.newton_parts(loss, 0.4, dev)
    grad, curv = qtt_fit_coefficient.central_differences(loss, 0.4, dev)
    assert abs(part["grad"] - grad) <= 1e-6 * abs(grad)
    assert abs(part["curv"] - curv) <= 1e-6 * abs(curv)
    assert part["curv"] > 0 and part["c_next"] == pytest.approx(0.4 - grad / curv, rel=1e-6)


def test_fit_energies_match_the_jax_trajectory():
    import jax.numpy as jnp

    from tensor_networks_tpu.ops import packed as jpk
    from tensor_networks_tpu.ops.evolve import tdvp_trajectory
    from tensor_networks_tpu.ops.qtt import qtt_tridiagonal

    _, energies = qtt_fit_coefficient.fit_problem(**FIT, device=CPU)
    with torch.no_grad():
        got = energies(torch.tensor(0.4, dtype=torch.float64)).numpy()
    K, r = FIT["K"], FIT["rank"]
    A = qtt_tridiagonal(K, 2.0, -1.0, -1.0)
    rng = np.random.default_rng(0)
    u0 = jpk.PackedTT(jnp.asarray(rng.standard_normal((2, r))),
                      jnp.asarray(rng.standard_normal((K - 2, r, 2, r)) / np.sqrt(r)),
                      jnp.asarray(rng.standard_normal((r, 2))))
    Ac = jpk.PackedTTOp(A.first * 0.4, A.mids, A.last)
    _, _, obs = tdvp_trajectory(Ac, u0, FIT["dt"], FIT["steps"], observables=(A,))
    want = np.asarray(obs)[:, 0]
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


# ---- the other scripts at small sizes against their oracles -------------------------


def _dense_solution(op, rhs):
    return np.linalg.solve(dense_operator(op), dense_vector(rhs))


def test_screened_poisson_against_dense_solves():
    from tensor_networks_tpu_torch.ops import qtt

    K, chi, K3 = 6, 4, 2
    out = qtt_screened_poisson.main(K, chi, device=CPU, K3=K3)
    u = _dense_solution(qtt.qtt_screened_laplacian(K, delta=1.0, device=CPU),
                        qtt.qtt_exponential(K, c=3.0, device=CPU))
    for key in ("x_als", "x_gmres"):
        assert np.linalg.norm(dense_vector(out[key]) - u) <= 1e-6 * np.linalg.norm(u)
    u2 = _dense_solution(qtt.qtt_screened_laplacian_2d(K // 2, delta=1.0, device=CPU),
                         qtt.qtt_exponential_2d(K // 2, device=CPU))
    assert np.linalg.norm(dense_vector(out["x_2d"]) - u2) <= 1e-6 * np.linalg.norm(u2)
    u3 = _dense_solution(qtt.qtt_screened_laplacian_nd(K3, 3, delta=1.0, device=CPU),
                         qtt.qtt_exponential_nd(K3, (3.0, 2.0, 1.5), device=CPU))
    assert np.linalg.norm(dense_vector(out["x_3d"]) - u3) <= 1e-3 * np.linalg.norm(u3)


def test_ground_state_against_the_analytic_spectrum():
    out = qtt_ground_state.main(K1=12, K=2, device=CPU)
    assert out["ground1d_err"] < 1e-9 and out["ground_err"] < 1e-9
    assert out["excited_err"] < 1e-8 and abs(out["overlap"]) < 1e-8


def test_heat_richardson_ratio_is_second_order():
    out = qtt_heat.main(K=6, step_counts=(4, 8, 16), T=2.0, device=CPU)
    assert 3.0 < out["ratio"] < 5.0
    assert max(out["max_resid"].values()) < 1e-8


def test_tdvp_against_the_spectral_solution():
    out = qtt_tdvp.main(K=5, steps=10, device=CPU)
    assert out["rel_err"] < 1e-6
    assert all(b < a for a, b in zip(out["energies"], out["energies"][1:]))


def test_scaling_example_times_both_paths():
    for graph in (False, True):
        out = inner_product_scaling.main(graph=graph, device=CPU, ranks=(2, 4), modes=(2, 3),
                                         dims=(4, 6, 8))
        for key in ("rank", "mode", "dim"):
            assert np.all(np.isfinite(out[key][1])) and np.all(out[key][1] > 0)


def test_export_serves_in_process():
    # the library-free subprocess is tests/test_torch_export.py's
    _, _, _, out = export_serving.serve_in_process(torch.device(CPU), d=4, n=3, rank=2,
                                                   batches=(1, 5))
    assert set(out["request_ms"]) == {1, 5}


def test_scaling_probe_records_every_point(monkeypatch):
    monkeypatch.syspath_prepend(str(ROOT / "tools"))
    import scaling_probe_torch as probe

    configs = (("d4_n3_r2", 4, 3, 2), ("d6_n3_r2", 6, 3, 2))
    rec = probe.probe(configs, device=CPU, inner_ks=(1, 2), round_ks=(1, 2), reps=1)
    for name, d, n, r in configs:
        row = rec["points"][name]
        assert row["d"] == d and row["inner_ms"] > 0 and row["round_prefix_ms"] > 0
        assert row["api_ms"] > 0 and row["inner_rel_err"] <= probe.INNER_TOL
        assert row["bound_ms"] > 0 and row["max_kept_rank"] <= r


# ---- the distributed scripts on gloo ranks ------------------------------------------


@pytest.fixture(scope="module")
def distributed(tmp_path_factory):
    """What each distributed script's main returned on ranks 0 and 1 of a
    2-rank gloo group."""
    if torch.distributed.is_initialized():
        pytest.fail("this process must not hold a default process group")
    out_dir = tmp_path_factory.mktemp("gloo_examples")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=ranks_side.run_example_rank,
                         args=(rank, WORLD, str(out_dir / "store"), str(out_dir)))
             for rank in range(WORLD)]
    deadline = time.monotonic() + DEADLINE_S
    for p in procs:
        p.start()
    try:
        while any(p.is_alive() for p in procs) and time.monotonic() < deadline:
            if any(p.exitcode not in (None, 0) for p in procs):
                break  # one rank failed: the other would wait for it
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(10)
    errors = sorted(out_dir.glob("error_*.txt"))
    codes = [p.exitcode for p in procs]
    if errors or codes != [0] * WORLD:
        detail = "\n".join(e.read_text() for e in errors)
        pytest.fail(f"gloo ranks exited {codes} (deadline {DEADLINE_S} s)\n{detail}")
    results = []
    for rank in range(WORLD):
        with open(out_dir / f"results_{rank}.pkl", "rb") as f:
            results.append(pickle.load(f))
    return results


def test_distributed_solvers_on_two_ranks(distributed):
    for out in (r["solvers"] for r in distributed):
        assert out["P"] == WORLD and out["K"] == 6
        assert out["1"]["vs_fused"] <= 1e-9 and out["2"]["vs_fused"] <= 1e-9
        assert out["3"]["analytic_err"] <= 1e-9 and out["4"]["vs_fused"] <= 1e-9
        assert out["5"]["theta_vs_dense"] <= 1e-10 and out["5"]["tdvp_ratio_err"] <= 1e-9


def test_regression_on_two_ranks_matches_one(distributed):
    one = tt_regression_multichip.main(d=4, steps=10, device=CPU)
    assert not torch.distributed.is_initialized()
    for out in (r["regression"] for r in distributed):
        assert out["mesh"] == (1, WORLD)
        assert out["final_mse"] < out["first_mse"]
        assert out["final_mse"] == pytest.approx(one["final_mse"], rel=1e-4)
