"""Export round trip on the card: trace once, serve anywhere, no library.

The port of ``examples/export_serving.py``.  Builds a random TT, exports
its batched evaluator as one artifact (``export.py``: a
``torch.export`` program with a symbolic batch axis and the weights as
arguments), then serves it twice:

1. in process through ``ExportedEvaluator`` (any batch size, no new
   trace, weights swapped in place), and
2. in a subprocess that imports only ``torch`` and ``numpy`` -- never
   ``tensor_networks_tpu_torch`` -- which shows that the artifact is a
   self-contained serving contract, not a pickle of library objects.

Every in-process batch is held to the network's own evaluation (rtol
1e-4, atol 1e-5, the JAX script's bars), the subprocess's values to 1e-4
of the largest value.

    python3 examples_torch/export_serving.py [--device cpu]
"""

from __future__ import annotations

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import os
import subprocess
import sys
import tempfile
import textwrap
import time

import numpy as np

from examples_torch._common import device_of, parser, tt_network
from tensor_networks_tpu_torch import Index
from tensor_networks_tpu_torch import export as tnt_export

SERVED_BATCHES = (1, 17, 4096)

_SERVER = textwrap.dedent(
    """
    import io
    import json
    import sys

    import numpy as np
    import torch

    path, out_path, device = sys.argv[1:4]
    with np.load(path) as data:
        meta = json.loads(bytes(data["manifest"].tobytes()).decode())
        program = torch.export.load(io.BytesIO(data["artifact"].tobytes())).module()
        values = [torch.as_tensor(data[f"value_{i}"], device=device)
                  for i in range(meta["n_values"])]

    rng = np.random.default_rng(7)
    sizes = meta["index_sizes"]
    served = {}
    for batch in %r:
        pts = np.stack([rng.integers(0, s, batch) for s in sizes], axis=1)
        out = program(torch.as_tensor(pts, device=device), values).cpu().numpy()
        served[f"pts_{batch}"], served[f"out_{batch}"] = pts, out
        print(f"served batch {batch}: first={float(out[0]):.6f}")
    loaded = sorted(m for m in sys.modules if m.startswith("tensor_networks_tpu"))
    assert not loaded, loaded
    np.savez(out_path, **served)
    print("library-free serving OK")
    """ % (SERVED_BATCHES,)
)


def _random_tt(inds, rank, rng, dev):
    """The JAX script's ``rand_tt`` draws (legacy stream), float32."""
    n, d = inds[0].size, len(inds)
    shapes = [(n, rank)] + [(rank, n, rank)] * (d - 2) + [(rank, n)]
    return tt_network(inds, [rng.randn(*s).astype(np.float32) for s in shapes], dev)


def serve_in_process(dev, d: int = 10, n: int = 8, rank: int = 5,
                     batches=(1, 100, 10000)):
    """Export a random (d, n, rank) train's evaluator, serve ``batches``
    through it, then swap in a second train's weights; returns the
    evaluator, the second train, its indices and the readings."""
    legacy = np.random.RandomState(11)
    inds = [Index(f"x{k}", n) for k in range(d)]
    net = _random_tt(inds, rank, legacy, dev)
    out = {"request_ms": {}}

    t0 = time.perf_counter()
    ev = tnt_export.export_evaluator(net)
    out["export_s"] = time.perf_counter() - t0
    print(f"exported {len(inds)}-D evaluator (platforms {ev.platforms}) in "
          f"{out['export_s']:.1f}s")

    rng = np.random.default_rng(3)
    for batch in batches:
        pts = np.stack([rng.integers(0, n, batch) for _ in inds], axis=1)
        t0 = time.perf_counter()
        got = ev(pts)
        dt = time.perf_counter() - t0
        ref = net.evaluate(inds, pts[:4])
        assert np.allclose(got[:4], ref, rtol=1e-4, atol=1e-5)
        out["request_ms"][batch] = dt * 1e3
        print(f"batch {batch:>6}: {dt * 1e3:7.1f} ms "
              f"(symbolic batch axis; pow2-bucketed requests)")

    # swap in refreshed weights of the same structure
    net2 = _random_tt(inds, rank, legacy, dev)
    ev.update_values(net2)
    pts = np.stack([rng.integers(0, n, 64) for _ in inds], axis=1)
    assert np.allclose(ev(pts), net2.evaluate(inds, pts), rtol=1e-4, atol=1e-5)
    print("swapped weights serve the new network")
    return ev, net2, inds, out


def serve_in_subprocess(ev, net, inds, dev) -> dict:
    """Save ``ev`` and serve it from a process that imports only torch and
    numpy; its values against ``net``'s own evaluation, to 1e-4 of the
    largest |value| (float32 roundoff scales with the terms of each sum,
    not with the sometimes near-zero result)."""
    out = {"served_err": {}}
    with tempfile.TemporaryDirectory() as tmp:
        path = ev.save(os.path.join(tmp, "evaluator.npz"))
        out["artifact_kib"] = os.path.getsize(path) / 1024
        print(f"artifact: {out['artifact_kib']:.0f} KiB")
        served_path = os.path.join(tmp, "served.npz")
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", _SERVER, path, served_path, str(dev)],
                              capture_output=True, text=True, timeout=600, cwd=tmp)
        out["subprocess_s"] = time.perf_counter() - t0
        sys.stdout.write(proc.stdout)
        if proc.returncode != 0:
            sys.stderr.write(proc.stderr)
            raise SystemExit("subprocess serving failed")
        with np.load(served_path) as served:
            for batch in SERVED_BATCHES:
                ref = net.evaluate(inds, served[f"pts_{batch}"])
                err = float(np.abs(served[f"out_{batch}"] - ref).max() / np.abs(ref).max())
                out["served_err"][batch] = err
                assert err <= 1e-4, (batch, err)
    print(f"served values within {max(out['served_err'].values()):.1e} of max|value|")
    return out


def main(device=None, d: int = 10, n: int = 8, rank: int = 5,
         batches=(1, 100, 10000)) -> dict:
    dev = device_of(device)
    ev, net2, inds, out = serve_in_process(dev, d, n, rank, batches)
    out.update(serve_in_subprocess(ev, net2, inds, dev))
    print("OK")
    return out


if __name__ == "__main__":
    main(device=parser(__doc__).parse_args().device)
