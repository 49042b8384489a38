"""TT inner-product scaling study on the card: time against rank r, mode
size n and dimension d, beside the asymptotic guide slopes.

The port of ``examples/inner_product_scaling.py``.  Two paths:
  * fused  -- ``tt_inner_fast``, the zipper kernel (the default),
  * graph  -- ``TensorNetwork.inner``, the generic cached contraction
              (``--graph``; its first call plans, the timed ones reuse
              the plan).

Each point is the mean of ``num`` calls after one untimed call, by CUDA
events on the card, with every result added into a sum that is checked
finite.  The cores are Gaussian, scaled by 1/sqrt(n r) so that the
inner products stay finite in float32 at every size.

    python3 examples_torch/inner_product_scaling.py [--graph] [--plot] [--device cpu]

``--plot`` saves log-log figures and needs matplotlib.
"""

from __future__ import annotations

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import sys

import numpy as np

from examples_torch._common import device_of, parser, slope_ms, tt_network
from tensor_networks_tpu_torch import Index, tt_inner_fast

RANKS = (10, 20, 40, 80, 160, 320)
MODES = (5, 10, 20, 40, 80, 160, 320, 640)
DIMS = (5, 10, 20, 40, 80, 160, 320, 640)


def random_train(indices, r, rng, device):
    n = indices[0].size
    s = 1.0 / np.sqrt(n * r)
    shapes = [(n, r)] + [(r, n, r)] * (len(indices) - 2) + [(r, n)]
    return tt_network(indices, [(rng.standard_normal(x) * s).astype(np.float32)
                                for x in shapes], device)


def tt_inner_timer(r: int, n: int, d: int, num: int = 5, fused: bool = True,
                   device=None, seed: int = 0) -> float:
    """Seconds of one inner product of two random (d, n, r) float32 trains:
    the slope between ``num`` and ``2 num`` chained calls."""
    dev = device_of(device)
    rng = np.random.default_rng(seed)
    indices = [Index(f"x{i}", n) for i in range(d)]
    a = random_train(indices, r, rng, dev)
    b = random_train(indices, r, rng, dev)
    inner = (lambda: tt_inner_fast(a, b)) if fused else (lambda: a.inner(b))
    return slope_ms(inner, (num, 2 * num), dev)[0] / 1e3


def main(plot: bool = False, graph: bool = False, device=None,
         ranks=RANKS, modes=MODES, dims=DIMS) -> dict:
    fused = not graph
    results = {}

    n, d = 20, 20
    times_r = np.array([tt_inner_timer(r, n, d, fused=fused, device=device) for r in ranks])
    results["rank"] = (np.array(ranks), times_r)
    print("rank scaling (n=20, d=20):", file=sys.stderr)
    for r, t in zip(ranks, times_r):
        print(f"  r={r:4d}  {t*1e3:10.3f} ms", file=sys.stderr)

    d, r = 20, 20
    times_n = np.array([tt_inner_timer(r, nn, d, fused=fused, device=device) for nn in modes])
    results["mode"] = (np.array(modes), times_n)
    print("mode-size scaling (r=20, d=20):", file=sys.stderr)
    for nn, t in zip(modes, times_n):
        print(f"  n={nn:4d}  {t*1e3:10.3f} ms", file=sys.stderr)

    r, n = 5, 5
    times_d = np.array([tt_inner_timer(r, n, dd, fused=fused, device=device) for dd in dims])
    results["dim"] = (np.array(dims), times_d)
    print("dimension scaling (r=5, n=5):", file=sys.stderr)
    for dd, t in zip(dims, times_d):
        print(f"  d={dd:4d}  {t*1e3:10.3f} ms", file=sys.stderr)

    # time must scale ~linearly in d (the reference README's defect)
    lo = min(3, len(dims) - 2)
    big = times_d[-1] / times_d[lo]
    results["d_exponent"] = float(np.log(big) / np.log(dims[-1] / dims[lo]))
    print(f"d-scaling exponent proxy (should be ~1): {results['d_exponent']:.2f}",
          file=sys.stderr)

    if plot:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, axes = plt.subplots(1, 3, figsize=(15, 4))
        for ax, (key, xlabel, slopes) in zip(
            axes,
            [("rank", "rank r", (3, 4)), ("mode", "mode size n", (1, 2)),
             ("dim", "dimension d", (1, 2))],
        ):
            xs, ts = results[key]
            ax.loglog(xs, ts, "o-", label="measured")
            for s in slopes:
                ax.loglog(xs, ts[0] * (xs / xs[0]) ** float(s), "--", label=f"slope {s}")
            ax.set_xlabel(xlabel)
            ax.set_ylabel("time [s]")
            ax.legend()
        fig.tight_layout()
        fig.savefig("inner_product_scaling.png", dpi=120)
        print("saved inner_product_scaling.png", file=sys.stderr)

    return results


if __name__ == "__main__":
    p = parser(__doc__)
    p.add_argument("--plot", action="store_true")
    p.add_argument("--graph", action="store_true",
                   help="time the generic graph contraction instead of the fused zipper")
    args = p.parse_args()
    main(plot=args.plot, graph=args.graph, device=args.device)
