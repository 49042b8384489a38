"""QTT stretch: a 2^30-point quantized tensor train, on the card.

The port of ``examples/qtt_stretch.py``.  Builds a rank-chi QTT over 30
binary modes (2^30 ~ 1e9 logical points) in float32, takes its inner
product with a second one through the fused zipper kernel and through
the graph contraction, evaluates it at 1,000 random points without
densifying, and rounds ``a + a`` back down.

The cores are the JAX script's draws (``numpy.random.RandomState(0)``,
the legacy stream its ``np.random.seed(0)`` starts), each scaled so
that norms stay O(1) in f32 over 30 products.

    python3 examples_torch/qtt_stretch.py [--d 30] [--chi 16] [--device cpu]
"""

from __future__ import annotations

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import sys

import numpy as np

from examples_torch._common import clock, device_of, parser, tt_network
from tensor_networks_tpu_torch import Index, tt_inner_fast, tt_svd_round


def tt_cores(indices, chi, rng):
    """The cores ``TensorNetwork.rand_tt`` of the JAX package draws (first,
    middles, last), as float32 NumPy arrays, each scaled by
    ``1 / sqrt(prod(shape[:-1]) + 1)``."""
    d = len(indices)
    shapes = ([(indices[0].size, chi)]
              + [(chi, ix.size, chi) for ix in indices[1:-1]]
              + [(chi, indices[-1].size)])
    cores = [rng.randn(*s).astype(np.float32) for s in shapes]
    assert len(cores) == d
    return [c / np.float32(np.sqrt(np.prod(c.shape[:-1]) + 1.0)) for c in cores]


def main(d: int = 30, chi: int = 16, device=None, seed: int = 0) -> dict:
    dev = device_of(device)
    rng = np.random.RandomState(seed)
    indices = [Index(f"q{i}", 2) for i in range(d)]
    a = tt_network(indices, tt_cores(indices, chi, rng), dev)
    b = tt_network(indices, tt_cores(indices, chi, rng), dev)
    out = {"d": d, "chi": chi}

    t0 = clock(dev)
    val = float(tt_inner_fast(a, b))
    out["fused_s"] = clock(dev) - t0
    print(f"[qtt] 2^{d} points, rank {chi}: <a,b> = {val:.6e} "
          f"(fused zipper, {out['fused_s'] * 1e3:.1f} ms first call)", file=sys.stderr)

    t0 = clock(dev)
    val2 = float(a.inner(b))
    out["graph_s"] = clock(dev) - t0
    print(f"[qtt] graph-path inner = {val2:.6e} ({out['graph_s'] * 1e3:.1f} ms "
          "first call incl. planning)", file=sys.stderr)
    assert np.isclose(val, val2, rtol=1e-4), (val, val2)
    out["inner_fused"], out["inner_graph"] = val, val2

    # point evaluation over the 2^30 grid without densifying
    pts = rng.randint(0, 2, size=(1000, d))
    t0 = clock(dev)
    vals = a.evaluate(a.free_indices(), pts)
    out["evaluate_s"] = clock(dev) - t0
    print(f"[qtt] evaluated 1000 points in {out['evaluate_s'] * 1e3:.1f} ms; "
          f"mean={vals.mean():.3e}", file=sys.stderr)
    out["points"], out["values"] = pts, vals

    # round a + a back down.  The tolerance must clear the f32 noise the
    # 30 chained QRs accumulate, so the per-bond budget eps/sqrt(d-1)
    # needs eps >= ~1e-3 in f32.
    t0 = clock(dev)
    s = tt_svd_round(a + a, 1e-3)
    out["round_s"] = clock(dev) - t0
    out["ranks"] = s.ranks()
    print(f"[qtt] rounded (a+a) ranks: max={max(s.ranks())}", file=sys.stderr)
    assert max(s.ranks()) <= chi

    print("qtt stretch OK", file=sys.stderr)
    return out


if __name__ == "__main__":
    p = parser(__doc__)
    p.add_argument("--d", type=int, default=30)
    p.add_argument("--chi", type=int, default=16)
    args = p.parse_args()
    main(args.d, args.chi, device=args.device)
