#!/usr/bin/env python3
"""The d- and n-scaling envelope of the port on the card: the zipper inner
product (the H1 kernel) and the prefix rounding sweep
(``tt_round_fixed(..., method="prefix", eps=1e-3)``).

The port of ``tools/scaling_probe.py``, along its two axes:

* d in {10, 50, 100, 200} at n=32, r=100
* n in {32, 128, 512} at d=50, r=100

Two float32 trains x and y, drawn on the device: x's cores Gaussian
scaled by 1/sqrt(n r), y's cores x's plus 0.1 of an independent draw,
times 2^(1/d).  So <x, y> is about 2 <x, x>, and a kernel that read one
train's core for the other's would be off by 2^(1/d) or more.  Each
point is slope-timed (``examples_torch._common.slope_ms``: ``k`` chained
calls between two CUDA events, for two values of ``k``, best of
``reps`` each; every output consumed):

* H1 itself (``zipper.tt_inner`` on the packed cores), beside its plain
  PyTorch version on the same cores, and held to the plain version in
  float64;
* the public call ``tt_inner_fast(x, y)`` on the two networks
  (``api_ms``), which also stacks each train's middle cores;
* ``tt_round_fixed(x, 1e-3, method="prefix")``.

H1 stands beside its bound (``kernels.bounds.inner_bound``: its flops
over the FP32 peak, its bytes over the HBM rate, whichever is larger).

    python3 tools/scaling_probe_torch.py [--out PATH] [--device cpu]

Prints one line a point and writes the record as JSON to ``--out``
(default ``chiprun_out/scaling_probe_torch.json``, not tracked by git).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys

import torch

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)

from examples_torch._common import device_of, slope_ms, tt_network  # noqa: E402
from tensor_networks_tpu_torch import Index, tt_inner_fast, tt_round_fixed  # noqa: E402
from tensor_networks_tpu_torch.kernels import zipper  # noqa: E402
from tensor_networks_tpu_torch.kernels.bounds import inner_bound  # noqa: E402

CONFIGS = (
    ("d10_n32_r100", 10, 32, 100),
    ("d50_n32_r100", 50, 32, 100),
    ("d100_n32_r100", 100, 32, 100),
    ("d200_n32_r100", 200, 32, 100),
    ("d50_n128_r100", 50, 128, 100),
    ("d50_n512_r100", 50, 512, 100),
)
INNER_KS, ROUND_KS = (8, 40), (1, 9)
#: H1 in float32 against the plain zipper in float64, relative to <x, y>
INNER_TOL = 1e-4
OUT_PATH = os.path.join(_ROOT, "chiprun_out", "scaling_probe_torch.json")


def make_trains(d, n, r, dev, seed=0):
    """The packed cores (first, mids, last) of x and y, drawn on ``dev``
    from ``torch.Generator(seed)`` (the largest train is 1 GB)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    s = 1.0 / math.sqrt(n * r)
    shapes = ((n, r), (d - 2, r, n, r), (r, n))
    x = [torch.randn(shape, generator=g, device=dev).mul_(s) for shape in shapes]
    y = [torch.randn(shape, generator=g, device=dev).mul_(0.1 * s).add_(c).mul_(2 ** (1 / d))
         for shape, c in zip(shapes, x)]
    return x, y


def _network(indices, cores, dev):
    return tt_network(indices, [cores[0], *cores[1].unbind(0), cores[2]], dev)


def probe(configs=CONFIGS, device=None, inner_ks=INNER_KS, round_ks=ROUND_KS,
          reps=4) -> dict:
    """The envelope at ``configs``: for each point, H1's ms a call beside
    its plain version's, its bound and share of the bound, the public
    call's ms, and the prefix rounding's ms a call with its kept ranks."""
    dev = device_of(device)
    record = {"points": {}}
    for name, d, n, r in configs:
        x, y = make_trains(d, n, r, dev)
        indices = [Index(f"x{k}", n) for k in range(d)]
        net_x, net_y = _network(indices, x, dev), _network(indices, y, dev)
        inner_ms, inner_runs = slope_ms(lambda: zipper.tt_inner(*x, *y), inner_ks, dev, reps)
        plain_ms, _ = slope_ms(lambda: zipper.tt_inner_plain(*x, *y), inner_ks, dev, reps)
        api_ms, api_runs = slope_ms(lambda: tt_inner_fast(net_x, net_y), inner_ks, dev, reps)
        bound_ms, bound_by = inner_bound(x, y)
        ref = zipper.tt_inner_plain(*(c.double() for c in x), *(c.double() for c in y)).item()
        inner_err = abs(zipper.tt_inner(*x, *y).item() - ref)
        api_err = abs(tt_inner_fast(net_x, net_y).item() - ref)
        if not max(inner_err, api_err) <= INNER_TOL * abs(ref):
            raise AssertionError(f"{name}: H1 {inner_err:.3e}, tt_inner_fast {api_err:.3e} "
                                 f"from the f64 plain value {ref:.6e}")

        def rounded():
            out, ranks = tt_round_fixed(net_x, 1e-3, method="prefix")
            total = sum(out.value(k).sum(dtype=torch.float64) for k in out.network.nodes)
            return total + sum(ranks)

        round_ms, round_runs = slope_ms(rounded, round_ks, dev, reps)
        _, ranks = tt_round_fixed(net_x, 1e-3, method="prefix")
        row = {"d": d, "n": n, "r": r, "inner_ms": inner_ms, "plain_ms": plain_ms,
               "api_ms": api_ms, "bound_ms": bound_ms, "bound_by": bound_by,
               "share_of_bound": bound_ms / inner_ms, "inner_abs_err": inner_err,
               "inner_rel_err": inner_err / abs(ref), "api_rel_err": api_err / abs(ref),
               "round_prefix_ms": round_ms, "max_kept_rank": max(ranks),
               "inner_runs_ms": inner_runs, "api_runs_ms": api_runs,
               "round_runs_ms": round_runs,
               "train_mb": sum(c.numel() for c in x) * 4 / 2**20}
        record["points"][name] = row
        print(f"[scaling] {name}: H1 {inner_ms:.4f} ms (plain {plain_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms, {bound_by}; {100 * row['share_of_bound']:.1f}%; "
              f"{row['inner_rel_err']:.1e} from the f64 plain value), tt_inner_fast "
              f"{api_ms:.4f} ms, prefix round {round_ms:.2f} ms (max kept rank {max(ranks)})",
              flush=True)
        del net_x, net_y, x, y
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    if dev.type == "cuda":
        record["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    return record


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.strip().splitlines()[0])
    p.add_argument("--out", default=OUT_PATH)
    p.add_argument("--device", default=None)
    args = p.parse_args(argv)
    record = probe(CONFIGS, args.device)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(record, fh, indent=1)
    print(f"[scaling] wrote {args.out}")
    return record


if __name__ == "__main__":
    main()
