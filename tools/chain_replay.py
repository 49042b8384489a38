#!/usr/bin/env python3
"""Time H1 of one checkout of this repository on the card.

    python3 tools/chain_replay.py ROOT [CALLS]

ROOT is the root of the checkout whose ``tensor_networks_tpu_torch`` is
measured (its kernels are built there at first use), so that two commits
compare in one machine: run it for the parent, the change, the change
and the parent.  It prints one JSON line:

* ``chain_ms``: ``tt_inner_chain_cuda`` at d=50, n=32 and the shapes
  (256, 256) f32, (512, 300) f32, (200, 100) f64 and (100, 100) f32,
  mean ms of 5 calls after 2 (``chip_smoke._time_ms``, CUDA events);
  ``fused_ms``:
  ``tt_inner_cuda`` (the fused route) at (100, 100) f32, 20 calls after 4;
* ``replay``: when CALLS is given, the calls of ``chip_smoke.py``'s
  phase 6 (its ``rounding_families`` line's ``chain_calls.by_shape``,
  as JSON: {"RAxRB f64 d=D n=N": count}) replayed by the same code as
  phase 6 (``chip_smoke._chain_calls_device_ms``): their summed device
  time under torch.profiler.

The trains are random (seeded), mids scaled 1/sqrt(n r).  Needs a card.
"""

from __future__ import annotations

import importlib.util
import json
import math
import re
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent  # this checkout
SHAPES = ((256, 256, "float32"), (512, 300, "float32"), (200, 100, "float64"),
          (100, 100, "float32"))


def main() -> int:
    root = Path(sys.argv[1]).resolve()
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        print("chain_replay: no CUDA device", file=sys.stderr)
        return 2
    # this checkout's chip_smoke.py (ROOT may hold an older one)
    spec = importlib.util.spec_from_file_location("chain_replay_smoke", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from tensor_networks_tpu_torch.kernels import zipper as zp

    if Path(zp.__file__).resolve().parents[2] != root:  # ROOT's package, not HERE's
        raise RuntimeError(f"imported {zp.__file__}, not the package under {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    g = torch.Generator(device=dev).manual_seed(cs.SEED + 31)
    out = {"root": str(root), "chain_ms": {}}
    for ra, rb, name in SHAPES:
        dtype = getattr(torch, name)
        x = cs._train(g, cs.D, cs.N, ra, 1 / math.sqrt(cs.N * ra), dtype=dtype)
        y = cs._train(g, cs.D, cs.N, rb, 1 / math.sqrt(cs.N * rb), dtype=dtype)
        out["chain_ms"][f"{ra}x{rb} {zp.DTYPE_SUFFIX[dtype]}"] = cs._time_ms(
            lambda: zp.tt_inner_chain_cuda(*x, *y), 5, 1)
        if (ra, rb) == (100, 100):
            out["fused_ms"] = cs._time_ms(lambda: zp.tt_inner_cuda(*x, *y))
        del x, y
    if len(sys.argv) > 2:
        dtypes = {v: k for k, v in zp.DTYPE_SUFFIX.items()}
        calls = []
        for key, count in json.loads(sys.argv[2]).items():
            ra, rb, name, d, n = re.fullmatch(r"(\d+)x(\d+) (\w+) d=(\d+) n=(\d+)", key).groups()
            ra, rb, d, n = int(ra), int(rb), int(d), int(n)
            shapes = ((n, ra), (d - 2, ra, n, ra) if d > 2 else None, (ra, n),
                      (n, rb), (d - 2, rb, n, rb) if d > 2 else None, (rb, n))
            calls += [(shapes, dtypes[name])] * count
        out["replay"] = cs._chain_calls_device_ms(zp, calls, dev)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
