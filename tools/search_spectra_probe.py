#!/usr/bin/env python3
"""Time the ways of computing a group of singular values on the card.

    python3 tools/search_spectra_probe.py [MEMBERS]

On ``bench.py``'s ``_leg_bfs8`` target (``default_rng(0)``, d=8 modes of
6), for each of its four exact-shape bipartition groups ((6, 279936),
(36, 46656), (216, 7776), (1296, 1296)) in float32 and float64, the
first MEMBERS (default 8) matricizations of the group, each as one
batched call:

* ``svdvals`` with cuSOLVER's default driver, ``gesvd``, ``gesvdj`` and
  ``gesvda``;
* ``qr``: one batched QR of the transposed matrices, then ``svdvals``
  of the (m, m) R factors (default driver, and ``gesvd``);
* ``gram64``: the Gram ``A A^T`` formed in float64, ``eigvalsh``, the
  square roots.

Each route runs once on two members (its first call), then is timed
once on the MEMBERS (host clock, synchronised); its first member is
held to ``numpy.linalg.svd`` in float64 on the host, relative to the
top singular value.  Prints the card and one JSON line: {dtype: {group:
{route: [ms a matrix, error]}}}.  Needs a card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import _bfs8_groups  # noqa: E402
from tensor_networks_tpu_torch.search import batched  # noqa: E402

D, N = 8, 6


def _routes():
    def svdvals(driver):
        return lambda a: torch.linalg.svdvals(a, driver=driver)

    def qr(driver):
        return lambda a: torch.linalg.svdvals(torch.linalg.qr(a.mT, mode="r")[1], driver=driver)

    def gram64(a):
        a = a.double()
        return torch.linalg.eigvalsh(a @ a.mT).flip(-1).clamp_min(0.0).sqrt()

    out = {f"svdvals {d or 'default'}": svdvals(d) for d in (None, "gesvd", "gesvdj", "gesvda")}
    out.update({f"qr {d or 'default'}": qr(d) for d in (None, "gesvd")})
    out["gram64"] = gram64
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("search_spectra_probe: no CUDA device", file=sys.stderr)
        return 2
    members = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}")
    host = np.random.default_rng(0).standard_normal([N] * D)
    groups = _bfs8_groups(torch.from_numpy(host))
    out = {}
    for dtype in (torch.float32, torch.float64):
        data = host.astype(np.float32) if dtype == torch.float32 else host
        value = torch.from_numpy(data).to("cuda")
        rows = {}
        for (m, n), group in groups.items():
            stack = batched._stack_group(value, [p for _, p in group[:members]], (m, n))
            axes = group[0][0]
            rest = [k for k in range(D) if k not in axes]
            ref = np.linalg.svd(np.transpose(data.astype(np.float64), list(axes) + rest)
                                .reshape(N ** len(axes), -1), compute_uv=False)
            row = {}
            for name, fn in _routes().items():
                try:  # a driver that refuses the shape is recorded, not fatal
                    fn(stack[:2])
                except RuntimeError as exc:
                    row[name] = str(exc)[:80]
                    continue
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                s = fn(stack)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3 / stack.shape[0]
                err = float(np.abs(s[0].double().cpu().numpy() - ref).max() / ref[0])
                row[name] = [float(f"{ms:.4g}"), float(f"{err:.3g}")]
            rows[f"{m}x{n}"] = row
            print(f"{dtype} {m}x{n}: {row}", file=sys.stderr)
        out[str(dtype)[6:]] = rows
    print(json.dumps(out, separators=(",", ":")))
    return 0


if __name__ == "__main__":
    sys.exit(main())
