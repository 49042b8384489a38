"""Tracing and profiling hooks.

Counterpart of ``tensor_networks_tpu/profiling.py``, with
``torch.profiler`` in place of ``jax.profiler``: :func:`trace` records
the enclosed region (host activity, and the card's kernels and copies
where a CUDA device is present) and writes a Chrome/Perfetto trace into
``log_dir``; :func:`annotate` names a region so that it shows in that
timeline.

Usage::

    from tensor_networks_tpu_torch.profiling import trace, annotate

    with trace("/tmp/tnt-trace"):
        with annotate("tt_round"):
            tt_round_tight(tn, 1e-8)
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str, create_perfetto_link: bool = False) -> Iterator[str]:
    """Capture a trace of the enclosed region into ``log_dir``; yields the
    path of the trace file, written when the region ends.
    ``create_perfetto_link`` is accepted for the JAX signature: a Chrome
    trace opens in Perfetto as it is."""
    del create_perfetto_link
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    with torch.profiler.profile(activities=activities) as prof:
        yield path
    prof.export_chrome_trace(path)


def annotate(name: str):
    """Name the enclosed region in profiler timelines."""
    return torch.profiler.record_function(name)


class Timer:
    """Lightweight wall-clock accumulator for host-side phases.

    Covers code that never reaches the device (search enumeration, tree
    sweeps), where a device trace has nothing to show.
    """

    def __init__(self) -> None:
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def section(self, name: str) -> Iterator[None]:
        start = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - start
            self.counts[name] += 1

    def summary(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            lines.append(
                f"{name:<40s} {self.totals[name]*1e3:10.2f} ms "
                f"({self.counts[name]} calls)"
            )
        return "\n".join(lines)


_GLOBAL_TIMER: Optional[Timer] = None


def global_timer() -> Timer:
    """Process-wide timer used by ``--profile``-style flags."""
    global _GLOBAL_TIMER
    if _GLOBAL_TIMER is None:
        _GLOBAL_TIMER = Timer()
    return _GLOBAL_TIMER
