"""Search observability: trajectory recording and the error metric.

The emitted dict keeps the reference engine's stat names (``count``,
``costs``, ``errors``, ``ops``, ``best_cost``, ``unique``, ``cr_core``,
``cr_start``, ``reconstruction_error``, ...) so downstream log consumers
keep working; the recorder itself is a small class rather than a bag of
module functions.

Counterpart of ``tensor_networks_tpu/search/trace.py``.  The error is
computed on the value's device; one float is read.
"""

from __future__ import annotations

import copy
import os
import time
from typing import Optional

import torch

from tensor_networks_tpu_torch.network import TensorNetwork
from tensor_networks_tpu_torch.tensor import Tensor

#: schema of an empty stats dict (kept as a constant for compatibility)
EMPTY_SEARCH_STATS = {
    "networks": [],
    "best_networks": [],
    "best_cost": [],
    "costs": [],
    "errors": [],
    "ops": [],
    "unique": {},
    "count": 0,
}


def approx_error(target: Tensor, net: TensorNetwork) -> float:
    """Relative Frobenius error of the network against a dense target,
    with free axes matched by index identity (order-insensitive)."""
    dense = net.contract()
    axis_of = {ind: k for k, ind in enumerate(dense.indices)}
    value = dense.value.permute([axis_of[i] for i in target.indices])
    ref = target.value
    return float(
        torch.linalg.vector_norm(value - ref) / torch.linalg.vector_norm(ref)
    )


class SearchTrace:
    """Accumulates the per-candidate trajectory of one search run.

    ``record`` appends one sample; ``stats`` is the live dict (mutated in
    place so strategies can add their own summary keys).
    """

    def __init__(self, target: Optional[Tensor], enabled: bool):
        self.target = target
        self.enabled = enabled
        self.stats = copy.deepcopy(EMPTY_SEARCH_STATS)
        self._start = time.time()
        self._overhead = 0.0

    def elapsed(self) -> float:
        """Wall-clock since construction, excluding recording overhead."""
        return time.time() - self._start - self._overhead

    def record(self, state, best: TensorNetwork) -> None:
        """Append one sample for a freshly generated candidate state."""
        ts = self.elapsed()
        if not self.enabled:
            return
        tic = time.time()
        self.stats["ops"].append((ts, len(state.past_actions)))
        self.stats["costs"].append((ts, state.network.cost()))
        self.stats["errors"].append(
            (ts, approx_error(self.target, state.network))
        )
        self.stats["best_cost"].append((ts, best.cost()))
        key = state.network.canonical_structure()
        self.stats["unique"][key] = self.stats["unique"].get(key, 0) + 1
        self._overhead += time.time() - tic


def remove_temp_dir(temp_dir: str, temp_files) -> None:
    """Best-effort cleanup of spilled preprocessing files."""
    try:
        for path in temp_files:
            os.remove(path)
        if not os.listdir(temp_dir):
            os.rmdir(temp_dir)
    except FileNotFoundError:
        pass
