"""SearchEngine: the one-stop facade over the three strategies.

Dispatches to the exhaustive drivers (:mod:`.drivers`) or the program
synthesizer (:mod:`.synthesis`) and decorates the raw run stats with the
summary metrics downstream consumers expect (``cr_core``, ``cr_start``,
``reconstruction_error``, ``best_network``).

Counterpart of ``tensor_networks_tpu/search/search.py``.  The engine
runs on the device of the network it is given.
"""

from __future__ import annotations

import numpy as np

from tensor_networks_tpu_torch.network import TensorNetwork
from tensor_networks_tpu_torch.search.configuration import SearchConfig
from tensor_networks_tpu_torch.search.drivers import run_bfs, run_dfs
from tensor_networks_tpu_torch.search.synthesis import PartitionSearch
from tensor_networks_tpu_torch.search.trace import approx_error
from tensor_networks_tpu_torch.tensor import Tensor


def _summarize(
    stats: dict, net: TensorNetwork, best: TensorNetwork, target: Tensor
) -> dict:
    """Attach the summary metrics to a finished run."""
    dense_cost = float(np.prod([i.size for i in net.free_indices()]))
    stats["best_network"] = best
    stats["cr_core"] = dense_cost / best.cost()
    stats["cr_start"] = net.cost() / best.cost()
    stats["reconstruction_error"] = approx_error(target, best)
    return stats


class SearchEngine:
    """Tensor-network topology search."""

    def __init__(self, config: SearchConfig):
        self.config = config

    def dfs(self, net: TensorNetwork) -> dict:
        """Exhaustive depth-first enumeration."""
        stats, best, target = run_dfs(net, self.config)
        return _summarize(stats, net, best, target)

    def bfs(self, net: TensorNetwork) -> dict:
        """Exhaustive breadth-first enumeration."""
        stats, best, target = run_bfs(net, self.config)
        # the timeout can expire before any candidate was scored; the
        # input network is then the (trivial) best
        return _summarize(stats, net, best if best is not None else net, target)

    def partition_search(self, net: TensorNetwork) -> dict:
        """Output-directed split synthesis with exact rank assignment."""
        return PartitionSearch(self.config).search(net)
