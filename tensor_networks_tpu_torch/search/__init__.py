"""Tensor-network structure search.

Layers: the action vocabulary and MDP (:mod:`.actions`, :mod:`.mdp`),
exhaustive drivers (:mod:`.drivers`), bipartition spectra and the exact
rank solver (:mod:`.spectra`, :mod:`.constraint`), program synthesis with
a killable watchdog (:mod:`.synthesis`), and the :class:`SearchEngine`
facade (:mod:`.search`).

Counterpart of ``tensor_networks_tpu/search``, with its public names.
The search runs on the device of the network it is given; the batched
split scorer (:mod:`.batched`) and the bipartition spectra
(:mod:`.spectra`) factorize exact-shape batches there.
"""

from tensor_networks_tpu_torch.search.actions import (
    Action,
    ISplit,
    Merge,
    OSplit,
)
from tensor_networks_tpu_torch.search.configuration import (
    HeuristicConfig,
    OutputConfig,
    PreprocessConfig,
    ProgramSearchConfig,
    RankSearchConfig,
    SearchConfig,
    SearchEngineConfig,
)
from tensor_networks_tpu_torch.search.mdp import SearchState
from tensor_networks_tpu_torch.search.search import SearchEngine

__all__ = [
    "HeuristicConfig",
    "RankSearchConfig",
    "ProgramSearchConfig",
    "SearchEngineConfig",
    "OutputConfig",
    "PreprocessConfig",
    "SearchConfig",
    "Action",
    "OSplit",
    "ISplit",
    "Merge",
    "SearchState",
    "SearchEngine",
]
