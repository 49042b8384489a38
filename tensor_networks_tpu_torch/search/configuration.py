"""Structure-search configuration.

Counterpart of ``tensor_networks_tpu/search/configuration.py``, copied:
a JSON file that the JAX package's ``SearchConfig.load`` accepts loads
here unchanged, and one it refuses is refused with the same error.
Plain dataclasses plus a small JSON loader.  The field names and default
values form the on-disk config schema and are therefore frozen — a JSON
file written for the reference engine (``pytens/search/configuration.py``)
must load here unchanged — but the implementation is our own: no pydantic,
just typed dataclasses with a recursive dict decoder and eager validation
of the enum-like fields.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field, fields
from typing import Optional


@dataclass
class HeuristicConfig:
    """Switches for the search-space pruning rules."""

    # drop children whose fresh bond could not be truncated at all
    prune_full_rank: bool = False
    # skip networks whose canonical topology hash was already visited
    prune_duplicates: bool = False
    # include bond sizes in the dedup hash (with prune_duplicates)
    prune_by_ranks: bool = True


@dataclass
class RankSearchConfig:
    """How many rank variants each split explores, and how programs are
    fitted to data."""

    # how many tail-block truncation candidates to branch on per split
    error_split_stepsize: int = 1
    # "topk": score programs with the exact rank solver, replay the best k
    # "all":  replay every program with an even per-step error split
    fit_mode: str = "topk"
    # number of programs replayed under fit_mode == "topk"
    k: int = 1

    _FIT_MODES = ("topk", "all")

    def __post_init__(self) -> None:
        if self.fit_mode not in self._FIT_MODES:
            raise ValueError(
                f"fit_mode must be one of {self._FIT_MODES}, "
                f"got {self.fit_mode!r}"
            )


@dataclass
class ProgramSearchConfig:
    """Symbolic program synthesis knobs."""

    # truncation candidates closer than bin_size * delta^2 in error mass
    # collapse into one bin during preprocessing
    bin_size: float = 0.1
    # split vocabulary: node-axis bipartitions ("isplit") or free-index
    # bipartitions resolved to their LCA node ("osplit")
    action_type: str = "osplit"
    # path of a pickled action list to re-execute instead of searching
    replay_from: Optional[str] = None

    _ACTION_TYPES = ("isplit", "osplit")

    def __post_init__(self) -> None:
        if self.action_type not in self._ACTION_TYPES:
            raise ValueError(
                f"action_type must be one of {self._ACTION_TYPES}, "
                f"got {self.action_type!r}"
            )


@dataclass
class SearchEngineConfig:
    """Budgets shared by every strategy."""

    eps: float = 0.1  # relative Frobenius error bound
    max_ops: int = 5  # longest action program considered
    timeout: Optional[float] = None  # wall-clock budget in seconds
    verbose: bool = False  # record the per-state trajectory


@dataclass
class OutputConfig:
    """Where preprocessing spills live and whether they are kept."""

    output_dir: str = "./output"
    remove_temp_after_run: bool = True


@dataclass
class PreprocessConfig:
    """Preprocessing-cache behavior."""

    force_recompute: bool = False  # ignore spilled SVD files


@dataclass
class SearchConfig:
    """Root of the configuration tree."""

    engine: SearchEngineConfig = field(default_factory=SearchEngineConfig)
    heuristics: HeuristicConfig = field(default_factory=HeuristicConfig)
    rank_search: RankSearchConfig = field(default_factory=RankSearchConfig)
    synthesizer: ProgramSearchConfig = field(
        default_factory=ProgramSearchConfig
    )
    output: OutputConfig = field(default_factory=OutputConfig)
    preprocess: PreprocessConfig = field(default_factory=PreprocessConfig)

    @staticmethod
    def load(json_str: str) -> "SearchConfig":
        """Build a config from a JSON string; unknown keys are rejected."""
        return _decode(SearchConfig, json.loads(json_str))

    @staticmethod
    def load_file(json_file: str) -> "SearchConfig":
        """Build a config from a JSON file."""
        with open(json_file, "r", encoding="utf-8") as f:
            return SearchConfig.load(f.read())


def _decode(cls, data):
    """Recursively instantiate a dataclass tree from nested dicts."""
    if not dataclasses.is_dataclass(cls):
        return data
    if not isinstance(data, dict):
        raise TypeError(f"expected an object for {cls.__name__}, got {data!r}")
    known = {f.name: f for f in fields(cls)}
    unknown = set(data) - set(known)
    if unknown:
        raise ValueError(
            f"unknown {cls.__name__} fields: {sorted(unknown)}"
        )
    kwargs = {}
    for name, value in data.items():
        # resolve the nested dataclass for the section fields; leaf fields
        # (str/float/bool/Optional[...]) pass through unchanged
        sub_cls = _SECTION_TYPES.get(name) if cls is SearchConfig else None
        kwargs[name] = _decode(sub_cls, value) if sub_cls else value
    return cls(**kwargs)


_SECTION_TYPES = {
    "engine": SearchEngineConfig,
    "heuristics": HeuristicConfig,
    "rank_search": RankSearchConfig,
    "synthesizer": ProgramSearchConfig,
    "output": OutputConfig,
    "preprocess": PreprocessConfig,
}
