"""Core type definitions of the PyTorch tensor-network package.

Host-side metadata types: named indices and SVD configuration.  These
objects never live on a device; they describe the *structure* that the
torch code (see :mod:`tensor_networks_tpu_torch.kernels`) operates over.
Taken over from ``tensor_networks_tpu/types.py``; :func:`resolve_device`
(the package's default-device rule) has no counterpart there.

Parity reference: ``pytens/types.py`` (Index :19, SVDConfig :60).  The
dimension-tree machinery lives in :mod:`tensor_networks_tpu_torch.dimtree`.
"""

from __future__ import annotations

import dataclasses
import logging
from dataclasses import dataclass, field
from typing import Any, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

logger = logging.getLogger(__name__)

IntOrStr = Union[str, int]
IndexName = IntOrStr
IndexChain = Union[List[int], Tuple[int, ...]]
NodeName = IntOrStr


def resolve_device(device=None) -> torch.device:
    """The device a constructor places its tensors on.

    ``None`` means the card, ``torch.device("cuda")``: the package runs
    on the GPU unless the caller names another device.  Nothing here
    looks for a GPU: on a machine without one the first allocation
    raises torch's own error.  Anything else goes through
    ``torch.device``.
    """
    if device is None:
        return torch.device("cuda")
    return torch.device(device)


@dataclass(frozen=True)
class Index:
    """A named tensor leg.

    Two indices are interchangeable iff they share ``(name, size)``; the
    optional ``value_choices`` grid (used by function tensors in cross
    approximation) does not participate in equality or hashing.

    ``size`` is normally an ``int``; during structure search the rank
    solver temporarily relabels sizes to *tuples* of candidate ranks
    (see ``search/constraint.py``), so the field is intentionally loose.
    """

    name: IntOrStr
    size: Any
    value_choices: Sequence[float] = field(default_factory=tuple)

    def with_new_size(self, new_size: Any) -> "Index":
        """Same name, different size."""
        return Index(self.name, new_size)

    def with_new_name(self, name: IntOrStr) -> "Index":
        """Same size, different name."""
        return Index(name, self.size)

    def with_new_rng(self, rng: Sequence[float]) -> "Index":
        """Same name/size, new value grid for function tensors."""
        return Index(self.name, self.size, rng)

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, Index):
            return False
        return self.name == other.name and self.size == other.size

    def __lt__(self, other: "Index") -> bool:
        return str(self.name) < str(other.name)

    def __hash__(self) -> int:
        return hash((self.name, self.size))

    def to_dict(self) -> dict:
        """Serialize to a plain dictionary."""
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, data_dict: dict) -> "Index":
        """Reconstruct from :meth:`to_dict` output."""
        return cls(**data_dict)


@dataclass
class SVDConfig:
    """Knobs for a network-level SVD split.

    ``delta``            absolute truncation budget (Frobenius).
    ``with_orthonormal`` orthonormalize the environment first so the local
                         truncation error equals the global one.
    ``compute_data``     when False, perform a *symbolic* split: graph
                         surgery only, node values left empty (used by the
                         structure-search program synthesizer).
    """

    delta: float = 1e-5
    with_orthonormal: bool = True
    compute_data: bool = True
