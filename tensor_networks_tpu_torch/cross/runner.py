"""One-call cross-approximation entry points per ansatz family.

Each runner builds a rank-1 starting structure of its family on its
device (default: the card) and drives :class:`CrossApproximation` to
the requested accuracy.  The families are table-driven; add a new
ansatz by registering a builder.  Counterpart of
``tensor_networks_tpu/cross/runner.py``.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np

from tensor_networks_tpu_torch.cross.cross import CrossApproximation, CrossConfig
from tensor_networks_tpu_torch.cross.funcs import TensorFunc
from tensor_networks_tpu_torch.network import TensorNetwork
from tensor_networks_tpu_torch.types import NodeName

AnsatzBuilder = Callable[[TensorFunc, object], Tuple[TensorNetwork, NodeName]]


def _build_tt(f: TensorFunc, device) -> Tuple[TensorNetwork, NodeName]:
    net = TensorNetwork.rand_tt(
        f.indices[:], [1] * (len(f.indices) - 1), device=device
    )
    return net, list(net.network.nodes)[0]


def _build_ht(f: TensorFunc, device) -> Tuple[TensorNetwork, NodeName]:
    net = TensorNetwork.rand_ht(f.indices, 1, device=device)
    return net, list(net.network.nodes)[0]


def _build_tucker(f: TensorFunc, device) -> Tuple[TensorNetwork, NodeName]:
    return TensorNetwork.rand_tucker(f.indices, device=device), "root"


_ANSATZ_BUILDERS: Dict[str, AnsatzBuilder] = {
    "tt": _build_tt,
    "ht": _build_ht,
    "tucker": _build_tucker,
}


class CrossRunner:
    """Fit a tensor network of a chosen family to a tensor function.

    Subclasses pin ``ansatz``; alternatively construct directly with
    ``CrossRunner(ansatz="tt")``.  The network is built on ``device``
    (default: the card, :func:`~tensor_networks_tpu_torch.resolve_device`).
    """

    ansatz: str = "tt"

    def __init__(self, ansatz: Optional[str] = None, device=None):
        if ansatz is not None:
            self.ansatz = ansatz
        if self.ansatz not in _ANSATZ_BUILDERS:
            raise ValueError(f"unknown ansatz {self.ansatz!r}")
        self.device = device

    def run(
        self,
        f: TensorFunc,
        eps: float,
        kickrank: int = 2,
        validation: Optional[np.ndarray] = None,
    ) -> TensorNetwork:
        """Run cross approximation to relative accuracy ``eps`` and
        return the fitted network."""
        net, root = _ANSATZ_BUILDERS[self.ansatz](f, self.device)
        engine = CrossApproximation(f, CrossConfig(kickrank=kickrank))
        engine.cross(net, root, validation, eps=eps)
        return net


class TTCrossRunner(CrossRunner):
    """TT-cross."""

    ansatz = "tt"


class HTCrossRunner(CrossRunner):
    """Hierarchical-Tucker cross."""

    ansatz = "ht"


class TuckerCrossRunner(CrossRunner):
    """Tucker cross."""

    ansatz = "tucker"
