"""Cross approximation: rank-adaptive interpolation over dimension trees
(the port of ``tensor_networks_tpu.cross``)."""

from tensor_networks_tpu_torch.cross.cross import (
    CrossAlgo,
    CrossApproximation,
    CrossConfig,
    CrossResult,
    ConvergenceCheck,
)
from tensor_networks_tpu_torch.cross.funcs import (
    TensorFunc,
    CachedFunc,
    FuncData,
    FuncTensorNetwork,
)
from tensor_networks_tpu_torch.cross.runner import (
    CrossRunner,
    TTCrossRunner,
    HTCrossRunner,
    TuckerCrossRunner,
)
from tensor_networks_tpu_torch.cross.maxvol import maxvol, maxvol_auto, maxvol_device

__all__ = [
    "CrossAlgo",
    "CrossApproximation",
    "CrossConfig",
    "CrossResult",
    "ConvergenceCheck",
    "TensorFunc",
    "CachedFunc",
    "FuncData",
    "FuncTensorNetwork",
    "CrossRunner",
    "TTCrossRunner",
    "HTCrossRunner",
    "TuckerCrossRunner",
    "maxvol",
    "maxvol_auto",
    "maxvol_device",
]
