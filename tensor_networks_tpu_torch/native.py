"""ctypes bridge to the native C++ path optimizer.

Binds the repository's shared ``native/path_optimizer.cpp`` (the same
source the JAX package builds; it is not copied).  The library is built
with ``g++`` on first use into the package's own ignored build directory
(:mod:`tensor_networks_tpu_torch.kernels._build`), never next to the
source.  When the toolchain is missing, :func:`optimal_path` returns None
and the planner uses its greedy search: the native optimizer is a
performance component, never a correctness dependency.
"""

from __future__ import annotations

import ctypes
import logging
import threading
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

from tensor_networks_tpu_torch.kernels._build import compile_shared

logger = logging.getLogger(__name__)

_SRC = (
    Path(__file__).resolve().parent.parent / "native" / "path_optimizer.cpp"
)
_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"]

MAX_NATIVE_OPERANDS = 18

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_LIB_FAILED = False


def _lib() -> Optional[ctypes.CDLL]:
    global _LIB, _LIB_FAILED
    with _LOCK:
        if _LIB is not None or _LIB_FAILED:
            return _LIB
        try:
            so = compile_shared("g++", [_SRC], _FLAGS, "libtnt_path.so")
            lib = ctypes.CDLL(str(so))
        except (OSError, RuntimeError) as exc:
            logger.info("native path optimizer unavailable: %s", exc)
            _LIB_FAILED = True
            return None
        lib.tnt_optimal_path.restype = ctypes.c_int
        lib.tnt_optimal_path.argtypes = [
            ctypes.c_int32,
            np.ctypeslib.ndpointer(np.int32),
            np.ctypeslib.ndpointer(np.int32),
            ctypes.c_int32,
            np.ctypeslib.ndpointer(np.float64),
            np.ctypeslib.ndpointer(np.int32),
            ctypes.c_int32,
            np.ctypeslib.ndpointer(np.int32),
        ]
        _LIB = lib
        return _LIB


def optimal_path(
    operand_ids: Sequence[Sequence[int]],
    out_ids: Sequence[int],
    dim_of_id: Sequence[float],
) -> Optional[List[Tuple[int, int]]]:
    """Exact minimum-flop pairwise contraction path.

    Index ids must be dense 0..n_ids-1 with ``dim_of_id[i]`` the extent of
    id ``i``.  Returns opt_einsum-convention position pairs, or None when
    the native library is unavailable or the instance is out of range.
    """
    n_ops = len(operand_ids)
    n_ids = len(dim_of_id)
    if n_ops < 2 or n_ops > MAX_NATIVE_OPERANDS or n_ids >= 64:
        return None
    lib = _lib()
    if lib is None:
        return None

    flat = np.asarray(
        [i for ids in operand_ids for i in ids], dtype=np.int32
    )
    offsets = np.zeros(n_ops + 1, dtype=np.int32)
    for i, ids in enumerate(operand_ids):
        offsets[i + 1] = offsets[i] + len(ids)
    dims = np.asarray(dim_of_id, dtype=np.float64)
    out = np.asarray(list(out_ids), dtype=np.int32)
    path = np.zeros(2 * (n_ops - 1), dtype=np.int32)

    rc = lib.tnt_optimal_path(
        n_ops, flat, offsets, n_ids, dims, out, len(out_ids), path
    )
    if rc != 0:
        return None
    return [
        (int(path[2 * k]), int(path[2 * k + 1]))
        for k in range(n_ops - 1)
    ]
