"""Target functions for cross approximation.

A target is anything that turns a batch of integer multi-indices into a
batch of scalar values.  :class:`TensorFunc` handles the index->argument
mapping through each :class:`~tensor_networks_tpu_torch.types.Index`'s
``value_choices`` grid (precompiled into one lookup table at
construction); :class:`CachedFunc` adds unique-evaluation accounting —
the standard sample-efficiency metric of cross approximation.

Copied from ``tensor_networks_tpu/cross/funcs.py`` (framework-free host
code); :class:`FuncTensorNetwork` samples a network of this package.

Capability parity: the function protocol of ``pytens/cross/funcs.py``
(TensorFunc :12, CachedFunc :107, FuncData :136, FuncTensorNetwork :147).
"""

from __future__ import annotations

from abc import abstractmethod
from typing import List

import numpy as np

from tensor_networks_tpu_torch.types import Index


class TensorFunc:
    """A function of ``d`` named indices, evaluated in batch.

    Subclasses implement :meth:`run`, mapping an (n, d) array of
    *argument values* to (n,) function values.  Calling the object maps
    integer multi-indices to arguments first.
    """

    def __init__(self, indices: List[Index]):
        self.indices = indices
        self.d = len(indices)
        self.name = "_func_"
        # one padded lookup table: grids[i, j] = j-th choice of index i;
        # indices without an explicit grid default to the identity, so
        # data-backed functions work without value_choices
        sizes = [
            len(i.value_choices) or int(i.size) for i in indices
        ]
        table = np.zeros((len(indices), max(sizes, default=1)))
        for row, ind in enumerate(indices):
            grid = np.asarray(ind.value_choices, dtype=float)
            if grid.size == 0:
                grid = np.arange(int(ind.size), dtype=float)
            table[row, : grid.size] = grid
        self._grid_table = table
        self._grid_sizes = np.asarray(sizes, dtype=int)

    def index_to_args(self, indices: np.ndarray) -> np.ndarray:
        """Integer multi-indices (n, d) -> argument values (n, d), one
        vectorized gather from the precompiled grid table."""
        pts = np.asarray(indices).astype(int)
        # the table is padded to the largest mode; an index into the pad
        # region of a smaller mode is a pivot-bookkeeping bug upstream
        # and must fail loudly, not read 0.0
        if pts.size and (
            pts.min() < 0 or (pts >= self._grid_sizes[None, :]).any()
        ):
            bad = np.argwhere(
                (pts < 0) | (pts >= self._grid_sizes[None, :])
            )[0]
            raise IndexError(
                f"multi-index out of range: row {bad[0]} has index "
                f"{pts[bad[0], bad[1]]} for mode {bad[1]} of size "
                f"{self._grid_sizes[bad[1]]}"
            )
        return self._grid_table[
            np.arange(self.d)[None, :], pts
        ]

    @property
    def shape(self) -> List[int]:
        """Mode sizes of the represented tensor."""
        out = []
        for ind in self.indices:
            size = ind.size
            out.append(
                size[-1] if isinstance(size, tuple) else int(size)
            )
        return out

    def size(self) -> int:
        """Number of entries of the dense tensor."""
        return int(np.prod(self.shape))

    def cost(self) -> int:
        """Storage cost proxy (dense entry count)."""
        return self.size()

    def free_indices(self) -> List[Index]:
        """The domain indices."""
        return self.indices

    @abstractmethod
    def run(self, args: np.ndarray) -> np.ndarray:
        """Evaluate at argument values: (n, d) -> (n,)."""
        raise NotImplementedError

    def __call__(self, indices: np.ndarray) -> np.ndarray:
        return self.run(self.index_to_args(indices))


class CachedFunc(TensorFunc):
    """A tensor function with unique-evaluation accounting.

    Deduplication uses a hash set of argument rows (O(1) per row), not a
    growing array scan; ``calls`` retains the raw evaluation history for
    API parity.
    """

    def __init__(self, indices: List[Index]):
        super().__init__(indices)
        self._seen = set()
        self.calls = np.empty((0, self.d))

    def num_calls(self) -> int:
        """Count of distinct argument rows evaluated so far."""
        return len(self._seen)

    @abstractmethod
    def _run(self, args: np.ndarray) -> np.ndarray:
        """Subclass hook: evaluate at (n, d) argument values."""
        raise NotImplementedError

    def run(self, args: np.ndarray) -> np.ndarray:
        rows = np.ascontiguousarray(np.asarray(args, dtype=float))
        self._seen.update(row.tobytes() for row in rows)
        self.calls = np.concatenate([rows, self.calls])
        return self._run(args)


class FuncData(CachedFunc):
    """A dense array exposed as a tensor function (index lookups)."""

    def __init__(self, indices: List[Index], data: np.ndarray):
        super().__init__(indices)
        self.data = data

    def _run(self, args: np.ndarray) -> np.ndarray:
        lookup = tuple(np.asarray(args).astype(int).T)
        return self.data[lookup]


class FuncTensorNetwork(CachedFunc):
    """An existing network exposed as a tensor function; evaluation is
    the network's batched evaluation (the H2 kernel for a chain on the
    card).

    ``precision="dw"``: sample in float64 (H2's float64 instantiation
    for a chain on the card, whatever the cores' dtype) -- the fiber
    precision of the on-chip cross loop, whose approximation error
    floor is the fiber noise (f32 fibers put a ~1e-6 floor under the
    whole cross)."""

    def __init__(self, indices: List[Index], net, precision: str = None):
        super().__init__(indices)
        self.net = net
        self.precision = precision

    def _run(self, args: np.ndarray) -> np.ndarray:
        return self.net.evaluate(
            self.indices, np.asarray(args).astype(int),
            precision=self.precision,
        )

    def cost(self) -> int:
        """Evaluation cost of the underlying network."""
        return self.net.cost()
