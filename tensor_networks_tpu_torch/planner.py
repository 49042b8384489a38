"""Edge-aware contraction planning with a cached frozen path.

Counterpart of ``tensor_networks_tpu/planner.py``.  The plan is a cached
artifact keyed per (structure, shapes, dtype):

  * index names are interned to integer ids, so no einsum alphabet limits
    the network size (d=640 trains work);
  * the pairwise contraction path is computed once per signature: the
    native subset DP (:mod:`tensor_networks_tpu_torch.native`) finds the
    exact minimum-flop order for up to 18 operands, and a size-greedy
    pass written here covers larger networks (it recovers the O(d n r^3)
    zipper order on TT chains and ladders);
  * execution is a sequence of pairwise ``torch.einsum`` calls along the
    frozen path, each with its own small local alphabet.

PyTorch runs eagerly, so there is no executable to compile; the cache
saves the path search, which is the expensive part for large networks.
"""

from __future__ import annotations

import functools
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from tensor_networks_tpu_torch.native import MAX_NATIVE_OPERANDS, optimal_path

_CACHE: Dict[tuple, "CompiledContraction"] = {}
_CACHE_LOCK = threading.Lock()

Path = List[Tuple[int, int]]


def _greedy_path(
    operand_ids: Sequence[Sequence[int]],
    out_ids: Sequence[int],
    dim_of: Dict[int, int],
) -> Path:
    """Size-greedy pairwise path (opt_einsum's greedy cost rule).

    Each step contracts the pair that minimizes ``size(result) -
    size(a) - size(b)``, preferring pairs that share an index; an index
    survives while the output or another remaining operand still holds
    it.  Among pairs of equal cost the one with the smaller result
    wins: on a chain of gathered cores, (B, r) x (B, r, r) and
    (B, r, r) x (B, r, r) free the same memory, and only the first is
    the zipper order (B r^2 operations a step, not B r^3, and no
    (B, r, r) intermediates held at once).  Positions follow the
    opt_einsum convention: the two operands are removed and their
    result is appended at the end.
    """
    ops = [frozenset(ids) for ids in operand_ids]
    out = frozenset(out_ids)
    count: Dict[int, int] = {}
    for o in ops:
        for x in o:
            count[x] = count.get(x, 0) + 1

    def size(ids) -> float:
        p = 1.0
        for i in ids:
            p *= dim_of[i]
        return p

    def kept_of(a, b) -> frozenset:
        # an index survives if the output or a third operand holds it
        return frozenset(
            x
            for x in a | b
            if x in out or count[x] > (x in a) + (x in b)
        )

    path: Path = []
    while len(ops) > 1:
        holders: Dict[int, List[int]] = {}
        for k, o in enumerate(ops):
            for x in o:
                holders.setdefault(x, []).append(k)
        pairs = {
            (h[p], h[q])
            for h in holders.values()
            for p in range(len(h))
            for q in range(p + 1, len(h))
        }
        if not pairs:  # disconnected: outer product of the cheapest pair
            pairs = {
                (i, j)
                for i in range(len(ops))
                for j in range(i + 1, len(ops))
            }
        best = None
        for i, j in pairs:
            kept = kept_of(ops[i], ops[j])
            cost = size(kept) - size(ops[i]) - size(ops[j])
            if best is None or (cost, size(kept), i, j) < best[0]:
                best = ((cost, size(kept), i, j), kept)
        (_, _, i, j), kept = best
        for x in ops[i] | ops[j]:
            count[x] -= (x in ops[i]) + (x in ops[j])
        for x in kept:
            count[x] += 1
        path.append((i, j))
        ops = [o for k, o in enumerate(ops) if k not in (i, j)] + [kept]
    return path


def _pair_einsum(
    a: torch.Tensor, a_ids, b: torch.Tensor, b_ids, out_ids
) -> torch.Tensor:
    """One pairwise contraction with a local (dense, < 52) alphabet."""
    local: Dict[int, int] = {}
    for i in list(a_ids) + list(b_ids):
        local.setdefault(i, len(local))
    return torch.einsum(
        a,
        [local[i] for i in a_ids],
        b,
        [local[i] for i in b_ids],
        [local[i] for i in out_ids],
    )


class CompiledContraction:
    """An einsum over interned index ids with a frozen pairwise path."""

    def __init__(
        self,
        operand_ids: Tuple[Tuple[int, ...], ...],
        out_ids: Tuple[int, ...],
        shapes: Tuple[Tuple[int, ...], ...],
    ):
        self.operand_ids = operand_ids
        self.out_ids = out_ids
        dim_of: Dict[int, int] = {}
        for ids, shape in zip(operand_ids, shapes):
            for i, sz in zip(ids, shape):
                dim_of[i] = int(sz)

        n_ops = len(operand_ids)
        self.path: Optional[Path] = None
        if n_ops == 2:
            self.path = [(0, 1)]
        elif n_ops > 2:
            self.path = self._native_path(operand_ids, out_ids, dim_of)
            if self.path is None:
                self.path = _greedy_path(operand_ids, out_ids, dim_of)

        # the id list each intermediate carries, fixed with the path
        self._steps = []
        ids = [tuple(x) for x in operand_ids]
        for i, j in self.path or []:
            rest = set(out_ids)
            for k, o in enumerate(ids):
                if k != i and k != j:
                    rest.update(o)
            seen = []
            for x in ids[i] + ids[j]:
                if x in rest and x not in seen:
                    seen.append(x)
            kept = tuple(seen)
            self._steps.append((i, j, ids[i], ids[j], kept))
            ids = [o for k, o in enumerate(ids) if k not in (i, j)]
            ids.append(kept)
        self._final_ids = ids[0] if ids else ()

    @staticmethod
    def _native_path(operand_ids, out_ids, dim_of) -> Optional[Path]:
        """Exact minimum-flop path from the C++ subset DP, when in range."""
        if not (2 < len(operand_ids) <= MAX_NATIVE_OPERANDS):
            return None
        n_ids = max(dim_of) + 1 if dim_of else 0
        if n_ids >= 64 or len(dim_of) != n_ids:
            return None
        dims = [float(dim_of[i]) for i in range(n_ids)]
        return optimal_path(operand_ids, out_ids, dims)

    def __call__(self, *arrays: torch.Tensor) -> torch.Tensor:
        return self.contract_lazy(arrays.__getitem__, len(arrays))

    def contract_lazy(self, operand, n_operands: int) -> torch.Tensor:
        """Run the frozen path on operands made at their first use:
        ``operand(k)`` returns operand ``k``.  Only the path's live
        intermediates and the two operands of a step are held at once,
        so a batched evaluator gathers one core at a time.  Nothing
        here reads a shape, so a traced batch size stays symbolic."""
        ops = list(range(n_operands))  # an int: operand not made yet
        for i, j, ids_i, ids_j, kept in self._steps:
            a, b = (operand(o) if isinstance(o, int) else o
                    for o in (ops[i], ops[j]))
            res = _pair_einsum(a, ids_i, b, ids_j, kept)
            ops = [o for k, o in enumerate(ops) if k not in (i, j)]
            ops.append(res)
        if isinstance(ops[0], int):
            ops[0] = operand(ops[0])
        # last operand: sum what the output drops, order as the output
        local = {x: k for k, x in enumerate(self._final_ids)}
        return torch.einsum(
            ops[0],
            [local[x] for x in self._final_ids],
            [local[x] for x in self.out_ids],
        )


def get_contraction(
    operand_ids: Sequence[Sequence[int]],
    out_ids: Sequence[int],
    shapes: Sequence[Sequence[int]],
    dtype,
) -> CompiledContraction:
    """Fetch (or build) the contraction plan for this signature."""
    key = (
        tuple(tuple(ids) for ids in operand_ids),
        tuple(out_ids),
        tuple(tuple(int(s) for s in shape) for shape in shapes),
        str(dtype),
    )
    with _CACHE_LOCK:
        hit = _CACHE.get(key)
    if hit is not None:
        return hit
    built = CompiledContraction(key[0], key[1], key[2])
    with _CACHE_LOCK:
        _CACHE[key] = built
    return built


def intern_ids(index_lists: Sequence[Sequence]) -> List[List[int]]:
    """Assign a stable integer id to each distinct index object."""
    mapping: Dict[object, int] = {}
    out: List[List[int]] = []
    for indices in index_lists:
        row = []
        for ind in indices:
            if ind not in mapping:
                mapping[ind] = len(mapping)
            row.append(mapping[ind])
        out.append(row)
    return out


def contract_values(
    index_lists: Sequence[Sequence],
    values: Sequence[torch.Tensor],
    output_indices: Sequence,
) -> torch.Tensor:
    """Contract arbitrary named-index operands down to ``output_indices``.

    The generic entry point used by ``TensorNetwork.contract`` and friends.
    """
    ids = intern_ids(list(index_lists) + [list(output_indices)])
    operand_ids, out_ids = ids[:-1], ids[-1]
    shapes = [tuple(v.shape) for v in values]
    dtype = functools.reduce(torch.promote_types, [v.dtype for v in values])
    # torch.einsum does not promote mixed dtypes; JAX's einsum does
    values = [v.to(dtype) for v in values]
    return get_contraction(operand_ids, out_ids, shapes, dtype)(*values)


def clear_cache() -> None:
    """Drop all cached plans (mostly for tests/benchmarks)."""
    with _CACHE_LOCK:
        _CACHE.clear()


def cache_size() -> int:
    with _CACHE_LOCK:
        return len(_CACHE)
