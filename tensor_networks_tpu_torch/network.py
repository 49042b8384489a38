"""TensorNetwork: a host-side graph of named-index tensors.

Counterpart of ``tensor_networks_tpu/network.py`` (the subset the main
path needs: construction, index queries, contraction, composition, the
tree-aligned sum, batched evaluation, constructors and serialization).
Topology and index names stay in Python (O(d) metadata); the numbers are
``torch.Tensor`` values, contracted through
:mod:`tensor_networks_tpu_torch.planner` with a cached edge-aware path.

``copy.deepcopy`` of a network shares the value tensors, so code that
clones networks does no array copies.
"""

from __future__ import annotations

import copy
from collections import Counter
from dataclasses import dataclass
from typing import Any, Dict, List, Literal, Optional, Sequence, Tuple

import numpy as np
import torch

from tensor_networks_tpu_torch.dimtree import DimTreeNode, NodeInfo
from tensor_networks_tpu_torch.graph import Graph
from tensor_networks_tpu_torch.planner import contract_values
from tensor_networks_tpu_torch.tensor import Tensor
from tensor_networks_tpu_torch.types import (
    Index,
    IndexName,
    IntOrStr,
    NodeName,
    resolve_device,
)

_EVAL_CHUNK = 65536


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


@dataclass
class EinsumArgs:
    """A reusable contraction spec: per-node index lists + output order."""

    node_order: List[NodeName]
    node_indices: List[List[Index]]
    output_indices: List[Index]


class TensorNetwork:
    """A graph of tensors; contraction driven by shared index identity."""

    def __init__(self) -> None:
        self.network = Graph()

    # -- deepcopy: share value tensors ----------------------------------------

    def __deepcopy__(self, memo) -> "TensorNetwork":
        new = TensorNetwork()
        for name, attrs in self.network.nodes(data=True):
            t = attrs.get("tensor")
            if t is not None:
                new.network.add_node(
                    name, tensor=Tensor(t.value, list(t.indices))
                )
            else:
                new.network.add_node(name)
        for u, v in self.network.edges():
            new.network.add_edge(u, v)
        return new

    # -- node/edge management -------------------------------------------------

    def add_node(self, name: NodeName, tensor: Tensor) -> None:
        self.network.add_node(name, tensor=tensor)

    def add_edge(self, name1: NodeName, name2: NodeName) -> None:
        self.network.add_edge(name1, name2)

    def node_tensor(self, node_name: NodeName) -> Tensor:
        return self.network.nodes[node_name]["tensor"]

    def set_node_tensor(self, node_name: NodeName, value: Tensor) -> None:
        self.network.nodes[node_name]["tensor"] = value

    def value(self, node_name: NodeName) -> torch.Tensor:
        return self.network.nodes[node_name]["tensor"].value

    # -- index queries ---------------------------------------------------------

    def all_indices(self) -> Counter:
        indices: List[Index] = []
        for _, data in self.network.nodes(data=True):
            indices += data["tensor"].indices
        return Counter(indices)

    def free_indices(self) -> List[Index]:
        return [i for i, v in self.all_indices().items() if v == 1]

    def inner_indices(self) -> List[Index]:
        return [i for i, v in self.all_indices().items() if v > 1]

    def ranks(self) -> List[int]:
        return [r.size for r in self.inner_indices()]

    def shape(self) -> List[int]:
        return [i.size for i in self.free_indices()]

    def dim(self) -> int:
        return len(self.free_indices())

    def get_contraction_index(
        self, node1: NodeName, node2: NodeName
    ) -> List[Index]:
        inds = list(self.node_tensor(node1).indices) + list(
            self.node_tensor(node2).indices
        )
        cnt = Counter(inds)
        return [i for i, v in cnt.items() if v > 1]

    def rename_indices(
        self, rename_map: Dict[IntOrStr, IntOrStr]
    ) -> "TensorNetwork":
        for _, data in self.network.nodes(data=True):
            data["tensor"].rename_indices(rename_map)
        return self

    def node_by_free_index(self, index: IndexName) -> NodeName:
        for n in self.network.nodes:
            if index in [ind.name for ind in self.node_tensor(n).indices]:
                return n
        raise KeyError(f"Cannot find index {index} in the network")

    # -- contraction -------------------------------------------------------------

    def einsum_args(self) -> EinsumArgs:
        """Build the reusable contraction spec for this topology."""
        free = self.free_indices()
        node_order = list(self.network.nodes)
        node_indices = [list(self.node_tensor(n).indices) for n in node_order]
        return EinsumArgs(node_order, node_indices, free)

    def contract(self, eargs: Optional[EinsumArgs] = None) -> Tensor:
        """Contract the whole network to a dense tensor.

        The contraction path is edge-aware and cached by (structure,
        shapes, dtype).
        """
        if eargs is None:
            eargs = self.einsum_args()
        values = [self.value(n) for n in eargs.node_order]
        out = contract_values(
            eargs.node_indices, values, eargs.output_indices
        )
        return Tensor(out, list(eargs.output_indices))

    # -- composition ----------------------------------------------------------------

    def attach(
        self, other: "TensorNetwork", rename: Tuple[str, str] = ("G", "H")
    ) -> "TensorNetwork":
        """Union two networks; shared free indices become bonds.

        Interior indices on each side are prefixed so only the free-index
        overlap connects the two halves (reference composition,
        ``pytens/algs.py:521``).  Value tensors are shared, never copied.
        """
        joined = TensorNetwork()
        for side, prefix in ((self, rename[0]), (other, rename[1])):
            exposed = set(side.free_indices())
            for n, data in side.network.nodes(data=True):
                t = data["tensor"]
                remap = {
                    ix.name: (
                        ix.name if ix in exposed else f"{prefix}{ix.name}"
                    )
                    for ix in t.indices
                }
                joined.add_node(
                    f"{prefix}{n}",
                    Tensor(t.value, list(t.indices)).rename_indices(remap),
                )
            for u, v in side.network.edges():
                joined.add_edge(f"{prefix}{u}", f"{prefix}{v}")

        owners: Dict[Index, List[NodeName]] = {}
        for n in self.network.nodes:
            name = f"{rename[0]}{n}"
            for ix in joined.node_tensor(name).indices:
                owners.setdefault(ix, []).append(name)
        for n in other.network.nodes:
            name = f"{rename[1]}{n}"
            for ix in joined.node_tensor(name).indices:
                for left in owners.get(ix, ()):
                    joined.add_edge(left, name)
        return joined

    def scale(self, scale_factor: float) -> "TensorNetwork":
        """Scale the represented tensor (folds the factor into one core)."""
        first = next(iter(self.network.nodes))
        t = self.node_tensor(first)
        t.value = t.value * scale_factor
        return self

    def inner(self, other: "TensorNetwork") -> torch.Tensor:
        """Inner product <self, other> over the shared free indices."""
        return self.attach(other).contract().value

    def norm(self) -> float:
        """Frobenius norm of the represented tensor."""
        val = float(self.inner(self))
        return float(np.sqrt(np.abs(val)))

    # -- dimension trees -------------------------------------------------------------------

    def _rooted_order(
        self, root: NodeName
    ) -> Tuple[List[NodeName], Dict[NodeName, Optional[NodeName]]]:
        """Iterative preorder + parent map of the tree hanging off ``root``.

        Children appear in neighbor (insertion) order; reversing the
        returned list gives a valid leaves-first schedule.
        """
        parent: Dict[NodeName, Optional[NodeName]] = {root: None}
        order: List[NodeName] = []
        stack: List[NodeName] = [root]
        while stack:
            cur = stack.pop()
            order.append(cur)
            fresh = [
                n
                for n in self.network.neighbors(cur)
                if n not in parent
            ]
            for n in fresh:
                parent[n] = cur
            stack.extend(reversed(fresh))
        return order, parent

    def canonicalize_indices(self, tree: DimTreeNode) -> None:
        """Record, per tree node, the permutation from the node tensor's
        axis order to (free, children bonds, parent bond) order."""
        for tnode in tree.preorder():
            axes = self.node_tensor(tnode.node).indices
            want: List[Index] = list(tnode.free_indices)
            for child in tnode.down_info.nodes:
                want.append(
                    self.get_contraction_index(child.node, tnode.node)[0]
                )
            up = [ix for ix in axes if ix not in want]
            assert len(up) <= 1, (
                f"expected at most one parent bond, got {up}"
            )
            want.extend(up)
            tnode.perm = [axes.index(ix) for ix in want]

    def dimension_tree(self, root: NodeName) -> DimTreeNode:
        """Build the rooted dimension tree (up/down index assignments) for
        this tree network.  Reference semantics: ``pytens/algs.py:1038``.

        Three iterative passes over the ``_rooted_order`` schedule:
        leaves-first construction of the nodes, one root-first pass
        filling every node's down-facing index list, then
        ``canonicalize_indices`` for the axis permutations.
        """
        free_set = set(self.free_indices())
        order, parent = self._rooted_order(root)

        built: Dict[NodeName, DimTreeNode] = {}
        collected: Dict[NodeName, List[DimTreeNode]] = {n: [] for n in order}
        for name in reversed(order):
            own_free = [
                ix
                for ix in self.node_tensor(name).indices
                if ix in free_set
            ]
            kids = sorted(collected[name], key=lambda c: c.indices)
            subtree: List[Index] = list(own_free)
            for c in kids:
                subtree.extend(c.indices)
            tnode = DimTreeNode(
                node=name,
                indices=subtree,
                free_indices=sorted(own_free),
                down_info=NodeInfo(kids, [], np.empty(0)),
                up_info=NodeInfo(
                    [], list(subtree), np.empty((0, len(subtree)))
                ),
            )
            for c in kids:
                c.up_info.nodes = [tnode]
            built[name] = tnode
            if parent[name] is not None:
                collected[parent[name]].append(tnode)

        tree = built[root]
        for tnode in tree.preorder():
            if not tnode.up_info.nodes:
                continue  # root sees nothing from above
            p = tnode.up_info.nodes[0]
            seen_above = list(p.free_indices)
            seen_above.extend(p.down_info.indices)
            for sib in p.down_info.nodes:
                if sib.node != tnode.node:
                    seen_above.extend(sib.up_info.indices)
            tnode.down_info.indices = seen_above
            tnode.down_info.vals = np.empty((0, len(seen_above)))

        self.canonicalize_indices(tree)
        return tree

    # -- batched evaluation -------------------------------------------------------------------

    def evaluate(
        self, indices: Sequence[Index], values: np.ndarray,
        precision: Optional[str] = None,
    ) -> np.ndarray:
        """Evaluate the represented tensor at a batch of multi-indices
        without densifying; returns a float64 NumPy vector.

        Out-of-range entries clamp to the index's range on every route,
        as the JAX package's device gathers do.  Chunks are padded to
        powers of two, as in the JAX package (which does it for compile
        reuse), so both give identical results.  ``precision="dw"``
        (double-word evaluation) is not ported yet.
        """
        if precision == "dw":
            raise NotImplementedError(
                "precision='dw' is not ported yet (ROADMAP, port queue: "
                "evaluate_dw becomes f64 evaluation)"
            )
        values = np.asarray(values).astype(int)
        n_total = values.shape[0]
        if values.ndim != 2 or values.shape[1] != len(indices):
            raise ValueError(
                f"values must be (B, {len(indices)}), got {values.shape}"
            )

        ragged = self._ragged_evaluator(indices)
        out = np.empty(n_total)
        start = 0
        while start < n_total:
            batch = min(_EVAL_CHUNK, n_total - start)
            padded = _next_pow2(batch)
            chunk = values[start : start + batch]
            if padded != batch:
                chunk = np.concatenate(
                    [chunk, np.repeat(chunk[-1:], padded - batch, axis=0)],
                    axis=0,
                )
            got = (
                ragged(chunk)
                if ragged is not None
                else self._evaluate_chunk(indices, chunk)
            )
            # numpy has no bfloat16: the values reach it as float64
            out[start : start + batch] = (
                got.detach().cpu().double().numpy()[:batch]
            )
            start += batch
        return out

    def _ragged_evaluator(self, indices: Sequence[Index]):
        """Packed-train route for linear chains whose cores live on a
        CUDA device.

        A chain with one free index per core evaluates through
        :func:`ops.packed.evaluate`, which launches the evaluation kernel
        (the JAX package gates the same route on a TPU backend).  Returns
        a ``chunk -> (B,)`` callable, or None when the topology or the
        device does not qualify (the general evaluator handles those).

        The packed cores are cached on the instance, keyed by the node
        value OBJECTS (held, and compared by identity, so CPython id
        reuse cannot alias) -- ``update_val_size`` replaces the value
        tensor, so mutation invalidates the cache without bookkeeping.
        """
        if len(self.network.nodes) < 3:
            return None
        key = tuple(self.node_tensor(n).value for n in self.network.nodes)
        if not all(v.is_cuda for v in key):
            return None
        from tensor_networks_tpu_torch.ops import packed as _pk

        cached = getattr(self, "_ragged_cache", None)
        if (
            cached is not None
            and len(cached[0]) == len(key)
            and all(a is b for a, b in zip(cached[0], key))
        ):
            pk, frees = cached[1], cached[2]
        else:
            extracted = _pk.chain_cores(self)
            if extracted is None:
                return None
            frees = extracted[2]
            pk = _pk.pack_ragged(self)
            self._ragged_cache = (key, pk, frees)
        try:
            cols = [list(indices).index(f) for f in frees]
        except ValueError:  # evaluation over a different index set
            return None

        device = pk.first.device
        # per-dimension upper bounds: mixed mode sizes are padded to the
        # max inside the pack, so each column clamps at its TRUE size
        ub = torch.tensor([f.size - 1 for f in frees], device=device)

        def run(chunk: np.ndarray) -> torch.Tensor:
            idx = torch.as_tensor(chunk[:, cols], device=device)
            idx = torch.minimum(idx.clamp(min=0), ub[None, :])
            return _pk.evaluate(pk, idx, precision="highest")

        return run

    def _evaluate_chunk(
        self, indices: Sequence[Index], chunk: np.ndarray
    ) -> torch.Tensor:
        """One gather + contraction over a padded batch."""
        fn, values = self.evaluator(indices, chunk.shape[0])
        device = values[0].device
        return fn(values, torch.as_tensor(chunk, device=device))

    def evaluator(self, indices: Sequence[Index], batch_size: int):
        """The pure batched-evaluation function of this topology.

        Returns ``(fn, values)`` where ``fn(values, cols) -> (B,)``
        evaluates the network whose node values are ``values`` (listed in
        node order) at the ``(batch_size, len(indices))`` integer
        multi-index array ``cols``.  ``fn`` is differentiable in
        ``values``.  Out-of-range columns clamp to each index's range.
        """
        batch_ind = Index("_batch", batch_size)
        operand_indices: List[List[Index]] = []
        plans = []  # (perm or None, gathered columns, their sizes)
        values = []
        col_of = {ind: c for c, ind in enumerate(indices)}
        for node in self.network.nodes:
            tensor = self.node_tensor(node)
            gathered_axes = []
            gathered_cols = []
            rest_axes = []
            for ii, ind in enumerate(tensor.indices):
                col = col_of.get(ind)
                if col is not None:
                    gathered_axes.append(ii)
                    gathered_cols.append(col)
                else:
                    rest_axes.append(ii)
            if gathered_axes:
                plans.append(
                    (
                        tuple(gathered_axes + rest_axes),
                        tuple(gathered_cols),
                        tuple(tensor.indices[i].size for i in gathered_axes),
                    )
                )
                operand_indices.append(
                    [batch_ind] + [tensor.indices[i] for i in rest_axes]
                )
            else:
                plans.append((None, (), ()))
                operand_indices.append(list(tensor.indices))
            values.append(tensor.value)

        def run(vals, cols):
            operands = []
            for v, (perm, gcols, sizes) in zip(vals, plans):
                if perm is None:
                    operands.append(v)
                else:
                    idx = tuple(
                        cols[:, c].clamp(0, s - 1)
                        for c, s in zip(gcols, sizes)
                    )
                    operands.append(v.permute(perm)[idx])
            return contract_values(operand_indices, operands, [batch_ind])

        return run, values

    # -- constructors ------------------------------------------------------------------------------

    @staticmethod
    def rand_tt(
        indices: List[Index],
        ranks: List[int],
        dtype: torch.dtype = torch.float64,
        device=None,
        generator: Optional[torch.Generator] = None,
    ) -> "TensorNetwork":
        """A random tensor train with the given mode indices and bond
        ranks; standard-normal cores on ``device`` (default: the card),
        drawn from ``generator`` (which must live on that device) or,
        without one, from the device's default generator."""
        dim = len(indices)
        assert len(ranks) + 1 == len(indices)
        tt = TensorNetwork()
        device = resolve_device(device)

        def randn(*shape):
            return torch.randn(
                shape, generator=generator, dtype=dtype, device=device
            )

        bonds = [Index("r1", ranks[0])]
        tt.add_node(
            0,
            Tensor(randn(indices[0].size, ranks[0]), [indices[0], bonds[0]]),
        )
        for ii, index in enumerate(indices[1:-1]):
            bonds.append(Index(f"r{ii + 2}", ranks[ii + 1]))
            tt.add_node(
                ii + 1,
                Tensor(
                    randn(ranks[ii], index.size, ranks[ii + 1]),
                    [bonds[ii], index, bonds[ii + 1]],
                ),
            )
            tt.add_edge(ii, ii + 1)
        tt.add_node(
            dim - 1,
            Tensor(
                randn(ranks[-1], indices[-1].size), [bonds[-1], indices[-1]]
            ),
        )
        tt.add_edge(dim - 2, dim - 1)
        return tt

    # -- tree-aligned binary algebra --------------------------------------------------------------------

    def _binary_op(
        self,
        other: "TensorNetwork",
        op: Literal["add", "mul"],
        trees: Tuple[DimTreeNode, DimTreeNode],
        result_net: "TensorNetwork",
    ) -> None:
        stack = [trees]
        while stack:
            tree1, tree2 = stack.pop()
            tensor1 = self.node_tensor(tree1.node)
            tensor2 = other.node_tensor(tree2.node)
            assert len(tensor1.indices) == len(tensor2.indices)
            if op == "add":
                res = tensor1.block_diagonal(tensor2, tree1.free_indices)
            elif op == "mul":
                res = tensor1.mult(tensor2, self.free_indices())
            else:
                raise ValueError(f"Unknown operation {op}")
            result_net.set_node_tensor(tree1.node, res)
            stack.extend(zip(tree1.down_info.nodes, tree2.down_info.nodes))

    def _aligned_trees(
        self, other: "TensorNetwork"
    ) -> Tuple[DimTreeNode, DimTreeNode]:
        assert self.network.is_isomorphic_tree(other.network)
        root_ind = self.free_indices()[0]
        self_tree = self.dimension_tree(
            self.node_by_free_index(root_ind.name)
        )
        other_tree = other.dimension_tree(
            other.node_by_free_index(root_ind.name)
        )
        return self_tree, other_tree

    def __add__(self, other: "TensorNetwork") -> "TensorNetwork":
        """Exact structured addition of two isomorphic tree networks."""
        trees = self._aligned_trees(other)
        result = copy.deepcopy(self)
        self._binary_op(other, "add", trees, result)
        return result

    def __sub__(self, other: "TensorNetwork") -> "TensorNetwork":
        neg = copy.deepcopy(other)
        a_node = list(neg.network.nodes)[0]
        a_tensor = neg.node_tensor(a_node)
        neg.set_node_tensor(
            a_node, a_tensor.update_val_size(a_tensor.value * -1)
        )
        return self + neg

    def __mul__(self, other: "TensorNetwork") -> "TensorNetwork":
        """Exact structured Hadamard product (ranks multiply)."""
        trees = self._aligned_trees(other)
        result = copy.deepcopy(self)
        self._binary_op(other, "mul", trees, result)
        return result

    # -- serialization ---------------------------------------------------------------------------------------

    def to_dict(self) -> dict:
        """Node-link dict with embedded tensor payloads (NumPy values)."""
        nodes = []
        for name, data in self.network.nodes(data=True):
            entry: Dict[str, Any] = {"id": name}
            if "tensor" in data:
                entry["tensor_dict"] = data["tensor"].to_dict()
            nodes.append(entry)
        links = [{"source": u, "target": v} for u, v in self.network.edges()]
        return {"directed": False, "nodes": nodes, "links": links}

    @classmethod
    def from_dict(
        cls, data_dict: dict, device=None, dtype=None
    ) -> "TensorNetwork":
        """Rebuild from :meth:`to_dict` output, placing the values on
        ``device`` (default: the card) as ``dtype``."""
        tn = cls()
        device = resolve_device(device)
        for entry in data_dict["nodes"]:
            name = entry["id"]
            tn.network.add_node(name)
            if "tensor_dict" in entry:
                tn.set_node_tensor(
                    name,
                    Tensor.from_dict(
                        entry["tensor_dict"], device=device, dtype=dtype
                    ),
                )
        for link in data_dict.get("links", []):
            tn.add_edge(link["source"], link["target"])
        return tn

    def to_separated_dict(self) -> Tuple[dict, Dict[Any, np.ndarray]]:
        """Split into JSON-safe metadata plus a dict of raw arrays; the
        same format as the JAX package's ``to_separated_dict``."""
        metadata = self.to_dict()
        arrays: Dict[Any, np.ndarray] = {}
        metadata["numpy_arrays_info"] = {}
        for entry in metadata["nodes"]:
            tensor_dict = entry.pop("tensor_dict", None)
            if tensor_dict is None:
                continue
            node_id = entry["id"]
            arr = np.ascontiguousarray(tensor_dict["value"])
            arrays[node_id] = arr
            metadata["numpy_arrays_info"][node_id] = {
                "shape": [int(d) for d in arr.shape],
                "dtype": arr.dtype.name,
            }
            entry["tensor_indices"] = tensor_dict["indices"]
        return metadata, arrays

    @classmethod
    def from_separated_dict(
        cls,
        metadata: dict,
        arrays: Dict[Any, np.ndarray],
        device=None,
        dtype=None,
    ) -> "TensorNetwork":
        """Rebuild a network from :meth:`to_separated_dict` output of
        either package, placing the values on ``device`` (default: the
        card) as ``dtype`` (default: the arrays' own dtype).  ``metadata`` is not modified."""
        metadata = copy.deepcopy(metadata)
        for entry in metadata["nodes"]:
            node_id = entry["id"]
            if node_id in arrays:
                entry["tensor_dict"] = {
                    "value": arrays[node_id],
                    "indices": entry.pop("tensor_indices"),
                }
        return cls.from_dict(metadata, device=device, dtype=dtype)
