"""Rooted dimension trees: the host-side control structure for cross
approximation and tree-aligned binary ops.

A dimension tree is a rooted view of a tree tensor network.  Every node
records which free indices live below it (``up_info`` — its own subtree
side) and above it (``down_info`` — the root side), together with the
sampled pivot rows and bond rank per direction.  The objects are pure
metadata — pivots are small integer arrays; all heavy numerics happen in
the cross engine's fiber evaluations.

All traversals are iterative (explicit stacks) so deep trees — e.g. QTT
trains with hundreds of dimensions — never hit the recursion limit.

API parity: the reference's tree machinery (``pytens/types.py:69-321``);
same class and method names, own implementation.  Taken over unchanged
from ``tensor_networks_tpu/dimtree.py`` (pure host code).
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from tensor_networks_tpu_torch.types import Index, NodeName


class NodeInfo:
    """Per-direction state of a tree node: neighbor links, visible free
    indices, sampled pivot rows, and the bond rank."""

    def __init__(
        self,
        nodes: List["DimTreeNode"],
        indices: List[Index],
        vals: np.ndarray,
    ):
        self.nodes = nodes
        self.indices = indices
        self.vals = vals
        self.rank = 0


class DimTreeNode:
    """One node of a rooted dimension tree.

    ``up_info`` faces the parent (its indices are this node's subtree);
    ``down_info`` faces the children (its indices are the complement).
    ``perm`` records the axis permutation between the tree's canonical
    core layout and the network node's actual one.
    """

    def __init__(
        self,
        node: NodeName,
        indices: List[Index],
        free_indices: List[Index],
        up_info: NodeInfo,
        down_info: NodeInfo,
    ):
        self.node = node
        self.indices = indices
        self.free_indices = free_indices
        self.up_info = up_info
        self.down_info = down_info
        axes = len(free_indices) + len(down_info.nodes) + len(up_info.nodes)
        self.perm = list(range(axes))

    def __lt__(self, other: "DimTreeNode") -> bool:
        return sorted(self.indices) < sorted(other.indices)

    # -- iterative traversal core ------------------------------------------

    def _walk(self) -> Iterator["DimTreeNode"]:
        """Pre-order iterator (children visited in stored order)."""
        stack: List[DimTreeNode] = [self]
        while stack:
            cur = stack.pop()
            yield cur
            stack.extend(reversed(cur.down_info.nodes))

    def _parent(self) -> Optional["DimTreeNode"]:
        links = self.up_info.nodes
        return links[0] if links else None

    def _ancestry(self) -> List["DimTreeNode"]:
        """This node and its ancestors, leaf-to-root order."""
        chain = [self]
        while chain[-1]._parent() is not None:
            chain.append(chain[-1]._parent())
        return chain

    def preorder(self) -> List["DimTreeNode"]:
        """All subtree nodes, parents before children."""
        return list(self._walk())

    def locate(self, node: NodeName) -> Optional["DimTreeNode"]:
        """The tree node wrapping the given network node, if present."""
        return next(
            (t for t in self._walk() if t.node == node), None
        )

    def leaves(self) -> List["DimTreeNode"]:
        """Nodes with no parent links above ``self``'s orientation.

        (Kept with the reference's orientation quirk: it follows the
        ``up`` links, so on the root it returns the root itself.)
        """
        if not self.up_info.nodes:
            return [self]
        return [
            leaf
            for parent in self.up_info.nodes
            for leaf in parent.leaves()
        ]

    def height(self) -> int:
        """Length of the longest up-chain from this node (>= 1)."""
        return 1 + max(
            (p.height() for p in self.up_info.nodes), default=0
        )

    def path(
        self, node1: NodeName, node2: NodeName
    ) -> List["DimTreeNode"]:
        """Tree nodes on the path between two network nodes, inclusive."""
        a = self.locate(node1)
        b = self.locate(node2)
        assert a is not None and b is not None

        up_a = a._ancestry()
        names_a = {t.node: i for i, t in enumerate(up_a)}
        up_b = []
        cur = b
        while cur.node not in names_a:
            up_b.append(cur)
            cur = cur._parent()
            if cur is None:
                raise RuntimeError("not a valid tree")
        meet = names_a[cur.node]
        return up_a[: meet + 1] + list(reversed(up_b))

    def distance(self, node1: NodeName, node2: NodeName) -> int:
        """Node count of the connecting path."""
        return len(self.path(node1, node2))

    def sibling(self, node: "DimTreeNode") -> "DimTreeNode":
        """A child of ``node``'s parent other than ``node`` itself."""
        parent = node._parent()
        if parent is None or len(node.up_info.nodes) != 1:
            raise ValueError("root node does not have a sibling")
        for child in parent.down_info.nodes:
            if child.node != node.node:
                return child
        raise ValueError("No sibling for the given node")

    def is_ancestor(self, other: "DimTreeNode") -> bool:
        """True iff ``self`` lies strictly above ``other``."""
        return any(
            t.node == self.node for t in other._ancestry()[1:]
        )

    def highest_frontier(
        self, indices: Sequence[Index]
    ) -> List["DimTreeNode"]:
        """Maximal subtrees whose index sets ``indices`` fully covers."""
        allowed = set(indices)
        out: List[DimTreeNode] = []
        stack = [self]
        while stack:
            cur = stack.pop()
            if cur.indices and set(cur.indices) <= allowed:
                out.append(cur)
            else:
                stack.extend(reversed(cur.down_info.nodes))
        return out

    # -- rank bookkeeping ------------------------------------------------------

    def increment_ranks(
        self, kickrank: int = 1, max_rank: Optional[int] = None
    ) -> None:
        """Raise every up-rank by ``kickrank`` (clamped to ``max_rank``)."""
        for tree in self._walk():
            tree.up_info.rank += kickrank
            if max_rank is not None:
                tree.up_info.rank = min(tree.up_info.rank, max_rank)

    def ranks(self) -> List[int]:
        """Up-ranks in pre-order."""
        return [tree.up_info.rank for tree in self._walk()]

    @staticmethod
    def _capacity(frees: List[Index], ranks: Iterator[int]) -> int:
        cap = 1
        for r in ranks:
            if r:
                cap *= r
        for ind in frees:
            cap *= ind.size
        return cap

    def bound_ranks(self) -> None:
        """Clamp each up-rank by the representational capacity of either
        side of its edge (iterated to fixpoint by the caller)."""
        for tree in self._walk():
            below = DimTreeNode._capacity(
                tree.free_indices,
                (c.up_info.rank for c in tree.down_info.nodes),
            )
            parent = tree._parent()
            if parent is None:
                above = tree.up_info.rank
            else:
                sides = [parent.up_info.rank] + [
                    s.up_info.rank
                    for s in parent.down_info.nodes
                    if s.node != tree.node
                ]
                above = DimTreeNode._capacity(
                    parent.free_indices, iter(sides)
                )
            tree.up_info.rank = min(below, above, tree.up_info.rank)

    def add_values(self, up_vals: np.ndarray) -> None:
        """Distribute fresh pivot rows down the tree, each node keeping
        its first ``rank`` rows."""
        stack: List[Tuple[DimTreeNode, np.ndarray]] = [(self, up_vals)]
        while stack:
            tree, rows = stack.pop()
            for child in tree.down_info.nodes:
                cols = [tree.indices.index(i) for i in child.indices]
                picked = rows[:, cols]
                child.up_info.vals = np.append(
                    child.up_info.vals, picked, axis=0
                )[: child.up_info.rank]
                stack.append((child, picked))

    # -- pivot extraction ----------------------------------------------------

    def entries(self) -> np.ndarray:
        """This node's up-direction pivot rows."""
        if len(self.up_info.vals):
            return self.up_info.vals
        return np.empty((0, len(self.up_info.indices)))

    def known_entries(self) -> np.ndarray:
        """Every full pivot row known in this subtree, columns ordered by
        ``self.indices``'s (down + up) layout."""
        order = self.down_info.indices + self.up_info.indices
        chunks = []
        if len(self.up_info.vals):
            chunks.append(
                np.concatenate(
                    [self.down_info.vals, self.up_info.vals], axis=-1
                )
            )
        for child in self.down_info.nodes:
            rows = child.known_entries()
            child_order = (
                child.down_info.indices + child.up_info.indices
            )
            take = [order.index(i) for i in child_order]
            chunks.append(rows[:, take])
        if not chunks:
            return np.empty((0, len(self.indices)))
        return np.concatenate(
            [np.empty((0, len(order)))] + chunks, axis=0
        )
