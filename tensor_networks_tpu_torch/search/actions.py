"""The structure-search action vocabulary.

Actions are small mutable records; ``ISplit`` names tensor axis positions
on one node, ``OSplit`` names a set of free indices that is resolved to a
positional split at the unique node from which those indices can be
separated, and ``Merge`` contracts an edge.  Resolution works on *edge
free-index sets*: one post-order pass labels every tree edge with the
free indices living behind it, after which LCA candidacy is a local
purity check per node — no recursive walk per candidate.

Cite for behavior parity: ``pytens/search/state.py`` defines the same
three-action vocabulary; ordering, equality, and validity semantics are
pinned by the count-exact search tests.

Counterpart of ``tensor_networks_tpu/search/actions.py``.  Precomputed
factors are installed on the device of the node they replace; nothing
is copied to the host and back.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from tensor_networks_tpu_torch.network import TensorNetwork
from tensor_networks_tpu_torch.types import Index, NodeName, SVDConfig


class Action:
    """Common ordering/identity behavior: actions compare by repr."""

    def __str__(self) -> str:  # pragma: no cover - subclasses override
        raise NotImplementedError

    def __lt__(self, other: "Action") -> bool:
        return str(self) < str(other)

    def __hash__(self) -> int:
        return hash(str(self))

    def is_valid(self, _history: Sequence["Action"]) -> bool:
        """Whether this action is allowed after ``_history``."""
        return True


class ISplit(Action):
    """Split one node by tensor axis positions.

    ``target_size`` and ``delta`` are annotations the synthesizer writes
    back after rank solving; they do not participate in identity.
    """

    def __init__(
        self,
        node: NodeName,
        left_indices: Sequence[int],
        target_size: Optional[int] = None,
        delta: Optional[float] = None,
    ):
        self.node = node
        self.left_indices = sorted(left_indices)
        self.target_size = target_size
        self.delta = delta

    def __str__(self) -> str:
        return f"ISplit({self.node}, {self.left_indices})"

    def __eq__(self, other: object) -> bool:
        return isinstance(other, ISplit) and (
            self.node,
            self.left_indices,
        ) == (other.node, other.left_indices)

    def __hash__(self) -> int:
        return hash(str(self))

    def execute(self, net: TensorNetwork, svd=None):
        """Split the node in-place; returns ((u, s, v) names, rank cap).

        With ``svd`` given (a precomputed (U, s, V): device tensors from
        the batched scorer, which may add the host copy of s as a fourth
        entry, or NumPy arrays from the preprocessing spill), the split is
        symbolic graph surgery and the factors are installed directly on
        the device of the node they replace.
        """
        axes = self.left_indices
        node_indices = net.node_tensor(self.node).indices
        rest = [k for k in range(len(node_indices)) if k not in axes]
        dim_l = int(np.prod([node_indices[k].size for k in axes]))
        dim_r = int(np.prod([node_indices[k].size for k in rest]))

        if svd is None:
            names, _ = net.svd(
                self.node, axes, SVDConfig(with_orthonormal=True)
            )
        else:
            names, _ = net.svd(
                self.node, axes, SVDConfig(compute_data=False)
            )
            u_mat, s_vec, v_mat = svd[:3]
            lshape = [node_indices[k].size for k in axes]
            rshape = [node_indices[k].size for k in rest]
            s_mat = (
                torch.diag(s_vec)
                if isinstance(s_vec, torch.Tensor)
                else np.diag(s_vec)
            )
            # update_val_size places a NumPy factor on the device of the
            # empty value it replaces
            net.node_tensor(names[0]).update_val_size(
                u_mat.reshape(*lshape, -1)
            )
            net.node_tensor(names[1]).update_val_size(s_mat)
            net.node_tensor(names[2]).update_val_size(
                v_mat.reshape(-1, *rshape)
            )
        return names, min(dim_l, dim_r)


class OSplit(Action):
    """Separate a set of free (output) indices from the rest."""

    def __init__(
        self,
        indices: Sequence[Index],
        target_size: Optional[int] = None,
        delta: Optional[float] = None,
    ):
        self.indices = sorted(indices)
        self.target_size = target_size
        self.delta = delta

    def __str__(self) -> str:
        return f"OSplit({[i.name for i in self.indices]})"

    def __eq__(self, other: object) -> bool:
        return isinstance(other, OSplit) and [
            i.name for i in self.indices
        ] == [i.name for i in other.indices]

    def __hash__(self) -> int:
        return hash(str(self))

    def __lt__(self, other: "OSplit") -> bool:
        # fewer indices first, then lexicographic
        if len(self.indices) != len(other.indices):
            return len(self.indices) < len(other.indices)
        return sorted(self.indices) < sorted(other.indices)

    def is_valid(self, history: Sequence[Action]) -> bool:
        """Reject exact repeats and any overlap with an earlier grouped
        (multi-index) OSplit."""
        if self in history:
            return False
        mine = set(self.indices)
        return not any(
            isinstance(past, OSplit)
            and len(past.indices) > 1
            and mine & set(past.indices)
            for past in history
        )

    def to_isplit(self, net: TensorNetwork) -> ISplit:
        """Lower to a positional split at the separating node."""
        node, gateways = _separating_node(net, set(self.indices), self.indices)
        node_indices = net.node_tensor(node).indices
        return ISplit(node, [node_indices.index(g) for g in gateways])

    def execute(self, net: TensorNetwork, svd=None):
        """Resolve to the positional form and execute that."""
        return self.to_isplit(net).execute(net, svd)


class Merge(Action):
    """Contract two adjacent nodes into one."""

    def __init__(self, node1: NodeName, node2: NodeName):
        self.node1 = node1
        self.node2 = node2

    def __str__(self) -> str:
        return f"Merge({self.node1}, {self.node2})"

    def execute(self, net: TensorNetwork) -> TensorNetwork:
        net.merge(self.node1, self.node2)
        return net


# -- OSplit -> node resolution ------------------------------------------------


def _edge_free_sets(
    net: TensorNetwork,
) -> Dict[Tuple[NodeName, NodeName], Set[Index]]:
    """For every directed tree edge (child -> parent), the set of free
    indices in the subtree hanging below the child.

    One iterative post-order pass from an arbitrary root; the opposite
    direction is the complement against all free indices.
    """
    free_all = set(net.free_indices())
    nodes = list(net.network.nodes)
    behind: Dict[Tuple[NodeName, NodeName], Set[Index]] = {}
    if not nodes:
        return behind

    root = nodes[0]
    parent: Dict[NodeName, Optional[NodeName]] = {root: None}
    order: List[NodeName] = []
    stack = [root]
    while stack:
        cur = stack.pop()
        order.append(cur)
        for nbr in net.network.neighbors(cur):
            if nbr not in parent:
                parent[nbr] = cur
                stack.append(nbr)

    for cur in reversed(order):
        par = parent[cur]
        if par is None:
            continue
        owned = {
            i for i in net.node_tensor(cur).indices if i in free_all
        }
        for nbr in net.network.neighbors(cur):
            if nbr != par:
                owned |= behind[(nbr, cur)]
        behind[(cur, par)] = owned
        behind[(par, cur)] = free_all - owned
    return behind


def _separating_node(
    net: TensorNetwork,
    desired: Set[Index],
    ordered_desired: Sequence[Index],
) -> Tuple[NodeName, List[Index]]:
    """Find the node at which ``desired`` can be split off, plus the
    ordered gateway indices (bond or own free index) that carry each
    desired index into that node."""
    behind = _edge_free_sets(net)
    free_all = set(net.free_indices())

    for node in net.network.nodes:
        node_t = net.node_tensor(node)
        # each incident branch must be pure: all-desired or all-undesired
        carrier: Dict[Index, Index] = {}
        ok = True
        for nbr in net.network.neighbors(node):
            sub = behind[(nbr, node)]
            wanted = sub & desired
            if wanted and (sub - desired):
                ok = False
                break
            if wanted:
                gateway = net.get_contraction_index(nbr, node)[0]
                for w in wanted:
                    carrier[w] = gateway
        if not ok:
            continue
        for ind in node_t.indices:
            if ind in free_all and ind in desired:
                carrier[ind] = ind
        if set(carrier) != desired:
            continue
        gateways: List[Index] = []
        for want in ordered_desired:
            g = carrier[want]
            if g not in gateways:
                gateways.append(g)
        return node, gateways

    raise ValueError(f"Cannot find the lca for indices {sorted(desired)}")
