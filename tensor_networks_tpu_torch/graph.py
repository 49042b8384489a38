"""A minimal undirected graph with node payloads.

The tensor-network graph is pure host-side metadata (O(number of cores)),
so we keep it as a tiny adjacency-set structure instead of pulling in a
general graph library.  Only the operations the framework actually needs
are provided: neighbors, union, connected components, reachability, and an
AHU-style canonical tree hash used both for structure-search deduplication
and for tree-isomorphism checks.

Fills the role networkx plays in the reference (``pytens/algs.py:363-444``).
Taken over unchanged from ``tensor_networks_tpu/graph.py``.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Hashable, Iterable, Iterator, List, Set, Tuple


class Graph:
    """Undirected graph: node -> attrs dict, plus adjacency sets."""

    def __init__(self) -> None:
        self._nodes: Dict[Hashable, Dict[str, Any]] = {}
        self._adj: Dict[Hashable, Set[Hashable]] = {}

    # -- construction --------------------------------------------------------

    def add_node(self, name: Hashable, **attrs: Any) -> None:
        if name not in self._nodes:
            self._nodes[name] = {}
            self._adj[name] = set()
        self._nodes[name].update(attrs)

    def add_edge(self, u: Hashable, v: Hashable) -> None:
        if u not in self._nodes:
            self.add_node(u)
        if v not in self._nodes:
            self.add_node(v)
        if u != v:
            self._adj[u].add(v)
            self._adj[v].add(u)

    def remove_node(self, name: Hashable) -> None:
        for nbr in self._adj.pop(name, set()):
            self._adj[nbr].discard(name)
        self._nodes.pop(name, None)

    def remove_edge(self, u: Hashable, v: Hashable) -> None:
        self._adj[u].discard(v)
        self._adj[v].discard(u)

    # -- queries -------------------------------------------------------------

    @property
    def nodes(self) -> "NodeView":
        return NodeView(self)

    def has_node(self, name: Hashable) -> bool:
        return name in self._nodes

    def has_edge(self, u: Hashable, v: Hashable) -> bool:
        return u in self._adj and v in self._adj[u]

    def neighbors(self, name: Hashable) -> List[Hashable]:
        # insertion-stable order: sort within the adjacency set is not
        # meaningful across mixed name types, so keep set order stable by
        # tracking node insertion order.
        order = {n: i for i, n in enumerate(self._nodes)}
        return sorted(self._adj[name], key=lambda n: order[n])

    def edges(self) -> List[Tuple[Hashable, Hashable]]:
        seen = set()
        out = []
        for u in self._nodes:
            for v in self._adj[u]:
                key = frozenset((u, v))
                if key not in seen:
                    seen.add(key)
                    out.append((u, v))
        return out

    def number_of_nodes(self) -> int:
        return len(self._nodes)

    def __iter__(self) -> Iterator[Hashable]:
        return iter(self._nodes)

    def __contains__(self, name: Hashable) -> bool:
        return name in self._nodes

    def get_attrs(self, name: Hashable) -> Dict[str, Any]:
        return self._nodes[name]

    # -- algorithms ----------------------------------------------------------

    def union(self, other: "Graph", rename: Tuple[str, str]) -> "Graph":
        """Disjoint union with node names prefixed by ``rename``."""
        out = Graph()
        for graph, prefix in ((self, rename[0]), (other, rename[1])):
            mapping = {n: f"{prefix}{n}" for n in graph._nodes}
            for n, attrs in graph._nodes.items():
                out.add_node(mapping[n], **copy.deepcopy(attrs))
            for u, v in graph.edges():
                out.add_edge(mapping[u], mapping[v])
        return out

    def reachable_from(
        self, start: Hashable, blocked: Iterable[Hashable] = ()
    ) -> Set[Hashable]:
        """All nodes reachable from ``start`` without entering ``blocked``."""
        blocked = set(blocked)
        seen = {start}
        stack = [start]
        while stack:
            cur = stack.pop()
            for nbr in self._adj[cur]:
                if nbr not in seen and nbr not in blocked:
                    seen.add(nbr)
                    stack.append(nbr)
        return seen

    def connected_components(self) -> List[Set[Hashable]]:
        seen: Set[Hashable] = set()
        comps = []
        for n in self._nodes:
            if n not in seen:
                comp = self.reachable_from(n)
                seen |= comp
                comps.append(comp)
        return comps

    def subgraph(self, keep: Iterable[Hashable]) -> "Graph":
        keep = set(keep)
        out = Graph()
        for n in self._nodes:
            if n in keep:
                out.add_node(n, **self._nodes[n])
        for u, v in self.edges():
            if u in keep and v in keep:
                out.add_edge(u, v)
        return out

    def tree_hash(self) -> int:
        """Canonical AHU hash of the graph viewed as an unlabeled tree.

        Two trees get equal hashes iff they are isomorphic (up to hash
        collisions).  Non-tree graphs fall back to a degree-multiset hash.
        """
        if not self._nodes:
            return hash(())
        n_edges = len(self.edges())
        if n_edges != len(self._nodes) - 1:
            degs = tuple(sorted(len(self._adj[n]) for n in self._nodes))
            return hash(("nontree", degs, n_edges))

        # root at the tree centroid(s) for a canonical form
        def encode(node: Hashable, parent: Hashable) -> Tuple:
            return tuple(
                sorted(
                    encode(c, node)
                    for c in self._adj[node]
                    if c != parent
                )
            )

        centers = self._tree_centers()
        return hash(tuple(sorted(hash(encode(c, None)) for c in centers)))

    def is_isomorphic_tree(self, other: "Graph") -> bool:
        """Tree-isomorphism check via canonical hashing."""
        return self.tree_hash() == other.tree_hash()

    def _tree_centers(self) -> List[Hashable]:
        """The 1 or 2 center nodes of a tree (iterative leaf stripping)."""
        if len(self._nodes) <= 2:
            return list(self._nodes)
        deg = {n: len(self._adj[n]) for n in self._nodes}
        leaves = [n for n, d in deg.items() if d <= 1]
        remaining = len(self._nodes)
        while remaining > 2:
            remaining -= len(leaves)
            nxt = []
            for leaf in leaves:
                for nbr in self._adj[leaf]:
                    deg[nbr] -= 1
                    if deg[nbr] == 1:
                        nxt.append(nbr)
                deg[leaf] = 0
            leaves = nxt
        return [n for n, d in deg.items() if d >= 1] or list(self._nodes)[:1]


class NodeView:
    """networkx-flavored view: iterable, indexable, supports data=True."""

    def __init__(self, graph: Graph):
        self._graph = graph

    def __iter__(self) -> Iterator[Hashable]:
        return iter(self._graph._nodes)

    def __contains__(self, name: Hashable) -> bool:
        return name in self._graph._nodes

    def __len__(self) -> int:
        return len(self._graph._nodes)

    def __getitem__(self, name: Hashable) -> Dict[str, Any]:
        return self._graph._nodes[name]

    def __call__(self, data: bool = False):
        if data:
            return [(n, attrs) for n, attrs in self._graph._nodes.items()]
        return list(self._graph._nodes)
