"""Matplotlib drawing of tensor networks (host-only, optional).

Circles for tensor cores, squares for free legs, edge labels showing bond
dimensions.  Taken over from ``tensor_networks_tpu/viz.py``; matplotlib
is imported only when a network is drawn.  Parity reference:
``pytens/algs.py:1399-1485``.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple


def _tree_layout(graph) -> Dict[object, Tuple[float, float]]:
    """Simple radial/spring-free layout: BFS levels on concentric arcs."""
    nodes = list(graph.nodes)
    if not nodes:
        return {}
    root = nodes[0]
    levels = {root: 0}
    order = [root]
    queue = [root]
    while queue:
        cur = queue.pop(0)
        for nbr in graph.neighbors(cur):
            if nbr not in levels:
                levels[nbr] = levels[cur] + 1
                order.append(nbr)
                queue.append(nbr)
    # any disconnected leftovers
    for n in nodes:
        if n not in levels:
            levels[n] = 0
            order.append(n)

    by_level: Dict[int, list] = {}
    for n in order:
        by_level.setdefault(levels[n], []).append(n)

    pos = {}
    for lvl, members in by_level.items():
        radius = 1.0 + lvl
        for i, n in enumerate(members):
            theta = 2 * math.pi * (i + 0.5) / len(members) + 0.3 * lvl
            pos[n] = (radius * math.cos(theta), radius * math.sin(theta))
    if len(by_level.get(0, [])) == 1:
        pos[root] = (0.0, 0.0)
    return pos


def draw_network(net, ax=None):
    """Draw ``net`` (a TensorNetwork) on the given matplotlib axes."""
    import matplotlib.pyplot as plt

    if ax is None:
        ax = plt.gca()

    free_indices = sorted(net.free_indices())

    g = net.network
    pos = _tree_layout(g)

    # free-leg positions: offset from their owning core
    leg_pos = {}
    leg_edges = []
    for index in free_indices:
        if index.size == 1:
            continue
        label = f"{index.name}-{index.size}"
        for node, data in g.nodes(data=True):
            if index in data["tensor"].indices:
                x, y = pos[node]
                norm = math.hypot(x, y) or 1.0
                leg_pos[label] = (x + 0.6 * x / norm + 0.2, y + 0.6 * y / norm)
                leg_edges.append((node, label))
                break

    for u, v in g.edges():
        (x1, y1), (x2, y2) = pos[u], pos[v]
        ax.plot([x1, x2], [y1, y2], "k-", lw=1, zorder=1)
        labels = [str(i.size) for i in net.get_contraction_index(u, v)]
        ax.text(
            (x1 + x2) / 2,
            (y1 + y2) / 2,
            "-".join(labels),
            fontsize=10,
            ha="center",
            zorder=3,
        )

    for node, label in leg_edges:
        (x1, y1), (x2, y2) = pos[node], leg_pos[label]
        ax.plot([x1, x2], [y1, y2], "k--", lw=0.8, zorder=1)

    for node in g.nodes:
        x, y = pos[node]
        ax.scatter([x], [y], s=300, c="lightblue", marker="o", zorder=2)
        ax.annotate(
            str(node), (x, y), fontsize=12, ha="center", va="center", zorder=4
        )
    for label, (x, y) in leg_pos.items():
        ax.scatter([x], [y], s=100, c="orange", marker="s", zorder=2)
        ax.annotate(
            label, (x, y), fontsize=10, ha="center", va="bottom", zorder=4
        )
    ax.set_axis_off()
    return ax
