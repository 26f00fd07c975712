"""Domain-neutral routed-graph topology engine (the port's numpy copy of
``repro.core.graphtop``): hashable link graphs with per-link capacities
and statically computed widest-shortest-path routes, pair→link incidence
matrices and the :class:`LinkGroups` symmetry packing."""

from repro_torch.core.graphtop.graph import (
    LinkGraph,
    LinkGroups,
    all_shortest_routes,
    all_widest_routes,
    from_bandwidth_matrix,
    from_fit,
    fully_connected,
    glued,
    link_groups,
    mesh2d,
    ring,
    snc,
    torus2d,
    torus3d,
    tree,
)

__all__ = [
    "LinkGraph",
    "LinkGroups",
    "all_shortest_routes",
    "all_widest_routes",
    "from_bandwidth_matrix",
    "from_fit",
    "fully_connected",
    "glued",
    "link_groups",
    "mesh2d",
    "ring",
    "snc",
    "torus2d",
    "torus3d",
    "tree",
]
