"""NUMA interconnect topologies — the host-side face of
:mod:`repro_torch.core.graphtop` (the port's copy of
``repro.core.numa.topology``; plain numpy, no tensors).

The machinery (hashable link graphs, BFS widest-shortest-path routing
with deterministic tie-breaks, pair→link incidence matrices, the
:class:`LinkGroups` calibration packing, and the generic builders) lives
in :mod:`repro_torch.core.graphtop.graph`; this module gives it its NUMA
names, as the reference's does:

* :class:`Topology` is a field-free subclass of
  :class:`~repro_torch.core.graphtop.LinkGraph`.  ``namedtuple`` reprs, ``_make``
  and ``_replace`` all go through ``self.__class__``, so a ``Topology``
  prints as ``Topology(...)`` exactly as the reference's — which keeps
  :meth:`~repro_torch.core.numa.machine.MachineSpec.fingerprint` digests
  (they hash ``repr(topology)``) equal to the reference's.
* The builders below rewrap the shared implementations under the
  reference's names (``fc{n}``, ``ring{n}``, ``mesh{rows}x{cols}``,
  ``glued8s``, ``snc{s}x{n}``), link enumeration order, and routing
  tables.
* ``LinkGroups`` / ``link_groups`` / ``from_fit`` / ``from_bandwidth_matrix``
  re-export the shared code (``from_fit`` preserves the template's class,
  so fitting a ``Topology`` yields a ``Topology``).

A topology's nodes are NUMA *nodes*, not sockets: a sub-NUMA-clustered
(SNC / Cluster-on-Die) part contributes ``nodes_per_socket`` nodes per
socket, joined by intra-socket links (:func:`snc`), and the
:class:`~repro_torch.core.numa.machine.MachineSpec` embedding the topology
requires ``n_nodes == sockets * nodes_per_socket``.
"""

from __future__ import annotations

from repro_torch.core.graphtop import graph as _graph
from repro_torch.core.graphtop.graph import (  # noqa: F401  (re-exported API)
    LinkGraph,
    LinkGroups,
    from_fit,
    link_groups,
)


class Topology(LinkGraph):
    """An interconnect graph over ``n_nodes`` NUMA nodes with static
    routes — a :class:`~repro_torch.core.graphtop.LinkGraph` under its
    historical NUMA name (no new fields, no new behaviour; the class
    identity matters because machine fingerprints digest ``repr``)."""

    __slots__ = ()


def _rewrap(g: LinkGraph, *, name: str | None = None) -> Topology:
    topo = Topology(
        name=g.name if name is None else name,
        n_nodes=g.n_nodes,
        link_ends=g.link_ends,
        link_bw=g.link_bw,
        routes=g.routes,
    )
    return topo


def from_bandwidth_matrix(name: str, bw) -> Topology:
    """Build a topology from a symmetric ``(n, n)`` link-bandwidth matrix
    (0 = no link) — the natural form for measured machines."""
    return _rewrap(_graph.from_bandwidth_matrix(name, bw))


def fully_connected(n: int, link_bw) -> Topology:
    """Every socket pair directly linked (the 2-socket machines and fully
    QPI-meshed quad Haswell-EX).  Links enumerate in upper-triangle order,
    matching the scalar-pair model's resource layout exactly."""
    return _rewrap(_graph.fully_connected(n, link_bw))


def ring(n: int, link_bw) -> Topology:
    """Sockets on a bidirectional ring — the worst-case hop spread
    (diameter ``n // 2``)."""
    return _rewrap(_graph.ring(n, link_bw))


def mesh2d(rows: int, cols: int, link_bw) -> Topology:
    """Sockets on a ``rows x cols`` grid with nearest-neighbour links
    (SGI/HPE hypercube-ish blades flattened to 2D)."""
    return _rewrap(_graph.mesh2d(rows, cols, link_bw))


def glued_8s(qpi_bw: float, nc_bw: float) -> Topology:
    """The glued 8-socket node-controller topology (Haswell-EX E7-8800
    class): two fully QPI-meshed quads; socket ``i`` of quad 0 reaches its
    twin ``i + 4`` over a node-controller link.  Cross-quad non-twin pairs
    route over 2 hops (one QPI + one controller link), so far traffic
    charges both — the hop-count bandwidth cliff the scalar model could
    not express.  Exactly :func:`repro_torch.core.graphtop.glued` with two
    islands of four, under the historical ``glued8s`` name."""
    return _rewrap(_graph.glued(2, 4, qpi_bw, nc_bw), name="glued8s")


def snc(
    sockets: int, nodes_per_socket: int, *, qpi_bw: float, intra_bw: float
) -> Topology:
    """Sub-NUMA clustering (SNC / Cluster-on-Die): each socket splits into
    ``nodes_per_socket`` NUMA nodes joined by fast intra-socket (in-die
    mesh) links, while each socket's FIRST node is its interconnect
    endpoint and the endpoints are fully QPI-meshed.  Cross-socket traffic
    from a non-endpoint node routes through its socket's endpoint, so both
    of a socket's nodes *share* the one QPI port — the SNC reality a
    per-socket machine model cannot express.  With ``nodes_per_socket=1``
    this degenerates to :func:`fully_connected`."""
    return _rewrap(_graph.snc(sockets, nodes_per_socket, qpi_bw=qpi_bw, intra_bw=intra_bw))
