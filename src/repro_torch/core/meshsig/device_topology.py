"""Routed device meshes: accelerator interconnects as link graphs (port of
``repro.core.meshsig.device_topology``; numpy over the port's own
:mod:`repro_torch.core.graphtop`, so routes and incidence tables are the
reference's).

The scalar advisor divides per-axis collective bytes by one link rate,
which is right only when every axis ring runs over dedicated, uniform
links.  A 2D/3D ICI torus has per-dimension links, an NVLink island is
fully switched, and a multi-host system glues fast islands with a much
thinner host interconnect.  A :class:`DeviceTopology` embeds the mesh
into a :class:`~repro_torch.core.graphtop.LinkGraph` so collective bytes
are charged per *physical link* along static routes:

* devices map to graph nodes row-major over the candidate's axis order
  (``{"data": 2, "model": 8}`` lays the model axis contiguous; swapping
  the key order transposes the embedding), which is how two candidates
  with identical axis sizes can differ: one keeps its heavy axis inside
  an island, the other strides it across the glue links;
* each axis's collective runs as a ring over its device groups: every
  member sends the signature's per-device axis link bytes to its ring
  successor, charged along the widest-shortest route;
* links are full-duplex: each direction of an undirected link gets the
  full ``link_bw`` via the directed incidence matrix, and the axis time
  is the most-loaded directed link's ``bytes / bw``.

On a fully-connected uniform-bandwidth graph every ring step is a
dedicated one-hop link, so the axis time collapses to
``axis_bytes / link_bw``, the scalar model exactly.  With
``multipath=True`` the charge splits over all equal-hop
equal-bottleneck routes
(:meth:`~repro_torch.core.graphtop.LinkGraph.directed_route_incidence`).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np

from repro_torch.core.graphtop import (
    LinkGraph,
    fully_connected,
    glued,
    torus2d,
    torus3d,
)


class DeviceTopology(NamedTuple):
    """A device interconnect: a routed link graph plus charging policy.

    Hashable (the graph is nested tuples), so a ``DeviceTopology`` can key
    caches like a NUMA :class:`~repro_torch.core.numa.topology.Topology`
    does."""

    graph: LinkGraph
    multipath: bool = False

    @property
    def n_devices(self) -> int:
        return self.graph.n_nodes

    @property
    def name(self) -> str:
        return self.graph.name

    def device_groups(self, axis_sizes: dict[str, int]) -> dict[str, list[list[int]]]:
        """Per-axis communication groups under the row-major embedding of
        ``axis_sizes`` (dict order = major-to-minor).  Group member order
        is the ring order of that axis's collectives."""
        names = list(axis_sizes)
        dims = [int(axis_sizes[a]) for a in names]
        if math.prod(dims) != self.n_devices:
            raise ValueError(
                f"axis sizes {axis_sizes} need {math.prod(dims)} devices; "
                f"topology {self.name!r} has {self.n_devices}"
            )
        strides = [1] * len(dims)
        for k in range(len(dims) - 2, -1, -1):
            strides[k] = strides[k + 1] * dims[k + 1]
        out: dict[str, list[list[int]]] = {}
        for p, axis in enumerate(names):
            groups = []
            for base in range(self.n_devices):
                if (base // strides[p]) % dims[p] != 0:
                    continue  # not the group's first member
                groups.append([base + t * strides[p] for t in range(dims[p])])
            out[axis] = groups
        return out

    def axis_pair_bytes(
        self, axis_sizes: dict[str, int], axis: str, bytes_per_device: float
    ) -> np.ndarray:
        """``(n*n,)`` ordered-pair bytes for one axis's ring collective:
        every group member sends ``bytes_per_device`` (the signature's
        per-device axis link bytes, ring passes already folded in via
        ``class_factor``) to its ring successor."""
        n = self.n_devices
        pair = np.zeros((n * n,), np.float64)
        if bytes_per_device <= 0:
            return pair
        for group in self.device_groups(axis_sizes)[axis]:
            if len(group) < 2:
                continue
            for t, d in enumerate(group):
                succ = group[(t + 1) % len(group)]
                pair[d * n + succ] += bytes_per_device
        return pair

    def per_axis_times(
        self, axis_sizes: dict[str, int], per_axis_bytes: dict[str, float]
    ) -> dict[str, float]:
        """Per-axis collective time: route every ring transfer, charge each
        directed link, take the most-loaded link's ``bytes / bw``."""
        R = np.asarray(self.graph.directed_route_incidence(multipath=self.multipath))
        slot_bw = np.repeat(np.asarray(self.graph.link_bw, np.float64), 2)
        out: dict[str, float] = {}
        for axis in axis_sizes:
            pair = self.axis_pair_bytes(
                axis_sizes, axis, per_axis_bytes.get(axis, 0.0)
            )
            loads = pair @ R  # (2L,) directed link bytes
            out[axis] = float((loads / slot_bw).max()) if loads.any() else 0.0
        return out

    def collective_time(
        self, axis_sizes: dict[str, int], per_axis_bytes: dict[str, float]
    ) -> float:
        """Step-level collective bound: the max over axes (axes overlap no
        worse than the scalar model assumes)."""
        times = self.per_axis_times(axis_sizes, per_axis_bytes)
        return max(times.values(), default=0.0)

    def link_loads(
        self, axis_sizes: dict[str, int], per_axis_bytes: dict[str, float]
    ) -> np.ndarray:
        """``(2 * n_links,)`` total directed-link bytes across all axes —
        the observable the ICI calibration fits against."""
        R = np.asarray(self.graph.directed_route_incidence(multipath=self.multipath))
        total = np.zeros((R.shape[1],), np.float64)
        for axis in axis_sizes:
            pair = self.axis_pair_bytes(
                axis_sizes, axis, per_axis_bytes.get(axis, 0.0)
            )
            total += pair @ R
        return total


# ---------------------------------------------------------------------------
# The fabrics the advisor ranks over
# ---------------------------------------------------------------------------

ICI_LINK_BW = 50e9  # v5e-class per-link ICI, bytes/s (ChipSpec.ici_bw default)
NVLINK_BW = 450e9  # switched island per-pair effective bytes/s
HOST_LINK_BW = 25e9  # inter-host (DCN/IB-class) per-link bytes/s


def ici_torus2d(rows: int, cols: int, link_bw=ICI_LINK_BW, *, multipath: bool = False) -> DeviceTopology:
    """A ``rows x cols`` ICI torus (v5e-class slice)."""
    return DeviceTopology(graph=torus2d(rows, cols, link_bw), multipath=multipath)


def ici_torus3d(x: int, y: int, z: int, link_bw=ICI_LINK_BW, *, multipath: bool = False) -> DeviceTopology:
    """An ``x * y * z`` ICI torus (v4/v5p-class cube)."""
    return DeviceTopology(graph=torus3d(x, y, z, link_bw), multipath=multipath)


def nvlink_island(n: int, link_bw=NVLINK_BW, *, multipath: bool = False) -> DeviceTopology:
    """A fully-switched island: every device pair one hop (NVLink/NVSwitch
    style) — the regime where the routed model equals the scalar one."""
    return DeviceTopology(graph=fully_connected(n, link_bw), multipath=multipath)


def ring_of_islands(
    n_islands: int,
    island_size: int,
    island_bw=NVLINK_BW,
    host_bw=HOST_LINK_BW,
    *,
    multipath: bool = False,
) -> DeviceTopology:
    """Multi-host: fully-switched islands of ``island_size`` devices, host
    ``a``'s device ``i`` linked to host ``a + 1``'s device ``i`` (and wrap
    for > 2 hosts) — the glued-socket shape of
    :func:`repro_torch.core.graphtop.glued` wearing its accelerator hat.  Heavy
    traffic striding across islands funnels into the thin host links,
    which is exactly what the scalar ``ICI_BW`` model cannot see."""
    return DeviceTopology(
        graph=glued(
            n_islands, island_size, island_bw, host_bw, ring_islands=True
        ),
        multipath=multipath,
    )
