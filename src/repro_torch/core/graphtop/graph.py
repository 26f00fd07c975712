"""Routed link graphs: bandwidth-capacitated links + static routing.

PyTorch port's copy of ``repro.core.graphtop.graph`` (plain numpy, kept
nearly verbatim so routes, hop matrices and incidence tables are
identical; the port imports nothing from the JAX package).  The tables
stay float64 numpy here; every consumer that turns one into a tensor
casts it to float32 explicitly.

The engine behind every interconnect model in the repo.  The paper's
machines are dual-socket boxes where "the interconnect" is a single QPI
link, but large NUMA machines have strongly distance-dependent bandwidth
(STREAM-style measurements show per-hop cliffs — Bergstrom,
arXiv:1103.3225), glued 8-socket systems route far socket pairs through
node controllers, and accelerator meshes (ICI tori, NVLink islands,
multi-host rings) are graphs from the start.  A :class:`LinkGraph`
captures that structure:

* an undirected link list with per-link capacities (bytes/s), and
* a statically computed shortest-path routing table: for every ordered
  node pair, the sequence of links its traffic crosses.

Everything is stored as nested tuples of python scalars, so a
``LinkGraph`` (and any spec that embeds one, e.g.
:class:`~repro_torch.core.numa.machine.MachineSpec`) stays hashable — it can be
a signature-cache key even when the builder was handed numpy arrays for
the bandwidth matrix.  The derived *arrays* (link capacities, hop
matrix, pair→link routing incidence) are materialized lazily and cached
per graph, so consumers keep fixed ``(n, n_links)``-shaped slabs for
any node count.

Routing is hop-count shortest path (BFS) with bandwidth-aware tie-breaks:
among equal-hop routes the one with the largest bottleneck link bandwidth
wins (widest-shortest path), and remaining ties fall back to the
smallest-id predecessor in the previous BFS layer — with uniform link
bandwidths this reduces exactly to the old smallest-predecessor rule, so
routing tables stay reproducible across processes.

**Multipath** (:func:`all_widest_routes`): when several equal-hop routes
share the best bottleneck bandwidth, flow can be split evenly across all
of them instead of pinned to the deterministic tie-break winner.  The
incidence matrices take ``multipath=True`` to return the fractional
pair→link matrix (each route carries ``1/k`` of the pair's flow); the
default ``multipath=False`` reproduces the single-route tables
bit-for-bit, which is what the NUMA golden pins ride on.

What a graph's nodes *are* is the embedding domain's business: NUMA
nodes for hosts (:mod:`repro_torch.core.numa.topology`), devices for
accelerator meshes (the mesh-domain models, not yet ported).
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple, Sequence

import numpy as np


class LinkGraph(NamedTuple):
    """An interconnect graph over ``n_nodes`` nodes with static routes.

    ``link_ends[l] = (i, j)`` with ``i < j`` names the l-th undirected
    link; ``link_bw[l]`` is its capacity in bytes/s (both directions share
    it, like QPI — duplex consumers charge each direction against the full
    capacity via :meth:`directed_route_incidence`).
    ``routes[i * n_nodes + j]`` is the tuple of link indices the ordered
    pair ``i -> j`` crosses (empty for ``i == j``).
    """

    name: str
    n_nodes: int
    link_ends: tuple[tuple[int, int], ...]
    link_bw: tuple[float, ...]
    routes: tuple[tuple[int, ...], ...]

    @property
    def n_links(self) -> int:
        return len(self.link_ends)

    def route(self, i: int, j: int) -> tuple[int, ...]:
        """Link indices crossed by traffic from node ``i`` to ``j``."""
        return self.routes[i * self.n_nodes + j]

    @property
    def max_hops(self) -> int:
        return max((len(r) for r in self.routes), default=0)

    @property
    def is_fully_direct(self) -> bool:
        """True when every distinct pair is one hop (no routed traffic) —
        the regime where the link model degenerates to the scalar-pair
        model of the original 2-socket formulation."""
        return self.max_hops <= 1

    def hop_matrix(self) -> np.ndarray:
        """``(n, n)`` int hop counts (0 on the diagonal)."""
        return _hop_matrix(self)

    def route_incidence(
        self, *, multipath: bool = False, weighting: str = "equal"
    ) -> np.ndarray:
        """``(n*n, n_links)`` float32 matrix ``R`` with ``R[i*n+j, l] = 1``
        iff link ``l`` is on the route ``i -> j``.  Charging per-link usage
        is then one matmul: ``flows.reshape(-1, n*n) @ R``.  With
        ``multipath=True`` each pair's flow splits over its equal-hop
        routes, so entries become fractional; ``weighting`` picks the
        split:

        * ``"equal"`` (default) — ``1/k`` over the equal-hop
          *equal-bottleneck* (widest-tie) route set, bit-for-bit the
          historical table;
        * ``"bottleneck"`` — over ALL equal-hop shortest routes, each
          weighted by its bottleneck link bandwidth (a route through a
          thin link carries proportionally less of the pair's flow —
          ECMP with unequal-cost shares).  With all-equal route
          bottlenecks this coincides with ``"equal"`` over the same set.

        The default single-route table is unchanged bit-for-bit."""
        if multipath:
            if weighting == "equal":
                return _route_incidence_multipath(self)
            if weighting == "bottleneck":
                return _route_incidence_bottleneck(self)
            raise ValueError(
                f"unknown multipath weighting {weighting!r} "
                "(expected 'equal' or 'bottleneck')"
            )
        if weighting != "equal":
            raise ValueError("weighting requires multipath=True")
        return _route_incidence(self, multihop_only=False)

    def route_incidence_multihop(self) -> np.ndarray:
        """Like :meth:`route_incidence` but with single-hop rows zeroed —
        the *extra* charges routed topologies add on top of the direct
        endpoint-pair traffic every link always carries."""
        return _route_incidence(self, multihop_only=True)

    def directed_route_incidence(
        self, *, multipath: bool = False, weighting: str = "equal"
    ) -> np.ndarray:
        """``(n*n, 2 * n_links)`` float32 incidence over *directed* link
        slots: column ``2l`` is link ``l`` traversed in canonical
        (low-id -> high-id) direction, ``2l + 1`` the reverse.  Full-duplex
        fabrics (ICI, NVLink) charge each direction against the link's full
        capacity; half-duplex consumers can fold the two columns.  With
        ``multipath=True`` entries are the fractional multipath split
        (``weighting`` as in :meth:`route_incidence`: equal over widest
        ties, or bottleneck-bandwidth-proportional over all shortest
        routes)."""
        if weighting not in ("equal", "bottleneck"):
            raise ValueError(
                f"unknown multipath weighting {weighting!r} "
                "(expected 'equal' or 'bottleneck')"
            )
        if weighting == "bottleneck" and not multipath:
            raise ValueError("weighting requires multipath=True")
        return _directed_route_incidence(
            self, multipath=multipath, weighting=weighting
        )

    def all_routes(self, i: int, j: int) -> tuple[tuple[int, ...], ...]:
        """Every equal-hop route from ``i`` to ``j`` whose bottleneck
        bandwidth ties the widest-shortest optimum (deterministic order;
        the primary ``route(i, j)`` is always among them)."""
        return all_widest_routes(self)[i * self.n_nodes + j]

    def all_shortest_routes_of(self, i: int, j: int) -> tuple[tuple[int, ...], ...]:
        """Every equal-hop shortest route from ``i`` to ``j`` regardless
        of bottleneck bandwidth — the route set bottleneck-weighted
        multipath splits over (:meth:`route_incidence` with
        ``weighting="bottleneck"``)."""
        return all_shortest_routes(self)[i * self.n_nodes + j]

    def validate(self) -> None:
        n = self.n_nodes
        if len(self.routes) != n * n:
            raise ValueError(f"routes must have {n * n} entries")
        if len(self.link_bw) != len(self.link_ends):
            raise ValueError("link_bw and link_ends disagree on link count")
        if len(set(self.link_ends)) != len(self.link_ends):
            raise ValueError("duplicate links: endpoint pairs must be unique")
        for l, (i, j) in enumerate(self.link_ends):
            if not (0 <= i < j < n):
                raise ValueError(f"link {l} endpoints {(i, j)} invalid")
            if self.link_bw[l] <= 0:
                raise ValueError(f"link {l} has non-positive bandwidth")
        for i in range(n):
            for j in range(n):
                r = self.route(i, j)
                if i == j:
                    if r:
                        raise ValueError(f"self-route {i} must be empty")
                    continue
                if not r:
                    raise ValueError(f"nodes {i} and {j} are disconnected")
                at = i
                for l in r:
                    a, b = self.link_ends[l]
                    if at == a:
                        at = b
                    elif at == b:
                        at = a
                    else:
                        raise ValueError(f"route {i}->{j} breaks at link {l}")
                if at != j:
                    raise ValueError(f"route {i}->{j} ends at {at}")


@lru_cache(maxsize=128)
def _hop_matrix(graph: LinkGraph) -> np.ndarray:
    n = graph.n_nodes
    hops = np.zeros((n, n), np.int32)
    for i in range(n):
        for j in range(n):
            hops[i, j] = len(graph.route(i, j))
    hops.setflags(write=False)
    return hops


@lru_cache(maxsize=128)
def _route_incidence(graph: LinkGraph, *, multihop_only: bool) -> np.ndarray:
    n = graph.n_nodes
    R = np.zeros((n * n, graph.n_links), np.float32)
    for i in range(n):
        for j in range(n):
            r = graph.route(i, j)
            if multihop_only and len(r) <= 1:
                continue
            for l in r:
                R[i * n + j, l] = 1.0
    R.setflags(write=False)
    return R


@lru_cache(maxsize=128)
def _route_incidence_multipath(graph: LinkGraph) -> np.ndarray:
    n = graph.n_nodes
    R = np.zeros((n * n, graph.n_links), np.float32)
    routes = all_widest_routes(graph)
    for pair, alts in enumerate(routes):
        if not alts:
            continue
        w = 1.0 / len(alts)
        for r in alts:
            for l in r:
                R[pair, l] += w
    R.setflags(write=False)
    return R


def _route_shares(
    graph: LinkGraph, alts: tuple[tuple[int, ...], ...]
) -> list[float]:
    """Bottleneck-proportional flow shares over a route set: route ``r``
    carries ``bottleneck(r) / sum_r' bottleneck(r')`` of the pair's flow.
    Equal bottlenecks reduce to the even ``1/k`` split."""
    widths = [
        min((graph.link_bw[l] for l in r), default=float("inf")) for r in alts
    ]
    total = sum(widths)
    return [w / total for w in widths]


@lru_cache(maxsize=128)
def _route_incidence_bottleneck(graph: LinkGraph) -> np.ndarray:
    """Unequal ECMP: split each pair's flow over ALL its equal-hop
    shortest routes, weighted by route bottleneck bandwidth — a route
    whose narrowest link is 10x thinner carries 10x less flow, instead of
    being either excluded (widest-tie equal split) or charged evenly."""
    n = graph.n_nodes
    R = np.zeros((n * n, graph.n_links), np.float32)
    routes = all_shortest_routes(graph)
    for pair, alts in enumerate(routes):
        if not alts:
            continue
        for r, share in zip(alts, _route_shares(graph, alts)):
            for l in r:
                R[pair, l] += share
    R.setflags(write=False)
    return R


def _walk_directions(graph: LinkGraph, src: int, route: tuple[int, ...]):
    """Yield ``(link, direction)`` along ``route`` from ``src``: direction
    0 traverses the link low-id -> high-id, 1 the reverse."""
    at = src
    for l in route:
        a, b = graph.link_ends[l]
        if at == a:
            yield l, 0
            at = b
        else:
            yield l, 1
            at = a


@lru_cache(maxsize=128)
def _directed_route_incidence(
    graph: LinkGraph, *, multipath: bool, weighting: str = "equal"
) -> np.ndarray:
    n = graph.n_nodes
    R = np.zeros((n * n, 2 * graph.n_links), np.float32)
    for i in range(n):
        for j in range(n):
            if not multipath:
                alts = (graph.route(i, j),)
            elif weighting == "bottleneck":
                alts = graph.all_shortest_routes_of(i, j)
            else:
                alts = graph.all_routes(i, j)
            alts = tuple(r for r in alts if r)
            if not alts:
                continue
            if multipath and weighting == "bottleneck":
                shares = _route_shares(graph, alts)
            else:
                shares = [1.0 / len(alts)] * len(alts)
            for r, share in zip(alts, shares):
                for l, d in _walk_directions(graph, i, r):
                    R[i * n + j, 2 * l + d] += share
    R.setflags(write=False)
    return R


# ---------------------------------------------------------------------------
# Routing
# ---------------------------------------------------------------------------


def _shortest_routes(
    n: int,
    link_ends: Sequence[tuple[int, int]],
    link_bw: Sequence[float] | None = None,
) -> tuple[tuple[int, ...], ...]:
    """BFS hop-count routing for every ordered pair, with bandwidth-aware
    tie-breaking: among equal-hop shortest paths the route with the largest
    bottleneck link bandwidth wins (widest-shortest path).  Remaining ties
    break deterministically toward the smallest-id predecessor in the
    previous BFS layer, then the smallest link id — with uniform link
    bandwidths (or ``link_bw=None``) this is exactly the old
    smallest-predecessor rule, so routing tables are reproducible across
    processes and unchanged for unweighted topologies."""
    widths = (
        [float("inf")] * len(link_ends) if link_bw is None else [float(b) for b in link_bw]
    )
    adj: list[list[tuple[int, int]]] = [[] for _ in range(n)]  # node -> (nbr, link)
    for l, (i, j) in enumerate(link_ends):
        adj[i].append((j, l))
        adj[j].append((i, l))
    for nbrs in adj:
        nbrs.sort()

    routes: list[tuple[int, ...]] = []
    for src in range(n):
        dist = {src: 0}
        order: list[int] = []  # nodes in (layer, id) order — DP dependencies first
        frontier = [src]
        while frontier:
            nxt: list[int] = []
            for u in frontier:
                for v, _ in adj[u]:
                    if v not in dist:
                        dist[v] = dist[u] + 1
                        nxt.append(v)
            nxt = sorted(set(nxt))
            order.extend(nxt)
            frontier = nxt
        # Widest-path DP over the BFS layering: a node's route width is the
        # best min(predecessor width, entering link bandwidth) over the
        # previous layer, ties preferring (smallest pred id, smallest link).
        width = {src: float("inf")}
        prev: dict[int, tuple[int, int]] = {}  # node -> (prev node, link)
        for v in order:
            best: tuple[float, int, int] | None = None
            for u, l in adj[v]:
                if dist.get(u) == dist[v] - 1:
                    key = (-min(width[u], widths[l]), u, l)
                    if best is None or key < best:
                        best = key
            assert best is not None  # v was discovered from the previous layer
            width[v] = -best[0]
            prev[v] = (best[1], best[2])
        for dst in range(n):
            if dst == src:
                routes.append(())
                continue
            if dst not in dist:
                raise ValueError(f"node {dst} unreachable from {src}")
            path: list[int] = []
            at = dst
            while at != src:
                at, l = prev[at]
                path.append(l)
            routes.append(tuple(reversed(path)))
    return tuple(routes)


@lru_cache(maxsize=64)
def all_widest_routes(graph: LinkGraph) -> tuple[tuple[tuple[int, ...], ...], ...]:
    """For every ordered pair, ALL shortest (equal-hop) routes whose
    bottleneck bandwidth equals the widest-shortest optimum — the route set
    multipath flow splits over.  Routes enumerate in deterministic
    (predecessor-id, link-id) order, so the fractional incidence matrices
    are reproducible across processes; with no ties the set is exactly the
    singleton primary route.  Intended for the small graphs this repo
    models (the shortest-path DAG of a ``k``-dim torus has combinatorially
    many corner-to-corner routes; the fractional matrices are cached per
    graph)."""
    n = graph.n_nodes
    widths = [float(b) for b in graph.link_bw]
    adj: list[list[tuple[int, int]]] = [[] for _ in range(n)]
    for l, (i, j) in enumerate(graph.link_ends):
        adj[i].append((j, l))
        adj[j].append((i, l))
    for nbrs in adj:
        nbrs.sort()

    out: list[tuple[tuple[int, ...], ...]] = []
    for src in range(n):
        dist = {src: 0}
        order: list[int] = []
        frontier = [src]
        while frontier:
            nxt: list[int] = []
            for u in frontier:
                for v, _ in adj[u]:
                    if v not in dist:
                        dist[v] = dist[u] + 1
                        nxt.append(v)
            nxt = sorted(set(nxt))
            order.extend(nxt)
            frontier = nxt
        # best achievable bottleneck width per node (same DP as the router)
        width = {src: float("inf")}
        for v in order:
            width[v] = max(
                min(width[u], widths[l])
                for u, l in adj[v]
                if dist.get(u) == dist[v] - 1
            )
        # enumerate every shortest route achieving width[dst], memoized over
        # (node, required bottleneck): a route through predecessor u via
        # link l has bottleneck width[dst] iff min(prefix, widths[l]) can
        # still reach it.
        memo: dict[int, tuple[tuple[int, ...], ...]] = {src: ((),)}

        def routes_to(v: int) -> tuple[tuple[int, ...], ...]:
            got = memo.get(v)
            if got is not None:
                return got
            target = width[v]
            acc: list[tuple[int, ...]] = []
            for u, l in adj[v]:
                if dist.get(u) != dist[v] - 1:
                    continue
                if min(width[u], widths[l]) < target:
                    continue  # this arm cannot carry the optimal bottleneck
                for prefix in routes_to(u):
                    if min((widths[k] for k in prefix), default=float("inf")) >= target:
                        acc.append(prefix + (l,))
            memo[v] = tuple(acc)
            return memo[v]

        for dst in range(n):
            if dst == src:
                out.append(())
            elif dst not in dist:
                raise ValueError(f"node {dst} unreachable from {src}")
            else:
                out.append(routes_to(dst))
    return tuple(out)


@lru_cache(maxsize=64)
def all_shortest_routes(graph: LinkGraph) -> tuple[tuple[tuple[int, ...], ...], ...]:
    """For every ordered pair, ALL equal-hop shortest routes — no
    bottleneck filtering (superset of :func:`all_widest_routes` per pair).
    This is the route set unequal (bottleneck-weighted) multipath splits
    over: a route through a thin link stays in the set and carries a
    proportionally small share, where the widest-tie set would drop it
    entirely.  Deterministic (predecessor-id, link-id) enumeration order,
    same caveats on combinatorial torus route counts as
    :func:`all_widest_routes`."""
    n = graph.n_nodes
    adj: list[list[tuple[int, int]]] = [[] for _ in range(n)]
    for l, (i, j) in enumerate(graph.link_ends):
        adj[i].append((j, l))
        adj[j].append((i, l))
    for nbrs in adj:
        nbrs.sort()

    out: list[tuple[tuple[int, ...], ...]] = []
    for src in range(n):
        dist = {src: 0}
        frontier = [src]
        while frontier:
            nxt: list[int] = []
            for u in frontier:
                for v, _ in adj[u]:
                    if v not in dist:
                        dist[v] = dist[u] + 1
                        nxt.append(v)
            frontier = sorted(set(nxt))
        memo: dict[int, tuple[tuple[int, ...], ...]] = {src: ((),)}

        def routes_to(v: int) -> tuple[tuple[int, ...], ...]:
            got = memo.get(v)
            if got is not None:
                return got
            acc: list[tuple[int, ...]] = []
            for u, l in adj[v]:
                if dist.get(u) != dist[v] - 1:
                    continue
                for prefix in routes_to(u):
                    acc.append(prefix + (l,))
            memo[v] = tuple(acc)
            return memo[v]

        for dst in range(n):
            if dst == src:
                out.append(())
            elif dst not in dist:
                raise ValueError(f"node {dst} unreachable from {src}")
            else:
                out.append(routes_to(dst))
    return tuple(out)


def _as_bw_list(link_bw, n_links: int, what: str) -> list[float]:
    """Canonicalize a scalar / sequence / array of link bandwidths to a
    plain list of python floats (array-valued input stays hashable)."""
    arr = np.asarray(link_bw, np.float64)
    if arr.ndim == 0:
        return [float(arr)] * n_links
    flat = [float(v) for v in arr.reshape(-1)]
    if len(flat) != n_links:
        raise ValueError(f"{what}: expected {n_links} bandwidths, got {len(flat)}")
    return flat


def _build(name: str, n: int, ends: list[tuple[int, int]], bws: list[float]) -> LinkGraph:
    graph = LinkGraph(
        name=name,
        n_nodes=n,
        link_ends=tuple(ends),
        link_bw=tuple(bws),
        routes=_shortest_routes(n, ends, bws),
    )
    graph.validate()
    return graph


def from_bandwidth_matrix(name: str, bw: np.ndarray) -> LinkGraph:
    """Build a graph from a symmetric ``(n, n)`` link-bandwidth matrix
    (0 = no link) — the natural form for measured machines.  Accepts any
    array-like; values are canonicalized to python floats."""
    bw = np.asarray(bw, np.float64)
    if bw.ndim != 2 or bw.shape[0] != bw.shape[1]:
        raise ValueError(f"need a square matrix, got shape {bw.shape}")
    if not np.allclose(bw, bw.T):
        raise ValueError("link bandwidth matrix must be symmetric")
    if (bw < 0).any():
        raise ValueError("link bandwidths must be >= 0 (0 = no link)")
    n = bw.shape[0]
    ends = [(i, j) for i in range(n) for j in range(i + 1, n) if bw[i, j] > 0]
    bws = [float(bw[i, j]) for i, j in ends]
    return _build(name, n, ends, bws)


# ---------------------------------------------------------------------------
# Calibration support: parameter <-> link-matrix packing and fitted rebuilds
# ---------------------------------------------------------------------------


class LinkGroups(NamedTuple):
    """Parameter↔matrix packing for fitting link bandwidths.

    ``groups`` partitions a graph's link ids into tied classes: every
    link in a group shares one free parameter (the symmetry/structure mask
    of the inverse problem — e.g. a glued 8-socket machine's 12 QPI links
    are one hardware part, its 4 node-controller links another; a 2D
    torus's row links one ICI class, its column links another).  The
    untied parameterization is ``n_links`` singleton groups.  ``pack``
    reduces per-link values to the free-parameter vector; ``unpack``
    scatters a parameter vector back to per-link order.  Both work on
    numpy and traced JAX arrays (``unpack`` is a pure gather), so the
    packing layer sits inside a jitted objective.
    """

    groups: tuple[tuple[int, ...], ...]

    @property
    def n_params(self) -> int:
        return len(self.groups)

    @property
    def n_links(self) -> int:
        return sum(len(g) for g in self.groups)

    def link_index(self) -> np.ndarray:
        """``(n_links,)`` free-parameter id of every link."""
        idx = np.zeros((self.n_links,), np.int32)
        for p, group in enumerate(self.groups):
            for l in group:
                idx[l] = p
        return idx

    def pack(self, link_bw) -> np.ndarray:
        """Per-link values -> ``(n_params,)`` group means."""
        bw = np.asarray(link_bw, np.float64)
        return np.array([bw[list(g)].mean() for g in self.groups])

    def unpack(self, params):
        """``(n_params,)`` free parameters -> per-link values (a gather:
        differentiable, vmappable)."""
        return params[self.link_index()]

    def validate(self) -> None:
        seen = sorted(l for g in self.groups for l in g)
        if seen != list(range(len(seen))):
            raise ValueError("groups must partition the link ids exactly")
        if any(not g for g in self.groups):
            raise ValueError("empty link group")


def link_groups(graph: LinkGraph, *, tie_equal_bw: bool = False) -> LinkGroups:
    """The natural parameterization of a graph's link bandwidths.

    With ``tie_equal_bw`` links whose *template* bandwidths are equal share
    one parameter (structural knowledge: same physical link class);
    otherwise every link is free.  Fitting stays well-posed either way —
    ties just let a link that never saturates in the sample set inherit
    its class's recovered capacity."""
    if not tie_equal_bw:
        groups = tuple((l,) for l in range(graph.n_links))
    else:
        by_bw: dict[float, list[int]] = {}
        for l, bw in enumerate(graph.link_bw):
            by_bw.setdefault(float(bw), []).append(l)
        groups = tuple(tuple(ls) for _, ls in sorted(by_bw.items()))
    out = LinkGroups(groups=groups)
    out.validate()
    return out


def from_fit(template: LinkGraph, link_bw, *, name: str | None = None) -> LinkGraph:
    """Rebuild a graph from fitted per-link bandwidths, holding the
    template's link list AND routing tables static — the contract of the
    calibration inverse problem (§ the forward model's routes are
    compile-time structure; only capacities are free parameters).  Values
    are canonicalized to python floats so the result stays hashable, and
    the template's class is preserved (a ``numa.topology.Topology``
    template yields a ``Topology``, keeping fingerprints in-domain)."""
    bws = _as_bw_list(link_bw, template.n_links, "from_fit")
    graph = type(template)(
        name=template.name if name is None else name,
        n_nodes=template.n_nodes,
        link_ends=template.link_ends,
        link_bw=tuple(bws),
        routes=template.routes,
    )
    graph.validate()
    return graph


# ---------------------------------------------------------------------------
# Builders
# ---------------------------------------------------------------------------


def fully_connected(n: int, link_bw) -> LinkGraph:
    """Every node pair directly linked (2-socket machines, fully
    QPI-meshed quad Haswell-EX, an NVLink-switched island).  Links
    enumerate in upper-triangle order, matching the scalar-pair model's
    resource layout exactly."""
    ends = [(i, j) for i in range(n) for j in range(i + 1, n)]
    bws = _as_bw_list(link_bw, len(ends), "fully_connected")
    return _build(f"fc{n}", n, ends, bws)


def ring(n: int, link_bw) -> LinkGraph:
    """Nodes on a bidirectional ring — the worst-case hop spread
    (diameter ``n // 2``), and the 1D torus of a single ICI axis."""
    if n < 2:
        raise ValueError("ring needs >= 2 nodes")
    ends = sorted(tuple(sorted((i, (i + 1) % n))) for i in range(n))
    ends = list(dict.fromkeys(ends))  # n == 2: one link, not two
    bws = _as_bw_list(link_bw, len(ends), "ring")
    return _build(f"ring{n}", n, ends, bws)


def _grid_ends(dims: tuple[int, ...], *, wrap: bool) -> list[tuple[int, int]]:
    """Nearest-neighbour links of a row-major ``dims`` grid, optionally
    with wraparound (torus) links, deduplicated (a wrapped length-2 axis
    would repeat its grid link)."""
    strides = [1] * len(dims)
    for k in range(len(dims) - 2, -1, -1):
        strides[k] = strides[k + 1] * dims[k + 1]
    ends: list[tuple[int, int]] = []
    for u in range(int(np.prod(dims))):
        coord = [(u // strides[k]) % dims[k] for k in range(len(dims))]
        for k, size in enumerate(dims):
            if size < 2:
                continue
            if coord[k] + 1 < size:
                ends.append((u, u + strides[k]))
            elif wrap:
                v = u - (size - 1) * strides[k]
                ends.append(tuple(sorted((u, v))))
    ends = sorted(dict.fromkeys(ends))
    return ends


def mesh2d(rows: int, cols: int, link_bw) -> LinkGraph:
    """Nodes on a ``rows x cols`` grid with nearest-neighbour links
    (SGI/HPE hypercube-ish blades flattened to 2D)."""
    n = rows * cols
    if n < 2:
        raise ValueError("mesh2d needs >= 2 nodes")
    ends = _grid_ends((rows, cols), wrap=False)
    bws = _as_bw_list(link_bw, len(ends), "mesh2d")
    return _build(f"mesh{rows}x{cols}", n, ends, bws)


def torus2d(rows: int, cols: int, link_bw) -> LinkGraph:
    """``rows x cols`` grid with wraparound links in both axes — the ICI
    2D torus of a TPU v5e-class slice.  Length-2 axes contribute a single
    link per pair (wrap deduplicated)."""
    n = rows * cols
    if n < 2:
        raise ValueError("torus2d needs >= 2 nodes")
    ends = _grid_ends((rows, cols), wrap=True)
    bws = _as_bw_list(link_bw, len(ends), "torus2d")
    return _build(f"torus{rows}x{cols}", n, ends, bws)


def torus3d(x: int, y: int, z: int, link_bw) -> LinkGraph:
    """``x * y * z`` 3D torus — the ICI fabric of a v4/v5p-class cube."""
    n = x * y * z
    if n < 2:
        raise ValueError("torus3d needs >= 2 nodes")
    ends = _grid_ends((x, y, z), wrap=True)
    bws = _as_bw_list(link_bw, len(ends), "torus3d")
    return _build(f"torus{x}x{y}x{z}", n, ends, bws)


def tree(n: int, link_bw, *, branching: int = 2) -> LinkGraph:
    """A balanced ``branching``-ary tree over ``n`` nodes (node ``i``'s
    parent is ``(i - 1) // branching``) — switch-hierarchy fabrics where
    every cross-subtree pair funnels through shared uplinks."""
    if n < 2:
        raise ValueError("tree needs >= 2 nodes")
    if branching < 1:
        raise ValueError("tree needs branching >= 1")
    ends = sorted((min(i, (i - 1) // branching), max(i, (i - 1) // branching))
                  for i in range(1, n))
    bws = _as_bw_list(link_bw, len(ends), "tree")
    return _build(f"tree{n}b{branching}", n, ends, bws)


def glued(
    n_islands: int,
    island_size: int,
    intra_bw,
    glue_bw,
    *,
    ring_islands: bool = False,
) -> LinkGraph:
    """``n_islands`` fully-meshed islands of ``island_size`` nodes glued by
    twin links: node ``i`` of island ``a`` reaches its twin in island
    ``a + 1`` (and island 0, when ``ring_islands`` — deduplicated for 2
    islands).  This is the glued-socket node-controller shape of Haswell-EX
    8-socket machines AND the multi-host accelerator shape (NVLink island
    per host, host interconnect between): cross-island non-twin pairs route
    over 2 hops, charging an intra link and a glue link — the bandwidth
    cliff a scalar interconnect constant cannot express."""
    if n_islands < 2:
        raise ValueError("glued needs >= 2 islands")
    if island_size < 1:
        raise ValueError("glued needs >= 1 node per island")
    ends: list[tuple[int, int]] = []
    bws: list[float] = []
    for a in range(n_islands):
        base = a * island_size
        for i in range(island_size):
            for j in range(i + 1, island_size):
                ends.append((base + i, base + j))
                bws.append(0.0)  # placeholder, filled below
    n_intra = len(ends)
    intra = _as_bw_list(intra_bw, n_intra, "glued intra_bw")
    bws = list(intra)
    glue_pairs: list[tuple[int, int]] = []
    last = n_islands if ring_islands and n_islands > 2 else n_islands - 1
    for a in range(last):
        b = (a + 1) % n_islands
        for i in range(island_size):
            glue_pairs.append(
                tuple(sorted((a * island_size + i, b * island_size + i)))
            )
    glue = _as_bw_list(glue_bw, len(glue_pairs), "glued glue_bw")
    ends.extend(glue_pairs)
    bws.extend(glue)
    order = sorted(range(len(ends)), key=lambda k: ends[k])
    ends = [ends[k] for k in order]
    bws = [bws[k] for k in order]
    return _build(f"glued{n_islands}x{island_size}", n_islands * island_size, ends, bws)


def snc(
    sockets: int, nodes_per_socket: int, *, qpi_bw: float, intra_bw: float
) -> LinkGraph:
    """Sub-NUMA clustering (SNC / Cluster-on-Die): each socket splits into
    ``nodes_per_socket`` NUMA nodes joined by fast intra-socket (in-die
    mesh) links, while each socket's FIRST node is its interconnect
    endpoint and the endpoints are fully QPI-meshed.  Cross-socket traffic
    from a non-endpoint node routes through its socket's endpoint, so both
    of a socket's nodes *share* the one QPI port — the SNC reality a
    per-socket machine model cannot express.  With ``nodes_per_socket=1``
    this degenerates to :func:`fully_connected`."""
    if sockets < 2:
        raise ValueError("snc needs >= 2 sockets")
    if nodes_per_socket < 1:
        raise ValueError("snc needs >= 1 node per socket")
    ends: list[tuple[int, int]] = []
    bws: list[float] = []
    for s in range(sockets):
        base = s * nodes_per_socket
        for i in range(nodes_per_socket):
            for j in range(i + 1, nodes_per_socket):
                ends.append((base + i, base + j))
                bws.append(float(intra_bw))
    for a in range(sockets):
        for b in range(a + 1, sockets):
            ends.append((a * nodes_per_socket, b * nodes_per_socket))
            bws.append(float(qpi_bw))
    order = sorted(range(len(ends)), key=lambda k: ends[k])
    ends = [ends[k] for k in order]
    bws = [bws[k] for k in order]
    n = sockets * nodes_per_socket
    return _build(f"snc{sockets}x{nodes_per_socket}", n, ends, bws)
