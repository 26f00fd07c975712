"""The port's copy of the routed-graph engine against the reference: the
same graphs (links, capacities, routes), hop matrices, every incidence
table and the link-group packing, for every builder."""

import numpy as np
import pytest

import repro.core.graphtop as ref
import repro.core.numa.topology as ref_numa
import repro_torch.core.graphtop as port
import repro_torch.core.numa.topology as port_numa

GB = 1e9
_BW = np.array(
    [[0, 10, 0, 4], [10, 0, 6, 0], [0, 6, 0, 10], [4, 0, 10, 0]], dtype=np.float64
) * GB

BUILDERS = {
    "fully_connected": lambda m: m.fully_connected(4, 19.2 * GB),
    "fully_connected_per_link": lambda m: m.fully_connected(3, [1.0 * GB, 2.0 * GB, 3.0 * GB]),
    "ring": lambda m: m.ring(6, 8.0 * GB),
    "ring_thin_link": lambda m: m.ring(4, [10.0 * GB, 10.0 * GB, 10.0 * GB, 1.0 * GB]),
    "mesh2d": lambda m: m.mesh2d(2, 3, 5.0 * GB),
    "torus2d": lambda m: m.torus2d(3, 3, 5.0 * GB),
    "torus3d": lambda m: m.torus3d(2, 2, 3, 4.0 * GB),
    "tree": lambda m: m.tree(7, 6.0 * GB),
    "tree_ternary": lambda m: m.tree(9, 6.0 * GB, branching=3),
    "glued": lambda m: m.glued(2, 4, 12.8 * GB, 9.6 * GB),
    "glued_ring": lambda m: m.glued(3, 2, 12.8 * GB, 9.6 * GB, ring_islands=True),
    "snc": lambda m: m.snc(2, 2, qpi_bw=51.2 * GB, intra_bw=44.0 * GB),
    "snc_3x3": lambda m: m.snc(3, 3, qpi_bw=20.0 * GB, intra_bw=40.0 * GB),
    "from_bandwidth_matrix": lambda m: m.from_bandwidth_matrix("measured", _BW),
}

NUMA_BUILDERS = {
    "fully_connected": lambda m: m.fully_connected(2, 16.0 * GB),
    "ring": lambda m: m.ring(5, 8.0 * GB),
    "mesh2d": lambda m: m.mesh2d(2, 2, 8.0 * GB),
    "glued_8s": lambda m: m.glued_8s(qpi_bw=12.8 * GB, nc_bw=9.6 * GB),
    "snc": lambda m: m.snc(2, 2, qpi_bw=51.2 * GB, intra_bw=44.0 * GB),
    "from_bandwidth_matrix": lambda m: m.from_bandwidth_matrix("measured", _BW),
}


def _tables(g) -> dict[str, np.ndarray]:
    return {
        "hop_matrix": g.hop_matrix(),
        "route_incidence": g.route_incidence(),
        "route_incidence_multipath": g.route_incidence(multipath=True),
        "route_incidence_bottleneck": g.route_incidence(
            multipath=True, weighting="bottleneck"
        ),
        "route_incidence_multihop": g.route_incidence_multihop(),
        "directed": g.directed_route_incidence(),
        "directed_multipath": g.directed_route_incidence(multipath=True),
        "directed_bottleneck": g.directed_route_incidence(
            multipath=True, weighting="bottleneck"
        ),
    }


@pytest.mark.parametrize("builder", sorted(BUILDERS))
def test_graph_builders_identical(builder):
    want = BUILDERS[builder](ref)
    got = BUILDERS[builder](port)
    assert tuple(got) == tuple(want)  # name, n_nodes, link_ends, link_bw, routes
    assert repr(got) == repr(want)
    assert got.max_hops == want.max_hops
    assert got.is_fully_direct == want.is_fully_direct
    n = want.n_nodes
    for i in range(n):
        for j in range(n):
            assert got.all_routes(i, j) == want.all_routes(i, j)
            assert got.all_shortest_routes_of(i, j) == want.all_shortest_routes_of(i, j)
    want_t, got_t = _tables(want), _tables(got)
    for name in want_t:
        assert got_t[name].dtype == want_t[name].dtype, name
        np.testing.assert_array_equal(got_t[name], want_t[name], err_msg=name)


@pytest.mark.parametrize("tie", [False, True])
@pytest.mark.parametrize("builder", ["ring_thin_link", "glued", "snc_3x3", "torus2d"])
def test_link_groups_and_from_fit_identical(builder, tie):
    want_g = BUILDERS[builder](ref)
    got_g = BUILDERS[builder](port)
    want = ref.link_groups(want_g, tie_equal_bw=tie)
    got = port.link_groups(got_g, tie_equal_bw=tie)
    assert tuple(got) == tuple(want)
    np.testing.assert_array_equal(got.link_index(), want.link_index())
    bw = np.linspace(1.0, 2.0, want_g.n_links) * GB
    np.testing.assert_array_equal(got.pack(bw), want.pack(bw))
    params = want.pack(bw)
    assert tuple(got.unpack(params)) == tuple(want.unpack(params))
    assert tuple(port.from_fit(got_g, bw)) == tuple(ref.from_fit(want_g, bw))


@pytest.mark.parametrize("builder", sorted(NUMA_BUILDERS))
def test_numa_topology_reprs_identical(builder):
    """``Topology`` prints exactly as the reference's: machine
    fingerprints digest that repr."""
    want = NUMA_BUILDERS[builder](ref_numa)
    got = NUMA_BUILDERS[builder](port_numa)
    assert type(got).__name__ == type(want).__name__ == "Topology"
    assert repr(got) == repr(want)
    np.testing.assert_array_equal(got.route_incidence(), want.route_incidence())
