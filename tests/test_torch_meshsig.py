"""The port's mesh-domain signature (``repro_torch.core.meshsig``:
``device_topology``, ``counters``, ``fit``, the mesh half of ``advisor``,
``calibrate``; ``launch.mesh.advise_mesh_shape``) against the JAX
reference on the same inputs, on the CPU.

Tolerances: device groups, probe designs, link-byte rules and rankings'
orders exactly; routed bytes and times at rel 1e-6; the signature's terms
and predictions (plain Python floats on both sides) at rel 1e-12; the
synthetic samples at rel 1e-6, the seeds and the loss at the seed at rel
1e-5; the loss's gradient within 1e-4 of its largest entry; a 60-step fit
on noisy samples: its first 20 losses at rel 1e-4 and its links at rel
1e-3 (AdamW turns last-bit gradient differences into full steps).  The
routed rankings run on 16-device fabrics; 256 devices are ranked with
the scalar model, as a routed 256-device table is 65,536 pairs by the
links.  The port alone meets the reference's own round-trip gates.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import CPU, assert_rel_to_scale

import repro.core.meshsig.advisor as ref_adv
import repro.core.meshsig.calibrate as ref_cal
import repro.core.meshsig.device_topology as ref_dt
import repro.core.meshsig.fit as ref_fit
import repro.core.meshsig.hlo_counters as ref_hlo
import repro_torch.core.meshsig.advisor as port_adv
import repro_torch.core.meshsig.calibrate as port_cal
import repro_torch.core.meshsig.counters as port_cnt
import repro_torch.core.meshsig.device_topology as port_dt
import repro_torch.core.meshsig.fit as port_fit
from repro.core.graphtop import from_fit as ref_from_fit
from repro.core.graphtop import link_groups as ref_link_groups
from repro.launch.mesh import advise_mesh_shape as ref_advise
from repro.launch.mesh import candidate_mesh_axes
from repro_torch.core.graphtop import LinkGraph, link_groups
from repro_torch.core.graphtop import from_fit as port_from_fit
from repro_torch.launch.mesh import advise_mesh_shape as port_advise

ROOT = Path(__file__).resolve().parents[1]

TOPOLOGIES = {
    "torus4x4": ("ici_torus2d", (4, 4)),
    "torus2x2x4": ("ici_torus3d", (2, 2, 4)),
    "island16": ("nvlink_island", (16,)),
    "ring2x8": ("ring_of_islands", (2, 8)),
}
AXES_16 = [
    {"data": 4, "model": 4},
    {"data": 2, "model": 8},
    {"model": 8, "data": 2},
    {"data": 8, "model": 2},
    {"model": 2, "data": 8},
    {"data": 16, "model": 1},
    {"pod": 2, "data": 2, "model": 4},
    {"model": 4, "data": 2, "pod": 2},
]
AXIS_BYTES = {"pod": 3e8, "data": 7e8, "model": 13e8}


def topologies(name: str, multipath: bool = False):
    """The reference's and the port's topology from the same function."""
    fabric, args = TOPOLOGIES[name]
    ref = getattr(ref_dt, fabric)(*args, multipath=multipath)
    port = getattr(port_dt, fabric)(*args, multipath=multipath)
    return ref, port


def port_topology(ref):
    """The port's :class:`DeviceTopology` for a reference one, field by field."""
    return port_dt.DeviceTopology(graph=LinkGraph(*ref.graph), multipath=ref.multipath)


def synth_profile(mod, axes, *, grad_bytes=1e9, gather_bytes=5e8, a2a_base=2e9):
    """``tests/test_meshsig.py``'s ground-truth generator, built with
    ``mod``'s ``MeshProfile``: the gradient all-reduce and the parameter
    all-gather on data (e = 0), the MoE all-to-all on model scaling with
    1 / batch (e = 1)."""
    b = axes.get("data", 1) * axes.get("pod", 1)
    kd, km = axes["data"], axes["model"]
    return mod.MeshProfile(
        axis_sizes=dict(axes),
        class_axis_bytes={
            ("interleaved", "data"): mod.class_factor("interleaved", kd) * grad_bytes,
            ("static", "data"): mod.class_factor("static", kd) * gather_bytes,
            ("per_shard", "model"): mod.class_factor("per_shard", km) * a2a_base / b,
        },
        local_bytes=1e10 / b,
        flops=1e13 / b,
    )


def signatures(sym_axes, asym_axes):
    """The reference's and the port's signature fitted from the same two
    synthetic profiles."""
    ref = ref_fit.fit_mesh_signature(
        synth_profile(ref_fit, sym_axes), synth_profile(ref_fit, asym_axes)
    )
    port = port_fit.fit_mesh_signature(
        synth_profile(port_fit, sym_axes), synth_profile(port_fit, asym_axes)
    )
    return ref, port


def perturbed_torus(mod, rows=4, cols=4, base=50e9, spread=0.3, seed=0):
    """``tests/test_device_topology.py``'s truth: a torus whose links lie
    within +-30% of ``base``, in ``mod``'s types."""
    t = mod.ici_torus2d(rows, cols, base)
    rng = np.random.default_rng(seed)
    bw = base * (1 + spread * rng.uniform(-1, 1, t.graph.n_links))
    from_fit = ref_from_fit if mod is ref_dt else port_from_fit
    return mod.DeviceTopology(graph=from_fit(t.graph, bw), multipath=False)


def jax_noise(seed: int, n: int) -> np.ndarray:
    return np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (n,)))


def port_samples(ref_samples):
    return port_cal.CollectiveSamples(
        charges=torch.as_tensor(np.array(ref_samples.charges)),
        times=torch.as_tensor(np.array(ref_samples.times)),
    )


# ---------------------------------------------------------------------------
# device_topology
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", TOPOLOGIES)
def test_fabrics_give_the_reference_graphs(name):
    ref, port = topologies(name)
    assert tuple(port.graph) == tuple(ref.graph)
    assert (port.n_devices, port.name) == (ref.n_devices, ref.name)
    assert (port_dt.ICI_LINK_BW, port_dt.NVLINK_BW, port_dt.HOST_LINK_BW) == (
        ref_dt.ICI_LINK_BW, ref_dt.NVLINK_BW, ref_dt.HOST_LINK_BW)
    assert hash(port) == hash(port_topology(ref))


@pytest.mark.parametrize("name", TOPOLOGIES)
@pytest.mark.parametrize("axes", AXES_16, ids=lambda a: "x".join(f"{k}{v}" for k, v in a.items()))
def test_device_groups_match_reference(name, axes):
    ref, port = topologies(name)
    got = port.device_groups(axes)
    assert list(got) == list(axes)
    assert got == ref.device_groups(axes)


@pytest.mark.parametrize("name", TOPOLOGIES)
@pytest.mark.parametrize("multipath", [False, True])
def test_charges_and_times_match_reference(name, multipath):
    """Ring bytes per axis, directed link loads, per-axis times and the
    collective time, for every axis dict in both key orders."""
    ref, port = topologies(name, multipath)
    for axes in AXES_16:
        bytes_ = {a: AXIS_BYTES[a] for a in axes}
        for axis in axes:
            got = port.axis_pair_bytes(axes, axis, bytes_[axis])
            want = ref.axis_pair_bytes(axes, axis, bytes_[axis])
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
        np.testing.assert_allclose(port.link_loads(axes, bytes_),
                                   ref.link_loads(axes, bytes_), rtol=1e-6, atol=0)
        got_t, want_t = port.per_axis_times(axes, bytes_), ref.per_axis_times(axes, bytes_)
        assert list(got_t) == list(want_t)
        np.testing.assert_allclose(list(got_t.values()), list(want_t.values()), rtol=1e-6)
        assert port.collective_time(axes, bytes_) == pytest.approx(
            ref.collective_time(axes, bytes_), rel=1e-6)


@pytest.mark.parametrize("name", TOPOLOGIES)
def test_size_mismatch_raises_like_reference(name):
    ref, port = topologies(name)
    axes = {"data": 3, "model": 4}
    with pytest.raises(ValueError) as want:
        ref.device_groups(axes)
    with pytest.raises(ValueError) as got:
        port.device_groups(axes)
    assert str(got.value) == str(want.value)


def test_multipath_splits_a_ring_as_the_reference_does():
    """A 4-device ring whose strided axis pairs opposite corners: the two
    2-hop routes split the charge and halve the axis time."""
    from repro.core.graphtop import ring as ref_ring
    from repro_torch.core.graphtop import ring

    axes, B = {"a": 2, "b": 2}, {"a": 4e9, "b": 0.0}
    for multipath in (False, True):
        ref = ref_dt.DeviceTopology(graph=ref_ring(4, 10e9), multipath=multipath)
        port = port_dt.DeviceTopology(graph=ring(4, 10e9), multipath=multipath)
        np.testing.assert_allclose(port.link_loads(axes, B), ref.link_loads(axes, B), rtol=1e-6)
    single = port_dt.DeviceTopology(graph=ring(4, 10e9))
    multi = port_dt.DeviceTopology(graph=ring(4, 10e9), multipath=True)
    assert multi.per_axis_times(axes, B)["a"] == pytest.approx(
        single.per_axis_times(axes, B)["a"] / 2)


# ---------------------------------------------------------------------------
# counters + fit
# ---------------------------------------------------------------------------


def _assert_terms(got: dict, want: dict):
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        assert np.shape(g) == np.shape(w), k
        np.testing.assert_allclose(g, w, rtol=1e-12, atol=0, err_msg=str(k))


@pytest.mark.parametrize("sym,asym", [
    ({"data": 32, "model": 8}, {"data": 64, "model": 4}),
    ({"data": 8, "model": 2}, {"data": 4, "model": 4}),
])
def test_signature_fit_matches_reference(sym, asym):
    ref, port = signatures(sym, asym)
    _assert_terms(port.terms, ref.terms)
    assert (port.local_bytes0, port.flops0, port.batch_shards0) == pytest.approx(
        (ref.local_bytes0, ref.flops0, ref.batch_shards0), rel=1e-12)
    assert port.terms[("per_shard", "model")][1] == 1.0


@pytest.mark.parametrize("target", [
    {"data": 8, "model": 32}, {"data": 4, "model": 64}, {"data": 16, "model": 16},
])
def test_predictions_match_reference(target):
    ref, port = signatures({"data": 32, "model": 8}, {"data": 64, "model": 4})
    _assert_terms(port.predict_axis_bytes(target), ref.predict_axis_bytes(target))
    assert port.predict_local_bytes(target) == pytest.approx(
        ref.predict_local_bytes(target), rel=1e-12)
    _assert_terms(port.class_fractions(), ref.class_fractions())


def _op(mod, kind, bytes_, group, link_bytes):
    return mod.CollectiveOp(kind=kind, bytes=bytes_, group=group, count=1, link_bytes=link_bytes)


PROFILE_CASES = {
    # tests/test_meshsig.py's two attribution cases
    "distinct_sizes": ({"data": 32, "model": 8}, 1.0, 10.0, [
        ("all-reduce", 8.0, 32, 8.0), ("all-to-all", 4.0, 8, 4.0)]),
    "tie_splits": ({"data": 16, "model": 16}, 0.0, 0.0, [("all-gather", 6.0, 16, 6.0)]),
    # a collective over every device spans every axis
    "global": ({"data": 32, "model": 8}, 3.0, 400.0, [
        ("all-reduce", 10.0, 256, 19.9), ("reduce-scatter", 2.0, 8, 14.0)]),
    # a group that is a product of axes goes to the largest axis; an
    # unknown kind and zero link bytes are skipped
    "product_of_axes": ({"pod": 2, "data": 16, "model": 8}, 5.0, 50.0, [
        ("all-gather", 6.0, 128, 5.0), ("collective-permute", 1.0, 2, 1.0),
        ("send", 9.0, 2, 9.0), ("all-to-all", 3.0, 8, 0.0)]),
}


@pytest.mark.parametrize("case", PROFILE_CASES)
def test_profile_from_analysis_matches_reference(case):
    """The reference's ``HloAnalysis`` converted field by field into the
    port's record; every ``class_axis_bytes`` entry, the local bytes and
    the collective summary equal."""
    axes, flops, hbm, ops = PROFILE_CASES[case]
    ref_rec = ref_hlo.HloAnalysis(flops=flops, hbm_bytes=hbm,
                                  collectives=[_op(ref_hlo, *o) for o in ops])
    port_rec = port_cnt.ProgramCounters(
        flops=ref_rec.flops, hbm_bytes=ref_rec.hbm_bytes,
        collectives=[port_cnt.CollectiveOp(**vars(c)) for c in ref_rec.collectives],
    )
    want = ref_fit.profile_from_analysis(ref_rec, axes)
    got = port_fit.profile_from_analysis(port_rec, axes)
    _assert_terms(got.class_axis_bytes, want.class_axis_bytes)
    assert got.axis_sizes == want.axis_sizes
    assert got.local_bytes == pytest.approx(want.local_bytes, rel=1e-12)
    assert got.flops == want.flops
    assert port_rec.collective_summary() == ref_rec.collective_summary()


@pytest.mark.parametrize("kind", [
    "all-reduce", "all-gather", "reduce-scatter", "all-to-all", "collective-permute",
])
def test_collective_link_bytes_matches_reference(kind):
    for group in (1, 2, 8, 512):
        for result_bytes in (0.0, 3.0, 1.5e9):
            assert port_cnt.collective_link_bytes(kind, result_bytes, group) == \
                ref_hlo._collective_link_bytes(kind, result_bytes, group)


# ---------------------------------------------------------------------------
# advisor.rank_meshes + launch.mesh.advise_mesh_shape
# ---------------------------------------------------------------------------


def _assert_rankings(got, want):
    assert [list(r.axis_sizes.items()) for r in got] == [list(r.axis_sizes.items()) for r in want]
    for g, w in zip(got, want):
        assert (g.compute_s, g.memory_s, g.collective_s, g.step_s) == pytest.approx(
            (w.compute_s, w.memory_s, w.collective_s, w.step_s), rel=1e-6)
        assert list(g.per_axis_s) == list(w.per_axis_s)
        np.testing.assert_allclose(list(g.per_axis_s.values()), list(w.per_axis_s.values()),
                                   rtol=1e-6)
        assert g.bottleneck == w.bottleneck


def test_chip_presets_match_reference():
    for name in ("CHIP_V5E", "CHIP_V5P"):
        got, want = getattr(port_adv, name), getattr(ref_adv, name)
        assert (got.name, got.peak_flops, got.hbm_bw, got.ici_bw) == (
            want.name, want.peak_flops, want.hbm_bw, want.ici_bw)


@pytest.mark.parametrize("chip", ["CHIP_V5E", "CHIP_V5P"])
@pytest.mark.parametrize("topology", [None, *TOPOLOGIES])
def test_rank_meshes_matches_reference_on_16_devices(chip, topology):
    ref_sig, port_sig = signatures({"data": 8, "model": 2}, {"data": 4, "model": 4})
    candidates = candidate_mesh_axes(16) + [{"model": 8, "data": 2}, {"model": 4, "data": 4}]
    ref_topo, port_topo = topologies(topology) if topology else (None, None)
    want = ref_adv.rank_meshes(ref_sig, candidates, chip=getattr(ref_adv, chip),
                               topology=ref_topo)
    got = port_adv.rank_meshes(port_sig, candidates, chip=getattr(port_adv, chip),
                               topology=port_topo)
    _assert_rankings(got, want)


@pytest.mark.parametrize("chip", ["CHIP_V5E", "CHIP_V5P"])
def test_rank_meshes_matches_reference_on_256_devices(chip):
    ref_sig, port_sig = signatures({"data": 32, "model": 8}, {"data": 64, "model": 4})
    candidates = candidate_mesh_axes(256, max_model=64)
    want = ref_adv.rank_meshes(ref_sig, candidates, chip=getattr(ref_adv, chip))
    got = port_adv.rank_meshes(port_sig, candidates, chip=getattr(port_adv, chip))
    _assert_rankings(got, want)
    # the explicit rates override the chip's, as in the reference
    kw = dict(peak_flops=1e15, hbm_bw=2e12, ici_bw=3e11)
    _assert_rankings(port_adv.rank_meshes(port_sig, candidates, **kw),
                     ref_adv.rank_meshes(ref_sig, candidates, **kw))


def test_routed_equals_scalar_on_a_uniform_island():
    """On a fully-connected uniform fabric at the chip's link rate the
    routed times are the scalar model's, and the order is the same."""
    ref_sig, port_sig = signatures({"data": 8, "model": 2}, {"data": 4, "model": 4})
    candidates = candidate_mesh_axes(16)
    island = port_dt.nvlink_island(16, port_adv.CHIP_V5E.ici_bw)
    scalar = port_adv.rank_meshes(port_sig, candidates)
    routed = port_adv.rank_meshes(port_sig, candidates, topology=island)
    _assert_rankings(routed, scalar)
    _assert_rankings(routed, ref_adv.rank_meshes(
        ref_sig, candidates, topology=ref_dt.nvlink_island(16, ref_adv.CHIP_V5E.ici_bw)))


def test_glue_separates_identical_axis_sizes():
    """On two hosts the model axis striding across the glue ranks below
    the island-local one, which the scalar model scores the same."""
    kw = dict(grad_bytes=1e8, gather_bytes=5e7, a2a_base=64e9)
    sig = port_fit.fit_mesh_signature(synth_profile(port_fit, {"data": 8, "model": 2}, **kw),
                                      synth_profile(port_fit, {"data": 4, "model": 4}, **kw))
    local, strided = {"data": 2, "model": 8}, {"model": 8, "data": 2}
    s = port_adv.rank_meshes(sig, [local, strided])
    assert s[0].step_s == s[1].step_s
    r = port_adv.rank_meshes(sig, [local, strided], topology=port_dt.ring_of_islands(2, 8))
    assert [list(x.axis_sizes) for x in r] == [["data", "model"], ["model", "data"]]
    assert r[1].collective_s > 3 * r[0].collective_s


@pytest.mark.parametrize("kwargs", [
    dict(n_devices=16),
    dict(n_devices=16, chip="CHIP_V5P", topology="ring2x8"),
    dict(n_devices=16, topology="torus4x4", axis_names=("pod", "model"), min_model=2),
    dict(n_devices=16, topology="island16", max_model=8),
    dict(n_devices=256, chip="CHIP_V5P", max_model=64),
])
def test_advise_mesh_shape_matches_reference(kwargs):
    ref_sig, port_sig = signatures({"data": 32, "model": 8}, {"data": 64, "model": 4})
    ref_kw, port_kw = dict(kwargs), dict(kwargs)
    if "chip" in kwargs:
        ref_kw["chip"] = getattr(ref_adv, kwargs["chip"])
        port_kw["chip"] = getattr(port_adv, kwargs["chip"])
    if "topology" in kwargs:
        ref_kw["topology"], port_kw["topology"] = topologies(kwargs["topology"])
    _assert_rankings(port_advise(port_sig, **port_kw), ref_advise(ref_sig, **ref_kw))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_chip_smoke_rankings_are_the_cpu_ones():
    """``chip_smoke.py``'s committed H100 rankings are what the port gives
    here, and what the reference gives on the same signature and chip;
    the island's routed times are the scalar model's."""
    smoke = _chip_smoke()
    h100 = smoke.h100_chip()
    ref_h100 = ref_adv.ChipSpec(h100.name, h100.peak_flops, h100.hbm_bw, h100.ici_bw)
    ref_sig, _ = signatures({"data": 8, "model": 2}, {"data": 4, "model": 4})
    for fabric, args, want in smoke.MESH_RANK_CELLS:
        got = smoke.mesh_rankings(fabric, args)
        assert smoke.rank_order(got) == want, fabric
        ref_topo = getattr(ref_dt, fabric)(*args)
        _assert_rankings(got, ref_advise(ref_sig, ref_topo.n_devices, chip=ref_h100,
                                         topology=ref_topo))
    _assert_rankings(smoke.mesh_rankings("nvlink_island", (8,)),
                     smoke.mesh_rankings("nvlink_island", (8,), routed=False))


# ---------------------------------------------------------------------------
# calibrate
# ---------------------------------------------------------------------------

RING_AXES = [{"data": 4, "model": 4}, {"data": 2, "model": 8}]


def test_probe_suite_matches_reference():
    ref, port = perturbed_torus(ref_dt), perturbed_torus(port_dt)
    for axes in ([], RING_AXES):
        got = port_cal.probe_suite(port, axis_sizes_list=axes, probe_bytes=3e8)
        want = ref_cal.probe_suite(ref, axis_sizes_list=axes, probe_bytes=3e8)
        assert got.shape == want.shape == (64 + len(axes), 64)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("noisy", [False, True])
def test_collect_samples_matches_reference(noisy):
    ref, port = perturbed_torus(ref_dt, seed=3), perturbed_torus(port_dt, seed=3)
    charges = ref_cal.probe_suite(ref, axis_sizes_list=RING_AXES)
    if noisy:
        want = ref_cal.collect_samples(ref, charges, noise_std=0.01, key=jax.random.PRNGKey(7))
        got = port_cal.collect_samples(port, charges, noise_std=0.01,
                                       noise=jax_noise(7, len(charges)), device=CPU)
    else:
        want = ref_cal.collect_samples(ref, charges)
        got = port_cal.collect_samples(port, charges, device=CPU)
    assert got.charges.dtype == got.times.dtype == torch.float32
    np.testing.assert_allclose(got.charges.numpy(), np.asarray(want.charges), rtol=1e-6)
    np.testing.assert_allclose(got.times.numpy(), np.asarray(want.times), rtol=1e-6)


def test_collect_samples_needs_a_noise_source():
    truth = perturbed_torus(port_dt)
    charges = port_cal.probe_suite(truth)
    with pytest.raises(ValueError, match="noise"):
        port_cal.collect_samples(truth, charges, noise_std=0.01, device=CPU)
    a = port_cal.collect_samples(truth, charges, noise_std=0.01, device=CPU,
                                 generator=torch.Generator().manual_seed(1))
    b = port_cal.collect_samples(truth, charges, noise_std=0.01, device=CPU,
                                 generator=torch.Generator().manual_seed(1))
    assert torch.equal(a.times, b.times)
    assert not torch.equal(a.times, port_cal.collect_samples(truth, charges, device=CPU).times)


def _tie_cases():
    """``(ref template, ref samples, groups, log_bw point)`` of the two
    tie cases, each with links tied inside a sample's max: the glued ring's
    two classes under ``tie_equal_bw`` at the seed of a noisy sweep, and a
    uniform blind template (every link free) at its own uniform rate."""
    truth = ref_dt.ring_of_islands(2, 4, island_bw=400e9, host_bw=20e9)
    charges = ref_cal.probe_suite(
        truth, axis_sizes_list=[{"data": 2, "model": 4}, {"model": 4, "data": 2}])
    samples = ref_cal.collect_samples(truth, charges, noise_std=0.02, key=jax.random.PRNGKey(3))
    placeholder = [100e9 if (i < 4) == (j < 4) else 1e9 for i, j in truth.graph.link_ends]
    two_class = ref_dt.DeviceTopology(graph=ref_from_fit(truth.graph, placeholder))
    groups = ref_link_groups(two_class.graph, tie_equal_bw=True)
    seed = ref_cal.seed_link_bw(two_class, samples)
    yield "two_class_seed", two_class, samples, groups, np.log(groups.pack(seed).astype(np.float32))
    blind = ref_dt.DeviceTopology(graph=ref_from_fit(
        truth.graph, np.full((truth.graph.n_links,), float(np.mean(truth.graph.link_bw)))))
    groups = ref_link_groups(blind.graph)
    yield ("uniform_blind", blind, samples, groups,
           np.log(groups.pack(blind.graph.link_bw).astype(np.float32)))


@pytest.mark.parametrize("case", ["two_class_seed", "uniform_blind"])
def test_loss_gradient_at_a_tie_matches_reference(case):
    """Several links share a sample's max: the reference's gradient splits
    the cotangent over them, and so must the port's (``amax``)."""
    _, template, ref_samples, ref_groups, point = next(c for c in _tie_cases() if c[0] == case)
    charges = np.asarray(ref_samples.charges, np.float64)
    slot_bw = np.repeat(np.exp(point.astype(np.float64))[ref_groups.link_index()], 2)
    per_slot = charges / slot_bw
    ties = (per_slot == per_slot.max(axis=1, keepdims=True)).sum(axis=1)
    assert ties.max() > 1  # the case holds a tie

    x = jnp.asarray(point)
    want_loss, want_grad = jax.value_and_grad(
        lambda q: ref_cal._time_loss(ref_groups, ref_samples, q))(x)
    samples = port_samples(ref_samples)
    groups = link_groups(LinkGraph(*template.graph), tie_equal_bw=case == "two_class_seed")
    leaf = torch.as_tensor(point).requires_grad_()
    loss = port_cal._time_loss(port_cal._link_index(groups, CPU), samples, leaf)
    (grad,) = torch.autograd.grad(loss, leaf)
    assert float(loss.detach()) == pytest.approx(float(want_loss), rel=1e-5)
    assert float(np.abs(np.asarray(want_grad)).max()) > 0
    assert_rel_to_scale(grad, np.asarray(want_grad), rtol=1e-4, what=case)


def test_seed_and_loss_at_the_seed_match_reference():
    ref, port = perturbed_torus(ref_dt, seed=3), perturbed_torus(port_dt, seed=3)
    charges = ref_cal.probe_suite(ref, axis_sizes_list=RING_AXES)
    ref_samples = ref_cal.collect_samples(ref, charges, noise_std=0.01,
                                          key=jax.random.PRNGKey(7))
    samples = port_samples(ref_samples)
    want = ref_cal.seed_link_bw(ref, ref_samples)
    got = port_cal.seed_link_bw(port, samples)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    groups = ref_link_groups(ref.graph)
    log_bw = np.log(groups.pack(want).astype(np.float32))
    want_loss = float(ref_cal._time_loss(groups, ref_samples, jnp.asarray(log_bw)))
    got_loss = float(port_cal._time_loss(
        port_cal._link_index(link_groups(port.graph), CPU), samples, torch.as_tensor(log_bw)))
    assert got_loss == pytest.approx(want_loss, rel=1e-5)


def test_fit_trajectory_matches_reference():
    """60 steps from the blind template on the noisy torus sweep (the
    reference's noise, drawn from ``PRNGKey(7)``): the loss before each of
    the first 20 updates at rel 1e-4, the fitted links at rel 1e-3."""
    ref, port = perturbed_torus(ref_dt, seed=3), perturbed_torus(port_dt, seed=3)
    charges = ref_cal.probe_suite(ref, axis_sizes_list=RING_AXES[:1])
    ref_samples = ref_cal.collect_samples(ref, charges, noise_std=0.01,
                                          key=jax.random.PRNGKey(7))
    blind = ref_dt.DeviceTopology(graph=ref_from_fit(
        ref.graph, np.full((ref.graph.n_links,), float(np.mean(ref.graph.link_bw)))))
    want = ref_cal.fit_device_topology(blind, ref_samples, steps=60)
    got = port_cal.fit_device_topology(port_cal.blind_template(port), port_samples(ref_samples),
                                       steps=60, device=CPU)
    assert got.loss_history.shape == (60,)
    np.testing.assert_allclose(got.loss_history[:20], want.loss_history[:20], rtol=1e-4)
    assert got.seed_loss == pytest.approx(want.seed_loss, rel=1e-5)
    np.testing.assert_allclose(got.link_bw, want.link_bw, rtol=1e-3)
    assert got.topology.graph.routes == want.topology.graph.routes
    assert got.groups == want.groups


# ---------------------------------------------------------------------------
# the reference's round-trip gates, on the port alone (200 steps)
# ---------------------------------------------------------------------------


def test_roundtrip_on_the_torus():
    truth = perturbed_torus(port_dt)
    res = port_cal.fit_from_synthetic(truth, axis_sizes_list=RING_AXES, device=CPU)
    assert port_cal.link_relative_errors(res.topology, truth).max() < 0.05
    assert res.final_loss < 1e-3
    assert res.topology.graph.routes == truth.graph.routes
    assert res.loss_history.shape == (200,)


def test_roundtrip_on_the_noisy_torus():
    truth = perturbed_torus(port_dt, seed=3)
    res = port_cal.fit_from_synthetic(truth, axis_sizes_list=RING_AXES[:1], noise_std=0.01,
                                      generator=torch.Generator().manual_seed(7), device=CPU)
    assert port_cal.link_relative_errors(res.topology, truth).max() < 0.05
    assert res.final_loss < 1e-3
    assert res.topology.graph.routes == truth.graph.routes


def test_tie_equal_bw_fits_one_parameter_per_class():
    truth = port_dt.ring_of_islands(2, 4, island_bw=400e9, host_bw=20e9)
    placeholder = [100e9 if (i < 4) == (j < 4) else 1e9 for i, j in truth.graph.link_ends]
    template = port_dt.DeviceTopology(graph=port_from_fit(truth.graph, placeholder))
    res = port_cal.fit_from_synthetic(truth, template, tie_equal_bw=True, device=CPU)
    assert res.groups.n_params == 2
    assert port_cal.link_relative_errors(res.topology, truth).max() < 0.05


def test_fit_rejects_a_mismatched_charge_width():
    truth = perturbed_torus(port_dt)
    samples = port_cal.collect_samples(truth, port_cal.probe_suite(truth), device=CPU)
    with pytest.raises(ValueError, match="directed slots"):
        port_cal.fit_device_topology(port_dt.nvlink_island(4), samples, device=CPU)
