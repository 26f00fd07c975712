"""The port's learned topology calibration (``repro_torch.core.numa.
calibrate``) and its paired batch (``simulator.simulate_paired_batch``)
against the JAX reference on the same inputs, on the CPU.

Tolerances: the probe suite exactly; sweep counters and
``counter_errors_pct`` at rel 1e-5 of the largest counter (the paired
structured fill against the reference's per-sample grouped fill), the
paired batch against the port's own per-sample ``simulate`` at 1e-6;
seeds at rel 1e-5; the loss at rel 1e-4 and each gradient leaf within
1e-4 of the gradient's largest entry.  A gradient leaf is compared to the
gradient's scale, not elementwise: at a noise-free seed the banks sit
exactly on their observed rates, and their gradients are float32
rounding of a zero residual (about 1e-5 of the link gradients).  For the
same reason the fit trajectory is compared on a noisy sweep: AdamW
normalizes a rounding-noise gradient into a full-size step, so a
noise-free fit amplifies last-bit differences, while on measured
(noisy) counters every gradient is signal.

The reference's fits and sweeps are called under one ``jax.jit`` each
(``_fit_jit``, ``_collect_jit``), as the reference does itself.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import (
    CPU,
    assert_close,
    assert_rel_to_scale,
    jax_counter_noise,
    port_machine,
    to_np,
)

import repro.core.numa as ref
import repro.core.numa.calibrate as ref_cal
import repro_torch.core.numa as port
import repro_torch.core.numa.calibrate as port_cal
from repro_torch.convert import calibration_params_from_arrays, calibration_samples_from_arrays
from repro_torch.core.numa.benchmarks import benchmark_workload
from repro_torch.core.numa.evaluate import evaluate_batch, placement_array
from repro_torch.core.numa.simulator import (
    CounterNoise,
    default_generator,
    machine_caps,
    simulate,
    simulate_paired_batch,
)

PRESETS = [
    "E5-2630v3-8c", "E5-2630v3-8c-mixed-dimm", "E7-4830v3-4s12c", "E7-8860v3-8s16c",
    "E5-2699v3-18c-snc2",
]


@functools.lru_cache(maxsize=None)
def _machines(name):
    m = ref.MACHINES[name]
    return m, port_machine(m)


@functools.lru_cache(maxsize=None)
def _ref_sweep(name, noise_std=0.0, seed=0):
    return ref_cal.collect_sweep(
        ref.MACHINES[name], noise_std=noise_std, key=jax.random.PRNGKey(seed)
    )


def _port_samples(ref_samples):
    fields = {k: np.asarray(v) for k, v in ref_samples._asdict().items() if k != "wl_arrays"}
    fields["wl_arrays"] = [np.asarray(a) for a in ref_samples.wl_arrays]
    return calibration_samples_from_arrays(fields, device=CPU)


def _port_params(ref_params):
    return calibration_params_from_arrays(
        {k: np.asarray(v) for k, v in ref_params._asdict().items()}, device=CPU
    )


def _templates(name):
    m, pm = _machines(name)
    tmpl = ref_cal.blind_template(m)
    return tmpl, port_machine(tmpl)


# ---------------------------------------------------------------------------
# Probe design, sweeps and the paired batch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", PRESETS)
def test_probe_suite_equals_reference(name):
    m, pm = _machines(name)
    want, got = ref_cal.probe_suite(m), port_cal.probe_suite(pm, device=CPU)
    assert len(got) == len(want)
    for (gw, gp), (ww, wp) in zip(got, want):
        assert gw.name == ww.name
        np.testing.assert_array_equal(np.asarray(gp), np.asarray(wp))
        for f in ww._fields[1:]:
            np.testing.assert_array_equal(to_np(getattr(gw, f)), np.asarray(getattr(ww, f)))
    with pytest.raises(ValueError):
        port_cal.probe_suite(pm, n_threads=pm.cores_per_node + 1, device=CPU)


@pytest.mark.parametrize("name", ["E7-4830v3-4s12c", "E7-8860v3-8s16c", "E5-2699v3-18c-snc2"])
@pytest.mark.parametrize("noise_std", [0.0, 0.02])
def test_collect_sweep_matches_reference(name, noise_std):
    """Noise-free, and with the reference's own draws: ``collect_sweep``
    splits its key once per probe, and each probe's ``simulate`` draws its
    noise from its key."""
    m, pm = _machines(name)
    want = _ref_sweep(name, noise_std, 3)
    noise = None
    if noise_std:
        keys = jax.random.split(jax.random.PRNGKey(3), want.n_samples)
        draws = [jax_counter_noise(k, m.n_nodes) for k in keys]
        noise = CounterNoise(*(torch.stack(z) for z in zip(*draws)))
    got = port_cal.collect_sweep(pm, noise_std=noise_std, noise=noise, device=CPU)
    for f in ("local_read", "remote_read", "local_write", "remote_write", "instructions"):
        assert_rel_to_scale(getattr(got, f), getattr(want, f), rtol=1e-5, what=f)
    np.testing.assert_array_equal(to_np(got.placements), np.asarray(want.placements))
    for g, w in zip(got.wl_arrays, want.wl_arrays):
        np.testing.assert_array_equal(to_np(g), np.asarray(w))


@pytest.mark.parametrize("name", ["E7-8860v3-8s16c", "E5-2699v3-18c-snc2"])
def test_paired_batch_matches_per_sample_simulate(name):
    """Row ``p`` of the paired batch is ``simulate`` of workload ``p`` at
    placement ``p`` (rel 1e-6), on the probe sweep and on two-class
    Page-rank rows at random placements."""
    _, pm = _machines(name)
    probes = port_cal.probe_suite(pm, device=CPU)
    wls = [w for w, _ in probes]
    stacked = port.Workload("p", *(torch.stack(f) for f in zip(*(w[1:] for w in wls))))
    placements = np.stack([p for _, p in probes])
    got = simulate_paired_batch(pm, stacked, placements, thread_classes=(0,))
    for p, (wl, placement) in enumerate(probes):
        want = simulate(pm, wl, torch.as_tensor(placement))
        assert_rel_to_scale(got.read_flows[p], want.read_flows, rtol=1e-6, what=f"read {p}")
        assert_rel_to_scale(got.write_flows[p], want.write_flows, rtol=1e-6, what=f"write {p}")
        assert_rel_to_scale(got.instructions[p], want.sample.instructions, rtol=1e-6)

    n = 2 * pm.cores_per_node
    pr = benchmark_workload("Page rank", n, device=CPU)
    table = placement_array(pm, n, max_placements=12)
    rows = port.Workload("pr", *(f.expand(len(table), *f.shape).contiguous() for f in pr[1:]))
    classes = port.thread_class_starts(pr)
    got = simulate_paired_batch(pm, rows, table, thread_classes=classes)
    for p, placement in enumerate(table):
        want = simulate(pm, pr, torch.as_tensor(placement), thread_classes=classes)
        assert_rel_to_scale(got.read_flows[p], want.read_flows, rtol=1e-6)
        assert float(got.throughput[p]) == pytest.approx(float(want.throughput), rel=1e-6)


# ---------------------------------------------------------------------------
# Seeding, capacities, the loss and its gradient
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["E7-4830v3-4s12c", "E7-8860v3-8s16c", "E5-2699v3-18c-snc2"])
def test_seed_parameters_match_reference(name):
    tmpl, ptmpl = _templates(name)
    want = ref_cal.seed_parameters(tmpl, _ref_sweep(name))
    got = port_cal.seed_parameters(ptmpl, _port_samples(_ref_sweep(name)))
    for f in want._fields:
        assert_close(getattr(got, f), getattr(want, f), rtol=1e-5, what=f)


def test_caps_from_at_truth_equals_machine_caps():
    m, pm = _machines("E5-2699v3-18c-snc2")
    groups = port.link_groups(pm.topology)
    params = port_cal.CalibrationParams(
        log_link_bw=torch.log(torch.tensor(groups.pack(pm.topology.link_bw), dtype=torch.float32)),
        log_local_read=torch.log(pm.node_local_bw("read", CPU)),
        log_local_write=torch.log(pm.node_local_bw("write", CPU)),
        att_raw=torch.tensor(np.log(pm.hop_attenuation / (1 - pm.hop_attenuation)),
                             dtype=torch.float32),
    )
    got = to_np(port_cal._caps_from(pm, groups, params))
    want = to_np(machine_caps(pm, CPU))
    finite = np.isfinite(want)
    np.testing.assert_allclose(got[finite], want[finite], rtol=1e-5)
    assert (got[~finite] == port_cal._UNUSED_CAP).all()
    ref_got = np.asarray(ref_cal._caps_from(
        m, ref_cal.link_groups(m.topology),
        ref_cal.CalibrationParams(*(jnp.asarray(to_np(v)) for v in params)),
    ))
    np.testing.assert_allclose(got, ref_got, rtol=1e-6)


def _loss_and_grad(name, params_of, huber):
    """The reference's and the port's ``_sweep_loss`` and gradient at the
    parameters ``params_of(seed)`` returns (numpy leaves)."""
    tmpl, ptmpl = _templates(name)
    samples = _ref_sweep(name)
    groups = ref_cal.link_groups(tmpl.topology)
    seed = ref_cal.seed_parameters(tmpl, samples, groups)
    q = params_of({k: np.asarray(v) for k, v in seed._asdict().items()})

    @jax.jit
    def ref_loss(leaves):
        return ref_cal._sweep_loss(
            tmpl, groups, samples, ref_cal.CalibrationParams(**leaves), 0.25, (0,), huber
        )

    want_loss, want_grad = jax.value_and_grad(ref_loss)({k: jnp.asarray(v) for k, v in q.items()})
    leaves = {k: torch.tensor(v, requires_grad=True) for k, v in q.items()}
    loss = port_cal._sweep_loss(
        ptmpl, port.link_groups(ptmpl.topology), _port_samples(samples),
        port_cal.CalibrationParams(**leaves), 0.25, (0,), huber,
    )
    grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    got_grad = {
        k: np.zeros(np.shape(q[k]), np.float32) if g is None else to_np(g)
        for k, g in zip(leaves, grads)
    }
    return float(loss.detach()), got_grad, float(want_loss), {k: np.asarray(v) for k, v in want_grad.items()}


def _hold_gradients(got, want):
    scale = max(float(np.abs(w).max()) for w in want.values())
    assert scale > 0
    for k, w in want.items():
        assert np.isfinite(got[k]).all(), k
        err = float(np.abs(got[k] - w).max()) / scale
        assert err <= 1e-4, f"{k}: max |diff| / gradient scale = {err:.3e}"


@pytest.mark.parametrize("name", ["E7-4830v3-4s12c", "E7-8860v3-8s16c"])
@pytest.mark.parametrize("huber", [None, 0.05])
def test_sweep_loss_and_gradient_at_the_seed(name, huber):
    got_loss, got_grad, want_loss, want_grad = _loss_and_grad(name, lambda p: p, huber)
    assert got_loss == pytest.approx(want_loss, rel=1e-4)
    _hold_gradients(got_grad, want_grad)


@pytest.mark.parametrize("name", ["E7-8860v3-8s16c", "E5-2699v3-18c-snc2"])
def test_sweep_loss_and_gradient_off_the_seed(name):
    """Away from the seed (a numpy-seeded offset of every leaf) every
    parameter, the attenuation included, has a gradient well above
    rounding; the port's finite diagonal keeps it finite."""
    rng = np.random.default_rng(7)

    def offset(p):
        return {k: (v + rng.normal(0, 0.1, np.shape(v))).astype(np.float32) for k, v in p.items()}

    got_loss, got_grad, want_loss, want_grad = _loss_and_grad(name, offset, None)
    assert got_loss == pytest.approx(want_loss, rel=1e-4)
    assert np.abs(want_grad["att_raw"]).max() > 0
    _hold_gradients(got_grad, want_grad)


# ---------------------------------------------------------------------------
# The fit
# ---------------------------------------------------------------------------


def test_fit_trajectory_matches_reference():
    """60 steps on E7-4830 v3's noisy sweep: the loss before each of the
    first 20 updates at rel 1e-4, the fitted links at rel 1e-3."""
    name = "E7-4830v3-4s12c"
    tmpl, ptmpl = _templates(name)
    samples = _ref_sweep(name, 0.02, 1)
    want = ref_cal.fit_machine(tmpl, samples, steps=60)
    got = port_cal.fit_machine(ptmpl, _port_samples(samples), steps=60)
    assert got.loss_history.shape == (60,)
    assert_close(got.loss_history[:20], want.loss_history[:20], rtol=1e-4, what="history")
    assert got.seed_loss == pytest.approx(want.seed_loss, rel=1e-4)
    assert got.final_loss == pytest.approx(want.final_loss, rel=1e-3)
    np.testing.assert_allclose(got.machine.topology.link_bw, want.machine.topology.link_bw,
                               rtol=1e-3)
    np.testing.assert_allclose(got.machine.local_read_bw, want.machine.local_read_bw, rtol=1e-3)
    assert got.machine.topology.routes == want.machine.topology.routes
    assert got.diagnostics == want.diagnostics


def test_fit_from_a_given_init_and_huber_loss_match_reference():
    """``init`` and ``huber_delta`` pass through: 30 steps of the Huber
    loss from the reference's seed, on E7-8860 v3's noisy sweep."""
    name = "E7-8860v3-8s16c"
    tmpl, ptmpl = _templates(name)
    samples = _ref_sweep(name, 0.02, 2)
    init = ref_cal.seed_parameters(tmpl, samples)
    want = ref_cal.fit_machine(tmpl, samples, steps=30, init=init, huber_delta=0.05)
    got = port_cal.fit_machine(ptmpl, _port_samples(samples), steps=30,
                               init=_port_params(init), huber_delta=0.05)
    assert_close(got.loss_history[:20], want.loss_history[:20], rtol=1e-4, what="history")
    np.testing.assert_allclose(got.machine.topology.link_bw, want.machine.topology.link_bw,
                               rtol=1e-3)
    assert got.machine.hop_attenuation == pytest.approx(want.machine.hop_attenuation, rel=1e-3)


@pytest.mark.parametrize("name", ["E7-8860v3-8s16c", "E5-2699v3-18c-snc2"])
def test_roundtrip_gates_on_the_port(name):
    """The port alone, as ``benchmarks/calibration_roundtrip.py`` runs the
    reference: a blind 200-step fit recovers every link within 5%, and
    the refit machine's noisy sweep median (Swim, CG, EP, NPO over 64
    placements, one generator seed for both machines) stays within
    0.25 pp of the truth's."""
    _, pm = _machines(name)
    res = port_cal.fit_from_simulated(pm, steps=200, device=CPU)
    assert float(port_cal.link_relative_errors(res.machine, pm).max()) < 0.05
    local = port_cal.local_bw_relative_errors(res.machine, pm)
    assert float(local["read"].max()) < 0.05 and float(local["write"].max()) < 0.05
    assert res.seed_loss >= 0 and np.isfinite(res.loss_history).all()
    n = 2 * pm.cores_per_node
    n -= n % pm.n_nodes
    placements = placement_array(pm, n, max_placements=64)
    wls = [benchmark_workload(b, n, device=CPU) for b in ("Swim", "CG", "EP", "NPO")]
    medians = [
        float(np.median(to_np(evaluate_batch(
            m, wls, placements, noise_std=0.02, generator=default_generator(CPU, 0),
        ).errors_combined)) * 100.0)
        for m in (pm, res.machine)
    ]
    assert abs(medians[1] - medians[0]) <= 0.25, medians


# ---------------------------------------------------------------------------
# Receipts and diagnostics
# ---------------------------------------------------------------------------


def _poison(samples, lib):
    """Plant the three corruption modes: row 0 non-finite, row 1 a
    negative counter, row 2 a zero elapsed time."""
    lr = np.array(samples.local_read, np.float32)
    lr[0] = np.nan
    rr = np.array(samples.remote_read, np.float32)
    rr[1, 0] = -1.0
    el = np.array(samples.elapsed, np.float32)
    el[2] = 0.0
    return samples._replace(local_read=lib(lr), remote_read=lib(rr), elapsed=lib(el))


def test_clean_concat_take_receipts_equal_reference():
    name = "E5-2630v3-8c"
    want_samples = _ref_sweep(name)
    got_samples = _port_samples(want_samples)
    want_kept, want_diag = ref_cal.clean_samples(_poison(want_samples, jnp.asarray))
    got_kept, got_diag = port_cal.clean_samples(_poison(got_samples, torch.as_tensor))
    assert tuple(got_diag) == tuple(want_diag)
    assert got_diag.reject_rate == want_diag.reject_rate
    for g, w in zip(got_kept[1:], want_kept[1:]):
        np.testing.assert_array_equal(to_np(g), np.asarray(w))
    same, diag = port_cal.clean_samples(got_samples)
    assert same is got_samples and diag.n_rejected == 0
    all_bad = got_samples._replace(elapsed=torch.zeros(got_samples.n_samples))
    with pytest.raises(ValueError, match="rejected"):
        port_cal.clean_samples(all_bad)
    empty, ediag = port_cal.clean_samples(all_bad, on_empty="ignore")
    assert empty.n_samples == 0 and ediag.n_rejected == got_samples.n_samples

    idx = [5, 0, 9, 3]
    for g, w in zip(port_cal.take_samples(got_samples, idx)[1:],
                    ref_cal.take_samples(want_samples, idx)[1:]):
        np.testing.assert_array_equal(to_np(g), np.asarray(w))
    halves = [port_cal.take_samples(got_samples, np.arange(got_samples.n_samples) < 10),
              port_cal.take_samples(got_samples, np.arange(got_samples.n_samples) >= 10)]
    joined = port_cal.concat_samples(halves)
    for g, w in zip(joined[1:], got_samples[1:]):
        np.testing.assert_array_equal(to_np(g), to_np(w))
    other = _port_samples(_ref_sweep("E7-4830v3-4s12c"))
    with pytest.raises(ValueError, match="node count"):
        port_cal.concat_samples([got_samples, other])
    with pytest.raises(ValueError):
        port_cal.concat_samples([])


def test_samples_from_counters_matches_collect_sweep():
    """A counter trace (one CounterSample per run) packages to the
    reference's samples, and a placement order mismatch fails loudly."""
    name = "E5-2630v3-8c"
    m, pm = _machines(name)
    probes = port_cal.probe_suite(pm, device=CPU)
    counters = [simulate(pm, wl, torch.as_tensor(p)).sample for wl, p in probes]
    placements = np.stack([p for _, p in probes])
    got = port_cal.samples_from_counters([w for w, _ in probes], placements, counters)
    want = _ref_sweep(name)
    for f in ("local_read", "remote_read", "local_write", "remote_write", "instructions"):
        assert_rel_to_scale(getattr(got, f), getattr(want, f), rtol=1e-5, what=f)
    np.testing.assert_array_equal(to_np(got.elapsed), np.asarray(want.elapsed))
    with pytest.raises(ValueError, match="recorded placement"):
        port_cal.samples_from_counters([w for w, _ in probes], placements[::-1], counters)
    with pytest.raises(ValueError):
        port_cal.samples_from_counters([w for w, _ in probes], placements, counters[:-1])


@pytest.mark.parametrize("name", ["E7-4830v3-4s12c", "E5-2699v3-18c-snc2"])
def test_counter_errors_and_guard_metrics_match_reference(name):
    """``counter_errors_pct`` of a drifted spec against a noisy sweep at
    rel 1e-5 (float64 on both sides over float32 simulations); the
    sweep median orders truth below drift, as the swap guard needs."""
    m, pm = _machines(name)
    samples = _ref_sweep(name, 0.02, 4)
    psamples = _port_samples(samples)
    for factor in (1.0, 0.7):
        spec = m._replace(remote_read_bw=m.remote_read_bw * factor,
                          remote_write_bw=m.remote_write_bw * factor)
        want = ref_cal.counter_errors_pct(spec, samples)
        got = port_cal.counter_errors_pct(port_machine(spec), psamples)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert (port_cal.sweep_median_error_pct(pm, psamples)
            < port_cal.sweep_median_error_pct(
                pm._replace(remote_read_bw=pm.remote_read_bw * 0.7), psamples))
    with pytest.raises(ValueError):
        port_cal.counter_errors_pct(port_machine(ref.E5_2630_V3), psamples)


def test_blind_template_and_fitted_machine_match_reference():
    name = "E7-8860v3-8s16c"
    m, pm = _machines(name)
    assert port_cal.blind_template(pm) == port_machine(ref_cal.blind_template(m))
    tmpl, ptmpl = _templates(name)
    groups = ref_cal.link_groups(tmpl.topology)
    params = ref_cal.seed_parameters(tmpl, _ref_sweep(name), groups)
    want = ref_cal.fitted_machine(tmpl, groups, params)
    got = port_cal.fitted_machine(ptmpl, port.link_groups(ptmpl.topology), _port_params(params))
    assert got.topology.routes == want.topology.routes
    np.testing.assert_allclose(got.topology.link_bw, want.topology.link_bw, rtol=1e-6)
    np.testing.assert_allclose(got.local_read_bw, want.local_read_bw, rtol=1e-6)
    assert got.hop_attenuation == pytest.approx(want.hop_attenuation, rel=1e-6)
    np.testing.assert_allclose(port_cal.link_relative_errors(got, pm),
                               ref_cal.link_relative_errors(want, m), rtol=1e-6, atol=1e-9)

