"""The port's progressive-fill simulator against the reference on every
preset: the grouped ``simulate``, the per-thread ``simulate_reference``
and the batched ``simulate_grouped_batch``, on the Page-rank violator
(two thread classes) over a seeded placement sample.  Measurement noise
is drawn by JAX and handed to the port.

Tolerances: port vs reference rel 1e-5 (float32 on both sides, sums in
another order); the port's grouped path vs its own per-thread path
1e-6, as the reference pins its own pair."""

import functools

import jax
import numpy as np
import pytest
import torch
from _torch_parity import (
    CPU,
    assert_close,
    assert_rel_to_scale,
    jax_counter_noise,
    port_machine,
    port_workload,
    to_np,
)

import repro.core.numa as ref
import repro.core.numa.evaluate as ref_eval
import repro.core.numa.simulator as ref_sim
import repro_torch.core.numa as port
import repro_torch.core.numa.simulator as port_sim
from repro.core.numa.benchmarks import benchmark_workload as ref_benchmark
from repro.core.numa.workload import Workload as RefWorkload

THREADS = {
    "E5-2630v3-8c": 8,
    "E5-2630v3-8c-throttled": 8,
    "E5-2630v3-8c-mixed-dimm": 12,
    "E5-2699v3-18c": 16,
    "E5-2699v3-18c-snc2": 16,
    "E7-4830v3-4s12c": 24,
    "E7-8860v3-8s16c": 32,
}
NOISE_STD = 0.03
BACKGROUND = 2e8
N_PLACEMENTS = 6


@functools.partial(jax.jit, static_argnums=(0, 2), static_argnames=("multipath", "bank"))
def _ref_all(machine, arrays, thread_classes, placements, support, slab_id, keys,
             multipath=False, bank=None):
    """Every reference solver on the placement batch, in one trace."""
    wl = RefWorkload("w", *arrays)
    kw = dict(multipath=multipath, bank_assignment=bank)
    noisy = dict(noise_std=NOISE_STD, background_bw=BACKGROUND)

    def grouped(p, k):
        return ref_sim.simulate(machine, wl, p, key=k, thread_classes=thread_classes,
                                **noisy, **kw)

    def per_thread(p, k):
        return ref_sim.simulate_reference(machine, wl, p, key=k, **noisy, **kw)

    batch = ref_sim.simulate_grouped_batch(
        machine, wl, placements, thread_classes=thread_classes, support=support,
        slab_id=slab_id, **kw,
    )
    return jax.vmap(grouped)(placements, keys), jax.vmap(per_thread)(placements, keys), batch


def _case(name, *, seed=0, multipath=False, bank=None):
    machine = ref.MACHINES[name]
    n = THREADS[name]
    wl = ref_benchmark("Page rank", n)
    placements = np.array(
        ref_eval.enumerate_placements(machine, n, max_placements=N_PLACEMENTS, seed=seed)
    )
    support, slab_id = ref_sim.support_patterns(placements)
    keys = jax.random.split(jax.random.PRNGKey(seed), len(placements))
    want = _ref_all(machine, tuple(wl[1:]), ref.thread_class_starts(wl), placements,
                    support, slab_id, keys, multipath=multipath, bank=bank)
    return machine, wl, placements, keys, want


def _assert_result_close(got, want, i, rtol, what):
    assert_close(got.rates, want.rates[i], rtol=rtol, what=f"{what} rates")
    assert_rel_to_scale(got.read_flows, want.read_flows[i], rtol=rtol, what=f"{what} read")
    assert_rel_to_scale(got.write_flows, want.write_flows[i], rtol=rtol, what=f"{what} write")
    assert_close(got.throughput, want.throughput[i], rtol=rtol, what=f"{what} throughput")
    for f in ("local_read", "remote_read", "local_write", "remote_write", "instructions"):
        assert_rel_to_scale(getattr(got.sample, f), getattr(want.sample, f)[i],
                            rtol=rtol, what=f"{what} {f}")


def _assert_batch_close(got, want, rtol, what):
    for f in ("read_flows", "write_flows", "instructions"):
        for i in range(got.read_flows.shape[0]):
            assert_rel_to_scale(getattr(got, f)[i], getattr(want, f)[i],
                                rtol=rtol, what=f"{what} {f}[{i}]")
    assert_close(got.throughput, want.throughput, rtol=rtol, what=f"{what} throughput")
    assert_close(got.group_rates, want.group_rates, rtol=rtol, what=f"{what} group rates")


@pytest.mark.parametrize("name", sorted(THREADS))
def test_solvers_match_reference(name):
    machine, wl, placements, keys, (want_g, want_r, want_b) = _case(name)
    pm, pwl = port_machine(machine), port_workload(wl)
    s = machine.n_nodes
    for i, p in enumerate(placements):
        noise = jax_counter_noise(keys[i], s)
        kw = dict(noise_std=NOISE_STD, background_bw=BACKGROUND, noise=noise)
        got_g = port.simulate(pm, pwl, torch.as_tensor(p), **kw)
        got_r = port.simulate_reference(pm, pwl, torch.as_tensor(p), **kw)
        _assert_result_close(got_g, want_g, i, 1e-5, f"simulate {p}")
        _assert_result_close(got_r, want_r, i, 1e-5, f"simulate_reference {p}")
    got_b = port.simulate_grouped_batch(
        pm, pwl, torch.as_tensor(placements), thread_classes=port.thread_class_starts(pwl)
    )
    _assert_batch_close(got_b, want_b, 1e-5, "grouped batch")


@pytest.mark.parametrize(
    "name,multipath,bank",
    [
        ("E7-8860v3-8s16c", True, (1, 0, 3, 2, 5, 4, 7, 6)),
        ("E5-2699v3-18c-snc2", False, (0, 0, 2, 2)),
    ],
)
def test_multipath_and_bank_assignment_match_reference(name, multipath, bank):
    machine, wl, placements, keys, (want_g, want_r, want_b) = _case(
        name, seed=1, multipath=multipath, bank=bank
    )
    pm, pwl = port_machine(machine), port_workload(wl)
    kw = dict(multipath=multipath, bank_assignment=bank)
    for i, p in enumerate(placements[:3]):
        noise = jax_counter_noise(keys[i], machine.n_nodes)
        got = port.simulate(pm, pwl, torch.as_tensor(p), noise_std=NOISE_STD,
                            background_bw=BACKGROUND, noise=noise, **kw)
        _assert_result_close(got, want_g, i, 1e-5, f"simulate {p}")
        got = port.simulate_reference(pm, pwl, torch.as_tensor(p), noise_std=NOISE_STD,
                                      background_bw=BACKGROUND, noise=noise, **kw)
        _assert_result_close(got, want_r, i, 1e-5, f"simulate_reference {p}")
    got_b = port.simulate_grouped_batch(
        pm, pwl, torch.as_tensor(placements), thread_classes=port.thread_class_starts(pwl), **kw
    )
    _assert_batch_close(got_b, want_b, 1e-5, "grouped batch")


@pytest.mark.parametrize("name", sorted(THREADS))
def test_grouped_equals_per_thread_in_port(name):
    """The port's group-collapsed solver reproduces its per-thread solver
    (<= 1e-6), for the violator and a homogeneous suite workload."""
    pm = port.MACHINES[name]
    n = THREADS[name]
    placements = port_sim_placements(pm, n)
    for bench in ("Page rank", "CG"):
        pwl = port_benchmark(bench, n)
        for p in placements:
            g = port.simulate(pm, pwl, p)
            r = port.simulate_reference(pm, pwl, p)
            assert_close(g.rates, r.rates, rtol=1e-6, what=f"{bench} {p} rates")
            assert_rel_to_scale(g.read_flows, r.read_flows, rtol=1e-6, what="read")
            assert_rel_to_scale(g.write_flows, r.write_flows, rtol=1e-6, what="write")
            assert_rel_to_scale(g.sample.instructions, r.sample.instructions, rtol=1e-6)
        batch = port.simulate_grouped_batch(
            pm, pwl, placements, thread_classes=port.thread_class_starts(pwl)
        )
        for i, p in enumerate(placements):
            r = port.simulate_reference(pm, pwl, p)
            assert_rel_to_scale(batch.read_flows[i], r.read_flows, rtol=1e-6, what="batch read")
            assert_rel_to_scale(batch.write_flows[i], r.write_flows, rtol=1e-6)
            assert_close(batch.throughput[i], r.throughput, rtol=1e-6)


def port_sim_placements(pm, n):
    from repro_torch.core.numa.evaluate import enumerate_placements

    return enumerate_placements(pm, n, max_placements=N_PLACEMENTS, seed=2, device=CPU)


def port_benchmark(name, n):
    from repro_torch.core.numa.benchmarks import benchmark_workload

    return benchmark_workload(name, n, device=CPU)


def test_workload_batch_axis_equals_separate_calls():
    """A leading workload axis (the reference's vmap over benchmarks)
    gives each workload's separate result."""
    from repro_torch.core.numa.evaluate import _stack_workloads

    pm = port.E7_8860_V3
    wls = [port_benchmark(b, 32) for b in ("Swim", "EP", "Page rank")]
    classes = port.thread_class_starts(wls)
    placements = port_sim_placements(pm, 32)
    stacked = port_sim.simulate_grouped_batch(
        pm, _stack_workloads(wls), placements, thread_classes=classes
    )
    for b, wl in enumerate(wls):
        one = port_sim.simulate_grouped_batch(pm, wl, placements, thread_classes=classes)
        for f in one._fields:
            np.testing.assert_allclose(to_np(getattr(stacked, f)[b]), to_np(getattr(one, f)),
                                       rtol=1e-6, atol=0, err_msg=f)


@pytest.mark.parametrize("bench,n", [("Page rank", 16), ("CG", 8), ("Swim", 24)])
def test_interleaved_fractions_match_reference(bench, n):
    """``read_interleaved`` / ``write_interleaved``, the residual class,
    on the reference's workload carried over value for value and on the
    port's own ``benchmark_workload``."""
    ref_wl = ref_benchmark(bench, n)
    for wl in (port_workload(ref_wl), port_benchmark(bench, n)):
        for d in ("read", "write"):
            got, want = getattr(wl, f"{d}_interleaved")(), getattr(ref_wl, f"{d}_interleaved")()
            assert got.dtype == torch.float32
            assert_close(got, want, rtol=1e-6, atol=1e-7, what=f"{bench} {d}")


def test_noise_from_generator_is_seeded():
    """Without a noise tensor a noisy call draws from the generator it is
    given: the same seed gives the same counters, another seed others."""
    pm, wl = port.E5_2630_V3, port_benchmark("CG", 8)
    p = torch.tensor([5, 3], dtype=torch.int32)

    def run(seed):
        gen = port_sim.default_generator(CPU, seed)
        return port.simulate(pm, wl, p, noise_std=0.05, generator=gen).sample.local_read

    assert torch.equal(run(3), run(3))
    assert not torch.equal(run(3), run(4))


def test_profile_placements_match_reference():
    for name, n in THREADS.items():
        if n % ref.MACHINES[name].n_nodes:
            continue
        want_s = np.asarray(ref_sim.symmetric_placement(ref.MACHINES[name], n))
        want_a = np.asarray(ref_sim.asymmetric_placement(ref.MACHINES[name], n))
        np.testing.assert_array_equal(
            to_np(port.symmetric_placement(port.MACHINES[name], n, device=CPU)), want_s
        )
        np.testing.assert_array_equal(
            to_np(port.asymmetric_placement(port.MACHINES[name], n, device=CPU)), want_a
        )
    for n in (1, 2, 15, 16):
        np.testing.assert_array_equal(
            to_np(port.asymmetric_placement(port.E5_2630_V3, n, device=CPU)),
            np.asarray(ref_sim.asymmetric_placement(ref.E5_2630_V3, n)),
        )


def test_padding_and_support_patterns_match_reference():
    rows = np.array([[3, 0, 1], [0, 0, 4], [2, 2, 0], [1, 0, 3], [0, 0, 4]], np.int32)
    for n in (0, 1, 8, 9, 1469):
        assert port_sim.bucket_size(n) == ref_sim.bucket_size(n)
    np.testing.assert_array_equal(port_sim.pad_rows(rows), ref_sim.pad_rows(rows))
    for got, want in zip(port_sim.support_patterns(rows), ref_sim.support_patterns(rows)):
        np.testing.assert_array_equal(got, want)
    got = port_sim.support_patterns(torch.as_tensor(rows))
    np.testing.assert_array_equal(got[1], ref_sim.support_patterns(rows)[1])


@pytest.mark.parametrize("solver", ["simulate", "simulate_reference"])
@pytest.mark.parametrize(
    "name,n,placement",
    [("E5-2630v3-8c", 16, (8, 8)), ("E7-8860v3-8s16c", 32, (8, 0, 4, 4, 0, 8, 4, 4))],
)
def test_caps_gradient_matches_jax_grad(solver, name, n, placement):
    """Throughput is differentiable through the capacity vector (the
    hook calibration fits through): autograd's gradient equals
    ``jax.grad``'s on a saturated placement."""
    machine = ref.MACHINES[name]
    wl = ref_benchmark("Swim", n)
    p = np.asarray(placement, np.int32)

    @jax.jit
    def ref_grad(arrays, caps):
        def throughput(c):
            w = RefWorkload("w", *arrays)
            return getattr(ref_sim, solver)(machine, w, p, caps=c).throughput
        return jax.grad(throughput)(caps)

    want = np.asarray(ref_grad(tuple(wl[1:]), ref_sim.machine_caps(machine)))
    caps = port_sim.machine_caps(port_machine(machine), CPU).clone().requires_grad_(True)
    getattr(port_sim, solver)(
        port_machine(machine), port_workload(wl), torch.as_tensor(p), caps=caps
    ).throughput.backward()
    assert np.count_nonzero(want) > 0  # a capacity binds
    assert_rel_to_scale(caps.grad, want, rtol=1e-5, what="d throughput / d caps")
