"""The port's batched fit + predict sweep against the reference:
``evaluate_batch`` errors, bandwidth totals, misfit scores and fitted
signatures on the E5-2630 v3 sweep and a 64-placement subsample of the
E7-4830 v3 sweep, noise-free and on JAX's noise draws; the suite and
single-workload evaluations; the signature and memo caches.

Tolerances: prediction errors are fractions of run bandwidth and
noise-free ones are differences of nearly equal float32 sums, so they
are compared absolutely (1e-6, i.e. 1e-4 percentage points); bandwidth
totals rel 1e-5; signature fractions rel 1e-5 with a 1e-6 floor."""

import functools

import jax
import numpy as np
import pytest
import torch
from _torch_parity import CPU, assert_close, port_machine, port_workload, to_np

import repro.core.numa as ref
import repro.core.numa.evaluate as ref_eval
import repro_torch.core.numa as port
import repro_torch.core.numa.evaluate as port_eval
from repro.core.numa.benchmarks import benchmark_workload as ref_benchmark
from repro_torch.core.numa.simulator import CounterNoise

SWEEP_BENCHMARKS = ("Swim", "CG", "EP", "NPO")


def _sweep_noise(keys, n_placements: int, s: int) -> port_eval.SweepNoise:
    """The draws the reference's ``evaluate_batch(keys=keys)`` makes, as
    the port's :class:`SweepNoise`."""
    prof, meas_r, meas_w = [], [], []
    for key in keys:
        k_prof, k_meas = jax.random.split(key)
        runs = []
        for k in jax.random.split(k_prof):
            k1, k2, k3 = jax.random.split(k, 3)
            runs.append((jax.random.normal(k1, (s, s)), jax.random.normal(k2, (s, s)),
                         jax.random.normal(k3, (s,))))
        prof.append(runs)
        kr, kw = jax.random.split(k_meas)
        meas_r.append(jax.random.normal(kr, (n_placements, s, s)))
        meas_w.append(jax.random.normal(kw, (n_placements, s, s)))

    def t(a):
        return torch.as_tensor(np.array(a))

    profile = CounterNoise(*(t([[run[f] for run in runs] for runs in prof]) for f in range(3)))
    return port_eval.SweepNoise(profile, t(meas_r), t(meas_w))


@functools.lru_cache(maxsize=None)
def _case(name, n, max_p, benchmarks, noise_std):
    machine = ref.MACHINES[name]
    placements = ref_eval.enumerate_placements(machine, n, max_placements=max_p, seed=0)
    wls = [ref_benchmark(b, n) for b in benchmarks]
    keys = jax.numpy.stack([jax.random.fold_in(jax.random.PRNGKey(0), i)
                            for i in range(len(wls))])
    want = ref_eval.evaluate_batch(machine, wls, placements, noise_std=noise_std, keys=keys)
    pwls = [port_workload(w) for w in wls]
    noise = (_sweep_noise(keys, placements.shape[0], machine.n_nodes)
             if noise_std else None)
    got = port_eval.evaluate_batch(
        port_machine(machine), pwls, torch.as_tensor(np.array(placements)),
        noise_std=noise_std, noise=noise,
    )
    return want, got


def _assert_batch_close(got, want):
    np.testing.assert_array_equal(to_np(got.placements), np.asarray(want.placements))
    for f in ("errors_read", "errors_write", "errors_combined"):
        assert_close(getattr(got, f), getattr(want, f), rtol=0.0, atol=1e-6, what=f)
    assert_close(got.total_bw, want.total_bw, rtol=1e-5, what="total_bw")
    assert_close(got.misfit, want.misfit, rtol=1e-5, atol=1e-6, what="misfit")
    for which in ("signatures", "combined_signatures"):
        for d in ("read", "write"):
            g, w = getattr(getattr(got, which), d), getattr(getattr(want, which), d)
            np.testing.assert_array_equal(to_np(g.static_socket), np.asarray(w.static_socket))
            for f in ("static_fraction", "local_fraction", "per_thread_fraction"):
                assert_close(getattr(g, f), getattr(w, f), rtol=1e-5, atol=1e-6,
                             what=f"{which}.{d}.{f}")


@pytest.mark.parametrize(
    "name,n,max_p,benchmarks",
    [
        ("E5-2630v3-8c", 8, None, ("BT", "EP", "NPO", "Equake", "Page rank")),
        ("E7-4830v3-4s12c", 24, 64, SWEEP_BENCHMARKS),
    ],
)
def test_noise_free_sweep_matches_reference(name, n, max_p, benchmarks):
    want, got = _case(name, n, max_p, benchmarks, 0.0)
    _assert_batch_close(got, want)


def test_noisy_sweep_on_reference_draws_matches_reference():
    """With the reference's own noise draws handed in, the noisy sweep
    (profiling fit included) reproduces the reference's."""
    want, got = _case("E7-4830v3-4s12c", 24, 64, SWEEP_BENCHMARKS, 0.02)
    _assert_batch_close(got, want)
    got_med = float(np.median(to_np(got.errors_combined)))
    want_med = float(np.median(np.asarray(want.errors_combined)))
    assert abs(got_med - want_med) <= 1e-6


def test_routed_sweep_subsample_matches_reference():
    want, got = _case("E5-2699v3-18c-snc2", 16, 48, ("CG", "Page rank"), 0.0)
    _assert_batch_close(got, want)


def test_output_rows_follow_caller_order():
    """Bucketing by support is internal: a permuted placement batch gives
    the same rows permuted."""
    pm = port.E7_4830_V3
    wls = [port_eval.benchmark_workload(b, 24, device=CPU) for b in ("CG", "EP")]
    placements = port_eval.enumerate_placements(pm, 24, max_placements=40, seed=3, device=CPU)
    perm = torch.randperm(40, generator=torch.Generator().manual_seed(0))
    a = port_eval.evaluate_batch(pm, wls, placements)
    b = port_eval.evaluate_batch(pm, wls, placements[perm].clone())
    np.testing.assert_allclose(to_np(b.errors_combined), to_np(a.errors_combined)[:, to_np(perm)],
                               rtol=0, atol=1e-7)
    np.testing.assert_allclose(to_np(b.total_bw), to_np(a.total_bw)[:, to_np(perm)], rtol=1e-6)


def test_fitted_signatures_agree_with_batch_and_cache():
    pm = port.E5_2699_V3_SNC2
    wls = [port_eval.benchmark_workload(b, 16, device=CPU) for b in ("Swim", "Page rank")]
    placements = port_eval.enumerate_placements(pm, 16, max_placements=16, device=CPU)
    batch = port_eval.evaluate_batch(pm, wls, placements)
    fits = port_eval.fitted_signatures(pm, wls)
    for i, (sig, csig, misfit) in enumerate(fits):
        for d in ("read", "write"):
            for f in sig.read._fields:
                assert torch.equal(getattr(getattr(sig, d), f),
                                   getattr(getattr(batch.signatures, d), f)[i])
        assert torch.equal(misfit, batch.misfit[i])
    # a second call is answered from the cache: the same objects
    again = port_eval.fitted_signatures(pm, wls)
    assert all(a[0] is b[0] for a, b in zip(fits, again))
    # a noisy fit is keyed on its draws and differs from the noise-free one
    noisy = port_eval.fitted_signatures(
        pm, wls, noise_std=0.05, generator=torch.Generator().manual_seed(1)
    )
    assert not torch.equal(noisy[0][0].read.local_fraction, fits[0][0].read.local_fraction)


def test_signature_cache_is_bounded(monkeypatch):
    monkeypatch.setattr(port_eval, "_SIG_CACHE", {})
    monkeypatch.setattr(port_eval, "_SIG_CACHE_MAX", 3)
    pm = port.E5_2630_V3
    for b in ("BT", "CG", "EP", "FT", "IS"):
        port_eval.fitted_signatures(pm, [port_eval.benchmark_workload(b, 8, device=CPU)])
    assert len(port_eval._SIG_CACHE) == 3


def test_memo_caches_are_bounded(monkeypatch):
    monkeypatch.setattr(port_eval, "_STACK_CACHE", {})
    monkeypatch.setattr(port_eval, "_SUPPORT_CACHE", {})
    monkeypatch.setattr(port_eval, "_MEMO_CACHE_MAX", 2)
    pm = port.E5_2630_V3
    for seed in range(4):
        wls = [port_eval.benchmark_workload("CG", 8, device=CPU)]
        placements = port_eval.enumerate_placements(pm, 8, device=CPU)
        port_eval.evaluate_batch(pm, wls, placements + 0 * seed)
    assert len(port_eval._STACK_CACHE) <= 2
    assert len(port_eval._SUPPORT_CACHE) <= 2


def test_suite_and_accuracy_evaluations_match_reference():
    want = ref_eval.evaluate_suite(ref.E5_2630_V3)
    got = port_eval.evaluate_suite(port.E5_2630_V3, device=CPU)
    assert got.names == want.names
    np.testing.assert_allclose(got.all_errors, want.all_errors, rtol=0, atol=1e-4)
    assert abs(got.median_error_pct - want.median_error_pct) <= 1e-4
    wl = ref_benchmark("Equake", 8)
    want_a = ref_eval.evaluate_accuracy(ref.E5_2630_V3, wl)
    got_a = port_eval.evaluate_accuracy(port.E5_2630_V3, port_workload(wl))
    assert_close(got_a.errors_combined, want_a.errors_combined, rtol=0, atol=1e-6)
    assert_close(got_a.total_bw, want_a.total_bw, rtol=1e-5)


def test_noisy_sweep_from_generator_is_seeded():
    pm = port.E7_4830_V3
    wls = [port_eval.benchmark_workload(b, 24, device=CPU) for b in SWEEP_BENCHMARKS]
    placements = port_eval.enumerate_placements(pm, 24, max_placements=32, device=CPU)

    def run(seed):
        return port_eval.evaluate_batch(
            pm, wls, placements, noise_std=0.02,
            generator=torch.Generator().manual_seed(seed),
        ).errors_combined

    assert torch.equal(run(0), run(0))
    assert not torch.equal(run(0), run(1))


def _stability_noise(names, s_a, s_b, seed=0):
    """The profiling draws of the reference's ``evaluate_stability``:
    benchmark ``i`` fits on machine A with ``split(fold_in(key, i))[0]``
    and on machine B with ``[1]``."""
    from _torch_parity import jax_profile_noise

    key = jax.random.PRNGKey(seed)
    runs = {"a": [], "b": []}
    for i in range(len(names)):
        ka, kb = jax.random.split(jax.random.fold_in(key, i))
        runs["a"].append(jax_profile_noise(ka, s_a))
        runs["b"].append(jax_profile_noise(kb, s_b))

    def stack(pairs):
        return CounterNoise(*(torch.stack([torch.stack([sym[f], asym[f]]) for sym, asym in pairs])
                              for f in range(3)))

    return stack(runs["a"]), stack(runs["b"])


@pytest.mark.parametrize("noise_std", [0.0, 0.03])
def test_stability_matches_reference(noise_std):
    """Signature moves between the paper's two machines (Figures 13-15):
    noise-free, and with the reference's profiling draws handed in.  The
    changes are percentages of reallocated bandwidth: rel 1e-5 with a
    1e-4 pp floor for near-zero moves."""
    ma, mb = ref.E5_2630_V3, ref.E5_2699_V3
    want = ref_eval.evaluate_stability(ma, mb, noise_std=noise_std)
    noise = (_stability_noise(want.names, ma.n_nodes, mb.n_nodes)
             if noise_std else None)
    got = port_eval.evaluate_stability(port.E5_2630_V3, port.E5_2699_V3,
                                       noise_std=noise_std, noise=noise, device=CPU)
    assert got.names == want.names
    for field in ("read_change", "write_change", "combined_change"):
        g, w = getattr(got, field), getattr(want, field)
        np.testing.assert_allclose([g[n] for n in want.names], [w[n] for n in want.names],
                                   rtol=1e-5, atol=1e-4, err_msg=field)
    assert got.median_combined_pct == pytest.approx(want.median_combined_pct, rel=1e-5, abs=1e-4)
    assert got.mean_combined_pct == pytest.approx(want.mean_combined_pct, rel=1e-5, abs=1e-4)


def test_stability_noise_from_generator_is_seeded():
    def run(seed):
        return port_eval.evaluate_stability(
            port.E5_2630_V3, port.E5_2699_V3, noise_std=0.03, seed=seed,
            include_violators=False, device=CPU,
        ).combined_change

    assert run(0) == run(0) and run(0) != run(1)


def test_suite_matches_reference():
    from repro.core.numa.benchmarks import suite as ref_suite
    from repro_torch.core.numa.benchmarks import suite

    for include in (True, False):
        got = list(suite(12, include, device=CPU))
        want = list(ref_suite(12, include))
        assert [w.name for w in got] == [w.name for w in want]
        for g, w in zip(got, want):
            for f, a in zip(g._fields[1:], g[1:]):
                np.testing.assert_array_equal(to_np(a), np.asarray(getattr(w, f)), err_msg=f)
