"""The port's signature engine against the reference: the 2-run fit,
counter prediction, misfit detection and signature distance on samples
the reference simulator produced, and the quickstart pipeline twin.

Tolerance: rel 1e-5 (float32 in both; the two frameworks may sum in
another order), with an absolute floor of 1e-6 on fractions."""

import functools

import jax
import numpy as np
import pytest
import torch
from _torch_parity import (
    CPU,
    assert_close,
    assert_rel_to_scale,
    jax_profile_noise,
    port_machine,
    port_sample,
    port_signature,
    port_workload,
    ref_fit_signature,
    ref_profile_pair,
    to_np,
)

import repro.core.bwsig as ref_bw
import repro.core.numa as ref
import repro_torch.core.bwsig as port_bw
import repro_torch.core.numa as port
from repro.core.numa.benchmarks import benchmark_workload as ref_benchmark

CASES = [
    ("E5-2630v3-8c-throttled", "CG", 8),
    ("E7-4830v3-4s12c", "NPO", 24),
    ("E7-8860v3-8s16c", "Applu", 32),
    ("E5-2699v3-18c-snc2", "Page rank", 16),
]


@functools.lru_cache(maxsize=None)
def _case(name, bench, n):
    """The reference's noisy profiling pair of one case, shared by the
    tests below."""
    return ref_profile_pair(ref.MACHINES[name], ref_benchmark(bench, n))


def _assert_sig_close(got, want, what):
    for d in ("read", "write"):
        g, w = getattr(got, d), getattr(want, d)
        np.testing.assert_array_equal(to_np(g.static_socket), np.asarray(w.static_socket))
        for f in ("static_fraction", "local_fraction", "per_thread_fraction"):
            assert_close(getattr(g, f), getattr(w, f), rtol=1e-5, atol=1e-6,
                         what=f"{what} {d}.{f}")


@pytest.mark.parametrize("name,bench,n", CASES)
def test_fit_on_reference_samples(name, bench, n):
    sym, asym = _case(name, bench, n)
    psym, pasym = port_sample(sym), port_sample(asym)
    for combined in (False, True):
        want = ref_fit_signature(sym, asym, combined=combined)
        got = port_bw.fit_signature(psym, pasym, combined=combined)
        _assert_sig_close(got, want, f"{name}/{bench} combined={combined}")
    for direction in ("read", "write"):
        want = ref_bw.normalize_sample(sym, direction)
        got = port_bw.normalize_sample(psym, direction)
        for k in ("local", "remote", "source_weights"):
            assert_close(got[k], want[k], rtol=1e-5, what=f"normalize {direction} {k}")


@pytest.mark.parametrize("name,bench,n", CASES)
def test_predict_with_reference_signature(name, bench, n):
    machine = ref.MACHINES[name]
    sym, asym = _case(name, bench, n)
    sig = ref_fit_signature(sym, asym)
    psig = port_signature(sig)
    rng = np.random.default_rng(1)
    s = machine.n_nodes
    placement = rng.multinomial(n, np.ones(s) / s).astype(np.int32)
    demand = rng.uniform(1e9, 5e9, s).astype(np.float32)
    for d in ("read", "write"):
        ref_sig, port_sig = getattr(sig, d), getattr(psig, d)
        want_m = ref_bw.placement_matrix(ref_sig, placement)
        got_m = port_bw.placement_matrix(port_sig, torch.as_tensor(placement))
        assert_close(got_m, want_m, rtol=1e-5, atol=1e-7, what=f"{d} placement matrix")
        want_f = ref_bw.predict_flows(ref_sig, demand, placement)
        got_f = port_bw.predict_flows(port_sig, torch.as_tensor(demand), torch.as_tensor(placement))
        assert_rel_to_scale(got_f, want_f, rtol=1e-5, what=f"{d} flows")
        want_l, want_r = ref_bw.predict_counters(ref_sig, demand, placement)
        got_l, got_r = port_bw.predict_counters(
            port_sig, torch.as_tensor(demand), torch.as_tensor(placement)
        )
        assert_rel_to_scale(got_l, want_l, rtol=1e-5, what=f"{d} local")
        assert_rel_to_scale(got_r, want_r, rtol=1e-5, what=f"{d} remote")


@pytest.mark.parametrize("name,bench,n", CASES)
def test_misfit_and_distance(name, bench, n):
    machine = ref.MACHINES[name]
    sym, asym = _case(name, bench, n)
    psym = port_sample(sym)
    for d in ("read", "write"):
        assert_close(port_bw.misfit_score(psym, d), ref_bw.misfit_score(sym, d),
                     rtol=1e-5, atol=1e-6, what=f"misfit {d}")
    a = ref_fit_signature(sym, asym)
    b = ref_fit_signature(sym, asym, combined=True)
    s = machine.n_nodes
    assert_close(
        port_bw.signature_distance(port_signature(a), port_signature(b), s),
        ref_bw.signature_distance(a, b, s), rtol=1e-5, atol=1e-6, what="distance",
    )


@pytest.mark.parametrize("name,bench,n", CASES)
def test_counter_sample_sockets_and_totals_match_reference(name, bench, n):
    """``sockets`` and the per-bank ``totals`` of paper §5.3 on both runs
    of the reference's profiling pair."""
    for sample in _case(name, bench, n):
        got = port_sample(sample)
        assert got.sockets == sample.sockets == ref.MACHINES[name].n_nodes
        for d in ("read", "write", "combined"):
            assert_close(got.totals(d), sample.totals(d), rtol=1e-6, what=f"{name} {d}")
    with pytest.raises(ValueError, match="unknown direction"):
        got.totals("both")


def test_batched_fit_equals_per_sample_fits():
    """Leading batch dimensions (the reference's vmap) fit each row as a
    separate call would."""
    machine = ref.E7_4830_V3
    pairs = [_case(machine.name, "NPO", 24)] + [
        ref_profile_pair(machine, ref_benchmark(b, 24), seed=i) for i, b in enumerate(("CG", "EP"))
    ]
    sym = port_bw.CounterSample(*(torch.stack(f) for f in zip(*(port_sample(p[0]) for p in pairs))))
    asym = port_bw.CounterSample(*(torch.stack(f) for f in zip(*(port_sample(p[1]) for p in pairs))))
    batched = port_bw.fit_signature(sym, asym)
    misfit = port_bw.misfit_score(sym)
    for i, (s1, a1) in enumerate(pairs):
        one = port_bw.fit_signature(port_sample(s1), port_sample(a1))
        for d in ("read", "write"):
            for f in one.read._fields:
                assert_close(getattr(getattr(batched, d), f)[i], getattr(getattr(one, d), f),
                             rtol=1e-6, atol=1e-7, what=f"row {i} {d}.{f}")
        assert_close(misfit[i], port_bw.misfit_score(port_sample(s1)), rtol=1e-6, atol=1e-7)


def test_profile_pair_with_reference_noise():
    """The port's profiling runs on the reference's noise draws give the
    reference's samples."""
    machine = ref.E5_2699_V3_SNC2
    wl = ref_benchmark("Page rank", 16)
    key = jax.random.PRNGKey(5)
    want = ref_profile_pair(machine, wl, noise_std=0.05, background_bw=1e8, seed=5)
    got = port.profile_pair(
        port_machine(machine), port_workload(wl), noise_std=0.05, background_bw=1e8,
        noise=jax_profile_noise(key, machine.n_nodes),
    )
    for g, w in zip(got, want):
        for f in w._fields:
            assert_rel_to_scale(getattr(g, f), getattr(w, f), rtol=1e-5, what=f)


def test_quickstart_twin():
    """``examples/quickstart.py`` through the port: profile, fit, predict
    an unseen placement within 5% — and the same numbers as the reference."""
    wl = port.mixed_workload(
        "worked-example", n_threads=16, read_mix=(0.2, 0.35, 0.3), static_socket=1,
        device=CPU,
    )
    sym, asym = port.profile_pair(port.E5_2699_V3, wl)
    sig = port_bw.fit_signature(sym, asym)
    target = torch.tensor([11, 5], dtype=torch.int32)
    measured = port.simulate(port.E5_2699_V3, wl, target)
    demand = measured.read_flows.sum(dim=1)
    pred_local, pred_remote = port_bw.predict_counters(sig.read, demand, target)
    total = float((measured.sample.local_read + measured.sample.remote_read).sum())
    err = float(
        (pred_local - measured.sample.local_read).abs().sum()
        + (pred_remote - measured.sample.remote_read).abs().sum()
    ) / total
    assert err < 0.05
    assert int(sig.read.static_socket) == 1
    assert abs(float(sig.read.static_fraction) - 0.2) < 0.01

    ref_wl = ref.mixed_workload(
        "worked-example", n_threads=16, read_mix=(0.2, 0.35, 0.3), static_socket=1
    )
    ref_sig = ref_fit_signature(*ref_profile_pair(ref.E5_2699_V3, ref_wl, noise_std=0.0))
    _assert_sig_close(sig, ref_sig, "quickstart")
