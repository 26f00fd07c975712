"""The port's NUMA advisor (``repro_torch.core.meshsig.advisor``) against
the reference: the signature-only placement ranking, the admissible
bounds and the schedule front end, on the CPU.

The ranking sorts float32 roofline scores, and on symmetric or
bandwidth-capped machines many placements score the same; a last-bit
difference between the two frameworks may order tied placements
differently (and then their remote fractions, the second key, too).  So
each placement's two scores are held at rel 1e-5, and the port's
placement at every rank must score the reference's throughput at that
rank: the rankings are equal up to tied objectives."""

import functools

import jax
import numpy as np
import pytest
import torch
from _torch_parity import CPU, jax_profile_noise, port_machine, port_workload

import repro.core.meshsig.advisor as ref_advisor
import repro.core.numa as ref
import repro_torch.core.meshsig as port_advisor
import repro_torch.core.numa as port
from repro.core.numa.benchmarks import benchmark_workload as ref_benchmark
from repro_torch.core.numa.simulator import CounterNoise

REL = 1e-5


@functools.lru_cache(maxsize=None)
def _pair(name, n, bench):
    m = ref.MACHINES[name]
    wl = ref_benchmark(bench, n)
    return m, wl, port_machine(m), port_workload(wl)


def _assert_rankings_agree(got, want_full):
    """``got`` (possibly top-k) against the reference's full ranking."""
    want_at = {r.placement: r for r in want_full}
    for i, g in enumerate(got):
        w = want_at[g.placement]
        assert g.predicted_throughput == pytest.approx(w.predicted_throughput, rel=REL)
        assert g.remote_fraction == pytest.approx(w.remote_fraction, rel=REL, abs=1e-6)
        # the placement at rank i ties the reference's rank-i objective
        assert w.predicted_throughput == pytest.approx(
            want_full[i].predicted_throughput, rel=REL), i


@pytest.mark.parametrize("name,n,bench,max_p", [
    ("E7-4830v3-4s12c", 24, "CG", None),  # 1,469 placements, symmetric
    ("E5-2630v3-8c-throttled", 8, "NPO", None),  # per-node rates differ
    ("E7-8860v3-8s16c", 32, "Swim", 512),  # routed links, sampled
    ("E5-2630v3-8c-mixed-dimm", 8, "Page rank", None),  # per-node DIMMs, two classes
])
def test_rankings_match_reference(name, n, bench, max_p):
    m, wl, pm, pwl = _pair(name, n, bench)
    want = ref_advisor.rank_numa_placements(m, wl, max_placements=max_p)
    got = port_advisor.rank_numa_placements(pm, pwl, max_placements=max_p)
    assert len(got) == len(want)
    _assert_rankings_agree(got, want)
    if name.endswith("throttled"):  # no symmetric twins: the same order
        assert [r.placement for r in got] == [r.placement for r in want]


def test_noisy_ranking_on_reference_draws_matches_reference():
    m, wl, pm, pwl = _pair("E7-4830v3-4s12c", 24, "Swim")
    key = jax.random.PRNGKey(5)
    want = ref_advisor.rank_numa_placements(m, wl, noise_std=0.05, key=key)
    sym, asym = jax_profile_noise(key, m.n_nodes)
    noise = CounterNoise(*(torch.stack([a, b])[None] for a, b in zip(sym, asym)))
    got = port_advisor.rank_numa_placements(pm, pwl, noise_std=0.05, noise=noise, top_k=40)
    assert len(got) == 40
    _assert_rankings_agree(got, want)


def test_explicit_candidates_and_top_k():
    m, wl, pm, pwl = _pair("E5-2699v3-18c-snc2", 16, "CG")
    cands = np.asarray([[4, 4, 4, 4], [8, 8, 0, 0], [16, 0, 0, 0], [0, 8, 0, 8]], np.int32)
    want = ref_advisor.rank_numa_placements(m, wl, placements=cands)
    got = port_advisor.rank_numa_placements(pm, pwl, placements=cands, top_k=3)
    assert len(got) == 3
    _assert_rankings_agree(got, want)


@pytest.mark.parametrize("name,n,bench", [
    ("E7-4830v3-4s12c", 24, "CG"), ("E7-8860v3-8s16c", 32, "Page rank"),
    ("E5-2630v3-8c-mixed-dimm", 8, "NPO"),
])
def test_numa_placement_bounds_equal_reference(name, n, bench):
    m, wl, pm, pwl = _pair(name, n, bench)
    placements = port.evaluate.placement_array(pm, n, max_placements=300, seed=2)
    np.testing.assert_array_equal(
        port_advisor.numa_placement_bounds(pm, pwl, placements),
        ref_advisor.numa_placement_bounds(m, wl, placements),
    )


def test_advise_schedule_is_the_scheduler():
    wls = [port.mixed_workload(f"s{s}", 8, read_mix=(0.7, 0.1, 0.0), read_bpi=5.0,
                               static_socket=s, device=CPU) for s in (0, 1)]
    pw = port.phased_workload("flip", [(w, 5.0) for w in wls])
    model = port.MigrationModel(thread_move_bytes=1e6, page_move_bytes=1e6)
    got = port_advisor.advise_schedule(port.E5_2630_V3, pw, model=model)
    want = port.optimize_schedule(port.E5_2630_V3, pw, model=model)
    assert got.schedule == want.schedule and got.gain_pct == want.gain_pct
