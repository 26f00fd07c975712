"""The port's phased scheduler (``repro_torch.core.numa.temporal``)
against the reference on the CPU.

The migration accounting is integer and float64 host arithmetic on the
same placements, so ``transition_cost``, ``follow_banks`` and the move
counts of ``evaluate_schedule`` are compared exactly; its phase rates
come from the float32 fill (rel 1e-5).  The three schedule-search
records (``benchmarks/schedule_search.py``) are held against the
reference's live run here: ``gain_pct`` within 0.005 percentage points,
the prohibitive-migration case at exactly 0.0 with the static schedule.
On the symmetric 4-socket machine the two candidate pools may pick other
placements among float32 ties, so that record's schedules may differ
while their work agrees."""

import functools

import numpy as np
import pytest
from _torch_parity import CPU, port_machine

import repro.core.numa as ref
import repro.core.numa.temporal as ref_t
import repro_torch.core.numa as port
import repro_torch.core.numa.temporal as port_t
from repro.core.numa.evaluate import enumerate_placements as ref_enumerate

GAIN_PP = 0.005


def _flip(pkg, n=8, **kw):
    return [
        (pkg.mixed_workload(f"phase-s{s}", n, read_mix=(0.7, 0.1, 0.0), read_bpi=5.0,
                            static_socket=s, **kw), 5.0)
        for s in (0, 1)
    ]


def _tri(pkg, **kw):
    return [
        (pkg.mixed_workload("tri-s0", 24, read_mix=(0.7, 0.1, 0.0), read_bpi=4.0,
                            static_socket=0, **kw), 4.0),
        (pkg.mixed_workload("tri-s2", 24, read_mix=(0.7, 0.1, 0.0), read_bpi=4.0,
                            static_socket=2, **kw), 4.0),
        (pkg.mixed_workload("tri-local", 24, read_mix=(0.1, 0.6, 0.1), read_bpi=4.0, **kw), 2.0),
    ]


# the three records of benchmarks/schedule_search.py: (label, machine,
# phases, bytes per moved thread and page, static expected)
RECORDS = [
    ("2-socket flip (cheap migration)", "E5_2630_V3", _flip, 1e6, False),
    ("2-socket flip (prohibitive migration)", "E5_2630_V3", _flip, 1e13, True),
    ("4-socket 3-phase (cheap migration)", "E7_4830_V3", _tri, 1e6, False),
]


@functools.lru_cache(maxsize=None)
def _record(i):
    label, machine, build, cost, _ = RECORDS[i]
    want = ref_t.optimize_schedule(
        getattr(ref, machine), ref_t.phased_workload(label, build(ref)),
        model=ref_t.MigrationModel(cost, cost))
    got = port_t.optimize_schedule(
        getattr(port, machine), port_t.phased_workload(label, build(port, device=CPU)),
        model=port_t.MigrationModel(cost, cost))
    return want, got


@pytest.mark.parametrize("i", range(len(RECORDS)))
def test_schedule_records_match_reference(i):
    want, got = _record(i)
    static = RECORDS[i][4]
    assert abs(got.gain_pct - want.gain_pct) <= GAIN_PP, (got.gain_pct, want.gain_pct)
    assert got.gain_pct >= 0.0
    assert got.candidates == want.candidates
    assert got.schedule.total_work == pytest.approx(want.schedule.total_work, rel=1e-5)
    assert got.static.total_work == pytest.approx(want.static.total_work, rel=1e-5)
    if static:
        assert got.gain_pct == want.gain_pct == 0.0
        assert len(set(got.schedule.placements)) == 1
        assert sum(got.schedule.moved_threads) == sum(got.schedule.moved_pages) == 0
    if i < 2:  # two sockets: no ties between candidates, the same DP
        assert got.schedule.placements == want.schedule.placements
        assert got.schedule.bank_assignments == want.schedule.bank_assignments
        assert got.states_expanded == want.states_expanded
        assert got.schedule.moved_threads == want.schedule.moved_threads
        assert got.schedule.moved_pages == want.schedule.moved_pages


@functools.lru_cache(maxsize=None)
def _pairs(name, n, k=25):
    placements = np.asarray(ref_enumerate(ref.MACHINES[name], n, max_placements=k, seed=4))
    rng = np.random.default_rng(1)
    return [(placements[i], placements[j]) for i, j in rng.integers(0, len(placements), (k, 2))]


@pytest.mark.parametrize("name,n", [("E7-4830v3-4s12c", 24), ("E5-2630v3-8c", 8)])
def test_transition_cost_and_follow_banks_exact(name, n):
    m, pm = ref.MACHINES[name], port_machine(ref.MACHINES[name])
    for model in (ref_t.MigrationModel(), ref_t.MigrationModel(1e6, 3e7, bandwidth=5e9)):
        pmodel = port_t.MigrationModel(*model)
        assert pmodel.boundary_bandwidth(pm) == model.boundary_bandwidth(m)
        for a, b in _pairs(name, n):
            fb = ref_t.follow_banks(m, n, a, None, b)
            assert port_t.follow_banks(pm, n, a, None, b) == fb
            for banks_a, banks_b in [(None, None), (None, fb), (fb, None)]:
                np.testing.assert_array_equal(port_t.thread_banks(a, banks_a, n),
                                              ref_t.thread_banks(a, banks_a, n))
                assert port_t.transition_cost(pm, pmodel, n, a, banks_a, b, banks_b) == \
                    ref_t.transition_cost(m, model, n, a, banks_a, b, banks_b)


def test_evaluate_schedule_matches_reference():
    placements = [(6, 6, 6, 6), (12, 0, 12, 0), (3, 7, 7, 7)]
    banks = [None, (0, 1, 0, 3), None]
    model = ref_t.MigrationModel(1e6, 1e6)
    want = ref_t.evaluate_schedule(ref.E7_4830_V3, ref_t.phased_workload("tri", _tri(ref)),
                                   placements, bank_assignments=banks, model=model)
    got = port_t.evaluate_schedule(
        port.E7_4830_V3, port_t.phased_workload("tri", _tri(port, device=CPU)),
        placements, bank_assignments=banks, model=port_t.MigrationModel(*model))
    assert got.placements == want.placements and got.bank_assignments == want.bank_assignments
    assert got.transition_times == want.transition_times
    assert (got.moved_threads, got.moved_pages) == (want.moved_threads, want.moved_pages)
    np.testing.assert_allclose(got.phase_rates, want.phase_rates, rtol=1e-5)
    assert got.total_work == pytest.approx(want.total_work, rel=1e-5)


def test_single_phase_schedule_is_the_steady_state_argmax():
    wl = port.benchmarks.benchmark_workload("CG", 8, device=CPU)
    res = port_t.optimize_schedule(port.E5_2630_V3, port_t.phased_workload("one", [(wl, 2.0)]))
    table = port.evaluate.placement_array(port.E5_2630_V3, 8)
    best = port.exact_objectives(port.E5_2630_V3, wl, table).max()
    assert res.gain_pct == 0.0
    assert res.schedule.phase_rates[0] == pytest.approx(float(best), rel=1e-6)


def test_phased_workload_validation():
    a = port.mixed_workload("a", 8, device=CPU)
    with pytest.raises(ValueError, match="no phases"):
        port_t.phased_workload("empty", [])
    with pytest.raises(ValueError, match="threads"):
        port_t.phased_workload("mixed", [(a, 1.0), (port.mixed_workload("b", 4, device=CPU), 1.0)])
    with pytest.raises(ValueError, match="duration"):
        port_t.phased_workload("zero", [(a, 0.0)])
    with pytest.raises(ValueError, match="does not hold"):
        port_t.thread_nodes((4, 3), 8)
