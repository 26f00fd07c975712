"""The resilience layer of the port's advisor service on the CPU: fault
injection, the deadline degradation ladder, spec-epoch hot-swap and
rollback, live recalibration and close/drain — the scenarios of
``tests/test_serve_resilience.py`` with ``device="cpu"``.

Parity: the :class:`Recalibrator`'s decisions equal the reference's on
the same samples (the reference's sweep, carried over through
``convert``), with the old and new sweep-median errors at rel 1e-3; the
ranked rung's pick scores the reference's ranking at rel 1e-5.

Every ``result()`` and ``join()`` carries its own timeout, so a hang
fails one test instead of the whole run.
"""

import threading
import time

import numpy as np
import pytest

import repro.core.numa as ref
import repro.core.numa.calibrate as ref_cal
import repro.serve as ref_serve
import repro_torch.core.numa as port
import repro_torch.core.numa.calibrate as port_cal
from repro.core.meshsig.advisor import rank_numa_placements
from repro_torch.convert import calibration_samples_from_arrays
from repro_torch.launch.advisor_serve import signature_pool
from repro_torch.serve import (
    FIDELITIES,
    NO_FAULTS,
    Advice,
    AdvisorService,
    FaultError,
    FaultInjector,
    Recalibrator,
    ServiceClosedError,
)

CPU = "cpu"
WAIT = 120  # seconds any single future or thread may take


def _sigs(n, seed=0):
    return signature_pool(n, seed=seed)


def _join_all(threads):
    for t in threads:
        t.join(timeout=WAIT)
    assert not any(t.is_alive() for t in threads), "a worker thread hung"


def _port_samples(ref_samples):
    fields = {k: np.asarray(v) for k, v in ref_samples._asdict().items() if k != "wl_arrays"}
    fields["wl_arrays"] = [np.asarray(a) for a in ref_samples.wl_arrays]
    return calibration_samples_from_arrays(fields, device=CPU)


def _drift(spec, factor=0.8):
    return spec._replace(
        remote_read_bw=spec.remote_read_bw * factor,
        remote_write_bw=spec.remote_write_bw * factor,
    )


@pytest.fixture()
def faulty_service():
    fi = FaultInjector()
    svc = AdvisorService(device=CPU, max_wait_s=0.002, faults=fi)
    yield svc, fi
    fi.clear()
    svc.close()


# ---------------------------------------------------------------------------
# FaultInjector (the port's copy)
# ---------------------------------------------------------------------------


def test_fault_injector_error_budget_log_and_clock_skew():
    fi = FaultInjector()
    fi.fire("batch")  # nothing armed: no-op
    fi.inject_error("batch", times=2)
    for _ in range(2):
        with pytest.raises(FaultError):
            fi.fire("batch")
    fi.fire("batch")  # budget spent: healed
    assert fi.fired("batch") == 2 and fi.log == [("batch", "error")] * 2
    fi.inject_clock_skew(3.5)
    assert fi.now() - time.monotonic() == pytest.approx(3.5, abs=0.05)
    fi.clear()
    assert fi.now() - time.monotonic() == pytest.approx(0.0, abs=0.05)
    fi.inject_error("search", exc_factory=lambda: KeyError("boom"))
    with pytest.raises(KeyError):
        fi.fire("search")


def test_fault_injector_corrupts_the_same_rows_as_the_reference():
    arrays = tuple(np.arange(8, dtype=np.float64) + i for i in range(3))
    got, want = FaultInjector(), ref_serve.FaultInjector()
    assert got.corrupt_counters(arrays) is arrays  # disarmed: identity
    for fi in (got, want):
        fi.inject_counter_corruption(fraction=0.25, times=1, seed=3)
    poisoned, ref_poisoned = got.corrupt_counters(arrays), want.corrupt_counters(arrays)
    np.testing.assert_array_equal(np.isnan(np.stack(poisoned)), np.isnan(np.stack(ref_poisoned)))
    assert np.isnan(np.stack(poisoned)).any(axis=0).sum() == 2
    assert not np.isnan(np.stack(got.corrupt_counters(arrays))).any()  # budget spent
    NO_FAULTS.fire("batch")
    assert NO_FAULTS.log == []


# ---------------------------------------------------------------------------
# Degradation ladder
# ---------------------------------------------------------------------------


def test_deadline_miss_degrades_to_ranked(faulty_service):
    svc, fi = faulty_service
    fp = svc.register(port.E5_2630_V3)
    svc.warmup(fp, 8)
    fi.inject_error("batch", times=1)
    sig = _sigs(1, seed=1)[0]
    adv = svc.query(fp, sig, 8, deadline_s=5.0)
    assert adv.tier == "degraded" and adv.fidelity == "ranked" and adv.epoch == 0
    assert sum(adv.placement) == 8 and np.isnan(adv.predicted_bandwidth)
    # the rung is the reference's signature-only ranking
    best = rank_numa_placements(
        ref.E5_2630_V3, ref_serve.QuerySignature(*sig).workload(8), top_k=1,
        max_placements=2048,
    )[0]
    assert adv.placement == best.placement
    assert adv.objective == pytest.approx(best.predicted_throughput, rel=1e-5)
    snap = svc.metrics.snapshot()
    assert snap["tier_counts"]["degraded"] == 1 and snap["fidelity_counts"]["ranked"] == 1
    assert snap["degraded_rate"] > 0


def test_expired_deadline_degrades_without_waiting():
    """A zero deadline never waits on the batcher: the answer comes off
    the ladder at once."""
    fi = FaultInjector()
    svc = AdvisorService(device=CPU, max_wait_s=1.0, faults=fi)
    try:
        fp = svc.register(port.E5_2630_V3)
        t0 = time.perf_counter()
        adv = svc.query(fp, _sigs(1, seed=21)[0], 8, deadline_s=0.0)
        assert adv.fidelity == "ranked"
        assert time.perf_counter() - t0 < 1.0  # did not sit out max_wait_s
    finally:
        svc.close()


def test_ladder_falls_to_stale_then_fallback(faulty_service):
    svc, fi = faulty_service
    fp = svc.register(port.E5_2630_V3)
    exact = svc.warmup(fp, 8)  # fills the last-known-good cache
    fi.inject_error("batch", times=1)
    fi.inject_error("rank", times=1)
    adv = svc.query(fp, _sigs(1, seed=2)[0], 8, deadline_s=5.0)
    assert adv.fidelity == "stale" and adv.tier == "degraded"
    assert adv.placement == exact.placement and adv.objective == exact.objective


def test_ranked_rung_over_its_budget_yields_to_the_next_rung(monkeypatch):
    """The ranked rung waits at most ``RANK_BUDGET_S``.  With the batch
    tier held up (a slow batch) and the rung held up too (a slow rank),
    the query answers stale within its deadline plus the budget; a second
    degraded query, whose ranking queues behind the held one, does too,
    and its ranking is cancelled unrun.  Once the rung is free it answers
    ranked again.  Every ranking runs on the ``advisor-rank`` thread on
    the service's device."""
    from repro_torch.serve import service as service_mod

    ran = []
    rank = service_mod.rank_numa_placements

    def recorded(machine, workload, **kwargs):
        ran.append((threading.current_thread().name, workload.device.type))
        return rank(machine, workload, **kwargs)

    monkeypatch.setattr(service_mod, "rank_numa_placements", recorded)
    fi = FaultInjector()
    deadline_s, budget_s, hold_s = 0.25, service_mod.RANK_BUDGET_S, 2.0
    svc = AdvisorService(device=CPU, max_wait_s=0.002, faults=fi)
    try:
        fp = svc.register(port.E5_2630_V3)
        exact = svc.warmup(fp, 8)  # fills the last-known-good cache
        ran.clear()
        fi.inject_slow("batch", hold_s, times=1)
        fi.inject_slow("rank", hold_s, times=1)
        for seed in (31, 32):
            t0 = time.perf_counter()
            adv = svc.query(fp, _sigs(1, seed=seed)[0], 8, deadline_s=deadline_s)
            wall = time.perf_counter() - t0
            assert adv.fidelity == "stale" and adv.tier == "degraded"
            assert adv.placement == exact.placement
            assert wall < deadline_s + budget_s + 0.5, wall  # not the 2 s hold
        time.sleep(hold_s + 0.5)  # the held ranking and the slow batch finish
        assert len(ran) == 1  # the held ranking ran late; the queued one never ran
        fi.inject_error("batch", times=1)
        assert svc.query(fp, _sigs(1, seed=33)[0], 8, deadline_s=5.0).fidelity == "ranked"
        assert ran == [("advisor-rank_0", "cpu")] * 2
        assert svc.metrics.snapshot()["fidelity_counts"]["stale"] == 2
    finally:
        fi.clear()
        svc.close()


class _LateWaker(FaultInjector):
    """A fault injector whose deadline clock, once armed, stalls the
    armed thread's second read by ``stall_s``: the waiter looks up its
    remaining wait that much late, as a thread does that wakes late when
    others hold the interpreter lock."""

    def __init__(self):
        super().__init__()
        self.stall_s, self.thread, self.reads = 0.0, None, 0

    def now(self) -> float:
        if threading.get_ident() == self.thread:
            self.reads += 1
            if self.reads == 2:
                time.sleep(self.stall_s)
        return super().now()


def test_degraded_answer_is_bounded_from_the_query_start():
    """The ranked rung's budget counts from the query's own start, not
    from the moment the waiter gives up: a waiter that looks at the clock
    0.6 s late, with the exact tier and the rung both held up, answers
    stale within its deadline plus ``RANK_BUDGET_S`` of its start, not a
    full budget after it woke."""
    from repro_torch.serve import service as service_mod

    fi = _LateWaker()
    deadline_s, budget_s, hold_s = 0.25, service_mod.RANK_BUDGET_S, 2.0
    svc = AdvisorService(device=CPU, max_wait_s=0.002, faults=fi)
    try:
        fp = svc.register(port.E5_2630_V3)
        exact = svc.warmup(fp, 8)  # fills the last-known-good cache
        fi.inject_slow("batch", hold_s, times=1)
        fi.inject_slow("rank", hold_s, times=1)
        fi.stall_s, fi.thread = 0.6, threading.get_ident()
        t0 = time.perf_counter()
        adv = svc.query(fp, _sigs(1, seed=34)[0], 8, deadline_s=deadline_s)
        wall = time.perf_counter() - t0
        assert fi.reads == 2
        assert adv.fidelity == "stale" and adv.placement == exact.placement
        # the stall alone is 0.6 s; a budget counted from the wake-up
        # would answer at about 1.1 s
        assert 0.6 <= wall < deadline_s + budget_s + 0.15, wall
        time.sleep(hold_s)  # the held ranking and the slow batch finish
    finally:
        fi.clear()
        svc.close()


def test_ladder_fallback_is_even_spread():
    fi = FaultInjector()
    svc = AdvisorService(device=CPU, max_wait_s=0.002, faults=fi)
    try:
        fp = svc.register(port.E5_2630_V3)
        fi.inject_error("batch", times=1)
        fi.inject_error("rank", times=1)
        adv = svc.query(fp, _sigs(1, seed=3)[0], 9, deadline_s=5.0)
    finally:
        svc.close()
    assert adv.fidelity == "fallback" and adv.tier == "degraded"
    assert adv.placement == (5, 4)  # divmod even spread, remainder first
    assert np.isnan(adv.objective) and np.isnan(adv.predicted_bandwidth)


def test_degraded_answers_are_never_cached(faulty_service):
    svc, fi = faulty_service
    fp = svc.register(port.E5_2630_V3)
    svc.warmup(fp, 8)
    sig = _sigs(1, seed=4)[0]
    fi.inject_error("batch", times=1)
    assert svc.query(fp, sig, 8, deadline_s=5.0).fidelity == "ranked"
    healed = svc.query(fp, sig, 8, deadline_s=5.0)
    assert healed.fidelity == "exact" and healed.tier == "batch"
    assert svc.query(fp, sig, 8) is healed


def test_all_answers_fidelity_tagged_in_mixed_chaos(faulty_service):
    svc, fi = faulty_service
    fp = svc.register(port.E5_2630_V3)
    svc.warmup(fp, 8)
    sigs = _sigs(40, seed=5)
    fi.inject_slow("batch", 0.05, times=2)
    fi.inject_error("batch", times=3)
    fi.inject_error("batcher", times=1)
    answers = {}
    lock = threading.Lock()
    idx = iter(range(len(sigs)))

    def worker():
        while True:
            with lock:
                i = next(idx, None)
            if i is None:
                return
            answers[i] = svc.query(fp, sigs[i], 8, deadline_s=2.0)

    threads = [threading.Thread(target=worker) for _ in range(3)]
    for t in threads:
        t.start()
    _join_all(threads)
    assert len(answers) == len(sigs)
    assert all(a.fidelity in FIDELITIES for a in answers.values())
    assert svc.metrics.snapshot()["worker_restarts"] >= 1  # the batcher healed
    fi.clear()
    assert svc.query(fp, _sigs(1, seed=6)[0], 8, deadline_s=2.0).fidelity == "exact"


# ---------------------------------------------------------------------------
# Search-tier retries
# ---------------------------------------------------------------------------


def test_search_faults_absorbed_within_retry_budget():
    fi = FaultInjector()
    svc = AdvisorService(device=CPU, sweep_limit=1, search_retries=2,
                         search_backoff_s=0.001, faults=fi)
    try:
        fi.inject_error("search", times=2)
        adv = svc.query(port.E5_2630_V3, _sigs(1, seed=7)[0], 8, timeout=WAIT)
    finally:
        svc.close()
    assert adv.tier == "search" and adv.fidelity == "exact" and sum(adv.placement) == 8
    assert fi.fired("search") == 2


@pytest.mark.parametrize("deadline", [None, 30.0])
def test_search_faults_beyond_budget_surface_or_degrade(deadline):
    """Without a deadline the failure surfaces; with one it degrades."""
    fi = FaultInjector()
    svc = AdvisorService(device=CPU, sweep_limit=1, search_retries=1,
                         search_backoff_s=0.001, faults=fi)
    try:
        fi.inject_error("search", times=3)  # the budget is 1 + 1 attempts
        sig = _sigs(1, seed=8)[0]
        if deadline is None:
            with pytest.raises(FaultError):
                svc.query(port.E5_2630_V3, sig, 8, timeout=WAIT)
        else:
            adv = svc.query(port.E5_2630_V3, sig, 8, deadline_s=deadline)
            assert adv.tier == "degraded" and adv.fidelity == "ranked"
    finally:
        svc.close()


def test_schedule_fault_site_fails_the_phased_query():
    fi = FaultInjector()
    svc = AdvisorService(device=CPU, faults=fi)
    try:
        fi.inject_error("schedule", times=1)
        with pytest.raises(FaultError):
            svc.query_schedule(port.E5_2630_V3, [(_sigs(1)[0], 1.0)], 8, timeout=WAIT)
    finally:
        svc.close()
    assert fi.fired("schedule") == 1


# ---------------------------------------------------------------------------
# Spec epochs & hot-swap
# ---------------------------------------------------------------------------


def test_swap_bumps_epoch_and_answers_move():
    svc = AdvisorService(device=CPU, max_wait_s=0.0)
    try:
        fp = svc.register(port.E5_2630_V3, machine_id="prod")
        assert fp == "prod" and svc.epoch_of(fp) == 0
        sig = _sigs(1, seed=10)[0]
        before = svc.query(fp, sig, 8)
        assert svc.swap_machine(fp, _drift(port.E5_2630_V3)) == 1
        assert svc.epoch_of(fp) == 1 and svc.machine_spec(fp) == _drift(port.E5_2630_V3)
        after = svc.query(fp, sig, 8)
        assert before.epoch == 0 and after.epoch == 1 and after is not before
        assert svc.metrics.snapshot()["swaps"] == 1
    finally:
        svc.close()


def test_warm_swap_registers_the_new_epoch_shape_at_install():
    """The new epoch's table is built and its shape key registered at the
    swap, so the first post-swap query adds no new shape."""
    svc = AdvisorService(device=CPU, max_wait_s=0.0)
    try:
        fp = svc.register(port.E5_2630_V3, machine_id="prod")
        svc.warmup(fp, 8)
        svc.metrics.reset(keep_traces=True)
        svc.swap_machine(fp, _drift(port.E5_2630_V3))
        assert svc.metrics.snapshot()["retraces"] == 1  # moved at the swap
        assert (fp, 1, 8) in svc._tables.keys()
        svc.metrics.reset(keep_traces=True)
        assert svc.query(fp, _sigs(1, seed=20)[0], 8).epoch == 1
        assert svc.metrics.snapshot()["retraces"] == 0  # not at the query
    finally:
        svc.close()


def test_swap_invalidation_is_per_machine():
    svc = AdvisorService(device=CPU, max_wait_s=0.0)
    try:
        a = svc.register(port.E5_2630_V3, machine_id="a")
        b = svc.register(port.E7_4830_V3, machine_id="b")
        sig = _sigs(1, seed=11)[0]
        adv_a, adv_b = svc.query(a, sig, 8), svc.query(b, sig, 24)
        svc.swap_machine(a, _drift(port.E5_2630_V3))
        assert svc.query(b, sig, 24) is adv_b
        assert svc.query(a, sig, 8) is not adv_a
    finally:
        svc.close()


def test_swap_rejects_structural_change_and_unknown_handle():
    svc = AdvisorService(device=CPU)
    try:
        fp = svc.register(port.E5_2630_V3)
        with pytest.raises(ValueError):
            svc.swap_machine(fp, port.E7_4830_V3)  # 2 nodes -> 4 nodes
        with pytest.raises(KeyError):
            svc.swap_machine("nope", port.E5_2630_V3)
    finally:
        svc.close()


def test_register_is_idempotent_across_swaps_and_rollback_moves_forward():
    svc = AdvisorService(device=CPU, max_wait_s=0.0)
    try:
        fp = svc.register(port.E5_2630_V3, machine_id="prod")
        with pytest.raises(RuntimeError):
            svc.rollback_machine(fp)  # nothing to roll back to yet
        svc.swap_machine(fp, _drift(port.E5_2630_V3))
        assert svc.register(port.E5_2630_V3, machine_id="prod") == fp
        assert svc.machine_spec(fp) == _drift(port.E5_2630_V3)
        assert svc.rollback_machine(fp) == 2  # epochs only move forward
        assert svc.machine_spec(fp) == port.E5_2630_V3
        snap = svc.metrics.snapshot()
        assert snap["swaps"] == 1 and snap["rollbacks"] == 1
    finally:
        svc.close()


def test_inflight_batch_pins_its_epoch():
    """Queries admitted before a swap answer on the old spec and epoch,
    even when the swap lands while they wait in the pending queue."""
    svc = AdvisorService(device=CPU, max_batch=8, max_wait_s=0.3)
    old = AdvisorService(device=CPU, max_wait_s=0.0)
    try:
        fp = svc.register(port.E5_2630_V3, machine_id="prod")
        svc.warmup(fp, 8)
        fresh = _sigs(3, seed=13)
        futures = [svc.submit(fp, s, 8) for s in fresh]
        svc.swap_machine(fp, _drift(port.E5_2630_V3, 0.5))  # lands mid-wait
        answers = [f.result(timeout=WAIT) for f in futures]
        assert all(a.epoch == 0 for a in answers)
        want = [old.query(port.E5_2630_V3, s, 8, timeout=WAIT) for s in fresh]
        assert [(a.placement, a.objective) for a in answers] == [
            (w.placement, w.objective) for w in want
        ]
        assert svc.query(fp, _sigs(1, seed=12)[0], 8, timeout=WAIT).epoch == 1
    finally:
        svc.close()
        old.close()


def test_sustained_stream_straddling_swap_has_no_torn_reads():
    svc = AdvisorService(device=CPU, max_wait_s=0.002)
    try:
        fp = svc.register(port.E5_2630_V3, machine_id="prod")
        svc.warmup(fp, 8)
        sigs = _sigs(6, seed=14)
        for s in sigs:
            svc.query(fp, s, 8, timeout=WAIT)
        observed = []
        stop = threading.Event()

        def streamer():
            i = 0
            while not stop.is_set() and i < 20_000:
                adv = svc.query(fp, sigs[i % len(sigs)], 8, timeout=WAIT)
                observed.append((i % len(sigs), adv.epoch, adv.placement, adv.objective))
                i += 1

        threads = [threading.Thread(target=streamer) for _ in range(2)]
        for t in threads:
            t.start()
        time.sleep(0.05)
        svc.swap_machine(fp, _drift(port.E5_2630_V3))
        time.sleep(0.05)
        svc.rollback_machine(fp)
        time.sleep(0.05)
        stop.set()
        _join_all(threads)
    finally:
        svc.close()
    assert {e for _, e, _, _ in observed} >= {0, 1}
    by_key = {}
    for sig_id, epoch, placement, obj in observed:
        assert by_key.setdefault((sig_id, epoch), (placement, obj)) == (placement, obj)


# ---------------------------------------------------------------------------
# Recalibration
# ---------------------------------------------------------------------------


def _sweeps(machine, n_threads=4, noise_std=0.0):
    """The reference's sweep of ``machine``, and the same samples in the
    port."""
    samples = ref_cal.collect_sweep(
        machine, ref_cal.probe_suite(machine, n_threads=n_threads), noise_std=noise_std
    )
    return samples, _port_samples(samples)


def test_recalibrator_rejects_nan_rows_at_ingest():
    fi = FaultInjector()
    svc = AdvisorService(device=CPU, faults=fi)
    try:
        fp = svc.register(port.E5_2630_V3, machine_id="prod")
        recal = Recalibrator(svc)
        _, samples = _sweeps(ref.E5_2630_V3)
        fi.inject_counter_corruption(fraction=0.5, times=1, seed=1)
        diag = recal.ingest(fp, samples)
        assert diag.n_rejected == round(0.5 * samples.n_samples)
        assert diag.n_kept == samples.n_samples - diag.n_rejected
        assert recal.buffered(fp) == diag.n_kept
        assert recal.ingest(fp, samples).n_rejected == 0  # budget spent
    finally:
        svc.close()


def test_recalibrator_refuses_insufficient_samples():
    svc = AdvisorService(device=CPU)
    try:
        fp = svc.register(port.E5_2630_V3, machine_id="prod")
        recal = Recalibrator(svc, min_samples=10_000)
        recal.ingest(fp, _sweeps(ref.E5_2630_V3)[1])
        event = recal.recalibrate(fp)
    finally:
        svc.close()
    assert not event.accepted and "insufficient" in event.reason
    assert svc.epoch_of(fp) == 0 and recal.events == [event] and recal.buffered(fp) == 0


def test_recalibrator_fit_failure_is_an_event_not_a_crash():
    fi = FaultInjector()
    svc = AdvisorService(device=CPU, faults=fi)
    try:
        fp = svc.register(port.E5_2630_V3, machine_id="prod")
        recal = Recalibrator(svc, min_samples=4)
        recal.ingest(fp, _sweeps(ref.E5_2630_V3)[1])
        fi.inject_error("recalibrate", times=1)
        event = recal.recalibrate(fp)
    finally:
        svc.close()
    assert not event.accepted and "refit failed" in event.reason
    assert svc.epoch_of(fp) == 0


def _decide(svc_cls, spec, samples, **kw):
    svc = svc_cls()
    try:
        fp = svc.register(spec, machine_id="prod")
        recal = kw.pop("recal_cls")(svc, **kw)
        recal.ingest(fp, samples)
        event = recal.recalibrate(fp)
        return event, svc.epoch_of(fp), svc.metrics.snapshot()
    finally:
        svc.close()


@pytest.mark.parametrize("case", ["guard_rejects", "drift_accepted"])
def test_recalibrator_decisions_match_reference(case):
    """The same samples into both recalibrators: an unmeetable guard
    (demanding a 100 pp improvement) rejects and counts a rollback; a
    clean refit of a drifted spec from the true machine's sweep is
    accepted and swapped in.  Decision, epoch and counters equal; the old
    and new sweep-median errors at rel 1e-3."""
    truth = ref.E5_2630_V3
    if case == "guard_rejects":
        spec, kw = truth, dict(min_samples=4, fit_steps=5, max_error_regression_pp=-100.0)
        ref_samples, samples = _sweeps(truth)
    else:
        spec, kw = _drift(truth, 0.7), dict(min_samples=8, fit_steps=150)
        ref_samples, samples = _sweeps(truth, n_threads=8, noise_std=0.01)
    want, want_epoch, want_snap = _decide(
        ref_serve.AdvisorService, spec, ref_samples, recal_cls=ref_serve.Recalibrator, **kw
    )
    pspec = port.MACHINES[truth.name]
    pspec = pspec if case == "guard_rejects" else _drift(pspec, 0.7)
    got, got_epoch, got_snap = _decide(
        lambda: AdvisorService(device=CPU, max_wait_s=0.0), pspec, samples,
        recal_cls=Recalibrator, **kw,
    )
    assert (got.accepted, got_epoch) == (want.accepted, want_epoch)
    assert (got_snap["swaps"], got_snap["rollbacks"]) == (want_snap["swaps"], want_snap["rollbacks"])
    assert (got.n_samples, got.n_rejected) == (want.n_samples, want.n_rejected)
    assert got.old_error_pct == pytest.approx(want.old_error_pct, rel=1e-3)
    assert got.new_error_pct == pytest.approx(want.new_error_pct, rel=1e-3)
    if case == "drift_accepted":
        assert got.accepted and got.new_error_pct < got.old_error_pct and got_epoch == 1
    else:
        assert "previous spec retained" in got.reason and got_snap["rollbacks"] == 1


def test_recalibrator_swapped_spec_serves_exact_answers():
    truth = port.E5_2630_V3
    svc = AdvisorService(device=CPU, max_wait_s=0.0)
    try:
        fp = svc.register(_drift(truth, 0.7), machine_id="prod")
        svc.warmup(fp, 8)
        recal = Recalibrator(svc, min_samples=8, fit_steps=60)
        samples = port_cal.collect_sweep(
            truth, port_cal.probe_suite(truth, n_threads=8, device=CPU), device=CPU
        )
        assert recal.ingest(fp, samples).n_rejected == 0
        event = recal.recalibrate(fp)
        assert event.accepted, event.reason
        adv = svc.query(fp, _sigs(1, seed=15)[0], 8, timeout=WAIT)
        assert adv.epoch == 1 and adv.fidelity == "exact"
    finally:
        svc.close()


def test_recalibrator_background_loop_starts_and_stops():
    svc = AdvisorService(device=CPU)
    try:
        fp = svc.register(port.E5_2630_V3, machine_id="prod")
        recal = Recalibrator(svc, min_samples=4, fit_steps=3)
        recal.ingest(fp, _sweeps(ref.E5_2630_V3)[1])
        recal.start(interval_s=0.01)
        with pytest.raises(RuntimeError):
            recal.start()
        deadline = time.monotonic() + WAIT
        while not recal.events and time.monotonic() < deadline:
            time.sleep(0.01)
        recal.stop(timeout=WAIT)
        recal.stop()  # idempotent
    finally:
        svc.close()
    assert len(recal.events) == 1 and recal.buffered(fp) == 0


# ---------------------------------------------------------------------------
# Lifecycle: close/drain
# ---------------------------------------------------------------------------


def test_closed_service_raises_everywhere():
    svc = AdvisorService(device=CPU)
    fp = svc.register(port.E5_2630_V3)
    svc.close()
    svc.close()  # idempotent
    sig = _sigs(1)[0]
    for call in (
        lambda: svc.query(fp, sig, 8),
        lambda: svc.query(fp, sig, 8, deadline_s=1.0),
        lambda: svc.submit(fp, sig, 8),
        lambda: svc.query_schedule(fp, [(sig, 1.0)], 8),
        lambda: svc.swap_machine(fp, _drift(port.E5_2630_V3)),
    ):
        with pytest.raises(ServiceClosedError):
            call()


def test_close_during_query_hammer_never_hangs():
    svc = AdvisorService(device=CPU, max_batch=4, max_wait_s=0.01)
    fp = svc.register(port.E5_2630_V3, machine_id="prod")
    svc.warmup(fp, 8)
    sigs = _sigs(64, seed=16)
    outcomes = []
    lock = threading.Lock()
    idx = iter(range(len(sigs)))

    def worker():
        while True:
            with lock:
                i = next(idx, None)
            if i is None:
                return
            try:
                out = svc.query(fp, sigs[i], 8, timeout=30)
            except ServiceClosedError:
                out = "closed"
            with lock:
                outcomes.append(out)

    threads = [threading.Thread(target=worker) for _ in range(4)]
    for t in threads:
        t.start()
    time.sleep(0.05)
    svc.close()
    _join_all(threads)
    assert len(outcomes) == len(sigs)
    for adv in outcomes:
        if isinstance(adv, Advice):
            assert sum(adv.placement) == 8


def test_advisor_cli_takes_a_deadline(tmp_path):
    """``--deadline-ms`` bounds every query of the CLI's stream; on a
    healthy service every answer is still exact and fidelity-counted."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    out = tmp_path / "snap.json"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.advisor_serve", "--device", "cpu",
         "--queries", "40", "--pool", "4", "--workers", "2", "--search-fraction", "0",
         "--deadline-ms", "60000", "--json", str(out)],
        capture_output=True, text=True, timeout=300, cwd=root,
        env={"PYTHONPATH": str(root / "src"), "PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "2"},
    )
    assert proc.returncode == 0, proc.stderr
    snap = json.loads(out.read_text())
    assert snap["fidelity_counts"]["exact"] == 40 and snap["degraded_rate"] == 0.0
    assert snap["tier_counts"]["degraded"] == 0


def test_metrics_reset_after_warmup_counts_only_the_stream(monkeypatch):
    """A query's metrics are recorded before its answer wakes the caller,
    so ``serve_stream``'s reset after the warm-up leaves exactly the
    stream's queries counted, however late the recording would run."""
    from repro_torch.launch.advisor_serve import serve_stream

    record = AdvisorService._record

    def slow_record(self, *args):  # the recording lags the batch's answer
        time.sleep(0.2)
        record(self, *args)

    monkeypatch.setattr(AdvisorService, "_record", slow_record)
    svc = AdvisorService(device=CPU, max_wait_s=0.002)
    try:
        snap = serve_stream(svc, 12, pool=2, hit_fraction=0.5, search_fraction=0.0,
                            workers=2, deadline_s=WAIT)
        time.sleep(0.5)  # a recording still pending would land here
        late = svc.metrics.snapshot()
    finally:
        svc.close()
    for counted in (snap, late):
        assert sum(counted["tier_counts"].values()) == 12
        assert sum(counted["fidelity_counts"].values()) == 12


def test_failing_metrics_recorder_still_answers(monkeypatch):
    """A metrics recorder that raises does not keep the answer from its
    waiter: the future resolves whatever its recorders do."""
    def broken(self, *args):
        raise RuntimeError("metrics sink down")

    monkeypatch.setattr(AdvisorService, "_record", broken)
    svc = AdvisorService(device=CPU, max_wait_s=0.002)
    try:
        fp = svc.register(port.E5_2630_V3, machine_id="m")
        advice = svc.submit(fp, _sigs(1, seed=21)[0], 8).result(timeout=WAIT)
        assert advice.fidelity == "exact"
    finally:
        svc.close()


def test_raising_recorder_does_not_drop_a_coalesced_querys_metrics(monkeypatch, caplog):
    """Two queries coalesced on one in-flight key each add a recorder to
    the shared answer.  The first recorder raises: both queries are still
    answered, the second is still counted, and the failure is logged, as
    ``concurrent.futures`` logs a raising done-callback."""
    record = AdvisorService._record
    calls = []

    def first_raises(self, *args):
        calls.append(args)
        if len(calls) == 1:
            raise RuntimeError("metrics sink down")
        record(self, *args)

    monkeypatch.setattr(AdvisorService, "_record", first_raises)
    svc = AdvisorService(device=CPU, max_batch=8, max_wait_s=0.5)
    try:
        fp = svc.register(port.E5_2630_V3, machine_id="m")
        sig = _sigs(1, seed=22)[0]
        with caplog.at_level("ERROR", logger="repro_torch.serve.service"):
            first, second = svc.submit(fp, sig, 8), svc.submit(fp, sig, 8)
            answers = [f.result(timeout=WAIT) for f in (first, second)]
        snap = svc.metrics.snapshot()
    finally:
        svc.close()
    assert all(a.fidelity == "exact" for a in answers)
    assert answers[0].placement == answers[1].placement
    assert len(calls) == 2  # one in-flight answer, two recorders
    assert sum(snap["tier_counts"].values()) == 1
    assert sum(snap["fidelity_counts"].values()) == 1
    assert any(r.exc_info and "metrics sink down" in str(r.exc_info[1]) for r in caplog.records)
