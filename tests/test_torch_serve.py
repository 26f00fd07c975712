"""The port's advisor service (cache and batch tiers) against the JAX
``AdvisorService``, and its serving contracts on the CPU.

Parity: every answer's objective and predicted bandwidth within rel
1e-5 of the reference's.  The placement is the reference's, or a tie:
on a symmetric machine permuted placements have the same objective and
``argmax`` may pick another one, so a differing placement must score
the reference's objective when the port simulates it."""

import json
import subprocess
import sys
import threading
from concurrent.futures import Future
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core.numa as ref
import repro.serve as ref_serve
import repro_torch.core.numa as port
from repro.launch.advisor_serve import mixed_stream as ref_mixed_stream
from repro.launch.advisor_serve import signature_pool as ref_signature_pool
from repro_torch.launch.advisor_serve import drive_threads, mixed_stream, signature_pool
from repro_torch.serve import (
    Advice,
    AdvisorService,
    LRUCache,
    QuerySignature,
    ServiceClosedError,
    ServiceMetrics,
)

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"
# (preset, threads): a symmetric machine (ties) and an asymmetric one
GROUPS = [("E7-4830v3-4s12c", 8), ("E5-2630v3-8c-throttled", 10)]


@pytest.fixture(scope="module")
def ref_service():
    svc = ref_serve.AdvisorService(max_wait_s=0.002)
    yield svc
    svc.close()


@pytest.fixture
def service():
    svc = AdvisorService(device=CPU, max_wait_s=0.002)
    yield svc
    svc.close()


def _port_objective(machine, sig: QuerySignature, n: int, placement) -> float:
    wl = sig.workload(n, device=CPU)
    res = port.simulate(machine, wl, torch.tensor(placement, dtype=torch.int32))
    return float(res.sample.instructions.sum())


def test_signature_pool_and_stream_match_reference():
    assert signature_pool(16, seed=3) == [
        QuerySignature(*s) for s in ref_signature_pool(16, seed=3)
    ]
    pool, fresh = signature_pool(8, seed=0), signature_pool(20, seed=7)
    got = mixed_stream(pool, fresh, 64, sweep_target=("m", 24))
    want = ref_mixed_stream(
        ref_signature_pool(8, seed=0), ref_signature_pool(20, seed=7), [], 64,
        sweep_target=("m", 24), search_target=None, search_fraction=0.0,
    )
    assert [(m, tuple(s), n) for m, s, n in got] == [(m, tuple(s), n) for m, s, n in want]


@pytest.mark.parametrize("name,n", GROUPS)
def test_answers_match_reference_service(ref_service, service, name, n):
    pm = port.MACHINES[name]
    sigs = signature_pool(12, seed=5)
    queries = [(pm, s, n) for s in sigs]
    got, _ = drive_threads(service, queries, n_workers=4)
    ref_queries = [(ref.MACHINES[name], ref_serve.QuerySignature(*s), n) for s in sigs]
    want = [ref_service.query(*q) for q in ref_queries]
    for sig, g, w in zip(sigs, got, want):
        assert g.tier == "batch" and g.optimal
        assert g.objective == pytest.approx(w.objective, rel=1e-5)
        assert g.predicted_bandwidth == pytest.approx(w.predicted_bandwidth, rel=1e-5)
        if g.placement != tuple(w.placement):
            # a tie: the reference's answer scores the same through the port
            assert sum(g.placement) == n
            assert _port_objective(pm, sig, n, w.placement) == pytest.approx(
                g.objective, rel=1e-5
            )
    if name.endswith("throttled"):  # no symmetric twins: the same placements
        assert [g.placement for g in got] == [tuple(w.placement) for w in want]


def test_main_path_group_matches_reference_on_one_batch(ref_service, service):
    """E7-4830 v3 at 24 threads, the advisor CLI's group: its 1469
    placements padded to a 2048-row table, one full micro-batch."""
    sigs = signature_pool(8, seed=11)
    futures = [service.submit(port.E7_4830_V3, s, 24) for s in sigs]
    got = [f.result(timeout=120) for f in futures]
    want = [ref_service.query(ref.E7_4830_V3, ref_serve.QuerySignature(*s), 24) for s in sigs]
    for g, w in zip(got, want):
        assert g.objective == pytest.approx(w.objective, rel=1e-5)
        assert g.predicted_bandwidth == pytest.approx(w.predicted_bandwidth, rel=1e-5)
    table = service._table_for(port.E7_4830_V3, service.register(port.E7_4830_V3), 24)
    assert tuple(table.placements.shape) == (2048, 4)


def test_concurrent_answers_identical_to_serial():
    pool = signature_pool(24, seed=2)
    queries = [(port.E7_4830_V3, s, 8) for s in pool]
    with AdvisorService(device=CPU, max_batch=8, max_wait_s=0.05) as svc:
        concurrent, _ = drive_threads(svc, queries * 2, n_workers=8)
        hist = svc.metrics.snapshot()["batch_size_hist"]
    with AdvisorService(device=CPU, max_batch=8) as svc:
        serial = [svc.query(*q) for q in queries]
    assert concurrent[: len(pool)] == serial
    assert concurrent[len(pool):] == serial
    assert sum(size * count for size, count in hist.items()) == len(pool)
    assert max(hist) > 1  # misses coalesced into shared batches


def test_cache_hit_returns_identical_object(service):
    sig = signature_pool(1, seed=21)[0]
    first = service.query(port.E5_2630_V3, sig, 8)
    # float noise below the canonical rounding shares the cache line
    jitter = QuerySignature(tuple(v + 1e-9 for v in sig.read_mix), sig.write_mix)
    assert service.query(port.E5_2630_V3, jitter, 8) is first
    fut = service.submit(port.E5_2630_V3, sig, 8)
    assert fut.done() and fut.result() is first
    assert service.metrics.snapshot()["tier_counts"]["cache"] == 2


def test_identical_inflight_queries_share_one_future(service):
    sig = signature_pool(1, seed=33)[0]
    futures = [service.submit(port.E7_4830_V3, sig, 12) for _ in range(6)]
    answers = {id(f.result(timeout=60)) for f in futures}
    assert len(answers) == 1
    assert service.metrics.snapshot()["batch_size_hist"] == {1: 1}


def test_lone_miss_answers_after_deadline():
    with AdvisorService(device=CPU, max_batch=8, max_wait_s=0.05) as svc:
        adv = svc.query(port.E5_2630_V3, signature_pool(1, seed=4)[0], 6, timeout=30)
        assert isinstance(adv, Advice)
        assert svc.metrics.snapshot()["batch_size_hist"] == {1: 1}


def test_steady_state_registers_no_new_shapes(service):
    handle = service.register(port.E7_4830_V3)
    service.warmup(handle, 8)
    pool = signature_pool(16, seed=0)
    for s in pool:
        service.query(handle, s, 8)
    service.metrics.reset(keep_traces=True)
    stream = mixed_stream(pool, signature_pool(40, seed=7), 120, sweep_target=(handle, 8))
    answers, _ = drive_threads(service, stream, n_workers=6)
    snap = service.metrics.snapshot()
    assert all(isinstance(a, Advice) for a in answers)
    assert snap["retraces"] == 0
    assert snap["tier_counts"]["cache"] + snap["tier_counts"]["batch"] == len(stream)
    json.dumps(snap)  # JSON-ready


def test_budget_past_sweep_limit_needs_the_search_tier():
    with AdvisorService(device=CPU, sweep_limit=100) as svc:
        assert svc.uses_search(port.E7_4830_V3, 24)
        with pytest.raises(NotImplementedError, match="search tier"):
            svc.query(port.E7_4830_V3, signature_pool(1)[0], 24)
        with pytest.raises(NotImplementedError, match="search tier"):
            svc.submit(port.E7_4830_V3, signature_pool(1)[0], 24)
        assert not svc.uses_search(port.E5_2630_V3, 8)


def test_tiers_not_ported_raise_naming_the_tier(service):
    sig = signature_pool(1)[0]
    with pytest.raises(NotImplementedError, match="deadline ladder"):
        service.query(port.E5_2630_V3, sig, 8, deadline_s=0.01)
    with pytest.raises(NotImplementedError, match="schedule tier"):
        service.query_schedule(port.E5_2630_V3, [(sig, 1.0)], 8)
    with pytest.raises(NotImplementedError, match="schedule tier"):
        service.submit_schedule(port.E5_2630_V3, [(sig, 1.0)], 8)
    handle = service.register(port.E5_2630_V3)
    with pytest.raises(NotImplementedError, match="hot-swap tier"):
        service.swap_machine(handle, port.E5_2630_V3_THROTTLED)
    with pytest.raises(NotImplementedError, match="hot-swap tier"):
        service.rollback_machine(handle)
    assert service.metrics.snapshot()["queries"] == 0  # nothing answered instead


def test_unknown_handle_raises(service):
    with pytest.raises(KeyError):
        service.query("no-such-machine", signature_pool(1)[0], 8)


def test_register_is_idempotent(service):
    h1 = service.register(port.E5_2630_V3)
    h2 = service.register(port.E5_2630_V3)
    assert h1 == h2 == port.E5_2630_V3.fingerprint()
    assert service.register(port.E5_2630_V3, machine_id="box-1") == "box-1"
    assert service.query("box-1", signature_pool(1)[0], 8).objective == pytest.approx(
        service.query(h1, signature_pool(1)[0], 8).objective
    )


def test_close_is_idempotent_drains_and_refuses():
    svc = AdvisorService(device=CPU, max_batch=8, max_wait_s=0.5)
    futures = [svc.submit(port.E7_4830_V3, s, 12) for s in signature_pool(20, seed=9)]
    closers = [threading.Thread(target=svc.close) for _ in range(3)]
    for t in closers:
        t.start()
    for t in closers:
        t.join(timeout=60)
        assert not t.is_alive()
    for f in futures:  # every future resolved: an answer or the close error
        exc = f.exception(timeout=10)
        assert exc is None or isinstance(exc, ServiceClosedError)
    svc.close()
    with pytest.raises(ServiceClosedError):
        svc.query(port.E5_2630_V3, signature_pool(1)[0], 8)
    with pytest.raises(ServiceClosedError):
        svc.submit(port.E5_2630_V3, signature_pool(1)[0], 8)


def test_batch_failure_resolves_waiters_and_keeps_serving(service, monkeypatch):
    import repro_torch.serve.service as svc_mod

    real = svc_mod._advise_batch

    def boom(*args, **kwargs):
        raise RuntimeError("injected")

    monkeypatch.setattr(svc_mod, "_advise_batch", boom)
    fut = service.submit(port.E5_2630_V3, signature_pool(1, seed=40)[0], 8)
    with pytest.raises(RuntimeError, match="injected"):
        fut.result(timeout=30)
    monkeypatch.setattr(svc_mod, "_advise_batch", real)
    assert isinstance(service.query(port.E5_2630_V3, signature_pool(1, seed=40)[0], 8), Advice)


def test_lru_cache_bounds_and_recency():
    c = LRUCache(capacity=3)
    for k in "abc":
        c.put(k, k.upper())
    assert c.get("a") == "A"
    c.put("d", "D")  # evicts 'b'
    assert "b" not in c and len(c) == 3
    assert c.keys() == ["c", "a", "d"]
    with pytest.raises(ValueError):
        LRUCache(capacity=0)


def test_lru_cache_thread_safety_hammer():
    c = LRUCache(capacity=32)
    errors = []

    def worker(base):
        try:
            for i in range(400):
                c.put((base, i % 50), i)
                c.get((base, (i * 7) % 50))
        except Exception as exc:  # pragma: no cover - reported below
            errors.append(exc)

    threads = [threading.Thread(target=worker, args=(b,)) for b in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not errors and len(c) <= 32


def test_metrics_snapshot_and_reset():
    m = ServiceMetrics(latency_window=8)
    m.record_query("cache", 1e-6)
    m.record_query("batch", 2e-3)
    m.record_batch(4)
    assert m.register_trace(("k", 1)) is True
    assert m.register_trace(("k", 1)) is False
    snap = m.snapshot()
    assert snap["tier_counts"]["cache"] == 1 and snap["tier_counts"]["batch"] == 1
    assert snap["batch_size_hist"] == {4: 1} and snap["retraces"] == 1
    m.reset(keep_traces=True)
    assert m.snapshot()["retraces"] == 0
    assert m.register_trace(("k", 1)) is False
    m.reset()
    assert m.register_trace(("k", 1)) is True


def test_future_type_and_query_timeout(service):
    fut = service.submit(port.E5_2630_V3, signature_pool(1, seed=50)[0], 4)
    assert isinstance(fut, Future)
    assert isinstance(fut.result(timeout=30), Advice)


def test_advisor_cli_runs_on_the_cpu_on_request(tmp_path):
    out = tmp_path / "snap.json"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.advisor_serve", "--device", "cpu",
         "--queries", "40", "--pool", "4", "--workers", "2", "--json", str(out)],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
             "OMP_NUM_THREADS": "2"},
    )
    assert proc.returncode == 0, proc.stderr
    snap = json.loads(out.read_text())
    assert snap["device"] == "cpu"
    assert snap["tier_counts"]["cache"] + snap["tier_counts"]["batch"] == 40
    assert snap["retraces"] == 0
    assert np.isfinite(snap["qps"])
