"""Service instrumentation: per-tier counters, batch histogram, latency
(port of ``repro.serve.metrics``).

Every query the :class:`~repro_torch.serve.service.AdvisorService`
answers is accounted here, per tier:

* ``cache`` — tier-1 LRU answer-cache hits;
* ``batch`` — tier-2 micro-batched ``simulate_grouped_batch`` misses;
* ``search`` — tier-3 warm-started branch and bound on machines past
  ``sweep_limit``;
* ``schedule`` — phased queries answered by the migration-aware
  scheduler;
* ``degraded`` — deadline-bounded answers served off the degradation
  ladder (signature-only ranking / last known good / even spread)
  instead of the exact tiers.

Orthogonally to the tier, every answer carries a *fidelity*
(``FIDELITIES``): ``exact`` off the cache, batch, search and schedule
tiers, ``ranked`` / ``stale`` / ``fallback`` off the ladder's three
rungs; ``degraded_rate`` in the snapshot is the non-exact share.  Spec
hot-swaps, guard rollbacks and batcher-thread restarts are counted too.

Latencies land in preallocated per-tier numpy ring buffers, and
percentiles are computed lazily in :meth:`ServiceMetrics.snapshot`.

The *retrace counter*: the reference counts jit traces.  PyTorch runs
eagerly and traces nothing, so the port counts what a later CUDA-graph
capture would key on — the distinct padded batch shapes seen per
``(machine, budget)`` group (query rows padded to ``max_batch``,
placement-table rows, support buckets).  A key seen for the first time
counts one; steady-state serving with every group warmed holds it at
zero, as the reference's gate does.
"""

from __future__ import annotations

import threading
from collections import Counter

import numpy as np

TIERS = ("cache", "batch", "search", "schedule", "degraded")

FIDELITIES = ("exact", "ranked", "stale", "fallback")


class _LatencyRing:
    """Fixed-size ring of the most recent latencies (seconds)."""

    def __init__(self, capacity: int):
        self._buf = np.zeros(capacity, np.float64)
        self._n = 0  # total samples ever recorded

    def record(self, seconds: float) -> None:
        self._buf[self._n % self._buf.shape[0]] = seconds
        self._n += 1

    def values(self) -> np.ndarray:
        return self._buf[: min(self._n, self._buf.shape[0])]

    @property
    def count(self) -> int:
        """Samples ever recorded (the ring keeps the latest ones)."""
        return self._n


class ServiceMetrics:
    """Thread-safe counters for one :class:`AdvisorService`.

    All mutation happens under one lock (each operation is a few
    dictionary or array updates).  ``snapshot`` returns plain python
    values so callers can JSON-serialize it directly.
    """

    def __init__(self, latency_window: int = 16384):
        self._lock = threading.Lock()
        self._latency_window = latency_window
        self.reset()

    def reset(self, *, keep_traces: bool = False) -> None:
        """Zero every counter.  ``keep_traces=True`` keeps the registered
        shape-key set (but zeroes the retrace count): the steady-state idiom
        — warm up, ``reset(keep_traces=True)``, serve, assert ``retraces
        == 0`` — only a genuinely new shape counts after the reset."""
        with self._lock:
            self.tier_counts = {tier: 0 for tier in TIERS}
            self.fidelity_counts = {f: 0 for f in FIDELITIES}
            self.batch_sizes: Counter = Counter()
            self.batch_calls = 0
            self.retraces = 0
            self.swaps = 0
            self.rollbacks = 0
            self.worker_restarts = 0
            if not keep_traces or not hasattr(self, "_trace_keys"):
                self._trace_keys: set = set()
            self._latency = {
                tier: _LatencyRing(self._latency_window) for tier in TIERS
            }

    # -- recording ---------------------------------------------------------

    def record_query(self, tier: str, seconds: float) -> None:
        """Count one answered query and its latency against ``tier``."""
        with self._lock:
            self.tier_counts[tier] += 1
            self._latency[tier].record(seconds)

    def record_fidelity(self, fidelity: str) -> None:
        """Count one served answer's fidelity (``exact`` / ``ranked`` /
        ``stale`` / ``fallback``)."""
        with self._lock:
            self.fidelity_counts[fidelity] += 1

    def record_swap(self) -> None:
        """Count one accepted spec hot-swap (epoch bump)."""
        with self._lock:
            self.swaps += 1

    def record_rollback(self) -> None:
        """Count one rejected or rolled-back recalibration."""
        with self._lock:
            self.rollbacks += 1

    def record_restart(self) -> None:
        """Count one self-healing batcher-thread restart."""
        with self._lock:
            self.worker_restarts += 1

    def record_batch(self, size: int) -> None:
        """Record one micro-batch flush of ``size`` coalesced queries."""
        with self._lock:
            self.batch_calls += 1
            self.batch_sizes[size] += 1

    def register_trace(self, key) -> bool:
        """Register a padded batch-shape key; returns True (and counts a
        retrace) iff the key is new.  Call *before* dispatching the batch
        so the counter reflects the shape about to run."""
        with self._lock:
            if key in self._trace_keys:
                return False
            self._trace_keys.add(key)
            self.retraces += 1
            return True

    # -- reading -----------------------------------------------------------

    def latency_percentiles(self, tier: str | None = None, qs=(50.0, 99.0)) -> dict[str, float]:
        """``{"p50": ..., "p99": ...}`` in seconds over the recent window
        of one tier (every tier pooled when ``tier`` is None); NaN where
        nothing was recorded."""
        with self._lock:
            if tier is None:
                vals = np.concatenate([ring.values() for ring in self._latency.values()])
            else:
                vals = self._latency[tier].values().copy()
        if vals.size == 0:
            return {f"p{q:g}": float("nan") for q in qs}
        return {f"p{q:g}": float(np.percentile(vals, q)) for q in qs}

    def snapshot(self) -> dict:
        """A JSON-ready view: per-tier counts and p50/p99 latency (ms),
        fidelity counts and the degraded rate, batch-size histogram + mean,
        and the retrace, swap, rollback and restart counters."""
        with self._lock:
            counts = dict(self.tier_counts)
            fidelity = dict(self.fidelity_counts)
            sizes = dict(sorted(self.batch_sizes.items()))
            calls = self.batch_calls
            retraces = self.retraces
            swaps = self.swaps
            rollbacks = self.rollbacks
            restarts = self.worker_restarts
            lat = {
                tier: ring.values().copy()
                for tier, ring in self._latency.items()
            }
        n_fid = sum(fidelity.values())
        out: dict = {
            "queries": sum(counts.values()),
            "tier_counts": counts,
            "fidelity_counts": fidelity,
            "degraded_rate": (n_fid - fidelity["exact"]) / n_fid if n_fid else 0.0,
            "batch_calls": calls,
            "batch_size_hist": sizes,
            "retraces": retraces,
            "swaps": swaps,
            "rollbacks": rollbacks,
            "worker_restarts": restarts,
        }
        total = sum(n * size for size, n in sizes.items())
        out["mean_batch_size"] = total / calls if calls else 0.0
        for tier, vals in lat.items():
            if vals.size:
                out[f"{tier}_p50_ms"] = float(np.percentile(vals, 50)) * 1e3
                out[f"{tier}_p99_ms"] = float(np.percentile(vals, 99)) * 1e3
        pooled = np.concatenate(list(lat.values()))
        if pooled.size:
            out["p50_ms"] = float(np.percentile(pooled, 50)) * 1e3
            out["p99_ms"] = float(np.percentile(pooled, 99)) * 1e3
        return out
