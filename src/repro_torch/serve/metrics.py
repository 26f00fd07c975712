"""Service instrumentation: per-tier counters, batch histogram, latency
(port of ``repro.serve.metrics``).

Every query the :class:`~repro_torch.serve.service.AdvisorService`
answers is accounted here, per tier.  The port serves two tiers so far:

* ``cache`` — tier-1 LRU answer-cache hits;
* ``batch`` — tier-2 micro-batched ``simulate_grouped_batch`` misses.

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

TIERS = ("cache", "batch")


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
            self.batch_sizes: Counter = Counter()
            self.batch_calls = 0
            self.retraces = 0
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

    def snapshot(self) -> dict:
        """A JSON-ready view: per-tier counts and p50/p99 latency (ms),
        batch-size histogram + mean, and the retrace counter."""
        with self._lock:
            counts = dict(self.tier_counts)
            sizes = dict(sorted(self.batch_sizes.items()))
            calls = self.batch_calls
            retraces = self.retraces
            restarts = self.worker_restarts
            lat = {
                tier: ring.values().copy()
                for tier, ring in self._latency.items()
            }
        out: dict = {
            "queries": sum(counts.values()),
            "tier_counts": counts,
            "batch_calls": calls,
            "batch_size_hist": sizes,
            "retraces": retraces,
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
