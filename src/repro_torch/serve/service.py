"""Placement advisor as a service: the micro-batched online query engine
(port of ``repro.serve.service``: the cache, batch, search and schedule
tiers).

Callers submit ``(workload signature, machine handle, thread budget)``
and get back a placement plus its predicted bandwidth and work rate:

1. **cache** — a thread-safe bounded LRU (:class:`~repro_torch.serve.
   cache.LRUCache`) keyed on the canonicalized query; a hit returns the
   already-allocated :class:`Advice` object.
2. **batch** — concurrent misses for the same ``(machine, budget)`` group
   coalesce in a pending queue; a batcher thread drains a group when it
   reaches ``max_batch`` or its oldest entry ages past ``max_wait_s``, and
   answers the whole batch in ONE :func:`~repro_torch.core.numa.simulator.
   simulate_grouped_batch` pass over the group's padded placement table,
   on the service's device.  Query rows are always padded to exactly
   ``max_batch``, so each group runs one shape, and a query's row never
   interacts with its batch-mates: answers equal serial evaluation.
3. **search** — a ``(machine, budget)`` whose composition count exceeds
   ``sweep_limit`` is answered by :func:`~repro_torch.core.numa.search.
   branch_and_bound`, warm-started from the advisor's signature-only
   ranking (``advisor_seeds``), on the ``advisor-search`` thread pool so
   searches never stall micro-batching.  A failed attempt retries after a
   backoff with a halved node budget.  The winner is scored through the
   batch tier's evaluator, so objective and bandwidth do not depend on
   the tier.

Phased queries (:meth:`AdvisorService.query_schedule`) take the
**schedule** tier: :func:`~repro_torch.core.numa.temporal.
optimize_schedule` on the search pool, cached and deduplicated like
one-shot queries.

Two resilience layers sit on top:

**Spec epochs and hot-swap.**  The registry maps a stable *handle* (the
fingerprint at registration, or a caller-chosen ``machine_id``) to a
``(spec, epoch)`` entry.  :meth:`AdvisorService.swap_machine` installs a
recalibrated spec under the same handle with a bumped epoch; every
answer key, pending-group key and table key carries the epoch, so
in-flight queries finish on the spec they started with (the pending
group pins the spec object) and invalidation is per machine.  The new
epoch's placement tables are built and one padded batch runs on the new
spec before the flip, and their shape keys are registered then, so the
first post-swap queries find a warmed path.
:meth:`AdvisorService.rollback_machine` restores the previous spec as a
new epoch.

**Deadlines and the degradation ladder.**  A query may carry
``deadline_s`` (or inherit ``default_deadline_s``); when the exact tiers
cannot answer in time, or fail, the service walks down a fidelity
ladder instead of blocking: ``exact`` → ``ranked`` (signature-only
roofline via :func:`~repro_torch.core.meshsig.advisor.
rank_numa_placements`, no simulation) → ``stale`` (this handle's last
known good exact answer) → ``fallback`` (an even spread).  Every
:class:`Advice` is tagged with its fidelity, and degraded answers are
never cached.  The ranked rung runs on a thread of its own
(``advisor-rank``) under a time budget (:data:`RANK_BUDGET_S`) counted
past the query's deadline from the query's own start: past it, the next
rung answers, so a degraded answer comes within the query's deadline plus
that budget even when the rung's many small tensor operations wait for the
interpreter lock behind the batcher and a running search (the reference's
rung runs inline).  Fault injection
(:mod:`repro_torch.serve.faults`) hooks the batcher, the batch dispatch,
the search attempts, the ranked rung, the schedule worker and the
deadline clock.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import DEFAULT_DEVICE, resolve_device
from repro_torch.core.meshsig.advisor import rank_numa_placements
from repro_torch.core.numa.evaluate import placement_array
from repro_torch.core.numa.machine import MachineSpec
from repro_torch.core.numa.search import branch_and_bound
from repro_torch.core.numa.simulator import (
    pad_rows,
    simulate_grouped_batch,
    support_patterns,
)
from repro_torch.core.numa.temporal import (
    MigrationModel,
    optimize_schedule,
    phased_workload,
)
from repro_torch.core.numa.workload import Workload, mixed_workload
from repro_torch.serve.cache import LRUCache
from repro_torch.serve.faults import NO_FAULTS, FaultInjector
from repro_torch.serve.metrics import ServiceMetrics

_log = logging.getLogger(__name__)


class ServiceClosedError(RuntimeError):
    """Raised by every entry point of a closed :class:`AdvisorService`,
    and set on any future the close drained rather than resolved — a type
    of its own, so callers tell an orderly shutdown from a compute
    failure (which degrades or propagates, depending on the deadline)."""


class QuerySignature(NamedTuple):
    """The model-representable description of a workload — the paper's
    4-class signature phrased as a query, uniform across threads."""

    read_mix: tuple[float, float, float]  # (static, local, per-thread)
    write_mix: tuple[float, float, float]
    read_bpi: float = 0.6
    write_bpi: float = 0.2
    static_socket: int = 0

    def canonical(self) -> "QuerySignature":
        """Round-trip through rounded floats so queries that differ only
        in float noise share a cache line."""
        return QuerySignature(
            tuple(round(float(v), 6) for v in self.read_mix),
            tuple(round(float(v), 6) for v in self.write_mix),
            round(float(self.read_bpi), 6),
            round(float(self.write_bpi), 6),
            int(self.static_socket),
        )

    def workload(
        self, n_threads: int, name: str = "serve", *, device=DEFAULT_DEVICE
    ) -> Workload:
        """Materialize the signature as an ``n_threads`` uniform workload."""
        return mixed_workload(
            name,
            n_threads,
            read_mix=self.read_mix,
            write_mix=self.write_mix,
            read_bpi=self.read_bpi,
            write_bpi=self.write_bpi,
            static_socket=self.static_socket,
            device=device,
        )


@dataclass(frozen=True)
class Advice:
    """One answered query.  ``tier`` names the tier that *computed* the
    answer; a later cache hit returns this same object.  ``fidelity`` is
    the ladder rung that produced it (``exact`` off the normal tiers) and
    ``epoch`` the spec version it was computed against."""

    placement: tuple[int, ...]  # threads per NUMA node
    predicted_bandwidth: float  # total bytes/s moved at this placement
    objective: float  # work rate (instructions/s), the quantity maximized
    tier: str  # "batch" | "search" | "degraded"
    optimal: bool  # exhaustive sweep, or B&B certificate within its gap
    fidelity: str = "exact"  # "exact" | "ranked" | "stale" | "fallback"
    epoch: int = 0  # spec epoch the answer was computed against


@dataclass(frozen=True)
class ScheduleAdvice:
    """One answered *phased* query: a placement (and page placement) per
    phase plus the scheduler's receipts.  ``gain_pct`` is the improvement
    over holding the best static placement for the whole horizon."""

    placements: tuple[tuple[int, ...], ...]  # per-phase threads per node
    bank_assignments: tuple  # per-phase bank maps (None = node-local)
    total_work: float  # instructions over the horizon
    static_work: float  # best static placement's instructions
    gain_pct: float
    transition_times: tuple[float, ...]  # boundary stalls (seconds)
    tier: str = "schedule"


class _MachineEntry(NamedTuple):
    """Registry slot: the live spec, its epoch, and the previous entry
    (one step of history — what :meth:`AdvisorService.rollback_machine`
    restores)."""

    spec: MachineSpec
    epoch: int
    previous: "_MachineEntry | None"


class _PlacementTable(NamedTuple):
    """Per-``(machine, budget)`` candidate set, padded once at build time
    to a power-of-two row count so every batch against it has one shape."""

    placements: torch.Tensor  # (P_pad, s) on the service's device
    placements_np: np.ndarray  # host copy for answer extraction
    support: torch.Tensor  # (n_buckets, s)
    slab_id: torch.Tensor  # (P_pad,)


class _RecordedFuture(Future):
    """An in-flight answer whose queries' metrics are recorded before any
    waiter wakes (``add_done_callback`` runs after the waiters, so a
    caller could see the answer, reset the metrics and then have the
    answer counted)."""

    def __init__(self) -> None:
        super().__init__()
        self.recorders: list = []

    def set_result(self, result) -> None:
        if not self.done():  # close() may have failed it already
            for record in self.recorders:
                # one raising recorder neither drops the others nor keeps
                # the answer unresolved; logged as a failing done-callback is
                try:
                    record(result)
                except Exception:
                    _log.exception("a metrics recorder of %r raised", self)
        super().set_result(result)


class _Pending(NamedTuple):
    key: tuple  # full answer-cache key
    sig: QuerySignature  # canonical
    future: Future
    t0: float  # enqueue time (monotonic) — anchors the batch deadline


class _PendingGroup(NamedTuple):
    """One coalescing group's queue plus its epoch-pinned spec: the batch
    worker answers from this spec even if a hot-swap lands while the
    group waits, so no batch straddles two epochs."""

    spec: MachineSpec
    items: list  # list[_Pending], mutated in place under the service lock


def _advise_batch(
    machine: MachineSpec,
    workloads: Workload,  # fields with a leading query axis W
    table: _PlacementTable,
    thread_classes: tuple[int, ...],
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Answer a whole micro-batch in one pass: the shared-slab grouped
    sweep over (queries x placements), the argmax work rate per query,
    and the winner's total flow.  Rows are independent, so a query's
    answer does not depend on its batch-mates."""
    sim = simulate_grouped_batch(
        machine,
        workloads,
        table.placements,
        thread_classes=thread_classes,
        support=table.support,
        slab_id=table.slab_id,
    )
    obj = sim.instructions.sum(-1)  # (W, P)
    best = torch.argmax(obj, dim=-1)  # (W,) first maximum, as jnp.argmax
    rows = torch.arange(obj.shape[0], device=obj.device)
    bandwidth = sim.read_flows[rows, best].sum((-2, -1)) + sim.write_flows[
        rows, best
    ].sum((-2, -1))
    return best, obj[rows, best], bandwidth


# How far past its deadline a degraded query waits for the ranked rung,
# counted from the query's start, before the next rung answers.  The rung
# takes 15-24 ms on an idle H100 service and up to 0.47 s in the chaos
# record while a search runs (PERF.md §6); a 0.25 s deadline plus 0.5 s
# leaves the record's 1 s grace half a second for a waiter that wakes late.
RANK_BUDGET_S = 0.5


class AdvisorService:
    """Online placement advisor over a registry of machines, computing on
    ``device`` (``"cuda"`` unless the caller asks for the CPU).

    Thread-safe: any number of caller threads may :meth:`query` /
    :meth:`submit` concurrently.  Answers equal serial evaluation because
    batch rows never interact and padding always lands on the same shape.
    ``sweep_limit`` is the largest composition count the batch tier
    sweeps; larger ``(machine, budget)`` groups go to warm-started branch
    and bound (``search_*``, ``advisor_*``) on ``search_workers`` threads.

    ``default_deadline_s`` (None = wait forever) arms the degradation
    ladder for every query without its own ``deadline_s``; ``faults``
    installs a :class:`~repro_torch.serve.faults.FaultInjector` whose
    clock the deadline math reads and whose sites the workers fire.
    """

    def __init__(
        self,
        *,
        device=DEFAULT_DEVICE,
        answer_capacity: int = 4096,
        table_capacity: int = 16,
        max_batch: int = 8,
        max_wait_s: float = 0.002,
        sweep_limit: int = 20_000,
        search_gap: float = 0.05,
        search_max_nodes: int = 50_000,
        search_retries: int = 2,
        search_backoff_s: float = 0.01,
        search_min_nodes: int = 500,
        advisor_seeds: int = 8,
        advisor_max_placements: int = 2048,
        search_workers: int = 2,
        default_deadline_s: float | None = None,
        lkg_capacity: int = 1024,
        faults: FaultInjector | None = None,
        metrics: ServiceMetrics | None = None,
    ):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.device = resolve_device(device)
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_s)
        self.sweep_limit = int(sweep_limit)
        self.search_gap = float(search_gap)
        self.search_max_nodes = int(search_max_nodes)
        self.search_retries = int(search_retries)
        self.search_backoff_s = float(search_backoff_s)
        self.search_min_nodes = int(search_min_nodes)
        self.advisor_seeds = int(advisor_seeds)
        self.advisor_max_placements = int(advisor_max_placements)
        self.default_deadline_s = (
            None if default_deadline_s is None else float(default_deadline_s)
        )
        self.metrics = metrics if metrics is not None else ServiceMetrics()
        self.faults = faults if faults is not None else NO_FAULTS

        self._machines: dict[str, _MachineEntry] = {}
        self._answers = LRUCache(answer_capacity)
        self._tables = LRUCache(table_capacity)
        # last-known-good exact answers, keyed without the epoch and not
        # invalidated on a swap: a stale answer is the ladder's point
        self._lkg = LRUCache(lkg_capacity)
        self._cond = threading.Condition()
        # group key (handle, epoch, n_threads) -> epoch-pinned queue
        self._pending: dict[tuple, _PendingGroup] = {}
        # answer key -> Future, so concurrent identical misses compute once
        self._inflight: dict[tuple, Future] = {}
        self._closed = False
        self._close_started = False
        self._close_done = threading.Event()
        self._search_pool = ThreadPoolExecutor(
            max_workers=max(1, int(search_workers)),
            thread_name_prefix="advisor-search",
        )
        # the ladder's ranked rung, so a query can stop waiting for it
        self._rank_pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="advisor-rank")
        self._batcher = threading.Thread(
            target=self._batcher_main, name="advisor-batcher", daemon=True
        )
        self._batcher.start()

    # -- registry ------------------------------------------------------------

    def register(self, machine: MachineSpec, machine_id: str | None = None) -> str:
        """Add a machine to the registry; returns its *handle* (its
        fingerprint, or ``machine_id`` if given).  Idempotent: a handle
        already registered is returned as is, so re-presenting the
        original spec after a hot-swap does not clobber the swapped one."""
        handle = machine_id if machine_id is not None else machine.fingerprint()
        with self._cond:
            if handle not in self._machines:
                self._machines[handle] = _MachineEntry(machine, 0, None)
        return handle

    def _entry(self, handle: str) -> _MachineEntry:
        with self._cond:
            entry = self._machines.get(handle)
        if entry is None:
            raise KeyError(f"unknown machine handle {handle!r}")
        return entry

    def _resolve(self, machine) -> tuple[MachineSpec, str, int]:
        """``machine`` (spec or handle) -> the live ``(spec, handle,
        epoch)`` a query pins itself to."""
        handle = machine if isinstance(machine, str) else self.register(machine)
        entry = self._entry(handle)
        return entry.spec, handle, entry.epoch

    def epoch_of(self, handle: str) -> int:
        """The registry's current spec epoch for ``handle`` (bumped by
        every accepted swap and every rollback)."""
        return self._entry(handle).epoch

    def machine_spec(self, handle: str) -> MachineSpec:
        """The live spec currently serving ``handle``."""
        return self._entry(handle).spec

    # -- hot swap ------------------------------------------------------------

    def swap_machine(self, handle: str, new_spec: MachineSpec, *, warm: bool = True) -> int:
        """Atomically install ``new_spec`` under ``handle`` with a bumped
        epoch; returns the new epoch.

        In-flight queries are untouched (their pending groups pinned the
        old spec).  Answers and placement tables are invalidated for this
        handle only.  ``warm=True`` builds the new epoch's tables for
        every budget the handle serves and runs one padded batch on the
        new spec before the swap is visible.  Raises ValueError when the
        node or core count changes: recalibration refits bandwidths, not
        structure."""
        with self._cond:
            if self._closed:
                raise ServiceClosedError("AdvisorService is closed")
        old = self._entry(handle).spec
        if (new_spec.n_nodes != old.n_nodes
                or new_spec.cores_per_node != old.cores_per_node):
            raise ValueError(
                f"swap for {handle!r} changes machine structure "
                f"({old.n_nodes}x{old.cores_per_node} -> "
                f"{new_spec.n_nodes}x{new_spec.cores_per_node}); "
                "register a new machine instead"
            )
        new_epoch = self._install_spec(handle, new_spec, warm=warm)
        self.metrics.record_swap()
        return new_epoch

    def rollback_machine(self, handle: str, *, warm: bool = True) -> int:
        """Restore ``handle``'s previous spec as a *new* epoch (epochs only
        move forward).  Raises RuntimeError when there is none."""
        entry = self._entry(handle)
        if entry.previous is None:
            raise RuntimeError(f"machine {handle!r} has no previous spec")
        new_epoch = self._install_spec(handle, entry.previous.spec, warm=warm)
        self.metrics.record_rollback()
        return new_epoch

    def _install_spec(self, handle: str, new_spec: MachineSpec, *, warm: bool) -> int:
        # warm the new spec against the budgets this handle serves before
        # the swap becomes visible: its tables, and one padded batch
        warmed: list[tuple[int, _PlacementTable]] = []
        if warm:
            budgets = sorted({k[2] for k in self._tables.keys() if k[0] == handle})
            for n_threads in budgets:
                table = self._build_table(new_spec, n_threads)
                workloads = self._stacked_workloads(
                    [QuerySignature((1.0, 0.0, 0.0), (1.0, 0.0, 0.0))], n_threads
                )
                _advise_batch(new_spec, workloads, table, (0,))
                warmed.append((n_threads, table))
        with self._cond:
            entry = self._machines[handle]
            new_epoch = entry.epoch + 1
            self._machines[handle] = _MachineEntry(new_spec, new_epoch, entry)
        # per-machine invalidation after the flip, so no window serves a
        # stale answer against the new epoch
        self._answers.pop_where(lambda k: k[0] == handle and k[1] != new_epoch)
        self._tables.pop_where(lambda k: k[0] == handle and k[1] != new_epoch)
        for n_threads, table in warmed:
            self._tables.put((handle, new_epoch, n_threads), table)
            self.metrics.register_trace(self._trace_key(handle, new_epoch, n_threads, table))
        return new_epoch

    # -- public front ends ---------------------------------------------------

    def query(self, machine, signature: QuerySignature, n_threads: int,
              timeout: float | None = None, *,
              deadline_s: float | None = None) -> Advice:
        """Synchronous ask-and-wait.  ``machine`` is a MachineSpec or a
        registered handle.

        ``deadline_s`` (falling back to ``default_deadline_s``) bounds the
        wait: past the deadline, or if the exact computation fails, the
        answer comes off the degradation ladder instead of blocking or
        raising.  Without a deadline, ``timeout`` raises on expiry.  A
        closed service raises :class:`ServiceClosedError` either way."""
        if deadline_s is None:
            deadline_s = self.default_deadline_s
        t_deadline = None if deadline_s is None else self.faults.now() + deadline_s
        t0 = time.perf_counter()
        advice, future = self._lookup_or_dispatch(
            machine, signature, n_threads, deadline_s=deadline_s
        )
        if advice is not None:
            return advice
        if t_deadline is None:
            return future.result(timeout)
        try:
            return future.result(max(t_deadline - self.faults.now(), 0.0))
        except ServiceClosedError:
            raise
        except BaseException:
            # deadline expired or the exact tier failed: degrade
            spec, handle, epoch = self._resolve(machine)
            return self._degrade(
                spec, handle, epoch, signature.canonical(), int(n_threads), t0,
                t0 + deadline_s + RANK_BUDGET_S,
            )

    def submit(self, machine, signature: QuerySignature, n_threads: int) -> Future:
        """Async front end: a Future resolving to the :class:`Advice`
        (already resolved on a cache hit).  Futures carry no deadline:
        the ladder is a :meth:`query`-side policy."""
        advice, future = self._lookup_or_dispatch(machine, signature, n_threads)
        if advice is not None:
            future = Future()
            future.set_result(advice)
        return future

    def _lookup_or_dispatch(self, machine, signature, n_threads,
                            deadline_s: float | None = None):
        t0 = time.perf_counter()
        if self._closed:
            raise ServiceClosedError("AdvisorService is closed")
        spec, handle, epoch = self._resolve(machine)
        sig = signature.canonical()
        key = (handle, epoch, int(n_threads), sig)
        hit = self._answers.get(key)
        if hit is not None:
            self.metrics.record_query("cache", time.perf_counter() - t0)
            self.metrics.record_fidelity(hit.fidelity)
            return hit, None
        with self._cond:
            if self._closed:
                raise ServiceClosedError("AdvisorService is closed")
            # re-check under the dispatch lock: a batch completion inserts
            # into the answer cache *before* retiring its in-flight future
            hit = self._answers.get(key)
            if hit is not None:
                self.metrics.record_query("cache", time.perf_counter() - t0)
                self.metrics.record_fidelity(hit.fidelity)
                return hit, None
            future = self._inflight.get(key)
            if future is None:
                future = _RecordedFuture()
                self._inflight[key] = future
                if self.uses_search(spec, n_threads):
                    self._search_pool.submit(
                        self._run_search, spec, handle, epoch, int(n_threads), sig,
                        key, future, deadline_s,
                    )
                else:
                    group = (handle, epoch, int(n_threads))
                    pg = self._pending.get(group)
                    if pg is None:
                        pg = _PendingGroup(spec, [])
                        self._pending[group] = pg
                    pg.items.append(_Pending(key, sig, future, time.perf_counter()))
                    self._cond.notify_all()
            # under the dispatch lock, so the completion (which retires the
            # key under it first) runs this query's recorder
            future.recorders.append(lambda adv: self._record(adv, t0))
        return None, future

    def _record(self, adv, t0: float) -> None:
        self.metrics.record_query(adv.tier, time.perf_counter() - t0)
        self.metrics.record_fidelity(getattr(adv, "fidelity", "exact"))

    # -- degradation ladder ----------------------------------------------------

    def _degrade(self, spec: MachineSpec, handle: str, epoch: int,
                 sig: QuerySignature, n_threads: int, t0: float,
                 t_rank_end: float) -> Advice:
        """Serve a deadline-missed query off the ladder: signature-only
        ranking → last known good exact answer → even spread.  Never
        blocks on the simulator, waits for the ranking (on the
        ``advisor-rank`` thread, on the service's device) until
        ``t_rank_end`` on the ``time.perf_counter`` clock (a ranking not
        yet started then is cancelled, one under way finishes unread) and
        never caches its answer (the next identical query retries the
        exact path)."""
        advice = None
        try:
            ranking = self._rank_pool.submit(self._rank, spec, sig, n_threads)
            try:
                best = ranking.result(max(0.0, t_rank_end - time.perf_counter()))
            finally:
                ranking.cancel()
            advice = Advice(
                placement=best.placement,
                predicted_bandwidth=float("nan"),
                objective=float(best.predicted_throughput),
                tier="degraded",
                optimal=False,
                fidelity="ranked",
                epoch=epoch,
            )
        except BaseException:
            lkg = self._lkg.get((handle, n_threads, sig))
            if lkg is None:
                lkg = self._lkg.get(("any", handle, n_threads))
            if lkg is not None:
                advice = dataclasses.replace(lkg, tier="degraded", fidelity="stale")
        if advice is None:
            base, extra = divmod(int(n_threads), spec.n_nodes)
            advice = Advice(
                placement=tuple(base + (1 if i < extra else 0) for i in range(spec.n_nodes)),
                predicted_bandwidth=float("nan"),
                objective=float("nan"),
                tier="degraded",
                optimal=False,
                fidelity="fallback",
                epoch=epoch,
            )
        self.metrics.record_query("degraded", time.perf_counter() - t0)
        self.metrics.record_fidelity(advice.fidelity)
        return advice

    def _rank(self, spec: MachineSpec, sig: QuerySignature, n_threads: int):
        """The ranked rung's pick: the best placement of the signature-only
        ranking."""
        self.faults.fire("rank")
        return rank_numa_placements(
            spec, sig.workload(n_threads, device=self.device), top_k=1,
            max_placements=self.advisor_max_placements,
        )[0]

    # -- phased queries --------------------------------------------------------

    @staticmethod
    def _canonical_phases(phases) -> tuple:
        """``(signature, duration)`` pairs with rounded signatures and
        durations, so float-noise variants of one schedule share a cache
        line."""
        canon = tuple((sig.canonical(), round(float(dur), 6)) for sig, dur in phases)
        if not canon:
            raise ValueError("phased query needs at least one phase")
        return canon

    def query_schedule(self, machine, phases, n_threads: int, *,
                       model: MigrationModel | None = None,
                       timeout: float | None = None) -> ScheduleAdvice:
        """Synchronous phased query: ``phases`` is a sequence of
        ``(QuerySignature, duration_s)`` pairs.  Answers with one placement
        (and bank assignment) per phase from the migration-aware
        scheduler, computed on the search pool; cached and deduplicated
        like one-shot queries."""
        advice, future = self._dispatch_schedule(machine, phases, n_threads, model)
        if advice is not None:
            return advice
        return future.result(timeout)

    def submit_schedule(self, machine, phases, n_threads: int, *,
                        model: MigrationModel | None = None) -> Future:
        """Async twin of :meth:`query_schedule`: a Future resolving to the
        :class:`ScheduleAdvice`."""
        advice, future = self._dispatch_schedule(machine, phases, n_threads, model)
        if advice is not None:
            future = Future()
            future.set_result(advice)
        return future

    def _dispatch_schedule(self, machine, phases, n_threads, model):
        t0 = time.perf_counter()
        if self._closed:
            raise ServiceClosedError("AdvisorService is closed")
        spec, handle, epoch = self._resolve(machine)
        model = model if model is not None else MigrationModel()
        canon = self._canonical_phases(phases)
        key = (handle, epoch, int(n_threads), "schedule", canon, model)
        hit = self._answers.get(key)
        if hit is not None:
            self.metrics.record_query("cache", time.perf_counter() - t0)
            self.metrics.record_fidelity("exact")
            return hit, None
        with self._cond:
            if self._closed:
                raise ServiceClosedError("AdvisorService is closed")
            hit = self._answers.get(key)
            if hit is not None:
                self.metrics.record_query("cache", time.perf_counter() - t0)
                self.metrics.record_fidelity("exact")
                return hit, None
            future = self._inflight.get(key)
            if future is None:
                future = _RecordedFuture()
                self._inflight[key] = future
                self._search_pool.submit(
                    self._run_schedule, spec, int(n_threads), canon, model, key, future
                )
            future.recorders.append(lambda adv: self._record(adv, t0))
        return None, future

    def _run_schedule(self, machine: MachineSpec, n_threads: int, canon: tuple,
                      model: MigrationModel, key: tuple, future: Future) -> None:
        try:
            self.faults.fire("schedule")
            pw = phased_workload(
                "serve-schedule",
                [
                    (sig.workload(n_threads, name=f"phase{i}", device=self.device), dur)
                    for i, (sig, dur) in enumerate(canon)
                ],
            )
            result = optimize_schedule(machine, pw, model=model, sweep_limit=self.sweep_limit)
            advice = ScheduleAdvice(
                placements=result.schedule.placements,
                bank_assignments=result.schedule.bank_assignments,
                total_work=result.schedule.total_work,
                static_work=result.static.total_work,
                gain_pct=result.gain_pct,
                transition_times=result.schedule.transition_times,
            )
            self._finish(key, future, advice)
        except BaseException as exc:
            self._fail([(key, future)], exc)

    # -- tier selection & placement tables ------------------------------------

    def uses_search(self, machine: MachineSpec, n_threads: int) -> bool:
        """True when the full composition space of ``n_threads`` over the
        machine's nodes is too large to sweep (the search tier)."""
        s = machine.n_nodes
        return math.comb(int(n_threads) + s - 1, s - 1) > self.sweep_limit

    def _build_table(self, machine: MachineSpec, n_threads: int) -> _PlacementTable:
        return self._padded_table(placement_array(machine, n_threads))

    def _padded_table(self, placements: np.ndarray) -> _PlacementTable:
        padded = pad_rows(placements)
        support, slab_id = support_patterns(padded)
        return _PlacementTable(
            placements=torch.as_tensor(padded, device=self.device),
            placements_np=padded,
            support=torch.as_tensor(support, device=self.device),
            slab_id=torch.as_tensor(slab_id, device=self.device).to(torch.int64),
        )

    def _table_for(self, machine: MachineSpec, handle: str, n_threads: int,
                   epoch: int = 0) -> _PlacementTable:
        key = (handle, epoch, n_threads)
        table = self._tables.get(key)
        if table is None:
            table = self._build_table(machine, n_threads)
            self._tables.put(key, table)
        return table

    # -- batch tier ------------------------------------------------------------

    def _batcher_main(self) -> None:
        """Self-healing wrapper: a crash anywhere in the batcher loop loses
        nothing (the pending queues are untouched) and the loop restarts
        unless the service is closing."""
        while True:
            try:
                self._batch_loop()
                return  # orderly exit: closed and drained
            except BaseException:
                with self._cond:
                    if self._closed:
                        return
                self.metrics.record_restart()

    def _batch_loop(self) -> None:
        while True:
            self.faults.fire("batcher")
            with self._cond:
                while not self._pending and not self._closed:
                    self._cond.wait()
                if not self._pending and self._closed:
                    return
                gkey = min(self._pending, key=lambda g: self._pending[g].items[0].t0)
                group = self._pending[gkey]
                deadline = group.items[0].t0 + self.max_wait_s
                now = time.perf_counter()
                if (
                    len(group.items) < self.max_batch
                    and now < deadline
                    and not self._closed
                ):
                    self._cond.wait(deadline - now)
                    continue
                take = group.items[: self.max_batch]
                rest = group.items[self.max_batch:]
                if rest:
                    self._pending[gkey] = _PendingGroup(group.spec, rest)
                else:
                    del self._pending[gkey]
            self._run_batch(gkey, group.spec, take)

    def _stacked_workloads(self, sigs: list[QuerySignature], n: int) -> Workload:
        """Per-query uniform workload rows, the query axis padded to
        exactly ``max_batch`` by repeating the first row — one shape per
        group, whatever the live batch size."""
        def column(values, dtype):
            col = pad_rows(np.asarray(values, dtype), base=self.max_batch)
            return torch.as_tensor(col, device=self.device)

        def rows(values):
            per_query = column(values, np.float32)[:, None]
            return per_query.expand(per_query.shape[0], n).contiguous()

        return Workload(
            "serve",
            rows([s.read_mix[0] for s in sigs]),
            rows([s.read_mix[1] for s in sigs]),
            rows([s.read_mix[2] for s in sigs]),
            rows([s.write_mix[0] for s in sigs]),
            rows([s.write_mix[1] for s in sigs]),
            rows([s.write_mix[2] for s in sigs]),
            rows([s.read_bpi for s in sigs]),
            rows([s.write_bpi for s in sigs]),
            column([s.static_socket for s in sigs], np.int32),
        )

    def _finish(self, key: tuple, future: Future, advice) -> None:
        # answer cache first, in-flight retirement second: every moment a
        # key is absent from the in-flight map it is present in the cache
        self._answers.put(key, advice)
        if isinstance(advice, Advice) and advice.fidelity == "exact":
            handle, _, n_threads, sig = key[:4]
            self._lkg.put((handle, n_threads, sig), advice)
            self._lkg.put(("any", handle, n_threads), advice)
        with self._cond:
            self._inflight.pop(key, None)
        try:
            future.set_result(advice)
        except Exception:
            pass  # close() already failed this future; the cache has it

    def _fail(self, keys_futures, exc: BaseException) -> None:
        with self._cond:
            for key, _ in keys_futures:
                self._inflight.pop(key, None)
        for _, future in keys_futures:
            try:
                future.set_exception(exc)
            except Exception:
                pass  # already resolved (e.g. by a concurrent close)

    def _run_batch(self, gkey: tuple, machine: MachineSpec,
                   take: list[_Pending]) -> None:
        handle, epoch, n_threads = gkey
        try:
            self.faults.fire("batch")
            table = self._table_for(machine, handle, n_threads, epoch)
            workloads = self._stacked_workloads([it.sig for it in take], n_threads)
            self.metrics.register_trace(self._trace_key(handle, epoch, n_threads, table))
            best, obj, bandwidth = _advise_batch(machine, workloads, table, (0,))
            best = best.cpu().numpy()
            obj = obj.cpu().numpy()
            bandwidth = bandwidth.cpu().numpy()
            self.metrics.record_batch(len(take))
            for i, item in enumerate(take):
                advice = Advice(
                    placement=tuple(int(v) for v in table.placements_np[int(best[i])]),
                    predicted_bandwidth=float(bandwidth[i]),
                    objective=float(obj[i]),
                    tier="batch",
                    optimal=True,
                    epoch=epoch,
                )
                self._finish(item.key, item.future, advice)
        except BaseException as exc:  # resolve waiters, keep the loop alive
            self._fail([(it.key, it.future) for it in take], exc)

    def _trace_key(self, handle: str, epoch: int, n_threads: int,
                   table: _PlacementTable) -> tuple:
        return (
            handle,
            epoch,
            n_threads,
            self.max_batch,
            int(table.placements.shape[0]),
            int(table.support.shape[0]),
        )

    # -- search tier -----------------------------------------------------------

    def _run_search(self, machine: MachineSpec, handle: str, epoch: int,
                    n_threads: int, sig: QuerySignature, key: tuple,
                    future: Future, deadline_s: float | None = None) -> None:
        wl = sig.workload(n_threads, device=self.device)
        # deadline-aware node budget: a query with a fifth of the 5 s
        # horizon gets a fifth of the nodes — B&B returns its certified
        # incumbent at any budget, so a cut degrades the certificate only
        max_nodes = self.search_max_nodes
        if deadline_s is not None:
            frac = min(1.0, max(deadline_s, 0.0) / 5.0)
            max_nodes = max(self.search_min_nodes, int(max_nodes * frac))
        result = None
        for attempt in range(self.search_retries + 1):
            try:
                self.faults.fire("search")
                result = branch_and_bound(
                    machine,
                    wl,
                    gap=self.search_gap,
                    max_nodes=max_nodes,
                    advisor_seeds=self.advisor_seeds,
                    advisor_max_placements=self.advisor_max_placements,
                )
                break
            except BaseException as exc:
                if attempt >= self.search_retries:
                    self._fail([(key, future)], exc)
                    return
                # back off, then retry on a cut node budget: a transient
                # stall is ridden out, a slow search lands on a cheaper
                # certified incumbent
                time.sleep(self.search_backoff_s * (2 ** attempt))
                max_nodes = max(self.search_min_nodes, max_nodes // 2)
        try:
            # score the winner through the batch tier's evaluator, so
            # objective and bandwidth do not depend on the tier
            table = self._padded_table(np.asarray(result.placement, np.int32)[None, :])
            workloads = self._stacked_workloads([sig], n_threads)
            self.metrics.register_trace(self._trace_key(handle, epoch, n_threads, table))
            _, obj, bandwidth = _advise_batch(machine, workloads, table, (0,))
            advice = Advice(
                placement=tuple(int(v) for v in result.placement),
                predicted_bandwidth=float(bandwidth[0]),
                objective=float(obj[0]),
                tier="search",
                optimal=result.optimal,
                epoch=epoch,
            )
            self._finish(key, future, advice)
        except BaseException as exc:
            self._fail([(key, future)], exc)

    # -- warmup & lifecycle ------------------------------------------------------

    def warmup(self, machine, n_threads: int,
               signature: QuerySignature | None = None) -> Advice:
        """Run a ``(machine, budget)`` group's single steady-state shape
        (building its placement table, or on a search-tier machine
        answering one search) by answering one query; also prime the
        ladder's ranked rung (its signature fit), so a deadline miss
        does not pay for it."""
        sig = signature if signature is not None else QuerySignature(
            (0.25, 0.25, 0.25), (0.25, 0.25, 0.25)
        )
        advice = self.query(machine, sig, n_threads)
        spec, _, _ = self._resolve(machine)
        rank_numa_placements(
            spec, sig.canonical().workload(int(n_threads), device=self.device), top_k=1,
            max_placements=self.advisor_max_placements,
        )
        return advice

    def close(self, timeout: float | None = 5.0) -> None:
        """Stop the service: drain-then-fail, idempotent, never hangs.

        The batcher flushes every already-pending micro-batch (their
        futures resolve with exact answers), the search pool stops taking
        work, and any future still unresolved afterwards (queued searches
        that never ran, stragglers past ``timeout``) fails with
        :class:`ServiceClosedError`.  Concurrent and
        repeated calls are safe: the first runs the shutdown, the rest
        wait for it.  Every entry point raises ``ServiceClosedError`` once
        close has begun."""
        with self._cond:
            first = not self._close_started
            self._close_started = True
            self._closed = True
            self._cond.notify_all()
        if not first:
            self._close_done.wait(timeout)
            return
        try:
            self._batcher.join(timeout)
            self._search_pool.shutdown(wait=False, cancel_futures=True)
            self._rank_pool.shutdown(wait=False, cancel_futures=True)
            with self._cond:
                pending = [it for g in self._pending.values() for it in g.items]
                self._pending.clear()
                inflight = list(self._inflight.items())
                self._inflight.clear()
            exc = ServiceClosedError("AdvisorService is closed")
            self._fail([(it.key, it.future) for it in pending], exc)
            for key, future in inflight:
                if not future.done():
                    self._fail([(key, future)], exc)
        finally:
            self._close_done.set()

    def __enter__(self) -> "AdvisorService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
