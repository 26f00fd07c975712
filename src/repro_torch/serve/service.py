"""Placement advisor as a service: the micro-batched online query engine
(port of ``repro.serve.service``, cache and batch tiers).

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

Not ported yet (they need the search, scheduling, calibration and
advisor modules of later slices): the branch-and-bound search tier, the
phased schedule tier, spec hot-swap/rollback, the deadline degradation
ladder and fault injection.  Every entry point of a missing tier (a
budget past ``sweep_limit``, ``deadline_s``, ``query_schedule``,
``swap_machine``...) raises ``NotImplementedError`` naming it; nothing
answers it through another tier.
"""

from __future__ import annotations

import math
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import DEFAULT_DEVICE, resolve_device
from repro_torch.core.numa.evaluate import placement_array
from repro_torch.core.numa.machine import MachineSpec
from repro_torch.core.numa.simulator import (
    pad_rows,
    simulate_grouped_batch,
    support_patterns,
)
from repro_torch.core.numa.workload import Workload, mixed_workload
from repro_torch.serve.cache import LRUCache
from repro_torch.serve.metrics import ServiceMetrics


def _not_ported(tier: str, needs: str) -> NotImplementedError:
    """The error every entry point of a tier the port lacks raises."""
    return NotImplementedError(
        f"the {tier} is not in the PyTorch port yet (it needs {needs})"
    )


class ServiceClosedError(RuntimeError):
    """Raised by every entry point of a closed :class:`AdvisorService`,
    and set on any future the close drained rather than resolved."""


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
    answer; a later cache hit returns this same object."""

    placement: tuple[int, ...]  # threads per NUMA node
    predicted_bandwidth: float  # total bytes/s moved at this placement
    objective: float  # work rate (instructions/s), the quantity maximized
    tier: str  # "batch"
    optimal: bool  # exhaustive sweep


class _PlacementTable(NamedTuple):
    """Per-``(machine, budget)`` candidate set, padded once at build time
    to a power-of-two row count so every batch against it has one shape."""

    placements: torch.Tensor  # (P_pad, s) on the service's device
    placements_np: np.ndarray  # host copy for answer extraction
    support: torch.Tensor  # (n_buckets, s)
    slab_id: torch.Tensor  # (P_pad,)


class _Pending(NamedTuple):
    key: tuple  # full answer-cache key
    sig: QuerySignature  # canonical
    future: Future
    t0: float  # enqueue time (monotonic) — anchors the batch deadline


class _PendingGroup(NamedTuple):
    """One coalescing group's queue plus the spec it is answered on."""

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


class AdvisorService:
    """Online placement advisor over a registry of machines, computing on
    ``device`` (``"cuda"`` unless the caller asks for the CPU).

    Thread-safe: any number of caller threads may :meth:`query` /
    :meth:`submit` concurrently.  Answers equal serial evaluation because
    batch rows never interact and padding always lands on the same shape.
    ``sweep_limit`` is the largest composition count the batch tier
    sweeps; larger ``(machine, budget)`` groups belong to the search tier,
    which is not ported yet.
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
        metrics: ServiceMetrics | None = None,
    ):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.device = resolve_device(device)
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_s)
        self.sweep_limit = int(sweep_limit)
        self.metrics = metrics if metrics is not None else ServiceMetrics()

        self._machines: dict[str, MachineSpec] = {}
        self._answers = LRUCache(answer_capacity)
        self._tables = LRUCache(table_capacity)
        self._cond = threading.Condition()
        # group key (handle, n_threads) -> pending queue
        self._pending: dict[tuple, _PendingGroup] = {}
        # answer key -> Future, so concurrent identical misses compute once
        self._inflight: dict[tuple, Future] = {}
        self._closed = False
        self._close_started = False
        self._close_done = threading.Event()
        self._batcher = threading.Thread(
            target=self._batcher_main, name="advisor-batcher", daemon=True
        )
        self._batcher.start()

    # -- registry ------------------------------------------------------------

    def register(self, machine: MachineSpec, machine_id: str | None = None) -> str:
        """Add a machine to the registry; returns its *handle* (its
        fingerprint, or ``machine_id`` if given).  Idempotent."""
        handle = machine_id if machine_id is not None else machine.fingerprint()
        with self._cond:
            if handle not in self._machines:
                self._machines[handle] = machine
        return handle

    def _resolve(self, machine) -> tuple[MachineSpec, str]:
        """``machine`` (spec or handle) -> its ``(spec, handle)``."""
        handle = machine if isinstance(machine, str) else self.register(machine)
        with self._cond:
            spec = self._machines.get(handle)
        if spec is None:
            raise KeyError(f"unknown machine handle {machine!r}")
        return spec, handle

    def swap_machine(self, handle: str, new_spec: MachineSpec, *, warm: bool = True) -> int:
        """Spec hot-swap: not ported yet; raises ``NotImplementedError``."""
        raise _not_ported("hot-swap tier", "spec epochs and recalibration")

    def rollback_machine(self, handle: str, *, warm: bool = True) -> int:
        """Spec rollback: not ported yet; raises ``NotImplementedError``."""
        raise _not_ported("hot-swap tier", "spec epochs and recalibration")

    # -- public front ends ---------------------------------------------------

    def query(self, machine, signature: QuerySignature, n_threads: int,
              timeout: float | None = None, *,
              deadline_s: float | None = None) -> Advice:
        """Synchronous ask-and-wait.  ``machine`` is a MachineSpec or a
        registered handle; ``timeout`` raises on expiry.  A
        ``deadline_s`` needs the degradation ladder, which is not ported
        yet: it raises ``NotImplementedError``."""
        if deadline_s is not None:
            raise _not_ported("deadline ladder", "the ranked and stale tiers")
        advice, future = self._lookup_or_dispatch(machine, signature, n_threads)
        if advice is not None:
            return advice
        return future.result(timeout)

    def submit(self, machine, signature: QuerySignature, n_threads: int) -> Future:
        """Async front end: a Future resolving to the :class:`Advice`
        (already resolved on a cache hit)."""
        advice, future = self._lookup_or_dispatch(machine, signature, n_threads)
        if advice is not None:
            future = Future()
            future.set_result(advice)
        return future

    def _lookup_or_dispatch(self, machine, signature, n_threads):
        t0 = time.perf_counter()
        if self._closed:
            raise ServiceClosedError("AdvisorService is closed")
        spec, handle = self._resolve(machine)
        if self.uses_search(spec, n_threads):
            raise _not_ported(
                "search tier",
                f"branch and bound: {spec.name} at {n_threads} threads exceeds "
                f"sweep_limit={self.sweep_limit}",
            )
        sig = signature.canonical()
        key = (handle, int(n_threads), sig)
        hit = self._answers.get(key)
        if hit is not None:
            self.metrics.record_query("cache", time.perf_counter() - t0)
            return hit, None
        with self._cond:
            if self._closed:
                raise ServiceClosedError("AdvisorService is closed")
            # re-check under the dispatch lock: a batch completion inserts
            # into the answer cache *before* retiring its in-flight future
            hit = self._answers.get(key)
            if hit is not None:
                self.metrics.record_query("cache", time.perf_counter() - t0)
                return hit, None
            future = self._inflight.get(key)
            if future is None:
                future = Future()
                self._inflight[key] = future
                group = (handle, int(n_threads))
                pg = self._pending.get(group)
                if pg is None:
                    pg = _PendingGroup(spec, [])
                    self._pending[group] = pg
                pg.items.append(_Pending(key, sig, future, time.perf_counter()))
                self._cond.notify_all()

        def _record(f, t0=t0):
            if f.cancelled() or f.exception() is not None:
                return
            adv = f.result()
            self.metrics.record_query(adv.tier, time.perf_counter() - t0)

        future.add_done_callback(_record)
        return None, future

    def query_schedule(self, machine, phases, n_threads: int, **kwargs):
        """Phased query: not ported yet; raises ``NotImplementedError``."""
        raise _not_ported("schedule tier", "the phased scheduler")

    def submit_schedule(self, machine, phases, n_threads: int, **kwargs):
        """Async phased query: not ported yet; raises ``NotImplementedError``."""
        raise _not_ported("schedule tier", "the phased scheduler")

    # -- tier selection & placement tables ------------------------------------

    def uses_search(self, machine: MachineSpec, n_threads: int) -> bool:
        """True when the full composition space of ``n_threads`` over the
        machine's nodes is too large to sweep."""
        s = machine.n_nodes
        return math.comb(int(n_threads) + s - 1, s - 1) > self.sweep_limit

    def _build_table(self, machine: MachineSpec, n_threads: int) -> _PlacementTable:
        padded = pad_rows(placement_array(machine, n_threads))
        support, slab_id = support_patterns(padded)
        return _PlacementTable(
            placements=torch.as_tensor(padded, device=self.device),
            placements_np=padded,
            support=torch.as_tensor(support, device=self.device),
            slab_id=torch.as_tensor(slab_id, device=self.device).to(torch.int64),
        )

    def _table_for(self, machine: MachineSpec, handle: str,
                   n_threads: int) -> _PlacementTable:
        key = (handle, n_threads)
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

    def _finish(self, key: tuple, future: Future, advice: Advice) -> None:
        # answer cache first, in-flight retirement second: every moment a
        # key is absent from the in-flight map it is present in the cache
        self._answers.put(key, advice)
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
        handle, n_threads = gkey
        try:
            table = self._table_for(machine, handle, n_threads)
            workloads = self._stacked_workloads([it.sig for it in take], n_threads)
            self.metrics.register_trace(self._trace_key(handle, n_threads, table))
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
                )
                self._finish(item.key, item.future, advice)
        except BaseException as exc:  # resolve waiters, keep the loop alive
            self._fail([(it.key, it.future) for it in take], exc)

    def _trace_key(self, handle: str, n_threads: int,
                   table: _PlacementTable) -> tuple:
        return (
            handle,
            n_threads,
            self.max_batch,
            int(table.placements.shape[0]),
            int(table.support.shape[0]),
        )

    # -- warmup & lifecycle ------------------------------------------------------

    def warmup(self, machine, n_threads: int,
               signature: QuerySignature | None = None) -> Advice:
        """Run a ``(machine, budget)`` group's single steady-state shape
        (building its placement table) by answering one query."""
        sig = signature if signature is not None else QuerySignature(
            (0.25, 0.25, 0.25), (0.25, 0.25, 0.25)
        )
        return self.query(machine, sig, n_threads)

    def close(self, timeout: float | None = 5.0) -> None:
        """Stop the service: drain-then-fail, idempotent, never hangs.

        The batcher flushes every already-pending micro-batch (their
        futures resolve with exact answers); any future still unresolved
        afterwards fails with :class:`ServiceClosedError`.  Concurrent and
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
