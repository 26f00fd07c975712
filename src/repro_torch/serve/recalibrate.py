"""Live recalibration: stream counter samples into a serving advisor
(port of ``repro.serve.recalibrate``).

The paper's premise is that a machine's bandwidth model comes from a
couple of counter runs — which means the model can *drift* whenever the
machine does (BIOS updates, DIMM swaps, thermal throttling, a neighbour
saturating an interconnect).  :class:`Recalibrator` closes the loop for a
live :class:`~repro_torch.serve.service.AdvisorService`:

1. **Ingest** — counter sample batches arrive per machine handle, in any
   order, covering any subset of the probe suite (production traces are
   partial sweeps, not designed experiments).  Every batch is NaN-guarded
   through :func:`~repro_torch.core.numa.calibrate.clean_samples` — corrupted
   rows are rejected and counted, never fitted — and buffered per handle.
2. **Refit** — :meth:`Recalibrator.recalibrate` concatenates a handle's
   buffer and refits with the outlier-robust (Huberized) loss, seeded
   from the machine's current structure.  Partial coverage is fine: the
   fit recovers whatever parameters the observed placements identify.
3. **Guard & swap** — the refit spec replays the very samples it was
   fitted from (:func:`~repro_torch.core.numa.calibrate.sweep_median_error_pct`)
   and is compared against the *current* spec on the same samples.  Only
   a refit that does not regress the sweep-median error beyond
   ``max_error_regression_pp`` is hot-swapped in
   (:meth:`AdvisorService.swap_machine` — versioned epoch, per-machine
   cache invalidation, in-flight queries unaffected).  A regressing refit
   is rejected — the previous spec keeps serving, which is the rollback —
   and counted on the service metrics.

Every decision is returned (and kept in :attr:`Recalibrator.events`) as a
:class:`RecalibrationEvent` — the audit trail chaos tests and the
resilience runs assert over.  A ``"recalibrate"`` fault site and the
injector's counter-corruption hook make the failure paths testable.

The fit runs on the samples' device, on the recalibrator's thread, with
eager autograd: on one card it competes with the service's batcher for
the interpreter lock, never for a lock of the service's.
"""

from __future__ import annotations

import threading
import time
from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core.numa.calibrate import (
    CalibrationSamples,
    clean_samples,
    concat_samples,
    fit_machine,
    samples_from_counters,
    sweep_median_error_pct,
)
from repro_torch.serve.faults import FaultInjector
from repro_torch.serve.service import AdvisorService


class RecalibrationEvent(NamedTuple):
    """One refit decision: what was fitted, how it scored, what happened.

    ``old_error_pct`` / ``new_error_pct`` are the current and refit
    spec's sweep-median counter errors on the *same* ingested samples —
    the pair the acceptance guard compares.  ``epoch`` is the service
    epoch after the decision (bumped iff ``accepted``)."""

    handle: str
    accepted: bool
    reason: str
    epoch: int
    old_error_pct: float
    new_error_pct: float
    n_samples: int
    n_rejected: int
    fit_seconds: float


class Recalibrator:
    """Background recalibration worker for one :class:`AdvisorService`.

    Thread-safe: producers may :meth:`ingest` while a (manual or
    :meth:`start`-ed periodic) :meth:`recalibrate` runs.  The worker never
    blocks the serving path — fitting happens on the caller/background
    thread and the only service interaction is the atomic
    ``swap_machine`` at the end of an accepted refit.
    """

    def __init__(
        self,
        service: AdvisorService,
        *,
        min_samples: int = 16,
        max_error_regression_pp: float = 0.5,
        fit_steps: int = 120,
        fit_lr: float = 0.03,
        huber_delta: float | None = 0.05,
        warm_swap: bool = True,
        faults: FaultInjector | None = None,
    ):
        self.service = service
        self.min_samples = int(min_samples)
        self.max_error_regression_pp = float(max_error_regression_pp)
        self.fit_steps = int(fit_steps)
        self.fit_lr = float(fit_lr)
        self.huber_delta = huber_delta
        self.warm_swap = bool(warm_swap)
        self.faults = faults if faults is not None else service.faults
        self.events: list[RecalibrationEvent] = []
        self._lock = threading.Lock()
        self._buffers: dict[str, list[CalibrationSamples]] = {}
        self._rejected: dict[str, int] = {}
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()

    # -- ingestion -----------------------------------------------------------

    def ingest(self, handle: str, samples: CalibrationSamples):
        """Buffer a counter sample batch for ``handle``; returns the
        batch's :class:`~repro_torch.core.numa.calibrate.SampleDiagnostics`.
        Corrupt/non-finite rows are rejected here (and remembered, so the
        eventual :class:`RecalibrationEvent` reports them) — a poisoned
        feed degrades coverage, never the fit."""
        fields = ("local_read", "remote_read", "local_write", "remote_write",
                  "instructions", "elapsed")
        # the injector poisons host copies (it is numpy); an untouched
        # batch comes back as the same tuple and stays where it was
        host = tuple(getattr(samples, f).detach().cpu() for f in fields)
        out = self.faults.corrupt_counters(host)
        if out is not host:
            samples = samples._replace(**{
                f: torch.as_tensor(np.asarray(a), dtype=torch.float32, device=samples.device)
                for f, a in zip(fields, out)
            })
        cleaned, diag = clean_samples(samples, on_empty="ignore")
        with self._lock:
            if cleaned.n_samples:
                self._buffers.setdefault(handle, []).append(cleaned)
            self._rejected[handle] = (
                self._rejected.get(handle, 0) + diag.n_rejected
            )
        return diag

    def ingest_counters(self, handle: str, workloads: Sequence,
                        placements, counters: Sequence):
        """Ingest an externally measured trace — one
        :class:`~repro_torch.core.bwsig.counters.CounterSample` per known
        ``(workload, placement)`` run — via
        :func:`~repro_torch.core.numa.calibrate.samples_from_counters`."""
        return self.ingest(
            handle, samples_from_counters(workloads, placements, counters)
        )

    def buffered(self, handle: str) -> int:
        """Clean samples currently buffered for ``handle``."""
        with self._lock:
            return sum(
                b.n_samples for b in self._buffers.get(handle, [])
            )

    # -- refit & guard -------------------------------------------------------

    def recalibrate(self, handle: str) -> RecalibrationEvent:
        """Refit ``handle`` from its buffered samples, guard, and swap.

        Consumes the buffer whatever the outcome — a rejected fit's
        samples are as suspect as its parameters, so the next window
        starts fresh.  Returns (and records) the decision event."""
        with self._lock:
            batches = self._buffers.pop(handle, [])
            n_rejected = self._rejected.pop(handle, 0)
        n_samples = sum(b.n_samples for b in batches)
        current = self.service.machine_spec(handle)
        if n_samples < self.min_samples:
            event = RecalibrationEvent(
                handle=handle, accepted=False,
                reason=(
                    f"insufficient samples ({n_samples} clean < "
                    f"{self.min_samples} required; {n_rejected} rejected)"
                ),
                epoch=self.service.epoch_of(handle),
                old_error_pct=float("nan"), new_error_pct=float("nan"),
                n_samples=n_samples, n_rejected=n_rejected,
                fit_seconds=0.0,
            )
            with self._lock:
                self.events.append(event)
            return event
        samples = concat_samples(batches)
        t0 = time.perf_counter()
        try:
            self.faults.fire("recalibrate")
            old_err = sweep_median_error_pct(current, samples)
            result = fit_machine(
                current, samples,
                steps=self.fit_steps, lr=self.fit_lr,
                huber_delta=self.huber_delta, clean=False,
            )
            new_err = sweep_median_error_pct(result.machine, samples)
        except Exception as exc:
            event = RecalibrationEvent(
                handle=handle, accepted=False,
                reason=f"refit failed: {exc}",
                epoch=self.service.epoch_of(handle),
                old_error_pct=float("nan"), new_error_pct=float("nan"),
                n_samples=n_samples, n_rejected=n_rejected,
                fit_seconds=time.perf_counter() - t0,
            )
            with self._lock:
                self.events.append(event)
            return event
        fit_seconds = time.perf_counter() - t0
        if new_err <= old_err + self.max_error_regression_pp:
            epoch = self.service.swap_machine(
                handle, result.machine, warm=self.warm_swap
            )
            event = RecalibrationEvent(
                handle=handle, accepted=True,
                reason=(
                    f"sweep-median error {old_err:.3f}% -> {new_err:.3f}%"
                ),
                epoch=epoch,
                old_error_pct=old_err, new_error_pct=new_err,
                n_samples=n_samples, n_rejected=n_rejected,
                fit_seconds=fit_seconds,
            )
        else:
            # the guard IS the rollback: the regressing spec is never
            # installed, the previous (current) spec keeps serving
            self.service.metrics.record_rollback()
            event = RecalibrationEvent(
                handle=handle, accepted=False,
                reason=(
                    f"refit regressed sweep-median error "
                    f"{old_err:.3f}% -> {new_err:.3f}% "
                    f"(> +{self.max_error_regression_pp}pp); "
                    "previous spec retained"
                ),
                epoch=self.service.epoch_of(handle),
                old_error_pct=old_err, new_error_pct=new_err,
                n_samples=n_samples, n_rejected=n_rejected,
                fit_seconds=fit_seconds,
            )
        with self._lock:
            self.events.append(event)
        return event

    # -- background loop -----------------------------------------------------

    def start(self, interval_s: float = 30.0) -> None:
        """Recalibrate every buffered handle every ``interval_s`` seconds
        on a daemon thread, until :meth:`stop`."""
        if self._thread is not None and self._thread.is_alive():
            raise RuntimeError("recalibrator already running")
        self._stop.clear()

        def loop() -> None:
            while not self._stop.wait(interval_s):
                with self._lock:
                    handles = [
                        h for h, b in self._buffers.items()
                        if sum(x.n_samples for x in b) >= self.min_samples
                    ]
                for handle in handles:
                    if self._stop.is_set():
                        return
                    self.recalibrate(handle)

        self._thread = threading.Thread(
            target=loop, name="advisor-recalibrate", daemon=True
        )
        self._thread.start()

    def stop(self, timeout: float | None = 5.0) -> None:
        """Stop the background loop (idempotent; safe if never started)."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None
