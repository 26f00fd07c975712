"""Fault injection for the advisor serving stack (a copy of
``repro.serve.faults``, which is plain numpy).

The resilience contracts of :class:`~repro_torch.serve.service.AdvisorService`
("bounded when unhealthy") are only testable if unhealth can be
manufactured on demand.  This module is the manufacturing plant: a
:class:`FaultInjector` holds an armed-fault registry that the service,
the recalibration worker and the chaos suite all share, and the
instrumented code calls back into it at named *sites*:

* ``"batch"`` — inside the micro-batcher, immediately before the jitted
  batch dispatch (a slow fault here models a stalled compile/dispatch; a
  raise models the evaluator dying mid-batch);
* ``"batcher"`` — at the top of each batcher-loop iteration, before any
  queries are taken (a raise here kills the batcher thread between jobs
  — the service's self-healing restart is what keeps queries flowing);
* ``"search"`` — inside each branch-and-bound attempt (raises are
  absorbed by the search tier's retry-with-backoff ladder);
* ``"schedule"`` — inside the phased-query worker;
* ``"rank"`` — inside the degradation ladder's signature-only rung
  (failing it forces the ladder down to the stale/fallback rungs);
* ``"recalibrate"`` — inside the recalibration worker's fit.

Faults are armed with a ``times`` budget and disarm themselves after
firing that many times, so a chaos scenario is fully deterministic:
"the 3rd through 5th batches stall 200 ms, then the world heals".
Everything is thread-safe (sites fire from the batcher, pool workers and
caller threads concurrently) and every firing is appended to
:attr:`FaultInjector.log` so tests can assert the scenario actually
happened instead of silently passing against a healthy service.

Clock skew is injected at the *clock*, not at a site: the service reads
deadlines through :meth:`FaultInjector.now`, so a skewed injector makes
every in-flight deadline appear nearer/farther exactly the way a stepped
or drifting system clock would.

The module-level :data:`NO_FAULTS` singleton is the default injector —
permanently empty, its hooks compile down to a dict probe — so
production paths pay one attribute load per site.
"""

from __future__ import annotations

import threading
import time
from typing import Callable

import numpy as np


class FaultError(RuntimeError):
    """Default exception type raised by an armed error fault — distinct
    from real failures so tests can tell injected pain from genuine
    bugs."""


class _Fault:
    """One armed fault at one site: an action plus a remaining-fire
    budget (``None`` = unlimited)."""

    __slots__ = ("kind", "delay_s", "exc_factory", "times")

    def __init__(self, kind: str, *, delay_s: float = 0.0,
                 exc_factory: Callable[[], BaseException] | None = None,
                 times: int | None = 1):
        self.kind = kind
        self.delay_s = delay_s
        self.exc_factory = exc_factory
        self.times = times


class FaultInjector:
    """Thread-safe armed-fault registry shared by the serving stack.

    Arm faults with :meth:`inject_slow` / :meth:`inject_error` /
    :meth:`inject_clock_skew` / :meth:`inject_counter_corruption`;
    instrumented code calls :meth:`fire` at its site, :meth:`now` for
    deadline clocks and :meth:`corrupt_counters` on ingested counter
    batches.  ``log`` records every firing as ``(site, kind)`` tuples in
    order.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._faults: dict[str, list[_Fault]] = {}
        self._skew_s = 0.0
        self._corrupt: _Fault | None = None
        self._corrupt_fraction = 0.0
        self._corrupt_seed = 0
        self.log: list[tuple[str, str]] = []

    # -- arming ------------------------------------------------------------

    def inject_slow(self, site: str, delay_s: float,
                    *, times: int | None = 1) -> "FaultInjector":
        """Arm a slow fault: the next ``times`` firings of ``site`` sleep
        ``delay_s`` seconds before proceeding.  Returns self (chainable)."""
        with self._lock:
            self._faults.setdefault(site, []).append(
                _Fault("slow", delay_s=float(delay_s), times=times)
            )
        return self

    def inject_error(self, site: str, *, times: int | None = 1,
                     exc_factory: Callable[[], BaseException] | None = None,
                     ) -> "FaultInjector":
        """Arm an error fault: the next ``times`` firings of ``site``
        raise (:class:`FaultError` by default)."""
        factory = exc_factory or (lambda: FaultError(f"injected fault at {site!r}"))
        with self._lock:
            self._faults.setdefault(site, []).append(
                _Fault("error", exc_factory=factory, times=times)
            )
        return self

    def inject_clock_skew(self, offset_s: float) -> "FaultInjector":
        """Skew the injected monotonic clock by ``offset_s`` seconds
        (positive = the future arrives early, so deadlines look nearer)."""
        with self._lock:
            self._skew_s = float(offset_s)
        return self

    def inject_counter_corruption(self, *, fraction: float = 0.25,
                                  times: int | None = 1,
                                  seed: int = 0) -> "FaultInjector":
        """Arm counter-batch corruption: the next ``times`` batches passed
        through :meth:`corrupt_counters` get ``fraction`` of their rows
        NaN-poisoned (deterministically, from ``seed``)."""
        with self._lock:
            self._corrupt = _Fault("corrupt", times=times)
            self._corrupt_fraction = float(fraction)
            self._corrupt_seed = int(seed)
        return self

    def clear(self, site: str | None = None) -> None:
        """Disarm every fault at ``site`` (or everywhere when None),
        including clock skew and counter corruption."""
        with self._lock:
            if site is None:
                self._faults.clear()
                self._skew_s = 0.0
                self._corrupt = None
            else:
                self._faults.pop(site, None)

    # -- firing ------------------------------------------------------------

    def _take(self, site: str) -> _Fault | None:
        with self._lock:
            queue = self._faults.get(site)
            if not queue:
                return None
            fault = queue[0]
            if fault.times is not None:
                fault.times -= 1
                if fault.times <= 0:
                    queue.pop(0)
                if not queue:
                    del self._faults[site]
            self.log.append((site, fault.kind))
            return fault

    def fire(self, site: str) -> None:
        """Fire ``site``: no-op when nothing is armed there; otherwise
        consume one budgeted firing — sleeping for slow faults, raising
        for error faults."""
        fault = self._take(site)
        if fault is None:
            return
        if fault.kind == "slow":
            time.sleep(fault.delay_s)
        elif fault.kind == "error":
            raise fault.exc_factory()  # type: ignore[misc]

    def now(self) -> float:
        """The (possibly skewed) monotonic clock deadlines are read from."""
        return time.monotonic() + self._skew_s

    def corrupt_counters(self, arrays: tuple) -> tuple:
        """Pass a tuple of per-sample counter arrays (leading axis =
        samples) through the armed corruption fault, NaN-poisoning a
        deterministic subset of rows; identity when disarmed."""
        with self._lock:
            fault = self._corrupt
            if fault is None:
                return arrays
            if fault.times is not None:
                fault.times -= 1
                if fault.times <= 0:
                    self._corrupt = None
            fraction, seed = self._corrupt_fraction, self._corrupt_seed
            self.log.append(("counters", "corrupt"))
        rng = np.random.default_rng(seed)
        out = []
        n = int(np.asarray(arrays[0]).shape[0])
        k = max(1, int(round(fraction * n)))
        rows = rng.choice(n, size=min(k, n), replace=False)
        for arr in arrays:
            a = np.array(arr, np.float64, copy=True)
            a[rows] = np.nan
            out.append(a)
        return tuple(out)

    def fired(self, site: str) -> int:
        """How many times ``site`` has fired so far."""
        with self._lock:
            return sum(1 for s, _ in self.log if s == site)


NO_FAULTS = FaultInjector()
"""The default, permanently inert injector (arm your own instance for
chaos runs — arming this one would fault every service that kept the
default)."""
