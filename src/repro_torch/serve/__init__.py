"""Placement advisor as a service (port of ``repro.serve``): LRU answer
cache, micro-batched grouped sweeps, warm-started branch and bound for
machines too large to sweep, and phased schedules — on the service's
device, behind sync and async front ends, instrumented per tier.

The resilience layer: versioned spec epochs with live hot-swap and
rollback (:class:`Recalibrator` streams counter samples into guarded
refits), a deadline-bounded degradation ladder that tags every
:class:`Advice` with its fidelity, and a :class:`FaultInjector` that
manufactures each failure path on demand."""

from repro_torch.serve.cache import LRUCache
from repro_torch.serve.faults import NO_FAULTS, FaultError, FaultInjector
from repro_torch.serve.metrics import FIDELITIES, TIERS, ServiceMetrics
from repro_torch.serve.recalibrate import RecalibrationEvent, Recalibrator
from repro_torch.serve.service import (
    Advice,
    AdvisorService,
    QuerySignature,
    ScheduleAdvice,
    ServiceClosedError,
)

__all__ = [
    "Advice",
    "AdvisorService",
    "FIDELITIES",
    "FaultError",
    "FaultInjector",
    "LRUCache",
    "NO_FAULTS",
    "QuerySignature",
    "RecalibrationEvent",
    "Recalibrator",
    "ScheduleAdvice",
    "ServiceClosedError",
    "ServiceMetrics",
    "TIERS",
]
