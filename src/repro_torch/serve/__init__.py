"""Placement advisor as a service (port of ``repro.serve``): LRU answer
cache, micro-batched grouped sweeps, warm-started branch and bound for
machines too large to sweep, and phased schedules — on the service's
device, behind sync and async front ends, instrumented per tier.
Hot-swap, the deadline ladder and fault injection are not ported yet."""

from repro_torch.serve.cache import LRUCache
from repro_torch.serve.metrics import TIERS, ServiceMetrics
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
    "LRUCache",
    "QuerySignature",
    "ScheduleAdvice",
    "ServiceClosedError",
    "ServiceMetrics",
    "TIERS",
]
