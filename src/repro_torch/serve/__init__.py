"""Placement advisor as a service (port of ``repro.serve``): a two-tier
fast path — LRU answer cache, then micro-batched grouped sweeps on the
service's device — behind sync and async front ends, instrumented per
tier.  The search and schedule tiers, hot-swap, the deadline ladder and
fault injection are not ported yet."""

from repro_torch.serve.cache import LRUCache
from repro_torch.serve.metrics import TIERS, ServiceMetrics
from repro_torch.serve.service import (
    Advice,
    AdvisorService,
    QuerySignature,
    ServiceClosedError,
)

__all__ = [
    "Advice",
    "AdvisorService",
    "LRUCache",
    "QuerySignature",
    "ServiceClosedError",
    "ServiceMetrics",
    "TIERS",
]
