"""The counter record a mesh signature is fitted from (the record half of
``repro.core.meshsig.hlo_counters``).

A profiling run of a sharded program yields, per device: its FLOPs, its
HBM bytes, and every collective it executes with the collective's kind,
result bytes, group size, execution count and per-device link bytes.
:class:`ProgramCounters` holds those fields and
:func:`~repro_torch.core.meshsig.fit.profile_from_analysis` reads them.
The reference fills its record (``HloAnalysis``) by parsing the compiled
module's HLO text; this module holds no parser, only the record and the
rule :func:`collective_link_bytes` that turns a collective's result
bytes into the bytes each device moves over links.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class CollectiveOp:
    kind: str
    bytes: float  # result bytes x executions
    group: int
    count: float  # executions (trip-multiplied)
    link_bytes: float  # per-device link traffic estimate


@dataclass
class ProgramCounters:
    """One profiling run's counters: the fields the signature fit reads
    (the reference's ``HloAnalysis`` without its parser's bookkeeping)."""

    flops: float = 0.0
    hbm_bytes: float = 0.0
    collectives: list[CollectiveOp] = field(default_factory=list)

    def collective_summary(self) -> dict:
        """Executions, result bytes and link bytes per collective kind,
        and the link bytes of all of them."""
        per_kind: dict[str, dict] = {}
        total_link = 0.0
        for c in self.collectives:
            s = per_kind.setdefault(
                c.kind, {"count": 0.0, "bytes": 0.0, "link_bytes": 0.0}
            )
            s["count"] += c.count
            s["bytes"] += c.bytes
            s["link_bytes"] += c.link_bytes
            total_link += c.link_bytes
        return {"per_kind": per_kind, "link_bytes_total": total_link}


def collective_link_bytes(kind: str, result_bytes: float, group: int) -> float:
    """Per-device link bytes of one ring collective over ``group``
    devices whose result holds ``result_bytes`` (an all-gather's result
    is the gathered size, a reduce-scatter's the shard)."""
    k = max(group, 1)
    if kind == "all-reduce":
        return 2.0 * result_bytes * (k - 1) / k
    if kind == "all-gather":
        return result_bytes * (k - 1) / k
    if kind == "reduce-scatter":
        return result_bytes * (k - 1)
    if kind == "all-to-all":
        return result_bytes * (k - 1) / k
    return result_bytes  # collective-permute
