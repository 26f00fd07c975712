"""Bandwidth signatures and the advisor in both domains (port of
``repro.core.meshsig``).

Mesh domain: ``counters`` holds the record a profiling run fills (FLOPs,
HBM bytes, collectives) and the rule that turns a collective's bytes
into link bytes; ``fit`` turns two profiling runs into a mesh bandwidth
signature; ``advisor`` applies it to rank candidate meshes.
``device_topology`` embeds the mesh into the routed-graph engine
(:mod:`repro_torch.core.graphtop`, the core that routes NUMA machines) so
collective bytes are charged per physical link instead of against one
scalar link rate, and ``calibrate`` fits per-link bandwidths from
measured collective times the way ``numa/calibrate.py`` fits QPI links.
The reference's HLO reader (``hlo_counters.analyze_hlo``) and its
validation experiment (``validate``) are not ported yet: the port has no
HLO and needs a counter source of its own to fill the record.

NUMA domain: rank thread placements from a fitted bandwidth signature,
schedule a phased workload, and bound placements admissibly.
"""

from repro_torch.core.meshsig.advisor import (
    CHIP_V5E,
    CHIP_V5P,
    ChipSpec,
    MeshRanking,
    PlacementRanking,
    advise_schedule,
    numa_placement_bounds,
    rank_meshes,
    rank_numa_placements,
)
from repro_torch.core.meshsig.counters import CollectiveOp, ProgramCounters
from repro_torch.core.meshsig.device_topology import (
    DeviceTopology,
    ici_torus2d,
    ici_torus3d,
    nvlink_island,
    ring_of_islands,
)

__all__ = [
    "CHIP_V5E",
    "CHIP_V5P",
    "ChipSpec",
    "CollectiveOp",
    "DeviceTopology",
    "MeshRanking",
    "PlacementRanking",
    "ProgramCounters",
    "advise_schedule",
    "ici_torus2d",
    "ici_torus3d",
    "numa_placement_bounds",
    "nvlink_island",
    "rank_meshes",
    "rank_numa_placements",
    "ring_of_islands",
]
