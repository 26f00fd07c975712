"""The advisor API (port of ``repro.core.meshsig``), NUMA half only:
rank thread placements from a fitted bandwidth signature, schedule a
phased workload, and bound placements admissibly.  The mesh half
(``ChipSpec``, ``rank_meshes``, ``hlo_counters``, ``validate``) is not
ported yet."""

from repro_torch.core.meshsig.advisor import (
    PlacementRanking,
    advise_schedule,
    numa_placement_bounds,
    rank_numa_placements,
)

__all__ = [
    "PlacementRanking",
    "advise_schedule",
    "numa_placement_bounds",
    "rank_numa_placements",
]
