"""Bandwidth signatures and the advisor in both domains (port of
``repro.core.meshsig``).

Mesh domain: ``counters`` holds the record a profiling run fills (FLOPs,
HBM bytes, collectives), the rule that turns a collective's bytes into
link bytes and the port's counter source, ``count_program``, which runs
one rank of a sharded program (on ``meta`` tensors for a mesh of any
size) and fills the record; ``fit`` turns two profiling runs into a mesh
bandwidth signature; ``advisor`` applies it to rank candidate meshes;
``validate`` runs the §6.2.2 accuracy experiment over five meshes.
``device_topology`` embeds the mesh into the routed-graph engine
(:mod:`repro_torch.core.graphtop`, the core that routes NUMA machines) so
collective bytes are charged per physical link instead of against one
scalar link rate, and ``calibrate`` fits per-link bandwidths from
measured collective times the way ``numa/calibrate.py`` fits QPI links.
The reference reads its counters from compiled HLO
(``hlo_counters.analyze_hlo``); the port has no HLO, and
``count_program`` takes its place.

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
from repro_torch.core.meshsig.counters import CollectiveOp, ProgramCounters, count_program
from repro_torch.core.meshsig.device_topology import (
    DeviceTopology,
    ici_torus2d,
    ici_torus3d,
    nvlink_island,
    ring_of_islands,
)
from repro_torch.core.meshsig.validate import (
    FIT_MESHES,
    VAL_MESHES,
    measured_axis_bytes,
    prediction_errors,
    profile_mesh,
    run_validation,
)

__all__ = [
    "FIT_MESHES",
    "VAL_MESHES",
    "CHIP_V5E",
    "CHIP_V5P",
    "ChipSpec",
    "CollectiveOp",
    "DeviceTopology",
    "MeshRanking",
    "PlacementRanking",
    "ProgramCounters",
    "advise_schedule",
    "count_program",
    "ici_torus2d",
    "ici_torus3d",
    "measured_axis_bytes",
    "numa_placement_bounds",
    "nvlink_island",
    "prediction_errors",
    "profile_mesh",
    "rank_meshes",
    "rank_numa_placements",
    "ring_of_islands",
    "run_validation",
]
