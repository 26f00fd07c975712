"""The paper's benchmark suite, re-expressed as simulator workloads (port
of ``repro.core.numa.benchmarks``; the mixes are copied value for value).

Paper Table 1 draws 23 workloads from NPB, SPEC OMP, in-memory graph
analytics and database joins.  Their true memory traces are not available
here, so each is given a plausible ground-truth mix consistent with how the
paper describes the families:

* NPB solvers (BT/LU/SP/MG/CG/FT): large shared grids, partially
  partitioned per thread — per-thread heavy with interleaved halo traffic.
* EP is embarrassingly parallel — almost pure local.
* IS (integer sort) and the hash joins (NPO/PRHO/PRH/PRO/Sort join)
  shuffle data between all threads — interleaved/per-thread heavy, strong
  write components.
* SPEC OMP physics codes (Applu/Apsi/Bwaves/Equake/FMA-3D/Swim/Wupwise/MD/
  Art): master-thread-loaded inputs (a static component) plus partitioned
  working sets.  Equake performs almost exclusively reads (its write
  signature is noise — paper §6.2.1).
* Page rank (GA) violates the model: the early, well-connected chunk of
  the graph is hotter than the rest (paper Figure 16) — modeled with
  per-thread heterogeneity that the 4-class model cannot express.

The *absolute* mixes are synthetic; what the evaluation demonstrates is the
paper's pipeline — fit on 2 runs, predict every other placement, measure
error distributions, flag misfits — on a diverse population of signatures,
including low-bandwidth workloads that reproduce the paper's observation
that large errors concentrate where little data moves.
"""

from __future__ import annotations

from typing import Iterator

from repro_torch import DEFAULT_DEVICE
from repro_torch.core.numa.workload import (
    Workload,
    mixed_workload,
    violator_workload,
)

# name -> (read_mix(static, local, per_thread), write_mix, read_bpi, write_bpi, static_socket)
_SUITE: dict[str, tuple] = {
    # NPB
    "BT": ((0.05, 0.25, 0.55), (0.02, 0.38, 0.50), 0.55, 0.28, 0),
    "CG": ((0.10, 0.10, 0.45), (0.02, 0.58, 0.30), 0.80, 0.12, 0),
    "EP": ((0.02, 0.93, 0.03), (0.00, 0.97, 0.02), 0.04, 0.02, 0),
    "FT": ((0.05, 0.05, 0.30), (0.03, 0.07, 0.30), 0.90, 0.45, 0),
    "IS": ((0.04, 0.06, 0.20), (0.02, 0.08, 0.22), 0.70, 0.60, 0),
    "LU": ((0.06, 0.30, 0.52), (0.03, 0.42, 0.45), 0.50, 0.22, 0),
    "MD": ((0.12, 0.55, 0.25), (0.03, 0.75, 0.15), 0.18, 0.05, 0),
    "MG": ((0.08, 0.15, 0.55), (0.04, 0.22, 0.52), 0.75, 0.30, 0),
    "SP": ((0.05, 0.28, 0.55), (0.02, 0.40, 0.48), 0.60, 0.25, 0),
    # SPEC OMP
    "Applu": ((0.15, 0.35, 0.40), (0.05, 0.55, 0.30), 0.45, 0.20, 0),
    "Apsi": ((0.20, 0.40, 0.30), (0.08, 0.60, 0.22), 0.25, 0.10, 0),
    "Art": ((0.30, 0.45, 0.15), (0.05, 0.80, 0.08), 0.35, 0.06, 0),
    "Bwaves": ((0.10, 0.20, 0.55), (0.04, 0.30, 0.55), 0.85, 0.35, 0),
    "Equake": ((0.18, 0.32, 0.35), (0.10, 0.45, 0.25), 0.55, 0.004, 0),
    "FMA-3D": ((0.12, 0.38, 0.35), (0.05, 0.55, 0.28), 0.40, 0.18, 0),
    "Swim": ((0.08, 0.12, 0.60), (0.04, 0.16, 0.62), 0.95, 0.50, 0),
    "Wupwise": ((0.10, 0.30, 0.45), (0.05, 0.40, 0.40), 0.50, 0.22, 0),
    # Database joins (Balkesen et al.)
    "NPO": ((0.35, 0.05, 0.45), (0.08, 0.12, 0.55), 0.65, 0.30, 0),
    "PRHO": ((0.10, 0.15, 0.30), (0.05, 0.20, 0.35), 0.70, 0.55, 0),
    "PRH": ((0.12, 0.12, 0.35), (0.06, 0.15, 0.40), 0.75, 0.58, 0),
    "PRO": ((0.10, 0.18, 0.32), (0.05, 0.22, 0.38), 0.68, 0.52, 0),
    "Sort join": ((0.08, 0.10, 0.35), (0.04, 0.12, 0.40), 0.80, 0.62, 0),
}

# Low-bandwidth workloads (bpi scaled down) that reproduce the paper's
# "errors concentrate in low-bandwidth benchmarks" observation.
_LOW_BW = {"EP", "MD", "Art", "Apsi"}


def benchmark_workload(
    name: str, n_threads: int, *, device=DEFAULT_DEVICE
) -> Workload:
    """Instantiate one suite workload for ``n_threads`` threads."""
    if name == "Page rank":
        return violator_workload("Page rank", n_threads, device=device)
    read_mix, write_mix, rbpi, wbpi, socket = _SUITE[name]
    return mixed_workload(
        name,
        n_threads,
        read_mix=read_mix,
        write_mix=write_mix,
        read_bpi=rbpi,
        write_bpi=wbpi,
        static_socket=socket,
        device=device,
    )


def suite_names(include_violators: bool = True) -> list[str]:
    """Names of the paper's Table 1 benchmarks (23 with the
    assumption-violating ``"Page rank"`` included, 22 without)."""
    names = list(_SUITE)
    if include_violators:
        names.append("Page rank")
    return names



def suite(
    n_threads: int, include_violators: bool = True, *, device=DEFAULT_DEVICE
) -> Iterator[Workload]:
    """Yield every Table 1 benchmark as an ``n_threads``-thread workload."""
    for name in suite_names(include_violators):
        yield benchmark_workload(name, n_threads, device=device)
