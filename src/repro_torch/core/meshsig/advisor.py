"""Placement advisor in both domains (port of
``repro.core.meshsig.advisor``).

Mesh domain: given a fitted :class:`~repro_torch.core.meshsig.fit.
MeshSignature`, rank candidate mesh aspect ratios by predicted step time
WITHOUT running them (:func:`rank_meshes`): the three roofline terms come
from the signature's predicted per-axis link bytes, predicted local HBM
traffic and compute scaling, on the host in Python floats.

NUMA domain: given a fitted
:class:`~repro_torch.core.bwsig.BandwidthSignature` (2 profiling runs),
rank candidate thread placements on any machine WITHOUT simulating them
— one batched tensor pass over the ``(P, s)`` candidates on the
workload's device (:func:`rank_numa_placements`) — schedule a phased
workload (:func:`advise_schedule`), and bound placements admissibly
(:func:`numa_placement_bounds`).

Profiling noise is an explicit :class:`~repro_torch.core.numa.simulator.
CounterNoise` or a ``torch.Generator``, as in
:func:`~repro_torch.core.numa.evaluate.fitted_signatures`.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.bwsig import DirectionSignature, placement_matrix
from repro_torch.core.meshsig.device_topology import DeviceTopology
from repro_torch.core.meshsig.fit import MeshSignature

_F32 = torch.float32


@dataclass(frozen=True)
class ChipSpec:
    """Per-chip roofline constants.  Callers pick a preset or build
    their own."""

    name: str
    peak_flops: float  # bf16 FLOP/s
    hbm_bw: float  # bytes/s
    ici_bw: float  # bytes/s per link (the scalar-model fallback)


CHIP_V5E = ChipSpec(name="v5e", peak_flops=197e12, hbm_bw=819e9, ici_bw=50e9)
CHIP_V5P = ChipSpec(name="v5p", peak_flops=459e12, hbm_bw=2.765e12, ici_bw=100e9)


@dataclass
class MeshRanking:
    axis_sizes: dict[str, int]
    compute_s: float
    memory_s: float
    collective_s: float
    per_axis_s: dict[str, float]

    @property
    def step_s(self) -> float:
        # collectives overlap compute at best; the bound is the max term
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def bottleneck(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)


def rank_meshes(
    sig: MeshSignature,
    candidates: list[dict[str, int]],
    *,
    chip: ChipSpec = CHIP_V5E,
    topology: DeviceTopology | None = None,
    peak_flops: float | None = None,
    hbm_bw: float | None = None,
    ici_bw: float | None = None,
) -> list[MeshRanking]:
    """Evaluate every candidate mesh; returns rankings sorted by predicted
    step time (best first).

    With a :class:`DeviceTopology` the collective term routes every axis
    ring over the physical link graph (per-directed-link charging; a
    candidate's dict order picks the row-major device embedding), so two
    candidates with identical axis sizes can rank differently by how they
    lay onto the fabric.  Without one, each axis's bytes are divided by
    the chip's scalar ``ici_bw``; the two agree exactly on a
    fully-connected uniform-bandwidth topology.  The ``peak_flops`` /
    ``hbm_bw`` / ``ici_bw`` keywords override the chip's values."""
    peak_flops = chip.peak_flops if peak_flops is None else peak_flops
    hbm_bw = chip.hbm_bw if hbm_bw is None else hbm_bw
    ici_bw = chip.ici_bw if ici_bw is None else ici_bw
    out = []
    for axes in candidates:
        b = axes.get("data", 1) * axes.get("pod", 1)
        flops = sig.flops0 * sig.batch_shards0 / b  # per-device compute
        per_axis_bytes = sig.predict_axis_bytes(axes)
        if topology is None:
            per_axis_s = {a: v / ici_bw for a, v in per_axis_bytes.items()}
        else:
            per_axis_s = topology.per_axis_times(axes, per_axis_bytes)
        out.append(
            MeshRanking(
                axis_sizes=axes,
                compute_s=flops / peak_flops,
                memory_s=sig.predict_local_bytes(axes) / hbm_bw,
                collective_s=max(per_axis_s.values(), default=0.0),
                per_axis_s=per_axis_s,
            )
        )
    return sorted(out, key=lambda r: r.step_s)


# ---------------------------------------------------------------------------
# NUMA domain: rank thread placements from a fitted signature
# ---------------------------------------------------------------------------


@dataclass
class PlacementRanking:
    """One candidate placement's predicted cost (no measurement)."""

    placement: tuple[int, ...]  # threads per NUMA node
    remote_fraction: float  # predicted fraction of traffic leaving its node
    predicted_throughput: float  # roofline bound on the sum of thread rates,
    # each thread weighted by its node's relative core rate (a full-speed
    # thread on the fastest node counts 1.0)


def _placement_scores(
    machine,
    sig_read: DirectionSignature,
    sig_write: DirectionSignature,
    placements: torch.Tensor,  # (P, s) int
    read_bpi: float,
    write_bpi: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Signature-only roofline of every placement, as ``(P,)`` remote
    fractions and throughputs: predict the ``(s, s)`` flow matrices the
    way §4 applies a signature (demand follows thread count and node
    rate), divide by every resource capacity (per-node banks, per-pair
    hop-attenuated paths, every link on a pair's route), and bound the
    rate by the worst utilization."""
    dev = placements.device
    P, s = placements.shape
    rr_caps = machine.remote_read_caps(dev)
    ww_caps = machine.remote_write_caps(dev)
    route_inc = torch.as_tensor(
        np.array(machine.topology.route_incidence(), np.float32), device=dev
    )  # (s*s, L)
    link_caps = machine.link_caps(dev)
    node_rates = machine.node_rates(dev)
    rel_rates = node_rates / node_rates.max()
    tiny = torch.full((), 1e-9, dtype=_F32, device=dev)
    one = torch.ones((), dtype=_F32, device=dev)

    n = placements.to(_F32)
    nw = n * rel_rates
    w = nw / torch.maximum(nw.sum(-1, keepdim=True), tiny)
    demand_r = n * node_rates * read_bpi  # unsaturated bytes/s
    demand_w = n * node_rates * write_bpi
    m_read = placement_matrix(sig_read, placements)  # (P, s, s)
    m_write = placement_matrix(sig_write, placements)
    flows_r = demand_r[..., None] * m_read
    flows_w = demand_w[..., None] * m_write

    utils = [
        flows_r.sum(-2) / machine.node_local_bw("read", dev),
        flows_w.sum(-2) / machine.node_local_bw("write", dev),
        (flows_r / rr_caps).reshape(P, -1),
        (flows_w / ww_caps).reshape(P, -1),
    ]
    if machine.n_links:
        # self pairs have empty routes, so local flows drop out by themselves
        cross = (flows_r + flows_w).reshape(P, s * s)
        utils.append((cross @ route_inc) / link_caps)
    worst = torch.cat(utils, dim=-1).amax(-1)
    rate = torch.minimum(one, 1.0 / torch.maximum(worst, tiny))
    throughput = nw.sum(-1) * rate

    remote_r = 1.0 - (w * torch.diagonal(m_read, dim1=-2, dim2=-1)).sum(-1)
    remote_w = 1.0 - (w * torch.diagonal(m_write, dim1=-2, dim2=-1)).sum(-1)
    # the reference adds the two weights in float32
    weight = torch.tensor(read_bpi, dtype=_F32, device=dev) + write_bpi
    frac = (read_bpi * remote_r + write_bpi * remote_w) / torch.maximum(weight, tiny)
    return frac, throughput


def rank_numa_placements(
    machine,
    workload,
    *,
    noise_std: float = 0.0,
    noise=None,
    generator: torch.Generator | None = None,
    max_placements: int | None = None,
    top_k: int | None = None,
    placements=None,
) -> list[PlacementRanking]:
    """Rank every one-thread-per-core placement of ``workload`` over
    ``machine``'s NUMA nodes by predicted throughput (desc), then
    predicted remote-traffic fraction (asc), on the workload's device.

    Profiling is the paper's 2 runs (cached); ranking is one batched
    tensor pass over the candidates.  ``placements`` overrides the
    candidate set (``(P, s)``); ``max_placements`` samples it as
    :func:`~repro_torch.core.numa.evaluate.enumerate_placements` does.
    ``noise`` holds the profiling draws (leading ``(1, 2)`` axes) for a
    noisy fit; without it a noisy fit draws from ``generator``."""
    from repro_torch.core.numa.evaluate import fitted_signatures, placement_array

    dev = workload.device
    (sig, _, _), = fitted_signatures(
        machine, workload, noise_std=noise_std, noise=noise, generator=generator
    )
    if placements is None:
        placements = placement_array(
            machine, workload.n_threads, max_placements=max_placements
        )
    if isinstance(placements, torch.Tensor):
        placements = placements.cpu().numpy()
    p_np = np.asarray(placements, np.int32)
    # the reference averages the bpi fields in numpy float32
    read_bpi = float(workload.read_bpi.cpu().numpy().mean())
    write_bpi = float(workload.write_bpi.cpu().numpy().mean())
    fracs, thrs = _placement_scores(
        machine, sig.read, sig.write, torch.as_tensor(p_np, device=dev),
        read_bpi, write_bpi,
    )
    fracs, thrs = fracs.cpu().numpy(), thrs.cpu().numpy()
    order = np.lexsort((fracs, -thrs))
    if top_k is not None:
        order = order[:top_k]
    return [
        PlacementRanking(
            placement=tuple(int(v) for v in p_np[i]),
            remote_fraction=float(fracs[i]),
            predicted_throughput=float(thrs[i]),
        )
        for i in order
    ]


def advise_schedule(
    machine,
    phased,
    *,
    model=None,
    candidates_per_phase: int = 8,
    beam_width: int = 24,
    allow_page_placement: bool = True,
):
    """Schedule a phased workload: which placement per phase, and is
    reconfiguring at each boundary worth its cost?  Delegates to
    :func:`repro_torch.core.numa.temporal.optimize_schedule` and returns
    its :class:`~repro_torch.core.numa.temporal.ScheduleSearchResult`."""
    from repro_torch.core.numa.temporal import optimize_schedule

    return optimize_schedule(
        machine,
        phased,
        model=model,
        candidates_per_phase=candidates_per_phase,
        beam_width=beam_width,
        allow_page_placement=allow_page_placement,
    )


def numa_placement_bounds(machine, workload, placements, *, thread_classes=None):
    """Admissible per-placement upper bounds on total work rate
    (instructions/s), fit to certify search optimality.  The ranking
    score above is a heuristic (it scales every thread by the single
    worst utilization) and must never prune; this delegates to
    :func:`repro_torch.core.numa.search.placement_upper_bound`."""
    from repro_torch.core.numa.search import placement_upper_bound

    return placement_upper_bound(
        machine, workload, placements, thread_classes=thread_classes
    )
