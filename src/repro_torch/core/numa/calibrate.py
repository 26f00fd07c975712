"""Learned topology calibration — the inverse problem of the simulator
(port of ``repro.core.numa.calibrate``).

Given ``(placement, observed counters)`` samples — from the simulator for
a synthetic ground truth, or any counter trace shaped like
:class:`~repro_torch.core.bwsig.counters.CounterSample` — recover a
machine's free parameters: the per-link interconnect bandwidths (through
the topology's :class:`~repro_torch.core.numa.topology.LinkGroups`
packing), ``hop_attenuation`` and the per-node ``local_read_bw`` /
``local_write_bw``.  The structural template stays fixed: node count,
core rates, routing tables and the remote path bases.

Two stages, as in the reference:

1. **Counter seeding** (:func:`seed_parameters`) — closed-form lower
   bounds read off the samples: every observed rate is a lower bound on
   the capacity it crossed, and the probe suite makes them tight.
2. **Projected gradient** (:func:`fit_machine`) — AdamW in log space
   (:mod:`repro_torch.optim.adamw`) against the squared (or Huber)
   relative counter error of the max-min-fair forward model.  The probe
   sweep's slab does not depend on the capacities, so it is built once
   (:func:`~repro_torch.core.numa.simulator.paired_slab`) and each step
   refills it with the capacities assembled from the parameters
   (:func:`~repro_torch.core.numa.simulator.fill_paired`), under the
   reference's derivative rule for ``maximum``/``minimum``.  The loop
   keeps the loss history on the device: one copy per fit.

Samples live on one device and every fit runs there.  The seeding's
attenuation bound, :func:`fitted_machine` and :func:`counter_errors_pct`
are float64 numpy, as in the reference; the fit is float32.  Noisy
sweeps take their standard-normal draws as a stacked
:class:`~repro_torch.core.numa.simulator.CounterNoise` or draw them from
a ``torch.Generator`` (the reference splits ``jax.random`` keys).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch import DEFAULT_DEVICE, resolve_device
from repro_torch.core.bwsig.counters import CounterSample
from repro_torch.core.bwsig.fit import _remote_source_weights
from repro_torch.core.numa.machine import GB, MachineSpec
from repro_torch.core.numa.simulator import (
    CounterNoise,
    PairedSlab,
    _apply_noise,
    _asymmetric_counts,
    class_starts_from_arrays,
    default_generator,
    draw_counter_noise,
    fill_paired,
    paired_slab,
    simulate_paired_batch,
    thread_class_starts,
)
from repro_torch.core.numa.topology import LinkGroups, from_fit, link_groups
from repro_torch.core.numa.workload import Workload, mixed_workload
from repro_torch.optim import adamw

_EPS = 1e-9
_F32 = torch.float32
# Finite stand-in for the unconstrained diagonal of the remote-path caps:
# its usage column is structurally zero, so any value never binds — but a
# finite one keeps the fill's linearization coefficients finite under
# reverse mode (inf residuals turn 0-cotangent products into NaN).
_UNUSED_CAP = 1e5


class CalibrationSamples(NamedTuple):
    """A counter sweep: ``P`` profiling runs of known workloads and
    placements, on one device.  ``wl_arrays`` stacks every tensor field
    of the run's :class:`Workload` over the leading sample axis (the last
    is the ``(P,)`` static socket); counters are bank-perspective bytes
    (or instructions) observed over ``elapsed`` seconds."""

    wl_arrays: tuple[torch.Tensor, ...]  # leaves (P, n) / (P,)
    placements: torch.Tensor  # (P, s) int32
    local_read: torch.Tensor  # (P, s)
    remote_read: torch.Tensor  # (P, s)
    local_write: torch.Tensor  # (P, s)
    remote_write: torch.Tensor  # (P, s)
    instructions: torch.Tensor  # (P, s)
    elapsed: torch.Tensor  # (P,)

    @property
    def n_samples(self) -> int:
        """Number of profiled placements in the sample set."""
        return int(self.placements.shape[0])

    @property
    def n_nodes(self) -> int:
        """NUMA node count of the machine the samples came from."""
        return int(self.placements.shape[1])

    @property
    def device(self) -> torch.device:
        """The device every leaf lives on."""
        return self.placements.device

    def to(self, device) -> "CalibrationSamples":
        """The same samples on ``device``."""
        dev = resolve_device(device)
        return CalibrationSamples(
            tuple(a.to(dev) for a in self.wl_arrays),
            *(t.to(dev) for t in self[1:]),
        )


class CalibrationParams(NamedTuple):
    """Free parameters, unconstrained: capacities in log space and the
    attenuation behind a sigmoid, so plain gradient steps stay inside the
    feasible set (the smooth projection)."""

    log_link_bw: torch.Tensor  # (n_groups,)
    log_local_read: torch.Tensor  # (s,)
    log_local_write: torch.Tensor  # (s,)
    att_raw: torch.Tensor  # () — hop_attenuation = sigmoid(att_raw)


class SampleDiagnostics(NamedTuple):
    """Ingestion receipts from :func:`clean_samples`: how many rows
    arrived, how many survived, and why the rest were rejected."""

    n_total: int
    n_kept: int
    n_rejected: int
    reasons: tuple[str, ...]  # one short description per reject category

    @property
    def reject_rate(self) -> float:
        """Fraction of ingested rows rejected (0.0 on an empty batch)."""
        return self.n_rejected / self.n_total if self.n_total else 0.0


class CalibrationResult(NamedTuple):
    """A fitted machine plus the optimizer's receipts (loss trajectory,
    seed-vs-final loss, and the raw parameters behind the spec).
    ``diagnostics`` carries the ingestion receipts when the fit cleaned
    its input (``fit_machine(clean=True)``, the default)."""

    machine: MachineSpec  # the fitted spec (concrete, validated)
    params: CalibrationParams
    groups: LinkGroups
    loss_history: np.ndarray  # (steps,)
    seed_loss: float
    final_loss: float
    diagnostics: "SampleDiagnostics | None" = None


def _host(x) -> np.ndarray:
    """A tensor (any device) or array-like as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


# ---------------------------------------------------------------------------
# Sample construction
# ---------------------------------------------------------------------------


def _stack_probe_workloads(wls: Sequence[Workload], device) -> tuple[torch.Tensor, ...]:
    n_threads = {w.n_threads for w in wls}
    if len(n_threads) != 1:
        raise ValueError(f"probe workloads must share a thread count, got {n_threads}")
    return tuple(
        torch.stack([p.to(device) for p in parts]) for parts in zip(*(w[1:] for w in wls))
    )


def samples_from_counters(
    workloads: Sequence[Workload],
    placements,
    counters: Sequence[CounterSample],
) -> CalibrationSamples:
    """Package an externally measured counter trace (one
    :class:`CounterSample` per known workload+placement run) for fitting,
    on the workloads' device — the path a real machine's counter trace
    takes into the calibrator."""
    if not len(workloads) == len(counters):
        raise ValueError("one CounterSample per workload run required")
    dev = workloads[0].device
    placements_np = _host(placements).astype(np.int32)
    if placements_np.shape[0] != len(workloads):
        raise ValueError("one placement per workload run required")
    # each CounterSample records the placement of its own run — a silent
    # order mismatch would apportion the remote counters by the wrong
    # thread counts and corrupt the fit
    for k, c in enumerate(counters):
        recorded = _host(c.n_per_socket)
        if not np.array_equal(recorded, placements_np[k]):
            raise ValueError(
                f"run {k}: placement {placements_np[k].tolist()} "
                f"disagrees with the counter sample's recorded placement "
                f"{recorded.tolist()}"
            )

    def stack(field):
        return torch.stack([getattr(c, field).to(dev) for c in counters])

    return CalibrationSamples(
        wl_arrays=_stack_probe_workloads(workloads, dev),
        placements=torch.as_tensor(placements_np, device=dev),
        local_read=stack("local_read"),
        remote_read=stack("remote_read"),
        local_write=stack("local_write"),
        remote_write=stack("remote_write"),
        instructions=stack("instructions"),
        elapsed=torch.stack(
            [torch.as_tensor(c.elapsed, dtype=_F32).to(dev) for c in counters]
        ),
    )


def _take_rows(samples: CalibrationSamples, keep: np.ndarray) -> CalibrationSamples:
    """Index every leaf of a sample set by the ``keep`` row indices."""
    idx = torch.as_tensor(np.asarray(keep, np.int64), device=samples.device)
    return CalibrationSamples(
        tuple(a[idx] for a in samples.wl_arrays), *(t[idx] for t in samples[1:])
    )


def _counter_leaves(samples: CalibrationSamples) -> tuple[torch.Tensor, ...]:
    return (
        samples.local_read, samples.remote_read, samples.local_write,
        samples.remote_write, samples.instructions,
    )


def clean_samples(
    samples: CalibrationSamples,
    *,
    on_empty: str = "raise",
) -> tuple[CalibrationSamples, SampleDiagnostics]:
    """NaN-guard a sample batch before it can poison the AdamW fit.

    A row is rejected when any of its workload arrays, placement entries
    or counters is non-finite, any counter is negative, or its elapsed
    time is not strictly positive.  Returns the surviving rows plus a
    :class:`SampleDiagnostics` counting what was dropped and why.

    ``on_empty="raise"`` (default) raises ``ValueError`` when no row
    survives; ``on_empty="ignore"`` returns the empty batch."""
    P = samples.n_samples
    leaves = samples.wl_arrays + (samples.placements,) + _counter_leaves(samples) + (
        samples.elapsed,
    )
    finite = np.ones((P,), bool)
    for arr in leaves:
        finite &= np.isfinite(_host(arr).astype(np.float64).reshape(P, -1)).all(axis=1)
    counters = np.concatenate(
        [_host(c).astype(np.float64).reshape(P, -1) for c in _counter_leaves(samples)],
        axis=1,
    )
    with np.errstate(invalid="ignore"):
        nonneg = ~(counters < 0).any(axis=1)
        pos_elapsed = _host(samples.elapsed).astype(np.float64) > 0
    keep_mask = finite & nonneg & pos_elapsed
    reasons = []
    for mask, what in (
        (~finite, "non-finite values"),
        (finite & ~nonneg, "negative counters"),
        (finite & nonneg & ~pos_elapsed, "non-positive elapsed time"),
    ):
        idx = np.flatnonzero(mask)
        if idx.size:
            shown = ", ".join(str(i) for i in idx[:8])
            more = f", +{idx.size - 8} more" if idx.size > 8 else ""
            reasons.append(f"{idx.size} row(s) with {what} (rows {shown}{more})")
    diag = SampleDiagnostics(
        n_total=P,
        n_kept=int(keep_mask.sum()),
        n_rejected=int(P - keep_mask.sum()),
        reasons=tuple(reasons),
    )
    if diag.n_kept == 0 and on_empty == "raise":
        raise ValueError(
            f"all {P} calibration samples rejected: " + "; ".join(reasons)
            if reasons
            else "calibration sample batch is empty"
        )
    if diag.n_rejected == 0:
        return samples, diag
    return _take_rows(samples, np.flatnonzero(keep_mask)), diag


def concat_samples(batches: Sequence[CalibrationSamples]) -> CalibrationSamples:
    """Concatenate sample batches along the sample axis (the accumulation
    step of a recalibration stream).  All batches must agree on node
    count and probe thread count."""
    if not batches:
        raise ValueError("need at least one sample batch to concatenate")
    if len(batches) == 1:
        return batches[0]
    nodes = {b.n_nodes for b in batches}
    if len(nodes) != 1:
        raise ValueError(f"sample batches disagree on node count: {nodes}")
    shapes = {tuple(tuple(a.shape[1:]) for a in b.wl_arrays) for b in batches}
    if len(shapes) != 1:
        raise ValueError(
            "sample batches disagree on workload shape (thread counts differ?)"
        )
    dev = batches[0].device
    return CalibrationSamples(
        tuple(
            torch.cat([b.wl_arrays[i].to(dev) for b in batches])
            for i in range(len(batches[0].wl_arrays))
        ),
        *(torch.cat([b[f].to(dev) for b in batches]) for f in range(1, len(batches[0]))),
    )


def take_samples(samples: CalibrationSamples, idx) -> CalibrationSamples:
    """Row-subset a sample set (``idx`` is any numpy index expression:
    integer rows or a boolean mask) — the partial-sweep path."""
    return _take_rows(samples, np.arange(samples.n_samples)[np.asarray(idx)])


# ---------------------------------------------------------------------------
# Probe sweep design
# ---------------------------------------------------------------------------


def _spread_placement(s: int, n_threads: int) -> np.ndarray:
    counts = np.full((s,), n_threads // s, np.int32)
    counts[: n_threads % s] += 1
    return counts


def probe_suite(
    template: MachineSpec,
    n_threads: int | None = None,
    *,
    read_bpi: float = 8.0,
    write_bpi: float = 4.0,
    device=DEFAULT_DEVICE,
) -> list[tuple[Workload, np.ndarray]]:
    """The designed calibration sweep: ``(workload, placement)`` pairs
    whose union of saturation patterns identifies every free parameter
    (workloads on ``device``, placements as numpy rows).

    Only the template's structure shapes the design.  Every probe shares
    one thread count, so the whole sweep stacks into one paired batch:
    per-node local probes in each direction, per-ordered-pair static
    probes, spread interleave probes, static-sink probes at three
    write:read ratios, and the paper's 2-run pair."""
    dev = resolve_device(device)
    s, cap = template.n_nodes, template.cores_per_node
    if n_threads is None:
        n_threads = min(cap, 8)
    if not 0 < n_threads <= cap:
        raise ValueError(f"{n_threads} probe threads exceed {cap} cores/node")
    nt = n_threads
    probes: list[tuple[Workload, np.ndarray]] = []

    def probe(name, placement, **kw):
        probes.append((mixed_workload(name, nt, device=dev, **kw), placement))

    def one_node(i: int) -> np.ndarray:
        p = np.zeros((s,), np.int32)
        p[i] = nt
        return p

    # 1. per-node local probes, one direction at a time
    for i in range(s):
        for tag, rb, wb in (("r", read_bpi, 0.0), ("w", 0.0, write_bpi)):
            probe(f"cal-local-{tag}{i}", one_node(i),
                  read_mix=(0.0, 1.0, 0.0), read_bpi=rb, write_bpi=wb)

    # 2. per-ordered-pair static probes: all threads on node i streaming a
    #    Static allocation on node j
    for i in range(s):
        for j in range(s):
            if i == j:
                continue
            for tag, rb, wb in (("r", read_bpi, 0.0), ("w", 0.0, write_bpi)):
                probe(f"cal-pair-{tag}{i}-{j}", one_node(i), read_mix=(1.0, 0.0, 0.0),
                      read_bpi=rb, write_bpi=wb, static_socket=j)

    # 3. spread interleave stress probes: the only pattern that fills fat
    #    shared links
    spread = _spread_placement(s, nt)
    for tag, rb, wb in (
        ("r", read_bpi, 0.0), ("w", 0.0, write_bpi), ("rw", read_bpi, write_bpi),
    ):
        probe(f"cal-inter-{tag}", spread, read_mix=(0.0, 0.0, 0.0),
              read_bpi=rb, write_bpi=wb)

    # 4. static-sink stress probes: every other node's threads converging
    #    on one bank, at several write:read ratios so that for some ratio
    #    the incident link binds before either bank direction
    for j in range(s):
        if s < 2:
            break
        others = np.zeros((s,), np.int32)
        others[np.arange(s) != j] = _spread_placement(s - 1, nt)
        for alpha in (0.25, 0.5, 1.0):
            probe(f"cal-sink-{j}-a{alpha}", others, read_mix=(1.0, 0.0, 0.0),
                  read_bpi=read_bpi, write_bpi=read_bpi * alpha, static_socket=j)

    # 5. the paper's 2-run pair (§5.1), kept in-sweep
    wl_2run = mixed_workload(
        "cal-2run", nt, read_mix=(0.3, 0.3, 0.2),
        read_bpi=read_bpi * 0.5, write_bpi=write_bpi * 0.5, device=dev,
    )
    probes.append((wl_2run, spread))
    probes.append((wl_2run, np.asarray(_asymmetric_counts(template, nt), np.int32)))
    return probes


def _bank_counters(flows: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Bank-perspective ``(local, remote)`` counters of ``(..., s, s)``
    flows (:func:`~repro_torch.core.bwsig.counters.counters_from_flows`
    without its tensor wrapping)."""
    local = torch.diagonal(flows, dim1=-2, dim2=-1)
    return local, flows.sum(dim=-2) - local


def _simulated_counters(
    machine: MachineSpec, wl_arrays, placements, thread_classes
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Noise-free ``(read_flows, write_flows, instructions)`` of every
    sample row on the paired batch."""
    res = simulate_paired_batch(
        machine, Workload("calib", *wl_arrays), placements, thread_classes=thread_classes
    )
    return res.read_flows, res.write_flows, res.instructions


def collect_sweep(
    machine: MachineSpec,
    probes: Sequence[tuple[Workload, np.ndarray]] | None = None,
    *,
    noise_std: float = 0.0,
    background_bw: float = 0.0,
    noise: CounterNoise | None = None,
    generator: torch.Generator | None = None,
    device=DEFAULT_DEVICE,
) -> CalibrationSamples:
    """Run a probe sweep through the simulator (the synthetic-ground-truth
    path) on ``device`` and package the observed counters for fitting.
    ``probes`` defaults to :func:`probe_suite` on the machine itself.  A
    noisy sweep takes its draws from ``noise`` (leading axis = probes) or
    from ``generator`` (seed 0 when none is given)."""
    dev = resolve_device(device)
    if probes is None:
        probes = probe_suite(machine, device=dev)
    wls = [wl for wl, _ in probes]
    P, s = len(wls), machine.n_nodes
    placements = torch.as_tensor(
        np.stack([_host(p) for _, p in probes]).astype(np.int32), device=dev
    )
    wl_arrays = _stack_probe_workloads(wls, dev)
    rf, wf, ins = _simulated_counters(
        machine, wl_arrays, placements, thread_class_starts(wls)
    )
    if noise_std > 0.0 or background_bw > 0.0:
        if noise is None:
            if generator is None:
                generator = default_generator(dev)
            noise = draw_counter_noise((P,), s, generator, dev)
        noise = CounterNoise(*(z.to(dev) for z in noise))
        rf, wf, ins = _apply_noise(rf, wf, ins, 1.0, noise_std, background_bw, noise, s)
    lr, rr = _bank_counters(rf)
    lw, rw = _bank_counters(wf)
    return CalibrationSamples(
        wl_arrays=wl_arrays, placements=placements,
        local_read=lr, remote_read=rr, local_write=lw, remote_write=rw,
        instructions=ins,
        elapsed=torch.ones((P,), dtype=_F32, device=dev),
    )


# ---------------------------------------------------------------------------
# Stage 1: counter seeding
# ---------------------------------------------------------------------------


def _pair_flows(samples: CalibrationSamples, counter: torch.Tensor) -> torch.Tensor:
    """``(P, s, s)`` estimated source->bank flows from a bank-perspective
    counter, apportioning each bank's remote traffic to the other nodes in
    proportion to their thread counts (exact for one remote source)."""
    w = _remote_source_weights(samples.placements)  # (P, bank j, src i)
    return (w * counter[:, :, None]).transpose(1, 2)  # (P, i, j)


def seed_parameters(
    template: MachineSpec,
    samples: CalibrationSamples,
    groups: LinkGroups | None = None,
    *,
    floor_frac: float = 0.02,
) -> CalibrationParams:
    """Closed-form seeds on the samples' device: every observed rate is a
    lower bound on the capacity it crossed.  Parameters never exercised
    are floored at ``floor_frac`` of the largest seed in their family so
    log space stays finite."""
    if groups is None:
        groups = link_groups(template.topology)
    dev = samples.device
    s = template.n_nodes
    el = samples.elapsed[:, None]
    lr = samples.local_read / el
    rr = samples.remote_read / el
    lw = samples.local_write / el
    rw = samples.remote_write / el

    def floored(x: torch.Tensor) -> torch.Tensor:
        return torch.maximum(x, torch.clamp(floor_frac * x.max(), min=1.0))

    bank_r = floored((lr + rr).amax(0))
    bank_w = floored((lw + rw).amax(0))

    pair_r = _pair_flows(samples, rr)
    pair_w = _pair_flows(samples, rw)
    incidence = torch.as_tensor(
        np.array(template.topology.route_incidence(), np.float32), device=dev
    )  # (s*s, L)
    charge = (pair_r + pair_w).reshape(samples.n_samples, s * s) @ incidence
    link_seed = _host(floored(charge.amax(0)))

    # attenuation: a multi-hop pair's flow obeys flow <= base * att**(h-1),
    # so every (flow/base)**(1/(h-1)) lower-bounds att; take the best bound
    hops = np.asarray(template.topology.hop_matrix(), np.float64)
    att_seed = 0.95
    if hops.max() > 1:
        ests = []
        for base, flows in (
            (template.remote_read_bw, _host(pair_r.amax(0)).astype(np.float64)),
            (template.remote_write_bw, _host(pair_w.amax(0)).astype(np.float64)),
        ):
            multi = hops > 1
            ratio = np.clip(flows / max(base, _EPS), 1e-6, 1.0)
            ests.append((ratio ** (1.0 / np.maximum(hops - 1.0, 1.0)))[multi])
        att_seed = float(np.clip(np.concatenate(ests).max(), 0.3, 0.995))

    return CalibrationParams(
        log_link_bw=torch.log(torch.as_tensor(groups.pack(link_seed), dtype=_F32, device=dev)),
        log_local_read=torch.log(bank_r),
        log_local_write=torch.log(bank_w),
        att_raw=torch.as_tensor(np.log(att_seed / (1.0 - att_seed)), dtype=_F32, device=dev),
    )


# ---------------------------------------------------------------------------
# Stage 2: projected gradient over the differentiable forward model
# ---------------------------------------------------------------------------


class _CapsLayout(NamedTuple):
    """Device tensors of the static structure :func:`_caps_from` reads:
    the link->parameter gather, the remote-path diagonal and extra hops."""

    link_index: torch.Tensor  # (n_links,) int64
    diagonal: torch.Tensor  # (s, s) bool
    extra_hops: torch.Tensor  # (s, s) max(hops - 1, 0)


def _caps_layout(template: MachineSpec, groups: LinkGroups, device) -> _CapsLayout:
    hops = torch.as_tensor(
        np.array(template.topology.hop_matrix(), np.float32), device=device
    )
    return _CapsLayout(
        link_index=torch.as_tensor(groups.link_index(), dtype=torch.int64, device=device),
        diagonal=hops == 0,
        extra_hops=torch.clamp(hops - 1.0, min=0.0),
    )


def _caps_from(
    template: MachineSpec,
    groups: LinkGroups,
    params: CalibrationParams,
    layout: _CapsLayout | None = None,
) -> torch.Tensor:
    """Assemble the capacity vector (simulator slab order) from the free
    parameters; routing, hop counts and the remote path bases stay
    template structure.  ``layout`` carries that structure on the device
    (built here when absent)."""
    s = template.n_nodes
    dev = params.log_link_bw.device
    if layout is None:
        layout = _caps_layout(template, groups, dev)
    link_bw = torch.exp(params.log_link_bw)[layout.link_index]
    bank_r = torch.exp(params.log_local_read)
    bank_w = torch.exp(params.log_local_write)
    if template.topology.max_hops > 1:
        att = torch.sigmoid(params.att_raw)
    else:  # single-hop: attenuation is structurally unobservable
        att = torch.ones((), dtype=_F32, device=dev)
    scale = att**layout.extra_hops
    rr = torch.where(layout.diagonal, _UNUSED_CAP, template.remote_read_bw * scale)
    ww = torch.where(layout.diagonal, _UNUSED_CAP, template.remote_write_bw * scale)
    return torch.cat([bank_r, bank_w, rr.reshape(s * s), ww.reshape(s * s), link_bw])


def _residual_penalty(r: torch.Tensor, huber_delta: float | None) -> torch.Tensor:
    """Sum over the last axis of the squared residuals, or — when
    ``huber_delta`` is set — of the Huber penalty: quadratic inside
    ``delta``, linear outside, so a few corrupted rows pull the fit
    linearly instead of quadratically."""
    if huber_delta is None:
        return (r**2).sum(-1)
    a = torch.abs(r)
    d = huber_delta
    return torch.where(a <= d, 0.5 * a * a, d * (a - 0.5 * d)).sum(-1)


class _Sweep(NamedTuple):
    """What the loss reads from a sample set, built once per fit: the
    paired slab, the observed rates and their normalizers."""

    slab: PairedSlab
    observed: torch.Tensor  # (P, 4s) local/remote read, local/remote write rates
    total: torch.Tensor  # (P,)
    instructions: torch.Tensor  # (P, s) observed instruction rates
    instruction_total: torch.Tensor  # (P,)
    layout: _CapsLayout


def _prepare_sweep(template, groups, samples, thread_classes) -> _Sweep:
    el = samples.elapsed
    observed = torch.cat(
        [samples.local_read, samples.remote_read, samples.local_write, samples.remote_write],
        dim=-1,
    ) / el[:, None]
    return _Sweep(
        slab=paired_slab(
            template, Workload("calib", *samples.wl_arrays), samples.placements,
            thread_classes=thread_classes,
        ),
        observed=observed,
        total=torch.clamp(observed.sum(-1), min=_EPS),
        instructions=samples.instructions / el[:, None],
        instruction_total=torch.clamp(samples.instructions.sum(-1) / el, min=_EPS),
        layout=_caps_layout(template, groups, samples.device),
    )


def _loss_on(template, groups, sweep: _Sweep, params, instruction_weight, huber_delta):
    caps = _caps_from(template, groups, params, sweep.layout)
    sim = fill_paired(template, sweep.slab, caps)
    lr, rr = _bank_counters(sim.read_flows)
    lw, rw = _bank_counters(sim.write_flows)
    simulated = torch.cat([lr, rr, lw, rw], dim=-1)
    err = _residual_penalty((simulated - sweep.observed) / sweep.total[:, None], huber_delta)
    err = err + instruction_weight * _residual_penalty(
        (sim.instructions - sweep.instructions) / sweep.instruction_total[:, None],
        huber_delta,
    )
    return err.mean()


def _sweep_loss(
    template: MachineSpec,
    groups: LinkGroups,
    samples: CalibrationSamples,
    params: CalibrationParams,
    instruction_weight: float,
    thread_classes: tuple[int, ...],
    huber_delta: float | None = None,
) -> torch.Tensor:
    """Mean over the samples of the relative counter residual penalty
    (plus ``instruction_weight`` times the instruction residual's) of the
    forward model at ``params``."""
    sweep = _prepare_sweep(template, groups, samples, thread_classes)
    return _loss_on(template, groups, sweep, params, instruction_weight, huber_delta)


_PARAM_KEYS = tuple(sorted(CalibrationParams._fields))  # JAX's dict flattening order


def _fit_step(template, groups, sweep, p, state, lr, instruction_weight, huber_delta):
    """One AdamW step over the prepared sweep from the parameter dict
    ``p``, updated in place: ``(loss at p, p, updated state)``."""
    leaves = {k: v.detach().requires_grad_() for k, v in p.items()}
    loss = _loss_on(
        template, groups, sweep, CalibrationParams(**leaves), instruction_weight, huber_delta
    )
    grads = torch.autograd.grad(loss, [leaves[k] for k in _PARAM_KEYS], allow_unused=True)
    # an unused leaf (single-hop attenuation) has a zero gradient, as in JAX
    grads = {
        k: torch.zeros_like(leaves[k]) if g is None else g
        for k, g in zip(_PARAM_KEYS, grads)
    }
    state = adamw.update_(grads, state, p, lr=lr, weight_decay=0.0)
    return loss.detach(), p, state


def _fit_loop(template, groups, sweep, params, steps, lr, instruction_weight, huber_delta):
    """``steps`` AdamW steps of forward plus backward over the prepared
    sweep.  ``history[k]`` is the loss at the pre-update params of step
    ``k``; the history stays on the device (no host sync in the loop)."""
    schedule = adamw.cosine_schedule(
        lr, warmup_steps=min(20, max(steps // 10, 1)), total_steps=steps
    )
    p = {k: getattr(params, k).detach().clone() for k in _PARAM_KEYS}  # updated in place
    state = adamw.init(p)
    history = []
    for _ in range(steps):
        loss, p, state = _fit_step(
            template, groups, sweep, p, state, schedule(state.step),
            instruction_weight, huber_delta,
        )
        history.append(loss)
    final = CalibrationParams(**p)
    with torch.no_grad():
        final_loss = _loss_on(template, groups, sweep, final, instruction_weight, huber_delta)
    return final, torch.stack(history) if history else torch.zeros((0,)), final_loss


def fitted_machine(
    template: MachineSpec,
    groups: LinkGroups,
    params: CalibrationParams,
    *,
    name: str | None = None,
) -> MachineSpec:
    """Materialize a concrete, validated ``MachineSpec`` from fitted
    parameters (float64 on the host): per-link bandwidths through
    :func:`~repro_torch.core.numa.topology.from_fit` (routes held
    static), per-node local tuples, scalar attenuation."""
    link_bw = np.exp(_host(params.log_link_bw).astype(np.float64))
    full_link_bw = np.asarray(groups.unpack(link_bw))
    att = (
        float(torch.sigmoid(params.att_raw.detach()))
        if template.topology.max_hops > 1
        else template.hop_attenuation
    )
    machine = template._replace(
        name=name or f"{template.name}-fit",
        local_read_bw=tuple(
            float(v) for v in np.exp(_host(params.log_local_read).astype(np.float64))
        ),
        local_write_bw=tuple(
            float(v) for v in np.exp(_host(params.log_local_write).astype(np.float64))
        ),
        hop_attenuation=att,
        topology=from_fit(
            template.topology, full_link_bw, name=f"{template.topology.name}-fit"
        ),
    )
    machine.validate()
    return machine


def _sample_classes(samples: CalibrationSamples) -> tuple[int, ...]:
    # the last leaf is the stacked static_socket, whose trailing axis is
    # samples, not threads
    return class_starts_from_arrays(samples.wl_arrays[:-1])


def fit_machine(
    template: MachineSpec,
    samples: CalibrationSamples,
    *,
    steps: int = 250,
    lr: float = 0.03,
    tie_equal_bw: bool = False,
    groups: LinkGroups | None = None,
    init: CalibrationParams | None = None,
    instruction_weight: float = 0.25,
    name: str | None = None,
    clean: bool = True,
    huber_delta: float | None = None,
) -> CalibrationResult:
    """Fit a machine's free parameters from a counter sweep, on the
    samples' device.

    ``template`` supplies the structure; its bandwidth values are not
    consulted (seeding reads them off the samples).  ``tie_equal_bw``
    shares one parameter across links of one template class.
    ``clean=True`` runs :func:`clean_samples` first (receipts in
    ``result.diagnostics``); ``huber_delta`` switches the loss from
    squared to Huber on the relative residuals."""
    if samples.n_nodes != template.n_nodes:
        raise ValueError(
            f"samples cover {samples.n_nodes} nodes; template has "
            f"{template.n_nodes}"
        )
    diagnostics = None
    if clean:
        samples, diagnostics = clean_samples(samples)
    if samples.n_samples == 0:
        raise ValueError("no calibration samples to fit from")
    if groups is None:
        groups = link_groups(template.topology, tie_equal_bw=tie_equal_bw)
    if init is None:
        init = seed_parameters(template, samples, groups)
    huber = None if huber_delta is None else float(huber_delta)
    iw = float(instruction_weight)
    sweep = _prepare_sweep(template, groups, samples, _sample_classes(samples))
    with torch.no_grad():
        seed_loss = float(_loss_on(template, groups, sweep, init, iw, huber))
    params, history, final_loss = _fit_loop(
        template, groups, sweep, init, int(steps), float(lr), iw, huber
    )
    return CalibrationResult(
        machine=fitted_machine(template, groups, params, name=name),
        params=params,
        groups=groups,
        loss_history=_host(history),
        seed_loss=seed_loss,
        final_loss=float(final_loss),
        diagnostics=diagnostics,
    )


# ---------------------------------------------------------------------------
# Round-trip drivers and diagnostics
# ---------------------------------------------------------------------------


def blind_template(
    machine: MachineSpec,
    *,
    link_bw: float = 20.0 * GB,
    local_read_bw: float = 40.0 * GB,
    local_write_bw: float = 20.0 * GB,
    hop_attenuation: float = 1.0,
) -> MachineSpec:
    """Strip a machine of everything the calibration is supposed to
    recover, keeping only structure: link list + routes, node geometry,
    core rates and the remote path bases."""
    return machine._replace(
        name=f"{machine.name}-blind",
        local_read_bw=local_read_bw,
        local_write_bw=local_write_bw,
        hop_attenuation=hop_attenuation,
        topology=from_fit(
            machine.topology,
            np.full((machine.n_links,), link_bw),
            name=f"{machine.topology.name}-blind",
        ),
    )


def fit_from_simulated(
    machine: MachineSpec,
    template: MachineSpec | None = None,
    *,
    probes: Sequence[tuple[Workload, np.ndarray]] | None = None,
    noise_std: float = 0.0,
    noise: CounterNoise | None = None,
    generator: torch.Generator | None = None,
    device=DEFAULT_DEVICE,
    **fit_kwargs,
) -> CalibrationResult:
    """The synthetic round trip on ``device``: sweep ``machine`` (ground
    truth) through the simulator, then fit blind from the samples alone.
    ``template`` defaults to :func:`blind_template` of the machine."""
    samples = collect_sweep(
        machine, probes, noise_std=noise_std, noise=noise, generator=generator,
        device=device,
    )
    if template is None:
        template = blind_template(machine)
    return fit_machine(template, samples, **fit_kwargs)


def counter_errors_pct(machine: MachineSpec, samples: CalibrationSamples) -> np.ndarray:
    """``(P,)`` per-sample relative total-counter error (%) of
    ``machine``'s predicted counters against the observed sweep (the
    forward model replayed over the samples on their device, compared in
    float64 on the host) — what the live-recalibration guard gates on."""
    P = samples.n_samples
    if P == 0:
        raise ValueError("cannot score a machine against zero samples")
    if samples.n_nodes != machine.n_nodes:
        raise ValueError(
            f"samples cover {samples.n_nodes} nodes; machine has "
            f"{machine.n_nodes}"
        )
    with torch.no_grad():
        rf, wf, _ = _simulated_counters(
            machine, samples.wl_arrays, samples.placements, _sample_classes(samples)
        )
    lr, rr = _bank_counters(rf)
    lw, rw = _bank_counters(wf)

    def rows(arrays):
        return np.concatenate(
            [_host(x).astype(np.float64).reshape(P, -1) for x in arrays], axis=1
        )

    sim = rows((lr, rr, lw, rw))
    el = _host(samples.elapsed).astype(np.float64).reshape(P, 1)
    obs = rows((samples.local_read, samples.remote_read,
                samples.local_write, samples.remote_write)) / el
    denom = np.maximum(np.abs(obs).sum(axis=1), _EPS)
    return 100.0 * np.abs(sim - obs).sum(axis=1) / denom


def sweep_median_error_pct(machine: MachineSpec, samples: CalibrationSamples) -> float:
    """Median of :func:`counter_errors_pct` — the single number the
    recalibration swap guard compares old and new specs on."""
    return float(np.median(counter_errors_pct(machine, samples)))


def link_relative_errors(fitted: MachineSpec, reference: MachineSpec) -> np.ndarray:
    """``(n_links,)`` relative error of every fitted link bandwidth
    against a reference machine with the same link list."""
    if fitted.topology.link_ends != reference.topology.link_ends:
        raise ValueError("machines disagree on the link list")
    fit = np.asarray(fitted.topology.link_bw, np.float64)
    ref = np.asarray(reference.topology.link_bw, np.float64)
    return np.abs(fit - ref) / ref


def local_bw_relative_errors(
    fitted: MachineSpec, reference: MachineSpec
) -> dict[str, np.ndarray]:
    """Per-node relative errors of the fitted local bandwidths (through
    float32, as the reference's node vectors are)."""
    out = {}
    for direction in ("read", "write"):
        fit = _host(fitted.node_local_bw(direction, "cpu")).astype(np.float64)
        ref = _host(reference.node_local_bw(direction, "cpu")).astype(np.float64)
        out[direction] = np.abs(fit - ref) / ref
    return out
