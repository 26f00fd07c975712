"""Steady-state NUMA bandwidth simulator with max-min fair saturation
(port of ``repro.core.numa.simulator``).

Given a machine, a workload and a thread placement (threads per NUMA
node) this computes every thread's execution rate under bandwidth
saturation by *progressive filling*: all threads speed up together until
a resource (a bank's read or write capacity, a remote path, an
interconnect link) saturates; the threads crossing it freeze and the
rest keep growing.  It emits the counters the paper's fit reads.

Three solvers, as in the reference:

* :func:`simulate_reference` — one resource-slab row per thread (the
  test reference);
* :func:`simulate` — rows collapsed to ``(class, node)`` thread groups
  with integer multiplicities (exact: identical rows freeze together);
* :func:`simulate_grouped_batch` — the main path's hot loop: a whole
  placement batch (and optionally a batch of workloads) in one pass over
  a *structured* slab built once per support bucket;
* :func:`simulate_paired_batch` — the same structured fill over paired
  rows (workload ``p`` at placement ``p``): a probe sweep, and the
  calibration's loss, which refills one :class:`PairedSlab` with new
  capacities at every step.

Every fill runs a fixed count of ``min(rows, resources) + 1`` iterations:
each iteration freezes at least one row set, so that count reaches the
fixed point, and iterations after it change nothing.  It gives the
reference's ``while_loop`` result without a host sync per iteration.
Batch dimensions that the reference gets from ``vmap`` are written out.

Measurement noise: the reference draws ``jax.random`` streams, which
torch cannot reproduce.  Noisy calls here take the standard-normal draws
as a :class:`CounterNoise` (the tests pass JAX's draws in), or draw them
from a ``torch.Generator``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import DEFAULT_DEVICE, resolve_device
from repro_torch.core.bwsig.counters import CounterSample, counters_from_flows
from repro_torch.core.numa.machine import MachineSpec, canonical_bank_assignment
from repro_torch.core.numa.workload import Workload

_EPS = 1e-12
_F32 = torch.float32


class SimulationResult(NamedTuple):
    """One simulated run: per-thread rates, per-node-pair flow matrices,
    the counter sample the model may observe, and total throughput."""

    rates: torch.Tensor  # (n,) per-thread execution-rate multiplier in (0, 1]
    read_flows: torch.Tensor  # (s, s) bytes from node i CPUs to bank j
    write_flows: torch.Tensor  # (s, s)
    sample: CounterSample
    throughput: torch.Tensor  # scalar: sum of thread rates


class CounterNoise(NamedTuple):
    """Standard-normal draws for one (or a batch of) noisy runs: the
    lognormal factors of the read and write flows and of the instruction
    counts, ``exp(noise_std * z)`` (``0.2 * noise_std`` for instructions)."""

    read: torch.Tensor  # (..., s, s)
    write: torch.Tensor  # (..., s, s)
    instructions: torch.Tensor  # (..., s)


def draw_counter_noise(
    batch: tuple[int, ...], s: int, generator: torch.Generator, device
) -> CounterNoise:
    """Draw :class:`CounterNoise` with leading dimensions ``batch``."""
    def z(*shape):
        return torch.randn(
            batch + shape, generator=generator, dtype=_F32, device=device
        )

    return CounterNoise(z(s, s), z(s, s), z(s))


def default_generator(device, seed: int = 0) -> torch.Generator:
    """A generator on ``device`` seeded with ``seed`` — the counterpart of
    the reference's default ``PRNGKey(0)``."""
    return torch.Generator(device=device).manual_seed(seed)


def _f32(a: np.ndarray, device) -> torch.Tensor:
    """A numpy table (float64 in graphtop) as a float32 tensor."""
    return torch.as_tensor(np.array(a, np.float32), device=device)


def _thread_nodes(n_per_node: torch.Tensor, n_threads: int) -> torch.Tensor:
    """Contiguous thread->node assignment: the first ``n_0`` threads on
    node 0, the next ``n_1`` on node 1, ..."""
    bounds = torch.cumsum(n_per_node.to(torch.int64), dim=0)
    t = torch.arange(n_threads, device=n_per_node.device)
    return torch.searchsorted(bounds, t, right=True)


def _mix_rows(
    static_frac, local_frac, per_thread_frac, static_socket, node_of,
    n_per_node, bank_assignment=None,
) -> torch.Tensor:
    """Per-thread traffic mix over banks (the per-thread version of the
    paper's §4 class matrices); ``bank_assignment`` redirects the Local
    class of a thread on node ``k`` to bank ``bank_assignment[k]``."""
    s = n_per_node.shape[0]
    dev = n_per_node.device
    nf = n_per_node.to(_F32)
    used = (nf > 0).to(_F32)
    s_used = torch.clamp(used.sum(), min=1.0)

    static_row = (torch.arange(s, device=dev) == static_socket).to(_F32)
    if bank_assignment is None:
        local_rows = F.one_hot(node_of, s).to(_F32)
    else:
        bank_of = torch.tensor(bank_assignment, dtype=torch.int64, device=dev)[node_of]
        local_rows = F.one_hot(bank_of, s).to(_F32)
    pt_row = nf / torch.clamp(nf.sum(), min=1.0)
    il_row = used / s_used

    inter = 1.0 - static_frac - local_frac - per_thread_frac
    return (
        static_frac[:, None] * static_row[None, :]
        + local_frac[:, None] * local_rows
        + per_thread_frac[:, None] * pt_row[None, :]
        + inter[:, None] * il_row[None, :]
    )


def machine_caps(machine: MachineSpec, device) -> torch.Tensor:
    """The capacity vector of the resource slab, in slab order: bank
    reads (s), bank writes (s), remote read paths (s*s), remote write
    paths (s*s), interconnect links (n_links)."""
    s = machine.n_nodes
    return torch.cat(
        [
            machine.bank_read_caps(device),
            machine.bank_write_caps(device),
            machine.remote_read_caps(device).reshape(s * s),
            machine.remote_write_caps(device).reshape(s * s),
            machine.link_caps(device),
        ]
    )


def _resource_tensor(
    machine, read_unit, write_unit, node_of, caps=None, multipath=False
) -> tuple[torch.Tensor, torch.Tensor]:
    """The per-thread resource-usage matrix ``U[t, r]`` and the capacity
    vector, in :func:`machine_caps` order.  A flow from node ``i`` to
    bank ``j`` charges every link on ``route(i, j)``."""
    s = machine.n_nodes
    n = node_of.shape[0]
    dev = read_unit.device
    topo = machine.topology
    onehot = F.one_hot(node_of, s).to(_F32)

    rr = onehot[:, :, None] * read_unit[:, None, :]
    ww = onehot[:, :, None] * write_unit[:, None, :]
    off_diag = (1.0 - torch.eye(s, dtype=_F32, device=dev))[None, :, :]
    rr_remote = rr * off_diag
    ww_remote = ww * off_diag

    # (1) direct traffic on each link's own endpoint pair, summed in the
    # reference's order; (2) multi-hop routes through the incidence
    # matrix.  Under multipath the whole charge goes through the
    # fractional incidence.
    n_links = topo.n_links
    if n_links and multipath:
        inc = _f32(topo.route_incidence(multipath=True), dev)
        link_usage = (rr_remote + ww_remote).reshape(n, s * s) @ inc
    elif n_links:
        ends_i = torch.tensor([e[0] for e in topo.link_ends], device=dev)
        ends_j = torch.tensor([e[1] for e in topo.link_ends], device=dev)
        link_usage = (
            rr_remote[:, ends_i, ends_j]
            + rr_remote[:, ends_j, ends_i]
            + ww_remote[:, ends_i, ends_j]
            + ww_remote[:, ends_j, ends_i]
        )
        if not topo.is_fully_direct:
            routed = _f32(topo.route_incidence_multihop(), dev)
            cross = (rr_remote + ww_remote).reshape(n, s * s)
            link_usage = link_usage + cross @ routed
    else:
        link_usage = torch.zeros((n, 0), dtype=_F32, device=dev)

    usage = torch.cat(
        [
            read_unit,
            write_unit,
            rr_remote.reshape(n, s * s),
            ww_remote.reshape(n, s * s),
            link_usage,
        ],
        dim=1,
    )
    if caps is None:
        caps = machine_caps(machine, dev)
    return usage, caps


def _lam(resid: torch.Tensor, act: torch.Tensor) -> torch.Tensor:
    """Fill level at which each resource saturates (inf when no active
    row uses it)."""
    return torch.where(act > _EPS, resid / torch.clamp(act, min=_EPS), torch.inf)


def _progressive_fill(usage: torch.Tensor, caps: torch.Tensor, iterations: int) -> torch.Tensor:
    """Max-min fair rates: grow all threads together, freeze the set
    crossing each successive bottleneck."""
    n = usage.shape[0]
    x = torch.zeros((n,), dtype=usage.dtype, device=usage.device)
    frozen = torch.zeros((n,), dtype=torch.bool, device=usage.device)
    for _ in range(iterations):
        active = ~frozen
        frozen_usage = (usage * torch.where(frozen, x, 0.0)[:, None]).sum(0)
        act_usage = (usage * active[:, None].to(usage.dtype)).sum(0)
        resid = torch.clamp(caps - frozen_usage, min=0.0)
        lam = _lam(resid, act_usage)
        lam_star = torch.clamp(lam.min(), max=1.0)
        bottleneck = lam <= lam_star * (1.0 + 1e-6)
        uses_bottleneck = (usage * bottleneck[None, :]).sum(1) > _EPS
        freeze_now = active & (uses_bottleneck | (lam_star >= 1.0))
        x = torch.where(freeze_now, lam_star, x)
        frozen = frozen | freeze_now
    # anything still unfrozen touches no finite resource: full speed
    return torch.where(frozen, x, 1.0)


def _placement_tensor(n_per_node, device) -> torch.Tensor:
    return torch.as_tensor(n_per_node, device=device).to(torch.int32)


def simulate_reference(
    machine: MachineSpec,
    workload: Workload,
    n_per_node,
    *,
    elapsed: float = 1.0,
    noise_std: float = 0.0,
    background_bw: float = 0.0,
    noise: CounterNoise | None = None,
    generator: torch.Generator | None = None,
    caps: torch.Tensor | None = None,
    multipath: bool = False,
    bank_assignment: tuple[int, ...] | None = None,
) -> SimulationResult:
    """The per-thread reference solver: one resource-slab row per thread
    (the formulation the grouped paths are tested against)."""
    bank_assignment = canonical_bank_assignment(machine, bank_assignment)
    dev = workload.device
    s = machine.n_nodes
    n = workload.n_threads
    n_per_node = _placement_tensor(n_per_node, dev)
    node_of = _thread_nodes(n_per_node, n)
    rate_of = machine.node_rates(dev)[node_of]

    read_mix = _mix_rows(
        workload.read_static, workload.read_local, workload.read_per_thread,
        workload.static_socket, node_of, n_per_node, bank_assignment,
    )
    write_mix = _mix_rows(
        workload.write_static, workload.write_local, workload.write_per_thread,
        workload.static_socket, node_of, n_per_node, bank_assignment,
    )
    read_unit = rate_of[:, None] * workload.read_bpi[:, None] * read_mix
    write_unit = rate_of[:, None] * workload.write_bpi[:, None] * write_mix

    usage, caps = _resource_tensor(
        machine, read_unit, write_unit, node_of, caps, multipath=multipath
    )
    iterations = min(usage.shape[0], usage.shape[1]) + 1
    rates = _progressive_fill(usage, caps, iterations)

    onehot = F.one_hot(node_of, s).to(_F32)
    read_flows = onehot.T @ (rates[:, None] * read_unit) * elapsed
    write_flows = onehot.T @ (rates[:, None] * write_unit) * elapsed
    instructions = onehot.T @ (rates * rate_of) * elapsed

    return _finalize_result(
        rates, read_flows, write_flows, instructions, n_per_node,
        elapsed, noise_std, background_bw, noise, generator, s,
    )


def _apply_noise(read_flows, write_flows, instructions, elapsed, noise_std,
                 background_bw, noise: CounterNoise, s: int):
    """The reference's lognormal measurement noise plus background
    traffic, from the standard-normal draws in ``noise``."""
    read_flows = read_flows * torch.exp(noise_std * noise.read) + (
        background_bw * elapsed / (s * s)
    )
    write_flows = write_flows * torch.exp(noise_std * noise.write) + (
        background_bw * elapsed / (s * s)
    )
    instructions = instructions * torch.exp(0.2 * noise_std * noise.instructions)
    return read_flows, write_flows, instructions


def _finalize_result(
    rates, read_flows, write_flows, instructions, n_per_node, elapsed,
    noise_std, background_bw, noise, generator, s,
) -> SimulationResult:
    """Measurement noise + counter reduction, shared by the grouped and
    per-thread paths."""
    if noise_std > 0.0 or background_bw > 0.0:
        if noise is None:
            if generator is None:
                generator = default_generator(rates.device)
            noise = draw_counter_noise((), s, generator, rates.device)
        read_flows, write_flows, instructions = _apply_noise(
            read_flows, write_flows, instructions, elapsed, noise_std,
            background_bw, noise, s,
        )
    sample = counters_from_flows(
        read_flows, write_flows, instructions, elapsed, n_per_node
    )
    return SimulationResult(
        rates=rates,
        read_flows=read_flows,
        write_flows=write_flows,
        sample=sample,
        throughput=rates.sum(),
    )


# ---------------------------------------------------------------------------
# Group-collapsed solver: (class, node) equivalence classes of threads
# ---------------------------------------------------------------------------


def class_starts_from_arrays(arrays) -> tuple[int, ...]:
    """Thread-class boundaries from concrete per-thread arrays: maximal
    runs of the thread range over which every array (last axis = threads;
    scalars skipped) is constant."""
    boundary = None
    for a in arrays:
        a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        if a.ndim == 0 or a.shape[-1] < 2:
            continue
        diff = a[..., 1:] != a[..., :-1]
        diff = diff.reshape(-1, diff.shape[-1]).any(axis=0)
        boundary = diff if boundary is None else (boundary | diff)
    if boundary is None:
        return (0,)
    return (0,) + tuple(int(i) + 1 for i in np.flatnonzero(boundary))


def thread_class_starts(workloads) -> tuple[int, ...]:
    """Common class refinement over one or more workloads (the union of
    each workload's class boundaries)."""
    if isinstance(workloads, Workload):
        workloads = [workloads]
    # wl[1:-1]: every per-thread field; static_socket never partitions
    arrays = [a for wl in workloads for a in wl[1:-1]]
    return class_starts_from_arrays(arrays)


def _group_multiplicities(
    class_starts: tuple[int, ...], n: int, n_per_node: torch.Tensor
) -> torch.Tensor:
    """``(..., C, s)`` thread count of class ``c`` on node ``k``: the
    overlap of the class interval with the node interval of the
    contiguous thread->node assignment.  Leading placement dimensions
    pass through."""
    dev = n_per_node.device
    bounds = torch.tensor(class_starts + (n,), dtype=torch.int32, device=dev)
    npn = n_per_node.to(torch.int32)
    node_hi = torch.cumsum(npn, dim=-1, dtype=torch.int32)
    node_lo = node_hi - npn
    lo = torch.maximum(bounds[:-1, None], node_lo[..., None, :])
    hi = torch.minimum(bounds[1:, None], node_hi[..., None, :])
    return torch.clamp(hi - lo, min=0)


def _group_mix_rows(
    static_frac, local_frac, per_thread_frac, static_socket, n_per_node,
    bank_assignment=None,
) -> torch.Tensor:
    """``(C, s, s)`` traffic mix over banks for a class-``c`` thread on
    node ``k``."""
    s = n_per_node.shape[0]
    dev = n_per_node.device
    nf = n_per_node.to(_F32)
    used = (nf > 0).to(_F32)
    s_used = torch.clamp(used.sum(), min=1.0)

    static_row = (torch.arange(s, device=dev) == static_socket).to(_F32)
    if bank_assignment is None:
        local_rows = torch.eye(s, dtype=_F32, device=dev)
    else:
        local_rows = F.one_hot(
            torch.tensor(bank_assignment, dtype=torch.int64, device=dev), s
        ).to(_F32)
    pt_row = nf / torch.clamp(nf.sum(), min=1.0)
    il_row = used / s_used

    inter = 1.0 - static_frac - local_frac - per_thread_frac
    return (
        static_frac[:, None, None] * static_row[None, None, :]
        + local_frac[:, None, None] * local_rows[None, :, :]
        + per_thread_frac[:, None, None] * pt_row[None, None, :]
        + inter[:, None, None] * il_row[None, None, :]
    )


def _group_resource_tensor(
    machine, read_unit, write_unit, caps=None, multipath=False
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-*group* resource-usage matrix ``U[g, r]`` (``g = c * s + k``)
    in :func:`machine_caps` order: each group occupies only its own
    node's row of the remote slabs (a static scatter), and per-link
    charges gather the node's rows of the full route incidence."""
    s = machine.n_nodes
    C = read_unit.shape[0]
    G = C * s
    dev = read_unit.device
    topo = machine.topology

    read_flat = read_unit.reshape(G, s)
    write_flat = write_unit.reshape(G, s)
    node_idx = np.tile(np.arange(s), C)  # group g lives on node g % s
    offdiag = _f32(np.arange(s)[None, :] != node_idx[:, None], dev)
    rr_vals = read_flat * offdiag
    ww_vals = write_flat * offdiag

    cols = torch.as_tensor(node_idx[:, None] * s + np.arange(s)[None, :], device=dev)
    rr_remote = torch.zeros((G, s * s), dtype=_F32, device=dev).scatter(1, cols, rr_vals)
    ww_remote = torch.zeros((G, s * s), dtype=_F32, device=dev).scatter(1, cols, ww_vals)

    if topo.n_links:
        inc = np.asarray(topo.route_incidence(multipath=multipath)).reshape(
            s, s, topo.n_links
        )
        inc_rows = _f32(inc[node_idx], dev)  # (G, s, L)
        link_usage = torch.einsum("gj,gjl->gl", rr_vals + ww_vals, inc_rows)
    else:
        link_usage = torch.zeros((G, 0), dtype=_F32, device=dev)

    usage = torch.cat([read_flat, write_flat, rr_remote, ww_remote, link_usage], dim=1)
    if caps is None:
        caps = machine_caps(machine, dev)
    return usage, caps


def _progressive_fill_grouped(
    unit_usage: torch.Tensor, mult: torch.Tensor, caps: torch.Tensor, iterations: int
) -> torch.Tensor:
    """Weighted max-min fairness over thread groups: ``unit_usage[g]`` is
    one member's resource row, ``mult[g]`` the member count.  Reproduces
    the per-thread rates exactly (the freeze rule reads only a row's
    support)."""
    g = unit_usage.shape[0]
    total_usage = unit_usage * mult[:, None]
    x = torch.zeros((g,), dtype=unit_usage.dtype, device=unit_usage.device)
    frozen = torch.zeros((g,), dtype=torch.bool, device=unit_usage.device)
    for _ in range(iterations):
        active = ~frozen
        frozen_usage = (total_usage * torch.where(frozen, x, 0.0)[:, None]).sum(0)
        act_usage = (total_usage * active[:, None].to(unit_usage.dtype)).sum(0)
        resid = torch.clamp(caps - frozen_usage, min=0.0)
        lam = _lam(resid, act_usage)
        lam_star = torch.clamp(lam.min(), max=1.0)
        bottleneck = lam <= lam_star * (1.0 + 1e-6)
        uses_bottleneck = (unit_usage * bottleneck[None, :]).sum(1) > _EPS
        freeze_now = active & (uses_bottleneck | (lam_star >= 1.0))
        x = torch.where(freeze_now, lam_star, x)
        frozen = frozen | freeze_now
    return torch.where(frozen, x, 1.0)


# ---------------------------------------------------------------------------
# Batched shared-slab evaluation: one resource build per support bucket
# ---------------------------------------------------------------------------
#
# A placement enters the grouped solver through the (C, s) multiplicity
# grid, the per-thread row pt_row = n / sum(n) and the interleave row
# il_row = used / s_used (support only).  The unit demand is linear in
# the mix rows:
#
#   unit(c, k, j) = base(c, k, j) + pt_coeff(c, k) * pt_row(j)
#                                 + il_coeff(c, k) * il_row(j)
#
# so the base+interleave slab (with its per-link charges) is built once
# per support bucket, and only the rank-1 pt_row update and the
# multiplicities are per-placement work.  Remote constraints stay in
# (C, s, s) form: each remote path (k, j) is used only by the C groups
# living on node k.


class GroupSlabs(NamedTuple):
    """Placement-independent slab components of one benchmark's unit
    demand (leading workload-batch dimensions pass through)."""

    base_read: torch.Tensor  # (..., C, s, s) static + local unit demand
    base_write: torch.Tensor
    pt_read: torch.Tensor  # (..., C, s) coefficient of the per-thread row
    pt_write: torch.Tensor
    il_read: torch.Tensor  # (..., C, s) coefficient of the interleave row
    il_write: torch.Tensor


class GroupedBatchResult(NamedTuple):
    """Per-placement ground truth from :func:`simulate_grouped_batch`
    (noise-free).  With a batch of ``B`` workloads every field gains a
    leading ``B`` axis."""

    read_flows: torch.Tensor  # (P, s, s)
    write_flows: torch.Tensor  # (P, s, s)
    instructions: torch.Tensor  # (P, s)
    throughput: torch.Tensor  # (P,) sum of thread rates
    group_rates: torch.Tensor  # (P, C, s) shared rate of class c on node k


def group_slab_components(
    machine: MachineSpec,
    workload: Workload,
    thread_classes: tuple[int, ...],
    bank_assignment: tuple[int, ...] | None = None,
) -> GroupSlabs:
    """The placement-independent unit-demand components of every
    (class, node) group.  Workload fields may carry a leading batch axis
    (``(B, n)``); the components then carry it too."""
    s = machine.n_nodes
    dev = workload.device
    rep = torch.as_tensor(np.asarray(thread_classes, np.int64), device=dev)
    node_rates = machine.node_rates(dev)
    if bank_assignment is None:
        local_mat = torch.eye(s, dtype=_F32, device=dev)
    else:
        local_mat = F.one_hot(
            torch.tensor(bank_assignment, dtype=torch.int64, device=dev), s
        ).to(_F32)
    static_row = (
        torch.arange(s, device=dev) == workload.static_socket[..., None]
    ).to(_F32)  # (..., s)

    def direction(static_frac, local_frac, pt_frac, bpi):
        sf = static_frac[..., rep]  # (..., C)
        lf = local_frac[..., rep]
        pf = pt_frac[..., rep]
        inter = 1.0 - sf - lf - pf
        unit = node_rates[:, None] * bpi[..., rep][..., :, None, None]  # (..., C, s, 1)
        base = unit * (
            sf[..., :, None, None] * static_row[..., None, None, :]
            + lf[..., :, None, None] * local_mat
        )
        coeff = unit[..., 0]  # (..., C, s)
        return base, coeff * pf[..., :, None], coeff * inter[..., :, None]

    base_r, pt_r, il_r = direction(
        workload.read_static, workload.read_local,
        workload.read_per_thread, workload.read_bpi,
    )
    base_w, pt_w, il_w = direction(
        workload.write_static, workload.write_local,
        workload.write_per_thread, workload.write_bpi,
    )
    return GroupSlabs(base_r, base_w, pt_r, pt_w, il_r, il_w)


def split_caps(
    machine: MachineSpec, caps: torch.Tensor | None = None, device=None
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Split a :func:`machine_caps`-order capacity vector into the
    structured fill's blocks: dense ``[bank reads, bank writes, links]``,
    remote-read ``(s, s)`` and remote-write ``(s, s)``."""
    s = machine.n_nodes
    if caps is None:
        dense = torch.cat(
            [
                machine.bank_read_caps(device),
                machine.bank_write_caps(device),
                machine.link_caps(device),
            ]
        )
        return dense, machine.remote_read_caps(device), machine.remote_write_caps(device)
    dense = torch.cat([caps[: 2 * s], caps[2 * s + 2 * s * s :]])
    rr = caps[2 * s : 2 * s + s * s].reshape(s, s)
    ww = caps[2 * s + s * s : 2 * s + 2 * s * s].reshape(s, s)
    return dense, rr, ww


def _balanced_grad(g: torch.Tensor, x: torch.Tensor, z: torch.Tensor, y: torch.Tensor):
    """``g`` times JAX's ``_balanced_eq(x, z, y)``: 1 where ``x`` alone
    attains ``z``, 0.5 where ``x`` and ``y`` both do, else 0 — as a
    product, so a NaN in ``g`` stays NaN even where the weight is 0."""
    gw = torch.where(y == z, g * 0.5, g)
    return torch.where(x == z, gw, g * 0.0).sum_to_size(x.shape)


class _JaxExtremum(torch.autograd.Function):
    """``torch.maximum``/``minimum`` with the derivative rule of
    ``jnp.maximum``/``minimum``: the cotangent is *multiplied* by the
    balanced indicator (ties split in half), where torch masks it.  The
    two differ at ties and where the cotangent is not finite: JAX carries
    ``nan * 0 = nan`` on, torch drops it."""

    @staticmethod
    def forward(ctx, a, b, take_max: bool):
        out = torch.maximum(a, b) if take_max else torch.minimum(a, b)
        ctx.save_for_backward(a, b, out)
        return out

    @staticmethod
    def backward(ctx, g):
        a, b, out = ctx.saved_tensors
        need_a, need_b, _ = ctx.needs_input_grad
        return (
            _balanced_grad(g, a, out, b) if need_a else None,
            _balanced_grad(g, b, out, a) if need_b else None,
            None,
        )


def jax_maximum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.maximum`` whose gradient follows ``jnp.maximum``'s rule."""
    return _JaxExtremum.apply(a, b, True)


def jax_minimum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.minimum`` whose gradient follows ``jnp.minimum``'s rule."""
    return _JaxExtremum.apply(a, b, False)


def _progressive_fill_structured(
    dense: torch.Tensor,  # (N, G, 2s + L) unit usage: bank reads/writes, links
    rem_read: torch.Tensor,  # (N, C, s, s) off-diagonal remote read unit usage
    rem_write: torch.Tensor,  # (N, C, s, s)
    mult: torch.Tensor,  # (N, G) group multiplicities (float)
    dense_caps: torch.Tensor,  # (2s + L,)
    rr_caps: torch.Tensor,  # (s, s), inf diagonal
    ww_caps: torch.Tensor,  # (s, s)
    iterations: int,
) -> torch.Tensor:
    """:func:`_progressive_fill_grouped` over the structured slab, for a
    batch of ``N`` independent problems (placements x workloads): the
    dense block contracts as a batched matmul, each remote path only
    over the C groups on its source node.  Same freeze rule, bottleneck
    tolerance and fixed point as the reference."""
    N, C, s, _ = rem_read.shape
    g = dense.shape[1]
    dtype = dense.dtype
    x = torch.zeros((N, g), dtype=dtype, device=dense.device)
    frozen = torch.zeros((N, g), dtype=torch.bool, device=dense.device)
    # maximum/minimum against scalar tensors rather than clamp: the same
    # values; under autograd (the search's relaxed ascent) with the
    # reference's derivative rule, so gradients match jax.grad's
    zero = torch.zeros((), dtype=dtype, device=dense.device)
    one = torch.ones((), dtype=dtype, device=dense.device)
    eps = torch.full((), _EPS, dtype=dtype, device=dense.device)
    # the search differentiates the multiplicities, the calibration the caps
    if torch.is_grad_enabled() and any(
        t.requires_grad for t in (dense, mult, dense_caps, rr_caps, ww_caps)
    ):
        maximum, minimum = jax_maximum, jax_minimum
    else:
        maximum, minimum = torch.maximum, torch.minimum

    def lam_of(resid, act):
        return torch.where(act > _EPS, resid / maximum(act, eps), torch.inf)

    for _ in range(iterations):
        active = ~frozen
        wt_frozen = torch.where(frozen, x, 0.0) * mult
        wt_active = torch.where(active, mult, 0.0)
        fz_dense = torch.bmm(wt_frozen[:, None, :], dense)[:, 0]
        act_dense = torch.bmm(wt_active[:, None, :], dense)[:, 0]
        wf = wt_frozen.reshape(N, C, s, 1)
        wa = wt_active.reshape(N, C, s, 1)
        fz_rr = (wf * rem_read).sum(1)
        act_rr = (wa * rem_read).sum(1)
        fz_ww = (wf * rem_write).sum(1)
        act_ww = (wa * rem_write).sum(1)

        lam_d = lam_of(maximum(dense_caps - fz_dense, zero), act_dense)
        lam_rr = lam_of(maximum(rr_caps - fz_rr, zero), act_rr)
        lam_ww = lam_of(maximum(ww_caps - fz_ww, zero), act_ww)
        lam_star = minimum(
            minimum(lam_d.amin(1), lam_rr.amin((1, 2))),
            minimum(lam_ww.amin((1, 2)), one),
        )  # (N,)
        tol = (lam_star * (1.0 + 1e-6))[:, None]
        bn_d = (lam_d <= tol).to(dtype)
        bn_rr = (lam_rr <= tol[:, :, None]).to(dtype)
        bn_ww = (lam_ww <= tol[:, :, None]).to(dtype)
        uses = (
            (dense * bn_d[:, None, :]).sum(2)
            + (rem_read * bn_rr[:, None]).sum(3).reshape(N, g)
            + (rem_write * bn_ww[:, None]).sum(3).reshape(N, g)
        ) > _EPS
        freeze_now = active & (uses | (lam_star >= 1.0)[:, None])
        x = torch.where(freeze_now, lam_star[:, None], x)
        frozen = frozen | freeze_now
    return torch.where(frozen, x, 1.0)


def bucket_size(n: int, *, base: int = 8) -> int:
    """The padded batch size for ``n`` rows: the smallest power-of-two
    bucket >= ``base`` that holds them."""
    if n < 0:
        raise ValueError(f"cannot bucket {n} rows")
    padded = base
    while padded < n:
        padded *= 2
    return padded


def pad_rows(rows: np.ndarray, *, base: int = 8) -> np.ndarray:
    """Pad a row batch to its :func:`bucket_size` by repeating row 0 —
    fixed shapes for variable batch sizes; callers slice the first
    ``len(rows)`` outputs back out."""
    rows = np.asarray(rows)
    padded = bucket_size(rows.shape[0], base=base)
    if padded == rows.shape[0]:
        return rows
    return np.concatenate(
        [rows, np.repeat(rows[:1], padded - rows.shape[0], axis=0)]
    )


def support_patterns(placements) -> tuple[np.ndarray, np.ndarray]:
    """Host-side bucketing of placements by support pattern (which nodes
    hold any thread): the ``(n_buckets, s)`` 0/1 support matrix in
    lexicographic order and the ``(P,)`` bucket id of every placement."""
    if isinstance(placements, torch.Tensor):
        placements = placements.detach().cpu().numpy()
    p = np.asarray(placements)
    sup = (p > 0).astype(np.int32)
    uniq, slab_id = np.unique(sup, axis=0, return_inverse=True)
    return uniq, slab_id.astype(np.int32).reshape(-1)


def simulate_grouped_batch(
    machine: MachineSpec,
    workload: Workload,
    placements,  # (P, s) integer thread counts per node
    *,
    thread_classes: tuple[int, ...],
    support=None,  # (n_buckets, s) support patterns
    slab_id=None,  # (P,) bucket of each placement
    caps: torch.Tensor | None = None,
    multipath: bool = False,
    elapsed: float = 1.0,
    bank_assignment: tuple[int, ...] | None = None,
) -> GroupedBatchResult:
    """Ground truth for a whole placement batch in one pass: bucket the
    placements by support pattern, build the base+interleave slab once
    per bucket, and run the structured fill over every placement at once.

    Workload fields of shape ``(B, n)`` evaluate ``B`` workloads (sharing
    ``thread_classes``) against the same placements in the same pass; the
    result then carries a leading ``B`` axis.  ``support``/``slab_id``
    (from :func:`support_patterns`) may be passed in when the caller
    already bucketed on the host."""
    bank_assignment = canonical_bank_assignment(machine, bank_assignment)
    dev = workload.device
    batched = workload.read_static.dim() == 2
    s = machine.n_nodes
    n = workload.n_threads if not batched else workload.read_static.shape[1]
    topo = machine.topology
    placements = torch.as_tensor(placements, device=dev)
    if support is None or slab_id is None:
        support, slab_id = support_patterns(placements)
    support = torch.as_tensor(support, device=dev)
    slab_id = torch.as_tensor(slab_id, device=dev).to(torch.int64)

    comps = group_slab_components(machine, workload, thread_classes, bank_assignment)
    if not batched:
        comps = GroupSlabs(*(c[None] for c in comps))
    B, C = comps.base_read.shape[:2]
    G = C * s
    P = placements.shape[0]
    dense_caps, rr_caps, ww_caps = split_caps(machine, caps, dev)
    offdiag = 1.0 - torch.eye(s, dtype=_F32, device=dev)  # (s, s)
    node_rates = machine.node_rates(dev)
    n_links = topo.n_links
    iterations = min(G, 2 * s + 2 * s * s + n_links) + 1

    # per-bucket slabs: (B, NB, C, s, s) and link charges (B, NB, C, s, L)
    used = support.to(_F32)
    il_row = used / torch.clamp(used.sum(-1, keepdim=True), min=1.0)  # (NB, s)
    il = il_row[None, :, None, None, :]
    b_ru = comps.base_read[:, None] + comps.il_read[:, None, :, :, None] * il
    b_wu = comps.base_write[:, None] + comps.il_write[:, None, :, :, None] * il
    if n_links:
        inc = _f32(topo.route_incidence(multipath=multipath), dev).reshape(s, s, n_links)
        b_lu = torch.einsum("bnckj,kjl->bnckl", (b_ru + b_wu) * offdiag, inc)

    nf = placements.to(_F32)
    pt_row = nf / torch.clamp(nf.sum(-1, keepdim=True), min=1.0)  # (P, s)
    pt = pt_row[None, :, None, None, :]
    ru = b_ru[:, slab_id] + comps.pt_read[:, None, :, :, None] * pt  # (B, P, C, s, s)
    wu = b_wu[:, slab_id] + comps.pt_write[:, None, :, :, None] * pt
    parts = [ru.reshape(B, P, G, s), wu.reshape(B, P, G, s)]
    if n_links:
        # per-link charge of one unit of pt_row flow from node k (the
        # diagonal rows of inc are all-zero, so no off-diagonal mask)
        pt_link = torch.einsum("pj,kjl->pkl", pt_row, inc)  # (P, s, L)
        lu = b_lu[:, slab_id] + (
            (comps.pt_read + comps.pt_write)[:, None, :, :, None]
            * pt_link[None, :, None, :, :]
        )
        parts.append(lu.reshape(B, P, G, n_links))
    dense = torch.cat(parts, dim=-1)
    rem_read = ru * offdiag
    rem_write = wu * offdiag
    mult = _group_multiplicities(tuple(int(v) for v in thread_classes), n, placements)
    mult = mult.to(_F32)  # (P, C, s)

    x = _progressive_fill_structured(
        dense.reshape(B * P, G, -1),
        rem_read.reshape(B * P, C, s, s),
        rem_write.reshape(B * P, C, s, s),
        mult.reshape(1, P, G).expand(B, P, G).reshape(B * P, G),
        dense_caps, rr_caps, ww_caps, iterations,
    )
    xg = x.reshape(B, P, C, s)
    weight = mult[None] * xg
    result = GroupedBatchResult(
        read_flows=(weight[..., None] * ru).sum(2) * elapsed,
        write_flows=(weight[..., None] * wu).sum(2) * elapsed,
        instructions=(weight * node_rates).sum(2) * elapsed,
        throughput=weight.sum((2, 3)),
        group_rates=xg,
    )
    if not batched:
        result = GroupedBatchResult(*(f[0] for f in result))
    return result


class PairedSlab(NamedTuple):
    """The structured slab of ``P`` paired (workload, placement) problems,
    row ``p`` workload row ``p`` at placement row ``p``.  Nothing in it
    depends on the capacities, so a fit builds it once and refills it
    at every step."""

    dense: torch.Tensor  # (P, G, 2s + L) bank reads, bank writes, links
    rem_read: torch.Tensor  # (P, C, s, s) off-diagonal remote read usage
    rem_write: torch.Tensor  # (P, C, s, s)
    mult: torch.Tensor  # (P, G) group multiplicities (float)
    read_unit: torch.Tensor  # (P, C, s, s) one member's demand per bank
    write_unit: torch.Tensor  # (P, C, s, s)
    node_rates: torch.Tensor  # (s,)
    iterations: int


def paired_slab(
    machine: MachineSpec,
    workloads: Workload,  # fields (P, n); static_socket (P,)
    placements,  # (P, s) integer thread counts per node
    *,
    thread_classes: tuple[int, ...],
    multipath: bool = False,
    bank_assignment: tuple[int, ...] | None = None,
) -> PairedSlab:
    """Build the paired problems' slab: row ``p`` takes the interleave row
    of its placement's support bucket and the rank-1 per-thread update of
    its placement, as :func:`simulate_grouped_batch` builds each
    (workload, placement) cell of its cross product."""
    bank_assignment = canonical_bank_assignment(machine, bank_assignment)
    dev = workloads.device
    s = machine.n_nodes
    n = workloads.read_static.shape[-1]
    topo = machine.topology
    placements = torch.as_tensor(placements, device=dev)
    support, slab_id = support_patterns(placements)
    support = torch.as_tensor(support, device=dev)
    slab_id = torch.as_tensor(slab_id, device=dev).to(torch.int64)

    comps = group_slab_components(machine, workloads, thread_classes, bank_assignment)
    P, C = comps.base_read.shape[:2]
    G = C * s
    offdiag = 1.0 - torch.eye(s, dtype=_F32, device=dev)
    n_links = topo.n_links

    used = support.to(_F32)
    il_row = (used / torch.clamp(used.sum(-1, keepdim=True), min=1.0))[slab_id]  # (P, s)
    il = il_row[:, None, None, :]
    b_ru = comps.base_read + comps.il_read[..., None] * il  # (P, C, s, s)
    b_wu = comps.base_write + comps.il_write[..., None] * il
    nf = placements.to(_F32)
    pt_row = nf / torch.clamp(nf.sum(-1, keepdim=True), min=1.0)  # (P, s)
    pt = pt_row[:, None, None, :]
    ru = b_ru + comps.pt_read[..., None] * pt
    wu = b_wu + comps.pt_write[..., None] * pt
    parts = [ru.reshape(P, G, s), wu.reshape(P, G, s)]
    if n_links:
        inc = _f32(topo.route_incidence(multipath=multipath), dev).reshape(s, s, n_links)
        b_lu = torch.einsum("pckj,kjl->pckl", (b_ru + b_wu) * offdiag, inc)
        pt_link = torch.einsum("pj,kjl->pkl", pt_row, inc)  # (P, s, L)
        lu = b_lu + (comps.pt_read + comps.pt_write)[..., None] * pt_link[:, None]
        parts.append(lu.reshape(P, G, n_links))
    mult = _group_multiplicities(tuple(int(v) for v in thread_classes), n, placements)
    return PairedSlab(
        dense=torch.cat(parts, dim=-1),
        rem_read=ru * offdiag,
        rem_write=wu * offdiag,
        mult=mult.to(_F32).reshape(P, G),
        read_unit=ru,
        write_unit=wu,
        node_rates=machine.node_rates(dev),
        iterations=min(G, 2 * s + 2 * s * s + n_links) + 1,
    )


def fill_paired(
    machine: MachineSpec,
    slab: PairedSlab,
    caps: torch.Tensor | None = None,
    *,
    elapsed: float = 1.0,
) -> GroupedBatchResult:
    """Run the structured fill over a :class:`PairedSlab` and reduce it to
    flows: one :class:`GroupedBatchResult` row per pair.  ``caps``
    (:func:`machine_caps` order) may require grad; the fill then follows
    the reference's derivative rule."""
    P, C, s, _ = slab.read_unit.shape
    dev = slab.dense.device
    dense_caps, rr_caps, ww_caps = split_caps(machine, caps, dev)
    x = _progressive_fill_structured(
        slab.dense, slab.rem_read, slab.rem_write, slab.mult,
        dense_caps, rr_caps, ww_caps, slab.iterations,
    )
    xg = x.reshape(P, C, s)
    weight = slab.mult.reshape(P, C, s) * xg
    return GroupedBatchResult(
        read_flows=(weight[..., None] * slab.read_unit).sum(1) * elapsed,
        write_flows=(weight[..., None] * slab.write_unit).sum(1) * elapsed,
        instructions=(weight * slab.node_rates).sum(1) * elapsed,
        throughput=weight.sum((1, 2)),
        group_rates=xg,
    )


def simulate_paired_batch(
    machine: MachineSpec,
    workloads: Workload,
    placements,
    *,
    thread_classes: tuple[int, ...],
    caps: torch.Tensor | None = None,
    multipath: bool = False,
    elapsed: float = 1.0,
    bank_assignment: tuple[int, ...] | None = None,
) -> GroupedBatchResult:
    """Ground truth of ``P`` paired problems in one pass: workload row
    ``p`` (fields of shape ``(P, n)``, sharing ``thread_classes``) at
    placement row ``p`` — the reference's ``vmap(simulate)`` over a probe
    sweep, where :func:`simulate_grouped_batch` would evaluate the whole
    ``P x P`` cross product."""
    slab = paired_slab(
        machine, workloads, placements, thread_classes=thread_classes,
        multipath=multipath, bank_assignment=bank_assignment,
    )
    return fill_paired(machine, slab, caps, elapsed=elapsed)


def simulate(
    machine: MachineSpec,
    workload: Workload,
    n_per_node,
    *,
    elapsed: float = 1.0,
    noise_std: float = 0.0,
    background_bw: float = 0.0,
    noise: CounterNoise | None = None,
    generator: torch.Generator | None = None,
    caps: torch.Tensor | None = None,
    thread_classes: tuple[int, ...] | None = None,
    multipath: bool = False,
    bank_assignment: tuple[int, ...] | None = None,
) -> SimulationResult:
    """Run the workload on the machine under the given placement (threads
    per NUMA node) on the group-collapsed solver and emit ground truth +
    the paper-visible counters.  ``thread_classes`` defaults to the
    workload's own class partition (:func:`thread_class_starts`);
    ``bank_assignment`` places the Local class's pages; ``caps``
    substitutes the machine's capacity vector."""
    bank_assignment = canonical_bank_assignment(machine, bank_assignment)
    if thread_classes is None:
        thread_classes = thread_class_starts(workload)
    dev = workload.device
    s = machine.n_nodes
    n = workload.n_threads
    n_per_node = _placement_tensor(n_per_node, dev)
    starts = np.asarray(thread_classes, np.int64)
    if starts.size == 0 or starts[0] != 0 or (np.diff(starts) <= 0).any() or (
        starts[-1] >= n
    ):
        raise ValueError(f"invalid thread_classes {thread_classes} for {n} threads")
    C = starts.size
    rep = torch.as_tensor(starts, device=dev)

    node_rates = machine.node_rates(dev)
    read_mix = _group_mix_rows(
        workload.read_static[rep], workload.read_local[rep],
        workload.read_per_thread[rep], workload.static_socket, n_per_node,
        bank_assignment,
    )
    write_mix = _group_mix_rows(
        workload.write_static[rep], workload.write_local[rep],
        workload.write_per_thread[rep], workload.static_socket, n_per_node,
        bank_assignment,
    )
    read_unit = node_rates[None, :, None] * workload.read_bpi[rep][:, None, None] * read_mix
    write_unit = node_rates[None, :, None] * workload.write_bpi[rep][:, None, None] * write_mix

    usage, caps = _group_resource_tensor(
        machine, read_unit, write_unit, caps, multipath=multipath
    )
    mult_f = _group_multiplicities(
        tuple(int(v) for v in starts), n, n_per_node
    ).to(usage.dtype)
    iterations = min(usage.shape[0], usage.shape[1]) + 1
    x = _progressive_fill_grouped(usage, mult_f.reshape(C * s), caps, iterations)
    xg = x.reshape(C, s)

    weight = mult_f * xg
    read_flows = torch.einsum("ck,ckj->kj", weight, read_unit) * elapsed
    write_flows = torch.einsum("ck,ckj->kj", weight, write_unit) * elapsed
    instructions = (weight * node_rates[None, :]).sum(0) * elapsed

    node_of = _thread_nodes(n_per_node, n)
    class_of = torch.as_tensor(
        np.searchsorted(starts, np.arange(n), side="right") - 1, device=dev
    )
    rates = xg[class_of, node_of]

    return _finalize_result(
        rates, read_flows, write_flows, instructions, n_per_node,
        elapsed, noise_std, background_bw, noise, generator, s,
    )


def simulate_counters(
    machine: MachineSpec, workload: Workload, n_per_node, **kwargs
) -> CounterSample:
    """Just the performance counters of a simulated run."""
    return simulate(machine, workload, n_per_node, **kwargs).sample


def _symmetric_counts(machine: MachineSpec, n_threads: int) -> list[int]:
    if n_threads % machine.n_nodes:
        raise ValueError(
            f"symmetric run needs {n_threads} threads to split over "
            f"{machine.n_nodes} nodes"
        )
    per = n_threads // machine.n_nodes
    if per > machine.cores_per_node:
        raise ValueError(f"{per} threads per node exceed {machine.cores_per_node} cores")
    return [per] * machine.n_nodes


def _asymmetric_counts(machine: MachineSpec, n_threads: int) -> list[int]:
    """The reference's 3:1-target unequal split (nearest feasible
    unequal split; the equal split only when nothing else fits)."""
    s = machine.n_nodes
    cap = machine.cores_per_node
    if not 0 < n_threads <= s * cap:
        raise ValueError(f"{n_threads} threads do not fit {s} nodes x {cap} cores")
    target = -(-3 * n_threads // 4)

    def split_for(first: int) -> list[int] | None:
        rest = n_threads - first
        if rest < 0 or rest > (s - 1) * cap:
            return None
        others = [rest // (s - 1)] * (s - 1)
        others[0] += rest - sum(others)
        # spill overflow beyond per-socket capacity rightward
        for k in range(s - 2):
            if others[k] > cap:
                others[k + 1] += others[k] - cap
                others[k] = cap
        counts = [first] + others
        return counts if max(counts) <= cap else None

    candidates = sorted(
        range(min(cap, n_threads) + 1), key=lambda f: (abs(f - target), -f)
    )
    fallback = None
    for first in candidates:
        counts = split_for(first)
        if counts is None:
            continue
        if len(set(counts)) > 1:
            return counts
        if fallback is None:
            fallback = counts
    if fallback is None:  # unreachable: n_threads <= s * cap guarantees a split
        raise ValueError(f"no placement of {n_threads} threads")
    return fallback


def symmetric_placement(
    machine: MachineSpec, n_threads: int, device=DEFAULT_DEVICE
) -> torch.Tensor:
    """Paper §5.1 run 1: equal threads per NUMA node, 1 thread/core."""
    return torch.tensor(
        _symmetric_counts(machine, n_threads), dtype=torch.int32,
        device=resolve_device(device),
    )


def asymmetric_placement(
    machine: MachineSpec, n_threads: int, device=DEFAULT_DEVICE
) -> torch.Tensor:
    """Paper §5.1 run 2: same thread count, unequal (3:1 target) split."""
    return torch.tensor(
        _asymmetric_counts(machine, n_threads), dtype=torch.int32,
        device=resolve_device(device),
    )


def profile_pair(
    machine: MachineSpec,
    workload: Workload,
    *,
    noise_std: float = 0.0,
    background_bw: float = 0.0,
    noise: tuple[CounterNoise, CounterNoise] | None = None,
    generator: torch.Generator | None = None,
    thread_classes: tuple[int, ...] | None = None,
) -> tuple[CounterSample, CounterSample]:
    """The paper's 2-run profiling protocol (§5.1): one symmetric and one
    asymmetric placement of the same thread count.  ``noise`` holds the
    two runs' draws; without it a noisy call draws them from
    ``generator`` (seed 0 when none is given)."""
    dev = workload.device
    s = machine.n_nodes
    if noise is None and (noise_std > 0.0 or background_bw > 0.0):
        if generator is None:
            generator = default_generator(dev)
        noise = (
            draw_counter_noise((), s, generator, dev),
            draw_counter_noise((), s, generator, dev),
        )
    n_sym, n_asym = noise if noise is not None else (None, None)
    kw = dict(
        noise_std=noise_std, background_bw=background_bw,
        thread_classes=thread_classes,
    )
    sym = simulate_counters(
        machine, workload, symmetric_placement(machine, workload.n_threads, dev),
        noise=n_sym, **kw,
    )
    asym = simulate_counters(
        machine, workload, asymmetric_placement(machine, workload.n_threads, dev),
        noise=n_asym, **kw,
    )
    return sym, asym
