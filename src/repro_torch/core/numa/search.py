"""Placement *search*: the best thread placement without a sweep (port of
``repro.core.numa.search``).

Past about 8 NUMA nodes the composition space is too large to sweep (a
16-node SNC machine has about 1.07e10 compositions).  Two searches drive
the same grouped max-min fill as the sweep:

* :func:`optimize_placement` — multi-start relaxed gradient ascent:
  fractional node counts ``n * softmax(logits)`` through a continuous
  relaxation of the structured fill (the fixed-count loop of
  :func:`~repro_torch.core.numa.simulator._progressive_fill_structured`,
  differentiated by ``torch.autograd``), AdamW
  (:mod:`repro_torch.optim.adamw`) over all starts at once, then
  cap-aware largest-remainder rounding and a polish by exact
  single-thread moves.
* :func:`branch_and_bound` — best-first search over compositions with an
  admissible per-group roofline (:func:`placement_upper_bound`), so the
  answer is within ``gap`` of the optimum when the tree is exhausted.
  The heap and the bound tables live on the host; each batch of 64
  leaves is one :func:`exact_objectives` call on the workload's device.

The bound tables are float64 numpy, built from the placement-independent
slab components as in the reference (see its module docstring for why
the bound is admissible).  The objective is the total instruction rate.

Where the reference ``vmap``s ``grad`` over the starts, the starts here
are independent rows of one batched fill, and one backward pass of their
summed loss gives every start its own gradient.  As in the reference,
non-finite gradients are zeroed per start.
"""

from __future__ import annotations

import heapq
from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core.numa.machine import MachineSpec, canonical_bank_assignment
from repro_torch.core.numa.simulator import (
    _progressive_fill_structured,
    group_slab_components,
    jax_maximum,
    jax_minimum,
    pad_rows,
    simulate_grouped_batch,
    split_caps,
    thread_class_starts,
)
from repro_torch.core.numa.workload import Workload
from repro_torch.optim import adamw

_F32 = torch.float32


class SearchResult(NamedTuple):
    """One found placement plus the effort receipts."""

    placement: tuple[int, ...]  # threads per NUMA node
    objective: float  # instructions/s of `placement` (exact simulation)
    evaluations: int  # placements evaluated exactly
    nodes_expanded: int  # B&B tree nodes popped (0 for the optimizer)
    optimal: bool  # True iff B&B exhausted the tree within `gap`


def _classes_for(workload: Workload, thread_classes) -> tuple[int, ...]:
    return (
        thread_class_starts([workload])
        if thread_classes is None
        else tuple(int(v) for v in thread_classes)
    )


def _host_workload(workload: Workload) -> Workload:
    """The workload's fields on the CPU: the host-side bound tables are
    built from CPU arithmetic whatever device the search runs on."""
    return Workload(workload.name, *(f.cpu() for f in workload[1:]))


# ---------------------------------------------------------------------------
# Exact batched evaluation (shared by both modes and by tests)
# ---------------------------------------------------------------------------


def exact_objectives(
    machine: MachineSpec,
    workload: Workload,
    placements,
    *,
    thread_classes: tuple[int, ...] | None = None,
    bank_assignment=None,
) -> np.ndarray:
    """Simulated work rate (instructions/s) of each placement, on the
    workload's device: one support bucket per placement, rows padded to a
    power-of-two batch by repetition.  ``bank_assignment`` prices one
    page placement for the whole batch (``None`` = node-local)."""
    classes = _classes_for(workload, thread_classes)
    p = np.asarray(placements, np.int32)
    if p.ndim == 1:
        p = p[None, :]
    n_rows = p.shape[0]
    padded = pad_rows(p)
    dev = workload.device
    sim = simulate_grouped_batch(
        machine,
        workload,
        torch.as_tensor(padded, device=dev),
        thread_classes=classes,
        support=torch.as_tensor((padded > 0).astype(np.int32), device=dev),
        slab_id=torch.arange(padded.shape[0], device=dev),
        bank_assignment=canonical_bank_assignment(machine, bank_assignment),
    )
    return sim.instructions.sum(-1).cpu().numpy()[:n_rows]


# ---------------------------------------------------------------------------
# Relaxed continuous objective (differentiable)
# ---------------------------------------------------------------------------


def _continuous_multiplicities(
    class_starts: tuple[int, ...], n: int, p: torch.Tensor
) -> torch.Tensor:
    """``(..., C, s)`` group multiplicities of *fractional* node counts
    ``p`` (``(..., s)``): the interval overlap is piecewise linear in
    ``p``, so gradients flow."""
    bounds = torch.tensor(class_starts + (n,), dtype=p.dtype, device=p.device)
    node_hi = torch.cumsum(p, dim=-1)
    node_lo = node_hi - p
    lo = jax_maximum(bounds[:-1, None], node_lo[..., None, :])
    hi = jax_minimum(bounds[1:, None], node_hi[..., None, :])
    return jax_maximum(hi - lo, torch.zeros((), dtype=p.dtype, device=p.device))


class _Relaxed(NamedTuple):
    """The placement-independent parts of the relaxed objective."""

    comps: tuple  # GroupSlabs, (C, s, s) / (C, s)
    classes: tuple[int, ...]
    n: int
    s: int
    dense_caps: torch.Tensor
    rr_caps: torch.Tensor
    ww_caps: torch.Tensor
    offdiag: torch.Tensor
    inc: torch.Tensor | None  # (s, s, L) route incidence
    node_rates: torch.Tensor
    iterations: int


def _relaxed_setup(machine, workload, classes) -> _Relaxed:
    dev = workload.device
    s = machine.n_nodes
    topo = machine.topology
    comps = group_slab_components(machine, workload, classes)
    G = comps.base_read.shape[0] * s
    dense_caps, rr_caps, ww_caps = split_caps(machine, device=dev)
    n_links = topo.n_links
    inc = None
    if n_links:
        inc = torch.as_tensor(
            np.array(topo.route_incidence(), np.float32).reshape(s, s, n_links),
            device=dev,
        )
    return _Relaxed(
        comps=comps,
        classes=classes,
        n=workload.n_threads,
        s=s,
        dense_caps=dense_caps,
        rr_caps=rr_caps,
        ww_caps=ww_caps,
        offdiag=1.0 - torch.eye(s, dtype=_F32, device=dev),
        inc=inc,
        node_rates=machine.node_rates(dev),
        iterations=min(G, 2 * s + 2 * s * s + n_links) + 1,
    )


def _relaxed_rate(r: _Relaxed, p: torch.Tensor, tau: float) -> torch.Tensor:
    """``(N,)`` relaxed work rate of ``N`` fractional placements ``(N, s)``."""
    comps, s = r.comps, r.s
    C = comps.base_read.shape[0]
    G = C * s
    N = p.shape[0]
    one = torch.ones((), dtype=_F32, device=p.device)
    pt_row = p / jax_maximum(p.sum(-1, keepdim=True), one)
    used = p / (p + tau)
    il_row = used / jax_maximum(used.sum(-1, keepdim=True), one)
    pt = pt_row[:, None, None, :]
    il = il_row[:, None, None, :]
    ru = (comps.base_read + comps.pt_read[:, :, None] * pt + comps.il_read[:, :, None] * il)
    wu = (comps.base_write + comps.pt_write[:, :, None] * pt + comps.il_write[:, :, None] * il)
    parts = [ru.reshape(N, G, s), wu.reshape(N, G, s)]
    if r.inc is not None:
        lu = torch.einsum("nckj,kjl->nckl", (ru + wu) * r.offdiag, r.inc)
        parts.append(lu.reshape(N, G, -1))
    mult = _continuous_multiplicities(r.classes, r.n, p)  # (N, C, s)
    x = _progressive_fill_structured(
        torch.cat(parts, dim=-1),
        ru * r.offdiag,
        wu * r.offdiag,
        mult.reshape(N, G),
        r.dense_caps,
        r.rr_caps,
        r.ww_caps,
        r.iterations,
    )
    return (mult * x.reshape(N, C, s) * r.node_rates).sum((1, 2))


def relaxed_work_rate(
    machine: MachineSpec,
    workload: Workload,
    p: torch.Tensor,
    *,
    thread_classes: tuple[int, ...] | None = None,
    tau: float = 0.25,
) -> torch.Tensor:
    """Differentiable work rate of a *fractional* placement ``p`` (positive
    reals summing to ``n_threads``), on the workload's device; ``p`` of
    shape ``(N, s)`` gives ``N`` rates.  The support indicator becomes
    ``p / (p + tau)`` so emptying a node is a smooth event."""
    classes = _classes_for(workload, thread_classes)
    p = torch.as_tensor(p, device=workload.device).to(_F32)
    single = p.dim() == 1
    out = _relaxed_rate(_relaxed_setup(machine, workload, classes), p.reshape(-1, p.shape[-1]), tau)
    return out[0] if single else out


# ---------------------------------------------------------------------------
# Mode (a): multi-start gradient ascent + round-and-polish
# ---------------------------------------------------------------------------


def _ascend_starts(
    machine: MachineSpec,
    workload: Workload,
    logits0: np.ndarray,
    classes: tuple[int, ...],
    steps: int,
    lr: float,
    tau: float,
) -> torch.Tensor:
    """AdamW ascent of every start's relaxed work rate at once; returns
    the final fractional placements ``(n_starts, s)``.  Grad mode is
    enabled here only (it is thread-local: the service runs this on its
    search pool beside the batcher)."""
    dev = workload.device
    n = workload.n_threads
    cap = float(machine.cores_per_node)
    relaxed = _relaxed_setup(machine, workload, classes)
    scale = n * relaxed.node_rates.max()
    zero = torch.zeros((), dtype=_F32, device=dev)
    params = {"logits": torch.tensor(logits0, device=dev)}  # updated in place
    state = adamw.init(params)
    with torch.enable_grad():
        for _ in range(steps):
            logits = params["logits"].detach().requires_grad_(True)
            p = n * torch.softmax(logits, dim=-1)
            obj = _relaxed_rate(relaxed, p, tau)
            over = jax_maximum(p - cap, zero)
            loss = -(obj / scale) + 10.0 * (over * over).sum(-1)
            (grad,) = torch.autograd.grad(loss.sum(), logits)
            # the relaxed fill is only piecewise smooth: a start whose
            # cotangents are not finite gets them zeroed, not the batch
            grad = torch.nan_to_num(grad, nan=0.0, posinf=0.0, neginf=0.0)
            state = adamw.update_({"logits": grad}, state, params, lr=lr, weight_decay=0.0)
    return n * torch.softmax(params["logits"], dim=-1)


def _round_capped(p_cont: np.ndarray, n: int, cap: int) -> np.ndarray:
    """Largest-remainder rounding of a fractional placement onto the
    integer composition simplex with per-node caps."""
    q = np.clip(p_cont, 0.0, cap)
    base = np.floor(q).astype(np.int64)
    frac = q - base
    rem = n - int(base.sum())
    order = list(np.argsort(-frac))
    while rem > 0:
        for k in order:
            if rem == 0:
                break
            if base[k] < cap:
                base[k] += 1
                rem -= 1
    while rem < 0:
        for k in reversed(order):
            if rem == 0:
                break
            if base[k] > 0:
                base[k] -= 1
                rem += 1
    return base.astype(np.int32)


def _neighbours(p: np.ndarray, cap: int) -> list[np.ndarray]:
    """All single-thread moves (src with a thread, dst with headroom)."""
    s = p.shape[0]
    out = []
    for src in range(s):
        if p[src] == 0:
            continue
        for dst in range(s):
            if dst == src or p[dst] >= cap:
                continue
            q = p.copy()
            q[src] -= 1
            q[dst] += 1
            out.append(q)
    return out


def optimize_placement(
    machine: MachineSpec,
    workload: Workload,
    *,
    thread_classes: tuple[int, ...] | None = None,
    n_starts: int = 16,
    steps: int = 150,
    lr: float = 0.25,
    tau: float = 0.25,
    seed: int = 0,
    polish: bool = True,
    max_polish_passes: int | None = None,
) -> SearchResult:
    """Multi-start relaxed gradient ascent on predicted work rate, then
    round-and-polish, on the workload's device.  The starts are the
    reference's (uniform, one-hot-ish packers, then
    ``np.random.default_rng(seed)`` normals).  Cost is independent of the
    composition count."""
    classes = _classes_for(workload, thread_classes)
    s = machine.n_nodes
    n = workload.n_threads
    cap = machine.cores_per_node
    if not 0 < n <= s * cap:
        raise ValueError(f"{n} threads do not fit {s} nodes x {cap} cores")

    rng = np.random.default_rng(seed)
    logits0 = np.zeros((n_starts, s), np.float32)
    # start 0: uniform spread; a few one-hot-ish packers; the rest random
    for i in range(1, min(n_starts, s + 1)):
        logits0[i, (i - 1) % s] = 3.0
    if n_starts > s + 1:
        logits0[s + 1 :] = rng.normal(0.0, 1.5, (n_starts - s - 1, s))
    p_frac = _ascend_starts(
        machine, workload, logits0, classes, int(steps), float(lr), float(tau)
    ).cpu().numpy()

    seen: dict[tuple[int, ...], None] = {}
    uniform = np.full(s, n / s)
    for row in p_frac:
        if not np.all(np.isfinite(row)):  # a diverged start; fall back
            row = uniform
        seen.setdefault(tuple(int(v) for v in _round_capped(row, n, cap)), None)
    candidates = [np.asarray(c, np.int32) for c in seen]
    values = exact_objectives(
        machine, workload, np.stack(candidates), thread_classes=classes
    )
    evals = len(candidates)
    best_i = int(np.argmax(values))
    best, best_val = candidates[best_i], float(values[best_i])

    if polish:
        passes = 4 * s if max_polish_passes is None else max_polish_passes
        for _ in range(passes):
            moves = _neighbours(best, cap)
            if not moves:
                break
            vals = exact_objectives(
                machine, workload, np.stack(moves), thread_classes=classes
            )
            evals += len(moves)
            i = int(np.argmax(vals))
            if float(vals[i]) <= best_val * (1.0 + 1e-7):
                break
            best, best_val = moves[i], float(vals[i])

    return SearchResult(
        placement=tuple(int(v) for v in best),
        objective=best_val,
        evaluations=evals,
        nodes_expanded=0,
        optimal=False,
    )


# ---------------------------------------------------------------------------
# Mode (b): branch and bound with an admissible per-group roofline
# ---------------------------------------------------------------------------


def _group_rate_ceilings(
    machine: MachineSpec, workload: Workload, classes: tuple[int, ...]
) -> np.ndarray:
    """``(C, s)`` admissible per-thread rate ceiling ``cap_r / u_lower`` of
    a (class, node) group, before the demand clip at 1.0.  ``u_lower``
    keeps only the usage every placement is sure to charge: static and
    local rows plus the own-node per-thread (``>= 1/n``) and interleave
    (``>= 1/s``) floors."""
    s = machine.n_nodes
    n = workload.n_threads
    comps = [
        c.numpy() for c in group_slab_components(machine, _host_workload(workload), classes)
    ]
    base_read, base_write, pt_read, pt_write, il_read, il_write = comps
    own = np.eye(s)[None, :, :]  # (1, s, s): the own-node bank column
    ru = base_read + (pt_read[:, :, None] / n + il_read[:, :, None] / s) * own
    wu = base_write + (pt_write[:, :, None] / n + il_write[:, :, None] / s) * own

    dense_caps, rr_caps, ww_caps = (
        a.numpy().astype(np.float64) for a in split_caps(machine, device="cpu")
    )
    bank_r = dense_caps[:s]
    bank_w = dense_caps[s : 2 * s]
    link_caps = dense_caps[2 * s :]
    offdiag = 1.0 - np.eye(s)

    with np.errstate(divide="ignore"):
        # bank capacities: usage row j vs cap j
        r_banks = np.where(ru > 0, bank_r[None, None, :] / np.maximum(ru, 1e-30), np.inf)
        w_banks = np.where(wu > 0, bank_w[None, None, :] / np.maximum(wu, 1e-30), np.inf)
        ceil = np.minimum(r_banks.min(axis=2), w_banks.min(axis=2))  # (C, s)
        # remote per-pair path capacities (diagonal caps are inf already)
        rr = np.where(
            ru * offdiag > 0, rr_caps[None, :, :] / np.maximum(ru * offdiag, 1e-30), np.inf
        )
        wwp = np.where(
            wu * offdiag > 0, ww_caps[None, :, :] / np.maximum(wu * offdiag, 1e-30), np.inf
        )
        ceil = np.minimum(ceil, np.minimum(rr.min(axis=2), wwp.min(axis=2)))
        if machine.n_links:
            inc = np.asarray(machine.topology.route_incidence(), np.float64).reshape(
                s, s, machine.n_links
            )
            lu = np.einsum("ckj,kjl->ckl", (ru + wu) * offdiag, inc)
            links = np.where(lu > 0, link_caps[None, None, :] / np.maximum(lu, 1e-30), np.inf)
            ceil = np.minimum(ceil, links.min(axis=2))
    return ceil  # (C, s) in threads-at-full-rate units


class _BoundTables(NamedTuple):
    value: np.ndarray  # (s, n+1, cap+1) admissible value of t threads at
    #                    offset m on node j (thread->node order is contiguous)
    suffix: np.ndarray  # (s+1, n+1) best completion value from (node, offset)


def _bound_tables(
    machine: MachineSpec, workload: Workload, classes: tuple[int, ...]
) -> _BoundTables:
    s = machine.n_nodes
    n = workload.n_threads
    cap = machine.cores_per_node
    ceil = _group_rate_ceilings(machine, workload, classes)  # (C, s)
    rates = machine.node_rates("cpu").numpy().astype(np.float64)
    starts = np.asarray(classes + (n,), np.int64)
    C = len(classes)
    # cum[c, m] = threads of class c among the first m threads
    cum = np.zeros((C, n + 1), np.int64)
    for c in range(C):
        lo, hi = starts[c], starts[c + 1]
        cum[c] = np.clip(np.arange(n + 1), lo, hi) - lo

    value = np.zeros((s, n + 1, cap + 1))
    t_grid = np.arange(cap + 1)
    for j in range(s):
        acc = np.zeros((n + 1, cap + 1))
        for c in range(C):
            hi = cum[c][np.minimum(np.arange(n + 1)[:, None] + t_grid[None, :], n)]
            acc += np.minimum(hi - cum[c][:, None], ceil[c, j])
        value[j] = acc * rates[j]

    suffix = np.full((s + 1, n + 1), -np.inf)
    suffix[s, n] = 0.0
    for j in range(s - 1, -1, -1):
        for m in range(n + 1):
            t_max = min(cap, n - m)
            cand = value[j, m, : t_max + 1] + suffix[j + 1, m : m + t_max + 1]
            suffix[j, m] = cand.max() if cand.size else -np.inf
    return _BoundTables(value=value, suffix=suffix)


def placement_upper_bound(
    machine: MachineSpec,
    workload: Workload,
    placements,
    *,
    thread_classes: tuple[int, ...] | None = None,
) -> np.ndarray:
    """Admissible work-rate roofline of each placement:
    ``bound(p) >= exact_objectives(p)`` for every ``p`` (the branch-and-
    bound invariant).  A host-side lookup into the per-node value tables
    B&B prunes with."""
    classes = _classes_for(workload, thread_classes)
    tables = _bound_tables(machine, workload, classes)
    p = np.asarray(placements, np.int64)
    if p.ndim == 1:
        p = p[None, :]
    offs = np.concatenate(
        [np.zeros((p.shape[0], 1), np.int64), np.cumsum(p, axis=1)[:, :-1]], axis=1
    )
    out = np.zeros(p.shape[0])
    for j in range(machine.n_nodes):
        out += tables.value[j, offs[:, j], p[:, j]]
    return out


def _heuristic_seeds(machine: MachineSpec, n: int) -> list[np.ndarray]:
    """Cheap incumbents: spread the threads as evenly as caps allow over
    the k fastest nodes, for every k that fits."""
    s = machine.n_nodes
    cap = machine.cores_per_node
    rates = machine.node_rates("cpu").numpy().astype(np.float64)
    order = np.argsort(-rates, kind="stable")
    seeds = []
    for k in range(1, s + 1):
        if k * cap < n:
            continue
        p = np.zeros(s, np.int64)
        chosen = order[:k]
        base, extra = divmod(n, k)
        if base >= cap and extra:
            continue
        for i, node in enumerate(chosen):
            p[node] = min(cap, base + (1 if i < extra else 0))
        if p.sum() == n:
            seeds.append(p.astype(np.int32))
    return seeds


def advisor_warm_seeds(
    machine: MachineSpec,
    workload: Workload,
    *,
    top_k: int = 8,
    max_placements: int = 4096,
    noise_std: float = 0.0,
    generator: torch.Generator | None = None,
) -> list[np.ndarray]:
    """Incumbent seeds from the advisor's signature-only ranking
    (:func:`repro_torch.core.meshsig.advisor.rank_numa_placements`): the
    top-k placements by the roofline score, for the caller to evaluate
    exactly.  Seeds only ever raise the incumbent; they never prune.

    Returns no seeds when the thread count does not divide evenly over the
    nodes (the 2-run fit needs the symmetric profiling placement)."""
    from repro_torch.core.meshsig.advisor import rank_numa_placements

    if workload.n_threads % machine.n_nodes != 0:
        return []
    ranked = rank_numa_placements(
        machine,
        workload,
        top_k=top_k,
        max_placements=max_placements,
        noise_std=noise_std,
        generator=generator,
    )
    return [np.asarray(r.placement, np.int32) for r in ranked]


def branch_and_bound(
    machine: MachineSpec,
    workload: Workload,
    *,
    thread_classes: tuple[int, ...] | None = None,
    gap: float = 0.0,
    max_nodes: int = 200_000,
    leaf_batch: int = 64,
    seed_placements: Sequence | None = None,
    advisor_seeds: int = 0,
    advisor_max_placements: int = 4096,
) -> SearchResult:
    """Best-first branch and bound over thread compositions.  Returns a
    placement whose exact work rate is within ``gap`` (relative) of the
    optimum when the tree is exhausted (``optimal=True``); hitting
    ``max_nodes`` returns the incumbent.

    The tree assigns node counts left to right; a node's bound is its
    prefix value plus the suffix DP completion.  Leaves are evaluated
    exactly in batches of ``leaf_batch`` on the workload's device.
    ``advisor_seeds > 0`` warm-starts the incumbent from the advisor's
    signature-only ranking (:func:`advisor_warm_seeds`)."""
    classes = _classes_for(workload, thread_classes)
    s = machine.n_nodes
    n = workload.n_threads
    cap = machine.cores_per_node
    if not 0 < n <= s * cap:
        raise ValueError(f"{n} threads do not fit {s} nodes x {cap} cores")
    tables = _bound_tables(machine, workload, classes)
    value, suffix = tables.value, tables.suffix

    seeds = [np.asarray(p, np.int32) for p in (seed_placements or [])]
    if advisor_seeds > 0:
        seeds.extend(
            advisor_warm_seeds(
                machine, workload, top_k=advisor_seeds,
                max_placements=advisor_max_placements,
            )
        )
    seeds.extend(_heuristic_seeds(machine, n))
    vals = exact_objectives(machine, workload, np.stack(seeds), thread_classes=classes)
    evals = len(seeds)
    best_i = int(np.argmax(vals))
    incumbent_p, incumbent = seeds[best_i], float(vals[best_i])

    def prune_level() -> float:
        return incumbent * (1.0 + gap)

    # heap entries: (-bound, tiebreak, depth, offset, prefix_value, prefix)
    heap = [(-suffix[0, 0], 0, 0, 0, 0.0, ())]
    tiebreak = 1
    expanded = 0
    leaves: list[tuple[float, tuple[int, ...]]] = []
    exhausted = True

    def flush_leaves():
        nonlocal incumbent, incumbent_p, evals
        if not leaves:
            return
        batch = np.asarray([p for _, p in leaves], np.int32)
        vals = exact_objectives(machine, workload, batch, thread_classes=classes)
        evals += len(leaves)
        i = int(np.argmax(vals))
        if float(vals[i]) > incumbent:
            incumbent = float(vals[i])
            incumbent_p = batch[i]
        leaves.clear()

    while heap:
        neg_bound, _, depth, off, pval, prefix = heapq.heappop(heap)
        if -neg_bound <= prune_level():
            break  # best-first: nothing left can beat the incumbent
        if expanded >= max_nodes:
            exhausted = False
            break
        expanded += 1
        if depth == s - 1:
            # the last node count is forced; emit a leaf
            t = n - off
            if 0 <= t <= cap:
                leaves.append((pval + value[depth, off, t], prefix + (t,)))
                if len(leaves) >= leaf_batch:
                    flush_leaves()
            continue
        remaining_cap = (s - depth - 1) * cap
        t_lo = max(0, n - off - remaining_cap)
        t_hi = min(cap, n - off)
        for t in range(t_lo, t_hi + 1):
            child_val = pval + value[depth, off, t]
            child_bound = child_val + suffix[depth + 1, off + t]
            if child_bound <= prune_level():
                continue
            heapq.heappush(
                heap,
                (-child_bound, tiebreak, depth + 1, off + t, child_val, prefix + (t,)),
            )
            tiebreak += 1
    flush_leaves()

    return SearchResult(
        placement=tuple(int(v) for v in incumbent_p),
        objective=incumbent,
        evaluations=evals,
        nodes_expanded=expanded,
        optimal=exhausted,
    )
