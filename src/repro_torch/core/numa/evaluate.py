"""Evaluation harness reproducing the paper's §6 methodology, batched
(port of ``repro.core.numa.evaluate``).

* :func:`enumerate_placements` / :func:`sweep_placements`: every
  one-thread-per-core distribution of ``n_threads`` over the machine's
  NUMA nodes, or a seeded sample of it — the same placements, in the
  same order, as the reference (the sample uses Python ``random``
  exactly as the reference does).
* :func:`evaluate_batch`: fit each workload's signature from the two
  profiling runs, then predict the bank counters of every placement and
  compare against simulated measurements — all workloads and placements
  in one pass over the structured progressive fill.
* :func:`fitted_signatures`, :func:`evaluate_accuracy`,
  :func:`evaluate_suite`, :func:`evaluate_stability`: the paper's §6
  evaluations over that engine.

Errors are reported the paper's way: per counter measurement, as a
fraction of the run's total bandwidth.  Fitted signatures are cached
keyed on ``(machine, workload, noise)``.

Measurement noise comes as a :class:`SweepNoise` of standard-normal
draws or from a ``torch.Generator`` (see
:mod:`repro_torch.core.numa.simulator`); the reference's ``jax.random``
streams are not reproduced.
"""

from __future__ import annotations

import hashlib
import random as _pyrandom
import threading
from functools import lru_cache
from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch import DEFAULT_DEVICE, resolve_device
from repro_torch.core.bwsig import (
    BandwidthSignature,
    CounterSample,
    DirectionSignature,
    fit_signature,
    misfit_score,
    signature_distance,
)
from repro_torch.core.numa.benchmarks import benchmark_workload, suite_names
from repro_torch.core.numa.machine import MachineSpec, canonical_bank_assignment
from repro_torch.core.numa.simulator import (
    CounterNoise,
    _apply_noise,
    _asymmetric_counts,
    _symmetric_counts,
    default_generator,
    draw_counter_noise,
    simulate_grouped_batch,
    support_patterns,
    thread_class_starts,
)
from repro_torch.core.numa.workload import Workload

_F32 = torch.float32

# ---------------------------------------------------------------------------
# Placement enumeration: compositions of n_threads over s nodes
# ---------------------------------------------------------------------------


@lru_cache(maxsize=256)
def _composition_table(s: int, cap: int, n: int) -> tuple[tuple[int, ...], ...]:
    """``T[k][m]``: number of compositions of ``m`` into ``k`` ordered
    parts each in ``[0, cap]`` (python ints — exact at any scale)."""
    T = [[0] * (n + 1) for _ in range(s + 1)]
    T[0][0] = 1
    for k in range(1, s + 1):
        prev, cur = T[k - 1], T[k]
        for m in range(n + 1):
            cur[m] = sum(prev[m - j] for j in range(min(cap, m) + 1))
    return tuple(tuple(row) for row in T)


def _unrank_compositions(
    table: tuple[tuple[int, ...], ...], ranks, s: int, cap: int, n: int
) -> np.ndarray:
    """Unrank composition ``ranks`` through the counting table, one numpy
    pass per position (exact-bigint python loop when a table entry would
    overflow int64)."""
    ranks = list(ranks)
    out = np.empty((len(ranks), s), np.int32)
    if not ranks:
        return out
    if max(max(row) for row in table) < 2**62:  # every table entry fits int64
        T = np.asarray(table, np.int64)  # (s+1, n+1)
        r = np.asarray(ranks, np.int64)
        m = np.full(r.shape, n, np.int64)
        j_grid = np.arange(cap + 1, dtype=np.int64)
        for k in range(s, 0, -1):
            idx = m[:, None] - j_grid[None, :]  # (R, cap+1)
            counts = np.where(idx >= 0, T[k - 1][np.clip(idx, 0, None)], 0)
            csum = counts.cumsum(axis=1)
            j = (csum <= r[:, None]).sum(axis=1)  # first j with r < csum[j]
            prev = np.take_along_axis(csum, np.maximum(j - 1, 0)[:, None], 1)[:, 0]
            r = r - np.where(j > 0, prev, 0)
            out[:, s - k] = j
            m = m - j
        return out
    for row, rank in enumerate(ranks):
        r, m = rank, n
        for k in range(s, 0, -1):
            for j in range(min(cap, m) + 1):
                c = table[k - 1][m - j]
                if r < c:
                    out[row, s - k] = j
                    m -= j
                    break
                r -= c
    return out


def count_placements(machine: MachineSpec, n_threads: int) -> int:
    """How many one-thread-per-core distributions of ``n_threads`` over
    the machine's NUMA nodes exist."""
    table = _composition_table(machine.n_nodes, machine.cores_per_node, n_threads)
    return table[machine.n_nodes][n_threads]


def placement_array(
    machine: MachineSpec,
    n_threads: int,
    *,
    max_placements: int | None = None,
    seed: int = 0,
) -> np.ndarray:
    """Host-side ``(P, s)`` int32 placements of :func:`enumerate_placements`:
    lexicographic order (node-0 count ascending); a seeded uniform sample
    of ranks when the count exceeds ``max_placements``."""
    s, cap = machine.n_nodes, machine.cores_per_node
    if not 0 <= n_threads <= s * cap:
        raise ValueError(f"{n_threads} threads do not fit {s} nodes x {cap} cores")
    table = _composition_table(s, cap, n_threads)
    total = table[s][n_threads]
    if max_placements is not None and total > max_placements:
        ranks: Sequence[int] = sorted(
            _pyrandom.Random(seed).sample(range(total), max_placements)
        )
    else:
        ranks = range(total)
    return _unrank_compositions(table, ranks, s, cap, n_threads)


def enumerate_placements(
    machine: MachineSpec,
    n_threads: int,
    *,
    max_placements: int | None = None,
    seed: int = 0,
    device=DEFAULT_DEVICE,
) -> torch.Tensor:
    """All (or a deterministic sample of) thread distributions over the
    machine's NUMA nodes keeping one thread per core, as an int32 tensor
    on ``device`` — identical to the reference's placements."""
    arr = placement_array(machine, n_threads, max_placements=max_placements, seed=seed)
    return torch.as_tensor(arr, device=resolve_device(device))


def sweep_placements(
    machine: MachineSpec,
    n_threads: int,
    *,
    max_placements: int | None = None,
    seed: int = 0,
    device=DEFAULT_DEVICE,
) -> torch.Tensor:
    """The paper's §6.2.2 sweep ("varied the distribution of the threads
    ... maintaining a single thread per core") over any node count."""
    return enumerate_placements(
        machine, n_threads, max_placements=max_placements, seed=seed, device=device
    )


# ---------------------------------------------------------------------------
# The batched fit + predict engine
# ---------------------------------------------------------------------------


class AccuracyResult(NamedTuple):
    """Fit-and-predict accuracy on one workload: per-counter prediction
    errors over a placement sweep, as fractions of run bandwidth."""

    placements: torch.Tensor  # (P, s)
    errors_read: torch.Tensor  # (P, 2s)
    errors_write: torch.Tensor  # (P, 2s)
    errors_combined: torch.Tensor  # (P, 2s)
    total_bw: torch.Tensor  # (P,)
    misfit: torch.Tensor  # scalar §6.2.1 detector score
    signature: BandwidthSignature


class BatchAccuracy(NamedTuple):
    """:func:`evaluate_batch` output: leading axis = benchmark (B), then
    placement."""

    placements: torch.Tensor  # (P, s)
    errors_read: torch.Tensor  # (B, P, 2s)
    errors_write: torch.Tensor  # (B, P, 2s)
    errors_combined: torch.Tensor  # (B, P, 2s)
    total_bw: torch.Tensor  # (B, P)
    misfit: torch.Tensor  # (B,)
    signatures: BandwidthSignature  # leaves stacked over B
    combined_signatures: BandwidthSignature


class SweepNoise(NamedTuple):
    """Standard-normal draws for a noisy :func:`evaluate_batch`: the two
    profiling runs of every workload and the measurement of every
    (workload, placement) flow matrix."""

    profile: CounterNoise  # leaves (B, 2, ...): symmetric, asymmetric run
    read: torch.Tensor  # (B, P, s, s)
    write: torch.Tensor  # (B, P, s, s)


def draw_sweep_noise(
    n_workloads: int, n_placements: int, s: int, generator: torch.Generator, device
) -> SweepNoise:
    """Draw a :class:`SweepNoise` from ``generator``."""
    profile = draw_counter_noise((n_workloads, 2), s, generator, device)
    shape = (n_workloads, n_placements, s, s)
    read = torch.randn(shape, generator=generator, dtype=_F32, device=device)
    write = torch.randn(shape, generator=generator, dtype=_F32, device=device)
    return SweepNoise(profile, read, write)


def _batched_direction_errors(sig_dir, pt, il, used, demand, local_meas, remote_meas):
    """Counter errors of one direction for a whole (benchmark, placement)
    batch.  ``predict_counters`` only reads the diagonal and the column
    sums of the predicted flow matrix, and every §4 placement-matrix term
    is rank-1 in the bank axis:

        pred[i, j] = demand_i * (sf*st_j + lf*δij + pf*pt_j
                                 + inter * used_i * used_j / s_used)

    so both counters close over ``(P, s)`` element-wise math.  Signature
    leaves are ``(B,)``; ``pt``/``il``/``used`` are ``(P, s)``; demand
    and measurements ``(B, P, s)``."""
    s = pt.shape[-1]
    cols = torch.arange(s, device=pt.device)
    st = (cols == sig_dir.static_socket[:, None]).to(pt.dtype)[:, None, :]  # (B, 1, s)
    sf = sig_dir.static_fraction[:, None, None]
    lf = sig_dir.local_fraction[:, None, None]
    pf = sig_dir.per_thread_fraction[:, None, None]
    inter = torch.clamp(1.0 - sf - lf - pf, 0.0, 1.0)
    total = demand.sum(dim=-1, keepdim=True)  # (B, P, 1)
    total_used = (demand * used).sum(dim=-1, keepdim=True)
    colw = sf * st + pf * pt + inter * il  # (B, P, s)
    local = demand * (colw + lf)
    colsum = (sf * st + pf * pt) * total + inter * il * total_used + lf * demand
    remote = colsum - local
    return torch.cat(
        [torch.abs(local - local_meas), torch.abs(remote - remote_meas)], dim=-1
    )


def _workload_arrays(wl: Workload) -> tuple[torch.Tensor, ...]:
    """The array fields of a Workload (everything but the name)."""
    return tuple(wl[1:])


def _as_workload_list(workloads: Workload | Sequence[Workload]) -> list[Workload]:
    wl_list = [workloads] if isinstance(workloads, Workload) else list(workloads)
    n_threads = {w.n_threads for w in wl_list}
    if len(n_threads) != 1:
        raise ValueError(f"workloads must share a thread count, got {n_threads}")
    devices = {w.device for w in wl_list}
    if len(devices) != 1:
        raise ValueError(f"workloads must share a device, got {devices}")
    return wl_list


def _memo_get(cache: dict, lock: threading.RLock, key):
    """LRU-touching lookup into an id-keyed memo (a hit moves the entry
    to the young end), under ``lock``."""
    with lock:
        hit = cache.pop(key, None)
        if hit is not None:
            cache[key] = hit
        return hit


def _memo_put(cache: dict, lock: threading.RLock, key, value, max_entries: int):
    """Bounded insert: evict oldest-first past ``max_entries``."""
    with lock:
        cache[key] = value
        while len(cache) > max_entries:
            cache.pop(next(iter(cache)))


_MEMO_LOCK = threading.RLock()
_MEMO_CACHE_MAX = 64
_STACK_CACHE: dict[tuple, tuple] = {}
_SUPPORT_CACHE: dict[tuple, tuple] = {}


def _stack_workloads(wl_list: Sequence[Workload]) -> Workload:
    """The workloads as one :class:`Workload` whose fields carry a leading
    benchmark axis, memoized on the workload objects' identities (the
    value keeps them alive, so ids cannot be recycled while a key is
    live)."""
    key = tuple(id(w) for w in wl_list)
    hit = _memo_get(_STACK_CACHE, _MEMO_LOCK, key)
    if hit is not None:
        return hit[1]
    stacked = Workload(
        "batched",
        *(torch.stack(parts) for parts in zip(*(_workload_arrays(w) for w in wl_list))),
    )
    _memo_put(_STACK_CACHE, _MEMO_LOCK, key, (tuple(wl_list), stacked), _MEMO_CACHE_MAX)
    return stacked


def _support_arrays(placements, device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Device-ready ``(placements, support, slab_id)`` for a placement
    batch, memoized on the batch object's identity and the device (the
    value keeps the batch alive)."""
    key = (id(placements), str(device))
    hit = _memo_get(_SUPPORT_CACHE, _MEMO_LOCK, key)
    if hit is not None:
        return hit[1]
    support, slab_id = support_patterns(placements)
    if not isinstance(placements, torch.Tensor):
        placements_t = torch.as_tensor(np.array(placements, np.int32), device=device)
    else:
        placements_t = placements.to(device=device, dtype=torch.int32)
    value = (
        placements_t,
        torch.as_tensor(support, device=device),
        torch.as_tensor(slab_id, device=device).to(torch.int64),
    )
    _memo_put(_SUPPORT_CACHE, _MEMO_LOCK, key, (placements, value), _MEMO_CACHE_MAX)
    return value


def _profile_samples(
    machine: MachineSpec,
    stacked: Workload,
    noise: CounterNoise | None,
    noise_std: float,
    background_bw: float,
    thread_classes: tuple[int, ...],
) -> tuple[CounterSample, CounterSample]:
    """The two profiling runs (paper §5.1) of every stacked workload:
    both placements through the batched fill at once, then the
    measurement noise of each run."""
    dev = stacked.device
    n = stacked.read_static.shape[-1]
    runs = torch.tensor(
        [_symmetric_counts(machine, n), _asymmetric_counts(machine, n)],
        dtype=torch.int32, device=dev,
    )
    sim = simulate_grouped_batch(machine, stacked, runs, thread_classes=thread_classes)
    rf, wf, instr = sim.read_flows, sim.write_flows, sim.instructions  # (B, 2, ...)
    if noise_std > 0.0 or background_bw > 0.0:
        rf, wf, instr = _apply_noise(
            rf, wf, instr, 1.0, noise_std, background_bw, noise, machine.n_nodes
        )
    elapsed = torch.tensor(1.0, dtype=_F32, device=dev)

    def run(i):
        l_read = torch.diagonal(rf[:, i], dim1=-2, dim2=-1)
        l_write = torch.diagonal(wf[:, i], dim1=-2, dim2=-1)
        return CounterSample(
            local_read=l_read,
            remote_read=rf[:, i].sum(-2) - l_read,
            local_write=l_write,
            remote_write=wf[:, i].sum(-2) - l_write,
            instructions=instr[:, i],
            elapsed=elapsed,
            n_per_socket=runs[i],
        )

    return run(0), run(1)


def _fit_batch(machine, stacked, noise, noise_std, background_bw, thread_classes):
    """Fit ``(signature, combined signature, misfit)`` for every stacked
    workload (leaves with a leading benchmark axis)."""
    sym, asym = _profile_samples(
        machine, stacked, noise, noise_std, background_bw, thread_classes
    )
    sig = fit_signature(sym, asym)
    sig_combined = fit_signature(sym, asym, combined=True)
    return sig, sig_combined, misfit_score(sym, "read")


def evaluate_batch(
    machine: MachineSpec,
    workloads: Workload | Sequence[Workload],
    placements,
    *,
    noise_std: float = 0.0,
    background_bw: float = 0.0,
    noise: SweepNoise | None = None,
    generator: torch.Generator | None = None,
    multipath: bool = False,
    bank_assignment=None,
) -> BatchAccuracy:
    """Fit + predict every workload over every placement in one batched
    pass, bucketing the placements by support pattern so the resource
    slab is built once per bucket.  Runs on the workloads' device.

    A noisy call takes its draws from ``noise`` or, without it, from
    ``generator`` (seed 0 when none is given).  Output rows stay in the
    caller's placement order.  ``bank_assignment`` applies one page
    placement to every simulated placement; the profiling fit is not
    re-pointed (signatures describe the workload, not the placement).
    """
    wl_list = _as_workload_list(workloads)
    dev = wl_list[0].device
    s = machine.n_nodes
    noisy = noise_std > 0.0 or background_bw > 0.0
    placements_t, support, slab_id = _support_arrays(placements, dev)
    stacked = _stack_workloads(wl_list)
    B, P = len(wl_list), placements_t.shape[0]
    if noisy and noise is None:
        if generator is None:
            generator = default_generator(dev)
        noise = draw_sweep_noise(B, P, s, generator, dev)
    thread_classes = thread_class_starts(wl_list)

    sigs, csigs, misfit = _fit_batch(
        machine, stacked, noise.profile if noisy else None,
        noise_std, background_bw, thread_classes,
    )
    sim = simulate_grouped_batch(
        machine, stacked, placements_t,
        thread_classes=thread_classes, support=support, slab_id=slab_id,
        multipath=multipath,
        bank_assignment=canonical_bank_assignment(machine, bank_assignment),
    )
    read_flows, write_flows = sim.read_flows, sim.write_flows  # (B, P, s, s)
    if noisy:
        # the error metrics never read the instruction counters, so only
        # the two flow draws are applied
        read_flows = read_flows * torch.exp(noise_std * noise.read) + background_bw / (s * s)
        write_flows = write_flows * torch.exp(noise_std * noise.write) + background_bw / (s * s)

    local_read = torch.diagonal(read_flows, dim1=-2, dim2=-1)  # (B, P, s)
    remote_read = read_flows.sum(-2) - local_read
    local_write = torch.diagonal(write_flows, dim1=-2, dim2=-1)
    remote_write = write_flows.sum(-2) - local_write
    totals = torch.clamp(read_flows.sum((-2, -1)) + write_flows.sum((-2, -1)), min=1e-9)

    # batched §4 prediction (guards mirror bwsig's placement matrices)
    nf = placements_t.to(_F32)
    pt = nf / torch.clamp(nf.sum(-1, keepdim=True), min=1.0)
    used = (nf > 0).to(_F32)
    il = used / torch.clamp(used.sum(-1, keepdim=True), min=1.0)
    inv = 1.0 / totals[..., None]
    e_read = inv * _batched_direction_errors(
        sigs.read, pt, il, used, read_flows.sum(-1), local_read, remote_read
    )
    e_write = inv * _batched_direction_errors(
        sigs.write, pt, il, used, write_flows.sum(-1), local_write, remote_write
    )
    e_comb = inv * _batched_direction_errors(
        csigs.read, pt, il, used,
        read_flows.sum(-1) + write_flows.sum(-1),
        local_read + local_write, remote_read + remote_write,
    )
    result = BatchAccuracy(
        placements=placements_t,
        errors_read=e_read,
        errors_write=e_write,
        errors_combined=e_comb,
        total_bw=totals,
        misfit=misfit,
        signatures=sigs,
        combined_signatures=csigs,
    )
    profile_noise = noise.profile if noisy else None
    for i, wl in enumerate(wl_list):
        ck = _cache_key(machine, wl, noise_std, background_bw, profile_noise, i)
        if _cache_lookup(ck) is None:
            _cache_insert(ck, (_tree_index(sigs, i), _tree_index(csigs, i), misfit[i]))
    return result


def _tree_index(sig: BandwidthSignature, i: int) -> BandwidthSignature:
    return BandwidthSignature(*(DirectionSignature(*(f[i] for f in d)) for d in sig))


def _accuracy_from_batch(batch: BatchAccuracy, i: int) -> AccuracyResult:
    return AccuracyResult(
        placements=batch.placements,
        errors_read=batch.errors_read[i],
        errors_write=batch.errors_write[i],
        errors_combined=batch.errors_combined[i],
        total_bw=batch.total_bw[i],
        misfit=batch.misfit[i],
        signature=_tree_index(batch.signatures, i),
    )


# ---------------------------------------------------------------------------
# Fitted-signature cache
# ---------------------------------------------------------------------------

_SIG_CACHE: dict[tuple, tuple] = {}
_SIG_CACHE_MAX = 4096
# one re-entrant lock serializes every read-modify-write of the cache;
# fits are idempotent, so two threads racing on the same miss both
# compute and the second insert wins
_SIG_LOCK = threading.RLock()


def _digest(arrays) -> str:
    digest = hashlib.blake2b(digest_size=16)
    for a in arrays:
        a = a.detach().cpu().numpy()
        digest.update(str(a.shape).encode())
        digest.update(str(a.dtype).encode())
        digest.update(a.tobytes())
    return digest.hexdigest()


def _workload_fingerprint(wl: Workload) -> tuple:
    return (wl.name, wl.n_threads, _digest(_workload_arrays(wl)))


def _cache_key(machine, wl, noise_std, background_bw, profile_noise, i) -> tuple:
    """Content key of one fit: the machine fingerprint, the workload's
    digest and device (a fit's tensors live where its workload does), the
    noise level and (for a noisy fit) the digest of the profiling draws
    the fit consumed."""
    drawn = "" if profile_noise is None else _digest(f[i] for f in profile_noise)
    return (
        machine.fingerprint(),
        _workload_fingerprint(wl),
        str(wl.device),
        float(noise_std),
        float(background_bw),
        drawn,
    )


def _cache_lookup(cache_key: tuple):
    """LRU-touching get (pop + re-insert under the cache lock)."""
    with _SIG_LOCK:
        value = _SIG_CACHE.pop(cache_key, None)
        if value is not None:
            _SIG_CACHE[cache_key] = value
        return value


def _cache_insert(cache_key: tuple, value) -> None:
    """Locked insert + oldest-first eviction sweep."""
    with _SIG_LOCK:
        _SIG_CACHE[cache_key] = value
        while len(_SIG_CACHE) > _SIG_CACHE_MAX:
            _SIG_CACHE.pop(next(iter(_SIG_CACHE)))


def fitted_signatures(
    machine: MachineSpec,
    workloads: Workload | Sequence[Workload],
    *,
    noise_std: float = 0.0,
    background_bw: float = 0.0,
    noise: CounterNoise | None = None,
    generator: torch.Generator | None = None,
) -> list[tuple[BandwidthSignature, BandwidthSignature, torch.Tensor]]:
    """Cached 2-run fits: ``(signature, combined_signature, misfit)`` per
    workload.  ``noise`` holds the profiling draws with leading
    ``(B, 2)`` axes (drawn from ``generator`` when absent and the call is
    noisy); misses are fitted in one batched pass."""
    wl_list = _as_workload_list(workloads)
    dev = wl_list[0].device
    noisy = noise_std > 0.0 or background_bw > 0.0
    if noisy and noise is None:
        if generator is None:
            generator = default_generator(dev)
        noise = draw_counter_noise((len(wl_list), 2), machine.n_nodes, generator, dev)
    cache_keys = [
        _cache_key(machine, wl, noise_std, background_bw, noise if noisy else None, i)
        for i, wl in enumerate(wl_list)
    ]
    results = {}
    for i, ck in enumerate(cache_keys):
        hit = _cache_lookup(ck)
        if hit is not None:
            results[i] = hit
    missing = [i for i in range(len(wl_list)) if i not in results]
    if missing:
        missing_wls = [wl_list[i] for i in missing]
        sub_noise = None
        if noisy:
            idx = torch.as_tensor(missing, device=dev)
            sub_noise = CounterNoise(*(f[idx] for f in noise))
        sigs, csigs, mis = _fit_batch(
            machine, _stack_workloads(missing_wls), sub_noise,
            noise_std, background_bw, thread_class_starts(missing_wls),
        )
        for row, i in enumerate(missing):
            results[i] = (_tree_index(sigs, row), _tree_index(csigs, row), mis[row])
            _cache_insert(cache_keys[i], results[i])
    return [results[i] for i in range(len(wl_list))]


# ---------------------------------------------------------------------------
# Paper §6 evaluations
# ---------------------------------------------------------------------------


def evaluate_accuracy(
    machine: MachineSpec,
    workload: Workload,
    *,
    noise_std: float = 0.0,
    background_bw: float = 0.0,
    noise: SweepNoise | None = None,
    generator: torch.Generator | None = None,
    max_placements: int | None = None,
) -> AccuracyResult:
    """Profile two placements, fit the signature, and score its counter
    predictions over the full placement sweep (§6.2), on the workload's
    device."""
    placements = sweep_placements(
        machine, workload.n_threads, max_placements=max_placements,
        device=workload.device,
    )
    batch = evaluate_batch(
        machine, [workload], placements,
        noise_std=noise_std, background_bw=background_bw,
        noise=noise, generator=generator,
    )
    return _accuracy_from_batch(batch, 0)


def _default_suite_threads(machine: MachineSpec) -> int:
    """Largest single-socket thread count, rounded down so the symmetric
    profiling run splits it evenly over the NUMA nodes."""
    n_threads = machine.cores_per_socket
    n_threads -= n_threads % machine.n_nodes
    return n_threads or machine.n_nodes


class SuiteAccuracy(NamedTuple):
    """Suite-level accuracy rollup: per-benchmark results plus the pooled
    error distribution and its headline percentiles."""

    names: list[str]
    per_benchmark: dict[str, AccuracyResult]
    all_errors: np.ndarray  # every counter measurement's % error
    median_error_pct: float
    p75_error_pct: float


def evaluate_suite(
    machine: MachineSpec,
    n_threads: int | None = None,
    *,
    noise_std: float = 0.0,
    include_violators: bool = True,
    seed: int = 0,
    max_placements: int | None = None,
    device=DEFAULT_DEVICE,
) -> SuiteAccuracy:
    """Fit + predict every suite benchmark over every placement — the
    paper's "thousands of measurements" (§6.2.2) — in one
    :func:`evaluate_batch` pass; noise is drawn from a generator seeded
    with ``seed``."""
    dev = resolve_device(device)
    if n_threads is None:
        n_threads = _default_suite_threads(machine)
    names = suite_names(include_violators)
    workloads = [benchmark_workload(name, n_threads, device=dev) for name in names]
    placements = sweep_placements(
        machine, n_threads, max_placements=max_placements, device=dev
    )
    batch = evaluate_batch(
        machine, workloads, placements, noise_std=noise_std,
        generator=default_generator(dev, seed),
    )
    results = {name: _accuracy_from_batch(batch, i) for i, name in enumerate(names)}
    all_errors = batch.errors_combined.detach().cpu().numpy().reshape(-1) * 100.0
    return SuiteAccuracy(
        names=names,
        per_benchmark=results,
        all_errors=all_errors,
        median_error_pct=float(np.median(all_errors)),
        p75_error_pct=float(np.percentile(all_errors, 75)),
    )


class StabilityResult(NamedTuple):
    """Signature stability across machines: how much each benchmark's
    fitted signature moves when refit on a different machine (§6.3)."""

    names: list[str]
    read_change: dict[str, float]
    write_change: dict[str, float]
    combined_change: dict[str, float]
    mean_combined_pct: float
    median_combined_pct: float


def evaluate_stability(
    machine_a: MachineSpec,
    machine_b: MachineSpec,
    n_threads_a: int | None = None,
    n_threads_b: int | None = None,
    *,
    noise_std: float = 0.0,
    include_violators: bool = True,
    noise: tuple[CounterNoise, CounterNoise] | None = None,
    seed: int = 0,
    device=DEFAULT_DEVICE,
) -> StabilityResult:
    """Fit each suite benchmark on both machines and report the bandwidth
    reallocated between the two signatures (paper Figures 13-15), each
    machine's suite fitted in one batched (cached) pass.

    A noisy call takes the profiling draws of machine A's and machine B's
    fits from ``noise`` (leading ``(benchmarks, 2)`` axes each) or, without
    it, draws A's and then B's from a generator seeded with ``seed``."""
    dev = resolve_device(device)
    if n_threads_a is None:
        n_threads_a = _default_suite_threads(machine_a)
    if n_threads_b is None:
        n_threads_b = _default_suite_threads(machine_b)
    names = suite_names(include_violators)
    wl_a = [benchmark_workload(name, n_threads_a, device=dev) for name in names]
    wl_b = [benchmark_workload(name, n_threads_b, device=dev) for name in names]
    noisy = noise_std > 0.0
    if noisy and noise is None:
        generator = default_generator(dev, seed)
        noise = tuple(
            draw_counter_noise((len(names), 2), m.n_nodes, generator, dev)
            for m in (machine_a, machine_b)
        )
    noise_a, noise_b = noise if noisy else (None, None)
    fits_a = fitted_signatures(machine_a, wl_a, noise_std=noise_std, noise=noise_a)
    fits_b = fitted_signatures(machine_b, wl_b, noise_std=noise_std, noise=noise_b)

    read_c, write_c, comb_c = {}, {}, {}
    for name, (sig_a, csig_a, _), (sig_b, csig_b, _) in zip(names, fits_a, fits_b):
        read_c[name] = float(signature_distance(sig_a.read, sig_b.read)) * 100
        write_c[name] = float(signature_distance(sig_a.write, sig_b.write)) * 100
        comb_c[name] = float(signature_distance(csig_a.read, csig_b.read)) * 100
    vals = np.asarray(list(comb_c.values()))
    return StabilityResult(
        names=names,
        read_change=read_c,
        write_change=write_c,
        combined_change=comb_c,
        mean_combined_pct=float(vals.mean()),
        median_combined_pct=float(np.median(vals)),
    )
