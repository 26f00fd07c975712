"""Time axis: phased workloads, migration costs, and schedule search
(port of ``repro.core.numa.temporal``).

* :class:`PhasedWorkload` — a piecewise-stationary workload: per-phase
  :class:`~repro_torch.core.numa.workload.Workload` signatures with
  durations, each phase scored through
  :func:`repro_torch.core.numa.search.exact_objectives` on the phase
  workload's device.
* :class:`MigrationModel` — what a phase-boundary move costs: bytes per
  migrated thread and per thread whose Local pages change banks, over
  the boundary bandwidth.
* :func:`optimize_schedule` — a candidate placement pool per phase, then
  an exact DP/beam over phase boundaries trading steady-state throughput
  against transition cost, with the option of leaving pages behind
  (``bank_assignment``) when threads move.

The DP and beam run in float64 numpy on the host, as in the reference;
only the phase rates come from the device.
"""

from __future__ import annotations

import time
from typing import NamedTuple, Sequence

import numpy as np

from repro_torch.core.numa.evaluate import count_placements, placement_array
from repro_torch.core.numa.machine import MachineSpec, canonical_bank_assignment
from repro_torch.core.numa.search import (
    _heuristic_seeds,
    exact_objectives,
    optimize_placement,
)
from repro_torch.core.numa.workload import Workload

# ---------------------------------------------------------------------------
# Phased workloads
# ---------------------------------------------------------------------------


class Phase(NamedTuple):
    """One stationary segment of a :class:`PhasedWorkload`."""

    workload: Workload
    duration: float  # seconds the phase runs before the next one starts


class PhasedWorkload(NamedTuple):
    """A piecewise-stationary workload: phases with durations.

    Every phase must keep the same thread count — phases change *what*
    the threads do, not how many there are (spawn/join churn is a
    different axis).  Durations are seconds of steady-state execution;
    the schedule objective is total instructions retired across the whole
    horizon, so long phases dominate exactly as they should.
    """

    name: str
    phases: tuple[Phase, ...]

    @property
    def n_threads(self) -> int:
        """Thread count shared by every phase."""
        return self.phases[0].workload.n_threads

    def validate(self) -> None:
        """Raise ``ValueError`` on empty, non-positive-duration or
        thread-count-mismatched phase lists."""
        if not self.phases:
            raise ValueError(f"phased workload {self.name!r} has no phases")
        n = self.phases[0].workload.n_threads
        for i, ph in enumerate(self.phases):
            if ph.workload.n_threads != n:
                raise ValueError(
                    f"phase {i} has {ph.workload.n_threads} threads, "
                    f"phase 0 has {n}"
                )
            if not ph.duration > 0.0:
                raise ValueError(f"phase {i} duration {ph.duration} <= 0")


def phased_workload(
    name: str, phases: Sequence[tuple[Workload, float]]
) -> PhasedWorkload:
    """Build and validate a :class:`PhasedWorkload` from ``(workload,
    duration_s)`` pairs."""
    pw = PhasedWorkload(
        name, tuple(Phase(wl, float(dur)) for wl, dur in phases)
    )
    pw.validate()
    return pw


# ---------------------------------------------------------------------------
# Migration cost model
# ---------------------------------------------------------------------------


class MigrationModel(NamedTuple):
    """What a phase-boundary reconfiguration costs.

    ``thread_move_bytes`` is the traffic one migrated thread drags across
    the boundary (architectural state plus the cold-cache refill on the
    destination node — order LLC-slice size).  ``page_move_bytes`` is the
    Local-class working set that must be copied when one thread's pages
    change backing bank.  ``bandwidth`` is the bytes/s available to the
    move; ``None`` derives it from the machine (the slowest local read
    bank — migration streams through memory, so the weakest DIMM group
    on the path bounds it).  The resulting stall is charged against the
    start of the next phase: a boundary that moves ``T`` threads and
    re-banks ``P`` threads' pages costs
    ``(T * thread_move_bytes + P * page_move_bytes) / bandwidth`` seconds
    of that phase's execution.
    """

    thread_move_bytes: float = 8e6
    page_move_bytes: float = 256e6
    bandwidth: float | None = None

    def boundary_bandwidth(self, machine: MachineSpec) -> float:
        """The bytes/s a phase-boundary move sustains on ``machine``."""
        if self.bandwidth is not None:
            return float(self.bandwidth)
        return float(np.min(machine.node_local_bw("read", "cpu").numpy()))


def thread_nodes(placement, n_threads: int) -> np.ndarray:
    """Host-side contiguous thread->node map of a concrete placement —
    the numpy twin of the solver's ``_thread_nodes``."""
    p = np.asarray(placement, np.int64)
    if int(p.sum()) != n_threads:
        raise ValueError(f"placement {p.tolist()} does not hold {n_threads} threads")
    return np.repeat(np.arange(p.shape[0]), p)


def thread_banks(placement, bank_assignment, n_threads: int) -> np.ndarray:
    """Per-thread Local-class backing bank under one ``(placement,
    bank_assignment)`` state (``None`` = node-local)."""
    nodes = thread_nodes(placement, n_threads)
    if bank_assignment is None:
        return nodes
    return np.asarray(bank_assignment, np.int64)[nodes]


def transition_cost(
    machine: MachineSpec,
    model: MigrationModel,
    n_threads: int,
    prev_placement,
    prev_banks,
    next_placement,
    next_banks,
) -> tuple[float, int, int]:
    """Seconds of stall (plus the thread/page move counts behind it) to
    reconfigure from one ``(placement, bank_assignment)`` state to the
    next."""
    nodes_a = thread_nodes(prev_placement, n_threads)
    nodes_b = thread_nodes(next_placement, n_threads)
    banks_a = thread_banks(prev_placement, prev_banks, n_threads)
    banks_b = thread_banks(next_placement, next_banks, n_threads)
    moved_threads = int((nodes_a != nodes_b).sum())
    moved_pages = int((banks_a != banks_b).sum())
    bytes_moved = (
        model.thread_move_bytes * moved_threads
        + model.page_move_bytes * moved_pages
    )
    return bytes_moved / model.boundary_bandwidth(machine), moved_threads, moved_pages


def follow_banks(
    machine: MachineSpec,
    n_threads: int,
    prev_placement,
    prev_banks,
    next_placement,
) -> tuple[int, ...] | None:
    """The bank assignment that keeps pages where they are when threads
    move from ``prev_placement`` to ``next_placement``.

    ``bank_assignment`` is per *node*, but the threads landing on a node
    may come from several old nodes — the assignment points each
    destination node at the bank backing the *plurality* of its arriving
    threads (ties to the lowest bank id; empty nodes keep the identity).
    Minority threads still pay a page move, which :func:`transition_cost`
    charges honestly."""
    s = machine.n_nodes
    nodes_b = thread_nodes(next_placement, n_threads)
    banks_a = thread_banks(prev_placement, prev_banks, n_threads)
    ba = list(range(s))
    for k in range(s):
        held = banks_a[nodes_b == k]
        if held.size:
            ba[k] = int(np.bincount(held, minlength=s).argmax())
    return canonical_bank_assignment(machine, tuple(ba))


# ---------------------------------------------------------------------------
# Schedule evaluation
# ---------------------------------------------------------------------------


class Schedule(NamedTuple):
    """One placement trajectory over a :class:`PhasedWorkload` plus its
    receipts (from :func:`evaluate_schedule` / :func:`optimize_schedule`)."""

    placements: tuple[tuple[int, ...], ...]  # per-phase threads-per-node
    bank_assignments: tuple[tuple[int, ...] | None, ...]  # per-phase pages
    total_work: float  # instructions retired over the whole horizon
    phase_rates: tuple[float, ...]  # instructions/s sustained per phase
    transition_times: tuple[float, ...]  # stall charged at each boundary
    moved_threads: tuple[int, ...]  # thread migrations per boundary
    moved_pages: tuple[int, ...]  # page re-bankings (threads) per boundary


class ScheduleSearchResult(NamedTuple):
    """:func:`optimize_schedule` output: the chosen schedule, the best
    *static* schedule over the same candidate pool (the one-shot
    advisor's answer held for the whole horizon), and search telemetry."""

    schedule: Schedule
    static: Schedule
    gain_pct: float  # 100 * (schedule.work - static.work) / static.work
    candidates: int  # placement pool size the DP searched over
    states_expanded: int  # DP states scored (beam telemetry)
    elapsed_s: float


def _phase_rate(machine, workload, placement, bank_assignment) -> float:
    return float(
        exact_objectives(
            machine,
            workload,
            np.asarray([placement], np.int32),
            bank_assignment=bank_assignment,
        )[0]
    )


def evaluate_schedule(
    machine: MachineSpec,
    phased: PhasedWorkload,
    placements: Sequence,
    *,
    bank_assignments: Sequence | None = None,
    model: MigrationModel | None = None,
) -> Schedule:
    """Score one explicit placement trajectory: per-phase steady-state
    rates through the grouped solver, transition stalls charged against
    the start of each following phase (a stall longer than the phase
    forfeits the whole phase, never goes negative)."""
    phased.validate()
    model = model or MigrationModel()
    n = phased.n_threads
    P = len(phased.phases)
    if len(placements) != P:
        raise ValueError(f"{len(placements)} placements for {P} phases")
    banks: list = list(bank_assignments) if bank_assignments else [None] * P
    if len(banks) != P:
        raise ValueError(f"{len(banks)} bank assignments for {P} phases")
    banks = [canonical_bank_assignment(machine, b) for b in banks]
    placements = [tuple(int(v) for v in p) for p in placements]

    rates, stalls, mts, mps = [], [], [], []
    total = 0.0
    for i, ph in enumerate(phased.phases):
        rate = _phase_rate(machine, ph.workload, placements[i], banks[i])
        if i:
            stall, mt, mp = transition_cost(
                machine, model, n,
                placements[i - 1], banks[i - 1], placements[i], banks[i],
            )
            stalls.append(stall)
            mts.append(mt)
            mps.append(mp)
        else:
            stall = 0.0
        total += rate * max(ph.duration - stall, 0.0)
        rates.append(rate)
    return Schedule(
        placements=tuple(placements),
        bank_assignments=tuple(banks),
        total_work=total,
        phase_rates=tuple(rates),
        transition_times=tuple(stalls),
        moved_threads=tuple(mts),
        moved_pages=tuple(mps),
    )


# ---------------------------------------------------------------------------
# Schedule search: candidate pool + DP/beam over phase boundaries
# ---------------------------------------------------------------------------


def _candidate_pool(
    machine: MachineSpec,
    phased: PhasedWorkload,
    per_phase: int,
    sweep_limit: int,
    seed: int,
) -> list[tuple[int, ...]]:
    """The shared placement pool the DP searches: each phase's top
    placements (exhaustive argsort when the composition space fits
    ``sweep_limit``, gradient search + heuristic seeds beyond), unioned
    across phases so "stay on another phase's best" is always a legal
    move and the static baseline is always reachable."""
    n = phased.n_threads
    pool: dict[tuple[int, ...], None] = {}
    small = count_placements(machine, n) <= sweep_limit
    if small:
        all_p = placement_array(machine, n)
    for ph in phased.phases:
        if small:
            scores = exact_objectives(machine, ph.workload, all_p)
            top = np.argsort(scores)[::-1][:per_phase]
            cands = [tuple(int(v) for v in all_p[i]) for i in top]
        else:
            best = optimize_placement(machine, ph.workload, seed=seed).placement
            cands = [tuple(int(v) for v in best)]
            cands += [
                tuple(int(v) for v in s)
                for s in _heuristic_seeds(machine, n)
            ]
            cands = cands[:per_phase]
        for c in cands:
            pool.setdefault(c, None)
    return list(pool)


class _State(NamedTuple):
    placement_idx: int
    banks: tuple[int, ...] | None
    work: float
    history: tuple  # ((placement_idx, banks, stall, mt, mp), ...) per phase


def optimize_schedule(
    machine: MachineSpec,
    phased: PhasedWorkload,
    *,
    model: MigrationModel | None = None,
    candidates_per_phase: int = 8,
    beam_width: int = 24,
    allow_page_placement: bool = True,
    sweep_limit: int = 20_000,
    seed: int = 0,
) -> ScheduleSearchResult:
    """Search per-phase placements jointly against the migration model.

    Two-stage: (1) build a shared candidate placement pool (per-phase
    top-k through the grouped solver, unioned across phases); (2) exact
    DP over phase boundaries on that pool, beam-pruned to ``beam_width``
    states per phase.  At every boundary each (state, next-placement)
    pair is expanded two ways: *migrate pages* (next phase runs
    node-local, pays thread + page bytes) and — when
    ``allow_page_placement`` — *leave pages behind*
    (:func:`follow_banks`: next phase pays remote Local traffic instead
    of the copy).  Rates for non-local bank states are scored lazily and
    memoized, so the exact solver runs once per distinct
    ``(phase, placement, banks)`` actually reached.

    The returned ``static`` schedule holds the pool's best fixed
    placement for the whole horizon — the one-shot advisor's answer —
    and ``gain_pct`` is the scheduler's improvement over it.  Since the
    constant trajectory is always in the DP's feasible set, ``gain_pct``
    is never negative.
    """
    phased.validate()
    model = model or MigrationModel()
    t0 = time.perf_counter()
    n = phased.n_threads
    P = len(phased.phases)
    pool = _candidate_pool(
        machine, phased, candidates_per_phase, sweep_limit, seed
    )
    pool_arr = np.asarray(pool, np.int32)

    # identity-bank rates: one batched grouped-solver call per phase
    base_rates = [
        exact_objectives(machine, ph.workload, pool_arr) for ph in phased.phases
    ]
    rate_memo: dict[tuple[int, int, tuple[int, ...]], float] = {}

    def rate_of(phase_i: int, j: int, banks) -> float:
        if banks is None:
            return float(base_rates[phase_i][j])
        key = (phase_i, j, banks)
        if key not in rate_memo:
            rate_memo[key] = _phase_rate(
                machine, phased.phases[phase_i].workload, pool[j], banks
            )
        return rate_memo[key]

    expanded = 0
    dur0 = phased.phases[0].duration
    beam = [
        _State(j, None, float(base_rates[0][j]) * dur0,
               ((j, None, 0.0, 0, 0),))
        for j in range(len(pool))
    ]
    beam.sort(key=lambda st: -st.work)
    beam = beam[: max(beam_width, 1)]
    expanded += len(pool)

    for i in range(1, P):
        dur = phased.phases[i].duration
        nxt: dict[tuple[int, tuple[int, ...] | None], _State] = {}
        for st in beam:
            for j in range(len(pool)):
                options: list[tuple[int, ...] | None] = [None]
                if allow_page_placement:
                    fb = follow_banks(
                        machine, n, pool[st.placement_idx], st.banks, pool[j]
                    )
                    if fb is not None:
                        options.append(fb)
                for banks in options:
                    stall, mt, mp = transition_cost(
                        machine, model, n,
                        pool[st.placement_idx], st.banks, pool[j], banks,
                    )
                    work = st.work + rate_of(i, j, banks) * max(
                        dur - stall, 0.0
                    )
                    expanded += 1
                    key = (j, banks)
                    if key not in nxt or work > nxt[key].work:
                        nxt[key] = _State(
                            j, banks, work,
                            st.history + ((j, banks, stall, mt, mp),),
                        )
        beam = sorted(nxt.values(), key=lambda st: -st.work)[: max(beam_width, 1)]

    best = beam[0]
    schedule = Schedule(
        placements=tuple(pool[j] for j, *_ in best.history),
        bank_assignments=tuple(b for _, b, *_ in best.history),
        total_work=best.work,
        phase_rates=tuple(
            rate_of(i, j, b) for i, (j, b, *_) in enumerate(best.history)
        ),
        transition_times=tuple(h[2] for h in best.history[1:]),
        moved_threads=tuple(h[3] for h in best.history[1:]),
        moved_pages=tuple(h[4] for h in best.history[1:]),
    )

    # best static trajectory over the same pool (no moves, no stalls).
    # float64 like the DP's python accumulation, so an identical
    # trajectory sums to the identical total and gain_pct is exactly 0.
    static_work = sum(
        np.asarray(base_rates[i], np.float64) * phased.phases[i].duration
        for i in range(P)
    )
    sj = int(np.argmax(static_work))
    static = Schedule(
        placements=(pool[sj],) * P,
        bank_assignments=(None,) * P,
        total_work=float(static_work[sj]),
        phase_rates=tuple(float(base_rates[i][sj]) for i in range(P)),
        transition_times=(0.0,) * (P - 1),
        moved_threads=(0,) * (P - 1),
        moved_pages=(0,) * (P - 1),
    )
    gain = 100.0 * (schedule.total_work - static.total_work) / max(
        static.total_work, 1e-30
    )
    return ScheduleSearchResult(
        schedule=schedule,
        static=static,
        gain_pct=gain,
        candidates=len(pool),
        states_expanded=expanded,
        elapsed_s=time.perf_counter() - t0,
    )
