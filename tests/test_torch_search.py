"""The port's placement search (``repro_torch.core.numa.search``) against
the reference on the same machines and workloads, on the CPU.

Tolerances: the relaxed objective and a short ascent at rel 1e-4 (the
fill runs in float32 in another summation order); exact objectives at
rel 1e-5; the float64 bound tables at rel 1e-6.  Combinatorial receipts
(``optimal``, ``nodes_expanded``, evaluations) are compared exactly.  On a
symmetric machine permuted placements tie, so a placement that differs
from the reference's must score the reference's objective.

The reference's relaxed gradient is NaN for every input: each remote
path's diagonal capacity is ``inf``, so the unselected branch of the
fill's ``where(act > eps, resid / max(act, eps), inf)`` gets a
``0 * inf`` cotangent, and ``jnp.maximum``'s derivative multiplies it on
(``nan * 0 = nan``).  Its ascent therefore zeroes every gradient and
never leaves its starts.  The port follows JAX's derivative rule
(``simulator.jax_maximum``), so it returns the same NaN gradients and the
same placements; the tests below pin that, and a rule that merely masked
the cotangent would move the starts and fail them."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import CPU, assert_close, port_machine, port_workload, to_np

import repro.core.numa as ref
import repro.core.numa.search as ref_search
import repro_torch.core.numa as port
import repro_torch.core.numa.search as port_search
from repro.core.numa.benchmarks import benchmark_workload as ref_benchmark
from repro.core.numa.evaluate import enumerate_placements as ref_enumerate
from repro_torch.core.numa.simulator import jax_maximum, jax_minimum

# the two 4-node presets of the placement-search records
PRESETS = [("E7-4830v3-4s12c", 24), ("E5-2699v3-18c-snc2", 16)]
REL = 1e-5


@functools.lru_cache(maxsize=None)
def _pair(name, n, bench="CG"):
    m = ref.MACHINES[name]
    wl = ref_benchmark(bench, n)
    return m, wl, port_machine(m), port_workload(wl)


def _same_or_tie(pm, pwl, got_placement, want_placement, want_objective):
    """A placement equal to the reference's, or one the port scores at
    the reference's objective."""
    if tuple(got_placement) == tuple(want_placement):
        return
    obj = float(port_search.exact_objectives(pm, pwl, np.asarray([got_placement]))[0])
    assert obj == pytest.approx(want_objective, rel=REL), (got_placement, want_placement)


@pytest.mark.parametrize("name,n,bench", [
    ("E7-4830v3-4s12c", 24, "CG"), ("E7-8860v3-8s16c", 32, "Page rank"),
    ("E5-2630v3-8c-throttled", 8, "NPO"),
])
def test_relaxed_work_rate_and_gradient_match_reference(name, n, bench):
    m, wl, pm, pwl = _pair(name, n, bench)
    p = np.random.default_rng(0).dirichlet(np.ones(m.n_nodes)) * n
    want, want_grad = jax.jit(jax.value_and_grad(
        lambda q: ref_search.relaxed_work_rate(m, wl, q)
    ))(jnp.asarray(p, jnp.float32))
    q = torch.tensor(p, dtype=torch.float32, requires_grad=True)
    got = port_search.relaxed_work_rate(pm, pwl, q)
    (got_grad,) = torch.autograd.grad(got, q)
    assert float(got.detach()) == pytest.approx(float(want), rel=1e-4)
    want_grad, got_grad = np.asarray(want_grad), to_np(got_grad)
    np.testing.assert_array_equal(np.isfinite(got_grad), np.isfinite(want_grad))
    finite = np.isfinite(want_grad)
    np.testing.assert_allclose(got_grad[finite], want_grad[finite], rtol=1e-4)
    # batched rows are independent relaxed rates
    rows = torch.tensor(np.stack([p, p[::-1]]), dtype=torch.float32)
    batched = port_search.relaxed_work_rate(pm, pwl, rows)
    assert float(batched[0]) == pytest.approx(float(got.detach()), rel=1e-6)


def test_jax_extrema_follow_jax_derivative_rule():
    """Ties split the cotangent in half; a NaN cotangent is multiplied on,
    even into the argument that lost."""
    a = np.array([1.0, 2.0, 3.0], np.float32)
    b = np.array([1.0, 3.0, 2.0], np.float32)
    for jfn, tfn in [(jnp.maximum, jax_maximum), (jnp.minimum, jax_minimum)]:
        for ct in (np.array([1.0, 1.0, 1.0], np.float32), np.array([np.nan, 1, 1], np.float32)):
            want = jax.vjp(jfn, jnp.asarray(a), jnp.asarray(b))[1](jnp.asarray(ct))
            ta = torch.tensor(a, requires_grad=True)
            tb = torch.tensor(b, requires_grad=True)
            got = torch.autograd.grad(tfn(ta, tb), (ta, tb), torch.tensor(ct))
            for g, w in zip(got, want):
                np.testing.assert_array_equal(to_np(g), np.asarray(w))


def test_continuous_multiplicities_jacobian_matches_reference():
    """Dyadic node counts make both cumulative sums exact, so the class
    boundaries meet node boundaries in exact ties (at 0 and at n)."""
    classes, n = (0, 3, 7), 24
    p = np.array([9.5, 14.25, 0.125, 0.125], np.float32)
    want = np.asarray(jax.jacobian(
        lambda q: ref_search._continuous_multiplicities(classes, n, q))(jnp.asarray(p)))
    got = torch.autograd.functional.jacobian(
        lambda q: port_search._continuous_multiplicities(classes, n, q), torch.tensor(p))
    np.testing.assert_allclose(to_np(got), want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("name,n", PRESETS)
def test_three_step_ascent_matches_reference(name, n):
    m, wl, pm, pwl = _pair(name, n, "Page rank")
    classes = ref_search._classes_for(wl, None)
    logits0 = np.random.default_rng(2).normal(0.0, 1.5, (5, m.n_nodes)).astype(np.float32)
    want = np.asarray(ref_search._ascend_starts_jit(
        m, tuple(wl[1:]), jnp.asarray(logits0), classes, 3, 0.25, 0.25))
    got = to_np(port_search._ascend_starts(pm, pwl, logits0, classes, 3, 0.25, 0.25))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name,n,bench", [
    ("E7-4830v3-4s12c", 24, "CG"), ("E7-8860v3-8s16c", 32, "Page rank"),
    ("E5-2630v3-8c-mixed-dimm", 8, "Swim"),
])
def test_exact_objectives_match_reference(name, n, bench):
    m, wl, pm, pwl = _pair(name, n, bench)
    placements = np.asarray(ref_enumerate(m, n, max_placements=40, seed=1))
    assert_close(port_search.exact_objectives(pm, pwl, placements),
                 ref_search.exact_objectives(m, wl, placements), rtol=REL)
    banks = tuple(range(m.n_nodes))[::-1]  # every Local page on the mirror node
    assert_close(port_search.exact_objectives(pm, pwl, placements[:9], bank_assignment=banks),
                 ref_search.exact_objectives(m, wl, placements[:9], bank_assignment=banks),
                 rtol=REL)


@pytest.mark.parametrize("name,n,bench", [
    ("E7-4830v3-4s12c", 24, "CG"), ("E7-8860v3-8s16c", 32, "Page rank"),
    ("E5-2630v3-8c-throttled", 8, "NPO"),
])
def test_placement_upper_bound_matches_reference_and_is_admissible(name, n, bench):
    m, wl, pm, pwl = _pair(name, n, bench)
    placements = np.asarray(ref_enumerate(m, n, max_placements=200, seed=3))
    got = port_search.placement_upper_bound(pm, pwl, placements)
    assert_close(got, ref_search.placement_upper_bound(m, wl, placements), rtol=1e-6)
    exact = port_search.exact_objectives(pm, pwl, placements)
    assert (got >= exact * (1 - REL)).all()


def test_heuristic_seeds_match_reference():
    for name in ref.MACHINES:
        m = ref.MACHINES[name]
        n = m.n_nodes * m.cores_per_node // 2
        want = ref_search._heuristic_seeds(m, n)
        got = port_search._heuristic_seeds(port_machine(m), n)
        assert [tuple(p) for p in got] == [tuple(p) for p in want]


@functools.lru_cache(maxsize=None)
def _exhaustive_best(name, n):
    _, _, pm, pwl = _pair(name, n)
    table = port.evaluate.placement_array(pm, n)
    return float(port_search.exact_objectives(pm, pwl, table).max())


@pytest.mark.parametrize("name,n", PRESETS)
def test_optimize_placement_matches_reference(name, n):
    m, wl, pm, pwl = _pair(name, n)
    want = ref_search.optimize_placement(m, wl)
    got = port_search.optimize_placement(pm, pwl)
    assert got.objective == pytest.approx(want.objective, rel=REL)
    _same_or_tie(pm, pwl, got.placement, want.placement, want.objective)
    assert got.objective >= _exhaustive_best(name, n) * (1 - REL)  # 0% regret
    assert got.nodes_expanded == 0 and not got.optimal


@pytest.mark.parametrize("name,n", PRESETS)
def test_branch_and_bound_matches_reference(name, n):
    m, wl, pm, pwl = _pair(name, n)
    for kw in ({}, {"gap": 0.01, "seed_placements": [np.asarray([n // m.n_nodes] * m.n_nodes)]}):
        want = ref_search.branch_and_bound(m, wl, **kw)
        got = port_search.branch_and_bound(pm, pwl, **kw)
        assert (got.optimal, got.nodes_expanded, got.evaluations) == (
            want.optimal, want.nodes_expanded, want.evaluations)
        assert got.objective == pytest.approx(want.objective, rel=REL)
        _same_or_tie(pm, pwl, got.placement, want.placement, want.objective)
        assert got.objective >= _exhaustive_best(name, n) * (1 - REL)  # 0% regret


def test_tight_sixteen_node_receipts():
    """The bandwidth-starved 16-node SNC machine of the reference's search
    tests: cold B&B spends its whole 4,000-node budget without a
    certificate; the advisor's warm start certifies at the root."""
    scale = 0.27
    m16 = port.make_machine(
        "snc2-8s-tight", sockets=8, cores_per_socket=8, nodes_per_socket=2,
        qpi_bw=25.6e9 * scale, core_rate=(2.4e9, 1.6e9) * 8,
        local_read_bw=(52e9 * scale, 26e9 * scale) * 8,
        local_write_bw=(28e9 * scale, 14e9 * scale) * 8,
    )
    wl = port.benchmarks.benchmark_workload("CG", 48, device=CPU)
    cold = port_search.branch_and_bound(m16, wl, gap=0.0, max_nodes=4000)
    warm = port_search.branch_and_bound(m16, wl, gap=0.0, max_nodes=4000, advisor_seeds=8)
    assert not cold.optimal and cold.nodes_expanded == 4000
    assert warm.optimal and warm.nodes_expanded == 0
    assert warm.objective > cold.objective * 1.01
    p = np.asarray(warm.placement)
    assert p.sum() == 48 and (p >= 0).all() and (p <= m16.cores_per_node).all()


def test_advisor_warm_seeds_match_reference():
    m, wl, pm, pwl = _pair("E7-4830v3-4s12c", 24)
    want = ref_search.advisor_warm_seeds(m, wl, top_k=6)
    got = port_search.advisor_warm_seeds(pm, pwl, top_k=6)
    assert len(got) == len(want) == 6
    # the seeds rank by a float32 roofline: tied seeds may come permuted
    assert_close(port_search.exact_objectives(pm, pwl, np.stack(got)),
                 ref_search.exact_objectives(m, wl, np.stack(want)), rtol=REL)
    odd = port.benchmarks.benchmark_workload("CG", 10, device=CPU)
    assert port_search.advisor_warm_seeds(pm, odd) == []  # no symmetric profiling run


def test_search_rejects_overfull_budget():
    _, _, pm, _ = _pair("E5-2699v3-18c-snc2", 16)
    big = port.benchmarks.benchmark_workload("CG", 80, device=CPU)
    with pytest.raises(ValueError, match="do not fit"):
        port_search.branch_and_bound(pm, big)
    with pytest.raises(ValueError, match="do not fit"):
        port_search.optimize_placement(pm, big)
