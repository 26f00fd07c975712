"""jamba-1.5-large-398b reduced (attention, mamba and MoE layers, 16 of
them) on gloo ranks against the reference's own (2, 4) mesh run: prefill
and 12 teacher-forced decode steps, as ``tests/test_torch_parallel_lm.py``
holds the other archs (its own file: the reference's jamba compiles take
most of a file's time).

float32 at the mamba archs' tolerances (prefill 2e-2 for the reference's
bf16 prefill scan, decode rel 1e-4 with equal tokens and a float32
cache); bf16 with the routers zeroed on both sides at 4e-2, with the
float32 conv window and state of ``tests/test_torch_lm.py``
(``model.routing_feeds_state``).  The default capacity factor binds: each
data shard routes its own 16 tokens.  The port's ranks are also held
against its own no-mesh run at a capacity factor of 8.
"""

import pytest

from _torch_parallel import (
    LM_REF_BODY,
    LM_STEPS,
    at_factor_8,
    check_against_port,
    check_lm_case,
    lm_case,
    lm_meta_log,
    lm_rank,
    run_ranks,
    run_reference,
)

CASES = [lm_case("jamba-1.5-large-398b", d) for d in ("float32", "bfloat16")]
SELF = [at_factor_8(c) for c in CASES]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel_lm_hybrid")
    ref = run_reference(LM_REF_BODY, CASES, tmp / "ref.npz", jobs=2)
    ranks = run_ranks(lm_rank, 8, tmp, CASES + SELF, str(tmp / "ref.npz"), LM_STEPS)
    return ref, ranks


@pytest.mark.parametrize("case", CASES, ids=[c["name"] for c in CASES])
def test_ranks_match_reference_mesh_run(runs, case):
    check_lm_case(*runs, case)
    assert sum(r[case["name"]]["dropped"] for r in runs[1]) > 0  # the capacity binds


@pytest.mark.parametrize("case", SELF, ids=[c["name"] for c in SELF])
def test_ranks_match_port_without_mesh(runs, case):
    check_against_port(*runs, case)


@pytest.mark.parametrize("case", CASES, ids=[c["name"] for c in CASES])
def test_meta_ranks_run_the_gloo_ranks_collectives(runs, case):
    """The counter source's rank (``meta`` tensors, a layout-only mesh,
    this process, nothing run) calls exactly the collectives the gloo
    rank ran, in order: the prefill's and the first decode step's, at
    ranks 0 and 7."""
    ref, ranks = runs
    shape = ref[f"{case.get('tree', case['name'])}/tokens"].shape
    for rank in (0, 7):
        assert lm_meta_log(case, rank, shape) == ranks[rank][case["name"]]["log"], rank
