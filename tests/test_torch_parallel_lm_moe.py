"""The MoE archs whole on gloo ranks against the reference's own mesh
runs, at the default capacity factor (1.25), where capacity binds:
qwen3-moe-30b-a3b on a (2, 4) mesh through the gather path, the
all-to-all path (``moe_impl="a2a"``; decode steps take the gather path,
as in the reference) and the no-gather decode path (forced in both
packages by a replication limit of nothing, so the expert weights stay
sharded over ``data``), and mixtral-8x22b on a (1, 8) mesh, where its 4
experts are each split over ``d_ff`` into 2 rows (``factor`` 2; the tree
is initialised under the mesh, and has no single-device counterpart).

Prefill and 12 teacher-forced decode steps, float32 within rel 1e-4 of
the logits' scale with equal greedy tokens, bf16 within 2e-2
(``tests/test_torch_parallel_lm.py``).  Each data shard routes its own 16
tokens at its own capacity (the a2a path a quarter of them, at its send
and second-level capacities); the qwen3 gather paths' dropped
assignments are checked to be nonzero.  At a capacity factor of 8 the qwen3 ranks are also held
against the port's own no-mesh run.
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

DTYPES = ("float32", "bfloat16")
QWEN3 = [lm_case("qwen3-moe-30b-a3b", d, impl=impl, nogather=impl == "nogather")
         for impl in ("gather", "a2a", "nogather") for d in DTYPES]
for c in QWEN3:  # the no-gather cases run the gather implementation's decode
    if c["nogather"]:
        c["fields"]["moe_impl"] = "gather"
CASES = QWEN3 + [lm_case("mixtral-8x22b", d, shape=(1, 8)) for d in DTYPES]
SELF = [at_factor_8(c) for c in QWEN3]
# The gather paths' 16 tokens a data shard overflow an expert's 10 slots;
# the a2a path's slices of 4 tokens stay within its floor of 4 send
# slots (tests/test_torch_parallel_moe.py holds a2a where it binds)
BINDS = [c for c in QWEN3 if c["fields"]["moe_impl"] == "gather"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel_lm_moe")
    ref = run_reference(LM_REF_BODY, CASES, tmp / "ref.npz", jobs=3)
    ranks = run_ranks(lm_rank, 8, tmp, CASES + SELF, str(tmp / "ref.npz"), LM_STEPS)
    return ref, ranks


@pytest.mark.parametrize("case", CASES, ids=[c["name"] for c in CASES])
def test_ranks_match_reference_mesh_run(runs, case):
    check_lm_case(*runs, case)
    if case in BINDS:
        assert sum(r[case["name"]]["dropped"] for r in runs[1]) > 0


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
