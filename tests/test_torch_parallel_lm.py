"""Whole models on gloo ranks against the reference's own mesh runs: the
dense, SWA and mamba archs on a (2, 4) mesh (``data`` x ``model``),
prefill and 12 teacher-forced decode steps.

The reference (8 fake devices, ``tests/_torch_parallel.py``) initialises
each reduced arch's parameters under ``launch.mesh.cell_context``, runs
its jitted prefill step and decode steps there, and writes everything
out; the port's 8 ranks read the same tree through
``convert.lm_shards_from_reference`` (each rank its heads, KV heads,
``d_ff`` columns, mamba channels and vocabulary block; batch rows over
``data``) and run ``steps.make_prefill_step`` and ``make_decode_step``
under the port's ``cell_context``.  Tolerances are the single-device
parity tests' (``tests/test_torch_lm.py``): float32 logits within rel
1e-4 of their scale with equal greedy tokens, except falcon-mamba's
prefill at 2e-2 (the reference's prefill scan stores bf16); bf16 within
2e-2.  The reduced configs hold 4 heads and 2 KV heads, so each model
rank computes one head and the KV head it reads.  The ranks are also
held against the port's own no-mesh run of the same trees.  The MoE
archs are held in ``tests/test_torch_parallel_lm_moe.py``, jamba in
``tests/test_torch_parallel_lm_hybrid.py``.
"""

import pytest

from _torch_parallel import (
    LM_REF_BODY,
    LM_STEPS,
    check_against_port,
    check_lm_case,
    lm_case,
    lm_meta_log,
    lm_rank,
    run_ranks,
    run_reference,
)

ARCHS = ["llama3-8b", "gemma2-9b", "falcon-mamba-7b"]
CASES = [lm_case(a, d) for a in ARCHS for d in ("float32", "bfloat16")]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel_lm")
    ref = run_reference(LM_REF_BODY, CASES, tmp / "ref.npz", jobs=2)
    ranks = run_ranks(lm_rank, 8, tmp, CASES, str(tmp / "ref.npz"), LM_STEPS)
    return ref, ranks


@pytest.mark.parametrize("case", CASES, ids=[c["name"] for c in CASES])
def test_ranks_match_reference_mesh_run(runs, case):
    check_lm_case(*runs, case)


@pytest.mark.parametrize("case", CASES, ids=[c["name"] for c in CASES])
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
