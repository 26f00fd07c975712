"""Training across ranks: the port's ``make_train_step`` on gloo ranks
against the reference's own jitted mesh train step on 8 devices
(``Auto`` axes, parameters placed by ``tree_shardings``), three steps on
one batch of 8 x 16 tokens.

Cases: reduced llama3-8b (dense) on (2, 4) and (2, 2, 2) (a ``pod``
axis) in float32, and on (1, 8) in bf16 (4 query heads on 8 model
ranks, each head's ranks splitting its rows of ``wo``; 2 KV heads held
by 4 ranks each); qwen3-moe-30b-a3b through the gather path at the
default capacity factor, which binds (each data shard routes its own
rows), and through the all-to-all path at a factor of 8, where nothing
drops; falcon-mamba-7b on (2, 2, 2) with the reference's training scan
made float32 by a shim (as ``tests/test_torch_train.py`` does); accum 1
and 2.  Dense weights lie in FSDP shards over ``data``, experts over
``data`` and ``model``.

Also ``loss_fn``'s gradients by ``backward`` on the shards (the path
``cast_for_compute`` takes under autograd, with its FSDP gathers) against
one device's, in float32 at a capacity factor of 8 with the balance
loss's weight 0.

What is held: the loss, ``grad_norm``, ``lr`` and (at accum 1) the
``nll``, ``aux`` and ``lse`` histories, and every parameter after the
steps gathered from the ranks; float32 within rel 1e-4 (of each leaf's
largest magnitude for the parameters), bf16 within 2e-2.  The learning
rate is 3e-4: AdamW moves an element whose gradient is near rounding
noise by up to the learning rate whatever its sign, so the parameters of
two float32 runs that add in other orders part by a share of the
learning rate that grows with it (past 1e-4 of a leaf's scale at 1e-3 in
a qwen3 case).  Every rank reports the same history.  The dense and mamba ranks, and qwen3 on a (1, 4) mesh (no
data split, so its per-shard balance loss and capacities are one
device's) at factor 8, are also held against the port's own no-mesh
steps on the same tree.
"""

import pytest

from _torch_parallel import (
    F32_RTOL,
    TRAIN_REF_BODY,
    assert_history,
    assert_params,
    port_gradients_without_mesh,
    port_train_without_mesh,
    reference_history,
    run_ranks,
    run_reference,
    train_case,
    train_meta_log,
    train_rank,
)

CASES = [
    train_case("llama3-8b", "float32", (2, 4)),
    train_case("llama3-8b", "float32", (2, 2, 2), accum=2),
    train_case("llama3-8b", "bfloat16", (1, 8), accum=2),
    train_case("qwen3-moe-30b-a3b", "float32", (2, 4), accum=2),
    train_case("qwen3-moe-30b-a3b", "float32", (2, 4), impl="a2a", cf=8.0),
    train_case("falcon-mamba-7b", "float32", (2, 2, 2), accum=2),
]
BINDS = [c for c in CASES if c["moe"] and c["fields"]["capacity_factor"] < 8]
# the ranks against the port's own no-mesh steps on the same tree: the
# dense and mamba archs on their meshes, and qwen3 at a capacity factor of
# 8 on a (1, 4) mesh, where no data axis splits its balance loss
SELF = [dict(c, name=c["name"] + "-self", tree=c["name"]) for c in CASES
        if not c["moe"] and c["fields"]["compute_dtype"] == "float32"]
QWEN3_SELF = [dict(CASES[4], name="qwen3-1-4-gather-cf8-self", tree=CASES[4]["name"],
                   shape=[1, 4], fields=dict(CASES[4]["fields"], moe_impl="gather"))]


def _grad_case(case: dict, shape=None, **fields) -> dict:
    """``loss_fn``'s gradients by ``backward`` on the shards of ``case``'s
    tree (float32, capacity factor 8, the balance loss's weight 0, so a
    mesh computes one device's function) against the port's no-mesh
    gradients."""
    shape = shape or case["shape"]
    fields = dict(case["fields"], compute_dtype="float32", capacity_factor=8.0, **fields)
    tag = "-".join(str(v) for v in shape)
    name = f"{case['arch']}-{tag}-{fields['moe_impl'] if case['moe'] else 'dense'}-grads"
    return dict(case, name=name, tree=case["name"], shape=list(shape), fields=fields,
                aux_weight=0.0, tol=F32_RTOL)


GRADS = [_grad_case(CASES[0]), _grad_case(CASES[0], (1, 8)), _grad_case(CASES[3]),
         _grad_case(CASES[4]), _grad_case(CASES[5])]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel_train")
    ref = run_reference(TRAIN_REF_BODY, CASES, tmp / "ref.npz", jobs=3)
    ranks = run_ranks(train_rank, 8, tmp, CASES + SELF + GRADS, str(tmp / "ref.npz"))
    four = run_ranks(train_rank, 4, tmp, QWEN3_SELF, str(tmp / "ref.npz"))
    return ref, ranks, four


def _check_ranks_agree(ranks: list, name: str) -> None:
    for r, got in enumerate(ranks):
        assert got[name]["hist"] == ranks[0][name]["hist"], (name, r)


@pytest.mark.parametrize("case", CASES, ids=[c["name"] for c in CASES])
def test_train_steps_match_reference_mesh_run(runs, case):
    ref, ranks, _ = runs
    name = case["name"]
    _check_ranks_agree(ranks, name)
    got = ranks[0][name]
    assert_history(got["hist"], reference_history(ref, name), case["tol"], name)
    assert got["hist"]["loss"][-1] < got["hist"]["loss"][0], got["hist"]["loss"]
    prefix = f"{name}/final/"
    want = {k[len(prefix):]: v for k, v in ref.items() if k.startswith(prefix)}
    assert_params(got["final"], want, case["tol"], name)
    if case in BINDS:
        assert sum(r[name]["dropped"] for r in ranks) > 0  # the capacity binds


@pytest.mark.parametrize("case", SELF + QWEN3_SELF, ids=[c["name"] for c in SELF + QWEN3_SELF])
def test_train_steps_match_port_without_mesh(runs, case):
    ref, ranks, four = runs
    ranks = four if case in QWEN3_SELF else ranks
    name = case["name"]
    _check_ranks_agree(ranks, name)
    want = port_train_without_mesh(ref, case)
    assert_history(ranks[0][name]["hist"], want["hist"], case["tol"], name)
    assert_params(ranks[0][name]["final"], want["final"], case["tol"], name)
    assert ranks[0][name]["dropped"] == 0



@pytest.mark.parametrize("case", GRADS, ids=[c["name"] for c in GRADS])
def test_mesh_backward_gives_one_devices_gradient(runs, case):
    """A mesh forward under autograd (the FSDP gathers and ``fan_out`` of
    ``cast_for_compute``, the layers' collectives): every leaf's gradient
    gathered from the shards is one device's within rel 1e-4 of its
    scale: KV heads held by several ranks, a query head split over
    ``wo``'s rows on (1, 8), the router on both MoE paths, mamba's
    channels over a ``pod`` axis."""
    ref, ranks, _ = runs
    want = port_gradients_without_mesh(ref, case)
    assert_params(ranks[0][case["name"]]["grads"], want, F32_RTOL, case["name"])


@pytest.mark.parametrize("case", CASES, ids=[c["name"] for c in CASES])
def test_meta_ranks_run_the_gloo_ranks_collectives(runs, case):
    """The counter source's rank (``meta`` tensors, a layout-only mesh,
    this process, nothing run) calls exactly the collectives the gloo
    rank's first train step ran, in order, backward included, at ranks 0
    and 7."""
    ref, ranks, _ = runs
    B, S1 = ref[f"{case['name']}/tokens"].shape
    for rank in (0, 7):
        assert train_meta_log(case, rank, (B, S1 - 1)) == ranks[rank][case["name"]]["log"], rank
