"""The port's mesh context, mesh helpers, cuts and serving across ranks
(``repro_torch.parallel.context``, ``repro_torch.launch.mesh``,
``repro_torch.convert``, ``repro_torch.launch.serve --mesh``).

* The logical-axis helpers (``resolve``, ``divisible_batch_axes``,
  ``axis_size``, the ``cell_context`` overrides) and
  ``candidate_mesh_axes`` against the reference's, on abstract meshes of
  (2, 4), (1, 8), (4, 2) and (2, 2, 2) (they read only a mesh's axis names
  and sizes); the replication decision is pinned either way by patching
  both packages' limits, as the reference's own test does.
* The cuts on a layout-only mesh (no process group): every rank's heads,
  KV heads, mamba channels, vocabulary block and expert rows, and the
  decode cache's shapes.
* On 8 gloo ranks (``tests/_torch_parallel.py``): the collectives' sums,
  orders and all-to-all blocks on (2, 4) and (2, 2, 2) meshes; the
  production meshes; reference trees (mixtral's split experts among them)
  cut to each rank's shards by ``convert.lm_shards_from_reference`` and
  gathered back by ``lm_params_to_reference`` bit for bit; float32
  generation on (2, 4) and (1, 8) meshes equal to one device's; and
  ``serve.main(["--mesh", "single"])``, whose rank 0 alone prints.
"""

import contextlib
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from _torch_parallel import _flat, context_rank, run_ranks
from repro.configs.base import SHAPES as REF_SHAPES
from repro.configs.base import get_config as ref_get_config
from repro.launch import mesh as ref_mesh
from repro.models import model as RM
from repro.parallel import context as ref_ctx
from repro_torch.configs.base import ShapeConfig, get_config
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import model as M
from repro_torch.parallel import context as ctx

SHAPES_2D = [(2, 4), (1, 8), (4, 2), (8, 1)]
LOGICAL = ("batch", "fsdp", "dp_all", "tp", "expert", "efsdp", "seq", "cache_batch", "cache_seq")


def _names(shape):
    return ("data", "model") if len(shape) == 2 else ("pod", "data", "model")


def _meshes(shape):
    """The reference's abstract mesh and the port's layout-only mesh."""
    return AbstractMesh(shape, _names(shape)), ctx.Mesh(_names(shape), shape)


def _ref_resolve(*dims):
    return tuple(ref_ctx.resolve(*dims))


@pytest.mark.parametrize("shape", SHAPES_2D + [(2, 2, 2)], ids=str)
def test_logical_helpers_match_reference(shape):
    ref, port = _meshes(shape)
    with ref_ctx.use_mesh(ref), ctx.use_mesh(port):
        assert ctx.resolve(*LOGICAL, None) == _ref_resolve(*LOGICAL, None)
        for dim in LOGICAL:
            assert ctx.axis_size(dim) == ref_ctx.axis_size(dim), dim
            assert ctx.physical_axes(dim) == ref_ctx.physical_axes(dim), dim
        for n in range(1, 17):
            assert ctx.divisible_batch_axes(n) == ref_ctx.divisible_batch_axes(n), n
        with ctx.use_logical_rules(tp=("model", "data")), \
                ref_ctx.use_logical_rules(tp=("model", "data")):
            assert ctx.resolve("tp", "fsdp") == _ref_resolve("tp", "fsdp")
        assert ctx.resolve("tp") == _ref_resolve("tp")  # restored
    assert ctx.current_mesh() is None and ctx.resolve("batch") == ()
    assert ctx.axis_size("tp") == 1 and ctx.divisible_batch_axes(4) == ()


@pytest.mark.parametrize("replicated", [True, False])
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_cell_context_overrides_match_reference(monkeypatch, kind, replicated):
    monkeypatch.setattr(ref_mesh, "SERVE_REPLICATION_LIMIT", 1 << 60 if replicated else 1)
    monkeypatch.setattr(mesh_lib, "SERVE_REPLICATION_SHARE", 1e9 if replicated else 0.0)
    for shape in SHAPES_2D + [(2, 2, 2)]:
        for batch in (1, 2, 4, 6, 8):
            ref, port = _meshes(shape)
            ref_cell = ref_mesh.cell_context(
                ref, ref_get_config("qwen3-moe-30b-a3b"),
                dataclasses.replace(REF_SHAPES["decode_32k"], kind=kind, global_batch=batch))
            port_cell = mesh_lib.cell_context(
                port, get_config("qwen3-moe-30b-a3b"), ShapeConfig("c", 64, batch, kind))
            # a decode cell of weights not replicated adds the rules the
            # reference's serve_decode_param_shardings cuts its weights by
            two_d = ref_ctx.use_logical_rules(fsdp=(), tp=("model", "data")) if (
                kind == "decode" and not replicated) else contextlib.nullcontext()
            with ref_cell, port_cell, two_d:
                assert ctx.resolve(*LOGICAL) == _ref_resolve(*LOGICAL), (shape, batch)
            assert ctx.current_mesh() is None


def test_serve_replication_decision():
    """bf16 weights over the model ranks against a quarter of the card:
    llama3-8b's 16 GB replicate on one rank, qwen3-moe-30b-a3b's 61 GB
    only from 4 model ranks on."""
    assert mesh_lib.serve_params_replicated(get_config("llama3-8b"))
    qwen3 = get_config("qwen3-moe-30b-a3b")
    assert not mesh_lib.serve_params_replicated(qwen3)
    assert mesh_lib.serve_params_replicated(qwen3, tp=4)


@pytest.mark.parametrize("n", list(range(1, 33)))
def test_candidate_mesh_axes_match_reference(n):
    assert mesh_lib.candidate_mesh_axes(n) == ref_mesh.candidate_mesh_axes(n)
    kw = dict(axis_names=("pod", "model"), min_model=2, max_model=6)
    try:
        want = ref_mesh.candidate_mesh_axes(n, **kw)
    except ValueError as e:
        with pytest.raises(ValueError, match="no factorization"):
            mesh_lib.candidate_mesh_axes(n, **kw)
        assert "no factorization" in str(e)
    else:
        assert mesh_lib.candidate_mesh_axes(n, **kw) == want


def test_mesh_layout():
    m = ctx.Mesh(("pod", "data", "model"), (2, 2, 2), rank=6)
    assert m.coords() == {"pod": 1, "data": 1, "model": 0}
    assert m.axis_index(("pod", "data")) == 3
    assert m.axis_index(("data", "pod"), rank=4) == 1  # in the order given, as jax's
    assert m.axis_index(("pod", "data"), rank=4) == 2
    assert m.axis_index(("model",)) == 0 and m.axes_size(("data", "model", "seq")) == 4
    assert [m.coords(r)["model"] for r in range(8)] == [0, 1] * 4
    with pytest.raises(RuntimeError, match="layout-only"):
        m.group(("model",))
    with pytest.raises(ValueError):
        ctx.Mesh(("data", "model"), (2, 4), rank=8)
    with pytest.raises(ValueError):
        ctx.Mesh(("data", "data"), (2, 4))


def _cut(cfg, shape, rank, rules=None):
    """Every leaf's shape in ``rank``'s shards of a float32 model on a
    layout-only mesh."""
    cfg = dataclasses.replace(cfg, compute_dtype="float32")
    mesh = ctx.Mesh(_names(shape), shape, rank)
    with ctx.use_mesh(mesh), ctx.use_logical_rules(**(rules or {})):
        lm = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
        local = mesh_lib.shard_params(cfg, lm)
        cache = M.init_cache(cfg, 4, 8, torch.float32, device="cpu")
    return lm, local, cache


@pytest.mark.parametrize("shape", [(2, 4), (1, 8)], ids=str)
def test_attention_cut_by_heads(shape):
    """4 heads, 2 KV heads of 16: on 4 model ranks one head each and the
    KV head it reads; on 8 half a head's rows of ``wo`` each.  Under the
    default rules (``fsdp`` on ``data``) each dense matrix's ``d_model``
    dim is also cut over ``data``.  The decode cache (default rules: rows
    over ``data``, slots over ``model``) holds every KV head."""
    cfg = get_config("llama3-8b").reduced()
    dp, tp = shape
    for rank in range(8):
        lm, local, cache = _cut(cfg, shape, rank)
        i, j = rank % tp, rank // tp
        d = slice(j * 64 // dp, (j + 1) * 64 // dp)  # this data rank's d_model block
        head = i * 4 // tp
        mix, whole = local.layers[0].mixer, lm.layers[0].mixer
        assert torch.equal(mix.wq, whole.wq[d, head * 16 : (head + 1) * 16])
        assert torch.equal(mix.wk, whole.wk[d, head // 2 * 16 : (head // 2 + 1) * 16])
        rows = 64 // tp
        assert torch.equal(mix.wo, whole.wo[i * rows : (i + 1) * rows, d])
        assert torch.equal(local.embed.table,
                           lm.embed.table[i * 512 // tp : (i + 1) * 512 // tp, d])
        assert torch.equal(local.lm_head, lm.lm_head[d, i * 512 // tp : (i + 1) * 512 // tp])
        assert torch.equal(local.layers[0].ffn.w_down,
                           lm.layers[0].ffn.w_down[i * 128 // tp : (i + 1) * 128 // tp, d])
        assert local.layers[0].norm1 is lm.layers[0].norm1  # replicated leaves are shared
        # the cache: rows over data, a block of the 8 slots over model, both KV heads
        assert tuple(cache[0].k.shape) == (4 // dp, 8 // tp, 2, 16) and cache[0].length == 8
    # a serving cell that replicates the model over data cuts by heads alone
    _, local, _ = _cut(cfg, shape, 0, rules=dict(fsdp=()))
    assert tuple(local.layers[0].mixer.wq.shape) == (64, 16)


def test_mamba_cut_by_channel():
    """``in_proj``'s x and z halves each by channel; ``x_proj`` and
    ``out_proj`` by rows; the cache's channels; ``in_proj``'s and
    ``out_proj``'s ``d_model`` dim over ``data`` (``fsdp``)."""
    cfg = get_config("falcon-mamba-7b").reduced()
    di = cfg.d_inner
    for rank in range(8):
        lm, local, cache = _cut(cfg, (2, 4), rank)
        ch = slice(rank % 4 * di // 4, (rank % 4 + 1) * di // 4)
        d = slice(rank // 4 * 32, (rank // 4 + 1) * 32)
        mix, whole = local.layers[0].mixer, lm.layers[0].mixer
        xz = torch.cat([whole.in_proj[d, :di][:, ch], whole.in_proj[d, di:][:, ch]], dim=1)
        assert torch.equal(mix.in_proj, xz)
        assert torch.equal(mix.x_proj, whole.x_proj[ch]) and torch.equal(mix.A_log, whole.A_log[ch])
        assert torch.equal(mix.conv_w, whole.conv_w[:, ch])
        assert torch.equal(mix.dt_proj, whole.dt_proj[:, ch])
        assert torch.equal(mix.out_proj, whole.out_proj[ch, d])
        assert tuple(cache[0].conv.shape) == (2, cfg.ssm_conv - 1, di // 4)
        assert tuple(cache[0].ssm.shape) == (2, di // 4, cfg.ssm_state)


def test_expert_cut_rows_and_efsdp():
    """Expert rows over ``model``, their ``d_model`` dim over ``efsdp``
    (``data``); mixtral's 4 experts pre-split into 8 rows on (1, 8)."""
    for rank in range(8):
        lm, local, _ = _cut(get_config("qwen3-moe-30b-a3b").reduced(), (2, 4), rank)
        d = rank // 4
        ffn, whole = local.layers[0].ffn, lm.layers[0].ffn
        assert torch.equal(ffn.w_gate, whole.w_gate[rank % 4 : rank % 4 + 1, d * 32 : (d + 1) * 32])
        assert torch.equal(ffn.w_down, whole.w_down[rank % 4 : rank % 4 + 1, :, d * 32 : (d + 1) * 32])
        assert ffn.router is whole.router
        lm, local, _ = _cut(get_config("mixtral-8x22b").reduced(), (1, 8), rank)
        assert tuple(lm.layers[0].ffn.w_up.shape) == (8, 64, 64)  # factor 2
        assert torch.equal(local.layers[0].ffn.w_up, lm.layers[0].ffn.w_up[rank : rank + 1])


def test_cuts_refuse_splits_that_do_not_divide():
    cfg = dataclasses.replace(get_config("llama3-8b").reduced(), n_heads=6, n_kv_heads=2)
    with pytest.raises(ValueError, match="heads"):
        _cut(cfg, (1, 4), 0)
    with pytest.raises(ValueError, match="experts"):
        _cut(get_config("qwen3-moe-30b-a3b").reduced(), (1, 3), 0)
    moe_cfg = dataclasses.replace(get_config("qwen3-moe-30b-a3b").reduced(), moe_impl="a2a")
    with ctx.use_mesh(ctx.Mesh(("data", "model"), (1, 4))), torch.no_grad():
        from repro_torch.models import moe as moe_mod

        p = moe_mod.init_moe_params(moe_cfg, torch.Generator().manual_seed(0), torch.float32,
                                    "cpu")
        with pytest.raises(ValueError, match="sequence"):
            moe_mod.moe_apply(moe_cfg, p, torch.zeros(1, 6, 64))


def test_train_mesh_still_raises(tmp_path):
    """Training runs across ranks now (``tests/test_torch_parallel_train.py``);
    what still raises is a mesh the job cannot form: ``--mesh multi``
    (two pods) in a job of one rank."""
    import torch.distributed as dist

    from repro_torch.launch import train

    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
                            world_size=1)
    try:
        with pytest.raises(ValueError, match="do not split into 2 pod"):
            train.main(["--reduced", "--device", "cpu", "--mesh", "multi",
                        "--ckpt-dir", str(tmp_path / "ckpt")])
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# On 8 gloo ranks
# ---------------------------------------------------------------------------

ROUND_TRIPS = [
    dict(name="mixtral-1-8", arch="mixtral-8x22b", shape=[1, 8], fields={}),
    dict(name="qwen3-2-4", arch="qwen3-moe-30b-a3b", shape=[2, 4], fields={}),
    dict(name="jamba-2-4", arch="jamba-1.5-large-398b", shape=[2, 4], fields={}),
    dict(name="gemma2-2-4", arch="gemma2-9b", shape=[2, 4], fields={}),
]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel_context")
    trees = {}
    for case in ROUND_TRIPS:
        cfg = ref_get_config(case["arch"]).reduced()
        with ref_ctx.use_mesh(AbstractMesh(tuple(case["shape"]), ("data", "model"))):
            tree = RM.init_params(cfg, jax.random.PRNGKey(0))  # split experts under the mesh
        trees.update(_flat(jax.tree.map(np.asarray, tree), case["name"] + "/"))
    np.savez(tmp / "trees.npz", **trees)
    return trees, run_ranks(context_rank, 8, tmp, str(tmp / "trees.npz"), ROUND_TRIPS)


def test_collectives(ranks):
    _, out = ranks
    for r, got in enumerate(out):
        data, model = divmod(r, 4)
        assert got["psum_model"] == sum(4 * data + m + 1 for m in range(4))
        assert got["pmean_data"] == (model + 1 + model + 5) / 2
        assert got["gather_data"] == [model + 1, model + 5]
        assert got["a2a_model"] == [10.0 * (4 * data + i) + model for i in range(4)]
        assert got["bf16_psum"] == 4 * (1 + 2**-7)
        pod, d, m = divmod(r, 4)[0], divmod(r, 2)[0] % 2, r % 2
        assert got["coords_222"] == {"pod": pod, "data": d, "model": m}
        assert got["index_pod_data"] == 2 * pod + d
        assert got["gather_data_pod"] == [m + 1, m + 5, m + 3, m + 7]  # data-major order


def test_production_meshes(ranks):
    for got in ranks[1]:
        assert got["single"] == (1, 8)
        assert got["multi"] == {"pod": 2, "data": 2, "model": 2}
        assert "do not split" in got["multi_8"]


@pytest.mark.parametrize("case", ROUND_TRIPS, ids=[c["name"] for c in ROUND_TRIPS])
def test_reference_tree_round_trip_through_rank_shards(ranks, case):
    """Each rank holds its cut; gathered back, the tree is the reference's
    bit for bit, split experts included."""
    trees, out = ranks
    prefix = case["name"] + "/"
    want = {k[len(prefix):]: v for k, v in trees.items() if k.startswith(prefix)}
    got = out[0][case["name"]]
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    for got in out:  # each rank held its block of the vocabulary
        assert got[case["name"] + "/local"]["embed.table"][0] == 512 // case["shape"][1]


def test_float32_generation_across_ranks_equals_one_device(ranks):
    from repro_torch.launch.serve import generate

    cfg = dataclasses.replace(get_config("llama3-8b").reduced(), compute_dtype="float32")
    gen = torch.Generator()
    params = M.init_params(cfg, gen.manual_seed(0), device="cpu")
    prompts = torch.randint(0, cfg.vocab_size, (4, 8), generator=gen.manual_seed(1))
    want = generate(cfg, params, prompts, 16, 8, device="cpu").numpy()
    for got in ranks[1]:
        np.testing.assert_array_equal(got["f32_2x4"], want)
        np.testing.assert_array_equal(got["f32_1x8"], want)


def _first_row_logits(cfg, prompt_len: int, gen: int) -> list[torch.Tensor]:
    """The bf16 logits of the first sequence at each step of what
    ``serve.main(["--reduced", "--device", "cpu"])`` runs: its weights and
    prompts (seeds 0 and 1), teacher-forced and then greedy."""
    from repro_torch.launch import steps as steps_lib

    g = torch.Generator()
    params = M.cast_for_compute(cfg, M.init_params(cfg, g.manual_seed(0), device="cpu",
                                                   compute=True))
    prompts = torch.randint(0, cfg.vocab_size, (4, prompt_len), generator=g.manual_seed(1),
                            dtype=torch.int32)
    cache = M.init_cache(cfg, 4, prompt_len + gen, torch.bfloat16, device="cpu")
    step = steps_lib.make_decode_step(cfg, cast=False)
    tok, logits = prompts[:, :1], []
    for t in range(prompt_len + gen - 1):
        nxt, lg, cache = step(params, cache, tok, t)
        logits.append(lg[0])
        tok = prompts[:, t + 1 : t + 2] if t + 1 < prompt_len else nxt[:, None]
    return logits


def test_serve_cli_across_ranks(ranks, capsys):
    """``--mesh single`` on 8 ranks prints, from rank 0 alone, the first
    sequence of ``--mesh none``: token for token up to the first
    difference, if any, and there the no-mesh run's two best bf16 logits
    lie within one bf16 ulp and the ranks chose the runner-up (the ranks
    add their partial sums in another order, so a one-ulp tie may break
    the other way; float32 generation across ranks equals one device's,
    ``test_float32_generation_across_ranks_equals_one_device``)."""
    from repro_torch.launch import serve

    serve.main(["--reduced", "--device", "cpu"])
    none = capsys.readouterr().out
    first = [ln for ln in ranks[1][0]["printed"].splitlines() if ln.startswith("first sequence")]
    assert len(first) == 1 and all(not got["printed"] for got in ranks[1][1:])
    seq = json.loads(first[0].split(":", 1)[1])
    want = json.loads([ln for ln in none.splitlines() if ln.startswith("first sequence")][0]
                      .split(":", 1)[1])
    prompt_len, gen = 16, 16  # serve.main's defaults
    assert len(seq) == len(want) == prompt_len + gen
    logits = _first_row_logits(get_config("llama3-8b").reduced(), prompt_len, gen)
    assert [int(lg.float().argmax()) for lg in logits[prompt_len - 1 :]] == want[prompt_len:]
    k = next((i for i, (a, b) in enumerate(zip(seq, want)) if a != b), len(want))
    assert k > prompt_len  # the broadcast prompts and at least one generated token agree
    if k < len(want):
        (best, runner_up), top = torch.topk(logits[k - 1], 2)
        assert set(top.tolist()) == {want[k], seq[k]}
        assert best == runner_up or torch.nextafter(runner_up, best) == best, (k, best, runner_up)


def test_split_expert_trees_convert():
    """``lm_params_from_reference`` takes a tree of pre-split experts
    (rows E * factor) and refuses rows that are no multiple of E."""
    from repro_torch.convert import lm_params_from_reference

    cfg = ref_get_config("mixtral-8x22b").reduced()
    with ref_ctx.use_mesh(AbstractMesh((1, 8), ("data", "model"))):
        tree = jax.tree.map(np.asarray, RM.init_params(cfg, jax.random.PRNGKey(0)))
    lm = lm_params_from_reference(get_config("mixtral-8x22b").reduced(), tree, device="cpu")
    assert tuple(lm.layers[0].ffn.w_gate.shape) == (8, 64, 64)
    ffn = tree["groups"]["slot0"]["ffn"]
    bad = {**tree, "groups": {"slot0": {**tree["groups"]["slot0"], "ffn": {
        **ffn, "w_gate": ffn["w_gate"][:, :7]}}}}
    with pytest.raises(ValueError, match="expert rows"):
        lm_params_from_reference(get_config("mixtral-8x22b").reduced(), bad, device="cpu")
