"""Shared helpers of the ``tests/test_torch_parallel*.py`` tests: the
reference's own mesh runs and the port's ranks.

* The reference runs once per test file in a subprocess with 8 fake CPU
  devices (``XLA_FLAGS=--xla_force_host_platform_device_count=8``) and
  meshes of ``Auto`` axes.  jax 0.9's ``jax.make_mesh`` defaults to
  ``Explicit`` axes, under which ``with_sharding_constraint`` refuses the
  reference's specs (the failure of ``tests/test_moe_parallel_paths.py``);
  with ``AxisType.Auto`` its mesh paths run.  The script writes its
  parameters and outputs (float32 numpy: bf16 values are exact in it) to
  an ``.npz``.
* The port runs as ``gloo`` processes (``torch.multiprocessing``, spawn)
  that meet through a ``FileStore`` under the test's ``tmp_path`` (no
  fixed port: several test workers run at once), one thread each, and are
  joined with a timeout, so that a hung collective fails its test.

This module imports no JAX: the ranks import it.
"""

from __future__ import annotations

import json
import os
import pickle
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
REF_TIMEOUT_S = 300
RANK_TIMEOUT_S = 240

REF_PRELUDE = '''
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import dataclasses, json, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import AxisType

CASES = json.loads(sys.argv[2])
RESULTS = {}


def make_mesh(shape):
    names = ("data", "model") if len(shape) == 2 else ("pod", "data", "model")
    return jax.make_mesh(tuple(shape), names, axis_types=(AxisType.Auto,) * len(shape))


def host(x):
    """A float32 (bf16 is exact in it) or integer numpy array."""
    x = np.asarray(x)
    return x if x.dtype.kind in "iub" else x.astype(np.float32)


def save_tree(prefix, tree):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        RESULTS[prefix + "/".join(str(k.key) for k in path)] = host(leaf)
'''

REF_EPILOGUE = "\nnp.savez(sys.argv[1], **RESULTS)\n"


def run_reference(body: str, cases: list[dict], out: Path, *, jobs: int = 1) -> dict[str, np.ndarray]:
    """Run ``body`` (after :data:`REF_PRELUDE`, with ``CASES`` a list of
    the given cases, each with its ``seed``, its index in ``cases``) in
    ``jobs`` concurrent subprocesses with 8 fake devices, each taking every
    ``jobs``-th case; writes what they put in ``RESULTS`` to ``out`` and
    returns it."""
    script = REF_PRELUDE + textwrap.dedent(body) + REF_EPILOGUE
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu"}
    seeded = [dict(c, seed=i) for i, c in enumerate(cases)]
    parts = [out.with_name(f"{out.stem}.{j}.npz") for j in range(jobs)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", script, str(part), json.dumps(seeded[j::jobs])],
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True, env=env, cwd=ROOT,
    ) for j, part in enumerate(parts)]
    try:
        errs = [p.communicate(timeout=REF_TIMEOUT_S)[1] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, err in zip(procs, errs):
        assert p.returncode == 0, err[-4000:]
    results = {}
    for part in parts:
        with np.load(part) as f:
            results.update({k: f[k] for k in f.files})
    np.savez(out, **results)
    return results


def tree_of(arrays: dict[str, np.ndarray], prefix: str) -> dict:
    """The nested parameter tree saved under ``prefix`` by ``save_tree``."""
    tree: dict = {}
    for key, value in arrays.items():
        if not key.startswith(prefix):
            continue
        *parents, leaf = key[len(prefix):].split("/")
        node = tree
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = value
    return tree


def run_ranks(fn, world: int, tmp_path: Path, *args, timeout: float = RANK_TIMEOUT_S) -> list:
    """``fn(rank, world, *args)`` on ``world`` gloo ranks; returns each
    rank's result.  Fails the test if a rank raises or the ranks are not
    done within ``timeout`` seconds (they are killed)."""
    name = f"{fn.__name__}-{world}-{time.monotonic_ns()}"
    out = tmp_path / name
    out.mkdir()
    procs = torch.multiprocessing.start_processes(
        _rank_entry, args=(world, str(tmp_path / f"{name}.store"), str(out), fn, args),
        nprocs=world, join=False, start_method="spawn",
    )
    deadline = time.monotonic() + timeout
    try:
        while not procs.join(timeout=max(0.0, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise AssertionError(
                    f"{fn.__name__}: {world} ranks still running after {timeout} s "
                    "(a collective one rank skipped?)")
    finally:
        for p in procs.processes:
            if p.is_alive():
                p.kill()
                p.join(5)
    results = []
    for r in range(world):
        with open(out / f"rank{r}.pkl", "rb") as f:
            results.append(pickle.load(f))
    return results


def _rank_entry(rank: int, world: int, store: str, out: str, fn, args) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    try:
        result = fn(rank, world, *args)
    finally:
        dist.destroy_process_group()
    with open(Path(out) / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(result, f)


def numpy_of(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def meshes():
    """A ``shape -> Mesh`` cache for one rank (each mesh creates its
    process groups once)."""
    from repro_torch.parallel import context as ctx

    made: dict[tuple, object] = {}

    def get(shape):
        shape = tuple(shape)
        if shape not in made:
            names = ("data", "model") if len(shape) == 2 else ("pod", "data", "model")
            made[shape] = ctx.make_mesh(shape, names)
        return made[shape]

    return get


def port_config(case: dict):
    import dataclasses

    from repro_torch.configs.base import get_config

    return dataclasses.replace(get_config(case["arch"]).reduced(), **case["fields"])


# ---------------------------------------------------------------------------
# Rank programs
# ---------------------------------------------------------------------------


def _load(path: str) -> dict[str, np.ndarray]:
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def moe_rank(rank: int, world: int, cases: list[dict], ref_path: str) -> dict:
    """Each MoE case (``path`` gather, a2a or decode) on this rank's rows,
    weights and experts; returns the gathered outputs, the balance loss
    and the dropped assignments this rank counted."""
    from torch import nn

    from repro_torch.configs.base import torch_dtype
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import moe as moe_mod
    from repro_torch.parallel import context as ctx

    ref, mesh_of, out = _load(ref_path), meshes(), {}
    for case in cases:
        cfg = port_config(case)
        dtype = torch_dtype(cfg.compute_dtype)
        name = case["name"]
        leaves = [torch.as_tensor(ref[f"{name}/p/{k}"]) for k in moe_mod.MoE.LEAVES]
        whole = moe_mod.MoE(leaves[0], *(t.to(dtype) for t in leaves[1:]))
        x = torch.as_tensor(ref[f"{name}/x"]).to(dtype)
        with ctx.use_mesh(mesh_of(case["shape"])), torch.no_grad():
            p = mesh_lib.shard_params(cfg, nn.ModuleDict({"ffn": whole}))["ffn"]
            with ctx.use_batch_rows(x.shape[0]), moe_mod.drop_tally() as drops:
                xl = ctx.local_rows(x)
                if case["path"] == "a2a":
                    y, aux = moe_mod.moe_ffn_a2a(cfg, p, xl)
                else:
                    y, aux = moe_mod.moe_ffn(cfg, p, xl, decode=case["path"] == "decode")
                y = ctx.all_gather(y, ctx.batch_axes(), 0, adjoint="slice")
        out[name] = dict(out=numpy_of(y), aux=float(aux), dtype=str(y.dtype),
                         local_rows=xl.shape[0], dropped=int(sum(int(d) for d in drops)))
    return out


def lm_rank(rank: int, world: int, cases: list[dict], ref_path: str, steps_n: int) -> dict:
    """Each whole-model case: its reference tree cut to this rank's shards
    under the prefill cell, a prefill, then cut under the decode cell (its
    sequence-sharded cache; 2-D tensor parallelism where the weights are
    not replicated) and ``steps_n`` teacher-forced decode steps; returns
    the gathered logits, the greedy tokens, the prefill's dropped
    assignments and the collectives the prefill and the first decode step
    called (:func:`collective_log`, recorded in ``"observe"`` mode)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.convert import lm_shards_from_reference
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import steps
    from repro_torch.models import model as M
    from repro_torch.models import moe as moe_mod
    from repro_torch.parallel import context as ctx

    ref, mesh_of, out = _load(ref_path), meshes(), {}
    share = mesh_lib.SERVE_REPLICATION_SHARE
    for case in cases:
        cfg = port_config(case)
        name, tree = case["name"], case.get("tree", case["name"])
        tokens = torch.as_tensor(ref[f"{tree}/tokens"])
        B, S = tokens.shape
        mesh = mesh_of(case["shape"])
        mesh_lib.SERVE_REPLICATION_SHARE = 0.0 if case.get("nogather") else share
        try:
            with mesh_lib.cell_context(mesh, cfg, ShapeConfig("p", S, B, "prefill")):
                lm = lm_shards_from_reference(cfg, tree_of(ref, f"{tree}/params/"), device="cpu")
                with moe_mod.drop_tally() as drops, ctx.record() as pre_rec:
                    prefill = steps.make_prefill_step(cfg)(lm, {"tokens": tokens})
            with mesh_lib.cell_context(mesh, cfg, ShapeConfig("d", S, B, "decode")):
                # a decode cell of weights not replicated over data cuts them in 2-D
                lm = lm_shards_from_reference(cfg, tree_of(ref, f"{tree}/params/"), device="cpu")
                cache = M.init_cache(cfg, B, S, getattr(torch, case["cache_dtype"]), device="cpu")
                step = steps.make_decode_step(cfg)
                logits, toks = [], []
                for t in range(steps_n):
                    with ctx.record() as rec:
                        nxt, lg, cache = step(lm, cache, tokens[:, t : t + 1], t)
                    if t == 0:
                        dec_rec = rec
                    logits.append(numpy_of(lg))
                    toks.append(nxt.numpy())
        finally:
            mesh_lib.SERVE_REPLICATION_SHARE = share
        out[name] = dict(prefill=numpy_of(prefill), decode=np.stack(logits),
                         tokens=np.stack(toks), dropped=int(sum(int(d) for d in drops)),
                         log=dict(prefill=collective_log(pre_rec), decode=collective_log(dec_rec)))
    return out


# ---------------------------------------------------------------------------
# Whole models
# ---------------------------------------------------------------------------

LM_B, LM_S, LM_STEPS = 2, 16, 12

# The reference's side of each whole-model case: parameters initialised
# under the prefill cell (so split experts match the mesh), its jitted
# prefill step, then LM_STEPS teacher-forced decode steps under the decode
# cell.  ``nogather`` cases set the replication limit to 1 byte, so the
# expert weights stay sharded over data and decode takes the no-gather
# path.
LM_REF_BODY = f"""
from repro.configs.base import ShapeConfig, get_config
from repro.launch import mesh as mesh_lib
from repro.launch import steps
from repro.models import model as M

B, S, STEPS = {LM_B}, {LM_S}, {LM_STEPS}
LIMIT = mesh_lib.SERVE_REPLICATION_LIMIT


def zero_routers(params):
    groups = {{
        slot: {{**p, "ffn": {{**p["ffn"], "router": jnp.zeros_like(p["ffn"]["router"])}}}}
        if "router" in p.get("ffn", {{}}) else p
        for slot, p in params["groups"].items()
    }}
    return {{**params, "groups": groups}}


for case in CASES:
    i = case["seed"]
    cfg = dataclasses.replace(get_config(case["arch"]).reduced(), **case["fields"])
    name = case["name"]
    mesh = make_mesh(case["shape"])
    tokens = np.random.default_rng(200 + i).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    mesh_lib.SERVE_REPLICATION_LIMIT = 1 if case["nogather"] else LIMIT
    with mesh_lib.cell_context(mesh, cfg, ShapeConfig("p", S, B, "prefill")):
        params = M.init_params(cfg, jax.random.PRNGKey(i))
        if case["zero_routers"]:
            params = zero_routers(params)
        prefill = jax.jit(steps.make_prefill_step(cfg))(params, {{"tokens": tokens}})
    with mesh_lib.cell_context(mesh, cfg, ShapeConfig("d", S, B, "decode")):
        cache = M.init_cache(cfg, B, S, jnp.dtype(case["cache_dtype"]))
        step = jax.jit(steps.make_decode_step(cfg))
        logits, toks = [], []
        for t in range(STEPS):
            nxt, lg, cache = step(params, cache, tokens[:, t : t + 1], jnp.asarray(t, jnp.int32))
            logits.append(host(lg))
            toks.append(host(nxt))
    mesh_lib.SERVE_REPLICATION_LIMIT = LIMIT
    RESULTS[name + "/tokens"] = tokens
    RESULTS[name + "/prefill"] = host(prefill)
    RESULTS[name + "/decode"] = np.stack(logits)
    RESULTS[name + "/next"] = np.stack(toks)
    save_tree(name + "/params/", params)
"""

F32_RTOL = 1e-4
BF16_TOL = 2e-2
BF16_TOL_DEEP_HYBRID = 4e-2  # jamba in bf16, routers zeroed (tests/test_torch_lm.py)


def lm_case(arch: str, dtype: str, shape=(2, 4), *, impl: str = "gather", cf: float = 1.25,
            nogather: bool = False) -> dict:
    """One whole-model case: the reduced ``arch`` in ``dtype``, jamba in
    bf16 with its routers zeroed (``tests/test_torch_lm.py``).  The decode
    cache is bf16 as served in bf16 cases (jamba's float32, as in
    ``tests/test_torch_lm.py``) and float32 in float32 cases: two float32
    runs that add their partial sums in other orders differ in the last
    bits, and a bf16 cache turns those into bf16 ulps (1.5e-4 of gemma2's
    logits' scale after 12 steps, between the ranks and one device)."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import model as M

    cfg = get_config(arch).reduced()
    hybrid = M.routing_feeds_state(cfg)
    mamba = any(M.slot_kinds(cfg, s)[0] == "mamba" for s in range(cfg.group_size))
    moe = any(M.slot_kinds(cfg, s)[2] == "moe" for s in range(cfg.group_size))
    tag = "-".join(str(v) for v in shape)
    name = f"{arch}-{tag}-{dtype}" + (f"-{impl}-cf{cf}" if moe else "") + ("-nogather" * nogather)
    return dict(
        name=name, arch=arch, shape=list(shape), nogather=nogather, moe=moe, mamba=mamba,
        fields=dict(compute_dtype=dtype, moe_impl=impl, capacity_factor=cf),
        zero_routers=dtype == "bfloat16" and hybrid,
        cache_dtype="float32" if hybrid or dtype == "float32" else "bfloat16",
        tol=(BF16_TOL if mamba else F32_RTOL) if dtype == "float32"
        else (BF16_TOL_DEEP_HYBRID if hybrid else BF16_TOL),
        decode_tol=F32_RTOL if dtype == "float32" else (BF16_TOL_DEEP_HYBRID if hybrid else BF16_TOL),
    )


def at_factor_8(case: dict) -> dict:
    """A case run by the port alone on ``case``'s reference tree at a
    capacity factor of 8, where nothing drops, for the ranks against the
    port's own no-mesh run."""
    return dict(case, name=case["name"] + "-self-cf8", tree=case["name"],
                fields=dict(case["fields"], capacity_factor=8.0))


def check_against_port(ref: dict, ranks: list, case: dict) -> None:
    """The ranks' logits against the port's own no-mesh run of the same
    tree: float32 within rel 1e-4 of their scale, bf16 at the case's
    decode tolerance."""
    want = port_without_mesh(ref, case)
    tol = F32_RTOL if case["fields"]["compute_dtype"] == "float32" else case["decode_tol"]
    got = ranks[0][case["name"]]
    assert_logits(got["prefill"], want["prefill"], tol, f"{case['name']} prefill")
    for t in range(LM_STEPS):
        assert_logits(got["decode"][t], want["decode"][t], tol, f"{case['name']} step {t}")


def assert_logits(got: np.ndarray, want: np.ndarray, tol: float, what: str) -> None:
    """rel ``tol`` of the largest logit at float32's 1e-4, else ``tol``
    elementwise (atol and rtol), as ``tests/test_torch_lm.py`` holds
    single-device logits."""
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if tol == F32_RTOL:
        gap = float(np.abs(got - want).max() / np.abs(want).max())
        assert gap <= tol, f"{what}: rel gap {gap}"
    else:
        np.testing.assert_allclose(got, want, atol=tol, rtol=tol, err_msg=what)


def check_lm_case(ref: dict, ranks: list, case: dict) -> None:
    """The ranks' prefill and decode logits against the reference's mesh
    run, float32 greedy tokens equal, every rank's logits the same."""
    name = case["name"]
    for r, got in enumerate(ranks):
        res = got[name]
        assert_logits(res["prefill"], ref[f"{name}/prefill"], case["tol"], f"{name} prefill, rank {r}")
        for t in range(LM_STEPS):
            assert_logits(res["decode"][t], ref[f"{name}/decode"][t], case["decode_tol"],
                          f"{name} decode step {t}, rank {r}")
        if case["fields"]["compute_dtype"] == "float32":
            np.testing.assert_array_equal(res["tokens"], ref[f"{name}/next"], err_msg=name)
        np.testing.assert_array_equal(res["prefill"], ranks[0][name]["prefill"])
        np.testing.assert_array_equal(res["decode"], ranks[0][name]["decode"])


def port_without_mesh(ref: dict, case: dict) -> dict:
    """The port's own ``--mesh none`` run of a case's reference tree:
    prefill logits and the decode steps' logits."""
    from repro_torch.convert import lm_params_from_reference
    from repro_torch.launch import steps
    from repro_torch.models import model as M

    cfg = port_config(case)
    tree = case.get("tree", case["name"])
    lm = lm_params_from_reference(cfg, tree_of(ref, f"{tree}/params/"), device="cpu")
    tokens = torch.as_tensor(ref[f"{tree}/tokens"])
    B, S = tokens.shape
    prefill = steps.make_prefill_step(cfg)(lm, {"tokens": tokens})
    cache = M.init_cache(cfg, B, S, getattr(torch, case["cache_dtype"]), device="cpu")
    step = steps.make_decode_step(cfg)
    logits = []
    for t in range(LM_STEPS):
        _, lg, cache = step(lm, cache, tokens[:, t : t + 1], t)
        logits.append(numpy_of(lg))
    return dict(prefill=numpy_of(prefill), decode=np.stack(logits))


# ---------------------------------------------------------------------------
# The mesh, its collectives, the cuts, serving
# ---------------------------------------------------------------------------


def _flat(tree: dict, prefix: str = "") -> dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def context_rank(rank: int, world: int, trees_path: str, round_trips: list[dict]) -> dict:
    """The mesh's collectives on (2, 4) and (2, 2, 2) meshes, the
    production meshes, reference trees cut to this rank's shards and
    gathered back, float32 generation on two meshes, and the serving CLI;
    returns what each produced here."""
    import contextlib
    import dataclasses
    import io

    from repro_torch.configs.base import ShapeConfig, get_config
    from repro_torch.convert import lm_params_to_reference, lm_shards_from_reference
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    from repro_torch.parallel import context as ctx

    out: dict = {}
    m24 = ctx.make_mesh((2, 4), ("data", "model"))
    m222 = ctx.make_mesh((2, 2, 2), ("pod", "data", "model"))
    mine = torch.tensor([float(rank + 1)])
    with ctx.use_mesh(m24):
        out["psum_model"] = float(ctx.psum(mine.clone(), ("model",)))
        out["pmean_data"] = float(ctx.pmean(mine.clone(), ("data",)))
        out["gather_data"] = ctx.all_gather(mine.clone(), ("data",), 0, adjoint="slice").tolist()
        blocks = torch.tensor([[10.0 * rank + j] for j in range(4)])
        out["a2a_model"] = ctx.all_to_all(blocks, ("model",))[:, 0].tolist()
        out["bf16_psum"] = float(ctx.psum(torch.tensor([1.0 + 2**-7]).bfloat16(), ("model",)))
    with ctx.use_mesh(m222):
        out["coords_222"] = m222.coords()
        out["gather_data_pod"] = ctx.all_gather(mine.clone(), ("data", "pod"), 0,
                                                  adjoint="slice").tolist()
        out["index_pod_data"] = ctx.axis_index(("pod", "data"))
    out["single"] = mesh_lib.make_production_mesh().sizes
    out["multi"] = mesh_lib.make_production_mesh(multi_pod=True, local=2).shape
    try:
        mesh_lib.make_production_mesh(multi_pod=True)
    except ValueError as e:
        out["multi_8"] = str(e)

    trees = _load(trees_path)
    for case in round_trips:
        cfg = port_config(case)
        with ctx.use_mesh(m24 if tuple(case["shape"]) == (2, 4) else ctx.make_mesh(
                tuple(case["shape"]), ("data", "model"))):
            lm = lm_shards_from_reference(cfg, tree_of(trees, case["name"] + "/"), device="cpu")
            out[case["name"] + "/local"] = {n: tuple(p.shape) for n, p in lm.named_parameters()}
            back = lm_params_to_reference(cfg, lm)
        if rank == 0:
            out[case["name"]] = _flat(back)

    cfg = dataclasses.replace(get_config("llama3-8b").reduced(), compute_dtype="float32")
    gen = torch.Generator()
    whole = M.init_params(cfg, gen.manual_seed(0), device="cpu")
    prompts = torch.randint(0, cfg.vocab_size, (4, 8), generator=gen.manual_seed(1))
    for name, mesh in (("f32_2x4", m24), ("f32_1x8", ctx.make_mesh((1, 8), ("data", "model")))):
        with mesh_lib.cell_context(mesh, cfg, ShapeConfig("s", 16, 4, "decode")):
            params = mesh_lib.shard_params(cfg, whole)
            out[name] = serve.generate(cfg, params, prompts, 16, 8, device="cpu").numpy()

    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        serve.main(["--reduced", "--mesh", "single", "--device", "cpu"])
    out["printed"] = printed.getvalue()
    return out


# ---------------------------------------------------------------------------
# Training across ranks
# ---------------------------------------------------------------------------

TRAIN_B, TRAIN_S, TRAIN_STEPS, TRAIN_LR = 8, 16, 3, 3e-4

# The reference's side of each training case: parameters initialised under
# the training cell (so split experts match the mesh) and placed by
# ``tree_shardings``, then TRAIN_STEPS of its jitted ``make_train_step``
# on one numpy batch.  ``f32_scan`` cases make the reference's training
# scan store float32 (its bf16 storage, ROADMAP §3) through a shim of
# ``repro.models.mamba.jnp``, as ``tests/test_torch_train.py`` does.
TRAIN_REF_BODY = f"""
import types
import repro.models.mamba as ref_mamba
from repro.configs.base import ShapeConfig, get_config
from repro.launch import mesh as mesh_lib
from repro.launch import steps
from repro.models import model as M
from repro.optim import adamw

B, S, STEPS, LR = {TRAIN_B}, {TRAIN_S}, {TRAIN_STEPS}, {TRAIN_LR}
JNP = ref_mamba.jnp
SHIM = types.SimpleNamespace(**{{k: getattr(jnp, k) for k in dir(jnp) if not k.startswith("__")}})
SHIM.bfloat16 = jnp.float32

for case in CASES:
    i = case["seed"]
    cfg = dataclasses.replace(get_config(case["arch"]).reduced(), **case["fields"])
    name = case["name"]
    ref_mamba.jnp = SHIM if case["f32_scan"] else JNP
    mesh = make_mesh(case["shape"])
    tok = np.random.default_rng(300 + i).integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    batch = {{"tokens": tok[:, :-1], "labels": tok[:, 1:]}}
    with mesh_lib.cell_context(mesh, cfg, ShapeConfig("t", S, B, "train")):
        params = M.init_params(cfg, jax.random.PRNGKey(i))
        save_tree(name + "/params/", params)
        params = jax.tree.map(jax.device_put, params,
                              mesh_lib.tree_shardings(mesh, M.param_specs(cfg)))
        opt = adamw.init(params, cfg.moment_dtype)
        step = jax.jit(steps.make_train_step(cfg, accum=case["accum"],
                                             lr_schedule=adamw.cosine_schedule(LR, 0, STEPS)))
        hist = []
        for s in range(STEPS):
            params, opt, m = step(params, opt, batch, jnp.asarray(s, jnp.int32))
            hist.append(m)
    RESULTS[name + "/tokens"] = tok
    for k in hist[0]:
        RESULTS[name + "/hist/" + k] = np.array([float(m[k]) for m in hist], np.float32)
    save_tree(name + "/final/", params)
"""


def train_case(arch: str, dtype: str, shape=(2, 4), *, accum: int = 1, impl: str = "gather",
               cf: float = 1.25) -> dict:
    """One training case: the reduced ``arch`` in ``dtype`` on ``shape``
    with ``accum`` micro-batches; a mamba arch's reference scan stores
    float32 in float32 cases (``f32_scan``), so float32 holds at rel 1e-4
    and bf16 at 2e-2."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import model as M

    cfg = get_config(arch).reduced()
    mamba = any(M.slot_kinds(cfg, s)[0] == "mamba" for s in range(cfg.group_size))
    moe = any(M.slot_kinds(cfg, s)[2] == "moe" for s in range(cfg.group_size))
    tag = "-".join(str(v) for v in shape)
    name = f"{arch}-{tag}-{dtype}-accum{accum}" + (f"-{impl}-cf{cf}" if moe else "")
    return dict(name=name, arch=arch, shape=list(shape), accum=accum, moe=moe,
                fields=dict(compute_dtype=dtype, moe_impl=impl, capacity_factor=cf),
                f32_scan=mamba and dtype == "float32",
                tol=F32_RTOL if dtype == "float32" else BF16_TOL)


def train_history(cfg, lm, batch: dict, accum: int, *, log: list | None = None):
    """``TRAIN_STEPS`` of the port's ``make_train_step`` on ``lm`` (its
    shards under an active mesh) with ``batch``: ``(history, dropped)``,
    the history a dict of per-step metric lists and ``dropped`` the
    assignments this rank's first step dropped.  ``log`` receives the
    collectives the first step called (:func:`collective_log`)."""
    from repro_torch.launch import steps
    from repro_torch.models import moe as moe_mod
    from repro_torch.optim import adamw
    from repro_torch.parallel import context as ctx

    step = steps.make_train_step(cfg, accum=accum,
                                 lr_schedule=adamw.cosine_schedule(TRAIN_LR, 0, TRAIN_STEPS))
    opt = adamw.init(steps.param_tree(lm), cfg.moment_dtype)
    hist: dict[str, list] = {}
    dropped = 0
    for s in range(TRAIN_STEPS):
        with moe_mod.drop_tally() as drops, ctx.record() as rec:
            _, opt, metrics = step(lm, opt, batch, s)
        if s == 0:
            dropped = int(sum(int(d) for d in drops))
            if log is not None:
                log.extend(collective_log(rec))
        for k, v in metrics.items():
            hist.setdefault(k, []).append(float(v))
    assert int(opt.step) == TRAIN_STEPS
    return hist, dropped


def reference_history(ref: dict, name: str) -> dict:
    prefix = f"{name}/hist/"
    return {k[len(prefix):]: ref[k] for k in ref if k.startswith(prefix)}


def train_batch(ref: dict, tree: str) -> dict:
    tok = torch.as_tensor(ref[f"{tree}/tokens"])
    return {"tokens": tok[:, :-1], "labels": tok[:, 1:]}


def _gradients(cfg, lm, batch: dict, aux_weight: float) -> dict:
    """``loss_fn``'s gradient of every leaf of ``lm`` (this rank's shards
    under a mesh) by ``backward``, gathered whole as the reference's
    tree."""
    from repro_torch.convert import lm_params_to_reference
    from repro_torch.models import model as M

    loss, _ = M.loss_fn(cfg, lm, batch, aux_weight=aux_weight)
    loss.backward()
    grads = M._with_leaves(lm, {n: p.grad for n, p in lm.named_parameters()})
    return _flat(lm_params_to_reference(cfg, grads))


def train_rank(rank: int, world: int, cases: list[dict], ref_path: str) -> dict:
    """Each training case on this rank's shards of its reference tree
    under the training cell: the history, the first step's dropped
    assignments and collectives and (rank 0) the gathered parameters
    after the steps; a
    case with ``aux_weight`` instead runs one ``loss_fn`` ``backward`` and
    returns (rank 0) the gathered gradients."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.convert import lm_params_to_reference, lm_shards_from_reference
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import model as M

    ref, mesh_of, out = _load(ref_path), meshes(), {}
    for case in cases:
        cfg = port_config(case)
        tree = case.get("tree", case["name"])
        batch = train_batch(ref, tree)
        B, S = batch["tokens"].shape
        with mesh_lib.cell_context(mesh_of(case["shape"]), cfg, ShapeConfig("t", S, B, "train")):
            lm = M.train_mode(lm_shards_from_reference(cfg, tree_of(ref, f"{tree}/params/"),
                                                       device="cpu"))
            if "aux_weight" in case:
                grads = _gradients(cfg, lm, batch, case["aux_weight"])
                out[case["name"]] = dict(grads=grads if rank == 0 else None)
                continue
            log: list = []
            hist, dropped = train_history(cfg, lm, batch, case["accum"], log=log)
            final = lm_params_to_reference(cfg, lm)
        out[case["name"]] = dict(hist=hist, dropped=dropped, log=log,
                                 final=_flat(final) if rank == 0 else None)
    return out


def port_gradients_without_mesh(ref: dict, case: dict) -> dict:
    """:func:`_gradients` of the port with no mesh on a case's tree."""
    from repro_torch.convert import lm_params_from_reference
    from repro_torch.models import model as M

    cfg = port_config(case)
    lm = M.train_mode(lm_params_from_reference(cfg, tree_of(ref, f"{case['tree']}/params/"),
                                               device="cpu"))
    return _gradients(cfg, lm, train_batch(ref, case["tree"]), case["aux_weight"])


def port_train_without_mesh(ref: dict, case: dict) -> dict:
    """The port's own ``--mesh none`` training of a case's reference tree:
    its history and final parameters."""
    from repro_torch.convert import lm_params_from_reference, lm_params_to_reference
    from repro_torch.models import model as M

    cfg = port_config(case)
    tree = case.get("tree", case["name"])
    lm = M.train_mode(lm_params_from_reference(cfg, tree_of(ref, f"{tree}/params/"), device="cpu"))
    hist, _ = train_history(cfg, lm, train_batch(ref, tree), case["accum"])
    return dict(hist=hist, final=_flat(lm_params_to_reference(cfg, lm)))


def assert_params(got: dict, want: dict, tol: float, what: str) -> None:
    """Every leaf at float32's rel 1e-4 of its largest magnitude, else
    ``tol`` elementwise (atol and rtol)."""
    assert set(got) == set(want), (what, set(got) ^ set(want))
    for k, w in want.items():
        g = np.asarray(got[k], np.float32)
        w = np.asarray(w, np.float32)
        assert g.shape == w.shape, (what, k, g.shape, w.shape)
        if tol == F32_RTOL:
            gap = float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-30))
            assert gap <= tol, f"{what} {k}: rel gap {gap}"
        else:
            np.testing.assert_allclose(g, w, atol=tol, rtol=tol, err_msg=f"{what} {k}")


def assert_history(got: dict, want: dict, tol: float, what: str) -> None:
    """Each metric the reference reports (loss, grad_norm, lr and at
    accum 1 nll, aux and lse) step by step: rel ``tol``, aux (about 1e-2
    of the loss) within ``tol`` of max(1, |aux|)."""
    for k, w in want.items():
        g = np.asarray(got[k])
        for s, (a, b) in enumerate(zip(g, w)):
            scale = max(1.0, abs(float(b))) if k == "aux" else max(abs(float(b)), 1e-30)
            assert abs(float(a) - float(b)) <= tol * scale, f"{what} {k} step {s}: {a} vs {b}"


# ---------------------------------------------------------------------------
# Gradient compression, remesh and resume
# ---------------------------------------------------------------------------


def compression_rank(rank: int, world: int, ref_path: str) -> dict:
    """``compressed_psum_mean`` of this data rank's block of the
    reference's ``x`` over ``data`` ((4, 2)) and over ``pod`` and
    ``data`` ((2, 2, 2)), two ``compressed_grad_mean`` calls with the
    residual carried, and both functions over one data rank ((1, 8)) and
    with no mesh."""
    from repro_torch.parallel import context as ctx
    from repro_torch.parallel.compression import compressed_grad_mean, compressed_psum_mean

    ref, mesh_of, out = _load(ref_path), meshes(), {}
    x = torch.as_tensor(ref["x"])
    with ctx.use_mesh(mesh_of((4, 2))):
        out["mean_4x2"] = numpy_of(compressed_psum_mean(x[ctx.axis_index(("data",))], ("data",)))
        g1, g2 = ({"w": torch.as_tensor(ref[k])} for k in ("g1", "g2"))
        mean1, res1 = compressed_grad_mean(g1)
        mean2, res2 = compressed_grad_mean(g2, res1)
        out.update(mean1=numpy_of(mean1["w"]), res1=numpy_of(res1["w"]),
                   mean2=numpy_of(mean2["w"]), res2=numpy_of(res2["w"]))
    with ctx.use_mesh(mesh_of((2, 2, 2))):
        block = x[ctx.axis_index(("pod", "data"))]
        out["mean_222"] = numpy_of(compressed_psum_mean(block, ("pod", "data")))
    with ctx.use_mesh(mesh_of((1, 8))):
        block = x[0]
        out["one_rank_is_x"] = compressed_psum_mean(block, ("data",)) is block
        mean, res = compressed_grad_mean(g1)
        out["one_rank_mean_equal"] = bool(torch.equal(mean["w"], g1["w"]))
        out["one_rank_res_zero"] = bool((res["w"] == 0).all())
    out["no_mesh"] = compressed_grad_mean(g1, "r") == (g1, "r")
    return out


REMESH_CFG = dict(arch="llama3-8b", fields=dict(compute_dtype="float32"))


def _train_state(cfg, lm, seed: int):
    """``(param_tree, AdamWState)`` of ``lm`` with moments drawn from
    ``seed`` (so a cut of them is seen), whole."""
    from repro_torch.launch import steps
    from repro_torch.optim import adamw

    tree = steps.param_tree(lm)
    opt = adamw.init(tree, cfg.moment_dtype)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for t in adamw._leaves(opt.m) + adamw._leaves(opt.v):
            t.copy_(torch.rand(t.shape, generator=gen))
    return tree, opt


def _flat_state(state) -> dict[str, np.ndarray]:
    from repro_torch.checkpoint import store

    return {k: t.detach().numpy().copy() for k, t in store._items(state)}


def _states_equal(a, b) -> bool:
    fa, fb = _flat_state(a), _flat_state(b)
    return fa.keys() == fb.keys() and all(np.array_equal(fa[k], fb[k]) for k in fa)


def remesh_rank(rank: int, world: int, tmp: str, phase: str) -> dict:
    """The remesh and resume programs: ``phase`` ``"eight"`` on a (2, 4)
    mesh, ``"four"`` on a (2, 2) mesh (see
    ``tests/test_torch_parallel_remesh.py``)."""
    import shutil

    from repro_torch.checkpoint import store
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import TokenStream
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import steps
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    from repro_torch.parallel import context as ctx
    from repro_torch.runtime.fault_tolerance import FailureInjector, TrainLoop, remesh

    cfg = port_config(REMESH_CFG)
    tmp = Path(tmp)
    shape = (2, 4) if phase == "eight" else (2, 2)
    mesh = ctx.make_mesh(shape, ("data", "model"))
    stream = TokenStream(cfg, 16, 8, seed=5, device="cpu")
    step = steps.make_train_step(cfg, lr_schedule=adamw.cosine_schedule(1e-3, 0, 4))
    out: dict = {}

    def fresh():
        """This rank's shards of the seed's model and zero moments, and a
        TrainLoop step over them."""
        whole = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
        lm = M.train_mode(mesh_lib.shard_params(cfg, whole))
        tree = steps.param_tree(lm)
        state = (tree, adamw.init(tree, cfg.moment_dtype))

        def step_fn(st, s):
            _, opt = st
            _, opt, metrics = step(lm, opt, stream.batch_at(s), s)
            return (tree, opt), {"loss": float(metrics["loss"]),
                                 "grad_norm": float(metrics["grad_norm"])}

        return state, step_fn

    def losses(history):
        return [(h["step"], h["loss"], h["grad_norm"]) for h in history]

    with mesh_lib.cell_context(mesh, cfg, ShapeConfig("t", 16, 8, "train")):
        if phase == "eight":
            # a whole state cut under (2, 4), gathered, cut under (2, 2)
            whole = M.init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
            state = _train_state(cfg, whole, 2)
            cut = mesh_lib.shard_state(cfg, state)
            out["cut_shapes"] = {k: v.shape for k, v in _flat_state(cut).items()}
            back = mesh_lib.gather_state(cfg, cut)
            out["round_trip_equal"] = _states_equal(back, state)
            out["recut_equal"] = all(
                _states_equal(remesh(back, cfg, layout), remesh(state, cfg, layout))
                for layout in (ctx.Mesh(("data", "model"), (2, 2), q) for q in range(4)))
            # killed at step 2, after its checkpoint
            state, step_fn = fresh()
            loop = TrainLoop(step_fn=step_fn, ckpt_dir=tmp / "killed", save_every=2,
                             injector=FailureInjector({2}), cfg=cfg)
            try:
                loop.run(state, 4)
            except FailureInjector.NodeFailure:
                out["killed_at"] = 2
            out["saved"] = _flat_state(store.restore(tmp / "killed", 2, state)) if rank == 0 else None
            if rank == 0:
                shutil.copytree(tmp / "killed", tmp / "killed8")
            torch.distributed.barrier()
            state, step_fn = fresh()
            _, _, history = TrainLoop(step_fn=step_fn, ckpt_dir=tmp / "killed8", save_every=2,
                                      cfg=cfg).run(state, 4)
            out["resumed"] = losses(history)
            state, step_fn = fresh()
            _, _, history = TrainLoop(step_fn=step_fn, ckpt_dir=tmp / "whole8", save_every=2,
                                      cfg=cfg).run(state, 4)
            out["uninterrupted"] = losses(history)
            out["files"] = sorted(p.name for p in (tmp / "whole8").iterdir())
        else:
            state, step_fn = fresh()
            TrainLoop(step_fn=step_fn, ckpt_dir=tmp / "killed", save_every=2, cfg=cfg).run(state, 2)
            restored = _flat_state(mesh_lib.gather_state(cfg, state))
            out["restored"] = restored if rank == 0 else None
            state, step_fn = fresh()
            _, _, history = TrainLoop(step_fn=step_fn, ckpt_dir=tmp / "killed", save_every=2,
                                      cfg=cfg).run(state, 4)
            out["resumed"] = losses(history)
            # the same state handed over without TrainLoop's resume
            state, step_fn = fresh()
            whole = store.restore(tmp / "killed", 2, state)
            with torch.no_grad():
                for (_, live), (_, new) in zip(store._items(state),
                                               store._items(remesh(whole, cfg, mesh))):
                    live.copy_(new)
            _, _, history = TrainLoop(step_fn=step_fn, ckpt_dir=tmp / "handed", save_every=2,
                                      cfg=cfg).run(state, 4, start_step=2)
            out["handed"] = losses(history)
    return out


# ---------------------------------------------------------------------------
# Sequence-sharded decode caches and 2-D decode tensor parallelism
# ---------------------------------------------------------------------------

# The reference's side of each decode case: parameters initialised under
# the prefill cell, its jitted prefill step (``prefill`` cases), then
# teacher-forced decode steps under the decode cell from a cache of
# ``seq`` slots (whisper's cross cache filled by its ``cross_kv`` from a
# seeded encoder output of ``frames`` frames).  ``two_d`` cases set the
# replication limit to 1 byte and jit the step with the parameters placed
# by ``serve_decode_param_shardings`` and the cache by ``cache_specs``, as
# ``launch.dryrun.lower_cell`` lowers a big model's decode cell, and write
# each device's shard of every parameter.  Every cache leaf is written whole, and each device's shard of it under
# ``cache_specs`` as GSPMD tiles a dim: padded to a multiple of its ranks,
# so the last blocks are short or empty where they do not divide it.
DECODE_REF_BODY = """
from jax.sharding import NamedSharding
from repro.configs.base import ShapeConfig, get_config
from repro.launch import mesh as mesh_lib
from repro.launch import steps
from repro.models import attention as A
from repro.models import model as M

LIMIT = mesh_lib.SERVE_REPLICATION_LIMIT


def zero_routers(params):
    groups = {
        slot: {**p, "ffn": {**p["ffn"], "router": jnp.zeros_like(p["ffn"]["router"])}}
        if "router" in p.get("ffn", {}) else p
        for slot, p in params["groups"].items()
    }
    return {**params, "groups": groups}


def path_name(path):
    return "/".join(str(getattr(k, "key", getattr(k, "name", k))) for k in path)


def shard_of(x, sharding, device):
    # GSPMD's tile of an uneven dim: the dim padded to a multiple of its
    # ranks; numpy's slicing then clamps the padded blocks
    sizes = dict(zip(sharding.mesh.axis_names, sharding.mesh.devices.shape))
    spec = tuple(sharding.spec) + (None,) * (x.ndim - len(sharding.spec))
    parts = [1 if e is None else int(np.prod([sizes[a] for a in ((e,) if isinstance(e, str) else e)]))
             for e in spec]
    padded = tuple(-(-n // f) * f for n, f in zip(x.shape, parts))
    return x[sharding.devices_indices_map(padded)[device]]


for case in CASES:
    i = case["seed"]
    cfg = dataclasses.replace(get_config(case["arch"]).reduced(), **case["fields"])
    name = case["name"]
    mesh = make_mesh(case["shape"])
    B, S, STEPS = case["batch"], case["seq"], case["steps"]
    tokens = np.random.default_rng(200 + i).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    mesh_lib.SERVE_REPLICATION_LIMIT = 1 if case["two_d"] else LIMIT
    with mesh_lib.cell_context(mesh, cfg, ShapeConfig("p", S, B, "prefill")):
        params = M.init_params(cfg, jax.random.PRNGKey(i))
        if case["zero_routers"]:
            params = zero_routers(params)
        if case["prefill"]:
            RESULTS[name + "/prefill"] = host(
                jax.jit(steps.make_prefill_step(cfg))(params, {"tokens": tokens}))
    with mesh_lib.cell_context(mesh, cfg, ShapeConfig("d", S, B, "decode")):
        cache = M.init_cache(cfg, B, S, jnp.dtype(case["cache_dtype"]))
        if cfg.is_encoder_decoder:
            compute = jnp.dtype(cfg.compute_dtype)
            enc = np.random.default_rng(300 + i).standard_normal(
                (B, case["frames"], cfg.d_model)).astype(np.float32)
            RESULTS[name + "/enc"] = enc
            p = M.cast_for_compute(cfg, params)["groups"]["slot0"]["cross"]
            proj = jax.jit(lambda w, e: A.cross_kv(cfg, w, e))
            ks, vs = zip(*(proj(jax.tree.map(lambda x, g=g: x[g], p), jnp.asarray(enc, compute))
                           for g in range(cfg.n_groups)))
            dt = jnp.dtype(case["cache_dtype"])
            cache["cross"] = A.KVCache(k=jnp.stack(ks).astype(dt), v=jnp.stack(vs).astype(dt))
        cache_sh = mesh_lib.tree_shardings(mesh, M.cache_specs(cfg))
        fn = steps.make_decode_step(cfg)
        if case["two_d"]:
            serve = M.cast_for_compute(cfg, params)
            param_sh = mesh_lib.serve_decode_param_shardings(mesh, cfg)
            serve = jax.tree.map(jax.device_put, serve, param_sh)
            cache = jax.tree.map(jax.device_put, cache, cache_sh)
            for (path, leaf), sh in zip(
                    jax.tree_util.tree_flatten_with_path(serve)[0],
                    jax.tree.leaves(param_sh, is_leaf=lambda x: isinstance(x, NamedSharding))):
                for d in range(mesh.devices.shape[0]):
                    for m in range(mesh.devices.shape[1]):
                        RESULTS[f"{name}/pshard/{d}-{m}/{path_name(path)}"] = shard_of(
                            host(leaf), sh, mesh.devices[d, m])
            step = jax.jit(fn, in_shardings=(param_sh, cache_sh, None, None),
                           out_shardings=(None, None, cache_sh))
            params = serve
        else:
            step = jax.jit(fn)
        logits, toks = [], []
        for t in range(STEPS):
            nxt, lg, cache = step(params, cache, tokens[:, t : t + 1], jnp.asarray(t, jnp.int32))
            logits.append(host(lg))
            toks.append(host(nxt))
    mesh_lib.SERVE_REPLICATION_LIMIT = LIMIT
    RESULTS[name + "/tokens"] = tokens
    RESULTS[name + "/decode"] = np.stack(logits)
    RESULTS[name + "/next"] = np.stack(toks)
    save_tree(name + "/params/", params)
    flat_cache = jax.tree_util.tree_flatten_with_path(cache)[0]
    flat_sh = jax.tree.leaves(cache_sh, is_leaf=lambda x: isinstance(x, NamedSharding))
    for (path, leaf), sh in zip(flat_cache, flat_sh):
        leaf = host(leaf)
        RESULTS[name + "/cache/" + path_name(path)] = leaf
        for d in range(mesh.devices.shape[0]):
            for m in range(mesh.devices.shape[1]):
                RESULTS[f"{name}/shard/{d}-{m}/{path_name(path)}"] = shard_of(
                    leaf, sh, mesh.devices[d, m])
"""


def decode_case(arch: str, dtype: str, batch: int, *, seq: int = 20, steps: int = 12,
                two_d: bool = False, prefill: bool = True, frames: int = 0,
                fields: dict | None = None) -> dict:
    """One decode case on a (2, 4) mesh: the reduced ``arch`` in
    ``dtype`` at ``batch`` rows (2: the cache's rows over ``data``, its
    slots over ``model``; 1: its slots over all 8 ranks), ``steps``
    teacher-forced decode steps from a cache of ``seq`` slots, with the
    caches, tolerances and zeroed routers of :func:`lm_case`."""
    case = lm_case(arch, dtype)
    tag = f"-b{batch}" + ("-2d" * two_d)
    case.update(name=case["name"] + tag, batch=batch, seq=seq, steps=steps, two_d=two_d,
                prefill=prefill, frames=frames)
    case["fields"] = {**case["fields"], **(fields or {})}
    return case


def _cache_leaves(cfg, cache) -> dict[str, np.ndarray]:
    """A port cache's leaves under the reference's names
    (``slot<s>/k`` with the group leading, ``cross/k``) for group ``g``
    as ``<name>@<g>``."""
    from repro_torch.models.attention import KVCache

    out = {}
    layers = cache.layers if hasattr(cache, "cross") else cache
    for i, entry in enumerate(layers):
        g, s = divmod(i, cfg.group_size)
        fields = ("k", "v") if isinstance(entry, KVCache) else ("conv", "ssm")
        for f in fields:
            out[f"slot{s}/{f}@{g}"] = numpy_of(getattr(entry, f))
    for g, entry in enumerate(getattr(cache, "cross", [])):
        for f in ("k", "v"):
            out[f"cross/{f}@{g}"] = numpy_of(getattr(entry, f))
    return out


def run_decode(cfg, lm, ref: dict, case: dict, log: list | None = None
               ) -> tuple[np.ndarray, np.ndarray, object]:
    """The port's teacher-forced decode of a case under the active cell
    (or none): ``(logits, greedy tokens, cache)``, whisper's cross cache
    filled by ``attention.cross_kv`` from the reference's encoder
    output.  ``log`` receives the collectives the first step called."""
    from repro_torch.launch import steps
    from repro_torch.models import attention as A
    from repro_torch.models import model as M
    from repro_torch.parallel import context as ctx

    tokens = torch.as_tensor(ref[f"{case['name']}/tokens"])
    B, S = tokens.shape
    dtype = getattr(torch, case["cache_dtype"])
    cache = M.init_cache(cfg, B, case["frames"] or S, dtype, device="cpu")
    if cfg.is_encoder_decoder:
        compute = M.cast_for_compute(cfg, lm)
        enc = torch.as_tensor(ref[f"{case['name']}/enc"]).to(getattr(torch, cfg.compute_dtype))
        with torch.no_grad():
            for layer, entry in zip(compute.layers, cache.cross):
                k, v = A.cross_kv(cfg, layer.cross, enc)
                entry.k.copy_(k)
                entry.v.copy_(v)
    step = steps.make_decode_step(cfg)
    logits, toks = [], []
    for t in range(case["steps"]):
        with ctx.record() as rec:
            nxt, lg, cache = step(lm, cache, tokens[:, t : t + 1], t)
        if t == 0 and log is not None:
            log.extend(collective_log(rec))
        logits.append(numpy_of(lg))
        toks.append(nxt.numpy())
    return np.stack(logits), np.stack(toks), cache


def decode_rank(rank: int, world: int, cases: list[dict], ref_path: str) -> dict:
    """Each decode case on this rank: the prefill (``prefill`` cases) on
    the shards cut under the prefill cell, then the decode steps on those
    cut under the decode cell; returns the logits, the greedy tokens, the
    first decode step's collectives, this
    rank's cache leaves, per dense leaf its elements here and whole and
    whether ``cast_for_compute`` left its shape, and (2-D cases) every
    leaf this rank holds and whether ``lm_params_to_reference`` gathers
    the whole tree back bit for bit."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.convert import lm_params_from_reference, lm_params_to_reference
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import steps
    from repro_torch.models import model as M

    ref, mesh_of, out = _load(ref_path), meshes(), {}
    share = mesh_lib.SERVE_REPLICATION_SHARE
    for case in cases:
        cfg = port_config(case)
        name = case["name"]
        whole = lm_params_from_reference(cfg, tree_of(ref, f"{name}/params/"), device="cpu")
        want = _flat(lm_params_to_reference(cfg, whole))
        tokens = torch.as_tensor(ref[f"{name}/tokens"])
        B, S = tokens.shape
        mesh = mesh_of(case["shape"])
        res = {}
        mesh_lib.SERVE_REPLICATION_SHARE = 0.0 if case["two_d"] else share
        try:
            if case["prefill"]:
                with mesh_lib.cell_context(mesh, cfg, ShapeConfig("p", S, B, "prefill")):
                    lm = mesh_lib.shard_params(cfg, whole)
                    res["prefill"] = numpy_of(steps.make_prefill_step(cfg)(lm, {"tokens": tokens}))
            with mesh_lib.cell_context(mesh, cfg, ShapeConfig("d", S, B, "decode")):
                lm = mesh_lib.shard_params(cfg, whole)
                res["log"] = []
                res["decode"], res["tokens"], cache = run_decode(cfg, lm, ref, case, res["log"])
                res["cache"] = _cache_leaves(cfg, cache)
                cast = M.cast_for_compute(cfg, lm)
                res["weights"] = {
                    n: (p.numel(), dict(whole.named_parameters())[n].numel(),
                        tuple(dict(cast.named_parameters())[n].shape) == tuple(p.shape))
                    for n, p in lm.named_parameters() if M.fsdp_dim(n, p.ndim) is not None}
                if case["two_d"]:
                    res["leaves"] = {n: numpy_of(p) for n, p in lm.named_parameters()}
                    back = _flat(lm_params_to_reference(cfg, lm))  # every rank gathers
                    res["round_trip_exact"] = set(back) == set(want) and all(
                        np.array_equal(back[k], want[k]) for k in want)
        finally:
            mesh_lib.SERVE_REPLICATION_SHARE = share
        out[name] = res
    return out


def decode_without_mesh(ref: dict, case: dict) -> dict:
    """The port's own ``--mesh none`` run of a decode case's reference
    tree: prefill logits (``prefill`` cases) and the decode logits."""
    from repro_torch.convert import lm_params_from_reference
    from repro_torch.launch import steps

    cfg = port_config(case)
    lm = lm_params_from_reference(cfg, tree_of(ref, f"{case['name']}/params/"), device="cpu")
    out = {}
    if case["prefill"]:
        tokens = torch.as_tensor(ref[f"{case['name']}/tokens"])
        out["prefill"] = numpy_of(steps.make_prefill_step(cfg)(lm, {"tokens": tokens}))
    out["decode"], _, _ = run_decode(cfg, lm, ref, case)
    return out


# ---------------------------------------------------------------------------
# The same ranks on meta: the counter source's simulated collectives
# ---------------------------------------------------------------------------


def collective_log(rec) -> list[tuple]:
    """A recording's collectives (``parallel.context.record``) as plain
    tuples: kind, reduction, axes, ranks, result bytes, dtype."""
    return [tuple(c) for c in rec.collectives]


def _meta_rank(case: dict, rank: int):
    """``(cfg, layout-only mesh at rank)`` of a case."""
    from repro_torch.parallel import context as ctx

    shape = tuple(case["shape"])
    names = ("data", "model") if len(shape) == 2 else ("pod", "data", "model")
    return port_config(case), ctx.Mesh(names, shape, rank)


def _meta_params(cfg, *, train: bool = False):
    """This rank's shards of a whole model laid out on ``meta`` under the
    active cell (``train``: trainable)."""
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import model as M

    lm = mesh_lib.shard_params(cfg, M.init_params(cfg, torch.Generator(), device="meta"))
    return M.train_mode(lm) if train else lm


def _meta(shape, dtype=torch.int32) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def lm_meta_log(case: dict, rank: int, tokens_shape: tuple) -> dict:
    """What :func:`lm_rank` records of ``case`` on ``rank``, simulated on
    ``meta`` under a layout-only mesh in this process: the prefill's
    collectives and the first decode step's."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import steps
    from repro_torch.models import model as M
    from repro_torch.parallel import context as ctx

    cfg, mesh = _meta_rank(case, rank)
    B, S = tokens_shape
    share = mesh_lib.SERVE_REPLICATION_SHARE
    mesh_lib.SERVE_REPLICATION_SHARE = 0.0 if case.get("nogather") else share
    try:
        with mesh_lib.cell_context(mesh, cfg, ShapeConfig("p", S, B, "prefill")):
            lm = _meta_params(cfg)
            with ctx.record("simulate") as pre:
                steps.make_prefill_step(cfg)(lm, {"tokens": _meta((B, S))})
        with mesh_lib.cell_context(mesh, cfg, ShapeConfig("d", S, B, "decode")):
            lm = _meta_params(cfg)
            cache = M.init_cache(cfg, B, S, getattr(torch, case["cache_dtype"]), device="meta")
            with ctx.record("simulate") as dec:
                steps.make_decode_step(cfg)(lm, cache, _meta((B, 1)), 0)
    finally:
        mesh_lib.SERVE_REPLICATION_SHARE = share
    return dict(prefill=collective_log(pre), decode=collective_log(dec))


def train_meta_log(case: dict, rank: int, tokens_shape: tuple) -> list[tuple]:
    """What :func:`train_rank` records of ``case``'s first step on
    ``rank``, simulated on ``meta``."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import steps
    from repro_torch.optim import adamw
    from repro_torch.parallel import context as ctx

    cfg, mesh = _meta_rank(case, rank)
    B, S = tokens_shape
    with mesh_lib.cell_context(mesh, cfg, ShapeConfig("t", S, B, "train")):
        lm = _meta_params(cfg, train=True)
        step = steps.make_train_step(cfg, accum=case["accum"],
                                     lr_schedule=adamw.cosine_schedule(TRAIN_LR, 0, TRAIN_STEPS))
        opt = adamw.init(steps.param_tree(lm), cfg.moment_dtype)
        with ctx.record("simulate") as rec:
            step(lm, opt, {"tokens": _meta((B, S)), "labels": _meta((B, S))}, 0)
    return collective_log(rec)


def decode_meta_log(case: dict, rank: int, tokens_shape: tuple) -> list[tuple]:
    """What :func:`decode_rank` records of ``case``'s first decode step on
    ``rank``, simulated on ``meta``."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import steps
    from repro_torch.models import model as M
    from repro_torch.parallel import context as ctx

    cfg, mesh = _meta_rank(case, rank)
    B, S = tokens_shape
    share = mesh_lib.SERVE_REPLICATION_SHARE
    mesh_lib.SERVE_REPLICATION_SHARE = 0.0 if case["two_d"] else share
    try:
        with mesh_lib.cell_context(mesh, cfg, ShapeConfig("d", S, B, "decode")):
            lm = _meta_params(cfg)
            dtype = getattr(torch, case["cache_dtype"])
            cache = M.init_cache(cfg, B, case["frames"] or S, dtype, device="meta")
            with ctx.record("simulate") as rec:
                steps.make_decode_step(cfg)(lm, cache, _meta((B, 1)), 0)
    finally:
        mesh_lib.SERVE_REPLICATION_SHARE = share
    return collective_log(rec)
