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
                y = ctx.all_gather(y, ctx.batch_axes(), 0)
        out[name] = dict(out=numpy_of(y), aux=float(aux), dtype=str(y.dtype),
                         local_rows=xl.shape[0], dropped=int(sum(int(d) for d in drops)))
    return out


def lm_rank(rank: int, world: int, cases: list[dict], ref_path: str, steps_n: int) -> dict:
    """Each whole-model case: its reference tree cut to this rank's shards
    under the prefill cell, a prefill, then ``steps_n`` teacher-forced
    decode steps under the decode cell; returns the gathered logits, the
    greedy tokens and the prefill's dropped assignments."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.convert import lm_shards_from_reference
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import steps
    from repro_torch.models import model as M
    from repro_torch.models import moe as moe_mod

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
                with moe_mod.drop_tally() as drops:
                    prefill = steps.make_prefill_step(cfg)(lm, {"tokens": tokens})
            with mesh_lib.cell_context(mesh, cfg, ShapeConfig("d", S, B, "decode")):
                cache = M.init_cache(cfg, B, S, getattr(torch, case["cache_dtype"]), device="cpu")
                step = steps.make_decode_step(cfg)
                logits, toks = [], []
                for t in range(steps_n):
                    nxt, lg, cache = step(lm, cache, tokens[:, t : t + 1], t)
                    logits.append(numpy_of(lg))
                    toks.append(nxt.numpy())
        finally:
            mesh_lib.SERVE_REPLICATION_SHARE = share
        out[name] = dict(prefill=numpy_of(prefill), decode=np.stack(logits),
                         tokens=np.stack(toks), dropped=int(sum(int(d) for d in drops)))
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
        out["gather_data"] = ctx.all_gather(mine.clone(), ("data",), 0).tolist()
        blocks = torch.tensor([[10.0 * rank + j] for j in range(4)])
        out["a2a_model"] = ctx.all_to_all(blocks, ("model",))[:, 0].tolist()
        out["bf16_psum"] = float(ctx.psum(torch.tensor([1.0 + 2**-7]).bfloat16(), ("model",)))
    with ctx.use_mesh(m222):
        out["coords_222"] = m222.coords()
        out["gather_data_pod"] = ctx.all_gather(mine.clone(), ("data", "pod"), 0).tolist()
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
