"""The port's expert-parallel MoE paths on gloo ranks against the
reference's own mesh runs (8 fake devices, ``tests/_torch_parallel.py``).

Each case runs one path of ``repro.models.moe`` under a mesh and the same
path of ``repro_torch.models.moe`` on 8 ranks, with the reference's
parameters (``init_moe_params`` under the mesh, so split experts match)
and the same numpy-seeded tokens:

* gather (``moe_ffn``), all-to-all (``moe_ffn_a2a``) and the no-gather
  decode path (``moe_ffn(decode=True)`` with ``efsdp`` weight shards) on a
  (2, 4) mesh, 8 experts top-2, so each model rank holds 2 experts;
* mixtral's 4 experts on a (1, 8) mesh: each expert split over ``d_ff``
  into 2 rows (``factor`` 2), gather and decode paths.

Each runs at the default capacity factor 1.25, where capacity binds, and
at 8, where nothing drops.  Capacities come from the tokens a rank routes
(a data shard's rows; the a2a path's sequence slice, with its own send
and second-level capacities), so at 1.25 the mesh drops other tokens
than one device: the cases there also show that the port's no-mesh
output lies outside the tolerance (gather and a2a; the no-gather decode
path routes every row on each rank, as one device does).  Outputs within
rel 1e-4 of their scale in float32 and 2e-2 (the repo's bf16 tolerance)
in bf16, where both sides add bf16 partial outputs over the model ranks
in their own orders; balance losses within rel 1e-5.  At factor 8 the ranks also match the port's own
no-mesh run (``factor`` 1 cases; a split-expert tree has no
single-device counterpart).
"""

import numpy as np
import pytest
import torch

from _torch_parallel import moe_rank, port_config, run_ranks, run_reference

F32_RTOL = 1e-4
BF16_TOL = 2e-2
B, S = 4, 16


def _cases() -> list[dict]:
    out = []
    for dtype in ("float32", "bfloat16"):
        for cf in (1.25, 8.0):
            base = dict(compute_dtype=dtype, capacity_factor=cf)
            for path in ("gather", "a2a", "decode"):
                out.append(dict(name=f"qwen3-{path}-cf{cf}-{dtype}", arch="qwen3-moe-30b-a3b",
                                fields=dict(base, n_experts=8, experts_per_token=2),
                                shape=[2, 4], path=path, factor=1, cf=cf))
            for path in ("gather", "decode"):
                out.append(dict(name=f"mixtral-split-{path}-cf{cf}-{dtype}", arch="mixtral-8x22b",
                                fields=base, shape=[1, 8], path=path, factor=2, cf=cf))
    return out


CASES = _cases()

REF_BODY = f"""
from repro.configs.base import get_config
from repro.models import moe as moe_mod
from repro.parallel import context as ctx

B, S = {B}, {S}
for case in CASES:
    i = case["seed"]
    cfg = dataclasses.replace(get_config(case["arch"]).reduced(), **case["fields"])
    dtype = jnp.dtype(cfg.compute_dtype)
    name = case["name"]
    # tokens of scale 3 about a common offset load the experts unevenly
    # enough for the default capacity to bind
    x = 3 * np.random.default_rng(100 + i).standard_normal((B, S, cfg.d_model)) + 2
    x = jnp.asarray(x.astype(np.float32), dtype)
    with ctx.use_mesh(make_mesh(case["shape"])):
        p = moe_mod.init_moe_params(jax.random.PRNGKey(i), cfg, dtype)
        assert moe_mod.moe_factor(cfg) == case["factor"]
        if case["path"] == "a2a":
            fn = lambda p, x: moe_mod.moe_ffn_a2a(cfg, p, x)
        else:
            fn = lambda p, x: moe_mod.moe_ffn(cfg, p, x, decode=case["path"] == "decode")
        out, aux = jax.jit(fn)(p, x)
    RESULTS[name + "/out"] = host(out)
    RESULTS[name + "/aux"] = host(aux)
    RESULTS[name + "/x"] = host(x)
    save_tree(name + "/p/", p)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel_moe")
    ref = run_reference(REF_BODY, CASES, tmp / "ref.npz")
    ranks = run_ranks(moe_rank, 8, tmp, CASES, str(tmp / "ref.npz"))
    return ref, ranks


def _gap(got, want) -> float:
    """max |got - want| over max |want|."""
    return float(np.abs(got - want).max() / np.abs(want).max())


def _tol(case) -> float:
    return F32_RTOL if case["fields"]["compute_dtype"] == "float32" else BF16_TOL


def _port_without_mesh(case, ref):
    from repro_torch.configs.base import torch_dtype
    from repro_torch.models import moe as moe_mod

    cfg = port_config(case)
    dtype = torch_dtype(cfg.compute_dtype)
    name = case["name"]
    leaves = [torch.as_tensor(ref[f"{name}/p/{k}"]) for k in moe_mod.MoE.LEAVES]
    p = moe_mod.MoE(leaves[0], *(t.to(dtype) for t in leaves[1:]))
    out, _ = moe_mod.moe_ffn(cfg, p, torch.as_tensor(ref[f"{name}/x"]).to(dtype))
    return out.float().numpy()


@pytest.mark.parametrize("case", CASES, ids=[c["name"] for c in CASES])
def test_moe_path_matches_reference_mesh_run(runs, case):
    ref, ranks = runs
    name, dtype = case["name"], case["fields"]["compute_dtype"]
    want = ref[f"{name}/out"]
    for r, got in enumerate(ranks):
        assert got[name]["out"].shape == want.shape
        assert got[name]["dtype"] == f"torch.{dtype}"
        assert _gap(got[name]["out"], want) <= _tol(case), f"{name}, rank {r}"
        assert got[name]["aux"] == pytest.approx(float(ref[f"{name}/aux"]), rel=1e-5), name
    # every rank returned the same whole output
    for got in ranks[1:]:
        np.testing.assert_array_equal(got[name]["out"], ranks[0][name]["out"])
    dropped = sum(got[name]["dropped"] for got in ranks)
    if case["cf"] == 8.0:
        assert dropped == 0, name
    else:
        assert dropped > 0, f"{name}: the default capacity dropped nothing"


BINDING = [c for c in CASES if c["cf"] == 1.25 and c["factor"] == 1 and c["path"] != "decode"]


@pytest.mark.parametrize("case", BINDING, ids=[c["name"] for c in BINDING])
def test_binding_capacity_is_per_shard(runs, case):
    """At the default capacity factor one device drops other tokens than
    the mesh: the port's no-mesh output lies outside the tolerance of the
    reference's mesh run, which the ranks meet."""
    ref, _ = runs
    want = ref[f"{case['name']}/out"]
    got = _port_without_mesh(case, ref)
    assert _gap(got, want) > _tol(case)


UNBOUND = [c for c in CASES if c["cf"] == 8.0 and c["factor"] == 1]


@pytest.mark.parametrize("case", UNBOUND, ids=[c["name"] for c in UNBOUND])
def test_ranks_match_port_without_mesh(runs, case):
    """Where nothing drops the ranks compute the port's no-mesh output."""
    ref, ranks = runs
    assert _gap(ranks[0][case["name"]]["out"], _port_without_mesh(case, ref)) <= _tol(case)
