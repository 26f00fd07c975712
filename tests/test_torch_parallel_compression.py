"""The int8 error-feedback gradient mean (``parallel.compression``) on
gloo ranks against the reference's own shard_map runs on 8 devices, the
inputs drawn from numpy seeds.

* ``compressed_psum_mean`` over ``data`` on a (4, 2) mesh, each data rank
  holding one block of ``x`` (4, 64, 32), and over ``pod`` and ``data``
  on a (2, 2, 2) mesh: within rel 1e-6 of the reference's output's scale.
* ``compressed_grad_mean`` twice on the (4, 2) mesh, the second call
  carrying the first's residual: both means and residuals within rel
  1e-6.
* Over one data rank ((1, 8)) the mean is its input and the residual
  zeros; with no mesh both come back as given.
"""

import numpy as np
import pytest

from _torch_parallel import compression_rank, run_ranks, run_reference

REL = 1e-6

REF_BODY = """
from jax.sharding import PartitionSpec as P
from repro import compat
from repro.parallel import context as ctx
from repro.parallel.compression import compressed_grad_mean, compressed_psum_mean

rng = np.random.default_rng(11)
x = rng.standard_normal((4, 64, 32)).astype(np.float32)
g1 = rng.standard_normal((16, 8)).astype(np.float32)
g2 = rng.standard_normal((16, 8)).astype(np.float32)
RESULTS.update(x=x, g1=g1, g2=g2)

mesh = make_mesh((4, 2))
out = jax.jit(compat.shard_map(
    lambda xb: compressed_psum_mean(xb[0], ("data",))[None], mesh=mesh,
    in_specs=P("data", None, None), out_specs=P("data", None, None), check_vma=False))(x)
RESULTS["mean_4x2"] = host(out)
with ctx.use_mesh(mesh):
    mean1, res1 = compressed_grad_mean({"w": jnp.asarray(g1)})
    mean2, res2 = compressed_grad_mean({"w": jnp.asarray(g2)}, res1)
RESULTS.update(mean1=host(mean1["w"]), res1=host(res1["w"]), mean2=host(mean2["w"]),
               res2=host(res2["w"]))

mesh = make_mesh((2, 2, 2))
out = jax.jit(compat.shard_map(
    lambda xb: compressed_psum_mean(xb[0], ("pod", "data"))[None], mesh=mesh,
    in_specs=P(("pod", "data"), None, None), out_specs=P(("pod", "data"), None, None),
    check_vma=False))(x)
RESULTS["mean_222"] = host(out)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel_compression")
    ref = run_reference(REF_BODY, [{}], tmp / "ref.npz")
    return ref, run_ranks(compression_rank, 8, tmp, str(tmp / "ref.npz"))


def _close(got, want, what):
    gap = float(np.abs(got - want).max() / np.abs(want).max())
    assert gap <= REL, f"{what}: rel gap {gap}"


def test_compressed_psum_mean_matches_reference(runs):
    ref, ranks = runs
    for r, got in enumerate(ranks):
        data = r // 2  # (4, 2): ("data", "model")
        _close(got["mean_4x2"], ref["mean_4x2"][data], f"(4, 2) rank {r}")
        pod_data = r // 2  # (2, 2, 2): index over ("pod", "data") row-major
        _close(got["mean_222"], ref["mean_222"][pod_data], f"(2, 2, 2) rank {r}")
    # the int8 exchange is an approximation of the mean, as in the reference
    mean = ref["x"].mean(axis=0)
    assert np.abs(ranks[0]["mean_4x2"] - mean).max() / np.abs(mean).max() < 0.02


def test_compressed_grad_mean_carries_its_residual(runs):
    ref, ranks = runs
    for r, got in enumerate(ranks):
        for k in ("mean1", "res1", "mean2", "res2"):
            _close(got[k], ref[k], f"{k}, rank {r}")
    assert np.abs(ref["res1"]).max() > 0  # the first call lost something to quantization


def test_identity_over_one_rank_and_without_a_mesh(runs):
    for got in runs[1]:
        assert got["one_rank_is_x"] and got["one_rank_mean_equal"] and got["one_rank_res_zero"]
        assert got["no_mesh"]
