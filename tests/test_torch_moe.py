"""The port's single-device MoE FFN (``repro_torch.models.moe``) against
the reference's ``_local_moe`` (``repro.models.moe``, ``first_expert`` 0,
``factor`` 1, the path ``moe_ffn`` takes with no mesh), with
numpy-seeded tokens and the reference's own parameters.

The routing is discrete, so it is compared exactly: the top-k experts,
the keep mask and every kept token's slot equal the reference's, which
``_transcribed_routing`` recomputes with ``_local_moe``'s own ``jnp``
lines (``_local_moe`` returns only the combined output).  The output is
held at rel 1e-4 of its scale in float32 and 2e-2 elementwise in bf16,
the balance loss at rel 1e-5.  Cases: a random router at the reduced
qwen3-moe-30b-a3b's width and at 8 experts top-3; a zero router, where
every probability ties and both sides must choose experts 0..k-1;
capacity factors that drop tokens; decode-sized batches of 1-3 tokens.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_rel_to_scale
from repro.configs.base import get_config as ref_get_config
from repro.models import moe as RMOE
from repro_torch.configs.base import get_config
from repro_torch.models import moe as PMOE

F32_RTOL = 1e-4
BF16_TOL = 2e-2


def _configs(**fields):
    ref = dataclasses.replace(ref_get_config("qwen3-moe-30b-a3b").reduced(), **fields)
    port = dataclasses.replace(get_config("qwen3-moe-30b-a3b").reduced(), **fields)
    return ref, port


def _tensor(a) -> torch.Tensor:
    """A JAX array as a tensor of its dtype (numpy has no bf16)."""
    return torch.as_tensor(np.array(a, np.float32)).to(getattr(torch, str(a.dtype)))


def _transcribed_routing(cfg, x, router):
    """``_local_moe``'s routing lines (``src/repro/models/moe.py``), as
    ``(top_i (T, k), keep (T, E), slot (T, E))``."""
    T = x.shape[0]
    C = RMOE._capacity(cfg, T)
    probs = jax.nn.softmax(x.astype(jnp.float32) @ router, axis=-1)
    top_p, top_i = jax.lax.top_k(probs, cfg.experts_per_token)
    top_p = top_p / jnp.maximum(top_p.sum(-1, keepdims=True), 1e-9)
    keeps, slots = [], []
    for e in range(cfg.n_experts):
        gate = ((top_i == e).astype(jnp.float32) * top_p).sum(axis=-1)
        mask = gate > 0.0
        pos = jnp.cumsum(mask.astype(jnp.int32)) - 1
        keep = mask & (pos < C)
        keeps.append(keep)
        slots.append(jnp.where(keep, pos, C))
    return np.asarray(top_i), np.stack(keeps, 1), np.stack(slots, 1)


def _case(rcfg, T, dtype, *, zero_router=False, seed=0):
    p = RMOE.init_moe_params(jax.random.PRNGKey(seed), rcfg, jnp.dtype(dtype))
    if zero_router:
        p["router"] = jnp.zeros_like(p["router"])
    x = np.random.default_rng(seed + 1).standard_normal((T, rcfg.d_model)).astype(np.float32)
    return p, jnp.asarray(x, jnp.dtype(dtype))


# (label, config fields, tokens, zero router); capacity C = max(4, min(ceil(cf * T * k / E), T))
CASES = [
    ("random", {}, 80, False),  # E 4, k 2: C 50
    ("8 experts top-3", dict(n_experts=8, experts_per_token=3), 96, False),  # C 45
    ("zero router", {}, 80, True),  # experts 0 and 1 for every token: 30 drops each
    ("drops", dict(capacity_factor=0.5), 80, False),  # C 20
    ("drops, 8 experts", dict(n_experts=8, experts_per_token=3, capacity_factor=0.3), 96, False),
    ("decode 1", {}, 1, False),  # C 4 > T: nothing drops
    ("decode 2", {}, 2, False),
    ("decode 3, zero router", {}, 3, True),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("label,fields,T,zero_router", CASES, ids=[c[0] for c in CASES])
def test_local_moe_matches_reference(label, fields, T, zero_router, dtype):
    rcfg, pcfg = _configs(compute_dtype=dtype, **fields)
    p, x = _case(rcfg, T, dtype, zero_router=zero_router)
    pp = PMOE.MoE(*(_tensor(p[n]) for n in PMOE.MoE.LEAVES))
    px = _tensor(x)
    C = PMOE._capacity(pcfg, T)
    assert C == RMOE._capacity(rcfg, T)

    top_i, keep, slot = _transcribed_routing(rcfg, x, p["router"])
    r = PMOE.route(pcfg, px, pp.router, C)
    np.testing.assert_array_equal(r.top_i.numpy(), top_i, err_msg="top-k experts")
    np.testing.assert_array_equal(r.keep.numpy(), keep, err_msg="keep mask")
    np.testing.assert_array_equal(r.slot.numpy(), slot, err_msg="slots")
    dropped = int((r.top_p > 0).sum() - r.keep.sum())
    if zero_router:
        k = pcfg.experts_per_token
        assert (r.top_i == torch.arange(k)).all()  # ties go to the lower index
        assert dropped == k * max(0, T - C)
    if label.startswith("drops"):
        assert dropped > 0
    if label.startswith("decode"):
        assert dropped == 0

    want, want_aux = jax.jit(
        lambda x, p: RMOE._local_moe(rcfg, x, p["router"], p["w_gate"], p["w_up"], p["w_down"],
                                     jnp.asarray(0, jnp.int32), 1)
    )(x, p)
    got, aux = PMOE.local_moe(pcfg, px, pp.router, pp.w_gate, pp.w_up, pp.w_down)
    assert got.dtype == px.dtype and got.shape == px.shape
    if dtype == "float32":
        assert_rel_to_scale(got, want, rtol=F32_RTOL, what=label)
    else:
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                   atol=BF16_TOL, rtol=BF16_TOL, err_msg=label)
    assert float(aux) == pytest.approx(float(want_aux), rel=1e-5)


def test_dropped_tokens_get_no_expert_output():
    """A token dropped by every expert it chose gets zeros, as in the
    reference (its combine adds nothing for it)."""
    rcfg, pcfg = _configs(compute_dtype="float32")
    p, x = _case(rcfg, 80, "float32", zero_router=True)
    pp = PMOE.MoE(*(_tensor(p[n]) for n in PMOE.MoE.LEAVES))
    out, _ = PMOE.local_moe(pcfg, _tensor(x), pp.router, pp.w_gate, pp.w_up, pp.w_down)
    C = PMOE._capacity(pcfg, 80)
    assert C == math.ceil(1.25 * 80 * 2 / 4) == 50
    assert bool((out[C:] == 0).all()) and bool((out[:C].abs().sum(-1) > 0).all())


def test_moe_apply_matches_reference_moe_apply():
    """Through ``moe_apply`` on (B, S, D) tokens, as the model calls it
    in prefill and decode, against the reference's ``moe_apply`` with no
    mesh and its ``decode`` flag off and on."""
    rcfg, pcfg = _configs(compute_dtype="float32")
    p, _ = _case(rcfg, 1, "float32")
    pp = PMOE.MoE(*(_tensor(p[n]) for n in PMOE.MoE.LEAVES))
    x = np.random.default_rng(7).standard_normal((2, 24, rcfg.d_model)).astype(np.float32)
    for decode, xs in ((False, x), (True, x[:, :1])):
        want, want_aux = RMOE.moe_apply(rcfg, p, jnp.asarray(xs), decode=decode)
        got, aux = PMOE.moe_apply(pcfg, pp, torch.as_tensor(xs))
        assert got.shape == xs.shape
        assert_rel_to_scale(got, want, rtol=F32_RTOL, what=f"decode={decode}")
        assert float(aux) == pytest.approx(float(want_aux), rel=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_a2a_without_a_mesh_matches_reference_moe_ffn_a2a(dtype):
    """``moe_impl="a2a"`` with no mesh answers as the gather path does, as
    the reference's ``moe_ffn_a2a`` with no mesh does (its single-device
    branch), at a capacity that drops tokens."""
    rcfg, pcfg = _configs(compute_dtype=dtype, moe_impl="a2a", capacity_factor=0.5)
    p, _ = _case(rcfg, 1, dtype)
    pp = PMOE.MoE(*(_tensor(p[n]) for n in PMOE.MoE.LEAVES))
    x = np.random.default_rng(8).standard_normal((2, 24, rcfg.d_model)).astype(np.float32)
    xj = jnp.asarray(x, jnp.dtype(dtype))
    want, want_aux = RMOE.moe_ffn_a2a(rcfg, p, xj)
    with PMOE.drop_tally() as drops:
        got, aux = PMOE.moe_apply(pcfg, pp, _tensor(xj))
    assert sum(int(d) for d in drops) > 0  # the capacity binds
    if dtype == "float32":
        assert_rel_to_scale(got, want, rtol=F32_RTOL, what="a2a, no mesh")
    else:
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                   atol=BF16_TOL, rtol=BF16_TOL, err_msg="a2a, no mesh")
    assert float(aux) == pytest.approx(float(want_aux), rel=1e-5)


@pytest.mark.parametrize("impl", ["gather", "a2a"])
def test_mesh_forward_needing_grad_raises(impl):
    """A mesh forward that needs a gradient raised while the collectives
    had no backward; now it runs.  Under a mesh of one rank, where every
    collective and its backward are the identity, the output and the
    gradients of the tokens, the router and the experts equal the no-mesh
    ones: bit for bit on the gather path; within rel 1e-5 on the
    all-to-all path, which dispatches in two levels, at a capacity factor
    of 8 where neither drops (across ranks:
    ``tests/test_torch_parallel_train.py``)."""
    from repro_torch.parallel import context as ctx

    _, pcfg = _configs(compute_dtype="float32", moe_impl=impl, capacity_factor=8.0)
    x0 = torch.as_tensor(np.random.default_rng(3).standard_normal((2, 8, pcfg.d_model)),
                         dtype=torch.float32)

    def run(mesh):
        pp = PMOE.init_moe_params(pcfg, torch.Generator().manual_seed(0), torch.float32, "cpu")
        for name in PMOE.MoE.LEAVES:
            getattr(pp, name).requires_grad_(True)
        x = x0.clone().requires_grad_(True)
        with ctx.use_mesh(mesh):
            out, aux = PMOE.moe_apply(pcfg, pp, x)
            (out.square().sum() + aux).backward()
        return out.detach(), [x.grad] + [getattr(pp, n).grad for n in PMOE.MoE.LEAVES]

    out, grads = run(ctx.Mesh(("data", "model"), (1, 1)))
    want, want_grads = run(None)
    for g, w in zip([out] + grads, [want] + want_grads):
        assert g is not None
        if impl == "gather":
            assert torch.equal(g, w)
        else:
            assert_rel_to_scale(g, w, rtol=1e-5, what="a2a at one rank")
    assert float(grads[1].abs().max()) > 0  # the router's gradient reaches it


def test_init_matches_reference_leaves():
    """Leaf names, shapes and dtypes as the reference's (router float32,
    experts in the given dtype), random leaves at its scales."""
    rcfg, pcfg = _configs(n_experts=8)
    ref = RMOE.init_moe_params(jax.random.PRNGKey(0), rcfg, jnp.bfloat16)
    port = PMOE.init_moe_params(pcfg, torch.Generator().manual_seed(0), torch.bfloat16, "cpu")
    assert tuple(ref) == PMOE.MoE.LEAVES
    for name in PMOE.MoE.LEAVES:
        got, want = getattr(port, name), np.asarray(ref[name], np.float32)
        assert tuple(got.shape) == want.shape, name
        assert str(got.dtype).removeprefix("torch.") == str(ref[name].dtype), name
        assert float(got.float().std()) == pytest.approx(float(want.std()), rel=0.1), name
