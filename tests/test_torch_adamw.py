"""The port's AdamW (``repro_torch.optim.adamw``) against the reference's
on the same numpy-seeded parameters and gradients.

Both sides compute in float32 in the same order (bias corrections in
float32, ``(m / c1) / (sqrt(v / c2) + eps)``, decay added to the step),
so ten steps agree to rel 1e-6; the schedule and the clipping too."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import assert_close, to_np

from repro.optim import adamw as ref
from repro_torch.optim import adamw as port

SHAPES = {"w_in": (6, 4), "norm": (4,), "D": (3,), "blocks": [(2, 5), (5,)]}


def _tree(rng, scale=1.0):
    return {
        "w_in": rng.standard_normal(SHAPES["w_in"]).astype(np.float32) * scale,
        "norm": rng.standard_normal(SHAPES["norm"]).astype(np.float32) * scale,
        "D": rng.standard_normal(SHAPES["D"]).astype(np.float32) * scale,
        "blocks": [rng.standard_normal(s).astype(np.float32) * scale for s in SHAPES["blocks"]],
    }


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v) for v in tree]
    return fn(tree)


def _leaves(tree):
    """Leaves in JAX's flattening order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


@pytest.mark.parametrize("weight_decay", [0.1, 0.0])
def test_ten_updates_match_reference(weight_decay):
    rng = np.random.default_rng(0)
    params = _tree(rng)
    grads = [_tree(rng, 0.3) for _ in range(10)]
    schedule_r = ref.cosine_schedule(1e-2, 3, 10)
    schedule_p = port.cosine_schedule(1e-2, 3, 10)

    rp, rs = _map(jnp.asarray, params), ref.init(_map(jnp.asarray, params))
    pp = _map(torch.tensor, params)  # copies: the port updates them in place
    ps = port.init(pp)
    for g in grads:
        rp, rs = ref.update(_map(jnp.asarray, g), rs, rp, lr=schedule_r(rs.step),
                            weight_decay=weight_decay)
        ps = port.update_(_map(torch.as_tensor, g), ps, pp, lr=schedule_p(ps.step),
                          weight_decay=weight_decay)
    assert int(ps.step) == int(rs.step) == 10
    for got, want in zip(_leaves(pp), _leaves(rp)):
        assert_close(got, want, rtol=1e-6, atol=1e-7, what="params")
    for got, want in zip(_leaves(ps.m) + _leaves(ps.v), _leaves(rs.m) + _leaves(rs.v)):
        assert_close(got, want, rtol=1e-6, atol=1e-12, what="moments")


def test_decay_mask_is_keyed_on_the_leaf_name():
    params = {"w": torch.ones(2, 2), "final_norm": torch.ones(2), "A_log": torch.ones(2),
              "layers": [torch.ones(2)]}
    zeros = _map(torch.zeros_like, params)
    new = params
    port.update_(zeros, port.init(params), params, lr=1.0, weight_decay=0.5)
    assert torch.equal(new["w"], torch.full((2, 2), 0.5))  # decayed
    assert torch.equal(new["final_norm"], torch.ones(2))  # "norm" in the name
    assert torch.equal(new["A_log"], torch.ones(2))  # excluded by name
    assert torch.equal(new["layers"][0], torch.full((2,), 0.5))  # "[0]" decays


def test_cosine_schedule_matches_reference():
    steps = np.arange(0, 130, 7, dtype=np.int32)
    for args in [(3e-4, 10, 100), (1.0, 0, 50, 0.2), (0.5, 20, 20)]:
        want = np.asarray(ref.cosine_schedule(*args)(jnp.asarray(steps)))
        got = to_np(port.cosine_schedule(*args)(torch.as_tensor(steps)))
        np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_by_global_norm_matches_reference(max_norm):
    g = _tree(np.random.default_rng(3))
    want, want_norm = ref.clip_by_global_norm(_map(jnp.asarray, g), max_norm)
    got = _map(torch.tensor, g)
    got_norm = port.clip_by_global_norm_(got, max_norm)
    assert_close(got_norm, want_norm, rtol=1e-6, what="norm")
    for a, b in zip(_leaves(got), _leaves(want)):
        assert_close(a, b, rtol=1e-6, atol=1e-8, what="clipped")


def test_init_moment_dtype():
    params = {"w": torch.ones(3, dtype=torch.float32), "idx": torch.arange(3)}
    state = port.init(params, moment_dtype="bfloat16")
    assert state.m["w"].dtype == torch.bfloat16 and state.v["w"].dtype == torch.bfloat16
    assert state.m["idx"].dtype == torch.int64  # non-float leaves keep their dtype
    assert state.step.dtype == torch.int32 and int(state.step) == 0
