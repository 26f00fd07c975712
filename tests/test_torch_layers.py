"""The port's shared layers (``repro_torch.models.layers``) against the
reference's ``repro.models.layers``, function by function, in float32 on
numpy-seeded inputs: within rel 1e-6 of the largest magnitude of the
reference's output (the matmuls and transcendentals of the two
frameworks round in other orders, so near-zero entries are held to the
output's scale, not their own)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_rel_to_scale
from repro.models import layers as R
from repro_torch.models import layers as P

RTOL = 1e-6


def _rng(seed):
    return np.random.default_rng(seed)


def _normal(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("eps", [1e-5, 1e-6])
def test_rms_norm(eps):
    rng = _rng(0)
    x, w = _normal(rng, 2, 5, 64), _normal(rng, 64, scale=0.1)
    got = P.rms_norm(torch.as_tensor(x), torch.as_tensor(w), eps)
    assert got.dtype == torch.float32
    assert_rel_to_scale(got, R.rms_norm(jnp.asarray(x), jnp.asarray(w), eps), rtol=RTOL)


def test_rms_norm_keeps_bf16_and_computes_in_f32():
    rng = _rng(1)
    x, w = _normal(rng, 3, 32), _normal(rng, 32, scale=0.1)
    got = P.rms_norm(torch.as_tensor(x).to(torch.bfloat16), torch.as_tensor(w), 1e-5)
    want = R.rms_norm(jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(w), 1e-5)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


@pytest.mark.parametrize("cap", [0.0, 30.0, 50.0])
def test_softcap(cap):
    x = _normal(_rng(2), 4, 128, scale=40.0)
    got = P.softcap(torch.as_tensor(x), cap)
    assert_rel_to_scale(got, R.softcap(jnp.asarray(x), cap), rtol=RTOL)


@pytest.mark.parametrize("theta", [10_000.0, 500_000.0])
def test_rope(theta):
    rng = _rng(3)
    x = _normal(rng, 2, 24, 4, 16)
    positions = np.arange(100, 124, dtype=np.int32)[None]
    got = P.rope(torch.as_tensor(x), torch.as_tensor(positions), theta)
    want = R.rope(jnp.asarray(x), jnp.asarray(positions), theta)
    assert_rel_to_scale(got, want, rtol=RTOL)


def test_rope_keeps_bf16():
    x = _normal(_rng(4), 1, 8, 2, 16)
    positions = np.arange(8, dtype=np.int32)[None]
    got = P.rope(torch.as_tensor(x).to(torch.bfloat16), torch.as_tensor(positions), 10_000.0)
    want = R.rope(jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(positions), 10_000.0)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=1e-2, rtol=1e-2)


def test_swiglu():
    rng = _rng(5)
    x = _normal(rng, 2, 6, 64)
    ws = (_normal(rng, 64, 128, scale=0.125), _normal(rng, 64, 128, scale=0.125),
          _normal(rng, 128, 64, scale=0.09))
    got = P.swiglu(torch.as_tensor(x), *(torch.as_tensor(w) for w in ws))
    assert_rel_to_scale(got, R.swiglu(jnp.asarray(x), *(jnp.asarray(w) for w in ws)), rtol=RTOL)


def test_embed():
    rng = _rng(6)
    table = _normal(rng, 512, 64)
    tokens = rng.integers(0, 512, (3, 7)).astype(np.int32)
    got = P.embed(torch.as_tensor(tokens), torch.as_tensor(table))
    np.testing.assert_array_equal(got.numpy(), np.asarray(R.embed(jnp.asarray(tokens), jnp.asarray(table))))


@pytest.mark.parametrize("transpose,cap", [(False, 0.0), (True, 0.0), (True, 30.0)])
def test_unembed(transpose, cap):
    rng = _rng(7)
    x = _normal(rng, 2, 5, 64)
    table = _normal(rng, *((512, 64) if transpose else (64, 512)), scale=0.5)
    got = P.unembed(torch.as_tensor(x), torch.as_tensor(table), transpose=transpose, cap=cap)
    want = R.unembed(jnp.asarray(x), jnp.asarray(table), transpose=transpose, cap=cap)
    assert_rel_to_scale(got, want, rtol=RTOL)

