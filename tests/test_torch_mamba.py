"""The port's mamba mixer (``repro_torch.models.mamba``) against the
reference's (``repro.models.mamba``), on the reduced falcon-mamba-7b
(d_model 64, d_inner 128, N 8), with numpy-seeded inputs and the
reference's own parameters.

* Prefill: the reference's ``mamba_mixer`` scans in chunks of an
  associative scan whose states, ``da``, ``dbx`` and C are stored in bf16
  even at a float32 compute dtype; the port's scan (K2's plain version on
  the CPU) is float32.  So the port is held at rel 1e-4 against the
  reference's float32 composition (its ``_causal_conv``, ``_ssm_inputs``
  and ``selective_scan_ref``, then D, the gate and ``out_proj``) and at
  2e-2 elementwise against ``mamba_mixer`` itself.
* Decode: both sides step in float32, so ``mamba_decode`` is held at rel
  1e-4 over several steps, with the new conv window and state.
* Within the port, a prompt through ``mamba_mixer`` equals the same
  prompt stepped through ``mamba_decode``; and the bf16 model's prefill
  logits equal its decode path's, where the reference's own pair
  differs.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_rel_to_scale
from repro.configs.base import get_config as ref_get_config
from repro.kernels.mamba_scan.ref import selective_scan_ref
from repro.launch import steps as ref_steps
from repro.models import mamba as RMB
from repro.models import model as RM
from repro_torch.configs.base import get_config
from repro_torch.convert import lm_params_from_reference
from repro_torch.launch import steps
from repro_torch.models import mamba as PMB
from repro_torch.models import model as M

B, S = 2, 64
F32_RTOL = 1e-4
BF16_TOL = 2e-2


def _configs(compute_dtype="float32"):
    ref = ref_get_config("falcon-mamba-7b").reduced()
    port = get_config("falcon-mamba-7b").reduced()
    ref = dataclasses.replace(ref, compute_dtype=compute_dtype)
    port = dataclasses.replace(port, compute_dtype=compute_dtype)
    return ref, port


def _params(rcfg, dtype=jnp.float32):
    """The reference's parameters (``conv_b`` and ``dt_bias`` drawn away
    from their constant init so that both enter the comparison) and the
    port's :class:`Mamba` holding the same values."""
    p = RMB.init_mamba_params(jax.random.PRNGKey(0), rcfg, dtype)
    rng = np.random.default_rng(5)
    p["conv_b"] = jnp.asarray(rng.standard_normal(p["conv_b"].shape) * 0.1, dtype)
    p["dt_bias"] = p["dt_bias"] + jnp.asarray(rng.standard_normal(p["dt_bias"].shape), dtype)
    return p, PMB.Mamba(*(_tensor(p[n]) for n in PMB.Mamba.LEAVES))


def _tensor(a) -> torch.Tensor:
    """A JAX array as a tensor of its dtype (numpy has no bf16)."""
    return torch.as_tensor(np.array(a, np.float32)).to(getattr(torch, str(a.dtype)))


def _x(rcfg, seed=1, steps=S, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal((B, steps, rcfg.d_model)).astype(dtype)


def _ref_f32_mixer(cfg, p, x):
    """The reference's mixer with its scan in float32: its own pieces,
    composed as ``mamba_mixer`` composes them."""
    xin, z = jnp.split(x @ p["in_proj"], 2, axis=-1)
    x_conv = jax.nn.silu(RMB._causal_conv(xin, p["conv_w"], p["conv_b"], None))
    dt, a, b, c = RMB._ssm_inputs(cfg, p, x_conv)
    xf = x_conv.astype(jnp.float32)
    y, _ = selective_scan_ref(dt, a, b, c, xf)
    y = y + xf * p["D"][None, None]
    return (y * jax.nn.silu(z.astype(jnp.float32))).astype(x.dtype) @ p["out_proj"]


def test_init_matches_reference_leaves():
    """Leaf names, shapes and dtypes as the reference's, its constants
    (``conv_b`` 0, ``dt_bias`` -4.6, ``D`` 1) exactly and ``A_log`` =
    log(1..N) to float32's last bit (the two libraries' ``log`` may differ
    there), and the random leaves at the reference's scales."""
    rcfg, pcfg = _configs()
    ref = RMB.init_mamba_params(jax.random.PRNGKey(0), rcfg, jnp.bfloat16)
    port = PMB.init_mamba_params(pcfg, torch.Generator().manual_seed(0), torch.bfloat16, "cpu",
                                 master=torch.bfloat16)
    assert tuple(ref) == PMB.Mamba.LEAVES
    for name in PMB.Mamba.LEAVES:
        got, want = getattr(port, name), np.asarray(ref[name], np.float32)
        assert tuple(got.shape) == want.shape, name
        assert str(got.dtype).removeprefix("torch.") == str(ref[name].dtype), name
        if name in ("conv_b", "dt_bias", "D"):
            np.testing.assert_array_equal(got.float().numpy(), want, err_msg=name)
        elif name == "A_log":
            np.testing.assert_allclose(got.numpy(), want, rtol=2**-23, atol=0, err_msg=name)
        else:  # N(0, scale^2): the draws differ, their spread must not
            assert float(got.float().std()) == pytest.approx(float(want.std()), rel=0.15), name


def test_mixer_matches_reference_float32_composition():
    rcfg, pcfg = _configs()
    p, pp = _params(rcfg)
    x = _x(rcfg)
    want = _ref_f32_mixer(rcfg, p, jnp.asarray(x))
    got = PMB.mamba_mixer(pcfg, pp, torch.as_tensor(x))
    assert got.dtype == torch.float32 and got.shape == (B, S, pcfg.d_model)
    assert_rel_to_scale(got, want, rtol=F32_RTOL, what="mixer vs float32 composition")


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_mixer_matches_reference_mamba_mixer(compute_dtype):
    """Against the reference's own prefill mixer, whose scan rounds to bf16."""
    rcfg, pcfg = _configs(compute_dtype)
    jdt = jnp.dtype(compute_dtype)
    p, pp = _params(rcfg, jdt)
    x = _x(rcfg)
    want = np.asarray(RMB.mamba_mixer(rcfg, p, jnp.asarray(x, jdt)), np.float32)
    got = PMB.mamba_mixer(pcfg, pp, torch.as_tensor(x).to(getattr(torch, compute_dtype)))
    assert got.dtype == getattr(torch, compute_dtype)
    np.testing.assert_allclose(got.float().numpy(), want, atol=BF16_TOL, rtol=BF16_TOL)


def test_decode_steps_match_reference():
    """Eight steps from a zero cache: every output, and after each step the
    conv window and the state, at rel 1e-4 (float32 cache on both sides)."""
    rcfg, pcfg = _configs()
    p, pp = _params(rcfg)
    xs = _x(rcfg, seed=2, steps=8)
    rcache = RMB.init_mamba_cache(rcfg, B, jnp.float32)
    pcache = PMB.init_mamba_cache(pcfg, B, torch.float32, "cpu")
    assert pcache.conv.shape == rcache.conv.shape and pcache.ssm.shape == rcache.ssm.shape
    step = jax.jit(lambda p, x, c: RMB.mamba_decode(rcfg, p, x, c))
    for t in range(xs.shape[1]):
        want, rcache = step(p, jnp.asarray(xs[:, t : t + 1]), rcache)
        got, same = PMB.mamba_decode(pcfg, pp, torch.as_tensor(xs[:, t : t + 1]), pcache)
        assert same is pcache  # updated in place
        assert_rel_to_scale(got, want, rtol=F32_RTOL, what=f"step {t} output")
        assert_rel_to_scale(pcache.conv, rcache.conv, rtol=F32_RTOL, what=f"step {t} conv window")
        assert_rel_to_scale(pcache.ssm, rcache.ssm, rtol=F32_RTOL, what=f"step {t} state")


def test_bf16_cache_holds_the_window_in_bf16():
    """The conv window takes the cache dtype and the state stays float32,
    as in the reference; a bf16 window holds the rounded inputs."""
    rcfg, pcfg = _configs()
    p, pp = _params(rcfg)
    x = _x(rcfg, seed=3, steps=1)
    cache = PMB.init_mamba_cache(pcfg, B, torch.bfloat16, "cpu")
    assert cache.conv.dtype == torch.bfloat16 and cache.ssm.dtype == torch.float32
    PMB.mamba_decode(pcfg, pp, torch.as_tensor(x), cache)
    rcache = RMB.init_mamba_cache(rcfg, B, jnp.bfloat16)
    _, rcache = RMB.mamba_decode(rcfg, p, jnp.asarray(x), rcache)
    assert str(rcache.conv.dtype) == "bfloat16"
    np.testing.assert_allclose(cache.conv.float().numpy(), np.asarray(rcache.conv, np.float32),
                               rtol=2**-8, atol=0)


def test_prompt_through_the_scan_equals_stepping_decode():
    """Within the port: the prefill mixer (K2's plain version) over a
    prompt and ``mamba_decode`` stepped over the same prompt from a zero
    cache give the same outputs at every position."""
    rcfg, pcfg = _configs()
    _, pp = _params(rcfg)
    x = torch.as_tensor(_x(rcfg, seed=4, steps=24))
    full = PMB.mamba_mixer(pcfg, pp, x)
    cache = PMB.init_mamba_cache(pcfg, B, torch.float32, "cpu")
    stepped = torch.cat([PMB.mamba_decode(pcfg, pp, x[:, t : t + 1], cache)[0]
                         for t in range(x.shape[1])], dim=1)
    assert_rel_to_scale(stepped, full, rtol=F32_RTOL, what="decode vs prefill")


def test_bf16_model_prefill_equals_its_decode_path():
    """The bf16 model at 16 layers of the reduced widths, as served (bf16
    weights and conv window): the prefill's logits at the last of 24
    positions against the decode path's, teacher-forced over the same
    tokens.  On the CPU the port's two paths round in the same places and
    agree (gap 0 measured), so neither holds a bf16-only fault such as in
    the conv window or the softplus; the reference's pair differs by
    5.0e-2 of scale, its prefill scan storing bf16 states and its decode
    float32 ones.  On a card the two paths' GEMM and conv kernels differ
    with the shape, and the gap is the rounding that leaves."""
    layers, steps_run = 16, 24
    rcfg, pcfg = (dataclasses.replace(c.reduced(), compute_dtype="bfloat16", n_layers=layers)
                  for c in (ref_get_config("falcon-mamba-7b"), get_config("falcon-mamba-7b")))
    rparams = RM.init_params(rcfg, jax.random.PRNGKey(0))
    params = M.cast_for_compute(
        pcfg, lm_params_from_reference(pcfg, jax.tree.map(np.asarray, rparams), device="cpu"))
    tokens = np.random.default_rng(6).integers(0, rcfg.vocab_size, (B, steps_run)).astype(np.int32)

    def gap(got, want):
        got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
        return float(np.abs(got - want).max() / np.abs(want).max())

    prefill = steps.make_prefill_step(pcfg)(params, {"tokens": torch.as_tensor(tokens)})
    decode = steps.make_decode_step(pcfg, cast=False)
    cache = M.init_cache(pcfg, B, steps_run, torch.bfloat16, device="cpu")
    ref_prefill = jax.jit(ref_steps.make_prefill_step(rcfg))(rparams, {"tokens": tokens})
    ref_decode = jax.jit(ref_steps.make_decode_step(rcfg))
    ref_cache = RM.init_cache(rcfg, B, steps_run, jnp.bfloat16)
    for t in range(steps_run):
        _, logits, cache = decode(params, cache, torch.as_tensor(tokens[:, t : t + 1]), t)
        _, ref_logits, ref_cache = ref_decode(rparams, ref_cache, tokens[:, t : t + 1],
                                              jnp.asarray(t, jnp.int32))
    port_gap = gap(logits.float().numpy(), prefill.float().numpy())
    ref_gap = gap(ref_logits, ref_prefill)
    assert port_gap <= 1e-3 < ref_gap, (port_gap, ref_gap)
