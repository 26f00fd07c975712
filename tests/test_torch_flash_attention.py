"""The port's flash attention (K1) against the reference.

On the CPU the wrapper runs its plain PyTorch version; it is held against
the reference's Pallas kernel in interpret mode and its jnp oracle over
the reference's kernel sweep (``tests/test_kernels.py``: MHA, GQA 4:1,
MQA with Skv > Sq, dh 128; float32 at 2e-5, bfloat16 at 2e-2; window 32
and 64, soft-cap 30, non-causal), from numpy-seeded inputs, and
``mha_flash`` against the model's ``blocked_attention`` at 2e-4; plus
dh 80 (h2o-danube-1.8b's) in the sweep, and every registered attention
config's head dim among the kernels' ``HEAD_DIMS``.  The
CUDA kernel itself is held against the plain version on the card by
``tests/test_torch_cuda.py`` and by ``chip_smoke.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.kernels.flash_attention.kernel as port_kernel
from repro.kernels.flash_attention.kernel import flash_attention as ref_flash_attention
from repro.kernels.flash_attention.ref import attention_ref as ref_attention_ref
from repro.models.attention import blocked_attention
from repro_torch.kernels.flash_attention.ops import mha_flash
from repro_torch.kernels.flash_attention.ref import attention_ref

TOL = {"float32": dict(atol=2e-5, rtol=2e-5), "bfloat16": dict(atol=2e-2, rtol=2e-2)}
SWEEP = [
    # B, H, Kv, Sq, Skv, dh, block (the reference kernel's tiling)
    (1, 4, 4, 128, 128, 64, 64),  # MHA square
    (2, 8, 2, 128, 128, 64, 64),  # GQA 4:1
    (1, 4, 1, 64, 256, 32, 64),  # MQA, Skv > Sq (right-aligned)
    (1, 2, 2, 256, 256, 128, 128),  # wide head
    (1, 4, 2, 128, 128, 80, 64),  # h2o-danube-1.8b's head dim (2560 / 32)
    (1, 8, 1, 128, 128, 64, 64),  # GQA 8:1 (qwen3-moe-30b-a3b's 32:4)
]


def _qkv(seed, B, H, Kv, Sq, Skv, dh):
    """The reference tests' distribution (0.5 x standard normal), drawn
    with numpy, float32."""
    rng = np.random.default_rng(seed)
    return tuple(
        (rng.standard_normal(shape) * 0.5).astype(np.float32)
        for shape in ((B, H, Sq, dh), (B, Kv, Skv, dh), (B, Kv, Skv, dh))
    )


def _both(arrays, dtype: str):
    """The same values for both sides: numpy float32 rounded to ``dtype``
    by each framework (round to nearest even in both)."""
    jax_side = tuple(jnp.asarray(a).astype(dtype) for a in arrays)
    torch_side = tuple(torch.as_tensor(a).to(getattr(torch, dtype)) for a in arrays)
    return jax_side, torch_side


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,Kv,Sq,Skv,dh,block", SWEEP)
def test_flash_attention_sweep_matches_reference_kernel_and_oracle(dtype, B, H, Kv, Sq, Skv, dh, block):
    (jq, jk, jv), (q, k, v) = _both(_qkv(0, B, H, Kv, Sq, Skv, dh), dtype)
    got = port_kernel.flash_attention(q, k, v, causal=True)
    assert got.dtype == q.dtype and got.shape == q.shape
    want_kernel = ref_flash_attention(
        jq, jk, jv, causal=True, block_q=block, block_kv=block, interpret=True
    )
    want_ref = ref_attention_ref(jq, jk, jv, causal=True)
    np.testing.assert_allclose(_f32(got), _f32(want_kernel), **TOL[dtype])
    np.testing.assert_allclose(_f32(got), _f32(want_ref), **TOL[dtype])


@pytest.mark.parametrize(
    "shape,block,kwargs",
    [
        ((1, 4, 2, 128, 128, 64), 64, dict(causal=True, window=32)),
        ((1, 4, 2, 128, 128, 64), 64, dict(causal=True, window=64)),
        ((1, 2, 2, 64, 64, 32), 32, dict(causal=True, logit_cap=30.0)),
        ((1, 2, 2, 64, 64, 32), 32, dict(causal=False)),
    ],
    ids=["window32", "window64", "softcap30", "noncausal"],
)
def test_flash_attention_options_match_reference(shape, block, kwargs):
    (jq, jk, jv), (q, k, v) = _both(_qkv(1, *shape), "float32")
    got = port_kernel.flash_attention(q, k, v, **kwargs)
    want_kernel = ref_flash_attention(
        jq, jk, jv, block_q=block, block_kv=block, interpret=True, **kwargs
    )
    want_ref = ref_attention_ref(jq, jk, jv, **kwargs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_kernel), **TOL["float32"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want_ref), **TOL["float32"])


def test_mha_flash_matches_model_blocked_attention():
    """The wrapper in the model's (B, S, H, dh) layout against the model's
    blocked-XLA attention (the reference's prefill core)."""
    B, H, Kv, S, dh = 2, 8, 4, 128, 32
    arrays = tuple(a.transpose(0, 2, 1, 3) for a in _qkv(4, B, H, Kv, S, S, dh))
    got = mha_flash(*(torch.as_tensor(np.ascontiguousarray(a)) for a in arrays), causal=True)
    assert got.shape == (B, S, H, dh)
    want = blocked_attention(*arrays, causal=True, block_q=64, block_kv=64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=2e-4)


def test_plain_version_matches_oracle_on_ragged_and_windowed_shapes():
    """Sizes the reference kernel cannot take (S not a multiple of a
    block), against the jnp oracle: window with soft-cap, Skv > Sq."""
    for seed, shape, kwargs in [
        (5, (1, 4, 2, 77, 101, 32), dict(window=16, logit_cap=5.0)),
        (6, (2, 4, 4, 300, 300, 16), dict(causal=True)),
    ]:
        arrays = _qkv(seed, *shape)
        got = attention_ref(*(torch.as_tensor(a) for a in arrays), **kwargs)
        want = ref_attention_ref(*arrays, **kwargs)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL["float32"])


def test_cpu_tensors_take_the_plain_version_without_counting():
    q, k, v = (torch.as_tensor(a) for a in _qkv(7, 1, 2, 1, 16, 16, 16))
    before = port_kernel.flash_attention.launches
    out = torch.empty_like(q)
    got = port_kernel.flash_attention(q, k, v, out=out)
    assert got is out
    assert port_kernel.flash_attention.launches == before
    torch.testing.assert_close(out, attention_ref(q, k, v), rtol=0, atol=0)


def test_every_registered_attention_config_has_a_kernel_head_dim():
    """Every config whose layers have an attention slot runs its prefill
    through K1 on the card, so its head dim must be one the kernels take
    (h2o-danube-1.8b's 80 was missing, and its prefill raised)."""
    from repro_torch.configs.base import get_config, list_configs

    with_attention = [
        cfg for cfg in map(get_config, list_configs())
        if any(cfg.mixer_kind(slot) == "attn" for slot in range(cfg.group_size))
    ]
    assert {c.name for c in with_attention} >= {"llama3-8b", "gemma2-9b", "h2o-danube-1.8b"}
    missing = {c.name: c.head_dim for c in with_attention if c.head_dim not in port_kernel.HEAD_DIMS}
    assert not missing, f"head dims without a kernel instantiation: {missing}"


def test_wrapper_rejects_bad_inputs():
    q, k, v = (torch.as_tensor(a) for a in _qkv(8, 1, 4, 2, 16, 16, 16))
    with pytest.raises(TypeError):
        port_kernel.flash_attention(q.double(), k.double(), v.double())
    with pytest.raises(ValueError):  # mixed dtypes
        port_kernel.flash_attention(q, k.to(torch.bfloat16), v)
    with pytest.raises(ValueError):  # 3 q-heads over 2 kv-heads
        port_kernel.flash_attention(q[:, :3], k, v)
    with pytest.raises(ValueError):  # k and v disagree
        port_kernel.flash_attention(q, k, v[:, :, :8])
    with pytest.raises(ValueError):
        port_kernel.flash_attention(q[0], k[0], v[0])
    with pytest.raises(ValueError):  # out of the wrong shape
        port_kernel.flash_attention(q, k, v, out=torch.empty(1, 4, 8, 16))
    with pytest.raises(ValueError):  # neither cpu nor cuda
        port_kernel.flash_attention(*(t.to("meta") for t in (q, k, v)))
