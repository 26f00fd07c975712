"""The port's flash attention (K1) against the reference.

On the CPU the wrapper runs its plain PyTorch version; it is held against
the reference's Pallas kernel in interpret mode and its jnp oracle over
the reference's kernel sweep (``tests/test_kernels.py``: MHA, GQA 4:1,
MQA with Skv > Sq, dh 128; float32 at 2e-5, bfloat16 at 2e-2; window 32
and 64, soft-cap 30, non-causal), from numpy-seeded inputs, and
``mha_flash`` against the model's ``blocked_attention`` at 2e-4; plus
dh 80 (h2o-danube-1.8b's) in the sweep, and every registered attention
config's head dim among the kernels' ``HEAD_DIMS``.  The plain backward
(``attention_bwd_ref``, and ``mha_flash`` under autograd) is held at rel
1e-4 of each gradient's scale against ``jax.grad`` of the reference's
``attention_ref`` (GQA, window, soft-cap, non-causal, Skv > Sq, dh 80),
whole and chunked over rows.  The CUDA kernels themselves are held against
the plain versions on the card by ``tests/test_torch_cuda.py`` and by
``chip_smoke.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.kernels.flash_attention.kernel as port_kernel
from repro.kernels.flash_attention.kernel import flash_attention as ref_flash_attention
from repro.kernels.flash_attention.ref import attention_ref as ref_attention_ref
from repro.models.attention import blocked_attention
from repro_torch.kernels.flash_attention.ops import mha_flash
from repro_torch.kernels.flash_attention.ref import (
    attention_bwd_ref,
    attention_lse_ref,
    attention_ref,
)

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


def test_every_registered_attention_config_meets_the_bf16_backward_tma_rule():
    """The bf16 backward reads q, k, v and dO through TMA and checks every
    operand and gradient buffer for a 16-byte-aligned base and strides.  In
    the training layout (B, S, H, dh), viewed as (B, H, S, dh), as the model
    and ``ops.mha_flash`` hand them over, every registered attention config
    meets that rule, so no training step raises on the card."""
    from repro_torch.configs.base import get_config, list_configs

    with_attention = [
        cfg for cfg in map(get_config, list_configs())
        if any(cfg.mixer_kind(slot) == "attn" for slot in range(cfg.group_size))
    ]
    B, S = 2, 24
    for cfg in with_attention:
        H, Kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        q, out, dout, dq = (torch.empty((B, S, H, dh), dtype=torch.bfloat16) for _ in range(4))
        k, v, dk, dv = (torch.empty((B, S, Kv, dh), dtype=torch.bfloat16) for _ in range(4))
        views = dict(q=q, k=k, v=v, out=out, dout=dout, dq=dq, dk=dk, dv=dv)
        for name, t in views.items():
            view = t.transpose(1, 2)
            assert port_kernel._tma_aligned(view), (cfg.name, name, view.stride())


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
    with pytest.raises(ValueError):  # meta, as the card: a head dim with no kernel
        port_kernel.flash_attention(*(torch.empty(1, 4, 16, 24, device="meta")
                                      for _ in range(3)))


BWD_CASES = [
    # B, H, Kv, Sq, Skv, dh, options
    (1, 4, 4, 48, 48, 16, dict(causal=True)),
    (2, 8, 2, 40, 40, 32, dict(causal=True, window=12)),  # GQA 4:1
    (1, 4, 2, 33, 33, 80, dict(causal=True, logit_cap=5.0)),  # danube's dh
    (1, 4, 1, 24, 56, 32, dict(causal=True)),  # MQA, Skv > Sq
    (1, 2, 2, 30, 30, 16, dict(causal=False, window=0, logit_cap=2.0)),
    (1, 8, 1, 36, 36, 16, dict(causal=True, window=9, logit_cap=3.0)),  # GQA 8:1
]


def _ref_grads(arrays, dout, options):
    """``jax.grad`` of the reference attention's ``sum(out * dout)``."""
    def f(q, k, v):
        return jnp.sum(ref_attention_ref(q, k, v, **options) * dout)

    return jax.grad(f, argnums=(0, 1, 2))(*arrays)


@pytest.mark.parametrize("B,H,Kv,Sq,Skv,dh,options", BWD_CASES)
def test_plain_backward_matches_jax_grad_of_reference(B, H, Kv, Sq, Skv, dh, options):
    from _torch_parity import assert_rel_to_scale

    arrays = _qkv(9, B, H, Kv, Sq, Skv, dh)
    dout = np.random.default_rng(10).standard_normal((B, H, Sq, dh)).astype(np.float32)
    want = _ref_grads(arrays, dout, options)
    t = tuple(torch.as_tensor(a) for a in arrays)
    for rows in (None, 7):
        got = attention_bwd_ref(*t, torch.as_tensor(dout), rows=rows, **options)
        for name, g, w in zip("qkv", got, want):
            assert g.dtype == torch.float32
            assert_rel_to_scale(g, w, rtol=1e-4, what=f"d{name} rows={rows}")
    # the wrapper's CPU path and mha_flash under autograd, in the model layout
    got = port_kernel.flash_attention_bwd(*t, attention_ref(*t, **options),
                                          torch.as_tensor(dout), None, **options)
    for g, w in zip(got, want):
        assert_rel_to_scale(g, w, rtol=1e-4)
    model = [x.transpose(1, 2).contiguous().requires_grad_() for x in t]
    out = mha_flash(*model, **options)
    out.backward(torch.as_tensor(dout).transpose(1, 2))
    for x, w in zip(model, want):
        assert_rel_to_scale(x.grad.transpose(1, 2), w, rtol=1e-4)


def test_plain_lse_matches_reference_logsumexp():
    arrays = _qkv(11, 1, 4, 2, 40, 40, 32)
    options = dict(window=10, logit_cap=4.0)
    got = attention_lse_ref(*(torch.as_tensor(a) for a in arrays[:2]), **options)
    q, k = (jnp.asarray(a) for a in arrays[:2])
    k = jnp.repeat(k, 2, axis=1)
    s = jnp.einsum("bhqd,bhsd->bhqs", q, k) * 32**-0.5
    s = 4.0 * jnp.tanh(s / 4.0)
    pos = jnp.arange(40)
    ok = (pos[None] <= pos[:, None]) & (pos[None] > pos[:, None] - 10)
    want = jax.nn.logsumexp(jnp.where(ok, s, -1e30), axis=-1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    lse = torch.empty((1, 4, 40))
    port_kernel.flash_attention(*(torch.as_tensor(a) for a in arrays), lse=lse, **options)
    torch.testing.assert_close(lse, got, rtol=0, atol=0)


def test_rows_that_see_no_key_get_zero_gradients():
    """Sq > Skv under the causal mask: the first Sq - Skv rows see no key;
    their dq is exactly 0, they add nothing to dk or dv, and nothing is
    NaN."""
    q, k, v = (torch.as_tensor(a) for a in _qkv(12, 1, 2, 2, 20, 12, 16))
    dout = torch.ones_like(q)
    dq, dk, dv = attention_bwd_ref(q, k, v, dout)
    assert all(bool(torch.isfinite(g).all()) for g in (dq, dk, dv))
    assert not dq[:, :, :8].any()
    _, dk_live, dv_live = attention_bwd_ref(q[:, :, 8:], k, v, dout[:, :, 8:])
    torch.testing.assert_close(dk, dk_live, rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(dv, dv_live, rtol=1e-6, atol=1e-7)


def test_backward_wrapper_rejects_bad_inputs():
    q, k, v = (torch.as_tensor(a) for a in _qkv(13, 1, 4, 2, 16, 16, 16))
    out = attention_ref(q, k, v)
    with pytest.raises(ValueError):  # dout of the wrong shape
        port_kernel.flash_attention_bwd(q, k, v, out, out[:, :, :8], None)
    with pytest.raises(ValueError):  # meta, as the card: no log-sum-exp
        port_kernel.flash_attention_bwd(*(t.to("meta") for t in (q, k, v, out, out)), None)
    with pytest.raises(ValueError):  # lse of the wrong shape
        port_kernel.flash_attention(q, k, v, lse=torch.empty(1, 4, 8))
