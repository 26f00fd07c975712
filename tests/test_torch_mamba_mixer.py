"""The mamba mixer's prefill passes (``repro_torch.kernels.mamba_mixer``):
the conv with its SiLU, the dt softplus, and the D skip with the silu(z)
gate.

On the CPU (no CUDA): each plain version against its slice of the
reference mixer (``repro.models.mamba``) in float32 and bf16; the
refactored chain against a copy of the chain as it was before the passes
existed, bit for bit, outputs and gradients; and the routing, with the
kernels' wrappers replaced by recorders and the card check faked: a call
that autograd does not record reaches each pass once a layer, one it
records and ``mamba_decode`` never do.

On a card (``gpu``): each kernel against its plain version run on the
card (today's chain there) at falcon-mamba-7b's and jamba-1.5-large's
d_inner in bf16 and float32, within one ulp of the compute dtype at every
element; the served mixer against the chain at the prefill parity; the
launch counters per prefill and across a training step.  JAX is imported
only by the CPU tests' fixture, so the file collects where only torch is
installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_mamba_mixer.py
"""

import dataclasses
import types

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.configs.base import get_config
from repro_torch.kernels.mamba_mixer import kernel as mixer_kernel
from repro_torch.kernels.mamba_mixer.ref import conv_silu_ref, dt_softplus_ref, mixer_gate_ref
from repro_torch.kernels.mamba_scan import kernel as scan_kernel
from repro_torch.kernels.mamba_scan.ops import ssm_scan
from repro_torch.launch import steps
from repro_torch.models import mamba as PMB
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.parallel import context as ctx

F32_RTOL = 1e-6
BF16_TOL = 2e-2
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# B, S; d_inner 100 is no multiple of a kernel's block or vector
CPU_SHAPES = [(b, s) for b in (1, 2) for s in (1, 3, 64)]
D_INNER = 100
PASSES = ("conv_silu", "dt_softplus", "mixer_gate")


@pytest.fixture
def ref():
    """The reference's mamba module, JAX and the parity helpers, imported
    here so that the file collects without JAX."""
    import jax
    import jax.numpy as jnp
    from _torch_parity import assert_rel_to_scale
    from repro.configs.base import get_config as ref_get_config
    from repro.models import mamba as RMB

    cfg = dataclasses.replace(ref_get_config("falcon-mamba-7b").reduced(),
                              d_model=D_INNER // 2)
    return types.SimpleNamespace(jax=jax, jnp=jnp, RMB=RMB, cfg=cfg,
                                 assert_rel_to_scale=assert_rel_to_scale)


def _arrays(seed, shapes: dict) -> dict:
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(shape).astype(np.float32) * scale
            for k, (shape, scale) in shapes.items()}


def _both(ref, a: np.ndarray, dtype: str):
    """``a`` as the reference's array and the port's tensor of ``dtype``
    (the same rounded values)."""
    j = ref.jnp.asarray(a, ref.jnp.dtype(dtype))
    return j, torch.as_tensor(np.array(j, np.float32)).to(DTYPES[dtype])


def _tol(ref, got, want, dtype, what):
    ref.assert_rel_to_scale(got.float(), np.asarray(want, np.float32),
                            rtol=F32_RTOL if dtype == "float32" else BF16_TOL, what=what)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("B,S", CPU_SHAPES)
def test_conv_silu_plain_version_matches_reference(ref, dtype, B, S):
    a = _arrays(1, {"xin": ((B, S, D_INNER), 1.0), "w": ((4, D_INNER), 0.5),
                    "b": ((D_INNER,), 0.1)})
    (jx, tx), (jw, tw), (jb, tb) = (_both(ref, a[k], dtype) for k in ("xin", "w", "b"))
    want = ref.jax.nn.silu(ref.RMB._causal_conv(jx, jw, jb, None))
    x_conv, xf = conv_silu_ref(tx, tw, tb)
    assert x_conv.dtype == DTYPES[dtype] and xf.dtype == torch.float32
    assert torch.equal(xf, x_conv.float())
    _tol(ref, x_conv, want, dtype, "conv + silu")


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("B,S", CPU_SHAPES)
def test_dt_softplus_plain_version_matches_reference(ref, dtype, B, S):
    """Against ``_ssm_inputs``' dt from the same x_conv and leaves (the
    two frameworks' products may differ in their last bits)."""
    cfg, jdt = ref.cfg, ref.jnp.dtype(dtype)
    dtr, n = cfg.dt_rank_actual, cfg.ssm_state
    a = _arrays(2, {"x_conv": ((B, S, D_INNER), 1.0), "x_proj": ((D_INNER, dtr + 2 * n), 0.1),
                    "dt_proj": ((dtr, D_INNER), dtr**-0.5), "dt_bias": ((D_INNER,), 1.0)})
    (jx, tx), (jp, tp_), (jd, td) = (_both(ref, a[k], dtype) for k in ("x_conv", "x_proj",
                                                                      "dt_proj"))
    bias = a["dt_bias"] - 4.6  # the master dtype's values about softplus^-1(0.01)
    p = {"x_proj": jp, "dt_proj": jd, "dt_bias": ref.jnp.asarray(bias), "A_log":
         ref.jnp.zeros((D_INNER, n))}
    want = ref.RMB._ssm_inputs(cfg, p, jx)[0]
    assert want.dtype == ref.jnp.float32 and jx.dtype == jdt
    got = dt_softplus_ref((tx @ tp_)[..., :dtr] @ td, torch.as_tensor(bias))
    assert got.dtype == torch.float32
    _tol(ref, got, want, dtype, "dt softplus")


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("B,S", CPU_SHAPES)
def test_mixer_gate_plain_version_matches_reference(ref, dtype, B, S):
    """Against the reference mixer's lines after its scan: the D skip,
    ``silu(z)`` in float32 and the cast to the compute dtype."""
    jnp = ref.jnp
    a = _arrays(3, {"y": ((B, S, D_INNER), 1.0), "x_conv": ((B, S, D_INNER), 1.0),
                    "D": ((D_INNER,), 0.3), "z": ((B, S, D_INNER), 1.0)})
    (jx, tx), (jz, tz) = _both(ref, a["x_conv"], dtype), _both(ref, a["z"], dtype)
    y, D = a["y"], a["D"] + 1.0
    xf = jx.astype(jnp.float32)
    want = ((y + xf * D[None, None]) * ref.jax.nn.silu(jz.astype(jnp.float32))).astype(jx.dtype)
    got = mixer_gate_ref(torch.as_tensor(y), tx.float(), torch.as_tensor(D), tz)
    assert got.dtype == DTYPES[dtype]
    _tol(ref, got, want, dtype, "D skip and gate")


# --------------------------------------------------------------------------
# The chain as it was before the passes existed (models/mamba.py), kept
# verbatim as the yardstick of the refactored one.


def _old_causal_conv(x, w, b, history):
    k = w.shape[0]
    if history is None:
        pad = x.new_zeros((x.shape[0], k - 1, x.shape[2]))
    else:
        pad = history.to(x.dtype)
    xp = torch.cat([pad, x], dim=1).transpose(1, 2)
    out = F.conv1d(xp, w.T[:, None, :], b, groups=w.shape[1])
    return out.transpose(1, 2)


def _old_ssm_inputs(cfg, p, x_conv):
    dtr, n = cfg.dt_rank_actual, cfg.ssm_state
    tp = ctx.physical_axes("tp")
    x_dbl = ctx.fan_out(ctx.matmul_psum(x_conv, p.x_proj, tp), tp)
    dt, b, c = x_dbl.split([dtr, n, n], dim=-1)
    dt = F.softplus(dt @ p.dt_proj + p.dt_bias.to(x_conv.dtype)).float()
    a = -torch.exp(p.A_log)
    return dt, a, b.float(), c.float()


def _old_mamba_mixer(cfg, p, x):
    x = ctx.fan_out(x, ctx.physical_axes("tp"))
    xin, z = (x @ p.in_proj).chunk(2, dim=-1)
    x_conv = F.silu(_old_causal_conv(xin, p.conv_w, p.conv_b, None))
    dt, a, b, c = _old_ssm_inputs(cfg, p, x_conv)
    xf = x_conv.float()
    y = ssm_scan(dt, a, b, c, xf)
    out = ((y + xf * p.D) * F.silu(z.float())).to(x.dtype)
    return ctx.matmul_psum(out, p.out_proj, ctx.physical_axes("tp"))


def _mixer(dtype: str, *, trainable: bool):
    """The reduced falcon-mamba-7b's config, one mixer's leaves (``conv_b``
    and ``dt_bias`` drawn away from their constants, ``dt_bias`` and ``D``
    float32 as served) and an input, in ``dtype``."""
    cfg = dataclasses.replace(get_config("falcon-mamba-7b").reduced(), compute_dtype=dtype)
    p = PMB.init_mamba_params(cfg, torch.Generator().manual_seed(0), DTYPES[dtype], "cpu")
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        p.conv_b.copy_(torch.randn(p.conv_b.shape, generator=gen) * 0.1)
        p.dt_bias.add_(torch.randn(p.dt_bias.shape, generator=gen))
    for t in p.parameters():
        t.requires_grad_(trainable)
    x = torch.randn((2, 24, cfg.d_model), generator=gen).to(DTYPES[dtype])
    return cfg, p, x.requires_grad_(trainable)


def _fake_card(monkeypatch):
    """The mixer's card check answers yes for CPU tensors."""
    monkeypatch.setattr(PMB, "_on_card", lambda x: True)


@pytest.mark.parametrize("card", [False, True], ids=["cpu", "fake_card"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_mixer_without_autograd_equals_the_old_chain(monkeypatch, dtype, card):
    """No autograd: on the CPU the chain, and with the card check faked the
    three passes' wrappers (whose CPU branch is the plain version), give
    the old chain's output bit for bit."""
    cfg, p, x = _mixer(dtype, trainable=False)
    if card:
        _fake_card(monkeypatch)
    with torch.no_grad():
        got = PMB.mamba_mixer(cfg, p, x)
        want = _old_mamba_mixer(cfg, p, x)
    assert got.dtype == x.dtype and torch.equal(got, want)


@pytest.mark.parametrize("card", [False, True], ids=["cpu", "fake_card"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_mixer_under_autograd_equals_the_old_chain(monkeypatch, dtype, card):
    """A call autograd records (training's forward and its recompute) keeps
    the plain chain even on a card: output and every gradient, input and
    leaves, equal the old chain's bit for bit."""
    if card:
        _fake_card(monkeypatch)
    results = []
    for fn in (PMB.mamba_mixer, _old_mamba_mixer):
        cfg, p, x = _mixer(dtype, trainable=True)
        out = fn(cfg, p, x)
        g = torch.linspace(-1, 1, out.numel()).reshape(out.shape)
        (out.float() * g).sum().backward()
        results.append([out.detach(), x.grad] + [t.grad for t in p.parameters()])
    names = ["out", "x"] + [n for n, _ in p.named_parameters()]
    for name, got, want in zip(names, *results):
        assert want is not None and torch.equal(got, want), name


class _Recorder:
    """The three pass wrappers replaced by recorders that return the plain
    versions' results."""

    def __init__(self, monkeypatch):
        self.calls = dict.fromkeys(PASSES, 0)
        plain = {
            "conv_silu": conv_silu_ref,
            "dt_softplus": dt_softplus_ref,
            "mixer_gate": lambda y, xc, D, z: mixer_gate_ref(y, xc.float(), D, z),
        }
        for name in PASSES:
            monkeypatch.setattr(mixer_kernel, name, self._record(name, plain[name]))

    def _record(self, name, fn):
        def call(*args):
            self.calls[name] += 1
            return fn(*args)
        return call


def test_prefill_reaches_each_pass_once_a_layer_and_training_never(monkeypatch):
    """Reduced falcon-mamba-7b at 6 layers, the card check faked: a prefill
    step (no autograd) calls each pass once per layer and gives the
    prefill's logits of the unfaked run; a training step calls none."""
    cfg = dataclasses.replace(get_config("falcon-mamba-7b").reduced(), n_layers=6)
    tokens = torch.as_tensor(np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 17)),
                             dtype=torch.int32)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    prefill = steps.make_prefill_step(cfg)
    want = prefill(params, {"tokens": tokens[:, :-1]})
    rec = _Recorder(monkeypatch)
    _fake_card(monkeypatch)
    got = prefill(params, {"tokens": tokens[:, :-1]})
    assert rec.calls == dict.fromkeys(PASSES, cfg.n_layers)
    assert torch.equal(got, want)

    rec.calls = dict.fromkeys(PASSES, 0)
    params = M.train_mode(params)
    opt = adamw.init(steps.param_tree(params), cfg.moment_dtype)
    step = steps.make_train_step(cfg)
    step(params, opt, {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}, 0)
    assert rec.calls == dict.fromkeys(PASSES, 0)


def test_decode_never_reaches_the_passes(monkeypatch):
    """``mamba_decode`` steps through the plain code, the card check faked."""
    cfg, p, x = _mixer("bfloat16", trainable=False)
    rec = _Recorder(monkeypatch)
    _fake_card(monkeypatch)
    cache = PMB.init_mamba_cache(cfg, x.shape[0], torch.bfloat16, "cpu")
    with torch.no_grad():
        for t in range(4):
            PMB.mamba_decode(cfg, p, x[:, t : t + 1], cache)
    assert rec.calls == dict.fromkeys(PASSES, 0)


@pytest.mark.parametrize("name,args", [
    ("conv_silu", lambda: (torch.zeros(1, 4, 8, dtype=torch.float16), torch.zeros(4, 8),
                           torch.zeros(8))),
    ("dt_softplus", lambda: (torch.zeros(4, 8), torch.zeros(8))),
    ("mixer_gate", lambda: (torch.zeros(1, 4, 8), torch.zeros(1, 4, 8), torch.zeros(7),
                            torch.zeros(1, 4, 8))),
])
def test_pass_wrappers_reject_what_the_kernels_do_not_take(name, args):
    """A compute dtype without an instantiation, a 2-D input, a leaf of
    the wrong width."""
    with pytest.raises((TypeError, ValueError)):
        getattr(mixer_kernel, name)(*args())


# --------------------------------------------------------------------------
# On the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _ulps(got: torch.Tensor, want: torch.Tensor, dtype: torch.dtype) -> float:
    """The largest ``|got - want|`` over the spacing of ``dtype`` at
    ``want`` (float64 arithmetic; the spacing at zero is the smallest
    normal's)."""
    fi = torch.finfo(dtype)
    got, want = got.double(), want.double()
    spacing = fi.eps * torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(fi.tiny))))
    return float(((got - want).abs() / spacing).max())


def _card_inputs(B, S, di, dtype, device):
    """The passes' inputs at their served layout: in_proj's output (B, S,
    2 di) and its x and z halves as views, the conv's leaves, dt @ dt_proj
    and the float32 bias, K2's float32 output and D."""
    gen = torch.Generator(device=device).manual_seed(B * 100_003 + S * 7 + di)

    def rnd(shape, scale=1.0, shift=0.0):
        return torch.randn(shape, generator=gen, device=device) * scale + shift

    xz = rnd((B, S, 2 * di)).to(dtype)
    xin, z = xz.chunk(2, dim=-1)
    return dict(xin=xin, z=z, w=rnd((4, di), 0.5).to(dtype), b=rnd((di,), 0.1).to(dtype),
                dt_raw=rnd((B, S, di), 2.0).to(dtype), dt_bias=rnd((di,), 1.0, -4.6),
                y=rnd((B, S, di)), D=rnd((di,), 0.3, 1.0))


CARD_SHAPES = [(b, s, di) for di in (8192, 16384) for s in (1, 7, 1024, 8192) for b in (1, 2)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("B,S,di", CARD_SHAPES)
def test_passes_match_plain_versions_on_the_card(cuda, dtype, B, S, di):
    """Each kernel against its plain version on the card (today's chain):
    x_conv, dt and the gate's output within one ulp of the compute dtype at
    every element, xf the exact widening of x_conv; one launch a pass."""
    dtype = DTYPES[dtype]
    t = _card_inputs(B, S, di, dtype, cuda)
    before = [getattr(mixer_kernel, n).launches for n in PASSES]
    x_conv, xf = mixer_kernel.conv_silu(t["xin"], t["w"], t["b"])
    dt = mixer_kernel.dt_softplus(t["dt_raw"], t["dt_bias"])
    out = mixer_kernel.mixer_gate(t["y"], x_conv, t["D"], t["z"])
    torch.cuda.synchronize()
    assert [getattr(mixer_kernel, n).launches - b for n, b in zip(PASSES, before)] == [1, 1, 1]
    want_conv, _ = conv_silu_ref(t["xin"], t["w"], t["b"])
    want_dt = dt_softplus_ref(t["dt_raw"], t["dt_bias"])
    assert x_conv.dtype == dtype and x_conv.is_contiguous() and out.is_contiguous()
    assert torch.equal(xf, x_conv.float())
    assert _ulps(x_conv, want_conv, dtype) <= 1.0
    assert _ulps(dt, want_dt, dtype) <= 1.0
    # the gate against the chain's gate of the same x_conv
    assert _ulps(out, mixer_gate_ref(t["y"], xf, t["D"], t["z"]), dtype) <= 1.0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_passes_read_unaligned_views_on_the_card(cuda, dtype):
    """A d_inner that is no multiple of the 16-byte vector and strides
    that break the alignment take the scalar instantiation."""
    dtype = DTYPES[dtype]
    B, S, di = 2, 37, 70
    t = _card_inputs(B, S, di, dtype, cuda)
    xz = torch.randn((B, S, 2 * di + 1), device=cuda).to(dtype)
    xin, z = xz[..., 1 : di + 1], xz[..., di + 1 :]
    x_conv, xf = mixer_kernel.conv_silu(xin, t["w"], t["b"])
    assert _ulps(x_conv, conv_silu_ref(xin, t["w"], t["b"])[0], dtype) <= 1.0
    out = mixer_kernel.mixer_gate(t["y"], x_conv, t["D"], z)
    assert _ulps(out, mixer_gate_ref(t["y"], xf, t["D"], z), dtype) <= 1.0
    assert _ulps(mixer_kernel.dt_softplus(t["dt_raw"], t["dt_bias"]),
                 dt_softplus_ref(t["dt_raw"], t["dt_bias"]), dtype) <= 1.0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_served_mixer_matches_the_chain_on_the_card(cuda, dtype, monkeypatch):
    """falcon-mamba-7b's mixer at full width, B = 1 x 1,024: the served
    call (three passes and K2) within the prefill parity of the chain on
    the card; one launch of each pass and of K2."""
    cfg = dataclasses.replace(get_config("falcon-mamba-7b"), compute_dtype=dtype)
    dtype = DTYPES[dtype]
    p = PMB.init_mamba_params(cfg, torch.Generator(device=cuda).manual_seed(0), dtype, cuda)
    x = torch.randn((1, 1024, cfg.d_model), device=cuda).to(dtype)
    counters = [getattr(mixer_kernel, n) for n in PASSES] + [scan_kernel.selective_scan]
    before = [c.launches for c in counters]
    with torch.no_grad():
        got = PMB.mamba_mixer(cfg, p, x)
        torch.cuda.synchronize()
        assert [c.launches - b for c, b in zip(counters, before)] == [1, 1, 1, 1]
        monkeypatch.setattr(PMB, "_on_card", lambda x: False)
        want = PMB.mamba_mixer(cfg, p, x)
    assert [c.launches - b for c, b in zip(counters, before)] == [1, 1, 1, 2]
    scale = float(want.float().abs().max())
    assert float((got.float() - want.float()).abs().max()) <= BF16_TOL * scale


@pytest.mark.gpu
def test_launch_counters_per_prefill_and_train_step_on_the_card(cuda):
    """The reduced falcon-mamba-7b at its full 64 layers: each pass and K2
    launch 64 times a prefill; a training step launches no pass (K2
    forward twice a layer with the recompute, backward once)."""
    cfg = dataclasses.replace(get_config("falcon-mamba-7b").reduced(), n_layers=64)
    tokens = torch.as_tensor(np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 33)),
                             dtype=torch.int32, device=cuda)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu").to(cuda)
    counters = [getattr(mixer_kernel, n) for n in PASSES] + [scan_kernel.selective_scan,
                                                              scan_kernel.selective_scan_bwd]
    before = [c.launches for c in counters]
    steps.make_prefill_step(cfg)(params, {"tokens": tokens[:, :-1]})
    torch.cuda.synchronize()
    assert [c.launches - b for c, b in zip(counters, before)] == [64, 64, 64, 64, 0]
    params = M.train_mode(params)
    opt = adamw.init(steps.param_tree(params), cfg.moment_dtype)
    before = [c.launches for c in counters]
    steps.make_train_step(cfg)(params, opt, {"tokens": tokens[:, :-1],
                                             "labels": tokens[:, 1:]}, 0)
    torch.cuda.synchronize()
    assert [c.launches - b for c, b in zip(counters, before)] == [0, 0, 0, 128, 64]
