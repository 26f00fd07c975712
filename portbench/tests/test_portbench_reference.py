"""The reference against the program on the CPU at reduced sizes, both
families, float32 compute: prefill logits and one training step (loss,
every leaf's clipped gradient and change)."""

from __future__ import annotations

import importlib

import pytest
import torch

from portbench import check
from portbench import traffic as T
from portbench.reference import common as C
from portbench.reference import train as RT
from portbench.tests import _tiny


def _f32(cfg):
    return dict(cfg, compute_dtype="float32")


@pytest.mark.parametrize("family", ["dense", "ssm"])
def test_prefill_logits_match(family):
    from repro_torch.launch import steps

    cfg = _f32(_tiny.CONFIGS[family])
    fam = importlib.import_module(f"portbench.families.{family}")
    ref = importlib.import_module(f"portbench.reference.{family}")
    w = _tiny.leaves(fam, cfg)
    tokens = T.tokens(3, "p", (2, 57), cfg["vocab_size"], "cpu")
    got = steps.make_prefill_step(_tiny.model_config(cfg))(fam.build(_tiny.model_config(cfg), w),
                                                           {"tokens": tokens})
    with torch.no_grad():
        want = C.logits(cfg, w, C.hidden(ref, cfg, w, tokens, "float32")[:, -1], "float32")
    got = got[:, : cfg["vocab_size"]].float()
    assert torch.allclose(got, want, rtol=1e-4, atol=1e-4 * float(want.abs().max()))


@pytest.mark.parametrize("family", ["dense", "ssm"])
def test_train_step_matches(family):
    from repro_torch.launch import steps
    from repro_torch.models import model as M
    from repro_torch.optim import adamw

    cfg = _f32(_tiny.CONFIGS[family])
    mcfg = _tiny.model_config(cfg)
    fam = importlib.import_module(f"portbench.families.{family}")
    ref = importlib.import_module(f"portbench.reference.{family}")
    job = _tiny.TRAIN["optimizer"]
    batch = T.train_batch(_tiny.TRAIN, 5, 0, cfg["vocab_size"], "cpu")
    lm = M.train_mode(fam.build(mcfg, _tiny.leaves(fam, cfg)))
    start = {n: p.detach().clone() for n, p in lm.named_parameters()}
    opt = adamw.init(steps.param_tree(lm))
    sched = adamw.cosine_schedule(job["lr"], job["warmup_steps"], job["total_steps"],
                                  job["min_ratio"])
    step = steps.make_train_step(mcfg, accum=_tiny.TRAIN["accum"], lr_schedule=sched,
                                 max_grad_norm=job["max_grad_norm"])
    _, opt, metrics = step(lm, opt, batch, 0)
    from portbench.cells.train import _flat

    prog = {"losses": [float(metrics["loss"])],
            "grad1": {n: float(m.norm()) / (1 - job["b1"]) for n, m in _flat(opt.m).items()},
            "change": {n: float((p.detach() - start[n]).norm())
                       for n, p in lm.named_parameters()}}
    want = RT.run(ref, cfg, _tiny.leaves(fam, cfg), [batch], job, _tiny.TRAIN["accum"])
    assert set(prog["grad1"]) == set(want["grad1"])
    numbers = check.train_numbers(prog, want)
    assert numbers["loss_gap"] < 1e-5
    assert numbers["grad_gap"] < 1e-4
    assert numbers["update_gap"] < 1e-3


def test_doubling_scan_is_the_recurrence():
    from portbench.reference import ssm

    gen = torch.Generator().manual_seed(0)
    B, S, di, n = 2, 53, 20, 4
    dt = torch.rand(B, S, di, generator=gen) * 0.5
    a = -torch.rand(di, n, generator=gen) * 4
    b, c = torch.randn(B, S, n, generator=gen), torch.randn(B, S, n, generator=gen)
    x = torch.randn(B, S, di, generator=gen)
    h, ys = torch.zeros(B, di, n), []
    for t in range(S):
        h = h * torch.exp(dt[:, t, :, None] * a) + (dt[:, t] * x[:, t])[..., None] * b[:, t, None]
        ys.append((h * c[:, t, None]).sum(-1))
    assert torch.allclose(ssm.scan(dt, a, b, c, x), torch.stack(ys, 1), atol=1e-5, rtol=1e-5)


def test_blocked_attention_gradients():
    """The reference's blocked attention (forward and backward by hand)
    against autograd through the dense formula, with a window and GQA."""
    gen = torch.Generator().manual_seed(1)
    B, S, H, kv, dh, window = 2, 70, 4, 2, 8, 24
    q, k, v = (torch.randn(B, S, h, dh, generator=gen, dtype=torch.float64).float()
               .requires_grad_() for h in (H, kv, kv))
    rows = C.ATTN_ROWS
    C.ATTN_ROWS = 16
    try:
        out = C.attention(q, k, v, window, "float32")
    finally:
        C.ATTN_ROWS = rows
    dout = torch.randn(out.shape, generator=gen)
    got = torch.autograd.grad(out, (q, k, v), dout)
    i, j = torch.arange(S)[:, None], torch.arange(S)[None, :]
    ok = (j <= i) & (j > i - window)
    kk, vv = (t.repeat_interleave(H // kv, dim=2) for t in (k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", q, kk) * dh**-0.5
    p = torch.softmax(s.masked_fill(~ok, float("-inf")), -1)
    want_out = torch.einsum("bhqk,bkhd->bqhd", p, vv)
    want = torch.autograd.grad(want_out, (q, k, v), dout)
    assert torch.allclose(out, want_out, atol=1e-5)
    for g, w in zip(got, want):
        assert torch.allclose(g, w, atol=1e-4)


def test_fp8_control_is_coarser_than_bf16():
    """The control's rounding: float8 e4m3 under one scale a tensor loses
    about 2**-4 of a value, bf16 about 2**-8."""
    x = torch.randn(4096, generator=torch.Generator().manual_seed(2))
    err8 = float(((C.fp8(x) - x).abs() / x.abs().clamp_min(1e-3)).median())
    err16 = float(((x.bfloat16().float() - x).abs() / x.abs().clamp_min(1e-3)).median())
    assert err8 > 8 * err16
