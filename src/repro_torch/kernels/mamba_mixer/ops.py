"""Public wrappers for the mamba mixer's passes: take the model's leaves
as they are (``conv_w`` and ``conv_b`` in the compute dtype, ``dt_bias``
and ``D`` in any float dtype) and hand the kernels' wrappers
(:mod:`~repro_torch.kernels.mamba_mixer.kernel`) contiguous leaves,
``dt_bias`` and ``D`` widened to float32 (exactly).

Without autograd (serving) each wrapper launches its forward pass alone:
going through the Function there too launches the same kernels but costs
host time, and falcon-mamba-7b's prefill of 1-8k-token prompts, which the
host partly paces, lost 3.5-7% of its rate on an H100 for it.  When autograd records the
call (grad mode on and an input requiring a gradient: training's forward
and its recompute) it runs as a ``torch.autograd.Function`` whose
forward is the same pass, saving only what the backward pass reads, and
whose backward is the hand-written backward pass on a card and the plain
chain's vector-Jacobian product on the CPU.

xf, the conv's output widened to float32, has two consumers: K2 and the
gate.  Autograd would add their gradients in a pass of its own, so the
conv returns xf twice: once for K2 and once, as ``xf_gate``, for
:func:`mixer_gate`, which reads x_conv and takes ``xf_gate`` only to hand
its part of xf's gradient back to the conv's backward, which adds the two
parts itself."""

from __future__ import annotations

import torch

from repro_torch.kernels.mamba_mixer import kernel


def _records(*ts: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


class _ConvSilu(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xin, w, b):
        x_conv, xf = kernel.conv_silu(xin, w, b)
        if xf is x_conv:  # float32 on the CPU: one tensor, and each output needs its own
            xf = xf.clone()
        ctx.save_for_backward(xin, w, b)
        # xf_gate holds no values: the gate reads x_conv
        return x_conv, xf, xf.new_empty(()).expand(xf.shape)

    @staticmethod
    def backward(ctx, g_conv, g_xf, g_gate):
        xin, w, b = ctx.saved_tensors
        return kernel.conv_silu_bwd(xin, w, b, g_conv.contiguous(), g_xf.contiguous(),
                                    g_gate.contiguous())


class _DtSoftplus(torch.autograd.Function):
    @staticmethod
    def forward(ctx, dt_raw, dt_bias):
        ctx.save_for_backward(dt_raw, dt_bias)
        return kernel.dt_softplus(dt_raw, dt_bias)

    @staticmethod
    def backward(ctx, g_dt):
        dt_raw, dt_bias = ctx.saved_tensors
        return kernel.dt_softplus_bwd(dt_raw, dt_bias, g_dt.contiguous())


class _Gate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, xf_gate, x_conv, D, z):
        ctx.save_for_backward(y, x_conv, D, z)
        return kernel.mixer_gate(y, x_conv, D, z)

    @staticmethod
    def backward(ctx, g):
        y, x_conv, D, z = ctx.saved_tensors
        dy, dxf, dD, dz = kernel.mixer_gate_bwd(g.contiguous(), y, x_conv, D, z)
        return dy, dxf, None, dD, dz


def conv_silu(xin: torch.Tensor, conv_w: torch.Tensor, conv_b: torch.Tensor):
    """``(x_conv, xf, xf_gate)`` of the causal conv and SiLU from zero
    history: xf for K2, ``xf_gate`` for :func:`mixer_gate` (xf itself
    when autograd does not record)."""
    w, b = conv_w.contiguous(), conv_b.contiguous()
    if _records(xin, w, b):
        return _ConvSilu.apply(xin, w, b)
    x_conv, xf = kernel.conv_silu(xin, w, b)
    return x_conv, xf, xf


def dt_softplus(dt_raw: torch.Tensor, dt_bias: torch.Tensor) -> torch.Tensor:
    """float32 ``dt`` from ``dt @ dt_proj`` and the bias."""
    raw, bias = dt_raw.contiguous(), dt_bias.to(torch.float32).contiguous()
    if _records(raw, bias):
        return _DtSoftplus.apply(raw, bias)
    return kernel.dt_softplus(raw, bias)


def mixer_gate(y: torch.Tensor, x_conv: torch.Tensor, xf_gate: torch.Tensor,
               D: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """The D skip and the silu(z) gate, rounded to the compute dtype;
    ``xf_gate`` is :func:`conv_silu`'s third output."""
    D = D.to(torch.float32).contiguous()
    if _records(y, xf_gate, D, z):
        return _Gate.apply(y, xf_gate, x_conv, D, z)
    return kernel.mixer_gate(y, x_conv, D, z)
