"""Plain PyTorch versions of the mamba mixer's prefill passes: the chain
``models/mamba.py`` runs on the CPU and under autograd (the reference's
``_causal_conv``, SiLU, ``_ssm_inputs``' softplus, the D skip and the
silu(z) gate, in its rounding order), factored out so that the CUDA
passes' wrappers run it on CPU tensors and the tests hold the kernels
against it."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def causal_conv(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, history: torch.Tensor | None
) -> torch.Tensor:
    """Depthwise causal conv over the sequence: ``x`` (B, S, di), kernel
    ``w`` (K, di), preceded by ``history`` (B, K-1, di) or zeros; one
    depthwise ``conv1d`` in x's dtype."""
    k = w.shape[0]
    if history is None:
        pad = x.new_zeros((x.shape[0], k - 1, x.shape[2]))
    else:
        pad = history.to(x.dtype)
    xp = torch.cat([pad, x], dim=1).transpose(1, 2)  # (B, di, K-1+S)
    out = F.conv1d(xp, w.T[:, None, :], b, groups=w.shape[1])
    return out.transpose(1, 2)


def conv_silu_ref(
    xin: torch.Tensor, w: torch.Tensor, b: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(x_conv, xf)``: SiLU of the causal conv from zero history, in
    xin's dtype, and its float32 widening."""
    x_conv = F.silu(causal_conv(xin, w, b, None))
    return x_conv, x_conv.float()


def dt_softplus_ref(dt_raw: torch.Tensor, dt_bias: torch.Tensor) -> torch.Tensor:
    """``dt`` float32: ``dt_bias`` cast to dt_raw's (the compute) dtype
    before the add, softplus in that dtype, float32 after."""
    return F.softplus(dt_raw + dt_bias.to(dt_raw.dtype)).float()


def mixer_gate_ref(
    y: torch.Tensor, xf: torch.Tensor, D: torch.Tensor, z: torch.Tensor
) -> torch.Tensor:
    """``(y + xf D) silu(z)`` in float32, rounded to z's (the compute)
    dtype."""
    return ((y + xf * D) * F.silu(z.float())).to(z.dtype)
